"""HTTP model serving for the port's checkpoints (port of
``mgat_graphsage_tpu/serve.py``).

A long-lived process that answers SMILES -> pChEMBL queries: a stdlib HTTP
server around :class:`~mgat_graphsage_torch.eval.predict.Predictor`, which
loads the checkpoint once, featurises each request with the native library
on the host and runs the model on CUDA (adjacency and attention kernels):

    python -m mgat_graphsage_torch.serve \
        checkpoints/flagship/best_model.pt --port 8080 [--coalesce-ms 2] \
        [--device cpu]

    POST /predict   {"smiles": ["CCO", "c1ccccc1O"]}
        -> {"predictions": [5.81, 6.02], "model": "flagship", "count": 2}
    GET  /health    -> {"status": "ok", "model": "flagship", ...}

It runs on CUDA unless given ``device="cpu"`` (``--device cpu``), and
raises without CUDA.  Unparseable or over-budget molecules come back as
``null`` in the index-aligned predictions (the Predictor's NaN rows),
never as a dropped element.  Every device dispatch runs on one
long-lived thread, one at a time: the requests share one model on one card,
and interleaved eager dispatch from request threads would contend rather
than overlap.  That one thread is also why dispatch does not run on the
request's own: the first cuDNN and cuBLAS calls of each new thread cost
~8-10 ms a request on an H100 (``PERF.md``).

**Request coalescing** (``--coalesce-ms``): with a window, concurrent
requests are merged into one featurise + one dispatch (up to
``MAX_COALESCE`` molecules) and the results are split back per request.
A solo request pays up to the window in extra latency; 0 (the default)
turns it off.  ``{"timing": true}`` in a request returns its own
host/device split: on the direct path measured inside that request, on
the coalesced path its ``queue_wait_ms`` (the ``serve.queue_wait`` span:
enqueue until its thread resumes after its group's dispatch started) and
its group's ``featurize_ms`` and ``dispatch_ms``.  ``/health`` carries the
process's span and unit totals and kernel launch counts
(``utils/telemetry.py``) as ``telemetry``.
"""

from __future__ import annotations

import argparse
import json
import queue
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import urlsplit

import numpy as np

from .eval.predict import Predictor
from .utils import telemetry

__all__ = ["PredictionServer", "make_server", "serve_until_signalled",
           "main", "MAX_BODY_BYTES", "MAX_BATCH", "MAX_COALESCE"]

MAX_BODY_BYTES = 16 << 20   # 16 MiB ≈ 200k generous SMILES per request
MAX_BATCH = 100_000
# Molecules per merged dispatch: the reference package's value, kept;
# its value on the H100 is an open question (PERF.md §7)
MAX_COALESCE = 4096


class _Pending:
    """One enqueued predict request awaiting the coalescing worker."""

    __slots__ = ("smiles", "started", "event", "result", "timings", "error",
                 "cancelled")

    def __init__(self, smiles: List[str]):
        self.smiles = smiles
        # set when its group's dispatch starts (the end of its queue wait)
        self.started = threading.Event()
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        # its group's featurise / dispatch split (the predictor's timings)
        self.timings: dict = {}
        self.error: Optional[Exception] = None
        # Set by a waiter that gave up (queue timeout): the worker
        # skips cancelled entries instead of burning a device dispatch
        # on a result nobody will read (and skewing /health counters).
        self.cancelled = False


class PredictionServer:
    """Owns the Predictor and turns request dicts into response dicts.

    Separated from the HTTP plumbing so tests (and alternative
    frontends) can call :meth:`predict_payload` directly.
    """

    def __init__(self, ckpt_path: str, infer_dtype: Optional[str] = None,
                 batch_size: int = 64, coalesce_ms: float = 0.0,
                 queue_timeout_s: float = 600.0, device=None):
        self.predictor = Predictor(ckpt_path, infer_dtype=infer_dtype,
                                   device=device)
        self.batch_size = int(batch_size)
        self.ckpt_path = ckpt_path
        self.coalesce_ms = 0.0
        self.queue_timeout_s = float(queue_timeout_s)
        # every device dispatch and its counters run on this one
        # long-lived thread, which serialises them (the reference's
        # dispatch lock): the HTTP server starts a thread per request, and
        # a fresh thread's first cuDNN and cuBLAS calls cost milliseconds
        self._dispatcher = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mgat-dispatch")
        # Guards the worker lifecycle AND every enqueue: a request must
        # never land on the queue after the shutdown sentinel, or it
        # would wait out the full timeout unserved.
        self._state_lock = threading.Lock()
        # Serializes whole enable/disable transitions (put-sentinel +
        # join happen outside _state_lock, so without this a concurrent
        # re-enable could start a worker that eats the OLD worker's
        # sentinel and exits, leaving the old worker orphaned while
        # _worker points at a dead thread).
        self._toggle_lock = threading.Lock()
        self._requests = 0
        self._molecules = 0
        self._dispatches = 0
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        if float(coalesce_ms) > 0:
            self.enable_coalescing(coalesce_ms)

    def enable_coalescing(self, window_ms: float) -> None:
        """Set the coalescing window on a live backend (idempotent).

        ``window_ms <= 0`` stops the worker — subsequent requests take
        the direct dispatch path — so the toggle is symmetric.
        Transitions are serialized: a toggle that is stopping a worker
        holds the toggle mutex across sentinel + join, so a concurrent
        opposite toggle waits instead of racing the shutdown.
        """
        with self._toggle_lock:
            worker = None
            with self._state_lock:
                self.coalesce_ms = max(float(window_ms), 0.0)
                if self.coalesce_ms > 0:
                    if self._worker is None:
                        self._worker = threading.Thread(
                            target=self._coalesce_loop, daemon=True,
                            name="mgat-coalesce")
                        self._worker.start()
                    return
                worker, self._worker = self._worker, None
                if worker is not None:
                    # Enqueued under the same lock as requests, so every
                    # already-accepted request is ahead of the sentinel
                    # (FIFO) and still gets served.
                    self._queue.put(None)
            if worker is not None:
                worker.join(timeout=60)

    def close(self) -> None:
        """Stop the coalescing worker. Requests already accepted into
        the queue are served before the sentinel; later requests fall
        back to direct dispatch, which the dispatch thread keeps serving
        (it idles between requests and exits with the interpreter)."""
        self.enable_coalescing(0.0)

    # -- coalescing worker ------------------------------------------------
    def _coalesce_loop(self) -> None:
        carry: Optional[_Pending] = None
        while True:
            if carry is not None:
                item, carry = carry, None
            else:
                item = self._queue.get()
            if item is None:
                return
            if item.cancelled:           # waiter gave up: don't dispatch
                continue
            group = [item]
            total = len(item.smiles)
            deadline = time.monotonic() + self.coalesce_ms / 1e3
            while total < MAX_COALESCE:
                wait = deadline - time.monotonic()
                try:
                    nxt = (self._queue.get(timeout=wait) if wait > 0
                           else self._queue.get_nowait())
                except queue.Empty:
                    break
                if nxt is None:          # shutdown: serve this group first
                    self._queue.put(None)
                    break
                if nxt.cancelled:
                    continue
                if total + len(nxt.smiles) > MAX_COALESCE:
                    # would blow the merged-dispatch cap (by up to
                    # MAX_BATCH molecules): hold it back as the seed of
                    # the NEXT group instead of merging it.  A single
                    # request larger than MAX_COALESCE still dispatches
                    # alone (the cap bounds merging, not request size).
                    carry = nxt
                    break
                group.append(nxt)
                total += len(nxt.smiles)
            flat = [s for it in group for s in it.smiles]
            for it in group:
                it.started.set()
            try:
                preds, lt = self._dispatch(flat, len(group))
            except Exception as e:  # noqa: BLE001 — deliver to each waiter
                for it in group:
                    it.error = e
                    it.event.set()
                continue
            off = 0
            for it in group:
                it.result = preds[off:off + len(it.smiles)]
                it.timings = lt
                off += len(it.smiles)
                it.event.set()

    def _dispatch(self, smiles: List[str], n_requests: int):
        """``(predictions, the predictor's timings)`` of one dispatch on the
        dispatch thread, counted as ``n_requests`` requests."""
        return self._dispatcher.submit(self._predict, smiles,
                                       n_requests).result()

    def _predict(self, smiles: List[str], n_requests: int):
        # on the dispatch thread only, so no later dispatch can overwrite
        # last_timings before it is read
        preds = self.predictor(smiles, batch_size=self.batch_size)
        self._dispatches += 1
        self._requests += n_requests
        self._molecules += len(smiles)
        return preds, dict(getattr(self.predictor, "last_timings", {}))

    # -- endpoint bodies ------------------------------------------------
    def health(self) -> dict:
        cfg = self.predictor.cfg
        return {
            "status": "ok",
            "model": cfg.name,
            "fingerprint": cfg.fingerprint,
            "checkpoint": self.ckpt_path,
            "device": str(self.predictor.device),
            "max_nodes": self.predictor.max_nodes,
            "max_edges": self.predictor.max_edges,
            "requests_served": self._requests,
            "molecules_served": self._molecules,
            "device_dispatches": self._dispatches,
            "coalesce_ms": self.coalesce_ms,
            "telemetry": telemetry.snapshot(),
        }

    def predict_payload(self, payload: dict) -> dict:
        t_start = time.perf_counter()
        want_timing = bool(payload.get("timing"))
        smiles = payload.get("smiles")
        if isinstance(smiles, str):
            smiles = [smiles]
        if (not isinstance(smiles, list) or not smiles
                or not all(isinstance(s, str) for s in smiles)):
            raise ValueError(
                "body must be {\"smiles\": [\"...\", ...]} "
                "(a non-empty list of SMILES strings)")
        if len(smiles) > MAX_BATCH:
            raise ValueError(
                f"at most {MAX_BATCH} molecules per request "
                f"(got {len(smiles)}); split the input")
        pending = None
        with self._state_lock:
            if self._worker is not None:
                pending = _Pending(smiles)
                self._queue.put(pending)
        if pending is not None:
            deadline = time.monotonic() + self.queue_timeout_s
            with telemetry.span("serve.queue_wait") as waited:
                pending.started.wait(timeout=self.queue_timeout_s)
            if not pending.event.wait(
                    timeout=max(deadline - time.monotonic(), 0.0)):
                # Mark the entry so the worker drops it instead of
                # spending a device dispatch on an abandoned result.
                # (Benign race: if the worker grouped it in the same
                # instant, the dispatch happens and the result is
                # discarded — same as the pre-fix behavior, but now the
                # common case is a clean skip.)
                pending.cancelled = True
                raise RuntimeError(
                    "prediction timed out in the coalescing queue "
                    f"after {self.queue_timeout_s:g}s")
            if pending.error is not None:
                raise pending.error
            preds, lt = pending.result, pending.timings
            timing = {"path": "coalesced",
                      "queue_wait_ms": round(waited.seconds * 1e3, 2)}
        else:
            preds, lt = self._dispatch(smiles, 1)
            timing = {"path": "direct"}
        out: List[Optional[float]] = [
            None if not np.isfinite(p) else float(p) for p in preds]
        resp = {"predictions": out, "model": self.predictor.cfg.name,
                "count": len(out)}
        if want_timing:
            # one-pass split: the components are measured inside this
            # request (a coalesced request: its group's, inside its wait),
            # so client_total >= server_ms >= featurize + dispatch by
            # construction, and server_ms >= queue_wait_ms, which ends when
            # this thread resumes after its group's dispatch started; the
            # reply's serialisation and socket write land in the client's
            # residual
            timing["featurize_ms"] = round(lt["featurize_s"] * 1e3, 2)
            timing["dispatch_ms"] = round(lt["dispatch_s"] * 1e3, 2)
            timing["server_ms"] = round(
                (time.perf_counter() - t_start) * 1e3, 2)
            resp["timing"] = timing
        return resp


def make_server(ckpt_path: str, host: str = "127.0.0.1", port: int = 8080,
                infer_dtype: Optional[str] = None,
                batch_size: int = 64,
                coalesce_ms: float = 0.0,
                queue_timeout_s: float = 600.0,
                device=None) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``port=0`` picks a free
    port (``server.server_address[1]`` reports it)."""
    backend = PredictionServer(ckpt_path, infer_dtype=infer_dtype,
                               batch_size=batch_size,
                               coalesce_ms=coalesce_ms,
                               queue_timeout_s=queue_timeout_s,
                               device=device)

    class Handler(BaseHTTPRequestHandler):
        server_version = "mgat-serve/1.0"

        def _reply(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _route(self) -> str:
            # self.path carries the raw query string; health checkers
            # routinely append one (GET /health?timeout=5) — route on
            # the path component only.
            return urlsplit(self.path).path.rstrip("/")

        def do_GET(self):  # noqa: N802 (http.server API)
            if self._route() in ("", "/health"):
                self._reply(200, backend.health())
            else:
                self._reply(404, {"error": f"unknown path {self.path}; "
                                           f"GET /health or POST /predict"})

        def do_POST(self):  # noqa: N802
            if self._route() != "/predict":
                self._reply(404, {"error": f"unknown path {self.path}; "
                                           f"POST /predict"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": "request body too large"})
                    return
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                self._reply(200, backend.predict_payload(payload))
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — keep the server alive
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            pass  # quiet; observability comes from /health counters

    server = ThreadingHTTPServer((host, port), Handler)
    server.backend = backend  # for tests / embedding
    return server


def serve_until_signalled(server: ThreadingHTTPServer) -> None:
    """Serve until SIGTERM or Ctrl-C, then shut down cleanly.

    Process supervisors (systemd, docker stop, kubernetes) deliver
    SIGTERM; without a handler the process dies mid-request and any
    coalescing worker is killed with requests still queued. The handler
    calls ``server.shutdown()`` from a helper thread (calling it from
    the signal frame inside ``serve_forever`` would deadlock), and the
    backend is always closed — draining accepted requests — on the way
    out. Must run in the main thread (CPython signal API restriction);
    the previous SIGTERM disposition is restored on return.
    """
    def _term(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    prev = signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.backend.close()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Serve SMILES->pChEMBL predictions over HTTP")
    p.add_argument("ckpt", help="checkpoint of the port (.pt) or of the "
                                "JAX package (.msgpack), with its .json "
                                "sidecar")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--infer-dtype", default=None,
                   help="e.g. bfloat16 for bf16 serving")
    p.add_argument("--coalesce-ms", type=float, default=0.0,
                   help="merge concurrent requests arriving within this "
                        "window into one device dispatch (0 = off); solo "
                        "requests pay up to the window in extra latency")
    p.add_argument("--queue-timeout-s", type=float, default=600.0,
                   help="max seconds a request may wait in the "
                        "coalescing queue before it gets a 500 and is "
                        "dropped by the worker")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    server = make_server(args.ckpt, args.host, args.port,
                         infer_dtype=args.infer_dtype,
                         batch_size=args.batch_size,
                         coalesce_ms=args.coalesce_ms,
                         queue_timeout_s=args.queue_timeout_s,
                         device=args.device)
    host, port = server.server_address[:2]
    print(f"serving {args.ckpt} on http://{host}:{port} "
          f"on {server.backend.predictor.device} (POST /predict, GET /health)",
          flush=True)
    serve_until_signalled(server)


if __name__ == "__main__":
    main()
