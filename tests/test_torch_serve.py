"""The port's HTTP server (``serve.py``) on the CPU: a live server on an
ephemeral port answering SMILES -> pChEMBL from a port checkpoint, probed
as a deployment's health check would, and held against the reference
package's server on the same weights.

The checkpoints are built as ``tests/test_torch_predict.py`` builds them: a
light reference checkpoint of the flagship (CNN fc1 cut to 16 wide), and
the port checkpoint of the same weights.  Tolerance against the reference:
1e-4 pChEMBL (f32 sums in another order).
"""

import dataclasses
import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgat_graphsage_tpu.ops import dense_adjacency as jdense
from mgat_graphsage_tpu.serve import PredictionServer as JaxServer
from mgat_graphsage_tpu.train.checkpoint import save_checkpoint as jsave
from mgat_graphsage_tpu.train.config import get_config as jget_config
from mgat_graphsage_tpu.train.trainer import build_model as jbuild

from mgat_graphsage_torch import serve as serve_mod
from mgat_graphsage_torch.data import MolecularDataset
from mgat_graphsage_torch.eval import predict as tpredict
from mgat_graphsage_torch.models import params_from_jax
from mgat_graphsage_torch.serve import (
    PredictionServer,
    make_server,
    serve_until_signalled,
)
from mgat_graphsage_torch.train import save_checkpoint
from mgat_graphsage_torch.utils import telemetry

SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "c1ccncc1", "CCCC",
          "CC(C)O", "c1ccc(Cl)cc1"] * 2
BUDGET = (16, 32)
BIG = "C" * 20                   # parses, but past the 16-atom budget


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(reference checkpoint, port checkpoint) holding the same weights."""
    d = tmp_path_factory.mktemp("torch_serve")
    cfg = jget_config("flagship", cnn_fc_hidden=16)
    model = jbuild(cfg)
    n, e = BUDGET
    adj = jdense(jnp.zeros((1, 2, e), jnp.int32), jnp.zeros((1, e)), n)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(5), jnp.zeros((1, n, 35)), adj, jnp.ones((1, n)),
        jnp.zeros((1, 1024)))["params"])
    meta = {"config": dataclasses.asdict(cfg),
            "scaler": {"mean": 6.25, "scale": 1.375},
            "max_nodes": n, "max_edges": e}
    jpath = str(d / "ref.msgpack")
    jsave(jpath, {"step": np.zeros((), np.int32), "params": params,
                  "batch_stats": {}}, meta, light=True)
    tpath = str(d / "port.pt")
    with open(jpath + ".json") as f:
        side = json.load(f)
    save_checkpoint(tpath, params_from_jax(params), side)
    return jpath, tpath


@pytest.fixture(scope="module")
def ckpt(ckpts):
    return ckpts[1]


@pytest.fixture(scope="module")
def server(ckpt):
    srv = make_server(ckpt, port=0, batch_size=8, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body, raw=False):
    data = body if raw else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _backend(ckpt, **kw):
    return PredictionServer(ckpt, batch_size=8, device="cpu", **kw)


def test_health(server, ckpt):
    status, body = _get(server + "/health")
    assert status == 200
    assert body["status"] == "ok" and body["model"] == "flagship"
    assert body["fingerprint"] == "ecfp1024" and body["device"] == "cpu"
    assert (body["max_nodes"], body["max_edges"]) == BUDGET
    assert body["checkpoint"] == ckpt and body["coalesce_ms"] == 0.0


def test_predict(server):
    status, body = _post(server + "/predict", {"smiles": SMILES[:4]})
    assert status == 200
    assert body["count"] == 4 and body["model"] == "flagship"
    assert all(isinstance(p, float) for p in body["predictions"])
    # deterministic across requests
    _, body2 = _post(server + "/predict", {"smiles": SMILES[:4]})
    assert body2["predictions"] == body["predictions"]


def test_predict_single_string_and_nan_alignment(server):
    status, body = _post(server + "/predict", {"smiles": "CCO"})
    assert status == 200 and body["count"] == 1
    # unparseable and over-budget -> null at their index; neighbours kept
    status, body = _post(server + "/predict",
                         {"smiles": ["CCO", "C1CC(", "CCN", BIG]})
    assert status == 200
    p = body["predictions"]
    assert p[1] is None and p[3] is None
    assert p[0] is not None and p[2] is not None
    status, body = _post(server + "/predict", {"smiles": ["C1CC("]})
    assert status == 200 and body["predictions"] == [None]


def test_smiles_holding_a_nul_comes_back_null(server):
    """``"CCO\\u0000X"`` in a request is not scored as ``"CCO"``: the native
    featuriser fails it as the Python parser does."""
    status, body = _post(server + "/predict",
                         {"smiles": ["CCO\x00X", "CCO", "\x00"]})
    assert status == 200
    p = body["predictions"]
    assert p[0] is None and p[2] is None and p[1] is not None


def test_error_paths(server, monkeypatch):
    status, body = _post(server + "/predict", {"smiles": []})
    assert status == 400 and "smiles" in body["error"]
    status, body = _post(server + "/predict", {"smiles": [1, 2]})
    assert status == 400
    status, body = _post(server + "/predict", b"not json{", raw=True)
    assert status == 400 and "bad request" in body["error"]
    status, body = _post(server + "/predict", b"[1, 2]", raw=True)
    assert status == 400 and "JSON object" in body["error"]
    status, body = _post(server + "/nope", {"smiles": ["CCO"]})
    assert status == 404
    status, body = _get(server + "/nothere")
    assert status == 404
    monkeypatch.setattr(serve_mod, "MAX_BATCH", 3)
    status, body = _post(server + "/predict", {"smiles": ["C"] * 4})
    assert status == 400 and "at most 3" in body["error"]
    monkeypatch.setattr(serve_mod, "MAX_BODY_BYTES", 10)
    status, body = _post(server + "/predict", {"smiles": ["CCO"]})
    assert status == 413


def test_concurrent_requests(server):
    """8 threads post at once; dispatch is serialised on one thread, every
    reply is whole and the counters account for all of them."""
    _, before = _get(server + "/health")
    results, errors = [], []

    def worker(i):
        try:
            results.append(_post(server + "/predict",
                                 {"smiles": SMILES[i % 4:i % 4 + 3]}))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert len(results) == 8
    assert all(s == 200 and b["count"] == 3 for s, b in results)
    _, after = _get(server + "/health")
    assert after["requests_served"] == before["requests_served"] + 8
    assert after["molecules_served"] == before["molecules_served"] + 24


def test_health_counters_advance(server):
    _, before = _get(server + "/health")
    _post(server + "/predict", {"smiles": ["CCO"]})
    _, after = _get(server + "/health")
    assert after["requests_served"] == before["requests_served"] + 1
    assert after["molecules_served"] == before["molecules_served"] + 1
    assert after["device_dispatches"] == before["device_dispatches"] + 1


def test_request_coalescing(ckpt):
    """Concurrent requests inside the window merge into fewer dispatches,
    with each request's answer equal to its solo answer."""
    backend = _backend(ckpt, coalesce_ms=500.0)
    try:
        solo = backend.predict_payload({"smiles": SMILES[:3]})
        assert solo["count"] == 3 and solo["predictions"][0] is not None
        requests = [SMILES[i:i + 3] for i in range(4)]
        requests[2] = ["CCO", "C1CC(", "CCN"]   # the null stays aligned
        results, errors = [None] * len(requests), []

        def worker(i):
            try:
                results[i] = backend.predict_payload({"smiles": requests[i]})
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        before = backend.health()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        after = backend.health()
        assert not errors, errors
        merged = after["device_dispatches"] - before["device_dispatches"]
        assert merged < len(requests), merged
        assert after["requests_served"] - before["requests_served"] == 4
        for req, res in zip(requests, results):
            ref = backend.predictor(req, batch_size=8)
            got = [np.nan if p is None else p for p in res["predictions"]]
            np.testing.assert_allclose(got, ref, rtol=1e-6)
        assert results[2]["predictions"][1] is None
    finally:
        backend.close()


def test_query_strings_do_not_break_routing(server):
    status, body = _get(server + "/health?timeout=5")
    assert status == 200 and body["status"] == "ok"
    status, body = _post(server + "/predict?trace=1", {"smiles": ["CCO"]})
    assert status == 200 and body["count"] == 1


def test_coalescing_toggle_off_and_safe_close(ckpt):
    """``enable_coalescing(0)`` stops the worker, a negative window is
    clamped, and after ``close()`` requests take the direct path."""
    backend = _backend(ckpt, coalesce_ms=200.0)
    try:
        assert backend._worker is not None
        backend.enable_coalescing(0.0)
        assert backend._worker is None
        assert backend.health()["coalesce_ms"] == 0.0
        assert backend.predict_payload({"smiles": ["CCO"]})["count"] == 1
        backend.enable_coalescing(-5.0)
        assert backend.coalesce_ms == 0.0 and backend._worker is None
        backend.enable_coalescing(200.0)
        assert backend._worker is not None
        backend.close()
        assert backend._worker is None
        out = backend.predict_payload({"smiles": ["CCN", "CCO"]})
        assert out["count"] == 2
    finally:
        backend.close()


def test_sigterm_graceful_shutdown(ckpt):
    """SIGTERM drains the coalescing worker and returns from the serve
    loop; the previous disposition is restored."""
    srv = make_server(ckpt, port=0, batch_size=8, coalesce_ms=50.0,
                      device="cpu")
    assert srv.backend._worker is not None
    prev = signal.getsignal(signal.SIGTERM)
    timer = threading.Timer(1.0, os.kill, (os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        serve_until_signalled(srv)     # blocks until the timer's SIGTERM
    finally:
        timer.cancel()
        srv.server_close()
    assert srv.backend._worker is None
    assert signal.getsignal(signal.SIGTERM) is prev
    assert srv.backend.predict_payload({"smiles": ["CCO"]})["count"] == 1


class _StubPredictor:
    """Records dispatch sizes; sleeps on the first call when asked."""

    def __init__(self, real, first_call_sleep=0.0):
        self.cfg = real.cfg
        self.device = real.device
        self.max_nodes, self.max_edges = real.max_nodes, real.max_edges
        self.sizes = []
        self._sleep = first_call_sleep

    def __call__(self, smiles, batch_size=None):
        self.sizes.append(len(smiles))
        if self._sleep and len(self.sizes) == 1:
            time.sleep(self._sleep)
        return np.zeros(len(smiles), dtype=np.float64)


def test_toggle_storm_leaves_no_orphan_worker(ckpt):
    backend = _backend(ckpt)
    stop = threading.Event()

    def storm():
        while not stop.is_set():
            backend.enable_coalescing(5.0)
            backend.enable_coalescing(0.0)

    threads = [threading.Thread(target=storm) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    backend.enable_coalescing(0.0)
    time.sleep(0.1)
    orphans = [t for t in threading.enumerate()
               if t.name == "mgat-coalesce" and t.is_alive()]
    assert not orphans, orphans
    assert backend.predict_payload({"smiles": ["CCO"]})["count"] == 1


def test_coalesce_merge_respects_cap(ckpt, monkeypatch):
    """With the cap at 8 and five requests of 5 in flight, no merged
    dispatch passes 8 and every request is answered."""
    monkeypatch.setattr(serve_mod, "MAX_COALESCE", 8)
    backend = _backend(ckpt)
    stub = _StubPredictor(backend.predictor)
    backend.predictor = stub
    backend.enable_coalescing(100.0)
    try:
        results = [None] * 5

        def call(i):
            results[i] = backend.predict_payload({"smiles": ["CCO"] * 5})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None and r["count"] == 5 for r in results)
        assert stub.sizes and max(stub.sizes) <= 8, stub.sizes
        assert sum(stub.sizes) == 25
    finally:
        backend.close()


def test_queue_timeout_cancels_abandoned_entry(ckpt):
    """A request that times out in the queue is never dispatched later."""
    backend = _backend(ckpt, queue_timeout_s=0.25)
    stub = _StubPredictor(backend.predictor, first_call_sleep=1.0)
    backend.predictor = stub
    backend.enable_coalescing(10.0)
    try:
        errs, errs1 = [], []

        def slow_then_timeout():
            try:
                backend.predict_payload({"smiles": ["CCO"]})
            except RuntimeError as e:
                errs1.append(str(e))

        def expect_timeout():
            time.sleep(0.15)           # arrive while dispatch 1 sleeps
            try:
                backend.predict_payload({"smiles": ["CCN", "CCC"]})
            except RuntimeError as e:
                errs.append(str(e))

        t1 = threading.Thread(target=slow_then_timeout)
        t2 = threading.Thread(target=expect_timeout)
        t1.start()
        t2.start()
        t1.join(timeout=30)
        t2.join(timeout=30)
        assert errs and "timed out" in errs[0]
        assert errs1 and "timed out" in errs1[0]
        time.sleep(0.3)                # the worker has time to (not) act
        assert stub.sizes == [1], stub.sizes
        backend.queue_timeout_s = 60.0
        assert backend.predict_payload({"smiles": ["CCO"]})["count"] == 1
        assert stub.sizes == [1, 1]
    finally:
        backend.close()


def test_dispatch_runs_on_one_long_lived_thread(ckpt):
    """Direct and coalesced requests, from many request threads, reach the
    predictor on one thread: a new thread's first cuDNN and cuBLAS calls
    cost milliseconds on the card."""
    class Recording(_StubPredictor):
        last_timings = {"featurize_s": 0.0, "dispatch_s": 0.0}

        def __call__(self, smiles, batch_size=None):
            seen.append(threading.get_ident())
            return super().__call__(smiles, batch_size)

    seen = []
    backend = _backend(ckpt)
    backend.predictor = Recording(backend.predictor)
    try:
        for window in (0.0, 5.0):
            backend.enable_coalescing(window)
            threads = [threading.Thread(target=backend.predict_payload,
                                        args=({"smiles": ["CCO"]},))
                       for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert len(seen) >= 5 and len(set(seen)) == 1
        assert seen[0] != threading.get_ident()
    finally:
        backend.close()


@pytest.mark.parametrize("window", [0.0, 1.0], ids=["direct", "coalesced"])
def test_counters_hold_under_a_thread_storm(ckpt, window):
    """24 threads (more than the cores here) post 5 requests each with the
    interpreter switching threads every microsecond: every reply is whole
    and no counter update is lost."""
    backend = _backend(ckpt)
    backend.predictor = _StubPredictor(backend.predictor)
    backend.predictor.last_timings = {"featurize_s": 0.0, "dispatch_s": 0.0}
    backend.enable_coalescing(window)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        counts, errors = [], []

        def worker(i):
            try:
                for j in range(5):
                    n = 1 + (i + j) % 3
                    reply = backend.predict_payload({"smiles": ["C"] * n})
                    assert reply["count"] == n
                    counts.append(n)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        backend.close()
    assert not errors, errors
    health = backend.health()
    assert health["requests_served"] == len(counts) == 120
    assert health["molecules_served"] == sum(counts)
    assert sum(backend.predictor.sizes) == sum(counts)
    assert health["device_dispatches"] == len(backend.predictor.sizes)


def test_one_pass_timing_split(server):
    status, body = _post(server + "/predict",
                         {"smiles": ["CCO", "c1ccccc1"], "timing": True})
    assert status == 200
    t = body["timing"]
    assert t["path"] == "direct"
    assert t["featurize_ms"] >= 0 and t["dispatch_ms"] >= 0
    assert t["server_ms"] >= t["featurize_ms"] + t["dispatch_ms"] - 0.01
    status, body = _post(server + "/predict", {"smiles": ["CCO"]})
    assert status == 200 and "timing" not in body


def test_coalesced_timing_split(ckpt):
    """On the coalesced path ``timing`` gives the request's queue wait and
    its group's featurise / dispatch split, and the wait is the
    ``serve.queue_wait`` span of the registry."""
    backend = _backend(ckpt, coalesce_ms=50.0)
    try:
        before = telemetry.snapshot()["spans"].get(
            "serve.queue_wait", {"count": 0, "seconds": 0.0})
        reply = backend.predict_payload({"smiles": SMILES[:3],
                                         "timing": True})
        t = reply["timing"]
        assert t["path"] == "coalesced" and reply["count"] == 3
        assert t["featurize_ms"] > 0 and t["dispatch_ms"] > 0
        # the wait holds the coalescing window: the group's dispatch
        # starts when the window closes
        assert 40.0 <= t["queue_wait_ms"] <= t["server_ms"]
        assert t["server_ms"] >= t["featurize_ms"] + t["dispatch_ms"] - 0.01
        after = telemetry.snapshot()["spans"]["serve.queue_wait"]
        assert after["count"] == before["count"] + 1
        assert after["seconds"] - before["seconds"] == pytest.approx(
            t["queue_wait_ms"] / 1e3, abs=1e-4)
        assert "timing" not in backend.predict_payload({"smiles": ["CCO"]})
    finally:
        backend.close()


def test_health_carries_the_telemetry_totals(server):
    """``/health``'s ``telemetry`` holds the registry's totals: a request
    adds one ``predict_call`` unit and one ``predict.dispatch`` span, and
    the kernel wrappers' launch counters ride beside them, with the native
    featuriser's: one more call, on the calling thread alone."""
    _, before = _get(server + "/health")
    _post(server + "/predict", {"smiles": ["CCO", "c1ccccc1"]})
    _, after = _get(server + "/health")
    b, a = before["telemetry"], after["telemetry"]
    assert a["units"]["predict_call"]["count"] == \
        b["units"]["predict_call"]["count"] + 1
    for name in ("predict.featurize", "predict.dispatch", "featurize.native",
                 "predict.upload", "predict.readback"):
        assert a["spans"][name]["count"] == b["spans"][name]["count"] + 1
        assert a["spans"][name]["seconds"] > b["spans"][name]["seconds"]
    assert "dense_adjacency_cuda" in a["launches"]
    assert {k: a["featurize"][k] - b["featurize"][k]
            for k in a["featurize"]} == {"calls": 1, "parallel_calls": 0,
                                         "molecules": 2, "workers": 1}


def test_answers_as_the_reference_server_does(ckpts):
    """Same weights, same requests: the port's server within 1e-4 pChEMBL
    of the reference package's, with null in the same slots."""
    jpath, tpath = ckpts
    ref, ours = JaxServer(jpath, batch_size=8), _backend(tpath)
    requests = [SMILES, ["CCO", "C1CC(", BIG, "c1ccc(Cl)cc1"], "CCN",
                ["C1CC("]]
    for smiles in requests:
        a = ours.predict_payload({"smiles": smiles})
        b = ref.predict_payload({"smiles": smiles})
        assert a["count"] == b["count"] and a["model"] == b["model"]
        got = np.array([np.nan if p is None else p
                        for p in a["predictions"]])
        want = np.array([np.nan if p is None else p
                         for p in b["predictions"]])
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the port's own additions: the device it serves on, and the span and
    # unit totals of utils/telemetry.py
    assert set(ours.health()) == set(ref.health()) | {"device", "telemetry"}


def test_batch_rounding_leaves_outputs_unchanged(ckpt, monkeypatch):
    """The batch count is not rounded up to a power of two: 41 molecules
    at batch 8 run 6 batches, not 8.  The 7 pad rows of the last batch
    are inert: its one molecule comes out the same bits as in a batch of
    its own, and ``Predictor`` returns ``predict_dataset``'s bits."""
    p = tpredict.Predictor(ckpt, device="cpu")
    smiles = (SMILES * 3)[:41]
    ds = MolecularDataset(smiles, np.zeros(41, np.float32), scaler=p.scaler,
                          max_nodes=BUDGET[0], max_edges=BUDGET[1],
                          verbose=False)
    calls = []
    adjacency = tpredict.dense_adjacency
    monkeypatch.setattr(tpredict, "dense_adjacency",
                        lambda *a: calls.append(1) or adjacency(*a))
    plain = tpredict.predict_dataset(p.model, p.cfg, p.scaler, ds, 8)
    assert plain.shape == (41,) and len(calls) == 6
    last = MolecularDataset([smiles[40]] * 8, np.zeros(8, np.float32),
                            scaler=p.scaler, max_nodes=BUDGET[0],
                            max_edges=BUDGET[1], verbose=False)
    alone = tpredict.predict_dataset(p.model, p.cfg, p.scaler, last, 8)
    assert alone[0] == plain[40]
    np.testing.assert_array_equal(p(smiles, batch_size=8), plain)


def test_server_refuses_to_start_without_cuda(ckpt, monkeypatch):
    """No ``device`` means CUDA: without it the server raises, as
    ``Predictor`` does, rather than serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server(ckpt, port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.main([ckpt, "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PredictionServer(ckpt)
