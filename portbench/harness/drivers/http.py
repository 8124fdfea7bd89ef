"""Interactive serving over HTTP: the program's server
(``serve.make_server`` with request coalescing) in a thread of this
process, and an open-loop client in a child process sending Poisson
requests at the mix's fixed rate (``harness/client.py``).

``request_p95_ms`` is the 95th percentile (nearest rank) over all the
requests due in the window, each timed from its due time to its reply; a
request with no good reply counts as slower than any other.  The client's
lateness (send time after due time) is printed on standard error.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

from ..check import prediction_checks, reference_predictions
from ..runner import Check, Outcome
from ..spec import ROOT
from ..traffic import http_schedule, library_pool, seed_for
from .common import free_device, serving_checkpoint


def _post(url, smiles):
    req = urllib.request.Request(url + "/predict", json.dumps(
        {"smiles": smiles}).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def run(ctx) -> Outcome:
    from mgat_graphsage_torch.serve import make_server

    tr = ctx.traffic
    path, scaler = serving_checkpoint(ctx)
    with ctx.phase("load"):
        server = make_server(path, host="127.0.0.1", port=0,
                             batch_size=int(tr["batch_size"]),
                             coalesce_ms=float(tr["coalesce_ms"]),
                             device=str(ctx.device))
        thread = threading.Thread(target=server.serve_forever,
                                  name="portbench-http", daemon=True)
        thread.start()
        host, port = server.server_address[:2]
        url = f"http://{host}:{port}"
    client = None
    try:
        with ctx.phase("pool"):
            pool = library_pool(tr, ctx.seed, ctx.config["budget"][0])
            schedule = http_schedule(tr, pool, ctx.seconds, ctx.seed)
            sched_path = os.path.join(ctx.tmpdir, "schedule.json")
            out_path = os.path.join(ctx.tmpdir, "replies.json")
            with open(sched_path, "w") as f:
                json.dump(schedule, f)
            client = subprocess.Popen(
                [sys.executable, "-m", "portbench.harness.client", host,
                 str(port), sched_path, out_path,
                 str(ctx.seconds + float(tr["drain_seconds"]))],
                cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True)
        with ctx.phase("warmup"):
            rng = np.random.default_rng(seed_for(ctx.seed, "warmup"))
            for k in tr["warmup_requests"]:
                _post(url, [pool[i] for i in rng.integers(0, len(pool), k)])
            if client.stdout.readline().strip() != "ready":
                raise RuntimeError("the HTTP client did not start")
        before = server.backend.health()
        ctx.window_started()
        start = time.monotonic() + 0.05
        client.stdin.write(f"{start!r}\n")
        client.stdin.flush()
        # a traced run profiles the whole window: the profiler's start and
        # stop hold the interpreter lock, and a server stalled in the
        # window backs up for the rest of it
        with ctx.tracer.span("http"):
            client.wait(timeout=ctx.seconds + float(tr["drain_seconds"]) + 60)
        ctx.tracer.stop()
        after = server.backend.health()
        peak = ctx.memory_peak()
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait()
        server.shutdown()
        server.server_close()
        server.backend.close()
        thread.join(timeout=60)
    with open(out_path) as f:
        replies = json.load(f)
    del server
    free_device(ctx)

    lat = np.array([r[1] if r[2] == 200 and r[1] is not None else math.inf
                    for r in replies])
    late = np.array([r[0] for r in replies])
    ok = np.isfinite(lat)
    order = np.sort(lat)
    p95 = float(order[max(math.ceil(0.95 * len(order)) - 1, 0)])
    ctx.log(f"requests {len(replies)}, failed {int((~ok).sum())}, latency "
            f"p50 {np.median(lat) * 1e3:.3f} ms, p95 {p95 * 1e3:.3f} ms; "
            f"client late p50 {np.median(late) * 1e3:.3f} ms, max "
            f"{late.max() * 1e3:.3f} ms")
    due = np.array([t for t, _ in schedule])
    halves = [np.sort(lat[due < ctx.seconds / 2]),
              np.sort(lat[due >= ctx.seconds / 2])]
    half_p95 = [float(h[max(math.ceil(0.95 * len(h)) - 1, 0)]) * 1e3
                if len(h) else 0.0 for h in halves]
    if not math.isfinite(p95):
        # a tail of failed requests: the run's whole allowance
        p95 = ctx.seconds + float(tr["drain_seconds"])

    # a seeded sample of the finished requests, the longest among them
    rng = np.random.default_rng(seed_for(ctx.seed, "check"))
    done = [i for i in range(len(replies)) if ok[i]]
    pick, total = [], 0
    if done:
        pick.append(max(done, key=lambda i: len(schedule[i][1])))
        total = len(schedule[pick[0]][1])
        for i in rng.permutation(done):
            if total >= int(tr["check_molecules"]):
                break
            if i != pick[0]:
                pick.append(int(i))
                total += len(schedule[i][1])
    misaligned = sum(len(replies[i][3]) != len(schedule[i][1]) for i in pick)
    smiles = [s for i in pick for s in schedule[i][1]]
    got = np.array([np.nan if p is None else p for i in pick
                    if len(replies[i][3]) == len(schedule[i][1])
                    for p in replies[i][3]], np.float64)
    aligned = [s for i in pick if len(replies[i][3]) == len(schedule[i][1])
               for s in schedule[i][1]]
    want = reference_predictions(ctx, aligned, scaler)
    checks = prediction_checks(ctx, got, want) + [
        Check("missing", float((~ok).sum()), ctx.limit("missing")),
        Check("misaligned", float(misaligned), ctx.limit("misaligned"))]
    ctx.log(f"checked {len(pick)} requests, {len(smiles)} molecules")
    return Outcome(
        metrics={"request_p95_ms": p95 * 1e3},
        attempted=len(replies), failed=int((~ok).sum()), checks=checks,
        memory_peak_bytes=peak,
        counters={"window_s": ctx.seconds,
                  "molecules_served": after["molecules_served"]
                  - before["molecules_served"],
                  "device_dispatches": after["device_dispatches"]
                  - before["device_dispatches"],
                  "p50_ms": float(np.median(lat)) * 1e3,
                  "p95_ms": p95 * 1e3,
                  "p95_first_half_ms": half_p95[0],
                  "p95_second_half_ms": half_p95[1],
                  "failed": int((~ok).sum()),
                  "client_late_p50_s": float(np.median(late)),
                  "client_late_max_s": float(late.max())})
