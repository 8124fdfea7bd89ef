"""The port's spans and units of work (``utils/telemetry.py``) on the CPU:
the registry itself, the spans of the train step, ``Trainer.evaluate`` and
the ``Predictor`` call, their place in a ``torch.profiler`` trace, and the
benchmark's readers of them (``portbench/metrics/``)."""

import json
import os
import re
import sys
import threading
import types

import numpy as np
import pytest
import torch

from mgat_graphsage_torch.data import (
    TRAIN_CSV,
    VAL_CSV,
    MolecularDataset,
    load_csv,
)
from mgat_graphsage_torch.eval import predict as tpredict
from mgat_graphsage_torch.ops import adjacency
from mgat_graphsage_torch.train import Trainer, get_config
from mgat_graphsage_torch import utils as utils_pkg
from mgat_graphsage_torch.utils import telemetry, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_SPANS = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(scope="module")
def small():
    """A flagship with its CNN fc1 cut to 16 wide, on 32 + 16 bundled
    molecules at batch 16: two train steps and one validation batch."""
    torch.set_num_threads(1)
    sm, y = load_csv(TRAIN_CSV)
    vs, vy = load_csv(VAL_CSV)
    tr = MolecularDataset(sm[:32], y[:32], fit_scaler=True, verbose=False)
    va = MolecularDataset(vs[:16], vy[:16], scaler=tr.scaler,
                          max_nodes=tr.max_nodes, max_edges=tr.max_edges,
                          verbose=False)
    cfg = get_config("flagship", cnn_fc_hidden=16, batch_size=16,
                     eval_batch_size=16)
    return cfg, tr, va


def test_registry_sums_nested_spans_and_closes_units_with_counts():
    reg = telemetry.Registry()
    with reg.unit("work", items=3) as rec:
        with reg.span("outer") as outer:
            with reg.span("inner") as a:
                pass
            with reg.span("inner") as b:
                pass
        rec.counts["steps"] = 2
    with reg.span("outer"):          # outside any unit: totals only
        pass
    assert rec.counts == {"items": 3, "steps": 2} and rec.kind == "work"
    assert rec.spans["inner"] == pytest.approx(a.seconds + b.seconds)
    assert rec.spans["outer"] == outer.seconds >= rec.spans["inner"]
    assert rec.wall_s >= outer.seconds and not rec.profiled
    assert reg.records("work") == [rec] and reg.records("other") == []
    snap = reg.snapshot()
    assert snap["spans"]["inner"]["count"] == 2
    assert snap["spans"]["outer"]["count"] == 2
    assert snap["spans"]["outer"]["seconds"] > outer.seconds
    assert snap["units"]["work"]["count"] == 1
    json.dumps(snap)


def test_records_are_bounded_and_the_tail_follows_the_newest_profiled():
    reg = telemetry.Registry(max_records=5)
    for i in range(8):
        with reg.unit("epoch", i=i) as rec:
            rec.profiled = i in (2, 4)
    recs = reg.records("epoch")
    assert [r.counts["i"] for r in recs] == [3, 4, 5, 6, 7]
    assert [r.counts["i"] for r in reg.unprofiled_tail("epoch")] == [5, 6, 7]
    assert reg.snapshot()["units"]["epoch"]["count"] == 8
    with reg.unit("epoch", i=8) as rec:
        rec.profiled = True
    assert reg.unprofiled_tail("epoch") == []
    assert reg.unprofiled_tail("none") == []


def test_two_threads_keep_their_units_apart():
    """Each thread's spans land in its own open unit; the totals, under
    the lock, lose no update with the interpreter switching threads every
    microsecond."""
    reg = telemetry.Registry()
    barrier = threading.Barrier(2, timeout=30)
    n = 200

    def work(name):
        with reg.unit("call", thread=name) as rec:
            barrier.wait()
            for _ in range(n):
                with reg.span(name):
                    pass
            with reg.span("shared"):
                pass
        assert set(rec.spans) == {name, "shared"}

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(f"t{i}",))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    recs = reg.records("call")
    assert sorted(r.counts["thread"] for r in recs) == ["t0", "t1"]
    for r in recs:
        assert set(r.spans) == {r.counts["thread"], "shared"}
    snap = reg.snapshot()["spans"]
    assert snap["t0"]["count"] == snap["t1"]["count"] == n
    assert snap["shared"]["count"] == 2


def test_no_record_function_without_a_profiler(small, monkeypatch):
    """With no profiler running, no span enters ``record_function``: an
    epoch, an evaluation and a prediction run with it made to raise."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    # the name the spans look up (``Optimizer.step`` enters its own
    # record_function through ``torch.autograd.profiler``, profiler or not)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cfg, tr, va = small
    trainer = Trainer(cfg, tr, va, device="cpu")
    state = trainer.init_state()
    state, row = trainer.train_epoch(state, 0)
    trainer.evaluate(state)
    assert row["forward_s"] > 0 and row["sync_s"] > 0
    with telemetry.span("predict.upload"):
        pass
    assert not telemetry.records("train_epoch")[-1].profiled
    assert not telemetry.records("evaluate")[-1].profiled


def test_profiled_epoch_records_the_step_spans(small):
    """Under ``torch.profiler.profile(activities=[CPU])`` a CPU epoch's
    unit holds the step's spans, is ``profiled``, and the trace holds
    each span as a range; the evaluation's unit holds ``eval.readback``."""
    cfg, tr, va = small
    trainer = Trainer(cfg, tr, va, device="cpu")
    state = trainer.init_state()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        state, row = trainer.train_epoch(state, 0)
        trainer.evaluate(state)
    epoch = telemetry.records("train_epoch")[-1]
    assert epoch.profiled and epoch.counts == {"steps": 2}
    for name in STEP_SPANS + ("train.sync",):
        assert epoch.spans[name] > 0, name
    ev = telemetry.records("evaluate")[-1]
    assert ev.profiled and ev.counts == {"batches": 1}
    assert ev.spans["eval.readback"] > 0
    counts = {}
    for e in prof.events():
        counts[e.name] = counts.get(e.name, 0) + 1
    for name in STEP_SPANS:
        assert counts.get(name) == 2, (name, counts.get(name))
    assert counts.get("train.sync") == 1
    assert counts.get("eval.readback") == 1
    # after the profiler, the next epoch is not profiled
    trainer.train_epoch(state, 1)
    assert not telemetry.records("train_epoch")[-1].profiled


def test_trace_writes_the_span_names(small, tmp_path):
    cfg, tr, va = small
    trainer = Trainer(cfg, tr, va, device="cpu")
    state = trainer.init_state()
    with trace(str(tmp_path)):
        trainer.train_epoch(state, 0)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    names = {ev.get("name") for ev in events}
    for name in STEP_SPANS + ("train.sync",):
        assert name in names, name


def test_epoch_span_seconds_fit_in_the_epoch_and_the_log(small, tmp_path):
    cfg, tr, va = small
    log = tmp_path / "log.jsonl"
    trainer = Trainer(cfg.replace(epochs=2), tr, va, device="cpu",
                      log_path=str(log))
    _, _, history = trainer.fit(verbose=False, save_best=False)
    keys = ("forward_s", "backward_s", "optimizer_s", "sync_s")
    rows = [json.loads(line) for line in open(log)]
    assert len(rows) == len(history) == 2
    for row, hist in zip(rows, history):
        assert all(row[k] == hist[k] > 0 for k in keys)
        assert sum(row[k] for k in keys) <= row["epoch_time_s"]
        assert row["molecules_per_s"] == pytest.approx(
            len(tr) / row["epoch_time_s"])


def test_predictor_timings_split_the_call(small, tmp_path):
    """``last_timings`` keeps ``featurize_s`` and ``dispatch_s`` and splits
    them; the predictions are bit for bit ``predict_dataset``'s on the
    same dataset, with and without a profiler running."""
    cfg, tr, va = small
    trainer = Trainer(cfg, tr, va, device="cpu")
    state = trainer.init_state()
    ckpt = str(tmp_path / "m.pt")
    trainer.save(ckpt, state, light=True)
    pred = tpredict.Predictor(ckpt, device="cpu")
    smiles = list(va.smiles) + ["C1CC("]
    out = pred(smiles, batch_size=8)
    lt = pred.last_timings
    assert set(lt) == {"featurize_s", "dispatch_s", "native_s", "upload_s",
                       "readback_s"}
    assert 0 < lt["native_s"] <= lt["featurize_s"]
    assert 0 < lt["upload_s"] + lt["readback_s"] <= lt["dispatch_s"]
    rec = telemetry.records("predict_call")[-1]
    assert rec.counts == {"molecules": len(smiles)}
    assert lt["featurize_s"] == rec.spans["predict.featurize"]
    assert lt["featurize_s"] + lt["dispatch_s"] <= rec.wall_s
    ds = MolecularDataset(smiles, np.zeros(len(smiles), np.float32),
                          scaler=pred.scaler, max_nodes=pred.max_nodes,
                          max_edges=pred.max_edges, verbose=False)
    want = np.full(len(smiles), np.nan, np.float32)
    want[ds.kept_indices] = tpredict.predict_dataset(
        pred.model, pred.cfg, pred.scaler, ds, 8)
    np.testing.assert_array_equal(out, want)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        traced = pred(smiles, batch_size=8)
    np.testing.assert_array_equal(traced, want)
    assert telemetry.records("predict_call")[-1].profiled
    # no valid molecule: featurisation timed, nothing dispatched
    assert np.isnan(pred(["C1CC("])).all()
    assert pred.last_timings["featurize_s"] > 0
    assert pred.last_timings["dispatch_s"] == 0.0


def test_spans_names_every_span_the_program_opens():
    """``SPANS``, which the benchmark's tracer is to be handed, is exactly
    the set of names the package passes to ``telemetry.span``."""
    pkg = os.path.join(REPO, "mgat_graphsage_torch")
    opened = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    opened |= set(re.findall(
                        r'telemetry\.(?:device_)?span\("([^"]+)"[,)]',
                        fh.read()))
    assert opened == set(telemetry.SPANS)
    assert len(telemetry.SPANS) == len(set(telemetry.SPANS)) == 13
    assert {"graphormer.bias", "graphormer.attention"} <= set(telemetry.SPANS)


class _FakeEvent:
    """A CUDA event's interface on the host's clock: ``record`` notes the
    time; ``query`` is True unless the test says the device lags."""
    lagging = False

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = len(_FakeEvent.log)
        _FakeEvent.log.append(self)

    def query(self):
        return not _FakeEvent.lagging

    def elapsed_time(self, end):
        return 1000.0 * (end.t - self.t)     # ms: one second per record


def test_device_span_records_nothing_on_the_cpu():
    """On the CPU a device span makes no event and leaves the unit's
    device seconds empty; the host spans are as before."""
    reg = telemetry.Registry()
    with reg.unit("epoch") as rec:
        with reg.device_span("graphormer.attention", "cpu"), \
                reg.span("train.forward"):
            pass
    assert rec.device == {} and rec.pending == [] \
        and rec.device_unresolved == 0
    assert set(rec.spans) == {"train.forward"}
    assert reg.snapshot()["device_spans"] == {}


def test_device_span_attaches_to_the_process_unit_from_another_thread(
        monkeypatch):
    """A device span opened on a thread with no unit of its own (as
    autograd's backward thread is) lands on the unit open in the process,
    resolved when that unit closes; a pair that has not completed by then
    is counted, not waited for."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.log = []
    reg = telemetry.Registry()
    with reg.unit("train_epoch") as rec:
        with reg.device_span("graphormer.bias", "cuda"):
            pass
        t = threading.Thread(target=lambda: [
            reg.device_span("graphormer.attention", "cuda").__enter__()
            .__exit__(None, None, None) for _ in range(2)])
        t.start()
        t.join()
        assert len(rec.pending) == 3 and rec.device == {}
    assert rec.device == {"graphormer.bias": 1.0,
                          "graphormer.attention": 2.0}
    assert rec.pending == [] and rec.device_unresolved == 0
    assert reg.snapshot()["device_spans"]["graphormer.attention"] == {
        "seconds": 2.0, "count": 2}
    # no unit open anywhere: nothing is recorded
    with reg.device_span("graphormer.bias", "cuda"):
        pass
    assert len(_FakeEvent.log) == 6
    _FakeEvent.lagging = True
    try:
        with reg.unit("evaluate") as late:
            with reg.device_span("graphormer.bias", "cuda"):
                pass
    finally:
        _FakeEvent.lagging = False
    assert late.device == {} and late.device_unresolved == 1


def test_snapshot_counts_the_attention_calls():
    """``/health``'s telemetry counts the graph transformer's attention
    calls by path."""
    from mgat_graphsage_torch.ops.biased_attention import biased_attention

    before = telemetry.snapshot()["attention"]
    x = torch.zeros(1, 1, 2, 4)
    mask = torch.ones(1, 2, dtype=torch.bool)
    biased_attention(x, x, x, torch.zeros(1, 1, 2, 2), mask, sdpa=False)
    biased_attention(x, x, x, torch.zeros(1, 1, 2, 2), mask, sdpa=True)
    after = telemetry.snapshot()["attention"]
    assert {k: after[k] - before[k] for k in after} == {"explicit": 1,
                                                        "sdpa": 1}


def test_snapshot_reads_the_wrappers_launch_counters(monkeypatch):
    monkeypatch.setattr(adjacency.dense_adjacency_cuda, "launches", 7)
    launches = telemetry.snapshot()["launches"]
    assert launches["dense_adjacency_cuda"] == 7
    assert {"dy3_cuda", "dy3_cuda_bf16", "cnn_chain_bwd_cuda_bf16",
            "fused_masked_attention_cuda",
            "attention_bwd_cuda"} <= set(launches)


@pytest.mark.parametrize("cpus", [1, 4])
def test_snapshot_counts_the_featuriser_calls(cpus, monkeypatch):
    """Over a call of 10 SMILES and one of 256, ``featurize`` counts two
    calls, 266 molecules, and the rule's workers: 1 for the small call,
    ``min(cpus, 256 // 64)`` for the large one (a parallel call unless
    that is 1)."""
    from mgat_graphsage_torch.chem import native

    monkeypatch.setattr(native, "usable_cpus", lambda: cpus)
    smiles = load_csv(TRAIN_CSV)[0][:256]
    before = telemetry.snapshot()["featurize"]
    for n in (10, 256):
        native.featurize_batch_native(smiles[:n], 35, 80, 176, fp_bits=1024)
    after = telemetry.snapshot()["featurize"]
    assert {k: after[k] - before[k] for k in native.COUNTERS} == {
        "calls": 2, "parallel_calls": int(cpus > 1), "molecules": 266,
        "workers": 1 + min(cpus, 4)}
    json.dumps(after)


READERS = {
    "featurize.native_share.score": ("predict_call", "featurize.native"),
    "predict.upload_share.score": ("predict_call", "predict.upload"),
    "predict.readback_share.score": ("predict_call", "predict.readback"),
    "train.forward_share": ("train_epoch", "train.forward"),
    "train.backward_share": ("train_epoch", "train.backward"),
    "train.optimizer_share": ("train_epoch", "train.optimizer"),
    "train.sync_share": ("train_epoch", "train.sync"),
    "train.eval_readback_share": ("evaluate", "eval.readback"),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_benchmark_reader(name, monkeypatch):
    """Each new reader, through the benchmark's ``Spec``, sums its span
    over the units after the newest profiled one (warm-up first, then the
    traced units, then the untraced ones) over the window; it reads
    nothing when their number is not the driver's count, or in a program
    without the registry."""
    sys.path.insert(0, REPO)
    from portbench.harness.spec import Spec

    kind, span = READERS[name]
    reg = telemetry.Registry()
    monkeypatch.setattr(telemetry, "unprofiled_tail", reg.unprofiled_tail)
    for seconds, profiled in [(9.0, False)] * 2 + [(7.0, True)] * 2 + \
            [(0.5, False)] * 3:
        with reg.unit(kind) as rec:
            rec.profiled = profiled
            rec.spans[span] = seconds
            rec.spans["other"] = 3.0
    score = kind == "predict_call"
    counters = {"window_s": 5.0}
    counters.update({"molecules": 3 * 128} if score else {"epochs": 3})
    r = types.SimpleNamespace(counters=counters, traffic={"chunk": 128},
                              spans={}, traced={}, trace=None)
    read = Spec(REPO).reader(name)
    assert read(r) == pytest.approx(100.0 * 1.5 / 5.0)
    wrong = dict(counters, **({"molecules": 4 * 128} if score
                              else {"epochs": 4}))
    assert read(types.SimpleNamespace(**{**vars(r), "counters": wrong})) \
        is None
    assert read(types.SimpleNamespace(**{**vars(r), "counters": {}})) is None
    # a program without the registry (the parent of this benchmark's
    # readers): the import fails and the reader reads nothing
    monkeypatch.delattr(utils_pkg, "telemetry")
    monkeypatch.setitem(sys.modules, "mgat_graphsage_torch.utils.telemetry",
                        None)
    assert read(r) is None
