"""The cell ``egt_110m.train`` on the CPU: its entries are found by name,
its per-layer metrics are the generic training ones and its own four, its
seeded weights are the program's parameters, the reference's first steps
(``reference/egt.py`` through ``drivers/train_egt.py::reference_steps``,
in blocks) read the program's at a tiny size within f32 round-off, and a
program with a fault (the clip at 0.1, the scaler on the virtual nodes
too, gates open on padded keys, the SVD encodings one column off) parts
from them by far more (the seeded weights' logits stay well inside the
clip of 5, so a program without the clip would not part: its edges are
held in ``tests/test_torch_egt.py``); ``flops_egt`` counts a small case by hand; the readers compute
their shares from what they are given and read nothing from a program
without device spans."""

import os
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from portbench.harness import check, flops_egt  # noqa: E402
from portbench.harness.drivers import train_egt, train_gps  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402
from portbench.harness.traffic import seed_for  # noqa: E402
from portbench.harness.weights_egt import (  # noqa: E402
    make_weights,
    num_params,
    param_table,
)

CELL = "egt_110m.train"
# the training cells' step breakdown and idle share, then the cell's own
SHARED = ["train.eval_share", "device.idle.train", "train.forward_share",
          "train.backward_share", "train.optimizer_share",
          "train.sync_share", "train.eval_readback_share"]
METRICS = ["egt.mfu.train", "egt.attention_share.train",
           "egt.pair_share.train", "egt.attention_roofline.train"]
TINY = {"num_hidden_layers": 2, "hidden_size": 16, "ffn_hidden_size": 16,
        "num_attention_heads": 4, "head_dim": 4, "pair_size": 8,
        "pair_ffn_size": 8}
SEED = 2147483911


def test_the_cell_and_its_files_are_found_by_name():
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    conf = spec.config(cell["config"])
    assert cell["chips"] == 1 and conf["preset"] == "egt_110m"
    assert spec.traffic(cell["traffic"])["driver"] == "train_egt"
    assert set(spec.limits(CELL)) == {"loss_gap", "grad_gap", "change_gap",
                                    "grad_l2_gap"}
    assert [m["name"] for m in spec.end_to_end(CELL)] == [
        "train_mol_per_s", "setup_s"]
    assert [m["name"] for m in spec.per_layer(CELL)] == SHARED + METRICS
    for name in SHARED + METRICS:
        assert callable(spec.reader(name))


def test_seeded_weights_are_the_programs_parameters():
    """Names and shapes of the published configuration's weights are the
    program's ``state_dict``'s, 109,831,233 parameters, the last layer
    without a pair update; a layer norm starts at 1 and 0, a table within
    ``sqrt(3)``."""
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import get_config

    conf = Spec(ROOT).config("egt_110m")
    with torch.device("meta"):
        model = build_model(get_config("egt_110m"))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {n: s for n, s, _, _ in param_table(conf["model"])}
    assert num_params(conf["model"]) == 109831233 \
        == conf["parameters"]["here"]
    assert "layers.29.pair_out.weight" not in shapes
    w = make_weights({**conf["model"], **TINY}, 5, "cpu")
    assert torch.equal(w["layers.1.ffn_norm.weight"], torch.ones(16))
    assert torch.equal(w["layers.0.pair_norm.bias"], torch.zeros(8))
    assert float(w["distance.weight"].abs().max()) <= 3 ** 0.5


def _tiny_setup():
    spec = Spec(ROOT)
    conf = spec.config("egt_110m")
    conf = {**conf, "numerics": "f32", "model": {**conf["model"], **TINY},
            "train": {**conf["train"], "batch_size": 16,
                      "eval_batch_size": 16, "lr_schedule": "constant",
                      "lr": 1e-3}}
    ctx = types.SimpleNamespace(config=conf, seed=SEED,
                                traffic={"reference_block": 5},
                                device=torch.device("cpu"))
    smiles, y = check.load_csv("train_data.csv")
    return ctx, smiles[:48], y[:48]


def _program(ctx, smiles, y):
    """The program's first two steps under ``drivers/train_gps.py``'s
    spies, on 48 bundled molecules at batch 16, widths cut to the tiny
    ones, f32 compute, a constant lr."""
    from mgat_graphsage_torch.data import MolecularDataset
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import Trainer, get_config
    from mgat_graphsage_torch.train.optim import make_optimizer
    from mgat_graphsage_torch.train.trainer import TrainState

    cfg = get_config("egt_110m", seed=SEED, n_layers=2, hidden_dim=16,
                     ffn_dim=16, n_heads=4, pair_dim=8,
                     compute_dtype="float32", batch_size=16,
                     eval_batch_size=16, lr_schedule="constant", lr=1e-3)
    ds = MolecularDataset(smiles, y, fit_scaler=True, fingerprint=None,
                          max_nodes=80, max_edges=176,
                          structure="paths_svd", verbose=False)
    w = make_weights(ctx.config["model"], seed_for(SEED, "weights"), "cpu")
    model = build_model(cfg)
    model.load_state_dict(w)
    state = TrainState(0, model, make_optimizer(cfg, model))
    trainer = Trainer(cfg, ds, device="cpu")
    remove = train_gps._first_steps(trainer, state, w, 2)
    trainer.train_epoch(state, 0)
    return remove()


@pytest.fixture(scope="module")
def tiny_run():
    torch.set_num_threads(2)
    ctx, smiles, y = _tiny_setup()
    want = train_egt.reference_steps(ctx, smiles, y, 2)
    return ctx, smiles, y, want


def test_reference_reads_the_program_at_a_tiny_size(tiny_run):
    """The compared numbers sit at f32 round-off: the losses within 1e-5,
    the gradients within 1e-4 and the change within 1e-3 (Adam moves an
    element by ``lr g / (|g| + 1e-8)``), the reference in blocks of 5
    molecules padded to each block's own largest."""
    ctx, smiles, y, want = tiny_run
    nums = train_egt.numbers(_program(ctx, smiles, y), want)
    assert nums["loss_gap"] < 1e-5, nums
    assert nums["grad_gap"] < 1e-4 and nums["change_gap"] < 1e-3, nums
    assert nums["grad_l2_gap"] < 1e-4, nums


def _fault(monkeypatch, kind):
    from mgat_graphsage_torch.data import dataset
    from mgat_graphsage_torch.models import layers

    orig = layers.gated_attention
    if kind == "clip_at_0.1":
        monkeypatch.setattr(layers, "gated_attention",
                            lambda *a, **kw: orig(*a, **{**kw, "clip": 0.1}))
    elif kind == "scaler_on_virtual":
        monkeypatch.setattr(layers, "gated_attention",
                            lambda *a, **kw: orig(*a, **{**kw, "fixed": 0}))
    elif kind == "padded_keys":
        def attention(q, k, v, bias, gate, key_mask, *a, **kw):
            return orig(q, k, v, bias, gate, torch.ones_like(key_mask), *a,
                        **kw)

        monkeypatch.setattr(layers, "gated_attention", attention)
    else:
        svd = dataset.svd_encoding
        monkeypatch.setattr(dataset, "svd_encoding", lambda n, e: np.roll(
            svd(n, e), 1, axis=1))


@pytest.mark.parametrize("kind", ["clip_at_0.1", "scaler_on_virtual",
                                  "padded_keys", "svd_column"])
def test_the_faults_fail_the_reference(tiny_run, monkeypatch, kind):
    """A program that clips the logits at 0.1 in place of 5, with the
    degree scaler on the virtual nodes too, attending to padded atoms, or
    with the SVD encodings one column off parts from the reference by far
    more than the program's own gap: its first loss or its gradients by
    1e-3 or more."""
    ctx, smiles, y, want = tiny_run
    _fault(monkeypatch, kind)
    nums = train_egt.numbers(_program(ctx, smiles, y), want)
    assert max(nums["loss_gap"], nums["grad_gap"]) > 1e-3, nums


def test_the_controls_fail_the_reference(tiny_run):
    """Half of each batch left out moves the losses and the gradients by
    far more than the program's gap; e4m3 operands move the gradients'
    elements."""
    ctx, smiles, y, want = tiny_run
    half = train_egt.numbers(train_egt.reference_steps(
        ctx, smiles, y, 2, fault="half"), want)
    fp8 = train_egt.numbers(train_egt.reference_steps(
        ctx, smiles, y, 2, round_to="fp8"), want)
    assert half["loss_gap"] > 1e-3 and half["grad_l2_gap"] > 1e-2, half
    assert fp8["grad_gap"] > 1e-3 and fp8["grad_l2_gap"] > 1e-2, fp8


def test_flops_egt_counts_a_small_case_by_hand():
    """Width 4, pair width 2, 2 heads, FFNs 4 and 2, one virtual node, 2
    layers, 3 features, SVD rank 1, 2 atom slots: N = 3, 9 pair slots.  A
    layer: projections 4*2*3*4*4 = 384, node FFN 2*2*3*4*4 = 192, the
    attention's products 2*2*9*4 = 144, E and G 2*2*9*2*2 = 144, 864; the
    pair update 2*9*2*2 + 2*2*9*2*2 = 216 in the first layer only; the
    encoders 2*2*(3+2)*4 = 80; the head 2*(4*4 + 4*4 + 4) = 72: 2,096.
    The attention's tensors 3*3*4 + 2*2*9 + 3*4 (+ 2*9 for H^) = 84 (102)
    elements: a training row 2*2*102 + 18 = 426 bytes and 12*9*4 = 432
    operations, 354 bytes without H^, an evaluated one 204 bytes and 144
    operations."""
    model = {"hidden_size": 4, "pair_size": 2, "num_attention_heads": 2,
             "ffn_hidden_size": 4, "pair_ffn_size": 2, "virtual_nodes": 1,
             "num_hidden_layers": 2, "in_features": 3, "svd_rank": 1}
    assert flops_egt.forward_flops_per_row(model, 2) == 2096
    work = flops_egt.attention_work_per_row
    assert work(model, 2, "bf16", True) == (426, 432)
    assert work(model, 2, "bf16", True, pair_update=False) == (354, 432)
    assert work(model, 2, "bf16", False) == (204, 144)
    least = flops_egt.attention_least_s(model, 2, "bf16", 10, 3)
    bw = flops_egt.HBM_BYTES_PER_S
    assert least == pytest.approx((10 * 426 + 3 * 204 + 10 * 354 + 3 * 168)
                                  / bw)


def test_readers(monkeypatch):
    """The shares read the device spans of the untraced units over the
    window; the roofline divides ``flops_egt``'s least time by the
    attention's span; nothing without device spans or with a unit count
    other than the window's count."""
    from mgat_graphsage_torch.utils import telemetry

    reg = telemetry.Registry()
    monkeypatch.setattr(telemetry, "unprofiled_tail", reg.unprofiled_tail)
    for kind in ("train_epoch", "evaluate"):
        for profiled in (True, False, False):
            with reg.unit(kind) as rec:
                rec.profiled = profiled
                rec.device.update({"egt.attention": 0.5, "egt.pair": 0.75})
    spec = Spec(ROOT)
    conf = spec.config("egt_110m")
    counters = {"window_s": 10.0, "epochs": 2, "train_rows": 6144,
                "eval_rows": 1024}
    r = types.SimpleNamespace(config=conf, counters=counters)
    read = {m: spec.reader(m) for m in METRICS}
    assert read["egt.attention_share.train"](r) == \
        pytest.approx(100.0 * 2.0 / 10.0)
    assert read["egt.pair_share.train"](r) == \
        pytest.approx(100.0 * 3.0 / 10.0)
    least = flops_egt.attention_least_s(conf["model"], 80, "bf16", 6144,
                                        1024)
    assert read["egt.attention_roofline.train"](r) == \
        pytest.approx(100.0 * least / 2.0)
    per_row = flops_egt.forward_flops_per_row(conf["model"], 80)
    assert read["egt.mfu.train"](r) == pytest.approx(
        100.0 * per_row * (3 * 6144 + 1024) / 10.0 / 989e12)
    # a training row's attention: q, k, v, E, G, H^ and out with their
    # gradients at 2 bytes, the keep-mask at 1; memory sets its least time
    n = 84
    nbytes, ops = flops_egt.attention_work_per_row(conf["model"], 80, "bf16",
                                                   True)
    assert nbytes == 2 * 2 * (4 * n * 768 + 3 * 32 * n * n) + 32 * n * n
    assert ops == 12 * n * n * 768
    assert nbytes / flops_egt.HBM_BYTES_PER_S > ops / 989e12
    wrong = types.SimpleNamespace(config=conf,
                                  counters={**counters, "epochs": 3})
    assert read["egt.pair_share.train"](wrong) is None
    reg2 = telemetry.Registry()
    monkeypatch.setattr(telemetry, "unprofiled_tail", reg2.unprofiled_tail)
    for kind in ("train_epoch", "evaluate"):
        for _ in range(2):
            with reg2.unit(kind):
                pass
    for name in METRICS[1:]:
        assert read[name](r) is None, name
    assert np.isfinite(read["egt.mfu.train"](r))
