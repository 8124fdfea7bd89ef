"""The cell ``graphgps_medium.train`` on the CPU: its entries are found by
name, its seeded weights are the program's parameters and running
statistics, the reference's first steps (``reference/gps.py`` through
``drivers/train_gps.py::reference_steps``) read the program's at a tiny
size within f32 round-off, and a program with a fault (padded edges in
the edge norm or in the gated sum, a bias slipped into the attention that
has none, the random-walk encoding one step off) parts from them by far
more; its readers compute their shares from what they are given and read
nothing from a program without device spans."""

import os
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from portbench.harness import check, flops_gps  # noqa: E402
from portbench.harness.drivers import train_gps  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402
from portbench.harness.traffic import seed_for  # noqa: E402
from portbench.harness.weights_gps import (  # noqa: E402
    make_weights,
    num_params,
    param_table,
)

CELL = "graphgps_medium.train"
# the cell's metrics: the training cells' step breakdown and idle share,
# Graphormer's attention share (the same span), and the cell's own three
SHARED = ["train.eval_share", "device.idle.train", "train.forward_share",
          "train.backward_share", "train.optimizer_share",
          "train.sync_share", "train.eval_readback_share",
          "graphormer.attention_share.train"]
METRICS = ["gps.mfu.train", "gps.message_share.train",
           "gps.attention_roofline.train"]
TINY = {"num_hidden_layers": 2, "hidden_size": 32, "ffn_hidden_size": 32,
        "num_attention_heads": 2, "head_dim": 16}
SEED = 2147483911


def test_the_cell_and_its_files_are_found_by_name():
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    conf = spec.config(cell["config"])
    assert cell["chips"] == 1 and conf["preset"] == "graphgps_medium"
    assert spec.traffic(cell["traffic"])["driver"] == "train_gps"
    assert set(spec.limits(CELL)) == {"loss_gap", "grad_gap", "change_gap",
                                    "grad_l2_gap"}
    assert [m["name"] for m in spec.end_to_end(CELL)] == [
        "train_mol_per_s", "setup_s"]
    assert [m["name"] for m in spec.per_layer(CELL)] == SHARED + METRICS
    for name in SHARED + METRICS:
        assert callable(spec.reader(name))


def test_seeded_weights_are_the_programs_parameters():
    """Names and shapes of the published configuration's weights are the
    program's ``state_dict``'s, running statistics included, 19,360,953
    parameters; a batch norm starts at 1 and 0, its statistics at 0 and
    1."""
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import get_config

    conf = Spec(ROOT).config("graphgps_medium")
    with torch.device("meta"):
        model = build_model(get_config("graphgps_medium"))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {n: s for n, s, _, _ in param_table(conf["model"])}
    assert num_params(conf["model"]) == 19360953 \
        == conf["parameters"]["here"]
    w = make_weights({**conf["model"], **TINY}, 5, "cpu")
    assert torch.equal(w["layers.1.norm2.scale"], torch.ones(32))
    assert torch.equal(w["layers.1.norm2.var"], torch.ones(32))
    assert torch.equal(w["rwse_norm.mean"], torch.zeros(16))
    assert float(w["bond_encoder.weight"].abs().max()) <= 0.02 * 3 ** 0.5


def _tiny_setup():
    spec = Spec(ROOT)
    conf = spec.config("graphgps_medium")
    conf = {**conf, "numerics": "f32", "model": {**conf["model"], **TINY},
            "train": {**conf["train"], "batch_size": 16,
                      "eval_batch_size": 16, "lr_schedule": "constant",
                      "lr": 1e-3}}
    ctx = types.SimpleNamespace(config=conf, seed=SEED, traffic={},
                                device=torch.device("cpu"))
    smiles, y = check.load_csv("train_data.csv")
    return ctx, smiles[:48], y[:48]


def _program(ctx, smiles, y):
    """The program's first two steps under ``drivers/train_gps.py``'s
    spies, on 48 bundled molecules at batch 16, widths cut to 32, f32
    compute, a constant lr."""
    from mgat_graphsage_torch.data import MolecularDataset
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import Trainer, get_config
    from mgat_graphsage_torch.train.optim import make_optimizer
    from mgat_graphsage_torch.train.trainer import TrainState

    cfg = get_config("graphgps_medium", seed=SEED, n_layers=2,
                     hidden_dim=32, ffn_dim=32, n_heads=2,
                     compute_dtype="float32", batch_size=16,
                     eval_batch_size=16, lr_schedule="constant", lr=1e-3)
    ds = MolecularDataset(smiles, y, fit_scaler=True, fingerprint=None,
                          max_nodes=80, max_edges=176, structure="edges",
                          verbose=False)
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
    want = train_gps.reference_steps(ctx, smiles, y, 2)
    return ctx, smiles, y, want


def test_reference_reads_the_program_at_a_tiny_size(tiny_run):
    """The compared numbers sit at f32 round-off: the losses within 1e-5,
    the gradients' elements and the worst leaf's gradient within 1e-4 and its change within 1e-3 (at step 1 of the
    warm-up Adam moves an element by ``lr g / (|g| + 1e-8)``, and a leaf's
    elements near 1e-8 move by other shares)."""
    ctx, smiles, y, want = tiny_run
    nums = train_gps.numbers(_program(ctx, smiles, y), want)
    assert nums["loss_gap"] < 1e-5, nums
    assert nums["grad_gap"] < 1e-4 and nums["change_gap"] < 1e-3, nums
    assert nums["grad_l2_gap"] < 1e-4, nums


def _fault(monkeypatch, kind):
    from mgat_graphsage_torch.data import dataset
    from mgat_graphsage_torch.models import layers

    if kind == "edge_norm":
        orig = layers.GatedGCNLayer.forward

        def forward(self, h, e, edges, node_mask, edge_mask, generator=None):
            bn = self.bn_edge_e
            bn.forward = lambda x, m, f=type(bn).forward: f(
                bn, x, torch.ones_like(m))
            return orig(self, h, e, edges, node_mask, edge_mask, generator)

        monkeypatch.setattr(layers.GatedGCNLayer, "forward", forward)
    elif kind == "edge_sum":
        orig = layers.gated_message
        monkeypatch.setattr(layers, "gated_message", lambda *a: orig(
            *a[:5], torch.ones_like(a[5])))
    elif kind == "attention_bias":
        orig = layers.biased_attention

        def attention(q, k, v, bias, key_mask, keep, p):
            b, h, n, _ = q.shape
            bias = torch.randn(b, h, n, n,
                               generator=torch.Generator().manual_seed(0))
            return orig(q, k, v, bias, key_mask, keep, p)

        monkeypatch.setattr(layers, "biased_attention", attention)
    else:
        orig = dataset.random_walk_se
        monkeypatch.setattr(dataset, "random_walk_se", lambda n, e: np.roll(
            orig(n, e), 1, axis=1))


@pytest.mark.parametrize("kind", ["edge_norm", "edge_sum",
                                  "attention_bias", "rwse_step"])
def test_the_faults_fail_the_reference(tiny_run, monkeypatch, kind):
    """A program with padded edges in the edge norm's statistics or in the
    gated sums, a random bias in its attention, or its random-walk
    encoding one step off parts from the reference by far more than the
    program's own gap: its first loss or its gradients by 1e-3 or more."""
    ctx, smiles, y, want = tiny_run
    _fault(monkeypatch, kind)
    nums = train_gps.numbers(_program(ctx, smiles, y), want)
    assert max(nums["loss_gap"], nums["grad_gap"]) > 1e-3, nums


def test_the_controls_fail_the_reference(tiny_run):
    """Half of each batch left out moves the losses and the gradients by
    far more than the program's gap; e4m3 operands move the gradients'
    elements (by a tenth at this size)."""
    ctx, smiles, y, want = tiny_run
    half = train_gps.numbers(train_gps.reference_steps(
        ctx, smiles, y, 2, fault="half"), want)
    fp8 = train_gps.numbers(train_gps.reference_steps(
        ctx, smiles, y, 2, round_to="fp8"), want)
    assert half["loss_gap"] > 1e-3 and half["grad_l2_gap"] > 1e-2, half
    assert fp8["grad_gap"] > 1e-3 and fp8["grad_l2_gap"] > 1e-2, fp8


def test_readers(monkeypatch):
    """The shares read the device spans of the untraced units over the
    window; the roofline divides ``flops_gps``'s least time by the
    attention's span; nothing without device spans or with a unit count
    other than the window's count."""
    from mgat_graphsage_torch.utils import telemetry

    reg = telemetry.Registry()
    monkeypatch.setattr(telemetry, "unprofiled_tail", reg.unprofiled_tail)
    for kind in ("train_epoch", "evaluate"):
        for profiled in (True, False, False):
            with reg.unit(kind) as rec:
                rec.profiled = profiled
                rec.device.update({"graphormer.attention": 0.5,
                                   "gps.message": 0.75})
    spec = Spec(ROOT)
    conf = spec.config("graphgps_medium")
    counters = {"window_s": 10.0, "epochs": 2, "train_rows": 6144,
                "eval_rows": 2048}
    r = types.SimpleNamespace(config=conf, counters=counters)
    read = {m: spec.reader(m) for m in METRICS
            + ["graphormer.attention_share.train"]}
    assert read["graphormer.attention_share.train"](r) == \
        pytest.approx(100.0 * 2.0 / 10.0)
    assert read["gps.message_share.train"](r) == \
        pytest.approx(100.0 * 3.0 / 10.0)
    least = flops_gps.attention_least_s(conf["model"], 80, "bf16", 6144,
                                        2048)
    assert read["gps.attention_roofline.train"](r) == \
        pytest.approx(100.0 * least / 2.0)
    per_row = flops_gps.forward_flops_per_row(conf["model"], 80, 176)
    assert per_row == 3450778432
    assert read["gps.mfu.train"](r) == pytest.approx(
        100.0 * per_row * (3 * 6144 + 2048) / 10.0 / 989e12)
    # the bias-free attention's bytes: q, k, v, out (and their gradients)
    # at 2 bytes, the keep-mask at 1 in training, no bias
    fwd = flops_gps.attention_work_per_row(conf["model"], 80, "bf16", False)
    assert fwd == (4 * 80 * 384 * 2 + 16 * 80 * 80, 4 * 80 * 80 * 384)
    wrong = types.SimpleNamespace(config=conf,
                                  counters={**counters, "epochs": 3})
    assert read["gps.message_share.train"](wrong) is None
    reg2 = telemetry.Registry()
    monkeypatch.setattr(telemetry, "unprofiled_tail", reg2.unprofiled_tail)
    for kind in ("train_epoch", "evaluate"):
        for _ in range(2):
            with reg2.unit(kind):
                pass
    for name in METRICS[1:] + ["graphormer.attention_share.train"]:
        assert read[name](r) is None, name
    assert np.isfinite(read["gps.mfu.train"](r))
