"""The cell ``graphormer_base.train`` on the CPU: its entries are found by
name, its seeded weights are the program's parameters, and the
reference's first steps (``reference/graphormer.py`` through
``drivers/train_graphormer.py::reference_steps``) read the program's at
a tiny size, within f32 round-off; its readers compute their shares from
what they are given and read nothing from a program without device
spans."""

import os
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from portbench.harness import check, flops_graphormer  # noqa: E402
from portbench.harness.drivers import train_graphormer  # noqa: E402
from portbench.harness.drivers.train import _first_steps  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402
from portbench.harness.traffic import seed_for  # noqa: E402
from portbench.harness.weights_graphormer import (  # noqa: E402
    make_weights,
    num_params,
    param_table,
)

CELL = "graphormer_base.train"
METRICS = ["graphormer.mfu.train", "graphormer.attention_share.train",
           "graphormer.bias_share.train",
           "graphormer.attention_roofline.train"]
TINY = {"num_hidden_layers": 2, "hidden_size": 32, "ffn_hidden_size": 32,
        "num_attention_heads": 4, "head_dim": 8}


def test_the_cell_and_its_files_are_found_by_name():
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    conf = spec.config(cell["config"])
    assert cell["chips"] == 1 and conf["preset"] == "graphormer_base"
    assert spec.traffic(cell["traffic"])["driver"] == "train_graphormer"
    assert set(spec.limits(CELL)) == {"loss_gap", "grad_gap", "change_gap"}
    assert [m["name"] for m in spec.end_to_end(CELL)] == [
        "train_mol_per_s", "setup_s"]
    assert [m["name"] for m in spec.per_layer(CELL)] == METRICS
    for name in METRICS:
        assert callable(spec.reader(name))


def test_seeded_weights_are_the_programs_parameters():
    """Names and shapes of the published configuration's weights are the
    program's ``state_dict``'s, 43,988,129 of them; a layer norm starts at
    1 and 0."""
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import get_config

    conf = Spec(ROOT).config("graphormer_base")
    with torch.device("meta"):
        model = build_model(get_config("graphormer_base"))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {n: s for n, s, _, _ in param_table(conf["model"])}
    assert num_params(conf["model"]) == 43988129
    w = make_weights({**conf["model"], **TINY}, 5, "cpu")
    assert torch.equal(w["layers.1.ffn_norm.weight"], torch.ones(32))
    assert float(w["bias.spatial.weight"].abs().max()) \
        <= 0.02 * 3 ** 0.5


@pytest.fixture(scope="module")
def tiny_run():
    """The program's first two steps under ``drivers/train.py``'s spies,
    and the reference's, on 48 bundled molecules at batch 16, widths cut
    to 32, f32 compute, a constant lr."""
    from mgat_graphsage_torch.data import MolecularDataset
    from mgat_graphsage_torch.models import build_model
    from mgat_graphsage_torch.train import Trainer, get_config
    from mgat_graphsage_torch.train.optim import make_optimizer
    from mgat_graphsage_torch.train.trainer import TrainState

    torch.set_num_threads(2)
    spec = Spec(ROOT)
    conf = spec.config("graphormer_base")
    conf = {**conf, "numerics": "f32", "model": {**conf["model"], **TINY},
            "train": {**conf["train"], "batch_size": 16,
                      "eval_batch_size": 16, "lr_schedule": "constant",
                      "lr": 1e-3}}
    seed = 2147483911
    ctx = types.SimpleNamespace(config=conf, seed=seed,
                                traffic={"reference_block": 8},
                                device=torch.device("cpu"))
    smiles, y = check.load_csv("train_data.csv")
    smiles, y = smiles[:48], y[:48]
    cfg = get_config("graphormer_base", seed=seed, n_layers=2,
                     hidden_dim=32, ffn_dim=32, n_heads=4,
                     compute_dtype="float32", batch_size=16,
                     eval_batch_size=16, lr_schedule="constant", lr=1e-3)
    ds = MolecularDataset(smiles, y, fit_scaler=True, fingerprint=None,
                          max_nodes=80, max_edges=176, structure=True,
                          verbose=False)
    w = make_weights(conf["model"], seed_for(seed, "weights"), "cpu")
    model = build_model(cfg)
    model.load_state_dict(w)
    state = TrainState(0, model, make_optimizer(cfg, model))
    trainer = Trainer(cfg, ds, device="cpu")
    remove = _first_steps(trainer, state, w, 2)
    trainer.train_epoch(state, 0)
    got = remove()
    return ctx, smiles, y, got


def test_reference_reads_the_program_at_a_tiny_size(tiny_run):
    """The compared numbers sit at f32 round-off: the losses within 1e-5,
    the worst leaf's gradient and change within 1e-4 (the limits of the
    f32 reference against itself in another order of sums)."""
    ctx, smiles, y, got = tiny_run
    want = train_graphormer.reference_steps(ctx, smiles, y, 2)
    nums = check.train_numbers(got, want)
    assert nums["loss_gap"] < 1e-5, nums
    assert nums["grad_gap"] < 1e-4 and nums["change_gap"] < 1e-4, nums


def test_the_faults_fail_the_reference(tiny_run):
    """Half of each batch left out moves the losses and gradients by far
    more than the program's gap; e4m3 operands move the gradients."""
    ctx, smiles, y, _ = tiny_run
    want = train_graphormer.reference_steps(ctx, smiles, y, 2)
    half = train_graphormer.reference_steps(ctx, smiles, y, 2, fault="half")
    fp8 = train_graphormer.reference_steps(ctx, smiles, y, 2,
                                           round_to="fp8")
    assert check.train_numbers(half, want)["loss_gap"] > 1e-3
    assert check.train_numbers(fp8, want)["grad_gap"] > 1e-3


def test_readers(monkeypatch):
    """The shares read the device spans of the untraced units over the
    window; the roofline divides ``flops_graphormer``'s least time by the
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
                                   "graphormer.bias": 0.1})
    spec = Spec(ROOT)
    conf = spec.config("graphormer_base")
    counters = {"window_s": 10.0, "epochs": 2, "train_rows": 6144,
                "eval_rows": 2048}
    r = types.SimpleNamespace(config=conf, counters=counters)
    read = {m: spec.reader(m) for m in METRICS}
    assert read["graphormer.attention_share.train"](r) == \
        pytest.approx(100.0 * 2.0 / 10.0)
    assert read["graphormer.bias_share.train"](r) == \
        pytest.approx(100.0 * 0.4 / 10.0)
    least = flops_graphormer.attention_least_s(conf["model"], 80, "bf16",
                                               6144, 2048)
    assert read["graphormer.attention_roofline.train"](r) == \
        pytest.approx(100.0 * least / 2.0)
    per_row = flops_graphormer.forward_flops_per_row(conf["model"], 80)
    assert per_row == 7127053824
    assert read["graphormer.mfu.train"](r) == pytest.approx(
        100.0 * per_row * (3 * 6144 + 2048) / 10.0 / 989e12)
    wrong = types.SimpleNamespace(config=conf,
                                  counters={**counters, "epochs": 3})
    assert read["graphormer.attention_share.train"](wrong) is None
    reg2 = telemetry.Registry()
    monkeypatch.setattr(telemetry, "unprofiled_tail", reg2.unprofiled_tail)
    for kind in ("train_epoch", "evaluate"):
        for _ in range(2):
            with reg2.unit(kind):
                pass
    for name in METRICS[1:]:
        assert read[name](r) is None, name
    assert np.isfinite(read["graphormer.mfu.train"](r))
