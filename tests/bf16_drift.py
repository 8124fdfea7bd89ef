"""How far two bf16 training runs part, on the CPU: the measurement behind
the bound of ``test_torch_mixed_precision.py::
test_bf16_two_epochs_match_reference_trainer``.

    JAX_PLATFORMS=cpu python tests/bf16_drift.py [--molecules 96] [--batch 32]

Setting of that test: the ``flagship`` hybrid at full width on the first
``--molecules`` of the bundled train CSV, batch ``--batch``, 2 epochs,
dropout patched out on both sides.  It prints, per epoch:

- the train loss of the port and of the reference ``Trainer`` from the
  same weights, at f32 and at bf16 compute and moments, and their
  relative gaps;
- the port's own bf16 losses after its initial weights are scaled by
  ``1 + 1e-6 * N(0, 1)`` (two draws): how far rounding alone moves a run.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mgat_graphsage_tpu.data import MolecularDataset as JDataset  # noqa: E402
from mgat_graphsage_tpu.train import Trainer as JTrainer  # noqa: E402
from mgat_graphsage_tpu.train import get_config as jget_config  # noqa: E402
from mgat_graphsage_torch.data import (  # noqa: E402
    TRAIN_CSV, MolecularDataset, load_csv)
from mgat_graphsage_torch.models import Dropout, params_from_jax  # noqa: E402
from mgat_graphsage_torch.train import Trainer, get_config  # noqa: E402


class _NoDropout(fnn.Module):
    rate: float = 0.0
    deterministic: bool = True

    @fnn.compact
    def __call__(self, inputs, deterministic=None, rng=None):
        return inputs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--molecules", type=int, default=96)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    fnn.Dropout = _NoDropout
    Dropout.forward = lambda self, x, generator=None: x
    sm, y = load_csv(TRAIN_CSV)
    n = args.molecules
    ds = MolecularDataset(sm[:n], y[:n], fit_scaler=True, verbose=False)
    jds = JDataset(sm[:n], y[:n], fit_scaler=True, fingerprint="ecfp1024",
                   verbose=False)

    def losses(hist):
        return np.array([h["train_loss"] for h in hist])

    for dt in ("float32", "bfloat16"):
        kw = dict(epochs=2, batch_size=args.batch, compute_dtype=dt,
                  adam_moment_dtype=dt)
        jt = JTrainer(jget_config("flagship", **kw), jds)
        jstate = jt.init_state()
        pt = Trainer(get_config("flagship", **kw), ds, device="cpu")
        state = pt.init_state()
        state.model.load_state_dict(
            params_from_jax(jax.device_get(jstate.params)))
        want = losses(jt.fit(state=jstate, verbose=False,
                             save_best=False)[2])
        got = losses(pt.fit(state=state, verbose=False, save_best=False)[2])
        print(f"{dt}: reference {want}, port {got}, rel gap "
              f"{np.abs(got / want - 1)}")

    kw = dict(epochs=2, batch_size=args.batch, compute_dtype="bfloat16",
              adam_moment_dtype="bfloat16")
    runs = []
    for eps in (0.0, 1e-6, 1e-6):
        pt = Trainer(get_config("flagship", **kw), ds, device="cpu")
        state = pt.init_state()
        gen = torch.Generator().manual_seed(len(runs))
        with torch.no_grad():
            for p in state.model.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
        runs.append(losses(pt.fit(state=state, verbose=False,
                                  save_best=False)[2]))
    for i, r in enumerate(runs[1:]):
        print(f"port bf16, initial weights perturbed by 1e-6 (draw {i}): "
              f"{r} against {runs[0]}, rel gap {np.abs(r / runs[0] - 1)}")


if __name__ == "__main__":
    main()
