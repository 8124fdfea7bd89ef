"""On the card, at each cell's own size: the control (the reference one
precision below the configuration's) fails one of the cell's limits, and
the program's own readings pass them.  Skips without a CUDA device; run
on the card with

    python3 -m pytest -q portbench/tests/test_portbench_card.py
"""

import json
import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

CELLS = ["flagship.score", "flagship.train", "flagship_bf16_bs1024_wc.train"]


def limits(cell):
    with open(os.path.join(ROOT, "portbench", "limits", cell + ".json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


@pytest.fixture(scope="module")
def spec():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.harness import runner
    from portbench.harness.spec import Spec

    runner.prepare_env(ROOT)
    return Spec(ROOT)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit_at_the_cells_size(spec, cell):
    from portbench.calibrate import readings

    nums = readings(spec, cell, 8_589_934_609, "control", 1.0, "cuda")
    lim = limits(cell)
    assert any(nums[k] > lim[k] for k in lim if k in nums), nums


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_its_limits(spec, cell):
    from portbench.harness import runner

    res = runner.run(spec, cell, 8_589_934_621, 2.0, False,
                     time.perf_counter())
    assert res["correct"], res["checks"]
