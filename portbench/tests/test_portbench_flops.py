"""The yardstick's arithmetic: the FLOP count against a hand sum of the
flagship's layer shapes, and ``bound`` against the least times of kernels
1-3 in PERF.md's kernel table (``chip_smoke.py``'s counts)."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from portbench.harness import flops, weights  # noqa: E402


def model():
    path = os.path.join(ROOT, "portbench", "configs", "flagship.json")
    with open(path) as f:
        return json.load(f)["model"]


def test_forward_flops_by_hand():
    n, f = 80, 35
    by_hand = (
        2 * n * f * f * 3          # query, key, value
        + 2 * n * f * f * 2        # conv3, conv5 centre taps
        + 2 * n * 105 * 35         # linear_transform 105 -> 35
        + 2 * n * n * f * 2        # K Q^T, attn V
        + 2 * n * n * f            # adj @ x
        + 2 * n * f * f * 2        # lin_l, lin_r
        + 2 * 35 * 1500 + 2 * 1500 * 128 + 2 * 128   # fc_g1, fc_g2, out
        + 2 * 1024 * 3 * (1 * 32 + 32 * 64 + 64 * 128)  # three convs
        + 2 * 131072 * 256 + 2 * 256 * 1024            # cnn fc1, fc2
        + 2 * 1025 * 512 + 2 * 512)                    # head
    assert flops.forward_flops_per_row(model(), n) == by_hand == 135_588_200


@pytest.mark.parametrize("work, args, ms, by", [
    (flops.adjacency_work, (64, 80, 176), 0.53e-3, "bytes"),
    (flops.adjacency_work, (128, 80, 176), 1.06e-3, "bytes"),
    (flops.adjacency_work, (32, 80, 176), 0.26e-3, "bytes"),
    (flops.attention_fwd_work, (64, 80, 35), 0.89e-3, "operations"),
    (flops.attention_fwd_work, (128, 80, 35), 1.77e-3, "operations"),
    (flops.attention_bwd_work, (128, 80, 35), 4.28e-3, "operations"),
])
def test_bound_matches_the_kernel_table(work, args, ms, by):
    got, which = flops.bound(*work(*args))
    assert which == by
    assert got == pytest.approx(ms, abs=0.005e-3)


def test_peaks_and_parameter_count():
    assert flops.PEAK_FLOPS == {"float32": 67e12, "bfloat16": 989e12}
    assert flops.HBM_BYTES_PER_S == 3.35e12
    assert weights.num_params(model()) == 34_640_823


def test_kernel_bound_sums_batches():
    one = flops.kernel_bound_s("adjacency", {64: 1}, 80, 176, 35)
    assert flops.kernel_bound_s("adjacency", {64: 3, 128: 0}, 80, 176, 35) \
        == pytest.approx(3 * one)
