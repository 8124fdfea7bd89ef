"""The traffic generator: the same seed gives the same inputs, seeds differ
only in order where a mix fixes a multiset (sizes, gaps), and the mixes'
unparseable and over-budget shares are there."""

import json
import os
import sys
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from portbench.harness import traffic  # noqa: E402
from portbench.reference.featurize import featurize_one  # noqa: E402

SEED = 3_000_000_019   # past 32 signed bits, as the driver's seeds are


def mix(name):
    with open(os.path.join(ROOT, "portbench", "traffic", name + ".json")) as f:
        return json.load(f)


def small(name, **kw):
    return {**mix(name), "pool": 400, **kw}


def test_pool_is_seeded_distinct_and_holds_bad_strings():
    a = traffic.library_pool(small("score"), SEED, 80)
    assert a == traffic.library_pool(small("score"), SEED, 80)
    assert a != traffic.library_pool(small("score"), SEED + 1, 80)
    assert len(a) == len(set(a)) == 400
    rows = [featurize_one(s, 80, 176) for s in a]
    rejected = sum(r is None for r in rows)
    assert 8 <= rejected <= 40     # 1% unparseable + 1% over budget + a few


def test_chunks_reshuffle_each_pass():
    pool = traffic.library_pool(small("score"), SEED, 80)
    it = traffic.score_chunks(pool, 200, SEED)
    first = [next(it) for _ in range(2)]
    second = [next(it) for _ in range(2)]
    assert sorted(sum(first, [])) == sorted(pool) == sorted(sum(second, []))
    assert first != second
    again = traffic.score_chunks(pool, 200, SEED)
    assert [next(again) for _ in range(2)] == first


def test_http_schedule_fixed_by_the_mix():
    """The mix fixes the arrivals and sizes; the seed draws the SMILES."""
    tr = mix("serve_http")
    pool = traffic.library_pool(small("serve_http"), SEED, 80)
    a = traffic.http_schedule(tr, pool, 20.0, SEED)
    b = traffic.http_schedule(tr, pool, 20.0, SEED + 7)
    assert [(t, len(s)) for t, s in a] == [(t, len(s)) for t, s in b]
    assert [s for _, s in a] != [s for _, s in b]


def test_http_schedule_same_multiset_other_order():
    tr = {k: v for k, v in mix("serve_http").items() if k != "schedule_seed"}
    pool = traffic.library_pool(small("serve_http"), SEED, 80)
    a = traffic.http_schedule(tr, pool, 20.0, SEED)
    b = traffic.http_schedule(tr, pool, 20.0, SEED + 7)
    assert a == traffic.http_schedule(tr, pool, 20.0, SEED)
    assert len(a) == len(b) == round(tr["rate"] * 20)
    sizes = [Counter(len(s) for _, s in x) for x in (a, b)]
    assert sizes[0] == sizes[1]
    # the gaps, the last one up to the window's end
    gaps = [np.sort(np.diff([t for t, _ in x] + [20.0])) for x in (a, b)]
    assert [t for t, _ in a] != [t for t, _ in b]
    np.testing.assert_allclose(gaps[0], gaps[1], rtol=0, atol=1e-9)
    assert a[0][0] == 0.0 and a[-1][0] < 20.0
    n = len(a)
    assert sizes[0][1] == round(0.60 * n) + (n - sum(
        round(s * n) for s, _, _ in tr["sizes"]))
    assert max(len(s) for _, s in a) <= 512


def test_seed_for_separates_purposes():
    assert traffic.seed_for(SEED, "weights") != traffic.seed_for(SEED, "pool")
    assert traffic.seed_for(SEED, "pool") == traffic.seed_for(SEED, "pool")
    assert 0 <= traffic.seed_for(SEED, "weights") < 2 ** 63
