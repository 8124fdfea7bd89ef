"""The benchmark's one traffic generator: it reads a mix's parameters
(``portbench/traffic/<mix>.json``) and the run's seed, and makes the
inputs the program is given.  Nothing here reads the program.

The molecules are drug-like SMILES assembled from fragment templates, a
frozen copy of the template assembly of
``mgat_graphsage_torch/data/synth.py`` at commit 157b929 (scaffolds with
substitution sites, terminal groups, linkers, ring-label shifting), with
no parse: a string that does not parse, or whose graph exceeds the
model's budget, is part of the traffic and must come back as NaN.  A mix
adds such strings on purpose at fixed shares (``invalid_share``,
``oversize_share``).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np

_SCAFFOLDS_1 = [
    "c1ccc({0})cc1", "c1ccc2c(c1)cccc2{0}", "c1ccnc({0})c1",
    "c1cnc({0})cn1", "c1cc({0})[nH]c1", "c1cc({0})oc1", "c1cc({0})sc1",
    "c1nc({0})[nH]n1", "C1CCN({0})CC1", "C1CN({0})CCN1C", "C1CCC({0})CC1",
    "c1ccc2[nH]c({0})nc2c1", "c1ccc2oc({0})nc2c1",
    "N1C(=O)NC(=O)c2cc({0})ccc21",
]
_SCAFFOLDS_2 = [
    "c1cc({0})ccc1{1}", "c1cc({0})cc({1})c1", "c1nc({0})cc({1})n1",
    "c1cc({0})c({1})cc1F", "C1CC({0})CCC1{1}", "c1c({0})sc({1})c1",
]
_TERMINALS = [
    "C", "CC", "CCC", "C(C)C", "O", "OC", "N", "NC", "N(C)C", "F", "Cl",
    "Br", "C(=O)O", "C(=O)N", "C(=O)OC", "C#N", "S(=O)(=O)N", "S(=O)(=O)C",
    "C(F)(F)F", "OC(F)(F)F", "C=C", "C#C", "CO", "CN", "CCl", "C(=O)C",
    "NC(=O)C", "OCC", "CCO", "N1CCCC1", "N1CCOCC1",
]
_LINKERS = [
    "C{0}", "CC{0}", "CCC{0}", "O{0}", "OC{0}", "N{0}", "NC(=O){0}",
    "C(=O)N{0}", "C(=O){0}", "S{0}", "C=C{0}", "OCC{0}", "NC{0}", "CN{0}",
]
# strings that do not parse (an open ring, a bad bracket, an open branch)
_INVALID = ["C1CC(", "c1ccc(cc1", "C[Xx]C", "CC(=O", "C1CCC"]


def seed_for(seed: int, purpose: str) -> int:
    """A sub-seed of the run's seed for one purpose (weights, pool, ...)."""
    tag = int.from_bytes(purpose.encode()[:8].ljust(8, b"\0"), "little")
    return int(np.random.SeedSequence([int(seed), tag])
               .generate_state(2, np.uint64)[0] >> 1)


def _shift_ring_labels(smi: str, start: int = 3) -> str:
    out: List[str] = []
    mapping: Dict[int, int] = {}
    nxt = start
    i = 0
    while i < len(smi):
        c = smi[i]
        if c == "[":
            j = smi.find("]", i)
            out.append(smi[i:j + 1])
            i = j + 1
            continue
        if c == "%":
            lab = int(smi[i + 1:i + 3])
            i += 3
        elif c.isdigit():
            lab = int(c)
            i += 1
        else:
            out.append(c)
            i += 1
            continue
        if lab not in mapping:
            mapping[lab] = nxt
            nxt += 1
        nl = mapping[lab]
        out.append(str(nl) if nl < 10 else f"%{nl:02d}")
    return "".join(out)


def _random_group(rng: np.random.Generator, depth: int = 0) -> str:
    if depth >= 2 or rng.random() < 0.55:
        return str(rng.choice(_TERMINALS))
    return str(rng.choice(_LINKERS)).format(_random_scaffold(rng, depth + 1))


def _random_scaffold(rng: np.random.Generator, depth: int = 0) -> str:
    if rng.random() < 0.75 or depth > 0:
        return str(rng.choice(_SCAFFOLDS_1)).format(
            _shift_ring_labels(_random_group(rng, depth)))
    return str(rng.choice(_SCAFFOLDS_2)).format(
        _shift_ring_labels(_random_group(rng, depth)),
        _shift_ring_labels(_random_group(rng, depth)))


def _molecule(rng: np.random.Generator) -> str:
    smi = _random_scaffold(rng)
    for _ in range(int(rng.integers(0, 3))):
        linker = str(rng.choice(_LINKERS)).format(_shift_ring_labels(smi))
        smi = str(rng.choice(_SCAFFOLDS_1)).format(linker)
    return smi


def _oversize(rng: np.random.Generator, atoms: int) -> str:
    """A chain of more than ``atoms`` atoms with a ring at one end."""
    n = atoms + 1 + int(rng.integers(0, 24))
    return "c1ccccc1" + "C" * (n - 6)


def library_pool(params: Dict, seed: int, max_atoms: int) -> List[str]:
    """``params["pool"]`` distinct SMILES: template molecules, with
    ``invalid_share`` unparseable strings and ``oversize_share`` chains past
    ``max_atoms`` atoms mixed in at seeded positions."""
    rng = np.random.default_rng(seed_for(seed, "pool"))
    n = int(params["pool"])
    n_bad = int(round(n * params.get("invalid_share", 0.0)))
    n_big = int(round(n * params.get("oversize_share", 0.0)))
    seen, pool = set(), []
    while len(pool) < n - n_bad - n_big:
        smi = _molecule(rng)
        if smi not in seen:
            seen.add(smi)
            pool.append(smi)
    # unparseable strings made distinct by a prefix that parses
    pool += [("C" * (1 + i // len(_INVALID))) + _INVALID[i % len(_INVALID)]
             for i in range(n_bad)]
    pool += [_oversize(rng, max_atoms) + "O" * (i + 1)
             for i in range(n_big)]
    return [pool[i] for i in rng.permutation(len(pool))]


def score_chunks(pool: List[str], chunk: int, seed: int
                 ) -> Iterator[List[str]]:
    """Chunks of ``chunk`` SMILES, the pool reshuffled at each pass."""
    rng = np.random.default_rng(seed_for(seed, "chunks"))
    while True:
        order = rng.permutation(len(pool))
        for s in range(0, len(order) - chunk + 1, chunk):
            yield [pool[i] for i in order[s:s + chunk]]


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def request_sizes(params: Dict, n: int, seed: int) -> np.ndarray:
    """``n`` request sizes: the mix's quantiles, the same multiset for every
    seed, in an order drawn from ``seed``.  ``params["sizes"]`` is a list
    of ``[share, lo, hi]``, log-uniform from lo to hi inclusive."""
    sizes: List[int] = []
    bands = params["sizes"]
    counts = [int(round(share * n)) for share, _, _ in bands]
    counts[0] += n - sum(counts)
    for (share, lo, hi), k in zip(bands, counts):
        if lo == hi:
            sizes += [int(lo)] * k
            continue
        u = _quantiles(k)
        sizes += [int(math.floor(math.exp(math.log(lo) + x * (
            math.log(hi + 1) - math.log(lo))))) for x in u]
    rng = np.random.default_rng(seed_for(seed, "sizes"))
    return np.minimum(np.asarray(sizes, np.int64)[rng.permutation(n)],
                      max(hi for _, _, hi in bands))


def http_schedule(params: Dict, pool: List[str], seconds: float, seed: int
                  ) -> List[Tuple[float, List[str]]]:
    """Open-loop requests ``(due offset in s, SMILES)`` over ``seconds``
    at ``params["rate"]`` a second, Poisson: the same multiset of gaps
    (exponential quantiles) and of sizes for every seed.  Their order is
    drawn from ``params["schedule_seed"]`` where the mix fixes one (every
    run then offers the same arrivals, which under load set the tail),
    else from ``seed``; the SMILES are drawn from the pool by ``seed``."""
    rate = float(params["rate"])
    n = max(int(round(rate * seconds)), 1)
    order = int(params.get("schedule_seed", seed))
    gaps = -np.log1p(-_quantiles(n)) / rate
    rng = np.random.default_rng(seed_for(order, "gaps"))
    gaps = gaps[rng.permutation(n)] * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    sizes = request_sizes(params, n, order)
    pick = np.random.default_rng(seed_for(seed, "picks"))
    return [(float(t), [pool[i] for i in pick.integers(0, len(pool), k)])
            for t, k in zip(due, sizes)]
