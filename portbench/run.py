"""The benchmark of ``mgat_graphsage_torch`` (the PyTorch and CUDA port) on
NVIDIA GPUs.  One process runs one cell of ``BENCHMARK.json`` once:

    python3 portbench/run.py --workload flagship.score --seed 7 \
        --seconds 20 --trace 0

It sets up the program (weights made on the device from the seed, the
cell's inputs from the seed), warms up the shapes the cell uses, measures
for ``--seconds``, checks what the timed path produced against the plain
reference in ``portbench/reference/``, and prints one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, then
``setup`` (seconds by part of set-up) and ``checks`` (each number compared,
with its limit).  The numbers compared are also the last lines of standard
error.  Without as many CUDA devices as the cell asks for, it exits with 3
and prints no result; it exits with 1 and prints no result if the run
loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.harness import runner
    from portbench.harness.spec import Spec

    runner.prepare_env(ROOT)
    try:
        result = runner.run(Spec(ROOT), args.workload, args.seed,
                            args.seconds, bool(args.trace), T_START)
    except runner.NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    line = runner.dumps(result)
    sys.stdout.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
