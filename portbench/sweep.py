"""The rate sweep that fixes a serving mix's rate, on the chip, one process:

    python3 portbench/sweep.py --workload flagship.serve_http \
        --rates 50,100,200 --seconds 20 [--seed 5] [--out FILE]

For each rate (the i-th with seed ``--seed`` + i) it runs the cell with
the mix's rate set to it, in this process, and prints
one JSON line: the rate, the p95 and the p50 of request latency, the
client's lateness, the molecules a dispatch, the failed requests.  Where
latency grows through the window (a backlog) the rate is past what the
server sustains.  The highest rate with no backlog is the knee; the
mix's ``rate`` is written by hand at about four fifths of it.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.harness import runner
    from portbench.harness.spec import Spec

    runner.prepare_env(ROOT)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        spec = Spec(ROOT, traffic_overrides={"rate": rate})
        res = runner.run(spec, args.workload, args.seed + i, args.seconds,
                         False, time.perf_counter())
        line = json.dumps({"rate": rate, "seed": args.seed + i,
                           **res["counters"],
                           "correct": res["correct"]})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
