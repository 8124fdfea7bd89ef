"""Readings from which the correctness limits of ``graphormer_base.train``
are set (``portbench/limits/``), on the chip, several seeds in one
process, as ``calibrate.py`` takes them for the hybrid's cells:

    python3 portbench/calibrate_graphormer.py --what program \
        --seeds 11,12,13 [--seconds 3] [--out FILE]

``--what program``: whole runs of the cell (a short window), printing
each seed's compared numbers: the lower readings.  ``--what control``:
the reference with every operand of every product rounded to float8
e4m3 (one precision below the configuration's bfloat16), against the f32
reference, on the same inputs: an upper reading.  ``--what half``: the
reference with half of each batch left out, against the reference.  (A
state left unchanged reads 1 in ``change_gap`` and needs no run.)  Each
reading is one JSON line on standard output and in ``--out``.  The
benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOAD = "graphormer_base.train"


def readings(spec, seed, what, seconds, device):
    from portbench.harness import check, runner
    from portbench.harness.drivers import train_graphormer

    if what == "program":
        res = runner.run(spec, WORKLOAD, seed, seconds, False,
                         time.perf_counter(), device=device)
        return {**{k: v["value"] for k, v in res["checks"].items()},
                **res["counters"].get("numbers", {}),
                "train_mol_per_s": res["metrics"]["train_mol_per_s"][
                    "value"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
    import torch

    cell = spec.cell(WORKLOAD)
    tr = spec.traffic(cell["traffic"])
    ctx = types.SimpleNamespace(config=spec.config(cell["config"]),
                                traffic=tr, seed=seed,
                                device=torch.device(device))
    smiles, y = check.load_csv(tr["train_csv"])
    steps = tr["check_steps"]
    want = train_graphormer.reference_steps(ctx, smiles, y, steps)
    got = train_graphormer.reference_steps(
        ctx, smiles, y, steps, round_to="fp8" if what == "control" else None,
        fault="half" if what == "half" else None)
    return check.train_numbers(got, want, leaves=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--what", default="program",
                    choices=("program", "control", "half"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic", default="{}",
                    help="JSON of mix parameters set over the mix's own")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.harness import runner
    from portbench.harness.spec import Spec

    runner.prepare_env(ROOT)
    spec = Spec(ROOT, traffic_overrides=json.loads(args.traffic))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = readings(spec, seed, args.what, args.seconds, args.device)
        line = json.dumps({"workload": WORKLOAD, "what": args.what,
                           "seed": seed, **nums,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
