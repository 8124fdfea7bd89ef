"""Readings from which the correctness limits are set (``portbench/limits/``),
on the chip, several seeds in one process:

    python3 portbench/calibrate.py --workload flagship.score \
        --what program --seeds 11,12,13 [--seconds 3] [--out FILE]

``--what program``: whole runs of the cell (a short window), printing each
seed's compared numbers: the lower readings.  ``--what control``: the
reference put in the program's place, computed one precision below the
configuration's (TF32 operands for float32, e4m3 operands for bfloat16),
against the reference at the configuration's precision, on the inputs a
run checks: the upper readings.  ``--what half`` (training cells): the
reference with half of each batch left out (the mean over the rest),
against the reference.  (A state left unchanged reads 1 in
``change_gap`` and needs no run.)  Each reading is one JSON line on standard output and in
``--out``.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL = {"f32": "tf32", "bf16": "fp8"}


def readings(spec, workload, seed, what, seconds, device):
    from portbench.harness import check, runner
    from portbench.harness.traffic import library_pool, seed_for

    if what == "program":
        res = runner.run(spec, workload, seed, seconds, False,
                         time.perf_counter(), device=device)
        return {**{k: v["value"] for k, v in res["checks"].items()},
                **res["counters"].get("numbers", {})}
    import numpy as np
    import torch

    cell = spec.cell(workload)
    conf, tr = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    ctx = types.SimpleNamespace(config=conf, seed=seed,
                                device=torch.device(device))
    mode = CONTROL[conf["numerics"]] if what == "control" else None
    if tr["driver"] == "train":
        smiles, y = check.load_csv(tr["train_csv"])
        want = check.reference_train(ctx, smiles, y, tr["check_steps"])
        got = check.reference_train(ctx, smiles, y, tr["check_steps"],
                                    mode=mode,
                                    fault=None if mode else what)
        return check.train_numbers(got, want, leaves=True)
    if what != "control":
        raise ValueError(f"{what!r} is a training cell's fault")
    pool = library_pool(tr, seed, conf["budget"][0])
    rng = np.random.default_rng(seed_for(seed, "check"))
    smiles = [pool[i] for i in rng.choice(len(pool), tr["check_molecules"],
                                          replace=False)]
    scaler = check.fit_scaler(check.load_csv("train_data.csv")[1])
    want = check.reference_predictions(ctx, smiles, scaler)
    got = check.reference_predictions(ctx, smiles, scaler, mode=mode)
    return check.prediction_numbers(got, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
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
        nums = readings(spec, args.workload, seed, args.what, args.seconds,
                        args.device)
        line = json.dumps({"workload": args.workload, "what": args.what,
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
