"""The protein convergence run (tools/convergence_protein.py) over several
seeds, for the pass rule the port's gate is held to.

tools/convergence_protein.py trains from ProteinTrainConfig's seed (0). This
script runs it once per seed with that seed replaced, each run writing its
own JSON under --out-dir (never CONVERGENCE_PROTEIN.json), then prints one
summary line: each seed's recovery with the parameters and the EMA, their
medians and how many seeds reached --bar.

  python tools/convergence_protein_seeds.py --cpu --steps 2000 --seeds 0 1 2 3 4 \
      --out-dir /tmp/conv
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--bar", type=float, default=0.95)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import reed_tpu.train.protein as protein
    from tools import convergence_protein

    base = protein.ProteinTrainConfig
    os.makedirs(args.out_dir, exist_ok=True)
    runs = {}
    for seed in args.seeds:
        protein.ProteinTrainConfig = lambda seed=seed, **kw: dataclasses.replace(
            base(**kw), seed=seed)
        try:
            result = convergence_protein.main(
                ["--steps", str(args.steps), "--out", os.path.join(
                    args.out_dir, f"seed{seed}.json")]
                + (["--cpu"] if args.cpu else []) + (["--tiny"] if args.tiny else []))
        finally:
            protein.ProteinTrainConfig = base
        runs[seed] = {"final": result["final"], "final_ema": result["final_ema"],
                      "train_seconds": result["train_seconds"]}
    summary = {
        "tool": "tools/convergence_protein.py", "steps": args.steps, "bar": args.bar,
        "platform": result["platform"], "runs": runs,
        "median_final": statistics.median(r["final"] for r in runs.values()),
        "median_final_ema": statistics.median(r["final_ema"] for r in runs.values()),
        "passed": sum(r["final"] >= args.bar for r in runs.values()),
        "passed_ema": sum(r["final_ema"] >= args.bar for r in runs.values()),
    }
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
