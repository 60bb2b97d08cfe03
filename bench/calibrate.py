"""Readings that the limits of ``checks/<cell>.json`` are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --control 3 --seconds 15

In one process, for each seed: a run of the cell's set-up and a short
window at its own load, then the widest gap of the program's served tokens
below the reference's best (the number the benchmark compares); for the
first ``--control`` seeds also the control's: the reference itself put in
the program's place and computed one precision below the configuration's
bf16 (weights and keys / values rounded to float8 e4m3), read as the gap
of the token it puts first at each position of the same prompts and served
tokens.  Both go through the benchmark's own comparison (``judge.judge``
with the cell's ``checks/<cell>.json``): the line gives each verdict, and
the control's has to come out false.  One JSON line a seed.  Needs the
card; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    import torch
    import harness
    import judge
    if not torch.cuda.is_available():
        print("calibration needs the card", file=sys.stderr)
        return 3
    bench = harness.load_benchmark()
    check = harness.load_check(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        sv = harness.serve(args.workload, seed, args.seconds, False,
                           bench=bench)
        sample = judge.sample(sv.finished, seed)
        due = int(any(tr.skipped for tr in sv.finished))
        line = {"cell": args.workload, "seed": seed,
                "finished": len(sv.finished), "sampled": len(sample),
                "suffix_sampled": sum(1 for *_, k in sample if k),
                "served_tokens": int(sum(len(o) for _, o, _ in sample))}
        v = judge.judge(sv.run, sv.weights, sample, check, "cuda", due)
        line["program_gap"] = v["checks"]["logit_gap"]["value"]
        line["program_correct"] = v["correct"]
        if i < args.control:
            v = judge.judge(sv.run, sv.weights, sample, check, "cuda", due,
                            gaps=judge.control_gaps)
            line["control_gap"] = v["checks"]["logit_gap"]["value"]
            line["control_correct"] = v["correct"]
        print(json.dumps(line), flush=True)
        del sv, sample
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    bench_run._paths()
    sys.exit(main())
