"""Compare two groups of training runs by their late validation metrics.

    python3 tools/conv_band.py RUN_DIR... [--vs RUN_DIR...] [--names A B] [--epochs 16 20]

Each run directory holds the `metrics.jsonl` a training run writes (the
JAX package's and the port's have the same records). The statistic of a
run is the mean, over its `epoch_val` records of epochs 16-20 (the k-th
record is epoch k), of mos_iou, fb_iou, ego_rot_error, ego_trans_error and
inst_l2_error; a group's band is the mean and sd (ddof=1) of that
statistic over its runs. With `--vs` it prints both groups' bands and
Welch's t and two-sided p (scipy) per metric, the first group minus the
second; then one JSON line with the same numbers. Imports numpy and scipy
only.

    python3 tools/conv_band.py snapshot/port_conv_s4{2,3,4,5,6} \\
        --vs snapshot/conv_r11_band4 snapshot/conv_r13_band4_s4{3,4,5,6} --names port jax
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

METRICS = ("mos_iou", "fb_iou", "ego_rot_error", "ego_trans_error", "inst_l2_error")


def epoch_val_records(run_dir: str) -> list[dict]:
    """The run's `epoch_val` records in the order they were written."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if r.get("phase") == "epoch_val"]


def run_statistic(run_dir: str, first: int = 16, last: int = 20) -> dict:
    """{metric: mean over the epoch_val records of epochs first..last}."""
    recs = epoch_val_records(run_dir)
    if len(recs) < last:
        raise ValueError(f"{run_dir}: {len(recs)} epoch_val records, epoch {last} asked for")
    window = recs[first - 1:last]
    return {m: float(np.mean([r[m] for r in window])) for m in METRICS}


def band(run_dirs: list[str], first: int = 16, last: int = 20) -> dict:
    """{metric: {"mean", "sd", "runs"}} over the runs (sd with ddof=1)."""
    stats = [run_statistic(d, first, last) for d in run_dirs]
    out = {}
    for m in METRICS:
        v = np.array([s[m] for s in stats])
        out[m] = {"mean": float(v.mean()), "sd": float(v.std(ddof=1)) if len(v) > 1 else None,
                  "runs": v.tolist()}
    return out


def mean_sd(group: dict) -> str:
    """'mean ± sd', or the mean alone for one run."""
    if group["sd"] is None:
        return f"{group['mean']:.4f}"
    return f"{group['mean']:.4f} ± {group['sd']:.4f}"


def welch(a: list[float], b: list[float]) -> tuple[float, float]:
    """Welch's t (a minus b) and its two-sided p."""
    from scipy import stats

    res = stats.ttest_ind(a, b, equal_var=False)
    return float(res.statistic), float(res.pvalue)


def compare(a_dirs: list[str], b_dirs: list[str], first: int = 16, last: int = 20) -> dict:
    a, b = band(a_dirs, first, last), band(b_dirs, first, last)
    out = {}
    for m in METRICS:
        t, p = welch(a[m]["runs"], b[m]["runs"])
        out[m] = {"a": a[m], "b": b[m], "t": t, "p": p}
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--vs", nargs="+", default=None)
    ap.add_argument("--names", nargs="+", default=["a", "b"], help="the groups' labels")
    ap.add_argument("--epochs", nargs=2, type=int, default=[16, 20])
    args = ap.parse_args(argv)
    first, last = args.epochs
    na, nb = (args.names + ["b"])[:2]
    if args.vs is None:
        res = band(args.runs, first, last)
        print(f"| metric (val, mean of epochs {first}-{last}) | {na} mean ± sd |")
        print("| --- | --- |")
        for m in METRICS:
            print(f"| {m} | {mean_sd(res[m])} |")
        print(json.dumps({"epochs": [first, last], na: {"runs": args.runs, "band": res}}))
        return 0
    res = compare(args.runs, args.vs, first, last)
    print(f"| metric (val, mean of epochs {first}-{last}) | {na} mean ± sd (n={len(args.runs)}) "
          f"| {nb} mean ± sd (n={len(args.vs)}) | Welch t ({na} - {nb}) | p |")
    print("| --- | --- | --- | --- | --- |")
    for m in METRICS:
        r = res[m]
        print(f"| {m} | {mean_sd(r['a'])} | {mean_sd(r['b'])} | {r['t']:.3f} | {r['p']:.4f} |")
    print(json.dumps({"epochs": [first, last], "names": [na, nb], "a": args.runs,
                      "b": args.vs, "metrics": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
