"""Run the port's from-scratch convergence protocol: several training runs
of the port's CLI on one card at once, then (optionally) the test chain of
one of them, and copy what each run wrote to an output directory.

    python3 tools/port_conv_runs.py --out results/conv [--jobs 4] \
        [--seeds 42 43 44 45 46] [--dtypes float32 bfloat16] [--epochs 21] \
        [--control DIR] [--test-chain] [--suffix _rerun]

Each run is the protocol's command (the JAX package's five-seed band was
taken with the same one, `tools/PROFILE_r11.md`):

    python -m pcaccumulation_tpu_torch.main configs/synthetic.yaml 4 1 \
        --train.max_epoch=21 --misc.seed=S --path.dataset_base=data/synthetic_conv \
        --misc.exp_name=port_conv_sS

with `--precision.compute_dtype=bfloat16` and the name port_conv_bf16_sS
for bf16. `--control DIR` adds one float32 run of seed 42 from another
checkout of the port (e.g. the parent commit unpacked under `results/`),
named port_conv_control_s42. `--test-chain` runs, after port_conv_s42,
the Tester on the test split from its `model_best_metric.ckpt` and the
port's evaluation (their output in <out>/port_conv_s42/test_chain.log;
each run's training output is in <out>/<name>.out). `--suffix` is
appended to every run's name (a second run of a seed beside the first).
The runs share the
card; `--jobs` of them run at a time. Each run's `config.json`, `log`,
`metrics.jsonl` and `model_arch.txt` land in <out>/<name>/, and
<out>/runs.json holds each command's exit code and wall seconds and the
card's name and power limit. Imports neither JAX nor the port.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP = ("config.json", "log", "metrics.jsonl", "model_arch.txt")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def train_cmd(name: str, seed: int, dtype: str, epochs: int, data: str) -> list[str]:
    cmd = [sys.executable, "-m", "pcaccumulation_tpu_torch.main", "configs/synthetic.yaml",
           "4", "1", f"--train.max_epoch={epochs}", f"--misc.seed={seed}",
           f"--path.dataset_base={data}", f"--misc.exp_name={name}"]
    if dtype != "float32":
        cmd.append(f"--precision.compute_dtype={dtype}")
    return cmd


def run(name: str, cmds: list[list[str]], cwd: str, out: str, env: dict) -> dict:
    """The commands one after the other (stopping at a failure), the
    first's output in <out>/<name>.out and the others' (the test chain) in
    <out>/<name>/test_chain.log, and the run directory's files copied."""
    t0 = time.perf_counter()
    rcs = []
    os.makedirs(os.path.join(out, name), exist_ok=True)
    for i, cmd in enumerate(cmds):
        path = os.path.join(out, f"{name}.out") if i == 0 else os.path.join(
            out, name, "test_chain.log")
        with open(path, "w" if i < 2 else "a") as log:
            log.write("$ " + " ".join(cmd) + "\n")
            log.flush()
            rcs.append(subprocess.run(cmd, cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
                                      env=env).returncode)
        if rcs[-1]:
            break
    seconds = time.perf_counter() - t0
    src = os.path.join(cwd, "snapshot", name)
    if os.path.isdir(src):
        for f in KEEP:
            if os.path.exists(os.path.join(src, f)):
                shutil.copy(os.path.join(src, f), os.path.join(out, name, f))
    print(f"{name}: rc {rcs} in {seconds:.1f} s", flush=True)
    return {"name": name, "rcs": rcs, "seconds": seconds, "cwd": cwd}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44, 45, 46])
    ap.add_argument("--dtypes", nargs="+", default=["float32"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--epochs", type=int, default=21, help="train.max_epoch (epochs 1..N-1)")
    ap.add_argument("--control", default=None, help="another checkout: one float32 run, seed 42")
    ap.add_argument("--test-chain", action="store_true")
    ap.add_argument("--suffix", default="", help="appended to every run's name")
    args = ap.parse_args()

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    data = os.path.join("data", "synthetic_conv")  # relative to the run's directory
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 8) // args.jobs)))
    jobs = []  # (name, commands, cwd)
    for dtype in args.dtypes:
        for seed in args.seeds:
            name = (f"port_conv_s{seed}" if dtype == "float32"
                    else f"port_conv_bf16_s{seed}") + args.suffix
            cmds = [train_cmd(name, seed, dtype, args.epochs, data)]
            if args.test_chain and dtype == "float32" and seed == 42:
                test = f"{name}_test"
                cmds.append([sys.executable, "-m", "pcaccumulation_tpu_torch.main",
                             "configs/synthetic.yaml", "1", "1", "--misc.mode=test",
                             f"--misc.exp_name={test}", f"--path.dataset_base={data}",
                             f"--misc.pretrain=snapshot/{name}/model_best_metric.ckpt"])
                cmds.append([sys.executable, "-m", "pcaccumulation_tpu_torch.evaluation",
                             f"results/{test}", "synthetic"])
            jobs.append((name, cmds, ROOT))
    if args.control:
        name = "port_conv_control_s42" + args.suffix
        cwd = os.path.abspath(args.control)
        jobs.insert(0, (name, [train_cmd(name, 42, "float32", args.epochs,
                                         os.path.relpath(os.path.join(ROOT, data), cwd))], cwd))

    print(card(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(lambda j: run(*j, out, env), jobs))
    summary = {"card": card(), "jobs": args.jobs, "seconds": time.perf_counter() - t0,
               "runs": results}
    with open(os.path.join(out, "runs.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in ("card", "jobs", "seconds")}))
    return int(any(r["rcs"][-1] for r in results))


if __name__ == "__main__":
    sys.exit(main())
