"""`build_model` in several checkouts on the CPU: its state_dicts compared bit
for bit, and the time of a default-config build.

    python tools/build_model_check.py <checkout> [<checkout> ...] [--threads 1] [--reps 15]

Each checkout's `pcaccumulation_tpu_torch` runs in a process of its own,
twice in turn (A B A B ...), in `--threads` torch threads: it builds the
default, nuScenes, Waymo and synthetic configs from `model_generator(cfg)`
(seeded from `misc.seed`), then times `--reps` default-config builds. The
script prints each process's median, least and largest build time, and
whether every checkout's state_dicts (and the non-persistent buffers)
equal the first checkout's, dtype and bits. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

CONFIGS = {"default": None, "nuscene": "configs/nuscene.yaml", "waymo": "configs/waymo.yaml",
           "synthetic": "configs/synthetic.yaml"}


def child(checkout: str, out: str, threads: int, reps: int) -> None:
    import time

    sys.path.insert(0, checkout)
    os.chdir(checkout)
    torch.set_num_threads(threads)
    import pcaccumulation_tpu_torch as port
    from pcaccumulation_tpu_torch.config import load_config

    if not port.__file__.startswith(os.path.abspath(checkout)):
        raise SystemExit(f"imported {port.__file__}, not the checkout's package")
    tensors = {}
    for name, path in CONFIGS.items():
        cfg = load_config(path)
        model = port.build_model(cfg, "cpu", port.model_generator(cfg))
        tensors[name] = {**model.state_dict(), **dict(model.named_buffers())}
    cfg = load_config()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        port.build_model(cfg, "cpu", port.model_generator(cfg))
        times.append(time.perf_counter() - t0)
    torch.save({"tensors": tensors, "times": times}, out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        results = {}
        for turn in range(2):
            for i, checkout in enumerate(args.checkouts):
                out = os.path.join(tmp, f"{i}_{turn}.pt")
                subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                                os.path.abspath(checkout), out, str(args.threads), str(args.reps)],
                               check=True, timeout=1800)
                res = torch.load(out)
                t = sorted(res["times"])
                print(f"{checkout} (turn {turn + 1}, {args.threads} thread(s)): default-config build "
                      f"median {1e3 * t[len(t) // 2]:.1f} ms, least {1e3 * t[0]:.1f}, largest "
                      f"{1e3 * t[-1]:.1f} ({args.reps} builds)", flush=True)
                results.setdefault(i, res["tensors"])
    first = results[0]
    for i, checkout in enumerate(args.checkouts[1:], 1):
        for name, want in first.items():
            got = results[i][name]
            differ = sorted(k for k in set(want) | set(got)
                            if k not in want or k not in got or want[k].dtype != got[k].dtype
                            or not torch.equal(want[k], got[k]))
            print(f"{checkout} vs {args.checkouts[0]}, {name}: {len(want)} tensors, "
                  f"{'bit-identical' if not differ else f'differing: {differ}'}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
    else:
        main()
