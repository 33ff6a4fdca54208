"""How far the frame-split bf16 train micro-step lies from the float32 one,
on the CPU (ROADMAP item 31).

One Trainer micro-step (train-mode BatchNorm, FuseLoss, the random
keypoint draw of the step's generator) on one batch and one set of weights
at a small config, run four ways:
- in one process in float32 (the yardstick) and in bf16;
- over two gloo ranks at F=2 (`parallel.frame_devices=2`) in bf16 and in
  float32.

Per gradient leaf it prints the rel-norm and cosine of
`pcaccumulation_tpu_torch.utils.leaf_criteria` (leaves under its noise
floor, and the biases directly before a train-mode BatchNorm, set aside)
for: the split bf16 step against the one-process float32 step, the
one-process bf16 step against it, the two bf16 steps against each other,
and the split float32 step against the one-process one. For
`unet.conv_final.bias` it prints the norm of the gradient against the sum
of the norms of its per-pixel terms (the cotangent of the UNet's output at
each pixel), in float32 and in bf16.

    python tools/mesh_bf16_spread.py [--batch-size 2] [--frames 3] [--seed 0]
                                     [--threads 4]

The F=2 group's two ranks and the one-process run are three processes
(tests/ranks.py starts them and ends them), each in `--threads` CPU threads
(~15 s in all at the defaults). Imports nothing of JAX.
tests/test_torch_mesh.py runs the same steps.
"""

from __future__ import annotations

import argparse
import copy
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (REPO, os.path.join(REPO, "tests")) if p not in sys.path]

import ranks  # noqa: E402
from pcaccumulation_tpu_torch.utils.leaf_criteria import (  # noqa: E402
    STRUCTURAL_ZERO,
    leaf_distances,
    noise_floor,
)

PROBE = "unet.conv_final.bias"
STEP_TIMEOUT_S = 240  # the three processes; the rendezvous times out after 60 s
THREADS = 4  # CPU threads of each process
STEPS = ("one_float32", "one_bf16", "split_bf16", "split_float32")
PAIRS = (("split_bf16", "one_float32"), ("one_bf16", "one_float32"),
         ("split_bf16", "one_bf16"), ("split_float32", "one_float32"))


def small_config(frames: int = 3) -> dict:
    """The default config cut for the CPU as the port's parity tests cut it
    (64 x 64 grid, UNet depth 3, pillar encoder depth 2), T=`frames`,
    iter_size 2, the gradient clip acting, the random keypoint draw."""
    from pcaccumulation_tpu_torch.config import derive, load_config

    cfg = load_config()
    cfg["voxel_generator"].update({"range": [-8, -8, -5, 8, 8, 3], "voxel_size": [0.25, 0.25, 8],
                                   "n_sweeps": frames, "crop_range": [8, -5, 3]})
    cfg["data"].update({"n_frames": frames, "freq": 10.0, "max_speed": 20})
    cfg["warp_mode"] = "shear"
    cfg["tpointnet"].update({"n_iterations": 2, "min_points": 5})
    cfg["pillar_encoder"]["depth"] = 2
    cfg["capacity"] = {"max_points": 6000, "max_pillars": 4000, "max_instances": 8,
                       "max_fg_points": 512}
    cfg["pose_estimation"].update({"n_kpts": 128, "approx_sampling": False,
                                   "deterministic_sampling": False, "sparse_eval": True})
    cfg["unet"].update({"depth": 3, "s2d_level0": True})
    cfg["train"]["iter_size"] = 2
    cfg["train"]["grad_clip"] = 1.0
    return derive(cfg)


def write_setup(out: str, batch_size: int = 2, frames: int = 3, seed: int = 0) -> None:
    """The config, a batch of synthetic scenes and `build_model`'s weights
    from a generator seeded with `seed`, in <out>/setup.pt."""
    from pcaccumulation_tpu_torch import build_model
    from pcaccumulation_tpu_torch.data.dataset import prep_sample
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.data.synthetic import generate_sample

    cfg = small_config(frames)
    batch = collate([prep_sample(generate_sample(seed=10 + i, n_frames=frames,
                                                 n_static_clusters=8, n_dynamic=2,
                                                 pts_per_cluster=120, pts_per_object=90,
                                                 area=6.0), cfg)
                     for i in range(batch_size)])
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(seed))
    torch.save({"cfg": cfg, "batch": batch, "state": model.state_dict()},
               os.path.join(out, "setup.pt"))


def run_step(setup: dict, dtype: str, frame_devices: int, out: str) -> dict:
    """One Trainer micro-step in `dtype` at F=`frame_devices` (1: one
    process; else inside the process group): the reduced gradient, the loss
    terms, the running statistics after it and, on one process, the
    per-pixel cotangent of the UNet's output (for PROBE)."""
    from pcaccumulation_tpu_torch import build_model, to_device
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    cfg = copy.deepcopy(setup["cfg"])
    cfg["precision"]["compute_dtype"] = dtype
    cfg["parallel"].update(frame_devices=frame_devices, spatial_devices=1,
                           num_devices=frame_devices)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(setup["state"])
    tr = Trainer(cfg, model, {"train": [None] * 2}, save_dir=os.path.join(out, "run"),
                 device="cpu")
    seen = {}
    update = tr.optimizer.update

    def record(grads):
        seen["grads"] = {n: g.clone() for (n, _), g in zip(model.named_parameters(), grads)}
        return update(grads)

    def keep(g):
        seen.setdefault("cotangent", g.detach().float().clone())

    def keep_cotangent(module, args, y):
        if y.requires_grad:
            y.register_hook(keep)

    tr.optimizer.update = record
    hook = model.unet.conv_final.register_forward_hook(keep_cotangent)
    try:
        st = tr.train_step(to_device(setup["batch"], "cpu"), tr.step_generator(1, "train", 0))
    finally:
        hook.remove()
    res = {"grads": seen["grads"],
           "stats": {k: float(v) for k, v in st.items() if not isinstance(v, dict)},
           "buffers": {n: b.clone() for n, b in model.named_buffers() if "running_" in n}}
    if frame_devices == 1:
        res["cotangent"] = seen["cotangent"]
    return res


def child(role: str, rank: int, port: int, out: str, threads: int = THREADS) -> None:
    """A process of the measurement: role "one" runs both one-process
    steps, role "split" is rank `rank` of the F=2 group and runs both split
    steps; writes <out>/<role>_r<rank>.pt."""
    torch.set_num_threads(threads)
    from pcaccumulation_tpu_torch.parallel import mesh

    setup = torch.load(os.path.join(out, "setup.pt"), weights_only=False)
    world = 2 if role == "split" else 1
    if world > 1:
        mesh.init_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                              rank=rank, timeout_s=60)
    res = {dtype: run_step(setup, dtype, world, os.path.join(out, f"{role}_{rank}_{dtype}"))
           for dtype in ("float32", "bfloat16")}
    torch.save(res, os.path.join(out, f"{role}_r{rank}.pt"))
    if world > 1:
        torch.distributed.destroy_process_group()


def child_commands(out: str, port: int, threads: int = THREADS) -> list:
    """The three processes of one measurement: the F=2 group's two ranks
    and the one-process run."""
    me = os.path.abspath(__file__)
    return [[sys.executable, me, "--child", role, str(rank), str(port), out, str(threads)]
            for role, rank in (("split", 0), ("split", 1), ("one", 0))]


def load_steps(out: str) -> dict:
    """{"split_<dtype>" (rank 0), "one_<dtype>", "split_<dtype>_ranks_equal"
    (the two ranks' gradients the same bits, NaN where NaN)} from what the
    processes wrote (dtype "float32" or "bf16")."""
    split = [torch.load(os.path.join(out, f"split_r{r}.pt"), weights_only=False) for r in (0, 1)]
    one = torch.load(os.path.join(out, "one_r0.pt"), weights_only=False)
    steps = {}
    for dtype in ("float32", "bfloat16"):
        name = "bf16" if dtype == "bfloat16" else dtype
        steps[f"split_{name}"], steps[f"one_{name}"] = split[0][dtype], one[dtype]
        steps[f"split_{name}_ranks_equal"] = all(
            bool(((a == b) | (a.isnan() & b.isnan())).all())
            for a, b in zip(split[0][dtype]["grads"].values(), split[1][dtype]["grads"].values()))
    return steps


def leaf_names(grads: dict) -> list:
    return [n for n in grads if not n.endswith(STRUCTURAL_ZERO)]


def non_finite(steps: dict) -> list:
    """The leaves whose gradient is not finite in one of the steps."""
    return sorted({n for k in STEPS for n, g in steps[k]["grads"].items()
                   if not bool(torch.isfinite(g).all())})


def distances(steps: dict) -> dict:
    """{(a, b): {leaf: (rel, cos)}} for PAIRS, over the leaves above the
    noise floor of the one-process float32 gradient (NaN where a step's
    leaf is not finite)."""
    ref = steps["one_float32"]["grads"]
    names = leaf_names(ref)
    floor = noise_floor(ref, names)
    return {(a, b): leaf_distances(steps[a]["grads"], steps[b]["grads"], names, floor)
            for a, b in PAIRS}


def cancellation(cotangent: torch.Tensor) -> tuple[float, float]:
    """(|sum of the per-pixel terms|, sum of their norms) of the UNet
    output's cotangent ([B, C, H, W]): the bias gradient is the sum over
    pixels of the C-vectors."""
    terms = cotangent.double().movedim(1, -1).reshape(-1, cotangent.shape[1])
    return float(terms.sum(0).norm()), float(terms.norm(dim=1).sum())


def report(steps: dict) -> str:
    d = distances(steps)
    lines = [f"gradient leaves not finite in a step: {non_finite(steps) or 'none'}"]
    for (a, b), leaves in d.items():
        rels = np.array([r for r, _ in leaves.values()])
        worst = max(leaves, key=lambda n: leaves[n][0])
        lines.append(f"{a} vs {b}: {len(leaves)} leaves, worst {worst} rel-norm "
                     f"{leaves[worst][0]:.4f} cosine {leaves[worst][1]:.4f}; median rel-norm "
                     f"{np.median(rels):.4f}, mean {rels.mean():.4f}")
    names = list(d[PAIRS[1]])
    ratio = np.array([d[PAIRS[0]][n][0] / max(d[PAIRS[1]][n][0], 1e-300) for n in names])
    mutual = np.array([d[PAIRS[2]][n][0] / max(d[PAIRS[1]][n][0], 1e-300) for n in names])
    lines.append(f"per leaf, split bf16's rel-norm over one-process bf16's (both against "
                 f"float32): median {np.median(ratio):.3f}, quartiles "
                 f"{np.quantile(ratio, 0.25):.3f} / {np.quantile(ratio, 0.75):.3f}; the two bf16 "
                 f"steps' mutual rel-norm over one-process bf16's: median "
                 f"{np.median(mutual):.3f} (sqrt 2 = 1.414 for two independent samples)")
    p = PROBE
    lines.append(f"{p}: " + "; ".join(
        f"{a} vs {b} rel-norm {d[(a, b)][p][0]:.4f} cosine {d[(a, b)][p][1]:.4f}"
        for a, b in PAIRS if p in d[(a, b)]))
    for dtype in ("float32", "bf16"):
        s, n = cancellation(steps[f"one_{dtype}"]["cotangent"])
        lines.append(f"{p} one-process {dtype}: |gradient| {s:.4e}, sum of per-pixel term "
                     f"norms {n:.4e}, ratio {s / n:.4e}")
    lines.append("split ranks bit-equal: " + ", ".join(
        f"{k} {steps[f'split_{k}_ranks_equal']}" for k in ("float32", "bf16")))
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=THREADS)
    args = ap.parse_args()
    out = tempfile.mkdtemp(prefix="mesh_bf16_spread_")
    t0 = time.perf_counter()
    try:
        write_setup(out, args.batch_size, args.frames, args.seed)
        ranks.wait(ranks.start(child_commands(out, ranks.free_port(), args.threads)),
                   STEP_TIMEOUT_S)
        print(f"batch {args.batch_size}, T={args.frames}, weights seed {args.seed}, "
              f"{args.threads} thread(s) a process, {time.perf_counter() - t0:.1f} s")
        print(report(load_steps(out)))
    finally:
        shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], int(sys.argv[6]))
    else:
        main()
