"""`train.remat` on the card, step by step: for the nuScenes preset (bf16)
and the default config (float32), B=4, flax's seeded init (`chip_smoke.
flax_init`), train-mode BN, deterministic keypoints, torch's default
algorithms:
- one micro-step's forward + FuseLoss and its backward, plain and remat
  (order plain, remat, remat, plain; 3 timed steps after a warm-up): CUDA
  events and the host clock for each part, the memory held after the
  forward, the peak, and the Conv2d forwards each part runs (the
  recompute runs them again in the backward);
- how many gradient leaves two plain steps give bit-equal, with torch's
  default algorithms and under `torch.use_deterministic_algorithms`.

    python3 tools/remat_split.py
"""
import contextlib
import copy
import os
import statistics
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch
from torch.utils.checkpoint import checkpoint

import chip_smoke
import pcaccumulation_tpu_torch as port
from pcaccumulation_tpu_torch.config import load_config
from pcaccumulation_tpu_torch.data.loader import collate
from pcaccumulation_tpu_torch.kernels import build
from pcaccumulation_tpu_torch.profile_forward import default_scenes
from pcaccumulation_tpu_torch.train.loss import fuse_loss
from pcaccumulation_tpu_torch.train.trainer import _buffers_kept


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for path in ("configs/nuscene.yaml", "configs/default.yaml"):
        cfg = load_config(path, ["--misc.mode=train", "--train.ckpt_backend=pickle"])
        cfg["pose_estimation"]["deterministic_sampling"] = True  # the same keypoints every step
        model = port.build_model(cfg)
        chip_smoke.flax_init(model, chip_smoke.SEED)
        model.train()
        batch = port.to_device(collate(default_scenes(cfg, cfg["train"]["batch_size"])))
        calls = []
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.register_forward_hook(lambda *_: calls.append(1))

        def forward_loss(bt):
            return fuse_loss(model(bt, mode="train"), bt, cfg["loss"],
                             cfg["capacity"]["max_instances"])

        def step(remat):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            calls.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            t0 = time.perf_counter()
            ev[0].record()
            if remat:
                st = checkpoint(forward_loss, batch, use_reentrant=False,
                                context_fn=lambda: (contextlib.nullcontext(),
                                                    _buffers_kept(model)))
            else:
                st = forward_loss(batch)
            ev[1].record()
            t1 = time.perf_counter()
            held = torch.cuda.memory_allocated() / 2 ** 30
            n_fwd = len(calls)
            st["loss"].backward()
            ev[2].record()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            return (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), (t1 - t0) * 1e3,
                    (t2 - t1) * 1e3, held, torch.cuda.max_memory_allocated() / 2 ** 30, n_fwd,
                    len(calls) - n_fwd)

        for remat in (False, True, True, False):
            step(remat)
            runs = [step(remat) for _ in range(3)]
            med = [statistics.median(r[i] for r in runs) for i in range(6)]
            print(f"{path} {'remat' if remat else 'plain'}: forward+loss {med[0]:.3f} ms, "
                  f"backward {med[1]:.3f} ms (CUDA events); host {med[2]:.3f} / {med[3]:.3f} ms; "
                  f"held after the forward {med[4]:.3f} GiB, peak {med[5]:.3f} GiB; Conv2d "
                  f"forwards {runs[-1][6]} in the forward, {runs[-1][7]} in the backward",
                  flush=True)

        def grads():
            step(False)
            return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

        for det in (False, True):
            torch.use_deterministic_algorithms(det, warn_only=True)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                g0, g1 = grads(), grads()
            torch.use_deterministic_algorithms(False)
            same = sum(torch.equal(g0[n], g1[n]) for n in g0)
            worst = max((float((g1[n] - g0[n]).double().norm())
                         / max(float(g0[n].double().norm()), 1e-30), n) for n in g0)
            print(f"{path}, {'deterministic' if det else 'default'} algorithms: two plain steps "
                  f"give {same} of {len(g0)} gradient leaves bit-equal; the largest rel-norm "
                  f"apart {worst[0]:.3e} ({worst[1]})", flush=True)


if __name__ == "__main__":
    main()
