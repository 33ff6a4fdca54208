"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `pcaccumulation_tpu_torch/csrc/`, holds
each kernel against its plain PyTorch version on the card, drives the
val-mode MotionNet forward at the full default config (configs/default.yaml:
T=5, 288x288 BEV, 90k points, 30k pillars, float32) with seeded random
weights on synthetic scenes, holds the card's forward against the CPU's on
the same weights and batch, counts the kernels' launches on that path, and
times the forward and each kernel. Any failure exits non-zero. The last two
lines of stdout are the `kernels` JSON line and the result line
`{"ok": true, "device": {...}}`. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of fn over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_inputs(gen: torch.Generator, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """[90000, 32] f32 and sorted int32 ids: short runs, runs longer than
    any tile, and one run of 40,000 rows of -1e30 (a padded tail)."""
    n, c, tail = 90000, 32, 40000
    lengths = []
    while sum(lengths) < n - tail:
        r = int(torch.randint(0, 50, (1,), generator=gen))
        lengths.append(int(torch.randint(300, 3000, (1,), generator=gen)) if r == 0
                       else int(torch.randint(1, 12, (1,), generator=gen)))
    body = np.repeat(np.arange(len(lengths)), lengths)[: n - tail]
    ids = np.concatenate([body, np.full(tail, body[-1] + 7)]).astype(np.int32)
    x = torch.randn((n, c), generator=gen)
    x[n - tail:] = -1e30
    return x.to(dev), torch.from_numpy(ids).to(dev)


def k2_inputs(gen: torch.Generator, dev):
    """img [288, 288, 160] f32, shifts [288, 5]: negative, fractional,
    beyond the row (|k| > W) and zero."""
    r, w, nb, c = 288, 288, 5, 32
    img = torch.randn((r, w, nb * c), generator=gen)
    shifts = (torch.rand((r, nb), generator=gen) - 0.5) * 40.0
    shifts[:, 0] = 0.0                      # frame 0: pass-through
    shifts[::7, 1] = -(w + 50.5)            # whole row out of range
    shifts[3::7, 2] = w + 13.25
    shifts[5::11, 3] = -3.0                 # integer, negative
    return img.to(dev), shifts.to(dev)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    import pcaccumulation_tpu_torch as port
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift_blocks, row_shift_blocks_plain
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_plain
    from pcaccumulation_tpu_torch.profile_forward import default_scenes

    # ---- 1. device --------------------------------------------------------
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; card and power limit:")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, both sources in parallel)")

    gen = torch.Generator().manual_seed(SEED)
    kernels = {}

    # ---- 3. K1 seg_pool vs plain ---------------------------------------------
    x, ids = k1_inputs(gen, dev)
    got = seg_pool(x, ids, "max")
    want = seg_pool_plain(x, ids, "max")
    torch.cuda.synchronize()
    k1_err = float((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"K1 max differs from the plain version (max abs err {k1_err})")
    got_s = seg_pool(x[:50000], ids[:50000], "sum")
    want_s = seg_pool_plain(x[:50000], ids[:50000], "sum")
    abs_sum = seg_pool_plain(x[:50000].abs(), ids[:50000], "sum")
    # sum: float32 additions in another order; bound by 1e-5 of the
    # segment's sum of |x|
    if not bool(((got_s - want_s).abs() <= 1e-5 * abs_sum + 1e-6).all()):
        fail("K1 sum differs from the plain version beyond 1e-5 of sum|x|")
    log(f"K1 seg_pool [90000, 32]: max bit-exact ({len(torch.unique(ids))} segments, "
        f"40000-row tail); sum max rel err "
        f"{float(((got_s - want_s).abs() / (abs_sum + 1e-30)).max()):.2e}")

    # ---- 4. K2 row_shift_blocks vs plain --------------------------------------
    img, shifts = k2_inputs(gen, dev)
    got = row_shift_blocks(img, shifts, 5)
    k = torch.floor(shifts)
    want = row_shift_blocks_plain(img, k.clamp(-288, 288).to(torch.int32),
                                  (shifts - k).float(), 5)
    torch.cuda.synchronize()
    k2_err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
        fail(f"K2 row_shift_blocks differs from the plain version (max abs err {k2_err})")
    if not torch.equal(got[..., :32], img[..., :32]):
        fail("K2 zero shift is not a pass-through")
    log(f"K2 row_shift_blocks [288, 288, 160] nb=5: max abs err {k2_err:.2e} (tol 1e-6)")

    # ---- 5. main path: default config, seeded weights ---------------------
    cfg = load_config()
    cfg["pose_estimation"]["deterministic_sampling"] = True
    scenes = default_scenes(cfg, 3)
    torch.manual_seed(SEED)
    model = port.build_model(cfg)  # on the card
    n_valid_pts = [int(s["point_valid"].sum()) for s in scenes]
    n_valid_pil = [int(s["pillar_valid"].sum()) for s in scenes]
    log(f"scenes: valid points {n_valid_pts} of {cfg['capacity']['max_points']}, "
        f"valid pillars {n_valid_pil} of {cfg['capacity']['max_pillars']}")
    batches = [port.to_device(collate([s])) for s in scenes]

    seg_pool.launches = 0
    row_shift_blocks.launches = 0
    with torch.no_grad():
        gpu_out = [model(bt) for bt in batches]
    torch.cuda.synchronize()
    k1_launches, k2_launches = seg_pool.launches, row_shift_blocks.launches
    n_fwd = len(batches)
    if k1_launches != 2 * n_fwd or k2_launches != 3 * n_fwd:
        fail(f"kernel launches on the main path: K1 {k1_launches}, K2 {k2_launches} for "
             f"{n_fwd} forwards (want {2 * n_fwd} and {3 * n_fwd})")
    log(f"main path: {n_fwd} forwards launched K1 {k1_launches}x, K2 {k2_launches}x")
    for i, out in enumerate(gpu_out):
        for key, v in out.items():
            if torch.is_tensor(v) and v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"scene {i}: non-finite {key}")

    # the card's forward against the CPU's, same weights and batch
    t0 = time.perf_counter()
    cpu_model = port.build_model(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        cpu = cpu_model(port.to_device(collate([scenes[0]]), "cpu"))
    log(f"CPU forward: {time.perf_counter() - t0:.1f} s")
    gpu = {k: v.cpu() for k, v in gpu_out[0].items() if torch.is_tensor(v)}
    logits = gpu["fb_logit_pillar"]
    pv = batches[0]["pillar_valid"].cpu()
    margin = float((logits[..., 1] - logits[..., 0]).abs()[pv].min())
    est_g = gpu["fb_logit_pillar"][..., 1] > gpu["fb_logit_pillar"][..., 0]
    est_c = cpu["fb_logit_pillar"][..., 1] > cpu["fb_logit_pillar"][..., 0]
    flips = int((est_g != est_c)[pv].sum())
    errs = {}
    # tolerances: float32 throughout, TF32 off; the card's convolutions and
    # reductions round in another order than the CPU's
    tol = {"fb_seg_est": 1e-3, "ego_motion_est": 1e-3, "transformed_points": 1e-2,
           "mos_est": 1e-2, "offset_est": 1e-2, "rec_est": 1e-2}
    same_fg = gpu["fb_mask"] == cpu["fb_mask"]
    for key, t in tol.items():
        if gpu[key].shape != cpu[key].shape:
            fail(f"GPU vs CPU {key}: shape {tuple(gpu[key].shape)} != {tuple(cpu[key].shape)}")
        d = (gpu[key] - cpu[key]).abs()
        if key in ("mos_est", "offset_est"):
            d = d[same_fg]  # a flipped FB decision changes which rows are decoded
        errs[key] = float(d.max())
        if errs[key] > t:
            fail(f"GPU vs CPU {key}: max abs err {errs[key]:.3e} > {t}")
    if flips > max(1, int(pv.sum()) // 1000):
        fail(f"{flips} pillar FB decisions differ between GPU and CPU")
    log("GPU vs CPU: " + ", ".join(f"{k} {v:.2e} (tol {tol[k]})" for k, v in errs.items())
        + f"; FB decisions flipped {flips} of {int(pv.sum())} (min |logit margin| {margin:.2e})")

    # random keypoint draw
    cfg_r = dict(cfg, pose_estimation=dict(cfg["pose_estimation"],
                                           deterministic_sampling=False))
    model_r = port.build_model(cfg_r)
    model_r.load_state_dict(model.state_dict())
    g_cuda = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for bt in batches:
            out = model_r(bt, generator=g_cuda)
            for key in ("ego_motion_est", "mos_est", "offset_est", "rec_est"):
                if not bool(torch.isfinite(out[key]).all()):
                    fail(f"random sampling: non-finite {key}")
    log(f"random keypoint draw: {len(batches)} forwards finite")

    # ---- 6. timing ----------------------------------------------------------
    with torch.no_grad():
        for _ in range(3):
            model(batches[0])
        times = []
        for i in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            model(batches[i % n_fwd])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    fwd_ms = statistics.median(times)
    log(f"val forward (B=1, default config, CUDA events): median {fwd_ms:.3f} ms of 10 "
        f"(min {min(times):.3f}, max {max(times):.3f}) on {smi}")

    n, c = x.shape
    k1_bound, k1_by = bound_ms(2 * n * c * 4 + n * 4, n * c)
    kernels["seg_pool"] = {
        "name": "seg_pool", "route": "cuda", "source": "pcaccumulation_tpu_torch/csrc/segscan.cu",
        "replaces": "pcaccumulation_tpu/kernels/segscan.py:153",
        "launches": k1_launches, "max_abs_err": k1_err,
        "ms": cuda_ms(lambda: seg_pool(x, ids, "max")),
        "plain_ms": cuda_ms(lambda: seg_pool_plain(x, ids, "max")),
        "bound_ms": k1_bound, "bound_by": k1_by,
        "library_ms": None,  # no single PyTorch call reduces and broadcasts back
    }
    r, w, ctot = img.shape
    ki = k.clamp(-w, w).to(torch.int32)
    fr = (shifts - k).float()
    k2_bound, k2_by = bound_ms(2 * img.numel() * 4 + ki.numel() * 8, 3 * img.numel())
    # library yardstick: grid_sample, one x-only grid per (row, frame), on
    # the image laid out [R*nb, C, 1, W] (the layout copy is not timed),
    # at the clipped shift k + f, so that it computes the same function
    nb = 5
    img_g = img.reshape(r, w, nb, ctot // nb).permute(0, 2, 3, 1).reshape(r * nb, ctot // nb, 1, w)
    xs = (torch.arange(w, device=dev, dtype=torch.float32)[None, :]
          + (ki.float() + fr).reshape(-1, 1))
    grid = torch.stack([(2 * xs + 1) / w - 1, torch.zeros_like(xs)], -1)[:, None]  # [R*nb,1,W,2]
    lib_out = torch.nn.functional.grid_sample(img_g, grid, mode="bilinear",
                                              padding_mode="zeros", align_corners=False)
    lib_err = float((lib_out.reshape(r, nb, ctot // nb, w).permute(0, 3, 1, 2).reshape(r, w, ctot)
                     - want).abs().max())
    # grid_sample rounds its pixel coordinate through the normalised grid
    # (~1e-5 px at W = 288), times neighbour differences of up to ~10
    if lib_err > 1e-3:
        fail(f"the grid_sample yardstick does not compute row_shift_blocks (err {lib_err:.2e})")
    kernels["row_shift_blocks"] = {
        "name": "row_shift_blocks", "route": "cuda",
        "source": "pcaccumulation_tpu_torch/csrc/row_shift.cu",
        "replaces": "pcaccumulation_tpu/ops/bilinear.py:387",
        "launches": k2_launches, "max_abs_err": k2_err,
        "ms": cuda_ms(lambda: row_shift_blocks(img, shifts, 5)),
        "plain_ms": cuda_ms(lambda: row_shift_blocks_plain(img, ki, fr, 5)),
        "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
            img_g, grid, mode="bilinear", padding_mode="zeros", align_corners=False)),
    }
    for kern in kernels.values():
        log(f"{kern['name']}: {kern['ms']:.4f} ms (bound {kern['bound_ms']:.4f} ms by "
            f"{kern['bound_by']}; plain {kern['plain_ms']:.4f} ms; library "
            f"{kern['library_ms']})")
    log(f"grid_sample yardstick max abs err vs plain: {lib_err:.2e}")
    log(f"forward_ms {fwd_ms:.3f} on {smi}")

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
