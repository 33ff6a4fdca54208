"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `pcaccumulation_tpu_torch/csrc/`, holds
each kernel and each kernel's gradient against its plain PyTorch version on
the card, then drives the two paths of the port at the full default config
(configs/default.yaml: T=5, 288x288 BEV, 90k points, 30k pillars, float32)
with seeded random weights on synthetic scenes:
- the val-mode MotionNet forward (B=1): held against the CPU's forward on
  the same weights and batch, kernel launches counted, timed;
- the training micro-step through the port's Trainer (B=4, iter_size 2,
  random keypoint draw): FuseLoss, backward, optimizer; loss terms finite,
  parameters moved, kernel launches counted, timed, peak memory; and the
  card's gradient held against the CPU's (B=1, eval BN, deterministic
  keypoints).
Any failure exits non-zero. The last two lines of stdout are the `kernels`
JSON line and the result line `{"ok": true, "device": {...}}`. Without a
CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
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


def k1_batch_inputs(gen: torch.Generator, dev, b: int):
    """b samples of `k1_inputs` stacked, ids offset per sample as the
    pillar encoder offsets them: x [b*90000, 32], sorted ids."""
    xs, ids = zip(*(k1_inputs(gen, "cpu") for _ in range(b)))
    offs, out = 0, []
    for i in ids:
        out.append(i + offs)
        offs = int(out[-1][-1]) + 1
    return torch.cat(xs).to(dev), torch.cat(out).to(dev)


def tie_values(x: torch.Tensor) -> torch.Tensor:
    """x with its values rounded to halves (the -1e30 rows kept): maxima tie
    inside most segments."""
    return torch.where(x > -1e29, torch.round(x * 2) / 2, x)


def sync_ms(start, end) -> float:
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def scaled_init(model: torch.nn.Module, seed: int) -> None:
    """Seeded weights whose signal keeps its scale through the depth (He
    normal for convolutions and linears, the tests' draw for biases and
    BatchNorm), so that every leaf of the full-width net gets a gradient
    above the noise floor; torch's default initialisation shrinks the
    signal ~2.4x per layer, and the deep STPN leaves then get ~1e-7 of the
    largest gradient."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            w = getattr(mod, "weight", None)
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear,
                                torch.nn.ConvTranspose2d)):
                # a 2x2 stride-2 transpose conv feeds each output from one tap
                fan_in = (w.shape[0] if isinstance(mod, torch.nn.ConvTranspose2d)
                          else w[0].numel())
                w.copy_(torch.randn(w.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                if mod.bias is not None:
                    mod.bias.copy_(0.05 * torch.randn(mod.bias.shape, generator=gen))
            elif hasattr(mod, "running_var"):
                w.copy_(1.0 + 0.1 * torch.randn(w.shape, generator=gen))
                mod.bias.copy_(0.05 * torch.randn(w.shape, generator=gen))
                mod.running_mean.copy_(0.05 * torch.randn(w.shape, generator=gen))
                mod.running_var.copy_(1.0 + 0.2 * torch.rand(w.shape, generator=gen))


def leaf_criterion(grads_a: dict, grads_b: dict) -> tuple[int, int, float, float, str]:
    """The per-leaf gradient criterion of tests/test_full_parity.py: leaves
    above 1e-5 of the largest gradient norm must have rel-norm < 0.05 and
    cosine > 0.995. Returns (checked, noise, worst rel, worst cos, worst
    leaf) and fails on a leaf that misses it."""
    norms = {n: max(float(grads_a[n].norm()), float(grads_b[n].norm())) for n in grads_a}
    floor = max(norms.values()) * 1e-5
    checked = noise = 0
    worst = (0.0, 1.0, "")
    for n, g in grads_a.items():
        if norms[n] < floor:
            noise += 1
            continue
        a, b = g.double().ravel(), grads_b[n].double().ravel()
        rel = float((a - b).norm()) / norms[n]
        cos = float(a @ b / (a.norm() * b.norm()))
        worst = max(worst, (rel, cos, n))
        if rel >= 0.05 or cos <= 0.995:
            fail(f"GPU vs CPU gradient of {n}: rel-norm {rel:.3e}, cosine {cos:.6f}")
        checked += 1
    if checked <= 3 * noise:
        fail(f"GPU vs CPU gradients: {checked} leaves checked, {noise} below the noise floor")
    return checked, noise, worst[0], worst[1], worst[2]


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    import pcaccumulation_tpu_torch as port
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.kernels.row_shift import (
        row_shift_blocks,
        row_shift_blocks_backward,
        row_shift_blocks_plain,
    )
    from pcaccumulation_tpu_torch.kernels.segscan import (
        seg_pool,
        seg_pool_backward,
        seg_pool_backward_plain,
        seg_pool_plain,
    )
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

    # ---- 4b. K1 gradient vs plain ------------------------------------------
    # the train path's shape: B=4 samples of [90000, 32] (the pack is
    # [360000, 64]); with float x and with integer-valued x (forced ties)
    x4, ids4 = k1_batch_inputs(gen, dev, 4)
    g4 = torch.randn(x4.shape, generator=gen).to(dev)
    k1b_err = 0.0
    for name, xin in (("float", x4), ("ties", tie_values(x4))):
        xg = xin.clone().requires_grad_(True)
        before = seg_pool_backward.launches
        seg_pool(xg, ids4, "max").backward(g4)
        if seg_pool_backward.launches != before + 1:
            fail("K1 gradient did not launch the kernel once")
        want_g = seg_pool_backward_plain(xin, ids4, seg_pool_plain(xin, ids4, "max"), g4)
        abs_sum = seg_pool_plain(g4.abs(), ids4, "sum")
        torch.cuda.synchronize()
        if not bool(((xg.grad - want_g).abs() <= 1e-5 * abs_sum + 1e-6).all()):
            fail(f"K1 gradient ({name}) differs from the plain one beyond 1e-5 of sum|g|")
        off = xin != seg_pool_plain(xin, ids4, "max")
        if not bool((xg.grad[off] == 0).all()):
            fail(f"K1 gradient ({name}) is not zero off the tie set")
        n_tied = int((~off).sum())
        err = float((xg.grad - want_g).abs().max())
        k1b_err = max(k1b_err, err)
        log(f"K1 gradient [{x4.shape[0]}, {x4.shape[1]}] ({name}): max abs err {err:.2e} "
            f"(bound 1e-5 of the segment's sum|g|), zero off the tie set, {n_tied} tied rows")

    # ---- 4c. K2 gradient vs plain ------------------------------------------
    g2 = torch.randn(img.shape, generator=gen).to(dev)
    ig = img.clone().requires_grad_(True)
    before = row_shift_blocks_backward.launches
    row_shift_blocks(ig, shifts, 5).backward(g2)
    if row_shift_blocks_backward.launches != before + 1:
        fail("K2 gradient did not launch the kernel once")
    kn = torch.floor(-shifts)
    want_g = row_shift_blocks_plain(g2, kn.clamp(-288, 288).to(torch.int32),
                                  (-shifts - kn).float(), 5)
    torch.cuda.synchronize()
    k2b_err = float((ig.grad - want_g).abs().max())
    if k2b_err > 1e-6:
        fail(f"K2 gradient differs from the plain one (max abs err {k2b_err})")
    log(f"K2 gradient [288, 288, 160] nb=5 (shift at -shifts): max abs err {k2b_err:.2e} "
        f"(tol 1e-6)")

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

    # ---- 7. train path: the Trainer's micro-step at full width --------------
    from pcaccumulation_tpu_torch.train.loss import fuse_loss
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    cfg_t = load_config()  # unchanged: B=4, iter_size 2, random keypoint draw
    bsz, iter_size = cfg_t["train"]["batch_size"], cfg_t["train"]["iter_size"]
    t0 = time.perf_counter()
    scenes_t = default_scenes(cfg_t, 2 * bsz)
    train_batches = [port.to_device(collate(scenes_t[i * bsz:(i + 1) * bsz])) for i in range(2)]
    log(f"train batches: 2 of B={bsz} ({time.perf_counter() - t0:.1f} s host prep)")
    torch.manual_seed(SEED)
    model_t = port.build_model(cfg_t)
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    n_warm, n_timed = 3, 4
    try:
        def trainer():
            # the loader is only sized here (updates per epoch); steps take batches directly
            return Trainer(cfg_t, model_t, {"train": train_batches}, save_dir=run_dir)

        warm = trainer()
        for i in range(n_warm):
            warm.train_step(train_batches[i % 2], warm.step_generator(0, "train", i))
        tr = trainer()
        before = [p.detach().clone() for p in tr.params]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seg_pool.launches = seg_pool_backward.launches = 0
        row_shift_blocks.launches = row_shift_blocks_backward.launches = 0
        micro_ms, step_stats = [], []
        for i in range(n_timed):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            step_stats.append(tr.train_step(train_batches[i % 2], tr.step_generator(1, "train", i)))
            end.record()
            micro_ms.append(sync_ms(start, end))
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        train_launches = {"seg_pool": seg_pool.launches,
                          "seg_pool_backward": seg_pool_backward.launches,
                          "row_shift_blocks": row_shift_blocks.launches,
                          "row_shift_blocks_backward": row_shift_blocks_backward.launches}
        want_launches = {"seg_pool": 2 * n_timed, "seg_pool_backward": 2 * n_timed,
                         "row_shift_blocks": 3 * n_timed, "row_shift_blocks_backward": 0}
        if train_launches != want_launches:
            fail(f"kernel launches on the train path: {train_launches} for {n_timed} micro-steps "
                 f"(want {want_launches})")
        for i, st in enumerate(step_stats):
            for key, v in st.items():
                vals = v.values() if isinstance(v, dict) else [v]
                if not all(bool(torch.isfinite(torch.as_tensor(a)).all()) for a in vals):
                    fail(f"train micro-step {i}: non-finite {key}")
        if tr.optimizer.count != n_timed // iter_size or tr.optimizer.n_skipped:
            fail(f"Adam's step count {tr.optimizer.count} (skipped {tr.optimizer.n_skipped}) "
                 f"after {n_timed} micro-steps at iter_size {iter_size}")
        moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, tr.params))
        if moved < len(tr.params) // 2:
            fail(f"only {moved} of {len(tr.params)} parameters moved")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    update_ms = [sum(micro_ms[i:i + iter_size]) for i in range(0, n_timed, iter_size)]
    micro_med = statistics.median(micro_ms)
    log(f"train path: {n_timed} micro-steps launched " + ", ".join(
        f"{k} {v}x" for k, v in train_launches.items()) + f"; Adam step {tr.optimizer.count}, "
        f"{moved} of {len(tr.params)} parameters moved; loss "
        + ", ".join(f"{float(st['loss']):.4f}" for st in step_stats))
    log(f"train micro-step (B={bsz}, default config, CUDA events): median {micro_med:.3f} ms of "
        f"{n_timed} ({', '.join(f'{t:.3f}' for t in micro_ms)}); per optimizer update "
        f"(iter_size {iter_size}) median {statistics.median(update_ms):.3f} ms; peak memory "
        f"{peak_gib:.3f} GiB on {smi}")

    # ---- 8. the card's gradient against the CPU's ------------------------------
    # Same weights and batch, B=1, eval BN, deterministic keypoints, full
    # width. The TPointNet objective reaches the STPN and the TPointNet's
    # embedding MLPs through max pools (instance and frame) whose near ties
    # turn rounding (~1e-7) into another winner, so its gradient at those
    # leaves is not reproducible even on one card: two runs of the same
    # step, whose atomics add in another order, differ there by ~10 %
    # (measured below). Hence: (a) FuseLoss without the TPointNet objective,
    # every leaf held to the per-leaf criterion; (b) the whole FuseLoss,
    # every leaf not upstream of those pools held to it, the others reported
    # against the card's own spread.
    cfg_g = load_config()
    cfg_g["pose_estimation"]["deterministic_sampling"] = True
    model_g = port.build_model(cfg_g)
    scaled_init(model_g, SEED)
    model_c = port.build_model(cfg_g, device="cpu")
    model_c.load_state_dict({k: v.cpu() for k, v in model_g.state_dict().items()})
    batch_g = {"gpu": port.to_device(collate(scenes_t[:1])),
               "cpu": port.to_device(collate(scenes_t[:1]), "cpu")}

    def loss_and_grads(where, weights):
        mdl = model_g if where == "gpu" else model_c
        mdl.zero_grad(set_to_none=True)
        bt = batch_g[where]
        st = fuse_loss(mdl(bt, mode="train"), bt, weights, cfg_g["capacity"]["max_instances"])
        st["loss"].backward()
        return float(st["loss"].detach()), {
            n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
            for n, p in mdl.named_parameters()}

    t0 = time.perf_counter()
    no_obj = dict(cfg_g["loss"], w_obj_loss=0.0)
    runs = {"a": {w: loss_and_grads(w, no_obj) for w in ("gpu", "cpu")},
            "b": {w: loss_and_grads(w, cfg_g["loss"]) for w in ("gpu", "cpu")}}
    runs["b"]["gpu2"] = loss_and_grads("gpu", cfg_g["loss"])
    for part, r in runs.items():
        if abs(r["gpu"][0] - r["cpu"][0]) > 1e-3 * max(1.0, abs(r["cpu"][0])):
            fail(f"GPU vs CPU loss ({part}): {r['gpu'][0]} vs {r['cpu'][0]}")
    ga, ca = runs["a"]["gpu"][1], runs["a"]["cpu"][1]
    checked, noise, w_rel, w_cos, w_leaf = leaf_criterion(ca, ga)
    log(f"GPU vs CPU gradient (a) FuseLoss without the TPointNet objective (B=1, eval BN, "
        f"deterministic keypoints, full width, nothing cut): loss {runs['a']['gpu'][0]:.6f} vs "
        f"{runs['a']['cpu'][0]:.6f}; {checked} leaves within rel-norm 0.05 and cosine 0.995, "
        f"{noise} below the noise floor; worst leaf {w_leaf} rel-norm {w_rel:.3e} cosine "
        f"{w_cos:.6f}")
    gb, cb, gb2 = runs["b"]["gpu"][1], runs["b"]["cpu"][1], runs["b"]["gpu2"][1]
    pooled = ("motionhead.", "reconstructor.alignment.motion_embed.",
              "reconstructor.alignment.geo_embed.", "reconstructor.alignment.pos_embed.")
    outside = [n for n in gb if not n.startswith(pooled)]
    checked, noise, w_rel, w_cos, w_leaf = leaf_criterion({n: cb[n] for n in outside},
                                                          {n: gb[n] for n in outside})
    def cosine(ga_, gb_):
        a_, b_ = (torch.cat([g[n].double().ravel() for n in gb]) for g in (ga_, gb_))
        return float(a_ @ b_ / (a_.norm() * b_.norm()))

    # a sanity bound only: the pooled leaves' spread alone takes two runs on
    # the card to a whole-gradient cosine of ~0.996
    cos_all, cos_self = cosine(gb, cb), cosine(gb, gb2)
    if cos_all <= 0.95:
        fail(f"GPU vs CPU whole-gradient cosine {cos_all:.6f}")

    def worst(ga_, gb_):
        return max((float((ga_[n] - gb_[n]).double().norm())
                    / max(float(ga_[n].norm()), float(gb_[n].norm()), 1e-30), n)
                   for n in ga_ if n.startswith(pooled))

    pool_cpu, pool_self = worst(gb, cb), worst(gb, gb2)
    log(f"GPU vs CPU gradient (b) whole FuseLoss: loss {runs['b']['gpu'][0]:.6f} vs "
        f"{runs['b']['cpu'][0]:.6f}; {checked} leaves not upstream of the TPointNet's max pools "
        f"within rel-norm 0.05 and cosine 0.995, {noise} below the noise floor, worst {w_leaf} "
        f"rel-norm {w_rel:.3e} cosine {w_cos:.6f}; whole-gradient cosine {cos_all:.8f} "
        f"(two runs on the card: {cos_self:.8f}); "
        f"the {len(gb) - len(outside)} leaves upstream of them: worst rel-norm "
        f"{pool_cpu[0]:.3e} ({pool_cpu[1]}) against the CPU, {pool_self[0]:.3e} "
        f"({pool_self[1]}) between two runs on the card ({time.perf_counter() - t0:.1f} s)")

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
    # the gradients at the train path's shapes
    y4 = seg_pool_plain(x4, ids4, "max")
    n4, c4 = x4.shape
    # reads x, y, g and ids once, writes the gradient once; a compare, a
    # sum over the [N, 2C] pack, a divide and a select per element
    k1b_bound, k1b_by = bound_ms(4 * n4 * c4 * 4 + n4 * 4, 5 * n4 * c4)
    kernels["seg_pool_backward"] = {
        "name": "seg_pool_backward", "route": "cuda",
        "source": "pcaccumulation_tpu_torch/csrc/segscan.cu",
        "replaces": "pcaccumulation_tpu/kernels/segscan.py:271",
        "launches": train_launches["seg_pool_backward"], "max_abs_err": k1b_err,
        "ms": cuda_ms(lambda: seg_pool_backward(x4, ids4, y4, g4)),
        "plain_ms": cuda_ms(lambda: seg_pool_backward_plain(x4, ids4, y4, g4)),
        "bound_ms": k1b_bound, "bound_by": k1b_by,
        "library_ms": None,  # no single PyTorch call computes the tie-split gradient
    }
    ki_b = kn.clamp(-w, w).to(torch.int32)
    fr_b = (-shifts - kn).float()
    g2_g = g2.reshape(r, w, nb, ctot // nb).permute(0, 2, 3, 1).reshape(r * nb, ctot // nb, 1, w)
    xs_b = (torch.arange(w, device=dev, dtype=torch.float32)[None, :]
            + (ki_b.float() + fr_b).reshape(-1, 1))
    grid_b = torch.stack([(2 * xs_b + 1) / w - 1, torch.zeros_like(xs_b)], -1)[:, None]
    lib_b = torch.nn.functional.grid_sample(g2_g, grid_b, mode="bilinear", padding_mode="zeros",
                                            align_corners=False)
    lib_b_err = float((lib_b.reshape(r, nb, ctot // nb, w).permute(0, 3, 1, 2).reshape(r, w, ctot)
                       - want_g).abs().max())
    if lib_b_err > 1e-3:
        fail(f"the grid_sample yardstick does not compute the K2 gradient (err {lib_b_err:.2e})")
    kernels["row_shift_blocks_backward"] = {
        "name": "row_shift_blocks_backward", "route": "cuda",
        "source": "pcaccumulation_tpu_torch/csrc/row_shift.cu",
        "replaces": "pcaccumulation_tpu/ops/bilinear.py:485",
        "launches": train_launches["row_shift_blocks_backward"], "max_abs_err": k2b_err,
        "ms": cuda_ms(lambda: row_shift_blocks_backward(g2, shifts, 5)),
        "plain_ms": cuda_ms(lambda: row_shift_blocks_plain(g2, ki_b, fr_b, 5)),
        "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
            g2_g, grid_b, mode="bilinear", padding_mode="zeros", align_corners=False)),
    }
    for kern in kernels.values():
        log(f"{kern['name']}: {kern['ms']:.4f} ms (bound {kern['bound_ms']:.4f} ms by "
            f"{kern['bound_by']}; plain {kern['plain_ms']:.4f} ms; library "
            f"{kern['library_ms']})")
    log(f"grid_sample yardstick max abs err vs plain: {lib_err:.2e}")
    log(f"forward_ms {fwd_ms:.3f} train_micro_step_ms {micro_med:.3f} "
        f"train_update_ms {statistics.median(update_ms):.3f} train_peak_gib {peak_gib:.3f} "
        f"on {smi}")

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
