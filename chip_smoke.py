"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--only kernels]

Builds the port's CUDA kernels from `pcaccumulation_tpu_torch/csrc/` and its
native host library from `pcaccumulation_tpu_torch/native/pcacc_host.cpp`
(the host compiler; a failed build ends the run with its output), holds
the host library against numpy references on the card's host
(`host_prep_phase`: the voxeliser against a first-come reference with and
without pillar overflow, the counting sort against the stable argsort,
`prep_sample`'s stages timed on the native path and under
`PCACC_NATIVE=0`, at the default and the nuScenes smoke scans), holds
each kernel and each kernel's gradient against its plain PyTorch version on
the card (K1 seg_pool and its gradient at the tile edges, two calls
bit-identical, timed through the wrapper and through the C entry point;
K2 row_shift_blocks at T=5, at T=11 and at C=9, K3
row_shift through warp_bev / warp_bev_batch, K4 nn at the ICP shapes with
and without a query mask and with references packed once, and the Chamfer
distance on K4; the bf16 kernels of K1 at the tile edges, on rows 2 and
8 bytes off a 16-byte boundary and at [120000, 32] and [480000, 32] and of
K2 at [288, 288, 352] nb=11 and at C=9, K3 in bf16 once; the bf16
gradients of K1 at the tile edges, with a misaligned cotangent and at
[480000, 32] and of K2 at [288, 288, 352] nb=11; K1's bf16 kernels launch
by launch, both designs (`k1_bf16_split`), their resident blocks per SM
(`k1_bf16_kernel_info`) and the host's us per wrapper call), then drives
the paths of the port at the full default
config (configs/default.yaml: T=5, 288x288 BEV, 90k points, 30k pillars,
float32) with seeded random weights on synthetic scenes, the FB and MOS
heads' biases set to scene 0's label shares (`calibrate_heads`), so that
the ego head sees background:
- the val-mode MotionNet forward (B=1): held against the CPU's forward on
  the same weights and batch (the ego poses away from the identity),
  kernel launches counted, timed;
- the test-mode forward (B=1) with the ego and instance ICPs on at 50
  iterations: finite, rigid poses, launches counted, timed with the share
  of clustering and ICP; at 3 iterations held against the CPU with the
  card's cluster labels injected (the ego pose against the CPU's ego ICP
  rerun with K4's arithmetic, and against the plain version within the
  tolerance plus the CPU's own spread), the instance ICP alone held against the
  CPU's on the card's inputs (but the slices that the CPU moves itself when
  it rounds the distances as K4 does), and the clusterer held against the
  CPU's on the card's inputs (pair agreement);
- the Tester over the 3 test scenes of data/synthetic (configs/
  synthetic.yaml, both ICPs on) into a temporary directory, the dumps'
  schema checked and read by the port's evaluation;
- the training micro-step through the port's Trainer (B=4, iter_size 2,
  random keypoint draw): FuseLoss, backward, optimizer; loss terms finite,
  parameters moved, kernel launches counted, timed, peak memory; and the
  card's gradient held against the CPU's (B=1, eval BN, deterministic
  keypoints);
- the nuScenes preset (configs/nuscene.yaml: T=11, 288x288 BEV, 120,000
  points, 40,000 pillars, compute_dtype bfloat16) on calibrated heads:
  the bf16 val forward (launch counts per kernel and dtype: K1-bf16 2 and
  K2-bf16 3 per forward, no float32 K1 or K2) and the test forward with
  both ICPs, each held against the float32 forward on the same weights
  and batch and timed beside it; the CLI's test mode on the preset;
- the nuScenes preset's bf16 training: `Trainer.train_step` at B=4 and
  iter_size 2 (launch counts per kernel, dtype and direction: K1-bf16
  forward and gradient 2 and K2-bf16 forward 3 per micro-step, no K2
  gradient, no float32 K1 or K2), timed beside the float32 micro-step with
  peak memory; the bf16 gradient held against the float32 one per leaf
  (`bf16_leaf_criterion`); the CLI's train mode on the preset for one
  epoch, with its checkpoints;
- serving (`serving_phase`), on the nuScenes preset in bf16 (the nuScenes
  phase's weights) and on the default config in float32 (the main path's
  weights): `Predictor.predict` against a direct `MotionNet(mode="test")`
  call on the same batch (launch counts: K1 2 and K2 3 per predict, in the
  config's dtype, nothing else), timed on the host clock and the step on
  CUDA events; `predict_stream` over 8 scans against 8 `predict` calls, the
  serial and streamed rates in sequences per second and the H2D bytes per
  call; the host side of one predict split by stage (`serve_host_split`),
  and predict, serial and streamed again on numpy's preparation path
  (`PCACC_NATIVE=0`) in the same process; `export` on the card and
  `ExportedPredictor` on the artifact
  (labels equal, floats within 1e-5, the same launch counts); the tracker
  over the streamed outputs; and on the default config with both ICPs at
  50 iterations (3 scans, export included: K4 100 launches per predict,
  live and exported, inside the graph);
- the options of `configs/default.yaml` beyond the defaults
  (`options_phase`, `nuscenes_full_phase`, `remat_phase`,
  `process_loader_phase`, `options_cli_phase`): the val forward with
  `seq_pose: chain`, `seq_pose: full` and `stpn.n_band_layers: 2` at full
  width, each held against the CPU and timed beside `skip`; the nuScenes
  bf16 val forward with `seq_pose: full` (55 pairs) against float32; the
  nuScenes bf16 train micro-step with `train.remat` against a plain one
  on the same weights, batch and generator seed (every gradient leaf and
  running statistic), both timed with peak memory; forked loader workers
  (`worker_mode: process`) against threads and under the Trainer; the CLI
  in train, val and test mode with these options;
- the Trainer's step reproducible (`determinism_phase`: default float32 and
  nuScenes bf16, two steps bit-equal, the ops torch warns about, the cost
  of deterministic algorithms and the noise-leaf split under torch's
  default ones); the data-parallel path in an in-process NCCL group of
  world 1 (`ddp_world1_phase`: with and without ZeRO-1, bit-equal to the
  plain step, K1 and K2 launched on it, timed beside it); and
  `torchrun --nproc_per_node=1` over the CLI on the nuScenes preset with
  its orbax (torch.distributed.checkpoint) checkpoints, read back by the
  Tester (`torchrun_cli_phase`);
- the frame and spatial axes (`mesh_phase`): two processes sharing the
  card over gloo, the default float32 val forward at F=2 and at S=2, the
  nuScenes micro-step at F=2 in float32 and in bf16, and a predict at S=2,
  each against this process's one-process run (K1 and K2 counted on each
  rank, timed beside it);
- training from scratch (`train_from_scratch_phase`): the model built on
  the card from the seed's generator, bit-equal to the CPU build and every
  leaf within the JAX package's initial distributions; then the
  convergence protocol's CLI run (configs/synthetic.yaml, B=4, seed 42,
  data/synthetic_conv) for 2 epochs, the counts zeroed before it: the
  epoch-2 train loss below epoch 1's, every val metric finite.
Any failure exits non-zero. The last two lines of stdout are the `kernels`
JSON line and the result line `{"ok": true, "device": {...}}`. Without a
CUDA device it exits 1 and prints no result. With `--only kernels` it stops
after the build (with ptxas's report on csrc/segscan.cu) and the kernel
phases, prints K1's rows and the bf16 rows of the `kernels` line
(launches null: no path ran) and no result line.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pcaccumulation_tpu_torch.utils.leaf_criteria import (BF16_LEAF_COS, BF16_LEAF_REL, POOLED,
                                                          STRUCTURAL_ZERO, bf16_misses,
                                                          leaf_distances, noise_floor)

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


def k1_inputs(gen: torch.Generator, dev, n: int = 90000) -> tuple[torch.Tensor, torch.Tensor]:
    """[n, 32] f32 and sorted int32 ids: short runs, runs longer than
    any tile, and one run of 40,000 rows of -1e30 (a padded tail)."""
    c, tail = 32, 40000
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


def k2_inputs(gen: torch.Generator, dev, nb: int = 5, c: int = 32):
    """img [288, 288, nb*c] f32, shifts [288, nb]: negative, fractional,
    beyond the row (|k| > W) and zero."""
    r, w = 288, 288
    img = torch.randn((r, w, nb * c), generator=gen)
    shifts = (torch.rand((r, nb), generator=gen) - 0.5) * 40.0
    shifts[:, 0] = 0.0                      # frame 0: pass-through
    shifts[::7, 1] = -(w + 50.5)            # whole row out of range
    shifts[3::7, 2] = w + 13.25
    shifts[5::11, 3] = -3.0                 # integer, negative
    return img.to(dev), shifts.to(dev)


def k2_check(gen: torch.Generator, dev, nb: int, c: int):
    """K2 forward and gradient (one launch each) against the plain version
    on `k2_inputs(nb, c)` and a random cotangent g, within 1e-6; a zero
    shift passes through. Returns (img, shifts, g, the two plain results,
    the two max abs errors)."""
    from pcaccumulation_tpu_torch.kernels.row_shift import (
        row_shift_blocks,
        row_shift_blocks_backward,
        row_shift_blocks_plain,
    )

    img, shifts = k2_inputs(gen, dev, nb, c)
    g = torch.randn(img.shape, generator=gen).to(dev)
    w = img.shape[1]
    ig = img.clone().requires_grad_(True)
    before = row_shift_blocks.launches, row_shift_blocks_backward.launches
    out = row_shift_blocks(ig, shifts, nb)
    out.backward(g)
    if (row_shift_blocks.launches, row_shift_blocks_backward.launches) != (before[0] + 1,
                                                                           before[1] + 1):
        fail(f"K2 at nb={nb}, C={c}: forward and gradient did not launch the kernel once each")
    errs, wants = [], []
    for x, s, got in ((img, shifts, out.detach()), (g, -shifts, ig.grad)):
        k = torch.floor(s)
        wants.append(row_shift_blocks_plain(x, k.clamp(-w, w).to(torch.int32), (s - k).float(),
                                            nb))
        torch.cuda.synchronize()
        errs.append(float((got - wants[-1]).abs().max()))
        if not torch.allclose(got, wants[-1], rtol=1e-6, atol=1e-6):
            fail(f"K2 at nb={nb}, C={c} differs from the plain version (max abs err {errs[-1]})")
    if not torch.equal(out[..., :c], img[..., :c]):
        fail(f"K2 at nb={nb}, C={c}: zero shift is not a pass-through")
    return img, shifts, g, wants, errs


def k1_batch_inputs(gen: torch.Generator, dev, b: int, n: int = 90000):
    """b samples of `k1_inputs` stacked, ids offset per sample as the
    pillar encoder offsets them: x [b*n, 32], sorted ids."""
    xs, ids = zip(*(k1_inputs(gen, "cpu", n) for _ in range(b)))
    offs, out = 0, []
    for i in ids:
        out.append(i + offs)
        offs = int(out[-1][-1]) + 1
    return torch.cat(xs).to(dev), torch.cat(out).to(dev)


K1_TILE = 256  # K1's tile rows (TILE_ROWS of kernels/segscan.py)
K1_EDGES = ["n=1", f"n={K1_TILE - 1}", f"n={K1_TILE}", f"n={K1_TILE + 1}", f"n={2 * K1_TILE + 3}",
            "on_tile_edges", "runs_R_R+1", "on_tile_edges_128", "one_run", "tail_90000",
            "b4_360000"]


def k1_edge_case(name: str, c: int, rng: np.random.Generator):
    """(x, ids, g) at one of K1's tile edges (tests/test_torch_kernels.py
    holds the same cases): N in {1, R-1, R, R+1, 2R+3} with short runs, runs
    ending exactly on tile boundaries (R = 256 rows) and on half-tile
    boundaries, runs of R and R+1 rows (and of 128 and 129), one run over
    all rows, a sample of 90,000 rows with runs of 300-3,000 rows and a
    40,000-row tail at -1e30, and four such samples (360,000 rows). Every
    other row's values are rounded to halves, so maxima tie."""
    r = K1_TILE

    def from_lengths(lengths):
        return np.repeat(np.arange(len(lengths), dtype=np.int32) * 3, lengths)

    if name == "b4_360000":
        parts = [k1_edge_case("tail_90000", c, rng) for _ in range(4)]
        offs = np.cumsum([0] + [int(p[1][-1]) + 1 for p in parts[:-1]]).astype(np.int32)
        return tuple(np.concatenate(a) for a in zip(*[(p[0], p[1] + o, p[2])
                                                       for p, o in zip(parts, offs)]))
    if name.startswith("n="):
        n = int(name[2:])
        ids = np.sort(rng.integers(0, n // 3 + 1, size=n)).astype(np.int32)
    elif name == "on_tile_edges":
        ids = from_lengths([r, r, 5, r - 5, r + 1, r - 1, 3])
    elif name == "runs_R_R+1":
        ids = from_lengths([7, r, r + 1, 1, 2 * r + 9, 30])
    elif name == "on_tile_edges_128":  # runs of 128 and 129 rows on half-tile edges
        ids = from_lengths([128, 128, 5, 123, 129, 127, 3, 128, 129])
    elif name == "one_run":
        ids = np.zeros(10 * r + 17, np.int32)
    else:
        lengths = []
        while sum(lengths) < 50000:
            lengths.append(int(rng.integers(300, 3000)) if rng.random() < 0.02
                           else int(rng.integers(1, 12)))
        body = from_lengths(lengths)[:50000]
        ids = np.concatenate([body, np.full(40000, body[-1] + 7, np.int32)])
    n = ids.size
    x = rng.standard_normal((n, c)).astype(np.float32)
    x[::2] = np.round(x[::2] * 2) / 2
    if name == "tail_90000":
        x[n - 40000:] = -1e30
    return x, ids, rng.standard_normal((n, c)).astype(np.float32)


def k1_check(what: str, x, ids, g) -> tuple[float, float, float]:
    """K1 forward and gradient against their plain versions on the card:
    max bit-exact; sum and the gradient within 1e-5 of the segment's sum of
    |.| + 1e-6 of the plain versions evaluated in float64 (the kernel adds
    in a fixed tree of depth ~25; the float32 plain sum on the card adds a
    run's rows one by one through atomics and is 2e-4 off over the
    40,000-row tail); the gradient exactly 0 off the tie set; two calls of
    the sum and of the gradient torch.equal. Returns the max abs errors of
    (max, sum, gradient)."""
    from pcaccumulation_tpu_torch.kernels.segscan import (
        seg_pool,
        seg_pool_backward,
        seg_pool_backward_plain,
        seg_pool_plain,
    )

    y = seg_pool(x, ids, "max")
    want_y = seg_pool_plain(x, ids, "max")
    err_y = float((y - want_y).abs().max())
    if not torch.equal(y, want_y):
        fail(f"K1 max ({what}) differs from the plain version (max abs err {err_y})")
    s1, s2 = seg_pool(x, ids, "sum"), seg_pool(x, ids, "sum")
    want_s = seg_pool_plain(x.double(), ids, "sum")
    if not bool(((s1 - want_s).abs() <= 1e-5 * seg_pool_plain(x.abs(), ids, "sum") + 1e-6).all()):
        fail(f"K1 sum ({what}) differs from the plain version beyond 1e-5 of sum|x|")
    if not torch.equal(s1, s2):
        fail(f"K1 sum ({what}): two calls differ")
    b1, b2 = seg_pool_backward(x, ids, y, g), seg_pool_backward(x, ids, y, g)
    want_b = seg_pool_backward_plain(x.double(), ids, y.double(), g.double())
    if not bool(((b1 - want_b).abs() <= 1e-5 * seg_pool_plain(g.abs(), ids, "sum") + 1e-6).all()):
        fail(f"K1 gradient ({what}) differs from the plain one beyond 1e-5 of sum|g|")
    if not bool((b1[x != y] == 0).all()):
        fail(f"K1 gradient ({what}) is not zero off the tie set")
    if not torch.equal(b1, b2):
        fail(f"K1 gradient ({what}): two calls differ")
    torch.cuda.synchronize()
    return err_y, float((s1 - want_s).abs().max()), float((b1 - want_b).abs().max())


def k1_edge_phase(dev) -> None:
    """`k1_check` at every tile edge of `K1_EDGES` at C = 32, and at C = 9
    (one column per thread) and C = 128 (four column tiles) on the small
    cases."""
    rng = np.random.default_rng(SEED)
    cases = [(name, 32) for name in K1_EDGES]
    cases += [(name, c) for c in (9, 128) for name in K1_EDGES[:9]]
    worst_s = worst_b = 0.0
    for name, c in cases:
        x, ids, g = (torch.from_numpy(a).to(dev) for a in k1_edge_case(name, c, rng))
        _, err_s, err_b = k1_check(f"{name}, C={c}", x, ids, g)
        worst_s, worst_b = max(worst_s, err_s), max(worst_b, err_b)
    log(f"K1 at the tile edges ({len(cases)} cases: {', '.join(K1_EDGES)} at C=32; the first 9 "
        f"at C=9 and C=128): max bit-exact; sum max abs err {worst_s:.2e}, gradient "
        f"{worst_b:.2e} (tol 1e-5 of the segment's sum|.| + 1e-6); the gradient 0 off the tie "
        f"set; two calls of the sum and of the gradient torch.equal")


def cuda_ms_queued(fn, iters: int = 100) -> float:
    """Mean device ms per call of fn over `iters` calls enqueued behind a
    30 ms spin of the card (torch.cuda._sleep), so that they run back to
    back however slowly the host enqueues them."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, flush: torch.Tensor, iters: int = 20) -> float:
    """Mean ms of one call of fn with the L2 cache flushed before it (a
    write of `flush`, untimed), by CUDA events around each call."""
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def k1_timings(x, ids, x4, ids4, g4, k1_err: float, k1b_err: float) -> dict:
    """The rows of the `kernels` line for K1's forward at [90000, 32] and
    its gradient at [360000, 32] (launches None until the main path's
    counts are read, so `--only kernels` prints no count it did not read):
    through the wrapper (back to back, as every kernel's `ms`), through the
    C entry point alone (queued behind a spin of the card: the device time;
    back to back from the host; with the L2 cache flushed before each
    call), the plain versions, the bounds; the host's time to enqueue one
    PyTorch op; the bytes that one gradient call allocates besides its
    output."""
    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.kernels.segscan import (
        TILE_ROWS,
        seg_pool,
        seg_pool_backward,
        seg_pool_backward_plain,
        seg_pool_plain,
    )

    lib = build.load_library("segscan")
    stream = build.stream(x)
    flush = torch.empty(64 * 2 ** 20, device=x.device)  # 256 MB, > the 50 MB L2
    n, c = x.shape
    out = torch.empty_like(x)
    scratch = torch.empty(-(-n // TILE_ROWS) * (2 * c + 1), device=x.device)

    def entry_fwd():
        lib.segpool_forward(x.data_ptr(), ids.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                            scratch.numel(), n, c, 0, stream)

    y4 = seg_pool_plain(x4, ids4, "max")
    n4, c4 = x4.shape
    out4 = torch.empty_like(x4)
    scratch4 = torch.empty(-(-n4 // TILE_ROWS) * (4 * c4 + 1), device=x.device)

    def entry_bwd():
        lib.segpool_backward_max(x4.data_ptr(), y4.data_ptr(), g4.data_ptr(), ids4.data_ptr(),
                                 out4.data_ptr(), scratch4.data_ptr(), scratch4.numel(), n4, c4,
                                 stream)

    k1_bound, k1_by = bound_ms(2 * n * c * 4 + n * 4, n * c)
    # reads x, y, g and ids once, writes the gradient once; a compare, two
    # sums, a divide and a select per element
    k1b_bound, k1b_by = bound_ms(4 * n4 * c4 * 4 + n4 * 4, 5 * n4 * c4)
    rows = {
        "seg_pool": {
            "name": "seg_pool", "route": "cuda",
            "source": "pcaccumulation_tpu_torch/csrc/segscan.cu",
            "replaces": "pcaccumulation_tpu/kernels/segscan.py:153",
            "launches": None, "max_abs_err": k1_err,
            "ms": cuda_ms(lambda: seg_pool(x, ids, "max"), iters=200),
            "plain_ms": cuda_ms(lambda: seg_pool_plain(x, ids, "max")),
            "bound_ms": k1_bound, "bound_by": k1_by,
            "library_ms": None,  # no single PyTorch call reduces and broadcasts back
            "entry_ms": cuda_ms_queued(entry_fwd, iters=200),
            "entry_b2b_ms": cuda_ms(entry_fwd, iters=200),
            "entry_cold_ms": cuda_ms_cold(entry_fwd, flush),
        },
        "seg_pool_backward": {
            "name": "seg_pool_backward", "route": "cuda",
            "source": "pcaccumulation_tpu_torch/csrc/segscan.cu",
            "replaces": "pcaccumulation_tpu/kernels/segscan.py:271",
            "launches": None, "max_abs_err": k1b_err,
            "ms": cuda_ms(lambda: seg_pool_backward(x4, ids4, y4, g4), iters=50),
            "plain_ms": cuda_ms(lambda: seg_pool_backward_plain(x4, ids4, y4, g4)),
            "bound_ms": k1b_bound, "bound_by": k1b_by,
            "library_ms": None,  # no single PyTorch call computes the tie-split gradient
            "entry_ms": cuda_ms_queued(entry_bwd, iters=100),
            "entry_b2b_ms": cuda_ms(entry_bwd, iters=50),
            "entry_cold_ms": cuda_ms_cold(entry_bwd, flush),
        },
    }
    del flush
    tiny = torch.zeros(1, device=x.device)
    t0 = time.perf_counter()
    for _ in range(2000):
        tiny.add(1.0)
    host_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seg_pool_backward(x4, ids4, y4, g4)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - x4.numel() * 4
    for key, shape in (("seg_pool", (n, c)), ("seg_pool_backward", (n4, c4))):
        r = rows[key]
        log(f"K1 {key} {list(shape)}: wrapper {r['ms']:.4f} ms back to back; C entry point "
            f"{r['entry_ms']:.4f} ms on the card (queued), {r['entry_b2b_ms']:.4f} ms back to "
            f"back from the host, {r['entry_cold_ms']:.4f} ms with the L2 flushed; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['entry_ms']:.3f} of it "
            f"on the card; plain {r['plain_ms']:.4f} ms")
    log(f"K1: the host enqueues one elementwise PyTorch op in {host_us:.1f} us; one gradient "
        f"call at [{n4}, {c4}] allocates {extra} bytes besides its output (scratch "
        f"{scratch4.numel() * 4} bytes)")
    return rows


def bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values (8 significant bits) at |a|, float32."""
    a = a.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def k1_bf16_check(what: str, x: torch.Tensor, ids: torch.Tensor) -> tuple[float, float]:
    """K1's bf16 kernel against its plain version (float32 reduction, one
    rounding) on bf16 x: max torch.equal; sum within 1 bf16 ulp of the
    result plus 1e-5 of the segment's sum of |x| (the two float32 sums add
    in other orders); two calls of the sum torch.equal. One launch per call
    on `seg_pool.launches_bf16`, none on the float32 count. Returns the max
    abs errors of (max, sum)."""
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_plain

    before = seg_pool.launches, seg_pool.launches_bf16
    y = seg_pool(x, ids, "max")
    if (seg_pool.launches, seg_pool.launches_bf16) != (before[0], before[1] + 1):
        fail(f"K1 bf16 ({what}): not one launch of the bf16 kernel (counts {before} -> "
             f"{(seg_pool.launches, seg_pool.launches_bf16)})")
    want_y = seg_pool_plain(x, ids, "max")
    if y.dtype != torch.bfloat16 or not torch.equal(y, want_y):
        fail(f"K1 bf16 max ({what}) differs from the plain version "
             f"({float((y.float() - want_y.float()).abs().max())})")
    s1, s2 = seg_pool(x, ids, "sum"), seg_pool(x, ids, "sum")
    want_s = seg_pool_plain(x, ids, "sum").float()
    tol = (bf16_ulp(torch.maximum(want_s.abs(), s1.float().abs()))
           + 1e-5 * seg_pool_plain(x.float().abs(), ids, "sum"))
    err_s = (s1.float() - want_s).abs()
    if not bool((err_s <= tol).all()):
        fail(f"K1 bf16 sum ({what}) beyond 1 bf16 ulp of the plain version")
    if not torch.equal(s1, s2):
        fail(f"K1 bf16 sum ({what}): two calls differ")
    torch.cuda.synchronize()
    return float((y.float() - want_y.float()).abs().max()), float(err_s.max())


def misaligned(t: torch.Tensor, elems: int) -> torch.Tensor:
    """A contiguous copy of t whose data starts `elems` elements past an
    aligned allocation (bf16: 1 = 2 bytes, 4 = 8 bytes off a 16-byte
    boundary)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


K1_BF16_KERNELS = ("forward_first", "forward_second", "gradient_first", "gradient_second")
K1_BF16_INFO = ("blocks_per_sm", "registers", "spill_bytes", "shared_bytes", "threads")


def k1_bf16_kernel_info() -> dict:
    """{design: {kernel: resident blocks per SM, registers, spill bytes,
    shared bytes, threads}} of K1's bf16 kernels at C = 32, from the CUDA
    runtime (`segpool_bf16_kernel_info`): design 0 the two-launch
    seg_partials + seg_tiles (kept for C != 32 and misaligned rows), 1 the
    Hopper path (bf_local + bf_fix)."""
    import ctypes

    from pcaccumulation_tpu_torch.kernels import build

    lib = build.load_library("segscan")
    info = {}
    for design in (0, 1):
        buf = (ctypes.c_int * 20)()
        if lib.segpool_bf16_kernel_info(design, ctypes.addressof(buf), 20) != 4:
            fail(f"segpool_bf16_kernel_info refused design {design}")
        info[design] = {name: dict(zip(K1_BF16_INFO, buf[5 * i: 5 * i + 5]))
                        for i, name in enumerate(K1_BF16_KERNELS)}
    return info


def k1_bf16_split(x: torch.Tensor, ids: torch.Tensor, y=None, g=None) -> dict:
    """Each launch of both bf16 designs of K1 alone and the two together on
    one input (the forward's max, or with y and g the gradient of max),
    queued behind a spin (`cuda_ms_queued`; the second launch alone reads
    the scratch a whole call left): {"d<design>_<first|second|both>_ms"}."""
    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.kernels.segscan import scratch_floats

    lib = build.load_library("segscan")
    n, c = x.shape
    op = 0 if y is None else 2
    res = torch.empty_like(x)
    scratch = torch.empty(scratch_floats(n, c, x.dtype, 1 if y is None else 2), device=x.device)
    ptrs = (x.data_ptr(), 0 if y is None else y.data_ptr(), 0 if g is None else g.data_ptr(),
            ids.data_ptr(), res.data_ptr(), scratch.data_ptr(), scratch.numel(), n, c,
            build.stream(x))
    row = {}
    for design in (0, 1):
        if lib.segpool_bf16_phase(design, op, 3, *ptrs) != 0:
            fail(f"segpool_bf16_phase refused design {design} at {[n, c]}")
        for phase, key in ((1, "first"), (2, "second"), (3, "both")):
            row[f"d{design}_{key}_ms"] = cuda_ms_queued(
                lambda: lib.segpool_bf16_phase(design, op, phase, *ptrs), iters=100)
    return row


def host_us_per_call(fn, calls: int = 1000) -> float:
    """The host's us per call of fn over `calls` calls with no synchronise
    between them (the enqueue; the card may still be running)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def log_k1_bf16_split(what: str, split: dict, bound: float, host_us: float) -> None:
    log(f"K1 bf16 {what} per launch (queued): two-launch design first "
        f"{split['d0_first_ms']:.4f} + second {split['d0_second_ms']:.4f} -> both "
        f"{split['d0_both_ms']:.4f} ms; Hopper design bf_local {split['d1_first_ms']:.4f} + "
        f"bf_fix {split['d1_second_ms']:.4f} -> both {split['d1_both_ms']:.4f} ms "
        f"({bound / split['d1_both_ms']:.3f} of the {bound:.4f} ms bound); the host "
        f"{host_us:.1f} us per wrapper call")


def k2_bf16_check(what: str, img: torch.Tensor, shifts: torch.Tensor, nb: int,
                  counted) -> tuple[torch.Tensor, float]:
    """The bf16 row shift (`row_shift_blocks`, or `row_shift` at nb=1)
    against the plain version on the same bf16 image, within 1 bf16 ulp;
    one launch on `counted.launches_bf16`. Returns (plain result, max abs
    error)."""
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift, row_shift_blocks_plain

    w = img.shape[1]
    before = counted.launches, counted.launches_bf16
    got = (row_shift(img, shifts[:, 0]) if counted is row_shift
           else counted(img, shifts, nb))
    if (counted.launches, counted.launches_bf16) != (before[0], before[1] + 1):
        fail(f"{what}: not one launch of the bf16 kernel")
    k = torch.floor(shifts)
    want = row_shift_blocks_plain(img, k.clamp(-w, w).to(torch.int32), (shifts - k).float(), nb)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if got.dtype != torch.bfloat16 or not bool(
            (err <= bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))).all()):
        fail(f"{what} differs from the plain version beyond 1 bf16 ulp ({float(err.max())})")
    return want, float(err.max())


def bf16_kernel_phase(dev, gen) -> dict:
    """The bf16 kernels of K1 and K2 against their plain versions: K1 at
    its tile edges (`K1_EDGES` at C=32, and C=9 on the small cases), on
    rows 2 and 8 bytes off a 16-byte boundary (the two-launch kernels), and
    at the nuScenes pillar encoder's shapes [120000, 32] and [480000, 32]
    (B=4), with K1's per-launch split and resident blocks per SM; K2 at the
    nuScenes warp's [288, 288, 352] nb=11 and at C=9 (the one-channel path), K3 (K2's kernel
    at one shift per row) at [1152, 288, 32] once. Timings at the nuScenes
    shapes against the bounds and, for K2, `F.grid_sample` on the same bf16
    canvas. Returns the two rows of the `kernels` line (launches None until
    the nuScenes path's counts are read)."""
    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.kernels.row_shift import (
        row_shift,
        row_shift_blocks,
        row_shift_blocks_plain,
    )
    from pcaccumulation_tpu_torch.kernels.segscan import scratch_floats, seg_pool, seg_pool_plain

    bf = torch.bfloat16
    rng = np.random.default_rng(SEED + 7)
    cases = [(name, 32) for name in K1_EDGES] + [(name, 9) for name in K1_EDGES[:9]]
    worst = [0.0, 0.0]
    for name, c in cases:
        x, ids, _ = k1_edge_case(name, c, rng)
        errs = k1_bf16_check(f"{name}, C={c}", torch.from_numpy(x).to(dev).to(bf),
                             torch.from_numpy(ids).to(dev))
        worst = [max(a, b) for a, b in zip(worst, errs)]
    # rows 2 and 8 bytes off a 16-byte boundary: the one-column and the
    # 4-column two-launch kernels
    for name, elems in (("tail_90000", 1), ("tail_90000", 4), ("on_tile_edges", 4)):
        x, ids, _ = k1_edge_case(name, 32, rng)
        errs = k1_bf16_check(f"{name}, C=32, {2 * elems} bytes off", misaligned(
            torch.from_numpy(x).to(dev).to(bf), elems), torch.from_numpy(ids).to(dev))
        worst = [max(a, b) for a, b in zip(worst, errs)]
    x, ids = k1_inputs(gen, dev, n=120000)
    xb = x.to(bf)
    k1_err = k1_bf16_check("[120000, 32]", xb, ids)
    # the B=4 micro-step's forward shape, from its own seed
    x4f, ids4f = k1_batch_inputs(torch.Generator().manual_seed(SEED + 9), dev, 4, n=120000)
    x4f = x4f.to(bf)
    k1_err4 = k1_bf16_check("[480000, 32]", x4f, ids4f)
    log(f"K1 bf16 at the tile edges ({len(cases)} cases), on rows 2 and 8 bytes off a 16-byte "
        f"boundary (3 cases) and at [120000, 32] and [480000, 32]: max torch.equal to the plain "
        f"version; sum max abs err {max(worst[1], k1_err[1], k1_err4[1]):.2e} (tol 1 bf16 ulp "
        f"+ 1e-5 of the segment's sum|x|); two calls equal")

    # K2 at the nuScenes warp's shape and at C = 9; K3 at [1152, 288, 32]
    k2_errs = {}
    for nb_x, c_x in ((11, 32), (5, 9)):
        img32, shifts = k2_inputs(gen, dev, nb_x, c_x)
        img_b = img32.to(bf)
        want, k2_errs[(nb_x, c_x)] = k2_bf16_check(f"K2 bf16 nb={nb_x} C={c_x}", img_b, shifts,
                                                   nb_x, row_shift_blocks)
        if nb_x == 11:
            img_n, shifts_n, want_n = img_b, shifts, want
    img3 = torch.randn((1152, 288, 32), generator=gen).to(dev).to(bf)
    sh3 = ((torch.rand((1152, 1), generator=gen) - 0.5) * 40.0).to(dev)
    _, k3_err = k2_bf16_check("K3 bf16 [1152, 288, 32]", img3, sh3, 1, row_shift)
    log(f"K2 bf16 [288, 288, 352] nb=11: max abs err {k2_errs[(11, 32)]:.2e}, [288, 288, 45] "
        f"nb=5 C=9: {k2_errs[(5, 9)]:.2e}; K3 bf16 [1152, 288, 32]: {k3_err:.2e} (tol 1 bf16 "
        f"ulp of the plain version)")

    # timings at the nuScenes shapes
    lib = build.load_library("segscan")
    stream = build.stream(xb)
    n, c = xb.shape

    def entry(xe, ide):
        out = torch.empty_like(xe)
        scratch = torch.empty(scratch_floats(xe.shape[0], c, bf, 1), device=dev)
        return lambda: lib.segpool_forward_bf16(xe.data_ptr(), ide.data_ptr(), out.data_ptr(),
                                                scratch.data_ptr(), scratch.numel(),
                                                xe.shape[0], c, 0, stream)

    entry_fwd, entry_fwd4 = entry(xb, ids), entry(x4f, ids4f)
    k1_bound, k1_by = bound_ms(2 * n * c * 2 + n * 4, n * c)
    k1_bound4 = bound_ms(2 * x4f.numel() * 2 + x4f.shape[0] * 4, x4f.numel())[0]
    r, w, ctot = img_n.shape
    k = torch.floor(shifts_n)
    ki, fr = k.clamp(-w, w).to(torch.int32), (shifts_n - k).float()
    k2_bound, k2_by = bound_ms(2 * img_n.numel() * 2 + shifts_n.numel() * 4, 3 * img_n.numel())
    # yardstick: grid_sample on the bf16 canvas laid out [R*nb, C, 1, W]
    # (the layout copy untimed); its grid is bf16 too (grid_sample takes
    # one dtype), so it computes the shift only to ~0.5 px: a timing only
    nb = 11
    img_g = img_n.reshape(r, w, nb, ctot // nb).permute(0, 2, 3, 1).reshape(r * nb, ctot // nb,
                                                                          1, w)
    xs = (torch.arange(w, device=dev, dtype=torch.float32)[None, :]
          + (ki.float() + fr).reshape(-1, 1))
    grid = torch.stack([(2 * xs + 1) / w - 1, torch.zeros_like(xs)], -1)[:, None].to(bf)
    rows = {
        "seg_pool_bf16": {
            "name": "seg_pool_bf16", "route": "cuda",
            "source": "pcaccumulation_tpu_torch/csrc/segscan.cu",
            "replaces": "pcaccumulation_tpu/kernels/segscan.py:153",
            "launches": None, "max_abs_err": k1_err[0],
            "ms": cuda_ms(lambda: seg_pool(xb, ids, "max"), iters=200),
            "plain_ms": cuda_ms(lambda: seg_pool_plain(xb, ids, "max")),
            "bound_ms": k1_bound, "bound_by": k1_by,
            "library_ms": None,  # no single PyTorch call reduces and broadcasts back
            "entry_ms": cuda_ms_queued(entry_fwd, iters=200),
            # the B=4 micro-step's forward: the C entry point and its bound
            "entry_ms_480000": cuda_ms_queued(entry_fwd4, iters=200),
            "bound_ms_480000": k1_bound4,
        },
        "row_shift_blocks_bf16": {
            "name": "row_shift_blocks_bf16", "route": "cuda",
            "source": "pcaccumulation_tpu_torch/csrc/row_shift.cu",
            "replaces": "pcaccumulation_tpu/ops/bilinear.py:387",
            "launches": None, "max_abs_err": k2_errs[(11, 32)],
            "ms": cuda_ms(lambda: row_shift_blocks(img_n, shifts_n, nb)),
            "plain_ms": cuda_ms(lambda: row_shift_blocks_plain(img_n, ki, fr, nb)),
            "bound_ms": k2_bound, "bound_by": k2_by,
            "library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
                img_g, grid, mode="bilinear", padding_mode="zeros", align_corners=False)),
        },
    }
    # the float32 kernels at the same shapes, for the comparison in PERF.md
    x32, img32n = xb.float(), img_n.float()
    f32_ms = {"seg_pool": cuda_ms(lambda: seg_pool(x32, ids, "max"), iters=200),
              "row_shift_blocks": cuda_ms(lambda: row_shift_blocks(img32n, shifts_n, nb))}
    for key, row in rows.items():
        log(f"{key}: {row['ms']:.4f} ms through the wrapper (float32 kernel at the same shape "
            f"{f32_ms[key[:-5]]:.4f} ms); bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"plain {row['plain_ms']:.4f} ms; library {row['library_ms']}"
            + (f"; C entry queued {row['entry_ms']:.4f} ms" if "entry_ms" in row else ""))
    r = rows["seg_pool_bf16"]
    log(f"seg_pool_bf16 at [480000, 32]: C entry queued {r['entry_ms_480000']:.4f} ms, bound "
        f"{k1_bound4:.4f} ms, {k1_bound4 / r['entry_ms_480000']:.3f} of it; at [120000, 32] "
        f"{k1_bound / r['entry_ms']:.3f} of its bound")
    # the per-launch split of both bf16 designs, and their kernels' residency
    for design, kern in k1_bf16_kernel_info().items():
        log(f"K1 bf16 kernels, design {design} ("
            f"{'seg_partials + seg_tiles' if design == 0 else 'bf_local + bf_fix'}), C=32: "
            + "; ".join(f"{name} {k['blocks_per_sm']} blocks/SM of {k['threads']} threads, "
                        f"{k['registers']} registers, {k['spill_bytes']} spill bytes, "
                        f"{k['shared_bytes']} shared bytes" for name, k in kern.items()))
    for what, (xs, ids_s, bound) in (("forward [120000, 32]", (xb, ids, k1_bound)),
                                     ("forward [480000, 32]", (x4f, ids4f, k1_bound4))):
        log_k1_bf16_split(what, k1_bf16_split(xs, ids_s), bound,
                          host_us_per_call(lambda: seg_pool(xs, ids_s, "max")))
    del want_n
    return rows


def waymo_kernel_phase(dev, gen) -> dict:
    """K1's and K2's bf16 kernels at the Waymo preset's shapes
    (configs/waymo.yaml: T=5, 90,000 points, 288 x 288 BEV): K1 at [90000,
    32] (the pillar encoder's rows at B=1) and K2 at [288, 288, 160] nb=5
    (the warp's canvas of 5 frames of 32 channels), each against its plain
    version on the same bf16 inputs (`k1_bf16_check`, `k2_bf16_check`) and
    timed through the wrapper beside the plain version, the bound and, for
    K2, `F.grid_sample` on the same bf16 canvas. Returns the two rows of the
    `kernels` line (launches None until the Waymo path's counts are read)."""
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift_blocks, row_shift_blocks_plain
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_plain

    bf = torch.bfloat16
    x, ids = k1_inputs(gen, dev, n=90000)
    xb = x.to(bf)
    k1_err = k1_bf16_check("Waymo [90000, 32]", xb, ids)
    nb = 5
    img32, shifts = k2_inputs(gen, dev, nb, 32)
    img = img32.to(bf)
    _, k2_err = k2_bf16_check("K2 bf16 Waymo [288, 288, 160] nb=5", img, shifts, nb,
                              row_shift_blocks)
    n, c = xb.shape
    k1_bound, k1_by = bound_ms(2 * n * c * 2 + n * 4, n * c)
    r, w, ctot = img.shape
    k = torch.floor(shifts)
    ki, fr = k.clamp(-w, w).to(torch.int32), (shifts - k).float()
    k2_bound, k2_by = bound_ms(2 * img.numel() * 2 + shifts.numel() * 4, 3 * img.numel())
    img_g = img.reshape(r, w, nb, ctot // nb).permute(0, 2, 3, 1).reshape(r * nb, ctot // nb, 1, w)
    xs = (torch.arange(w, device=dev, dtype=torch.float32)[None, :]
          + (ki.float() + fr).reshape(-1, 1))
    grid = torch.stack([(2 * xs + 1) / w - 1, torch.zeros_like(xs)], -1)[:, None].to(bf)
    rows = {
        "seg_pool_bf16_waymo": {
            "name": "seg_pool_bf16_waymo", "route": "cuda",
            "source": "pcaccumulation_tpu_torch/csrc/segscan.cu",
            "replaces": "pcaccumulation_tpu/kernels/segscan.py:153",
            "launches": None, "max_abs_err": k1_err[0],
            "ms": cuda_ms(lambda: seg_pool(xb, ids, "max"), iters=200),
            "plain_ms": cuda_ms(lambda: seg_pool_plain(xb, ids, "max")),
            "bound_ms": k1_bound, "bound_by": k1_by,
            "library_ms": None,  # no single PyTorch call reduces and broadcasts back
        },
        "row_shift_blocks_bf16_waymo": {
            "name": "row_shift_blocks_bf16_waymo", "route": "cuda",
            "source": "pcaccumulation_tpu_torch/csrc/row_shift.cu",
            "replaces": "pcaccumulation_tpu/ops/bilinear.py:387",
            "launches": None, "max_abs_err": k2_err,
            "ms": cuda_ms(lambda: row_shift_blocks(img, shifts, nb)),
            "plain_ms": cuda_ms(lambda: row_shift_blocks_plain(img, ki, fr, nb)),
            "bound_ms": k2_bound, "bound_by": k2_by,
            "library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
                img_g, grid, mode="bilinear", padding_mode="zeros", align_corners=False)),
        },
    }
    log(f"Waymo shapes: K1 bf16 [90000, 32] max torch.equal to the plain version, sum max abs "
        f"err {k1_err[1]:.2e} (tol 1 bf16 ulp + 1e-5 of the segment's sum|x|); K2 bf16 [288, "
        f"288, 160] nb=5 max abs err {k2_err:.2e} (tol 1 bf16 ulp)")
    for key, row in rows.items():
        log(f"{key}: {row['ms']:.4f} ms through the wrapper; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.3f} of it; plain "
            f"{row['plain_ms']:.4f} ms; library {row['library_ms']}")
    return rows


def k1_bf16_grad_check(what: str, x: torch.Tensor, ids: torch.Tensor,
                       g: torch.Tensor) -> tuple[float, int]:
    """K1's bf16 gradient kernel (max) against its plain version on the
    same bf16 x, its max y and a bf16 cotangent g: bit-equal, or within 1
    bf16 ulp of the share (plus 1e-5 of the segment's sum|g| over its tie
    count) where the two float32 sums of a segment round to neighbouring
    bf16 values (the plain sum on the card adds by atomics, the kernel in
    its fixed tree); zero off the tie set; two calls torch.equal; one
    launch per call on `seg_pool_backward.launches_bf16`, none on the
    float32 count; through SegPool's backward the same bits. Returns (max
    abs error, rows not bit-equal)."""
    from pcaccumulation_tpu_torch.kernels.segscan import (
        seg_pool,
        seg_pool_backward,
        seg_pool_backward_plain,
        seg_pool_plain,
    )

    y = seg_pool(x, ids, "max")
    before = seg_pool_backward.launches, seg_pool_backward.launches_bf16
    b1, b2 = seg_pool_backward(x, ids, y, g), seg_pool_backward(x, ids, y, g)
    after = seg_pool_backward.launches, seg_pool_backward.launches_bf16
    if after != (before[0], before[1] + 2):
        fail(f"K1 bf16 gradient ({what}): counts {before} -> {after}, want two bf16 launches")
    want = seg_pool_backward_plain(x, ids, y, g)
    tie = x == y
    nt = seg_pool_plain(tie.float(), ids, "sum").clamp(min=1.0)
    err = (b1.float() - want.float()).abs()
    tol = (bf16_ulp(torch.maximum(b1.float().abs(), want.float().abs()))
           + 1e-5 * seg_pool_plain(g.float().abs(), ids, "sum") / nt)
    if b1.dtype != torch.bfloat16 or not bool((err <= tol).all()):
        fail(f"K1 bf16 gradient ({what}) beyond 1 bf16 ulp of the plain version "
             f"({float(err.max())})")
    if not bool((b1[~tie] == 0).all()):
        fail(f"K1 bf16 gradient ({what}) is not zero off the tie set")
    if not torch.equal(b1, b2):
        fail(f"K1 bf16 gradient ({what}): two calls differ")
    xg = x.clone().requires_grad_(True)
    seg_pool(xg, ids, "max").backward(g)
    if not torch.equal(xg.grad, b1):
        fail(f"K1 bf16 gradient ({what}) through SegPool differs from the direct call")
    torch.cuda.synchronize()
    return float(err.max()), int((err > 0).any(-1).sum())


def bf16_grad_phase(dev, gen) -> dict:
    """The bf16 gradients of K1 and K2 against their plain versions: K1's
    at PR 6's tile edges in bf16 (C=32, and C=9 on the small cases; every
    other row rounded to halves, and bf16's own rounding, force ties) and
    at the nuScenes train step's [480000, 32] (B=4 samples of 120,000
    points, each with a 40,000-row tail at -1e30 that ties throughout),
    timed through the wrapper and at the C entry point; K2's (the bf16
    kernel at -shifts) at [288, 288, 352] nb=11, through RowShift's
    backward and the direct call, timed beside `F.grid_sample` in bf16.
    Returns the two rows of the `kernels` line (launches None until the
    nuScenes train phase's counts are read)."""
    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.kernels.row_shift import (
        row_shift_blocks,
        row_shift_blocks_backward,
        row_shift_blocks_plain,
    )
    from pcaccumulation_tpu_torch.kernels.segscan import (
        scratch_floats,
        seg_pool_backward,
        seg_pool_backward_plain,
        seg_pool_plain,
    )

    bf = torch.bfloat16
    rng = np.random.default_rng(SEED + 8)
    cases = [(name, 32) for name in K1_EDGES] + [(name, 9) for name in K1_EDGES[:9]]
    worst, n_off = 0.0, 0
    for name, c in cases:
        x, ids, g = (torch.from_numpy(a).to(dev) for a in k1_edge_case(name, c, rng))
        err, off = k1_bf16_grad_check(f"{name}, C={c}", x.to(bf), ids, g.to(bf))
        worst, n_off = max(worst, err), n_off + off
    # a cotangent 2 or 8 bytes off a 16-byte boundary: the two-launch kernels
    for name, elems in (("tail_90000", 1), ("tail_90000", 4), ("on_tile_edges", 4)):
        x, ids, g = (torch.from_numpy(a).to(dev) for a in k1_edge_case(name, 32, rng))
        err, off = k1_bf16_grad_check(f"{name}, C=32, g {2 * elems} bytes off", x.to(bf), ids,
                                      misaligned(g.to(bf), elems))
        worst, n_off = max(worst, err), n_off + off
    x4, ids4 = k1_batch_inputs(gen, dev, 4, n=120000)
    x4 = tie_values(x4).to(bf)
    g4 = torch.randn(x4.shape, generator=gen).to(dev).to(bf)
    k1_err, off4 = k1_bf16_grad_check("[480000, 32]", x4, ids4, g4)
    y4 = seg_pool_plain(x4, ids4, "max")
    n_tied = int((x4 == y4).sum())
    log(f"K1 bf16 gradient at the tile edges ({len(cases)} cases), with a cotangent 2 and 8 "
        f"bytes off a 16-byte boundary (3 cases) and at [480000, 32] ({n_tied} "
        f"tied values of 480000 x 32): max abs err {max(worst, k1_err):.2e} against the plain "
        f"version (tol 1 bf16 ulp of the share + 1e-5 of sum|g| / ties); rows not bit-equal: "
        f"{n_off} over the edge cases, {off4} of 480000 at [480000, 32]; zero off the tie set; "
        f"two calls and SegPool's backward torch.equal")

    lib = build.load_library("segscan")
    stream = build.stream(x4)
    n, c = x4.shape
    out = torch.empty_like(x4)
    scratch = torch.empty(scratch_floats(n, c, bf, 2), device=dev)

    def entry_bwd():
        lib.segpool_backward_max_bf16(x4.data_ptr(), y4.data_ptr(), g4.data_ptr(),
                                      ids4.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                      scratch.numel(), n, c, stream)

    # reads x, y, g (bf16) and ids once, writes the gradient (bf16) once
    k1_bound, k1_by = bound_ms(4 * n * c * 2 + n * 4, 5 * n * c)

    # K2's gradient at the nuScenes warp's shape
    nb = 11
    g2, shifts = k2_inputs(gen, dev, nb, 32)
    g2 = g2.to(bf)
    r, w, ctot = g2.shape
    kn = torch.floor(-shifts)
    ki, fr = kn.clamp(-w, w).to(torch.int32), (-shifts - kn).float()
    before = row_shift_blocks_backward.launches, row_shift_blocks_backward.launches_bf16
    got = row_shift_blocks_backward(g2, shifts, nb)
    img = torch.zeros_like(g2).requires_grad_(True)
    row_shift_blocks(img, shifts, nb).backward(g2)
    after = row_shift_blocks_backward.launches, row_shift_blocks_backward.launches_bf16
    if after != (before[0], before[1] + 2):
        fail(f"K2 bf16 gradient: counts {before} -> {after}, want two bf16 launches")
    want = row_shift_blocks_plain(g2, ki, fr, nb)
    torch.cuda.synchronize()
    k2_err = (got.float() - want.float()).abs()
    if got.dtype != bf or not bool(
            (k2_err <= bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))).all()):
        fail(f"K2 bf16 gradient differs from the plain version beyond 1 bf16 ulp "
             f"({float(k2_err.max())})")
    if not torch.equal(img.grad, got):
        fail("K2 bf16 gradient through RowShift differs from the direct call")
    log(f"K2 bf16 gradient [288, 288, 352] nb=11 (the bf16 kernel at -shifts): max abs err "
        f"{float(k2_err.max()):.2e} (tol 1 bf16 ulp of the plain version); RowShift's backward "
        f"torch.equal to the direct call")
    k2_bound, k2_by = bound_ms(2 * g2.numel() * 2 + shifts.numel() * 4, 3 * g2.numel())
    g_g = g2.reshape(r, w, nb, ctot // nb).permute(0, 2, 3, 1).reshape(r * nb, ctot // nb, 1, w)
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :] + (ki.float() + fr).reshape(
        -1, 1)
    grid = torch.stack([(2 * xs + 1) / w - 1, torch.zeros_like(xs)], -1)[:, None].to(bf)
    rows = {
        "seg_pool_backward_bf16": {
            "name": "seg_pool_backward_bf16", "route": "cuda",
            "source": "pcaccumulation_tpu_torch/csrc/segscan.cu",
            "replaces": "pcaccumulation_tpu/kernels/segscan.py:271",
            "launches": None, "max_abs_err": k1_err,
            "ms": cuda_ms(lambda: seg_pool_backward(x4, ids4, y4, g4), iters=50),
            "plain_ms": cuda_ms(lambda: seg_pool_backward_plain(x4, ids4, y4, g4)),
            "bound_ms": k1_bound, "bound_by": k1_by,
            "library_ms": None,  # no single PyTorch call computes the tie-split gradient
            "entry_ms": cuda_ms_queued(entry_bwd, iters=100),
        },
        "row_shift_blocks_backward_bf16": {
            "name": "row_shift_blocks_backward_bf16", "route": "cuda",
            "source": "pcaccumulation_tpu_torch/csrc/row_shift.cu",
            "replaces": "pcaccumulation_tpu/ops/bilinear.py:485",
            "launches": None, "max_abs_err": float(k2_err.max()),
            "ms": cuda_ms(lambda: row_shift_blocks_backward(g2, shifts, nb)),
            "plain_ms": cuda_ms(lambda: row_shift_blocks_plain(g2, ki, fr, nb)),
            "bound_ms": k2_bound, "bound_by": k2_by,
            "library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
                g_g, grid, mode="bilinear", padding_mode="zeros", align_corners=False)),
        },
    }
    for key, row in rows.items():
        log(f"{key}: {row['ms']:.4f} ms through the wrapper; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); plain {row['plain_ms']:.4f} ms; library {row['library_ms']}"
            + (f"; C entry queued {row['entry_ms']:.4f} ms, {row['bound_ms'] / row['entry_ms']:.3f}"
               f" of the bound" if "entry_ms" in row else ""))
    log_k1_bf16_split("gradient [480000, 32]", k1_bf16_split(x4, ids4, y4, g4), k1_bound,
                      host_us_per_call(lambda: seg_pool_backward(x4, ids4, y4, g4)))
    return rows


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


def nn_difference_form(a: torch.Tensor, refs, queries):
    """K4's own arithmetic in plain PyTorch: each distance as the sum of the
    squared coordinate differences (K4 sums them with fused multiply-adds),
    where the port's plain version (`kernels.chamfer._plain_packed`, which
    this takes the place of) expands |a|^2 + |b|^2 - 2 a.b. The same
    function rounded otherwise; the first argmin on ties, as both."""
    import pcaccumulation_tpu_torch.kernels.chamfer as chamfer

    p, n, _ = a.shape
    m = int(refs.top)
    if m == 0:
        return (a.new_full((p, n), chamfer._BIG),
                torch.zeros((p, n), dtype=torch.int32, device=a.device))
    b = refs.points[:, :m, :3]
    b_valid = torch.arange(m, device=a.device)[None] < refs.count[:, None]
    if queries is not None:  # only the asked-for queries, packed first as K4 reads them
        order = queries.order.long()
        n = int(queries.top)
        a = torch.gather(a, 1, order[:, :n, None].expand(p, n, 3))
    block = max(1, (1 << 25) // (3 * p * m))
    dists, idxs = [], []
    for s in range(0, n, block):
        d2 = ((a[:, s:s + block, None, :] - b[:, None, :, :]) ** 2).sum(-1)
        d, i = torch.min(torch.where(b_valid[:, None, :], d2, chamfer._BIG), dim=-1)
        dists.append(d)
        idxs.append(i)
    d2, idx = torch.cat(dists, 1), torch.gather(refs.order.long(), 1, torch.cat(idxs, 1))
    if queries is not None:
        full = queries.valid.shape[1]
        d2 = torch.full((p, full), chamfer._BIG, dtype=d2.dtype).scatter_(1, order[:, :n], d2)
        idx = torch.zeros((p, full), dtype=idx.dtype).scatter_(1, order[:, :n], idx)
        d2 = torch.where(queries.valid, d2, chamfer._BIG)
        idx = torch.where(queries.valid, idx, 0)
    return d2, idx.to(torch.int32)


class difference_form:
    """Within it, K4's plain version on the CPU computes its distances as
    K4 does (`nn_difference_form`)."""

    def __enter__(self):
        import pcaccumulation_tpu_torch.kernels.chamfer as chamfer

        self.plain = chamfer._plain_packed
        chamfer._plain_packed = nn_difference_form

    def __exit__(self, *exc):
        import pcaccumulation_tpu_torch.kernels.chamfer as chamfer

        chamfer._plain_packed = self.plain


class recording:
    """Within it, each call of `module.<name>` (an ICP as the model calls
    it: `tpointnet.refine_instance_poses`, `egomotion.refine_ego_poses`)
    appends its inputs and its result to `calls`."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def record(*args, **kw):
            out = self.fn(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def leaf_criterion(grads_a: dict, grads_b: dict,
                   what: str = "GPU vs CPU") -> tuple[int, int, float, float, str]:
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
        if not (rel < 0.05 and cos > 0.995):  # NaN misses too
            fail(f"{what} gradient of {n}: rel-norm {rel:.3e}, cosine {cos:.6f}")
        checked += 1
    if checked <= 3 * noise:
        fail(f"{what} gradients: {checked} leaves checked, {noise} below the noise floor")
    return checked, noise, worst[0], worst[1], worst[2]


def nn_tolerance(a: torch.Tensor, b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-query d2 tolerance of K4 against its plain version: the plain
    version expands |a|^2 + |b|^2 - 2 a.b, whose float32 error is a few
    ulp of |a|^2 + |b|^2 (2.4e-4 at 50 m from the origin); the kernel's
    difference form is exact to ~1 ulp of d2."""
    bn = torch.gather(b, 1, idx.long()[..., None].expand(a.shape))
    return 2e-6 * ((a * a).sum(-1) + (bn * bn).sum(-1)) + 1e-7


def check_nn(what: str, a, b, b_valid, a_valid=None) -> tuple[float, int]:
    """K4 against its plain version on the same inputs: distances within
    `nn_tolerance`; the argmins equal except where the two candidates' exact
    (float64) distances lie within it of each other, i.e. near ties that
    the two roundings may order either way; the queries not asked for
    (a_valid) are (1e30, 0). Returns (max abs d2 error, number of differing
    argmins)."""
    from pcaccumulation_tpu_torch.kernels.chamfer import nn, nn_plain

    d2, idx = nn(a, b, b_valid, a_valid)
    want_d, want_i = nn_plain(a, b, b_valid, a_valid)
    torch.cuda.synchronize()
    if a_valid is not None and not bool(((d2 == 1e30) & (idx == 0))[~a_valid].all()):
        fail(f"K4 {what}: a query not asked for is not (1e30, 0)")
    tol = nn_tolerance(a, b, want_i)
    has = b_valid.any(1)[:, None].expand_as(d2)  # problems with a valid reference
    err = float((d2 - want_d).abs()[has].max()) if bool(has.any()) else 0.0
    if not bool(((d2 - want_d).abs() <= tol)[has].all()):
        fail(f"K4 {what}: distances differ from the plain version beyond the tolerance")
    if not bool(((d2 == 1e30) & (idx == 0))[~has].all()):
        fail(f"K4 {what}: a problem without valid references is not (1e30, 0)")

    def exact(i):
        nearest = torch.gather(b, 1, i.long()[..., None].expand(a.shape))
        return ((a.double() - nearest.double()) ** 2).sum(-1)

    differ = idx != want_i
    if not bool(((exact(idx) - exact(want_i)).abs() <= tol)[differ].all()):
        fail(f"K4 {what}: an argmin differs from the plain version's beyond a near tie")
    return err, int(differ.sum())


def k3_phase(dev, gen) -> dict:
    """K3 through the public API: warp_bev on one [288, 288, 32] map and
    warp_bev_batch on [4, 288, 288, 32], shear, ego-like poses; launches
    counted; against the CPU (plain); the kernel against its plain version
    on the warp's own shifts; timings at the warp_bev_batch shape."""
    import math

    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift, row_shift_blocks_plain
    from pcaccumulation_tpu_torch.ops.bilinear import _shear_params, warp_bev, warp_bev_batch

    f, h, w, c = 4, 288, 288, 32
    feats = torch.randn((f, h, w, c), generator=gen)
    poses = torch.eye(4).repeat(f, 1, 1)
    for i in range(f):  # yaw up to 0.2 rad, 1-4 m: an ego motion over a few frames
        th = 0.05 * (i + 1)
        poses[i, :2, :2] = torch.tensor([[math.cos(th), -math.sin(th)],
                                         [math.sin(th), math.cos(th)]])
        poses[i, :2, 3] = torch.tensor([1.0 + i, -0.5 * i])
    args = (0.25, 0.25, -36.0, -36.0)
    feats_d, poses_d = feats.to(dev), poses.to(dev)
    row_shift.launches = 0
    single = warp_bev(feats_d[1], poses_d[1], *args)
    batch = warp_bev_batch(feats_d, poses_d, *args)
    torch.cuda.synchronize()
    launches = row_shift.launches
    if launches != 6:
        fail(f"K3: warp_bev + warp_bev_batch launched the kernel {launches}x (want 3 + 3)")
    # against the CPU: each device computes the shear parameters from
    # differences of pixel coordinates of ~144 px (float32 ulp ~1.5e-5 px),
    # scaled by up to 287 rows, so the shifts differ by up to ~3e-3 px;
    # times neighbour differences of up to ~6 for unit-normal features
    err_s = float((single.cpu() - warp_bev(feats[1], poses[1], *args)).abs().max())
    err_b = float((batch.cpu() - warp_bev_batch(feats, poses, *args)).abs().max())
    if max(err_s, err_b) > 3e-2:
        fail(f"K3: warp_bev on the card vs the CPU: {err_s:.2e}, batch {err_b:.2e} (tol 3e-2)")
    # the kernel against its plain version on the same (first-pass) shifts
    alpha, _, tx_p, ty_p = _shear_params(poses_d, *args, h, w)
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    shifts = (alpha[:, None] * rows + (tx_p - alpha * ty_p)[:, None]).reshape(-1)
    img = feats_d.reshape(f * h, w, c)
    k = torch.floor(shifts)
    ki = k.clamp(-w, w).to(torch.int32)[:, None]
    fr = (shifts - k)[:, None]
    got = row_shift(img, shifts)
    want = row_shift_blocks_plain(img, ki, fr, 1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > 1e-6:
        fail(f"K3 row_shift differs from the plain version (max abs err {err})")
    # C = 9: the kernel's one-channel-per-thread path
    img9 = torch.randn((f * h, w, 9), generator=gen).to(dev)
    err9 = float((row_shift(img9, shifts) - row_shift_blocks_plain(img9, ki, fr, 1)).abs().max())
    if err9 > 1e-6:
        fail(f"K3 row_shift at C=9 differs from the plain version (max abs err {err9})")
    log(f"K3 row_shift: warp_bev [288, 288, 32] + warp_bev_batch [4, 288, 288, 32] launched "
        f"{launches}x; card vs CPU max abs err {err_s:.2e} / {err_b:.2e} (tol 3e-2, shear "
        f"parameters rounded per device); kernel vs plain on the warp's shifts "
        f"[{f * h}, {w}, {c}]: {err:.2e}, at C=9: {err9:.2e} (tol 1e-6)")
    # library yardstick: grid_sample, one x-only grid per row, [R, C, 1, W]
    img_g = img.permute(0, 2, 1)[:, :, None, :].contiguous()
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :] + (ki.float() + fr)
    grid = torch.stack([(2 * xs + 1) / w - 1, torch.zeros_like(xs)], -1)[:, None]
    lib = torch.nn.functional.grid_sample(img_g, grid, mode="bilinear", padding_mode="zeros",
                                          align_corners=False)
    lib_err = float((lib[:, :, 0].permute(0, 2, 1) - want).abs().max())
    if lib_err > 1e-3:
        fail(f"the grid_sample yardstick does not compute row_shift (err {lib_err:.2e})")
    bound, by = bound_ms(2 * img.numel() * 4 + ki.numel() * 8, 3 * img.numel())
    # the kernel launched straight through its C entry point, and the host's
    # time to enqueue one PyTorch elementwise op: what the wrapper adds
    lib_rs, out = build.load_library("row_shift"), torch.empty_like(img)
    stream = build.stream(img)
    direct_ms = cuda_ms(lambda: lib_rs.row_shift_blocks_forward(
        img.data_ptr(), shifts.data_ptr(), out.data_ptr(), f * h, w, c, 1, 1.0, stream))
    tiny = torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    for _ in range(2000):
        tiny.add(1.0)
    host_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    log(f"K3 kernel launched through its C entry point (no wrapper): {direct_ms:.4f} ms; the "
        f"host enqueues one elementwise PyTorch op in {host_us:.1f} us")
    return {
        "name": "row_shift", "route": "cuda",
        "source": "pcaccumulation_tpu_torch/csrc/row_shift.cu",
        "replaces": "pcaccumulation_tpu/ops/bilinear.py:215",
        "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(lambda: row_shift(img, shifts)),
        "plain_ms": cuda_ms(lambda: row_shift_blocks_plain(img, ki, fr, 1)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
            img_g, grid, mode="bilinear", padding_mode="zeros", align_corners=False)),
    }


def k4_inputs(scene: dict, dev):
    """The ego ICP's K4 call at the default config: 4 problems (frames 1-4
    of one sample) of the sample's 90,000 points, moved by a small pose
    each, against the same points with frame 0's valid ones as references;
    the query mask asks for frame t's valid points in problem t - 1."""
    import math

    pts = torch.from_numpy(scene["points"]).to(dev)
    valid = torch.from_numpy(scene["point_valid"]).to(dev)
    tid = torch.from_numpy(scene["time_idx"]).to(dev)
    a = []
    for t in range(1, 5):
        th = 0.01 * t
        rot = torch.tensor([[math.cos(th), -math.sin(th), 0.0], [math.sin(th), math.cos(th), 0.0],
                            [0.0, 0.0, 1.0]], device=dev)
        a.append(pts @ rot.T + torch.tensor([0.05 * t, -0.03 * t, 0.0], device=dev))
    b_valid = (valid & (tid == 0))[None].expand(4, -1).contiguous()
    a_valid = torch.stack([valid & (tid == t) for t in range(1, 5)])
    return torch.stack(a), pts[None].expand(4, -1, -1).contiguous(), b_valid, a_valid


def k4_instance_inputs(gen, dev):
    """The instance ICP's K4 call at the default config: 32 instance slots
    x 4 frames = 128 problems of 1,024 points, objects of a few metres up to
    ~50 m from the origin, a quarter of the references valid (frame 0),
    exact duplicate references, and one problem without a valid one; the
    query mask asks for another quarter (frame t's slice)."""
    a = torch.rand((128, 1024, 3), generator=gen) * 4 + torch.randn((128, 1, 3), generator=gen) * 25
    b = a + 0.02 * torch.randn(a.shape, generator=gen)
    b[:, 600:700] = b[:, 100:200]  # duplicates: the lower index wins
    valid = torch.rand((128, 1024), generator=gen) < 0.25
    valid[:, 100:200] = valid[:, 600:700] = True
    valid[5] = False
    a_valid = torch.rand((128, 1024), generator=gen) < 0.25
    return a.to(dev), b.to(dev), valid.to(dev), a_valid.to(dev)


def nn_bound(a_valid, b_valid) -> tuple[float, str]:
    """K4's bound on the work of one call with a query mask: 8 flops per
    (asked-for query, valid reference) pair; the bytes: the asked-for
    queries (12 B) and the valid references (16 B, packed) read once, the
    packed orders (4 B a row) read once, d2 and idx (8 B a query) written."""
    n_q, n_r = a_valid.sum(1).double(), b_valid.sum(1).double()
    n_bytes = (float(n_q.sum()) * 12 + float(n_r.sum()) * 16
               + (a_valid.numel() + b_valid.numel()) * 4 + a_valid.numel() * 8)
    return bound_ms(n_bytes, 8.0 * float((n_q * n_r).sum()))


def k4_phase(dev, gen, scene: dict) -> dict:
    """K4 against its plain version at both ICP shapes, with and without a
    query mask, and with references and queries packed once and reused as
    ICP reuses them; timings of the call as ICP makes it (packed once, the
    query mask), its bound and the library yardstick (torch.cdist + min,
    TF32 off, on the asked-for queries and valid references) at the ego
    shape; the instance shape's call time; for comparison, `nn` over every
    query with packing on every call."""
    from pcaccumulation_tpu_torch.kernels.chamfer import (
        nn,
        nn_packed,
        nn_plain,
        pack_queries,
        pack_references,
    )

    a, b, b_valid, a_valid = k4_inputs(scene, dev)
    ai, bi, vi, avi = k4_instance_inputs(gen, dev)
    errs, diffs = {}, {}
    for what, args in (("ego shape", (a, b, b_valid)),
                       ("ego shape, query mask", (a, b, b_valid, a_valid)),
                       ("instance shape", (ai, bi, vi)),
                       ("instance shape, query mask", (ai, bi, vi, avi))):
        errs[what], diffs[what] = check_nn(what, *args)
    _, idx_i = nn(ai, bi, vi)
    if bool(((idx_i >= 600) & (idx_i < 700)).any()):  # exact copies of refs 100-199
        fail("K4: a duplicated reference resolved to the higher index")
    # packed once and reused for moved queries, as across ICP's iterations
    for what, (x, y, yv, xv) in (("ego", (a, b, b_valid, a_valid)),
                                 ("instance", (ai, bi, vi, avi))):
        refs, queries = pack_references(y, yv), pack_queries(xv)
        for step in range(3):
            moved = x + 0.01 * step
            got, want = nn_packed(moved, refs, queries), nn(moved, y, yv, xv)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                fail(f"K4 {what} shape: references packed once differ from per-call packing")
    m_valid = int(b_valid[0].sum())
    n_asked = [int(x) for x in a_valid.sum(1)]
    log(f"K4 nn ego shape [4, 90000] queries ({n_asked} asked for under the query mask) x "
        f"{m_valid} valid of 90000 refs: "
        + "; ".join(f"{k}: max |d2 err| {errs[k]:.2e}, {diffs[k]} argmins differ at near ties"
                    for k in errs)
        + " (instance shape [128, 1024] x [128, 1024]: a quarter valid, duplicates, one empty "
        "problem); packed once and reused for 3 moved query sets: equal to per-call packing")
    p, n, _ = a.shape
    bound, by = nn_bound(a_valid, b_valid)
    refs, queries = pack_references(b, b_valid), pack_queries(a_valid)
    out = (torch.empty((p, n), device=dev), torch.empty((p, n), dtype=torch.int32, device=dev))
    # the library call on the asked-for queries and the valid references,
    # each problem padded to the largest count
    q_max = max(n_asked)
    a_lib = torch.gather(a, 1, queries.order[:, :q_max].long()[..., None].expand(p, q_max, 3))
    b_lib = refs.points[:, :m_valid, :3].contiguous()
    torch.cuda.empty_cache()
    entry = {
        "name": "nn", "route": "cuda", "source": "pcaccumulation_tpu_torch/csrc/nn.cu",
        "replaces": "pcaccumulation_tpu/kernels/chamfer.py:89",
        "launches": 0, "max_abs_err": max(errs.values()),
        "ms": cuda_ms(lambda: nn_packed(a, refs, queries, out), iters=20),
        "plain_ms": cuda_ms(lambda: nn_plain(a, b, b_valid, a_valid), iters=2, warmup=1),
        "bound_ms": bound, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.cdist(a_lib, b_lib).min(-1), iters=3, warmup=1),
    }
    all_ms = cuda_ms(lambda: nn(a, b, b_valid), iters=5)
    all_bound, _ = bound_ms(p * n * 12 + p * b.shape[1] * 13 + p * n * 8, 8.0 * p * n * m_valid)
    log(f"K4 nn ego shape over every one of the 4 x 90000 queries, references packed on "
        f"every call: {all_ms:.4f} ms (bound {all_bound:.4f} ms); as ICP calls it now "
        f"(packed once, {sum(n_asked)} asked-for queries, outputs reused): {entry['ms']:.4f} ms "
        f"(bound {bound:.4f} ms, {bound / entry['ms']:.3f} of it)")
    refs_i, queries_i = pack_references(bi, vi), pack_queries(avi)
    out_i = (torch.empty(avi.shape, device=dev), torch.empty(avi.shape, dtype=torch.int32,
                                                             device=dev))
    ms_i = cuda_ms(lambda: nn_packed(ai, refs_i, queries_i, out_i), iters=50)
    ms_i_all = cuda_ms(lambda: nn(ai, bi, vi))
    plain_i = cuda_ms(lambda: nn_plain(ai, bi, vi, avi))
    bound_i, _ = nn_bound(avi, vi)
    log(f"K4 nn instance shape [128, 1024] as ICP calls it (packed once, {int(avi.sum())} "
        f"asked-for queries, outputs reused): {ms_i * 1e3:.1f} us per call (target < 30 us; "
        f"bound {bound_i * 1e3:.2f} us; plain {plain_i:.4f} ms); every query, packing on every "
        f"call: "
        f"{ms_i_all * 1e3:.1f} us")
    return entry


def chamfer_phase(dev, gen) -> None:
    """chamfer_distance forward and gradient on the card (two K4 launches)
    against the CPU (the plain nearest neighbour): two jittered 20^3 grids,
    0.5 m apart, 30 m from the origin, so that every nearest neighbour is
    clear of the others."""
    from pcaccumulation_tpu_torch.kernels.chamfer import chamfer_distance, nn

    g = torch.stack(torch.meshgrid(*[torch.arange(20.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    a = (g * 0.5 + 30.0 + (torch.rand(g.shape, generator=gen) - 0.5) * 0.1)[None]
    b = (g * 0.5 + 30.0 + (torch.rand(g.shape, generator=gen) - 0.5) * 0.1)[None]
    valid = torch.ones(a.shape[:2], dtype=torch.bool)
    res = {}
    before = nn.launches
    for where in ("cpu", dev):
        ta = a.to(where, copy=True).requires_grad_(True)
        tb = b.to(where, copy=True).requires_grad_(True)
        da, db = chamfer_distance(ta, tb, valid.to(where), valid.to(where))
        (da.sum() + 2.0 * db.sum()).backward()
        res[str(where)] = [x.detach().cpu() for x in (da, db, ta.grad, tb.grad)]
    if nn.launches != before + 2:
        fail(f"chamfer_distance launched K4 {nn.launches - before}x (want 2)")
    errs = [float((x - y).abs().max()) for x, y in zip(res["cuda"], res["cpu"])]
    # distances: the plain expansion's rounding at |a|^2 ~ 4000; gradients:
    # the same argmins, so the same differences, summed in another order
    if errs[0] > 5e-3 or errs[1] > 5e-3 or errs[2] > 1e-5 or errs[3] > 1e-5:
        fail(f"chamfer_distance card vs CPU: distances {errs[:2]}, gradients {errs[2:]}")
    log(f"chamfer_distance [8000] x [8000] card vs CPU: distances max abs err {max(errs[:2]):.2e} "
        f"(tol 5e-3), gradients {max(errs[2:]):.2e} (tol 1e-5); 2 K4 launches")


def pair_agreement(x: np.ndarray, y: np.ndarray) -> float:
    """Share of point pairs on which two labelings (0 = no cluster) agree
    about being in one cluster (the Rand index over the labelled pairs)."""
    n = len(x)
    if n < 2:
        return 1.0

    def same(lab):
        cnt = np.bincount(lab[lab != 0])
        return float((cnt * (cnt - 1) / 2).sum())

    both = (x != 0) & (y != 0)
    joint = x[both].astype(np.int64) * (int(y.max()) + 1) + y[both]
    cnt = np.bincount(joint)
    disagree = same(x) + same(y) - 2 * float((cnt * (cnt - 1) / 2).sum())
    return 1.0 - disagree / (n * (n - 1) / 2)


def test_path_phase(port, cfg_base: dict, weights: dict, batches: list, smi: str):
    """The test-mode forward at the default config with both ICPs at 50
    iterations; then at 3 iterations the card against the CPU with the
    card's labels injected (the ego pose also against the CPU's ego ICP
    with K4's arithmetic), the instance ICP alone on the card's inputs
    against the CPU's, and the clusterer against the CPU's. Returns
    (K4 launches on the path, median forward ms)."""
    from pcaccumulation_tpu_torch.kernels.chamfer import nn
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift, row_shift_blocks
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool
    from pcaccumulation_tpu_torch.ops.cluster import cluster_moving_points
    from pcaccumulation_tpu_torch.profile_forward import (
        NESTED,
        _with_stage_events,
        calibrate_heads,
        test_mode_config,
    )

    iters = 50
    cfg = test_mode_config(dict(cfg_base, pose_estimation=dict(cfg_base["pose_estimation"]),
                                tpointnet=dict(cfg_base["tpointnet"])), iters)
    model = port.build_model(cfg)
    model.load_state_dict(weights)
    n_fwd = len(batches)
    seg_pool.launches = row_shift_blocks.launches = nn.launches = row_shift.launches = 0
    with torch.no_grad():
        outs = [model(bt, mode="test") for bt in batches]
    torch.cuda.synchronize()
    counts = {"K1": seg_pool.launches, "K2": row_shift_blocks.launches, "K4": nn.launches,
              "K3": row_shift.launches}
    want = {"K1": 2 * n_fwd, "K2": 3 * n_fwd, "K4": 2 * iters * n_fwd, "K3": 0}
    if counts != want:
        fail(f"kernel launches on the test path: {counts} for {n_fwd} forwards (want {want}: "
             f"K4 once per ego and per instance ICP iteration)")
    n_inst = []
    for i, out in enumerate(outs):
        for key, v in out.items():
            if torch.is_tensor(v) and v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"test path, scene {i}: non-finite {key}")
        det_ego = torch.linalg.det(out["ego_motion_est"][..., :3, :3].double())
        labels = out["inst_labels_est"][0]
        slots = torch.unique(labels[labels > 0])
        det_inst = torch.linalg.det(out["inst_pose_est"][0, slots][..., :3, :3].double())
        worst = float(torch.cat([det_ego.reshape(-1), det_inst.reshape(-1)]).sub(1).abs().max())
        if worst > 1e-4:
            fail(f"test path, scene {i}: a pose is not a rotation (|det - 1| = {worst:.2e})")
        n_inst.append(len(slots))
    log(f"test path: {n_fwd} test-mode forwards (both ICPs, {iters} iterations) launched "
        + ", ".join(f"{k} {v}x" for k, v in counts.items())
        + f"; instances found {n_inst}; all outputs finite, |det - 1| <= 1e-4 for the ego "
        f"poses and the occupied instance slots")

    with torch.no_grad():
        for bt in batches:
            model(bt, mode="test")
        times = []
        for i in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            model(batches[i % n_fwd], mode="test")
            end.record()
            times.append(sync_ms(start, end))
        stages = _with_stage_events(lambda i: model(batches[i % n_fwd], mode="test"), 3)
    fwd_ms = statistics.median(times)
    total = sum(v for k, v in stages.items() if k not in NESTED)
    share = {k: stages.get(k, 0.0) / total for k in ("cluster", "icp_ego", "icp_instance")}
    log(f"test forward (B=1, default config, both ICPs at {iters} iterations, CUDA events): "
        f"median {fwd_ms:.3f} ms of 5 ({', '.join(f'{t:.3f}' for t in times)}) on {smi}; "
        f"stage ms (median of 3): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + "; share of the stage sum: " + ", ".join(f"{k} {v:.3f}" for k, v in share.items()))

    # the card against the CPU at 3 iterations, the card's labels injected
    t0 = time.perf_counter()
    cfg3 = test_mode_config(dict(cfg, pose_estimation=dict(cfg["pose_estimation"]),
                                 tpointnet=dict(cfg["tpointnet"])), 3)
    gpu_model = port.build_model(cfg3)
    gpu_model.load_state_dict(weights)
    cpu_model = port.build_model(cfg3, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in weights.items()})
    bt = batches[0]
    from pcaccumulation_tpu_torch.models import egomotion, tpointnet

    with torch.no_grad():
        with recording(tpointnet, "refine_instance_poses") as icp_calls:
            gpu = gpu_model(bt, mode="test")
        labels = gpu["inst_labels_est"]
        with recording(egomotion, "refine_ego_poses") as ego_calls:
            cpu = cpu_model({k: v.cpu() for k, v in bt.items()}, mode="test",
                            inst_labels_override=labels.cpu())
        # the CPU's ego ICP again on its own inputs, its distances computed as
        # K4 computes them
        args, kw, _ = ego_calls.calls[0]
        with difference_form():
            ego_k4 = egomotion.refine_ego_poses(*args, **kw)
    gpu = {k: v.cpu() for k, v in gpu.items() if torch.is_tensor(v)}
    same_fg = gpu["fb_mask"] == cpu["fb_mask"]
    flips = int((~same_fg).sum())
    # float32, TF32 off; the card's convolutions, reductions and nearest
    # neighbours round otherwise than the CPU's (a near tie or a point at the
    # ICP threshold may go the other way)
    tol = {"fb_seg_est": 1e-3, "ego_motion_est": 1e-3, "transformed_points": 1e-2,
           "mos_est": 1e-2, "offset_est": 1e-2}
    errs = {}
    for key, t in tol.items():
        d = (gpu[key] - cpu[key]).abs()
        if key in ("mos_est", "offset_est"):
            d = d[same_fg]  # a flipped FB decision changes which rows are decoded
        errs[key] = float(d.max())
        if errs[key] > t and key != "ego_motion_est":
            fail(f"test path GPU vs CPU {key}: max abs err {errs[key]:.3e} > {t}")
    # The ego pose per frame: the ego ICP's nearest neighbours go the other
    # way at near ties when the CPU expands |a|^2 + |b|^2 - 2ab, as its plain
    # version does, where K4 sums squared differences; the CPU's two
    # roundings of the same ICP differ by up to 1.7e-3 at one seed's weights,
    # and the card lies within 1e-4 of the CPU with K4's arithmetic (PERF.md
    # §6). So: within the tolerance of the CPU with K4's arithmetic,
    # and of the plain version within the tolerance plus the CPU's spread.
    per_frame = lambda x: x.abs().amax((-1, -2))[0]  # noqa: E731
    ego_card, ego_plain = gpu["ego_motion_est"], cpu["ego_motion_est"]
    d_k4, d_plain = per_frame(ego_card - ego_k4), per_frame(ego_card - ego_plain)
    ego_spread = per_frame(ego_k4 - ego_plain)
    ego_t = tol["ego_motion_est"]
    ego_log = (f"ego pose per frame: card vs the CPU with K4's arithmetic "
               f"{[float(f'{v:.2e}') for v in d_k4]}, vs the plain version "
               f"{[float(f'{v:.2e}') for v in d_plain]}, the CPU's two roundings "
               f"{[float(f'{v:.2e}') for v in ego_spread]}")
    if float(d_k4.max()) > ego_t or bool((d_plain > ego_t + ego_spread).any()):
        fail(f"test path GPU vs CPU ego_motion_est beyond {ego_t} (against the plain version: "
             f"plus the CPU's own spread): {ego_log}")
    if flips > max(1, int(bt["point_valid"].sum()) // 1000):
        fail(f"test path: {flips} FB decisions differ between GPU and CPU")
    # the instance ICP starts from the random TPointNet's poses (random
    # rotations about the centroid); a slice of a few dozen points then has
    # a handful of pairs within the threshold, and one pair more or less (a
    # near tie, a point at the threshold) moves its Kabsch update far. Held
    # per (instance, frame). The whole path: at least 85 % of the slices
    # and 99 % of the points within 1e-2; its inputs differ within the
    # tolerances above (ego poses 1e-3), and on the CPU alone K4's own
    # arithmetic in place of the plain expansion moves slices of over 100
    # points a frame by 0.26 (tools/icp_spread.py).
    valid_pts = bt["point_valid"][0].cpu()
    lab0 = labels[0].cpu()
    tid0 = bt["time_idx"][0].cpu().long()
    occ = torch.unique(lab0[(lab0 > 0) & valid_pts])
    t_frames = gpu["inst_pose_est"].shape[2]
    dpose = (gpu["inst_pose_est"][0, occ, 1:]
             - cpu["inst_pose_est"][0, occ, 1:]).abs().amax((-1, -2))
    pose_ok = dpose <= 1e-2
    slice_pts = torch.bincount(lab0[valid_pts].long() * t_frames + tid0[valid_pts],
                               minlength=(int(lab0.max()) + 1) * t_frames).reshape(-1, t_frames)
    bad = [(int(occ[i]), int(j) + 1, round(float(dpose[i, j]), 4), int(slice_pts[occ[i], 0]),
            int(slice_pts[occ[i], j + 1]))
           for i, j in zip(*torch.nonzero(~pose_ok, as_tuple=True))]
    rec_share = float(((gpu["rec_est"] - cpu["rec_est"]).abs().amax(-1)[0]
                       <= 1e-2)[valid_pts].float().mean())
    pose_share = float(pose_ok.float().mean()) if pose_ok.numel() else 1.0
    if pose_share < 0.85 or rec_share < 0.99:
        fail(f"test path instance ICP GPU vs CPU: {pose_share:.3f} of the (instance, frame) "
             f"poses and {rec_share:.4f} of the points within 1e-2; differing: {bad}")
    # The instance ICP alone on the card's inputs (its points, labels and
    # TPointNet poses), the card's result against the CPU's, each way held
    # as the whole path was before (every slice of 100 or more points in
    # both frames within 1e-2, at least 85 % of all slices): against the CPU
    # computing the distances as K4 does (`difference_form`), no slice set
    # aside; against the plain version, the slices that the CPU's two
    # roundings put within 1e-4 of each other (one rounding of the distances
    # decides the others). The smaller slices are held by the share alone:
    # a first iteration with a few pairs within the threshold leaves their
    # Kabsch covariance near rank 1 (tools/icp_spread.py), and the card's
    # SVD and the CPU's then pick other rotations.
    from pcaccumulation_tpu_torch.ops.icp import refine_instance_poses

    if len(icp_calls.calls) != 1:
        fail(f"test path: the instance ICP ran {len(icp_calls.calls)} times in one forward")
    args, kw, card_pose = icp_calls.calls[0]
    args = [x.cpu() if torch.is_tensor(x) else x for x in args]
    plain_pose = refine_instance_poses(*args, **kw)
    with difference_form():
        diff_pose = refine_instance_poses(*args, **kw)
    d_iso = (card_pose.cpu()[occ, 1:] - plain_pose[occ, 1:]).abs().amax((-1, -2))
    d_k4 = (card_pose.cpu()[occ, 1:] - diff_pose[occ, 1:]).abs().amax((-1, -2))
    spread = (diff_pose[occ, 1:] - plain_pose[occ, 1:]).abs().amax((-1, -2))
    settled = spread <= 1e-4
    big = torch.minimum(slice_pts[occ, :1], slice_pts[occ, 1:]) >= 100
    iso_share = float((d_iso <= 1e-2).float().mean()) if d_iso.numel() else 1.0
    k4_share = float((d_k4 <= 1e-2).float().mean()) if d_k4.numel() else 1.0
    settled_share = float(settled.float().mean()) if settled.numel() else 1.0
    iso_bad = [(int(occ[i]), int(j) + 1, round(float(d_k4[i, j]), 4),
                round(float(d_iso[i, j]), 4), round(float(spread[i, j]), 4),
                int(slice_pts[occ[i], 0]), int(slice_pts[occ[i], j + 1]))
               for i, j in zip(*torch.nonzero((d_k4 > 1e-2) | (d_iso > 1e-2) | ~settled,
                                              as_tuple=True))]
    if (bool((big & (d_k4 > 1e-2)).any()) or k4_share < 0.85
            or bool((settled & big & (d_iso > 1e-2)).any()) or iso_share < 0.85
            or settled_share < 0.85):
        fail(f"test path instance ICP alone, card vs CPU on the card's inputs: {k4_share:.3f} of "
             f"the slices within 1e-2 of K4's arithmetic, {iso_share:.3f} of the plain "
             f"version's, {settled_share:.3f} settled (the CPU's two roundings within 1e-4); "
             f"(slot, frame, card vs K4's arithmetic, card vs plain, the CPU's two, points in "
             f"frame 0, in frame t) of the others: {iso_bad}")
    # the clusterer on the CPU, on the card's inputs
    ccfg = cfg["cluster"]
    valid = bt["point_valid"][0].cpu()
    moving = torch.argmax(gpu["mos_est"][0], -1) == 1
    lab_cpu = cluster_moving_points(
        gpu["transformed_points"][0], gpu["offset_est"][0], moving, valid,
        eps=ccfg["eps_dbscan"], min_samples=ccfg["min_samples_dbscan"],
        min_cluster_size=ccfg["min_p_cluster"], pre_voxel=0.05,
        max_cluster_points=ccfg["max_cluster_points"], n_iters=ccfg["bfs_iters"])
    k_cap = bt["inst_motion_gt"].shape[1]
    lab_cpu = torch.where(lab_cpu < k_cap, lab_cpu, 0)
    sel = (moving & valid).numpy()
    agree = pair_agreement(labels[0].cpu().numpy()[sel], lab_cpu.numpy()[sel])
    if agree < 0.99:
        fail(f"clustering: card vs CPU pair agreement {agree:.6f} < 0.99")
    log(f"test path GPU vs CPU (3 ICP iterations, card's labels injected): "
        + ", ".join(f"{k} {v:.2e} (tol {tol[k]})" for k, v in errs.items() if k != "ego_motion_est")
        + f"; {ego_log}; FB decisions flipped {flips}; instance ICP: {int(pose_ok.sum())} of "
        f"{pose_ok.numel()} (instance, frame) poses within 1e-2, {rec_share:.6f} of the points' "
        f"rec_est; the others (slot, frame, max |d pose|, points in frame 0, in frame t): "
        f"{bad}; the instance ICP alone on the card's inputs: {k4_share:.4f} of the slices "
        f"within 1e-2 of the CPU with K4's arithmetic and {iso_share:.4f} of the plain "
        f"version, {settled_share:.4f} settled (the CPU's two roundings within 1e-4), every "
        f"slice of 100 or more points within 1e-2 of K4's arithmetic and, settled, of the "
        f"plain version; the others (slot, frame, card vs K4's arithmetic, card vs plain, the "
        f"CPU's two, points in frame 0, in frame t): {iso_bad}; "
        f"clustering of {int(sel.sum())} moving points on the "
        f"card vs the CPU: pair agreement {agree:.6f}, labels equal "
        f"{bool(torch.equal(labels[0].cpu(), lab_cpu))} ({time.perf_counter() - t0:.1f} s)")
    return counts["K4"], fwd_ms


def tester_phase(port) -> None:
    """The Tester on configs/synthetic.yaml with both ICPs on over the 3 test
    scenes of data/synthetic, into a temporary directory; the dumps' schema;
    the port's evaluation over them."""
    from pcaccumulation_tpu_torch import evaluation
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.profile_forward import test_mode_config
    from pcaccumulation_tpu_torch.train.tester import DUMP_KEYS, Tester

    t0 = time.perf_counter()
    cfg = test_mode_config(load_config("configs/synthetic.yaml"))
    cfg["misc"]["exp_name"] = "chip_smoke"
    torch.manual_seed(SEED)
    model = port.build_model(cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_test_")
    try:
        root = f"{tmp}/results/chip_smoke"
        Tester(cfg, model, save_dir=f"{tmp}/run", results_dir=root).test()
        dtypes = {"fb_label": np.bool_, "sd_label": np.bool_, "epe_per_point": np.float16,
                  "relative_error": np.float16, "time_indice": np.int8}
        scenes = sorted(os.listdir(root))
        if len(scenes) != 3:
            fail(f"Tester: dumps for {scenes}, want the 3 test scenes")
        n_pts = []
        for scene in scenes:
            with np.load(f"{root}/{scene}/flow_error.npz") as d:
                if set(d.files) != set(DUMP_KEYS):
                    fail(f"Tester {scene}: keys {sorted(d.files)}")
                n = d["epe_per_point"].shape[0]
                for k in DUMP_KEYS:
                    if d[k].dtype != dtypes[k] or d[k].shape != (n,):
                        fail(f"Tester {scene}: {k} {d[k].dtype} {d[k].shape}")
                if n == 0 or d["time_indice"].min() < 1 \
                        or not np.isfinite(d["epe_per_point"].astype(np.float64)).all():
                    fail(f"Tester {scene}: empty, anchor frame kept or non-finite epe")
                n_pts.append(n)
        if evaluation.main(["evaluation", root, "synthetic"]) != 0:
            fail("the port's evaluation failed on the Tester's dumps")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"Tester: 3 test scenes of data/synthetic (both ICPs, 50 iterations) dumped "
        f"{n_pts} points with the reference schema; the port's evaluation read them "
        f"({time.perf_counter() - t0:.1f} s)")


JAX_FIXTURE = os.path.join("tests", "data", "jax_orbax_tiny")


def val_against(what: str, got: dict, want: dict, pillar_valid: torch.Tensor) -> dict:
    """A val forward (`got`) against a reference's outputs (`want`, tensors
    or arrays) on the same weights and batch: `VAL_TOL` per output, MOS and
    offsets on the rows whose FB decision agrees (a flipped FB decision
    changes which rows are decoded), at most 1 in 1,000 pillar FB
    decisions flipped. Returns the errors."""
    got = {k: v.detach().float().cpu() for k, v in got.items() if torch.is_tensor(v)}
    want = {k: torch.as_tensor(np.asarray(v)).float() for k, v in want.items()
            if torch.is_tensor(v) or isinstance(v, np.ndarray)}
    pv = pillar_valid.cpu()
    est_g = got["fb_logit_pillar"][..., 1] > got["fb_logit_pillar"][..., 0]
    est_w = want["fb_logit_pillar"][..., 1] > want["fb_logit_pillar"][..., 0]
    flips = int((est_g != est_w)[pv].sum())
    same_fg = got["fb_mask"] == want["fb_mask"]
    errs = {}
    for key, tol in VAL_TOL.items():
        if tuple(got[key].shape) != tuple(want[key].shape):
            fail(f"{what} {key}: shape {tuple(got[key].shape)} != {tuple(want[key].shape)}")
        d = (got[key] - want[key]).abs()
        if key in ("mos_est", "offset_est"):
            d = d[same_fg]
        errs[key] = float(d.max()) if d.numel() else 0.0
        if errs[key] > tol:
            fail(f"{what} {key}: max abs err {errs[key]:.3e} > {tol}")
    if flips > max(1, int(pv.sum()) // 1000):
        fail(f"{what}: {flips} pillar FB decisions differ")
    errs.update(fb_flips=flips, pillars=int(pv.sum()))
    return errs


def jax_fixture_phase(port, dev="cuda") -> dict:
    """A JAX training run carried into the port on the card, from the
    tracked orbax checkpoint `tests/data/jax_orbax_tiny/`
    (tools/make_jax_orbax_fixture.py: the JAX package's Trainer at the tiny
    training config after 2 updates and one further micro-step; its
    `expected.npz`: the batches, the JAX val forward, the parameters after
    the JAX Trainer's next micro-step):
    - `read_checkpoint` reads it (no jax, orbax or tensorstore), timed;
    - the Tester (`misc.pretrain`) and the Predictor (`ckpt_path`) on `dev`
      load the same weights; the val forward (eval BN) of the Tester's
      model on batch 0 against the JAX package's (`val_against`), the
      Predictor's model the same bits;
    - `Trainer.load_pretrain` (`misc.pretrain`) resumes Adam's count 2,
      mini_step 1 and the accumulator; one `train_step` on batch 1 ends the
      accumulation and applies the third update: every leaf the JAX update
      changed is held to the JAX package's next parameters by
      `leaf_criterion`, and so is its update (the parameters' change); the
      leaves it left alone stay equal bit for bit.
    Returns the times."""
    import copy

    from pcaccumulation_tpu_torch.serve import Predictor
    from pcaccumulation_tpu_torch.train.tester import Tester
    from pcaccumulation_tpu_torch.train.trainer import Trainer
    from pcaccumulation_tpu_torch.utils.checkpoint import read_checkpoint

    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), JAX_FIXTURE)
    ckpt = os.path.join(root, "model_latest.ckpt")
    with open(os.path.join(root, "cfg.json")) as f:
        cfg = json.load(f)
    exp = np.load(os.path.join(root, "expected.npz"))
    part = {p: {k.split("/", 1)[1]: exp[k] for k in exp.files if k.startswith(p + "/")}
            for p in ("batch0", "batch1", "val", "next")}
    t1 = time.perf_counter()
    state = read_checkpoint(ckpt)
    read_s = time.perf_counter() - t1
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "orbax", "tensorstore",
                                                             "zstandard", "optax", "flax")]
    if loaded:
        fail(f"JAX fixture: reading it imported {loaded}")
    opt = state["optimizer"]
    if (opt["count"], opt["mini_step"], opt["n_skipped"]) != (2, 1, 0):
        fail(f"JAX fixture: optimizer state count {opt['count']}, mini_step "
             f"{opt['mini_step']}, skipped {opt['n_skipped']}; want 2, 1, 0")
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_fixture_")
    try:
        cfg_t = copy.deepcopy(cfg)
        cfg_t["misc"].update(pretrain=ckpt, mode="test")
        tester = Tester(cfg_t, port.build_model(cfg_t, device=dev), save_dir=run_dir,
                        device=dev, results_dir=os.path.join(run_dir, "results"))
        pred = Predictor(cfg, ckpt_path=ckpt, device=dev)
        b0 = port.to_device(part["batch0"], dev)
        with torch.no_grad():
            out = tester.model.eval()(b0, mode="val")
            out_p = pred.model.eval()(b0, mode="val")
        for k, v in out.items():
            if torch.is_tensor(v) and not torch.equal(v, out_p[k]):
                fail(f"JAX fixture: the Predictor's val forward differs from the Tester's at {k}")
        errs = val_against("JAX fixture val forward against the JAX package's", out,
                           part["val"], b0["pillar_valid"])

        cfg_r = copy.deepcopy(cfg)
        cfg_r["misc"].update(pretrain=ckpt, mode="train")
        tr = Trainer(cfg_r, port.build_model(cfg_r, device=dev), {"train": [None] * 2},
                     save_dir=os.path.join(run_dir, "train"), device=dev)
        with open(os.path.join(run_dir, "train", "log")) as f:
            if "reinitialised" in f.read():
                fail("JAX fixture: the Trainer reinitialised the optimizer")
        names = [n for n, _ in tr.model.named_parameters()]
        before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        if (tr.optimizer.count, tr.optimizer.mini_step, tr.start_epoch) != (2, 1, 2):
            fail(f"JAX fixture: resumed count {tr.optimizer.count}, mini_step "
                 f"{tr.optimizer.mini_step}, start epoch {tr.start_epoch}")
        t1 = time.perf_counter()
        stats = tr.train_step(port.to_device(part["batch1"], dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        if (tr.optimizer.count, tr.optimizer.mini_step) != (3, 0):
            fail(f"JAX fixture: after the step count {tr.optimizer.count}, mini_step "
                 f"{tr.optimizer.mini_step}; want 3, 0")
        after = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    # biases directly before a train-mode BatchNorm take a gradient that is
    # zero in exact arithmetic (cancellation residue): set aside, as in
    # tests/test_torch_parallel.py
    residue = [n for n in part["next"] if n.endswith(STRUCTURAL_ZERO)]
    moved = [n for n in names if n in part["next"] and n not in residue]
    still = [n for n in names if n not in part["next"]]
    for n in still:
        if not torch.equal(after[n], before[n].cpu()):
            fail(f"JAX fixture: {n}, which the JAX update left alone, moved")
    want = {n: torch.from_numpy(part["next"][n]).reshape(after[n].shape) for n in moved}
    p_crit = leaf_criterion(want, {n: after[n] for n in moved},
                            what="JAX fixture parameters after the update, port vs JAX")
    u_crit = leaf_criterion({n: want[n] - before[n].cpu() for n in moved},
                            {n: after[n] - before[n].cpu() for n in moved},
                            what="JAX fixture update, port vs JAX")
    log(f"JAX fixture ({JAX_FIXTURE}, the JAX package's orbax save of its Trainer after 2 "
        f"updates and a micro-step): read_checkpoint {read_s:.3f} s (no jax, orbax or "
        f"tensorstore imported); the Tester and the Predictor on {dev}: the same weights, "
        f"val forward against the JAX package's " + ", ".join(
            f"{k} {errs[k]:.2e} (tol {t})" for k, t in VAL_TOL.items())
        + f", FB decisions flipped {errs['fb_flips']} of {errs['pillars']}; the Trainer "
        f"resumed Adam's count 2 and mini_step 1, its step on batch 1 (loss "
        f"{float(stats['loss']):.6f}, {step_s:.3f} s) applied update 3: {len(moved)} leaves "
        f"the JAX update moved, parameters worst {p_crit[4]} rel-norm {p_crit[2]:.3e}, update "
        f"worst {u_crit[4]} rel-norm {u_crit[2]:.3e} cosine {u_crit[3]:.6f} ({u_crit[0]} "
        f"checked, {u_crit[1]} below the noise floor); {len(still)} leaves it left alone "
        f"unchanged; set aside (BatchNorm-cancelled biases) {residue} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"fixture_read_ms": 1e3 * read_s, "fixture_step_ms": 1e3 * step_s}


def bf16_vs_f32(what: str, o16: dict, o32: dict, batch: dict, rec_share_min: float,
                against_f32: bool = True) -> dict:
    """A bf16 forward against a reference forward (the float32 one, or
    the bf16 one on the CPU) on the same weights and batch, by
    tests/test_precision.py's criteria as far as they are well posed at
    the nuScenes width on seeded weights:
    - FB decisions: every valid point whose pillar's reference logit
      margin lies outside the band where the two forwards' logit drift can
      move it (twice the largest drift of a valid pillar's logits) decides
      alike; the band holds at most 10 % of the points (a path that
      computes something else drifts by the logits' own scale, and its
      band holds most of them). On seeded weights the margins are dense
      about the threshold, and even one bf16 function summed in two orders
      (the card's and the CPU's, compared below) splits a few points
      differently; the overall share is reported.
    - MOS decisions >= 99.5 % equal; ego poses within 5e-2.
    - FB logits differ from float32's (`against_f32`), but by no more than
      5 % of their largest magnitude (bf16's 2^-8 rounding over the ~25
      layers from the canvas).
    - rec_est within 0.05 at `rec_share_min` of the valid points, beyond
      what the ego poses move the point (its transformed_points drift):
      the ego criterion holds the poses, and at the preset's 36 m range a
      pose entry 1e-3 apart moves a point by up to 4 cm.
    Returns the measures."""
    v = batch["point_valid"][0].cpu()
    pv = batch["pillar_valid"][0].cpu()
    p2v = batch["pillar_of_point"][0].cpu().long().clamp(0, pv.numel() - 1)
    o16 = {k: x[0].float().cpu() for k, x in o16.items() if torch.is_tensor(x) and x.dim()}
    o32 = {k: x[0].float().cpu() for k, x in o32.items() if torch.is_tensor(x) and x.dim()}
    lp16, lp32 = o16["fb_logit_pillar"], o32["fb_logit_pillar"]
    band = 2.0 * float((lp16 - lp32).abs()[pv].max())
    clear = ((lp32[:, 1] - lp32[:, 0]).abs() > band)[p2v] & v
    same_fb = o16["fb_est_per_points"] == o32["fb_est_per_points"]
    m = {"fb_equal": float(same_fb[v].float().mean()),
         "fb_equal_clear": float(same_fb[clear].float().mean()),
         "fb_band_share": 1.0 - float(clear.sum()) / float(v.sum()),
         "mos_equal": float((o16["mos_est"][v].argmax(-1) == o32["mos_est"][v].argmax(-1))
                            .float().mean()),
         "ego": float((o16["ego_motion_est"] - o32["ego_motion_est"]).abs().max()),
         "fb_logits": float((o16["fb_seg_est"] - o32["fb_seg_est"]).abs().max()),
         "fb_logits_scale": float(o32["fb_seg_est"].abs().max())}
    rec = (o16["rec_est"] - o32["rec_est"]).abs().amax(-1)[v]
    moved = (o16["transformed_points"] - o32["transformed_points"]).abs().amax(-1)[v]
    m["rec_max"], m["points_max"] = float(rec.max()), float(moved.max())
    m["rec_share"] = float((rec <= 0.05 + moved).float().mean())
    if m["fb_equal_clear"] < 1.0 or m["fb_band_share"] > 0.10:
        fail(f"{what}: FB decisions differ outside the logit drift's band: {m}")
    if m["mos_equal"] < 0.995 or m["ego"] >= 5e-2:
        fail(f"{what}: {m}")
    if not (0.0 < m["fb_logits"] or not against_f32) or m["fb_logits"] > 0.05 * m[
            "fb_logits_scale"]:
        fail(f"{what}: the FB logits differ by 0 or by more than 5 % of their scale: {m}")
    if m["rec_share"] < rec_share_min:
        fail(f"{what}: rec_est within 0.05 beyond the ego drift at {m['rec_share']} of the "
             f"points, want {rec_share_min}: {m}")
    return m


def preset_phase(port, smi: str, preset: str = "configs/nuscene.yaml",
                 preset_name: str = "nuScenes") -> tuple[dict, dict, dict]:
    """A bf16 preset on the card: `preset` is configs/nuscene.yaml (T=11,
    288x288 BEV, 120,000 points, 40,000 pillars, 48 instances) or
    configs/waymo.yaml (T=5, 288x288 BEV, 90,000 points, 30,000 pillars,
    48 instances), compute_dtype bfloat16, `preset_name` its name in the log;
    seeded weights (`build_model`'s, drawn as the JAX package's
    `MotionNet.init` draws them; the TPointNet regressor's last layer
    about the identity and the Sinkhorn temperature at 0.1, as trained
    weights would have them), deterministic keypoints, the FB and MOS heads
    calibrated on the float32 model: the bf16 val forward (a main path,
    counts zeroed before and read after: K1 and K2 in bf16, no float32
    kernel) and the test forward with both ICPs at 50 iterations, each
    held against the float32 forward on the same weights and batch
    (`bf16_vs_f32`), the val forward also against the bf16 forward on the
    CPU, and timed beside the float32 ones. Returns (the bf16 launch counts
    of the val path, the times, the float32 model's weights)."""
    import copy
    import math

    from pcaccumulation_tpu_torch.config import check_supported, load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.kernels.chamfer import nn
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift, row_shift_blocks
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool
    from pcaccumulation_tpu_torch.profile_forward import (
        calibrate_heads,
        default_scenes,
        test_mode_config,
    )

    t0 = time.perf_counter()
    cfg16 = load_config(preset,
                        ["--misc.mode=val", "--train.ckpt_backend=pickle"])
    check_supported(cfg16)
    cfg16["pose_estimation"]["deterministic_sampling"] = True
    cfg32 = copy.deepcopy(cfg16)
    cfg32["precision"]["compute_dtype"] = "float32"
    # scenes that fill the preset in all its sweeps (`default_scenes`; at 11
    # sweeps ~10,700 points and ~3,300 pillars in each)
    batches = [port.to_device(collate([s])) for s in default_scenes(cfg16, 2)]
    n_fwd = len(batches)
    m32 = port.build_model(cfg32, generator=torch.Generator().manual_seed(SEED))
    # a trained TPointNet regresses a residual motion; a seeded one regresses
    # a random rotation of each instance about its centroid, which a
    # bf16-sized change of its embeddings turns by metres at the instance's
    # extent. Its last layer is scaled to a residual about the identity.
    reg = m32.reconstructor.alignment.regressor[6]
    with torch.no_grad():
        reg.weight.mul_(0.01)
        reg.bias.copy_(torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]))
        # the learned Sinkhorn temperature, exp(beta) + 0.02, from its initial
        # 0.027 to 0.1: on seeded features the sharp assignment picks among
        # near-ties, which a bf16-sized change of the features reorders, and
        # the pose jumps with them; the soft one averages over them
        m32.ego_motion_head.beta.fill_(math.log(0.08))
    fg_share, mov_share = calibrate_heads(m32, batches[0])
    m16 = port.build_model(cfg16)
    m16.load_state_dict(m32.state_dict())
    log(f"{preset_name}: {n_fwd} scenes, valid points "
        f"{[int(b['point_valid'].sum()) for b in batches]} of {cfg16['capacity']['max_points']}, "
        f"valid pillars {[int(b['pillar_valid'].sum()) for b in batches]} of "
        f"{cfg16['capacity']['max_pillars']}; heads calibrated to FG {fg_share:.4f}, moving "
        f"{mov_share:.4f} ({time.perf_counter() - t0:.1f} s host prep)")

    def zero():
        seg_pool.launches = seg_pool.launches_bf16 = 0
        row_shift_blocks.launches = row_shift_blocks.launches_bf16 = 0
        row_shift.launches = row_shift.launches_bf16 = nn.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {"K1": seg_pool.launches, "K1-bf16": seg_pool.launches_bf16,
                "K2": row_shift_blocks.launches, "K2-bf16": row_shift_blocks.launches_bf16,
                "K3": row_shift.launches, "K3-bf16": row_shift.launches_bf16, "K4": nn.launches}

    # ---- the bf16 val forward: this slice's main path ----
    zero()
    with torch.no_grad():
        val16 = [m16(bt) for bt in batches]
    val_counts = counts()
    k1_per = cfg16["pillar_encoder"]["depth"] - 1  # the pillar encoder's pools: 2
    want = {"K1": 0, "K1-bf16": k1_per * n_fwd, "K2": 0, "K2-bf16": 3 * n_fwd, "K3": 0,
            "K3-bf16": 0, "K4": 0}
    if val_counts != want:
        fail(f"{preset_name} bf16 val forward launched {val_counts}, want {want}")
    with torch.no_grad():
        val32 = [m32(bt) for bt in batches]
    for i, out in enumerate(val16):
        for key, x in out.items():
            if torch.is_tensor(x) and x.is_floating_point() and not bool(torch.isfinite(x).all()):
                fail(f"{preset_name} bf16 val forward, scene {i}: non-finite {key}")
    val_m = [bf16_vs_f32(f"{preset_name} val bf16 vs float32", a, b, bt, 1.0)
             for a, b, bt in zip(val16, val32, batches)]
    # the same bf16 function on the CPU (its plain kernels), scene 0
    t1 = time.perf_counter()
    cpu16 = port.build_model(cfg16, device="cpu")
    cpu16.load_state_dict({k: x.cpu() for k, x in m32.state_dict().items()})
    with torch.no_grad():
        ref = cpu16({k: x.cpu() for k, x in batches[0].items()})
    cpu_m = bf16_vs_f32(f"{preset_name} val bf16 card vs CPU", val16[0], ref, batches[0], 1.0,
                        against_f32=False)
    log(f"{preset_name} bf16 val forward, card vs CPU (the same function, summed in other orders; "
        f"{time.perf_counter() - t1:.1f} s on the CPU): {cpu_m}")
    from_id = float((val16[0]["ego_motion_est"][:, 1:].cpu()
                     - torch.eye(4)).abs().amax((-1, -2)).min())
    if from_id < 1e-4:
        fail(f"{preset_name} val: a bf16 ego pose of frames 1..T-1 is the identity; nothing "
             "compared")
    log(f"{preset_name} bf16 val forward: {n_fwd} forwards launched {val_counts}; against the "
        f"float32 "
        f"forward on the card (same weights and batch): {val_m}; ego poses of frames "
        f"1..{cfg16['data']['n_frames'] - 1} at "
        f"least {from_id:.4f} from the identity")

    times = {}
    for name, model in (("val_f32", m32), ("val_bf16", m16), ("val_bf16_2", m16),
                        ("val_f32_2", m32)):
        times[name] = forward_ms(model, batches, 5)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        m16(batches[0])
    peak16 = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        m32(batches[0])
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30

    # ---- the bf16 test forward, both ICPs at 50 iterations ----
    def test_models(iters):
        out = []
        for cfg in (cfg16, cfg32):
            mdl = port.build_model(test_mode_config(copy.deepcopy(cfg), iters))
            mdl.load_state_dict(m32.state_dict())
            out.append(mdl)
        return out

    t16, t32 = test_models(50)
    zero()
    with torch.no_grad():
        test16 = [t16(bt, mode="test") for bt in batches]
    test_counts = counts()
    want = {"K1": 0, "K1-bf16": k1_per * n_fwd, "K2": 0, "K2-bf16": 3 * n_fwd, "K3": 0,
            "K3-bf16": 0, "K4": 100 * n_fwd}
    if test_counts != want:
        fail(f"{preset_name} bf16 test forward launched {test_counts}, want {want}")
    n_inst = []
    for i, out in enumerate(test16):
        for key, x in out.items():
            if torch.is_tensor(x) and x.is_floating_point() and not bool(torch.isfinite(x).all()):
                fail(f"{preset_name} bf16 test forward, scene {i}: non-finite {key}")
        labels = out["inst_labels_est"][0]
        slots = torch.unique(labels[labels > 0])
        dets = torch.cat([torch.linalg.det(out["ego_motion_est"][..., :3, :3].double()).reshape(-1),
                          torch.linalg.det(out["inst_pose_est"][0, slots][..., :3, :3].double())
                          .reshape(-1)])
        if float((dets - 1).abs().max()) > 1e-4:
            fail(f"{preset_name} bf16 test forward, scene {i}: a pose is not a rotation")
        n_inst.append(len(slots))
    # held against float32 at 3 ICP iterations, as the default config's test
    # path is held against the CPU: 50 iterations from starting poses 1e-2
    # apart may settle a frame's ICP in another local minimum (the float32
    # forward on two devices does the same), which tests the start, not bf16
    t16_3, t32_3 = test_models(3)
    with torch.no_grad():
        test32 = [t32_3(bt, mode="test") for bt in batches]
        # the float32 run's clusters injected, so that both reconstruct the
        # same instances
        test16_inj = [t16_3(bt, mode="test", inst_labels_override=o["inst_labels_est"])
                      for bt, o in zip(batches, test32)]
        agree = [pair_agreement(t16_3(bt, mode="test")["inst_labels_est"][0].cpu().numpy(),
                                o["inst_labels_est"][0].cpu().numpy())
                 for bt, o in zip(batches, test32)]
    # the instance ICP starts from the TPointNet's poses and moves a few
    # small slices far on a bf16-sized nudge (the JAX package's own
    # bf16-vs-float32 drift does the same, tests/test_torch_precision.py)
    test_m = [bf16_vs_f32(f"{preset_name} test bf16 vs float32", a, b, bt, 0.99)
              for a, b, bt in zip(test16_inj, test32, batches)]
    log(f"{preset_name} bf16 test forward (both ICPs, 50 iterations): {n_fwd} forwards launched "
        f"{test_counts}; finite, rigid poses; instances found {n_inst}. At 3 ICP iterations "
        f"against the float32 forward: clustering pair agreement {agree}; with the float32 "
        f"run's labels injected: {test_m}")
    for name, model in (("test_f32", t32), ("test_bf16", t16)):
        times[name] = forward_ms(model, batches, 3, mode="test")
    log(f"{preset_name} forwards (B=1, CUDA events, median ms and all times): " + "; ".join(
        f"{k} {v[0]:.3f} ({', '.join(f'{t:.3f}' for t in v[1])})" for k, v in times.items())
        + f"; peak memory of one val forward bf16 {peak16:.3f} GiB, float32 {peak32:.3f} GiB; "
        f"on {smi} ({time.perf_counter() - t0:.1f} s)")
    return val_counts, {k: v[0] for k, v in times.items()}, m32.state_dict()


def nuscenes_cli_phase(port) -> None:
    """`python -m pcaccumulation_tpu_torch.main configs/nuscene.yaml 1 1
    --misc.mode=test --train.ckpt_backend=pickle` on the card over two
    synthetic samples of 11 sweeps at 20 Hz written to a temporary
    directory (the test split holds one): bf16 kernels only, one dump."""
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.synthetic import generate_sample
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift_blocks
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool
    from pcaccumulation_tpu_torch.main import main as cli_main

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nuscene_")
    cwd = os.getcwd()
    try:
        data = os.path.join(tmp, "data")
        for i in range(2):
            os.makedirs(os.path.join(data, f"scene_{i:04d}"))
            np.savez_compressed(os.path.join(data, f"scene_{i:04d}", "sample_00000.npz"),
                                **generate_sample(SEED + 100 + i, n_frames=11, freq=20.0))
        for split, i in (("train", 0), ("val", 0), ("test", 1)):
            with open(os.path.join(data, f"{split}_info.txt"), "w") as f:
                f.write(f"scene_{i:04d}/sample_00000.npz\n")
        os.chdir(tmp)
        seg_pool.launches = seg_pool.launches_bf16 = 0
        row_shift_blocks.launches = row_shift_blocks.launches_bf16 = 0
        rc = cli_main(["main", os.path.join(repo, "configs", "nuscene.yaml"), "1", "1",
                       "--misc.mode=test", "--train.ckpt_backend=pickle",
                       "--misc.exp_name=nuscene_cli", f"--path.dataset_base={data}"])
        torch.cuda.synchronize()
        got = (seg_pool.launches, seg_pool.launches_bf16, row_shift_blocks.launches,
               row_shift_blocks.launches_bf16)
        dumps = os.listdir(os.path.join(tmp, "results", "nuscene_cli"))
        nus = load_config(os.path.join(repo, "configs", "nuscene.yaml"))
        k1_per = nus["pillar_encoder"]["depth"] - 1
        if rc != 0 or got != (0, k1_per, 0, 3) or dumps != ["scene_0001"]:
            fail(f"nuScenes CLI test mode: rc {rc}, launches (K1, K1-bf16, K2, K2-bf16) {got}, "
                 f"dumps {dumps}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"nuScenes CLI (configs/nuscene.yaml, --misc.mode=test --train.ckpt_backend=pickle): "
        f"one test scene dumped, K1-bf16 {k1_per}x and K2-bf16 3x, no float32 kernel "
        f"({time.perf_counter() - t0:.1f} s)")


def bf16_leaf_criterion(g16: dict, g32: dict, names: list,
                        what: str = "bf16 vs float32") -> tuple[int, int, float, float, str]:
    """The bf16 gradient against the float32 one on the card, per leaf of
    `names` above the noise floor (`leaf_criteria.bf16_misses`):
    rel-norm < BF16_LEAF_REL and cosine > BF16_LEAF_COS (bf16 rounds each
    product to 8 significant bits, the FB decisions and the keypoints they
    choose move with an ulp: a leaf's gradient is a noisy estimate of the
    float32 one, not a rounding of it). More leaves checked than below the
    floor. Returns (checked, noise, worst rel, worst cos, worst leaf) and
    fails on a leaf that misses it."""
    dist, misses = bf16_misses(g16, g32, names)
    for n in misses:
        fail(f"{what} gradient of {n}: rel-norm {dist[n][0]:.3e}, cosine {dist[n][1]:.6f}")
    checked, noise = len(dist), len(names) - len(dist)
    if checked <= noise:
        fail(f"{what} gradients: {checked} leaves checked, {noise} below the noise floor")
    rel, cos, leaf = max((r, c, n) for n, (r, c) in dist.items())
    return checked, noise, rel, cos, leaf


def preset_train_phase(port, state: dict, smi: str, preset: str = "configs/nuscene.yaml",
                       preset_name: str = "nuScenes", steps: tuple = ((2, 4), (1, 2))) -> dict:
    """A bf16 preset's training micro-step (`preset`, configs/nuscene.yaml or
    configs/waymo.yaml, named `preset_name` in the log; `Trainer.train_step`
    at B=4 and iter_size 2, train-mode BN, the random keypoint draw) on four
    synthetic scenes of the preset's sweeps (`default_scenes`) and the
    preset phase's weights (`state`: flax's init, calibrated heads):
    warm-up micro-steps, then timed ones (`steps`: (warm-up, timed) in bf16,
    then in float32) with the kernels' counts zeroed
    before and read after (per micro-step K1-bf16 forward and gradient
    `pillar_encoder.depth - 1` times each, K2-bf16 forward 3 times, no K2
    gradient, no float32 K1 or K2), finite loss terms, Adam's count, peak
    memory; the float32 micro-step at the same preset, weights and batch
    timed beside it. Then the bf16 gradient against the float32 one (B=1,
    eval BN, deterministic keypoints) by `bf16_leaf_criterion`: (a) FuseLoss
    without the TPointNet objective, every leaf; (b) the whole FuseLoss,
    every leaf not upstream of the TPointNet's max pools, the others
    reported beside two float32 runs' own spread. Returns the bf16 launch
    counts of the timed micro-steps and the measures."""
    import copy

    from pcaccumulation_tpu_torch.config import check_supported, load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.kernels.chamfer import nn
    from pcaccumulation_tpu_torch.kernels.row_shift import (
        row_shift,
        row_shift_blocks,
        row_shift_blocks_backward,
    )
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_backward
    from pcaccumulation_tpu_torch.profile_forward import default_scenes
    from pcaccumulation_tpu_torch.train.loss import fuse_loss
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg16 = load_config(preset,
                        ["--misc.mode=train", "--train.ckpt_backend=pickle"])
    check_supported(cfg16)
    cfg32 = copy.deepcopy(cfg16)
    cfg32["precision"]["compute_dtype"] = "float32"
    bsz, iter_size = cfg16["train"]["batch_size"], cfg16["train"]["iter_size"]
    k1_per = cfg16["pillar_encoder"]["depth"] - 1
    scenes = default_scenes(cfg16, bsz)
    batch = port.to_device(collate(scenes))
    log(f"{preset_name} train batch: B={bsz}, valid points "
        f"{[int(x) for x in batch['point_valid'].sum(1)]}, valid pillars "
        f"{[int(x) for x in batch['pillar_valid'].sum(1)]} ({time.perf_counter() - t0:.1f} s host "
        f"prep)")
    counters = {"K1": (seg_pool, "launches"), "K1-bf16": (seg_pool, "launches_bf16"),
                "K1 bwd": (seg_pool_backward, "launches"),
                "K1 bwd-bf16": (seg_pool_backward, "launches_bf16"),
                "K2": (row_shift_blocks, "launches"), "K2-bf16": (row_shift_blocks, "launches_bf16"),
                "K2 bwd": (row_shift_blocks_backward, "launches"),
                "K2 bwd-bf16": (row_shift_blocks_backward, "launches_bf16"),
                "K3": (row_shift, "launches"), "K3-bf16": (row_shift, "launches_bf16"),
                "K4": (nn, "launches")}
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_nus_train_")
    res = {}
    try:
        for (name, cfg), (n_warm, n_timed) in zip((("bf16", cfg16), ("f32", cfg32)), steps):
            model = port.build_model(cfg)
            model.load_state_dict(state)
            warm = Trainer(cfg, model, {"train": [batch, batch]}, save_dir=run_dir)
            for i in range(n_warm):
                warm.train_step(batch, warm.step_generator(0, "train", i))
            model.load_state_dict(state)
            tr = Trainer(cfg, model, {"train": [batch, batch]}, save_dir=run_dir)
            before = [p.detach().clone() for p in tr.params]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            times, stats = [], []
            for i in range(n_timed):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                stats.append(tr.train_step(batch, tr.step_generator(1, "train", i)))
                end.record()
                times.append(sync_ms(start, end))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
            for i, st in enumerate(stats):
                for key, v in st.items():
                    vals = v.values() if isinstance(v, dict) else [v]
                    if not all(bool(torch.isfinite(torch.as_tensor(a)).all()) for a in vals):
                        fail(f"{preset_name} {name} micro-step {i}: non-finite {key}")
            if tr.optimizer.count != n_timed // iter_size or tr.optimizer.n_skipped:
                fail(f"{preset_name} {name}: Adam's count {tr.optimizer.count} (skipped "
                     f"{tr.optimizer.n_skipped}) after {n_timed} micro-steps at iter_size "
                     f"{iter_size}")
            moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, tr.params))
            if moved < len(tr.params) // 2 or any(p.dtype != torch.float32 for p in tr.params):
                fail(f"{preset_name} {name}: {moved} of {len(tr.params)} float32 parameters moved")
            res[name] = {"ms": statistics.median(times), "all": times, "peak_gib": peak,
                         "counts": counts, "loss": [float(st["loss"]) for st in stats],
                         "moved": moved, "updates": tr.optimizer.count}
        want = dict.fromkeys(counters, 0)
        n16 = len(res["bf16"]["all"])
        want.update({"K1-bf16": k1_per * n16, "K1 bwd-bf16": k1_per * n16, "K2-bf16": 3 * n16})
        if res["bf16"]["counts"] != want:
            fail(f"{preset_name} bf16 micro-steps launched {res['bf16']['counts']}, want {want}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    r16, r32 = res["bf16"], res["f32"]
    log(f"{preset_name} bf16 train: {n16} micro-steps launched {r16['counts']}; Adam's count "
        f"{r16['updates']}, {r16['moved']} float32 parameters moved; loss "
        + ", ".join(f"{x:.4f}" for x in r16["loss"]) + "; float32 loss "
        + ", ".join(f"{x:.4f}" for x in r32["loss"]))
    log(f"{preset_name} train micro-step (B={bsz}, iter_size {iter_size}, CUDA events): bf16 "
        f"median "
        f"{r16['ms']:.3f} ms ({', '.join(f'{t:.3f}' for t in r16['all'])}), peak "
        f"{r16['peak_gib']:.3f} GiB; float32 median {r32['ms']:.3f} ms "
        f"({', '.join(f'{t:.3f}' for t in r32['all'])}), peak {r32['peak_gib']:.3f} GiB; on {smi}")

    # ---- the bf16 gradient against the float32 one -------------------------
    t1 = time.perf_counter()
    models, bt = {}, port.to_device(collate(scenes[:1]))
    for name, cfg in (("bf16", cfg16), ("f32", cfg32)):
        cfg = copy.deepcopy(cfg)
        cfg["pose_estimation"]["deterministic_sampling"] = True
        models[name] = port.build_model(cfg).eval()
        models[name].load_state_dict(state)

    def grads(name, weights):
        mdl = models[name]
        mdl.zero_grad(set_to_none=True)
        st = fuse_loss(mdl(bt, mode="train"), bt, weights, cfg16["capacity"]["max_instances"])
        st["loss"].backward()
        return float(st["loss"].detach()), {
            n: (p.grad if p.grad is not None else torch.zeros_like(p)).float().cpu()
            for n, p in mdl.named_parameters()}

    no_obj = dict(cfg16["loss"], w_obj_loss=0.0)
    la16, ga16 = grads("bf16", no_obj)
    la32, ga32 = grads("f32", no_obj)
    ca, na, wr, wc, wl = bf16_leaf_criterion(ga16, ga32, list(ga32))
    lb16, gb16 = grads("bf16", cfg16["loss"])
    lb32, gb32 = grads("f32", cfg16["loss"])
    _, gb32b = grads("f32", cfg16["loss"])
    pooled = ("motionhead.", "reconstructor.alignment.motion_embed.",
              "reconstructor.alignment.geo_embed.", "reconstructor.alignment.pos_embed.")
    outside = [n for n in gb32 if not n.startswith(pooled)]
    cb, nb_, wrb, wcb, wlb = bf16_leaf_criterion(gb16, gb32, outside)

    def worst_pooled(ga_, gb_):
        return max((float((ga_[n] - gb_[n]).double().norm())
                    / max(float(ga_[n].norm()), float(gb_[n].norm()), 1e-30), n)
                   for n in gb32 if n.startswith(pooled))

    def cosine(ga_, gb_):
        a_, b_ = (torch.cat([g[n].double().ravel() for n in gb32]) for g in (ga_, gb_))
        return float(a_ @ b_ / (a_.norm() * b_.norm()))

    cos_a, cos_b, cos_self = cosine(ga16, ga32), cosine(gb16, gb32), cosine(gb32, gb32b)
    if cos_a <= 0.99 or cos_b <= 0.95:
        fail(f"bf16 vs float32 whole-gradient cosine (a) {cos_a:.6f}, (b) {cos_b:.6f}")
    p16, p32 = worst_pooled(gb16, gb32), worst_pooled(gb32b, gb32)
    log(f"{preset_name} bf16 vs float32 gradient (B=1, eval BN, deterministic keypoints, the same "
        f"weights and batch): (a) without the TPointNet objective: loss {la16:.6f} vs "
        f"{la32:.6f}; {ca} leaves within rel-norm {BF16_LEAF_REL} and cosine {BF16_LEAF_COS}, "
        f"{na} below the noise floor; worst {wl} rel-norm {wr:.3e} cosine {wc:.6f}; whole "
        f"cosine {cos_a:.6f}. (b) whole FuseLoss: loss {lb16:.6f} vs {lb32:.6f}; {cb} leaves "
        f"not upstream of the TPointNet's max pools within it, {nb_} below the floor, worst "
        f"{wlb} rel-norm {wrb:.3e} cosine {wcb:.6f}; whole cosine {cos_b:.6f} (two float32 "
        f"runs: {cos_self:.8f}); the {len(gb32) - len(outside)} pooled leaves: worst rel-norm "
        f"{p16[0]:.3e} ({p16[1]}) bf16 vs float32, {p32[0]:.3e} ({p32[1]}) between two float32 "
        f"runs ({time.perf_counter() - t1:.1f} s)")
    return {"counts": r16["counts"], "bf16_ms": r16["ms"], "f32_ms": r32["ms"],
            "bf16_gib": r16["peak_gib"], "f32_gib": r32["peak_gib"]}


def nuscenes_cli_train_phase(port) -> None:
    """`python -m pcaccumulation_tpu_torch.main configs/nuscene.yaml 4 2
    --misc.mode=train --train.ckpt_backend=pickle --train.max_epoch=2` (one
    epoch: the loop runs epochs 1 .. max_epoch - 1) on the card over 8
    train and 1 val synthetic samples of 11 sweeps at 20 Hz in a temporary
    directory: rc 0, the epoch's checkpoints, and bf16 kernels only (K1-bf16
    forward and gradient, K2-bf16 forward; no float32 kernel, no K2
    gradient)."""
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.synthetic import generate_sample
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift_blocks, row_shift_blocks_backward
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_backward
    from pcaccumulation_tpu_torch.main import main as cli_main

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nuscene_train_")
    cwd = os.getcwd()
    try:
        data = os.path.join(tmp, "data")
        rel = []
        for i in range(9):
            os.makedirs(os.path.join(data, f"scene_{i:04d}"))
            rel.append(f"scene_{i:04d}/sample_00000.npz")
            np.savez_compressed(os.path.join(data, rel[-1]),
                                **generate_sample(SEED + 200 + i, n_frames=11, freq=20.0))
        for split, sel in (("train", rel[:8]), ("val", rel[8:]), ("test", rel[8:])):
            with open(os.path.join(data, f"{split}_info.txt"), "w") as f:
                f.write("\n".join(sel) + "\n")
        os.chdir(tmp)
        for fn in (seg_pool, seg_pool_backward, row_shift_blocks, row_shift_blocks_backward):
            fn.launches = fn.launches_bf16 = 0
        rc = cli_main(["main", os.path.join(repo, "configs", "nuscene.yaml"), "4", "2",
                       "--misc.mode=train", "--train.ckpt_backend=pickle",
                       "--train.max_epoch=2", "--misc.exp_name=nuscene_train",
                       f"--path.dataset_base={data}"])
        torch.cuda.synchronize()
        got = {f"{fn.__name__}{sfx}": getattr(fn, "launches" + sfx)
               for fn in (seg_pool, seg_pool_backward, row_shift_blocks, row_shift_blocks_backward)
               for sfx in ("", "_bf16")}
        k1_per = load_config(os.path.join(repo, "configs", "nuscene.yaml"))["pillar_encoder"][
            "depth"] - 1
        # 2 train micro-steps of B=4 and 1 val step of B=1
        want = {"seg_pool": 0, "seg_pool_bf16": 3 * k1_per, "seg_pool_backward": 0,
                "seg_pool_backward_bf16": 2 * k1_per, "row_shift_blocks": 0,
                "row_shift_blocks_bf16": 9, "row_shift_blocks_backward": 0,
                "row_shift_blocks_backward_bf16": 0}
        run = os.path.join(tmp, "snapshot", "nuscene_train")
        ckpts = sorted(f for f in os.listdir(run) if f.endswith(".ckpt"))
        with open(os.path.join(run, "log")) as f:
            epoch_log = f.read()
        if rc != 0 or got != want or "model_latest.ckpt" not in ckpts or (
                "train Epoch: 1" not in epoch_log):
            fail(f"nuScenes CLI train mode: rc {rc}, launches {got} (want {want}), "
                 f"checkpoints {ckpts}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"nuScenes CLI (configs/nuscene.yaml 4 2 --misc.mode=train --train.ckpt_backend=pickle "
        f"--train.max_epoch=2): one epoch of 2 micro-steps and a val step, checkpoints {ckpts}, "
        f"launches {got} ({time.perf_counter() - t0:.1f} s)")


def init_statistics(model: torch.nn.Module) -> tuple[int, list]:
    """Every leaf of a freshly built model against the distribution
    `utils.weights.init_parameters` draws it from, as
    tests/test_torch_init.py holds the JAX package's and the port's draws:
    constants equal (biases 0, BatchNorm 1 / 0, alpha and beta -5, the zero
    kernels); a drawn kernel of n elements with sample sd within 5 /
    sqrt(2n) of `init_std` (relative), |mean| within 5 sd / sqrt(n), max |w|
    at most the truncation 2 sd / 0.8796. Returns (leaves checked, the
    failures)."""
    from pcaccumulation_tpu_torch.models.layers import MaskedBatchNorm
    from pcaccumulation_tpu_torch.utils.weights import TRUNC_STD, init_std

    bad, n_leaves = [], 0

    def const(name, t, value):
        if not bool((t == value).all()):
            bad.append(f"{name}: not {value}")

    for mname, mod in model.named_modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.modules.conv._ConvNd)):
            sd, w = init_std(mod), mod.weight.detach().double().cpu().ravel()
            if sd == 0.0:
                const(f"{mname}.weight", w, 0.0)
            else:
                n = w.numel()
                if abs(float(w.std(correction=0)) / sd - 1) > 5 / (2 * n) ** 0.5:
                    bad.append(f"{mname}.weight: sd {float(w.std()):.5f} against {sd:.5f}")
                if abs(float(w.mean())) > 5 * sd / n ** 0.5:
                    bad.append(f"{mname}.weight: mean {float(w.mean()):.5f}")
                if float(w.abs().max()) > 2 * sd / TRUNC_STD * (1 + 1e-6):
                    bad.append(f"{mname}.weight: max |w| {float(w.abs().max()):.5f} over the cut")
            if mod.bias is not None:
                const(f"{mname}.bias", mod.bias, 0.0)
        elif isinstance(mod, MaskedBatchNorm):
            for leaf, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                                ("running_var", 1.0)):
                const(f"{mname}.{leaf}", getattr(mod, leaf), value)
        n_leaves += len(list(mod.parameters(recurse=False)))
    const("ego_motion_head.alpha", model.ego_motion_head.alpha, -5.0)
    const("ego_motion_head.beta", model.ego_motion_head.beta, -5.0)
    return n_leaves, bad


def train_from_scratch_phase(port, smi: str) -> dict:
    """Training from scratch as the convergence protocol runs it
    (`tools/port_conv_runs.py`: configs/synthetic.yaml, B=4, iter_size 1,
    seed 42, the tracked data/synthetic_conv), cut to 2 epochs:
    - the model built on the card from `model_generator` (misc.seed 42):
      bit-equal to the CPU build from the same seed, and every leaf's
      statistics as the JAX package's initialisation has them
      (`init_statistics`);
    - the CLI (`--train.max_epoch=3`) in a temporary directory, the kernel
      counts zeroed before and read after: K1 forward (pillar_encoder depth
      - 1 per step) and gradient, K2 3 per step, no bf16 kernel and no K2
      gradient; the epoch-2 train loss below epoch 1's, every val metric
      finite."""
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.main import main as cli_main

    repo = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(repo, "data", "synthetic_conv")
    cfg = load_config(os.path.join(repo, "configs", "synthetic.yaml"), ["--misc.seed=42"])
    t0 = time.perf_counter()
    model = port.build_model(cfg, generator=port.model_generator(cfg))
    cpu = port.build_model(cfg, "cpu", port.model_generator(cfg))
    differ = [k for k, v in cpu.state_dict().items() if not torch.equal(model.state_dict()[k].cpu(), v)]
    n_leaves, bad = init_statistics(model)
    if differ or bad:
        fail(f"train from scratch: the card's initial weights differ from the CPU's at "
             f"{differ[:5]}; leaf statistics: {bad[:10]}")
    log(f"train from scratch: the model built on the card from misc.seed 42, bit-equal to the "
        f"CPU build; {n_leaves} leaves within the JAX package's initial distributions "
        f"({time.perf_counter() - t0:.1f} s)")
    del model, cpu

    def n_lines(split):
        with open(os.path.join(data, f"{split}_info.txt")) as f:
            return sum(1 for line in f if line.strip())

    epochs = 2
    steps = n_lines("train") // 4 + n_lines("val")  # per epoch: train at B=4 (drop_last), val at 1
    k1_per = cfg["pillar_encoder"]["depth"] - 1
    want = {"K1": k1_per * steps * epochs, "K1-bf16": 0, "K2": 3 * steps * epochs, "K2-bf16": 0,
            "K3": 0, "K3-bf16": 0, "K4": 0,
            "K1 bwd": k1_per * (n_lines("train") // 4) * epochs, "K2 bwd": 0}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_from_scratch_")
    cwd = os.getcwd()
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift_blocks_backward
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool_backward

    try:
        os.chdir(tmp)
        zero_kernel_counts()
        seg_pool_backward.launches = row_shift_blocks_backward.launches = 0
        t0 = time.perf_counter()
        rc = cli_main(["main", os.path.join(repo, "configs", "synthetic.yaml"), "4", "1",
                       f"--train.max_epoch={epochs + 1}", "--misc.seed=42",
                       f"--path.dataset_base={data}", "--misc.exp_name=from_scratch"])
        got = dict(kernel_counts(), **{"K1 bwd": seg_pool_backward.launches,
                                       "K2 bwd": row_shift_blocks_backward.launches})
        seconds = time.perf_counter() - t0
        with open(os.path.join(tmp, "snapshot", "from_scratch", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f if line.strip()]
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    train = [r for r in recs if r["phase"] == "epoch_train"]
    val = [r for r in recs if r["phase"] == "epoch_val"]
    if rc != 0 or got != want or len(train) != epochs or len(val) != epochs:
        fail(f"train from scratch: rc {rc}, launches {got} (want {want}), {len(train)} train and "
             f"{len(val)} val epochs")
    if not train[1]["loss"] < train[0]["loss"]:
        fail(f"train from scratch: the epoch-2 train loss {train[1]['loss']} is not below epoch "
             f"1's {train[0]['loss']}")
    nonfinite = [k for r in val for k, v in r.items()
                 if isinstance(v, float) and not np.isfinite(v)]
    if nonfinite:
        fail(f"train from scratch: non-finite val metrics {nonfinite}")
    keys = ("loss", "mos_iou", "fb_iou", "ego_rot_error", "ego_trans_error", "inst_l2_error")
    for name, rs in (("train", train), ("val", val)):
        log(f"train from scratch, {name} by epoch: " + "; ".join(
            ", ".join(f"{k} {r[k]:.4f}" for k in keys) for r in rs))
    log(f"train from scratch (configs/synthetic.yaml 4 1 --misc.seed=42 --train.max_epoch=3, "
        f"data/synthetic_conv): {epochs} epochs in {seconds:.1f} s, launches {got} on {smi}")
    return {"seconds": seconds, "train_loss": [r["loss"] for r in train]}


SERVE_LABELS = ("mos", "fb", "inst_labels", "time_idx", "points")
SERVE_FLOATS = ("rec_points", "flow", "offset", "ego_motion", "transformed_points")


def kernel_counts() -> dict:
    """Every kernel's launch count, per dtype (after a synchronise)."""
    from pcaccumulation_tpu_torch.kernels.chamfer import nn
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift, row_shift_blocks
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool

    torch.cuda.synchronize()
    return {"K1": seg_pool.launches, "K1-bf16": seg_pool.launches_bf16,
            "K2": row_shift_blocks.launches, "K2-bf16": row_shift_blocks.launches_bf16,
            "K3": row_shift.launches, "K3-bf16": row_shift.launches_bf16, "K4": nn.launches}


def zero_kernel_counts() -> None:
    from pcaccumulation_tpu_torch.kernels.chamfer import nn
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift, row_shift_blocks
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool

    seg_pool.launches = seg_pool.launches_bf16 = 0
    row_shift_blocks.launches = row_shift_blocks.launches_bf16 = 0
    row_shift.launches = row_shift.launches_bf16 = nn.launches = 0


def serve_diff(got: dict, want: dict) -> tuple[dict, float]:
    """Between two served outputs: ({key among SERVE_LABELS: elements that
    differ}, only for keys that differ; the largest absolute difference of
    SERVE_FLOATS, inf if a shape differs)."""
    labels = {k: int((got[k] != want[k]).sum()) if got[k].shape == want[k].shape
              else f"shape {got[k].shape} != {want[k].shape}"
              for k in SERVE_LABELS if not np.array_equal(got[k], want[k])}
    floats = max(float(np.abs(got[k] - want[k]).max(initial=0.0))
                 if got[k].shape == want[k].shape else float("inf") for k in SERVE_FLOATS)
    return labels, floats


def output_spread(a: dict, b: dict) -> dict:
    """{key: (elements that differ, largest absolute difference)} between two
    forwards' tensor outputs, for the keys that differ."""
    out = {}
    for k, x in a.items():
        if torch.is_tensor(x) and not torch.equal(x, b[k]):
            d = (x.double() - b[k].double()).abs()
            out[k] = (int((d > 0).sum()), float(d.max()))
    return out


def first_come_voxelize(points, time_idx, voxel, pc_range, n_sweeps: int, max_pillars: int):
    """The native voxeliser's semantics in numpy (the reference of
    `host_prep_phase`): the JAX package's numpy voxeliser with pillar ids
    ranked by the index of each pillar's first point instead of by key,
    and `in_range` the points that got a pillar."""
    pc = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel, np.float32)
    nx, ny, nz = np.round((pc[3:] - pc[:3]) / vs).astype(np.int64)
    c = np.floor((points - pc[:3]) / vs).astype(np.int64)
    t = np.asarray(time_idx, np.int64)
    ok = ((c[:, 0] >= 0) & (c[:, 0] < nx) & (c[:, 1] >= 0) & (c[:, 1] < ny)
          & (c[:, 2] >= 0) & (c[:, 2] < nz) & (t >= 0) & (t < n_sweeps))
    key = (t * ny + c[:, 1]) * nx + c[:, 0]
    uniq, first, inverse = np.unique(key[ok], return_index=True, return_inverse=True)
    by_arrival = np.argsort(first)
    rank = np.empty_like(by_arrival)
    rank[by_arrival] = np.arange(len(uniq))
    p2v = np.full(len(points), max_pillars, np.int32)
    p2v[ok] = np.minimum(rank[inverse.ravel()], max_pillars)
    m = min(len(uniq), max_pillars)
    kept = uniq[by_arrival[:m]]
    coords = np.zeros((max_pillars, 3), np.int32)
    coords[:m] = np.stack([kept // (nx * ny), (kept // nx) % ny, kept % nx], 1)
    valid = np.zeros(max_pillars, bool)
    valid[:m] = True
    return coords, valid, p2v, p2v < max_pillars


PREP_STAGES = ("crop_ground", "voxelise", "sort", "gather", "pad")


def host_prep_phase(smi: str) -> dict:
    """The native host library on the card's host, at the default and the
    nuScenes smoke scans (`default_samples`, 3 each):
    - `native_voxelize` on scan 0's raw points (out-of-range ones
      included) `np.array_equal` to `first_come_voxelize`, at as many
      pillars as the scan has and at half of them (overflow);
    - `native_sort_by_key` of those ids equal to the stable argsort of the
      ids clamped into [0, max_pillars];
    - `prep_sample` (labels on, as training prepares) per stage, median ms
      of 10 calls over the 3 scans, on the native path and under
      `PCACC_NATIVE=0`, in that order, in one process; both give sorted
      ids and as many valid points.
    Returns {config: {path: {stage: ms}}}."""
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data import voxelizer
    from pcaccumulation_tpu_torch.data.dataset import prep_sample
    from pcaccumulation_tpu_torch.native.host import native_sort_by_key, native_voxelize
    from pcaccumulation_tpu_torch.profile_forward import default_samples

    out = {}
    saved = voxelizer._USE_NATIVE
    for name, path in (("default", None), ("nuscenes", "configs/nuscene.yaml")):
        cfg = load_config(path)
        vg = cfg["voxel_generator"]
        raws = default_samples(cfg, 3)
        pts, tid = raws[0]["raw_points"], raws[0]["time_indice"]
        grid = (vg["voxel_size"], vg["range"], vg["n_sweeps"])
        n_distinct = int(first_come_voxelize(pts, tid, *grid, len(pts))[1].sum())
        checks = []
        for cap in (n_distinct, n_distinct // 2):  # every pillar placed; overflow
            got = native_voxelize(pts, tid, *grid, cap)
            want = first_come_voxelize(pts, tid, *grid, cap)
            bad = [k for k, g, w in zip(("coords", "valid", "pillar_of_point", "in_range"),
                                        got, want)
                   if g.dtype != w.dtype or not np.array_equal(g, w)]
            if bad:
                fail(f"host prep {name}: native_voxelize at max_pillars {cap} differs from the "
                     f"first-come reference in {bad}")
            order = native_sort_by_key(got[2], cap)
            if not np.array_equal(order, np.argsort(np.clip(got[2], 0, cap), kind="stable")):
                fail(f"host prep {name}: native_sort_by_key at {cap} buckets differs from the "
                     f"stable argsort")
            checks.append(f"max_pillars {cap}: {int(got[1].sum())} pillars, "
                          f"{int(got[3].sum())} of {len(pts)} points placed")
        out[name], valid = {}, {}
        try:
            for prep_path in ("native", "numpy"):
                voxelizer._USE_NATIVE = prep_path == "native"
                rows = {k: [] for k in (*PREP_STAGES, "total")}
                for i in range(11):
                    st = {}
                    sample = prep_sample(raws[i % 3], cfg, stage_ms=st)
                    if i:  # the first call warms up
                        for k in PREP_STAGES:
                            rows[k].append(st[k])
                        rows["total"].append(sum(st.values()))
                if (np.diff(sample["pillar_of_point"]) < 0).any():
                    fail(f"host prep {name} ({prep_path}): pillar ids not sorted")
                valid[prep_path] = int(sample["point_valid"].sum())
                out[name][prep_path] = {k: statistics.median(v) for k, v in rows.items()}
        finally:
            voxelizer._USE_NATIVE = saved
        if valid["native"] != valid["numpy"]:
            fail(f"host prep {name}: valid points native {valid['native']} against numpy "
                 f"{valid['numpy']}")
        log(f"host prep {name} ({len(pts)} raw points, {n_distinct} distinct pillars): "
            f"native_voxelize equal to the first-come reference and native_sort_by_key to the "
            f"stable argsort at " + "; ".join(checks) + f"; prep_sample median ms of 10 "
            f"(native | PCACC_NATIVE=0): " + ", ".join(
                f"{k} {out[name]['native'][k]:.3f} | {out[name]['numpy'][k]:.3f}"
                for k in (*PREP_STAGES, "total")) + f" on the host of {smi}")
    return out


def serving_phase(port, name: str, cfg: dict, state: dict, n_scans: int, smi: str,
                  export: bool, host_split: bool = False) -> dict:
    """The serving path on one config, on the card (`serve.py`): a
    Predictor on `state`, the random keypoint draw of its seed:
    - `predict` on the first scan against a direct `MotionNet(mode="test")`
      call on the same device batch and scores (the labels equal, the
      floats within 1e-5), counts zeroed before `predict` and read after;
    - `predict` timed on the host clock (raw scan to numpy result) and the
      step alone on CUDA events; `predict` over `n_scans` scans back to back
      (serial) and `predict_stream` over them (streamed), in sequences per
      second, the stream held against the serial results;
    - with `host_split`: the host side of one predict by stage, median ms
      of 10 (`serve_host_split`), on the native preparation path and under
      `PCACC_NATIVE=0`; then serial and streamed predicts on numpy's path
      in this process, the stream held against the serial results;
    - with `export`: `export` on the card, `ExportedPredictor` on the
      artifact: labels equal to the live Predictor's, floats within 1e-5,
      the same launch counts;
    - the tracker over the streamed outputs.
    Returns the phase's numbers."""
    from pcaccumulation_tpu_torch.data import voxelizer
    from pcaccumulation_tpu_torch.profile_forward import (
        default_samples,
        print_host_split,
        serve_host_split,
    )
    from pcaccumulation_tpu_torch.serve import ExportedPredictor, Predictor
    from pcaccumulation_tpu_torch.track import ClusterTracker, centroids_from_labels

    t0 = time.perf_counter()
    scans = [(s["raw_points"], s["time_indice"])
             for s in default_samples(cfg, n_scans, first=SEED + 300)]
    pred = Predictor(cfg, state_dict=state)
    k1_per = cfg["pillar_encoder"]["depth"] - 1
    bf16 = cfg.get("precision", {}).get("compute_dtype") == "bfloat16"
    want_counts = {k: 0 for k in kernel_counts()}
    want_counts["K1-bf16" if bf16 else "K1"] = k1_per
    want_counts["K2-bf16" if bf16 else "K2"] = 3
    # K4 once per ICP iteration: ego, then instance
    want_counts["K4"] = sum(cfg[k]["icp_max_iter"] for k in ("pose_estimation", "tpointnet")
                            if cfg[k].get("icp", False))
    problems = []

    # ---- predict against the direct test-mode forward, launches counted ----
    pred.predict(*scans[0])  # warm-up
    zero_kernel_counts()
    first = pred.predict(*scans[0])
    counts = kernel_counts()
    if counts != want_counts:
        problems.append(f"predict launched {counts}, want {want_counts}")
    batch = pred._prep(*scans[0])
    dbatch = pred._to_device(batch)
    h2d_bytes = pred.h2d_bytes
    with torch.inference_mode():
        r = pred.model(dbatch, mode="test", kpt_scores=pred._scores)
        spread = output_spread(r, pred.model(dbatch, mode="test", kpt_scores=pred._scores))
    if spread:
        problems.append(f"two direct forwards on one batch differ: {spread}")
    valid = batch["point_valid"][0]
    direct = {
        "rec_points": r["rec_est"][0].cpu().numpy()[valid],
        "offset": r["offset_est"][0].cpu().numpy()[valid],
        "ego_motion": r["ego_motion_est"][0].cpu().numpy(),
        "mos": torch.argmax(r["mos_est"], -1)[0].cpu().numpy()[valid].astype(np.int32),
        "fb": r["fb_est_per_points"][0].cpu().numpy()[valid].astype(np.int32),
        "inst_labels": r["inst_labels_est"][0].cpu().numpy()[valid].astype(np.int32),
        "time_idx": batch["time_idx"][0][valid], "points": batch["points"][0][valid],
    }
    direct["flow"] = direct["rec_points"] - direct["points"]
    # the host rebuilds transformed_points from points and ego_motion; held
    # against the forward's own at float32 rounding of coordinates <= 50 m
    d_tp = float(np.abs(first["transformed_points"]
                        - r["transformed_points"][0].cpu().numpy()[valid]).max())
    direct["transformed_points"] = first["transformed_points"]
    labels, d_direct = serve_diff(first, direct)
    if labels or d_direct > 1e-5 or d_tp > 1e-4:
        problems.append(f"predict vs the direct forward: labels differ {labels}, floats "
                        f"{d_direct:.3e} (tol 1e-5), transformed_points rebuilt on the host "
                        f"{d_tp:.3e} (tol 1e-4)")
    n_inst = len(np.unique(first["inst_labels"])) - 1

    # ---- timing: predict on the host clock, the step on CUDA events ----
    host_ms, dev_ms = [], []
    for i in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred.predict(*scans[i % n_scans])
        host_ms.append((time.perf_counter() - t1) * 1e3)
    with torch.inference_mode():
        for i in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            pred._run_step(dbatch)
            end.record()
            dev_ms.append(sync_ms(start, end))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    serial = [pred.predict(*s) for s in scans]
    serial_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    streamed = list(pred.predict_stream(iter(scans), prefetch=2, depth=2))
    stream_s = time.perf_counter() - t1
    if len(streamed) != n_scans:
        problems.append(f"predict_stream gave {len(streamed)} results for {n_scans} scans")
    d_stream = 0.0
    for i, (a, b) in enumerate(zip(streamed, serial)):
        labels, d = serve_diff(a, b)
        d_stream = max(d_stream, d)
        if labels or d > 1e-5:
            problems.append(f"predict_stream item {i} vs predict: labels differ {labels}, "
                            f"floats {d:.3e}")

    # ---- the host split by stage; numpy's preparation path beside native ----
    res = {}
    if host_split:
        split = serve_host_split(pred, scans, 10)
        print_host_split(split, f"serving {name} on {smi}", 10)
        saved = voxelizer._USE_NATIVE
        voxelizer._USE_NATIVE = False
        try:
            t1 = time.perf_counter()
            serial_np = [pred.predict(*s) for s in scans]
            serial_np_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            streamed_np = list(pred.predict_stream(iter(scans), prefetch=2, depth=2))
            stream_np_s = time.perf_counter() - t1
        finally:
            voxelizer._USE_NATIVE = saved
        for i, (a, b) in enumerate(zip(streamed_np, serial_np)):
            labels, d = serve_diff(a, b)
            if labels or d > 1e-5:
                problems.append(f"numpy path: predict_stream item {i} vs predict: labels "
                                f"differ {labels}, floats {d:.3e}")
        if len(streamed_np) != n_scans:
            problems.append(f"numpy path: predict_stream gave {len(streamed_np)} results")
        for path in ("native", "numpy"):
            row = split[path]
            res[f"host_ms_{path}"] = row["host"]
            res[f"split_predict_ms_{path}"] = row["predict"]
        res["serial_seq_s_numpy"] = n_scans / serial_np_s
        res["stream_seq_s_numpy"] = n_scans / stream_np_s
        log(f"serving {name}, numpy's preparation path (PCACC_NATIVE=0) in this process: "
            f"predict median {split['numpy']['predict']:.3f} ms against native "
            f"{split['native']['predict']:.3f}; host side (every stage but the step) "
            f"{res['host_ms_numpy']:.3f} against {res['host_ms_native']:.3f} ms; serial "
            f"{res['serial_seq_s_numpy']:.3f} sequences/s, predict_stream (depth 2) "
            f"{res['stream_seq_s_numpy']:.3f}; on {smi}")

    # ---- export on the card, the artifact served ----
    if export:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
        try:
            t1 = time.perf_counter()
            path = os.path.join(tmp, f"{name}.pt2")
            pred.export(path)
            export_s = time.perf_counter() - t1
            served = ExportedPredictor(path)
            size_mib = os.path.getsize(path) / 2 ** 20
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        served.predict(*scans[0])  # warm-up
        zero_kernel_counts()
        got = served.predict(*scans[0])
        x_counts = kernel_counts()
        if x_counts != want_counts:
            problems.append(f"the exported program launched {x_counts}, want {want_counts}")
        labels, d_export = serve_diff(got, first)
        if labels or d_export > 1e-5:
            problems.append(f"ExportedPredictor vs Predictor: labels differ {labels}, floats "
                            f"{d_export:.3e} (tol 1e-5)")
        x_ms = []
        for i in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            served.predict(*scans[i % n_scans])
            x_ms.append((time.perf_counter() - t1) * 1e3)
        res["exported_predict_ms"] = statistics.median(x_ms)
        x_note = (f"export {export_s:.1f} s, artifact {size_mib:.1f} MiB; the exported program "
                  f"launched {x_counts}; exported vs live {d_export:.3e}; exported predict "
                  f"(host clock) {', '.join(f'{t:.3f}' for t in x_ms)} ms")
    else:
        x_note = "not exported"

    # ---- the tracker over the streamed outputs ----
    tracker = ClusterTracker()
    t_frames = pred.n_frames
    for out in streamed:
        obs, infos = centroids_from_labels(out["points"], out["time_idx"], out["inst_labels"],
                                           t_frames)
        for t in range(t_frames):
            tracker.update(obs[t], infos[t])
    tracks = tracker.flush()
    n_conf = sum(t["confirmed"] for t in tracks)

    res.update({
        "predict_ms": statistics.median(host_ms), "step_ms": statistics.median(dev_ms),
        "serial_seq_s": n_scans / serial_s, "stream_seq_s": n_scans / stream_s,
        "h2d_bytes": h2d_bytes,
    })
    log(f"serving {name}: {n_scans} scans of {[int(len(s[0])) for s in scans]} raw points; "
        f"predict launched {counts} (want {want_counts}); instances in scan 0: {n_inst}; "
        f"predict vs direct forward: floats max abs diff {d_direct:.3e}, transformed_points "
        f"rebuilt on the host {d_tp:.3e}; stream vs serial {d_stream:.3e}; "
        f"predict (host clock, raw scan to numpy) median {res['predict_ms']:.3f} ms "
        f"({', '.join(f'{t:.3f}' for t in host_ms)}); step (CUDA events) median "
        f"{res['step_ms']:.3f} ms ({', '.join(f'{t:.3f}' for t in dev_ms)}); serial "
        f"{res['serial_seq_s']:.3f} sequences/s, predict_stream (depth 2) "
        f"{res['stream_seq_s']:.3f} sequences/s; H2D {h2d_bytes} bytes per predict; {x_note}; "
        f"tracker over the stream: {len(tracks)} tracks, "
        f"{n_conf} confirmed; on {smi} ({time.perf_counter() - t0:.1f} s)")
    if problems:
        fail(f"serving {name}: " + "; ".join(problems))
    return res


# the val forward, card against CPU: float32 throughout, TF32 off; the card's
# convolutions and reductions round in another order than the CPU's
VAL_TOL = {"fb_seg_est": 1e-3, "ego_motion_est": 1e-3, "transformed_points": 1e-2,
           "mos_est": 1e-2, "offset_est": 1e-2, "rec_est": 1e-2}


def forward_ms(model, batches: list, reps: int, mode: str = "val") -> tuple[float, list]:
    """Median and all CUDA-event times of `reps` forwards over `batches`,
    after one warm-up."""
    with torch.no_grad():
        model(batches[0], mode=mode)
        times = []
        for i in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            model(batches[i % len(batches)], mode=mode)
            end.record()
            times.append(sync_ms(start, end))
    return statistics.median(times), times


def card_vs_cpu(what: str, port, cfg: dict, model, batch_gpu: dict, scene: dict,
                gpu_out: dict) -> dict:
    """A val forward on the card against the same model's on the CPU (same
    weights and batch): `VAL_TOL` per output, MOS and offsets on the rows
    whose FB decision agrees, at most 1 in 1,000 pillar FB decisions
    flipped; every frame 1..T-1 of the card's ego estimate at least 1e-4
    from the identity (the poses compared are real ones). Returns the
    errors."""
    from pcaccumulation_tpu_torch.data.loader import collate

    cpu_model = port.build_model(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        cpu = cpu_model(port.to_device(collate([scene]), "cpu"))
    gpu = {k: v.cpu() for k, v in gpu_out.items() if torch.is_tensor(v)}
    pv = batch_gpu["pillar_valid"].cpu()
    logits = gpu["fb_logit_pillar"]
    margin = float((logits[..., 1] - logits[..., 0]).abs()[pv].min())
    errs = val_against(f"{what} GPU vs CPU", gpu, cpu, pv)
    errs["fb_margin"] = margin
    # the ego poses compared must be real ones
    from_id = float((gpu["ego_motion_est"][:, 1:] - torch.eye(4)).abs().amax((-1, -2)).min())
    if from_id < 1e-4:
        fail(f"{what}: an ego pose of frames 1..T-1 within 1e-4 of the identity; the comparison "
             f"tests nothing")
    errs["ego_from_identity"] = from_id
    return errs


def options_phase(port, cfg: dict, weights: dict, batches: list, scenes: list, skip_ms: float,
                  smi: str) -> dict:
    """The options of this slice on the default config at full width (T=5,
    288x288, 90,000 points, float32, deterministic keypoints, the main
    path's calibrated weights): the val forward with `seq_pose: chain`
    (pairs (t, t-1), poses left-composed), `seq_pose: full` (10 pairs, the
    anchor pairs' poses) and `stpn.n_band_layers: 2` (two Conv3d, two
    `post_conv` Conv2d after the temporal max, seeded), each over the
    scenes with the kernels' counts zeroed before and read after (K1 2 and
    K2 3 per forward), held against its CPU forward (`card_vs_cpu`) and
    timed beside the main path's `skip` forward. Returns the times."""
    import copy

    from pcaccumulation_tpu_torch.utils.checkpoint import partial_load

    out = {}
    n_fwd = len(batches)
    for name, section, key, value in (("chain", "pose_estimation", "seq_pose", "chain"),
                                      ("full", "pose_estimation", "seq_pose", "full"),
                                      ("band2", "stpn", "n_band_layers", 2)):
        t0 = time.perf_counter()
        cfg_v = copy.deepcopy(cfg)
        cfg_v[section][key] = value
        torch.manual_seed(SEED)
        model = port.build_model(cfg_v)
        model.load_state_dict(partial_load(weights, model.state_dict()))
        zero_kernel_counts()
        with torch.no_grad():
            outs = [model(bt) for bt in batches]
        counts = kernel_counts()
        want = dict.fromkeys(counts, 0)
        want.update({"K1": 2 * n_fwd, "K2": 3 * n_fwd})
        if counts != want:
            fail(f"option {key}={value!r}: {n_fwd} val forwards launched {counts}, want {want}")
        for i, o in enumerate(outs):
            for k, v in o.items():
                if torch.is_tensor(v) and v.is_floating_point() and not bool(
                        torch.isfinite(v).all()):
                    fail(f"option {key}={value!r}, scene {i}: non-finite {k}")
        pairs = outs[0]["perm_matrix"].shape[1]
        errs = card_vs_cpu(f"option {key}={value!r}", port, cfg_v, model, batches[0], scenes[0],
                           outs[0])
        ms, times = forward_ms(model, batches, 5)
        out[name] = ms
        log(f"option {key}={value!r} (default config, full width): {n_fwd} val forwards launched "
            f"{counts}; perm_matrix {pairs} pairs; GPU vs CPU "
            + ", ".join(f"{k} {errs[k]:.2e}" for k in VAL_TOL)
            + f", FB decisions flipped {errs['fb_flips']}, ego poses at least "
            f"{errs['ego_from_identity']:.4f} from the identity"
            + f"; val forward median {ms:.3f} ms ({', '.join(f'{t:.3f}' for t in times)}) "
            f"against skip/4 {skip_ms:.3f} ms on {smi} ({time.perf_counter() - t0:.1f} s)")
    return out


def nuscenes_full_phase(port, state: dict, skip_ms: float, smi: str) -> dict:
    """The nuScenes preset's bf16 val forward with `seq_pose: full` (55
    pairs at T=11), on the nuScenes phase's weights and a scene of its:
    counts zeroed before and read after (K1-bf16 2, K2-bf16 3, nothing
    else), held against the float32 forward with `full` by `bf16_vs_f32`,
    timed beside it and beside the bf16 `skip` forward. Returns the times."""
    import copy

    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.profile_forward import default_scenes

    t0 = time.perf_counter()
    cfg16 = load_config("configs/nuscene.yaml", ["--misc.mode=val", "--train.ckpt_backend=pickle",
                                                 "--pose_estimation.seq_pose=full"])
    cfg16["pose_estimation"]["deterministic_sampling"] = True
    cfg32 = copy.deepcopy(cfg16)
    cfg32["precision"]["compute_dtype"] = "float32"
    batches = [port.to_device(collate([s])) for s in default_scenes(cfg16, 1)]
    models = {}
    for name, cfg in (("bf16", cfg16), ("f32", cfg32)):
        models[name] = port.build_model(cfg)
        models[name].load_state_dict(state)
    zero_kernel_counts()
    with torch.no_grad():
        o16 = models["bf16"](batches[0])
    counts = kernel_counts()
    want = dict.fromkeys(counts, 0)
    want.update({"K1-bf16": cfg16["pillar_encoder"]["depth"] - 1, "K2-bf16": 3})
    if counts != want:
        fail(f"nuScenes bf16 val forward with seq_pose=full launched {counts}, want {want}")
    pairs = o16["perm_matrix"].shape[1]
    t_frames = cfg16["voxel_generator"]["n_sweeps"]
    if models["bf16"].ego_motion_head.src_f.numel() != t_frames * (t_frames - 1) // 2 or (
            pairs != t_frames - 1):
        fail(f"nuScenes seq_pose=full: {models['bf16'].ego_motion_head.src_f.numel()} pairs, "
             f"perm_matrix {pairs}")
    with torch.no_grad():
        o32 = models["f32"](batches[0])
    m = bf16_vs_f32("nuScenes val bf16 vs float32, seq_pose=full", o16, o32, batches[0], 1.0)
    res = {"bf16": forward_ms(models["bf16"], batches, 5), "f32": forward_ms(models["f32"],
                                                                            batches, 3)}
    log(f"nuScenes bf16 val forward, seq_pose=full ({t_frames * (t_frames - 1) // 2} pairs, "
        f"{pairs} anchor pairs' perm matrices): launched {counts}; against the float32 forward "
        f"with full: {m}; median bf16 {res['bf16'][0]:.3f} ms "
        f"({', '.join(f'{t:.3f}' for t in res['bf16'][1])}), float32 {res['f32'][0]:.3f} ms, "
        f"bf16 skip/10 {skip_ms:.3f} ms on {smi} ({time.perf_counter() - t0:.1f} s)")
    return {k: v[0] for k, v in res.items()}


def remat_phase(port, state: dict, smi: str) -> dict:
    """`train.remat` on the nuScenes bf16 train micro-step (B=4, iter_size
    2, train-mode BN, the random keypoint draw): from the same weights
    (`state`), batch and generator seed, one plain micro-step and one remat
    micro-step (the Trainer's step runs under
    `torch.use_deterministic_algorithms`): every gradient leaf and every
    running statistic of the remat step equal to the plain step's, bit for
    bit, and a second plain step's too. Then both timed (warm-up, 3
    micro-steps each, order plain, remat, remat, plain) with their peak
    memory. Returns the measures."""
    import copy
    import warnings

    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.profile_forward import default_scenes
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = load_config("configs/nuscene.yaml", ["--misc.mode=train", "--train.ckpt_backend=pickle"])
    cfg_r = copy.deepcopy(cfg)
    cfg_r["train"]["remat"] = True
    batch = port.to_device(collate(default_scenes(cfg, cfg["train"]["batch_size"])))
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_remat_")
    try:
        def step(c):
            model = port.build_model(c)
            model.load_state_dict(state)
            calls = []  # Conv2d forwards: the recompute runs them again
            for mod in model.modules():
                if isinstance(mod, torch.nn.Conv2d):
                    mod.register_forward_hook(lambda *_: calls.append(1))
            tr = Trainer(c, model, {"train": [batch, batch]}, save_dir=run_dir)
            st = tr.train_step(batch, tr.step_generator(1, "train", 0))
            torch.cuda.synchronize()
            return (float(st["loss"]), len(calls),
                    {n: p.grad.detach().clone() for n, p in model.named_parameters()
                     if p.grad is not None},
                    {n: b.clone() for n, b in model.named_buffers()
                     if n.endswith(("running_mean", "running_var", "num_batches_tracked"))})

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # ops without a deterministic form warn
                (l0, c0, g0, b0), (l1, c1, g1, b1), (l2, _, g2, b2) = (step(cfg), step(cfg_r),
                                                                       step(cfg))
        finally:
            torch.use_deterministic_algorithms(False)
        if c0 == 0 or c1 != 2 * c0:
            fail(f"remat: the remat step ran {c1} Conv2d forwards, the plain one {c0} (want "
                 f"twice as many: the recompute)")
        if sorted(g0) != sorted(g1) or sorted(g0) != sorted(g2):
            fail("remat: the steps' gradient leaves differ")
        for name, g, b in (("remat", g1, b1), ("second plain", g2, b2)):
            diff = [n for n in g0 if not torch.equal(g[n], g0[n])]
            diff_b = [n for n in b0 if not torch.equal(b[n], b0[n])]
            if diff or diff_b:
                worst = max((float((g[n] - g0[n]).double().norm())
                             / max(float(g0[n].double().norm()), 1e-30), n) for n in diff) \
                    if diff else None
                fail(f"remat: the {name} step's gradients differ from the plain step's at "
                     f"{len(diff)} leaves (worst rel-norm {worst}), running statistics at "
                     f"{diff_b}")
        log(f"remat (nuScenes bf16 micro-step, B={cfg['train']['batch_size']}, the same weights, "
            f"batch and generator seed, deterministic algorithms): Conv2d forwards plain {c0}, "
            f"remat {c1}; loss plain {l0:.6f}, remat {l1:.6f}, plain again {l2:.6f}; all "
            f"{len(g0)} gradient leaves and {len(b0)} "
            f"running statistics of the remat step bit-equal to the plain step's")

        res = {}
        for name, c in (("plain", cfg), ("remat", cfg_r), ("remat_2", cfg_r), ("plain_2", cfg)):
            model = port.build_model(c)
            model.load_state_dict(state)
            tr = Trainer(c, model, {"train": [batch, batch]}, save_dir=run_dir)
            tr.train_step(batch, tr.step_generator(0, "train", 0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                tr.train_step(batch, tr.step_generator(1, "train", i))
                end.record()
                times.append(sync_ms(start, end))
            res[name] = (statistics.median(times), times,
                         torch.cuda.max_memory_allocated() / 2 ** 30)
            del model, tr
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    log("remat timing (nuScenes bf16 micro-step, CUDA events, median ms, all, peak GiB): "
        + "; ".join(f"{k} {v[0]:.3f} ({', '.join(f'{t:.3f}' for t in v[1])}) {v[2]:.3f} GiB"
                    for k, v in res.items()) + f" on {smi} ({time.perf_counter() - t0:.1f} s)")
    return {"plain_ms": statistics.median([res["plain"][0], res["plain_2"][0]]),
            "remat_ms": statistics.median([res["remat"][0], res["remat_2"][0]]),
            "plain_gib": res["plain"][2], "remat_gib": res["remat"][2]}


NOISE_NORM = 1e-3  # tests/test_parallel.py: a leaf whose larger norm is under it is noise


def _step_grads(port, cfg: dict, state: dict, batch: dict, run_dir: str) -> tuple:
    """One `Trainer.train_step` from `state` on `batch` (generator seed
    (1, train, 0)): (loss, gradient leaves, running statistics)."""
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    model = port.build_model(cfg)
    model.load_state_dict(state)
    tr = Trainer(cfg, model, {"train": [batch, batch]}, save_dir=run_dir)
    st = tr.train_step(batch, tr.step_generator(1, "train", 0))
    torch.cuda.synchronize()
    return (float(st["loss"]),
            {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: b.clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var", "num_batches_tracked"))})


def noise_split(g0: dict, g1: dict) -> tuple:
    """Two steps' gradients: (noise leaves, bit-equal leaves among the
    others, the others, worst rel-norm among the others and its leaf). A
    noise leaf's larger norm is under NOISE_NORM (a bias before a train-mode
    BatchNorm: zero in exact arithmetic, what the card computes there is
    cancellation residue)."""
    noise = [n for n in g0 if max(float(g0[n].norm()), float(g1[n].norm())) < NOISE_NORM]
    rest = [n for n in g0 if n not in noise]
    same = sum(torch.equal(g0[n], g1[n]) for n in rest)
    worst = max(((float((g0[n] - g1[n]).double().norm())
                  / max(float(g0[n].double().norm()), float(g1[n].double().norm()), 1e-30), n)
                 for n in rest), default=(0.0, ""))
    return len(noise), same, len(rest), worst


def determinism_phase(port, nus_state: dict, smi: str) -> dict:
    """The Trainer's step is reproducible on the card: for the default
    config (float32, flax's seeded init) and the nuScenes preset (bf16, the
    nuScenes phase's weights), B=4, train-mode BN, the random keypoint
    draw:
    - the ops torch warns about under `use_deterministic_algorithms(True,
      warn_only=True)` in one micro-step's forward, FuseLoss and backward
      (none expected: the Trainer runs them under the strict flag);
    - two `Trainer.train_step`s from the same weights on the same batch:
      every gradient leaf and running statistic bit-equal;
    - two steps with torch's default algorithms (the Trainer's context
      replaced by a null one): the leaves split by `noise_split`;
    - the step's ms with and without deterministic algorithms (order det,
      default, default, det; 3 timed steps each after a warm-up; medians
      of CUDA events). Returns the ms."""
    import contextlib
    import warnings

    import pcaccumulation_tpu_torch.train.trainer as trainer_mod
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.profile_forward import default_scenes
    from pcaccumulation_tpu_torch.train.loss import fuse_loss
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_det_")
    res = {}
    strict = trainer_mod.deterministic_algorithms
    try:
        for name, path in (("default_f32", None), ("nuscenes_bf16", "configs/nuscene.yaml")):
            cfg = load_config(path, ["--misc.mode=train"])
            if path is None:
                model = port.build_model(cfg, generator=torch.Generator().manual_seed(SEED))
                state = {k: v.clone() for k, v in model.state_dict().items()}
            else:
                state = nus_state
            batch = port.to_device(collate(default_scenes(cfg, cfg["train"]["batch_size"])))

            # the census: one micro-step's ops under the warning form of the flag
            model = port.build_model(cfg).train()
            model.load_state_dict(state)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    gen = torch.Generator(device="cuda").manual_seed(SEED)
                    fuse_loss(model(batch, mode="train", generator=gen), batch, cfg["loss"],
                              cfg["capacity"]["max_instances"])["loss"].backward()
                    torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
            warned = sorted({str(w.message).splitlines()[0][:160] for w in caught
                             if "deterministic" in str(w.message)})
            del model

            l0, g0, b0 = _step_grads(port, cfg, state, batch, run_dir)
            l1, g1, b1 = _step_grads(port, cfg, state, batch, run_dir)
            diff = [n for n in g0 if not torch.equal(g0[n], g1[n])]
            diff_b = [n for n in b0 if not torch.equal(b0[n], b1[n])]
            if warned or diff or diff_b or l0 != l1:
                fail(f"{name}: the Trainer's step is not reproducible: ops warned {warned}, "
                     f"losses {l0} / {l1}, {len(diff)} gradient leaves differ ({diff[:4]}), "
                     f"running statistics {diff_b[:4]}")
            trainer_mod.deterministic_algorithms = contextlib.nullcontext
            try:
                _, d0, _ = _step_grads(port, cfg, state, batch, run_dir)
                _, d1, _ = _step_grads(port, cfg, state, batch, run_dir)
            finally:
                trainer_mod.deterministic_algorithms = strict
            n_noise, same, n_rest, worst = noise_split(d0, d1)

            model = port.build_model(cfg)
            model.load_state_dict(state)
            tr = Trainer(cfg, model, {"train": [batch, batch]}, save_dir=run_dir)
            times = {"det": [], "default": []}
            for mode in ("det", "default", "default", "det"):
                trainer_mod.deterministic_algorithms = (strict if mode == "det"
                                                        else contextlib.nullcontext)
                try:
                    tr.train_step(batch, tr.step_generator(0, "train", 0))
                    for i in range(3):
                        start, end = (torch.cuda.Event(enable_timing=True),
                                      torch.cuda.Event(enable_timing=True))
                        torch.cuda.synchronize()
                        start.record()
                        tr.train_step(batch, tr.step_generator(1, "train", i))
                        end.record()
                        times[mode].append(sync_ms(start, end))
                finally:
                    trainer_mod.deterministic_algorithms = strict
            del model, tr
            det_ms, def_ms = (statistics.median(times[k]) for k in ("det", "default"))
            res[f"{name}_det_ms"], res[f"{name}_default_ms"] = det_ms, def_ms
            log(f"determinism ({name}, B={cfg['train']['batch_size']}, train-mode BN, random "
                f"draw): ops warned under warn_only: {len(warned)}; two Trainer steps: loss "
                f"{l0:.6f} twice, all {len(g0)} gradient leaves and {len(b0)} running "
                f"statistics bit-equal. Default algorithms: {n_noise} leaves under the noise "
                f"norm {NOISE_NORM:g}; of the other {n_rest}, {same} bit-equal, worst rel-norm "
                f"{worst[0]:.3e} ({worst[1]}). Step ms (CUDA events, medians of 6): "
                f"deterministic {det_ms:.3f} ({', '.join(f'{t:.3f}' for t in times['det'])}), "
                f"default {def_ms:.3f} ({', '.join(f'{t:.3f}' for t in times['default'])}), "
                f"cost {100 * (det_ms / def_ms - 1):+.1f} % on {smi}")
    finally:
        trainer_mod.deterministic_algorithms = strict
        shutil.rmtree(run_dir, ignore_errors=True)
    log(f"determinism phase: {time.perf_counter() - t0:.1f} s")
    return res


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ddp_world1_phase(port, nus_state: dict, smi: str) -> dict:
    """Part of the data-parallel path on the card: an in-process NCCL group
    of world 1 (`parallel.mesh.init_distributed`), the nuScenes bf16
    micro-step (B=4, iter_size 2, the random draw) through the Trainer in
    the group, with and without `parallel.zero1`, against the plain
    deterministic step (no group) from the same weights on the same batches:
    the reduced gradient of the first micro-step, the running statistics
    and the parameters after one update bit-equal; K1 and K2 launches on
    the group's path (counts zeroed before its timed micro-steps); ms of
    both (plain, DDP, DDP + zero1 untimed, DDP, plain). Returns the ms and
    the counts."""
    import torch.distributed as dist

    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.kernels.row_shift import row_shift_blocks, row_shift_blocks_backward
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_backward
    from pcaccumulation_tpu_torch.parallel import mesh
    from pcaccumulation_tpu_torch.profile_forward import default_scenes
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = load_config("configs/nuscene.yaml", ["--misc.mode=train"])
    bsz = cfg["train"]["batch_size"]
    scenes = default_scenes(cfg, 2 * bsz)
    batches = [port.to_device(collate(scenes[i * bsz:(i + 1) * bsz])) for i in range(2)]
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    kernels = (seg_pool, seg_pool_backward, row_shift_blocks, row_shift_blocks_backward)

    def run(c, n_timed=0):
        model = port.build_model(c)
        model.load_state_dict(nus_state)
        tr = Trainer(c, model, {"train": batches}, save_dir=run_dir)
        seen = []
        update = tr.optimizer.update

        def record(grads):  # the first micro-step's gradient, as the optimizer sees it
            if not seen:
                seen.append([g.clone() for g in grads])
            return update(grads)

        tr.optimizer.update = record
        for i in range(2):
            tr.train_step(batches[i], tr.step_generator(1, "train", i))
        torch.cuda.synchronize()
        out = {"grads": seen[0], "params": [p.detach().clone() for p in tr.params],
               "buffers": [b.clone() for b in model.buffers()], "group": tr.group}
        for fn in kernels:
            fn.launches = fn.launches_bf16 = 0
        times = []
        for i in range(n_timed):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            tr.train_step(batches[i % 2], tr.step_generator(2, "train", i))
            end.record()
            times.append(sync_ms(start, end))
        out["times"] = times
        out["counts"] = {f"{fn.__name__}{sfx}": getattr(fn, "launches" + sfx)
                         for fn in kernels for sfx in ("", "_bf16")}
        return out

    def same(a, b):
        return all(torch.equal(x, y) for key in ("grads", "params", "buffers")
                   for x, y in zip(a[key], b[key]))

    cfg_z = load_config("configs/nuscene.yaml", ["--misc.mode=train", "--parallel.zero1=true"])
    try:
        plain = run(cfg, 2)
        dev = mesh.init_distributed(init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                                    rank=0, timeout_s=120)
        try:
            backend = dist.get_backend()
            ddp, ddp_z, ddp2 = run(cfg, 2), run(cfg_z), run(cfg, 2)
        finally:
            dist.destroy_process_group()
        plain2 = run(cfg, 2)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    if plain["group"] is not None or ddp["group"] is None or backend != "nccl" or (
            dev != torch.device("cuda", 0)):
        fail(f"DDP world 1: groups {plain['group']} / {ddp['group']}, backend {backend}, "
             f"device {dev}")
    for name, run_ in (("DDP", ddp), ("DDP + zero1", ddp_z), ("DDP again", ddp2)):
        if not same(plain, run_):
            fail(f"DDP world 1: the {name} step is not bit-equal to the plain step")
    want = {"seg_pool": 0, "seg_pool_bf16": 2 * (cfg["pillar_encoder"]["depth"] - 1),
            "seg_pool_backward": 0, "seg_pool_backward_bf16": 2 * (cfg["pillar_encoder"]["depth"] - 1),
            "row_shift_blocks": 0, "row_shift_blocks_bf16": 6, "row_shift_blocks_backward": 0,
            "row_shift_blocks_backward_bf16": 0}
    if ddp["counts"] != want:
        fail(f"DDP world 1: 2 micro-steps launched {ddp['counts']}, want {want}")
    p_ms = statistics.median(plain["times"] + plain2["times"])
    d_ms = statistics.median(ddp["times"] + ddp2["times"])
    log(f"DDP world 1 (in-process NCCL group, nuScenes bf16 micro-step, B={bsz}, iter_size 2, "
        f"random draw): the first micro-step's reduced gradient, the running statistics and "
        f"the parameters after one update bit-equal to the plain step's, with and without "
        f"zero1; launches in 2 micro-steps {ddp['counts']}; ms (CUDA events, medians of 4): "
        f"plain {p_ms:.3f} ({', '.join(f'{t:.3f}' for t in plain['times'] + plain2['times'])}), "
        f"DDP {d_ms:.3f} ({', '.join(f'{t:.3f}' for t in ddp['times'] + ddp2['times'])}), "
        f"overhead {100 * (d_ms / p_ms - 1):+.1f} % on {smi} ({time.perf_counter() - t0:.1f} s)")
    return {"plain_ms": p_ms, "ddp_ms": d_ms, "counts": ddp["counts"]}


def torchrun_cli_phase(port) -> None:
    """`torchrun --nproc_per_node=1 -m pcaccumulation_tpu_torch.main
    configs/nuscene.yaml 4 2 --misc.mode=train` (through `python -m
    torch.distributed.run`, torchrun's module; `--train.max_epoch=2`: one
    epoch) in a subprocess, over 8 train and 1 val synthetic samples of 11
    sweeps at 20 Hz, with the preset's own `train.ckpt_backend: orbax`:
    rc 0, the rank's NCCL group in its log, `.dcp` checkpoints; then the
    CLI's test mode with `--misc.pretrain` on the `.dcp` checkpoint, its
    weights loaded."""
    from pcaccumulation_tpu_torch.data.synthetic import generate_sample
    from pcaccumulation_tpu_torch.main import main as cli_main

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_torchrun_")
    cwd = os.getcwd()
    try:
        data = os.path.join(tmp, "data")
        rel = []
        for i in range(9):
            os.makedirs(os.path.join(data, f"scene_{i:04d}"))
            rel.append(f"scene_{i:04d}/sample_00000.npz")
            np.savez_compressed(os.path.join(data, rel[-1]),
                                **generate_sample(SEED + 300 + i, n_frames=11, freq=20.0))
        for split, sel in (("train", rel[:8]), ("val", rel[8:]), ("test", rel[8:])):
            with open(os.path.join(data, f"{split}_info.txt"), "w") as f:
                f.write("\n".join(sel) + "\n")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1",
               f"--master_port={free_port()}", "-m", "pcaccumulation_tpu_torch.main",
               os.path.join(repo, "configs", "nuscene.yaml"), "4", "2", "--misc.mode=train",
               "--train.max_epoch=2", "--misc.exp_name=nuscene_ddp",
               f"--path.dataset_base={data}"]
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                              timeout=400)
        run = os.path.join(tmp, "snapshot", "nuscene_ddp")
        found = sorted(os.listdir(run)) if os.path.isdir(run) else []
        if proc.returncode != 0 or "model_latest.ckpt.dcp" not in found or any(
                f.endswith(".ckpt") for f in found):
            fail(f"torchrun CLI: rc {proc.returncode}, run directory {found}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(os.path.join(run, "log")) as f:
            epoch_log = f.read()
        ckpt = os.path.join(run, "model_latest.ckpt")
        if "train Epoch: 1" not in epoch_log or "model_latest.ckpt.dcp\n" not in epoch_log:
            fail(f"torchrun CLI: the log lacks the epoch or the .dcp save:\n{epoch_log[-2000:]}")
        os.chdir(tmp)
        rc = cli_main(["main", os.path.join(repo, "configs", "nuscene.yaml"), "1", "1",
                       "--misc.mode=test", "--misc.exp_name=nuscene_ddp_test",
                       f"--misc.pretrain={ckpt}", f"--path.dataset_base={data}"])
        with open(os.path.join(tmp, "snapshot", "nuscene_ddp_test", "log")) as f:
            test_log = f.read()
        if rc != 0 or f"Loaded checkpoint {ckpt}" not in test_log:
            fail(f"the Tester on the torchrun run's .dcp checkpoint: rc {rc}\n{test_log[-2000:]}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"torchrun CLI (python -m torch.distributed.run --nproc_per_node=1 -m "
        f"pcaccumulation_tpu_torch.main configs/nuscene.yaml 4 2 --misc.mode=train, no "
        f"checkpoint override): rc 0, run directory {found}; the Tester read "
        f"model_latest.ckpt.dcp through --misc.pretrain ({time.perf_counter() - t0:.1f} s)")


def process_loader_phase(port) -> None:
    """`worker_mode: process` on configs/synthetic.yaml over data/synthetic:
    the train and val loaders' batches with forked workers equal to the
    thread mode's (augmentation off, so that a batch is a function of its
    indices), then the Trainer takes an epoch of train micro-steps and the
    val steps through the CLI's process-mode loaders (`main.build_loaders`,
    the training split augmented): finite losses, K1 and K2 launched."""
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.dataset import SceneDataset
    from pcaccumulation_tpu_torch.data.loader import make_loader
    from pcaccumulation_tpu_torch.main import build_loaders
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = load_config("configs/synthetic.yaml",
                      ["--train.worker_mode=process", "--val.worker_mode=process",
                       "--train.batch_size=2"])
    n_batches = 0
    for split in ("train", "val"):
        ds = SceneDataset(cfg, split, augment=False)
        got = {mode: list(make_loader(ds, batch_size=cfg[split]["batch_size"], seed=1,
                                      num_workers=cfg[split]["num_workers"], mode=mode))
               for mode in ("thread", "process")}
        if len(got["process"]) != len(got["thread"]) or not got["process"]:
            fail(f"process loader ({split}): {len(got['process'])} batches, thread mode "
                 f"{len(got['thread'])}")
        for a, b in zip(got["process"], got["thread"]):
            if sorted(a) != sorted(b) or not all(np.array_equal(a[k], b[k]) for k in a):
                fail(f"process loader ({split}): a batch differs from the thread mode's")
        n_batches += len(got["process"])
    loaders = build_loaders(cfg)
    if any(ld.mode != "process" for ld in loaders.values()):
        fail("process loader: the CLI's loaders are not in process mode")
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_loader_")
    try:
        torch.manual_seed(SEED)
        tr = Trainer(cfg, port.build_model(cfg), loaders, save_dir=run_dir)
        zero_kernel_counts()
        meters = {ph: tr.inference_one_epoch(1, ph) for ph in ("train", "val")}
        counts = kernel_counts()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    losses = {ph: m["loss"].avg for ph, m in meters.items()}
    if not all(np.isfinite(v) for v in losses.values()) or counts["K1"] == 0 or counts["K2"] == 0:
        fail(f"process loader: Trainer losses {losses}, launches {counts}")
    log(f"process loader (configs/synthetic.yaml, data/synthetic): {n_batches} train and val "
        f"batches of forked workers equal to the thread mode's; the Trainer's epoch over "
        f"{len(loaders['train'])} train (B=2, augmented) and {len(loaders['val'])} val batches "
        f"from process-mode loaders: loss {losses}, launches {counts} "
        f"({time.perf_counter() - t0:.1f} s)")


def options_cli_phase(port) -> None:
    """`python -m pcaccumulation_tpu_torch.main configs/default.yaml 1 1`
    over data/synthetic in train (one epoch), val and test mode, each with
    options of this slice (every one at least once): train with
    `train.remat`, process workers for train and val, `seq_pose: chain` and
    `n_band_layers: 1`; val with `seq_pose: full`, `n_band_layers: 3` and a
    process worker; test with `seq_pose: full`, `n_band_layers: 2`, a
    process worker and both ICPs. rc 0 and the run's outputs."""
    from pcaccumulation_tpu_torch.main import main as cli_main

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_options_cli_")
    cwd = os.getcwd()
    base = ["main", os.path.join(repo, "configs", "default.yaml"), "1", "1",
            f"--path.dataset_base={os.path.join(repo, 'data', 'synthetic')}"]
    runs = {
        "train": ["--misc.mode=train", "--train.max_epoch=2", "--train.remat=true",
                  "--train.worker_mode=process", "--val.worker_mode=process",
                  "--pose_estimation.seq_pose=chain", "--stpn.n_band_layers=1",
                  "--misc.exp_name=opt_train"],
        "val": ["--misc.mode=val", "--val.worker_mode=process", "--pose_estimation.seq_pose=full",
                "--stpn.n_band_layers=3", "--misc.exp_name=opt_val"],
        "test": ["--misc.mode=test", "--test.worker_mode=process",
                 "--pose_estimation.seq_pose=full", "--stpn.n_band_layers=2",
                 "--pose_estimation.icp=true", "--tpointnet.icp=true",
                 "--misc.exp_name=opt_test"],
    }
    done = {}
    try:
        os.chdir(tmp)
        for mode, extra in runs.items():
            t1 = time.perf_counter()
            zero_kernel_counts()
            rc = cli_main(base + extra)
            counts = kernel_counts()
            if rc != 0 or counts["K1"] == 0 or counts["K2"] == 0 or (
                    (counts["K4"] == 0) == (mode == "test")):
                fail(f"options CLI {mode} ({' '.join(extra)}): rc {rc}, launches {counts}")
            done[mode] = (round(time.perf_counter() - t1, 1), counts)
        ckpts = sorted(f for f in os.listdir(os.path.join(tmp, "snapshot", "opt_train"))
                       if f.endswith(".ckpt"))
        dumps = sorted(os.listdir(os.path.join(tmp, "results", "opt_test")))
        if "model_latest.ckpt" not in ckpts or len(dumps) != 3:
            fail(f"options CLI: checkpoints {ckpts}, test dumps {dumps}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    log("options CLI (configs/default.yaml 1 1 over data/synthetic): " + "; ".join(
        f"{m} [{' '.join(runs[m][:-1])}] rc 0 in {s} s, launches {c}" for m, (s, c) in done.items())
        + f"; checkpoints {ckpts}; test dumps {dumps} ({time.perf_counter() - t0:.1f} s)")


# the frame and spatial axes: two processes on the one card over gloo
MESH_AXES = {"frame": (2, 1), "spatial": (1, 2)}
MESH_FWD_KEYS = ("ego_motion_est", "rec_est", "offset_est", "mos_est", "fb_seg_est",
                 "transformed_points", "fb_est_per_points", "fb_mask", "rec_mask")
# tests/test_torch_mesh.py's tolerances (tests/test_parallel.py's atol of a
# sharded forward), the decisions equal; but the ego pose within
# tests/test_torch_motionnet.py's 2e-4 for a float32 forward whose
# convolutions sum in another order: on the CPU the split keeps every
# convolution's arithmetic (bit-equal there), on the card cuDNN picks a UNet
# convolution's algorithm by the rows it gets (the UNet's output moves by
# ~4e-8), and Sinkhorn and the SVD turn that into ~1.3e-5 of pose
MESH_ATOL = {"ego_motion_est": 2e-4, "rec_est": 1e-4, "offset_est": 1e-4, "mos_est": 1e-4,
             "fb_seg_est": 1e-4, "transformed_points": 1e-4}
MESH_DECISIONS = ("fb_est_per_points", "fb_mask", "rec_mask")
MESH_REPS = 5  # timed forwards, float32 micro-steps and predicts per rank
MESH_TRAIN_REPS = 3  # timed bf16 micro-steps per rank
# the bf16 micro-step's batch: the nuScenes preset's (train.batch_size);
# the float32 micro-step stays at B=1 (at B=4 the float32 split moved a leaf
# upstream of the TPointNet's max pools 5.3e-2 from one process's step:
# ROADMAP item 33)
MESH_TRAIN_B = 4


def mesh_configs() -> dict:
    """The mesh phase's configs: the default float32 config (deterministic
    keypoints, as the main path), the nuScenes preset for training (its
    dtype set by the caller), the serving config (default, the random draw
    of the Predictor's seed); the mesh factors are set by the caller."""
    from pcaccumulation_tpu_torch.config import load_config

    val = load_config()
    val["pose_estimation"]["deterministic_sampling"] = True
    train = load_config("configs/nuscene.yaml", ["--misc.mode=train",
                                                  "--train.ckpt_backend=pickle"])
    return {"val": val, "train": train, "serve": load_config()}


def with_axes(cfg: dict, axis: str | None) -> dict:
    import copy

    cfg = copy.deepcopy(cfg)
    f, s = MESH_AXES[axis] if axis else (1, 1)
    cfg["parallel"].update(frame_devices=f, spatial_devices=s, num_devices=f * s)
    return cfg


def mesh_runs(port, setup: dict, split: bool) -> dict:
    """What the mesh phase compares, on this process: the default float32
    val forward on each axis, the nuScenes bf16 micro-step at F=2 and the
    predict at S=2 (split False: the one-process runs, without the factors),
    each with its launch counts (zeroed just before, read just after) and
    MESH_REPS timings."""
    from pcaccumulation_tpu_torch.models import egomotion
    from pcaccumulation_tpu_torch.parallel import mesh as pm
    from pcaccumulation_tpu_torch.serve import Predictor
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    cfgs, res = mesh_configs(), {}

    def timed(fn, reps: int = MESH_REPS) -> list:
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            times.append(sync_ms(start, end))
        return times

    batch = port.to_device(setup["val_batch"])
    for axis, (f, s) in MESH_AXES.items():
        on = pm.make_mesh(f, s) if split else None
        model = port.build_model(with_axes(cfgs["val"], axis if on else None))
        model.load_state_dict(setup["val_state"])
        with torch.no_grad(), pm.model_parallel(on):
            zero_kernel_counts()
            out = model(batch)
            counts = kernel_counts()
            times = timed(lambda: model(batch))
        res[axis] = {"out": {k: out[k].cpu() for k in MESH_FWD_KEYS}, "counts": counts,
                     "ms": times}

    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool_backward

    batches = {1: port.to_device(setup["train_batch"]),
               MESH_TRAIN_B: port.to_device(setup["train_batch_bf16"])}
    # (result, dtype, batch, timed micro-steps); one process also runs the
    # float32 step at the bf16 step's batch, the bf16 step's yardstick
    steps = [("train_float32", "float32", 1, MESH_REPS),
             ("train_bfloat16", "bfloat16", MESH_TRAIN_B, MESH_TRAIN_REPS)]
    if not split:
        steps.append(("yardstick_float32", "float32", MESH_TRAIN_B, 0))
    for key, dtype, bsz, reps in steps:
        tbatch = batches[bsz]
        cfg_t = with_axes(cfgs["train"], "frame" if split else None)
        cfg_t["precision"]["compute_dtype"] = dtype
        model = port.build_model(cfg_t)
        model.load_state_dict(setup["train_state"])
        run_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        try:
            tr = Trainer(cfg_t, model, {"train": [None] * 2}, save_dir=run_dir)
            seen = {}
            update = tr.optimizer.update

            def record(grads):
                seen.setdefault("grads", {n: g.cpu() for (n, _), g in
                                          zip(model.named_parameters(), grads)})
                return update(grads)

            tr.optimizer.update = record
            # the step's FB decisions and keypoints (ROADMAP item 31)
            fwd, draw = {}, egomotion.draw_keypoints

            def record_draw(*args, **kw):
                idx = draw(*args, **kw)
                fwd.setdefault("kpts", idx.detach().cpu())
                return idx

            def record_fb(module, args, out):
                fwd.setdefault("fb", out["fb_logit_pillar"].detach().cpu())

            hook = model.register_forward_hook(record_fb)
            egomotion.draw_keypoints = record_draw
            zero_kernel_counts()
            seg_pool_backward.launches = seg_pool_backward.launches_bf16 = 0
            try:
                st = tr.train_step(tbatch, tr.step_generator(1, "train", 0))
            finally:
                hook.remove()
                egomotion.draw_keypoints = draw
            counts = dict(kernel_counts(), **{"K1 bwd": seg_pool_backward.launches,
                                              "K1 bwd-bf16": seg_pool_backward.launches_bf16})
            # this rank's gradient before the mean over the ranks
            local = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                     for n, p in model.named_parameters()}
            stats = {k: float(v) for k, v in st.items() if not isinstance(v, dict)}
            buffers = {n: b.cpu() for n, b in model.named_buffers() if "running_" in n}
            times = timed(lambda: tr.train_step(tbatch, tr.step_generator(1, "train", 1)), reps)
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        res[key] = {"stats": stats, "grads": seen["grads"], "local": local,
                                 "buffers": buffers, "counts": counts, "ms": times,
                                 "shape": (tr.mesh.data, tr.mesh.frame, tr.mesh.spatial),
                                 "fb_logit_pillar": fwd["fb"], "kpts": fwd["kpts"]}

    on = pm.make_mesh(*MESH_AXES["spatial"]) if split else None
    pred = Predictor(with_axes(cfgs["serve"], "spatial" if on else None),
                     state_dict=setup["val_state"], mesh=on)
    pred.predict(*setup["scan"])
    zero_kernel_counts()
    out = pred.predict(*setup["scan"])
    counts = kernel_counts()
    times = []
    for _ in range(MESH_REPS):
        t0 = time.perf_counter()
        pred.predict(*setup["scan"])
        times.append(1e3 * (time.perf_counter() - t0))
    res["predict"] = {"out": out, "counts": counts, "ms": times}
    if on is not None:
        try:
            pred.export(os.path.join(tempfile.gettempdir(), "chip_smoke_never.pt2"))
            res["predict"]["export"] = "no error"
        except NotImplementedError as e:
            res["predict"]["export"] = str(e)
    return res


def mesh_rank(rank: int, port_no: int, out_dir: str) -> None:
    """One of the mesh phase's two processes: joins a gloo group of 2 on
    cuda:0 and runs `mesh_runs` on its meshes; writes rank<rank>.pt."""
    import torch.distributed as dist

    import pcaccumulation_tpu_torch as port
    from pcaccumulation_tpu_torch.parallel import mesh as pm

    dev = pm.init_distributed("cuda:0", init_method=f"tcp://127.0.0.1:{port_no}", world_size=2,
                              rank=rank, timeout_s=300, backend="gloo")
    if dev != torch.device("cuda", 0) or dist.get_backend() != "gloo":
        fail(f"mesh rank {rank}: device {dev}, backend {dist.get_backend()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup = torch.load(os.path.join(out_dir, "setup.pt"), weights_only=False)
    res = mesh_runs(port, setup, split=True)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def mesh_bf16_split_report(split: dict, one: dict, one32: dict, names: list) -> str:
    """Where the F=2 bf16 micro-step lies (ROADMAP item 31): per leaf of
    `names` above `bf16_leaf_criterion`'s noise floor, the rel-norm and
    cosine of the split step against the one-process float32 step, of the
    one-process bf16 step against it and of the two bf16 steps against each
    other (the three leaves farthest in each, `POOLED` marking those
    upstream of the TPointNet's max pools, the median, and per leaf the
    median ratio of the split's distance from float32 to one process's);
    the pillar FB decisions of the step's forward that differ between the
    two bf16 steps and between one process's bf16 and float32 steps, and
    the keypoints the two bf16 steps draw differently."""
    floor = noise_floor(one32["grads"], names)
    d = {pair: leaf_distances(a["grads"], b["grads"], names, floor)
         for pair, (a, b) in (("split bf16 vs one-process float32", (split, one32)),
                              ("one-process bf16 vs one-process float32", (one, one32)),
                              ("split bf16 vs one-process bf16", (split, one)))}
    parts = []
    for pair, leaves in d.items():
        rows = sorted(((r, c, n) for n, (r, c) in leaves.items()), reverse=True)
        parts.append(f"{pair}: {len(leaves)} leaves, median rel-norm "
                     f"{statistics.median(r for r, _, _ in rows):.4f}, worst " + "; ".join(
                         f"{n} rel-norm {r:.4f} cosine {c:.4f} "
                         f"({'upstream of' if n.startswith(POOLED) else 'not upstream of'} the "
                         f"max pools)" for r, c, n in rows[:3]))
    a, b = d["split bf16 vs one-process float32"], d["one-process bf16 vs one-process float32"]
    ratios = [a[n][0] / max(b[n][0], 1e-300) for n in b if n in a]
    parts.append(f"per leaf, split's rel-norm from float32 over one process's: median "
                 f"{statistics.median(ratios):.3f}")

    def fb(step):
        lg = step["fb_logit_pillar"]
        return lg[..., 1] > lg[..., 0]

    valid = one["fb_logit_pillar"].abs().sum(-1) > 0
    n_fb = int((fb(split) != fb(one))[valid].sum())
    n_fb32 = int((fb(one) != fb(one32))[valid].sum())
    ks, ko = split["kpts"], one["kpts"]
    n_kpt = sum(len(set(ks[b, t].tolist()) - set(ko[b, t].tolist()))
                for b in range(ks.shape[0]) for t in range(ks.shape[1]))
    parts.append(f"pillar FB decisions differing: split bf16 vs one-process bf16 {n_fb}, "
                 f"one-process bf16 vs float32 {n_fb32}, of {int(valid.sum())}; keypoints "
                 f"differing between the bf16 steps {n_kpt} of {ks.numel()} ({ks.shape[1]} "
                 f"frames x {ks.shape[2]})")
    return "\n  ".join(parts)


def mesh_phase(port, val_state: dict, val_scene: dict, nus_state: dict, smi: str) -> dict:
    """The frame and spatial axes on the card: two processes sharing the one
    H100 over gloo (NCCL refuses two ranks on one device), both on cuda:0,
    at full width: the default float32 val forward at F=2 (T=5, B=1: rows
    3/2) and at S=2 (bands 144/144), the nuScenes preset's train
    micro-step at F=2 (T=11, the random draw) in float32 at B=1 (rows 6/5)
    and in its bf16 at B=`MESH_TRAIN_B` (rows 22/22), and
    `Predictor.predict` at S=2 on a default raw scan.
    Each is held against this process's one-process run on the same
    weights, batch and scan (`mesh_runs(split=False)`, before the ranks
    start), both ranks the same bits: the forwards at `MESH_ATOL` with the
    decisions equal; the float32 micro-step's loss terms within rtol 1e-5,
    its gradient per leaf by the criterion of tests/test_parallel.py
    (`leaf_criterion`), its running statistics within rtol 1e-5; the bf16
    micro-step's loss terms within one bf16 rounding and its running
    statistics within rel-norm 0.05 of one process's bf16 step, its
    gradient per leaf within BF16_LEAF_REL / BF16_LEAF_COS (bf16's own
    noise) of the one-process float32 step at its batch, the yardstick of
    every bf16 check here, and of the one-process bf16 step, with the three
    distances
    logged (`mesh_bf16_split_report`); the predict's floats within
    1e-4 and labels equal, `export` refused. K1 and K2 launched on every
    rank (counts zeroed just before each run). The times measure gloo and
    two processes on one card, not what the axes would gain on several
    cards. Returns the ranks' launch counts and the times."""
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.profile_forward import default_samples, default_scenes

    t0 = time.perf_counter()
    cfgs = mesh_configs()
    raw = default_samples(cfgs["serve"], 1, first=SEED + 300)[0]
    setup = {"val_state": {k: v.cpu() for k, v in val_state.items()},
             "val_batch": collate([val_scene]),
             "train_state": {k: v.cpu() for k, v in nus_state.items()},
             "train_batch": collate(default_scenes(cfgs["train"], 1)),
             "train_batch_bf16": collate(default_scenes(cfgs["train"], MESH_TRAIN_B)),
             "scan": (raw["raw_points"], raw["time_indice"])}
    want = mesh_runs(port, setup, split=False)
    torch.cuda.empty_cache()  # the card is the ranks' now
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        torch.save(setup, os.path.join(out_dir, "setup.pt"))
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        port_no = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                   str(r), str(port_no), out_dir], cwd=here, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"mesh rank {r}: rc {p.returncode}\n{text[-4000:]}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    k1_per = 2  # the pillar encoder's pools (depth 3) in both configs
    faults = []  # every check is made; the phase fails at its end with all that missed
    for axis in MESH_AXES:
        a, b, ref = ranks[0][axis], ranks[1][axis], want[axis]
        for k in MESH_FWD_KEYS:
            if not torch.equal(a["out"][k], b["out"][k]):
                faults.append(f"mesh {axis}: the two ranks' {k} differ")
        for k in MESH_DECISIONS:
            if not torch.equal(a["out"][k], ref["out"][k]):
                faults.append(f"mesh {axis}: {k} differs from one process's")
        errs = {k: float((a["out"][k] - ref["out"][k]).abs().max()) for k in MESH_ATOL}
        for k, tol in MESH_ATOL.items():
            if errs[k] > tol:
                faults.append(f"mesh {axis}: {k} max abs err {errs[k]:.3e} against one process > {tol}")
        for r, rk in enumerate(ranks):
            if (rk[axis]["counts"]["K1"], rk[axis]["counts"]["K2"]) != (k1_per, 3):
                faults.append(f"mesh {axis} rank {r}: launched {rk[axis]['counts']}, want K1 {k1_per}, "
                     f"K2 3")
        log(f"mesh {axis} (default float32 val forward, B=1, 2 processes on one card over gloo): "
            f"both ranks the same bits, decisions equal to one process's, max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; launches per rank {[rk[axis]['counts'] for rk in ranks]}")

    for dtype, u in (("float32", 0.0), ("bfloat16", 2.0 ** -8)):
        tr, tref = [rk[f"train_{dtype}"] for rk in ranks], want[f"train_{dtype}"]
        if any(t["shape"] != (1, 2, 1) for t in tr):
            faults.append(f"mesh micro-step {dtype}: mesh shapes {[t['shape'] for t in tr]}, "
                          f"want (1, 2, 1)")
        # float32: tests/test_torch_mesh.py's rtol (the error metrics 10x);
        # bf16: one rounding to bf16 (the error metrics 10x)
        for key, w in tref["stats"].items():
            rtol = (u or 1e-5) * (10 if key.endswith("_error") else 1)
            for r, t in enumerate(tr):
                if abs(t["stats"][key] - w) > rtol * abs(w) + 1e-6:
                    faults.append(f"mesh micro-step {dtype} rank {r}: {key} {t['stats'][key]} "
                                  f"against one process's {w} (rtol {rtol:.2e})")
        for n in tref["grads"]:
            if not torch.equal(tr[0]["grads"][n], tr[1]["grads"][n]):
                faults.append(f"mesh micro-step {dtype}: the ranks' averaged gradient of {n} differ")
        if u == 0.0:
            # the float32 step: the split computes the one-process function
            checked, noise, w_rel, w_cos, w_leaf = leaf_criterion(
                tref["grads"], tr[0]["grads"], what="mesh micro-step float32 vs one process")
            for n, w in tref["buffers"].items():
                if not all(torch.allclose(t["buffers"][n], w, rtol=1e-5, atol=1e-6) for t in tr):
                    faults.append(f"mesh micro-step float32: running statistic {n} differs "
                                  f"from one process's")
        else:
            # bf16: cuDNN rounds the split UNet's rows otherwise, and the FB
            # decisions and keypoints move with an ulp, so the step is another
            # sample of bf16's noise about the float32 step, as one process's
            # bf16 step is (PERF.md §6, fault 31): held per leaf by the
            # criterion of that noise against the one-process float32 step,
            # the yardstick of every bf16 check here, and against the
            # one-process bf16 step; the running statistics against one
            # process's bf16 step by rel-norm 0.05
            names = [n for n in tref["grads"] if not n.endswith(STRUCTURAL_ZERO)]
            log("mesh micro-step bf16 at F=2 (ROADMAP item 31):\n  " + mesh_bf16_split_report(
                tr[0], tref, want["yardstick_float32"], names))
            for ref, what in ((tref, "one-process bf16"),
                              (want["yardstick_float32"], "one-process float32")):
                dist, misses = bf16_misses(tr[0]["grads"], ref["grads"], names)
                faults += [f"mesh micro-step bf16 at F=2 vs {what}: gradient of {n} rel-norm "
                           f"{dist[n][0]:.3e}, cosine {dist[n][1]:.6f}" for n in misses]
            # the log's worst leaf and counts: against the float32 step
            checked, noise = len(dist), len(names) - len(dist)
            if checked <= noise:
                faults.append(f"mesh micro-step bf16: {checked} leaves checked, {noise} below "
                              f"the noise floor")
            w_rel, w_cos, w_leaf = max((r, c, n) for n, (r, c) in dist.items())
            for n, w in tref["buffers"].items():
                rel = max(float((t["buffers"][n] - w).norm()) for t in tr) / float(w.norm())
                if rel >= 0.05:
                    faults.append(f"mesh micro-step bf16: running statistic {n} rel-norm "
                                  f"{rel:.3e} from one process's")
        sfx = "" if u == 0.0 else "-bf16"
        want_t = {"K1": 0, "K1-bf16": 0, "K2": 0, "K2-bf16": 0, "K1 bwd": 0, "K1 bwd-bf16": 0}
        want_t.update({"K1" + sfx: k1_per, "K1 bwd" + sfx: k1_per, "K2" + sfx: 3})
        for r, t in enumerate(tr):
            got = {k: t["counts"][k] for k in want_t}
            if got != want_t:
                faults.append(f"mesh micro-step {dtype} rank {r}: launched {got}, want {want_t}")
        rows = 11 * (1 if u == 0.0 else MESH_TRAIN_B)
        log(f"mesh micro-step (nuScenes preset in {dtype}, F=2, B={rows // 11}, T=11: rows "
            f"{(rows + 1) // 2}/{rows // 2}, random draw): loss {tr[0]['stats']['loss']:.6f} / "
            f"{tr[1]['stats']['loss']:.6f} against {tref['stats']['loss']:.6f}; gradient against "
            f"the one-process float32 step: "
            f"{checked} leaves checked, {noise} below the noise floor, worst {w_leaf} rel-norm "
            f"{w_rel:.3e} cosine {w_cos:.8f}; launches per rank {[t['counts'] for t in tr]}")

    pr, pref = [rk["predict"] for rk in ranks], want["predict"]
    for r, p in enumerate(pr):
        labels, floats = serve_diff(p["out"], pref["out"])
        if labels or floats > 1e-4:
            faults.append(f"mesh predict rank {r}: labels differ {labels}, floats {floats:.3e}")
        if "single-device" not in p["export"]:
            faults.append(f"mesh predict rank {r}: export under the mesh gave {p['export']!r}")
        if (p["counts"]["K1"], p["counts"]["K2"]) != (k1_per, 3):
            faults.append(f"mesh predict rank {r}: launched {p['counts']}, want K1 {k1_per}, K2 3")
    log(f"mesh predict (S=2, default float32, one raw scan): both ranks' outputs equal one "
        f"process's (labels equal, floats within 1e-4), export refused; launches per rank "
        f"{[p['counts'] for p in pr]}")

    if faults:
        fail("mesh phase:\n" + "\n".join(faults))

    def med(xs):
        return statistics.median(xs)

    ms = {}
    for name in ("frame", "spatial", "train_float32", "train_bfloat16", "predict"):
        ms[f"mesh_{name}_world1_ms"] = med(want[name]["ms"])
        for r in range(2):
            ms[f"mesh_{name}_rank{r}_ms"] = med(ranks[r][name]["ms"])
    log(f"mesh times (medians of {MESH_REPS}, the bf16 micro-step's of {MESH_TRAIN_REPS}; "
        "forwards and micro-steps on CUDA events, predicts on the "
        "host clock; two processes sharing one card over gloo: not a measure of multi-card "
        "scaling): " + ", ".join(
            f"{name} world 1 {ms[f'mesh_{name}_world1_ms']:.3f} ms, ranks "
            f"{ms[f'mesh_{name}_rank0_ms']:.3f} / {ms[f'mesh_{name}_rank1_ms']:.3f} ms"
            for name in ("frame", "spatial", "train_float32", "train_bfloat16", "predict"))
        + f" on {smi} ({time.perf_counter() - t0:.1f} s)")
    paths = ("frame", "spatial", "train_float32", "predict")
    launches = {"seg_pool": [sum(rk[p]["counts"]["K1"] for p in paths) for rk in ranks],
                "row_shift_blocks": [sum(rk[p]["counts"]["K2"] for p in paths) for rk in ranks],
                "seg_pool_backward": [rk["train_float32"]["counts"]["K1 bwd"] for rk in ranks],
                "seg_pool_bf16": [rk["train_bfloat16"]["counts"]["K1-bf16"] for rk in ranks],
                "seg_pool_backward_bf16": [rk["train_bfloat16"]["counts"]["K1 bwd-bf16"]
                                           for rk in ranks],
                "row_shift_blocks_bf16": [rk["train_bfloat16"]["counts"]["K2-bf16"]
                                          for rk in ranks]}
    return {"launches": launches, "ms": ms}


WAYMO = "configs/waymo.yaml"
WAYMO_STEPS = ((2, 2), (1, 2))  # (warm-up, timed) micro-steps in bf16, then float32


def presets_run(port, dev, gen, smi: str) -> None:
    """`--only presets`: after the build, the phases of the bf16 presets and
    the JAX checkpoint alone: the nuScenes and Waymo preset phases, K1/K2 in
    bf16 at the Waymo shapes, the Waymo training micro-step, a Waymo
    predict, the JAX fixture and the mesh phase (the default config's main
    path weights, calibrated as in the full run). Prints the Waymo rows of
    the `kernels` line and no result line."""
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.profile_forward import calibrate_heads, default_scenes

    _, _, nus_state = preset_phase(port, smi)
    way_counts, _, way_state = preset_phase(port, smi, WAYMO, "Waymo")
    rows = waymo_kernel_phase(dev, gen)
    preset_train_phase(port, way_state, smi, WAYMO, "Waymo", WAYMO_STEPS)
    serving_phase(port, "waymo_bf16", load_config(WAYMO, ["--train.ckpt_backend=pickle"]),
                  way_state, 2, smi, export=False)
    jax_fixture_phase(port)
    cfg = load_config()
    cfg["pose_estimation"]["deterministic_sampling"] = True
    scenes = default_scenes(cfg, 3)
    torch.manual_seed(SEED)
    model = port.build_model(cfg)
    calibrate_heads(model, port.to_device(collate([scenes[0]])))
    mesh_phase(port, model.state_dict(), scenes[0], nus_state, smi)
    rows["seg_pool_bf16_waymo"]["launches"] = way_counts["K1-bf16"]
    rows["row_shift_blocks_bf16_waymo"]["launches"] = way_counts["K2-bf16"]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    log("--only presets: the preset, fixture and mesh phases passed")


def main() -> None:
    args = sys.argv[1:]
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if args[:1] == ["--mesh-rank"] and len(args) == 4:  # a process of `mesh_phase`
        mesh_rank(int(args[1]), int(args[2]), args[3])
        return
    if args not in ([], ["--only", "kernels"], ["--only", "presets"]):
        fail(f"usage: python3 chip_smoke.py [--only kernels | --only presets], got {args}")
    only_kernels = args == ["--only", "kernels"]
    import pcaccumulation_tpu_torch as port
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.kernels.row_shift import (
        row_shift_blocks,
        row_shift_blocks_backward,
        row_shift_blocks_plain,
    )
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_backward, seg_pool_plain
    from pcaccumulation_tpu_torch.native import host
    from pcaccumulation_tpu_torch.profile_forward import calibrate_heads, default_scenes

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
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, one process per source, "
        f"in parallel)")
    t0 = time.perf_counter()
    host.get_lib()  # raises with the compiler's output
    log(f"host library: {time.perf_counter() - t0:.1f} s "
        f"({host.compiler_version().splitlines()[0]}, {' '.join(host.CXX_FLAGS)})")
    if only_kernels:
        log("ptxas on csrc/segscan.cu:\n" + build.ptxas_report("segscan").strip())

    gen = torch.Generator().manual_seed(SEED)
    kernels = {}
    if args == ["--only", "presets"]:
        presets_run(port, dev, gen, smi)
        return

    # ---- 3. K1 seg_pool vs plain ---------------------------------------------
    k1_edge_phase(dev)
    x, ids = k1_inputs(gen, dev)
    g1 = torch.randn(x.shape, generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    k1_err, err_s, err_b = k1_check("[90000, 32]", x, ids, g1)
    log(f"K1 seg_pool [90000, 32] ({len(torch.unique(ids))} segments, 40000-row tail): max "
        f"bit-exact; sum max abs err {err_s:.2e}, gradient {err_b:.2e}; two calls equal")

    # ---- 4. K2 and its gradient vs plain -------------------------------------
    # the main path's T=5 shape, the T=11 width (ctot 352) and C % 4 != 0
    # (the kernel's one-channel-per-thread path)
    for nb_x, c_x in ((5, 32), (11, 32), (5, 9)):
        k2 = k2_check(gen, dev, nb_x, c_x)
        log(f"K2 row_shift_blocks [288, 288, {nb_x * c_x}] nb={nb_x} C={c_x}: forward max abs "
            f"err {k2[4][0]:.2e}, gradient (shift at -shifts) {k2[4][1]:.2e} (tol 1e-6); zero "
            f"shift passes through")
        if nb_x == 5 and c_x == 32:
            img, shifts, g2, (k2_want, k2_want_g), (k2_err, k2b_err) = k2

    # ---- 4b. K1 gradient vs plain ------------------------------------------
    # the train path's shape: B=4 samples of [90000, 32]; with float x and
    # with values rounded to halves (forced ties); through SegPool's backward
    # (one launch) as through the direct call
    x4, ids4 = k1_batch_inputs(gen, dev, 4)
    g4 = torch.randn(x4.shape, generator=gen).to(dev)
    k1b_err = 0.0
    for name, xin in (("float", x4), ("ties", tie_values(x4))):
        xg = xin.clone().requires_grad_(True)
        before = seg_pool_backward.launches
        seg_pool(xg, ids4, "max").backward(g4)
        if seg_pool_backward.launches != before + 1:
            fail("K1 gradient did not launch the kernel once")
        if not torch.equal(xg.grad, seg_pool_backward(xin, ids4, seg_pool(xin, ids4, "max"), g4)):
            fail(f"K1 gradient ({name}) through SegPool differs from the direct call")
        err = k1_check(f"[{x4.shape[0]}, {x4.shape[1]}] {name}", xin, ids4, g4)[2]
        k1b_err = max(k1b_err, err)
        n_tied = int((xin == seg_pool_plain(xin, ids4, "max")).sum())
        log(f"K1 gradient [{x4.shape[0]}, {x4.shape[1]}] ({name}) through SegPool: max abs err "
            f"{err:.2e} (bound 1e-5 of the segment's sum|g|), zero off the tie set, {n_tied} "
            f"tied rows, two calls equal")
    k1_rows = k1_timings(x, ids, x4, ids4, g4, k1_err, k1b_err)

    # ---- 4c. the bf16 kernels of K1 and K2 (and K3) vs plain ----------------
    bf16_rows = bf16_kernel_phase(dev, gen)
    bf16_rows.update(bf16_grad_phase(dev, gen))
    if only_kernels:
        cfg = load_config()
        k3_phase(dev, gen)
        k4_phase(dev, gen, default_scenes(cfg, 1)[0])
        chamfer_phase(dev, gen)
        print(json.dumps({"kernels": list(k1_rows.values()) + list(bf16_rows.values())}),
              flush=True)
        log("--only kernels: the build and the kernel phases passed; no path was driven")
        return

    # ---- 4d. the native host library against numpy, prep_sample by stage ----
    host_prep = host_prep_phase(smi)

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
    # seeded random weights call every pillar FG, and the ego head then
    # gates every pair to the identity; set the FB and MOS biases to scene
    # 0's label shares, for the val phase and the test path alike
    fg_share, mov_share = calibrate_heads(model, batches[0])
    log(f"weights: the FB and MOS heads' class-1 biases set so that {fg_share:.4f} of the "
        f"pillars are FG and {mov_share:.4f} of the decoded rows move (scene 0's label shares)")

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
    errs = card_vs_cpu("val phase", port, cfg, model, batches[0], scenes[0], gpu_out[0])
    log(f"GPU vs CPU ({time.perf_counter() - t0:.1f} s with the CPU forward): "
        + ", ".join(f"{k} {errs[k]:.2e} (tol {t})" for k, t in VAL_TOL.items())
        + f"; ego_motion_est of frames 1..T-1 at least {errs['ego_from_identity']:.4e} from the "
        f"identity; FB decisions flipped {errs['fb_flips']} of {errs['pillars']} (min |logit "
        f"margin| {errs['fb_margin']:.2e})")

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
    log(f"val forward (B=1, default config, calibrated heads, CUDA events): median "
        f"{fwd_ms:.3f} ms of 10 "
        f"(min {min(times):.3f}, max {max(times):.3f}) on {smi}")

    # ---- 6a. the options: seq_pose chain and full, n_band_layers 2 ------------
    opt_ms = options_phase(port, cfg, model.state_dict(), batches, scenes, fwd_ms, smi)

    # ---- 6b. K3, K4 and the Chamfer distance vs plain -------------------------
    k3_entry = k3_phase(dev, gen)
    k4_entry = k4_phase(dev, gen, scenes[0])
    chamfer_phase(dev, gen)

    # ---- 6c. test path: the test-mode forward with both ICPs ---------------
    k4_entry["launches"], test_ms = test_path_phase(port, cfg, model.state_dict(), batches, smi)

    # ---- 6d. the Tester and the evaluation on data/synthetic ----------------
    tester_phase(port)

    # ---- 6d'. process workers; the CLI with the options in every mode ---------
    process_loader_phase(port)
    options_cli_phase(port)

    # ---- 6e. the nuScenes preset in bf16: val and test forward, the CLI ------
    nus_counts, nus_ms, nus_state = preset_phase(port, smi)
    nus_full_ms = nuscenes_full_phase(port, nus_state, nus_ms["val_bf16"], smi)
    nuscenes_cli_phase(port)
    # ---- 6e'. the Waymo preset in bf16: val and test forward, K1/K2 at its shapes
    way_counts, way_ms, way_state = preset_phase(port, smi, WAYMO, "Waymo")
    way_rows = waymo_kernel_phase(dev, gen)

    # ---- 6f. the presets' bf16 training: micro-steps, gradient, CLI ----------
    nus_train = preset_train_phase(port, nus_state, smi)
    way_train = preset_train_phase(port, way_state, smi, WAYMO, "Waymo", WAYMO_STEPS)
    remat = remat_phase(port, nus_state, smi)
    nuscenes_cli_train_phase(port)

    # ---- 6f*. a JAX training run's orbax checkpoint taken over ----------------
    fixture = jax_fixture_phase(port)

    # ---- 6f'. reproducible steps; the data-parallel path; the torchrun CLI --------
    det_ms = determinism_phase(port, nus_state, smi)
    ddp = ddp_world1_phase(port, nus_state, smi)
    torchrun_cli_phase(port)

    # ---- 6f''. the frame and spatial axes: two processes on the one card ------
    mesh = mesh_phase(port, model.state_dict(), scenes[0], nus_state, smi)

    # ---- 6g. serving: Predictor, predict_stream, export, the tracker ---------
    cfg_s = load_config("configs/nuscene.yaml", ["--train.ckpt_backend=pickle"])
    serve_ms = {"nuscenes_bf16": serving_phase(port, "nuscenes_bf16", cfg_s, nus_state, 8, smi,
                                               export=True, host_split=True),
                "default_f32": serving_phase(port, "default_f32", load_config(),
                                             model.state_dict(), 8, smi, export=False,
                                             host_split=True)}
    # both ICPs, exported: K4 inside the graph; at 10 iterations each (the
    # test path runs 50), which keeps the export's unrolled graph short
    cfg_icp = load_config(None, ["--pose_estimation.icp=true", "--tpointnet.icp=true",
                                 "--pose_estimation.icp_max_iter=10",
                                 "--tpointnet.icp_max_iter=10"])
    serve_ms["default_f32_icp"] = serving_phase(port, "default_f32_icp", cfg_icp,
                                                model.state_dict(), 3, smi, export=True)
    serve_ms["waymo_bf16"] = serving_phase(port, "waymo_bf16", load_config(
        WAYMO, ["--train.ckpt_backend=pickle"]), way_state, 2, smi, export=False)

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

    # ---- 9. training from scratch: the JAX package's initialisation, 2 epochs --
    scratch = train_from_scratch_phase(port, smi)

    kernels["seg_pool"] = dict(k1_rows["seg_pool"], launches=k1_launches)
    r, w, ctot = img.shape
    k, kn = torch.floor(shifts), torch.floor(-shifts)
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
                     - k2_want).abs().max())
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
    kernels["seg_pool_backward"] = dict(k1_rows["seg_pool_backward"],
                                        launches=train_launches["seg_pool_backward"])
    ki_b = kn.clamp(-w, w).to(torch.int32)
    fr_b = (-shifts - kn).float()
    g2_g = g2.reshape(r, w, nb, ctot // nb).permute(0, 2, 3, 1).reshape(r * nb, ctot // nb, 1, w)
    xs_b = (torch.arange(w, device=dev, dtype=torch.float32)[None, :]
            + (ki_b.float() + fr_b).reshape(-1, 1))
    grid_b = torch.stack([(2 * xs_b + 1) / w - 1, torch.zeros_like(xs_b)], -1)[:, None]
    lib_b = torch.nn.functional.grid_sample(g2_g, grid_b, mode="bilinear", padding_mode="zeros",
                                            align_corners=False)
    lib_b_err = float((lib_b.reshape(r, nb, ctot // nb, w).permute(0, 3, 1, 2).reshape(r, w, ctot)
                       - k2_want_g).abs().max())
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
    kernels["row_shift"] = k3_entry
    kernels["nn"] = k4_entry
    kernels["seg_pool_bf16"] = dict(bf16_rows["seg_pool_bf16"], launches=nus_counts["K1-bf16"])
    kernels["row_shift_blocks_bf16"] = dict(bf16_rows["row_shift_blocks_bf16"],
                                            launches=nus_counts["K2-bf16"])
    kernels["seg_pool_bf16_waymo"] = dict(way_rows["seg_pool_bf16_waymo"],
                                          launches=way_counts["K1-bf16"])
    kernels["row_shift_blocks_bf16_waymo"] = dict(way_rows["row_shift_blocks_bf16_waymo"],
                                                  launches=way_counts["K2-bf16"])
    kernels["seg_pool_backward_bf16"] = dict(bf16_rows["seg_pool_backward_bf16"],
                                             launches=nus_train["counts"]["K1 bwd-bf16"])
    kernels["row_shift_blocks_backward_bf16"] = dict(
        bf16_rows["row_shift_blocks_backward_bf16"],
        launches=nus_train["counts"]["K2 bwd-bf16"])
    for name, per_rank in mesh["launches"].items():
        kernels[name]["mesh_launches"] = per_rank
    for kern in kernels.values():
        log(f"{kern['name']}: {kern['ms']:.4f} ms (bound {kern['bound_ms']:.4f} ms by "
            f"{kern['bound_by']}; plain {kern['plain_ms']:.4f} ms; library "
            f"{kern['library_ms']})")
    log(f"grid_sample yardstick max abs err vs plain: {lib_err:.2e}")
    log(f"forward_ms {fwd_ms:.3f} test_forward_ms {test_ms:.3f} "
        f"train_micro_step_ms {micro_med:.3f} "
        f"train_update_ms {statistics.median(update_ms):.3f} train_peak_gib {peak_gib:.3f} "
        + " ".join(f"nuscenes_{k}_ms {v:.3f}" for k, v in nus_ms.items())
        + f" nuscenes_train_bf16_ms {nus_train['bf16_ms']:.3f} nuscenes_train_f32_ms "
        f"{nus_train['f32_ms']:.3f} nuscenes_train_bf16_gib {nus_train['bf16_gib']:.3f} "
        f"nuscenes_train_f32_gib {nus_train['f32_gib']:.3f} "
        + " ".join(f"serve_{c}_{k} {v:.3f}" for c, r in serve_ms.items() for k, v in r.items())
        + " " + " ".join(f"option_{k}_ms {v:.3f}" for k, v in opt_ms.items())
        + " " + " ".join(f"nuscenes_full_{k}_ms {v:.3f}" for k, v in nus_full_ms.items())
        + " " + " ".join(f"nuscenes_train_{k} {v:.3f}" for k, v in remat.items())
        + " " + " ".join(f"train_{k} {v:.3f}" for k, v in det_ms.items())
        + f" nuscenes_ddp_world1_ms {ddp['ddp_ms']:.3f} nuscenes_plain_ms {ddp['plain_ms']:.3f} "
        + f"train_from_scratch_s {scratch['seconds']:.3f} "
        + " ".join(f"waymo_{k}_ms {v:.3f}" for k, v in way_ms.items())
        + f" waymo_train_bf16_ms {way_train['bf16_ms']:.3f} waymo_train_f32_ms "
        f"{way_train['f32_ms']:.3f} waymo_train_bf16_gib {way_train['bf16_gib']:.3f} "
        f"waymo_train_f32_gib {way_train['f32_gib']:.3f} "
        + " ".join(f"{k} {v:.3f}" for k, v in fixture.items()) + " "
        + " ".join(f"{k} {v:.3f}" for k, v in mesh["ms"].items()) + " "
        + " ".join(f"prep_{c}_{p}_ms {r['total']:.3f}" for c, rows in host_prep.items()
                   for p, r in rows.items())
        + f" on {smi}")

    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
