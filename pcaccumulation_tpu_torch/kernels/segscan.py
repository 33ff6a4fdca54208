"""Segment reduce-broadcast over sorted ids: kernel K1, its gradient and
their plain versions.

`seg_pool(x, ids, op)` returns [N, C] where row i holds the `op`-reduce
(max or sum) over all rows sharing ids[i]; ids are non-decreasing. It is
the fused scatter-reduce + gather-back of PillarFeatureNet's local pooling.
On a CUDA tensor it calls the C entry point `segpool_forward` of
`csrc/segscan.cu` (which replaces the TPU kernel
`pcaccumulation_tpu/kernels/segscan.py::_seg_pool_impl`): two launches, the
partials of the runs that cross a tile edge and then each tile reduced and
written once, with no [N, C] table and no atomics, so that two calls give
the same bits; on a CPU tensor it runs `seg_pool_plain`. The forward is the
PyTorch operator `torch.ops.pcacc.seg_pool` (`seg_pool_op`), so that a
graph recorded by `torch.export` calls it: its CUDA implementation is the
launch and its count, its CPU implementation the plain version.

x may be float32 or bfloat16. A bf16 x goes to the bf16 kernel
(`segpool_forward_bf16`, the TPU kernel's bf16 case, the one the pillar
encoder runs under `precision.compute_dtype: bfloat16`): rows widened to
float32 where they are loaded, reduced in float32 and rounded to bf16 once
at the store; the plain version computes in float32 and casts once. It is
never cast to float32 for the float32 kernel. At C = 32 with aligned rows
(the pillar encoder's) the bf16 kernels are their own design for Hopper:
one pass that stages each tile in shared memory by bulk copies and writes
the runs inside it, then the runs that cross a tile edge (csrc/segscan.cu). Its launches count on
`seg_pool.launches_bf16`, the float32 kernel's on `seg_pool.launches`.

Its gradient (`SegPool`, the JAX package's `_seg_pool_bwd`) is one fused
kernel of the same two-launch shape, `segpool_backward_max`: it reads x, y
and g once, sums g and the tie mask (x == y) over each segment, and writes
tie ? sum(g) / max(ties, 1) : 0, the even split of each segment's cotangent
among its tied maxima, with no pack or [N, C] temporary. For sum the
gradient is the forward's sum-pool of g. On bf16 rows (the pillar
encoder's backward under `precision.compute_dtype: bfloat16`) it is
`segpool_backward_max_bf16`: the sums and the division in float32 and one
rounding to bf16, as `_seg_pool_bwd` computes them, never a cast of its
inputs to float32 for the float32 kernel; for sum, the bf16 forward's sum.
Its launches count on `seg_pool_backward.launches_bf16`, the float32
kernel's on `seg_pool_backward.launches`.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from pcaccumulation_tpu_torch.kernels import build


def seg_pool_plain(x: torch.Tensor, ids: torch.Tensor, op: str = "max") -> torch.Tensor:
    """Plain PyTorch version: reduce each run of equal ids into a table
    indexed by run number (`scatter_reduce`), then gather it back. A bf16
    x is reduced in float32 and the result cast to bf16 once."""
    if x.dtype == torch.bfloat16:
        return seg_pool_plain(x.float(), ids, op).to(x.dtype)
    n = ids.shape[0]
    new_run = torch.ones(n, dtype=torch.bool, device=ids.device)
    new_run[1:] = ids[1:] != ids[:-1]
    run = torch.cumsum(new_run, 0) - 1  # [N] run number, < N
    table = torch.zeros_like(x).scatter_reduce(
        0, run[:, None].expand_as(x), x,
        reduce="amax" if op == "max" else "sum", include_self=False,
    )
    return table[run]


TILE_ROWS = 256  # rows of a tile: TILE in csrc/segscan.cu
TILE_THREADS = 256  # threads of a tile's block: THREADS in csrc/segscan.cu


def scratch_floats(n: int, c: int, dtype: torch.dtype, payload: int) -> int:
    """The float32 scratch a C entry point takes for [n, c] rows of dtype
    (payload 1: the forward, 2: the gradient of max, whose partials hold g
    and the tie count): two partials [n_tiles, payload, c] and the tile
    flags (`prepare` in csrc/segscan.cu); in bf16 also each tile's run
    bounds and, for the gradient, a word of tie bits per thread
    (`bf16_scratch_floats`). O(N / TILE_ROWS * C) floats."""
    n_tiles = -(-n // TILE_ROWS)
    if dtype == torch.bfloat16:
        return n_tiles * (2 * payload * c + 2 + (TILE_THREADS if payload == 2 else 0))
    return n_tiles * (2 * payload * c + 1)


def _scratch(x: torch.Tensor, payload: int) -> torch.Tensor:
    """The kernel's scratch for x (`scratch_floats`)."""
    n, c = x.shape
    return torch.empty(scratch_floats(n, c, x.dtype, payload), dtype=torch.float32,
                       device=x.device)


def _check_kernel_inputs(ids: torch.Tensor, *tensors: torch.Tensor,
                         dtypes=(torch.float32,)) -> None:
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"seg_pool kernel takes {', '.join(map(str, dtypes))}, got {t.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"seg_pool kernel takes int32 ids, got {ids.dtype}")
    n, c = tensors[0].shape
    if n * c >= 2 ** 31:
        raise ValueError(f"seg_pool kernel: [{n}, {c}] overflows its 32-bit element index")


def _launch_pool(x: torch.Tensor, ids: torch.Tensor, op: str) -> torch.Tensor:
    """One C call of the forward kernel of x's dtype on CUDA tensors; counts
    nothing (the caller does)."""
    x, ids = x.contiguous(), ids.contiguous()
    _check_kernel_inputs(ids, x, dtypes=(torch.float32, torch.bfloat16))
    n, c = x.shape
    out = torch.empty((n, c), dtype=x.dtype, device=x.device)
    scratch = _scratch(x, 1)
    lib = build.load_library("segscan")
    entry = lib.segpool_forward_bf16 if x.dtype == torch.bfloat16 else lib.segpool_forward
    rc = entry(
        x.data_ptr(), ids.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, c,
        0 if op == "max" else 1, build.stream(x))
    build.check(rc, "segscan")
    return out


@torch.library.custom_op("pcacc::seg_pool", mutates_args=(), device_types="cuda")
def seg_pool_op(x: torch.Tensor, ids: torch.Tensor, op: str) -> torch.Tensor:
    """The forward as a PyTorch operator (`torch.ops.pcacc.seg_pool`), so
    that `torch.export` records it in a graph. On CUDA tensors: the kernel
    of x's dtype, one launch on `seg_pool.launches` or `.launches_bf16`; a
    failed build or launch raises. On CPU tensors: the sortedness check and
    `seg_pool_plain`."""
    out = _launch_pool(x, ids, op)
    if x.dtype == torch.bfloat16:
        seg_pool.launches_bf16 += 1
    else:
        seg_pool.launches += 1
    return out


@seg_pool_op.register_kernel("cpu")
def _seg_pool_cpu(x: torch.Tensor, ids: torch.Tensor, op: str) -> torch.Tensor:
    if ids.numel() > 1 and bool((ids[1:] < ids[:-1]).any()):
        raise ValueError("seg_pool needs non-decreasing ids")
    return seg_pool_plain(x, ids, op)


@seg_pool_op.register_fake
def _seg_pool_fake(x: torch.Tensor, ids: torch.Tensor, op: str) -> torch.Tensor:
    return torch.empty_like(x)


def _backward_max(x, ids, y, g) -> torch.Tensor:
    """The fused gradient kernel of max of x's dtype on CUDA tensors (one
    C call); x, y and g share one dtype."""
    x, y, g, ids = x.contiguous(), y.contiguous(), g.contiguous(), ids.contiguous()
    _check_kernel_inputs(ids, x, dtypes=(torch.float32, torch.bfloat16))
    _check_kernel_inputs(ids, y, g, dtypes=(x.dtype,))
    n, c = x.shape
    out = torch.empty((n, c), dtype=x.dtype, device=x.device)
    scratch = _scratch(x, 2)
    lib = build.load_library("segscan")
    entry = (lib.segpool_backward_max_bf16 if x.dtype == torch.bfloat16
             else lib.segpool_backward_max)
    rc = entry(x.data_ptr(), y.data_ptr(), g.data_ptr(), ids.data_ptr(), out.data_ptr(),
               scratch.data_ptr(), scratch.numel(), n, c, build.stream(x))
    build.check(rc, "segscan")
    return out


def seg_pool_backward_plain(x, ids, y, g, op: str = "max") -> torch.Tensor:
    """Plain version of the gradient; see `seg_pool_backward`. The sums and
    the division in float32 (float64 for a float64 x), the result rounded
    to x's dtype once, as `_seg_pool_bwd` casts it."""
    if op == "sum":
        return seg_pool_plain(g, ids, "sum").to(x.dtype)
    acc = torch.promote_types(x.dtype, torch.float32)
    gs = seg_pool_plain(g.to(acc), ids, "sum")
    tie = x == y
    nt = seg_pool_plain(tie.to(acc), ids, "sum")
    return torch.where(tie, gs / torch.clamp(nt, min=1.0), 0.0).to(x.dtype)


def seg_pool_backward(x: torch.Tensor, ids: torch.Tensor, y: torch.Tensor,
                      g: torch.Tensor, op: str = "max") -> torch.Tensor:
    """Gradient of `seg_pool` for the cotangent g [N, C] of its output y
    (one value per segment, as `seg_pool` gives it).

    Max: every row that ties its segment's maximum gets the segment's
    cotangent sum divided by the number of tied rows, other rows zero (the
    even split of JAX's segment_max gradient). Sum: the segment's cotangent
    sum. One C call on a CUDA tensor (the fused gradient kernel of x's
    dtype for max, the forward kernel's sum for sum), which counts on
    `seg_pool_backward.launches` (float32) or `.launches_bf16`; the plain
    version on a CPU tensor. In bf16, x, y and g are bf16 and the result is
    the float32 sum and division rounded to bf16 once.
    """
    if x.device.type == "cpu":
        return seg_pool_backward_plain(x, ids, y, g, op)
    out = _launch_pool(g, ids, "sum") if op == "sum" else _backward_max(x, ids, y, g)
    if x.dtype == torch.bfloat16:
        seg_pool_backward.launches_bf16 += 1
    else:
        seg_pool_backward.launches += 1
    return out


class SegPool(torch.autograd.Function):
    """`seg_pool` with its gradient. On the CPU the same Function runs the
    plain versions, so CPU and card split ties the same way."""

    @staticmethod
    def forward(ctx, x, ids, op):
        y = seg_pool_op(x, ids, op)
        ctx.op = op
        ctx.save_for_backward(x, ids, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, ids, y = ctx.saved_tensors
        return seg_pool_backward(x, ids, y, g, ctx.op), None, None


def seg_pool(x: torch.Tensor, ids: torch.Tensor, op: str = "max") -> torch.Tensor:
    """x [N, C] float32 or bfloat16, ids [N] int32 non-decreasing -> [N, C]
    in x's dtype.

    A CPU tensor goes to the plain version (after a check that the ids are
    sorted); a CUDA tensor goes to the kernel of its dtype or raises. Max is
    exact; sum adds in another order than the plain version (float32
    rounding, relative 1e-6 per term; a bf16 sum is rounded once at the
    end). Differentiable through `SegPool`, in either dtype.
    """
    if op not in ("max", "sum"):
        raise ValueError(f"op must be 'max' or 'sum', got {op!r}")
    if x.dim() != 2 or ids.shape != x.shape[:1]:
        raise ValueError(f"seg_pool wants x [N, C] and ids [N], got {tuple(x.shape)}, "
                         f"{tuple(ids.shape)}")
    if x.device.type not in ("cpu", "cuda") or ids.device != x.device:
        raise ValueError(f"seg_pool: x on {x.device}, ids on {ids.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return SegPool.apply(x, ids, op)
    return seg_pool_op(x, ids, op)  # no autograd node to build


seg_pool.launches = 0  # float32 forward kernel launches (one per call that reached the card)
seg_pool.launches_bf16 = 0  # bf16 forward kernel launches
seg_pool_backward.launches = 0  # float32 gradient launches (one per backward on the card)
seg_pool_backward.launches_bf16 = 0  # bf16 gradient launches
