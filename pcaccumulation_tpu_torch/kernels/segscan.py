"""Segment reduce-broadcast over sorted ids: kernel K1, its gradient and
their plain versions.

`seg_pool(x, ids, op)` returns [N, C] where row i holds the `op`-reduce
(max or sum) over all rows sharing ids[i]; ids are non-decreasing. It is
the fused scatter-reduce + gather-back of PillarFeatureNet's local pooling.
On a CUDA tensor it launches the kernel of `csrc/segscan.cu` (which replaces
the TPU kernel `pcaccumulation_tpu/kernels/segscan.py::_seg_pool_impl`); on
a CPU tensor it runs `seg_pool_plain`.

Its gradient (`SegPool`, the JAX package's `_seg_pool_bwd`) is one more
sum-pool launch of the same kernel: for max, over the cotangent packed
beside the tie mask ([N, 2C]), whose sums split each segment's cotangent
evenly among its tied maxima; for sum, over the cotangent.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from pcaccumulation_tpu_torch.kernels import build


def seg_pool_plain(x: torch.Tensor, ids: torch.Tensor, op: str = "max") -> torch.Tensor:
    """Plain PyTorch version: reduce each run of equal ids into a table
    indexed by run number (`scatter_reduce`), then gather it back."""
    n = ids.shape[0]
    new_run = torch.ones(n, dtype=torch.bool, device=ids.device)
    new_run[1:] = ids[1:] != ids[:-1]
    run = torch.cumsum(new_run, 0) - 1  # [N] run number, < N
    table = torch.zeros_like(x).scatter_reduce(
        0, run[:, None].expand_as(x), x,
        reduce="amax" if op == "max" else "sum", include_self=False,
    )
    return table[run]


def _pool(x: torch.Tensor, ids: torch.Tensor, op: str) -> tuple[torch.Tensor, bool]:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor.
    Returns (out, launched)."""
    if x.device.type == "cpu":
        return seg_pool_plain(x, ids, op), False
    if x.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"seg_pool kernel takes float32 x and int32 ids, got {x.dtype}, "
                        f"{ids.dtype}")
    x = x.contiguous()
    ids = ids.contiguous()
    n, c = x.shape
    table = torch.full_like(x, float("-inf") if op == "max" else 0.0)
    out = torch.empty_like(x)
    lib = build.load_library("segscan")
    rc = lib.segpool_forward(
        x.data_ptr(), ids.data_ptr(), table.data_ptr(), out.data_ptr(), n, c,
        0 if op == "max" else 1, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "segscan")
    return out, True


def seg_pool_backward_plain(x, ids, y, g, op: str = "max") -> torch.Tensor:
    """Plain version of the gradient; see `seg_pool_backward`."""
    return _backward(x, ids, y, g, op, seg_pool_plain)


def _backward(x, ids, y, g, op, sum_pool) -> torch.Tensor:
    if op == "sum":
        return sum_pool(g.float(), ids, "sum")
    c = x.shape[1]
    tie = x == y
    packed = torch.cat([g.float(), tie.float()], dim=-1)  # [N, 2C]
    ps = sum_pool(packed, ids, "sum")
    gs, nt = ps[:, :c], ps[:, c:]
    return torch.where(tie, gs / torch.clamp(nt, min=1.0), 0.0).to(x.dtype)


def seg_pool_backward(x: torch.Tensor, ids: torch.Tensor, y: torch.Tensor,
                      g: torch.Tensor, op: str = "max") -> torch.Tensor:
    """Gradient of `seg_pool` for the cotangent g [N, C] of its output y.

    Max: every row that ties its segment's maximum gets the segment's
    cotangent sum divided by the number of tied rows, other rows zero (the
    even split of JAX's segment_max gradient). Sum: the segment's cotangent
    sum. One K1 sum launch on a CUDA tensor; the plain sum-pool on a CPU
    tensor.
    """

    def sum_pool(a, i, op_):
        out, launched = _pool(a, i, op_)
        seg_pool_backward.launches += launched
        return out

    return _backward(x, ids, y, g, op, sum_pool)


class SegPool(torch.autograd.Function):
    """`seg_pool` with its gradient. On the CPU the same Function runs the
    plain versions, so CPU and card split ties the same way."""

    @staticmethod
    def forward(ctx, x, ids, op):
        y, launched = _pool(x, ids, op)
        seg_pool.launches += launched
        ctx.op = op
        ctx.save_for_backward(x, ids, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, ids, y = ctx.saved_tensors
        return seg_pool_backward(x, ids, y, g, ctx.op), None, None


def seg_pool(x: torch.Tensor, ids: torch.Tensor, op: str = "max") -> torch.Tensor:
    """x [N, C] float32, ids [N] int32 non-decreasing -> [N, C].

    A CPU tensor goes to the plain version (after a check that the ids are
    sorted); a CUDA tensor goes to the kernel or raises. Max is exact;
    sum adds in another order than the plain version (float32 rounding,
    relative 1e-6 per term). Differentiable in x through `SegPool`.
    """
    if op not in ("max", "sum"):
        raise ValueError(f"op must be 'max' or 'sum', got {op!r}")
    if x.dim() != 2 or ids.shape != x.shape[:1]:
        raise ValueError(f"seg_pool wants x [N, C] and ids [N], got {tuple(x.shape)}, "
                         f"{tuple(ids.shape)}")
    if x.device.type == "cpu":
        if ids.numel() > 1 and bool((ids[1:] < ids[:-1]).any()):
            raise ValueError("seg_pool needs non-decreasing ids")
    elif x.device.type != "cuda" or ids.device != x.device:
        raise ValueError(f"seg_pool: x on {x.device}, ids on {ids.device}")
    return SegPool.apply(x, ids, op)


seg_pool.launches = 0  # forward kernel launches (one per call that reached the card)
seg_pool_backward.launches = 0  # gradient kernel launches (one per backward on the card)
