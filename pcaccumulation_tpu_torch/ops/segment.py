"""Fixed-capacity segment reductions (the port of the JAX package's
`ops/segment.py`).

Every op takes a static `num_segments`; invalid rows are masked, and ids
outside [0, num_segments) are redirected to a spare row that is dropped, as
JAX's `mode="drop"` scatters drop them (an out-of-range index on the card
would be a device-side assert). Both max reductions split the gradient
evenly among tied maxima, as the JAX package's do.

Sums over segments, and the gradients of row gathers (`take_rows`), are
`sorted_segment_sum`. On the card it is a stable sort of the ids and a
segmented scan: the same bits on every call, with or without
`torch.use_deterministic_algorithms`, whatever the skew of the segments.
`index_put_` with `accumulate` (and `index_add_` and the backward of
`torch.gather` under deterministic algorithms) sorts too, but then walks
each segment's rows one after another in one warp: 2-21 ms per call on
the H100 on a few long segments, such as the background instance or the
rows a capacity drops. On the CPU it is `index_put_`'s one pass in row
order.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from pcaccumulation_tpu_torch.kernels.segscan import seg_pool

_NEG_INF = -1e30  # masking sentinel of invalid rows


def _rows(valid: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return valid.reshape((-1,) + (1,) * (data.dim() - 1))


def _safe_ids(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids = ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def _segment_scan_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The forward of `sorted_segment_sum`, without autograd."""
    n = ids.shape[0]
    if n == 0:
        return data.new_zeros((num_segments,) + data.shape[1:])
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    v = data[order].to(torch.promote_types(data.dtype, torch.float32))
    # inclusive segmented scan by doubling: after the pass at shift k, row i
    # holds the sum of its segment's rows i-2k+1 .. i (the ids are sorted,
    # so equal ids k apart enclose one segment)
    k = 1
    while k < n:
        same = _rows(sid[k:] == sid[:-k], v)
        v[k:] += torch.where(same, v[:-k], 0.0)
        k *= 2
    seg = torch.arange(num_segments, device=ids.device)
    ends = torch.searchsorted(sid, seg, right=True)
    full = ends > torch.searchsorted(sid, seg, right=False)
    out = torch.where(_rows(full, v), v[(ends - 1).clamp(min=0)], 0.0)
    return out.to(data.dtype)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        return _segment_scan_sum(data, ids, num_segments)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        # each row's cotangent is its segment's; dropped rows get zero
        g = torch.cat([g, g.new_zeros((1,) + g.shape[1:])])
        return g[ids.clamp(max=ctx.num_segments)], None, None


def sorted_segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """data [N, ...] summed per id into [num_segments, ...]; rows whose id is
    outside [0, num_segments) are dropped. On the card: a stable sort of the
    ids, an inclusive segmented scan over the sorted rows by doubling
    (ceil(log2 N) shifted adds: each segment's sum in one fixed order, in
    float32 for a bf16 input, rounded once) read at each segment's last
    row; its gradient is a gather of the cotangent. On the CPU, where
    `index_put_`'s accumulation is one deterministic pass in row order (the
    order of the JAX package's scatter-add on the CPU), that."""
    ids = _safe_ids(ids, num_segments)
    if data.device.type == "cpu":
        out = data.new_zeros((num_segments + 1,) + data.shape[1:])
        return out.index_put_((ids,), data, accumulate=True)[:num_segments]
    return _SegmentSum.apply(data, ids, num_segments)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, arr, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = arr.shape[0]
        return arr.index_select(0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return sorted_segment_sum(g, idx, ctx.num_rows), None


def take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, R, ...] at idx [B, N] in [0, R) -> [B, N, ...] (a batched
    `torch.gather` of rows). On the card its gradient sums the cotangent
    per row by `sorted_segment_sum`; on the CPU it is `torch.gather`'s."""
    if arr.device.type == "cpu":
        expand = idx.reshape(idx.shape + (1,) * (arr.dim() - 2)).expand(idx.shape + arr.shape[2:])
        return torch.gather(arr, 1, expand)
    b, r = arr.shape[:2]
    flat = (idx.long() + torch.arange(b, device=idx.device)[:, None] * r).reshape(-1)
    out = _TakeRows.apply(arr.reshape((b * r,) + arr.shape[2:]), flat)
    return out.reshape(idx.shape + arr.shape[2:])


def masked_segment_sum(data, segment_ids, valid, num_segments: int):
    """data [N, ...] summed into [num_segments, ...] over valid rows
    (`sorted_segment_sum`)."""
    ids = torch.where(valid.reshape(-1), segment_ids.long(), num_segments)
    return sorted_segment_sum(data, ids, num_segments)


class _SegmentMax(torch.autograd.Function):
    """Segment max of x [N, ...] into [num_rows, ...] (rows start at the
    masking sentinel) with the JAX package's winner-mask gradient
    (`ops/segment.py::_segment_max_core`): each row of x equal to its
    segment's max gets the segment's cotangent divided by the number of
    such rows. The sentinel start value is no candidate, as in JAX's
    segment_max, where `scatter_reduce`'s own gradient would count it. The
    tie count and the share are float32 for a bf16 x, and the result is
    rounded to x's dtype once, as the JAX package computes them."""

    @staticmethod
    def forward(ctx, x, idx, num_rows):
        out = x.new_full((num_rows,) + x.shape[1:], _NEG_INF)
        out = out.scatter_reduce(0, idx.expand_as(x), x, reduce="amax", include_self=True)
        ctx.save_for_backward(x, idx, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, idx, out = ctx.saved_tensors
        flat = idx.reshape(-1)
        winner = x == out[flat]
        acc = torch.promote_types(x.dtype, torch.float32)
        nties = sorted_segment_sum(winner.to(acc), flat, out.shape[0])
        share = g.to(acc) / torch.clamp(nties, min=1.0)
        return torch.where(winner, share[flat], 0.0).to(x.dtype), None, None


def masked_segment_max(data, segment_ids, valid, num_segments: int,
                       fill_value: float = 0.0):
    """Segment max over valid rows; empty segments get `fill_value`.
    Ties split the gradient evenly (`_SegmentMax`)."""
    masked = torch.where(_rows(valid, data), data, _NEG_INF)
    idx = _safe_ids(segment_ids, num_segments)
    idx = idx.reshape((-1,) + (1,) * (data.dim() - 1))
    out = _SegmentMax.apply(masked, idx, num_segments + 1)[:num_segments]
    return torch.where(out <= _NEG_INF * 0.5, fill_value, out)


def masked_segment_mean(data, segment_ids, valid, num_segments: int,
                        eps: float = 1e-12):
    total = masked_segment_sum(data, segment_ids, valid, num_segments)
    count = masked_segment_sum(valid.to(data.dtype), segment_ids, valid, num_segments)
    return total / torch.clamp(count, min=eps).reshape(
        (num_segments,) + (1,) * (data.dim() - 1))


def masked_seg_pool_max(data, seg_ids, valid, fill_value: float = 0.0):
    """Masked segment max broadcast back to every row, over SORTED seg_ids:
    `masked_segment_max(...)[seg_ids]` without a scatter. This is the call
    site of kernel K1 (kernels/segscan.py)."""
    masked = torch.where(_rows(valid, data), data, _NEG_INF)
    y = seg_pool(masked, seg_ids, "max")
    return torch.where(y <= _NEG_INF * 0.5, fill_value, y)


def compact_mask_indices(mask: torch.Tensor, s_cap: int):
    """Indices of a mask's True rows, compacted to a static capacity.

    mask [B, N] bool -> (sel [B, s_cap] int64, sel_valid [B, s_cap] bool).
    Stable partition: selected indices first (ascending), then unselected
    filler, truncated at s_cap. The rows are a prefix of a
    permutation of arange(N), hence distinct. Overflow rows beyond s_cap
    True rows are not selected.
    """
    # a stable sort on "not selected": the selected rows ascending, then the
    # others ascending (a scatter to these places would send every row past
    # the capacity to one dropped slot, which deterministic algorithms walk
    # row by row)
    sel = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :s_cap]
    count = mask.sum(dim=1, keepdim=True)
    sel_valid = torch.arange(s_cap, device=mask.device)[None] < count
    return sel, sel_valid


def take_rows_unique(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: arr [B, N, ...], idx [B, S] in [0, N) -> [B, S, ...]."""
    expand = idx.reshape(idx.shape + (1,) * (arr.dim() - 2)).expand(
        idx.shape + arr.shape[2:])
    return torch.gather(arr, 1, expand)
