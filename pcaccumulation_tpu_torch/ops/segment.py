"""Fixed-capacity segment reductions (the port of the JAX package's
`ops/segment.py`).

Every op takes a static `num_segments`; invalid rows are masked, and ids
outside [0, num_segments) are redirected to a spare row that is dropped, as
JAX's `mode="drop"` scatters drop them (an out-of-range index on the card
would be a device-side assert). Both max reductions split the gradient
evenly among tied maxima, as the JAX package's do.
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


def masked_segment_sum(data, segment_ids, valid, num_segments: int):
    """data [N, ...] summed into [num_segments, ...] over valid rows.

    `index_put_` with `accumulate` sums on the card after a stable sort of
    the ids, each segment in row order, with no atomics: two calls give the
    same bits (`index_add_`'s atomics add in an order that changes from run
    to run, and a flipped decision downstream follows from an ulp)."""
    masked = data * _rows(valid, data).to(data.dtype)
    out = data.new_zeros((num_segments + 1,) + data.shape[1:])
    out.index_put_((_safe_ids(segment_ids, num_segments),), masked, accumulate=True)
    return out[:num_segments]


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
        nties = torch.zeros(out.shape, dtype=acc, device=out.device).index_add_(
            0, flat, winner.to(acc))
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
    Stable partition via two cumsums: selected indices first (ascending),
    then unselected filler, truncated at s_cap. The rows are a prefix of a
    permutation of arange(N), hence distinct. Overflow rows beyond s_cap
    True rows are not selected.
    """
    b, n = mask.shape
    sel_cum = torch.cumsum(mask.long(), dim=1)  # 1-based rank among selected
    count = sel_cum[:, -1:]
    idx = torch.arange(n, device=mask.device)[None].expand(b, n)
    unsel_rank = (idx + 1) - sel_cum
    dest = torch.where(mask, sel_cum - 1, count + unsel_rank - 1)  # permutation
    dest = torch.where(dest < s_cap, dest, s_cap)  # beyond the capacity: dropped
    sel = torch.zeros((b, s_cap + 1), dtype=torch.long, device=mask.device)
    sel.scatter_(1, dest, idx)
    sel_valid = idx[:, :s_cap] < count
    return sel[:, :s_cap], sel_valid


def take_rows_unique(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: arr [B, N, ...], idx [B, S] in [0, N) -> [B, S, ...]."""
    expand = idx.reshape(idx.shape + (1,) * (arr.dim() - 2)).expand(
        idx.shape + arr.shape[2:])
    return torch.gather(arr, 1, expand)
