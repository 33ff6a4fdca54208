"""Segment reduce-broadcast over sorted ids: kernel K1 and its plain version.

`seg_pool(x, ids, op)` returns [N, C] where row i holds the `op`-reduce
(max or sum) over all rows sharing ids[i]; ids are non-decreasing. It is
the fused scatter-reduce + gather-back of PillarFeatureNet's local pooling.
On a CUDA tensor it launches the kernel of `csrc/segscan.cu` (which replaces
the TPU kernel `pcaccumulation_tpu/kernels/segscan.py::_seg_pool_impl`); on
a CPU tensor it runs `seg_pool_plain`.
"""

from __future__ import annotations

import torch

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


def seg_pool(x: torch.Tensor, ids: torch.Tensor, op: str = "max") -> torch.Tensor:
    """x [N, C] float32, ids [N] int32 non-decreasing -> [N, C].

    A CPU tensor goes to the plain version (after a check that the ids are
    sorted); a CUDA tensor goes to the kernel or raises. Max is exact;
    sum adds in another order than the plain version (float32 rounding,
    relative 1e-6 per term).
    """
    if op not in ("max", "sum"):
        raise ValueError(f"op must be 'max' or 'sum', got {op!r}")
    if x.dim() != 2 or ids.shape != x.shape[:1]:
        raise ValueError(f"seg_pool wants x [N, C] and ids [N], got {tuple(x.shape)}, "
                         f"{tuple(ids.shape)}")
    if x.device.type == "cpu":
        if ids.numel() > 1 and bool((ids[1:] < ids[:-1]).any()):
            raise ValueError("seg_pool needs non-decreasing ids")
        return seg_pool_plain(x, ids, op)
    if x.device.type != "cuda" or ids.device != x.device:
        raise ValueError(f"seg_pool: x on {x.device}, ids on {ids.device}")
    if x.requires_grad:
        raise RuntimeError("seg_pool: backward kernel lands with the training slice")
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
    seg_pool.launches += 1
    return out


seg_pool.launches = 0  # kernel launches (one per call that reached the card)
