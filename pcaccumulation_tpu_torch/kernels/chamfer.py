"""Nearest neighbour over valid references: kernel K4, its plain version,
and the Chamfer distance built on it.

`nn(a, b, b_valid)` solves P problems at once: for each query a[p, i] the
squared distance to the nearest valid reference b[p, j] and its index j,
the first one on ties; with no valid reference, 1e30 and index 0. On a CUDA
tensor it launches the kernel of `csrc/nn.cu` (which replaces the TPU kernel
`pcaccumulation_tpu/kernels/chamfer.py::nn_pallas`); on a CPU tensor it runs
`nn_plain`, the formula of the JAX package's `nn_bruteforce_ref`.

The two round differently: the kernel computes sum (a - b)^2, which is
exact to about one ulp of the distance, where the plain version expands
|a|^2 + |b|^2 - 2 a.b, whose error is about an ulp of |a|^2 + |b|^2
(2.4e-4 at 50 m from the origin). Where two references lie within that of
each other, the two may pick different ones.

`chamfer_distance` is the JAX package's bidirectional custom-VJP Chamfer
distance: two `nn` calls forward, a scatter through the argmins backward.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from pcaccumulation_tpu_torch.kernels import build

_BIG = 1e30  # the distance of a query with no valid reference
_BLOCK_ELEMS = 2 ** 25  # pair distances the plain version holds at once


def _pack_valid(b: torch.Tensor, b_valid: torch.Tensor):
    """Each problem's valid references moved to the front of its row in
    their order (a stable sort on the mask): (order [P, M] of original
    indices, packed b [P, M, 3], valid counts [P] int32)."""
    p, m, _ = b.shape
    order = torch.sort((~b_valid).to(torch.uint8), dim=1, stable=True).indices
    packed = torch.gather(b, 1, order[..., None].expand(p, m, 3)).contiguous()
    return order, packed, b_valid.sum(1, dtype=torch.int32)


def nn_plain(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor):
    """Plain PyTorch version: |a|^2 + |b|^2 - 2 a.b as a float32 product,
    invalid references at 1e30, min and first argmin. It skips the columns
    past the largest valid count (after the packing `nn` does; the order of
    the valid ones is kept, so the first argmin is the same) and works over
    blocks of queries, holding at most 2^25 pair distances at once."""
    p, n, _ = a.shape
    order, packed, count = _pack_valid(b, b_valid)
    m = int(count.max()) if p else 0  # a host read: the plain version only
    if m == 0:
        return (a.new_full((p, n), _BIG),
                torch.zeros((p, n), dtype=torch.int32, device=a.device))
    b, b_valid = packed[:, :m], torch.arange(m, device=a.device)[None] < count[:, None]
    b_norm = (b * b).sum(-1)[:, None, :]  # [P, 1, M]
    block = max(1, _BLOCK_ELEMS // (p * m))
    dists, idxs = [], []
    for s in range(0, n, block):
        q = a[:, s:s + block]
        d2 = ((q * q).sum(-1)[..., None] + b_norm
              - 2.0 * torch.matmul(q, b.transpose(-1, -2)))
        d2 = torch.where(b_valid[:, None, :], d2, _BIG)
        d, i = torch.min(d2, dim=-1)  # the first index on ties
        dists.append(d)
        idxs.append(i)
    idx = torch.gather(order, 1, torch.cat(idxs, 1))  # a problem with none: order[p, 0] = 0
    return torch.cat(dists, 1), idx.to(torch.int32)


def nn(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor):
    """a [P, N, 3], b [P, M, 3] float32, b_valid [P, M] bool ->
    (d2 [P, N] float32, idx [P, N] int32).

    A CPU tensor goes to the plain version; a CUDA tensor goes to the
    kernel or raises. Before the launch each problem's valid references
    are packed to the front of its row in their order (a stable sort on
    the mask), so the kernel loops over those alone; the index is mapped
    back after it.
    """
    if a.dim() != 3 or b.dim() != 3 or a.shape[-1] != 3 or b.shape[-1] != 3 \
            or a.shape[0] != b.shape[0] or b_valid.shape != b.shape[:2]:
        raise ValueError(f"nn wants a [P, N, 3], b [P, M, 3], b_valid [P, M]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(b_valid.shape)}")
    if a.device.type == "cpu":
        return nn_plain(a, b, b_valid)
    if a.device.type != "cuda" or b.device != a.device or b_valid.device != a.device:
        raise ValueError(f"nn: a on {a.device}, b on {b.device}, b_valid on {b_valid.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32 or b_valid.dtype != torch.bool:
        raise TypeError(f"nn kernel takes float32 points and a bool mask, got {a.dtype}, "
                        f"{b.dtype}, {b_valid.dtype}")
    p, n, _ = a.shape
    m = b.shape[1]
    order, packed, count = _pack_valid(b, b_valid)
    a = a.contiguous()
    d2 = torch.empty((p, n), dtype=torch.float32, device=a.device)
    idx = torch.empty((p, n), dtype=torch.int32, device=a.device)
    lib = build.load_library("nn")
    rc = lib.nn_forward(a.data_ptr(), packed.data_ptr(), count.data_ptr(), d2.data_ptr(),
                        idx.data_ptr(), p, n, m,
                        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(rc, "nn")
    nn.launches += 1
    # with no valid reference the kernel's index 0 maps to order[p, 0] = 0
    return d2, torch.gather(order, 1, idx.long()).to(torch.int32)


nn.launches = 0  # kernel launches (one per call that reached the card)


class ChamferDistance(torch.autograd.Function):
    """The JAX package's `chamfer_distance` custom VJP over P problems:
    d(dist_a[i])/da[i] = 2 (a[i] - b[nn_a[i]]), and the cross terms add
    -2 (b[j] - a[nn_b[j]]) into a[nn_b[j]] (and the same with a and b
    swapped)."""

    @staticmethod
    def forward(ctx, a, b, a_valid, b_valid):
        d_a, i_a = nn(a, b, b_valid)
        d_b, i_b = nn(b, a, a_valid)
        ctx.save_for_backward(a, b, a_valid, b_valid, i_a, i_b)
        return torch.where(a_valid, d_a, 0.0), torch.where(b_valid, d_b, 0.0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_a, g_b):
        a, b, a_valid, b_valid, i_a, i_b = ctx.saved_tensors
        p, n, _ = a.shape
        m = b.shape[1]
        g_a = g_a * a_valid.to(g_a.dtype)
        g_b = g_b * b_valid.to(g_b.dtype)
        rows = torch.arange(p, device=a.device)[:, None]
        flat_a = (rows * n + i_b.long()).reshape(-1)  # rows of a that b's queries hit
        flat_b = (rows * m + i_a.long()).reshape(-1)
        diff_a = a - torch.gather(b, 1, i_a.long()[..., None].expand(p, n, 3))  # [P, N, 3]
        diff_b = b - torch.gather(a, 1, i_b.long()[..., None].expand(p, m, 3))  # [P, M, 3]
        ga = 2.0 * diff_a * g_a[..., None]
        gb = 2.0 * diff_b * g_b[..., None]
        da = ga.reshape(p * n, 3).index_add(0, flat_a, -gb.reshape(p * m, 3))
        db = gb.reshape(p * m, 3).index_add(0, flat_b, -ga.reshape(p * n, 3))
        return da.reshape(p, n, 3), db.reshape(p, m, 3), None, None


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, a_valid: torch.Tensor,
                     b_valid: torch.Tensor):
    """Bidirectional squared nearest-neighbour distance.

    a [N, 3] or [P, N, 3], b [M, 3] or [P, M, 3] float32; *_valid bool
    masks of their rows. Returns (dist_a, dist_b) of a's and b's row
    shapes; invalid rows get 0. Two `nn` calls; differentiable in a and b
    (`ChamferDistance`).
    """
    if a.dim() == 2:
        d_a, d_b = ChamferDistance.apply(a[None], b[None], a_valid[None], b_valid[None])
        return d_a[0], d_b[0]
    return ChamferDistance.apply(a, b, a_valid, b_valid)
