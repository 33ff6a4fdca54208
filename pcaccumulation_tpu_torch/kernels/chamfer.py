"""Nearest neighbour over valid references: kernel K4, its plain version,
and the Chamfer distance built on it.

`nn(a, b, b_valid, a_valid=None)` solves P problems at once: for each query
a[p, i] the squared distance to the nearest valid reference b[p, j] and its
index j, the first one on ties; with no valid reference, 1e30 and index 0.
With `a_valid`, only those queries are asked for and the others get (1e30,
0). On a CUDA tensor it launches the kernel of `csrc/nn.cu` (which replaces
the TPU kernel `pcaccumulation_tpu/kernels/chamfer.py::nn_pallas`); on a CPU
tensor it runs `nn_plain`, the formula of the JAX package's
`nn_bruteforce_ref`.

`nn` is two steps, which a caller that asks many times against the same
points (ICP) takes apart: `pack_references` / `pack_queries` move each
problem's valid rows to the front of its row in their order (a stable sort
on the mask) and count them and take the largest count, on the device,
and `nn_packed` computes on the packed rows, through the PyTorch operator
`torch.ops.pcacc.nn_packed` (`nn_packed_op`, which writes into its outputs
d2 and idx). Nothing is read to the host: the kernel's blocks read the
counts on the device, so a traced graph (`torch.export`) can hold the
call. `nn_scratch` gives the kernel's merge scratch, which a caller in a
loop allocates once.

The two versions round differently: the kernel computes sum (a - b)^2,
which is exact to about one ulp of the distance, where the plain version
expands |a|^2 + |b|^2 - 2 a.b, whose error is about an ulp of |a|^2 + |b|^2
(2.4e-4 at 50 m from the origin). Where two references lie within that of
each other, the two may pick different ones.

`chamfer_distance` is the JAX package's bidirectional custom-VJP Chamfer
distance: two `nn` calls forward, a scatter through the argmins backward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pcaccumulation_tpu_torch.kernels import build

_BIG = 1e30  # the distance of a query with no valid reference
_BLOCK_ELEMS = 2 ** 25  # pair distances the plain version holds at once
_SLICE = 2048  # references per kernel block (nn.cu's SLICE)


class References(NamedTuple):
    """Each problem's valid references first, in their order."""
    points: torch.Tensor  # [P, M, 4] float32: x, y, z, 0
    order: torch.Tensor   # [P, M] int32: the original index of each packed row
    count: torch.Tensor   # [P] int32: valid references
    top: torch.Tensor     # [] int32: the largest count, on the device


class Queries(NamedTuple):
    """Each problem's asked-for queries first, in their order."""
    valid: torch.Tensor   # [P, N] bool
    order: torch.Tensor   # [P, N] int32: the original index of each packed row
    count: torch.Tensor   # [P] int32: asked-for queries
    top: torch.Tensor     # [] int32: the largest count, on the device


def _valid_first(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order [P, K] int32: the True rows' indices first, in their order,
    then the others; count [P] int32 of True rows; their largest, [] int32),
    all on the mask's device."""
    order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices
    count = mask.sum(1, dtype=torch.int32)
    return order.to(torch.int32), count, count.amax() if len(count) else count.new_zeros(())


def pack_references(b: torch.Tensor, b_valid: torch.Tensor) -> References:
    """b [P, M, 3], b_valid [P, M] bool -> `References`."""
    p, m, _ = b.shape
    order, count, top = _valid_first(b_valid)
    packed = torch.gather(b, 1, order.long()[..., None].expand(p, m, 3))
    return References(F.pad(packed, (0, 1)).contiguous(), order, count, top)


def pack_queries(a_valid: torch.Tensor) -> Queries:
    """a_valid [P, N] bool -> `Queries`."""
    return Queries(a_valid, *_valid_first(a_valid))


def _check(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
           a_valid: torch.Tensor | None) -> None:
    if a.dim() != 3 or b.dim() != 3 or a.shape[-1] != 3 or b.shape[-1] != 3 \
            or a.shape[0] != b.shape[0] or b_valid.shape != b.shape[:2] \
            or (a_valid is not None and a_valid.shape != a.shape[:2]):
        raise ValueError(f"nn wants a [P, N, 3], b [P, M, 3], b_valid [P, M], a_valid [P, N]; "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, {tuple(b_valid.shape)}, "
                         f"{None if a_valid is None else tuple(a_valid.shape)}")


def _plain_packed(a: torch.Tensor, refs: References, queries: Queries | None):
    """The plain version on packed references: |a|^2 + |b|^2 - 2 a.b as a
    float32 product, invalid references at 1e30, min and first argmin,
    over every query; then (1e30, 0) where a query is not asked for. It
    skips the columns past the largest valid count, read to the host (the
    order of the valid ones is kept, so the first argmin is the same), and
    works over blocks of queries, holding at most 2^25 pair distances at
    once."""
    p, n, _ = a.shape
    count, m = refs.count, int(refs.top)
    if m == 0:
        return (a.new_full((p, n), _BIG),
                torch.zeros((p, n), dtype=torch.int32, device=a.device))
    b = refs.points[:, :m, :3].contiguous()
    b_valid = torch.arange(m, device=a.device)[None] < count[:, None]
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
    # a problem with none: order[p, 0] = 0
    d2, idx = torch.cat(dists, 1), torch.gather(refs.order.long(), 1, torch.cat(idxs, 1))
    if queries is not None:
        d2 = torch.where(queries.valid, d2, _BIG)
        idx = torch.where(queries.valid, idx, 0)
    return d2, idx.to(torch.int32)


def nn_plain(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
             a_valid: torch.Tensor | None = None):
    """Plain PyTorch version of `nn` (see `_plain_packed`)."""
    return _plain_packed(a, pack_references(b, b_valid),
                         None if a_valid is None else pack_queries(a_valid))


def nn_scratch(refs: References, n: int) -> torch.Tensor | None:
    """The kernel's merge scratch for queries of n rows against `refs`:
    [ceil(M / 2048), P, N, 2] int32 when the capacity M spans several
    slices, else None (also on the CPU)."""
    p, m, _ = refs.points.shape
    slices = -(-m // _SLICE)
    if refs.points.device.type != "cuda" or slices <= 1:
        return None
    return torch.empty((slices, p, n, 2), dtype=torch.int32, device=refs.points.device)


@torch.library.custom_op("pcacc::nn_packed", mutates_args=("d2", "idx", "part"),
                         device_types="cuda")
def nn_packed_op(a: torch.Tensor, ref_points: torch.Tensor, ref_order: torch.Tensor,
                 ref_count: torch.Tensor, ref_top: torch.Tensor, q_valid: torch.Tensor | None,
                 q_order: torch.Tensor | None, q_count: torch.Tensor | None,
                 q_top: torch.Tensor | None, d2: torch.Tensor, idx: torch.Tensor,
                 part: torch.Tensor | None) -> None:
    """K4 as a PyTorch operator (`torch.ops.pcacc.nn_packed`): `nn_packed`
    on the fields of `References` and `Queries` (q_* None: every query),
    written into d2 [P, N] float32 and idx [P, N] int32, with `part` the
    merge scratch of `nn_scratch`. On CUDA tensors: the kernel (no host
    read), one count on `nn.launches`; a failed build or launch raises. On
    CPU tensors: the plain version."""
    p, n, _ = a.shape
    m = ref_points.shape[1]
    if m == 0:  # no reference row at all
        d2.fill_(_BIG)
        idx.zero_()
        return
    slices = -(-m // _SLICE)
    if (part is None) != (slices == 1) or (
            part is not None and tuple(part.shape) != (slices, p, n, 2)):
        raise ValueError(f"nn: merge scratch {None if part is None else tuple(part.shape)} "
                         f"for {slices} slices of {p} x {n} queries (see nn_scratch)")
    a = a.contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = build.load_library("nn").nn_forward(
        a.data_ptr(), ref_points.data_ptr(), ref_count.data_ptr(), ref_order.data_ptr(),
        ref_top.data_ptr(), ptr(q_order), ptr(q_count), ptr(q_top), d2.data_ptr(),
        idx.data_ptr(), ptr(part), p, n, m, _SLICE, build.stream(a))
    build.check(rc, "nn")
    nn.launches += 1


@nn_packed_op.register_kernel("cpu")
def _nn_packed_cpu(a, ref_points, ref_order, ref_count, ref_top, q_valid, q_order, q_count,
                   q_top, d2, idx, part) -> None:
    refs = References(ref_points, ref_order, ref_count, ref_top)
    queries = None if q_order is None else Queries(q_valid, q_order, q_count, q_top)
    got = _plain_packed(a, refs, queries)
    d2.copy_(got[0])
    idx.copy_(got[1])


@nn_packed_op.register_fake
def _nn_packed_fake(a, ref_points, ref_order, ref_count, ref_top, q_valid, q_order, q_count,
                    q_top, d2, idx, part) -> None:
    return None


def nn_packed(a: torch.Tensor, refs: References, queries: Queries | None = None,
              out: tuple[torch.Tensor, torch.Tensor] | None = None,
              part: torch.Tensor | None = None):
    """`nn` on references (and asked-for queries) packed beforehand: a
    [P, N, 3] float32 -> (d2 [P, N] float32, idx [P, N] int32), written
    into `out` if given, with `part` as the kernel's merge scratch if given
    (`nn_scratch`; a caller in a loop, such as ICP, allocates both once).

    A CPU tensor goes to the plain version; a CUDA tensor goes to the
    kernel or raises (the operator `nn_packed_op`). The kernel walks the
    valid references only, and only the asked-for queries; it maps the
    index back through `refs.order`.
    """
    p, n, k = a.shape
    if k != 3 or p != refs.points.shape[0] \
            or (queries is not None and queries.valid.shape != (p, n)):
        raise ValueError(f"nn_packed: a {tuple(a.shape)} against references "
                         f"{tuple(refs.points.shape)}")
    dev = a.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"nn: a on {dev}")
    if refs.points.device != dev or (queries is not None and queries.order.device != dev):
        raise ValueError(f"nn: a on {dev}, references on {refs.points.device}")
    if dev.type == "cuda" and (a.dtype != torch.float32 or refs.points.dtype != torch.float32):
        raise TypeError(f"nn kernel takes float32 points, got {a.dtype}, {refs.points.dtype}")
    if out is None:
        out = (torch.empty((p, n), dtype=a.dtype, device=dev),
               torch.empty((p, n), dtype=torch.int32, device=dev))
    if part is None:
        part = nn_scratch(refs, n)
    q = (None, None, None, None) if queries is None else queries
    nn_packed_op(a, *refs, *q, *out, part)
    return out


def nn(a: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor,
       a_valid: torch.Tensor | None = None):
    """a [P, N, 3], b [P, M, 3] float32, b_valid [P, M] bool, a_valid
    [P, N] bool or None (every query) -> (d2 [P, N] float32, idx [P, N]
    int32).

    A CPU tensor goes to the plain version; a CUDA tensor goes to the
    kernel or raises. Packs the references (and the queries) and calls
    `nn_packed`.
    """
    _check(a, b, b_valid, a_valid)
    if a.device.type == "cuda" and b_valid.dtype != torch.bool:
        raise TypeError(f"nn kernel takes a bool mask, got {b_valid.dtype}")
    return nn_packed(a, pack_references(b, b_valid),
                     None if a_valid is None else pack_queries(a_valid))


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
