"""Fixed-capacity density clustering of the moving points (the port of the
JAX package's `ops/cluster.py`, its DBSCAN substitute).

Voxel downsample (sort, first-occurrence flags, prefix sum), DBSCAN
connectivity as core-point label propagation over the <= eps adjacency with
pointer jumping, border points on their smallest core neighbour's label,
noise 0, clusters below a size dropped, ids renumbered 1..C. The functions
take one sample; `cluster_moving_points` is the whole test-time path.

Exactness against the JAX package: `torch.round` rounds half to even as
`jnp.round` does; the lexicographic sort is a chain of stable sorts, as
`jnp.lexsort` is stable; the neighbour pass uses the difference form
(dx^2 + dy^2) + dz^2 in the JAX package's order, so co-membership at the
eps boundary is the same. The propagation stops at its fixpoint, as the JAX
package's `while_loop` does: the port reads one flag back to the host after
each pass (one device sync per pass) instead of running all `n_iters`
passes; both give the same labels. A graph that `torch.export` records
cannot read that flag, so under export (`torch.compiler.is_exporting()`)
the propagation runs all `n_iters` passes: a pass at the fixpoint leaves
the labels as they are, so the labels are the same.
"""

from __future__ import annotations

import torch

_BIG = 2 ** 30
_BLOCK_ELEMS = 2 ** 24  # pair distances a neighbour pass holds at once


def voxel_downsample(points: torch.Tensor, valid: torch.Tensor, voxel_size: float,
                     max_out: int):
    """First-occurrence voxel dedup with a static output capacity.

    points [N, 3] float32, valid [N] bool. Returns (rep_idx [max_out]
    indices into points, rep_valid [max_out] bool, inverse [N] in
    [0, max_out), each point's representative slot). Voxels beyond the
    capacity collapse onto the last slot. Slots past the valid ones hold
    index 0 (the JAX package leaves an unspecified index in the last one;
    both are masked by rep_valid).
    """
    n = points.shape[0]
    # a tensor divisor: a CUDA division by a host scalar multiplies by its
    # reciprocal, which rounds otherwise at the voxel boundaries
    size = torch.full((), voxel_size, dtype=points.dtype, device=points.device)
    q = torch.round(points / size).to(torch.int32)
    invalid = (~valid).to(torch.int32)
    # lexicographic (invalid, x, y, z): stable sorts from the least
    # significant key to the most
    order = torch.arange(n, device=points.device)
    for key in (q[:, 2], q[:, 1], q[:, 0], invalid):
        order = order[torch.sort(key[order], stable=True).indices]
    qs = q[order]
    vs = valid[order]  # the valid points are contiguous at the front
    first = torch.ones(n, dtype=torch.bool, device=points.device)
    first[1:] = (qs[1:] != qs[:-1]).any(dim=1)
    first &= vs
    voxel_id = torch.cumsum(first.to(torch.int64), 0) - 1
    slot = voxel_id.clamp(0, max_out - 1)
    inverse = torch.empty(n, dtype=torch.int64, device=points.device)
    inverse[order] = slot
    # the first point of each voxel into its slot; the other points go to a
    # spare slot that is dropped
    rep_idx = torch.zeros(max_out + 1, dtype=torch.int64, device=points.device)
    rep_idx.scatter_(0, torch.where(first, slot, max_out), order)
    n_unique = first.sum()
    rep_valid = torch.arange(max_out, device=points.device) < torch.clamp(n_unique, max=max_out)
    return rep_idx[:max_out], rep_valid, inverse


def _neighbour_pass(points: torch.Tensor, valid: torch.Tensor, labels_masked: torch.Tensor,
                    eps2: float):
    """One sweep over the implicit <= eps adjacency, in blocks of rows so
    that at most 2^24 pair distances exist at once. Returns (neighbour
    count [N], smallest neighbour label [N], _BIG where none)."""
    n = points.shape[0]
    block = max(1, _BLOCK_ELEMS // max(n, 1))
    counts, mins = [], []
    for s in range(0, n, block):
        rows = points[s:s + block]
        d = rows[:, None, :] - points[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        adj = (d2 <= eps2) & valid[s:s + block, None] & valid[None, :]
        counts.append(adj.sum(1))
        mins.append(torch.where(adj, labels_masked[None, :], _BIG).amin(1))
    return torch.cat(counts), torch.cat(mins)


def dbscan_labels(points: torch.Tensor, valid: torch.Tensor, eps: float, min_samples: int,
                  n_iters: int = 16) -> torch.Tensor:
    """DBSCAN cluster ids over points [N, 3]: the smallest core index of
    each cluster, -1 for noise and invalid points. min_samples counts the
    point itself; border points take their smallest core neighbour's
    label. Stops at the fixpoint (one host read per pass), except under
    `torch.export`, where it runs all n_iters passes."""
    early_exit = not torch.compiler.is_exporting()
    n = points.shape[0]
    eps2 = eps * eps
    idx = torch.arange(n, device=points.device)
    counts, _ = _neighbour_pass(points, valid, torch.zeros_like(idx), eps2)
    core = (counts >= min_samples) & valid
    labels = torch.where(core, idx, _BIG)

    def jump(lab):
        # pointer jumping: follow the representative's representative
        jumped = lab[lab.clamp(0, n - 1)]
        return torch.where(core & (lab < _BIG), torch.minimum(lab, jumped), lab)

    for _ in range(n_iters):
        # min label over core neighbours (core-core propagation)
        _, neigh_min = _neighbour_pass(points, valid, torch.where(core, labels, _BIG), eps2)
        new = torch.where(core, torch.minimum(labels, neigh_min), labels)
        for _ in range(3):  # several cheap jumps per expensive pass
            new = jump(new)
        if early_exit and not bool((new != labels).any()):  # one device sync per pass
            break
        labels = new

    # border points: smallest core-neighbour label
    _, border_min = _neighbour_pass(points, valid, torch.where(core, labels, _BIG), eps2)
    labels = torch.where(core, labels, border_min)
    return torch.where(valid & (labels < _BIG), labels, -1)


def filter_and_canonicalise(labels: torch.Tensor, valid: torch.Tensor, min_cluster_size: int,
                            order: str = "first") -> torch.Tensor:
    """Drop clusters smaller than min_cluster_size, renumber the rest
    1..C; noise and dropped points get 0.

    order 'first': by first appearance (the reference's numbering);
    'size': by descending size, first appearance breaking ties, so that a
    capacity drop of ids >= K sheds the smallest clusters.
    """
    n = labels.shape[0]
    dev = labels.device
    lab = torch.where(labels < 0, n, labels.long())  # noise -> overflow bucket
    sizes = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(0, lab, valid.long())
    keep = sizes[lab.clamp(0, n)] >= min_cluster_size
    lab = torch.where((lab < n) & keep, lab, n)

    idx = torch.arange(n, device=dev)
    first_occ = torch.full((n + 1,), _BIG, dtype=torch.int64, device=dev).scatter_reduce(
        0, lab, idx, reduce="amin")[:n]
    used = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, lab, torch.ones_like(idx))[:n] > 0
    occ_key = torch.where(used, first_occ, _BIG)
    sort_order = torch.sort(occ_key, stable=True).indices
    if order == "size":
        size_key = torch.where(used, -sizes[:n], _BIG)
        sort_order = sort_order[torch.sort(size_key[sort_order], stable=True).indices]
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[sort_order] = idx
    return torch.where(lab < n, rank[lab.clamp(0, n - 1)] + 1, 0)


def cluster_moving_points(transformed_points: torch.Tensor, offset: torch.Tensor,
                          moving: torch.Tensor, valid: torch.Tensor, eps: float = 0.4,
                          min_samples: int = 5, min_cluster_size: int = 15,
                          pre_voxel: float = 0.05, max_cluster_points: int = 8192,
                          n_iters: int = 16, label_order: str = "size") -> torch.Tensor:
    """The test-time clustering of one sample: shift the points by their
    predicted instance-centre offsets [N, 2], voxel-downsample the moving
    valid ones, flatten z, DBSCAN, size filter, renumber, broadcast back.
    Returns [N] int64 instance labels (0 = background)."""
    pts = transformed_points.clone()
    pts[:, :2] += offset
    sel = moving & valid
    rep_idx, rep_valid, inverse = voxel_downsample(pts, sel, pre_voxel, max_cluster_points)
    rep_pts = pts[rep_idx]
    rep_pts[:, 2] = 0.0  # z flattened after the downsample
    labels_rep = dbscan_labels(rep_pts, rep_valid, eps, min_samples, n_iters)
    labels_rep = filter_and_canonicalise(labels_rep, rep_valid, min_cluster_size,
                                         order=label_order)
    return torch.where(sel, labels_rep[inverse], 0)
