"""Batched point-to-point ICP (the port of the JAX package's `ops/icp.py`).

Every function solves many problems at once: one `nn_packed` call (kernel
K4, kernels/chamfer.py) per iteration serves all of them. The targets and
the valid sources are packed once per call, before the loop, and the
kernel computes only the valid sources' nearest neighbours. The iteration
count is fixed, as the JAX package's `fori_loop`, and nothing is read back
to the host (the kernel's grid comes from the shapes), so `torch.export`
traces these functions; the two degeneracy holds are `torch.where`
selections. ICP is not
differentiable in the reference (Open3D on the host): the results here are
computed without autograd, i.e. detached.
"""

from __future__ import annotations

import torch

from pcaccumulation_tpu_torch.kernels.chamfer import (
    nn_packed,
    nn_scratch,
    pack_queries,
    pack_references,
)
from pcaccumulation_tpu_torch.ops import se3
from pcaccumulation_tpu_torch.ops.kabsch import weighted_kabsch
from pcaccumulation_tpu_torch.ops.segment import compact_mask_indices


def _eye(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(shape + (4, 4))


@torch.no_grad()
def icp_point_to_point(src: torch.Tensor, tgt: torch.Tensor, src_valid: torch.Tensor,
                       tgt_valid: torch.Tensor, init_pose: torch.Tensor | None = None,
                       threshold: float = 0.15, max_iterations: int = 50) -> torch.Tensor:
    """Refine rigid poses aligning src -> tgt, for P problems.

    src [P, N, 3], tgt [P, M, 3], src_valid [P, N], tgt_valid [P, M] bool;
    init_pose [P, 4, 4] (None = identity). Each iteration matches every
    source point to its nearest valid target, keeps the pairs closer than
    `threshold` whose source is valid, and composes the weighted Kabsch
    update on the left; fewer than 3 pairs hold the pose. Returns
    refined @ init_pose [P, 4, 4], or init_pose where src or tgt has fewer
    than 3 valid points.
    """
    p = src.shape[0]
    if init_pose is None:
        init_pose = _eye((p,), src)
    eye = _eye((p,), src)
    pose = eye
    src_t = se3.apply_transform(src, init_pose)
    w_valid = src_valid.to(src.dtype)
    # tgt and the masks do not change in the loop. An invalid source is not
    # asked for and gets (1e30, index 0): its weight is 0 (w_valid), and its
    # finite `matched` row adds exact zeros to the Kabsch sums.
    refs, queries = pack_references(tgt, tgt_valid), pack_queries(src_valid)
    out = (torch.empty(src_valid.shape, dtype=torch.float32, device=src.device),
           torch.empty(src_valid.shape, dtype=torch.int32, device=src.device))
    part = nn_scratch(refs, src.shape[1])
    for _ in range(max_iterations):
        d2, idx = nn_packed(src_t, refs, queries, out, part)  # read within the iteration
        w = (d2 < threshold * threshold).to(src.dtype) * w_valid
        matched = torch.gather(tgt, 1, idx.long()[..., None].expand(src_t.shape))
        rot, trans = weighted_kabsch(src_t, matched, w)
        # fewer than 3 pairs within the threshold: Kabsch is degenerate, hold
        delta = torch.where((w.sum(-1) >= 3)[:, None, None], se3.make_transform(rot, trans), eye)
        pose = se3.compose(delta, pose)
        src_t = se3.apply_transform(src_t, delta)
    ok = (src_valid.sum(-1) >= 3) & (tgt_valid.sum(-1) >= 3)
    return torch.where(ok[:, None, None], se3.compose(pose, init_pose), init_pose)


@torch.no_grad()
def refine_ego_poses(points: torch.Tensor, time_idx: torch.Tensor, point_valid: torch.Tensor,
                     point_bg: torch.Tensor, poses: torch.Tensor, threshold: float = 0.15,
                     max_iterations: int = 50) -> torch.Tensor:
    """Ego-pose ICP: each frame t > 0's background points are aligned to
    the anchor frame's background points, from the current estimate.

    points [B, N, 3] raw per-frame points; time_idx [B, N]; point_valid,
    point_bg [B, N] bool; poses [B, T, 4, 4] frame -> anchor. Frame 0 stays
    as it is. All B*(T-1) frames are one batch of ICP problems.
    """
    b, n, _ = points.shape
    t = poses.shape[1]
    base = point_valid & point_bg
    mask0 = base & (time_idx == 0)                                            # [B, N]
    frames = torch.arange(1, t, device=points.device)
    maskt = base[:, None, :] & (time_idx[:, None, :] == frames[None, :, None])  # [B, T-1, N]
    pts = points[:, None].expand(b, t - 1, n, 3).reshape(b * (t - 1), n, 3)
    refined = icp_point_to_point(
        pts, pts, maskt.reshape(b * (t - 1), n),
        mask0[:, None].expand(b, t - 1, n).reshape(b * (t - 1), n),
        init_pose=poses[:, 1:].reshape(b * (t - 1), 4, 4), threshold=threshold,
        max_iterations=max_iterations)
    return torch.cat([poses[:, :1], refined.reshape(b, t - 1, 4, 4)], dim=1)


@torch.no_grad()
def refine_instance_poses(points: torch.Tensor, time_idx: torch.Tensor, inst_gid: torch.Tensor,
                          valid: torch.Tensor, pose_est: torch.Tensor, threshold: float = 0.25,
                          max_iterations: int = 50, max_points: int = 1024) -> torch.Tensor:
    """Per-instance ICP: each (instance, frame > 0) slice of the points,
    reconstructed with the current estimate, is aligned to that instance's
    frame-0 slice; the correction is composed on the left.

    points [P, 3] flattened anchor-frame points; time_idx, inst_gid [P]
    (slots in [0, G)); valid [P] bool; pose_est [G, T, 4, 4]. Each
    instance takes its first `max_points` members in index order (the JAX
    package's stable top_k on 0/1 scores, here the order-preserving
    compaction). All G*(T-1) slices are one batch of ICP problems.
    """
    g, t = pose_est.shape[:2]
    rec = se3.reconstruct_sequence(points, time_idx, inst_gid, pose_est)
    max_points = min(max_points, points.shape[0])
    member = valid[None, :] & (inst_gid[None, :].long()
                               == torch.arange(g, device=points.device)[:, None])  # [G, P]
    sel, sel_valid = compact_mask_indices(member, max_points)   # [G, max_points]
    inst_pts = rec[sel]                                          # [G, max_points, 3]
    inst_tid = time_idx[sel]
    mask0 = sel_valid & (inst_tid == 0)
    frames = torch.arange(1, t, device=points.device)
    maskt = sel_valid[:, None, :] & (inst_tid[:, None, :] == frames[None, :, None])  # [G, T-1, S]
    pts = inst_pts[:, None].expand(g, t - 1, max_points, 3).reshape(g * (t - 1), max_points, 3)
    refined = icp_point_to_point(
        pts, pts, maskt.reshape(g * (t - 1), max_points),
        mask0[:, None].expand(g, t - 1, max_points).reshape(g * (t - 1), max_points),
        threshold=threshold, max_iterations=max_iterations)
    correction = torch.cat([_eye((g, 1), pose_est), refined.reshape(g, t - 1, 4, 4)], dim=1)
    return se3.compose(correction, pose_est)
