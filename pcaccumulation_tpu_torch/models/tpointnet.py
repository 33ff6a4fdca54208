"""TPointNet + AlignNet: per-instance rigid motion regression, then
optionally the per-instance ICP refinement (the port of the JAX package's
`models/tpointnet.py`).

Instances are flattened across the batch into G = B*K global slots with a
static capacity K per sample; masks stand where the reference selects
points dynamically. An instance with no anchor-frame points borrows its
earliest occupied frame as frame 0 (counts, MOS maxima, centroid and the
t=0 positional embedding). With a compute dtype the embedding MLPs and
their max pools run in it; the pooled embeddings are cast back to float32,
so the regressor, its BatchNorm and every pose stay float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.profiler import record_function

from pcaccumulation_tpu_torch.models.layers import MaskedBatchNorm, mlp
from pcaccumulation_tpu_torch.ops import se3
from pcaccumulation_tpu_torch.ops.icp import refine_instance_poses
from pcaccumulation_tpu_torch.ops.numeric import safe_norm
from pcaccumulation_tpu_torch.ops.segment import masked_segment_max, masked_segment_sum

_EPS = 1e-7


def quat_trans_to_tsfm(rep):
    """[..., 7] (quat xyzw + trans) -> [..., 4, 4]."""
    quat = rep[..., :4]
    quat = quat / (safe_norm(quat, dim=-1, keepdim=True) + _EPS)
    return se3.make_transform(se3.quat_to_matrix(quat), rep[..., 4:])


def gt_to_quat_rep(pose_gt, centroids):
    """GT poses of centred clouds as transforms and quat+trans.
    pose_gt [G, T, 4, 4], centroids [G, 3]."""
    rot = pose_gt[..., :3, :3]
    eye3 = torch.eye(3, dtype=pose_gt.dtype, device=pose_gt.device)
    new_trans = pose_gt[..., :3, 3] + torch.einsum("gtij,gj->gti", rot - eye3, centroids)
    rep = torch.cat([se3.matrix_to_quat(rot), new_trans], dim=-1)  # [G, T, 7]
    return se3.make_transform(rot, new_trans), rep


def _take_time(arr, earliest):
    """arr [G, T, ...] at each row's frame earliest [G] -> [G, ...]."""
    idx = earliest.reshape((-1, 1) + (1,) * (arr.dim() - 2)).expand(
        (arr.shape[0], 1) + arr.shape[2:])
    return torch.gather(arr, 1, idx)[:, 0]


class TPointNet(nn.Module):
    """Pose regressor over G = B*K global instance slots."""

    def __init__(self, n_frames: int = 5, min_points_per_frame: int = 10,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.n_frames = n_frames
        self.min_points_per_frame = min_points_per_frame
        self.compute_dtype = compute_dtype
        self.motion_embed = mlp(64, [64, 128, 128], compute_dtype=compute_dtype)
        self.geo_embed = mlp(32, [32, 64, 128], compute_dtype=compute_dtype)
        self.pos_embed = mlp(4, [32, 64, 128], compute_dtype=compute_dtype)
        self.regressor = nn.Sequential(
            nn.Linear(512, 256), MaskedBatchNorm(256), nn.ReLU(),
            nn.Linear(256, 128), MaskedBatchNorm(128), nn.ReLU(),
            nn.Linear(128, 7),
        )

    def forward(self, points, time_idx, inst_gid, valid, mos_labels, frame_feats,
                mos_feats, inst_motion_gt) -> dict:
        """points [P, 3] flattened; time_idx, inst_gid (in [0, G)), mos_labels
        [P] int; valid [P] bool; frame_feats [P, 32]; mos_feats [P, 64];
        inst_motion_gt [G, T, 4, 4]."""
        g, t = inst_motion_gt.shape[:2]
        gt_slots = g * t
        dt = points.dtype
        frame_id = torch.where(valid, inst_gid.long() * t + time_idx.long(), gt_slots)

        # frame sums [count | xyz]
        sum_a = masked_segment_sum(torch.cat([torch.ones_like(points[:, :1]), points], -1),
                                   frame_id, valid, gt_slots + 1)[:gt_slots]
        frame_count_raw = sum_a[:, 0]
        frame_count = frame_count_raw.reshape(g, t)
        occupied = frame_count > 0
        earliest = torch.argmax(occupied.to(torch.int32), dim=1)  # first occupied frame
        anchor_empty = ~occupied[:, 0]

        def borrow(arr_gt):  # [G, T]: frame 0 <- earliest frame if empty
            out = arr_gt.clone()
            out[:, 0] = torch.where(anchor_empty, _take_time(arr_gt, earliest), arr_gt[:, 0])
            return out

        frame_count = borrow(frame_count)
        frame_centroid = (sum_a[:, 1:4] / torch.clamp(frame_count_raw, min=1e-12)[:, None]
                          ).reshape(g, t, 3)
        inst_centroid = torch.where(anchor_empty[:, None],
                                    _take_time(frame_centroid, earliest),
                                    frame_centroid[:, 0])  # [G, 3]

        inst_seg = torch.where(valid, inst_gid.long(), g)
        cd = self.compute_dtype or dt

        mos_emb_pp = self.motion_embed(mos_feats.to(cd))
        geo_emb_pp = self.geo_embed(frame_feats.to(cd))
        ec = mos_emb_pp.shape[-1]
        emb_i = masked_segment_max(torch.cat([mos_emb_pp, geo_emb_pp], -1), inst_seg, valid,
                                   g + 1)[:g].to(dt)
        mos_emb, geo_emb = emb_i[:, :ec], emb_i[:, ec:]

        centred = points - inst_centroid[inst_gid.long().clamp(0, g - 1)]
        frame_in = torch.cat([centred, time_idx[:, None].to(dt) / t], -1)
        anchor_in = torch.cat([centred, torch.zeros_like(centred[:, :1])], -1)

        # frame max [inst_mos | frame_emb | anchor_emb]
        max_f = masked_segment_max(
            torch.cat([mos_labels.to(dt).to(cd)[:, None], self.pos_embed(frame_in.to(cd)),
                       self.pos_embed(anchor_in.to(cd))], -1),
            frame_id, valid, gt_slots + 1,
        )[:gt_slots].to(dt)
        inst_mos = borrow(max_f[:, 0].reshape(g, t))
        mos_weights = torch.where(inst_mos == 0, 0.2, 1.0)
        temporal = (torch.arange(t, dtype=dt, device=points.device) + 1) / self.n_frames
        frame_weights = ((frame_count > self.min_points_per_frame).to(dt) * mos_weights
                         * temporal[None]).reshape(gt_slots)

        pc = (max_f.shape[-1] - 1) // 2
        frame_emb = max_f[:, 1:1 + pc].reshape(g, t, -1)
        anchor_all = max_f[:, 1 + pc:].reshape(g, t, -1)
        anchor_emb = torch.where(anchor_empty[:, None], _take_time(anchor_all, earliest),
                                 frame_emb[:, 0])
        frame_emb = torch.cat([anchor_emb[:, None], frame_emb[:, 1:]], dim=1)

        reg_in = torch.cat(
            [geo_emb.repeat_interleave(t, 0), mos_emb.repeat_interleave(t, 0),
             frame_emb.reshape(gt_slots, -1), anchor_emb.repeat_interleave(t, 0)],
            dim=-1,
        )  # [G*T, 512]
        inst_nonempty = occupied.any(dim=1).repeat_interleave(t)  # [G*T]
        reg = self.regressor
        x = torch.relu(reg[1](reg[0](reg_in), inst_nonempty))
        x = torch.relu(reg[4](reg[3](x), inst_nonempty))
        rep = reg[6](x)  # [G*T, 7]
        pose_est = quat_trans_to_tsfm(rep)  # [G*T, 4, 4]

        # losses
        gt_tsfm, gt_rep = gt_to_quat_rep(inst_motion_gt, inst_centroid)
        rec_est = se3.reconstruct_sequence(centred, time_idx, inst_gid,
                                           pose_est.reshape(g, t, 4, 4))
        rec_gt = se3.reconstruct_sequence(centred, time_idx, inst_gid, gt_tsfm)
        diff = rec_est - rec_gt
        # reference naming: 'l1' is the L2 norm, 'l2' the L1 norm
        sum_l = masked_segment_sum(torch.stack([safe_norm(diff), diff.abs().sum(-1)], -1),
                                   frame_id, valid, gt_slots + 1)[:gt_slots]
        inv_count = 1.0 / torch.clamp(frame_count_raw, min=1e-12)
        w_sum = frame_weights.sum() + _EPS
        quat_n = rep[:, :4] / (safe_norm(rep[:, :4], keepdim=True) + _EPS)
        gt_rep_flat = gt_rep.reshape(gt_slots, 7)
        losses = {
            "l1_loss": (sum_l[:, 0] * inv_count * frame_weights).sum() / w_sum,
            "l2_loss": (sum_l[:, 1] * inv_count * frame_weights).sum() / w_sum,
            "rot_loss": (safe_norm(gt_rep_flat[:, :4] - quat_n) * frame_weights).sum() / w_sum,
            "trans_loss": (safe_norm(gt_rep_flat[:, 4:] - rep[:, 4:]) * frame_weights).sum()
            / w_sum,
        }

        # de-centre, anchor frame identity
        rot_e = pose_est[:, :3, :3]
        eye3 = torch.eye(3, dtype=dt, device=points.device)
        comp = torch.einsum("nij,nj->ni", eye3 - rot_e, inst_centroid.repeat_interleave(t, 0))
        pose_out = se3.make_transform(rot_e, pose_est[:, :3, 3] + comp).reshape(g, t, 4, 4)
        pose_out = torch.cat(
            [torch.eye(4, dtype=dt, device=points.device).expand(g, 1, 4, 4), pose_out[:, 1:]],
            dim=1)
        return {**losses, "inst_est_motion": pose_out}


def update_gt_inst_motion(inst_motion_gt, ego_motion_gt, ego_motion_est):
    """inst' = inst @ ego_gt @ inv(ego_est) per (B, K, T)."""
    correction = se3.compose(ego_motion_gt, se3.transform_inverse(ego_motion_est))
    return se3.compose(inst_motion_gt, correction[:, None])  # [B, K, T, 4, 4]


class AlignNet(nn.Module):
    """Iterative TPointNet refinement over the whole batch."""

    def __init__(self, n_frames: int = 5, n_iterations: int = 1,
                 min_points_per_frame: int = 10, icp: bool = False,
                 icp_threshold: float = 0.25, icp_max_iter: int = 50,
                 icp_max_points: int = 1024, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.n_iterations = n_iterations
        self.icp = icp
        self.icp_threshold = icp_threshold
        self.icp_max_iter = icp_max_iter
        self.icp_max_points = icp_max_points
        self.alignment = TPointNet(n_frames, min_points_per_frame, compute_dtype)

    def forward(self, transformed_points, time_idx, inst_idx, rec_mask, mos_labels,
                backbone_feats, mos_feats, inst_motion_gt, ego_motion_gt,
                ego_motion_est) -> dict:
        """Per-sample inputs [B, N, ...]; inst_idx 0 = background;
        inst_motion_gt [B, K, T, 4, 4]; ego poses [B, T, 4, 4]."""
        b, k, t = inst_motion_gt.shape[:3]
        n = transformed_points.shape[1]
        g = b * k
        base = torch.arange(b, device=inst_idx.device)[:, None] * k
        gid = (base + inst_idx.long()).reshape(-1)
        pts = transformed_points.reshape(-1, 3)
        tid = time_idx.reshape(-1)
        valid = rec_mask.reshape(-1)
        mos_l = mos_labels.reshape(-1)
        bb_f = backbone_feats.reshape(-1, backbone_feats.shape[-1])
        mos_f = mos_feats.reshape(-1, mos_feats.shape[-1])

        updated_gt = update_gt_inst_motion(inst_motion_gt, ego_motion_gt,
                                           ego_motion_est).reshape(g, t, 4, 4)
        gt0 = updated_gt
        points = pts
        final_pose = None
        loss_terms = {}
        for it in range(self.n_iterations):
            pred = self.alignment(points.detach(), tid, gid, valid, mos_l, bb_f, mos_f,
                                  updated_gt.detach())
            loss_terms[f"{it}_th"] = {
                kk: pred[kk] for kk in ("l1_loss", "l2_loss", "rot_loss", "trans_loss")}
            est = pred["inst_est_motion"]  # [G, T, 4, 4]
            points = se3.reconstruct_sequence(points, tid, gid, est)
            # counter-rotate the GT
            r_new = updated_gt[..., :3, :3] @ est[..., :3, :3].transpose(-1, -2)
            t_new = updated_gt[..., :3, 3] - torch.einsum("gtij,gtj->gti", r_new,
                                                          est[..., :3, 3])
            updated_gt = se3.make_transform(r_new, t_new)
            final_pose = est if final_pose is None else se3.compose(est, final_pose)

        if self.icp:
            # detached, as the JAX package stop-gradients it
            with record_function("motionnet.icp_instance"):
                final_pose = refine_instance_poses(
                    pts.detach(), tid, gid, valid, final_pose.detach(), self.icp_threshold,
                    self.icp_max_iter, self.icp_max_points)

        rec_est = se3.reconstruct_sequence(pts, tid, gid, final_pose)
        rec_gt = se3.reconstruct_sequence(pts, tid, gid, gt0)
        l2 = safe_norm(rec_est - rec_gt)
        w_full = (valid & (tid > 0)).to(l2.dtype)
        w_dyn = w_full * (mos_l == 1)
        return {
            "tpointnet_loss_terms": loss_terms,
            "inst_l2_error": (l2 * w_full).sum() / (w_full.sum() + _EPS),
            "dynamic_inst_l2_error": (l2 * w_dyn).sum() / (w_dyn.sum() + _EPS),
            "inst_pose_est": final_pose.reshape(b, k, t, 4, 4),
            "sub_rec_est": rec_est.reshape(b, n, 3),
        }
