"""Ego-motion head: keypoint draw, soft correspondences (Sinkhorn) and
weighted Kabsch over all frame pairs at once, then optionally the ego-pose
ICP refinement (the port of the JAX package's `models/egomotion.py`;
`seq_pose: skip` only).

The keypoint draw takes n_kpts background pillars per (batch, frame):
- deterministic: the first n_kpts in (y, x) BEV scan order, a shortfall
  filled with the last valid one (the JAX package's parity mode, exactly);
- random: an exact top-k of uniform scores drawn from the given
  `torch.Generator` (a uniform draw without replacement), a shortfall
  filled with the first drawn pillar. The scores may be given instead
  (`scores`, [B, T, M] in [0, 1)): the serving layer draws them once, so
  that a live and an exported step compute the same thing.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from pcaccumulation_tpu_torch.ops import se3
from pcaccumulation_tpu_torch.ops.icp import refine_ego_poses
from pcaccumulation_tpu_torch.ops.kabsch import weighted_kabsch
from pcaccumulation_tpu_torch.ops.numeric import safe_norm
from pcaccumulation_tpu_torch.ops.sinkhorn import log_sinkhorn, square_distance

_EPS = 1e-7


def draw_keypoints(frame_mask: torch.Tensor, n: int, deterministic: bool,
                   scan_key: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   scores: torch.Tensor | None = None) -> torch.Tensor:
    """[B, T, M] frame masks -> [B, T, n] pillar indices."""
    b, t, m = frame_mask.shape
    if deterministic:
        scores = -scan_key.to(torch.float32)[:, None, :].expand(b, t, m)
    elif scores is None:
        scores = torch.rand((b, t, m), generator=generator, device=frame_mask.device)
    scores = torch.where(frame_mask, scores, float("-inf"))
    top_vals, top_idx = torch.topk(scores, n, dim=-1)  # sorted, descending
    have = torch.isfinite(top_vals)
    if deterministic:
        cnt = have.sum(dim=-1, keepdim=True)
        fill = torch.gather(top_idx, -1, torch.clamp(cnt - 1, min=0))
    else:
        fill = top_idx[..., :1]
    return torch.where(have, top_idx, fill)


class EgoMotionHead(nn.Module):
    def __init__(self, n_kpts: int = 1024, sinkhorn_iter: int = 3, slack: bool = True,
                 n_sweeps: int = 5, freq: float = 10.0, max_speed: float = 20.0,
                 seq_pose: str = "skip", deterministic_sampling: bool = False,
                 icp: bool = False, icp_threshold: float = 0.15, icp_max_iter: int = 50):
        super().__init__()
        if seq_pose != "skip":
            raise NotImplementedError(f"seq_pose={seq_pose!r}: only 'skip' is ported")
        self.icp = icp
        self.icp_threshold = icp_threshold
        self.icp_max_iter = icp_max_iter
        self.n_kpts = n_kpts
        self.sinkhorn_iter = sinkhorn_iter
        self.slack = slack
        self.n_sweeps = n_sweeps
        self.freq = freq
        self.max_speed = max_speed
        self.deterministic_sampling = deterministic_sampling
        # affinity parameters
        self.alpha = nn.Parameter(torch.tensor(-5.0))
        self.beta = nn.Parameter(torch.tensor(-5.0))

    def forward(self, pillar_feats, pillar_mean, pillar_t, pillar_valid, pillar_bg,
                ego_motion_gt, pillar_scan_key=None, generator=None, points=None,
                time_idx=None, point_valid=None, point_bg=None, kpt_scores=None) -> dict:
        """pillar_feats [B, M, C] L2-normalised ego features at pillars;
        pillar_mean [B, M, 3]; pillar_t [B, M] frame of each pillar;
        pillar_valid, pillar_bg [B, M] bool; ego_motion_gt [B, T, 4, 4];
        pillar_scan_key [B, M] = y*W + x (deterministic draw);
        generator: the random draw's torch.Generator, or kpt_scores
        [B, T, M]: its uniform scores, drawn beforehand. With `icp` on and
        point_bg given, the chained estimate is refined by ICP on the
        estimated background points (points [B, N, 3], time_idx [B, N],
        point_valid, point_bg [B, N] bool), detached; the pair losses keep
        the unrefined poses, as in the JAX package."""
        b, m = pillar_valid.shape
        t_frames = self.n_sweeps
        n = self.n_kpts
        dev = pillar_mean.device
        src_f = torch.arange(1, t_frames, device=dev)  # skip: pairs (t, 0)
        tgt_f = torch.zeros_like(src_f)
        durations = (src_f - tgt_f).abs().to(torch.float32) / self.freq  # [P]

        frame_mask = (
            pillar_valid[:, None, :] & pillar_bg[:, None, :]
            & (pillar_t[:, None, :] == torch.arange(t_frames, device=dev)[None, :, None])
        )  # [B, T, M]
        top_idx = draw_keypoints(frame_mask, n, self.deterministic_sampling,
                                 scan_key=pillar_scan_key, generator=generator,
                                 scores=kpt_scores)
        # a frame with no background pillar gates its pairs to identity
        frame_ok = frame_mask.any(dim=-1)  # [B, T]

        def take(arr):  # arr [B, M, C], top_idx [B, T, n] -> [B, T, n, C]
            flat = top_idx.reshape(b, t_frames * n, 1).expand(-1, -1, arr.shape[-1])
            return torch.gather(arr, 1, flat).reshape(b, t_frames, n, arr.shape[-1])

        samp_feats = take(pillar_feats)
        samp_coords = take(pillar_mean)
        fs, ft = samp_feats[:, src_f], samp_feats[:, tgt_f]  # [B, P, n, C]
        cs, ct = samp_coords[:, src_f], samp_coords[:, tgt_f]

        thr = (durations * self.max_speed) ** 2  # [P]
        support = (square_distance(cs, ct) < thr[None, :, None, None]).to(cs.dtype)
        feat_dist = square_distance(fs, ft, normalised=True)  # [B, P, n, n]
        affinity = -(feat_dist - F.softplus(self.alpha)) / (torch.exp(self.beta) + 0.02)
        log_perm = log_sinkhorn(affinity, self.sinkhorn_iter, self.slack)
        perm = torch.exp(log_perm) * support

        pair_ok = frame_ok[:, src_f] & frame_ok[:, tgt_f]  # [B, P]
        eye_n = torch.eye(n, dtype=perm.dtype, device=dev)
        perm = torch.where(pair_ok[..., None, None], perm, eye_n)

        row_sum = perm.sum(dim=-1)  # [B, P, n]
        # floored at 1e-12, not the reference's 1e-20, which underflows
        # when squared in a backward pass
        weighted_t = (perm @ ct) / torch.clamp(row_sum[..., None], min=1e-12)
        rot, trans = weighted_kabsch(cs, weighted_t, row_sum)
        eye4 = torch.eye(4, dtype=rot.dtype, device=dev)
        pose_pairs = torch.where(pair_ok[..., None, None], se3.make_transform(rot, trans),
                                 eye4)  # [B, P, 4, 4]

        pose_gt_pairs = se3.relative_pose(ego_motion_gt[:, src_f], ego_motion_gt[:, tgt_f])

        # per-pair point L1/L2 losses on the source frame's pillar means
        diff = (se3.apply_transform(pillar_mean[:, None], pose_pairs)
                - se3.apply_transform(pillar_mean[:, None], pose_gt_pairs))  # [B,P,M,3]
        in_frame = ((pillar_t[:, None, :] == src_f[None, :, None])
                    & pillar_valid[:, None, :]).to(pillar_mean.dtype)  # [B, P, M]
        count = in_frame.sum(dim=-1) + _EPS
        l1_pp = (diff.abs().sum(dim=-1) * in_frame).sum(dim=-1) / count
        l2_pp = (safe_norm(diff, dim=-1) * in_frame).sum(dim=-1) / count
        okf = pair_ok.to(pillar_mean.dtype)
        n_ok = okf.sum() + _EPS

        eye = eye4.expand(b, 1, 4, 4)
        chained_est = torch.cat([eye, pose_pairs], dim=1)  # [B, T, 4, 4]
        if self.icp and point_bg is not None:
            with record_function("motionnet.icp_ego"):
                chained_est = refine_ego_poses(points, time_idx, point_valid, point_bg,
                                               chained_est.detach(), self.icp_threshold,
                                               self.icp_max_iter)
        chained_gt = torch.cat(
            [eye, se3.relative_pose(ego_motion_gt[:, 1:], ego_motion_gt[:, :1])], dim=1)
        rot_err = se3.rotation_error_deg(chained_est[..., :3, :3], chained_gt[..., :3, :3])
        trans_err = se3.translation_error(chained_est[..., :3, 3], chained_gt[..., :3, 3])
        scale = t_frames / (t_frames - 1)
        return {
            "ego_motion_est": chained_est,
            "ego_motion_gt": chained_gt,
            "ego_l1_loss": (l1_pp * okf).sum() / n_ok,
            "ego_l2_loss": (l2_pp * okf).sum() / n_ok,
            "ego_rot_error": rot_err.mean() * scale,
            "ego_trans_error": trans_err.mean() * scale,
            "perm_matrix": perm,
        }
