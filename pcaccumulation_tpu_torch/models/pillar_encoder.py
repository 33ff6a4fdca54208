"""Pillar feature encoder, pillar statistics and the BEV scatter/gather (the
port of the JAX package's `models/pillar_encoder.py`, plain forms).

Shapes: B batch, N max points, M max pillars, T frames, H x W BEV grid.
`pillar_of_point` is in [0, M-1] for valid points and M for invalid ones
(the overflow segment). Points are sorted by it within each sample.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pcaccumulation_tpu_torch.models.layers import Linear, ResnetBlockFC
from pcaccumulation_tpu_torch.ops.bilinear import gather_bev, scatter_bev
from pcaccumulation_tpu_torch.ops.segment import (
    masked_seg_pool_max,
    masked_segment_max,
    masked_segment_sum,
)


def pillar_flat_index(pillar_coords: torch.Tensor, grid_hw) -> torch.Tensor:
    """[..., M, 3] (t, y, x) -> flat t*H*W + y*W + x."""
    h, w = grid_hw
    c = pillar_coords.long()
    return c[..., 0] * (h * w) + c[..., 1] * w + c[..., 2]


def segment_ids(pillar_of_point: torch.Tensor, max_pillars: int) -> torch.Tensor:
    """Per-sample pillar ids made global, [B, N] -> [B*N] int32: b*(M+1) +
    pillar. Sorted within each sample, hence sorted overall."""
    b = pillar_of_point.shape[0]
    base = torch.arange(b, dtype=torch.int32, device=pillar_of_point.device)[:, None]
    return (base * (max_pillars + 1) + pillar_of_point.to(torch.int32)).reshape(-1)


def scatter_pillars_to_bev(pillar_feats, pillar_coords, pillar_valid, n_frames, grid_hw):
    """[B, M, C] -> dense canvas [B, T, H, W, C]."""
    h, w = grid_hw
    b, _, c = pillar_feats.shape
    canvas = scatter_bev(pillar_feats, pillar_flat_index(pillar_coords, grid_hw),
                         pillar_valid, n_frames * h * w)
    return canvas.reshape(b, n_frames, h, w, c)


def gather_bev_at_pillars(canvas, pillar_coords, pillar_valid):
    """[B, T, H, W, C] -> [B, M, C] at each pillar's cell; invalid rows zero."""
    b, t, h, w, c = canvas.shape
    return gather_bev(canvas.reshape(b, t * h * w, c),
                      pillar_flat_index(pillar_coords, (h, w)), pillar_valid)


def pillar_stats(points, fb_labels, point_valid, pillar_of_point, max_pillars: int):
    """Per-pillar mean xyz and fb-label max in one masked segment sum
    (labels are binary, so max == (sum > 0)).

    Returns (pillar_mean [B, M, 3], fb_pillar [B, M] int32).
    """
    b, n, _ = points.shape
    m = max_pillars
    data = torch.cat(
        [points, (fb_labels > 0).to(points.dtype)[..., None], torch.ones_like(points[..., :1])],
        dim=-1,
    ).reshape(b * n, 5)
    total = masked_segment_sum(data, segment_ids(pillar_of_point, m),
                               point_valid.reshape(-1), b * (m + 1))
    mean = total[:, :3] / torch.clamp(total[:, 4], min=1e-12)[:, None]
    fb = (total[:, 3] > 0).to(torch.int32)
    return mean.reshape(b, m + 1, 3)[:, :m], fb.reshape(b, m + 1)[:, :m]


class PillarFeatureNet(nn.Module):
    """Per-point MLP with inter-block pillar max pooling, then a final
    pillar max. The 9-dim input is [xyz, dist-to-pillar-mean,
    dxy-to-pillar-centre, t]; spatial dims are normalised by |pc_range[0]|,
    t by n_sweeps. With a compute dtype the features are built in float32
    and cast to it before the MLP stack, whose pools (kernel K1) and output
    stay in it."""

    def __init__(self, num_filters: int = 32, depth: int = 3,
                 voxel_size=(0.25, 0.25, 8.0),
                 pc_range=(-36.0, -36.0, -5.0, 36.0, 36.0, 3.0), n_sweeps: int = 5,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.num_filters = num_filters
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        self.n_sweeps = n_sweeps
        self.compute_dtype = compute_dtype
        self.fc_pos = Linear(9, 2 * num_filters, compute_dtype=compute_dtype)
        self.blocks = nn.ModuleList(
            [ResnetBlockFC(2 * num_filters, num_filters, compute_dtype=compute_dtype)
             for _ in range(depth)])
        self.fc_c = Linear(num_filters, num_filters, compute_dtype=compute_dtype)

    def forward(self, points, time_idx, point_valid, pillar_of_point, pillar_coords,
                pillar_mean, max_pillars: int):
        """points [B, N, 3], time_idx [B, N], point_valid [B, N] bool,
        pillar_of_point [B, N] in [0, M], pillar_coords [B, M, 3] (t, y, x),
        pillar_mean [B, M, 3] -> pillar features [B, M, num_filters] in the
        compute dtype."""
        b, n, _ = points.shape
        m = max_pillars
        scale = abs(self.pc_range[0])
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x_offset = vx / 2 + self.pc_range[0]
        y_offset = vy / 2 + self.pc_range[1]

        p_idx = pillar_of_point.long().clamp(0, m - 1)[..., None]
        mean_pp = torch.gather(pillar_mean, 1, p_idx.expand(b, n, 3))
        coords_pp = torch.gather(pillar_coords, 1, p_idx.expand(b, n, 3)).to(points.dtype)
        f_center_x = points[..., 0] - (coords_pp[..., 2] * vx + x_offset)
        f_center_y = points[..., 1] - (coords_pp[..., 1] * vy + y_offset)
        feats = torch.cat(
            [
                points / scale,
                (points - mean_pp) / scale,
                f_center_x[..., None] / scale,
                f_center_y[..., None] / scale,
                time_idx[..., None].to(points.dtype) / self.n_sweeps,
            ],
            dim=-1,
        )  # [B, N, 9]

        if self.compute_dtype is not None:
            feats = feats.to(self.compute_dtype)
        seg_ids = segment_ids(pillar_of_point, m)
        valid_flat = point_valid.reshape(-1)
        net = self.blocks[0](self.fc_pos(feats).reshape(b * n, -1))
        for block in self.blocks[1:]:
            net = block(torch.cat([net, masked_seg_pool_max(net, seg_ids, valid_flat)], dim=-1))
        net = self.fc_c(net)
        pooled = masked_segment_max(net, seg_ids, valid_flat, b * (m + 1))
        return pooled.reshape(b, m + 1, self.num_filters)[:, :m]
