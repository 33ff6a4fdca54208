"""STPN: spatio-temporal pyramid for motion segmentation and offset voting
(the port of the JAX package's `models/stpn.py`).

The first `n_band_layers` (k, 1-4) of four 3x3x3 Conv3d + ReLU run over the
warped BEV sequence [B, C, T, H, W] (the JAX package's banded temporal conv
is the same function), then a max over time; the other 4 - k layers run
after it as plain 3x3 Conv2d + ReLU on the fused [B, C, H, W] map
(`post_conv{i}`, i = k..3, the JAX package's names; k = 4, the reference's
form, has none). Then a small UNet, a per-point bilinear lookup with a positional encoding, and the
MOS / offset heads. With a compute dtype the temporal convs and the UNet
run in it (the MOS map comes back in the input's dtype); the per-point
decoding stays float32, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pcaccumulation_tpu_torch.models.layers import Conv2d, Conv3d, SegHead1D, mlp
from pcaccumulation_tpu_torch.models.unet import make_unet_convs, run_unet
from pcaccumulation_tpu_torch.ops.bilinear import ungrid

_N_FILTERS = [32, 64, 128, 128, 256]


class STPN(nn.Module):
    def __init__(self, feat_dim: int = 32, n_frames: int = 5, offset_clamp: float = 20.0,
                 n_band_layers: int = 4, compute_dtype: torch.dtype | None = None):
        super().__init__()
        assert 1 <= n_band_layers <= 4, n_band_layers
        self.n_band_layers = n_band_layers
        self.compute_dtype = compute_dtype
        self.feat_dim = feat_dim
        self.n_frames = n_frames
        self.offset_clamp = offset_clamp
        convs: list[nn.Module] = []
        for _ in range(n_band_layers):
            convs += [Conv3d(feat_dim, feat_dim, 3, padding=1, compute_dtype=compute_dtype),
                      nn.ReLU()]
        self.init_conv = nn.Sequential(*convs)
        for i in range(n_band_layers, 4):
            setattr(self, f"post_conv{i}",
                    Conv2d(feat_dim, feat_dim, 3, padding=1, compute_dtype=compute_dtype))
        down = [max(64, w) for w in _N_FILTERS]
        up = [max(64, w) for w in _N_FILTERS[-2::-1]]
        self.down_convs, self.up_convs = make_unet_convs(feat_dim, down, up, compute_dtype)
        self.positional_encoding = mlp(3, [32, 64], final_act=True)
        self.final_proj = nn.Sequential(nn.Linear(64 + up[-1], 128), nn.ReLU())
        self.mos_seg = SegHead1D(128, 2)
        self.offset_head = SegHead1D(128, 2)

    def forward(self, x, points, point_mask, pc_range_min: float):
        """x [B, H, W, T*C] warped folded BEV features; points [B, S, 3]
        anchor-frame points; point_mask [B, S] bool (rows that count for
        BN statistics). Returns classes [B, S, 2], offset [B, S, 2] and the
        MOS feature map [B, H, W, 64]."""
        b, h, w, _ = x.shape
        in_dtype = x.dtype
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = x.reshape(b, h, w, self.n_frames, self.feat_dim).permute(0, 4, 3, 1, 2)
        x = self.init_conv(x).amax(dim=2)  # [B, C, H, W]
        for i in range(self.n_band_layers, 4):
            x = torch.relu(getattr(self, f"post_conv{i}")(x))
        mos_map = run_unet(self.down_convs, self.up_convs, x).permute(0, 2, 3, 1).to(in_dtype)

        # a bf16 map's corners are lerped at float32 weights: float32 rows
        ungridded = ungrid(mos_map, points[..., :2], pc_range_min, "border")
        pos = self.positional_encoding(points / abs(pc_range_min))
        enc = self.final_proj(torch.cat([pos, ungridded], dim=-1))
        flat = enc.reshape(-1, enc.shape[-1])
        mask = point_mask.reshape(-1)
        classes = self.mos_seg(flat, mask)
        offset = self.offset_head(flat, mask)
        offset = torch.where(torch.isfinite(offset), offset, 0.0)
        offset = offset.clamp(-self.offset_clamp, self.offset_clamp)
        s = points.shape[1]
        return classes.reshape(b, s, 2), offset.reshape(b, s, 2), mos_map
