"""2D UNet on BEV maps (the port of the JAX package's `models/unet.py`,
plain form: the space-to-depth level 0 is the same function and is not
ported). Every convolution is initialised xavier-normal, as the JAX
package's (and the reference's) UNet. Tensors inside are NCHW; the public UNet takes and returns NHWC.
With a compute dtype every convolution runs in it (models/layers.py).

Band mode (`halo`, the spatial axis of `parallel/mesh.py`): the input is
one band of the image's rows, its edges on multiples of 2^(depth-1) rows,
so that every 2x2 pool and stride-2 upsample stays inside the band; each
3x3 convolution takes its halo rows from the neighbouring bands (19 at
depth 5), and the output is the whole UNet's output on the band's rows."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pcaccumulation_tpu_torch.models.layers import Conv2d, ConvTranspose2d


class DownConv(nn.Module):
    """Two 3x3 convs (+ReLU) and an optional 2x2 max pool."""

    def __init__(self, in_channels: int, out_channels: int, pooling: bool = True,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1,
                            compute_dtype=compute_dtype, init="xavier")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            compute_dtype=compute_dtype, init="xavier")
        self.pooling = pooling

    def forward(self, x, halo=None):
        before_pool = torch.relu(self.conv2(torch.relu(self.conv1(x, halo)), halo))
        x = F.max_pool2d(before_pool, 2) if self.pooling else before_pool
        return x, before_pool


class UpConv(nn.Module):
    """2x2 stride-2 transpose-conv upsample, concat [up, skip], two 3x3 convs."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.upconv = ConvTranspose2d(in_channels, out_channels, 2, stride=2,
                                      compute_dtype=compute_dtype, init="xavier")
        self.conv1 = Conv2d(out_channels + skip_channels, out_channels, 3, padding=1,
                            compute_dtype=compute_dtype, init="xavier")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            compute_dtype=compute_dtype, init="xavier")

    def forward(self, from_down, from_up, halo=None):
        x = torch.cat([self.upconv(from_up), from_down], dim=1)
        return torch.relu(self.conv2(torch.relu(self.conv1(x, halo)), halo))


def make_unet_convs(in_channels: int, down_widths: Sequence[int], up_widths: Sequence[int],
                    compute_dtype: torch.dtype | None = None
                    ) -> tuple[nn.ModuleList, nn.ModuleList]:
    """Encoder levels of the given widths (no pool after the last) and
    decoder levels whose skip is the encoder level of matching depth."""
    down = nn.ModuleList()
    c = in_channels
    for i, w in enumerate(down_widths):
        down.append(DownConv(c, w, pooling=i < len(down_widths) - 1,
                             compute_dtype=compute_dtype))
        c = w
    up = nn.ModuleList()
    for i, w in enumerate(up_widths):
        up.append(UpConv(c, down_widths[-(i + 2)], w, compute_dtype=compute_dtype))
        c = w
    return down, up


def run_unet(down: nn.ModuleList, up: nn.ModuleList, x: torch.Tensor,
             halo=None) -> torch.Tensor:
    """x [N, C, H, W] through the encoder/decoder levels (a band of rows
    with `halo`)."""
    encoder_outs = []
    for level in down:
        x, before_pool = level(x, halo)
        encoder_outs.append(before_pool)
    for i, level in enumerate(up):
        x = level(encoder_outs[-(i + 2)], x, halo)
    return x


class UNet(nn.Module):
    """Encoder/decoder with `depth` levels, start_filts doubling per level,
    and a final 3x3 conv back to in_channels. NHWC in and out. With a
    compute dtype the input is cast to it, and the output is cast back to
    the input's dtype unless `keep_compute_dtype`. `band_unit`: the rows a
    band's edges fall on multiples of in band mode, 2^(depth-1)."""

    def __init__(self, in_channels: int = 32, depth: int = 5, start_filts: int = 32,
                 compute_dtype: torch.dtype | None = None, keep_compute_dtype: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.keep_compute_dtype = keep_compute_dtype
        self.band_unit = 2 ** (depth - 1)
        down_widths = [start_filts * 2 ** i for i in range(depth)]
        self.down_convs, self.up_convs = make_unet_convs(
            in_channels, down_widths, down_widths[-2::-1], compute_dtype)
        self.conv_final = Conv2d(start_filts, in_channels, 3, padding=1,
                                 compute_dtype=compute_dtype, init="xavier")

    def forward(self, x, halo=None):
        """x [N, H, W, C]; with `halo` a band of rows of height a multiple
        of `band_unit` (see the module docstring)."""
        in_dtype = x.dtype
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if halo is not None and x.shape[1] % self.band_unit:
            raise ValueError(f"a band of {x.shape[1]} rows is no multiple of {self.band_unit}")
        x = run_unet(self.down_convs, self.up_convs, x.permute(0, 3, 1, 2), halo)
        out = self.conv_final(x, halo).permute(0, 2, 3, 1)
        return out if self.keep_compute_dtype else out.to(in_dtype)
