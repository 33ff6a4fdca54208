"""Shared building blocks (the port of the JAX package's `models/layers.py`,
plain forms). Module and parameter names follow the reference PyTorch
model's state_dict, so its checkpoints load as they are."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn


def mlp(in_features: int, features: Sequence[int], final_act: bool = False) -> nn.Sequential:
    """Linear stack with ReLU between layers (and after the last if
    final_act); the Linears sit at Sequential indices 0, 2, 4, ..."""
    layers: list[nn.Module] = []
    for i, f in enumerate(features):
        layers.append(nn.Linear(in_features, f))
        if i + 1 < len(features) or final_act:
            layers.append(nn.ReLU())
        in_features = f
    return nn.Sequential(*layers)


class ResnetBlockFC(nn.Module):
    """Fully-connected ResNet block: pre-activation two-layer MLP with a
    zero-initialised second layer and a bias-free linear shortcut when the
    width changes."""

    def __init__(self, size_in: int, size_out: int, size_h: int | None = None):
        super().__init__()
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        nn.init.zeros_(self.fc_1.weight)
        self.shortcut = (nn.Linear(size_in, size_out, bias=False)
                         if size_in != size_out else None)

    def forward(self, x):
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + dx


class MaskedBatchNorm(nn.Module):
    """BatchNorm over channel dim 1 where only masked rows count.

    Used for [N, C] point sets (with a mask) and [N, C, H, W] maps (without).
    eps 1e-5; running statistics move by 0.1 of the batch statistic (flax
    momentum 0.9) and keep the biased batch variance — torch's own
    BatchNorm keeps the unbiased one, so the port has its own.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        # kept so reference checkpoints (torch BatchNorm) load as they are
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[1] = -1
        if self.training:
            dims = [d for d in range(x.dim()) if d != 1]
            if mask is None:
                mean = x.mean(dim=dims)
                var = ((x - mean.reshape(shape)) ** 2).mean(dim=dims)
            else:
                m = mask.to(x.dtype).reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
                count = torch.clamp(m.sum(), min=1.0)
                mean = (x * m).sum(dim=dims) / count
                var = (((x - mean.reshape(shape)) ** 2) * m).sum(dim=dims) / count
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + self.eps)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


class SegHead1D(nn.Module):
    """Linear -> masked BN -> ReLU -> Linear over [N, C] rows."""

    def __init__(self, in_channels: int, out_channel: int):
        super().__init__()
        mid = max(in_channels, out_channel)
        self.seg_head = nn.Sequential(
            nn.Linear(in_channels, mid), MaskedBatchNorm(mid), nn.ReLU(),
            nn.Linear(mid, out_channel),
        )

    def forward(self, x, mask=None):
        x = self.seg_head[1](self.seg_head[0](x), mask)
        return self.seg_head[3](torch.relu(x))


class SegHead2D(nn.Module):
    """Conv3x3 -> BN -> ReLU -> Conv3x3 over NHWC maps [N, H, W, C] -> [N, H, W, out].
    The convs run on the NCHW view of the NHWC tensor (channels-last
    memory), so no layout copy is made."""

    def __init__(self, in_channels: int, out_channel: int):
        super().__init__()
        mid = max(in_channels, out_channel)
        self.seg_head = nn.Sequential(
            nn.Conv2d(in_channels, mid, 3, padding=1), MaskedBatchNorm(mid), nn.ReLU(),
            nn.Conv2d(mid, out_channel, 3, padding=1),
        )

    def forward(self, x):
        return self.seg_head(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
