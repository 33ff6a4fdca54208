"""Shared building blocks (the port of the JAX package's `models/layers.py`,
plain forms). Module and parameter names follow the reference PyTorch
model's state_dict, so its checkpoints load as they are.

Compute dtype. A module built with `compute_dtype=torch.bfloat16` computes
as the flax module with `dtype=jnp.bfloat16` does: its parameters stay
float32 and are cast at use, with the input, to the compute dtype (flax's
`promote_dtype`), and its output is in the compute dtype. As in flax, a
product or convolution is rounded to the compute dtype before its bias is
added in that dtype (a bias fused into the product would round once, and
differ from the JAX package in ~30 % of the outputs by an ulp). A BatchNorm
with a compute dtype takes one of the JAX package's two forms (see
`MaskedBatchNorm`). `SegHead2D`
returns its input's dtype unless built with `keep_compute_dtype=True`. No
autocast: the casts land where the JAX package's land. `compute_dtype=None`
is the float32 model.

Initialisation. Each Linear / Conv layer carries the init kind of the JAX
parameter it stands for (`init`: "lecun", "xavier" or "zeros"), which
`utils.weights.init_parameters` draws from; torch's own default
initialisation is overwritten there.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pcaccumulation_tpu_torch.parallel.mesh import global_sum


def _apply_cast(op, cd: torch.dtype, x: torch.Tensor, weight: torch.Tensor, bias):
    """op(x, weight) in the compute dtype cd, then + bias in cd."""
    out = op(x.to(cd), weight.to(cd))
    return out if bias is None else out + bias.to(cd).reshape((-1,) + (1,) * (out.dim() - 2))


class Linear(nn.Linear):
    """nn.Linear that computes in `compute_dtype` where it is set."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype | None = None, init: str = "lecun"):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype
        self.init_kind = init

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        out = F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))
        return out if self.bias is None else out + self.bias.to(self.compute_dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in `compute_dtype` where it is set.

    Band mode (`halo`, a `parallel.mesh.halo_rows` exchange): x is one
    band of an image's rows; the exchange adds the `padding[0]` rows above
    and below it from the neighbouring bands (zeros at the image's edges),
    and the convolution pads in W alone, so each band's output rows are
    those of the whole image's convolution."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, init: str = "lecun",
                 **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype
        self.init_kind = init

    def forward(self, x, halo=None):
        if halo is None:
            conv = self._conv_forward
        else:  # the UNet's 3x3 convolutions: zero padding, stride 1
            x = halo(x, self.padding[0])
            pad = (0, self.padding[1])

            def conv(a, w, b):
                return F.conv2d(a, w, b, self.stride, pad, self.dilation, self.groups)
        if self.compute_dtype is None:
            return conv(x, self.weight, self.bias)
        return _apply_cast(lambda a, w: conv(a, w, None), self.compute_dtype, x,
                           self.weight, self.bias)


class Conv3d(nn.Conv3d):
    """nn.Conv3d that computes in `compute_dtype` where it is set."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, init: str = "lecun",
                 **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype
        self.init_kind = init

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        op = lambda a, w: self._conv_forward(a, w, None)  # noqa: E731
        if x.device.type == "cpu" and self.compute_dtype == torch.bfloat16:
            # oneDNN's bf16 Conv3d weight gradient is NaN in one CPU thread
            # and varies between runs in several: the CPU takes float32
            # products of the bf16 values, rounded once, as a bf16
            # convolution that sums in float32 does
            op = lambda a, w: self._conv_forward(a.float(), w.float(), None).to(a.dtype)  # noqa: E731
        return _apply_cast(op, self.compute_dtype, x, self.weight, self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d that computes in `compute_dtype` where it is set."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, init: str = "lecun",
                 **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype
        self.init_kind = init

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        return _apply_cast(
            lambda a, w: F.conv_transpose2d(a, w, None, self.stride, self.padding,
                                            self.output_padding, self.groups, self.dilation),
            self.compute_dtype, x, self.weight, self.bias)


def mlp(in_features: int, features: Sequence[int], final_act: bool = False,
        compute_dtype: torch.dtype | None = None) -> nn.Sequential:
    """Linear stack with ReLU between layers (and after the last if
    final_act); the Linears sit at Sequential indices 0, 2, 4, ..."""
    layers: list[nn.Module] = []
    for i, f in enumerate(features):
        layers.append(Linear(in_features, f, compute_dtype=compute_dtype))
        if i + 1 < len(features) or final_act:
            layers.append(nn.ReLU())
        in_features = f
    return nn.Sequential(*layers)


class ResnetBlockFC(nn.Module):
    """Fully-connected ResNet block: pre-activation two-layer MLP with a
    zero-initialised second layer and a bias-free linear shortcut when the
    width changes."""

    def __init__(self, size_in: int, size_out: int, size_h: int | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = Linear(size_in, size_h, compute_dtype=compute_dtype)
        self.fc_1 = Linear(size_h, size_out, compute_dtype=compute_dtype, init="zeros")
        self.shortcut = (Linear(size_in, size_out, bias=False, compute_dtype=compute_dtype)
                         if size_in != size_out else None)

    def forward(self, x):
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + dx


class MaskedBatchNorm(nn.Module):
    """BatchNorm over channel dim 1 where only masked rows count.

    Used for [N, C] point sets (with a mask) and [N, C, H, W] maps (without).
    eps 1e-5; running statistics move by 0.1 of the batch statistic (flax
    momentum 0.9) and keep the biased batch variance — torch's own
    BatchNorm keeps the unbiased one, so the port has its own. In train
    mode the statistics are sums and counts over the whole batch: in a
    data-parallel step (`parallel.mesh`) they are summed over the ranks,
    so every rank normalises with, and keeps, the joined batch's statistics.

    With a compute dtype (the 2-D heads' BatchNorm, no mask) it takes the
    form of the JAX module it stands for; the statistics are float32 sums
    of the input widened to float32 in both, and the gradient flows through
    them in train mode:
    - flax's `BatchNorm(dtype=...)` (`s2d=False`): variance E[x^2] - E[x]^2
      clipped at 0, normalisation (x - mean) * (rsqrt(var + eps) * scale) +
      bias in float32, rounded to the compute dtype once;
    - the JAX package's `S2DBatchNorm` (`s2d=True`, the heads that the JAX
      model runs in space-to-depth layout): variance E[x^2] - E[x]^2 not
      clipped, mul = scale / sqrt(var + eps) and add = bias - mean * scale /
      sqrt(var + eps) rounded to the compute dtype, and x * mul + add in the
      compute dtype, each operation rounded.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 compute_dtype: torch.dtype | None = None, s2d: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.compute_dtype = compute_dtype
        self.s2d = s2d
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        # kept so reference checkpoints (torch BatchNorm) load as they are
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked += 1

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[1] = -1
        dims = [d for d in range(x.dim()) if d != 1]
        if self.compute_dtype is not None:
            if mask is not None:
                raise ValueError("a BatchNorm with a compute dtype takes no mask")
            return self._forward_cast(x, shape, dims)
        if self.training:
            if mask is None:
                m = None
                count = x.new_full((), x.numel() // x.shape[1])  # a fill, no host copy
                sums = x.sum(dim=dims)
            else:
                m = mask.to(x.dtype).reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
                count = m.sum()
                sums = (x * m).sum(dim=dims)
            sums = global_sum(torch.cat([sums, count[None]]))
            count = torch.clamp(sums[-1], min=1.0)
            mean = sums[:-1] / count
            dev2 = (x - mean.reshape(shape)) ** 2
            var = global_sum((dev2 if m is None else dev2 * m).sum(dim=dims)) / count
            self._update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + self.eps)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)

    def _forward_cast(self, x: torch.Tensor, shape: list, dims: list) -> torch.Tensor:
        """The compute-dtype forms (see the class docstring)."""
        cd = self.compute_dtype
        xf = x.float()
        if self.training:
            c = xf.shape[1]
            sums = global_sum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims),
                                         xf.new_full((1,), xf.numel() // c)]))
            mean = sums[:c] / sums[-1]
            var = sums[c:2 * c] / sums[-1] - mean * mean
            if not self.s2d:
                var = torch.clamp(var, min=0.0)
            self._update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        if self.s2d:
            inv = torch.sqrt(var + self.eps)
            mul = (self.weight / inv).to(cd)
            add = (self.bias - mean * self.weight / inv).to(cd)
            # mul and add broadcast per 2x2 sub-position of the NHWC view (the
            # heads' channels-last maps: no copy), so that their gradients
            # reduce as the JAX module's do: over each sub-position in cd,
            # then over the four
            n, c, h, w = x.shape
            x6 = x.to(cd).permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
            per_sub = (1, 1, 2, 1, 2, c)
            y = x6 * mul.expand(per_sub) + add.expand(per_sub)
            return y.reshape(n, h, w, c).permute(0, 3, 1, 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(cd)


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
    memory), so no layout copy is made. With a compute dtype the input is
    cast to it, and the output is cast back to the input's dtype unless
    `keep_compute_dtype`. `s2d_bn` gives the BatchNorm the form of the JAX
    package's `S2DBatchNorm` (the heads it runs in space-to-depth layout;
    H and W even)."""

    def __init__(self, in_channels: int, out_channel: int,
                 compute_dtype: torch.dtype | None = None, keep_compute_dtype: bool = False,
                 s2d_bn: bool = False):
        super().__init__()
        mid = max(in_channels, out_channel)
        self.compute_dtype = compute_dtype
        self.keep_compute_dtype = keep_compute_dtype
        self.seg_head = nn.Sequential(
            Conv2d(in_channels, mid, 3, padding=1, compute_dtype=compute_dtype),
            MaskedBatchNorm(mid, compute_dtype=compute_dtype, s2d=s2d_bn), nn.ReLU(),
            Conv2d(mid, out_channel, 3, padding=1, compute_dtype=compute_dtype),
        )

    def forward(self, x):
        in_dtype = x.dtype
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        out = self.seg_head(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return out if self.keep_compute_dtype else out.to(in_dtype)
