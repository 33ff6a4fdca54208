"""Per-(row, channel block) row shift: kernels K2 and K3, their gradients
and their plain version.

`row_shift_blocks(img, shifts, n_blocks)` shifts each row of img
[R, W, n_blocks*C] along W by a fractional amount that differs per channel
block: out[r, j] = img[r, j + s] with linear interpolation and zeros
outside the row. One call warps every frame of a folded [H, W, T*C] BEV
canvas. On a CUDA tensor it launches the kernel of `csrc/row_shift.cu`
(which replaces the TPU kernel
`pcaccumulation_tpu/ops/bilinear.py::_row_shift_blocks_pallas`); on a CPU
tensor it runs `row_shift_blocks_plain`. Its forward is the PyTorch operator
`torch.ops.pcacc.row_shift_blocks` (`row_shift_blocks_op`), so that a graph
recorded by `torch.export` calls it.

`row_shift(img, shifts)` is the same with one shift per row: the TPU kernel
`ops/bilinear.py::_row_shift_pallas` (K3), behind `warp_bev` and
`warp_bev_batch`. On the card it launches the same kernel at n_blocks=1,
counted on its own (`row_shift.launches`).

img may be float32 or bfloat16. A bf16 image goes to the bf16 kernel
(`row_shift_blocks_forward_bf16`, the TPU kernel's bf16 case, the one the
shear warp runs under `precision.compute_dtype: bfloat16`): the taps
widened to float32, the lerp in float32 at a float32 f, the output rounded
to bf16 once at the store; the plain version computes in float32 and casts
once. It is never cast to float32 for the float32 kernel. Its launches
count on `row_shift_blocks.launches_bf16` (`row_shift.launches_bf16` for
K3), the float32 kernel's on `.launches`.

Their gradient (`RowShift`) is the JAX package's custom VJP
(`ops/bilinear.py::_make_row_shift_blocks`, `_row_shift_sample`): the same
kernel at -shifts for the image, zero for the shifts. That is not the exact
transpose of the lerp at the row ends, and the port follows JAX, not
autograd. A bf16 cotangent goes to the bf16 kernel at -shifts (float32
lerp, one rounding), counted on `row_shift_blocks_backward.launches_bf16`
(`row_shift_backward.launches_bf16` for K3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pcaccumulation_tpu_torch.kernels import build


def row_shift_blocks_plain(img: torch.Tensor, ki: torch.Tensor, f: torch.Tensor,
                           n_blocks: int) -> torch.Tensor:
    """Plain PyTorch version: per channel block, gather the shifted window
    of a zero-padded row and lerp its two taps. ki int [R, n_blocks] in
    [-W, W], f float [R, n_blocks]. A bf16 image is shifted in float32
    (float32 f) and the result cast to bf16 once."""
    if img.dtype == torch.bfloat16:
        return row_shift_blocks_plain(img.float(), ki, f.float(), n_blocks).to(img.dtype)
    r, w, ctot = img.shape
    c = ctot // n_blocks
    padded = F.pad(img, (0, 0, w, w + 1))  # [R, 3W+1, ctot]
    win = torch.arange(w + 1, device=img.device)[None, :] + w  # [1, W+1]
    outs = []
    for b in range(n_blocks):
        pos = (win + ki[:, b:b + 1].long())[..., None].expand(r, w + 1, c)
        sl = torch.gather(padded[:, :, b * c:(b + 1) * c], 1, pos)  # [R, W+1, C]
        fr = f[:, b, None, None].to(img.dtype)
        outs.append(sl[:, :w] * (1.0 - fr) + sl[:, 1:] * fr)
    return torch.cat(outs, dim=-1)


def _split(shifts: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """shift -> (k = floor(s) clipped to [-W, W] as int32, f = s - floor(s))."""
    k = torch.floor(shifts)
    return k.clamp(-w, w).to(torch.int32), (shifts - k).to(torch.float32)


def _shift(img: torch.Tensor, shifts: torch.Tensor, n_blocks: int,
           sign: float = 1.0) -> tuple[torch.Tensor, bool]:
    """The shift at sign * shifts: the kernel of img's dtype on a CUDA
    tensor (one launch, which splits the shifts itself), the plain version
    on a CPU tensor. Returns (out, launched)."""
    r, w, ctot = img.shape
    if not img.is_cuda:
        return row_shift_blocks_plain(img, *_split(sign * shifts, w), n_blocks), False
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"row_shift_blocks kernel takes float32 or bfloat16, got {img.dtype}")
    img = img.contiguous()
    shifts = shifts.to(torch.float32).contiguous()
    out = torch.empty_like(img)
    lib = build.load_library("row_shift")
    entry = (lib.row_shift_blocks_forward_bf16 if img.dtype == torch.bfloat16
             else lib.row_shift_blocks_forward)
    rc = entry(img.data_ptr(), shifts.data_ptr(), out.data_ptr(), r, w, ctot, n_blocks, sign,
               build.stream(img))
    build.check(rc, "row_shift")
    return out, True


def row_shift_blocks_backward(g: torch.Tensor, shifts: torch.Tensor,
                              n_blocks: int) -> torch.Tensor:
    """Gradient of `row_shift_blocks` for the image, given the cotangent g
    (float32 or bfloat16) of its output: the same shift at -shifts (one K2
    launch of g's dtype on a CUDA tensor, the plain version on a CPU
    tensor)."""
    out, launched = _shift(g, shifts, n_blocks, -1.0)
    _count(row_shift_blocks_backward, g, launched)
    return out


def row_shift_backward(g: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Gradient of `row_shift` for the image: the shift at -shifts [R, 1]."""
    out, launched = _shift(g, shifts, 1, -1.0)
    _count(row_shift_backward, g, launched)
    return out


@torch.library.custom_op("pcacc::row_shift_blocks", mutates_args=(), device_types="cuda")
def row_shift_blocks_op(img: torch.Tensor, shifts: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The K2 forward as a PyTorch operator (`torch.ops.pcacc.row_shift_blocks`),
    so that `torch.export` records it in a graph. On CUDA tensors: the
    kernel of img's dtype, one launch on `row_shift_blocks.launches` or
    `.launches_bf16`; a failed build or launch raises. On CPU tensors:
    `row_shift_blocks_plain`."""
    out, launched = _shift(img, shifts, n_blocks)
    _count(row_shift_blocks, img, launched)
    return out


@row_shift_blocks_op.register_kernel("cpu")
def _row_shift_blocks_cpu(img: torch.Tensor, shifts: torch.Tensor,
                          n_blocks: int) -> torch.Tensor:
    return _shift(img, shifts, n_blocks)[0]


@row_shift_blocks_op.register_fake
def _row_shift_blocks_fake(img: torch.Tensor, shifts: torch.Tensor,
                           n_blocks: int) -> torch.Tensor:
    return torch.empty_like(img)


def _row_shift_k3(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """K3's forward: the shift with one block, counted on `row_shift`."""
    out, launched = _shift(img, shifts, 1)
    _count(row_shift, img, launched)
    return out


class RowShift(torch.autograd.Function):
    """A row shift with the JAX package's gradient. `forward_fn(img, shifts)`
    is the counted forward; `backward_fn(g, shifts)` is the gradient
    wrapper (with its own count)."""

    @staticmethod
    def forward(ctx, img, shifts, forward_fn, backward_fn):
        ctx.backward_fn = backward_fn
        ctx.save_for_backward(shifts)
        return forward_fn(img, shifts)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (shifts,) = ctx.saved_tensors
        return ctx.backward_fn(g, shifts), torch.zeros_like(shifts), None, None


def _check(img: torch.Tensor, shifts: torch.Tensor, n_blocks: int, what: str) -> None:
    r, w, ctot = img.shape
    if ctot % n_blocks or shifts.shape != (r, n_blocks):
        raise ValueError(f"{what}: img {tuple(img.shape)}, shifts {tuple(shifts.shape)}, "
                         f"n_blocks {n_blocks}")
    dev = img.device
    if shifts.device != dev or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: img on {dev}, shifts on {shifts.device}")


def _count(counted, img: torch.Tensor, launched: bool) -> None:
    """Add a launch to the count of the kernel of img's dtype."""
    if img.dtype == torch.bfloat16:
        counted.launches_bf16 += launched
    else:
        counted.launches += launched


def _apply(img, shifts, forward_fn, backward_fn) -> torch.Tensor:
    """Through `RowShift` where a gradient is wanted; else the counted
    forward alone (no autograd node to build)."""
    if torch.is_grad_enabled() and (img.requires_grad or shifts.requires_grad):
        return RowShift.apply(img, shifts, forward_fn, backward_fn)
    return forward_fn(img, shifts)


def row_shift_blocks(img: torch.Tensor, shifts: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """img [R, W, n_blocks*C] float32 or bfloat16; shifts [R, n_blocks]
    float32.

    The shift splits into k = floor(s), clipped to [-W, W] (|rotation| <=
    90 deg), and f = s - floor(s). A CPU tensor goes to the plain version;
    a CUDA tensor goes to the kernel or raises. The kernel rounds as the
    plain version does (a bf16 output is the float32 result rounded once).
    Differentiable in img through `RowShift`, in either dtype; the forward
    is the operator `row_shift_blocks_op`.
    """
    _check(img, shifts, n_blocks, "row_shift_blocks")
    return _apply(img, shifts, lambda i, s: row_shift_blocks_op(i, s, n_blocks),
                  lambda g, s: row_shift_blocks_backward(g, s, n_blocks))


def row_shift(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """img [R, W, C] float32 or bfloat16; shifts [R] float32: out[r, j] = img[r, j + s_r]
    with linear interpolation, zeros outside the row (`row_shift_blocks`
    with one block; K3's own launch count)."""
    shifts = shifts[:, None]
    _check(img, shifts, 1, "row_shift")
    return _apply(img, shifts, _row_shift_k3, row_shift_backward)


row_shift_blocks.launches = 0  # float32 forward launches (one per call that reached the card)
row_shift_blocks.launches_bf16 = 0  # bf16 forward launches
row_shift_blocks_backward.launches = 0  # float32 gradient launches
row_shift_blocks_backward.launches_bf16 = 0  # bf16 gradient launches
row_shift.launches = 0  # K3: float32 forward launches at one shift per row
row_shift.launches_bf16 = 0
row_shift_backward.launches = 0
row_shift_backward.launches_bf16 = 0
