"""Weighted Kabsch with a gradient-safe SVD (the port of the JAX package's
`ops/kabsch.py`)."""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

_EPS = 1e-7
_SVD_EPS = 1e-10


def safe_svd_backward(u, s, vh, du, ds, dvh):
    """Gradient of the SVD a = u diag(s) vh for the cotangents (du, ds, dvh),
    with F_ij = gap / (gap^2 + 1e-10), gap = s_j^2 - s_i^2, in place of
    1 / gap (the JAX package's `_safe_svd_bwd`): finite on repeated
    singular values, where `torch.linalg.svd`'s own backward gives inf or
    NaN."""
    v = vh.transpose(-1, -2)
    dv = dvh.transpose(-1, -2)
    s2 = s * s
    gap = s2[..., None, :] - s2[..., :, None]
    f = gap / (gap * gap + _SVD_EPS)  # zero on the diagonal
    ut_du = u.transpose(-1, -2) @ du
    vt_dv = v.transpose(-1, -2) @ dv
    j_u = f * (ut_du - ut_du.transpose(-1, -2))
    j_v = f * (vt_dv - vt_dv.transpose(-1, -2))
    inner = j_u * s[..., None, :] + s[..., :, None] * j_v + torch.diag_embed(ds)
    return u @ inner @ vh


class SafeSVD(torch.autograd.Function):
    """(u, s, vh) = torch.linalg.svd(a, full_matrices=False) with
    `safe_svd_backward` as its gradient."""

    @staticmethod
    def forward(ctx, a):
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        ctx.save_for_backward(u, s, vh)
        return u, s, vh

    @staticmethod
    @once_differentiable
    def backward(ctx, du, ds, dvh):
        return safe_svd_backward(*ctx.saved_tensors, du, ds, dvh)


def safe_svd(a: torch.Tensor):
    return SafeSVD.apply(a)


def weighted_kabsch(xs: torch.Tensor, xt: torch.Tensor,
                    weights: torch.Tensor | None = None):
    """Weighted Procrustes: R, t with R @ xs + t ~= xt.

    xs, xt [..., N, 3]; weights [..., N] non-negative (None = uniform).
    Returns rot [..., 3, 3], trans [..., 3]. The determinant correction
    makes R independent of the signs the SVD picks for its vectors.
    """
    if weights is None:
        weights = torch.ones(xs.shape[:-1], dtype=xs.dtype, device=xs.device)
    w = (weights / (torch.sum(weights, dim=-1, keepdim=True) + _EPS))[..., None]

    mu_s = torch.sum(xs * w, dim=-2, keepdim=True)
    mu_t = torch.sum(xt * w, dim=-2, keepdim=True)
    cov = ((xs - mu_s) * w).transpose(-1, -2) @ (xt - mu_t)  # [..., 3, 3]

    u, _, vt = safe_svd(cov)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    d = torch.cat([torch.ones(cov.shape[:-2] + (2,), dtype=cov.dtype, device=cov.device),
                   det[..., None]], dim=-1)
    rot = (v * d[..., None, :]) @ ut
    trans = mu_t[..., 0, :] - torch.einsum("...ij,...j->...i", rot, mu_s[..., 0, :])
    return rot, trans
