"""Weighted Kabsch (the port of the JAX package's `ops/kabsch.py`,
forward; the gradient-safe SVD backward comes with training)."""

from __future__ import annotations

import torch

_EPS = 1e-7


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

    u, _, vt = torch.linalg.svd(cov, full_matrices=False)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    d = torch.ones(cov.shape[:-2] + (3,), dtype=cov.dtype, device=cov.device)
    d[..., 2] = det
    rot = (v * d[..., None, :]) @ ut
    trans = mu_t[..., 0, :] - torch.einsum("...ij,...j->...i", rot, mu_s[..., 0, :])
    return rot, trans
