"""Log-domain Sinkhorn normalisation with a slack row and column (the port
of the JAX package's `ops/sinkhorn.py`)."""

from __future__ import annotations

import torch


def log_sinkhorn(log_alpha: torch.Tensor, n_iters: int, slack: bool = True) -> torch.Tensor:
    """Sinkhorn iterations in log space over [..., J, K].

    With slack, the log-affinity is padded with a zero slack row and
    column; rows (all but the slack row) and columns (all but the slack
    column) are log-normalised in turn. Returns [..., J, K], slack removed.
    """
    if not slack:
        la = log_alpha
        for _ in range(n_iters):
            la = la - torch.logsumexp(la, dim=-1, keepdim=True)
            la = la - torch.logsumexp(la, dim=-2, keepdim=True)
        return la

    j, k = log_alpha.shape[-2:]
    padded = log_alpha.new_zeros(log_alpha.shape[:-2] + (j + 1, k + 1))
    padded[..., :j, :k] = log_alpha
    for _ in range(n_iters):
        rows = padded[..., :j, :]
        padded = torch.cat(
            [rows - torch.logsumexp(rows, dim=-1, keepdim=True), padded[..., j:, :]],
            dim=-2)
        cols = padded[..., :, :k]
        padded = torch.cat(
            [cols - torch.logsumexp(cols, dim=-2, keepdim=True), padded[..., :, k:]],
            dim=-1)
    return padded[..., :j, :k]


def square_distance(a: torch.Tensor, b: torch.Tensor, normalised: bool = False) -> torch.Tensor:
    """Pairwise squared L2 distance between [..., N, C] and [..., M, C],
    floored at 1e-12. For L2-normalised features it is 2 - 2 a.b^T."""
    ab = a @ b.transpose(-1, -2)
    if normalised:
        dist = 2.0 - 2.0 * ab
    else:
        aa = torch.sum(a * a, dim=-1)[..., :, None]
        bb = torch.sum(b * b, dim=-1)[..., None, :]
        dist = aa + bb - 2.0 * ab
    return torch.clamp(dist, min=1e-12)
