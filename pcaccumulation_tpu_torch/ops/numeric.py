"""Gradient-safe elementary ops: the squared norm is clamped at a tiny
floor, so zero rows (everywhere in padded, masked tensors) give a zero
gradient instead of NaN."""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12,
              keepdim: bool = False) -> torch.Tensor:
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps))
