"""Masked multi-class Lovász-Softmax loss (the port of the JAX package's
`ops/lovasz.py`).

Invalid entries get error 0 and fg 0, which sorts them to the tail where
the dot product term vanishes; classes with no positives among valid
entries are left out of the mean. The sort is stable, as JAX's is: tied
errors are common (every invalid row has error 0), and an unstable sort
would route their gradient to other rows.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors [P]."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / torch.clamp(union, min=_EPS)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """probas [P, C] class probabilities; labels [P] int in [0, C); valid
    [P] bool (None = all). Returns the mean over classes present among the
    valid entries."""
    p, c = probas.shape
    if valid is None:
        valid = torch.ones(p, dtype=torch.bool, device=probas.device)
    validf = valid.to(probas.dtype)
    losses, present = [], []
    for cls in range(c):
        fg = ((labels == cls) & valid).to(probas.dtype)
        errors = (fg - probas[:, cls]).abs() * validf
        order = torch.argsort(-errors, stable=True)  # descending, ties in index order
        losses.append(torch.dot(errors[order], _lovasz_grad(fg[order])))
        present.append((fg.sum() > 0).to(probas.dtype))
    losses = torch.stack(losses)
    present = torch.stack(present)
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0)
