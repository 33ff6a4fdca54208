"""Checkpoint save / restore (the port's own format).

One `torch.save` file of {epoch, model (state_dict), optimizer (its
state_dict), best_loss, best_metric}, written as the rolling
`model_best_loss` / `model_best_metric` / `model_latest` checkpoints, and
`partial_load`, which keeps only the saved entries whose name and shape
match the model (the JAX package's `partial_load` semantics). Reading the
JAX package's checkpoints is not supported.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, state: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file


def load_checkpoint(path: str) -> dict:
    """Tensors come back on the CPU; load_state_dict moves them."""
    return torch.load(path, map_location="cpu", weights_only=True)


def partial_load(saved: dict, current: dict) -> dict:
    """`current` (a state_dict) with every entry that `saved` holds under
    the same name and shape replaced by the saved one."""
    out = dict(current)
    for k, v in saved.items():
        if k in out and tuple(v.shape) == tuple(out[k].shape):
            out[k] = v
    return out
