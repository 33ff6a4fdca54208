"""Checkpoint save / restore.

The port's own format: one `torch.save` file of {epoch, model
(state_dict), optimizer (its state_dict), best_loss, best_metric}, written
as the rolling `model_best_loss` / `model_best_metric` / `model_latest`
checkpoints, and `partial_load`, which keeps only the saved entries whose
name and shape match the model (the JAX package's `partial_load`
semantics).

`load_checkpoint` also reads the JAX package's pickle checkpoints (its
`utils/checkpoint.py`, backend "pickle"): one pickle of a host-numpy tree
{epoch, params, batch_stats, opt_state, best_loss, best_metric}. Its
`opt_state` holds optax NamedTuples; the unpickler maps every class of
optax, flax, chex and jax to an inert stand-in that keeps its fields, so
nothing of them is imported, and refuses every other class but numpy's.
`model_state` turns either form into the port's state_dict (the JAX trees
through `utils/weights.py::state_dict_from_jax`). The JAX package's orbax
directories are refused.
"""

from __future__ import annotations

import os
import pickle
import zipfile

import torch

from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax

# the packages whose classes a JAX checkpoint may name; none is imported
_JAX_FAMILY = ("optax", "flax", "chex", "jax", "jaxlib")


class Inert:
    """Stands for a class of optax, flax, chex or jax named in a JAX
    checkpoint: keeps the arguments it was built with (a NamedTuple's
    fields, which pickle passes to `__new__`) and its state."""

    def __new__(cls, *args, **kwargs):
        self = super().__new__(cls)
        self.args, self.kwargs = args, kwargs
        return self

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"{type(self).__qualname__}{self.args}"


class _JaxUnpickler(pickle.Unpickler):
    _stubs: dict = {}

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _JAX_FAMILY:
            key = (module, name)
            if key not in self._stubs:
                self._stubs[key] = type(name, (Inert,), {"__module__": module,
                                                         "__qualname__": name})
            return self._stubs[key]
        if module.split(".")[0] == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a JAX checkpoint names {module}.{name}, which the "
                                     f"port does not read")


def save_checkpoint(path: str, state: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file


def load_checkpoint(path: str) -> dict:
    """A checkpoint of either package. The port's (a zip, `torch.save`):
    tensors come back on the CPU; load_state_dict moves them. The JAX
    package's pickle: its host-numpy tree, optax states as `Inert`."""
    if not os.path.isfile(path):
        if os.path.isdir(os.path.abspath(path) + ".orbax"):
            raise NotImplementedError(
                f"{path}: the JAX package's orbax checkpoints are not read by the port; "
                "save with --train.ckpt_backend=pickle")
        raise FileNotFoundError(path)
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        return _JaxUnpickler(f).load()


def model_state(state: dict) -> dict:
    """The model's state_dict in a loaded checkpoint of either package."""
    if "model" in state:
        return state["model"]
    return state_dict_from_jax(state["params"], state["batch_stats"])


def partial_load(saved: dict, current: dict) -> dict:
    """`current` (a state_dict) with every entry that `saved` holds under
    the same name and shape replaced by the saved one. A saved [1] entry
    matches a 0-d one (the JAX package's scalar parameters, such as the ego
    head's alpha and beta, are [1]), as `load_state_dict` allows."""
    out = dict(current)
    for k, v in saved.items():
        if k not in out:
            continue
        if tuple(v.shape) == tuple(out[k].shape):
            out[k] = v
        elif out[k].dim() == 0 and tuple(v.shape) == (1,):
            out[k] = v.reshape(())
    return out
