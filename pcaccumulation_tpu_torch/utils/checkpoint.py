"""Checkpoint save / restore.

The port's state: {epoch, model (state_dict), optimizer, best_loss,
best_metric}, written as the rolling `model_best_loss` /
`model_best_metric` / `model_latest` checkpoints by one of two backends,
the JAX package's names for them (`train.ckpt_backend`):
- "pickle": one `torch.save` file at the path, written by rank 0;
- "orbax": a `torch.distributed.checkpoint` (DCP) directory `<path>.dcp/`,
  written by every rank of the run together. Under ZeRO-1 each rank writes
  the optimizer entries of the parameters it owns, under their names, so a
  checkpoint of any number of ranks restores into any other.
As in the JAX package, a save removes what the other backend left at the
same path (the reader would take the older one), and overwrites its own.

`read_checkpoint` is the one reader of the Trainer, the Tester and the
Predictor. It sniffs what lies at the path and reads four forms into the
port's state ({"model", "optimizer" or None, and epoch / best_loss /
best_metric where the form has them}):
- the port's `torch.save` file;
- the JAX package's pickle (`params`, `batch_stats`, `opt_state`): the
  trees through `utils/weights.py::state_dict_from_jax`; the optax state
  does not map (optimizer None). Its unpickler maps every class of optax,
  flax, chex and jax to an inert stand-in that keeps its fields, so
  nothing of them is imported, and refuses every other class but numpy's;
- the reference's `.pth` (`{'state_dict': sd, ...}` or a bare state_dict):
  the reference's names are the port's; its torch.optim state does not map;
- a DCP directory, given as `<path>` or `<path>.dcp`.
The JAX package's orbax directories (`<path>.orbax/`) are refused.
`partial_load` keeps the saved entries whose name and shape match the
model (the JAX package's `partial_load` semantics).
"""

from __future__ import annotations

import os
import pickle
import shutil
import warnings
import zipfile

import torch
import torch.distributed as dist

from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax

# the packages whose classes a JAX checkpoint may name; none is imported
_JAX_FAMILY = ("optax", "flax", "chex", "jax", "jaxlib")
_META = ("epoch", "best_loss", "best_metric")


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


def _dcp_dir(path: str) -> str:
    return os.path.abspath(path) + ".dcp"


def _barrier(group) -> None:
    if group is not None:
        dist.barrier(group)


def _flatten(state: dict) -> dict:
    """The port's state as DCP's flat keys: model/<name>,
    optimizer/<acc|mu|nu>/<parameter name>, optimizer/<counter>, <meta>."""
    flat = {f"model/{k}": v for k, v in state["model"].items()}
    for key, v in state["optimizer"].items():
        if isinstance(v, dict):
            flat.update({f"optimizer/{key}/{n}": t for n, t in v.items()})
        else:
            flat[f"optimizer/{key}"] = v
    flat.update({k: state[k] for k in _META if k in state})
    return flat


def _unflatten(flat: dict) -> dict:
    out: dict = {"model": {}, "optimizer": {}}
    for k, v in flat.items():
        head, _, rest = k.partition("/")
        if head == "model":
            out["model"][rest] = v
        elif head == "optimizer":
            sub, _, name = rest.partition("/")
            if name:
                out["optimizer"].setdefault(sub, {})[name] = v
            else:
                out["optimizer"][sub] = v
        else:
            out[k] = v
    return out


def save_checkpoint(path: str, state: dict, backend: str = "pickle", group=None) -> None:
    """Write `state` at `path` (see the module docstring). "pickle": the
    caller writes on one rank. "orbax": every rank of `group` (None: one
    process) calls this together, with its own optimizer entries by name."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if backend == "pickle":
        shutil.rmtree(_dcp_dir(path), ignore_errors=True)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written file
    elif backend == "orbax":
        import torch.distributed.checkpoint as dcp

        target = _dcp_dir(path)
        tmp = target + ".tmp"
        main = group is None or dist.get_rank(group) == 0
        if main:
            shutil.rmtree(tmp, ignore_errors=True)
        _barrier(group)
        with warnings.catch_warnings():  # "assuming ... a single process": asked for
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
            dcp.save(_flatten(state), checkpoint_id=tmp, process_group=group,
                     no_dist=group is None)
        _barrier(group)
        if main:
            if os.path.isfile(path):
                os.remove(path)
            shutil.rmtree(target, ignore_errors=True)  # the rolling overwrite
            os.replace(tmp, target)
        _barrier(group)
    else:
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def _load_dcp(path: str) -> dict:
    """Every entry of a DCP directory, on the CPU, read by this process alone."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    flat = {k: (torch.empty(m.size, dtype=m.properties.dtype)
                if isinstance(m, TensorStorageMetadata) else 0) for k, m in meta.items()}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        dcp.load(flat, checkpoint_id=path, no_dist=True)
    return _unflatten(flat)


def load_checkpoint(path: str) -> dict:
    """What lies at `path`, as it was saved: a `torch.save` file (the port's,
    or the reference's `.pth`; tensors on the CPU), the JAX package's pickle
    (its host-numpy tree, optax states as `Inert`), or a DCP directory
    (`path` itself or `<path>.dcp`, nested as the port's state)."""
    if os.path.isfile(path):
        if zipfile.is_zipfile(path):
            return torch.load(path, map_location="cpu", weights_only=True)
        with open(path, "rb") as f:
            return _JaxUnpickler(f).load()
    for d in (path, _dcp_dir(path)):
        if os.path.isfile(os.path.join(d, ".metadata")):
            return _load_dcp(d)
    if os.path.isdir(os.path.abspath(path) + ".orbax"):
        raise NotImplementedError(
            f"{path}: the JAX package's orbax checkpoints are not read by the port; save "
            "them with the JAX package's --train.ckpt_backend=pickle")
    raise FileNotFoundError(path)


def read_checkpoint(path: str) -> dict:
    """The port's state of any of the four forms (see the module docstring):
    {"model": state_dict, "optimizer": the port's optimizer state or None,
    and epoch / best_loss / best_metric where the checkpoint has them}."""
    raw = load_checkpoint(path)
    if "model" in raw:                          # the port's file, a DCP directory
        model, opt = raw["model"], raw.get("optimizer")
    elif "params" in raw:                       # the JAX package's pickle
        model, opt = state_dict_from_jax(raw["params"], raw["batch_stats"]), None
    elif "state_dict" in raw:                   # the reference's .pth
        model, opt = raw["state_dict"], None
    elif raw and all(torch.is_tensor(v) for v in raw.values()):
        model, opt = raw, None                  # a bare state_dict
    else:
        raise ValueError(f"{path}: not a checkpoint of the port, the JAX package or the "
                         f"reference (keys {sorted(raw)[:8]})")
    out = {"model": model, "optimizer": opt or None}
    out.update({k: raw[k] for k in _META if k in raw})
    return out


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
