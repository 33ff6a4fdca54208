"""Layered YAML configuration with dotted CLI overrides.

The port's own copy of the JAX package's `config.py`: a default YAML
overridden by a per-dataset YAML, then `--a.b.c=value` overrides with typed
decoding (bool / int / float / list / str), and the derived voxel-grid
values propagated into the model sections. It reads the repository's
`configs/*.yaml` as data.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any

import numpy as np
import yaml

_DEFAULT = os.path.join(os.path.dirname(__file__), "..", "configs", "default.yaml")


def update_recursive(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict):
            dst.setdefault(k, {})
            update_recursive(dst[k], v)
        else:
            dst[k] = v
    return dst


def decode_value(value: str) -> Any:
    low = value.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if value.startswith("[") and value.endswith("]"):
        items = [v.strip() for v in value[1:-1].split(",") if v.strip()]
        return [decode_value(v) for v in items]
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


def parse_overrides(args: list[str]) -> dict:
    """Parse ['--a.b=1', '--c.d', '2'] into a nested dict."""
    out: dict = {}
    i = 0
    while i < len(args):
        arg = args[i]
        if not arg.startswith("--"):
            raise ValueError(f"override must start with '--': {arg}")
        if "=" in arg:
            key, raw = arg[2:].split("=", 1)
            i += 1
        else:
            key, raw = arg[2:], args[i + 1]
            i += 2
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = decode_value(raw)
    return out


def derive(cfg: dict) -> dict:
    """Propagate voxel-grid parameters into dependent sections and compute
    the static grid shape [nx, ny, nz]."""
    vg = cfg["voxel_generator"]
    pc_range = vg["range"]
    voxel = vg["voxel_size"]
    vg["grid_size"] = [
        int(round((pc_range[i + 3] - pc_range[i]) / voxel[i])) for i in range(3)
    ]
    pe = cfg.setdefault("pillar_encoder", {})
    pe["voxel_size"] = voxel
    pe["pc_range"] = pc_range
    pe["n_sweeps"] = vg["n_sweeps"]
    return cfg


def load_config(path: str | None = None, overrides: list[str] | None = None) -> dict:
    """configs/default.yaml, overridden by the YAML at `path` if given and
    by `--a.b=c` overrides, then derived."""
    with open(os.path.normpath(_DEFAULT)) as f:
        cfg = yaml.safe_load(f)
    if path is not None:
        with open(path) as f:
            update_recursive(cfg, yaml.safe_load(f) or {})
    if overrides:
        update_recursive(cfg, parse_overrides(overrides))
    return derive(cfg)


def _running_world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def check_supported(cfg: dict, world_size: int | None = None, mesh_axes: bool = True) -> None:
    """Raise NotImplementedError for a config value whose feature the port
    does not have, or a mesh geometry that does not fit the processes,
    instead of ignoring it. The port runs one process per card on a
    (data, frame, spatial) mesh (`parallel/mesh.py`) of `world_size`
    processes (by default those of the running process group, else 1).

    `parallel.num_devices` is the mesh's size: the world, or 0 (all of
    them); 1 with `parallel.frame_devices` x `parallel.spatial_devices` =
    F*S > 1 means a mesh of F*S, as in the JAX CLI. F*S must divide the
    world, F be at most the T frames of a sequence, and S at most the
    H / 2^(unet.depth-1) bands the UNet's pools allow. `mesh_axes`: whether
    the caller lays its processes out as the config's mesh (the CLI, the
    Trainer, a Predictor given a mesh); the Tester and a Predictor without
    one run one process's forward whatever the saved F and S say, as the
    JAX package's do outside a mesh. `parallel.zero1` and
    `train.ckpt_backend: pickle | orbax` (orbax: a
    torch.distributed.checkpoint directory) are ported; test mode runs on
    one process, as the JAX CLI's Tester runs on one device."""
    world = _running_world() if world_size is None else world_size
    par = cfg.get("parallel", {})
    train = cfg.get("train", {})
    f, s = par.get("frame_devices", 1), par.get("spatial_devices", 1)
    fs = f * s if mesh_axes else 1
    n_dev = par.get("num_devices", 1)
    size = fs if n_dev == 1 and fs > 1 else (world if n_dev == 0 else n_dev)
    refused = []
    if world % fs:
        refused.append(f"parallel.frame_devices={f} x parallel.spatial_devices={s}: "
                       f"parallel.num_devices (={world} processes; 0 = all local devices) "
                       f"must be a multiple of frame_devices {f} x spatial_devices {s} = {fs}")
    elif size != world:
        refused.append(f"parallel.num_devices={n_dev!r} with {world} process(es): the port runs "
                       "one process per card; launch that many with torchrun "
                       "--nproc_per_node, or set 0 (all)")
    if mesh_axes and f > 1 and f > cfg["voxel_generator"]["n_sweeps"]:
        refused.append(f"parallel.frame_devices={f}: more than the "
                       f"{cfg['voxel_generator']['n_sweeps']} frames of a sequence")
    if mesh_axes and s > 1:
        h, unit = cfg["voxel_generator"]["grid_size"][1], 2 ** (cfg["unet"]["depth"] - 1)
        if h % unit or s > h // unit:
            refused.append(f"parallel.spatial_devices={s}: the band edges fall on multiples of "
                           f"2^(unet.depth-1) = {unit} rows, and H = {h} rows make "
                           f"{h // unit if h % unit == 0 else 'no'} such bands")
    if train.get("ckpt_backend", "pickle") not in ("pickle", "orbax"):
        refused.append(f"train.ckpt_backend={train['ckpt_backend']!r}")
    if world > 1 and cfg.get("misc", {}).get("mode") == "test":
        refused.append(f"misc.mode='test' with {world} processes (the Tester runs on one)")
    if refused:
        raise NotImplementedError("the PyTorch port does not implement " + ", ".join(refused))


def save_config(cfg: dict, path: str) -> None:
    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items() if not k.startswith("_")}
        if isinstance(x, (np.integer,)):
            return int(x)
        if isinstance(x, (np.floating,)):
            return float(x)
        if isinstance(x, np.ndarray):
            return x.tolist()
        return x

    with open(path, "w") as f:
        json.dump(clean(copy.deepcopy(cfg)), f, indent=2, default=str)
