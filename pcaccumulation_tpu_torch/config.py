"""Layered YAML configuration.

The port's own copy of the JAX package's `config.py` (`load_config` and
`derive`): a default YAML overridden by a per-dataset YAML, and the derived
voxel-grid values propagated into the model sections. It reads the
repository's `configs/*.yaml` as data.
"""

from __future__ import annotations

import os

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


def load_config(path: str | None = None) -> dict:
    """configs/default.yaml, overridden by the YAML at `path` if given,
    then derived."""
    with open(os.path.normpath(_DEFAULT)) as f:
        cfg = yaml.safe_load(f)
    if path is not None:
        with open(path) as f:
            update_recursive(cfg, yaml.safe_load(f) or {})
    return derive(cfg)
