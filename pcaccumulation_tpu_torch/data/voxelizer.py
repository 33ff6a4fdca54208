"""Fixed-capacity 4D (x, y, t) pillar voxelisation — host side.

The port's copy of the JAX package's `data/voxelizer.py`. It emits padded,
static-shape arrays, so the model never sees a dynamic point or pillar
count. As in the JAX package, the native C++ voxeliser
(`native/host.py`) is the default path: pillar ids first-come. With
`PCACC_NATIVE=0` in the environment the numpy path runs instead: pillar
ids by sorted key, so other points survive the `max_points` cap
(`pad_sample`). The flag is read once, at import (`_USE_NATIVE`); the
native path never falls back to numpy.

Conventions:
  * pillar key = (t, y, x); z is collapsed (one 8 m z voxel covers the
    whole crop range, so nz == 1 in every config).
  * `pillar_of_point` is in [0, max_pillars - 1] for valid points and
    == max_pillars for invalid/overflow points (the "overflow segment" that
    masked segment ops route padding into).
"""

from __future__ import annotations

import os

import numpy as np

from pcaccumulation_tpu_torch.native.host import native_voxelize

_USE_NATIVE = os.environ.get("PCACC_NATIVE", "1") != "0"


def voxelize(
    points: np.ndarray,
    time_idx: np.ndarray,
    voxel_size,
    pc_range,
    n_sweeps: int,
    max_pillars: int,
):
    """Assign each point to an occupied pillar.

    Args:
      points: [n, 3] float32, per-frame sensor coords.
      time_idx: [n] int, frame index in [0, n_sweeps).
      voxel_size: [vx, vy, vz].
      pc_range: [x0, y0, z0, x1, y1, z1].
      n_sweeps: number of frames T.
      max_pillars: static pillar capacity M.

    Returns:
      pillar_coords: [M, 3] int32 (t, y, x), zero padded.
      pillar_valid:  [M] bool.
      pillar_of_point: [n] int32 in [0, M]; M == invalid/overflow.
      in_range: [n] bool, whether the point fell inside the grid (native
        path: whether it got a pillar).
    """
    if _USE_NATIVE:
        return native_voxelize(points, time_idx, voxel_size, pc_range, n_sweeps, max_pillars)

    pc_range = np.asarray(pc_range, np.float32)
    voxel_size = np.asarray(voxel_size, np.float32)
    grid = np.round((pc_range[3:] - pc_range[:3]) / voxel_size).astype(np.int64)
    nx, ny = int(grid[0]), int(grid[1])

    cx = np.floor((points[:, 0] - pc_range[0]) / voxel_size[0]).astype(np.int64)
    cy = np.floor((points[:, 1] - pc_range[1]) / voxel_size[1]).astype(np.int64)
    cz = np.floor((points[:, 2] - pc_range[2]) / voxel_size[2]).astype(np.int64)
    t = time_idx.astype(np.int64)

    in_range = (
        (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
        & (cz >= 0) & (cz < int(grid[2])) & (t >= 0) & (t < n_sweeps)
    )

    key = (t * ny + cy) * nx + cx  # z collapsed: one pillar per (t, y, x)
    key = np.where(in_range, key, -1)

    valid_keys = key[in_range]
    uniq, inverse = np.unique(valid_keys, return_inverse=True)
    m = min(len(uniq), max_pillars)

    pillar_of_point = np.full(points.shape[0], max_pillars, np.int32)
    vals = inverse.astype(np.int32)
    vals[vals >= max_pillars] = max_pillars  # overflow pillars -> invalid
    pillar_of_point[in_range] = vals

    pillar_coords = np.zeros((max_pillars, 3), np.int32)
    kept = uniq[:m]
    pillar_coords[:m, 0] = kept // (nx * ny)          # t
    pillar_coords[:m, 1] = (kept // nx) % ny          # y
    pillar_coords[:m, 2] = kept % nx                  # x
    pillar_valid = np.zeros(max_pillars, bool)
    pillar_valid[:m] = True

    return pillar_coords, pillar_valid, pillar_of_point, in_range


def pad_sample(sample: dict, max_points: int, max_instances: int) -> dict:
    """Pad the variable-length per-point arrays of a voxelised sample to the
    static capacities. Overflowing points are dropped by an evenly strided
    subsample, which keeps the per-frame balance."""
    n = sample["points"].shape[0]
    if n > max_points:
        sel = np.linspace(0, n - 1, max_points).astype(np.int64)
        sample = {
            k: (v[sel] if isinstance(v, np.ndarray) and v.ndim >= 1
                and v.shape[0] == n else v)
            for k, v in sample.items()
        }
        n = max_points
    keep = n
    out = {}

    def pad_pts(x, fill=0):
        shape = (max_points,) + x.shape[1:]
        buf = np.full(shape, fill, x.dtype)
        buf[:keep] = x[:keep]
        return buf

    out["points"] = pad_pts(sample["points"].astype(np.float32))
    out["time_idx"] = pad_pts(sample["time_idx"].astype(np.int32))
    out["pillar_of_point"] = pad_pts(
        sample["pillar_of_point"].astype(np.int32), fill=sample["pillar_valid"].shape[0]
    )
    out["point_valid"] = np.zeros(max_points, bool)
    out["point_valid"][:keep] = sample["point_valid"][:keep]
    for k in ("sd_labels", "fb_labels", "inst_labels", "sem_labels"):
        out[k] = pad_pts(sample[k].astype(np.int32))

    out["pillar_coords"] = sample["pillar_coords"]
    out["pillar_valid"] = sample["pillar_valid"]
    out["ego_motion_gt"] = sample["ego_motion_gt"].astype(np.float32)

    # instances: slot 0 is the static background (identity motion); real
    # instances occupy 1..K-1. Extra instances are folded into background.
    T = sample["ego_motion_gt"].shape[0]
    inst_gt = sample["inst_motion_gt"].astype(np.float32)  # [k, T, 4, 4]
    k_in = inst_gt.shape[0]
    inst_motion = np.tile(np.eye(4, dtype=np.float32), (max_instances, T, 1, 1))
    k_keep = min(k_in, max_instances)
    inst_motion[:k_keep] = inst_gt[:k_keep]
    inst_valid = np.zeros(max_instances, bool)
    inst_valid[:k_keep] = True
    out["inst_motion_gt"] = inst_motion
    out["inst_valid"] = inst_valid
    out["inst_labels"][out["inst_labels"] >= max_instances] = 0
    return out
