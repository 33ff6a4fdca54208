"""Per-sample preprocessing: raw sample -> cropped, voxelised, pillar-sorted,
padded arrays (the port's copy of the JAX package's
`data/dataset.py::prep_sample`)."""

from __future__ import annotations

import numpy as np

from pcaccumulation_tpu_torch.data.voxelizer import pad_sample, voxelize


def prep_sample(data: dict, cfg: dict) -> dict:
    """Crop, remove ground, voxelise, sort points by pillar id and pad to
    the static capacities (the JAX package's `prep_sample` with
    `augment=False`: the training augmentation comes with training)."""
    vg = cfg["voxel_generator"]
    cap = cfg["capacity"]

    points = np.asarray(data["raw_points"], np.float32)
    time_idx = np.asarray(data["time_indice"]).astype(np.int32)
    sd = np.asarray(data["sd_labels"]).astype(np.int32)
    fb = np.asarray(data["fb_labels"]).astype(np.int32)
    inst = np.asarray(data["inst_labels"]).astype(np.int32)
    sem = np.asarray(data.get("sem_labels", np.zeros_like(sd))).astype(np.int32)
    ego_gt = np.asarray(data["ego_motion_gt"], np.float32)
    inst_gt = np.asarray(data["bbox_tsfm"], np.float32)

    # 1. crop
    crop_xy, crop_z_min, crop_z_max = vg["crop_range"]
    sel = (
        (np.abs(points[:, 0]) < crop_xy)
        & (np.abs(points[:, 1]) < crop_xy)
        & (points[:, 2] > crop_z_min)
        & (points[:, 2] < crop_z_max)
    )

    # 2. ground removal by height
    if cfg["data"]["remove_ground"]:
        ground_h = cfg["data"]["ground_height"] + cfg["data"]["ground_slack"]
        sel &= points[:, 2] > ground_h

    sel_idx = np.flatnonzero(sel)
    points, time_idx = points[sel_idx], time_idx[sel_idx]

    # 3. voxelise at fixed capacity
    pillar_coords, pillar_valid, pillar_of_point, in_range = voxelize(
        points, time_idx, vg["voxel_size"], vg["range"], vg["n_sweeps"],
        cap["max_pillars"],
    )

    # 4. sort points by pillar id: the segment pool (kernels/segscan.py)
    # requires non-decreasing ids. Invalid/overflow ids (== max_pillars)
    # sort last. The stable sort gives the same order as the JAX
    # package's native counting sort.
    order = np.argsort(pillar_of_point, kind="stable")
    points, time_idx = points[order], time_idx[order]
    pillar_of_point, in_range = pillar_of_point[order], in_range[order]
    final_idx = sel_idx[order]
    sd, fb = sd[final_idx], fb[final_idx]
    inst, sem = inst[final_idx], sem[final_idx]

    sample = {
        "points": points,
        "time_idx": time_idx,
        "sd_labels": sd,
        "fb_labels": fb,
        "inst_labels": inst,
        "sem_labels": sem,
        "ego_motion_gt": ego_gt,
        "inst_motion_gt": inst_gt,
        "pillar_coords": pillar_coords,
        "pillar_valid": pillar_valid,
        "pillar_of_point": pillar_of_point,
        "point_valid": in_range & (pillar_of_point < cap["max_pillars"]),
    }
    return pad_sample(sample, cap["max_points"], cap["max_instances"])
