"""Dataset: npz samples -> augmented, cropped, voxelised, pillar-sorted,
padded arrays (the port's copy of the JAX package's `data/dataset.py`)."""

from __future__ import annotations

import os
import time

import numpy as np

from pcaccumulation_tpu_torch.data import voxelizer
from pcaccumulation_tpu_torch.data.voxelizer import pad_sample, voxelize
from pcaccumulation_tpu_torch.native.host import native_sort_by_key


def _random_aug_tsfm(rng, rot_aug, shift_range):
    """Random SE(2) augmentation transform: a yaw in [0, pi * rot_aug) and
    an xy shift in [-shift_range, shift_range)."""
    yaw = rng.uniform(0, np.pi * rot_aug)
    c, s = np.cos(yaw), np.sin(yaw)
    tsfm = np.eye(4)
    tsfm[:2, :2] = [[c, -s], [s, c]]
    tsfm[0, 3] = rng.uniform(-shift_range, shift_range)
    tsfm[1, 3] = rng.uniform(-shift_range, shift_range)
    return tsfm


class _Laps:
    """Adds the host-clock ms since the previous lap to `stage_ms[name]`;
    does nothing without a dict."""

    def __init__(self, stage_ms: dict | None):
        self.stage_ms = stage_ms
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.stage_ms is not None:
            now = time.perf_counter()
            self.stage_ms[name] = self.stage_ms.get(name, 0.0) + (now - self.t) * 1e3
            self.t = now


def prep_sample(data: dict, cfg: dict, augment: bool = False,
                rng: np.random.Generator | None = None, with_labels: bool = True,
                stage_ms: dict | None = None) -> dict:
    """Augment (optionally), crop, remove ground, voxelise, sort points by
    pillar id and pad to the static capacities. The augmentation moves the
    points by a random SE(2) transform, adds noise and scales them, and
    conjugates the GT poses by the transform; it draws from `rng` in the
    JAX package's order, so one seed gives both packages the same sample.

    with_labels=False (the serving path, whose labels are neutral zeros)
    reads no label channel and gathers none: the four label slots hold
    zeros. The keys and shapes are the same either way.

    The voxeliser and the sort are native (`native/host.py`) unless
    `PCACC_NATIVE=0` (`data/voxelizer.py`); both paths give the JAX
    package's sample in the same mode. With a `stage_ms` dict, the host
    ms of each stage are added to it: augment (with `augment`),
    crop_ground (reading the inputs included), voxelise, sort, gather (the
    points and labels in pillar order) and pad (`pad_sample`)."""
    lap = _Laps(stage_ms)
    vg = cfg["voxel_generator"]
    cap = cfg["capacity"]

    points = np.asarray(data["raw_points"], np.float32)
    time_idx = np.asarray(data["time_indice"]).astype(np.int32)
    if with_labels:
        sd = np.asarray(data["sd_labels"]).astype(np.int32)
        fb = np.asarray(data["fb_labels"]).astype(np.int32)
        inst = np.asarray(data["inst_labels"]).astype(np.int32)
        sem = np.asarray(data.get("sem_labels", np.zeros_like(sd))).astype(np.int32)
    ego_gt = np.asarray(data["ego_motion_gt"], np.float32)
    inst_gt = np.asarray(data["bbox_tsfm"], np.float32)

    # 0. augmentation + GT pose conjugation
    if augment:
        rng = rng or np.random.default_rng()
        aug = cfg["data_aug"]
        tsfm = _random_aug_tsfm(rng, aug["rot_aug"], aug["augment_shift_range"])
        t32 = tsfm.astype(np.float32)
        points = (t32[:3, :3] @ points.T).T + t32[:3, 3]
        noise = rng.random(points.shape, dtype=np.float32) - np.float32(0.5)
        points += noise * np.float32(aug["augment_noise"])
        scale = rng.uniform(aug["augment_scale_min"], aug["augment_scale_max"])
        points *= np.float32(scale)
        inv = np.linalg.inv(tsfm)
        ego_gt = (tsfm[None] @ ego_gt @ inv[None]).astype(np.float32)
        flat = inst_gt.reshape(-1, 4, 4)
        inst_gt = (tsfm[None] @ flat @ inv[None]).reshape(inst_gt.shape).astype(np.float32)
        lap("augment")

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
    lap("crop_ground")

    # 3. voxelise at fixed capacity
    pillar_coords, pillar_valid, pillar_of_point, in_range = voxelize(
        points, time_idx, vg["voxel_size"], vg["range"], vg["n_sweeps"],
        cap["max_pillars"],
    )
    lap("voxelise")

    # 4. sort points by pillar id: the segment pool (kernels/segscan.py)
    # requires non-decreasing ids. Invalid/overflow ids (== max_pillars)
    # sort last. The counting sort and the stable argsort give one order,
    # the JAX package's in either of its modes.
    if voxelizer._USE_NATIVE:
        order = native_sort_by_key(pillar_of_point, cap["max_pillars"])
    else:
        order = np.argsort(pillar_of_point, kind="stable")
    lap("sort")
    points, time_idx = points[order], time_idx[order]
    pillar_of_point, in_range = pillar_of_point[order], in_range[order]
    if with_labels:
        final_idx = sel_idx[order]
        sd, fb = sd[final_idx], fb[final_idx]
        inst, sem = inst[final_idx], sem[final_idx]
    else:  # one array for all four: pad_sample copies each into its own buffer
        sd = fb = inst = sem = np.zeros(order.shape[0], np.int32)
    lap("gather")

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
    out = pad_sample(sample, cap["max_points"], cap["max_instances"])
    lap("pad")
    return out


class SceneDataset:
    """File-list dataset over preprocessed .npz samples: `<split>_info.txt`
    under the base directory lists their relative paths; a sample's scene
    is the first directory of its path, and `scene_name` keeps one scene's
    samples (the test mode's per-scene loop). Training samples are
    augmented."""

    def __init__(self, cfg: dict, split: str, augment: bool | None = None,
                 base_dir: str | None = None, scene_name: str | None = None):
        self.cfg = cfg
        self.base = base_dir or cfg["path"]["dataset_base"]
        self.augment = augment if augment is not None else (split == "train")
        with open(os.path.join(self.base, f"{split}_info.txt")) as f:
            self.infos = [line.strip() for line in f if line.strip()]
        if scene_name is not None:
            self.infos = [p for p in self.infos if p.split(os.sep)[0] == scene_name]

    def scenes(self) -> list[str]:
        return sorted({p.split(os.sep)[0] for p in self.infos})

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, idx: int) -> dict:
        with np.load(os.path.join(self.base, self.infos[idx]), allow_pickle=True) as data:
            data = dict(data)
        rng = np.random.Generator(np.random.SFC64())
        return prep_sample(data, self.cfg, augment=self.augment, rng=rng)
