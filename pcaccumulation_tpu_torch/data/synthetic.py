"""Synthetic LiDAR-sequence generator (the port's copy of the JAX package's
`data/synthetic.py`: `generate_sample`, and `write_synthetic_dataset`, which
writes a dataset of its samples with the info files of each split).

Emits one sample in the `.npz` contract the data layer consumes:
  raw_points [m,3] f32  — per-frame sensor coords (not ego-compensated)
  time_indice [m] int
  sd_labels / fb_labels / inst_labels / sem_labels [m] int
  ego_motion_gt [T,4,4] f32 — frame t -> anchor frame 0 (anchor = identity)
  bbox_tsfm [K,T,4,4] f32  — instance motion on ego-compensated points,
                             index 0 = background identity

A scene holds a moving ego vehicle, static background structure and a few
rigid dynamic objects at constant velocity. The same seed gives the same
arrays as the JAX package's generator.
"""

from __future__ import annotations

import os

import numpy as np


def _pose(yaw: float, xyz) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = xyz
    return m


def _box_points(rng, extent, n):
    return (rng.random((n, 3)) - 0.5) * np.asarray(extent)


def generate_sample(
    seed: int,
    n_frames: int = 5,
    freq: float = 10.0,
    n_static_clusters: int = 24,
    n_dynamic: int = 4,
    pts_per_cluster: int = 600,
    pts_per_object: int = 400,
    area: float = 30.0,
    ground_height: float = -1.6,
) -> dict:
    rng = np.random.default_rng(seed)
    dt = 1.0 / freq

    # ego trajectory: forward motion with slight yaw drift
    ego_speed = rng.uniform(3.0, 12.0)
    yaw_rate = rng.uniform(-0.08, 0.08)
    ego_world = []  # P_t: world <- ego_t
    x = y = yaw = 0.0
    for t in range(n_frames):
        ego_world.append(_pose(yaw, [x, y, 0.0]))
        x += ego_speed * dt * np.cos(yaw)
        y += ego_speed * dt * np.sin(yaw)
        yaw += yaw_rate * dt

    inv_p0 = np.linalg.inv(ego_world[0])
    ego_motion_gt = np.stack([inv_p0 @ p for p in ego_world]).astype(np.float32)

    # static background: vertical structures scattered around the scene
    static_world = []
    for _ in range(n_static_clusters):
        centre = np.array(
            [rng.uniform(-area, area), rng.uniform(-area, area), rng.uniform(-0.8, 1.5)]
        )
        extent = rng.uniform([0.5, 0.5, 1.0], [8.0, 2.0, 3.0])
        static_world.append(_box_points(rng, extent, pts_per_cluster) + centre)
    static_world = np.concatenate(static_world)

    # dynamic rigid objects: constant velocity in world frame
    obj_pts, obj_world0, obj_vel, obj_speed = [], [], [], []
    spawn = area * 0.6
    for _ in range(n_dynamic):
        centre = np.array([rng.uniform(-spawn, spawn), rng.uniform(-spawn, spawn), 0.2])
        speed = rng.uniform(0.0, 8.0)  # some objects are parked (speed < 0.5)
        heading = rng.uniform(0, 2 * np.pi)
        vel = speed * np.array([np.cos(heading), np.sin(heading), 0.0])
        obj_pts.append(_box_points(rng, [4.2, 1.9, 1.6], pts_per_object))
        obj_world0.append(_pose(heading, centre))
        obj_vel.append(vel)
        obj_speed.append(speed)

    pts_list, tid_list, sd_list, fb_list, inst_list = [], [], [], [], []
    bbox_tsfm = np.tile(np.eye(4, dtype=np.float32), (n_dynamic + 1, n_frames, 1, 1))

    for t in range(n_frames):
        inv_pt = np.linalg.inv(ego_world[t])
        # static points observed from ego frame t (subsample for realism)
        sel = rng.random(len(static_world)) < 0.9
        s = static_world[sel]
        s_ego = (inv_pt[:3, :3] @ s.T).T + inv_pt[:3, 3]
        pts_list.append(s_ego)
        tid_list.append(np.full(len(s_ego), t))
        sd_list.append(np.zeros(len(s_ego)))
        fb_list.append(np.zeros(len(s_ego)))
        inst_list.append(np.zeros(len(s_ego)))

        for k in range(n_dynamic):
            # object pose at time t: translated by k velocity (no yaw change)
            o_t = obj_world0[k].copy()
            o_t[:3, 3] = o_t[:3, 3] + obj_vel[k] * (t * dt)
            p_world = (o_t[:3, :3] @ obj_pts[k].T).T + o_t[:3, 3]
            p_ego = (inv_pt[:3, :3] @ p_world.T).T + inv_pt[:3, 3]
            pts_list.append(p_ego)
            tid_list.append(np.full(len(p_ego), t))
            moving = float(obj_speed[k] > 0.5)
            sd_list.append(np.full(len(p_ego), moving))
            fb_list.append(np.ones(len(p_ego)))
            inst_list.append(np.full(len(p_ego), k + 1))

            # bbox_tsfm acts on ego-compensated (anchor frame 0) coords:
            # T = inv(P0) O_k(0) O_k(t)^-1 P0
            bbox_tsfm[k + 1, t] = (
                inv_p0 @ obj_world0[k] @ np.linalg.inv(o_t) @ ego_world[0]
            ).astype(np.float32)

    raw_points = np.concatenate(pts_list).astype(np.float32)
    # sensor noise + a sprinkling of ground points below the removal height
    raw_points += rng.normal(scale=0.01, size=raw_points.shape)
    n_ground = len(raw_points) // 10
    ground = np.stack(
        [
            rng.uniform(-area, area, n_ground),
            rng.uniform(-area, area, n_ground),
            np.full(n_ground, ground_height - 0.2),
        ],
        axis=1,
    ).astype(np.float32)
    gt_tid = rng.integers(0, n_frames, n_ground)

    time_indice = np.concatenate(tid_list + [gt_tid]).astype(np.int32)
    raw_points = np.concatenate([raw_points, ground])
    sd_labels = np.concatenate(sd_list + [np.zeros(n_ground)]).astype(np.int32)
    fb_labels = np.concatenate(fb_list + [np.zeros(n_ground)]).astype(np.int32)
    inst_labels = np.concatenate(inst_list + [np.zeros(n_ground)]).astype(np.int32)
    sem_labels = np.zeros_like(sd_labels)

    return {
        "raw_points": raw_points.astype(np.float32),
        "time_indice": time_indice,
        "sd_labels": sd_labels,
        "fb_labels": fb_labels,
        "inst_labels": inst_labels,
        "sem_labels": sem_labels,
        "ego_motion_gt": ego_motion_gt,
        "bbox_tsfm": bbox_tsfm,
    }


def write_synthetic_dataset(base_dir: str, n_samples: int, n_frames: int = 5,
                            freq: float = 10.0, seed: int = 0,
                            **gen_kwargs) -> list[str]:
    """Write npz samples + train/val/test info files mirroring the reference
    dataset layout (scene-grouped relative paths)."""
    os.makedirs(base_dir, exist_ok=True)
    paths = []
    for i in range(n_samples):
        scene = f"scene_{i % max(1, n_samples // 2):04d}"
        os.makedirs(os.path.join(base_dir, scene), exist_ok=True)
        rel = os.path.join(scene, f"sample_{i:05d}.npz")
        sample = generate_sample(seed + i, n_frames=n_frames, freq=freq, **gen_kwargs)
        np.savez_compressed(os.path.join(base_dir, rel), **sample)
        paths.append(rel)
    for split, sel in (
        ("train", paths[: max(1, int(len(paths) * 0.6))]),
        ("val", paths[max(1, int(len(paths) * 0.6)) : max(2, int(len(paths) * 0.8))]),
        ("test", paths[max(2, int(len(paths) * 0.8)) :] or paths[-1:]),
    ):
        with open(os.path.join(base_dir, f"{split}_info.txt"), "w") as f:
            f.write("\n".join(sel) + "\n")
    return paths
