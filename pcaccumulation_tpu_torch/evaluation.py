"""Offline scene-flow evaluation of the test mode's dumps (the port's copy
of the JAX package's root `evaluation.py`).

    python -m pcaccumulation_tpu_torch.evaluation results/<exp_name> <dataset>

Aggregates the per-scene `flow_error.npz` dumps into static BG / FG /
overall tables and a pooled dynamic-point table (dynamic points subsampled
every 4 on Waymo), printing the same four summary lines, and writes the
tables under the path with `results` replaced by `metrics`. Host only.
"""

from __future__ import annotations

import os
import pickle
import sys
from glob import glob

import numpy as np

from pcaccumulation_tpu_torch.train.metrics import AverageMeter
from pcaccumulation_tpu_torch.train.sf_metrics import compute_sf_metrics

SAMPLE_FREQ = {"waymo": 4, "nuscene": 1, "synthetic": 1}


def collect_results(target_folder: str, save_dir: str, dataset: str):
    """(static stats meter, pooled dynamic epe, pooled dynamic relative
    error) over the scenes of target_folder; the per-scene and static
    tables and the dynamic points are written into save_dir."""
    files = sorted(glob(os.path.join(target_folder, "*", "flow_error.npz")))
    stats_meter = None
    scene_stats = {}
    rel_dyn, epe_dyn = [], []

    for path in files:
        with np.load(path) as data:
            fb = data["fb_label"].astype(bool)
            sd = data["sd_label"].astype(bool)
            epe = data["epe_per_point"].astype(np.float64)
            rel = data["relative_error"].astype(np.float64)
            tid = data["time_indice"].astype(int)

        if sd.sum():
            freq = SAMPLE_FREQ.get(dataset, 1)
            rel_dyn.extend(rel[sd][::freq])
            epe_dyn.extend(epe[sd][::freq])

        m = {
            "scene_overall": compute_sf_metrics(epe, rel),
            "static_overall": compute_sf_metrics(epe[~sd], rel[~sd]),
            "static_BG": compute_sf_metrics(epe[~sd & ~fb], rel[~sd & ~fb]),
        }
        if (~sd & fb).sum():
            m["static_FG"] = compute_sf_metrics(epe[~sd & fb], rel[~sd & fb])
        for t in range(1, int(tid.max()) + 1 if len(tid) else 1):
            s = ~sd & (tid == t)
            m[f"{t}-th frame"] = compute_sf_metrics(epe[s], rel[s])

        if stats_meter is None:
            stats_meter = {}
        update_stats_meter_listaware(stats_meter, m)
        scene_stats[os.path.basename(os.path.dirname(path))] = m

    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "scene_stats.pkl"), "wb") as f:
        pickle.dump(scene_stats, f)
    with open(os.path.join(save_dir, "static_stats.pkl"), "wb") as f:
        pickle.dump(stats_meter, f)
    np.savez(os.path.join(save_dir, "dynamic_dict.npz"), relative_error=np.asarray(rel_dyn),
             epe_per_point=np.asarray(epe_dyn))
    return stats_meter, np.asarray(epe_dyn), np.asarray(rel_dyn)


def update_stats_meter_listaware(meter: dict, stats: dict) -> None:
    """Accumulate nested metric dicts whose leaves are [value, count] pairs
    (weighted means) or scalars; a category missing from earlier scenes
    gets its meter on first sight."""
    for k, v in stats.items():
        if k not in meter:
            meter[k] = {} if isinstance(v, dict) else AverageMeter()
        if isinstance(v, dict):
            update_stats_meter_listaware(meter[k], v)
        elif isinstance(v, list):
            meter[k].update(v[0], v[1])
        else:
            meter[k].update(v)


def main(argv: list[str]) -> int:
    if len(argv) < 3:
        print(__doc__)
        return 1
    path, dataset = argv[1], argv[2]
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    meter, epe_dyn, rel_dyn = collect_results(path, path.replace("results", "metrics"), dataset)
    if meter is None:
        raise FileNotFoundError(f"no */flow_error.npz under {path}")

    def line(cat):
        if cat not in meter:
            print("n/a")
            return
        m = meter[cat]
        print(round(float(m["EPE3D"].avg), 3), round(float(m["Acc3DS"].avg) * 100, 1),
              round(float(m["Acc3DR"].avg) * 100, 1), round(float(m["ROutlier"].avg) * 100, 1))

    print("Results on the static BG part")
    line("static_BG")
    print("Results on the static FG part")
    line("static_FG")
    print("Results on the static part")
    line("static_overall")

    dyn = compute_sf_metrics(epe_dyn, rel_dyn)
    print("Results on the dynamic part")
    print(round(float(dyn["EPE3D"][0]), 3), round(float(dyn["EPE3D_med"]), 3),
          round(float(dyn["Acc3DS"][0]) * 100, 1), round(float(dyn["Acc3DR"][0]) * 100, 1),
          round(float(dyn["ROutlier"][0]) * 100, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
