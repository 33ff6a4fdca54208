"""Scene-flow metric definitions (the port's copy of the JAX package's
`train/sf_metrics.py`, numpy): EPE3D (mean, median), Acc3DS (< 5 cm or
5 %), Acc3DR (< 10 cm or 10 %), Outlier (> 30 cm or > 10 %) and ROutlier
(> 30 cm and > 30 %), each with its point count; `SFEvaluator`, the
streaming evaluator with its per-category and per-frame tables, and
`load_and_display`, which prints a saved evaluation."""

from __future__ import annotations

import numpy as np


def compute_sf_metrics(epe_per_point: np.ndarray, relative_error: np.ndarray) -> dict:
    epe = np.asarray(epe_per_point, np.float64)
    rel = np.asarray(relative_error, np.float64)
    size = epe.shape[0]
    if size == 0:
        return {k: [0.0, 0] for k in ("EPE3D", "Acc3DR", "Acc3DS", "Outlier", "ROutlier")} | {
            "EPE3D_med": 0.0
        }
    return {
        "EPE3D": [float(epe.mean()), size],
        "EPE3D_med": float(np.median(epe)),
        "Acc3DS": [float(np.logical_or(epe < 0.05, rel < 0.05).mean()), size],
        "Acc3DR": [float(np.logical_or(epe < 0.1, rel < 0.1).mean()), size],
        "Outlier": [float(np.logical_or(epe > 0.3, rel > 0.1).mean()), size],
        "ROutlier": [float(np.logical_and(epe > 0.3, rel > 0.3).mean()), size],
    }


def _scalar_metrics(epe: np.ndarray, rel: np.ndarray) -> dict:
    """Reference-schema scalar row (sf_eval_utils.py:54-66)."""
    if epe.shape[0] == 0:
        return {k: float("nan") for k in (
            "EPE3D", "EPE3D_med", "Acc3DS", "Acc3DR", "Outlier", "ROutlier")}
    m = compute_sf_metrics(epe, rel)
    return {
        "EPE3D": m["EPE3D"][0], "EPE3D_med": m["EPE3D_med"],
        "Acc3DS": m["Acc3DS"][0], "Acc3DR": m["Acc3DR"][0],
        "Outlier": m["Outlier"][0], "ROutlier": m["ROutlier"][0],
    }


def _percentiles(data: np.ndarray, tags=(10, 25, 50, 75, 90)) -> dict:
    """EPE percentile row for the dynamic part (sf_eval_utils.py:203-212)."""
    if data.shape[0] == 0:
        return {f"{t}%": float("nan") for t in tags}
    return {f"{t}%": float(np.percentile(data, t)) for t in tags}


class SFEvaluator:
    """Streaming scene-flow evaluator with per-category breakdown.

    Rebuilds the reference's SF_Evaluator (its toolbox/sf_eval_utils.py:167-259):
    accumulate per-point EPE / relative error with fb/sd/time labels across
    scenes, then produce overall + per-frame tables split into
    overall / BG / FG / Static / Dynamic / dynamic-EPE-percentiles.

    Accumulation appends whole arrays (f16/bool/int8 like the reference)
    and concatenates once at evaluation time — no per-point Python lists.
    """

    def __init__(self, n_frames: int, save_dir: str | None = None):
        self.n_frames = n_frames
        self.save_dir = save_dir
        self._epe, self._rel = [], []
        self._fb, self._sd, self._tid = [], [], []

    def update(self, gt_flow, est_flow, time_indice, fb_label, sd_label,
               mask=None, relative_error=None, epe_per_point=None):
        gt = np.asarray(gt_flow, np.float32)
        est = np.asarray(est_flow, np.float32)
        tid = np.asarray(time_indice)
        fb = np.asarray(fb_label).astype(bool)
        sd = np.asarray(sd_label).astype(bool)
        if mask is not None:
            mask = np.asarray(mask).astype(bool)
            gt, est, tid, fb, sd = gt[mask], est[mask], tid[mask], fb[mask], sd[mask]
            if relative_error is not None:
                relative_error = np.asarray(relative_error)[mask]
                epe_per_point = np.asarray(epe_per_point)[mask]
        if relative_error is None:
            err = np.linalg.norm(est - gt, axis=1)
            mag = np.linalg.norm(gt, axis=1)
            epe_per_point = err
            relative_error = err / (mag + 1e-7)
        self._epe.append(np.asarray(epe_per_point, np.float16))
        self._rel.append(np.asarray(relative_error, np.float16))
        self._fb.append(fb)
        self._sd.append(sd)
        self._tid.append(tid.astype(np.int8))

    @staticmethod
    def _evaluate(fb, sd, epe, rel) -> dict:
        out = {
            "n_points": int(fb.shape[0]),
            "moving_ratio": float(sd.mean()) if fb.size else float("nan"),
            "FG_ratio": float(fb.mean()) if fb.size else float("nan"),
            "overall": _scalar_metrics(epe, rel),
            "BG": _scalar_metrics(epe[~fb], rel[~fb]),
            "FG": _scalar_metrics(epe[fb], rel[fb]),
            "Static": _scalar_metrics(epe[~sd], rel[~sd]),
            "Dynamic": _scalar_metrics(epe[sd], rel[sd]),
            "percentile": _percentiles(epe[sd]),
        }
        return out

    def full_evaluation(self, display: bool = True) -> dict:
        epe = np.concatenate(self._epe).astype(np.float64) if self._epe else np.zeros(0)
        rel = np.concatenate(self._rel).astype(np.float64) if self._rel else np.zeros(0)
        fb = np.concatenate(self._fb) if self._fb else np.zeros(0, bool)
        sd = np.concatenate(self._sd) if self._sd else np.zeros(0, bool)
        tid = np.concatenate(self._tid) if self._tid else np.zeros(0, np.int8)

        results = {"overall": self._evaluate(fb, sd, epe, rel)}
        for idx in range(1, self.n_frames):
            s = tid == idx
            results[f"{idx}-th frame"] = self._evaluate(
                fb[s], sd[s], epe[s], rel[s])

        if self.save_dir is not None:
            import os
            import pickle
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, "sf_results.pkl"), "wb") as f:
                pickle.dump(results, f)
        if display:
            display_sf_results(results)
        return results


def display_sf_results(results: dict) -> None:
    """Category tables, one row per index key (sf_eval_utils.py:10-31).

    Uses pandas when available, plain aligned text otherwise."""
    index = list(results.keys())
    sections = [
        ("overall", "Overall results"),
        ("BG", "Detailed results on BG part"),
        ("FG", "Detailed results on FG part"),
        ("Static", "Detailed results on static part"),
        ("Dynamic", "Detailed results on dynamic part"),
        ("percentile", "Detailed results on dynamic part by percentile"),
    ]
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover
        pd = None
    for cat, message in sections:
        keys = list(results[index[0]][cat].keys())
        table = {k: [results[row][cat][k] for row in index] for k in keys}
        print(message)
        if pd is not None:
            print(pd.DataFrame(table, index=index).round(3))
        else:  # pragma: no cover
            print("  " + "  ".join(f"{k:>9}" for k in keys))
            for row in index:
                print(f"{row:>12} " + "  ".join(
                    f"{results[row][cat][k]:9.3f}" for k in keys))
        print()


def load_and_display(path: str) -> None:
    """display_results equivalent (sf_eval_utils.py:10-31): pkl -> tables."""
    import pickle
    with open(path, "rb") as f:
        display_sf_results(pickle.load(f))
