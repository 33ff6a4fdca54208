"""Scene-flow metric definitions (the port's copy of the JAX package's
`train/sf_metrics.py::compute_sf_metrics`, numpy): EPE3D (mean, median),
Acc3DS (< 5 cm or 5 %), Acc3DR (< 10 cm or 10 %), Outlier (> 30 cm or
> 10 %) and ROutlier (> 30 cm and > 30 %), each with its point count."""

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
