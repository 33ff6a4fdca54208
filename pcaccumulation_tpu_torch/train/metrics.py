"""Host-side metric meters and IoU aggregation (the port's copy of the JAX
package's `train/metrics.py`): a recursive dict of running averages
(scalars and per-class arrays), and mean IoU / recall / precision from
accumulated intersection / union counters.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-7


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, value, n=1):
        value = float(value)
        self.sum += value * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class AverageMeterArray:
    def __init__(self, like):
        self.sum = np.zeros_like(np.asarray(like, dtype=np.float64))
        self.count = 0

    def update(self, value, n=1):
        self.sum += np.asarray(value, dtype=np.float64) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def init_stats_meter(stats: dict) -> dict:
    meters = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            meters[k] = init_stats_meter(v)
        elif np.ndim(v) > 0:
            meters[k] = AverageMeterArray(v)
        else:
            meters[k] = AverageMeter()
    return meters


def update_stats_meter(meters: dict, stats: dict) -> None:
    for k, v in stats.items():
        if k not in meters:
            meters[k] = (
                init_stats_meter(v) if isinstance(v, dict)
                else AverageMeterArray(v) if np.ndim(v) > 0
                else AverageMeter()
            )
        if isinstance(v, dict):
            update_stats_meter(meters[k], v)
        else:
            meters[k].update(np.asarray(v))


def compute_mean_iou_recall_precision(meter: dict, class_names: list[str]):
    """metrics.py:43-61: IoU/recall/precision from accumulated counters."""
    iou = meter["intersection"].sum / (meter["union"].sum + _EPS)
    recall = meter["intersection"].sum / (meter["gt_positives"].sum + _EPS)
    precision = meter["intersection"].sum / (meter["pred_positives"].sum + _EPS)

    message = ""
    for idx, name in enumerate(class_names):
        message += (
            f"{name}:  IoU: {round(float(iou[idx]), 3)},  "
            f"Recall: {round(float(recall[idx]), 3)},  "
            f"Precision: {round(float(precision[idx]), 3)} \n"
        )
    stats = {
        "iou": float(iou.mean()),
        "recall": float(recall.mean()),
        "precision": float(precision.mean()),
    }
    return stats, message
