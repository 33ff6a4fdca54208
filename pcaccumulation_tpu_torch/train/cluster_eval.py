"""Instance-segmentation evaluation, MUCov / MWCov / precision / recall
(the port's copy of the JAX package's `train/cluster_eval.py`, numpy).

Per class (static / dynamic, by the majority MOS label of a cluster):
coverage and precision / recall at IoU thresholds 0.5 .. 0.9, appended to
`cluster_eval.txt`.
"""

from __future__ import annotations

import os

import numpy as np

IOU_THRESHOLDS = [0.5, 0.6, 0.7, 0.8, 0.9]
N_CLASSES = 2


class ClusterEvaluation:
    def __init__(self, save_dir: str | None = None):
        self.all_mean_cov = [[] for _ in range(N_CLASSES)]
        self.all_mean_weighted_cov = [[] for _ in range(N_CLASSES)]
        self.total_gt_inst = np.zeros(N_CLASSES)
        self.tpsins = {f"@{t}": [[] for _ in range(N_CLASSES)] for t in IOU_THRESHOLDS}
        self.fpsins = {f"@{t}": [[] for _ in range(N_CLASSES)] for t in IOU_THRESHOLDS}
        self.log_path = os.path.join(save_dir, "cluster_eval.txt") if save_dir else None

    def _log(self, msg: str):
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(msg + "\n")
        print(msg)

    def add(self, inst_est, inst_gt, mos_label, valid=None):
        """Accumulate one sample's estimated and GT instance labels."""
        inst_est = np.asarray(inst_est)
        inst_gt = np.asarray(inst_gt)
        mos_label = np.asarray(mos_label).astype(float)
        if valid is not None:
            v = np.asarray(valid)
            inst_est, inst_gt, mos_label = inst_est[v], inst_gt[v], mos_label[v]

        def group(labels):
            groups = [[] for _ in range(N_CLASSES)]
            for uid in np.unique(labels):
                if uid == 0:
                    continue
                sel = labels == uid
                sem = int(round(mos_label[sel].mean()))
                groups[sem].append(sel)
            return groups

        est_groups = group(inst_est)
        gt_groups = group(inst_gt)

        # coverage
        for sem in range(N_CLASSES):
            sum_cov, weighted, n_gt_pts = 0.0, 0.0, 0
            for g in gt_groups[sem]:
                ovmax = 0.0
                for e in est_groups[sem]:
                    ovmax = max(ovmax, float((g & e).sum() / (g | e).sum()))
                sum_cov += ovmax
                weighted += ovmax * g.sum()
                n_gt_pts += g.sum()
            if gt_groups[sem]:
                self.all_mean_cov[sem].append(sum_cov / len(gt_groups[sem]))
                self.all_mean_weighted_cov[sem].append(weighted / max(n_gt_pts, 1))

        # precision / recall
        for sem in range(N_CLASSES):
            self.total_gt_inst[sem] += len(gt_groups[sem])
            for e in est_groups[sem]:
                ovmax = -1.0
                for g in gt_groups[sem]:
                    ovmax = max(ovmax, float((g & e).sum() / (g | e).sum()))
                for thr in IOU_THRESHOLDS:
                    hit = ovmax > thr
                    self.tpsins[f"@{thr}"][sem].append(1.0 if hit else 0.0)
                    self.fpsins[f"@{thr}"][sem].append(0.0 if hit else 1.0)

    def final_eval(self) -> dict:
        mucov = np.array([np.mean(c) if c else 0.0 for c in self.all_mean_cov])
        mwcov = np.array([np.mean(c) if c else 0.0 for c in self.all_mean_weighted_cov])
        self._log(f"Instance Segmentation MUCov: {mucov}")
        self._log(f"Instance Segmentation mMUCov: {np.mean(mucov)}")
        self._log(f"Instance Segmentation MWCov: {mwcov}")
        self._log(f"Instance Segmentation mMWCov: {np.mean(mwcov)}")

        out = {"MUCov": mucov, "MWCov": mwcov}
        for thr in IOU_THRESHOLDS:
            key = f"@{thr}"
            precision = np.zeros(N_CLASSES)
            recall = np.zeros(N_CLASSES)
            for sem in range(N_CLASSES):
                tp = float(np.sum(self.tpsins[key][sem]))
                fp = float(np.sum(self.fpsins[key][sem]))
                recall[sem] = tp / max(self.total_gt_inst[sem], 1e-7)
                precision[sem] = tp / max(tp + fp, 1e-7)
            self._log(f"IoU threshold {key}")
            self._log(f"Instance Segmentation Precision: {precision}")
            self._log(f"Instance Segmentation mPrecision: {np.mean(precision)}")
            self._log(f"Instance Segmentation Recall: {recall}")
            self._log(f"Instance Segmentation mRecall: {np.mean(recall)}")
            out[key] = {"precision": precision, "recall": recall}
        return out
