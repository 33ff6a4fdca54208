"""Test mode: per-scene scene-flow dumps and the MOS / cluster evaluation
(the port of the JAX package's `train/tester.py`).

For every scene of the test split the test-mode forward runs (on-device
clustering, instance reconstruction, ICP if the config turns it on); the
per-point end-point error against the GT reconstruction goes into
`<results_dir>/<scene>/flow_error.npz` with the JAX package's schema: fp16
`epe_per_point` and `relative_error`, int8 `time_indice`, bool `fb_label`
and `sd_label`, the anchor frame left out. `pcaccumulation_tpu_torch.
evaluation` reads the dumps. MOS IoU and the instance-cluster metrics
accumulate across scenes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pcaccumulation_tpu_torch import resolve_device, to_device
from pcaccumulation_tpu_torch.config import check_supported
from pcaccumulation_tpu_torch.data.dataset import SceneDataset
from pcaccumulation_tpu_torch.data.loader import make_loader
from pcaccumulation_tpu_torch.ops import se3
from pcaccumulation_tpu_torch.train.cluster_eval import ClusterEvaluation
from pcaccumulation_tpu_torch.train.loss import compute_iou_stats
from pcaccumulation_tpu_torch.train.metrics import (
    compute_mean_iou_recall_precision,
    init_stats_meter,
    update_stats_meter,
)
from pcaccumulation_tpu_torch.train.trainer import MOS_CLASSES, stats_to_host
from pcaccumulation_tpu_torch.utils.checkpoint import partial_load, read_checkpoint
from pcaccumulation_tpu_torch.utils.logging import Logger

_EPS = 1e-7
DUMP_KEYS = ("fb_label", "sd_label", "epe_per_point", "relative_error", "time_indice")


class Tester:
    """cfg: the derived config; model: a MotionNet; device: None = CUDA.
    The dumps go to results_dir (default results/<misc.exp_name> under the
    working directory), the logs to save_dir. `misc.pretrain` names a
    checkpoint to load, in any form `utils.checkpoint.read_checkpoint`
    reads. A config saved by a run on a frame or spatial mesh runs one
    process's forward, as the JAX package's Tester runs outside a mesh."""

    def __init__(self, cfg, model, save_dir=None, device=None, results_dir=None):
        check_supported(cfg, mesh_axes=False)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        exp = cfg["misc"]["exp_name"]
        self.save_dir = save_dir or os.path.join("snapshot", exp)
        self.results_dir = results_dir or os.path.join("results", exp)
        self.logger = Logger(self.save_dir)
        pretrain = cfg["misc"].get("pretrain", "")
        if pretrain:
            state = read_checkpoint(pretrain)
            self.model.load_state_dict(partial_load(state["model"], self.model.state_dict()))
            self.logger.write(f"Loaded checkpoint {pretrain}\n")

    @torch.no_grad()
    def step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """The test-mode forward of one batch (tensors on the device) and its
        per-point errors: epe and rel [B, N], mos_metric (IoU counters over
        the GT-or-estimated FG points), inst_labels_est [B, N]."""
        results = self.model(batch, mode="test", generator=generator)
        points = batch["points"].float()
        tid = batch["time_idx"]
        # GT flow: ego compensation, then the GT instance motions
        comp_gt = se3.ego_motion_compensation(points, tid, batch["ego_motion_gt"].float())
        b, n, _ = points.shape
        k = batch["inst_motion_gt"].shape[1]
        gid = (torch.arange(b, device=points.device)[:, None] * k
               + batch["inst_labels"].long()).reshape(-1)
        rec_gt = se3.reconstruct_sequence(
            comp_gt.reshape(-1, 3), tid.reshape(-1), gid,
            batch["inst_motion_gt"].float().reshape(b * k, -1, 4, 4)).reshape(b, n, 3)
        est_flow = results["rec_est"] - points
        gt_flow = rec_gt - points
        epe = torch.linalg.norm(est_flow - gt_flow, dim=-1)
        rel = epe / (torch.linalg.norm(gt_flow, dim=-1) + _EPS)
        fb_mask = (((batch["fb_labels"] == 1) | (results["fb_est_per_points"] == 1))
                   & batch["point_valid"])
        mos_metric = compute_iou_stats(torch.argmax(results["mos_est"], -1).reshape(-1),
                                       batch["sd_labels"].reshape(-1), fb_mask.reshape(-1))
        return {"epe": epe, "rel": rel, "mos_metric": mos_metric,
                "inst_labels_est": results["inst_labels_est"]}

    def test(self) -> dict:
        """Run every scene of the test split; returns the MOS stats meter."""
        cfg = self.cfg
        scenes = SceneDataset(cfg, "test", augment=False).scenes()
        stats_meter = None
        cluster_eval = ClusterEvaluation(self.save_dir)

        for scene in scenes:
            ds = SceneDataset(cfg, "test", augment=False, scene_name=scene)
            loader = make_loader(ds, batch_size=1, shuffle=False,
                                 num_workers=cfg["test"]["num_workers"], drop_last=False,
                                 mode=cfg["test"].get("worker_mode", "thread"))
            buf = {k: [] for k in DUMP_KEYS}

            def consume(out, batch):
                nonlocal stats_meter
                out = stats_to_host(out)
                valid = batch["point_valid"][0]
                tid = batch["time_idx"][0]
                sel = valid & (tid > 0)  # the anchor frame is left out
                buf["fb_label"].append(batch["fb_labels"][0][sel].astype(bool))
                buf["sd_label"].append(batch["sd_labels"][0][sel].astype(bool))
                buf["epe_per_point"].append(out["epe"][0][sel].astype(np.float16))
                buf["relative_error"].append(out["rel"][0][sel].astype(np.float16))
                buf["time_indice"].append(tid[sel].astype(np.int8))
                if stats_meter is None:
                    stats_meter = init_stats_meter(out["mos_metric"])
                update_stats_meter(stats_meter, out["mos_metric"])
                cluster_eval.add(out["inst_labels_est"][0].astype(np.int64),
                                 batch["inst_labels"][0], batch["sd_labels"][0], valid)

            # one-sample-delayed read: sample i-1 comes to the host while
            # sample i is queued on the card
            pending = None
            for it, batch in enumerate(loader):
                gen = torch.Generator(device=self.device).manual_seed(it)
                out = self.step(to_device(batch, self.device), gen)
                if pending is not None:
                    consume(*pending)
                pending = (out, batch)
            if pending is not None:
                consume(*pending)

            scene_dir = os.path.join(self.results_dir, scene)
            os.makedirs(scene_dir, exist_ok=True)
            np.savez_compressed(
                os.path.join(scene_dir, "flow_error.npz"),
                **{k: np.concatenate(v) if v else np.zeros(0) for k, v in buf.items()})
            self.logger.write(f"scene {scene}: dumped flow_error.npz\n")

        self.logger.write("Motion segmentation results\n")
        _, msg = compute_mean_iou_recall_precision(stats_meter, MOS_CLASSES)
        self.logger.write(msg)
        self.logger.write("cluster results from offseted points\n")
        cluster_eval.final_eval()
        return stats_meter
