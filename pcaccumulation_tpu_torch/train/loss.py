"""FuseLoss: the training objective over the padded, masked results (the
port of the JAX package's `train/loss.py`).

Weighted cross entropy with online sqrt-inverse-frequency class weights,
Lovász-Softmax, the Sinkhorn outlier loss, the offset norm and direction
losses and the γ-decayed TPointNet objective, plus per-class IoU counters
in thousandths for the host meters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pcaccumulation_tpu_torch.ops import se3
from pcaccumulation_tpu_torch.ops.lovasz import lovasz_softmax
from pcaccumulation_tpu_torch.ops.numeric import safe_norm
from pcaccumulation_tpu_torch.ops.segment import masked_segment_mean

_EPS = 1e-7
N_CLASSES = 2


def compute_iou_stats(pred, gt, valid) -> dict:
    """Per-class intersection / union / pred-positives / gt-positives over
    valid rows, each divided by 1e3."""
    inter, union, pred_pos, gt_pos = [], [], [], []
    for c in range(N_CLASSES):
        sel_gt = (gt == c) & valid
        sel_pred = (pred == c) & valid
        i = (sel_gt & sel_pred).sum() / 1e3
        p = sel_pred.sum() / 1e3
        gp = sel_gt.sum() / 1e3
        inter.append(i)
        union.append(p + gp - i)
        pred_pos.append(p)
        gt_pos.append(gp)
    return {"intersection": torch.stack(inter), "union": torch.stack(union),
            "pred_positives": torch.stack(pred_pos), "gt_positives": torch.stack(gt_pos)}


def weighted_ce(logits, labels, valid, max_weight: float = 50.0):
    """Cross entropy over valid rows, weighted by sqrt(inverse class
    frequency) clipped at max_weight, as a weighted mean (the weights are
    constants of the batch)."""
    validf = valid.to(logits.dtype)
    counts = torch.stack([((labels == c) & valid).sum() + _EPS
                          for c in range(N_CLASSES)]).to(logits.dtype)
    class_w = torch.clamp(torch.sqrt(counts.sum() / counts), 0.0, max_weight)
    logp = F.log_softmax(logits, dim=-1)
    lab = labels.long().clamp(0, N_CLASSES - 1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    w = class_w[lab] * validf
    return (nll * w).sum() / (w.sum() + _EPS)


def seg_loss(logits, labels, valid) -> dict:
    """CE + Lovász + IoU counters."""
    return {
        "bce_loss": weighted_ce(logits, labels, valid),
        "lovasz_loss": lovasz_softmax(F.softmax(logits, dim=-1), labels, valid),
        "metric": compute_iou_stats(logits.argmax(-1), labels, valid),
    }


def outlier_loss(perm):
    """Sinkhorn slack-mass penalty over perm [B, P, n, n]: mean(1 - column
    sums) + mean(1 - row sums)."""
    return (1.0 - perm.sum(dim=-2)).mean() + (1.0 - perm.sum(dim=-1)).mean()


def offset_loss(batch, results, max_instances: int):
    """Offset GT = instance centre of the GT reconstruction minus the
    est-ego-compensated point, over GT-foreground rows. Returns (norm,
    direction, l2 error)."""
    points = batch["points"].float()
    time_idx = batch["time_idx"]
    valid = batch["point_valid"]
    inst = batch["inst_labels"]
    fb_mask = (batch["fb_labels"] == 1) & valid
    b, n, _ = points.shape
    k = max_instances

    # the per-(instance, frame) GT transforms composed with the ego GT first
    ego_gt = batch["ego_motion_gt"].float()        # [B, T, 4, 4]
    inst_gt = batch["inst_motion_gt"].float()      # [B, K, T, 4, 4]
    composed = inst_gt @ ego_gt[:, None]
    gid = (torch.arange(b, device=points.device)[:, None] * k + inst.long()).reshape(-1)
    rec = se3.reconstruct_sequence(points.reshape(-1, 3), time_idx.reshape(-1), gid,
                                   composed.reshape((b * k,) + composed.shape[2:]))
    centers = masked_segment_mean(rec, gid, valid.reshape(-1), b * k + 1)[:b * k]
    center_pp = centers[gid.clamp(0, b * k - 1)].reshape(b, n, 3)

    est_comp = results["transformed_points"]
    if "offset_sub" in results:
        # rows of the decoded FG subset; the centres above use every point
        sel, sv = results["sub_sel"].long(), results["sub_valid"]
        center_pp = torch.gather(center_pp, 1, sel[..., None].expand(-1, -1, 3))
        est_comp = torch.gather(est_comp, 1, sel[..., None].expand(-1, -1, 3))
        est_off = results["offset_sub"]
        fb_mask = (torch.gather(batch["fb_labels"], 1, sel) == 1) & sv
    else:
        est_off = results["offset_est"]
    gt_off = center_pp[..., :2] - est_comp[..., :2]

    mf = fb_mask.to(points.dtype)
    cnt = mf.sum() + _EPS
    # per-coordinate mean over rows, then summed
    norm_loss = ((gt_off - est_off).abs() * mf[..., None]).sum(dim=(0, 1)).div(cnt).sum()
    l2_err = (safe_norm(gt_off - est_off) * mf).sum() / cnt
    gt_n = gt_off / (safe_norm(gt_off, keepdim=True) + _EPS)
    est_n = est_off / (safe_norm(est_off, keepdim=True) + _EPS)
    dir_loss = ((1.0 - (gt_n * est_n).sum(-1)) * mf).sum() / cnt

    gate = fb_mask.sum() > 0
    return (torch.where(gate, norm_loss, 0.0), torch.where(gate, dir_loss, 0.0),
            torch.where(gate, l2_err, 0.0))


def fuse_loss(results: dict, batch: dict, weights: dict, max_instances: int) -> dict:
    """The total objective. Returns a stats dict whose 'loss' entry is
    differentiable; the others are terms, errors and IoU counters."""
    stats = {}

    ego_l1 = weights["w_pose_l1_loss"] * results["ego_l1_loss"]
    total = ego_l1
    stats["ego_l1_loss"] = ego_l1
    stats["ego_l2_loss"] = results["ego_l2_loss"]
    stats["ego_rot_error"] = results["ego_rot_error"]
    stats["ego_trans_error"] = results["ego_trans_error"]

    perm = outlier_loss(results["perm_matrix"]) * weights["w_perm_loss"]
    total = total + perm
    stats["perm_loss"] = perm

    # FB segmentation over occupied pillars (one row per pillar)
    fb_stats = seg_loss(results["fb_logit_pillar"].reshape(-1, 2),
                        results["fb_pillar_gt"].long().reshape(-1),
                        batch["pillar_valid"].reshape(-1))
    fb = (weights["w_fb_bce_loss"] * fb_stats["bce_loss"]
          + weights["w_fb_lovasz_loss"] * fb_stats["lovasz_loss"])
    total = total + fb
    stats["fb_loss"] = fb
    stats["fb_metric"] = fb_stats["metric"]

    # MOS over (gt | est) foreground points; on the decoded FG subset when
    # the model decoded one
    fb_mask = (((batch["fb_labels"] == 1) | (results["fb_est_per_points"] == 1))
               & batch["point_valid"])
    if "mos_sub" in results:
        sel, sv = results["sub_sel"].long(), results["sub_valid"]
        mos_stats = seg_loss(results["mos_sub"].reshape(-1, 2),
                             torch.gather(batch["sd_labels"], 1, sel).reshape(-1),
                             sv.reshape(-1))
    else:
        mos_stats = seg_loss(results["mos_est"].reshape(-1, 2),
                             batch["sd_labels"].reshape(-1), fb_mask.reshape(-1))
    mos = torch.where(fb_mask.sum() > 0,
                      weights["w_mos_bce_loss"] * mos_stats["bce_loss"]
                      + weights["w_mos_lovasz_loss"] * mos_stats["lovasz_loss"], 0.0)
    total = total + mos
    stats["mos_loss"] = mos
    stats["mos_metric"] = mos_stats["metric"]

    off_norm, off_dir, off_l2 = offset_loss(batch, results, max_instances)
    off = off_dir * weights["w_offset_dir_loss"] + off_norm * weights["w_offset_norm_loss"]
    total = total + off
    stats["offset_loss"] = off
    stats["offset_l1_loss"] = off_norm
    stats["offset_dir_loss"] = off_dir
    stats["offset_l2_error"] = off_l2

    # TPointNet objective, iteration i weighted by gamma^(n_iter - 1 - i)
    if "tpointnet_loss_terms" in results:
        terms = results["tpointnet_loss_terms"]
        n_iter = len(terms)
        obj = 0.0
        for i, key in enumerate(sorted(terms)):
            v = terms[key]
            pose_l = (weights["w_obj_trans_loss"] * v["trans_loss"]
                      + weights["w_obj_rot_loss"] * v["rot_loss"])
            c_loss = weights["w_obj_l1_loss"] * v["l1_loss"] + weights["w_obj_pose_loss"] * pose_l
            obj = obj + c_loss * weights["obj_gamma"] ** (n_iter - (i + 1))
        obj = obj * weights["w_obj_loss"]
        total = total + obj
        stats["obj_loss"] = obj
        stats["inst_l2_error"] = results["inst_l2_error"]
        stats["dynamic_inst_l2_error"] = results["dynamic_inst_l2_error"]

    stats["loss"] = total
    return stats
