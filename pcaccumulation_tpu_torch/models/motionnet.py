"""MotionNet: the end-to-end orchestrator (the port of the JAX package's
`models/motionnet.py`, `mode="train" | "val" | "test"`).

Pillar stats -> PillarFeatureNet -> BEV densify -> UNet -> FB head ->
ego-feature head + EgoMotionHead -> shear warp of the folded BEV canvas ->
STPN -> FG-subset AlignNet/TPointNet reconstruction. Static capacities and
masks stand for the reference's dynamic selections, and its dynamic gates
are `torch.where` selections on default outputs, so the train and val
forwards never read a value back to the host.

Test mode takes the FB mask from the estimate alone and reconstructs the
instances that the on-device clustering of the moving points finds
(ops/cluster.py; its propagation reads one flag back per pass), against
identity instance motions; `inst_labels_override` injects labels instead.
With `pose_estimation.icp` / `tpointnet.icp` on, the ego poses and the
instance motions are refined by ICP (ops/icp.py, kernel K4).

BatchNorm runs with batch statistics in `model.train()` and with running
statistics in `model.eval()`. The forward is differentiable: the kernels'
gradients are `torch.autograd.Function`s (kernels/segscan.py,
kernels/row_shift.py). As in the JAX package, the warp and the
reconstruction read the BEV features and the ego pose detached.

`precision.compute_dtype: bfloat16` runs the val and test forward with a
bfloat16 backbone, its casts where the JAX package puts them: the pillar
encoder's MLP and pools (K1 in bf16), the UNet, the FB and ego-feature
heads (outputs kept in bf16; the FB decision compares the bf16 logits at
the pillars), the shear warp of the bf16 canvas (K2 in bf16) and the
STPN's convolutions; the densify runs in float32, the per-point gathers
read bf16 rows and lerp them in float32, and Sinkhorn, Kabsch, ICP and
every pose stay float32. In train mode the same casts carry the gradient
back (K1's bf16 gradient in the pillar encoder), the 2-D heads' BatchNorm
takes the batch statistics in float32 in the form of the JAX module it
stands for (`S2DBatchNorm` where the JAX model runs the head in
space-to-depth layout: the FB head whenever its level-0 s2d is active, the
ego-feature head when its sparse form is too; flax's BatchNorm otherwise),
and the parameters and their gradients stay float32.

Under `parallel.mesh.model_parallel(mesh)` with a frame or spatial axis
(one sequence split over several processes, as the JAX model's sharding
constraints split it under GSPMD) only the UNet is split: every rank
computes the pillar stats, the pillar encoder and the canvas of its data
slice, runs the UNet on its contiguous block of the [B*T] rows and its
band of H rows (halo exchanges before each 3x3 convolution), and one
gather puts the UNet's output back together on every rank; the heads,
the warp, the STPN and the reconstruction then run on every rank as in
one process. Outside it the forward is that of one process.

Each stage runs inside a `torch.profiler.record_function` range named
`motionnet.<stage>` (the ICP ranges `motionnet.icp_ego` and
`motionnet.icp_instance` sit inside the ego and reconstruction stages);
`pcaccumulation_tpu_torch.profile_forward` reads them.
Outside a profiler a range costs a few microseconds.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.profiler import record_function

from pcaccumulation_tpu_torch.models.egomotion import EgoMotionHead
from pcaccumulation_tpu_torch.models.layers import SegHead2D
from pcaccumulation_tpu_torch.models.pillar_encoder import (
    PillarFeatureNet,
    gather_bev_at_pillars,
    pillar_stats,
    scatter_pillars_to_bev,
)
from pcaccumulation_tpu_torch.models.stpn import STPN
from pcaccumulation_tpu_torch.models.tpointnet import AlignNet
from pcaccumulation_tpu_torch.models.unet import UNet
from pcaccumulation_tpu_torch.ops import se3
from pcaccumulation_tpu_torch.ops.bilinear import (
    temporal_ungrid,
    ungrid,
    warp_bev_batch,
    warp_bev_folded,
)
from pcaccumulation_tpu_torch.ops.cluster import cluster_moving_points
from pcaccumulation_tpu_torch.ops.segment import compact_mask_indices, take_rows_unique
from pcaccumulation_tpu_torch.parallel.mesh import (
    active_split,
    bands,
    blocks,
    gather_blocks,
    global_sum,
    halo_rows,
)

MIN_POINTS = 15


def _put_rows(base: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """base [B, N, C] with rows [B, S, C] written at idx [B, S]; an index of
    N (or beyond) is dropped, as JAX's `mode="drop"` scatter drops it."""
    b, n, c = base.shape
    out = torch.cat([base, base.new_zeros((b, 1, c))], dim=1)
    idx = idx.long().clamp(0, n)
    out.scatter_(1, idx[..., None].expand(-1, -1, c), rows.to(base.dtype))
    return out[:, :n]


class MotionNet(nn.Module):
    """cfg is the full (derived) config dict."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        vg = cfg["voxel_generator"]
        pe = cfg["pillar_encoder"]
        pose = cfg["pose_estimation"]
        dtype_name = cfg.get("precision", {}).get("compute_dtype", "float32")
        if dtype_name not in ("float32", "bfloat16"):
            raise NotImplementedError(f"compute_dtype={dtype_name!r}: float32 and bfloat16 "
                                      f"are ported")
        cd = self.compute_dtype = None if dtype_name == "float32" else torch.bfloat16
        self.warp_mode = cfg.get("warp_mode", "shear")
        if self.warp_mode not in ("shear", "gather"):
            raise ValueError(f"warp_mode={self.warp_mode!r}")
        self.grid_hw = (vg["grid_size"][1], vg["grid_size"][0])  # (H=ny, W=nx)
        self.n_frames = vg["n_sweeps"]
        self.pc_range = vg["range"]
        self.voxel_size = vg["voxel_size"]
        self.max_pillars = cfg["capacity"]["max_pillars"]
        c = pe["num_filters"]

        self.pillar_encoder = PillarFeatureNet(
            num_filters=c, depth=pe["depth"], voxel_size=vg["voxel_size"],
            pc_range=vg["range"], n_sweeps=vg["n_sweeps"], compute_dtype=cd)
        self.unet = UNet(cfg["unet"]["in_channels"], cfg["unet"]["depth"],
                         cfg["unet"]["start_filts"], compute_dtype=cd, keep_compute_dtype=True)
        cf = cfg["unet"]["in_channels"]
        # the JAX model's level-0 space-to-depth (the same function) decides
        # which BatchNorm form its heads run in bf16
        s2d = (cfg["unet"].get("s2d_level0", True) and cfg["unet"]["depth"] > 1
               and self.grid_hw[0] % 2 == 0 and self.grid_hw[1] % 2 == 0)
        self.semseg_head = SegHead2D(cf, 2, compute_dtype=cd, keep_compute_dtype=True,
                                     s2d_bn=s2d)
        self.ego_feats_head = SegHead2D(cf, pose["feats_dim"], compute_dtype=cd,
                                        keep_compute_dtype=True,
                                        s2d_bn=s2d and pose.get("sparse_eval", True))
        self.ego_motion_head = EgoMotionHead(
            n_kpts=pose["n_kpts"], sinkhorn_iter=pose["sinkhorn_iter"],
            slack=pose["add_slack"], n_sweeps=vg["n_sweeps"], freq=cfg["data"]["freq"],
            max_speed=cfg["data"]["max_speed"], seq_pose=pose["seq_pose"],
            deterministic_sampling=pose.get("deterministic_sampling", False),
            icp=pose.get("icp", False), icp_threshold=pose.get("icp_threshold", 0.15),
            icp_max_iter=pose.get("icp_max_iter", 50))
        self.motionhead = STPN(feat_dim=cfg["stpn"]["feat_dim"], n_frames=vg["n_sweeps"],
                               n_band_layers=cfg["stpn"].get("n_band_layers", 4),
                               compute_dtype=cd)
        tp = cfg["tpointnet"]
        self.reconstructor = AlignNet(
            n_frames=vg["n_sweeps"], n_iterations=tp["n_iterations"],
            min_points_per_frame=tp["min_points"], icp=tp.get("icp", False),
            icp_threshold=tp.get("icp_threshold", 0.25), icp_max_iter=tp.get("icp_max_iter", 50),
            icp_max_points=tp.get("icp_max_points", 1024), compute_dtype=cd)

    def _unet(self, x: torch.Tensor) -> torch.Tensor:
        """The UNet on x [B*T, H, W, C]; under `model_parallel` on this
        rank's block of rows and band of H, joined back on every rank."""
        m = active_split()
        if m is None:
            return self.unet(x)
        n, h = x.shape[:2]
        if n < m.frame:
            raise ValueError(f"{n} rows of [B*T] do not split over {m.frame} frame ranks")
        rows, band = blocks(n, m.frame), bands(h, self.unet.band_unit, m.spatial)
        _, f, s = m.coords
        r0, h0 = sum(rows[:f]), sum(band[:s])
        halo = None if m.spatial_group is None else halo_rows(m.spatial_group)
        y = self.unet(x[r0:r0 + rows[f], h0:h0 + band[s]], halo)
        return gather_blocks(gather_blocks(y, 1, band, m.spatial_group), 0, rows, m.frame_group)

    def forward(self, batch: dict, mode: str = "val",
                generator: torch.Generator | None = None,
                inst_labels_override: torch.Tensor | None = None,
                kpt_scores: torch.Tensor | None = None) -> dict:
        """batch: the collated tensors (see `pcaccumulation_tpu_torch.to_device`).
        generator: the random keypoint draw's torch.Generator, or kpt_scores
        [B, T, max_pillars]: its uniform scores, drawn beforehand (both
        unused with deterministic sampling). inst_labels_override [B, N] (test mode):
        instance labels to reconstruct instead of the clustering's."""
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode={mode!r}")
        points = batch["points"].float()                  # [B, N, 3]
        time_idx = batch["time_idx"]                      # [B, N]
        point_valid = batch["point_valid"]                # [B, N]
        p2v = batch["pillar_of_point"]                    # [B, N]
        pillar_coords = batch["pillar_coords"]            # [B, M, 3]
        pillar_valid = batch["pillar_valid"]              # [B, M]
        fb_labels = batch["fb_labels"]                    # [B, N]

        b, n, _ = points.shape
        m = self.max_pillars
        t = self.n_frames
        h, w = self.grid_hw
        results = {}

        # ---- 1. pillar stats ------------------------------------------------
        with record_function("motionnet.pillar_stats"):
            pillar_mean, fb_pillar_gt = pillar_stats(points, fb_labels, point_valid, p2v, m)

        # ---- 2. pillar encoder -> BEV -> UNet -------------------------------
        with record_function("motionnet.pillar_encoder"):
            pillar_feats = self.pillar_encoder(points, time_idx, point_valid, p2v,
                                               pillar_coords, pillar_mean, m)  # [B, M, C]
        c = pillar_feats.shape[-1]
        with record_function("motionnet.densify"):
            # float32 canvas; the UNet casts it to the compute dtype
            packed = torch.cat([pillar_feats.float(), pillar_valid[..., None].float(),
                                fb_pillar_gt[..., None].float()], dim=-1)
            canvas = scatter_pillars_to_bev(packed, pillar_coords, pillar_valid, t, (h, w))
            results["occ_map"] = canvas[..., c:c + 1]
            results["fb_seg_gt"] = canvas[..., c + 1:c + 2]
        with record_function("motionnet.unet"):
            # [B*T, H, W, Cf] in the compute dtype
            bev_feats = self._unet(canvas[..., :c].reshape(b * t, h, w, c))
        cf = bev_feats.shape[-1]

        # ---- 3. FB segmentation ---------------------------------------------
        with record_function("motionnet.fb_head"):
            fb_logits = self.semseg_head(bev_feats).reshape(b, t, h, w, 2)
            results["fb_seg_est"] = fb_logits.float()
            # the decision compares the compute-dtype logits, as in JAX
            fb_logit_pillar = gather_bev_at_pillars(fb_logits, pillar_coords, pillar_valid)
            fb_est_pillar = (fb_logit_pillar[..., 1] > fb_logit_pillar[..., 0]).to(torch.int32)
            results["fb_logit_pillar"] = fb_logit_pillar.float()
            results["fb_pillar_gt"] = fb_pillar_gt
            fb_est_point = torch.gather(fb_est_pillar, 1, p2v.long().clamp(0, m - 1))
            fb_est_point = torch.where(point_valid, fb_est_point, 0)
            results["fb_est_per_points"] = fb_est_point

        # ---- 4. ego motion ----------------------------------------------------
        with record_function("motionnet.ego"):
            ego_feats = self.ego_feats_head(bev_feats).reshape(b, t, h, w, -1)
            ego_pillar = gather_bev_at_pillars(ego_feats, pillar_coords, pillar_valid).float()
            # eps inside the sqrt: invalid pillar rows are exactly zero
            ego_pillar = ego_pillar / torch.sqrt((ego_pillar ** 2).sum(-1, keepdim=True) + 1e-12)
            ego = self.ego_motion_head(
                ego_pillar, pillar_mean, pillar_coords[..., 0], pillar_valid, fb_est_pillar == 0,
                batch["ego_motion_gt"].float(),
                pillar_scan_key=pillar_coords[..., 1] * w + pillar_coords[..., 2],
                generator=generator, points=points, time_idx=time_idx, point_valid=point_valid,
                point_bg=(fb_est_point == 0) & point_valid, kpt_scores=kpt_scores)
            results.update(ego)

        # ---- 5. warp + motion segmentation ----------------------------------
        with record_function("motionnet.warp"):
            pose_est = results["ego_motion_est"].detach()
            # fold to [B, H, W, T*Cf], t-minor: the layout of the row-shift
            # warp, in the compute dtype (K2 in bf16 under bfloat16)
            bevf = (bev_feats.detach().reshape(b, t, h, w, cf).permute(0, 2, 3, 1, 4)
                    .reshape(b, h, w, t * cf))
            # pose 0 pinned to the exact identity: frame 0's shifts are ~0 and
            # the row shift passes it through
            poses_w = torch.cat(
                [torch.eye(4, dtype=pose_est.dtype, device=pose_est.device).expand(b, 1, 4, 4),
                 pose_est[:, 1:]], dim=1)
            warp_args = (self.voxel_size[0], self.voxel_size[1], self.pc_range[0],
                         self.pc_range[1])
            if self.warp_mode == "gather":
                # per-frame bilinear warp of the unfolded [B*T, H, W, Cf] maps
                unfolded = bevf.reshape(b, h, w, t, cf).permute(0, 3, 1, 2, 4)
                warped = warp_bev_batch(unfolded.reshape(b * t, h, w, cf),
                                        poses_w.reshape(b * t, 4, 4), *warp_args,
                                        method="gather")
                warped = (warped.reshape(b, t, h, w, cf).permute(0, 2, 3, 1, 4)
                          .reshape(b, h, w, t * cf))
            else:
                warped = warp_bev_folded(bevf, poses_w, *warp_args)
        transformed_points = se3.ego_motion_compensation(points, time_idx, pose_est)
        results["transformed_points"] = transformed_points

        with record_function("motionnet.stpn"):
            fb_mask = (fb_est_point == 1) & point_valid
            if mode != "test":
                fb_mask = fb_mask | ((fb_labels == 1) & point_valid)
            gate = global_sum(fb_mask.sum()) > MIN_POINTS
            s_fb = self.cfg["capacity"].get("max_fg_points", 0) or n
            default_mos = torch.zeros((b, n, 2), dtype=points.dtype, device=points.device)
            default_mos[..., 0] = 1.0
            if s_fb < n:
                # decode MOS/offset on the FG subset only
                sel_fb, sel_fb_valid = compact_mask_indices(fb_mask, s_fb)
                pts_sub = take_rows_unique(transformed_points, sel_fb)
                mos_sub, off_sub, mos_map = self.motionhead(warped, pts_sub, sel_fb_valid,
                                                            self.pc_range[0])
                put_idx = torch.where(sel_fb_valid & gate, sel_fb, n)
                results["mos_est"] = _put_rows(default_mos, put_idx, mos_sub)
                results["offset_est"] = _put_rows(torch.zeros_like(default_mos), put_idx, off_sub)
                results["mos_sub"] = mos_sub
                results["offset_sub"] = off_sub
                results["sub_sel"] = sel_fb
                results["sub_valid"] = sel_fb_valid & gate
            else:
                mos, offset, mos_map = self.motionhead(warped, transformed_points, fb_mask,
                                                       self.pc_range[0])
                use = (fb_mask & gate)[..., None]
                results["mos_est"] = torch.where(use, mos, default_mos)
                results["offset_est"] = torch.where(use, offset, 0.0)

        # ---- 6. per-instance reconstruction ---------------------------------
        inst_labels = batch["inst_labels"]
        inst_motion_gt = batch["inst_motion_gt"].float()
        rec_mask = (fb_labels == 1) & point_valid
        if mode == "test":
            inst_labels = inst_labels_override
            if inst_labels is None:
                with record_function("motionnet.cluster"):
                    ccfg = self.cfg["cluster"]
                    moving = torch.argmax(results["mos_est"], dim=-1) == 1
                    inst_labels = torch.stack([
                        cluster_moving_points(
                            transformed_points[i], results["offset_est"][i], moving[i],
                            point_valid[i], eps=ccfg["eps_dbscan"],
                            min_samples=ccfg["min_samples_dbscan"],
                            min_cluster_size=ccfg["min_p_cluster"], pre_voxel=0.05,
                            max_cluster_points=ccfg["max_cluster_points"],
                            n_iters=ccfg["bfs_iters"])
                        for i in range(b)])
                    # the static instance capacity: overflow ids -> background
                    k_cap = inst_motion_gt.shape[1]
                    inst_labels = torch.where(inst_labels < k_cap, inst_labels, 0)
            results["inst_labels_est"] = inst_labels
            rec_mask = (inst_labels != 0) & point_valid
            inst_motion_gt = torch.eye(4, dtype=torch.float32, device=points.device).expand(
                inst_motion_gt.shape)
        with record_function("motionnet.reconstruction"):
            s_cap = self.cfg["capacity"].get("max_fg_points", 0) or n
            if s_cap < n:
                sel, r_mask = compact_mask_indices(rec_mask, s_cap)
                r_points = take_rows_unique(transformed_points, sel)
                # raw per-frame coords: the backbone lookup samples the UNWARPED
                # per-frame maps
                r_points_raw = take_rows_unique(points, sel)
                r_tid = take_rows_unique(time_idx, sel)
                r_inst = take_rows_unique(inst_labels, sel)
                r_sd = take_rows_unique(batch["sd_labels"], sel)
            else:
                sel = None
                r_points, r_points_raw, r_tid = transformed_points, points, time_idx
                r_inst, r_mask, r_sd = inst_labels, rec_mask, batch["sd_labels"]

            # gathers the compute-dtype rows, lerps them at float32 weights
            backbone_pp = temporal_ungrid(bev_feats.detach().reshape(b, t, h, w, cf),
                                          r_points_raw[..., :2], r_tid, self.pc_range[0]).float()
            mos_pp = ungrid(mos_map, r_points[..., :2], self.pc_range[0])
            rec = self.reconstructor(
                r_points, r_tid, r_inst, r_mask, r_sd, backbone_pp, mos_pp,
                inst_motion_gt, results["ego_motion_gt"],
                results["ego_motion_est"])

        rec_gate = global_sum(r_mask.sum()) > MIN_POINTS
        results["tpointnet_loss_terms"] = {
            it: {k: torch.where(rec_gate, v, 0.0) for k, v in terms.items()}
            for it, terms in rec["tpointnet_loss_terms"].items()
        }
        results["inst_l2_error"] = torch.where(rec_gate, rec["inst_l2_error"], 0.0)
        results["dynamic_inst_l2_error"] = torch.where(rec_gate, rec["dynamic_inst_l2_error"],
                                                       0.0)
        results["inst_pose_est"] = rec["inst_pose_est"]
        if sel is None:
            results["rec_est"] = torch.where((r_mask & rec_gate)[..., None],
                                             rec["sub_rec_est"], transformed_points)
        else:
            # scatter the reconstructed subset back; invalid slots dropped
            results["rec_est"] = _put_rows(transformed_points,
                                           torch.where(r_mask & rec_gate, sel, n),
                                           rec["sub_rec_est"])
        results["rec_mask"] = rec_mask
        results["fb_mask"] = fb_mask
        return results
