"""How far one rounding of its distances moves the test path's instance ICP,
on the CPU, with the weights and scene of `chip_smoke.py`'s test path.

    python tools/icp_spread.py [--threads 8]

The default config with both ICPs at 3 iterations, `build_model`'s weights
after `torch.manual_seed(0)` (the JAX package's initial distributions),
the FB and MOS heads calibrated on the first default scene
(`calibrate_heads`), deterministic keypoints. The test forward runs twice
on the CPU: with K4's plain version (|a|^2 + |b|^2 - 2 a.b), then with the
distances computed as K4 computes them (`chip_smoke.nn_difference_form`),
the first run's cluster labels injected. It prints, per occupied
(instance, frame > 0) slice, how far the second run's pose lies from the
first: over the whole path (both ICPs take the other form), and for the
instance ICP alone on the first run's inputs; and, for each slice the whole
path moves, the pairs of its first ICP iteration and the singular values
of their cross-covariance. Then one JSON line. Needs no card; takes a few
minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def slices(pose_a, pose_b, occ, slice_pts, tol=1e-2):
    """Share of the slices within `tol`, and (slot, frame, max |d pose|,
    points in frame 0, in frame t) of the others."""
    d = (pose_a[occ, 1:] - pose_b[occ, 1:]).abs().amax((-1, -2))
    off = [(int(occ[i]), int(j) + 1, round(float(d[i, j]), 4), int(slice_pts[occ[i], 0]),
            int(slice_pts[occ[i], j + 1]))
           for i, j in zip(*torch.nonzero(d > tol, as_tuple=True))]
    return float((d <= tol).float().mean()), off


def first_kabsch(icp_args, slot: int, frame: int) -> tuple[int, list[float]]:
    """The instance ICP's first iteration on one slice of its inputs: the
    pairs within the threshold, and the singular values of their
    (centred) cross-covariance, whose smaller two near 0 leave the Kabsch
    rotation undetermined."""
    from pcaccumulation_tpu_torch.kernels.chamfer import nn_plain
    from pcaccumulation_tpu_torch.ops import se3

    points, time_idx, gid, valid, pose, threshold = icp_args[:6]
    rec = se3.reconstruct_sequence(points, time_idx, gid, pose)
    mine = valid & (gid.long() == slot)
    src, tgt = rec[mine & (time_idx == frame)], rec[mine & (time_idx == 0)]
    d2, idx = nn_plain(src[None], tgt[None], torch.ones(1, len(tgt), dtype=torch.bool))
    w = d2[0] < threshold * threshold
    a, b = src[w], tgt[idx[0].long()[w]]
    if len(a) == 0:
        return 0, []
    h = (a - a.mean(0)).T @ (b - b.mean(0))
    return int(w.sum()), [float(x) for x in torch.linalg.svdvals(h)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)

    import chip_smoke
    import pcaccumulation_tpu_torch as port
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.models import tpointnet
    from pcaccumulation_tpu_torch.ops.icp import refine_instance_poses
    from pcaccumulation_tpu_torch.profile_forward import (
        calibrate_heads,
        default_scenes,
        test_mode_config,
    )

    t0 = time.perf_counter()
    cfg = load_config()
    cfg["pose_estimation"]["deterministic_sampling"] = True
    bt = port.to_device(collate(default_scenes(cfg, 1)), "cpu")
    torch.manual_seed(chip_smoke.SEED)
    model = port.build_model(cfg, "cpu")
    calibrate_heads(model, bt)
    cfg3 = test_mode_config(dict(cfg, pose_estimation=dict(cfg["pose_estimation"]),
                                 tpointnet=dict(cfg["tpointnet"])), 3)
    m3 = port.build_model(cfg3, "cpu")
    m3.load_state_dict(model.state_dict())
    with torch.no_grad():
        with chip_smoke.recording(tpointnet, "refine_instance_poses") as icp_calls:
            plain = m3(bt, mode="test")
        labels = plain["inst_labels_est"]
        with chip_smoke.difference_form():
            diff = m3(bt, mode="test", inst_labels_override=labels)
    icp_args, icp_kw, icp_plain = icp_calls.calls[0]
    with chip_smoke.difference_form():
        icp_diff = refine_instance_poses(*icp_args, **icp_kw)

    valid = bt["point_valid"][0]
    lab0 = labels[0]
    tid0 = bt["time_idx"][0].long()
    occ = torch.unique(lab0[(lab0 > 0) & valid])
    t_frames = plain["inst_pose_est"].shape[2]
    slice_pts = torch.bincount(lab0[valid].long() * t_frames + tid0[valid],
                               minlength=(int(lab0.max()) + 1) * t_frames).reshape(-1, t_frames)
    path_share, path_off = slices(plain["inst_pose_est"][0], diff["inst_pose_est"][0], occ,
                                  slice_pts)
    rec_share = float(((plain["rec_est"] - diff["rec_est"]).abs().amax(-1)[0]
                       <= 1e-2)[valid].float().mean())
    alone_share, alone_off = slices(icp_plain, icp_diff, occ, slice_pts)
    settled_share, unsettled = slices(icp_plain, icp_diff, occ, slice_pts, tol=1e-4)
    print(f"{int(occ.numel()) * (t_frames - 1)} (instance, frame) slices; the plain expansion "
          f"against K4's arithmetic, both on the CPU ({time.perf_counter() - t0:.1f} s)")
    print(f"whole test path: {path_share:.4f} of the slices and {rec_share:.6f} of the points' "
          f"rec_est within 1e-2; the others (slot, frame, max |d pose|, points in frame 0, in "
          f"frame t): {path_off}")
    print(f"instance ICP alone, one set of inputs: {alone_share:.4f} within 1e-2, "
          f"{settled_share:.4f} within 1e-4; over 1e-4: {unsettled}")
    kabsch = {f"{slot},{frame}": first_kabsch(icp_args, slot, frame)
              for slot, frame, *_ in path_off}
    print("first ICP iteration of those slices (pairs within the threshold, singular values "
          "of their cross-covariance): " + "; ".join(
              f"({k}) {n} pairs, " + ", ".join(f"{x:.2e}" for x in sv)
              for k, (n, sv) in kabsch.items()))
    print(json.dumps({"slices": int(occ.numel()) * (t_frames - 1),
                      "path_share": path_share, "path_rec_share": rec_share,
                      "path_off": path_off, "alone_share": alone_share,
                      "alone_settled_share": settled_share, "alone_unsettled": unsettled,
                      "first_kabsch": kabsch}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
