"""The port's single-card options against the JAX package: the ego head's
`seq_pose: chain | full`, the STPN's `n_band_layers` 1-3 (with the weight
map of its `post_conv` layers), the val forward with both, and the loader's
`worker_mode: process`. Float32 on the CPU; inputs are seeded numpy arrays
handed to both packages, weights carried across by `state_dict_from_jax`."""

import copy
import os

import jax
import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu.data import loader as jloader
from pcaccumulation_tpu.models.egomotion import EgoMotionHead as JEgo
from pcaccumulation_tpu.models.egomotion import pair_lists as j_pair_lists
from pcaccumulation_tpu.models.pillar_encoder import pillar_stats as jpillar_stats
from pcaccumulation_tpu.models.stpn import STPN as JSTPN
from pcaccumulation_tpu_torch import build_model
from pcaccumulation_tpu_torch.config import derive
from pcaccumulation_tpu_torch.config import load_config as t_load_config
from pcaccumulation_tpu_torch.data import loader as tloader
from pcaccumulation_tpu_torch.data.dataset import SceneDataset
from pcaccumulation_tpu_torch.models.egomotion import EgoMotionHead, pair_lists
from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_motionnet import (
    TOL,
    config,
    make_batch,
    place_fb_threshold,
    random_variables,
    run_jax,
    run_port,
)

T = torch.from_numpy


def test_pair_lists_match_jax():
    for t in range(2, 12):
        for strategy in ("skip", "chain", "full"):
            assert pair_lists(t, strategy) == j_pair_lists(t, strategy), (t, strategy)
    assert len(pair_lists(11, "full")[0]) == 55


@pytest.mark.parametrize("t", [3, 4])
@pytest.mark.parametrize("seq_pose", ["chain", "full"])
def test_ego_motion_head_seq_pose_matches_flax(seq_pose, t):
    """The JAX head and the port's on the same pillars, deterministic
    keypoints, pose-invariant descriptors (see
    test_torch_modules.py::test_ego_motion_head_deterministic_matches_flax):
    poses, the pair losses, the metrics and the anchor pairs' perm
    matrices. Sample 1's last frame has no background pillar, so its pairs
    are gated to the identity and left out of the losses (`pair_ok` over
    all pairs), while the metrics average over every frame."""
    cfg = config("default")
    cfg["voxel_generator"]["n_sweeps"] = t
    cfg["data"]["n_frames"] = t
    cfg = derive(cfg)
    batch = make_batch(cfg)
    rng = np.random.default_rng(t)
    m = cfg["capacity"]["max_pillars"]
    pe = cfg["pose_estimation"]
    w = cfg["voxel_generator"]["grid_size"][0]
    mean = np.asarray(jpillar_stats(batch["points"], batch["fb_labels"], batch["point_valid"],
                                    batch["pillar_of_point"], m)[0])
    coords = batch["pillar_coords"]
    pose = batch["ego_motion_gt"][np.arange(mean.shape[0])[:, None], coords[..., 0]]
    world = np.einsum("bmij,bmj->bmi", pose[..., :3, :3], mean) + pose[..., :3, 3]
    freq = rng.normal(size=(2, 64))
    feats = np.cos(world[..., :2] @ freq + 2 * np.pi * rng.random(64)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    bg = rng.random(coords.shape[:2]) < 0.9
    bg[1, coords[1, :, 0] == t - 1] = False
    scan_key = coords[..., 1] * w + coords[..., 2]
    alpha, beta = np.float32(-4.9), np.float32(-5.1)
    kw = dict(n_kpts=pe["n_kpts"], sinkhorn_iter=pe["sinkhorn_iter"], slack=pe["add_slack"],
              n_sweeps=t, freq=cfg["data"]["freq"], max_speed=cfg["data"]["max_speed"],
              seq_pose=seq_pose, deterministic_sampling=True)
    want = jax.jit(JEgo(**kw).apply)(
        {"params": {"alpha": alpha, "beta": beta}}, feats, mean, coords[..., 0],
        batch["pillar_valid"], bg, batch["points"], batch["time_idx"], batch["point_valid"],
        batch["ego_motion_gt"], pillar_scan_key=scan_key)
    head = EgoMotionHead(**kw)
    with torch.no_grad():
        head.alpha.fill_(float(alpha))
        head.beta.fill_(float(beta))
        got = head(T(feats), T(mean), T(coords[..., 0].copy()), T(batch["pillar_valid"]),
                   T(bg), T(batch["ego_motion_gt"]), T(scan_key))
    assert got["perm_matrix"].shape == (2, t - 1, pe["n_kpts"], pe["n_kpts"])
    # float32 on both sides: Sinkhorn and the 3x3 SVD round differently
    for key in ("ego_motion_est", "perm_matrix", "ego_motion_gt", "ego_l1_loss",
                "ego_l2_loss", "ego_trans_error"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   err_msg=key)
    # degrees, an arccos near 1: the estimates agree to ~3e-6 (chain
    # composes up to T-1 rounded poses), which moves the trace by up to
    # ~1e-5, and at these ~0.6 degree angles d(angle)/d(trace) = 1 / (2 sin)
    # turns that into up to ~0.03 degrees
    np.testing.assert_allclose(got["ego_rot_error"].numpy(), np.asarray(want["ego_rot_error"]),
                               atol=1e-2)
    est, gt = got["ego_motion_est"].numpy(), got["ego_motion_gt"].numpy()
    # the gated frame's link is the identity (chain: it keeps frame t-2's
    # pose); sample 0's estimate is the motion (1-4 m here), within 10 cm
    np.testing.assert_array_equal(est[1, t - 1], est[1, t - 2] if seq_pose == "chain"
                                  else np.eye(4, dtype=np.float32))
    assert np.abs(gt[0, 1:, :3, 3]).max() > 1.0
    np.testing.assert_allclose(est[0, :, :3, 3], gt[0, :, :3, 3], atol=0.1)


@pytest.fixture(scope="module")
def net():
    """One JAX MotionNet tree of the default-path config (n_band_layers 4)."""
    cfg = config("default")
    batch = make_batch(cfg)
    params, stats = random_variables(cfg, batch, seed=1)
    return cfg, params, stats


@pytest.mark.parametrize("k", [1, 2, 3])
def test_stpn_band_layers_match_flax(net, k):
    """JAX's STPN with k banded layers before the temporal max and 4 - k
    `post_conv` layers after it, its parameters carried into the port's
    MotionNet by `state_dict_from_jax` (a strict load: every layer named)."""
    cfg, params, stats = net
    t = cfg["voxel_generator"]["n_sweeps"]
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 32, 32, t * 32)).astype(np.float32)
    pts = ((rng.random((2, 100, 3)) - 0.5) * 14).astype(np.float32)
    mask = rng.random((2, 100)) < 0.8
    jstpn = JSTPN(feat_dim=32, n_frames=t, n_band_layers=k)
    mh = jax.tree.map(np.array, jstpn.init(jax.random.key(k), x, pts, mask, -8.0)["params"])
    for i in range(k, 4):  # flax initialises biases to zero: make them count
        mh[f"post_conv{i}"]["bias"] = rng.normal(size=32).astype(np.float32) * 0.1
    cfg_k = copy.deepcopy(cfg)
    cfg_k["stpn"]["n_band_layers"] = k
    model = build_model(cfg_k, device="cpu")
    sd = state_dict_from_jax(dict(params, motionhead=mh), stats)
    assert {f"motionhead.post_conv{i}.{p}" for i in range(k, 4) for p in ("weight", "bias")} \
        <= set(sd)
    model.load_state_dict(sd)
    want = jstpn.apply({"params": mh, "batch_stats": stats["motionhead"]}, x, pts, mask, -8.0)
    with torch.no_grad():
        got = model.motionhead.eval()(T(x), T(pts), T(mask), -8.0)
    for g, w_, name in zip(got, want, ("classes", "offset", "mos_map")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-4, err_msg=name)


def test_val_forward_full_pairs_and_two_band_layers_matches_jax():
    """MotionNet's val forward with `seq_pose: full` and `n_band_layers: 2`
    against JAX's, eval BN, with test_torch_motionnet.py's tolerances and
    checks (FB decisions equal, every FB margin above twice the logit
    tolerance)."""
    cfg = config("default")
    cfg["pose_estimation"]["seq_pose"] = "full"
    cfg["stpn"]["n_band_layers"] = 2
    batch = make_batch(cfg)
    params, stats = random_variables(cfg, batch)
    assert "post_conv2" in params["motionhead"] and "init_conv2" not in params["motionhead"]
    params = place_fb_threshold(cfg, params, stats, batch, False)
    got = run_port(cfg, params, stats, batch, False)
    want = run_jax(cfg, params, stats, batch, False)
    tol = TOL[False]
    lp = got["fb_logit_pillar"]
    assert np.abs(lp[..., 1] - lp[..., 0])[batch["pillar_valid"]].min() > 2 * tol["fb_seg_est"]
    np.testing.assert_array_equal(got["fb_est_per_points"], want["fb_est_per_points"])
    np.testing.assert_array_equal(got["fb_mask"], want["fb_mask"])
    t = cfg["voxel_generator"]["n_sweeps"]
    assert got["perm_matrix"].shape[1] == want["perm_matrix"].shape[1] == t - 1
    for key, tl in tol.items():
        np.testing.assert_allclose(got[key], want[key], atol=tl, rtol=0, err_msg=key)
    np.testing.assert_allclose(got["perm_matrix"], want["perm_matrix"], atol=1e-5)
    assert np.abs(got["ego_motion_est"][:, 1:, :3, 3]).max() > 1e-2


class _IdxDataset:
    def __init__(self, n=10):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full(3, i, np.int64), "y": np.arange(4) * i}


class _BadDataset(_IdxDataset):
    def __getitem__(self, i):
        if i == 3:
            raise ValueError("boom")
        return super().__getitem__(i)


class _DyingDataset(_IdxDataset):
    def __getitem__(self, i):
        if i == 3:
            os._exit(13)  # a crash or an OOM kill: no exception raised
        return super().__getitem__(i)


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("drop_last", [True, False])
def test_process_loader_matches_thread_and_jax(drop_last):
    """Forked workers give the thread mode's batches in its order, and the
    JAX loader's (process mode and synchronous) for one seed."""
    ds = _IdxDataset(11)
    want = list(jloader.make_loader(ds, batch_size=2, num_workers=0, seed=3,
                                    drop_last=drop_last))
    _assert_same_batches(list(jloader.make_loader(ds, batch_size=2, num_workers=2, seed=3,
                                                  drop_last=drop_last, mode="process")), want)
    for workers in (1, 2, 3):
        for mode in ("thread", "process"):
            _assert_same_batches(list(tloader.make_loader(
                ds, batch_size=2, num_workers=workers, seed=3, drop_last=drop_last,
                mode=mode)), want)


def test_process_loader_scene_batches_equal_thread_mode():
    """The synthetic dataset's val split (no augmentation) through two
    workers of each mode: equal batches."""
    cfg = t_load_config("configs/synthetic.yaml")
    ds = SceneDataset(cfg, "val")
    thread, proc = (list(tloader.make_loader(ds, batch_size=2, num_workers=2, seed=0,
                                             mode=mode)) for mode in ("thread", "process"))
    assert len(proc) == len(ds) // 2 > 0
    _assert_same_batches(proc, thread)


def test_process_loader_worker_error_propagates():
    loader = tloader.make_loader(_BadDataset(8), batch_size=2, num_workers=2, seed=0,
                                 mode="process")
    with pytest.raises(RuntimeError, match="worker failed.*boom"):
        list(loader)


def test_process_loader_worker_death_detected():
    loader = tloader.make_loader(_DyingDataset(8), batch_size=2, num_workers=2, seed=0,
                                 mode="process")
    with pytest.raises(RuntimeError, match="died"):
        list(loader)


def test_loader_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        tloader.make_loader(_IdxDataset(), batch_size=2, mode="fiber")
