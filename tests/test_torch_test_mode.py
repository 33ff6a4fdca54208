"""The PyTorch port's test path against the JAX package: the clustering
functions, MotionNet(mode="test") with both ICPs on, `warp_mode: gather`,
the Tester's flow_error.npz dumps, the port's evaluation and the test CLI.

One JAX parameter tree (random, seeded, from numpy) drives both packages;
the port loads it through `state_dict_from_jax`. Keypoint sampling is
deterministic. Sizes are cut for the CPU: ICP runs a few iterations over
a few thousand points (JAX's nearest neighbour holds the whole [N, N]
distance matrix).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu.config import derive, load_config
from pcaccumulation_tpu.models import MotionNet as JaxMotionNet
from pcaccumulation_tpu.ops import cluster as jcl
from pcaccumulation_tpu_torch import build_model, to_device
from pcaccumulation_tpu_torch.ops import cluster as tcl
from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_motionnet import (
    config,
    make_batch,
    place_fb_threshold,
    random_variables,
    run_jax,
    run_port,
)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blobs(rng, centers, sizes, scale):
    return np.concatenate([rng.normal(scale=scale, size=(s, 3)) + c
                           for c, s in zip(centers, sizes)]).astype(np.float32)


def co_membership(a: np.ndarray, b: np.ndarray) -> float:
    """Share of point pairs on which two labelings agree about being in the
    same (non-zero) cluster."""
    same_a = (a[:, None] == a[None, :]) & (a[:, None] != 0)
    same_b = (b[:, None] == b[None, :]) & (b[:, None] != 0)
    return float((same_a == same_b).mean())


def test_voxel_downsample_matches_jax():
    """Points exactly on a rounding boundary (x / voxel == k + 0.5 in
    float32, where round-half-to-even decides), duplicates and invalid
    points: the same representatives, slots and inverse map."""
    rng = np.random.default_rng(0)
    vox = 0.05
    pts = (rng.random((600, 3)) * 2).astype(np.float32)
    k = rng.integers(-40, 40, size=(200, 3))
    half = ((k + 0.5) * vox).astype(np.float32)
    on_boundary = (half / np.float32(vox)) == (k + 0.5)
    assert on_boundary.sum() > 100
    pts[:200] = half
    pts[200:260] = pts[:60]  # duplicates
    valid = rng.random(600) < 0.85
    got = tcl.voxel_downsample(T(pts), T(valid), vox, 512)
    want = [np.asarray(x) for x in jcl.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid),
                                                        vox, 512)]
    rep_valid = got[1].numpy()
    np.testing.assert_array_equal(rep_valid, want[1])
    np.testing.assert_array_equal(got[0].numpy()[rep_valid], want[0][rep_valid])
    np.testing.assert_array_equal(got[2].numpy()[valid], want[2][valid])
    assert 0 < rep_valid.sum() < valid.sum()


def test_dbscan_labels_match_jax():
    """Blobs, noise, and a chain of points spaced exactly eps = 0.4 apart in
    x (float32 distances on the <= eps boundary decide co-membership)."""
    rng = np.random.default_rng(1)
    pts = _blobs(rng, [[0, 0, 0], [3, 0, 0], [0, 4, 0], [6, 6, 0]], [60, 50, 40, 30], 0.1)
    noise = (rng.random((40, 3)) * 10 - 2).astype(np.float32)
    chain = np.stack([np.arange(12, dtype=np.float32) * np.float32(0.4) + 10.0,
                      np.full(12, 5.0, np.float32), np.zeros(12, np.float32)], -1)
    pts = np.concatenate([pts, noise, chain, np.zeros((30, 3), np.float32)])
    valid = np.arange(len(pts)) < len(pts) - 30
    got = tcl.dbscan_labels(T(pts), T(valid), 0.4, 3, n_iters=16).numpy()
    want = np.asarray(jcl.dbscan_labels(jnp.asarray(pts), jnp.asarray(valid), 0.4, 3,
                                        n_iters=16))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[got >= 0])) >= 4


@pytest.mark.parametrize("order", ["first", "size"])
def test_filter_and_canonicalise_matches_jax(order):
    rng = np.random.default_rng(2)
    labels = rng.integers(-1, 40, size=500).astype(np.int32)
    labels[rng.random(500) < 0.3] = 7  # one big cluster
    valid = rng.random(500) < 0.9
    got = tcl.filter_and_canonicalise(T(labels), T(valid), 12, order=order).numpy()
    want = np.asarray(jcl.filter_and_canonicalise(jnp.asarray(labels), jnp.asarray(valid), 12,
                                                  order=order))
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 3


def test_cluster_moving_points_matches_jax():
    """Three moving objects whose offsets vote towards their centres and a
    static background: equal labels, 1..C by descending size."""
    rng = np.random.default_rng(3)
    centres = np.array([[2.0, 1.0, 0.5], [-3.0, 2.0, 0.5], [5.0, -4.0, 0.3]])
    sizes = [80, 120, 40]
    obj = _blobs(rng, centres, sizes, 0.3)
    pts = np.concatenate([obj, rng.normal(scale=5.0, size=(200, 3)).astype(np.float32)])
    n = len(pts)
    moving = np.arange(n) < sum(sizes)
    offset = np.zeros((n, 2), np.float32)
    offset[:sum(sizes)] = (np.repeat(centres[:, :2], sizes, 0) - obj[:, :2]) * 0.9
    valid = rng.random(n) < 0.95
    args = dict(max_cluster_points=512, n_iters=8)
    got = tcl.cluster_moving_points(T(pts), T(offset), T(moving), T(valid), **args).numpy()
    want = np.asarray(jcl.cluster_moving_points(jnp.asarray(pts), jnp.asarray(offset),
                                                jnp.asarray(moving), jnp.asarray(valid), **args))
    np.testing.assert_array_equal(got, want)
    assert sorted(set(got[:sum(sizes)]) - {0}) == [1, 2, 3]


# ---- MotionNet(mode="test") -------------------------------------------------

# absolute tolerances, float32 on the CPU, eval BN: the val forward's
# (tests/test_torch_motionnet.py) where the ICPs do not act; the ICP-refined
# poses iterate products and 3x3 SVDs that round differently in the two
# frameworks
TEST_TOL = {"fb_seg_est": 1e-5, "ego_motion_est": 2e-4, "mos_est": 1e-4, "offset_est": 1e-4,
            "transformed_points": 1e-3, "rec_est": 1e-3, "inst_pose_est": 1e-3}


def small_test_config():
    """The default-path parity config, B=1, 4,000 points, both ICPs on with
    4 iterations, the clusterer at 1,024 representatives."""
    cfg = config("default")
    cfg["capacity"].update(max_points=4000, max_pillars=3000)
    cfg["pose_estimation"].update(icp=True, icp_max_iter=4)
    cfg["tpointnet"].update(icp=True, icp_max_iter=4, icp_max_points=256)
    cfg["cluster"].update(max_cluster_points=1024, bfs_iters=8)
    return cfg


@pytest.fixture(scope="module")
def test_case():
    """Weights under which every decoded point is moving (the MOS head's
    class-1 bias raised) with zero offsets, so the clusterer groups the
    estimated-FG points by position; the FB threshold in a wide gap."""
    cfg = small_test_config()
    batch = make_batch(cfg, seed=20, batch_size=1)
    params, stats = random_variables(cfg, batch, seed=1)
    params = place_fb_threshold(cfg, params, stats, batch, False)
    head = params["motionhead"]
    head["mos_seg"]["fc1"]["bias"][1] += 50.0
    head["offset_head"]["fc1"]["kernel"][:] = 0.0
    head["offset_head"]["fc1"]["bias"][:] = 0.0
    return cfg, batch, params, stats


def run_test_mode(cfg, params, stats, batch, override=None):
    model = JaxMotionNet(cfg)
    out = jax.jit(lambda p, s, b, o: model.apply({"params": p, "batch_stats": s}, b, train=False,
                                                 mode="test", inst_labels_override=o))(
        params, stats, jax.tree.map(jnp.asarray, batch), override)
    want = {k: np.asarray(v) for k, v in out.items() if not isinstance(v, dict)}
    tmodel = build_model(cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, stats))
    with torch.no_grad():
        got = tmodel(to_device(batch, "cpu"), mode="test",
                     inst_labels_override=None if override is None else T(override))
    return {k: v.numpy() for k, v in got.items() if torch.is_tensor(v)}, want


@pytest.mark.parametrize("labels", ["injected", "clustered"])
def test_test_mode_forward_matches_jax(test_case, labels, record_property):
    """Injected: both reconstruct the GT instances (labels given to both),
    every output held to TEST_TOL. Clustered: each package clusters its own
    estimate; the labels are compared as co-membership (the clusterer's
    inputs differ by the forward's rounding), and where they are equal the
    outputs are held as above."""
    cfg, batch, params, stats = test_case
    override = batch["inst_labels"] if labels == "injected" else None
    got, want = run_test_mode(cfg, params, stats, batch, override)
    valid = batch["point_valid"][0]
    np.testing.assert_array_equal(got["fb_est_per_points"], want["fb_est_per_points"])
    np.testing.assert_array_equal(got["fb_mask"], want["fb_mask"])
    share = co_membership(got["inst_labels_est"][0][valid], want["inst_labels_est"][0][valid])
    record_property("co_membership", share)
    assert share >= 0.999, share
    if labels == "clustered":
        assert len(np.unique(got["inst_labels_est"])) >= 3  # the clusterer found instances
        if not np.array_equal(got["inst_labels_est"], want["inst_labels_est"]):
            return
    np.testing.assert_array_equal(got["rec_mask"], want["rec_mask"])
    for key, tol in TEST_TOL.items():
        record_property(f"max_abs_err.{key}", float(np.abs(got[key] - want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0, err_msg=key)
    # the ICPs acted: the instance motions are not the identity
    assert np.abs(got["inst_pose_est"][..., 1:, :3, 3]).max() > 1e-3


def test_gather_warp_matches_jax():
    """`warp_mode: gather` in the val forward (the per-pixel bilinear warp)
    against JAX, eval BN, at the val forward's tolerances."""
    cfg = config("default")
    cfg["warp_mode"] = "gather"
    batch = make_batch(cfg, batch_size=1)
    params, stats = random_variables(cfg, batch)
    params = place_fb_threshold(cfg, params, stats, batch, False)
    got = run_port(cfg, params, stats, batch, False)
    want = run_jax(cfg, params, stats, batch, False)
    np.testing.assert_array_equal(got["fb_mask"], want["fb_mask"])
    for key in ("ego_motion_est", "mos_est", "offset_est", "rec_est"):
        np.testing.assert_allclose(got[key], want[key], atol=TEST_TOL[key], rtol=0, err_msg=key)


# ---- Tester, evaluation, CLI ------------------------------------------------

def make_tester_config():
    """configs/synthetic.yaml at tests/test_tester.py's sizes, 4,000 points,
    both ICPs on (3 iterations), deterministic keypoints."""
    cfg = load_config("configs/synthetic.yaml")
    cfg["misc"].update(mode="test", exp_name="torch_tester")
    cfg["unet"]["depth"] = 3
    cfg["pillar_encoder"]["depth"] = 2
    cfg["pose_estimation"].update(sinkhorn_iter=2, n_kpts=128, deterministic_sampling=True,
                                  approx_sampling=False, icp=True, icp_max_iter=3)
    cfg["cluster"]["bfs_iters"] = 8
    cfg["tpointnet"].update(n_iterations=1, icp=True, icp_max_iter=3)
    cfg["capacity"]["max_points"] = 4000
    cfg["test"]["num_workers"] = 0
    return derive(cfg)


@pytest.fixture(scope="module")
def tester_runs(tmp_path_factory):
    """The JAX Tester and the port's Tester over the 3 test scenes of
    data/synthetic on the same weights, each into its own results tree."""
    from pcaccumulation_tpu.data.dataset import SceneDataset as JDataset
    from pcaccumulation_tpu.train.tester import Tester as JTester
    from pcaccumulation_tpu_torch.train.tester import Tester

    cfg = make_tester_config()
    repo = os.getcwd()
    cfg["path"]["dataset_base"] = os.path.join(repo, "data", "synthetic")
    jdir = str(tmp_path_factory.mktemp("jax_run"))
    with pytest.MonkeyPatch.context() as mp:
        # both packages on their default, native, voxeliser: one point order,
        # so the 4,000-point cap keeps the same strided subsample of it
        sample = JDataset(cfg, "test", augment=False)[0]
        params, stats = random_variables(cfg, {k: v[None] for k, v in sample.items()}, seed=3)
        mp.chdir(jdir)  # the JAX Tester writes results/<exp> under the working directory
        JTester(copy.deepcopy(cfg), JaxMotionNet(cfg), save_dir=jdir,
                variables={"params": params, "batch_stats": stats}).test()
    tdir = str(tmp_path_factory.mktemp("port_run"))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats))
    stats_meter = Tester(copy.deepcopy(cfg), model, save_dir=tdir, device="cpu",
                         results_dir=os.path.join(tdir, "results", "torch_tester")).test()
    return (os.path.join(jdir, "results", "torch_tester"),
            os.path.join(tdir, "results", "torch_tester"), tdir, stats_meter)


def test_tester_dumps_match_jax(tester_runs, record_property):
    """Same scenes, keys, dtypes and lengths; labels and time indices equal;
    epe within 1e-2 m (the forwards agree to ~1e-3 m; fp16 storage rounds
    epe ~1 m to 5e-4)."""
    jroot, troot, tdir, stats_meter = tester_runs
    scenes = sorted(os.listdir(troot))
    assert scenes == sorted(os.listdir(jroot)) and len(scenes) == 3
    worst = 0.0
    for scene in scenes:
        with np.load(os.path.join(troot, scene, "flow_error.npz")) as g, \
                np.load(os.path.join(jroot, scene, "flow_error.npz")) as w:
            assert set(g.files) == set(w.files) == {
                "fb_label", "sd_label", "epe_per_point", "relative_error", "time_indice"}
            for k in g.files:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            for k in ("fb_label", "sd_label", "time_indice"):
                np.testing.assert_array_equal(g[k], w[k])
            assert g["time_indice"].min() >= 1  # the anchor frame is left out
            d = np.abs(g["epe_per_point"].astype(np.float64) - w["epe_per_point"])
            worst = max(worst, float(d.max()))
    record_property("max_abs_err.epe", worst)
    assert worst < 1e-2, worst
    assert np.asarray(stats_meter["intersection"].sum).shape == (2,)
    assert os.path.exists(os.path.join(tdir, "cluster_eval.txt"))


def test_evaluation_matches_jax(tester_runs, tmp_path):
    """The port's evaluation and the JAX package's root evaluation.py over
    the same dumps give the same numbers."""
    import evaluation as jeval

    from pcaccumulation_tpu_torch import evaluation as teval

    _, troot, _, _ = tester_runs
    got = teval.collect_results(troot, str(tmp_path / "port"), "synthetic")
    want = jeval.collect_results(troot, str(tmp_path / "jax"), "synthetic")

    def flat(meter, prefix=""):
        for k, v in sorted(meter.items()):
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", (v.avg, v.count)

    assert list(flat(got[0])) == list(flat(want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert len(list(flat(got[0]))) > 10


def test_cli_test_mode_on_cpu(tmp_path, monkeypatch, capsys):
    """python -m pcaccumulation_tpu_torch.main <cfg> 1 1 --misc.mode=test
    --misc.device=cpu dumps every test scene, and the port's evaluation CLI
    reads them."""
    from pcaccumulation_tpu_torch import evaluation
    from pcaccumulation_tpu_torch.main import main

    repo = os.getcwd()
    os.symlink(os.path.join(repo, "data"), tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    args = ["main", os.path.join(repo, "configs", "synthetic.yaml"), "1", "1",
            "--misc.mode=test", "--misc.device=cpu", "--misc.exp_name=cli_test",
            "--unet.depth=3", "--pillar_encoder.depth=2", "--pose_estimation.n_kpts=128",
            "--capacity.max_points=4000", "--cluster.bfs_iters=4", "--test.num_workers=0"]
    assert main(args) == 0
    scenes = sorted(os.listdir(tmp_path / "results" / "cli_test"))
    assert len(scenes) == 3
    assert evaluation.main(["evaluation", "results/cli_test", "synthetic"]) == 0
    assert "Results on the dynamic part" in capsys.readouterr().out
    assert (tmp_path / "metrics" / "cli_test" / "static_stats.pkl").exists()
