"""The port's host-side modules of the serving path against the JAX
package's: the tracker (`track.py`) on tests/test_tracker.py's scenarios,
the tracker over the port's Predictor (tests/test_track_pipeline.py's
pipeline, oracle heads), the scene-flow evaluator (`SFEvaluator`,
`load_and_display`), the ground-plane fit (`data/ground.py`) and the
synthetic dataset writer (`write_synthetic_dataset`).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu import track as jtrack
from pcaccumulation_tpu.data import ground as jground
from pcaccumulation_tpu.data.synthetic import write_synthetic_dataset as jax_write
from pcaccumulation_tpu.train import sf_metrics as jsf
from pcaccumulation_tpu_torch import track as ttrack
from pcaccumulation_tpu_torch.data import ground as tground
from pcaccumulation_tpu_torch.data.synthetic import write_synthetic_dataset
from pcaccumulation_tpu_torch.train import sf_metrics as tsf
from test_track_pipeline import CENTERS, N_SEQ, _blob_stream, _true_center


def assert_same(a, b, path="") -> None:
    """Equal nested dicts / lists / arrays / numbers (NaN equal to NaN)."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


# ---- the tracker on tests/test_tracker.py's scenarios -----------------------

def _scenarios():
    rng = np.random.default_rng(0)
    z0 = rng.normal(size=(3, 3)) * 5
    vel = np.array([[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0.5]])
    kf = [z0] + [z0 + (t + 1) * vel + rng.normal(size=z0.shape) * 0.05 for t in range(6)]
    ts = np.arange(14, dtype=np.float64)
    a = np.stack([ts, np.zeros_like(ts), np.zeros_like(ts)], 1)
    b = np.stack([13 - ts, 0.3 * np.ones_like(ts), np.zeros_like(ts)], 1)
    base = rng.normal(size=(5, 3)) * 40
    v5 = rng.normal(size=(5, 3)) * 0.5
    sep = [(base + t * v5 + rng.normal(size=base.shape) * 0.02)[rng.permutation(5)]
           for t in range(8)]
    empty = np.zeros((0, 3))
    return {
        "batched_kf": ({"mahalanobis_threshold": 1e9}, [(f, None) for f in kf]),
        "velocity": ({}, [(np.array([[2.0 * t, -1.0 * t, 0.5 * t]]), None) for t in range(12)]),
        "birth_death": ({"max_age": 2, "min_hits": 2}, [
            (np.array([[0.0, 0, 0]]), None), (np.array([[0.1, 0, 0]]), None), (empty, None),
            (empty, None), (np.array([[5.0, 5, 5]]), [{"score": 0.7, "instance_id": 9}]),
            (empty, None), (empty, None)]),
        "gate": ({"mahalanobis_threshold": 2.0, "velocity_uncertainty": 1.0,
                  "pos_uncertainty": 1.0},
                 [(np.array([[0.0, 0, 0]]), None), (np.array([[50.0, 0, 0]]), None)]),
        "crossing": ({}, [(np.stack([a[t], b[t]]), None) for t in range(14)]),
        "greedy": ({"match_algorithm": "greedy"}, [(f, None) for f in sep]),
        "hungarian": ({"match_algorithm": "hungarian"}, [(f, None) for f in sep]),
        "state_2d": ({"state_dim": 4, "obs_dim": 2},
                     [(np.array([[1.0 * t, 2.0 * t]]), None) for t in range(8)]),
    }


def _run_tracker(mod, config, frames):
    tracker = mod.ClusterTracker(config)
    per_frame = [tracker.update(obs, infos) for obs, infos in frames]
    state = (tracker.x.copy(), tracker.P.copy(), list(tracker.ids))
    return per_frame, state, tracker.flush()


@pytest.mark.parametrize("name", sorted(_scenarios()))
def test_tracker_matches_jax(name):
    """The same retired tracks (ids, states, histories), the same ids per
    frame, and the same filter states (x, P) before the flush."""
    config, frames = _scenarios()[name]
    got = _run_tracker(ttrack, config, frames)
    want = _run_tracker(jtrack, config, frames)
    assert_same(got[0], want[0], "per_frame")
    assert_same(got[1], want[1], "state")
    assert_same(got[2], want[2], "flush")
    assert got[2] or any(dead for dead, _ in got[0]), "no track was retired"


def test_track_scene_and_empty_tracker_match_jax():
    frames = [np.array([[1.0 * t, 0.5 * t, 0.0], [10.0, -2.0 * t, 1.0]]) for t in range(10)]
    assert_same(ttrack.track_scene(frames), jtrack.track_scene(frames))
    for mod in (ttrack, jtrack):
        tracker = mod.ClusterTracker()
        dead, ids = tracker.update(np.zeros((0, 3)))
        assert not dead and ids.size == 0
        tracker.update(np.array([[1.0, 1, 1]]))
        tracker.clear()
        assert tracker.update(np.array([[0.0, 0, 0]]))[1].tolist() == [1]


# ---- the tracker over the port's Predictor ----------------------------------

@pytest.fixture(scope="module")
def predictor():
    """tests/test_track_pipeline.py's predictor on the port: configs/
    synthetic.yaml cut as there, the Predictor's seeded initialisation (the
    JAX package's distributions) with oracle heads (every point foreground and moving, zero offsets), so that the
    instances are the clusterer's geometric clusters."""
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.serve import Predictor

    cfg = load_config("configs/synthetic.yaml", [
        "--unet.depth=3", "--pillar_encoder.depth=2", "--pose_estimation.sinkhorn_iter=2",
        "--pose_estimation.n_kpts=128", "--cluster.bfs_iters=8", "--tpointnet.n_iterations=1"])
    pred = Predictor(cfg, device="cpu")
    sd = pred.model.state_dict()
    for head, bias in (("semseg_head", [-8.0, 8.0]), ("motionhead.mos_seg", [-8.0, 8.0]),
                       ("motionhead.offset_head", None)):
        sd[f"{head}.seg_head.3.weight"].zero_()
        b = sd[f"{head}.seg_head.3.bias"]
        b.copy_(torch.zeros_like(b) if bias is None else torch.tensor(bias))
    return pred


def test_tracker_over_predictor_stream(predictor):
    """Every synthetic object holds one track id over the whole stream of
    N_SEQ sequences, distinct objects distinct ids (the JAX test's
    criteria); the centroids match the JAX helper's."""
    t_frames = predictor.n_frames
    tracker = ttrack.ClusterTracker()
    id_per_blob = {b: [] for b in range(len(CENTERS))}
    scans = [_blob_stream(s, t_frames) for s in range(N_SEQ)]
    for s, out in enumerate(predictor.predict_stream(iter(scans))):
        assert out["inst_labels"].max() >= len(CENTERS), (s, out["inst_labels"].max())
        obs, infos = ttrack.centroids_from_labels(
            out["points"], out["time_idx"], out["inst_labels"], t_frames)
        assert_same((obs, infos), jtrack.centroids_from_labels(
            out["points"], out["time_idx"], out["inst_labels"], t_frames))
        for t in range(t_frames):
            _, assigned = tracker.update(obs[t], infos[t])
            for b in range(len(CENTERS)):
                d = np.linalg.norm((obs[t] - _true_center(b, s * t_frames + t))[:, :2], axis=1)
                assert d.min() < 0.5, (s, t, b, d.min())
                id_per_blob[b].append(int(assigned[int(d.argmin())]))
    ids_used = set()
    for b, ids in id_per_blob.items():
        assert len(ids) == N_SEQ * t_frames and len(set(ids)) == 1, (b, ids)
        ids_used.add(ids[0])
    assert len(ids_used) == len(CENTERS)
    confirmed = [t for t in tracker.flush() if t["confirmed"]]
    assert len(confirmed) == len(CENTERS)
    for tr in confirmed:
        assert tr["track_length"] == N_SEQ * t_frames
        assert all(h["n_points"] > 100 for h in tr["track_history"])


# ---- the scene-flow evaluator -----------------------------------------------

def _sf_inputs(seed, n=600, n_frames=3):
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=(n, 3)).astype(np.float32)
    est = gt + rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    tid = rng.integers(0, n_frames, n)
    fb = rng.random(n) < 0.3
    sd = fb & (rng.random(n) < 0.5)
    return gt, est, tid, fb, sd, rng.random(n) < 0.8


def test_sf_evaluator_matches_jax(tmp_path, capsys):
    """tests/test_evaluation.py's evaluator cases: two scenes, one with a
    mask and precomputed errors; the results, the saved pickle and the
    printed tables equal the JAX package's."""
    results, printed = {}, {}
    for name, mod in (("port", tsf), ("jax", jsf)):
        ev = mod.SFEvaluator(3, save_dir=str(tmp_path / name))
        gt, est, tid, fb, sd, _ = _sf_inputs(0)
        ev.update(gt, est, tid, fb, sd)
        gt, est, tid, fb, sd, mask = _sf_inputs(1)
        err = np.linalg.norm(est - gt, axis=1)
        ev.update(gt, est, tid, fb, sd, mask=mask, epe_per_point=err,
                  relative_error=err / (np.linalg.norm(gt, axis=1) + 1e-7))
        results[name] = ev.full_evaluation(display=False)
        capsys.readouterr()
        mod.load_and_display(str(tmp_path / name / "sf_results.pkl"))
        printed[name] = capsys.readouterr().out
    assert_same(results["port"], results["jax"])
    with open(tmp_path / "port" / "sf_results.pkl", "rb") as f:
        assert_same(pickle.load(f), results["jax"])
    assert printed["port"] == printed["jax"] and "Detailed results on FG part" in printed["port"]
    assert results["port"]["overall"]["overall"]["Acc3DR"] > 0.5


# ---- the ground-plane fit ---------------------------------------------------

def _ground_cases():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-40, 40, size=(4000, 2))
    gz = 0.05 * xy[:, 0] - 0.02 * xy[:, 1] - 1.5
    obj_xy = rng.uniform(-30, 30, size=(600, 2))
    obj_z = 0.05 * obj_xy[:, 0] - 0.02 * obj_xy[:, 1] - 1.5 + rng.uniform(0.8, 2.5, 600)
    tilted = np.concatenate([np.concatenate([xy, (gz + rng.normal(0, 0.03, 4000))[:, None]], 1),
                             np.concatenate([obj_xy, obj_z[:, None]], 1)])
    x, y = rng.uniform(-50, 50, size=(2, 6000))
    slope = np.stack([x, y, 0.08 * x - 1.6 + rng.normal(0, 0.02, 6000)], 1)
    return {"tilted": (tilted, {}), "slope": (slope, {}), "empty": (np.zeros((0, 3)), {}),
            "two_points": (np.array([[0.0, 0, 5.0], [1.0, 0, 5.1]]), {"seed_margin": -10.0})}


@pytest.mark.parametrize("name", sorted(_ground_cases()))
def test_ground_fit_matches_jax(name):
    """tests/test_data.py's ground cases: the same plane and classification."""
    pts, kw = _ground_cases()[name]
    assert_same(tground.fit_ground_plane(pts, **kw), jground.fit_ground_plane(pts, **kw))
    assert_same(tground.non_ground_mask(pts, **kw), jground.non_ground_mask(pts, **kw))


# ---- the synthetic dataset writer -------------------------------------------

def test_write_synthetic_dataset_matches_jax(tmp_path):
    kw = dict(n_frames=3, seed=5, n_static_clusters=4, n_dynamic=2, pts_per_cluster=40,
              pts_per_object=30)
    got = write_synthetic_dataset(str(tmp_path / "port"), 5, **kw)
    want = jax_write(str(tmp_path / "jax"), 5, **kw)
    assert got == want
    for split in ("train", "val", "test"):
        with open(tmp_path / "port" / f"{split}_info.txt") as f, \
                open(tmp_path / "jax" / f"{split}_info.txt") as g:
            assert f.read() == g.read(), split
    for rel in got:
        with np.load(os.path.join(tmp_path, "port", rel)) as a, \
                np.load(os.path.join(tmp_path, "jax", rel)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{rel} {k}")
