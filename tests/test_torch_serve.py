"""The port's serving layer (`pcaccumulation_tpu_torch/serve.py`) against the
JAX package's `serve.py`: the Predictor's outputs, `predict_stream`, the
raw-scan checks, `prep_sample(with_labels=False)`, the clusterer's
fixed-pass form, JAX checkpoints read by the port, and the `torch.export`
artifact.

One JAX parameter tree (random, seeded, from numpy) drives both packages;
the port loads it through `state_dict_from_jax`. The config is
tests/test_serve.py's `_tiny_cfg` with deterministic keypoints and the
clusterer at 1,024 representatives; the MOS head calls every decoded point
moving and the offsets are zero, so that the clusterer finds the objects.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import pcaccumulation_tpu.data.voxelizer as jvox
from pcaccumulation_tpu.data.dataset import prep_sample as jax_prep_sample
from pcaccumulation_tpu.data.loader import collate
from pcaccumulation_tpu.ops import cluster as jcl
from pcaccumulation_tpu.serve import Predictor as JaxPredictor
from pcaccumulation_tpu_torch.data.dataset import prep_sample
from pcaccumulation_tpu_torch.ops import cluster as tcl
from pcaccumulation_tpu_torch.serve import (
    EXPORT_FORMAT_VERSION,
    ExportedPredictor,
    Predictor,
)
from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
from test_serve import _scan, _tiny_cfg
from test_torch_motionnet import place_fb_threshold, random_variables

# absolute tolerances, float32 on the CPU (the val forward's, 1e-4): the
# two frameworks sum in other orders; the poses go through Sinkhorn and an
# SVD, the points move with them
FLOAT_KEYS = ("rec_points", "flow", "offset", "ego_motion", "transformed_points")
LABEL_KEYS = ("mos", "fb", "inst_labels", "time_idx")
FB_TOL = 1e-5  # the val forward's FB logit tolerance
N_SCANS = 3


def serve_config():
    cfg = _tiny_cfg()
    cfg["pose_estimation"]["deterministic_sampling"] = True
    cfg["cluster"]["max_cluster_points"] = 1024
    return cfg


@pytest.fixture(scope="module")
def served():
    """The JAX and the port's Predictor on one parameter tree, and their
    outputs on N_SCANS scans."""
    cfg = serve_config()
    scans = [_scan(s) for s in range(N_SCANS)]
    port = Predictor(cfg, device="cpu")  # torch's seeded init, replaced below
    batch = collate([jax_prep_sample(port._wrap(*s), cfg, with_labels=False) for s in scans])
    params, stats = random_variables(cfg, batch, seed=3)
    params = place_fb_threshold(cfg, params, stats, batch, False)
    head = params["motionhead"]
    head["mos_seg"]["fc1"]["bias"][1] += 50.0  # every decoded point moves
    head["offset_head"]["fc1"]["kernel"][:] = 0.0
    head["offset_head"]["fc1"]["bias"][:] = 0.0
    port.model.load_state_dict(state_dict_from_jax(params, stats))
    jaxp = JaxPredictor(cfg, variables={"params": params, "batch_stats": stats})
    with pytest.MonkeyPatch.context() as mp:
        # the numpy voxeliser, whose pillar numbering (and so point order)
        # the port's copy has
        mp.setattr(jvox, "_USE_NATIVE", False)
        jax_out = [jaxp.predict(*s) for s in scans]
    return {
        "cfg": cfg, "scans": scans, "params": params, "stats": stats, "batch": batch,
        "port": port, "jax": jaxp, "jax_out": jax_out,
        "port_out": [port.predict(*s) for s in scans],
    }


def assert_outputs_match(got: dict, want: dict, tol: float, what: str) -> None:
    assert sorted(got) == sorted(want), what
    np.testing.assert_array_equal(got["points"], want["points"], err_msg=what)
    for key in LABEL_KEYS:
        assert got[key].dtype == np.int32, (what, key)
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{what} {key}")
    for key in FLOAT_KEYS:
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0,
                                   err_msg=f"{what} {key}")


def test_predict_matches_jax(served, record_property):
    """mos, fb and inst_labels equal, the floats within 1e-4, on scans whose
    pillars all lie at least twice the FB logit tolerance from the
    decision (so a flip cannot pass for a tolerance failure); the poses
    are not the identity and the clusterer found instances."""
    port = served["port"]
    n_inst = []
    for i, scan in enumerate(served["scans"]):
        dbatch = port._to_device(port._prep(*scan))
        with torch.no_grad():
            lp = port.model(dbatch, mode="val")["fb_logit_pillar"][0].numpy()
        valid = dbatch["pillar_valid"][0].numpy()
        margin = np.abs(lp[..., 1] - lp[..., 0])[valid].min()
        assert margin > 2 * FB_TOL, (i, margin)
        got, want = served["port_out"][i], served["jax_out"][i]
        record_property(f"scan{i}.max_abs_err", max(
            float(np.abs(got[k] - want[k]).max()) for k in FLOAT_KEYS))
        assert_outputs_match(got, want, 1e-4, f"scan {i}")
        assert 0 < got["fb"].mean() < 1
        assert np.abs(got["ego_motion"][1:, :3, 3]).max() > 1e-2
        n_inst.append(len(np.unique(got["inst_labels"])) - 1)
    assert max(n_inst) >= 3, n_inst


@pytest.mark.parametrize("depth", [1, 3])
def test_predict_stream_equals_predict(served, depth):
    port = served["port"]
    streamed = list(port.predict_stream(iter(served["scans"]), prefetch=2, depth=depth))
    assert len(streamed) == N_SCANS
    for got, want in zip(streamed, served["port_out"]):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_predict_stream_propagates_producer_errors(served):
    def bad_scans():
        yield served["scans"][0]
        raise RuntimeError("sensor died")

    it = served["port"].predict_stream(bad_scans())
    next(it)
    with pytest.raises(RuntimeError, match="sensor died"):
        list(it)


def test_to_device_rejects_real_labels(served):
    port = served["port"]
    batch = port._prep(*served["scans"][0])
    port._to_device(batch)  # a neutral batch passes
    bad = dict(batch)
    bad["sd_labels"] = np.ones_like(batch["sd_labels"])
    with pytest.raises(AssertionError, match="neutral-GT"):
        port._to_device(bad)


def test_predict_validates_raw_scan_contract(served):
    """tests/test_serve.py::test_predict_validates_raw_scan_contract's cases
    and messages."""
    port = served["port"]
    pts, tid = served["scans"][0]
    with pytest.raises(ValueError, match=r"\[m, 3\]"):
        port.predict(pts[:, :2], tid)
    with pytest.raises(ValueError, match="time_idx must be"):
        port.predict(pts, tid[:-1])
    with pytest.raises(ValueError, match="integer"):
        port.predict(pts, tid.astype(np.float32))
    with pytest.raises(ValueError, match="n_frames"):
        bad = tid.copy()
        bad[0] = 99
        port.predict(pts, bad)


def test_predictor_wants_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(serve_config())


def test_prep_sample_without_labels_matches_jax(served, monkeypatch):
    """Field by field against the JAX package's prep_sample(with_labels=
    False) (numpy voxeliser), and equal to the labelled form but for the
    zero labels."""
    monkeypatch.setattr(jvox, "_USE_NATIVE", False)
    cfg = served["cfg"]
    from pcaccumulation_tpu.data.synthetic import generate_sample

    data = generate_sample(seed=4, n_frames=3, freq=10.0, n_static_clusters=6, n_dynamic=2,
                           pts_per_cluster=150, pts_per_object=80, area=6.0)
    got = prep_sample(data, cfg, with_labels=False)
    want = jax_prep_sample(data, cfg, with_labels=False)
    labelled = prep_sample(data, cfg)
    assert sorted(got) == sorted(want) == sorted(labelled)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        if "labels" in key:
            assert not got[key].any(), key
        else:
            np.testing.assert_array_equal(got[key], labelled[key], err_msg=key)
    assert labelled["fb_labels"].any() and labelled["inst_labels"].any()


def test_dbscan_fixed_passes_equal_early_exit(monkeypatch):
    """The form that `torch.export` records (all n_iters passes, no host
    read) gives the early exit's labels and the JAX package's, on blobs,
    noise and a chain spaced exactly eps apart (which needs many passes)."""
    rng = np.random.default_rng(1)
    blobs = np.concatenate([rng.normal(scale=0.1, size=(s, 3)) + c for c, s in
                            zip([[0, 0, 0], [3, 0, 0], [0, 4, 0]], [60, 50, 40])])
    chain = np.stack([np.arange(40) * 0.4 + 10.0, np.full(40, 5.0), np.zeros(40)], -1)
    noise = rng.random((30, 3)) * 10 - 2
    pts = np.concatenate([blobs, chain, noise]).astype(np.float32)
    valid = rng.random(len(pts)) < 0.97
    valid[150:190] = True
    for n_iters in (2, 16):
        args = (torch.from_numpy(pts), torch.from_numpy(valid), 0.4, 3, n_iters)
        early = tcl.dbscan_labels(*args).numpy()
        with monkeypatch.context() as m:
            m.setattr(torch.compiler, "is_exporting", lambda: True)
            fixed = tcl.dbscan_labels(*args).numpy()
        want = np.asarray(jcl.dbscan_labels(pts, valid, 0.4, 3, n_iters=n_iters))
        np.testing.assert_array_equal(early, fixed)
        np.testing.assert_array_equal(early, want)
    assert len(np.unique(fixed[fixed >= 0])) >= 4


def test_jax_checkpoint_serves_through_the_port(served, tmp_path):
    """A checkpoint written by the JAX package's save_checkpoint, with the
    optax state of its Trainer's optimizer, serves through the port's
    Predictor(ckpt_path=...) with the JAX Predictor's outputs."""
    import pcaccumulation_tpu.train.trainer as jtrainer
    from pcaccumulation_tpu.utils.checkpoint import save_checkpoint as jax_save

    from pcaccumulation_tpu_torch.utils.checkpoint import Inert, load_checkpoint

    params, stats = served["params"], served["stats"]
    tx = jtrainer.make_optimizer(served["cfg"], 10)[0]
    opt_state = tx.init(jax.tree.map(np.asarray, params))
    path = str(tmp_path / "model_best_metric.ckpt")
    jax_save(path, {"epoch": 3, "params": params, "batch_stats": stats,
                    "opt_state": opt_state, "best_loss": 1.5, "best_metric": 0.25})
    state = load_checkpoint(path)
    assert state["epoch"] == 3 and state["best_metric"] == 0.25
    # optax's MultiStepsState, not imported: its fields, mini_step first
    assert isinstance(state["opt_state"], Inert) and len(state["opt_state"].args) == 5
    assert state["opt_state"].args[0].dtype == np.int32
    port = Predictor(served["cfg"], ckpt_path=path, device="cpu")
    for i in (0, 1):
        assert_outputs_match(port.predict(*served["scans"][i]), served["jax_out"][i], 1e-4,
                             f"checkpoint, scan {i}")


def test_export_matches_live_predictor(served, tmp_path):
    """The CPU artifact: its graph calls the kernels' operators, its outputs
    equal the live Predictor's (labels exactly, floats within 1e-6), and
    the version, device and re-export failures raise."""
    import zipfile

    port = served["port"]
    path = str(tmp_path / "model.pt2")
    port.export(path)
    served_x = ExportedPredictor(path, device="cpu")
    assert served_x.model is None
    code = served_x._program.code
    for op in ("pcacc.seg_pool", "pcacc.row_shift_blocks"):
        assert f"torch.ops.{op}" in code, op
    for i in (0, 2):
        got, want = served_x.predict(*served["scans"][i]), served["port_out"][i]
        assert sorted(got) == sorted(want)
        for key in LABEL_KEYS + ("points",):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        for key in FLOAT_KEYS:
            np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)

    with pytest.raises(NotImplementedError, match="artifact"):
        served_x.export(str(tmp_path / "again.pt2"))

    def rewrite(name, **files):
        out = str(tmp_path / name)
        with zipfile.ZipFile(path) as zin, zipfile.ZipFile(out, "w") as zout:
            for item in zin.infolist():
                base = item.filename.rpartition("/extra/")[2]
                if "/extra/" in item.filename and base in files:
                    if files[base] is not None:
                        zout.writestr(item, files[base])
                else:
                    zout.writestr(item, zin.read(item.filename))
        return out

    with pytest.raises(ValueError, match="format_version"):
        ExportedPredictor(rewrite("v.pt2", format_version="999"), device="cpu")
    with pytest.raises(RuntimeError, match="'cuda'.*'cpu'"):
        ExportedPredictor(rewrite("dev.pt2", device_type="cuda"), device="cpu")
    with pytest.raises(RuntimeError, match="None"):
        ExportedPredictor(rewrite("nodev.pt2", device_type=None), device="cpu")
    assert ExportedPredictor(rewrite("ok.pt2"), device="cpu").cfg == served["cfg"]
    assert int(zipfile.ZipFile(path).read(
        [n for n in zipfile.ZipFile(path).namelist() if n.endswith("/extra/format_version")][0]
    )) == EXPORT_FORMAT_VERSION


def test_export_with_icp_matches_live_predictor(served, tmp_path):
    """With `pose_estimation.icp` and `tpointnet.icp` on, the CPU artifact's
    graph holds K4's operator once per ICP iteration (the ego and the
    instance loops, unrolled), and its outputs equal the live Predictor's
    with ICP on (labels exactly, floats within 1e-6), which differ from
    ICP off."""
    cfg = copy.deepcopy(served["cfg"])
    cfg["pose_estimation"].update(icp=True, icp_max_iter=3)
    cfg["tpointnet"].update(icp=True, icp_max_iter=2, icp_max_points=256)
    live = Predictor(cfg, state_dict=served["port"].model.state_dict(), device="cpu")
    path = str(tmp_path / "icp.pt2")
    live.export(path)
    exported = ExportedPredictor(path, device="cpu")
    assert exported._program.code.count("torch.ops.pcacc.nn_packed") == 5
    got, want = exported.predict(*served["scans"][0]), live.predict(*served["scans"][0])
    for key in LABEL_KEYS + ("points",):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in FLOAT_KEYS:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)
    assert np.abs(want["ego_motion"] - served["port_out"][0]["ego_motion"]).max() > 0
    assert want["inst_labels"].max() > 0  # the instance ICP had instances to refine


def test_random_draw_is_fixed_per_predictor(served):
    """With the random keypoint draw, the Predictor draws its scores once
    from its seed: two calls agree, as two Predictors of one seed do; the
    scores fed to the model equal a draw from the generator inside it."""
    from pcaccumulation_tpu_torch.models.egomotion import draw_keypoints

    cfg = copy.deepcopy(served["cfg"])
    cfg["pose_estimation"]["deterministic_sampling"] = False
    sd = served["port"].model.state_dict()
    a, b = (Predictor(cfg, state_dict=sd, rng_seed=5, device="cpu") for _ in range(2))
    scan = served["scans"][0]
    out = [a.predict(*scan), a.predict(*scan), b.predict(*scan)]
    for o in out[1:]:
        for key in out[0]:
            np.testing.assert_array_equal(o[key], out[0][key], err_msg=key)
    mask = torch.rand(a._scores.shape, generator=torch.Generator().manual_seed(9)) < 0.3
    np.testing.assert_array_equal(
        draw_keypoints(mask, 16, False, scores=a._scores),
        draw_keypoints(mask, 16, False, generator=torch.Generator().manual_seed(5)))
