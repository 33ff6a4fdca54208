"""The PyTorch port's val-mode MotionNet forward against JAX
`MotionNet.apply` on two small configs, in eval BN and train BN, with
deterministic keypoint sampling.

One JAX parameter tree (random, seeded, from numpy) drives both: the port
loads it through `state_dict_from_jax`. Both get the same batch, built by
the JAX package's `prep_sample` + `collate`. Config (i) is the composed
parity config of tests/test_full_parity.py with the shear warp; config (ii)
is the default path: shear warp, s2d level 0 and the sparse ego head on the
JAX side, an FG-subset capacity, UNet depth 3, T=5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu.config import derive, load_config
from pcaccumulation_tpu.data.dataset import prep_sample
from pcaccumulation_tpu.data.loader import collate
from pcaccumulation_tpu.data.synthetic import generate_sample
from pcaccumulation_tpu.models import MotionNet as JaxMotionNet
from pcaccumulation_tpu_torch import build_model, to_device
from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax

# absolute tolerances, float32 on the CPU. Eval BN: the two frameworks'
# convolutions and reductions sum in different orders (~1e-7 relative per
# layer); the pose estimate goes through Sinkhorn and an SVD, and the
# points and the warp move with the pose. Train BN: the JAX side takes the
# batch statistics of the 2-D heads as E[x^2] - E[x]^2 over float32 sums
# of 10^4 rows (~1e-5 relative), and the TPointNet regressor normalises
# over a dozen instance rows, which amplifies what reaches it. The rotation
# error (degrees) is an arccos near 1, which amplifies trace rounding.
TOL = {
    False: {"fb_seg_est": 1e-5, "ego_motion_est": 2e-4, "mos_est": 1e-4,
            "offset_est": 1e-4, "transformed_points": 1e-3, "rec_est": 1e-3,
            "ego_l1_loss": 2e-4, "ego_rot_error": 1e-3, "inst_l2_error": 1e-4},
    True: {"fb_seg_est": 2e-4, "ego_motion_est": 2e-3, "mos_est": 3e-3,
           "offset_est": 3e-3, "transformed_points": 5e-3, "rec_est": 3e-2,
           "ego_l1_loss": 2e-4, "ego_rot_error": 3e-3, "inst_l2_error": 3e-3},
}


def config(variant: str) -> dict:
    cfg = load_config()
    t = 3 if variant == "parity" else 5
    cfg["voxel_generator"].update(
        {"range": [-8, -8, -5, 8, 8, 3], "voxel_size": [0.25, 0.25, 8],
         "n_sweeps": t, "crop_range": [8, -5, 3]})
    cfg["data"].update({"n_frames": t, "freq": 10.0, "max_speed": 20})
    cfg["precision"] = {"compute_dtype": "float32"}
    cfg["warp_mode"] = "shear"
    cfg["tpointnet"].update({"n_iterations": 2, "min_points": 5})
    cfg["pillar_encoder"]["depth"] = 2
    if variant == "parity":
        cfg["capacity"] = {"max_points": 8000, "max_pillars": 4000,
                           "max_instances": 8, "max_fg_points": 0}
        cfg["pose_estimation"].update(
            {"n_kpts": 2048, "approx_sampling": False,
             "deterministic_sampling": True, "sparse_eval": False})
        cfg["unet"].update({"depth": 3, "s2d_level0": False})
    else:
        cfg["capacity"] = {"max_points": 12000, "max_pillars": 6000,
                           "max_instances": 8, "max_fg_points": 512}
        cfg["pose_estimation"].update(
            {"n_kpts": 256, "approx_sampling": False,
             "deterministic_sampling": True, "sparse_eval": True})
        cfg["unet"].update({"depth": 3, "s2d_level0": True})
    return derive(cfg)


def make_batch(cfg, seed=10, batch_size=2):
    t = cfg["voxel_generator"]["n_sweeps"]
    return collate([
        prep_sample(generate_sample(seed=seed + i, n_frames=t, n_static_clusters=8,
                                    n_dynamic=2, pts_per_cluster=120, pts_per_object=90,
                                    area=6.0), cfg)
        for i in range(batch_size)
    ])


def random_variables(cfg, batch, seed=0):
    """JAX (params, batch_stats) as numpy trees: shapes from eval_shape,
    values seeded, scaled by fan-in; BN statistics perturbed so eval BN is
    a real test."""
    model = JaxMotionNet(cfg)
    shapes = jax.eval_shape(
        lambda b: model.init({"params": jax.random.key(0), "sample": jax.random.key(1)},
                             b, train=False, mode="val"),
        jax.tree.map(jnp.asarray, batch))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "mean":
            v = 0.05 * rng.normal(size=shape)
        elif name == "var":
            v = 1.0 + 0.2 * rng.random(size=shape)
        elif name in ("alpha", "beta"):
            v = -5.0 + 0.1 * rng.normal(size=shape)
        else:  # bias
            v = 0.05 * rng.normal(size=shape)
        return np.asarray(v, np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(np.asarray, variables["params"]), \
        jax.tree.map(np.asarray, variables["batch_stats"])


def run_jax(cfg, params, stats, batch, train_bn):
    model = JaxMotionNet(cfg)
    out = jax.jit(lambda p, s, b: model.apply(
        {"params": p, "batch_stats": s}, b, train=train_bn, mode="val",
        mutable=["batch_stats"] if train_bn else False))(params, stats,
                                                          jax.tree.map(jnp.asarray, batch))
    out = out[0] if train_bn else out
    return {k: np.asarray(v) for k, v in out.items() if not isinstance(v, dict)}


def run_port(cfg, params, stats, batch, train_bn):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats))
    model.train(train_bn)
    with torch.no_grad():
        out = model(to_device(batch, "cpu"), mode="val")
    return {k: v.numpy() for k, v in out.items() if torch.is_tensor(v)}


def place_fb_threshold(cfg, params, stats, batch, train_bn):
    """Shift the FB head's class-1 logit bias so the decision threshold
    sits in the widest gap of the pillar logit margins between the 50th
    and 95th percentile: both classes occur, and no pillar lies near the
    threshold. Returns new params."""
    lp = run_port(cfg, params, stats, batch, train_bn)["fb_logit_pillar"]
    d = np.sort((lp[..., 1] - lp[..., 0])[batch["pillar_valid"]])
    lo, hi = int(0.5 * len(d)), int(0.95 * len(d))
    i = lo + int(np.argmax(np.diff(d[lo:hi])))
    params = jax.tree.map(np.copy, params)
    params["semseg_head"]["conv1"]["bias"][1] -= (d[i] + d[i + 1]) / 2
    return params


@pytest.fixture(scope="module", params=["parity", "default"])
def case(request):
    cfg = config(request.param)
    batch = make_batch(cfg)
    params, stats = random_variables(cfg, batch)
    return request.param, cfg, batch, params, stats


@pytest.mark.parametrize("train_bn", [False, True], ids=["eval_bn", "train_bn"])
def test_val_forward_matches_jax(case, train_bn, record_property):
    name, cfg, batch, params, stats = case
    tol = TOL[train_bn]
    params = place_fb_threshold(cfg, params, stats, batch, train_bn)
    got = run_port(cfg, params, stats, batch, train_bn)
    want = run_jax(cfg, params, stats, batch, train_bn)

    # a flipped FB decision would change the FG masks and the keypoints
    # downstream: every valid pillar's logit margin must exceed twice the
    # logit tolerance, so that a flip cannot pass for a tolerance failure
    lp = got["fb_logit_pillar"]
    margin = np.abs(lp[..., 1] - lp[..., 0])[batch["pillar_valid"]].min()
    assert margin > 2 * tol["fb_seg_est"], (name, margin)
    np.testing.assert_array_equal(got["fb_est_per_points"], want["fb_est_per_points"])
    fg = got["fb_est_per_points"][batch["point_valid"]].mean()
    assert 0.0 < fg < 1.0, fg  # both FB classes occur
    np.testing.assert_array_equal(got["fb_mask"], want["fb_mask"])
    np.testing.assert_array_equal(got["rec_mask"], want["rec_mask"])

    # the errors go into the JUnit XML (--junitxml) for the parity table
    record_property("min_fb_logit_margin", float(margin))
    for key, t in tol.items():
        record_property(f"max_abs_err.{key}", float(np.abs(got[key] - want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], atol=t, rtol=0,
                                   err_msg=f"{name} {key}")
    # the ego estimate is not the identity: the pose path really ran
    assert np.abs(got["ego_motion_est"][:, 1:, :3, 3]).max() > 1e-2


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_port_data_copies_match_jax(monkeypatch, path):
    """The port's generate_sample -> prep_sample -> collate gives the JAX
    package's batch, both packages on the native voxeliser (their default)
    or both on numpy (PCACC_NATIVE=0)."""
    import pcaccumulation_tpu.data.voxelizer as jvox
    import pcaccumulation_tpu_torch.data.voxelizer as tvox
    from pcaccumulation_tpu_torch.config import load_config as t_load_config
    from pcaccumulation_tpu_torch.data.dataset import prep_sample as t_prep
    from pcaccumulation_tpu_torch.data.loader import collate as t_collate
    from pcaccumulation_tpu_torch.data.synthetic import generate_sample as t_gen

    if path == "numpy":
        monkeypatch.setattr(jvox, "_USE_NATIVE", False)
        monkeypatch.setattr(tvox, "_USE_NATIVE", False)
    assert jvox._USE_NATIVE == tvox._USE_NATIVE == (path == "native")
    for path in (None, "configs/waymo.yaml"):
        assert t_load_config(path) == load_config(path)
    cfg = config("default")
    tcfg = copy.deepcopy(cfg)
    want = make_batch(cfg, seed=3)
    t = cfg["voxel_generator"]["n_sweeps"]
    got = t_collate([
        t_prep(t_gen(seed=3 + i, n_frames=t, n_static_clusters=8, n_dynamic=2,
                     pts_per_cluster=120, pts_per_object=90, area=6.0), tcfg)
        for i in range(2)
    ])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the pillar ids of every sample are sorted: the precondition of K1
    assert (np.diff(got["pillar_of_point"], axis=1) >= 0).all()
