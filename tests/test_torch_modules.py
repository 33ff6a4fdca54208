"""Modules of the PyTorch port against the JAX package's flax modules, with
the weights carried across by `state_dict_from_jax`, plus the port's
independence from JAX and its device rules. Float32 on the CPU; inputs are
seeded numpy arrays handed to both."""

import ast
import copy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu.models import layers as jl
from pcaccumulation_tpu.models.egomotion import EgoMotionHead as JEgo
from pcaccumulation_tpu.models.pillar_encoder import PillarFeatureNet as JPFN
from pcaccumulation_tpu.models.pillar_encoder import pillar_stats as jpillar_stats
from pcaccumulation_tpu.models.stpn import STPN as JSTPN
from pcaccumulation_tpu.models.tpointnet import AlignNet as JAlign
from pcaccumulation_tpu.models.unet import UNet as JUNet
from pcaccumulation_tpu.utils.torch_convert import convert_state_dict
from pcaccumulation_tpu_torch import build_model, to_device
from pcaccumulation_tpu_torch.models import layers as tl
from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_motionnet import config, make_batch, random_variables

REPO = Path(__file__).resolve().parent.parent
T = torch.from_numpy


def _apply(module, variables, *args, train=False, **kw):
    """flax apply, with train-mode batch statistics when train."""
    if train:
        return module.apply(variables, *args, train=True, mutable=["batch_stats"], **kw)[0]
    return module.apply(variables, *args, **kw)


@pytest.fixture(scope="module")
def net():
    """One JAX MotionNet tree (default-path config) and the port loaded from it."""
    cfg = config("default")
    batch = make_batch(cfg)
    params, stats = random_variables(cfg, batch, seed=1)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats))
    return cfg, batch, params, stats, model


def test_layers_match_flax(rng):
    x = rng.normal(size=(40, 12)).astype(np.float32)
    mask = rng.random(40) < 0.6

    m = jl.MLP([16, 8], final_act=True)
    p = m.init(jax.random.key(0), x)["params"]
    tm = tl.mlp(12, [16, 8], final_act=True)
    for i in range(2):
        tm[2 * i].weight.data = T(np.asarray(p[f"fc{i}"]["kernel"]).T.copy())
        tm[2 * i].bias.data = T(np.asarray(p[f"fc{i}"]["bias"]))
    np.testing.assert_allclose(tm(T(x)).detach().numpy(), np.asarray(m.apply({"params": p}, x)),
                               atol=1e-5)

    blk = jl.ResnetBlockFC(5)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.1, blk.init(jax.random.key(1), x)["params"])
    tb = tl.ResnetBlockFC(12, 5)
    for name in ("fc_0", "fc_1", "shortcut"):
        getattr(tb, name).weight.data = T(p[name]["kernel"].T.copy())
        if "bias" in p[name]:
            getattr(tb, name).bias.data = T(p[name]["bias"])
    np.testing.assert_allclose(tb(T(x)).detach().numpy(), np.asarray(blk.apply({"params": p}, x)),
                               atol=1e-5)

    bn = jl.MaskedBatchNorm()
    v = {"params": {"scale": np.linspace(0.5, 1.5, 12, dtype=np.float32),
                    "bias": np.linspace(-1, 1, 12, dtype=np.float32)},
         "batch_stats": {"mean": np.full(12, 0.3, np.float32),
                         "var": np.full(12, 1.7, np.float32)}}
    tbn = tl.MaskedBatchNorm(12)
    tbn.weight.data, tbn.bias.data = T(v["params"]["scale"]), T(v["params"]["bias"])
    tbn.running_mean.copy_(T(v["batch_stats"]["mean"]))
    tbn.running_var.copy_(T(v["batch_stats"]["var"]))
    tbn.eval()
    np.testing.assert_allclose(tbn(T(x), T(mask)).detach().numpy(),
                               np.asarray(bn.apply(v, x, mask=mask)), atol=1e-5)
    tbn.train()
    out, upd = bn.apply(v, x, mask=mask, train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(tbn(T(x), T(mask)).detach().numpy(), np.asarray(out), atol=1e-5)
    # running statistics move as flax's do (momentum 0.9, biased variance)
    np.testing.assert_allclose(tbn.running_mean.numpy(), upd["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), upd["batch_stats"]["var"], atol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
def test_seg_heads_match_flax(net, rng, train):
    cfg, _, params, stats, model = net
    x = rng.normal(size=(3, 16, 16, 32)).astype(np.float32)
    v = {"params": params["ego_feats_head"], "batch_stats": stats["ego_feats_head"]}
    want = _apply(jl.SegHead2D(64), v, x, train=train)
    head = copy.deepcopy(model.ego_feats_head).train(train)  # train BN moves its stats
    with torch.no_grad():
        got = head(T(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)

    rows = rng.normal(size=(50, 128)).astype(np.float32)
    mask = rng.random(50) < 0.7
    v = {"params": params["motionhead"]["mos_seg"],
         "batch_stats": stats["motionhead"]["mos_seg"]}
    want = _apply(jl.SegHead1D(2), v, rows, mask=mask, train=train)
    head = copy.deepcopy(model.motionhead.mos_seg).train(train)
    with torch.no_grad():
        got = head(T(rows), T(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d_level0"])
def test_unet_matches_flax_with_and_without_s2d(net, rng, s2d):
    """The JAX UNet's space-to-depth level 0 computes the same function
    from the same parameters: both forms match the port's plain UNet."""
    cfg, _, params, _, model = net
    x = rng.normal(size=(2, 32, 32, 32)).astype(np.float32)
    want = JUNet(in_channels=32, depth=cfg["unet"]["depth"], start_filts=32,
                 s2d_level0=s2d).apply({"params": params["unet"]}, x)
    with torch.no_grad():
        got = model.unet(T(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_pillar_feature_net_matches_flax(net):
    """PillarFeatureNet, whose local pools are kernel K1's call site."""
    cfg, batch, params, _, model = net
    m = cfg["capacity"]["max_pillars"]
    vg = cfg["voxel_generator"]
    mean, _ = jpillar_stats(batch["points"], batch["fb_labels"], batch["point_valid"],
                            batch["pillar_of_point"], m)
    mean = np.asarray(mean)
    args = (batch["points"], batch["time_idx"], batch["point_valid"],
            batch["pillar_of_point"], batch["pillar_coords"], mean)
    want = JPFN(num_filters=32, depth=cfg["pillar_encoder"]["depth"],
                voxel_size=tuple(vg["voxel_size"]), pc_range=tuple(vg["range"]),
                n_sweeps=vg["n_sweeps"]).apply({"params": params["pillar_encoder"]}, *args, m)
    with torch.no_grad():
        got = model.pillar_encoder(*[T(np.ascontiguousarray(a)) for a in args], m).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_ego_motion_head_deterministic_matches_flax(net, rng):
    """Pose-invariant descriptors (a smooth random function of each
    pillar's world position) make the soft correspondences peaked, as a
    trained feature head makes them: the weighted Kabsch is then well
    posed and recovers the GT motion. With unrelated random descriptors
    the correspondences carry ~1e-20 mass, and both frameworks' float32
    poses lie ~1e-3 from a float64 run: a test of rounding, not of the
    port."""
    cfg, batch, params, _, model = net
    m = cfg["capacity"]["max_pillars"]
    pe = cfg["pose_estimation"]
    t = cfg["voxel_generator"]["n_sweeps"]
    w = cfg["voxel_generator"]["grid_size"][0]
    mean, _ = jpillar_stats(batch["points"], batch["fb_labels"], batch["point_valid"],
                            batch["pillar_of_point"], m)
    mean = np.asarray(mean)
    coords = batch["pillar_coords"]
    pose = batch["ego_motion_gt"][np.arange(mean.shape[0])[:, None], coords[..., 0]]
    world = np.einsum("bmij,bmj->bmi", pose[..., :3, :3], mean) + pose[..., :3, 3]
    freq = rng.normal(size=(2, 64))  # ~1 rad per metre
    feats = np.cos(world[..., :2] @ freq + 2 * np.pi * rng.random(64)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    bg = rng.random(coords.shape[:2]) < 0.9
    scan_key = coords[..., 1] * w + coords[..., 2]
    head = JEgo(n_kpts=pe["n_kpts"], sinkhorn_iter=pe["sinkhorn_iter"], slack=pe["add_slack"],
                n_sweeps=t, freq=cfg["data"]["freq"], max_speed=cfg["data"]["max_speed"],
                seq_pose="skip", deterministic_sampling=True)
    want = head.apply({"params": params["ego_motion_head"]}, feats, mean, coords[..., 0],
                      batch["pillar_valid"], bg, batch["points"], batch["time_idx"],
                      batch["point_valid"], batch["ego_motion_gt"], pillar_scan_key=scan_key)
    with torch.no_grad():
        got = model.ego_motion_head(T(feats), T(mean), T(coords[..., 0].copy()),
                                    T(batch["pillar_valid"]), T(bg),
                                    T(batch["ego_motion_gt"]), T(scan_key))
    # float32 on both sides: Sinkhorn and the 3x3 SVD round differently
    for key in ("ego_motion_est", "perm_matrix", "ego_motion_gt", "ego_l1_loss",
                "ego_l2_loss", "ego_trans_error"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   err_msg=key)
    # degrees, an arccos near 1, which amplifies the rounding of the trace
    np.testing.assert_allclose(got["ego_rot_error"].numpy(), np.asarray(want["ego_rot_error"]),
                               atol=3e-3)
    # the estimate is the motion (1-5 m here), not an identity: within 10 cm
    est, gt = got["ego_motion_est"].numpy(), got["ego_motion_gt"].numpy()
    assert np.abs(gt[:, 1:, :3, 3]).max() > 1.0
    np.testing.assert_allclose(est[..., :3, 3], gt[..., :3, 3], atol=0.1)


@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
def test_stpn_matches_flax(net, rng, train):
    cfg, _, params, stats, model = net
    t = cfg["voxel_generator"]["n_sweeps"]
    x = rng.normal(size=(2, 32, 32, t * 32)).astype(np.float32)
    pts = ((rng.random((2, 100, 3)) - 0.5) * 14).astype(np.float32)
    mask = rng.random((2, 100)) < 0.8
    v = {"params": params["motionhead"], "batch_stats": stats["motionhead"]}
    want = _apply(JSTPN(feat_dim=32, n_frames=t), v, x, pts, mask, -8.0, train=train)
    with torch.no_grad():
        got = copy.deepcopy(model.motionhead).train(train)(T(x), T(pts), T(mask), -8.0)
    for g, w_, name in zip(got, want, ("classes", "offset", "mos_map")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-4, err_msg=name)


@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
def test_alignnet_matches_flax(net, rng, train):
    cfg, batch, params, stats, model = net
    b, n = batch["points"].shape[:2]
    t = cfg["voxel_generator"]["n_sweeps"]
    rec_mask = (batch["fb_labels"] == 1) & batch["point_valid"]
    bb = rng.normal(size=(b, n, 32)).astype(np.float32)
    mos = rng.normal(size=(b, n, 64)).astype(np.float32)
    ego_est = batch["ego_motion_gt"].copy()
    ego_est[:, 1:, :3, 3] += 0.05
    args = (batch["points"], batch["time_idx"], batch["inst_labels"], rec_mask,
            batch["sd_labels"], bb, mos, batch["inst_motion_gt"], batch["ego_motion_gt"],
            ego_est)
    v = {"params": params["reconstructor"], "batch_stats": stats["reconstructor"]}
    want = _apply(JAlign(n_frames=t, n_iterations=cfg["tpointnet"]["n_iterations"],
                         min_points_per_frame=cfg["tpointnet"]["min_points"]),
                  v, *args, train=train)
    with torch.no_grad():
        got = copy.deepcopy(model.reconstructor).train(train)(
            *[T(np.ascontiguousarray(a)) for a in args])
    # train BN: the regressor's batch statistics cover 20 rows (4 instances
    # x 5 frames), and both frameworks' float32 poses (translations up to
    # ~8 m) lie 3-4e-4 from a float64 run of the port
    tol = 1e-3 if train else 2e-4
    for key in ("inst_pose_est", "sub_rec_est", "inst_l2_error"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=tol,
                                   err_msg=key)
    for it, terms in want["tpointnet_loss_terms"].items():
        for key, val in terms.items():
            np.testing.assert_allclose(got["tpointnet_loss_terms"][it][key].numpy(),
                                       np.asarray(val), atol=tol, err_msg=f"{it} {key}")


def test_weights_round_trip_bit_exact(net):
    """JAX trees -> state_dict_from_jax -> the port's state_dict ->
    torch_convert.convert_state_dict gives the JAX trees back bit for bit."""
    cfg, _, params, stats, model = net
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    p2, s2 = convert_state_dict(sd, pillar_depth=cfg["pillar_encoder"]["depth"],
                                unet_depth=cfg["unet"]["depth"])
    for tree, back in ((params, p2), (stats, s2)):
        flat, treedef = jax.tree_util.tree_flatten(tree)
        flat2, treedef2 = jax.tree_util.tree_flatten(back)
        assert treedef == treedef2
        for a, b in zip(flat, flat2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _port_files():
    return sorted((REPO / "pcaccumulation_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No file of the port (parallel/ included), and not chip_smoke.py,
    imports jax, flax, optax, orbax, tensorstore, zstandard or the JAX
    package; nor does reading the tracked JAX orbax checkpoint
    (tests/data/jax_orbax_tiny) through `read_checkpoint`."""
    banned = {"jax", "flax", "optax", "orbax", "tensorstore", "zstandard", "pcaccumulation_tpu"}
    found = []
    files = _port_files()
    assert REPO / "pcaccumulation_tpu_torch" / "parallel" / "mesh.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [(path.name, n) for n in names if n.split(".")[0] in banned]
    assert not found, found
    code = ("import sys, pcaccumulation_tpu_torch, pcaccumulation_tpu_torch.utils.weights, "
            "pcaccumulation_tpu_torch.kernels.build, pcaccumulation_tpu_torch.data.dataset, "
            "pcaccumulation_tpu_torch.data.loader, pcaccumulation_tpu_torch.config, "
            "pcaccumulation_tpu_torch.train.trainer, pcaccumulation_tpu_torch.main, "
            "pcaccumulation_tpu_torch.profile_forward, pcaccumulation_tpu_torch.ops.icp, "
            "pcaccumulation_tpu_torch.ops.cluster, pcaccumulation_tpu_torch.kernels.chamfer, "
            "pcaccumulation_tpu_torch.train.tester, pcaccumulation_tpu_torch.evaluation, "
            "pcaccumulation_tpu_torch.serve, pcaccumulation_tpu_torch.track, "
            "pcaccumulation_tpu_torch.utils.checkpoint, pcaccumulation_tpu_torch.data.ground, "
            "pcaccumulation_tpu_torch.train.sf_metrics, pcaccumulation_tpu_torch.parallel.mesh, "
            "pcaccumulation_tpu_torch.native.host, pcaccumulation_tpu_torch.utils.orbax_read; "
            "s = pcaccumulation_tpu_torch.utils.checkpoint.read_checkpoint("
            "'tests/data/jax_orbax_tiny/model_latest.ckpt'); "
            "assert s['optimizer']['count'] == 2 and s['optimizer']['mini_step'] == 1; "
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'tensorstore', 'zstandard', "
            "'pcaccumulation_tpu')], sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """build_model / to_device, the Tester and the test CLI without a device
    want CUDA and raise on a CPU-only host; with device='cpu' they run."""
    from pcaccumulation_tpu_torch.main import main
    from pcaccumulation_tpu_torch.train.tester import Tester

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config("parity")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_device({"x": np.zeros(3)})
    model = build_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert to_device({"x": np.zeros(3)}, "cpu")["x"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tester(cfg, model, save_dir=str(tmp_path))
    assert Tester(cfg, model, save_dir=str(tmp_path), device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="mode"):
        model(to_device(make_batch(cfg, batch_size=1), "cpu"), mode="predict")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["main", str(REPO / "configs" / "synthetic.yaml"), "1", "1", "--misc.mode=test"])


def test_draw_keypoints_marginal_is_uniform():
    """The port's random keypoint draw never takes a masked pillar and its
    marginal over the valid ones is uniform: the chi-square of
    tests/test_model.py at its sizes (600 pillars, 400 valid, 64 drawn,
    800 seeded generators)."""
    from pcaccumulation_tpu_torch.models.egomotion import draw_keypoints

    m, n_valid, n_draw, n_seeds = 600, 400, 64, 800
    mask = torch.zeros((1, 1, m), dtype=torch.bool)
    mask[..., :n_valid] = True
    counts = torch.zeros(m, dtype=torch.int64)
    for s in range(n_seeds):
        idx = draw_keypoints(mask, n_draw, deterministic=False,
                             generator=torch.Generator().manual_seed(s))
        assert idx.unique().numel() == n_draw  # without replacement
        counts += torch.bincount(idx.reshape(-1), minlength=m)
    assert int(counts[n_valid:].sum()) == 0  # never draws masked rows
    expected = n_seeds * n_draw / n_valid
    chi2 = float(((counts[:n_valid].double() - expected) ** 2 / expected).sum())
    # chi2 ~ ChiSq(n_valid - 1): mean 399, std ~28; 6 sigma ~ [230, 570]
    assert 230 < chi2 < 570, chi2
