"""The PyTorch port in bfloat16 (`precision.compute_dtype: bfloat16`, the
val and test forward) against the JAX package in bfloat16, on the CPU.

- Kernels: the plain versions of K1 and K2 on bf16 inputs against the JAX
  package's Pallas kernels in interpret mode (`_seg_pool_impl`,
  `_row_shift_blocks_pallas`), at tile edges: the CUDA kernels are held
  against these plain versions on the card (tests/test_torch_kernels.py,
  chip_smoke.py). The JAX package's CPU forward goes through its XLA
  fallbacks instead (`ops/segment.py`, `ops/bilinear.py::_row_shift_blocks_xla`,
  which rounds f to bf16 first), so the kernels are held against the
  Pallas kernels, and the composed forward by decisions.
- Modules: each ported module built with `compute_dtype=torch.bfloat16`
  against its flax module with `dtype=jnp.bfloat16`, on the same weights.
- The composed val and test forward: the port in bf16 against the JAX
  package in bf16 and against the port in float32, by the criteria of
  tests/test_precision.py.
bf16 training (the kernels' bf16 gradients, the train-mode BatchNorm
forms, the composed train step, the Trainer, the CLI) is held in
tests/test_torch_train_bf16.py.

bf16 values cross between the frameworks as float32 arrays (exact).
"""

import os

import flax.linen as fnn
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
from pcaccumulation_tpu.kernels.segscan import _seg_pool_impl
from pcaccumulation_tpu.models import MotionNet as JaxMotionNet
from pcaccumulation_tpu.models import layers as jl
from pcaccumulation_tpu.models.pillar_encoder import PillarFeatureNet as JPFN
from pcaccumulation_tpu.models.pillar_encoder import pillar_stats as jpillar_stats
from pcaccumulation_tpu.models.stpn import STPN as JSTPN
from pcaccumulation_tpu.models.tpointnet import AlignNet as JAlign
from pcaccumulation_tpu.models.unet import UNet as JUNet
from pcaccumulation_tpu.ops.bilinear import _row_shift_blocks_pallas
from pcaccumulation_tpu_torch import build_model, to_device
from pcaccumulation_tpu_torch.kernels.row_shift import row_shift_blocks, row_shift_blocks_plain
from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_plain
from pcaccumulation_tpu_torch.models import layers as tl
from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_motionnet import place_fb_threshold, random_variables

BF16 = torch.bfloat16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def to_np(x) -> np.ndarray:
    """A JAX or torch array as float32 numpy (bf16 widens exactly)."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_pair(x: np.ndarray):
    """x rounded to bf16, as a JAX array and a torch tensor with the same bits."""
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, T(to_np(xj)).to(BF16)


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at |a|."""
    a = np.maximum(np.abs(a.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


# ---------------------------------------------------------------- kernels

def k1_case(name: str, rng):
    """(ids, c, rblk) at a tile edge of the JAX kernel (rblk rows) and of
    the CUDA kernel (256 rows): a run over several blocks, runs ending on
    block boundaries, N not a multiple of the block, narrow channels; and
    the edges of the CUDA bf16 path at C=32: runs of exactly one tile (a
    tile that is one run and passes nothing on), and a padded tail of 9
    tiles and 3 rows after short runs (a run over more tiles than the
    fix-up sums in one warp, ending 3 rows into the last tile)."""
    if name == "long_run":
        ids = np.sort(rng.integers(0, 500, 1500))
        ids[200:900] = ids[200]
        return np.sort(ids).astype(np.int32), 32, 128
    if name == "block_edges":
        lengths = [256, 256, 5, 251, 257, 255, 3, 128, 129, 7]
        return np.repeat(np.arange(len(lengths)) * 3, lengths).astype(np.int32), 32, 128
    if name == "one_tile_runs":
        lengths = [256, 256, 3, 253, 256, 519, 1]
        return np.repeat(np.arange(len(lengths)) * 3, lengths).astype(np.int32), 32, 256
    if name == "padded_tail":
        body = np.sort(rng.integers(0, 60, 200))
        ids = np.concatenate([body, np.full(9 * 256 + 3, body[-1] + 7)])
        return ids.astype(np.int32), 32, 256
    return np.sort(rng.integers(0, 300, 777)).astype(np.int32), 9, 256  # ragged, C=9


K1_CASES = ["long_run", "block_edges", "ragged_c9", "one_tile_runs", "padded_tail"]


@pytest.mark.parametrize("case", K1_CASES)
@pytest.mark.parametrize("op", ["max", "sum"])
def test_k1_bf16_plain_matches_pallas(case, op):
    """K1's plain version on bf16 rows against the Pallas kernel in
    interpret mode on the same bits. Max: bit-equal. Sum of non-negative
    rows: within 1 bf16 ulp of the result, since both reduce in float32 and
    round once at the end, except that the Pallas kernel rounds its forward
    prefix to bf16 before the reverse pass (its `pre` output has x's dtype),
    half an ulp of a prefix no larger than the total. Sum of signed rows:
    within 1 bf16 ulp of the segment's sum of |x|, which bounds that prefix."""
    rng = np.random.default_rng(3)
    ids, c, rblk = k1_case(case, rng)
    signs = ("signed", "non_negative") if op == "sum" else ("signed",)
    for kind in signs:
        x = rng.standard_normal((ids.size, c)).astype(np.float32)
        if kind == "non_negative":
            x = np.abs(x)
        xj, xt = bf16_pair(x)
        want = _seg_pool_impl(xj, jnp.asarray(ids), op=op, rblk=rblk, interpret=True)
        got = seg_pool(xt, T(ids), op)
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        got, want = to_np(got), to_np(want)
        if op == "max":
            np.testing.assert_array_equal(got, want)
            continue
        scale = np.abs(want) if kind == "non_negative" else to_np(
            seg_pool_plain(T(np.abs(to_np(xt))), T(ids), "sum"))
        err = np.abs(got - want)
        assert (err <= bf16_ulp(np.maximum(scale, np.abs(got)))).all(), (kind, err.max())


@pytest.mark.parametrize("nb,c", [(5, 32), (11, 32), (5, 9)])
def test_k2_bf16_plain_matches_pallas(nb, c):
    """K2's plain version on a bf16 canvas against the Pallas kernel in
    interpret mode: both lerp in float32 at a float32 f and round once at
    the store; within 1 bf16 ulp (the two sum the taps' products in their
    own float32 order). Shifts beyond the row, negative and fractional."""
    rng = np.random.default_rng(nb * 100 + c)
    r, w = 24, 40
    xj, xt = bf16_pair(rng.normal(size=(r, w, nb * c)).astype(np.float32))
    shifts = ((rng.random((r, nb)) - 0.5) * 2.5 * w).astype(np.float32)
    shifts[:, 0] = 0.0
    k = np.floor(shifts)
    f = (shifts - k).astype(np.float32)
    ki = np.clip(k.astype(np.int32), -w, w)
    want = to_np(_row_shift_blocks_pallas(xj, jnp.asarray(ki), jnp.asarray(f), nb,
                                          interpret=True))
    got = row_shift_blocks(xt, T(shifts), nb)
    assert got.dtype == BF16
    got = to_np(got)
    assert (np.abs(got - want) <= bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()
    # the float32 plain version rounded once: the bf16 plain version
    want32 = row_shift_blocks_plain(xt.float(), T(ki), T(f), nb)
    np.testing.assert_array_equal(got, to_np(want32.to(BF16)))
    np.testing.assert_array_equal(got[..., :c], to_np(xt)[..., :c])  # zero shift


# ------------------------------------------------------------ the model

def precision_config(compute_dtype: str, icp: bool = False, n_kpts: int = 128,
                     sinkhorn_iter: int = 2) -> dict:
    """tests/test_precision.py's config with deterministic keypoints (both
    packages draw the same ones); with `icp`, the test path's ICPs on at 3
    iterations."""
    cfg = load_config()
    cfg["voxel_generator"].update(
        {"range": [-8, -8, -5, 8, 8, 3], "voxel_size": [0.25, 0.25, 8],
         "n_sweeps": 3, "crop_range": [8, -5, 3]})
    cfg["capacity"] = {"max_points": 6000, "max_pillars": 4000,
                       "max_instances": 8, "max_fg_points": 1024}
    cfg["data"].update({"n_frames": 3, "freq": 10.0, "max_speed": 20})
    cfg["pose_estimation"].update({"n_kpts": n_kpts, "sinkhorn_iter": sinkhorn_iter,
                                   "deterministic_sampling": True, "approx_sampling": False,
                                   "icp": icp, "icp_max_iter": 3})
    cfg["tpointnet"].update({"n_iterations": 1, "min_points": 5, "icp": icp,
                             "icp_max_iter": 3, "icp_max_points": 256})
    cfg["unet"]["depth"] = 3
    cfg["pillar_encoder"]["depth"] = 2
    cfg["cluster"]["bfs_iters"] = 8
    cfg["precision"] = {"compute_dtype": compute_dtype}
    return derive(cfg)


@pytest.fixture(scope="module")
def net():
    """One seeded JAX parameter tree (the FB threshold in a wide gap of the
    float32 port's pillar margins), test_precision's batch, and the port
    in bf16 and in float32 loaded from it."""
    cfg32, cfg16 = precision_config("float32"), precision_config("bfloat16")
    batch = collate([prep_sample(
        generate_sample(seed=42, n_frames=3, freq=10.0, n_static_clusters=8, n_dynamic=2,
                        pts_per_cluster=150, pts_per_object=90, area=6.0), cfg32)])
    params, stats = random_variables(cfg32, batch, seed=0)
    params = place_fb_threshold(cfg32, params, stats, batch, False)
    models = {}
    for name, cfg in (("f32", cfg32), ("bf16", cfg16)):
        models[name] = build_model(cfg, device="cpu")
        models[name].load_state_dict(state_dict_from_jax(params, stats))
    return cfg16, batch, params, stats, models


def flax_bf16(module_cls, *args, **kw):
    return module_cls(*args, dtype=jnp.bfloat16, **kw)


def assert_bf16_close(got: torch.Tensor, want, ulps: float, what: str, want32=None):
    """got (the port) and want (flax) both bf16, within `ulps` bf16 ulps of
    the output's largest magnitude; and, where want32 (the flax module in
    float32) is given, the port's mean distance to flax in bf16 at most half
    the bf16-vs-float32 drift: the casts land where flax's land (a path
    left in float32, or a cast moved across a reduction, sits at the drift)."""
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16, (what, got.dtype, want.dtype)
    g, w = to_np(got), to_np(want)
    err = float(np.abs(g - w).max())
    tol = ulps * float(bf16_ulp(np.abs(w).max()))
    assert err <= tol, (what, err, tol)
    if want32 is not None:
        drift = float(np.abs(np.asarray(want32, np.float32) - w).mean())
        assert 0 < drift and float(np.abs(g - w).mean()) <= 0.5 * drift, (what, drift)


def test_layers_bf16_match_flax():
    """MLP, ResnetBlockFC, the BatchNorm of SegHead2D (flax BatchNorm with
    dtype: float32 statistics, one rounding) and SegHead2D, in bf16 against
    flax with dtype=bfloat16, on the same weights and input bits. The
    BatchNorm is bit-equal; the others within 2 bf16 ulps of the output's
    scale (a product that sums in another float32 order may round one ulp
    away, and the next layer carries it; measured: equal)."""
    rng = np.random.default_rng(0)
    xj, xt = bf16_pair(rng.normal(size=(40, 12)).astype(np.float32))

    m = flax_bf16(jl.MLP, [16, 8], final_act=True)
    p = jax.tree.map(np.asarray, m.init(jax.random.key(0), xj)["params"])
    tm = tl.mlp(12, [16, 8], final_act=True, compute_dtype=BF16)
    for i in range(2):
        tm[2 * i].weight.data = T(p[f"fc{i}"]["kernel"].T)
        tm[2 * i].bias.data = T(p[f"fc{i}"]["bias"] + 0.1)
        p[f"fc{i}"]["bias"] = p[f"fc{i}"]["bias"] + 0.1
    assert_bf16_close(tm(xt), m.apply({"params": p}, xj), 2, "mlp",
                      jl.MLP([16, 8], final_act=True).apply({"params": p}, to_np(xj)))

    blk = flax_bf16(jl.ResnetBlockFC, 5)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.1, blk.init(jax.random.key(1), xj)["params"])
    tb = tl.ResnetBlockFC(12, 5, compute_dtype=BF16)
    for name in ("fc_0", "fc_1", "shortcut"):
        getattr(tb, name).weight.data = T(p[name]["kernel"].T)
        if "bias" in p[name]:
            getattr(tb, name).bias.data = T(p[name]["bias"])
    assert_bf16_close(tb(xt), blk.apply({"params": p}, xj), 2, "resnet_block",
                      jl.ResnetBlockFC(5).apply({"params": p}, to_np(xj)))

    mj, mt = bf16_pair(rng.normal(size=(2, 9, 9, 12)).astype(np.float32))
    bn = fnn.BatchNorm(use_running_average=True, dtype=jnp.bfloat16)
    v = {"params": {"scale": np.linspace(0.5, 1.5, 12, dtype=np.float32),
                    "bias": np.linspace(-1, 1, 12, dtype=np.float32)},
         "batch_stats": {"mean": np.linspace(-0.3, 0.3, 12, dtype=np.float32),
                         "var": np.linspace(0.5, 1.7, 12, dtype=np.float32)}}
    tbn = tl.MaskedBatchNorm(12, compute_dtype=BF16).eval()
    tbn.weight.data, tbn.bias.data = T(v["params"]["scale"]), T(v["params"]["bias"])
    tbn.running_mean.copy_(T(v["batch_stats"]["mean"]))
    tbn.running_var.copy_(T(v["batch_stats"]["var"]))
    got = tbn(mt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # float32 statistics and normalisation, one rounding: bit-equal
    np.testing.assert_array_equal(to_np(got), to_np(bn.apply(v, mj)))

    for keep in (False, True):
        head = jl.SegHead2D(64, dtype=jnp.bfloat16, keep_compute_dtype=keep)
        x32 = rng.normal(size=(2, 12, 12, 32)).astype(np.float32)
        hv = jax.tree.map(np.asarray, head.init(jax.random.key(2), x32))
        hv["params"]["bn"]["bias"] = np.full(64, 0.05, np.float32)
        th = tl.SegHead2D(32, 64, compute_dtype=BF16, keep_compute_dtype=keep).eval()
        sd = {"seg_head.0.weight": T(hv["params"]["conv0"]["kernel"].transpose(3, 2, 0, 1)),
              "seg_head.0.bias": T(hv["params"]["conv0"]["bias"]),
              "seg_head.1.weight": T(hv["params"]["bn"]["scale"]),
              "seg_head.1.bias": T(hv["params"]["bn"]["bias"]),
              "seg_head.1.running_mean": T(hv["batch_stats"]["bn"]["mean"]),
              "seg_head.1.running_var": T(hv["batch_stats"]["bn"]["var"]),
              "seg_head.3.weight": T(hv["params"]["conv1"]["kernel"].transpose(3, 2, 0, 1)),
              "seg_head.3.bias": T(hv["params"]["conv1"]["bias"])}
        th.load_state_dict(sd, strict=False)
        with torch.no_grad():
            got = th(T(x32))
        want = head.apply(hv, x32)
        if keep:
            assert_bf16_close(got, want, 2, "seg_head_2d")
        else:  # cast back to the input's float32
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2 * float(bf16_ulp(np.abs(want).max())))


def test_unet_bf16_matches_flax(net):
    """The UNet with keep_compute_dtype, bf16 in and out, against the flax
    UNet in bf16: three levels of convolutions whose float32 sums round to
    bf16 at every layer, in each framework's own order, so an ulp here and
    there moves through the layers; within 8 bf16 ulps of the output's
    scale, and at a quarter of the bf16 drift on average (measured). With
    the s2d level 0 (the same function, other sums) within 8 ulps."""
    cfg, _, params, _, models = net
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 32)).astype(np.float32)
    got = models["bf16"].unet(T(x))
    want32 = JUNet(in_channels=32, depth=3, start_filts=32).apply({"params": params["unet"]}, x)
    for s2d in (False, True):
        want = JUNet(in_channels=32, depth=3, start_filts=32, dtype=jnp.bfloat16,
                     keep_compute_dtype=True, s2d_level0=s2d).apply({"params": params["unet"]}, x)
        assert_bf16_close(got, want, 8, f"unet s2d={s2d}", None if s2d else want32)


def test_pillar_feature_net_bf16_matches_flax(net):
    """PillarFeatureNet in bf16 (features built in float32, the MLP stack
    and K1's pools in bf16) against flax in bf16; within 2 bf16 ulps of the
    output's scale (measured: all but 0.01 % of the outputs equal)."""
    cfg, batch, params, _, models = net
    m = cfg["capacity"]["max_pillars"]
    vg = cfg["voxel_generator"]
    mean = np.asarray(jpillar_stats(batch["points"], batch["fb_labels"], batch["point_valid"],
                                    batch["pillar_of_point"], m)[0])
    args = (batch["points"], batch["time_idx"], batch["point_valid"],
            batch["pillar_of_point"], batch["pillar_coords"], mean)
    kw = dict(num_filters=32, depth=cfg["pillar_encoder"]["depth"],
              voxel_size=tuple(vg["voxel_size"]), pc_range=tuple(vg["range"]),
              n_sweeps=vg["n_sweeps"])
    v = {"params": params["pillar_encoder"]}
    want = JPFN(**kw, dtype=jnp.bfloat16).apply(v, *args, m)
    with torch.no_grad():
        got = models["bf16"].pillar_encoder(*[T(a) for a in args], m)
    assert_bf16_close(got, want, 2, "pillar_feature_net", JPFN(**kw).apply(v, *args, m))


@pytest.mark.parametrize("threads", [1, 4])
def test_conv3d_bf16_gradient_on_the_cpu(threads):
    """The STPN's bf16 Conv3d on the CPU ([2, 32, 3, 64, 64], as the STPN
    sees a small canvas), in one and in four threads: its gradients are
    finite, the same bits in two calls, and within bf16's rounding (rel-norm
    < 2e-2) of the float32 convolution's. oneDNN's bf16 Conv3d weight
    gradient was NaN here in one thread and varied between calls in
    several (ROADMAP item 32); the port takes float32 products of the bf16
    values, rounded once."""
    gen = torch.Generator().manual_seed(0)
    conv = tl.Conv3d(32, 32, 3, padding=1, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.05)
        conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen) * 0.05)
    x = torch.randn(2, 32, 3, 64, 64, generator=gen).bfloat16().float().requires_grad_()
    g_out = torch.randn(2, 32, 3, 64, 64, generator=gen)

    def grads(compute_dtype):
        conv.compute_dtype = compute_dtype
        conv.zero_grad()
        x.grad = None
        conv(x).float().backward(g_out)
        return [t.grad.clone() for t in (x, conv.weight, conv.bias)]

    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got, again = grads(torch.bfloat16), grads(torch.bfloat16)
        want = grads(None)
    finally:
        torch.set_num_threads(before)
    for g, a, w, name in zip(got, again, want, ("input", "weight", "bias")):
        assert bool(torch.isfinite(g).all()), name
        assert torch.equal(g, a), name
        assert float((g - w).norm() / w.norm()) < 2e-2, name


def test_stpn_bf16_matches_flax(net):
    """The STPN on a bf16 canvas: the temporal convolutions and its UNet in
    bf16, the MOS map returned in bf16, the per-point decoding in float32.
    Map within 8 bf16 ulps of its scale (as the UNet); classes and offsets
    (float32) within 2e-2, where the bf16 drift is larger."""
    cfg, _, params, stats, models = net
    t = cfg["voxel_generator"]["n_sweeps"]
    rng = np.random.default_rng(2)
    xj, xt = bf16_pair(rng.normal(size=(1, 32, 32, t * 32)).astype(np.float32))
    pts = ((rng.random((1, 80, 3)) - 0.5) * 14).astype(np.float32)
    mask = rng.random((1, 80)) < 0.8
    v = {"params": params["motionhead"], "batch_stats": stats["motionhead"]}
    want = JSTPN(feat_dim=32, n_frames=t, dtype=jnp.bfloat16).apply(v, xj, pts, mask, -8.0)
    with torch.no_grad():
        got = models["bf16"].motionhead(xt, T(pts), T(mask), -8.0)
        # the float32 module (the port's, held to flax's in test_torch_modules.py)
        want32 = [a.numpy() for a in models["f32"].motionhead(xt.float(), T(pts), T(mask), -8.0)]
    assert_bf16_close(got[2], want[2], 8, "stpn mos_map", want32[2])
    for g, w_, w32, name in zip(got[:2], want[:2], want32[:2], ("classes", "offset")):
        assert g.dtype == torch.float32
        err = np.abs(g.numpy() - np.asarray(w_)).max()
        assert err < 2e-2 and err < np.abs(np.asarray(w32) - np.asarray(w_)).max(), (name, err)


def test_alignnet_bf16_matches_flax(net):
    """AlignNet with bf16 embedding MLPs and pools, the regressor and the
    poses float32, against flax in bf16; within 2e-3 (the pooled bf16
    embeddings enter a float32 regressor, whose output is a pose) and
    closer to it than the float32 module is."""
    cfg, batch, params, stats, models = net
    b, n = batch["points"].shape[:2]
    t = cfg["voxel_generator"]["n_sweeps"]
    rng = np.random.default_rng(4)
    rec_mask = (batch["fb_labels"] == 1) & batch["point_valid"]
    bb = rng.normal(size=(b, n, 32)).astype(np.float32)
    mos = rng.normal(size=(b, n, 64)).astype(np.float32)
    ego_est = batch["ego_motion_gt"].copy()
    ego_est[:, 1:, :3, 3] += 0.05
    args = (batch["points"], batch["time_idx"], batch["inst_labels"], rec_mask,
            batch["sd_labels"], bb, mos, batch["inst_motion_gt"], batch["ego_motion_gt"],
            ego_est)
    v = {"params": params["reconstructor"], "batch_stats": stats["reconstructor"]}
    kw = dict(n_frames=t, n_iterations=cfg["tpointnet"]["n_iterations"],
              min_points_per_frame=cfg["tpointnet"]["min_points"])
    want = JAlign(**kw, dtype=jnp.bfloat16).apply(v, *args)
    with torch.no_grad():
        got = models["bf16"].reconstructor(*[T(a) for a in args])
        want32 = models["f32"].reconstructor(*[T(a) for a in args])
    for key in ("inst_pose_est", "sub_rec_est"):
        err = np.abs(got[key].numpy() - np.asarray(want[key])).max()
        drift = np.abs(want32[key].numpy() - np.asarray(want[key])).max()
        assert err < 2e-3 and err < drift, (key, err, drift)


def run_all(cfgs, params, stats, batch, mode):
    """The JAX MotionNet and the port at each config of cfgs ({"bf16": ...,
    "f32": ...}), eval BN; test mode with the GT instance labels injected."""
    override = batch["inst_labels"] if mode == "test" else None
    res = {}
    for name, cfg in cfgs.items():
        model = JaxMotionNet(cfg)
        out = jax.jit(lambda p, s, b, o: model.apply(
            {"params": p, "batch_stats": s}, b, train=False, mode=mode,
            inst_labels_override=o))(params, stats, jax.tree.map(jnp.asarray, batch), override)
        res[f"jax_{name}"] = {k: np.asarray(v) for k, v in out.items() if not isinstance(v, dict)}
        port = build_model(cfg, device="cpu")
        port.load_state_dict(state_dict_from_jax(params, stats))
        with torch.no_grad():
            got = port(to_device(batch, "cpu"), mode=mode,
                       inst_labels_override=None if override is None else T(override))
        res[name] = {k: v.numpy() for k, v in got.items() if torch.is_tensor(v)}
    return res


@pytest.mark.parametrize("mode", ["val", "test"])
def test_composed_bf16_forward_matches_jax_and_f32(mode, record_property):
    """The bf16 val and test forward (test: both ICPs at 3 iterations, GT
    labels injected) against the JAX package's bf16 forward and against the
    port's float32 forward, by tests/test_precision.py's criteria: FB
    decisions >= 99.9 % equal, MOS >= 99.5 %, ego poses within 5e-2,
    rec_est within 0.05, and the FB logits differ from float32 at bf16
    noise but not by zero. test_precision's weights (flax's init, key 0),
    with the FB threshold moved into a wide gap of the pillar margins so
    that both classes occur. With deterministic keypoints the ego head
    needs 2,048 of them and 5 Sinkhorn iterations to be well posed: at
    test_precision's 128 and 2 the JAX package's own bf16-vs-float32
    rec_est drift is 0.085 on this batch (measured), beyond the criterion;
    at 2,048 and 5 it is 0.013. In test mode the instance ICP starts from
    the random TPointNet's poses and moves a few small slices far on a
    bf16-sized nudge: there the JAX package's own bf16-vs-float32 rec_est
    drift (0.083, measured) is the bound of the port's (the port in bf16
    lies 4e-6 from the JAX package in bf16 there, measured)."""
    cfgs = {name: precision_config(d, icp=mode == "test", n_kpts=2048, sinkhorn_iter=5)
            for name, d in (("bf16", "bfloat16"), ("f32", "float32"))}
    batch = collate([prep_sample(
        generate_sample(seed=42, n_frames=3, freq=10.0, n_static_clusters=8, n_dynamic=2,
                        pts_per_cluster=150, pts_per_object=90, area=6.0), cfgs["f32"])])
    model = JaxMotionNet(cfgs["f32"])
    variables = jax.jit(lambda rngs, b: model.init(rngs, b, train=False, mode="val"))(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jax.tree.map(jnp.asarray, batch))
    params, stats = (jax.tree.map(np.asarray, variables[k]) for k in ("params", "batch_stats"))
    params = place_fb_threshold(cfgs["f32"], params, stats, batch, False)
    res = run_all(cfgs, params, stats, batch, mode)
    valid = batch["point_valid"][0]

    def rec_drift(a, b):
        return np.abs(a["rec_est"][0][valid] - b["rec_est"][0][valid]).max()

    p16 = res["bf16"]
    jax_drift = rec_drift(res["jax_bf16"], res["jax_f32"])
    record_property("jax_bf16_vs_f32.rec", float(jax_drift))
    for ref in ("jax_bf16", "f32"):
        r = res[ref]
        fb = (p16["fb_est_per_points"][0][valid] == r["fb_est_per_points"][0][valid]).mean()
        mos = (np.argmax(p16["mos_est"][0][valid], -1)
               == np.argmax(r["mos_est"][0][valid], -1)).mean()
        ego = np.abs(p16["ego_motion_est"] - r["ego_motion_est"]).max()
        rec = rec_drift(p16, r)
        logits = np.abs(p16["fb_seg_est"] - r["fb_seg_est"]).max()
        for key, val in (("fb_equal", fb), ("mos_equal", mos), ("ego", ego), ("rec", rec),
                         ("fb_logits", logits)):
            record_property(f"{ref}.{key}", float(val))
        assert fb >= 0.999 and mos >= 0.995, (ref, fb, mos)
        assert ego < 5e-2 and logits < 0.15, (ref, ego, logits)
        rec_tol = 0.05 if ref == "jax_bf16" or mode == "val" else max(0.05, jax_drift + 1e-3)
        assert rec < rec_tol, (ref, rec, rec_tol)
    fg = p16["fb_est_per_points"][0][valid].mean()
    assert 0.0 < fg < 1.0, fg  # both FB classes occur
    # bf16 really ran: the logits differ from the float32 port's
    assert np.abs(p16["fb_seg_est"] - res["f32"]["fb_seg_est"]).max() > 0
    # the pose path ran: frames 1.. are not the identity
    assert np.abs(p16["ego_motion_est"][:, 1:, :3, 3]).max() > 1e-2


def test_cli_nuscene_bf16_test_mode_on_cpu(tmp_path, monkeypatch):
    """python -m pcaccumulation_tpu_torch.main configs/nuscene.yaml 1 1
    --misc.mode=test --train.ckpt_backend=pickle runs in bf16 (the preset's
    compute dtype) and dumps the test scene; cut for the CPU to a 16x16 m
    grid, 2,000 points, UNet depth 3, over two synthetic samples of the
    preset's 11 sweeps at 20 Hz."""
    from pcaccumulation_tpu.data.synthetic import write_synthetic_dataset
    from pcaccumulation_tpu_torch.main import main

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, 2, n_frames=11, freq=20.0, n_static_clusters=6, n_dynamic=2,
                            pts_per_cluster=60, pts_per_object=40, area=6.0)
    monkeypatch.chdir(tmp_path)
    args = ["main", os.path.join(REPO, "configs", "nuscene.yaml"), "1", "1",
            "--misc.mode=test", "--misc.device=cpu", "--misc.exp_name=nuscene_bf16",
            "--train.ckpt_backend=pickle", f"--path.dataset_base={data}",
            "--voxel_generator.range=[-8,-8,-5,8,8,3]", "--voxel_generator.crop_range=[8,-5,3]",
            "--capacity.max_points=2000", "--capacity.max_pillars=1500",
            "--unet.depth=3", "--pillar_encoder.depth=2", "--pose_estimation.n_kpts=128",
            "--cluster.bfs_iters=4", "--test.num_workers=0"]
    assert main(args) == 0
    saved = (tmp_path / "snapshot" / "nuscene_bf16" / "config.json").read_text()
    assert '"compute_dtype": "bfloat16"' in saved
    assert len(os.listdir(tmp_path / "results" / "nuscene_bf16")) == 1
