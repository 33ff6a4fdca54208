"""bf16 training of the PyTorch port (`precision.compute_dtype: bfloat16`
with `--misc.mode=train`) against the JAX package's bf16 train step, on
the CPU.

- Kernels: the gradients of K1 and K2 on bf16 (their plain versions, which
  the CUDA kernels are held against on the card) against `jax.vjp` of the
  JAX package's own functions: K1 through `kernels.segscan.seg_pool`, whose
  VJP `_seg_pool_bwd` is what the TPU runs (on the CPU its sum scan takes
  the `_seg_pool_jnp` path); K2 through `ops.bilinear.row_shift_blocks`
  with its TPU branch taken and the Pallas kernel in interpret mode (its
  CPU branch rounds f to bf16 first, which the TPU kernel does not).
- The two BatchNorm forms of the bf16 heads in train mode against their
  JAX modules with `mutable=["batch_stats"]`.
- The composed train step in bf16 against `jax.value_and_grad` of the JAX
  package's bf16 step (tests/test_torch_train.py's harness), the Trainer's
  micro-steps and checkpoints in bf16, and the CLI's train mode on
  configs/nuscene.yaml cut for the CPU.

bf16 values cross between the frameworks as float32 arrays (exact).
"""

import copy
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

import pcaccumulation_tpu.ops.bilinear as jbilinear
from pcaccumulation_tpu.data.synthetic import write_synthetic_dataset
from pcaccumulation_tpu.kernels.segscan import seg_pool as jseg_pool
from pcaccumulation_tpu.models.layers import S2DBatchNorm
from pcaccumulation_tpu.ops.s2d import depth_to_space, space_to_depth
from pcaccumulation_tpu_torch import build_model, to_device
from pcaccumulation_tpu_torch.kernels.row_shift import row_shift_blocks
from pcaccumulation_tpu_torch.kernels.segscan import seg_pool
from pcaccumulation_tpu_torch.models.layers import MaskedBatchNorm
from test_torch_motionnet import config, make_batch, place_fb_threshold, random_variables
from test_torch_precision import BF16, REPO, T, bf16_pair, bf16_ulp, k1_case, to_np
from test_torch_train import (
    TERM_TOL,
    WEIGHT_SEED,
    _tiny_batches,
    _tiny_cfg,
    jax_loss_and_grads,
    port_loss_and_grads,
)

# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("case", ["long_run", "block_edges", "ragged_c9", "padded_tail"])
def test_k1_bf16_gradient_matches_jax_vjp(case):
    """The gradient of K1's max on bf16 rows with forced ties (every row
    rounded to halves, so several rows share a segment's maximum)
    against `jax.vjp` of the JAX package's `seg_pool`: the forward equal,
    the gradient zero off the tie set in both, and on it within 1 bf16 ulp
    of the segment's share. Both sum g and the tie mask in float32, divide
    in float32 and round to bf16 once; their float32 sums add in other
    orders (the JAX VJP's log-shift scan), so a share may round one ulp
    apart."""
    rng = np.random.default_rng(11)
    ids, c, _ = k1_case(case, rng)
    x = rng.standard_normal((ids.size, c)).astype(np.float32)
    x = np.round(x * 2) / 2
    xj, xt = bf16_pair(x)
    gj, gt = bf16_pair(rng.standard_normal(x.shape).astype(np.float32))
    want_y, vjp = jax.vjp(lambda a: jseg_pool(a, jnp.asarray(ids), "max"), xj)
    (want,) = vjp(gj)
    xg = xt.clone().requires_grad_(True)
    y = seg_pool(xg, T(ids), "max")
    y.backward(gt)
    assert xg.grad.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(to_np(y), to_np(want_y))
    got, want = to_np(xg.grad), to_np(want)
    tie = to_np(xt) == to_np(y)
    assert (got[~tie] == 0).all() and (want[~tie] == 0).all()
    # forced ties: many (segment, column) maxima are shared by several rows
    n_extra = int(tie.sum()) - len(np.unique(ids)) * c
    assert n_extra > 0.05 * len(np.unique(ids)) * c, n_extra
    err = np.abs(got - want)
    assert (err <= bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all(), err.max()


@pytest.mark.parametrize("nb,c", [(5, 32), (11, 32), (5, 9)])
def test_k2_bf16_gradient_matches_jax_vjp(nb, c, monkeypatch):
    """The gradient of K2 on a bf16 cotangent (the kernel's plain version at
    -shifts) against `jax.vjp` of the JAX package's `row_shift_blocks`
    taking its TPU branch, with the Pallas kernel in interpret mode (its
    calls counted, so the branch really ran); the forward and the gradient
    within 1 bf16 ulp: both lerp in float32 at a float32 f and round once,
    summing the taps' products in their own float32 order. nb=11 runs as
    the JAX package's 4+4+3 chunks."""
    calls = []

    def pallas(*args, **kw):
        calls.append(args[0].shape)
        return pallas_kernel(*args, **kw, interpret=True)

    pallas_kernel = jbilinear._row_shift_blocks_pallas
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jbilinear, "_row_shift_blocks_pallas", pallas)
    rng = np.random.default_rng(nb * 10 + c)
    r, w = 24, 40
    xj, xt = bf16_pair(rng.normal(size=(r, w, nb * c)).astype(np.float32))
    gj, gt = bf16_pair(rng.normal(size=(r, w, nb * c)).astype(np.float32))
    shifts = ((rng.random((r, nb)) - 0.5) * 2.5 * w).astype(np.float32)
    shifts[:, 0] = 0.0
    shifts[::5, 1] = 3.0  # integral
    want_y, vjp = jax.vjp(lambda a: jbilinear.row_shift_blocks(a, jnp.asarray(shifts), nb), xj)
    (want,) = vjp(gj)
    img = xt.clone().requires_grad_(True)
    y = row_shift_blocks(img, T(shifts), nb)
    y.backward(gt)
    assert img.grad.dtype == BF16 and want.dtype == jnp.bfloat16
    assert len(calls) == 2 * -(-nb // min(nb, 128 // c)), calls  # forward and gradient chunks
    for a, b in ((y, want_y), (img.grad, want)):
        a, b = to_np(a), to_np(b)
        assert (np.abs(a - b) <= bf16_ulp(np.maximum(np.abs(a), np.abs(b)))).all()
    got = to_np(img.grad)
    np.testing.assert_array_equal(got[..., :c], to_np(gt)[..., :c])  # zero shift


# ------------------------------------------------------------ BatchNorm


def _bn_case(c=16):
    rng = np.random.default_rng(0)
    xj, xt = bf16_pair((rng.normal(size=(2, 12, 12, c)) * 2 + 0.7).astype(np.float32))
    gj, gt = bf16_pair(rng.normal(size=(2, 12, 12, c)).astype(np.float32))
    v = {"params": {"scale": np.linspace(0.5, 1.5, c, dtype=np.float32),
                    "bias": np.linspace(-1, 1, c, dtype=np.float32)},
         "batch_stats": {"mean": np.linspace(-0.3, 0.3, c, dtype=np.float32),
                         "var": np.linspace(0.5, 1.7, c, dtype=np.float32)}}
    return xj, xt, gj, gt, v


@pytest.mark.parametrize("form", ["flax", "s2d"])
def test_batchnorm_bf16_train_matches_jax(form):
    """The 2-D heads' BatchNorm in bf16 and train mode (batch statistics,
    gradient through them) against its JAX module with dtype=bfloat16 and
    mutable batch_stats: flax's BatchNorm (`form="flax"`) and the JAX
    package's S2DBatchNorm on the space-to-depth view (`form="s2d"`).
    - the output bit-equal (statistics in float32, the same roundings);
    - the input's gradient within 1 bf16 ulp of its scale (float32 sums of
      the statistics' gradients in other orders round a share of the
      elements one ulp apart);
    - the running statistics within 1e-6;
    - scale and bias: flax's gradients are float32 sums, within 1e-5 of
      their scale. The S2D form's reduce the bf16 cotangent in bf16, once
      per 2x2 sub-position and then over the four, as the JAX graph does;
      the port rounds each reduction once (float32 accumulation), which is
      within 1 bf16 ulp of the exact sums, while the JAX package on the
      CPU accumulates a bf16 reduction in bf16 row by row: the port's
      bias gradient lies within 1 bf16 ulp (of its scale) of the float64
      sum of the same cotangent, and both gradients within 3 % of the JAX
      CPU's (measured: 1 %).
    """
    xj, xt, gj, gt, v = _bn_case()
    c = xt.shape[-1]
    if form == "s2d":
        mod = S2DBatchNorm(momentum=0.9, dtype=jnp.bfloat16)

        def apply(p, x):
            y, st = mod.apply({"params": p, "batch_stats": v["batch_stats"]},
                              space_to_depth(x), train=True, mutable=["batch_stats"])
            return depth_to_space(y), st
    else:
        mod = fnn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jnp.bfloat16)

        def apply(p, x):
            return mod.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                             mutable=["batch_stats"])
    want_y, vjp, st = jax.vjp(apply, v["params"], xj, has_aux=True)
    gp, gx = vjp(gj)

    bn = MaskedBatchNorm(c, compute_dtype=BF16, s2d=form == "s2d").train()
    with torch.no_grad():
        bn.weight.copy_(T(v["params"]["scale"]))
        bn.bias.copy_(T(v["params"]["bias"]))
        bn.running_mean.copy_(T(v["batch_stats"]["mean"]))
        bn.running_var.copy_(T(v["batch_stats"]["var"]))
    xi = xt.clone().permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xi)
    y.backward(gt.permute(0, 3, 1, 2))
    assert y.dtype == BF16
    np.testing.assert_array_equal(to_np(y.permute(0, 2, 3, 1)), to_np(want_y))
    got_gx = to_np(xi.grad.permute(0, 2, 3, 1))
    assert np.abs(got_gx - to_np(gx)).max() <= bf16_ulp(np.abs(to_np(gx)).max())
    for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(st["batch_stats"][key]), atol=1e-6,
                                   rtol=0, err_msg=key)
    if form == "flax":
        for key, p in (("scale", bn.weight), ("bias", bn.bias)):
            want = np.asarray(gp[key])
            assert np.abs(p.grad.numpy() - want).max() <= 1e-5 * np.abs(want).max(), key
        return
    # the S2D form: bias's gradient is the gradient of add, the sum of the
    # bf16 cotangent over every row
    exact_bias = to_np(gt).astype(np.float64).sum((0, 1, 2))
    assert np.abs(bn.bias.grad.numpy() - exact_bias).max() <= bf16_ulp(np.abs(exact_bias).max())
    for key, p in (("scale", bn.weight), ("bias", bn.bias)):
        want = np.asarray(gp[key])
        assert np.abs(p.grad.numpy() - want).max() <= 0.03 * np.abs(want).max(), key


# ------------------------------------------------------------ the model


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("train_bn", [False, True], ids=["eval_bn", "train_bn"])
def test_bf16_train_step_matches_jax(train_bn, record_property):
    """The port's bf16 train step (MotionNet(mode="train") + FuseLoss +
    backward, loaded from the JAX package's float32 params and
    batch_stats) against `jax.value_and_grad` of the JAX package's bf16
    step, on test_torch_train.py's "default" config (s2d level 0 and the
    sparse ego head on the JAX side: the heads' S2D BatchNorm form, the
    nuScenes preset's path; FG-subset decoding) with its weight seed, eval
    and train BN.

    Criterion. Two bf16 computations of the same function that sum in other
    orders scatter about the float32 result independently: the FB head's
    decisions, the keypoints and the max pools' winners move with an ulp,
    and the TPointNet objective carries that to the deep STPN leaves (the
    JAX package's own bf16 gradient lies 50-75 % from its float32 one
    there). So the port is held to the JAX package's own bf16-vs-float32
    distance d = rel(jax_bf16, jax_f32), per leaf above the noise floor of
    1e-5 of the largest gradient: rel(port_bf16, jax_bf16) <= sqrt(2) d +
    0.02 (the distance of two independent draws of that spread), and
    rel(port_bf16, jax_f32) <= sqrt(2) d + 0.02 (the port in bf16 lies no
    farther from float32 than a second bf16 computation would); the 0.02
    is an absolute allowance for leaves whose drift is one or a few values
    (beta, a 2-wide bias). A loss term is one draw, and its own drift may
    vanish by chance, so each is held to the JAX package's largest relative
    drift over the terms, r = max |jax_bf16 - jax_f32| / max(1, |jax_f32|):
    |port_bf16 - jax_bf16| <= 3 r max(1, |jax_bf16|) + the float32 test's
    term tolerance. The parameters' gradients are float32."""
    cfg32 = config("default")
    cfg16 = copy.deepcopy(cfg32)
    cfg16["precision"] = {"compute_dtype": "bfloat16"}
    batch = make_batch(cfg32)
    params, stats = random_variables(cfg32, batch, seed=WEIGHT_SEED["default"])
    params = place_fb_threshold(cfg32, params, stats, batch, train_bn)
    got_s, got_g = port_loss_and_grads(cfg16, params, stats, batch, train_bn)
    want_s, want_g = jax_loss_and_grads(cfg16, params, stats, batch, train_bn)
    ref_s, ref_g = jax_loss_and_grads(cfg32, params, stats, batch, train_bn)

    terms = [k for k, w in want_s.items() if not isinstance(w, dict)]  # not the IoU counters
    drift = max(abs(float(want_s[k]) - float(ref_s[k])) / max(1.0, abs(float(ref_s[k])))
                for k in terms)
    record_property("jax_term_drift", drift)
    for key in terms:
        scale = max(1.0, abs(float(want_s[key])))
        err = abs(float(got_s[key].detach()) - float(want_s[key]))
        record_property(f"term.{key}", err)
        assert err <= (3 * drift + TERM_TOL[train_bn]) * scale, (key, err, drift)

    names = sorted(got_g)
    assert set(names) <= set(want_g)
    assert all(g.dtype == np.float32 for g in got_g.values())
    norms = {n: max(np.linalg.norm(want_g[n].numpy()), np.linalg.norm(got_g[n])) for n in names}
    floor = max(norms.values()) * 1e-5
    checked = 0
    worst = (0.0, "")
    for n in names:
        if norms[n] < floor:
            continue
        d = _rel(want_g[n].numpy(), ref_g[n].numpy())
        to_jax, to_f32 = _rel(got_g[n], want_g[n].numpy()), _rel(got_g[n], ref_g[n].numpy())
        bound = np.sqrt(2.0) * d + 0.02
        worst = max(worst, (max(to_jax, to_f32) / bound, n))
        assert to_jax <= bound and to_f32 <= bound, (n, to_jax, to_f32, d)
        checked += 1
    record_property("worst_leaf", f"{worst[1]} at {worst[0]:.3f} of its bound")
    assert checked > 0.9 * len(names), (checked, len(names))


def test_trainer_bf16_steps_and_checkpoint(tmp_path):
    """The Trainer on a bf16 model: two micro-steps at iter_size 2 give
    finite losses and one applied update; the parameters, their gradients
    and the optimizer's state stay float32 and the parameters move; a
    checkpoint restores the weights into a fresh bf16 model."""
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    cfg = _tiny_cfg(iter_size=2)
    cfg["precision"] = {"compute_dtype": "bfloat16"}
    batches = _tiny_batches(cfg)
    torch.manual_seed(0)
    tr = Trainer(cfg, build_model(cfg, "cpu"), {"train": batches},
                 save_dir=str(tmp_path / "a"), device="cpu")
    assert tr.model.compute_dtype == BF16
    before = [p.detach().clone() for p in tr.params]
    for i in range(2):
        st = tr.train_step(to_device(batches[i], "cpu"), tr.step_generator(1, "train", i))
        assert np.isfinite(float(st["loss"])), i
        assert all(p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
                   for p in tr.params)
    assert tr.optimizer.count == 1 and tr.optimizer.n_skipped == 0
    assert all(m.dtype == torch.float32 for m in tr.optimizer.mu + tr.optimizer.nu)
    moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, tr.params))
    assert moved > len(tr.params) // 2, (moved, len(tr.params))

    tr.snapshot(1, "latest")
    cfg2 = dict(cfg, misc=dict(cfg["misc"], pretrain=str(tmp_path / "a" / "model_latest.ckpt")))
    tr2 = Trainer(cfg2, build_model(cfg, "cpu"), {"train": batches},
                  save_dir=str(tmp_path / "b"), device="cpu")
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(tr2.model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    assert tr2.optimizer.count == 1 and tr2.start_epoch == 2


def test_cli_nuscene_bf16_train_mode_on_cpu(tmp_path, monkeypatch):
    """python -m pcaccumulation_tpu_torch.main configs/nuscene.yaml 2 1
    --misc.mode=train --train.ckpt_backend=pickle trains one epoch in bf16
    (the preset's compute dtype) and writes its checkpoints; cut for the
    CPU as the test mode's CLI test is (16x16 m grid, 2,000 points, UNet
    depth 3), over four synthetic samples of the preset's 11 sweeps at
    20 Hz (two train, one val)."""
    from pcaccumulation_tpu_torch.main import main

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, 4, n_frames=11, freq=20.0, n_static_clusters=6, n_dynamic=2,
                            pts_per_cluster=60, pts_per_object=40, area=6.0)
    monkeypatch.chdir(tmp_path)
    args = ["main", os.path.join(REPO, "configs", "nuscene.yaml"), "2", "1",
            "--misc.mode=train", "--misc.device=cpu", "--misc.exp_name=nuscene_train",
            "--train.ckpt_backend=pickle", "--train.max_epoch=2", f"--path.dataset_base={data}",
            "--voxel_generator.range=[-8,-8,-5,8,8,3]", "--voxel_generator.crop_range=[8,-5,3]",
            "--capacity.max_points=2000", "--capacity.max_pillars=1500",
            "--capacity.max_fg_points=512", "--unet.depth=3", "--pillar_encoder.depth=2",
            "--pose_estimation.n_kpts=128", "--train.num_workers=0", "--val.num_workers=0"]
    assert main(args) == 0
    run = tmp_path / "snapshot" / "nuscene_train"
    assert '"compute_dtype": "bfloat16"' in (run / "config.json").read_text()
    log = (run / "log").read_text()
    assert "train Epoch: 1" in log and "val Epoch: 1" in log
    for name in ("latest", "best_loss"):
        assert (run / f"model_{name}.ckpt").exists(), name
