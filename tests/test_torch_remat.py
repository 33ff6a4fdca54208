"""`train.remat` in the port's Trainer: a remat step recomputes the forward
and the loss in the backward pass (`torch.utils.checkpoint`), and its
gradients, running statistics and update equal a plain step's; and its
gradient against the JAX package's remat step (`jax.checkpoint(loss_fn,
policy=nothing_saveable)`) by the composed-gradient test's criterion.

The two traps a remat step has, each shown to bite by a naive checkpoint of
the same forward: (a) the random keypoint draw's explicit
`torch.Generator`, which the checkpoint does not restore, so a recompute
would draw other keypoints and give another gradient; (b) train-mode
BatchNorm's running statistics, which a recompute would update twice."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu.models import MotionNet as JaxMotionNet
from pcaccumulation_tpu.train.loss import fuse_loss as j_fuse_loss
from pcaccumulation_tpu_torch import build_model, to_device
from pcaccumulation_tpu_torch.train.loss import fuse_loss
from pcaccumulation_tpu_torch.train.trainer import Trainer
from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_motionnet import config, make_batch, place_fb_threshold, random_variables
from test_torch_train import TERM_TOL, _tiny_cfg

def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).double().norm() / max(float(a.double().norm()), 1e-30))


def _step(cfg, state, batch, tmp_path, name):
    """One Trainer micro-step from `state`: (stats, gradients, buffers,
    parameters after the update, the Conv2d forward calls it made)."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    calls = []
    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(lambda *_: calls.append(1))
    tr = Trainer(cfg, model, {}, save_dir=str(tmp_path / name), device="cpu")
    stats = tr.train_step(batch, tr.step_generator(1, "train", 0))
    return (stats, {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            {n: b.clone() for n, b in model.named_buffers()},
            {n: p.detach().clone() for n, p in model.named_parameters()}, len(calls))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """A plain and a remat step from one state (the random keypoint draw,
    train-mode BN, B=2), and a naive checkpoint of the same forward. One
    intra-op thread: the CPU's multithreaded convolution gradients sum in
    an order that changes from call to call (two plain steps differ by ~6e-6
    rel-norm at the Conv3d weights), in one thread they are reproducible."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _steps(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _steps(tmp_path_factory):
    cfg = _tiny_cfg()
    cfg["pose_estimation"]["deterministic_sampling"] = False
    batch = to_device(make_batch(cfg, batch_size=2), "cpu")
    torch.manual_seed(0)
    state = copy.deepcopy(build_model(cfg, device="cpu").state_dict())
    tmp = tmp_path_factory.mktemp("remat")
    out = {}
    for remat in (False, True):
        cfg_r = copy.deepcopy(cfg)
        cfg_r["train"]["remat"] = remat
        out[remat] = _step(cfg_r, state, batch, tmp, f"remat_{remat}")

    # naive: the model's own forward under checkpoint, the generator passed in
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    gen = Trainer(cfg, model, {}, save_dir=str(tmp / "naive"),
                  device="cpu").step_generator(1, "train", 0)
    model.train()

    def forward_loss(b):
        return fuse_loss(model(b, mode="train", generator=gen), b, cfg["loss"],
                         cfg["capacity"]["max_instances"])

    checkpoint(forward_loss, batch, use_reentrant=False)["loss"].backward()
    out["naive"] = (None, {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None},
                    {n: b.clone() for n, b in model.named_buffers()}, None, None)
    return out


def test_remat_gradients_and_update_equal_plain_step(steps):
    """The remat step runs the forward twice (the recompute in the
    backward) and equals the plain step bit for bit: the loss, every
    gradient leaf and every updated parameter."""
    (s0, g0, _, p0, c0), (s1, g1, _, p1, c1) = steps[False], steps[True]
    assert c0 > 0 and c1 == 2 * c0, (c0, c1)
    assert float(s0["loss"]) == float(s1["loss"])
    assert sorted(g0) == sorted(g1) and len(g0) > 50
    for n in g0:
        assert torch.equal(g0[n], g1[n]), (n, _rel(g0[n], g1[n]))
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    # trap (a): without the scores drawn outside it, the recompute draws
    # other keypoints, and the gradient moves
    gn = steps["naive"][1]
    assert max(_rel(g0[n], gn[n]) for n in g0) > 1e-3


def test_remat_running_statistics_equal_plain_step(steps):
    b0, b1, bn = steps[False][2], steps[True][2], steps["naive"][2]
    stats = [n for n in b0 if n.endswith(("running_mean", "running_var"))]
    assert len(stats) > 10
    for n in b0:
        assert torch.equal(b0[n], b1[n]), n
    # trap (b): a recompute that updates them again moves them
    assert any(not torch.equal(b0[n], bn[n]) for n in stats)
    assert any(int(bn[n]) == 2 for n in bn if n.endswith("num_batches_tracked"))


def test_remat_step_matches_jax_remat_step(tmp_path):
    """The port's remat micro-step (train-mode BN, deterministic keypoints,
    the default-path config) against `jax.value_and_grad` of the JAX
    package's `jax.checkpoint(loss_fn, policy=nothing_saveable)`: the
    criterion of test_torch_train.py's train-BN case (every loss term, the
    whole gradient's cosine above 0.99), and the updated running
    statistics within 1e-4 (float32 batch statistics over ~10^4 rows, which
    the JAX side takes as E[x^2] - E[x]^2)."""
    cfg = config("default")
    cfg["train"]["remat"] = True
    batch = make_batch(cfg)
    params, stats = random_variables(cfg, batch, seed=0)
    params = place_fb_threshold(cfg, params, stats, batch, True)

    jmodel = JaxMotionNet(cfg)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p, s):
        res, mutated = jmodel.apply({"params": p, "batch_stats": s}, jbatch, train=True,
                                    mode="train", mutable=["batch_stats"])
        st = j_fuse_loss(res, jbatch, cfg["loss"], cfg["capacity"]["max_instances"])
        return st["loss"], (st, mutated["batch_stats"])

    remat_fn = jax.checkpoint(loss_fn, policy=jax.checkpoint_policies.nothing_saveable)
    (_, (want_s, want_bs)), want_g = jax.jit(jax.value_and_grad(remat_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats))
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, want_g),
                                 jax.tree.map(np.zeros_like, stats))
    want_sd = state_dict_from_jax(params, jax.tree.map(np.asarray, want_bs))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats))
    tr = Trainer(cfg, model, {}, save_dir=str(tmp_path), device="cpu")
    got_s = tr.train_step(to_device(batch, "cpu"))

    for key, w in want_s.items():
        if isinstance(w, dict):
            continue
        err = abs(float(got_s[key]) - float(w))
        assert err < TERM_TOL[True] * max(1.0, abs(float(w))), (key, float(got_s[key]), float(w))
    names = sorted(n for n, p in model.named_parameters())
    a = np.concatenate([want_g[n].numpy().ravel() for n in names]).astype(np.float64)
    b = np.concatenate([(p.grad if p.grad is not None else torch.zeros_like(p)).numpy().ravel()
                        for n, p in sorted(model.named_parameters())]).astype(np.float64)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.99, cos
    got_sd = model.state_dict()
    for n in want_sd:
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[n].numpy(), want_sd[n].numpy(), atol=1e-4,
                                       err_msg=n)
