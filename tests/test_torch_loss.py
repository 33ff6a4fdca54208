"""Gradients of the PyTorch port's training path against the JAX package's,
piece by piece: the K1 and K2 gradients, the even tie split of both max
pools, the safe SVD backward and weighted Kabsch, Lovász-Softmax, every
FuseLoss statistic, and the optimizer against optax. The same seeded numpy
inputs go to both; float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu.kernels import segscan as jsegscan
from pcaccumulation_tpu.ops import bilinear as jbil
from pcaccumulation_tpu.ops.kabsch import _safe_svd_bwd
from pcaccumulation_tpu.ops.kabsch import safe_svd as j_safe_svd
from pcaccumulation_tpu.ops.kabsch import weighted_kabsch as j_weighted_kabsch
from pcaccumulation_tpu.ops import segment as jseg
from pcaccumulation_tpu.ops.lovasz import lovasz_softmax as j_lovasz
from pcaccumulation_tpu.train.loss import fuse_loss as j_fuse_loss
from pcaccumulation_tpu.train.trainer import make_optimizer
from pcaccumulation_tpu_torch.kernels.row_shift import row_shift_blocks
from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_plain
from pcaccumulation_tpu_torch.ops import kabsch as tkabsch
from pcaccumulation_tpu_torch.ops import segment as tseg
from pcaccumulation_tpu_torch.ops.lovasz import lovasz_softmax
from pcaccumulation_tpu_torch.train.loss import fuse_loss
from pcaccumulation_tpu_torch.train.trainer import Optimizer

T = torch.from_numpy


def _grad(fn, x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """x.grad of <fn(x), g> in the port."""
    xt = T(x.copy()).requires_grad_(True)
    fn(xt).backward(T(g))
    return xt.grad.numpy()


def _jvjp(fn, x, g):
    return np.asarray(jax.vjp(fn, jnp.asarray(x))[1](jnp.asarray(g))[0])


def _tied_k1_case(seed, n=1200, c=6, tail=300):
    """Sorted ids with short runs, one 500-row run and a -1e30 tail;
    integer-valued x, so maxima tie inside most segments."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, 200, size=n - tail)).astype(np.int32)
    ids[100:600] = ids[100]
    ids = np.concatenate([np.sort(ids), np.full(tail, 500, np.int32)])
    x = rng.integers(-2, 3, size=(n, c)).astype(np.float32)
    x[n - tail:] = -1e30
    g = rng.normal(size=(n, c)).astype(np.float32)
    return x, ids, g


@pytest.mark.parametrize("op", ["max", "sum"])
def test_seg_pool_vjp_matches_jax_with_ties(op):
    """K1's gradient: max splits each segment's cotangent evenly among its
    tied maxima and gives every other row exactly zero; sum broadcasts the
    segment's cotangent sum. Tolerance: float32 sums in another order,
    1e-5 of the segment's sum of |g|."""
    x, ids, g = _tied_k1_case(0)
    got = _grad(lambda xt: seg_pool(xt, T(ids), op), x, g)
    want = _jvjp(lambda xj: jsegscan.seg_pool(xj, jnp.asarray(ids), op), x, g)
    abs_sum = seg_pool_plain(T(np.abs(g)), T(ids), "sum").numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * abs_sum + 1e-6)
    if op == "max":
        tie = x == seg_pool_plain(T(x), T(ids), "max").numpy()
        assert (tie.sum(0) > 0).all() and (~tie).any()
        np.testing.assert_array_equal(got[~tie], 0.0)
        np.testing.assert_array_equal(want[~tie], 0.0)
        # the tie split really happens: some segment has several maxima
        nt = seg_pool_plain(T(tie.astype(np.float32)), T(ids), "sum").numpy()
        assert (nt[tie] > 1).any()


def test_masked_max_pools_vjp_match_jax():
    """masked_seg_pool_max (K1's call site) and masked_segment_max (the
    winner-mask gradient) against the JAX package's, with ties, invalid
    rows and, for masked_segment_max, ids beyond the last segment (JAX's
    backward wraps a negative id to a segment from the end, which the
    forward dropped; the model makes no negative id)."""
    x, ids, g = _tied_k1_case(1, tail=0)
    rng = np.random.default_rng(2)
    valid = rng.random(len(ids)) < 0.8
    valid[:20] = False  # whole segments of invalid rows: filled, no gradient
    got = _grad(lambda xt: tseg.masked_seg_pool_max(xt, T(ids), T(valid)), x, g)
    want = _jvjp(lambda xj: jseg.masked_seg_pool_max(xj, ids, valid, 500), x, g)
    abs_sum = seg_pool_plain(T(np.abs(g)), T(ids), "sum").numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * abs_sum + 1e-6)
    np.testing.assert_array_equal(got[~valid], 0.0)

    s = 40
    ids2 = rng.integers(0, s + 3, size=len(ids)).astype(np.int32)
    g2 = rng.normal(size=(s, x.shape[1])).astype(np.float32)
    got = _grad(lambda xt: tseg.masked_segment_max(xt, T(ids2), T(valid), s), x, g2)
    want = _jvjp(lambda xj: jseg.masked_segment_max(xj, ids2, valid, s), x, g2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    out = tseg.masked_segment_max(T(x), T(ids2), T(valid), s).numpy()
    winners = valid[:, None] & (ids2[:, None] < s) & (
        x == out[np.clip(ids2, 0, s - 1)])
    assert (got[winners] != 0).all() and (got[~winners] == 0).all()


@pytest.mark.parametrize("nb", [1, 5])
def test_row_shift_blocks_vjp_matches_jax(nb):
    """K2's gradient is the JAX custom VJP: the same shift at -shifts for
    the image (not autograd's transpose at the row ends), zero for the
    shifts. Shifts beyond the row included."""
    rng = np.random.default_rng(nb)
    r, w, c = 12, 20, 8
    img = rng.normal(size=(r, w, nb * c)).astype(np.float32)
    shifts = ((rng.random((r, nb)) - 0.5) * 2.5 * w).astype(np.float32)
    shifts[0] = 0.0
    shifts[1, 0] = -(w + 7.25)
    shifts[2, -1] = w + 3.5
    g = rng.normal(size=img.shape).astype(np.float32)
    it = T(img).requires_grad_(True)
    st = T(shifts).requires_grad_(True)
    row_shift_blocks(it, st, nb).backward(T(g))
    _, vjp = jax.vjp(lambda a, s: jbil.row_shift_blocks(a, s, nb), jnp.asarray(img),
                     jnp.asarray(shifts))
    want_img, want_shifts = vjp(jnp.asarray(g))
    np.testing.assert_allclose(it.grad.numpy(), np.asarray(want_img), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(st.grad.numpy(), 0.0)
    np.testing.assert_array_equal(np.asarray(want_shifts), 0.0)


def _svd_res(rng, s):
    q1, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q2, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q1.astype(np.float32), np.asarray(s, np.float32), q2.T.astype(np.float32)


@pytest.mark.parametrize("s", [[3.0, 1.7, 0.4], [2.0, 2.0, 1.0], [1.0, 1.0, 1.0],
                               [2.0, 2.0 + 3e-6, 0.0]],
                         ids=["distinct", "pair", "triple", "near_pair_and_zero"])
def test_safe_svd_backward_matches_jax(s):
    """The backward on the same (u, s, vh) and cotangents: finite where
    singular values repeat or nearly repeat; float32 rounding apart."""
    rng = np.random.default_rng(len(str(s)))
    u, sv, vh = _svd_res(rng, s)
    du, dvh = (rng.normal(size=(3, 3)).astype(np.float32) for _ in range(2))
    ds = rng.normal(size=3).astype(np.float32)
    got = tkabsch.safe_svd_backward(T(u), T(sv), T(vh), T(du), T(ds), T(dvh)).numpy()
    (want,) = _safe_svd_bwd((u, sv, vh), (du, ds, dvh))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_safe_svd_gradient_matches_jax_and_weighted_kabsch():
    """Gradients through the SVD of random matrices (a loss that does not
    depend on the SVD's signs), and of weighted Kabsch in xs, xt and the
    weights, against jax.grad."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 3, 3)).astype(np.float32)
    w1, w2 = (rng.normal(size=3).astype(np.float32) for _ in range(2))
    c1 = rng.normal(size=(4, 3, 3)).astype(np.float32)

    def loss(u, s, vh, lib):
        uu = (u * lib.asarray(w1)) @ lib.swapaxes(u, -1, -2)
        vv = (lib.swapaxes(vh, -1, -2) * lib.asarray(w2)) @ vh
        return (lib.asarray(c1) * (uu + vv + u @ vh)).sum() + (s * s).sum()

    at = T(a).requires_grad_(True)
    loss(*tkabsch.safe_svd(at), torch).backward()
    want = jax.grad(lambda x: loss(*j_safe_svd(x), jnp))(jnp.asarray(a))
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    xs = rng.normal(size=(3, 50, 3)).astype(np.float32) * 3
    xt = (xs @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T.astype(np.float32)
          + rng.normal(size=(3, 1, 3)).astype(np.float32) + 0.05 * rng.normal(size=xs.shape)
          ).astype(np.float32)
    wt = rng.random((3, 50)).astype(np.float32)
    cr = rng.normal(size=(3, 3, 3)).astype(np.float32)
    ct = rng.normal(size=(3, 3)).astype(np.float32)
    args = [T(v).requires_grad_(True) for v in (xs, xt, wt)]
    rot, trans = tkabsch.weighted_kabsch(*args)
    ((rot * T(cr)).sum() + (trans * T(ct)).sum()).backward()

    def jloss(*v):
        rot, trans = j_weighted_kabsch(*v)
        return (rot * cr).sum() + (trans * ct).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(v) for v in (xs, xt, wt)))
    for name, got_t, w in zip(("xs", "xt", "weights"), args, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got_t.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_lovasz_softmax_value_and_gradient_with_ties():
    """Tied errors everywhere: invalid rows (error 0) and probabilities on
    a coarse grid. The stable sort routes the gradient as JAX's does."""
    rng = np.random.default_rng(3)
    p, c = 400, 2
    logits = rng.integers(-2, 3, size=(p, c)).astype(np.float32)
    probas = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, c, size=p).astype(np.int32)
    valid = rng.random(p) < 0.7
    pt = T(probas).requires_grad_(True)
    val = lovasz_softmax(pt, T(labels).long(), T(valid))
    val.backward()
    want_v, want_g = jax.value_and_grad(lambda q: j_lovasz(q, labels, valid))(
        jnp.asarray(probas))
    np.testing.assert_allclose(float(val), float(want_v), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-7)
    errors = np.abs(((labels == 0) & valid) - probas[:, 0]) * valid
    assert len(np.unique(errors)) < p // 10  # many ties


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy() if torch.is_tensor(tree) else tree)


@pytest.mark.parametrize("variant", ["parity", "default"])
def test_fuse_loss_stats_match_jax(variant):
    """Every FuseLoss statistic and IoU counter on one results dict (the
    port's forward on a small config) fed to both packages. The FG-subset
    branches run in the default variant. Tolerance: float32 reductions in
    another order."""
    from pcaccumulation_tpu_torch import build_model, to_device
    from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
    from test_torch_motionnet import config, make_batch, random_variables

    cfg = config(variant)
    batch = make_batch(cfg)
    params, stats = random_variables(cfg, batch)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats))
    with torch.no_grad():
        res = model(to_device(batch, "cpu"), mode="train")
        got = fuse_loss(res, to_device(batch, "cpu"), cfg["loss"],
                        cfg["capacity"]["max_instances"])
    assert ("mos_sub" in res) == (variant == "default")
    want = j_fuse_loss(_to_jax(res), jax.tree.map(jnp.asarray, batch), cfg["loss"],
                       cfg["capacity"]["max_instances"])
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, dict):
            for k2, w2 in w.items():
                np.testing.assert_allclose(got[key][k2].numpy(), np.asarray(w2), atol=1e-6,
                                           err_msg=f"{key}.{k2}")
        else:
            np.testing.assert_allclose(float(got[key]), float(w), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    assert float(got["loss"]) > 0.5 and float(got["mos_loss"]) > 0


def test_optimizer_matches_optax():
    """The same gradient arrays through optax's `make_optimizer` and the
    port's Optimizer: iter_size 2 (the mean of two micro-steps), norms above
    the clip, updates_per_epoch 2 (the LR decays after two applied updates)
    and one non-finite micro-batch in the last window, which both skip.
    Parameters agree within 1e-6 relative.

    After a skip optax keeps the NaN in its accumulator (0 * nan) and skips
    every later window; the port starts the next window afresh. So the
    port's run past a skipped window must equal optax's run over the same
    gradients with that window left out."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    cfg = {"optimizer": {"learning_rate": 0.05, "weight_decay": 0.0},
           "scheduler": {"exp_gamma": 0.5}, "train": {"grad_clip": 1.0, "iter_size": 2}}
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 3).astype(np.float32) for s in shapes] for _ in range(10)]
    grads[7][1][2] = np.nan  # window 4 (micro-steps 6, 7) is non-finite

    def run_optax(seq):
        tx, _ = make_optimizer(cfg, updates_per_epoch=2)
        params = {f"p{i}": jnp.asarray(p) for i, p in enumerate(p0)}
        state = tx.init(params)
        out = []
        for g in seq:
            upd, state = tx.update({f"p{i}": jnp.asarray(a) for i, a in enumerate(g)}, state,
                                   params)
            params = optax.apply_updates(params, upd)
            out.append([np.asarray(params[f"p{i}"]) for i in range(len(shapes))])
        return out, state

    want, state = run_optax(grads[:8])
    assert float(np.asarray(state.acc_grads["p1"])[2]) != float(
        np.asarray(state.acc_grads["p1"])[2])  # optax: NaN stays in the accumulator
    want_after, _ = run_optax(grads[:6] + grads[8:])

    params = [T(p.copy()) for p in p0]
    opt = Optimizer(params, cfg, updates_per_epoch=2)
    results = []
    for i, g in enumerate(grads):
        results.append(opt.update([T(a) for a in g]))
        target = want[i] if i < 8 else want_after[i - 2]
        for got, w in zip(params, target):
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-7,
                                       err_msg=f"micro-step {i}")
    assert results == [None, True, None, True, None, True, None, False, None, True]
    assert opt.count == 4 and opt.n_skipped == 1
    assert opt.lr() == pytest.approx(0.05 * 0.5 ** 2)
    norms = [np.sqrt(sum(float((((a + b) / 2) ** 2).sum()) for a, b in zip(*grads[i:i + 2])))
             for i in (0, 2, 4)]
    assert min(norms) > 1.0  # every applied mean was clipped
