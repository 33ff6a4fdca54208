"""Ops of the PyTorch port against the JAX package's: se3, segment,
sinkhorn, kabsch, the bilinear lookups and the shear warp. The same numpy
inputs (seeded) go to both; float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu.ops import bilinear as jbil
from pcaccumulation_tpu.ops.kabsch import weighted_kabsch as j_weighted_kabsch
from pcaccumulation_tpu.ops import se3 as jse3
from pcaccumulation_tpu.ops import segment as jseg
from pcaccumulation_tpu.ops import sinkhorn as jsink
from pcaccumulation_tpu_torch.ops import bilinear as tbil
from pcaccumulation_tpu_torch.ops import kabsch as tkabsch
from pcaccumulation_tpu_torch.ops import se3 as tse3
from pcaccumulation_tpu_torch.ops import segment as tseg
from pcaccumulation_tpu_torch.ops import sinkhorn as tsink

T = torch.from_numpy


def _poses(rng, shape):
    """Random rigid transforms [..., 4, 4] (yaw + small roll/pitch)."""
    out = np.tile(np.eye(4, dtype=np.float32), shape + (1, 1))
    for idx in np.ndindex(*shape):
        a, b, c = rng.normal(size=3) * np.array([0.5, 0.05, 0.05])
        rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)], [0, np.sin(c), np.cos(c)]])
        out[idx][:3, :3] = rz @ ry @ rx
        out[idx][:3, 3] = rng.normal(size=3) * 2.0
    return out


def test_se3_ops(rng):
    poses = _poses(rng, (2, 4))
    pts = rng.normal(size=(2, 50, 3)).astype(np.float32) * 5
    tid = rng.integers(0, 4, size=(2, 50)).astype(np.int32)
    np.testing.assert_allclose(
        tse3.ego_motion_compensation(T(pts), T(tid), T(poses)).numpy(),
        np.asarray(jse3.ego_motion_compensation(pts, tid, poses)), atol=1e-5)
    np.testing.assert_allclose(tse3.transform_inverse(T(poses)).numpy(),
                               np.asarray(jse3.transform_inverse(poses)), atol=1e-5)
    np.testing.assert_allclose(tse3.relative_pose(T(poses[:, 1:]), T(poses[:, :1])).numpy(),
                               np.asarray(jse3.relative_pose(poses[:, 1:], poses[:, :1])),
                               atol=1e-5)
    np.testing.assert_allclose(tse3.apply_transform(T(pts[:, None]), T(poses)).numpy(),
                               np.asarray(jse3.apply_transform(pts[:, None], poses)), atol=1e-4)
    rot = poses[..., :3, :3]
    q = tse3.matrix_to_quat(T(rot))
    np.testing.assert_allclose(q.numpy(), np.asarray(jse3.matrix_to_quat(rot)), atol=1e-6)
    np.testing.assert_allclose(tse3.quat_to_matrix(q).numpy(), rot, atol=1e-5)
    np.testing.assert_allclose(
        tse3.rotation_error_deg(T(rot[:, 1:]), T(rot[:, :1])).numpy(),
        np.asarray(jse3.rotation_error_deg(rot[:, 1:], rot[:, :1])), atol=1e-3)
    inst = rng.integers(0, 3, size=(2, 50)).astype(np.int32)
    ipose = _poses(rng, (2, 3, 4))
    np.testing.assert_allclose(
        tse3.reconstruct_sequence(T(pts), T(tid), T(inst), T(ipose)).numpy(),
        np.asarray(jse3.reconstruct_sequence(pts, tid, inst, ipose)), atol=1e-5)


def test_segment_ops(rng):
    n, s, c = 400, 37, 6
    data = rng.normal(size=(n, c)).astype(np.float32)
    ids = rng.integers(-2, s + 2, size=n).astype(np.int32)  # some out of range
    valid = rng.random(n) < 0.8
    for name in ("masked_segment_sum", "masked_segment_max", "masked_segment_mean"):
        got = getattr(tseg, name)(T(data), T(ids), T(valid), s).numpy()
        want = np.asarray(getattr(jseg, name)(data, ids, valid, s))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
    # wide segment counts take the scatter path on the JAX side
    ids_w = rng.integers(0, 300, size=n).astype(np.int32)
    np.testing.assert_allclose(
        tseg.masked_segment_sum(T(data), T(ids_w), T(valid), 300).numpy(),
        np.asarray(jseg.masked_segment_sum(data, ids_w, valid, 300)), rtol=1e-5, atol=1e-5)
    sorted_ids = np.sort(ids_w)
    np.testing.assert_array_equal(
        tseg.masked_seg_pool_max(T(data), T(sorted_ids), T(valid)).numpy(),
        np.asarray(jseg.masked_seg_pool_max(data, sorted_ids, valid, 300)))


@pytest.mark.parametrize("s_cap", [16, 50])
def test_compact_mask_indices_and_take_rows(rng, s_cap):
    mask = rng.random((2, 50)) < 0.5
    mask[1] = False  # an empty row
    sel, sel_valid = tseg.compact_mask_indices(T(mask), s_cap)
    jsel, jvalid = jseg.compact_mask_indices(jnp.asarray(mask), s_cap)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(sel_valid.numpy(), np.asarray(jvalid))
    arr = rng.normal(size=(2, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(tseg.take_rows_unique(T(arr), sel).numpy(),
                                  np.asarray(jseg.take_rows_unique(arr, jsel)))


def test_pillar_stats_matches(rng):
    from pcaccumulation_tpu.models.pillar_encoder import pillar_stats as jstats
    from pcaccumulation_tpu_torch.models.pillar_encoder import pillar_stats as tstats

    b, n, m = 2, 300, 40
    pts = rng.normal(size=(b, n, 3)).astype(np.float32)
    fb = rng.integers(0, 2, size=(b, n)).astype(np.int32)
    valid = rng.random((b, n)) < 0.9
    p2v = np.sort(rng.integers(0, m + 1, size=(b, n)), axis=1).astype(np.int32)
    mean, fbp = tstats(T(pts), T(fb), T(valid), T(p2v), m)
    jmean, jfbp = jstats(pts, fb, valid, p2v, m)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(fbp.numpy(), np.asarray(jfbp))


def test_sinkhorn_and_square_distance(rng):
    a = rng.normal(size=(2, 3, 20, 8)).astype(np.float32)
    b = rng.normal(size=(2, 3, 24, 8)).astype(np.float32)
    for normalised in (False, True):
        np.testing.assert_allclose(
            tsink.square_distance(T(a), T(b), normalised).numpy(),
            np.asarray(jsink.square_distance(a, b, normalised)), rtol=1e-5, atol=1e-5)
    la = rng.normal(size=(2, 3, 20, 24)).astype(np.float32) * 3
    for slack in (True, False):
        np.testing.assert_allclose(
            tsink.log_sinkhorn(T(la), 3, slack).numpy(),
            np.asarray(jsink.log_sinkhorn(jnp.asarray(la), 3, slack)), rtol=1e-5, atol=1e-5)


def test_weighted_kabsch_matches_and_ignores_svd_signs(rng):
    poses = _poses(rng, (4,))
    xs = rng.normal(size=(4, 64, 3)).astype(np.float32) * 3
    xt = np.einsum("bij,bnj->bni", poses[:, :3, :3], xs) + poses[:, None, :3, 3]
    xt = (xt + rng.normal(size=xt.shape) * 0.01).astype(np.float32)
    w = rng.random((4, 64)).astype(np.float32)
    rot, trans = tkabsch.weighted_kabsch(T(xs), T(xt), T(w))
    jrot, jtrans = j_weighted_kabsch(jnp.asarray(xs), jnp.asarray(xt), jnp.asarray(w))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), atol=1e-5)
    np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans), atol=1e-4)
    # flip the signs of singular vector pairs: the det correction gives
    # the same rotation
    real_svd = torch.linalg.svd

    def flipped_svd(a, full_matrices=False):
        u, s, vt = real_svd(a, full_matrices=full_matrices)
        sign = torch.tensor([-1.0, 1.0, -1.0])
        return u * sign, s, vt * sign[:, None]

    torch.linalg.svd = flipped_svd
    try:
        rot2, trans2 = tkabsch.weighted_kabsch(T(xs), T(xt), T(w))
    finally:
        torch.linalg.svd = real_svd
    np.testing.assert_allclose(rot2.numpy(), rot.numpy(), atol=1e-6)
    np.testing.assert_allclose(trans2.numpy(), trans.numpy(), atol=1e-5)


def test_bilinear_lookups(rng):
    b, t, h, w, c, n = 2, 3, 16, 20, 5, 120
    fm = rng.normal(size=(b, h, w, c)).astype(np.float32)
    pts = ((rng.random((b, n, 2)) - 0.5) * 9.0).astype(np.float32)  # some outside
    for pad in ("zeros", "border"):
        got = tbil.ungrid(T(fm), T(pts), -4.0, pad).numpy()
        want = np.asarray(jax.vmap(lambda f, p: jbil.ungrid(f, p, -4.0, pad))(fm, pts))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=pad)
    feats = rng.normal(size=(b, t, h, w, c)).astype(np.float32)
    tid = rng.integers(0, t, size=(b, n)).astype(np.int32)
    want = np.asarray(jax.vmap(lambda f, p, i: jbil.temporal_ungrid(f, p, i, -4.0))(
        feats, pts, tid))
    np.testing.assert_allclose(tbil.temporal_ungrid(T(feats), T(pts), T(tid), -4.0).numpy(),
                               want, atol=1e-5)
    folded = np.ascontiguousarray(feats.transpose(0, 2, 3, 1, 4).reshape(b, h, w, t * c))
    np.testing.assert_allclose(
        tbil.temporal_ungrid_folded(T(folded), T(pts), T(tid), -4.0, t).numpy(), want,
        atol=1e-5)


def test_scatter_gather_bev(rng):
    b, m, c, size = 2, 30, 4, 100
    feats = rng.normal(size=(b, m, c)).astype(np.float32)
    idx = np.stack([rng.permutation(size)[:m] for _ in range(b)]).astype(np.int32)
    valid = rng.random((b, m)) < 0.7
    canvas = tbil.scatter_bev(T(feats), T(idx), T(valid), size)
    want = np.asarray(jax.vmap(lambda f, i, v: jbil.scatter_bev(f, i, v, size))(
        feats, idx, valid))
    np.testing.assert_array_equal(canvas.numpy(), want)
    np.testing.assert_array_equal(
        tbil.gather_bev(canvas, T(idx), T(valid)).numpy(),
        np.asarray(jax.vmap(jbil.gather_bev)(want, idx, valid)))


def test_warp_bev_folded_matches_jax(rng):
    """Three shear passes over a folded [B, H, W, T*C] canvas; frame 0 has
    the identity pose and passes through."""
    b, t, h, w, c = 2, 4, 24, 24, 4
    bevf = rng.normal(size=(b, h, w, t * c)).astype(np.float32)
    poses = _poses(rng, (b, t))
    poses[:, 0] = np.eye(4, dtype=np.float32)
    args = (0.25, 0.25, -3.0, -3.0)
    got = tbil.warp_bev_folded(T(bevf), T(poses), *args).numpy()
    want = np.asarray(jbil.warp_bev_folded(jnp.asarray(bevf), jnp.asarray(poses), *args))
    # the two pose inverses round differently: the shifts move by ~1e-6 px,
    # which a unit-variance noise image turns into ~1e-5
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got[..., :c], bevf[..., :c], atol=1e-5)
