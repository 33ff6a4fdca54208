"""Kernel K4 (nearest neighbour), the Chamfer distance, ICP and kernel K3
(the warp_bev row shift) of the PyTorch port.

CPU: the port's plain versions against the JAX package's functions on the
same numpy inputs (its Pallas kernel `_row_shift_pallas` in interpret mode,
its `nn_bruteforce_ref` where JAX's CPU path runs it). CUDA (marked `cuda`,
skipped without a card): the K4 and K3 kernels against their plain versions
on the card. JAX is imported inside the CPU tests, so on a machine without
it the CUDA tests run with
    python -m pytest --noconftest -m cuda tests/test_torch_icp.py
"""

import numpy as np
import pytest
import torch

from pcaccumulation_tpu_torch.kernels.chamfer import (
    chamfer_distance,
    nn,
    nn_packed,
    nn_plain,
    pack_queries,
    pack_references,
)
from pcaccumulation_tpu_torch.kernels.row_shift import (
    row_shift,
    row_shift_backward,
    row_shift_blocks_plain,
)
from pcaccumulation_tpu_torch.ops import icp as ticp
from pcaccumulation_tpu_torch.ops.bilinear import warp_bev, warp_bev_batch


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nn_case(kind: str, seed: int = 0, p: int = 3, n: int = 300, m: int = 400):
    """Queries and references in a 10 m box; masks, all refs invalid in
    one problem, exact ties (duplicated references, queries on them), or
    per-problem counts that take one slice of K4, several and none in one
    call ("slices")."""
    rng = np.random.default_rng(seed)
    a = (rng.random((p, n, 3)) * 10).astype(np.float32)
    b = (rng.random((p, m, 3)) * 10).astype(np.float32)
    valid = rng.random((p, m)) < 0.6
    if kind == "all_invalid":
        valid[1] = False
    if kind == "ties":
        b[:, 200:260] = b[:, 20:80]      # duplicates: the lower index must win
        a[:, :60] = b[:, 20:80]          # queries exactly on them (distance 0)
        valid[:, 20:80] = valid[:, 200:260] = True
        valid[:, 120] = True
        b[:, 130] = b[:, 120]            # an invalid duplicate after a valid one
        valid[:, 130] = False
    if kind == "slices":
        valid[0, 1000:] = False
        valid[1] = True
        if p > 2:
            valid[-1] = False
    return a, b, valid


@pytest.mark.parametrize("kind", ["masks", "all_invalid", "ties"])
def test_nn_plain_matches_jax_ref(kind, record_property):
    """The plain version computes nn_bruteforce_ref's formula: the same
    distances (float32 rounding of |a|^2 + |b|^2 - 2 a.b, tolerance 1e-5
    in a 10 m box where |a|^2 <= 300) and the same first-index argmins; no
    valid reference gives 1e30 and index 0."""
    import jax.numpy as jnp

    from pcaccumulation_tpu.kernels.chamfer import nn_bruteforce_ref

    a, b, valid = _nn_case(kind)
    before = nn.launches
    d2, idx = nn(T(a), T(b), T(valid))  # a CPU tensor: the plain version
    assert nn.launches == before
    for p in range(a.shape[0]):
        want_d, want_i = nn_bruteforce_ref(jnp.asarray(a[p]), jnp.asarray(b[p]),
                                           jnp.asarray(valid[p]))
        np.testing.assert_array_equal(idx[p].numpy(), np.asarray(want_i))
        np.testing.assert_allclose(d2[p].numpy(), np.asarray(want_d), rtol=0, atol=1e-5)
        record_property(f"max_abs_err.d2.{p}", float(np.abs(d2[p].numpy() - want_d).max()))
    if kind == "all_invalid":
        assert (d2[1] == 1e30).all() and (idx[1] == 0).all()
    if kind == "ties":
        np.testing.assert_array_equal(idx[:, :60].numpy(), np.arange(20, 80)[None].repeat(3, 0))
    # the blocked plain version equals one block
    d2_small, idx_small = (x.numpy() for x in nn_plain(T(a), T(b), T(valid)))
    np.testing.assert_array_equal(idx_small, idx.numpy())


def _query_mask(a, seed=12):
    """About half the queries asked for; in problem 0 none, in problem 2 all."""
    valid = np.random.default_rng(seed).random(a.shape[:2]) < 0.5
    valid[0] = False
    valid[-1] = True
    return valid


@pytest.mark.parametrize("kind", ["masks", "all_invalid", "ties"])
def test_nn_query_mask_matches_unmasked(kind):
    """`a_valid` on the CPU: the queries not asked for are (1e30, 0), the
    others equal the unmasked call bit for bit."""
    a, b, valid = _nn_case(kind)
    a_valid = _query_mask(a)
    d2, idx = nn(T(a), T(b), T(valid))
    d2_m, idx_m = nn(T(a), T(b), T(valid), T(a_valid))
    mask = T(a_valid)
    assert torch.equal(d2_m[mask], d2[mask]) and torch.equal(idx_m[mask], idx[mask])
    assert bool((d2_m[~mask] == 1e30).all()) and bool((idx_m[~mask] == 0).all())
    d2_p, idx_p = nn_plain(T(a), T(b), T(valid), T(a_valid))
    assert torch.equal(d2_p, d2_m) and torch.equal(idx_p, idx_m)


@pytest.mark.parametrize("masked", [False, True], ids=["all_queries", "query_mask"])
def test_nn_packed_once_matches_per_call_packing(masked):
    """References (and queries) packed once and reused for other queries,
    as ICP does across its iterations, give what per-call packing gives."""
    a, b, valid = _nn_case("ties")
    a_valid = T(_query_mask(a)) if masked else None
    refs = pack_references(T(b), T(valid))
    queries = pack_queries(a_valid) if masked else None
    for step in range(3):
        moved = T(a + 0.1 * step)
        got = nn_packed(moved, refs, queries)
        want = nn(moved, T(b), T(valid), a_valid)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_nn_checks_shapes():
    a, b, valid = _nn_case("masks")
    with pytest.raises(ValueError, match="nn wants"):
        nn(T(a[0]), T(b[0]), T(valid[0]))


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_chamfer_distance_value_and_grad_match_jax(batched, record_property):
    """chamfer_distance and its gradient (the scatter through the argmins)
    against the JAX package's custom VJP under jax.grad, for a weighted sum
    of both directions; float32 rounding, tolerance 1e-5."""
    import jax
    import jax.numpy as jnp

    from pcaccumulation_tpu.kernels.chamfer import chamfer_distance as jchamfer

    rng = np.random.default_rng(1)
    p = 3 if batched else 1
    a = (rng.random((p, 200, 3)) * 5).astype(np.float32)
    b = (rng.random((p, 250, 3)) * 5).astype(np.float32)
    av, bv = rng.random((p, 200)) < 0.8, rng.random((p, 250)) < 0.7
    wa, wb = rng.random((p, 200)).astype(np.float32), rng.random((p, 250)).astype(np.float32)

    def jloss(a_, b_, i):
        da, db = jchamfer(a_, b_, jnp.asarray(av[i]), jnp.asarray(bv[i]))
        return jnp.sum(da * wa[i]) + jnp.sum(db * wb[i])

    ta, tb = T(a).requires_grad_(True), T(b).requires_grad_(True)
    if batched:
        da, db = chamfer_distance(ta, tb, T(av), T(bv))
    else:
        da, db = (x[None] for x in chamfer_distance(ta[0], tb[0], T(av[0]), T(bv[0])))
    ((da * T(wa)).sum() + (db * T(wb)).sum()).backward()
    for i in range(p):
        want_a, want_b = jchamfer(jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(av[i]),
                                  jnp.asarray(bv[i]))
        np.testing.assert_allclose(da[i].detach().numpy(), np.asarray(want_a), atol=1e-5)
        np.testing.assert_allclose(db[i].detach().numpy(), np.asarray(want_b), atol=1e-5)
        ga, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a[i]), jnp.asarray(b[i]), i)
        np.testing.assert_allclose(ta.grad[i].numpy(), np.asarray(ga), atol=1e-5)
        np.testing.assert_allclose(tb.grad[i].numpy(), np.asarray(gb), atol=1e-5)
        record_property(f"max_abs_err.{i}", max(
            float(np.abs(da[i].detach().numpy() - want_a).max()),
            float(np.abs(db[i].detach().numpy() - want_b).max()),
            float(np.abs(ta.grad[i].numpy() - ga).max()),
            float(np.abs(tb.grad[i].numpy() - gb).max())))
    assert (da[~T(av)] == 0).all() and (db[~T(bv)] == 0).all()


def _zrot(deg, trans):
    from scipy.spatial.transform import Rotation

    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = Rotation.from_euler("z", deg, degrees=True).as_matrix()
    p[:3, 3] = trans
    return p


# ICP tolerances: float32 on both sides; the Kabsch SVDs and the per-
# iteration products round differently in the two frameworks, ~1e-6 per
# iteration in the pose entries (translations of a few metres)
ICP_TOL = 2e-5


def test_icp_point_to_point_matches_jax(record_property):
    """Three problems in one batch: a perturbed cloud, a wrong init pose,
    and one with only two valid source points (the pose is held)."""
    import jax.numpy as jnp

    from pcaccumulation_tpu.ops.icp import icp_point_to_point as jicp

    rng = np.random.default_rng(2)
    tgt = (rng.random((3, 300, 3)) * 6).astype(np.float32)
    src = np.stack([(tgt[i] - [0.1, -0.05, 0.0]) @ _zrot(3.0 * i, [0, 0, 0])[:3, :3]
                    for i in range(3)]).astype(np.float32)
    src_valid = rng.random((3, 300)) < 0.9
    src_valid[2] = False
    src_valid[2, :2] = True
    tgt_valid = rng.random((3, 300)) < 0.8
    init = np.stack([np.eye(4, dtype=np.float32), _zrot(1.0, [0.3, 0, 0]),
                     np.eye(4, dtype=np.float32)])
    got = ticp.icp_point_to_point(T(src), T(tgt), T(src_valid), T(tgt_valid), T(init),
                                  threshold=0.5, max_iterations=8).numpy()
    for i in range(3):
        want = np.asarray(jicp(jnp.asarray(src[i]), jnp.asarray(tgt[i]),
                               jnp.asarray(src_valid[i]), jnp.asarray(tgt_valid[i]),
                               init_pose=jnp.asarray(init[i]), threshold=0.5,
                               max_iterations=8))
        np.testing.assert_allclose(got[i], want, atol=ICP_TOL, err_msg=f"problem {i}")
        record_property(f"max_abs_err.{i}", float(np.abs(got[i] - want).max()))
    np.testing.assert_array_equal(got[2], init[2])  # < 3 valid sources: held
    assert np.abs(got[0] - init[0]).max() > 1e-2     # the others moved


def _icp_every_query(src, tgt, src_valid, tgt_valid, init_pose, threshold, max_iterations):
    """`icp_point_to_point` without the query mask: every source's nearest
    neighbour, references packed on every iteration."""
    from pcaccumulation_tpu_torch.ops import se3
    from pcaccumulation_tpu_torch.ops.kabsch import weighted_kabsch

    eye = torch.eye(4).expand(src.shape[0], 4, 4)
    pose = eye
    src_t = se3.apply_transform(src, init_pose)
    w_valid = src_valid.to(src.dtype)
    for _ in range(max_iterations):
        d2, idx = nn(src_t, tgt, tgt_valid)
        w = (d2 < threshold * threshold).to(src.dtype) * w_valid
        matched = torch.gather(tgt, 1, idx.long()[..., None].expand(src_t.shape))
        rot, trans = weighted_kabsch(src_t, matched, w)
        delta = torch.where((w.sum(-1) >= 3)[:, None, None], se3.make_transform(rot, trans), eye)
        pose = se3.compose(delta, pose)
        src_t = se3.apply_transform(src_t, delta)
    ok = (src_valid.sum(-1) >= 3) & (tgt_valid.sum(-1) >= 3)
    return torch.where(ok[:, None, None], se3.compose(pose, init_pose), init_pose)


@pytest.mark.parametrize("seed", [2, 13])
def test_icp_query_mask_equals_every_query(seed):
    """ICP with the query mask and the references packed once is bit for
    bit ICP over every query: an invalid source has weight 0 either way,
    and its matched row adds exact zeros to the Kabsch sums."""
    rng = np.random.default_rng(seed)
    tgt = (rng.random((4, 300, 3)) * 6 - 3).astype(np.float32)
    src = (tgt + rng.normal(scale=0.05, size=tgt.shape)).astype(np.float32)
    src_valid = rng.random((4, 300)) < 0.4
    src_valid[3] = False
    tgt_valid = rng.random((4, 300)) < 0.7
    init = np.stack([_zrot(2.0 * i, [0.1 * i, 0.0, 0.0]) for i in range(4)])
    args = (T(src), T(tgt), T(src_valid), T(tgt_valid), T(init))
    got = ticp.icp_point_to_point(*args, threshold=0.3, max_iterations=6)
    want = _icp_every_query(*args, threshold=0.3, max_iterations=6)
    assert torch.equal(got, want)
    assert float((got[:3] - T(init[:3])).abs().max()) > 1e-3  # the poses moved


def test_refine_ego_poses_matches_jax(record_property):
    """B=2 sequences of 3 frames, perturbed frame -> anchor poses, the
    background mask dropping a fifth of the points; frame 0 untouched."""
    import jax.numpy as jnp

    from pcaccumulation_tpu.ops.icp import refine_ego_poses as jref

    rng = np.random.default_rng(3)
    gt = [np.eye(4, dtype=np.float32), _zrot(3.0, [0.4, -0.2, 0.0]),
          _zrot(-2.0, [0.1, 0.5, 0.0])]
    points, tids = [], []
    for _ in range(2):
        anchor = (rng.random((200, 3)) * 10).astype(np.float32)
        pts = [anchor] + [(anchor @ np.linalg.inv(g)[:3, :3].T + np.linalg.inv(g)[:3, 3])
                          for g in gt[1:]]
        points.append(np.concatenate(pts).astype(np.float32))
        tids.append(np.repeat(np.arange(3), 200).astype(np.int32))
    points, tids = np.stack(points), np.stack(tids)
    valid = np.ones_like(tids, bool)
    bg = rng.random(tids.shape) < 0.8
    poses = np.stack([np.stack([np.eye(4, dtype=np.float32), _zrot(4.0, [0.5, -0.3, 0.0]),
                                _zrot(-3.0, [0.0, 0.4, 0.0])])] * 2)
    got = ticp.refine_ego_poses(T(points), T(tids), T(valid), T(bg), T(poses), threshold=0.5,
                                max_iterations=6).numpy()
    want = np.asarray(jref(jnp.asarray(points), jnp.asarray(tids), jnp.asarray(valid),
                           jnp.asarray(bg), jnp.asarray(poses), threshold=0.5,
                           max_iterations=6))
    np.testing.assert_allclose(got, want, atol=ICP_TOL)
    record_property("max_abs_err", float(np.abs(got - want).max()))
    np.testing.assert_array_equal(got[:, 0], poses[:, 0])
    assert np.abs(got[:, 1:] - poses[:, 1:]).max() > 1e-2


def test_refine_instance_poses_matches_jax(record_property):
    """4 instance slots over 3 frames: slot 1 has 400 members, more than
    max_points (128), so only its first 128 in index order take part (the
    JAX package's stable top_k); slot 0 is empty and keeps its pose."""
    import jax.numpy as jnp

    from pcaccumulation_tpu.ops.icp import refine_instance_poses as jref

    rng = np.random.default_rng(4)
    n = 900
    points = (rng.random((n, 3)) * 4).astype(np.float32)
    tid = rng.integers(0, 3, n).astype(np.int32)
    gid = np.where(np.arange(n) < 400, 1, rng.integers(2, 4, n)).astype(np.int32)
    valid = rng.random(n) < 0.9
    pose = np.broadcast_to(np.eye(4, dtype=np.float32), (4, 3, 4, 4)).copy()
    pose[1:, 1] = _zrot(2.0, [0.2, 0.1, 0.0])
    pose[1:, 2] = _zrot(-1.0, [0.0, -0.15, 0.0])
    got = ticp.refine_instance_poses(T(points), T(tid), T(gid), T(valid), T(pose),
                                     threshold=0.6, max_iterations=6, max_points=128).numpy()
    want = np.asarray(jref(jnp.asarray(points), jnp.asarray(tid), jnp.asarray(gid),
                           jnp.asarray(valid), jnp.asarray(pose), threshold=0.6,
                           max_iterations=6, max_points=128))
    np.testing.assert_allclose(got, want, atol=ICP_TOL)
    record_property("max_abs_err", float(np.abs(got - want).max()))
    np.testing.assert_array_equal(got[0], pose[0])
    assert np.abs(got[1] - pose[1]).max() > 1e-3


def _row_shift_case(seed, r=16, w=32, c=8):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(r, w, c)).astype(np.float32)
    shifts = ((rng.random(r) - 0.5) * 2.5 * w).astype(np.float32)
    shifts[0] = 0.0           # pass-through
    shifts[1] = -(w + 7.25)   # |k| > W: clipped
    shifts[2] = w + 3.5
    shifts[3] = -2.0          # integer shift
    return img, shifts


def test_row_shift_plain_matches_pallas_interpret(record_property):
    """K3: the port's one-shift-per-row shift (K2's plain version at
    n_blocks=1 on the CPU) against `_row_shift_pallas` in interpret mode."""
    import jax.numpy as jnp

    from pcaccumulation_tpu.ops.bilinear import _row_shift_pallas

    img, shifts = _row_shift_case(5)
    w = img.shape[1]
    k = np.floor(shifts)
    ki = np.clip(k.astype(np.int32), -w, w)
    f = (shifts - k).astype(np.float32)
    want = np.asarray(_row_shift_pallas(jnp.asarray(img), jnp.asarray(ki), jnp.asarray(f),
                                        interpret=True))
    before = row_shift.launches
    got = row_shift(T(img), T(shifts)).numpy()
    assert row_shift.launches == before
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    record_property("max_abs_err", float(np.abs(got - want).max()))
    np.testing.assert_array_equal(got[0], img[0])


def _warp_case(f=3, h=24, w=20, c=4):
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(f, h, w, c)).astype(np.float32)
    poses = np.stack([_zrot(deg, [dx, dy, 0.0]) for deg, dx, dy in
                      [(0.0, 0.0, 0.0), (7.0, 0.6, -0.4), (-25.0, -1.1, 0.3)][:f]])
    return feats, poses


# warp tolerance: the shear parameters come from differences of pixel
# coordinates of ~size/2 (float32 rounding ~1e-6 px there), and the two
# frameworks invert the pose and take tan/atan2 with other roundings: the
# shifts differ by up to ~1e-5 px, times neighbour differences of up to ~5
# for unit-normal features
WARP_TOL = 1e-4


@pytest.mark.parametrize("method", ["shear", "gather"])
def test_warp_bev_and_batch_match_jax(method, record_property):
    import jax.numpy as jnp

    from pcaccumulation_tpu.ops.bilinear import warp_bev as jwarp
    from pcaccumulation_tpu.ops.bilinear import warp_bev_batch as jwarp_batch

    feats, poses = _warp_case()
    args = (0.25, 0.25, -2.5, -3.0)  # x_min = -W*reso/2, y_min = -H*reso/2
    got_b = warp_bev_batch(T(feats), T(poses), *args, method=method).numpy()
    want_b = np.asarray(jwarp_batch(jnp.asarray(feats), jnp.asarray(poses), *args,
                                    method=method))
    np.testing.assert_allclose(got_b, want_b, atol=WARP_TOL)
    record_property("max_abs_err.batch", float(np.abs(got_b - want_b).max()))
    for i in range(feats.shape[0]):
        got = warp_bev(T(feats[i]), T(poses[i]), *args, method=method).numpy()
        want = np.asarray(jwarp(jnp.asarray(feats[i]), jnp.asarray(poses[i]), *args,
                                method=method))
        np.testing.assert_allclose(got, want, atol=WARP_TOL, err_msg=f"map {i}")
    assert np.abs(got_b[0] - feats[0]).max() < 1e-4   # the identity passes through
    assert np.abs(got_b[2] - feats[2]).max() > 0.1


def test_warp_bev_gradient_is_the_shift_at_minus_shifts():
    """The K3 gradient (`RowShift`): the image cotangent shifted back,
    the JAX package's custom VJP, against jax.vjp of `_row_shift_sample`."""
    import jax
    import jax.numpy as jnp

    from pcaccumulation_tpu.ops.bilinear import _row_shift_sample

    img, shifts = _row_shift_case(7)
    g = np.random.default_rng(8).normal(size=img.shape).astype(np.float32)
    ti = T(img).requires_grad_(True)
    ts = T(shifts).requires_grad_(True)
    row_shift(ti, ts).backward(T(g))
    _, vjp = jax.vjp(_row_shift_sample, jnp.asarray(img), jnp.asarray(shifts))
    want_i, want_s = vjp(jnp.asarray(g))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want_i), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ts.grad.numpy(), np.asarray(want_s))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _nn_tolerance(a, b, idx):
    """The plain version's rounding: ~4 ulp of |a|^2 + |b|^2 (its
    expansion), the kernel's difference form is exact to ~1 ulp of d2."""
    bn = torch.gather(b, 1, idx.long()[..., None].expand(a.shape))
    return 2e-6 * ((a * a).sum(-1) + (bn * bn).sum(-1)) + 1e-7


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["all_queries", "query_mask"])
@pytest.mark.parametrize("kind", ["masks", "all_invalid", "ties", "slices"])
@pytest.mark.parametrize("p,n,m", [(3, 300, 400), (4, 5000, 3000), (128, 1024, 1024),
                                   (2, 3000, 9000)])
def test_nn_kernel_matches_plain(cuda, kind, p, n, m, masked):
    """One launch; distances within the plain version's rounding; the
    argmins equal wherever the two candidates are farther apart than that
    (the difference form and the expansion can order a near tie either
    way); exact ties go to the lower index; no valid reference: 1e30, 0;
    with a query mask, the queries not asked for are (1e30, 0). m = 9000
    spreads the references over several blocks, whose minima are merged;
    "slices" mixes, in one call, a problem in one slice (written without
    the merge), one over several and one with none (the grid comes from
    the shapes, each block reads its problem's counts)."""
    a, b, valid = (T(x).to(cuda) for x in _nn_case(kind, seed=9, p=p, n=n, m=m))
    a = a * 5.0 + 20.0  # up to 70 m from the origin
    b = b * 5.0 + 20.0
    a_valid = T(_query_mask(a.cpu().numpy())).to(cuda) if masked else None
    if masked and kind == "ties":
        a_valid[:, :60] = True  # the queries on duplicated references
    before = nn.launches
    d2, idx = nn(a, b, valid, a_valid)
    assert nn.launches == before + 1
    want_d, want_i = nn_plain(a, b, valid, a_valid)
    if masked:
        assert bool((d2[~a_valid] == 1e30).all()) and bool((idx[~a_valid] == 0).all())
        assert torch.equal(want_d[~a_valid], d2[~a_valid])
    tol = _nn_tolerance(a, b, want_i)
    assert bool(((d2 - want_d).abs() <= tol).all())

    def exact(i):
        nearest = torch.gather(b, 1, i.long()[..., None].expand(a.shape))
        return ((a.double() - nearest.double()) ** 2).sum(-1)

    differ = idx != want_i
    assert bool(((exact(idx) - exact(want_i)).abs()[differ] <= tol[differ]).all())
    if kind == "all_invalid":
        assert bool((d2[1] == 1e30).all()) and bool((idx[1] == 0).all())
    if kind == "ties":
        want = torch.arange(20, 80, device=cuda, dtype=torch.int32)
        assert torch.equal(idx[:, :60], want[None].expand(idx.shape[0], 60))


@pytest.mark.cuda
def test_chamfer_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(10)
    a = (rng.random((2, 3000, 3)) * 20).astype(np.float32)
    b = (rng.random((2, 2500, 3)) * 20).astype(np.float32)
    av, bv = rng.random((2, 3000)) < 0.9, rng.random((2, 2500)) < 0.9
    out = {}
    for dev in ("cpu", cuda):
        ta, tb = T(a).to(dev).requires_grad_(True), T(b).to(dev).requires_grad_(True)
        da, db = chamfer_distance(ta, tb, T(av).to(dev), T(bv).to(dev))
        (da.sum() + 2 * db.sum()).backward()
        out[str(dev)] = [x.detach().cpu() for x in (da, db, ta.grad, tb.grad)]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("r,w,c", [(16, 32, 8), (4 * 288, 288, 32), (4 * 288, 288, 9)])
def test_row_shift_kernel_matches_plain(cuda, r, w, c):
    """K3: one launch of the K2 kernel at n_blocks=1; its gradient another."""
    img, shifts = _row_shift_case(11, r=r, w=w, c=c)
    it = T(img).to(cuda).requires_grad_(True)
    st = T(shifts).to(cuda)
    before = row_shift.launches, row_shift_backward.launches
    got = row_shift(it, st)
    g = torch.randn(got.shape, device=cuda)
    got.backward(g)
    assert (row_shift.launches, row_shift_backward.launches) == (before[0] + 1, before[1] + 1)
    k = torch.floor(st)
    want = row_shift_blocks_plain(it.detach(), k.clamp(-w, w).to(torch.int32)[:, None],
                                  (st - k)[:, None], 1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    kn = torch.floor(-st)
    want_g = row_shift_blocks_plain(g, kn.clamp(-w, w).to(torch.int32)[:, None],
                                    (-st - kn)[:, None], 1)
    torch.testing.assert_close(it.grad, want_g, rtol=1e-6, atol=1e-6)
