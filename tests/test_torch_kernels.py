"""Kernels K1 (seg_pool) and K2 (row_shift_blocks) of the PyTorch port.

CPU: the port's plain versions against the JAX package's Pallas kernels run
in interpret mode and against its references, on the same numpy inputs.
CUDA (marked `cuda`, skipped without a card): each kernel and its gradient
against their plain versions on the card. The CUDA tests import no JAX, so on a machine without
it they run with
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from pcaccumulation_tpu_torch.kernels.row_shift import (
    row_shift_blocks,
    row_shift_blocks_backward,
    row_shift_blocks_plain,
)
from pcaccumulation_tpu_torch.kernels.segscan import (
    seg_pool,
    seg_pool_backward,
    seg_pool_backward_plain,
    seg_pool_plain,
)


def _sorted_ids(rng, n, m, long_run_at=None, run_len=0, tail=0):
    """Sorted ids with short runs, an optional long run, and an optional
    final run of `tail` rows (a padded sample's overflow segment)."""
    ids = np.sort(rng.integers(0, m, size=n - tail)).astype(np.int32)
    if long_run_at is not None:
        ids[long_run_at:long_run_at + run_len] = ids[long_run_at]
        ids = np.sort(ids)
    return np.concatenate([ids, np.full(tail, m + 3, np.int32)])


def _k1_case(seed, n=1500, c=32, tail=400):
    rng = np.random.default_rng(seed)
    ids = _sorted_ids(rng, n, 300, long_run_at=200, run_len=600, tail=tail)
    x = rng.standard_normal((n, c)).astype(np.float32)
    x[n - tail:] = -1e30  # masked rows, as the pillar pool feeds them
    return x, ids


def _row_shift_case(seed, nb, r=16, w=32, c=8):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(r, w, nb * c)).astype(np.float32)
    shifts = ((rng.random((r, nb)) - 0.5) * 2.5 * w).astype(np.float32)
    shifts[0, :] = 0.0          # pass-through
    shifts[1, 0] = -(w + 7.25)  # |k| > W: clipped
    shifts[2, -1] = w + 3.5
    shifts[3, :] = -2.0         # integer shift
    return img, shifts


@pytest.fixture(scope="module")
def jax_segscan():
    from pcaccumulation_tpu.kernels import segscan

    return segscan


@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("rblk", [128, 256])
def test_seg_pool_plain_matches_pallas_interpret(jax_segscan, op, rblk):
    """Runs longer than the Pallas block (600 rows > rblk) and a long -1e30
    tail; values exact for max, float32 sum order for sum."""
    import jax.numpy as jnp

    x, ids = _k1_case(0)
    want = np.asarray(jax_segscan._seg_pool_impl(jnp.asarray(x), jnp.asarray(ids), op=op,
                                                 rblk=rblk, interpret=True))
    ref = np.asarray(jax_segscan.seg_pool_ref(jnp.asarray(x), jnp.asarray(ids), op))
    got = seg_pool_plain(torch.from_numpy(x), torch.from_numpy(ids), op).numpy()
    if op == "max":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
    else:
        # float32 sums in another order: relative 1e-5 of the segment's sum|x|
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_seg_pool_cpu_dispatch_and_checks():
    x, ids = _k1_case(1, n=300, c=5, tail=50)
    xt, it = torch.from_numpy(x), torch.from_numpy(ids)
    before = seg_pool.launches
    assert torch.equal(seg_pool(xt, it, "max"), seg_pool_plain(xt, it, "max"))
    assert seg_pool.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="non-decreasing"):
        seg_pool(xt, it.flip(0), "max")
    with pytest.raises(ValueError, match="op"):
        seg_pool(xt, it, "mean")


@pytest.mark.parametrize("nb", [1, 4, 5])
def test_row_shift_plain_matches_pallas_interpret(nb):
    """Negative, fractional, zero and clipped (|k| > W) shifts."""
    import jax.numpy as jnp

    from pcaccumulation_tpu.ops.bilinear import _row_shift_blocks_pallas

    img, shifts = _row_shift_case(nb, nb)
    w = img.shape[1]
    k = np.floor(shifts)
    ki = np.clip(k.astype(np.int32), -w, w)
    f = (shifts - k).astype(np.float32)
    want = np.asarray(_row_shift_blocks_pallas(jnp.asarray(img), jnp.asarray(ki),
                                               jnp.asarray(f), nb, interpret=True))
    got = row_shift_blocks(torch.from_numpy(img), torch.from_numpy(shifts), nb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], img[0])  # zero shift passes through
    plain = row_shift_blocks_plain(torch.from_numpy(img), torch.from_numpy(ki),
                                   torch.from_numpy(f), nb).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1500, 32), (90000, 32), (777, 9), (1000, 128)])
def test_seg_pool_kernel_matches_plain(cuda, n, c):
    x, ids = _k1_case(2, n=n, c=c, tail=n // 3)
    xt, it = torch.from_numpy(x).to(cuda), torch.from_numpy(ids).to(cuda)
    before = seg_pool.launches
    got = seg_pool(xt, it, "max")
    assert seg_pool.launches == before + 1
    assert torch.equal(got, seg_pool_plain(xt, it, "max"))  # max: bit-exact
    body = slice(0, n - n // 3)  # sum without the -1e30 tail
    got_s = seg_pool(xt[body], it[body], "sum")
    want_s = seg_pool_plain(xt[body], it[body], "sum")
    abs_sum = seg_pool_plain(xt[body].abs(), it[body], "sum")
    assert bool(((got_s - want_s).abs() <= 1e-5 * abs_sum + 1e-6).all())


@pytest.mark.cuda
def test_seg_pool_kernel_one_run_over_all_tiles(cuda):
    x = torch.randn((5000, 32), generator=torch.Generator().manual_seed(3)).to(cuda)
    ids = torch.zeros(5000, dtype=torch.int32, device=cuda)
    got = seg_pool(x, ids, "max")
    assert torch.equal(got, x.amax(0, keepdim=True).expand_as(x))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("n,c", [(1500, 32), (90000, 32), (777, 9)])
def test_seg_pool_backward_kernel_matches_plain(cuda, op, n, c):
    """The gradient through SegPool launches K1 once (sum over the [N, 2C]
    pack for max) and matches the plain gradient within 1e-5 of the
    segment's sum of |g|; for max it is exactly zero off the tie set.
    Integer-valued x forces ties."""
    x, ids = _k1_case(5, n=n, c=c, tail=n // 3)
    x[: n - n // 3] = np.round(x[: n - n // 3] * 2)
    g = np.random.default_rng(6).standard_normal((n, c)).astype(np.float32)
    xt, it, gt = (torch.from_numpy(a).to(cuda) for a in (x, ids, g))
    xt.requires_grad_(True)
    y = seg_pool(xt, it, op)
    before = seg_pool_backward.launches
    y.backward(gt)
    assert seg_pool_backward.launches == before + 1
    xd = xt.detach()
    want = seg_pool_backward_plain(xd, it, seg_pool_plain(xd, it, op), gt, op)
    abs_sum = seg_pool_plain(gt.abs(), it, "sum")
    assert bool(((xt.grad - want).abs() <= 1e-5 * abs_sum + 1e-6).all())
    if op == "max":
        off = xd != seg_pool_plain(xd, it, "max")
        assert bool((xt.grad[off] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nb,r,w,c", [(1, 16, 32, 8), (5, 288, 288, 32), (11, 288, 288, 32),
                                      (5, 288, 288, 9)])
def test_row_shift_backward_kernel_matches_plain(cuda, nb, r, w, c):
    """The gradient through RowShift is one K2 launch at -shifts."""
    img, shifts = _row_shift_case(7, nb, r=r, w=w, c=c)
    g = np.random.default_rng(8).standard_normal(img.shape).astype(np.float32)
    it, st, gt = (torch.from_numpy(a).to(cuda) for a in (img, shifts, g))
    it.requires_grad_(True)
    out = row_shift_blocks(it, st, nb)
    before = row_shift_blocks_backward.launches
    out.backward(gt)
    assert row_shift_blocks_backward.launches == before + 1
    k = torch.floor(-st)
    want = row_shift_blocks_plain(gt, k.clamp(-w, w).to(torch.int32), (-st - k), nb)
    torch.testing.assert_close(it.grad, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,r,w,c", [(1, 16, 32, 8), (5, 16, 32, 8), (5, 288, 288, 32),
                                      (11, 288, 288, 32), (5, 288, 288, 9), (3, 40, 1500, 12)])
def test_row_shift_kernel_matches_plain(cuda, nb, r, w, c):
    img, shifts = _row_shift_case(4, nb, r=r, w=w, c=c)
    it, st = torch.from_numpy(img).to(cuda), torch.from_numpy(shifts).to(cuda)
    before = row_shift_blocks.launches
    got = row_shift_blocks(it, st, nb)
    assert row_shift_blocks.launches == before + 1
    k = torch.floor(st)
    want = row_shift_blocks_plain(it, k.clamp(-w, w).to(torch.int32), (st - k), nb)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_row_shift_kernel_on_misaligned_image(cuda):
    """An image that starts 4 bytes past a 16-byte boundary takes the
    kernel's one-channel-per-thread path, with the same result."""
    img, shifts = _row_shift_case(9, 5, r=64, w=96, c=8)
    flat = torch.empty(img.size + 1, device=cuda)
    it = flat[1:].view(img.shape)
    it.copy_(torch.from_numpy(img))
    assert it.data_ptr() % 16 != 0
    st = torch.from_numpy(shifts).to(cuda)
    k = torch.floor(st)
    want = row_shift_blocks_plain(it, k.clamp(-96, 96).to(torch.int32), (st - k), 5)
    torch.testing.assert_close(row_shift_blocks(it, st, 5), want, rtol=1e-6, atol=1e-6)
