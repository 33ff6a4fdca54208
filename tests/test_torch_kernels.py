"""Kernels K1 (seg_pool) and K2 (row_shift_blocks) of the PyTorch port.

CPU: the port's plain versions against the JAX package's Pallas kernels run
in interpret mode and against its references, on the same numpy inputs.
CUDA (marked `cuda`, skipped without a card): each kernel and its gradient
against their plain versions on the card, and the bf16 kernels of K1 and K2
and their bf16 gradients against theirs (the CPU's bf16 tests are in
tests/test_torch_precision.py and tests/test_torch_train_bf16.py). The CUDA
tests import no JAX, so on a machine without
it they run with
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu_torch.kernels.row_shift import (
    row_shift_blocks,
    row_shift_blocks_backward,
    row_shift_blocks_plain,
)
from pcaccumulation_tpu_torch.kernels.segscan import (
    TILE_ROWS,
    TILE_THREADS,
    _scratch,
    scratch_floats,
    seg_pool,
    seg_pool_backward,
    seg_pool_backward_plain,
    seg_pool_plain,
)

SEGSCAN_CU = Path(__file__).resolve().parents[1] / "pcaccumulation_tpu_torch" / "csrc" / "segscan.cu"


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


R = 256  # K1's tile rows (TILE_ROWS)


def _lengths_ids(lengths):
    return np.repeat(np.arange(len(lengths), dtype=np.int32) * 3, lengths)


def _k1_edge_ids(name, rng):
    """Sorted ids at K1's tile edges: N in {1, R-1, R, R+1, 2R+3} with short
    runs, runs ending exactly on tile boundaries and on half-tile
    boundaries, runs of R and R+1 rows (and of 128 and 129), one run
    over all rows, and a sample of 90,000 rows with long runs and a
    40,000-row tail."""
    if name.startswith("n="):
        n = int(name[2:])
        return np.sort(rng.integers(0, n // 3 + 1, size=n)).astype(np.int32)
    if name == "on_tile_edges":
        return _lengths_ids([R, R, 5, R - 5, R + 1, R - 1, 3])
    if name == "runs_R_R+1":
        return _lengths_ids([7, R, R + 1, 1, 2 * R + 9, 30])
    if name == "on_tile_edges_128":
        return _lengths_ids([128, 128, 5, 123, 129, 127, 3, 128, 129])
    if name == "one_run":
        return np.zeros(10 * R + 17, np.int32)
    assert name == "tail_90000"
    lengths = []
    while sum(lengths) < 50000:
        lengths.append(int(rng.integers(300, 3000)) if rng.random() < 0.02
                       else int(rng.integers(1, 12)))
    body = _lengths_ids(lengths)[:50000]
    return np.concatenate([body, np.full(40000, body[-1] + 7, np.int32)])


K1_EDGES = ["n=1", f"n={R - 1}", f"n={R}", f"n={R + 1}", f"n={2 * R + 3}", "on_tile_edges",
            "runs_R_R+1", "on_tile_edges_128", "one_run", "tail_90000"]


def _k1_edge_case(name, c, seed=11):
    """(x, ids, g) at a tile-edge case: x with values rounded to halves on
    every other row (maxima tie), the tail of tail_90000 at -1e30."""
    rng = np.random.default_rng(seed)
    ids = _k1_edge_ids(name, rng)
    n = ids.size
    x = rng.standard_normal((n, c)).astype(np.float32)
    x[::2] = np.round(x[::2] * 2) / 2
    if name == "tail_90000":
        x[n - 40000:] = -1e30
    g = rng.standard_normal((n, c)).astype(np.float32)
    return x, ids, g


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


def _jax_seg_pool_vjp(jax_segscan, op):
    """jax.vjp of the JAX package's seg_pool, jitted: one compile per shape."""
    import jax

    def vjp(x, ids, g):
        return jax.vjp(lambda xj: jax_segscan.seg_pool(xj, ids, op), x)[1](g)[0]

    return jax.jit(vjp)


@pytest.mark.parametrize("name", K1_EDGES)
def test_seg_pool_plain_matches_jax_at_tile_edges(jax_segscan, name):
    """The plain forward (max and sum) and the plain gradient (max with
    ties, and sum) against the JAX package's seg_pool_ref and jax.vjp of
    its seg_pool, at K1's tile edges: max exact, sums within 1e-5 of the
    segment's sum of |.| (float32 order)."""
    import jax.numpy as jnp

    x, ids, g = _k1_edge_case(name, 32)
    xt, it, gt = torch.from_numpy(x), torch.from_numpy(ids), torch.from_numpy(g)
    for op in ("max", "sum"):
        want = np.asarray(jax_segscan.seg_pool_ref(jnp.asarray(x), jnp.asarray(ids), op))
        got = seg_pool_plain(xt, it, op).numpy()
        if op == "max":
            np.testing.assert_array_equal(got, want)
        else:
            abs_sum = seg_pool_plain(xt.abs(), it, "sum").numpy()
            assert np.all(np.abs(got - want) <= 1e-5 * abs_sum + 1e-6)
        want_g = np.asarray(_jax_seg_pool_vjp(jax_segscan, op)(x, ids, g))
        got_g = seg_pool_backward_plain(xt, it, seg_pool_plain(xt, it, op), gt, op).numpy()
        abs_g = seg_pool_plain(gt.abs(), it, "sum").numpy()
        assert np.all(np.abs(got_g - want_g) <= 1e-5 * abs_g + 1e-6), (op, name)
        if op == "max":
            off = x != seg_pool_plain(xt, it, "max").numpy()
            np.testing.assert_array_equal(got_g[off], 0.0)


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
    # what the kernel's wrapper refuses before a launch
    from pcaccumulation_tpu_torch.kernels.segscan import _check_kernel_inputs

    with pytest.raises(TypeError, match="float32"):
        _check_kernel_inputs(it, xt.double())
    with pytest.raises(TypeError, match="int32"):
        _check_kernel_inputs(it.long(), xt)
    huge = torch.zeros(1, 1).expand(2 ** 26, 32)  # 2^31 elements, no memory
    with pytest.raises(ValueError, match="32-bit"):
        _check_kernel_inputs(torch.zeros(2 ** 26, dtype=torch.int32), huge)


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


@pytest.mark.parametrize("n,c", [(1, 32), (255, 9), (256, 32), (257, 32), (120000, 32),
                                 (480000, 32)])
@pytest.mark.parametrize("payload", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_pool_scratch_matches_c_entry(dtype, payload, n, c):
    """The wrapper allocates (`_scratch`) exactly `scratch_floats`, which
    is what the C entry points require: its constants are csrc/segscan.cu's
    (a tile of THREADS / LANES * K rows, a tie word per thread of its
    block), and its two formulas are the source's: `prepare`'s two
    partials and a flag a tile in float32, `bf16_scratch_floats`' two
    partials, the flag and the run bounds a tile, and for the gradient the
    tie words, in bf16 (payload 1: the forward; 2: the gradient of max)."""
    src = SEGSCAN_CU.read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["THREADS"] // const["LANES"] * const["K"] == TILE_ROWS
    assert const["THREADS"] == TILE_THREADS
    assert "if (scratch_floats < 2 * part + a.n_tiles) return (int)cudaErrorInvalidValue;" in src
    assert "return n_tiles * (2LL * payload * c + 2 + (payload == 2 ? THREADS : 0));" in src
    n_tiles = -(-n // TILE_ROWS)
    part = n_tiles * payload * c
    want = (2 * part + 2 * n_tiles + (n_tiles * TILE_THREADS if payload == 2 else 0)
            if dtype == torch.bfloat16 else 2 * part + n_tiles)
    x = torch.empty((n, c), dtype=dtype)
    assert scratch_floats(n, c, dtype, payload) == want
    assert _scratch(x, payload).numel() == want and _scratch(x, payload).dtype == torch.float32


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
@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("n,c", [(1500, 32), (90000, 32), (777, 9)])
def test_seg_pool_backward_kernel_matches_plain(cuda, op, n, c):
    """The gradient through SegPool is one C call (the fused gradient kernel
    for max, the forward's sum for sum) and matches the plain gradient within 1e-5 of the
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
def test_seg_pool_kernel_one_run_over_all_tiles(cuda):
    x = torch.randn((5000, 32), generator=torch.Generator().manual_seed(3)).to(cuda)
    ids = torch.zeros(5000, dtype=torch.int32, device=cuda)
    got = seg_pool(x, ids, "max")
    assert torch.equal(got, x.amax(0, keepdim=True).expand_as(x))


def _k1_cuda_cases():
    cases = [(name, 32) for name in K1_EDGES] + [("b4_360000", 32)]
    return cases + [(name, c) for c in (9, 128) for name in ("n=515", "on_tile_edges",
                                                             "runs_R_R+1", "on_tile_edges_128",
                                                             "one_run")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,c", _k1_cuda_cases())
def test_seg_pool_kernels_at_tile_edges(cuda, name, c):
    """K1's forward and gradient at the tile edges: max bit-exact, sum and
    the gradient within 1e-5 of the segment's sum of |.| of the plain
    versions in float64 (on the card the float32 plain sum adds a run's
    rows one by one through atomics, 2e-4 off over the 40,000-row tail),
    the gradient zero off the tie set, and two calls of each
    bit-identical."""
    if name == "b4_360000":  # four samples of tail_90000, ids offset per sample
        parts = [_k1_edge_case("tail_90000", c, seed=s) for s in range(4)]
        offs = np.cumsum([0] + [int(p[1][-1]) + 1 for p in parts[:-1]]).astype(np.int32)
        x, ids, g = (np.concatenate(a) for a in zip(*[(p[0], p[1] + o, p[2])
                                                       for p, o in zip(parts, offs)]))
    else:
        x, ids, g = _k1_edge_case(name, c)
    xt, it, gt = (torch.from_numpy(a).to(cuda) for a in (x, ids, g))
    y = seg_pool(xt, it, "max")
    assert torch.equal(y, seg_pool_plain(xt, it, "max"))
    s1, s2 = seg_pool(xt, it, "sum"), seg_pool(xt, it, "sum")
    assert torch.equal(s1, s2)
    abs_x = seg_pool_plain(xt.abs(), it, "sum")
    assert bool(((s1 - seg_pool_plain(xt.double(), it, "sum")).abs() <= 1e-5 * abs_x + 1e-6).all())
    before = seg_pool_backward.launches
    b1, b2 = seg_pool_backward(xt, it, y, gt), seg_pool_backward(xt, it, y, gt)
    assert seg_pool_backward.launches == before + 2
    assert torch.equal(b1, b2)
    want = seg_pool_backward_plain(xt.double(), it, y.double(), gt.double())
    abs_g = seg_pool_plain(gt.abs(), it, "sum")
    assert bool(((b1 - want).abs() <= 1e-5 * abs_g + 1e-6).all())
    assert bool((b1[xt != y] == 0).all())
    # a cotangent that is a column slice of a wider gradient gives the same bits
    wide = torch.cat([gt, gt], dim=1)[:, c:]
    assert torch.equal(seg_pool_backward(xt, it, y, wide), b1)


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


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values (8 significant bits) at |a|, float32."""
    a = a.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("name,c", [(name, 32) for name in K1_EDGES]
                         + [(name, 9) for name in ("n=515", "on_tile_edges", "one_run")])
def test_seg_pool_bf16_kernel_at_tile_edges(cuda, name, c):
    """The bf16 kernel (one launch on `launches_bf16`, none on the float32
    count) at the tile edges: max torch.equal to the plain version (bf16
    in, float32 compare, bf16 out: no rounding); sum within 1 bf16 ulp of
    the plain version (both reduce in float32 and round once; their float32
    orders differ by up to 1e-5 of the segment's sum of |x|, added to the
    bound), and two calls torch.equal."""
    x, ids, _ = _k1_edge_case(name, c)
    xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    it = torch.from_numpy(ids).to(cuda)
    before = seg_pool.launches, seg_pool.launches_bf16
    y = seg_pool(xt, it, "max")
    assert (seg_pool.launches, seg_pool.launches_bf16) == (before[0], before[1] + 1)
    assert y.dtype == torch.bfloat16 and torch.equal(y, seg_pool_plain(xt, it, "max"))
    s1, s2 = seg_pool(xt, it, "sum"), seg_pool(xt, it, "sum")
    assert torch.equal(s1, s2)
    want = seg_pool_plain(xt, it, "sum")
    abs_x = seg_pool_plain(xt.float().abs(), it, "sum")
    tol = _bf16_ulp(torch.maximum(want.float().abs(), s1.float().abs())) + 1e-5 * abs_x
    assert bool(((s1.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nb,r,w,c", [(5, 288, 288, 32), (11, 288, 288, 32), (5, 288, 288, 9),
                                      (1, 1152, 288, 32), (3, 40, 1500, 16)])
def test_row_shift_bf16_kernel_matches_plain(cuda, nb, r, w, c):
    """The bf16 kernel (one launch on `launches_bf16`) against the plain
    version on the same bf16 image: the same float32 lerp rounded once;
    within 1 bf16 ulp (a float32 result on a rounding tie may go either
    way). A zero shift passes the bits through."""
    img, shifts = _row_shift_case(4, nb, r=r, w=w, c=c)
    it = torch.from_numpy(img).to(cuda).to(torch.bfloat16)
    st = torch.from_numpy(shifts).to(cuda)
    before = row_shift_blocks.launches, row_shift_blocks.launches_bf16
    got = row_shift_blocks(it, st, nb)
    assert (row_shift_blocks.launches, row_shift_blocks.launches_bf16) == (before[0],
                                                                         before[1] + 1)
    k = torch.floor(st)
    want = row_shift_blocks_plain(it, k.clamp(-w, w).to(torch.int32), (st - k), nb)
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - want.float()).abs()
                 <= _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))).all())
    zero = (st == 0).nonzero()
    for row, b in zero.tolist()[:8]:
        assert torch.equal(got[row, :, b * c:(b + 1) * c], it[row, :, b * c:(b + 1) * c])


@pytest.mark.cuda
def test_row_shift_bf16_kernel_on_misaligned_image(cuda):
    """A bf16 image 2 bytes past a 16-byte boundary takes the kernel's
    one-channel path (plain copies into the slab), with the same result."""
    img, shifts = _row_shift_case(9, 5, r=64, w=96, c=8)
    flat = torch.empty(img.size + 1, device=cuda, dtype=torch.bfloat16)
    it = flat[1:].view(img.shape)
    it.copy_(torch.from_numpy(img))
    assert it.data_ptr() % 16 != 0
    st = torch.from_numpy(shifts).to(cuda)
    k = torch.floor(st)
    want = row_shift_blocks_plain(it, k.clamp(-96, 96).to(torch.int32), (st - k), 5)
    got = row_shift_blocks(it, st, 5)
    assert bool(((got.float() - want.float()).abs()
                 <= _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,c", [(name, 32) for name in K1_EDGES]
                         + [(name, 9) for name in ("n=515", "on_tile_edges", "one_run")])
def test_seg_pool_bf16_gradient_kernel_at_tile_edges(cuda, name, c):
    """The bf16 gradient kernel of max (one launch on
    `seg_pool_backward.launches_bf16`, none on the float32 count) at the
    tile edges, on bf16 rows with forced ties: within 1 bf16 ulp of the
    plain version's share (both sum g and the tie mask in float32 and
    round the division once; their float32 orders differ by up to 1e-5 of
    the segment's sum of |g| over its tie count), zero off the tie set,
    two calls torch.equal, and through SegPool's backward the same bits."""
    x, ids, g = _k1_edge_case(name, c)
    xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    gt = torch.from_numpy(g).to(cuda).to(torch.bfloat16)
    it = torch.from_numpy(ids).to(cuda)
    y = seg_pool(xt, it, "max")
    before = seg_pool_backward.launches, seg_pool_backward.launches_bf16
    b1, b2 = seg_pool_backward(xt, it, y, gt), seg_pool_backward(xt, it, y, gt)
    assert (seg_pool_backward.launches, seg_pool_backward.launches_bf16) == (before[0],
                                                                             before[1] + 2)
    assert b1.dtype == torch.bfloat16 and torch.equal(b1, b2)
    want = seg_pool_backward_plain(xt, it, y, gt)
    tie = xt == y
    nt = seg_pool_plain(tie.float(), it, "sum").clamp(min=1.0)
    tol = (_bf16_ulp(torch.maximum(want.float().abs(), b1.float().abs()))
           + 1e-5 * seg_pool_plain(gt.float().abs(), it, "sum") / nt)
    assert bool(((b1.float() - want.float()).abs() <= tol).all())
    assert bool((b1[~tie] == 0).all())
    xg = xt.clone().requires_grad_(True)
    seg_pool(xg, it, "max").backward(gt)
    assert torch.equal(xg.grad, b1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1, 32), (257, 9), (120000, 32)])
@pytest.mark.parametrize("payload", [1, 2])
def test_seg_pool_bf16_entry_takes_the_wrappers_scratch(cuda, payload, n, c):
    """What a bf16 C entry point requires (`segpool_bf16_scratch_floats`) is
    `scratch_floats`: it refuses one float fewer and, on exactly that
    many, gives the plain version's max (or gradient of max)."""
    from pcaccumulation_tpu_torch.kernels import build

    lib = build.load_library("segscan")
    need = scratch_floats(n, c, torch.bfloat16, payload)
    assert lib.segpool_bf16_scratch_floats(n, c, payload) == need
    x, ids = _k1_case(5, n=n, c=c, tail=n // 3)
    xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    it = torch.from_numpy(ids).to(cuda)
    y = seg_pool_plain(xt, it, "max")
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(cuda).to(xt.dtype)
    out = torch.empty_like(xt)
    scratch = torch.empty(need, device=cuda)
    stream = build.stream(xt)

    def call(floats):
        if payload == 1:
            return lib.segpool_forward_bf16(xt.data_ptr(), it.data_ptr(), out.data_ptr(),
                                            scratch.data_ptr(), floats, n, c, 0, stream)
        return lib.segpool_backward_max_bf16(xt.data_ptr(), y.data_ptr(), g.data_ptr(),
                                             it.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                             floats, n, c, stream)

    assert call(need - 1) != 0
    assert call(need) == 0
    torch.cuda.synchronize()
    if payload == 1:
        assert torch.equal(out, y)
    else:
        assert bool((out[xt != y] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,elems", [("on_tile_edges", 1), ("on_tile_edges", 4),
                                        ("tail_90000", 4)])
def test_seg_pool_bf16_kernels_on_misaligned_rows(cuda, name, elems):
    """bf16 rows 2 or 8 bytes past a 16-byte boundary take the two-launch
    kernels (one column a thread, or four) instead of the bulk-copy path:
    max torch.equal to the plain version, the gradient of max within the
    bound of test_seg_pool_bf16_gradient_kernel_at_tile_edges and zero off
    the tie set, one launch each on the bf16 counts."""
    x, ids, g = _k1_edge_case(name, 32)
    xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    gt = torch.from_numpy(g).to(cuda).to(torch.bfloat16)
    it = torch.from_numpy(ids).to(cuda)

    def off(t):
        buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=cuda)
        moved = buf[elems:].view(t.shape)
        moved.copy_(t)
        assert moved.data_ptr() % 16 != 0
        return moved

    y = seg_pool_plain(xt, it, "max")
    before = seg_pool.launches_bf16, seg_pool_backward.launches_bf16
    assert torch.equal(seg_pool(off(xt), it, "max"), y)
    got = seg_pool_backward(off(xt), it, off(y), off(gt))
    assert (seg_pool.launches_bf16, seg_pool_backward.launches_bf16) == (before[0] + 1,
                                                                         before[1] + 1)
    want = seg_pool_backward_plain(xt, it, y, gt)
    tie = xt == y
    nt = seg_pool_plain(tie.float(), it, "sum").clamp(min=1.0)
    tol = (_bf16_ulp(torch.maximum(want.float().abs(), got.float().abs()))
           + 1e-5 * seg_pool_plain(gt.float().abs(), it, "sum") / nt)
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    assert bool((got[~tie] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nb,c", [(11, 32), (5, 9)])
def test_row_shift_bf16_gradient_kernel_matches_plain(cuda, nb, c):
    """The bf16 gradient (the bf16 kernel at -shifts, one launch on
    `row_shift_blocks_backward.launches_bf16`) against the plain version at
    -shifts, within 1 bf16 ulp; through RowShift's backward the same bits."""
    g, shifts = _row_shift_case(6, nb, r=288, w=288, c=c)
    gt = torch.from_numpy(g).to(cuda).to(torch.bfloat16)
    st = torch.from_numpy(shifts).to(cuda)
    before = row_shift_blocks_backward.launches, row_shift_blocks_backward.launches_bf16
    got = row_shift_blocks_backward(gt, st, nb)
    assert (row_shift_blocks_backward.launches,
            row_shift_blocks_backward.launches_bf16) == (before[0], before[1] + 1)
    k = torch.floor(-st)
    want = row_shift_blocks_plain(gt, k.clamp(-288, 288).to(torch.int32), (-st - k), nb)
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - want.float()).abs()
                 <= _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))).all())
    img = torch.zeros_like(gt).requires_grad_(True)
    row_shift_blocks(img, st, nb).backward(gt)
    assert torch.equal(img.grad, got)
