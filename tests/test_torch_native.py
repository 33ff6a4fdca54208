"""The port's native host library (`pcaccumulation_tpu_torch/native/`)
against the JAX package's (`pcaccumulation_tpu/native/host.py`): the
voxeliser, the counting sort and the fused transform/filter, and the
port's `prep_sample` against the JAX package's, field by field, with both
packages on the native path (their default) and both on numpy
(`PCACC_NATIVE=0`, the module flag `_USE_NATIVE`).

The JAX package's library is the tracked build it loads itself; the
port's is built by the host compiler into `_build/` at first use.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import pcaccumulation_tpu.data.voxelizer as jvox
from pcaccumulation_tpu.data.dataset import prep_sample as jax_prep_sample
from pcaccumulation_tpu.data.synthetic import generate_sample
from pcaccumulation_tpu.native import host as jhost
from pcaccumulation_tpu_torch.config import load_config
from pcaccumulation_tpu_torch.data import loader as tloader
from pcaccumulation_tpu_torch.data import voxelizer as tvox
from pcaccumulation_tpu_torch.data.dataset import prep_sample
from pcaccumulation_tpu_torch.native import host
from pcaccumulation_tpu_torch.profile_forward import default_samples

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

REPO = Path(__file__).resolve().parent.parent
VOXEL = [0.25, 0.25, 8.0]
RANGE = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]


@pytest.fixture(scope="module")
def jax_lib():
    lib = jhost.get_lib()
    assert lib is not None, "the JAX package's native library did not load"
    return lib


def small_config(**capacity) -> dict:
    """tests/test_torch_motionnet.py's small grid: 64 x 64 pillars, T=5."""
    cfg = load_config()
    cfg["voxel_generator"].update({"range": RANGE, "voxel_size": VOXEL, "n_sweeps": 5,
                                   "crop_range": [8, -5, 3]})
    cfg["data"].update({"n_frames": 5, "freq": 10.0})
    cfg["capacity"] = {"max_points": 12000, "max_pillars": 6000, "max_instances": 8,
                       "max_fg_points": 512, **capacity}
    return cfg


def small_scan(seed: int) -> dict:
    return generate_sample(seed=seed, n_frames=5, n_static_clusters=8, n_dynamic=2,
                           pts_per_cluster=120, pts_per_object=90, area=6.0)


def voxel_inputs(case: str):
    """(points, time_idx, max_pillars) of a voxeliser case."""
    rng = np.random.default_rng({"random": 0, "out_of_range": 1, "overflow": 2}[case])
    n = 20000
    if case == "out_of_range":  # x, y, z and t beyond the grid on either side
        pts = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
        pts[:, 2] = rng.uniform(-7, 5, n)
        return pts, rng.integers(-2, 8, n), 6000
    pts = rng.uniform(-7.9, 7.9, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4.9, 2.9, n)
    # "overflow": more distinct pillars than max_pillars, in random order
    return pts, rng.integers(0, 5, n), 16000 if case == "random" else 1500


def first_come_voxelize(points, time_idx, voxel, pc_range, n_sweeps, max_pillars):
    """The native voxeliser's semantics in numpy: pillar ids ranked by the
    index of each pillar's first point."""
    pc = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel, np.float32)
    nx, ny, nz = np.round((pc[3:] - pc[:3]) / vs).astype(np.int64)
    c = np.floor((points - pc[:3]) / vs).astype(np.int64)
    t = np.asarray(time_idx, np.int64)
    ok = ((c[:, 0] >= 0) & (c[:, 0] < nx) & (c[:, 1] >= 0) & (c[:, 1] < ny)
          & (c[:, 2] >= 0) & (c[:, 2] < nz) & (t >= 0) & (t < n_sweeps))
    key = (t * ny + c[:, 1]) * nx + c[:, 0]
    uniq, first, inverse = np.unique(key[ok], return_index=True, return_inverse=True)
    by_arrival = np.argsort(first)
    rank = np.empty_like(by_arrival)
    rank[by_arrival] = np.arange(len(uniq))
    p2v = np.full(len(points), max_pillars, np.int32)
    p2v[ok] = np.minimum(rank[inverse.ravel()], max_pillars)
    m = min(len(uniq), max_pillars)
    kept = uniq[by_arrival[:m]]
    coords = np.zeros((max_pillars, 3), np.int32)
    coords[:m] = np.stack([kept // (nx * ny), (kept // nx) % ny, kept % nx], 1)
    valid = np.zeros(max_pillars, bool)
    valid[:m] = True
    return coords, valid, p2v, p2v < max_pillars


@pytest.mark.parametrize("case", ["random", "out_of_range", "overflow"])
def test_native_voxelize_matches_jax(jax_lib, case):
    """All four arrays equal to the JAX package's native voxeliser and to
    the first-come numpy reference."""
    pts, t, max_pillars = voxel_inputs(case)
    got = host.native_voxelize(pts, t, VOXEL, RANGE, 5, max_pillars)
    want = jhost.native_voxelize(pts, t, VOXEL, RANGE, 5, max_pillars)
    ref = first_come_voxelize(pts, t, VOXEL, RANGE, 5, max_pillars)
    for name, g, w, r in zip(("coords", "valid", "p2v", "in_range"), got, want, ref):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, r, err_msg=name)
    n_valid = int(got[1].sum())
    if case == "overflow":
        assert n_valid == max_pillars and (got[2] == max_pillars).sum() > 1000
    elif case == "out_of_range":
        assert 1000 < got[3].sum() < len(pts)
    else:
        assert got[3].all() and n_valid < max_pillars


@pytest.mark.parametrize("n_buckets", [1, 100, 6000])
def test_native_sort_by_key_matches_jax(jax_lib, n_buckets):
    """Equal to the JAX package's counting sort and to the stable argsort of
    the clamped keys, with negative keys and keys above n_buckets."""
    rng = np.random.default_rng(n_buckets)
    keys = rng.integers(-50, n_buckets + 50, 30000).astype(np.int32)
    got = host.native_sort_by_key(keys, n_buckets)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jhost.native_sort_by_key(keys, n_buckets))
    np.testing.assert_array_equal(got, np.argsort(np.clip(keys, 0, n_buckets), kind="stable"))


def test_native_transform_filter_matches_jax(jax_lib):
    """Within 1e-5 m of the JAX package's library at coordinates <= 50 m
    (the two builds may contract other products into FMAs), keep masks
    equal away from the crop and ground edges."""
    rng = np.random.default_rng(7)
    n = 50000
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-6, 6, n)
    noise = ((rng.random((n, 3), dtype=np.float32) - 0.5) * 0.05).astype(np.float32)
    yaw = 0.7
    tsfm = np.eye(4, dtype=np.float32)
    tsfm[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    tsfm[:3, 3] = [1.5, -2.0, 0.1]
    scale, crop_xy, z_lo, z_hi, ground_h = 1.03, 32.0, -5.0, 3.0, -1.5
    got, keep = host.native_transform_filter(pts, tsfm, scale, noise, crop_xy, z_lo, z_hi,
                                             ground_h)
    want = pts.copy()
    want_keep = np.zeros(n, np.uint8)
    p = ctypes.POINTER(ctypes.c_float)
    jax_lib.transform_filter(
        want.ctypes.data_as(p), ctypes.c_int64(n), tsfm.ctypes.data_as(p), ctypes.c_float(scale),
        noise.ctypes.data_as(p), ctypes.c_float(crop_xy), ctypes.c_float(z_lo),
        ctypes.c_float(z_hi), ctypes.c_float(ground_h),
        want_keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert np.abs(got).max() <= 50.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    edge = ((np.abs(np.abs(want[:, :2]) - crop_xy) < 1e-4).any(1)
            | (np.abs(want[:, 2:] - [z_lo, z_hi, ground_h]) < 1e-4).any(1))
    np.testing.assert_array_equal(keep[~edge], want_keep.astype(bool)[~edge])
    assert 0 < keep.sum() < n
    # the plain formula, in float64
    ref = (pts.astype(np.float64) @ tsfm[:3, :3].T.astype(np.float64) + tsfm[:3, 3]
           + noise) * scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def prep_case(case: str):
    """(config, raw sample, prep_sample keyword arguments) of a case."""
    if case == "over_max_points":  # the default config's smoke scan: 194,857 raw points
        cfg = load_config()
        return cfg, default_samples(cfg, 1)[0], {}
    if case == "over_max_pillars":
        return small_config(max_pillars=500), small_scan(6), {}
    kw = {"small": {}, "small_no_labels": {"with_labels": False},
          "augment": {"augment": True}}[case]
    return small_config(), small_scan(5), kw


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("case", ["small", "small_no_labels", "over_max_points",
                                  "over_max_pillars", "augment"])
def test_prep_sample_matches_jax(jax_lib, monkeypatch, case, path):
    """The port's prep_sample np.array_equal to the JAX package's in every
    field, both packages on the same path; augmentation from one seeded
    generator each."""
    monkeypatch.setattr(tvox, "_USE_NATIVE", path == "native")
    monkeypatch.setattr(jvox, "_USE_NATIVE", path == "native")
    cfg, raw, kw = prep_case(case)
    if "augment" in kw:
        kw["rng"] = np.random.default_rng(5)
    got = prep_sample(raw, cfg, **kw)
    if "augment" in kw:
        kw["rng"] = np.random.default_rng(5)
    want = jax_prep_sample(raw, cfg, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cap = cfg["capacity"]
    n_in = int(got["point_valid"].sum())
    assert (np.diff(got["pillar_of_point"]) >= 0).all()  # sorted: K1's precondition
    if case == "over_max_points":
        assert n_in == cap["max_points"]
    if case == "over_max_pillars":  # every pillar taken, real points left without one
        assert got["pillar_valid"].all()
        assert (~got["point_valid"] & got["points"].any(1)).any()
    if case in ("small", "small_no_labels", "augment"):
        assert 0 < n_in < cap["max_points"] and not got["pillar_valid"].all()


def test_paths_keep_other_points_over_max_points(monkeypatch):
    """Why the path matters: over max_points the two paths keep other
    points (first-come against sorted-key pillar order before the strided
    subsample), so each package must be held against the other on the
    same path."""
    cfg, raw, _ = prep_case("over_max_points")
    native = prep_sample(raw, cfg)
    monkeypatch.setattr(tvox, "_USE_NATIVE", False)
    numpy_ = prep_sample(raw, cfg)
    assert native["point_valid"].sum() == numpy_["point_valid"].sum()
    assert not np.array_equal(native["points"], numpy_["points"])


def test_native_path_raises_without_a_compiler(monkeypatch, tmp_path):
    """On the native path, a library that cannot be built raises with the
    reason, and no numpy sample comes back; PCACC_NATIVE=0 needs no
    compiler."""
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(tvox, "_USE_NATIVE", True)
    cfg, raw = small_config(), small_scan(5)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        prep_sample(raw, cfg)
    assert host._lib is None and not list(tmp_path.glob("build/*.so"))
    monkeypatch.setattr(tvox, "_USE_NATIVE", False)
    out = prep_sample(raw, cfg)
    assert out["point_valid"].any() and host._lib is None


def test_failed_compile_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A compiler that runs and fails: its output reaches the caller, and no
    library file is left behind."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\nif [ \"$1\" = --version ]; then echo fake 1.0; exit 0; fi\n"
                   "echo 'pcacc_host.cpp:1: error: made to fail' >&2; exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="made to fail"):
        host.native_sort_by_key(np.zeros(3, np.int32), 4)
    assert not list((tmp_path / "build").iterdir())


def test_concurrent_builds_share_one_library(tmp_path):
    """Three processes that build into one empty directory at once each
    load a complete library; one file is left, and no temporary one."""
    code = ("import sys; from pathlib import Path; import numpy as np; "
            "from pcaccumulation_tpu_torch.native import host; "
            "host.BUILD_DIR = Path(sys.argv[1]); "
            "o = host.native_sort_by_key(np.array([3, -1, 2, 9], np.int32), 4); "
            "assert o.tolist() == [1, 2, 0, 3], o")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO)
             for _ in range(3)]
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=120))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append("timeout")
    assert rcs == [0, 0, 0]
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]


def test_process_loader_loads_the_library_before_forking(monkeypatch):
    """The forked workers inherit the parent's loaded library."""
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(tvox, "_USE_NATIVE", True)
    data = [{"i": np.array([i])} for i in range(4)]
    batches = list(tloader.make_loader(data, batch_size=2, shuffle=False, num_workers=1,
                                       mode="process"))
    assert [b["i"].ravel().tolist() for b in batches] == [[0, 1], [2, 3]]
    assert host._lib is not None
