"""ctypes binding of the port's native host library (`pcacc_host.cpp`).

The library is built at first use with the host compiler (`$CXX`, else
`g++`) into `pcaccumulation_tpu_torch/_build/`, under a name keyed by a
hash of the source, the flags, the compiler's `--version` and the CPU
model (`-march=native` code must not move to another CPU). Importing this
module builds nothing. A library that cannot be built or loaded raises
`RuntimeError` with the compiler's output: the caller asked for the native
path, and numpy's path keeps other points (`data/voxelizer.py`), so there
is no quiet fallback.

The functions take and return numpy arrays with the signatures of the JAX
package's `native/host.py`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from pcaccumulation_tpu_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "pcacc_host.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]
BUILD_DIR = build.BUILD_DIR

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_F32 = ctypes.c_float
SIGNATURES = {
    "voxelize": [_P, _P, _I64, _P, _P, _I32, _I32, _P, _P, _P],
    "transform_filter": [_P, _I64, _P, _F32, _P, _F32, _F32, _F32, _F32, _P],
    "sort_by_key": [_P, _I64, _I32, _P],
}

_lib: ctypes.CDLL | None = None


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def compiler_version(cxx: str | None = None) -> str:
    """What the host compiler (`$CXX`, else `g++`) says to `--version`;
    RuntimeError if it cannot be run."""
    cxx = cxx or _cxx()
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                                 timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the host compiler {cxx!r} cannot be run to build "
                           f"{SOURCE.name}: {e}") from e
    if version.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed:\n{version.stdout}{version.stderr}")
    return version.stdout


def _cpu_model() -> str:
    """The CPU's model name and feature flags (what `-march=native` reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
    except OSError:
        import platform

        return platform.processor() or platform.machine()
    return "".join(sorted(set(lines)))


def library_path(cxx: str) -> Path:
    """Where the library is built for this source, flags, compiler and CPU."""
    h = hashlib.sha256()
    for part in (SOURCE.read_bytes(), " ".join(CXX_FLAGS).encode(),
                 compiler_version(cxx).encode(), _cpu_model().encode()):
        h.update(part)
    return BUILD_DIR / f"libpcacc_host-{h.hexdigest()[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises RuntimeError if it
    cannot be built or loaded. Once loaded, forked processes inherit it."""
    global _lib
    if _lib is not None:
        return _lib
    cxx = _cxx()
    target = library_path(cxx)
    job = build.start_compile([cxx, *CXX_FLAGS], SOURCE, target)
    if job is not None:
        build.finish_compile(job)
    try:
        lib = ctypes.CDLL(str(target))
    except OSError as e:
        raise RuntimeError(f"cannot load the host library {target}: {e}") from e
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} returned {rc}")


def native_voxelize(points, time_idx, voxel_size, pc_range, n_sweeps, max_pillars):
    """`data/voxelizer.voxelize` in C++: the same tuple (pillar_coords,
    pillar_valid, pillar_of_point, in_range), with pillar ids given
    first-come and `in_range` the points that got a pillar."""
    points = np.ascontiguousarray(points, np.float32)
    time_idx = np.ascontiguousarray(time_idx, np.int32)
    voxel = np.ascontiguousarray(voxel_size, np.float32)
    rng = np.ascontiguousarray(pc_range, np.float32)
    n = points.shape[0]
    if points.shape != (n, 3) or time_idx.shape != (n,):
        raise ValueError(f"points [n, 3] and time_idx [n] wanted, got {points.shape} and "
                         f"{time_idx.shape}")
    if voxel.shape != (3,) or rng.shape != (6,):
        raise ValueError(f"voxel_size [3] and pc_range [6] wanted, got {voxel.shape} and "
                         f"{rng.shape}")
    if not 0 < max_pillars < 2 ** 30:
        raise ValueError(f"max_pillars {max_pillars} out of range")
    lib = get_lib()
    coords = np.zeros((max_pillars, 3), np.int32)
    p2v = np.zeros(n, np.int32)
    count = np.zeros(1, np.int32)
    _check(lib.voxelize(_ptr(points), _ptr(time_idx), n, _ptr(voxel), _ptr(rng), int(n_sweeps),
                        int(max_pillars), _ptr(coords), _ptr(p2v), _ptr(count)), "voxelize")
    pillar_valid = np.zeros(max_pillars, bool)
    pillar_valid[:int(count[0])] = True
    return coords, pillar_valid, p2v, p2v < max_pillars


def native_sort_by_key(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    """Stable counting-sort argsort of int keys clamped into [0, n_buckets]
    (ids >= n_buckets share one last bucket): int32 order, equal to
    `np.argsort(np.clip(keys, 0, n_buckets), kind="stable")`."""
    keys = np.ascontiguousarray(keys, np.int32)
    if keys.ndim != 1:
        raise ValueError(f"keys [n] wanted, got {keys.shape}")
    if not 0 <= n_buckets < 2 ** 31 - 1:
        raise ValueError(f"n_buckets {n_buckets} out of range")
    lib = get_lib()
    order = np.empty(keys.shape[0], np.int32)
    _check(lib.sort_by_key(_ptr(keys), keys.shape[0], int(n_buckets), _ptr(order)),
           "sort_by_key")
    return order


def native_transform_filter(points, tsfm, scale, noise, crop_xy, z_lo, z_hi, ground_h):
    """points' = scale * (R @ p + t + noise) and the keep mask |x|, |y| <
    crop_xy, z_lo < z < z_hi, z > ground_h. Returns (points' [n, 3]
    float32, keep [n] bool); `points` is not changed."""
    out = np.array(points, np.float32, order="C", copy=True)
    tsfm = np.ascontiguousarray(tsfm, np.float32)
    noise = np.ascontiguousarray(noise, np.float32)
    n = out.shape[0]
    if out.shape != (n, 3) or noise.shape != (n, 3) or tsfm.shape != (4, 4):
        raise ValueError(f"points [n, 3], noise [n, 3] and tsfm [4, 4] wanted, got "
                         f"{out.shape}, {noise.shape} and {tsfm.shape}")
    lib = get_lib()
    keep = np.zeros(n, np.uint8)
    _check(lib.transform_filter(_ptr(out), n, _ptr(tsfm), float(scale), _ptr(noise),
                                float(crop_xy), float(z_lo), float(z_hi), float(ground_h),
                                _ptr(keep)), "transform_filter")
    return out, keep.view(bool)
