"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`. A library is
built at first use into `_build/` inside the package, under a name keyed by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. Importing this module builds nothing. The
compile into a temporary file and its rename (`start_compile`,
`finish_compile`) also build the host library (`native/host.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
HOST_ONLY_FLAGS = {"-shared", "-Xcompiler", "-fPIC"}  # of the shared library, not the device code

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C entry points of each source: name -> (argtypes); each returns int (see RESTYPES)
SIGNATURES = {
    "segscan": {
        "segpool_forward": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _P],
        "segpool_forward_bf16": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _P],
        "segpool_backward_max": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _P],
        "segpool_backward_max_bf16": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _P],
        "segpool_bf16_scratch_floats": [_I32, _I32, _I32],
        "segpool_bf16_phase": [_I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _P],
        "segpool_bf16_kernel_info": [_I32, _P, _I32],
    },
    "row_shift": {
        "row_shift_blocks_forward": [_P, _P, _P, _I64, _I32, _I32, _I32, ctypes.c_float, _P],
        "row_shift_blocks_forward_bf16": [_P, _P, _P, _I64, _I32, _I32, _I32, ctypes.c_float,
                                          _P],
    },
    "nn": {
        "nn_forward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _P],
    },
}

# entry points that return something other than an int error code
RESTYPES = {"segpool_bf16_scratch_floats": _I64}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where the library for csrc/<name>.cu is built: keyed by the hash of
    the source, every header in csrc/ and the flags."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def start_compile(argv: list[str], source: Path, target: Path):
    """Start `argv -o <tmp> source` into a temporary file beside `target`;
    None if `target` is built. Shared by the CUDA kernels and the host
    library (`native/host.py`): several processes may build one target at
    once, and each renames its own complete file onto it."""
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        proc = subprocess.Popen([*argv, "-o", tmp, str(source)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"{argv[0]} could not be started for {source}: {e}") from e
    return proc, tmp, target, source


def finish_compile(job) -> None:
    """Wait for a `start_compile` job; raise with the compiler's output if
    it failed, else move the file onto its target."""
    proc, tmp, target, source = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{proc.args[0]} failed for {source}:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu; None if built."""
    return start_compile([_nvcc(), *NVCC_FLAGS], CSRC / f"{name}.cu", library_path(name))


def build_all() -> None:
    """Compile every kernel source that is not built yet, one nvcc process
    per source, all started together."""
    jobs = {name: _start_build(name) for name in SIGNATURES}
    errors = []
    for name, job in jobs.items():
        if job is None:
            continue
        try:
            finish_compile(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def ptxas_report(name: str) -> str:
    """What ptxas says of each kernel of csrc/<name>.cu (registers, shared
    memory, spills): a compile to a throw-away cubin with `-Xptxas -v`."""
    device_flags = [f for f in NVCC_FLAGS if f not in HOST_ONLY_FLAGS]
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_nvcc(), *device_flags, "-cubin", "-Xptxas", "-v",
               "-o", os.path.join(tmp, f"{name}.cubin"), str(CSRC / f"{name}.cu")]
        return subprocess.run(cmd, capture_output=True, text=True, check=True).stderr


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    job = _start_build(name)
    if job is not None:
        finish_compile(job)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(fn_name, ctypes.c_int)
    _loaded[name] = lib
    return lib


def stream(t) -> int:
    """The raw handle of the current CUDA stream on t's device (PyTorch's
    own lookup, without building a `torch.cuda.Stream` object per call)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
