"""A/B of K1's bf16 kernels (`csrc/segscan.cu`) on one card, between this
checkout and another checkout of the port (e.g. the parent commit unpacked
with `git archive`), and the per-launch split of this checkout's bf16
kernels.

    python3 tools/ab_k1_bf16.py <other checkout>
    python3 tools/ab_k1_bf16.py --split [<file for ptxas's report>]

A/B: each checkout runs in its own process, in the order other, this,
this, other, and prints one JSON line: the C entry points queued behind a
spin of the card (`chip_smoke.cuda_ms_queued`: the device time) and the
wrappers back to back (the host's pace), the median of 5 repeats, at the
nuScenes preset's shapes (`chip_smoke.k1_inputs` / `k1_batch_inputs` in
bf16: the forward at [120000, 32] (B=1) and [480000, 32] (B=4), the
gradient of max at [480000, 32] with ties) and the float32 entries at
the default config's shapes ([90000, 32], gradient [360000, 32]), each
beside its bound.
Inputs come from each checkout's own `chip_smoke.py` and one seed.

--split (this checkout): for each bf16 design the C library has
(`segpool_bf16_phase`: 0 = the two-launch seg_partials + seg_tiles, 1 = the
Hopper design of `segpool_forward_bf16`), each launch alone and both,
queued, the median of 5; each kernel's resident blocks per SM, registers,
spill bytes and shared bytes (`segpool_bf16_kernel_info`); the host's us
per wrapper call over 1,000 calls with no synchronise between them; and
ptxas's report of `segscan.cu` into the file given (default
`results/k1_ptxas.txt`).
"""
import json
import os
import statistics
import subprocess
import sys

REPEATS = 5


def _setup():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from pcaccumulation_tpu_torch.kernels import build

    build.build_all()
    return torch, chip_smoke, build


def _inputs(torch, chip_smoke, dev):
    """The bf16 and float32 inputs, from one seed: {name: (x, ids, y, g)}."""
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool_plain

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    x1, ids1 = chip_smoke.k1_inputs(gen, dev, n=120000)
    x4, ids4 = chip_smoke.k1_batch_inputs(gen, dev, 4, n=120000)
    xt = chip_smoke.tie_values(x4).to(bf)
    g4 = torch.randn(x4.shape, generator=gen).to(dev).to(bf)
    xf, idsf = chip_smoke.k1_inputs(gen, dev)
    x4f, ids4f = chip_smoke.k1_batch_inputs(gen, dev, 4)
    g4f = torch.randn(x4f.shape, generator=gen).to(dev)
    return {
        "fwd_bf16_120000": (x1.to(bf), ids1, None, None),
        "fwd_bf16_480000": (x4.to(bf), ids4, None, None),
        "bwd_bf16_480000": (xt, ids4, seg_pool_plain(xt, ids4, "max"), g4),
        "fwd_f32_90000": (xf, idsf, None, None),
        "bwd_f32_360000": (x4f, ids4f, seg_pool_plain(x4f, ids4f, "max"), g4f),
    }


def _scratch(torch, x):
    """Scratch enough for either design's C entry: two partials of (g,
    ties), flags, bounds and a tie word per thread of a 256-row tile."""
    n, c = x.shape
    return torch.empty(-(-n // 256) * (4 * c + 2 + 256), dtype=torch.float32, device=x.device)


def _median(fn) -> float:
    return statistics.median(fn() for _ in range(REPEATS))


def _bound(chip_smoke, x, grad: bool) -> float:
    n, c = x.shape
    arrays = 4 if grad else 2  # x (y, g) read once, the result written once
    return chip_smoke.bound_ms(arrays * n * c * x.element_size() + n * 4,
                               (5 if grad else 1) * n * c)[0]


def measure() -> None:
    """In the checkout that is the working directory: one JSON line."""
    torch, chip_smoke, build = _setup()
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_backward

    dev = torch.device("cuda")
    lib = build.load_library("segscan")
    out = {}
    for name, (x, ids, y, g) in _inputs(torch, chip_smoke, dev).items():
        n, c = x.shape
        res = torch.empty_like(x)
        scratch = _scratch(torch, x)
        stream = build.stream(x)
        bf = x.dtype == torch.bfloat16
        if y is None:
            entry = lib.segpool_forward_bf16 if bf else lib.segpool_forward

            def call_entry():
                entry(x.data_ptr(), ids.data_ptr(), res.data_ptr(), scratch.data_ptr(),
                      scratch.numel(), n, c, 0, stream)

            def call_wrapper():
                seg_pool(x, ids, "max")
        else:
            entry = lib.segpool_backward_max_bf16 if bf else lib.segpool_backward_max

            def call_entry():
                entry(x.data_ptr(), y.data_ptr(), g.data_ptr(), ids.data_ptr(), res.data_ptr(),
                      scratch.data_ptr(), scratch.numel(), n, c, stream)

            def call_wrapper():
                seg_pool_backward(x, ids, y, g)
        iters = 200 if y is None else 100
        entry_ms = _median(lambda: chip_smoke.cuda_ms_queued(call_entry, iters=iters))
        out[name] = {"entry_ms": entry_ms,
                     "wrapper_ms": _median(lambda: chip_smoke.cuda_ms(call_wrapper, iters=iters)),
                     "bound_ms": _bound(chip_smoke, x, y is not None)}
        out[name]["share"] = out[name]["bound_ms"] / entry_ms
    print(json.dumps(out), flush=True)


def split(ptxas_file: str) -> None:
    """This checkout's bf16 designs launch by launch; see the docstring."""
    torch, chip_smoke, build = _setup()
    from pcaccumulation_tpu_torch.kernels.segscan import seg_pool, seg_pool_backward

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(ptxas_file)), exist_ok=True)
    with open(ptxas_file, "w") as f:
        f.write(build.ptxas_report("segscan"))
    print(json.dumps({"kernel_info": chip_smoke.k1_bf16_kernel_info()}), flush=True)
    for name, (x, ids, y, g) in _inputs(torch, chip_smoke, dev).items():
        if "bf16" not in name:
            continue
        splits = [chip_smoke.k1_bf16_split(x, ids, y, g) for _ in range(REPEATS)]
        row = {key: statistics.median(sp[key] for sp in splits) for key in splits[0]}
        row["bound_ms"] = _bound(chip_smoke, x, y is not None)
        row["wrapper_host_us"] = chip_smoke.host_us_per_call(
            (lambda: seg_pool(x, ids, "max")) if y is None
            else (lambda: seg_pool_backward(x, ids, y, g)))
        print(json.dumps({name: row}), flush=True)


def main() -> None:
    if sys.argv[1:] == ["--measure"]:
        measure()
        return
    if sys.argv[1:2] == ["--split"] and len(sys.argv) <= 3:
        split(sys.argv[2] if len(sys.argv) == 3 else "results/k1_ptxas.txt")
        return
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for name, tree in (("other", other), ("this", this), ("this", this), ("other", other)):
        got = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure"], cwd=tree,
                             capture_output=True, text=True, check=True).stdout.strip()
        print(f"{name} ({tree}): {got.splitlines()[-1]}", flush=True)


if __name__ == "__main__":
    main()
