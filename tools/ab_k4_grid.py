"""A/B of K4 (`csrc/nn.cu`) on one card, between this checkout and another
checkout of the port (e.g. the parent commit unpacked with `git archive`):
the nearest-neighbour call as ICP makes it (references and queries packed
once, outputs reused) at the ego ICP shape (4 x 90,000 capacity, the
asked-for queries of `chip_smoke.k4_inputs` on `default_scenes` scene 0)
and at the instance shape ([128, 1024], `chip_smoke.k4_instance_inputs`).
Each checkout runs in its own process, in the order other, this, this,
other: 5 warm-up calls, then the median of 5 repeats of 50 calls timed
by CUDA events, and the same 50 calls on the host clock.

    python3 tools/ab_k4_grid.py <other checkout>
"""
import json
import os
import statistics
import subprocess
import sys
import time


def measure() -> None:
    """In the checkout that is the working directory: one JSON line."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.kernels.chamfer import nn_packed, pack_queries, pack_references
    from pcaccumulation_tpu_torch.profile_forward import default_scenes

    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    a, b, b_valid, a_valid = chip_smoke.k4_inputs(default_scenes(load_config(), 1)[0], dev)
    out = {}
    for name, (x, y, yv, xv) in (("ego", (a, b, b_valid, a_valid)),
                                 ("instance", chip_smoke.k4_instance_inputs(gen, dev))):
        refs, queries = pack_references(y, yv), pack_queries(xv)
        res = (torch.empty(xv.shape, device=dev), torch.empty(xv.shape, dtype=torch.int32,
                                                              device=dev))
        for _ in range(5):
            nn_packed(x, refs, queries, res)
        dev_ms, host_ms = [], []
        for _ in range(5):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.record()
            for _ in range(50):
                nn_packed(x, refs, queries, res)
            e.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3 / 50)
            dev_ms.append(s.elapsed_time(e) / 50)
        out[name] = {"ms": statistics.median(dev_ms), "all": dev_ms,
                     "host_ms": statistics.median(host_ms)}
    print(json.dumps(out), flush=True)


def main() -> None:
    if sys.argv[1:] == ["--measure"]:
        measure()
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
