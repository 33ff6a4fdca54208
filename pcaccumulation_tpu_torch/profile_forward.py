"""Where the val forward's time goes on the card.

    python -m pcaccumulation_tpu_torch.profile_forward

Builds the default config's MotionNet (configs/default.yaml) at full width
with seeded random weights on synthetic scenes at the config's capacities,
warms it up, then measures:
- the forward's median time on the host clock, synchronised;
- each stage's device time, from CUDA events around the forward's
  `motionnet.<stage>` ranges (see models/motionnet.py);
- with torch.profiler over ITERS forwards: the kernels by device time,
  each stage's kernel launches and kernel-busy time, and the device's
  busy share (the union of kernel intervals over the profiled forwards'
  device window).
It prints a readable table and, as its last line, one JSON object with the
same numbers. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import bisect
import collections
import json
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
ITERS = 10  # forwards per measurement


def default_scenes(cfg: dict, n: int) -> list[dict]:
    """n synthetic samples at the config's capacities (seeds 0..n-1): 40
    static clusters and 6 moving objects over the config's sweeps, enough
    points to fill `max_points`."""
    from pcaccumulation_tpu_torch.data.dataset import prep_sample
    from pcaccumulation_tpu_torch.data.synthetic import generate_sample

    return [
        prep_sample(generate_sample(seed=s, n_frames=cfg["voxel_generator"]["n_sweeps"],
                                    n_static_clusters=40, n_dynamic=6, pts_per_cluster=900,
                                    pts_per_object=500), cfg)
        for s in range(n)
    ]


class _StageEvents:
    """Stands in for `record_function` in models/motionnet.py: records a
    CUDA event pair around each stage and keeps the pairs per label."""

    pairs: dict[str, list] = collections.defaultdict(list)

    def __init__(self, label: str):
        self.label = label.split(".", 1)[-1]

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        self.pairs[self.label].append((self.start, self.end))
        return False


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main() -> None:
    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        sys.exit(1)

    import pcaccumulation_tpu_torch as port
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.kernels import build
    from pcaccumulation_tpu_torch.models import motionnet

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    build.build_all()
    cfg = load_config()
    cfg["pose_estimation"]["deterministic_sampling"] = True
    batches = [port.to_device(collate([s])) for s in default_scenes(cfg, 3)]
    torch.manual_seed(SEED)
    model = port.build_model(cfg)

    with torch.no_grad():
        for bt in batches:
            model(bt)
        host_ms = []
        for i in range(ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(batches[i % len(batches)])
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        fwd_ms = statistics.median(host_ms)

        # per-stage device time: CUDA events at the stage ranges
        motionnet.record_function = _StageEvents
        try:
            for i in range(ITERS):
                model(batches[i % len(batches)])
            torch.cuda.synchronize()
        finally:
            motionnet.record_function = torch.profiler.record_function
        stages = {k: statistics.median(s.elapsed_time(e) for s, e in v)
                  for k, v in _StageEvents.pairs.items()}

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(ITERS):
                model(batches[i % len(batches)])
            torch.cuda.synchronize()

    # device events are kernels, copies and the device-side spans of the
    # `motionnet.<stage>` annotations; the spans are not work
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    def is_span(e):
        return getattr(e, "is_user_annotation", False) or e.name.startswith("motionnet.")

    spans = sorted((e for e in device if is_span(e)), key=lambda e: e.time_range.start)
    span_starts = [s.time_range.start for s in spans]
    kernels = [e for e in device if not is_span(e)]
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    busy_per_fwd = busy_ms / ITERS
    # the profiled forwards' device window: first kernel start to last end
    window_per_fwd = ((max(e.time_range.end for e in kernels)
                       - min(e.time_range.start for e in kernels)) / 1e3 / ITERS
                      if kernels else None)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    # per stage: the kernels that start inside the stage's device span
    # (the spans of one stream do not overlap)
    stage_kernels: dict[str, list] = collections.defaultdict(list)
    for e in kernels:
        i = bisect.bisect_right(span_starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i].time_range.end:
            stage_kernels[spans[i].name.split(".", 1)[-1]].append(e)
    stage_busy = {k: _union_us([(e.time_range.start, e.time_range.end) for e in v])
                  / 1e3 / ITERS for k, v in stage_kernels.items()}
    stage_launches = {k: len(v) / ITERS for k, v in stage_kernels.items()}

    print(f"val forward (B=1, default config): median {fwd_ms:.3f} ms of {ITERS} "
          f"on {smi}")
    print("per stage and forward: device ms between the stage's CUDA events (median), "
          "kernel-busy ms and kernel launches (profiled):")
    for k, v in stages.items():
        print(f"  {k:16s} {v:9.3f} {stage_busy.get(k, 0.0):9.3f} "
              f"{stage_launches.get(k, 0.0):7.0f}")
    print(f"  {'sum':16s} {sum(stages.values()):9.3f} {sum(stage_busy.values()):9.3f} "
          f"{sum(stage_launches.values()):7.0f}")
    if kernels:
        print(f"profiled: device busy {busy_per_fwd:.3f} ms of a {window_per_fwd:.3f} ms "
              f"device window per forward (busy share {busy_per_fwd / window_per_fwd:.3f}); "
              f"{len(kernels) / ITERS:.0f} kernels per forward")
        print("kernels by device time (ms per forward, launches per forward):")
        for name, (ms, cnt) in top:
            print(f"  {ms / ITERS:8.3f} {cnt // ITERS:5d}  {name[:110]}")
    else:
        print("the profiler recorded no device kernels: busy share not measured")
    print(json.dumps({
        "card": smi, "forward_ms": fwd_ms, "forward_ms_all": host_ms, "stage_ms": stages,
        "stage_busy_ms": stage_busy, "stage_launches": stage_launches,
        "busy_ms_per_forward": busy_per_fwd if kernels else None,
        "profiled_window_ms_per_forward": window_per_fwd,
        "kernels_per_forward": len(kernels) / ITERS,
        "top_kernels": [{"name": n[:200], "ms_per_forward": ms / ITERS,
                         "launches_per_forward": c / ITERS} for n, (ms, c) in top],
    }), flush=True)


if __name__ == "__main__":
    main()
