"""Where the val forward's, the test forward's and the training
micro-step's time goes on the card.

    python -m pcaccumulation_tpu_torch.profile_forward [--train | --test | --serve] [config.yaml [--a.b=v ...]]

Builds the MotionNet of the given config (default: configs/default.yaml;
e.g. `--train configs/nuscene.yaml` for the nuScenes preset's bf16
micro-step) at full width with seeded random
weights on synthetic scenes at the config's capacities (`default_scenes`),
warms it up, then measures:
- the forward's (with --train: the micro-step's) median time on the host
  clock, synchronised; --test times the test-mode forward (clustering,
  instance reconstruction of the clusters) with both ICPs on at the
  config's 50 iterations, the FB and MOS heads set to the scene's label
  shares (`calibrate_heads`); --serve times the test-mode forward as the
  serving step runs it, with the config's ICP setting (off in the shipped
  configs), the heads set as with --test, and first splits the host side
  of one `Predictor.predict` on those weights (`serve_host_split`): the
  median host ms of each stage, on the native preparation path and on
  numpy's (`PCACC_NATIVE=0`), in one process;
- each stage's device time, from CUDA events around the forward's
  `motionnet.<stage>` ranges (see models/motionnet.py; the ICP ranges
  `icp_ego` and `icp_instance` lie inside `ego` and `reconstruction`, so
  they are shares of those, not stages of their own). With --train also
  each stage's backward: the saved tensors of a stage's forward carry its
  label, and every backward node that unpacks one records a CUDA event; the
  device time from one event to the next goes to that event's stage (nodes
  that save nothing count to the stage before them). The loss, the rest of
  the backward and the optimizer update get their own rows;
- with torch.profiler over ITERS forwards (micro-steps): the kernels by
  device time, each forward stage's kernel launches and kernel-busy time,
  and the device's busy share (the union of kernel intervals over the
  profiled window).
It prints a readable table and, as its last line, one JSON object with the
same numbers. Without a CUDA device it exits 1. The training micro-step is
the Trainer's: B=4, iter_size 2, train-mode BN, the random keypoint draw.
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
NESTED = ("icp_ego", "icp_instance")  # ranges inside the ego and reconstruction stages


def default_samples(cfg: dict, n: int, first: int = 0) -> list[dict]:
    """n raw synthetic samples (`generate_sample`, seeds first..first+n-1)
    at the config's sweeps and rate, with enough points to fill
    `max_points`: 40 static clusters and 6 moving objects at the default
    config's 5 sweeps; at more sweeps (the nuScenes preset's 11 at 20 Hz)
    32 static clusters and 6 moving objects of fewer points per sweep
    (~10,700 points and ~3,300 pillars each), so that every sweep fits the
    pillar capacity."""
    from pcaccumulation_tpu_torch.data.synthetic import generate_sample

    t = cfg["voxel_generator"]["n_sweeps"]
    dense = t <= 5
    kw = dict(n_static_clusters=40 if dense else 32, n_dynamic=6,
              pts_per_cluster=900 if dense else 400, pts_per_object=500 if dense else 230)
    if not dense:
        kw["freq"] = cfg["data"]["freq"]
    return [generate_sample(seed=s, n_frames=t, **kw) for s in range(first, first + n)]


def default_scenes(cfg: dict, n: int) -> list[dict]:
    """`default_samples` prepared at the config's capacities."""
    from pcaccumulation_tpu_torch.data.dataset import prep_sample

    return [prep_sample(s, cfg) for s in default_samples(cfg, n)]


def shift_to_share(bias: torch.Tensor, margins: torch.Tensor, share: float) -> float:
    """Lower bias[1] (a head's class-1 logit) so that `share` of the rows
    with these class-1 margins decide for class 1; the threshold goes to the
    middle of the widest gap among the margins within 1 % of that quantile,
    so that no row lies near it. Returns the shift."""
    d = torch.sort(margins.float()).values
    n = len(d)
    target = min(max(int(round((1.0 - share) * n)), 1), n - 1)
    lo, hi = max(1, target - n // 100), min(n - 1, target + n // 100)
    i = lo + int(torch.argmax(d[lo:hi + 1] - d[lo - 1:hi]))
    shift = float(d[i - 1] + d[i]) / 2
    with torch.no_grad():
        bias[1] -= shift
    return shift


def calibrate_heads(model, batch) -> tuple[float, float]:
    """Set the FB and MOS heads' class-1 biases of the seeded random weights
    so that the forward splits the scene as its labels do: the share of
    estimated-FG pillars is the share of FG points, and the share of moving
    decoded rows is the moving share of the FG points. (Seeded random
    weights call every pillar FG and every FG point moving, and the test
    path then has no background for the ego ICP.) Returns the two shares."""
    v = batch["point_valid"]
    fb = (batch["fb_labels"] == 1) & v
    fg_share = float(fb.sum() / v.sum())
    mov_share = float(((batch["sd_labels"] == 1) & fb).sum() / fb.sum())
    with torch.no_grad():
        lp = model(batch)["fb_logit_pillar"]
        shift_to_share(model.semseg_head.seg_head[3].bias,
                       (lp[..., 1] - lp[..., 0])[batch["pillar_valid"]], fg_share)
        out = model(batch)
        ms = out["mos_sub"][out["sub_valid"]]
        shift_to_share(model.motionhead.mos_seg.seg_head[3].bias, ms[:, 1] - ms[:, 0],
                       mov_share)
    return fg_share, mov_share


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _StageEvents:
    """Stands in for `record_function` in models/motionnet.py: records a
    CUDA event pair around each stage and keeps the pairs per label. With
    `backward_marks` set to a list, the stage's saved tensors are tagged
    with its label, and each unpack in the backward appends (label, event)
    to the list."""

    pairs: dict[str, list] = collections.defaultdict(list)
    backward_marks: list | None = None

    def __init__(self, label: str):
        self.label = label.split(".", 1)[-1]
        self.hooks = None

    def __enter__(self):
        self.start = _event()
        if self.backward_marks is not None:
            marks, label = self.backward_marks, self.label

            def unpack(packed):
                marks.append((label, _event()))
                return packed

            self.hooks = torch.autograd.graph.saved_tensors_hooks(lambda t: t, unpack)
            self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        if self.hooks is not None:
            self.hooks.__exit__(*exc)
        self.pairs[self.label].append((self.start, _event()))
        return False


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _kernel_summary(prof, iters: int) -> dict:
    """Kernels by device time, busy time and device window per iteration,
    and each forward stage's kernel-busy time and launches, from a profile
    of `iters` iterations."""
    # device events are kernels, copies and the device-side spans of the
    # `motionnet.<stage>` annotations; the spans are not work
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    def is_span(e):
        return getattr(e, "is_user_annotation", False) or e.name.startswith("motionnet.")

    spans = sorted((e for e in device if is_span(e)), key=lambda e: e.time_range.start)
    span_starts = [sp.time_range.start for sp in spans]

    def innermost(start):
        """The latest-starting span that still contains `start` (the ICP
        spans nest inside their stage's span)."""
        i = bisect.bisect_right(span_starts, start) - 1
        while i >= 0 and start >= spans[i].time_range.end:
            i -= 1
        return spans[i] if i >= 0 else None

    kernels = [e for e in device if not is_span(e)]
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / iters
    # the profiled device window: first kernel start to last end
    window = ((max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3 / iters if kernels else None)
    # per stage: the kernels that start inside the stage's innermost span
    stage_kernels: dict[str, list] = collections.defaultdict(list)
    for e in kernels:
        span = innermost(e.time_range.start)
        if span is not None:
            stage_kernels[span.name.split(".", 1)[-1]].append(e)
    return {
        "n_kernels": len(kernels), "busy_ms": busy if kernels else None, "window_ms": window,
        "top": sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20],
        "stage_busy": {k: _union_us([(e.time_range.start, e.time_range.end) for e in v])
                       / 1e3 / iters for k, v in stage_kernels.items()},
        "stage_launches": {k: len(v) / iters for k, v in stage_kernels.items()},
    }


def _print_kernels(summary: dict, iters: int, what: str) -> None:
    if not summary["n_kernels"]:
        print("the profiler recorded no device kernels: busy share not measured")
        return
    busy, window = summary["busy_ms"], summary["window_ms"]
    print(f"profiled: device busy {busy:.3f} ms of a {window:.3f} ms device window per {what} "
          f"(busy share {busy / window:.3f}); {summary['n_kernels'] / iters:.0f} kernels per "
          f"{what}")
    print(f"kernels by device time (ms per {what}, launches per {what}):")
    for name, (ms, cnt) in summary["top"]:
        print(f"  {ms / iters:8.3f} {cnt // iters:5d}  {name[:110]}")


def _summary_json(summary: dict, iters: int, what: str) -> dict:
    return {
        f"busy_ms_per_{what}": summary["busy_ms"],
        f"profiled_window_ms_per_{what}": summary["window_ms"],
        f"kernels_per_{what}": summary["n_kernels"] / iters,
        "top_kernels": [{"name": n[:200], f"ms_per_{what}": ms / iters,
                         f"launches_per_{what}": c / iters}
                        for n, (ms, c) in summary["top"]],
    }


def _profile(run, iters: int):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(iters):
            run(i)
        torch.cuda.synchronize()
    return _kernel_summary(prof, iters)


def _with_stage_events(run, iters: int, backward_marks: list | None = None) -> dict:
    """Run `iters` iterations with the stage ranges replaced by CUDA event
    pairs; returns the median device ms per stage."""
    from pcaccumulation_tpu_torch.models import egomotion, motionnet, tpointnet

    _StageEvents.pairs.clear()
    _StageEvents.backward_marks = backward_marks
    modules = (motionnet, egomotion, tpointnet)
    for mod in modules:
        mod.record_function = _StageEvents
    try:
        for i in range(iters):
            run(i)
        torch.cuda.synchronize()
    finally:
        for mod in modules:
            mod.record_function = torch.profiler.record_function
        _StageEvents.backward_marks = None
    return {k: statistics.median(a.elapsed_time(b) for a, b in v)
            for k, v in _StageEvents.pairs.items()}


def _host_ms(run, iters: int) -> list[float]:
    out = []
    for i in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


# one predict's stages, in order: prep_sample's (data/dataset.py), then the
# Predictor's (serve.py); "step" is the device's share, the rest the host's
SERVE_STAGES = ("crop_ground", "voxelise", "sort", "gather", "pad", "collate", "h2d", "step",
                "fetch", "postproc")


def serve_host_split(pred, scans: list, iters: int = ITERS) -> dict:
    """{"native" | "numpy": {stage: median ms}} over `iters` predicts of the
    raw (points, time_idx) `scans` in turn, after one warm-up, with
    `data/voxelizer.py`'s flag set for each path and put back after. Each
    stage runs as `Predictor.predict` runs it and ends in a synchronise:
    SERVE_STAGES, their sum ("total"), the host's part of it ("host":
    every stage but the step), and "predict", the median of `iters` whole
    predicts on the host clock."""
    from pcaccumulation_tpu_torch.data import voxelizer
    from pcaccumulation_tpu_torch.data.dataset import prep_sample
    from pcaccumulation_tpu_torch.data.loader import collate

    def since(t0: float) -> float:
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    saved, out = voxelizer._USE_NATIVE, {}
    try:
        for path in ("native", "numpy"):
            voxelizer._USE_NATIVE = path == "native"
            rows = collections.defaultdict(list)
            for i in range(iters + 1):
                st = {}
                sample = prep_sample(pred._wrap(*scans[i % len(scans)]), pred.cfg,
                                     with_labels=False, stage_ms=st)
                t0 = time.perf_counter()
                batch = collate([sample])
                st["collate"] = since(t0)
                t0 = time.perf_counter()
                dbatch = pred._to_device(batch)
                st["h2d"] = since(t0)
                with torch.inference_mode():
                    t0 = time.perf_counter()
                    res = pred._run_step(dbatch)
                    st["step"] = since(t0)
                    t0 = time.perf_counter()
                    fetched = pred._fetch(res)
                    st["fetch"] = since(t0)
                t0 = time.perf_counter()
                pred._postproc(batch, fetched)
                st["postproc"] = since(t0)
                if i:  # the first call warms up
                    for k in SERVE_STAGES:
                        rows[k].append(st[k])
                    rows["total"].append(sum(st[k] for k in SERVE_STAGES))
                    rows["host"].append(rows["total"][-1] - st["step"])
            out[path] = {k: statistics.median(v) for k, v in rows.items()}
            out[path]["predict"] = statistics.median(_host_ms(
                lambda i: pred.predict(*scans[i % len(scans)]), iters))
    finally:
        voxelizer._USE_NATIVE = saved
    return out


def print_host_split(split: dict, what: str, iters: int = ITERS) -> None:
    print(f"host split of one predict ({what}), median ms of {iters} calls per stage:")
    cols = (*SERVE_STAGES, "total", "host", "predict")
    print("  " + " ".join(f"{k:>11s}" for k in ("path", *cols)))
    for path, row in split.items():
        print("  " + f"{path:>11s} " + " ".join(f"{row[k]:11.3f}" for k in cols))


def test_mode_config(cfg: dict, icp_max_iter: int = 50) -> dict:
    """cfg with both ICP refinements on at `icp_max_iter` iterations."""
    cfg["pose_estimation"].update(icp=True, icp_max_iter=icp_max_iter)
    cfg["tpointnet"].update(icp=True, icp_max_iter=icp_max_iter)
    return cfg


def profile_val(port, cfg, smi: str, mode: str = "val",
                name: str = "configs/default.yaml", serve: bool = False) -> None:
    from pcaccumulation_tpu_torch.data.dataset import prep_sample
    from pcaccumulation_tpu_torch.data.loader import collate

    cfg["pose_estimation"]["deterministic_sampling"] = True
    raw = default_samples(cfg, 3)
    batches = [port.to_device(collate([prep_sample(s, cfg)])) for s in raw]
    torch.manual_seed(SEED)
    model = port.build_model(cfg)
    if mode == "test":
        calibrate_heads(model, batches[0])
    split = {}
    if serve:
        from pcaccumulation_tpu_torch.serve import Predictor

        pred = Predictor(cfg, state_dict=model.state_dict())
        split = serve_host_split(pred, [(s["raw_points"], s["time_indice"]) for s in raw])
        print_host_split(split, f"{name} on {smi}")

    def run(i):
        model(batches[i % len(batches)], mode=mode)

    with torch.no_grad():
        for i in range(len(batches)):
            run(i)
        host_ms = _host_ms(run, ITERS)
        fwd_ms = statistics.median(host_ms)
        stages = _with_stage_events(run, ITERS)
        summary = _profile(run, ITERS)
    stage_busy, stage_launches = summary["stage_busy"], summary["stage_launches"]

    print(f"{mode} forward (B=1, {name}): median {fwd_ms:.3f} ms of {ITERS} "
          f"on {smi}")
    print("per stage and forward: device ms between the stage's CUDA events (median), "
          "kernel-busy ms and kernel launches (profiled):")
    for k, v in stages.items():
        print(f"  {k:16s} {v:9.3f} {stage_busy.get(k, 0.0):9.3f} "
              f"{stage_launches.get(k, 0.0):7.0f}")
    top = [k for k in stages if k not in NESTED]
    print(f"  {'sum':16s} {sum(stages[k] for k in top):9.3f} {sum(stage_busy.values()):9.3f} "
          f"{sum(stage_launches.values()):7.0f}   (the icp rows are part of ego and "
          f"reconstruction; busy and launches count each kernel once)")
    _print_kernels(summary, ITERS, "forward")
    print(json.dumps({
        "card": smi, "mode": mode, "forward_ms": fwd_ms, "forward_ms_all": host_ms,
        "stage_ms": stages,
        "stage_busy_ms": stage_busy, "stage_launches": stage_launches,
        **_summary_json(summary, ITERS, "forward"), **({"host_split_ms": split} if serve else {}),
    }), flush=True)


def profile_train(port, cfg, smi: str, name: str = "configs/default.yaml") -> None:
    import tempfile

    from pcaccumulation_tpu_torch.data.loader import collate
    from pcaccumulation_tpu_torch.train.loss import fuse_loss
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    bsz = cfg["train"]["batch_size"]
    scenes = default_scenes(cfg, 2 * bsz)
    batches = [port.to_device(collate(scenes[i * bsz:(i + 1) * bsz])) for i in range(2)]
    torch.manual_seed(SEED)
    model = port.build_model(cfg)
    with tempfile.TemporaryDirectory() as run_dir:
        tr = Trainer(cfg, model, {"train": batches}, save_dir=run_dir)

        def run(i):
            tr.train_step(batches[i % 2], tr.step_generator(0, "train", i))

        for i in range(3):
            run(i)
        torch.cuda.reset_peak_memory_stats()
        host_ms = _host_ms(run, ITERS)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        # the Trainer's step written out, with events between its parts
        parts = collections.defaultdict(list)
        marks: list = []

        def run_parts(i):
            marks.clear()
            e0 = _event()
            tr.model.train()
            bt = batches[i % 2]
            results = tr.model(bt, mode="train", generator=tr.step_generator(0, "train", i))
            e1 = _event()
            stats = fuse_loss(results, bt, cfg["loss"], cfg["capacity"]["max_instances"])
            for p in tr.params:
                p.grad = None
            e2 = _event()
            marks.append(("loss", e2))
            stats["loss"].backward()
            e3 = _event()
            tr.optimizer.update([p.grad for p in tr.params])
            e4 = _event()
            torch.cuda.synchronize()
            parts["forward"].append(e0.elapsed_time(e1))
            parts["loss"].append(e1.elapsed_time(e2))
            parts["backward"].append(e2.elapsed_time(e3))
            parts["optimizer"].append(e3.elapsed_time(e4))
            bwd = collections.defaultdict(float)
            seq = marks + [("end", e3)]
            for (label, a), (_, b) in zip(seq, seq[1:]):
                bwd[label] += a.elapsed_time(b)
            for k, v in bwd.items():
                parts[f"bwd.{k}"].append(v)

        stages = _with_stage_events(run_parts, ITERS, backward_marks=marks)
        summary = _profile(run, ITERS)
    part_ms = {k: statistics.median(v) for k, v in parts.items()}
    step_ms = statistics.median(host_ms)
    print(f"train micro-step (B={bsz}, iter_size {cfg['train']['iter_size']}, "
          f"{name}, compute dtype {cfg['precision']['compute_dtype']}): median "
          f"{step_ms:.3f} ms of {ITERS}; peak memory {peak_gib:.3f} GiB; on {smi}")
    print("parts of the micro-step, device ms between CUDA events (median): " + ", ".join(
        f"{k} {part_ms[k]:.3f}" for k in ("forward", "loss", "backward", "optimizer")))
    print("per stage: forward device ms (stage events) and backward device ms (saved-tensor "
          "marks), median:")
    for k in stages:
        print(f"  {k:16s} {stages[k]:9.3f} {part_ms.get(f'bwd.{k}', 0.0):9.3f}")
    print(f"  {'loss':16s} {part_ms['loss']:9.3f} {part_ms.get('bwd.loss', 0.0):9.3f}")
    _print_kernels(summary, ITERS, "step")
    print(json.dumps({
        "card": smi, "config": name, "train_step_ms": step_ms,
        "train_step_ms_all": host_ms, "peak_gib": peak_gib,
        "part_ms": part_ms, "stage_fwd_ms": stages,
        **_summary_json(summary, ITERS, "step"),
    }), flush=True)


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        sys.exit(1)

    import pcaccumulation_tpu_torch as port
    from pcaccumulation_tpu_torch.config import load_config
    from pcaccumulation_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    build.build_all()
    args = argv[1:]
    modes = [a for a in args if a in ("--train", "--test", "--serve")]
    paths = [a for a in args if a.endswith(".yaml")]
    overrides = [a for a in args if a not in modes and a not in paths]
    if len(modes) > 1 or len(paths) > 1:
        raise SystemExit(__doc__)
    cfg = load_config(paths[0] if paths else None, overrides)
    name = paths[0] if paths else "configs/default.yaml"
    if "--train" in modes:
        profile_train(port, cfg, smi, name)
    elif "--test" in modes:
        profile_val(port, test_mode_config(cfg), smi, mode="test", name=name)
    elif "--serve" in modes:
        profile_val(port, cfg, smi, mode="test", name=name, serve=True)
    else:
        profile_val(port, cfg, smi, name=name)


if __name__ == "__main__":
    main(sys.argv)
