"""Deployment inference API of the port: the test-mode MotionNet as a
label-free predictor (the port of the JAX package's `serve.py`).

    pred = Predictor(cfg, ckpt_path="snapshot/exp/model_best_metric.ckpt")
    out = pred.predict(points, time_idx)       # one T-frame sequence
    for out in pred.predict_stream(scans):     # overlapped host/device
        ...
    pred.export("model.pt2")                   # torch.export artifact

    served = ExportedPredictor("model.pt2")    # builds no MotionNet
    out = served.predict(points, time_idx)

Input is the raw sensor contract (per-frame sensor-coordinate points and
their frame indices, `raw_points` / `time_indice` of the dataset); no
labels are needed. Outputs are numpy arrays over the points that survived
the crop and the ground filter. The checkpoint may be in any form
`utils/checkpoint.py::read_checkpoint` reads.

The step runs on the card unless the caller passes `device="cpu"`. The
JAX package keeps one jitted step per config (`_STEP_CACHE`); PyTorch
compiles nothing, so the port has no such cache.

Latency-sharded serving (`Predictor(cfg, mesh=parallel.mesh.make_mesh(F,
S))`, on every process of the mesh with the same scans): the sequence's
UNet is split over the mesh's frame and spatial axes as in training, and
every process returns the same outputs, those of one process. `export`
stays a one-process artifact.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import zipfile

import numpy as np
import torch

# the kernels' operators (torch.ops.pcacc.*) must be registered before an
# exported program that calls them is loaded
import pcaccumulation_tpu_torch.kernels.chamfer  # noqa: F401
import pcaccumulation_tpu_torch.kernels.row_shift  # noqa: F401
import pcaccumulation_tpu_torch.kernels.segscan  # noqa: F401
from pcaccumulation_tpu_torch import build_model, resolve_device
from pcaccumulation_tpu_torch.config import check_supported
from pcaccumulation_tpu_torch.data.dataset import prep_sample
from pcaccumulation_tpu_torch.data.loader import collate
from pcaccumulation_tpu_torch.parallel import mesh as pmesh
from pcaccumulation_tpu_torch.utils.checkpoint import partial_load, read_checkpoint

# bump when the artifact's contents change (its inputs, outputs or files)
EXPORT_FORMAT_VERSION = 1

# batch fields that are the same in every serving call (the neutral
# ground truth `_wrap` builds: zero labels, identity poses): they live on
# the device once instead of riding every predict's transfer
_CONST_KEYS = ("sd_labels", "fb_labels", "inst_labels", "sem_labels",
               "ego_motion_gt", "inst_motion_gt")


class _Step(torch.nn.Module):
    """The test-mode step. Its outputs ship narrow, as the JAX step's do:
    mos and fb as uint8, instance labels as uint16, and no
    transformed_points (the host rebuilds it from points and ego_motion)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: dict, kpt_scores: torch.Tensor | None = None) -> dict:
        r = self.model(batch, mode="test", kpt_scores=kpt_scores)
        return {
            "rec_points": r["rec_est"],
            "ego_motion": r["ego_motion_est"],
            "mos": torch.argmax(r["mos_est"], -1).to(torch.uint8),
            "fb": r["fb_est_per_points"].to(torch.uint8),
            "inst_labels": r["inst_labels_est"].to(torch.uint16),
            "offset": r["offset_est"],
        }


class Predictor:
    """Predictor over the config's fixed capacities (`capacity`): every
    call pads to the same shapes; a scan beyond them is cut the way the
    training pipeline cuts it.

    Weights: `state_dict` (the port's names), else the model of the
    checkpoint at `ckpt_path` (either package's) over a seeded default
    initialisation (entries that match by name and shape), else the seeded
    default initialisation. The random keypoint draw's uniform scores are
    drawn once, on the device, from a generator seeded with `rng_seed`, and
    fed to every call: the same scan gives the same output, call after
    call (with `pose_estimation.deterministic_sampling` nothing is drawn).

    `mesh` (`parallel.mesh.make_mesh`, made by every process of the group):
    latency-sharded serving, the UNet split over its frame and spatial
    axes, which must be the config's `parallel.frame_devices` and
    `parallel.spatial_devices`; each process predicts the same scans. A
    data axis serves the same sequence on each of its coordinates. Without
    a mesh a config saved by a run on one predicts in one process.
    """

    def __init__(self, cfg: dict, state_dict: dict | None = None,
                 ckpt_path: str | None = None, rng_seed: int = 0, device=None, mesh=None):
        if mesh is None:
            check_supported(cfg, mesh_axes=False)
        else:
            check_supported(cfg, pmesh.world(mesh.world_group))
            par = cfg.get("parallel", {})
            want = (par.get("frame_devices", 1), par.get("spatial_devices", 1))
            if (mesh.frame, mesh.spatial) != want:
                raise ValueError(f"a mesh of frame {mesh.frame} x spatial {mesh.spatial} for "
                                 f"parallel.frame_devices={want[0]} x "
                                 f"parallel.spatial_devices={want[1]}")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_frames = cfg["voxel_generator"]["n_sweeps"]
        model = build_model(cfg, self.device, torch.Generator().manual_seed(0))
        if state_dict is None and ckpt_path:
            state_dict = partial_load(read_checkpoint(ckpt_path)["model"], model.state_dict())
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model
        self._step = _Step(model).eval()
        self._scores = self._draw_scores(rng_seed)
        self._const_dev = None  # the first _to_device call fills it
        self.h2d_bytes = 0  # bytes the last _to_device call moved to the device

    def _draw_scores(self, rng_seed: int) -> torch.Tensor | None:
        if self.cfg["pose_estimation"].get("deterministic_sampling", False):
            return None
        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        shape = (1, self.n_frames, self.cfg["capacity"]["max_pillars"])
        return torch.rand(shape, generator=gen, device=self.device)

    def _dummy_scan(self):
        t = self.n_frames
        pts = np.random.default_rng(0).uniform(-20, 20, (t * 64, 3)).astype(np.float32)
        pts[:, 2] = np.abs(pts[:, 2]) * 0.1 + 0.5
        return pts, np.repeat(np.arange(t), 64).astype(np.int32)

    def _wrap(self, points, time_idx) -> dict:
        """Raw scan -> the dataset's dict with neutral ground truth (test
        mode reads it only for metric outputs). A malformed scan fails here
        with a clear message."""
        t = self.n_frames
        points = np.asarray(points, np.float32)
        time_idx = np.asarray(time_idx)
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError(
                f"points must be [m, 3] sensor-frame xyz; got {points.shape}")
        if time_idx.shape != (points.shape[0],):
            raise ValueError(
                f"time_idx must be [m] = [{points.shape[0]}] frame indices; "
                f"got {time_idx.shape}")
        if not np.issubdtype(time_idx.dtype, np.integer):
            raise ValueError(f"time_idx must be integer, got {time_idx.dtype}")
        if time_idx.size and (time_idx.min() < 0 or time_idx.max() >= t):
            raise ValueError(
                f"time_idx values must lie in [0, n_frames={t}); got "
                f"[{time_idx.min()}, {time_idx.max()}]")
        k = self.cfg["capacity"]["max_instances"]
        zeros = np.zeros(points.shape[0], np.int32)
        return {
            "raw_points": points,
            "time_indice": time_idx.astype(np.int32),
            "sd_labels": zeros, "fb_labels": zeros, "inst_labels": zeros, "sem_labels": zeros,
            "ego_motion_gt": np.broadcast_to(np.eye(4, dtype=np.float32), (t, 4, 4)).copy(),
            "bbox_tsfm": np.broadcast_to(np.eye(4, dtype=np.float32), (k, t, 4, 4)).copy(),
        }

    def _prep(self, points, time_idx) -> dict:
        # with_labels=False: the neutral labels need no gathering, and their
        # device copies are the cached _CONST_KEYS anyway
        return collate([prep_sample(self._wrap(points, time_idx), self.cfg, augment=False,
                                    with_labels=False)])

    def _to_device(self, batch: dict) -> dict:
        """A prepped batch on the device: each array from pinned host memory,
        `non_blocking`, on the current stream; the neutral ground-truth
        fields from the device copies of the first call.

        That substitution is sound only because every batch comes from
        `_wrap`, whose ground truth is always neutral; a batch with real
        labels would see them dropped, so an all-zero scan of sd_labels
        guards it (assert-based: `-O` removes it)."""
        sd = np.asarray(batch["sd_labels"])
        assert sd.size == 0 or not sd.any(), (
            "_to_device caches neutral-GT leaves; batches with real "
            "labels must not flow through the serving path")
        cuda = self.device.type == "cuda"

        def put(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if cuda:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=cuda)

        if self._const_dev is None:
            self._const_dev = {k: put(batch[k]) for k in _CONST_KEYS}
        self.h2d_bytes = sum(np.asarray(v).nbytes for k, v in batch.items()
                             if k not in _CONST_KEYS)
        return {k: self._const_dev[k] if k in _CONST_KEYS else put(v)
                for k, v in batch.items()}

    def _run_step(self, dbatch: dict) -> dict:
        args = (dbatch,) if self._scores is None else (dbatch, self._scores)
        with pmesh.model_parallel(self.mesh):
            return self._step(*args)

    def _invoke(self, dbatch: dict):
        """Launch the step and the copy of its outputs to the host; returns
        what `_fetch` returns."""
        with torch.inference_mode():
            return self._fetch(self._run_step(dbatch))

    def _fetch(self, out: dict):
        """Launch the copy of the step's outputs to the host (pinned,
        `non_blocking` on the card); returns (host outputs, an event that
        marks the copy's end, or None on the CPU)."""
        if self.device.type != "cuda":
            return out, None
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in out.items()}
        for k, v in out.items():
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _postproc(self, batch: dict, fetched) -> dict:
        """Wait for the outputs, trim them to the valid points, restore the
        public int32 label dtypes, and rebuild flow and transformed_points on
        the host."""
        out, done = fetched
        if done is not None:
            done.synchronize()
        out = {k: v.numpy() for k, v in out.items()}
        valid = np.asarray(batch["point_valid"][0])
        res = {k: v[0][valid] for k, v in out.items() if k != "ego_motion"}
        for k in ("mos", "fb", "inst_labels"):
            res[k] = res[k].astype(np.int32)
        res["points"] = np.asarray(batch["points"][0])[valid]
        res["time_idx"] = np.asarray(batch["time_idx"][0])[valid]
        res["flow"] = res["rec_points"] - res["points"]
        res["ego_motion"] = out["ego_motion"][0]
        # == se3.ego_motion_compensation(points, time_idx, ego_motion) on the
        # valid points, rebuilt here to keep [N, 3] floats off the transfer
        rows = res["ego_motion"][res["time_idx"]]
        res["transformed_points"] = (
            np.einsum("nij,nj->ni", rows[:, :3, :3], res["points"]) + rows[:, :3, 3]
        ).astype(np.float32)
        return res

    def predict(self, points: np.ndarray, time_idx: np.ndarray) -> dict:
        """One T-frame sequence: points [m, 3] (per-frame sensor coords),
        time_idx [m] in [0, n_frames). Returns numpy arrays over the points
        that survived preprocessing: points, time_idx, rec_points (the
        accumulated anchor-frame cloud), flow, transformed_points, mos
        (1 = moving), fb (1 = foreground), inst_labels, offset, and
        ego_motion [T, 4, 4]."""
        batch = self._prep(points, time_idx)
        return self._postproc(batch, self._invoke(self._to_device(batch)))

    def predict_stream(self, scans, prefetch: int = 2, depth: int = 1):
        """Iterate over (points, time_idx) pairs through three stages: a
        producer thread preprocesses the next scans and moves them to the
        device on a side CUDA stream, recording an event after each; the
        caller's thread waits on that event, launches the step, and fetches
        each result `depth` items later, so that the fetch overlaps the next
        launch. Results come in input order; an exception of the producer
        reaches the caller."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        err: list = []
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        stop = threading.Event()

        def producer():
            try:
                for pts, tid in scans:
                    if stop.is_set():
                        break
                    batch = self._prep(pts, tid)
                    if cuda:
                        with torch.cuda.stream(side):
                            dbatch = self._to_device(batch)
                            ready = torch.cuda.Event()
                            ready.record(side)
                    else:
                        dbatch, ready = self._to_device(batch), None
                    q.put((batch, dbatch, ready))
            except Exception as e:  # reaches the caller; never deadlocks it
                err.append(e)
            finally:
                q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        pending: collections.deque = collections.deque()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                batch, dbatch, ready = item
                if cuda:
                    main = torch.cuda.current_stream(self.device)
                    main.wait_event(ready)
                    for t in dbatch.values():
                        t.record_stream(main)  # made on the side stream, read on this one
                pending.append((batch, self._invoke(dbatch)))
                if len(pending) > depth:
                    yield self._postproc(*pending.popleft())
            while pending:
                yield self._postproc(*pending.popleft())
        finally:
            stop.set()
            while th.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    th.join(0.01)
        if err:
            raise err[0]

    def export(self, path: str) -> None:
        """Export the test-mode step with `torch.export` to one artifact: the
        graph of ATen operators and the port's kernel operators
        (`torch.ops.pcacc.*`), the weights inside it, and as extra files the
        config (for the host's preprocessing), `EXPORT_FORMAT_VERSION` and
        the device type it was exported on, whose kernels it calls.
        `ExportedPredictor` serves it without building a MotionNet or
        reading a checkpoint.

        The clustering runs all its `cluster.bfs_iters` passes in the graph
        (no host read; the same labels as eager serving's early exit). With
        `pose_estimation.icp` or `tpointnet.icp` on, the graph holds the
        ICP loops unrolled, K4 (`torch.ops.pcacc.nn_packed`) called once
        per iteration: its grid comes from the shapes, so no count is read
        to the host. Under a mesh it raises NotImplementedError, as the JAX
        package's does.
        """
        if self.mesh is not None:
            raise NotImplementedError(
                "export targets single-device deployment artifacts; build the Predictor "
                "without a mesh to export, and pass mesh= at serve time for latency-sharded "
                "serving")
        dbatch = self._to_device(self._prep(*self._dummy_scan()))
        args = (dbatch,) if self._scores is None else (dbatch, self._scores)
        with torch.no_grad():
            program = torch.export.export(self._step, args, strict=False)
        torch.export.save(program, path, extra_files={
            "config.json": json.dumps(self.cfg),
            "format_version": str(EXPORT_FORMAT_VERSION),
            "device_type": self.device.type,
        })


def _artifact_files(path: str) -> dict:
    """The extra files of a `torch.export.save` archive, read without
    loading its program or weights."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            head, _, base = name.rpartition("/extra/")
            if head and "/" not in head and "/" not in base:
                out[base] = z.read(name).decode()
    return out


class ExportedPredictor(Predictor):
    """Serve a `Predictor.export` artifact: graph and weights come from the
    `torch.export` program (no MotionNet is built, no checkpoint is read);
    the bundled config drives the same host preprocessing. Same `predict`
    and `predict_stream`. `device` (None = CUDA) must be of the device type
    the artifact was exported on; `rng_seed` seeds the keypoint draw's
    scores as in `Predictor`."""

    def __init__(self, path: str, rng_seed: int = 0, device=None):
        files = _artifact_files(path)
        version = int(files.get("format_version") or 0)
        if version != EXPORT_FORMAT_VERSION:
            raise ValueError(
                f"export artifact {path!r} has format_version {version}; this build reads "
                f"version {EXPORT_FORMAT_VERSION}: re-export with Predictor.export")
        self.device = resolve_device(device)
        exported_on = files.get("device_type")
        if exported_on != self.device.type:
            raise RuntimeError(
                f"export artifact {path!r} was exported for device type {exported_on!r}, but "
                f"it would run on {self.device.type!r}; re-export on this device type (the "
                "graph calls that device's kernels)")
        self.cfg = json.loads(files["config.json"])
        self.n_frames = self.cfg["voxel_generator"]["n_sweeps"]
        self._program = torch.export.load(path).module()
        self.model = None
        self._scores = self._draw_scores(rng_seed)
        self._const_dev = None
        self.h2d_bytes = 0

    def export(self, path: str) -> None:
        raise NotImplementedError(
            "this Predictor was loaded from an export artifact; the artifact is the "
            "exported form: copy the file instead")

    def _run_step(self, dbatch: dict) -> dict:
        args = (dbatch,) if self._scores is None else (dbatch, self._scores)
        return self._program(*args)
