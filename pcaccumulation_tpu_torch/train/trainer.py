"""Training and evaluation runtime (the port of the JAX package's
`train/trainer.py`): one process, or one process per card of a
data-parallel run (`parallel/mesh.py`).

`Optimizer` writes out by hand what the JAX package builds from optax
(`make_optimizer`), where torch's own optimizers and clipping differ:
- the MEAN of the gradients over `iter_size` micro-steps (optax.MultiSteps,
  the same running-mean update);
- a mean with a non-finite value skips the update: it advances neither
  Adam's step nor the LR schedule's count (optax.apply_if_finite). The
  accumulator then starts afresh. (optax.MultiSteps keeps a NaN in its
  accumulator after the skip, `0 * nan`, so the JAX package skips every
  later update too; the port does not.)
- clipping in optax's form: g * max_norm / |g| when |g| >= max_norm (torch's
  `clip_grad_norm_` divides by |g| + 1e-6);
- Adam (b1 0.9, b2 0.999, eps 1e-8; decoupled weight decay when
  `weight_decay` > 0) at lr0 * gamma^floor(applied updates /
  updates_per_epoch).

`Trainer` runs the epoch loop: train and val phases, host meters, the
rolling `best_loss` / `latest` / `best_metric` checkpoints, resume, and
one seeded `torch.Generator` per step for the random keypoint draw.

`train.remat` recomputes the forward and the loss in the backward pass
instead of keeping their activations (`torch.utils.checkpoint`, the
counterpart of the JAX package's `jax.checkpoint(loss_fn,
policy=nothing_saveable)`). The recompute must compute what the forward
did: the keypoint draw's scores are drawn before the checkpointed region
(the checkpoint restores only the default generators), and the train-mode
BatchNorms' running statistics, which the recompute would update a second
time, are put back after it. A remat step's gradients and statistics are
those of a plain step.

The steps run under `torch.use_deterministic_algorithms` (set on entry,
restored on exit): two steps on the same batch and weights give the same
bits on the card, as the JAX package's step does on its TPU.

Data parallel (a process group from `parallel.mesh.init_distributed`):
`train.batch_size` is per process and each step computes one process's
function on the joined batch. The forward and FuseLoss reduce over the
ranks inside `mesh.data_parallel` (BatchNorm statistics, loss sums and
counts, gates, Lovász's rows), each rank draws the joined batch's keypoint
scores and keeps its rows, and every micro-step's gradients are averaged
over the ranks in one all-reduce, so `Optimizer.update` sees the joined
gradient on every rank. With `parallel.zero1` each rank keeps Adam's
moments and the accumulators of the parameters it owns (a partition of
the parameters balanced by size), updates those, and broadcasts them; the
clip's global norm and the skip flag come from every parameter. Logs, the
architecture dump and pickle checkpoints are written by rank 0; an orbax
(torch.distributed.checkpoint) checkpoint by every rank.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.deterministic
from torch.utils.checkpoint import checkpoint

from pcaccumulation_tpu_torch import resolve_device, to_device
from pcaccumulation_tpu_torch.config import check_supported
from pcaccumulation_tpu_torch.parallel import mesh
from pcaccumulation_tpu_torch.train.loss import fuse_loss
from pcaccumulation_tpu_torch.train.metrics import (
    compute_mean_iou_recall_precision,
    init_stats_meter,
    update_stats_meter,
)
from pcaccumulation_tpu_torch.utils.checkpoint import (
    partial_load,
    read_checkpoint,
    save_checkpoint,
)
from pcaccumulation_tpu_torch.utils.logging import Logger, MetricsWriter

MOS_CLASSES = ["static", "moving"]
FB_CLASSES = ["background", "foreground"]


def partition_by_size(sizes: list, n_parts: int) -> list:
    """The owner in [0, n_parts) of each item: the largest first, each to the
    part holding the fewest elements so far (ties to the lower part)."""
    load = [0] * n_parts
    owner = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        part = min(range(n_parts), key=lambda r: (load[r], r))
        owner[i] = part
        load[part] += sizes[i]
    return owner


class Optimizer:
    """Gradient accumulation, skip-if-non-finite, global-norm clipping and
    Adam with a staircase exponential LR, as the JAX package's
    `make_optimizer` (see the module docstring). `group` and `zero1`: the
    ZeRO-1 partition of the state over the ranks of a data-parallel run;
    the state of a parameter this rank does not own is None."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, cfg: dict, updates_per_epoch: int = 1, group=None,
                 zero1: bool = False, names: list | None = None):
        self.params = list(params)
        self.names = names or [str(i) for i in range(len(self.params))]
        self.lr0 = cfg["optimizer"]["learning_rate"]
        self.weight_decay = cfg["optimizer"].get("weight_decay", 0.0)
        self.gamma = cfg["scheduler"]["exp_gamma"]
        self.updates_per_epoch = max(1, updates_per_epoch)
        self.max_norm = cfg["train"]["grad_clip"]
        self.iter_size = cfg["train"]["iter_size"]
        self.group = group if zero1 else None  # the ZeRO-1 group
        self.rank, self.world = mesh.rank(self.group), mesh.world(self.group)
        self.owner = partition_by_size([p.numel() for p in self.params], self.world)
        self.owned = [i for i, r in enumerate(self.owner) if r == self.rank]

        def zeros():
            return [torch.zeros_like(p) if r == self.rank else None
                    for p, r in zip(self.params, self.owner)]

        self.acc, self.mu, self.nu = zeros(), zeros(), zeros()
        self.mini_step = 0      # micro-steps in the current accumulation
        self.count = 0          # applied updates: Adam's step, the LR schedule's count
        self.n_skipped = 0      # updates skipped for a non-finite mean

    def lr(self) -> float:
        """The LR the next applied update uses."""
        return self.lr0 * self.gamma ** (self.count // self.updates_per_epoch)

    @torch.no_grad()
    def update(self, grads) -> bool | None:
        """Take one micro-step's gradients (one per parameter; None = zero).
        Returns None while it accumulates, then True if the mean was
        applied or False if it was skipped."""
        n = self.mini_step + 1
        for i in self.owned:
            a, g = self.acc[i], grads[i]
            a.add_(((g if g is not None else torch.zeros_like(a)) - a) / n)
        self.mini_step = n
        if n < self.iter_size:
            return None
        self.mini_step = 0
        sq, bad = self._leaf_stats()
        finite = not bool(bad.any())
        if finite:
            self._apply(torch.sqrt(sq.sum()))
        else:
            self.n_skipped += 1
        for i in self.owned:
            self.acc[i].zero_()
        return finite

    def _leaf_stats(self):
        """Each parameter's sum of squares of the accumulated mean and
        whether it holds a non-finite value, [n_params] each, on every rank
        (under ZeRO-1 each slot is filled by its owner alone, so the
        all-reduce adds zeros and the global norm has the same bits as
        without ZeRO-1)."""
        accs = [self.acc[i] for i in self.owned]
        local = (torch.stack([torch.stack([torch.sum(a * a) for a in accs]),
                              torch.stack([(~torch.isfinite(a).all()).float() for a in accs])])
                 if accs else None)
        if self.group is None:
            stats = local
        else:
            stats = torch.zeros((2, len(self.params)), device=self.params[0].device)
            if accs:
                stats[:, self.owned] = local
            dist.all_reduce(stats, group=self.group)
        return stats[0], stats[1] > 0

    def _apply(self, norm) -> None:
        clip = bool(norm >= self.max_norm)
        lr = self.lr()
        self.count += 1
        # bias corrections in float32, as optax computes them
        c1 = float(np.float32(1.0) - np.float32(self.B1) ** self.count)
        c2 = float(np.float32(1.0) - np.float32(self.B2) ** self.count)
        for i in self.owned:
            p, g, mu, nu = self.params[i], self.acc[i], self.mu[i], self.nu[i]
            if clip:
                g = g / norm * self.max_norm
            mu.mul_(self.B1).add_((1.0 - self.B1) * g)
            nu.mul_(self.B2).add_((1.0 - self.B2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.EPS)
            if self.weight_decay > 0:
                u = u + self.weight_decay * p
            p.add_(u * -lr)
        if self.group is not None:
            self._broadcast(self.params)

    def _broadcast(self, tensors: list) -> None:
        """Each owner's entries of `tensors` to every rank, one broadcast
        per rank (entries this rank does not own are written in place)."""
        for r in range(self.world):
            idx = [i for i, o in enumerate(self.owner) if o == r]
            if not idx:
                continue
            flat = (torch.cat([tensors[i].reshape(-1) for i in idx]) if r == self.rank else
                    torch.empty(sum(self.params[i].numel() for i in idx),
                                device=self.params[0].device))
            dist.broadcast(flat, src=dist.get_global_rank(self.group, r), group=self.group)
            if r != self.rank:
                ofs = 0
                for i in idx:
                    k = self.params[i].numel()
                    tensors[i].copy_(flat[ofs:ofs + k].view_as(tensors[i]))
                    ofs += k

    def state_dict(self) -> dict:
        """The state by parameter name, of the parameters this rank owns."""
        out = {key: {self.names[i]: getattr(self, key)[i] for i in self.owned}
               for key in ("acc", "mu", "nu")}
        out.update(mini_step=self.mini_step, count=self.count, n_skipped=self.n_skipped)
        return out

    def full_state_dict(self) -> dict:
        """`state_dict` with every parameter's entries: under ZeRO-1 a
        collective of the group, whose ranks all call it."""
        if self.group is None:
            return self.state_dict()
        full = {}
        for key in ("acc", "mu", "nu"):
            mine = getattr(self, key)
            ts = [mine[i] if mine[i] is not None else torch.empty_like(p)
                  for i, p in enumerate(self.params)]
            self._broadcast(ts)
            full[key] = dict(zip(self.names, ts))
        full.update(mini_step=self.mini_step, count=self.count, n_skipped=self.n_skipped)
        return full

    def load_state_dict(self, state: dict) -> None:
        """`state`'s entries of the parameters this rank owns. The entries
        are dicts by parameter name (any number of ranks wrote them) or
        lists over the parameters. Raises ValueError if the saved state does
        not fit the parameters."""
        saved = {}
        for key in ("acc", "mu", "nu"):
            entries = state[key]
            if isinstance(entries, dict):
                entries = [entries.get(n) for n in self.names]
            if len(entries) != len(self.params) or any(
                    entries[i] is None or tuple(entries[i].shape) != tuple(self.params[i].shape)
                    for i in self.owned):
                raise ValueError("optimizer state does not match the parameters")
            saved[key] = entries
        for key, entries in saved.items():
            for i in self.owned:
                getattr(self, key)[i].copy_(entries[i])
        self.mini_step = int(state["mini_step"])
        self.count = int(state["count"])
        self.n_skipped = int(state["n_skipped"])


@contextlib.contextmanager
def deterministic_algorithms():
    """`torch.use_deterministic_algorithms(True)` in the block, then torch's
    setting as it was. Memory that torch leaves uninitialised is not filled
    with NaN in it: a debugging aid, which reproducible results do not need,
    at ~14 ms per nuScenes micro-step on the card."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = prev[2]


@contextlib.contextmanager
def _buffers_kept(module: torch.nn.Module):
    """Put the module's buffers (the BatchNorms' running statistics) back
    as they were on entry when the block ends."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def _leaves(stats: dict, prefix=()):
    """(path, tensor) pairs of a nested stats dict, in a fixed order."""
    for k in sorted(stats):
        v = stats[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def stats_to_host(stats: dict) -> dict:
    """A nested stats dict of device tensors as numpy arrays, in one copy."""
    leaves = list(_leaves(stats))
    flat = torch.cat([torch.as_tensor(v).reshape(-1).float() for _, v in leaves]).cpu().numpy()
    out: dict = {}
    ofs = 0
    for path, v in leaves:
        size = torch.as_tensor(v).numel()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[ofs:ofs + size].reshape(tuple(torch.as_tensor(v).shape))
        ofs += size
    return out


class Trainer:
    """cfg: the derived config; model: a MotionNet; loaders: {"train",
    "val"} iterables of collated numpy batches (this process's slice);
    device: None = CUDA. In a process group (`parallel.mesh`) the Trainer
    is one rank of a data-parallel run (see the module docstring)."""

    def __init__(self, cfg, model, loaders, save_dir=None, device=None):
        self.group = mesh.default_group()
        self.rank, self.world = mesh.rank(self.group), mesh.world(self.group)
        check_supported(cfg, self.world)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loaders = loaders
        self.save_dir = save_dir or os.path.join("snapshot", cfg["misc"]["exp_name"])
        self.is_main = self.rank == 0
        self.logger = Logger(self.save_dir if self.is_main else None, also_print=self.is_main)
        self.metrics_writer = MetricsWriter(self.save_dir if self.is_main else None)
        self.n_verbose = cfg["train"].get("n_verbose", 0)
        self.iter_size = cfg["train"]["iter_size"]
        self.max_epoch = cfg["train"]["max_epoch"]
        self.metric_key = cfg["train"]["metric"]
        self.remat = cfg["train"].get("remat", False)
        self.best_loss = 1e5
        self.best_metric = -1e5
        self.start_epoch = 1

        if "train" in loaders:
            updates_per_epoch = max(1, len(loaders["train"]) // self.iter_size)
        else:
            updates_per_epoch = 1
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        self.optimizer = Optimizer(self.params, cfg, updates_per_epoch, group=self.group,
                                   zero1=cfg.get("parallel", {}).get("zero1", False),
                                   names=[n for n, _ in named])
        n_params = sum(p.numel() for p in self.params)
        self.logger.write(f"#parameters {n_params / 1e6} M\n")
        if self.is_main:
            self._dump_architecture(n_params)

        pretrain = cfg["misc"].get("pretrain", "")
        if pretrain:
            self.load_pretrain(pretrain)

    def _dump_architecture(self, n_params):
        """The module and parameter listing, in <run>/model_arch.txt."""
        lines = [f"{type(self.model).__name__}  ({n_params / 1e6:.3f} M parameters)", "",
                 str(self.model), ""]
        for name, p in self.model.named_parameters():
            lines.append(f"{name}: {tuple(p.shape)} {p.dtype} [{p.numel()}]")
        lines.append("\nbuffers/")
        for name, b in self.model.named_buffers():
            lines.append(f"  {name}: {tuple(b.shape)} {b.dtype}")
        with open(os.path.join(self.save_dir, "model_arch.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def current_lr(self) -> float:
        """The LR the next optimizer update will apply."""
        return self.optimizer.lr()

    def step_generator(self, epoch: int, phase: str, it: int) -> torch.Generator:
        """The random keypoint draw's generator of one step, seeded from
        (epoch, phase, step)."""
        seed = (epoch * 10007 + (0 if phase == "train" else 1)) * 1_000_003 + it
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------ steps
    def kpt_scores(self, batch: dict, generator: torch.Generator | None):
        """The random keypoint draw's uniform scores of this rank's rows: the
        joined batch's [world * B, T, M] drawn from the step's generator (the
        same on every rank), this rank's B rows kept, so that the draw is the
        one process's draw. None under deterministic sampling."""
        if self.cfg["pose_estimation"].get("deterministic_sampling", False):
            return None
        b, m = batch["pillar_valid"].shape
        scores = torch.rand((self.world * b, self.cfg["voxel_generator"]["n_sweeps"], m),
                            generator=generator, device=self.device)
        return scores[self.rank * b:(self.rank + 1) * b]

    def train_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """One micro-step: forward in train mode (batch statistics, running
        statistics updated), FuseLoss, backward, and the optimizer's
        accumulate-or-update. batch: tensors on the device (this rank's
        rows). Under `precision.compute_dtype: bfloat16` the model computes
        in bf16 where the JAX package does; its parameters, their gradients
        and the optimizer's state stay float32. With `train.remat` the
        forward and the loss are recomputed in the backward pass (see the
        module docstring)."""
        self.model.train()

        def forward_loss(batch, kpt_scores):
            results = self.model(batch, mode="train", kpt_scores=kpt_scores)
            return fuse_loss(results, batch, self.cfg["loss"],
                             self.cfg["capacity"]["max_instances"])

        with deterministic_algorithms(), mesh.data_parallel(self.group):
            # drawn outside the remat's recompute, which restores only the
            # default generators
            scores = self.kpt_scores(batch, generator)
            if self.remat:
                stats = checkpoint(forward_loss, batch, scores, use_reentrant=False,
                                   context_fn=lambda: (contextlib.nullcontext(),
                                                       _buffers_kept(self.model)))
            else:
                stats = forward_loss(batch, scores)
            for p in self.params:
                p.grad = None
            stats["loss"].backward()
            grads = [p.grad for p in self.params]
            if self.group is not None:
                grads = mesh.mean_over_ranks(
                    [g if g is not None else torch.zeros_like(p)
                     for g, p in zip(grads, self.params)], self.group)
            self.optimizer.update(grads)
        return {k: (v.detach() if torch.is_tensor(v) else v) for k, v in stats.items()}

    @torch.no_grad()
    def val_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        self.model.eval()
        with deterministic_algorithms(), mesh.data_parallel(self.group):
            results = self.model(batch, mode="val", kpt_scores=self.kpt_scores(batch, generator))
            return fuse_loss(results, batch, self.cfg["loss"],
                             self.cfg["capacity"]["max_instances"])

    # ------------------------------------------------------------------ epochs
    def inference_one_epoch(self, epoch: int, phase: str):
        assert phase in ("train", "val")
        loader = self.loaders[phase]
        meters = None
        step = self.train_step if phase == "train" else self.val_step
        pending = None  # the previous step's stats, read after this step is queued

        def consume(stats, it_done):
            nonlocal meters
            stats = stats_to_host(stats)
            if meters is None:
                meters = init_stats_meter(stats)
            update_stats_meter(meters, stats)
            if self.n_verbose > 0:
                interval = max(1, len(loader) // self.n_verbose)
                if (it_done + 1) % interval == 0:
                    self.metrics_writer.write(len(loader) * max(epoch - 1, 0) + it_done, phase,
                                              self._scalar_snapshot(meters))

        last_it = -1
        for it, batch in enumerate(loader):
            stats = step(to_device(batch, self.device), self.step_generator(epoch, phase, it))
            if pending is not None:
                consume(pending, it - 1)
            pending = stats
            last_it = it
        if pending is not None:
            consume(pending, last_it)
        self.log_epoch(meters, epoch, phase)
        self.metrics_writer.write(len(loader) * max(epoch, 1) - 1, f"epoch_{phase}",
                                  self._scalar_snapshot(meters))
        return meters

    def _scalar_snapshot(self, meters) -> dict:
        out = {}
        for key, classes in (("mos", MOS_CLASSES), ("fb", FB_CLASSES)):
            s, _ = compute_mean_iou_recall_precision(meters[f"{key}_metric"], classes)
            out.update({f"{key}_{k}": v for k, v in s.items()})
        for k, v in meters.items():
            if not isinstance(v, dict):
                out[k] = float(v.avg)
        out["lr"] = self.current_lr()
        return out

    def log_epoch(self, meters, epoch, phase):
        message = f"{phase} Epoch: {epoch}\t"
        msgs = []
        for key, classes in (("mos", MOS_CLASSES), ("fb", FB_CLASSES)):
            s, msg = compute_mean_iou_recall_precision(meters[f"{key}_metric"], classes)
            message += "".join(f"{key}_{k}: {v:.3f}\t" for k, v in s.items())
            msgs.append(msg)
        for k, v in meters.items():
            if not isinstance(v, dict):
                message += f"{k}: {v.avg:.3f}\t"
        self.logger.write(message + "\n")
        self.logger.write(msgs[0])
        self.logger.write(msgs[1] + "\n")

    # ------------------------------------------------------------------ api
    def train(self):
        # the training loop's own check
        check_supported(dict(self.cfg, misc=dict(self.cfg["misc"], mode="train")), self.world)
        for epoch in range(self.start_epoch, self.max_epoch):
            self.logger.write(f"epoch {epoch} lr {self.current_lr():.3e}\n")
            self.inference_one_epoch(epoch, "train")
            meters = self.inference_one_epoch(epoch, "val")
            if meters["loss"].avg < self.best_loss:
                self.best_loss = meters["loss"].avg
                self.snapshot(epoch, "best_loss")
            self.snapshot(epoch, "latest")
            mos_stats, _ = compute_mean_iou_recall_precision(meters["mos_metric"], MOS_CLASSES)
            if mos_stats[self.metric_key] > self.best_metric:
                self.best_metric = mos_stats[self.metric_key]
                self.snapshot(epoch, "best_metric")

    def eval(self):
        return self.inference_one_epoch(0, "val")

    # ------------------------------------------------------------------ ckpt
    def snapshot(self, epoch, name=None):
        """The rolling checkpoint `name` (`train.ckpt_backend`: pickle, a
        file written by rank 0; orbax, a torch.distributed.checkpoint
        directory written by every rank, each with its own optimizer
        entries). Every rank calls it."""
        fname = os.path.join(self.save_dir, f"model_{name or epoch}.ckpt")
        backend = self.cfg["train"].get("ckpt_backend", "pickle")
        state = {"epoch": epoch, "model": self.model.state_dict(),
                 "best_loss": self.best_loss, "best_metric": self.best_metric}
        if backend == "orbax":
            save_checkpoint(fname, dict(state, optimizer=self.optimizer.state_dict()),
                            backend, self.group)
        else:
            opt = self.optimizer.full_state_dict()  # a collective under ZeRO-1
            if self.is_main:
                save_checkpoint(fname, dict(state, optimizer=opt), backend)
            if self.group is not None:
                dist.barrier(self.group)
        self.logger.write(f"Save model to {fname}{'.dcp' if backend == 'orbax' else ''}\n")

    def load_pretrain(self, path):
        """Weights, and the optimizer's state where it maps, from a
        checkpoint in any form `utils.checkpoint.read_checkpoint` reads."""
        state = read_checkpoint(path)
        self.model.load_state_dict(partial_load(state["model"], self.model.state_dict()))
        if state["optimizer"] is None:
            self.logger.write("the checkpoint's optimizer state is not the port's (the JAX "
                              "package's optax state, or none); reinitialised\n")
        else:
            try:
                self.optimizer.load_state_dict(state["optimizer"])
            except (KeyError, ValueError):
                self.logger.write("optimizer state incompatible; reinitialised\n")
        self.start_epoch = int(state.get("epoch", 0)) + 1
        self.best_loss = state.get("best_loss", self.best_loss)
        self.best_metric = state.get("best_metric", self.best_metric)
        self.logger.write(f"Loaded pretrained model from {path} at epoch {self.start_epoch}\n")
