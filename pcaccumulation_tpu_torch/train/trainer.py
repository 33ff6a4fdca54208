"""Training and evaluation runtime (the port of the JAX package's
`train/trainer.py`, one device).

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
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pcaccumulation_tpu_torch import resolve_device, to_device
from pcaccumulation_tpu_torch.config import check_supported
from pcaccumulation_tpu_torch.train.loss import fuse_loss
from pcaccumulation_tpu_torch.train.metrics import (
    compute_mean_iou_recall_precision,
    init_stats_meter,
    update_stats_meter,
)
from pcaccumulation_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    partial_load,
    save_checkpoint,
)
from pcaccumulation_tpu_torch.utils.logging import Logger, MetricsWriter

MOS_CLASSES = ["static", "moving"]
FB_CLASSES = ["background", "foreground"]


class Optimizer:
    """Gradient accumulation, skip-if-non-finite, global-norm clipping and
    Adam with a staircase exponential LR, as the JAX package's
    `make_optimizer` (see the module docstring)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, cfg: dict, updates_per_epoch: int = 1):
        self.params = list(params)
        self.lr0 = cfg["optimizer"]["learning_rate"]
        self.weight_decay = cfg["optimizer"].get("weight_decay", 0.0)
        self.gamma = cfg["scheduler"]["exp_gamma"]
        self.updates_per_epoch = max(1, updates_per_epoch)
        self.max_norm = cfg["train"]["grad_clip"]
        self.iter_size = cfg["train"]["iter_size"]
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
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
        for a, g in zip(self.acc, grads):
            a.add_(((g if g is not None else torch.zeros_like(a)) - a) / n)
        self.mini_step = n
        if n < self.iter_size:
            return None
        self.mini_step = 0
        finite = bool(torch.stack([torch.isfinite(a).all() for a in self.acc]).all())
        if finite:
            self._apply(self.acc)
        else:
            self.n_skipped += 1
        for a in self.acc:
            a.zero_()
        return finite

    def _apply(self, grads) -> None:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = bool(norm >= self.max_norm)
        lr = self.lr()
        self.count += 1
        # bias corrections in float32, as optax computes them
        c1 = float(np.float32(1.0) - np.float32(self.B1) ** self.count)
        c2 = float(np.float32(1.0) - np.float32(self.B2) ** self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if clip:
                g = g / norm * self.max_norm
            mu.mul_(self.B1).add_((1.0 - self.B1) * g)
            nu.mul_(self.B2).add_((1.0 - self.B2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.EPS)
            if self.weight_decay > 0:
                u = u + self.weight_decay * p
            p.add_(u * -lr)

    def state_dict(self) -> dict:
        return {"acc": self.acc, "mu": self.mu, "nu": self.nu, "mini_step": self.mini_step,
                "count": self.count, "n_skipped": self.n_skipped}

    def load_state_dict(self, state: dict) -> None:
        """Raises ValueError if the saved state does not fit the parameters."""
        for key in ("acc", "mu", "nu"):
            saved = state[key]
            if len(saved) != len(self.params) or any(
                    s.shape != p.shape for s, p in zip(saved, self.params)):
                raise ValueError("optimizer state does not match the parameters")
        for key in ("acc", "mu", "nu"):
            for dst, src in zip(getattr(self, key), state[key]):
                dst.copy_(src)
        self.mini_step = state["mini_step"]
        self.count = state["count"]
        self.n_skipped = state["n_skipped"]


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
    "val"} iterables of collated numpy batches; device: None = CUDA."""

    def __init__(self, cfg, model, loaders, save_dir=None, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loaders = loaders
        self.save_dir = save_dir or os.path.join("snapshot", cfg["misc"]["exp_name"])
        self.logger = Logger(self.save_dir)
        self.metrics_writer = MetricsWriter(self.save_dir)
        self.n_verbose = cfg["train"].get("n_verbose", 0)
        self.iter_size = cfg["train"]["iter_size"]
        self.max_epoch = cfg["train"]["max_epoch"]
        self.metric_key = cfg["train"]["metric"]
        self.best_loss = 1e5
        self.best_metric = -1e5
        self.start_epoch = 1

        if "train" in loaders:
            updates_per_epoch = max(1, len(loaders["train"]) // self.iter_size)
        else:
            updates_per_epoch = 1
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = Optimizer(self.params, cfg, updates_per_epoch)
        n_params = sum(p.numel() for p in self.params)
        self.logger.write(f"#parameters {n_params / 1e6} M\n")
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
    def train_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """One micro-step: forward in train mode (batch statistics, running
        statistics updated), FuseLoss, backward, and the optimizer's
        accumulate-or-update. batch: tensors on the device. Under
        `precision.compute_dtype: bfloat16` the model computes in bf16 where
        the JAX package does; its parameters, their gradients and the
        optimizer's state stay float32."""
        self.model.train()
        results = self.model(batch, mode="train", generator=generator)
        stats = fuse_loss(results, batch, self.cfg["loss"],
                          self.cfg["capacity"]["max_instances"])
        for p in self.params:
            p.grad = None
        stats["loss"].backward()
        self.optimizer.update([p.grad for p in self.params])
        return {k: (v.detach() if torch.is_tensor(v) else v) for k, v in stats.items()}

    @torch.no_grad()
    def val_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        self.model.eval()
        results = self.model(batch, mode="val", generator=generator)
        return fuse_loss(results, batch, self.cfg["loss"], self.cfg["capacity"]["max_instances"])

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
        check_supported(dict(self.cfg, misc=dict(self.cfg["misc"], mode="train")))
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
        fname = os.path.join(self.save_dir, f"model_{name or epoch}.ckpt")
        save_checkpoint(fname, {
            "epoch": epoch, "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "best_loss": self.best_loss, "best_metric": self.best_metric,
        })
        self.logger.write(f"Save model to {fname}\n")

    def load_pretrain(self, path):
        state = load_checkpoint(path)
        self.model.load_state_dict(partial_load(state["model"], self.model.state_dict()))
        try:
            self.optimizer.load_state_dict(state["optimizer"])
        except (KeyError, ValueError):
            self.logger.write("optimizer state incompatible; reinitialised\n")
        self.start_epoch = state.get("epoch", 0) + 1
        self.best_loss = state.get("best_loss", self.best_loss)
        self.best_metric = state.get("best_metric", self.best_metric)
        self.logger.write(f"Loaded pretrained model from {path} at epoch {self.start_epoch}\n")
