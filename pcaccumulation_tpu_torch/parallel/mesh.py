"""The data axis over processes, one card each: the port's counterpart of
the JAX package's `parallel/mesh.py` data axis (`make_mesh`,
`shard_batch`, `global_batch_from_host_local`), its multi-host start
(`initialize_multihost`) and the collectives its ZeRO-1 leaves to GSPMD.

Batch convention, the JAX package's multi-host one with one card per
process: `train.batch_size` is per process, the joined batch is world x
batch_size with the ranks' rows in rank order, and every process loads
its own slice (`data.loader.make_loader(process_id=, process_count=)`).

The step computes one process's function on the joined batch, as the JAX
package's data-parallel step does under GSPMD. Every reduction over the
batch that the forward and FuseLoss make goes through `global_sum` (the
sum over the ranks of the local sums): the BatchNorm statistics, the loss
terms' numerators and counts, the class weights and the gates. The
Lovász loss, which sorts the whole batch's errors, reads the joined rows
(`gather_rows`). Outside `data_parallel(group)` both are the identity, so
one process computes what it computed before, bit for bit.

Gradients: every rank computes the same loss from the global sums. The
backward of `global_sum` and `gather_rows` sums the cotangents over the
ranks (as `torch.distributed.nn.functional` does), so each rank's
parameter gradient is world times its share, and the mean over the ranks
(`mean_over_ranks`) is the gradient of the joined batch. At world 1 every
collective is the identity.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

_log = logging.getLogger(__name__)
# the group of the data-parallel step running now: process state, as
# torch's own deterministic flag is, set and restored by `data_parallel`
# around a step, so that the model's modules need no group argument
_GROUP = None


class _SumOverRanks(torch.autograd.Function):
    """all-reduce (sum); its backward all-reduces the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """all-gather along dim 0, in rank order; its backward is the
    reduce-scatter of the cotangent (an all-reduce and this rank's rows:
    gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


@contextlib.contextmanager
def data_parallel(group):
    """Within the block `global_sum` and `gather_rows` reduce over `group`
    (None: they stay the identity)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks of the running data-parallel step."""
    return x if _GROUP is None else _SumOverRanks.apply(x, _GROUP)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' x joined along dim 0 in rank order."""
    if _GROUP is None:
        return x
    if x.dtype == torch.bool:
        return _GatherRows.apply(x.to(torch.uint8), _GROUP).bool()
    return _GatherRows.apply(x, _GROUP)


def active_world() -> int:
    """The number of ranks of the running data-parallel step (1 outside one)."""
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


def default_group():
    """The default process group once one exists (`init_distributed`)."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def rank(group=None) -> int:
    return 0 if group is None else dist.get_rank(group)


def world(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def mean_over_ranks(tensors: list, group) -> list:
    """The mean over the ranks of each tensor, in one all-reduce of the
    flattened list."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    out, ofs = [], 0
    for t in tensors:
        out.append(flat[ofs:ofs + t.numel()].view_as(t))
        ofs += t.numel()
    return out


def init_distributed(device=None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group of a data-parallel run; returns this
    process's device.

    With explicit `init_method`, `world_size` and `rank` a rendezvous that
    fails raises. Without them torchrun's environment is read (RANK,
    WORLD_SIZE, LOCAL_RANK, and MASTER_ADDR / MASTER_PORT through
    `env://`); with no such environment the run is one process with no
    group, and that is logged (as the JAX package's auto-detect does). NCCL
    on the card, each process on cuda:LOCAL_RANK (by default its rank);
    gloo only when `device` is the CPU. The rendezvous and every collective time out after
    `timeout_s`. No-op (the device) when a group exists already."""
    from pcaccumulation_tpu_torch import resolve_device

    dev = resolve_device(device)
    explicit = (init_method, world_size, rank) != (None, None, None)
    if explicit and None in (init_method, world_size, rank):
        raise ValueError("init_method, world_size and rank are given together")
    if not explicit and not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            _log.warning("no torchrun environment (RANK, WORLD_SIZE): one process, "
                         "no process group")
            return dev
        init_method = "env://"
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank or 0))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev
