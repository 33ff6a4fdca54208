"""The process mesh of the port: the data axis, and the frame and spatial
axes that split one sequence's UNet, one card per process. The port's
counterpart of the JAX package's `parallel/mesh.py` (`make_mesh` with
`frame_devices` / `spatial_devices`, `shard_batch`,
`global_batch_from_host_local`), its multi-host start
(`initialize_multihost`) and the collectives GSPMD inserts.

Mesh (`make_mesh`): the processes of the default group laid out as
(data, frame, spatial), the model axes innermost, as the JAX package's
mesh is: rank = (d * F + f) * S + s. A subgroup per axis and per
coordinate of the other two, made in one order on every rank.

Batch convention, the JAX package's multi-host one with one card per
process: `train.batch_size` is per data coordinate, the joined batch is
(world / (F * S)) x batch_size with the data coordinates' rows in order,
and every process loads the slice of its data coordinate
(`data.loader.make_loader(process_id=, process_count=)`): the ranks of
one (frame, spatial) group read the same samples.

The step computes one process's function on the joined batch, as the JAX
package's step does under GSPMD. Every reduction over the batch that the
forward and FuseLoss make goes through `global_sum` (the sum over the
data axis of the local sums): the BatchNorm statistics, the loss terms'
numerators and counts, the class weights and the gates. The Lovász loss,
which sorts the whole batch's errors, reads the joined rows
(`gather_rows`). Outside `data_parallel(group)` both are the identity, so
one process computes what it computed before, bit for bit.

Frame and spatial axes (`model_parallel(mesh)`, read by MotionNet): every
rank of a (frame, spatial) group computes the pillar encoder and the
canvas of its data slice; the UNet runs on this rank's contiguous block of
the [B*T] rows (`blocks`) and its band of H rows (`bands`: edges on
multiples of 2^(depth-1) rows, so every pool and every stride-2 upsample
stays inside a band), with a halo exchange before each 3x3 convolution
(`halo_rows`); `gather_blocks` puts the UNet's output back together on
every rank, and the rest of the forward runs on every rank as at world 1.
The UNet has no BatchNorm, so no statistic crosses the model axes.

Gradients: every rank computes the same loss from the global sums. The
backward of `global_sum`, `gather_rows` and `gather_blocks` sums the
cotangents over their group (as `torch.distributed.nn.functional` does),
so each rank's parameter gradient is a multiple of its share (the data
size on the tail, the world on the UNet and the pillar encoder), and the
mean over all ranks (`mean_over_ranks`) is the gradient of the joined
batch. At world 1 every collective is the identity.

The collectives are all-reduces and all-gathers, which NCCL and gloo
both serve on CUDA tensors (gloo's point-to-point ops take CPU tensors
only); an all-gather moves raw bytes, so every dtype travels as it is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import logging
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

_log = logging.getLogger(__name__)
# the data group of the step running now and the mesh whose frame and
# spatial axes split its UNet: process state, as torch's own deterministic
# flag is, set and restored by `data_parallel` / `model_parallel` around a
# step, so that the model's modules need no group argument
_GROUP = None
_SPLIT = None


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
    """The ranks' x (the same number of rows on each) joined along dim 0 in
    rank order."""
    if _GROUP is None:
        return x
    return gather_blocks(x, 0, [x.shape[0]] * dist.get_world_size(_GROUP), _GROUP)


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


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as a uint8 tensor (its last dim times the item size): what
    an all-gather moves, in any dtype either backend serves."""
    return x.contiguous().view(torch.uint8)


def _all_gather(x: torch.Tensor, group) -> list:
    """The group's x in group rank order (equal shapes)."""
    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return [p.view(x.dtype) for p in parts]


def _sum_float32(g: torch.Tensor, group) -> torch.Tensor:
    """g summed over the group, in float32, cast back to g's dtype."""
    total = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(total, group=group)
    return total.to(g.dtype)


def blocks(n: int, parts: int) -> list:
    """n split into `parts` sizes as equal as possible, the larger first."""
    q, r = divmod(n, parts)
    return [q + (i < r) for i in range(parts)]


def bands(h: int, unit: int, parts: int) -> list:
    """The rows of `parts` bands of h rows whose edges fall on multiples of
    `unit`, as equal as possible, the larger first (288 rows in units of
    16 over 4 parts: 80, 80, 64, 64). Raises ValueError when h is no
    multiple of unit or there are fewer units than parts."""
    if h % unit or h // unit < parts:
        raise ValueError(f"{h} rows in units of {unit} do not make {parts} bands")
    return [u * unit for u in blocks(h // unit, parts)]


class _GatherBlocks(torch.autograd.Function):
    """The group's blocks joined along `dim` in group rank order, each rank's
    block `sizes[rank]` long: padded to the largest, all-gathered, trimmed.
    Its backward sums the cotangent over the group (in float32) and keeps
    this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, sizes, group):
        me = dist.get_rank(group)
        ctx.dim, ctx.group = dim, group
        ctx.start, ctx.size = sum(sizes[:me]), sizes[me]
        padded = x
        if sizes[me] < max(sizes):
            shape = list(x.shape)
            shape[dim] = max(sizes)
            padded = x.new_zeros(shape)
            padded.narrow(dim, 0, sizes[me]).copy_(x)
        parts = _all_gather(padded, group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim)

    @staticmethod
    def backward(ctx, g):
        total = _sum_float32(g, ctx.group)
        return total.narrow(ctx.dim, ctx.start, ctx.size).contiguous(), None, None, None


def gather_blocks(x: torch.Tensor, dim: int, sizes: list, group) -> torch.Tensor:
    """x, this rank's block of `sizes[rank]` along `dim`, joined with the
    other ranks' of the group in rank order (None: x)."""
    return x if group is None else _GatherBlocks.apply(x, dim, list(sizes), group)


class _HaloRows(torch.autograd.Function):
    """x [N, C, h, W], this rank's band of rows: [N, C, h + 2k, W] with the
    k rows above it from the rank before and the k rows below it from the
    rank after, zeros at the image's top and bottom edges. Its backward
    returns the halo rows' cotangent to the rank that owns them, which adds
    it to its own (one all-gather each way)."""

    @staticmethod
    def forward(ctx, x, k, group):
        s, n = dist.get_rank(group), dist.get_world_size(group)
        if x.shape[2] < k:
            raise ValueError(f"a band of {x.shape[2]} rows cannot give a halo of {k}")
        ctx.k, ctx.group, ctx.s, ctx.n = k, group, s, n
        parts = _all_gather(torch.cat([x[:, :, :k], x[:, :, -k:]], 2), group)
        # x's layout kept (channels innermost: the UNet's NHWC maps), so that
        # the convolution runs the arithmetic of the whole image's
        fmt = torch.channels_last if x.stride(1) == 1 < x.shape[1] else torch.contiguous_format
        out = torch.empty(x.shape[:2] + (x.shape[2] + 2 * k, x.shape[3]), dtype=x.dtype,
                          device=x.device, memory_format=fmt).zero_()
        out[:, :, k:-k] = x
        if s > 0:
            out[:, :, :k] = parts[s - 1][:, :, k:]
        if s < n - 1:
            out[:, :, -k:] = parts[s + 1][:, :, :k]
        return out

    @staticmethod
    def backward(ctx, g):
        k, s, n = ctx.k, ctx.s, ctx.n
        gx = g[:, :, k:-k].clone()
        parts = _all_gather(torch.cat([g[:, :, :k], g[:, :, -k:]], 2), ctx.group)
        if s > 0:      # the rank before's bottom halo is this band's first rows
            gx[:, :, :k] += parts[s - 1][:, :, k:]
        if s < n - 1:  # the rank after's top halo is this band's last rows
            gx[:, :, -k:] += parts[s + 1][:, :, :k]
        return gx, None, None


def halo_rows(group):
    """The halo exchange of the spatial group as `fn(x, k)` (see
    `_HaloRows`), for `models.layers.Conv2d`'s band mode."""
    return lambda x, k: _HaloRows.apply(x, k, group)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, frame, spatial) layout of the processes (`make_mesh`):
    the axes' sizes, this rank's coordinates, and its subgroup along each
    axis (None where the axis has one coordinate; `world_group` None in one
    process)."""

    data: int = 1
    frame: int = 1
    spatial: int = 1
    coords: tuple = (0, 0, 0)
    world_group: object = None
    data_group: object = None
    frame_group: object = None
    spatial_group: object = None

    @property
    def splits(self) -> bool:
        """Whether the frame or spatial axis splits the UNet."""
        return self.frame * self.spatial > 1


def make_mesh(frame_devices: int = 1, spatial_devices: int = 1,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The (data, frame, spatial) mesh over the default process group, of
    shape (world // (F * S), F, S); in one process with F = S = 1 the
    trivial mesh. Every rank of the group calls it: the subgroups are made
    in one order on every rank, and one a rank does not join raises after
    `timeout_s`. Raises ValueError when the world does not factor."""
    group = default_group()
    n, r = world(group), rank(group)
    f, s = frame_devices, spatial_devices
    if f < 1 or s < 1 or n % (f * s):
        raise ValueError(f"{n} process(es) do not factor into a (data={n // max(1, f * s)} x "
                         f"frame={f} x spatial={s}) mesh")
    sizes = {"data": n // (f * s), "frame": f, "spatial": s}
    coords = (r // (f * s), r // s % f, r % s)
    mine = {}
    for axis in sizes:
        if sizes[axis] in (1, n):  # no subgroup, or the whole group
            mine[axis] = None if sizes[axis] == 1 else group
            continue
        others = [a for a in sizes if a != axis]
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            at = dict(zip(others, fixed))
            ranks = [(at.get("data", i) * f + at.get("frame", i)) * s + at.get("spatial", i)
                     for i in range(sizes[axis])]
            sub = dist.new_group(ranks, timeout=datetime.timedelta(seconds=timeout_s))
            if r in ranks:
                mine[axis] = sub
    return Mesh(sizes["data"], f, s, coords, group, mine.get("data"), mine.get("frame"),
                mine.get("spatial"))


@contextlib.contextmanager
def model_parallel(m: Mesh | None):
    """Within the block MotionNet splits its UNet over m's frame and
    spatial axes (None, or a mesh without them: it does not)."""
    global _SPLIT
    prev, _SPLIT = _SPLIT, (m if m is not None and m.splits else None)
    try:
        yield
    finally:
        _SPLIT = prev


def active_split() -> Mesh | None:
    """The mesh whose frame and spatial axes split the running step's UNet."""
    return _SPLIT


def init_distributed(device=None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     backend: str | None = None) -> torch.device:
    """Join the default process group of a run over several processes;
    returns this process's device.

    With explicit `init_method`, `world_size` and `rank` a rendezvous that
    fails raises. Without them torchrun's environment is read (RANK,
    WORLD_SIZE, LOCAL_RANK, and MASTER_ADDR / MASTER_PORT through
    `env://`); with no such environment the run is one process with no
    group, and that is logged (as the JAX package's auto-detect does). On
    the card each process takes cuda:LOCAL_RANK (by default its rank)
    unless `device` names an index. `backend`: NCCL on the card and gloo
    on the CPU by default; gloo on the card lets several processes share
    one card (NCCL refuses two ranks on one device). The rendezvous and
    every collective time out after `timeout_s`. No-op (the device) when
    a group exists already."""
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
        dev = torch.device("cuda", local_rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev
