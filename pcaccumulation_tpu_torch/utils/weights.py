"""JAX parameter trees -> a state_dict under the reference PyTorch names.

The inverse of the JAX package's `utils/torch_convert.py::convert_state_dict`:
it takes the `params` and `batch_stats` trees of the JAX MotionNet as numpy
arrays and returns the state_dict the port's MotionNet (and the reference
model) loads. Layouts:

  flax Dense kernel [in, out]            -> Linear weight [out, in]
  flax Conv kernel [H, W, in, out]       -> Conv2d weight [out, in, H, W]
  flax Conv kernel [T, H, W, in, out]    -> Conv3d weight [out, in, T, H, W]
  flax ConvTranspose kernel [H, W, in, out] -> ConvTranspose2d weight
        [in, out, H, W] with the taps flipped spatially (flax's transpose
        conv is a fractionally strided convolution, torch's the adjoint)
  BatchNorm scale / bias / mean / var    -> weight / bias / running_mean / running_var

The STPN's temporal convs `init_conv{i}` go to `motionhead.init_conv.{2i}`.
With `stpn.n_band_layers` k < 4 the JAX STPN has 3x3 convs `post_conv{i}`
(i = k..3) after its temporal max, which the reference model lacks (so the
JAX package's `torch_convert.py` names none); the port names them
`motionhead.post_conv{i}.weight` / `.bias` (a Conv2d).

`params_from_jax` maps any tree shaped as `params` (a gradient, Adam's
moments) by the same rules, and `optimizer_state_from_jax` maps the JAX
Trainer's optax state onto the port's `Optimizer` state with it.

`init_parameters` draws a fresh model's weights from the distributions the
JAX package's `MotionNet.init` draws them from.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

# the standard deviation of a unit normal truncated to [-2, 2] (flax's
# variance_scaling divides by it, so that the draw has the asked-for variance)
TRUNC_STD = 0.87962566103423978


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


class _Writer:
    def __init__(self):
        self.sd: dict[str, torch.Tensor] = {}

    def linear(self, prefix, p):
        self.sd[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.sd[f"{prefix}.bias"] = _tensor(p["bias"])

    def conv2d(self, prefix, p):
        self.sd[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        self.sd[f"{prefix}.bias"] = _tensor(p["bias"])

    def conv3d(self, prefix, p):
        self.sd[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2))
        self.sd[f"{prefix}.bias"] = _tensor(p["bias"])

    def conv_transpose2d(self, prefix, p):
        k = np.asarray(p["kernel"])[::-1, ::-1]
        self.sd[f"{prefix}.weight"] = _tensor(k.transpose(2, 3, 0, 1))
        self.sd[f"{prefix}.bias"] = _tensor(p["bias"])

    def bn(self, prefix, p, s):
        self.sd[f"{prefix}.weight"] = _tensor(p["scale"])
        self.sd[f"{prefix}.bias"] = _tensor(p["bias"])
        if s is not None:
            self.sd[f"{prefix}.running_mean"] = _tensor(s["mean"])
            self.sd[f"{prefix}.running_var"] = _tensor(s["var"])
            self.sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def mlp(self, prefix, p):
        """MLP fc{i} -> nn.Sequential Linears at indices 0, 2, 4, ..."""
        for i in range(len(p)):
            self.linear(f"{prefix}.{2 * i}", p[f"fc{i}"])

    def seg_head(self, prefix, p, s, conv: bool):
        put = self.conv2d if conv else self.linear
        put(f"{prefix}.seg_head.0", p["conv0" if conv else "fc0"])
        self.bn(f"{prefix}.seg_head.1", p["bn"], _sub(s, "bn"))
        put(f"{prefix}.seg_head.3", p["conv1" if conv else "fc1"])

    def unet_levels(self, prefix, p):
        for i in range(sum(k.startswith("down") for k in p)):
            for name in ("conv1", "conv2"):
                self.conv2d(f"{prefix}.down_convs.{i}.{name}", p[f"down{i}"][name])
        for i in range(sum(k.startswith("up") for k in p)):
            up = p[f"up{i}"]
            self.conv_transpose2d(f"{prefix}.up_convs.{i}.upconv", up["upconv"])
            self.conv2d(f"{prefix}.up_convs.{i}.conv1", up["conv1"])
            self.conv2d(f"{prefix}.up_convs.{i}.conv2", up["conv2"])


def _sub(tree, *keys):
    """tree[k0][k1]..., or None for no tree (a parameter tree's mapping
    writes no BatchNorm statistics)."""
    for k in keys:
        if tree is None:
            return None
        tree = tree[k]
    return tree


def state_dict_from_jax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """JAX MotionNet (params, batch_stats) -> state_dict (CPU float32 tensors)."""
    return _map(params, batch_stats)


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """A tree shaped as the JAX MotionNet's `params` (its gradient, Adam's
    moments, optax's accumulator) -> the port's parameters by name, through
    the parameters' own layout mapping (CPU float32 tensors)."""
    return _map(tree, None)


# The field order of optax's state NamedTuples (optax 0.2), which the JAX
# package's pickle checkpoints carry positionally (`utils/checkpoint.py`'s
# `Inert` stand-ins); the orbax tree names them.
MULTI_STEPS_FIELDS = ("mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                      "skip_state")
APPLY_IF_FINITE_FIELDS = ("notfinite_count", "last_finite", "total_notfinite", "inner_state")
SCALE_BY_ADAM_FIELDS = ("count", "mu", "nu")
SCALE_BY_SCHEDULE_FIELDS = ("count",)


def _fields(node, names: tuple) -> dict:
    """An optax state NamedTuple as {field: value}: the orbax tree's dict, or
    the pickle's stand-in with its fields in order."""
    if isinstance(node, dict):
        missing = [n for n in names if n not in node]
        if missing:
            raise ValueError(f"optax state without {missing}")
        return node
    args = getattr(node, "args", None)
    if args is None or len(args) != len(names):
        raise ValueError(f"not an optax state with fields {names}: {node!r}")
    return dict(zip(names, args))


def optimizer_state_from_jax(opt_state, names: list | None = None) -> dict:
    """The JAX Trainer's optimizer state -> the port's `Optimizer.state_dict()`
    form: {"acc", "mu", "nu": {parameter name: CPU float32 tensor},
    "mini_step", "count", "n_skipped"}.

    `opt_state` is the state of `optax.MultiSteps(optax.apply_if_finite(
    chain(clip_by_global_norm, adam or adamw)))` (the JAX package's
    `make_optimizer`), as the orbax tree of dicts and lists or as the
    pickle's stand-ins: MultiStepsState (mini_step, gradient_step,
    inner_opt_state, acc_grads, skip_state), ApplyIfFiniteState
    (notfinite_count, last_finite, total_notfinite, inner_state), the chain
    (clip's empty state, (ScaleByAdamState (count, mu, nu), [adamw: the
    decay's empty state,] ScaleByScheduleState (count))). `acc_grads`, `mu`
    and `nu` go through the parameters' own layout mapping
    (`params_from_jax`). `names`: the parameters to keep (None: all).

    Where the counters differ, the port takes what optax's next update uses:
    - `count` is Adam's count (its bias corrections) and the schedule's
      count (the LR): both advance on applied updates only, and must agree.
      `gradient_step` also counts skipped windows; the update reads it only
      for `every_k_schedule`, constant in the JAX package, so it is dropped;
    - `n_skipped` is `total_notfinite`; `notfinite_count` and `last_finite`
      steer only optax's `max_consecutive_errors` (1000), which the port does
      not model;
    - `mini_step` is optax's; at mini_step 0 the accumulator is zero in the
      port. optax's next micro-step replaces a finite accumulator there
      (acc + (g - acc) / 1), but after a skipped update it holds 0 * nan
      and skips every later window, where the port starts afresh (its skip
      semantics, `train/trainer.py`). Mid-window, a non-finite accumulator
      is carried: both then skip the window's update.
    """
    ms = _fields(opt_state, MULTI_STEPS_FIELDS)
    aif = _fields(ms["inner_opt_state"], APPLY_IF_FINITE_FIELDS)
    chain = list(aif["inner_state"])  # a tuple (pickle) or a list (orbax)
    if len(chain) != 2:
        raise ValueError(f"not the JAX package's chain(clip, adam): {len(chain)} states")
    inner = list(chain[1])
    if len(inner) not in (2, 3):
        raise ValueError(f"not the JAX package's adam / adamw chain: {len(inner)} states")
    adam = _fields(inner[0], SCALE_BY_ADAM_FIELDS)
    sched = _fields(inner[-1], SCALE_BY_SCHEDULE_FIELDS)
    count, sched_count = int(np.asarray(adam["count"])), int(np.asarray(sched["count"]))
    if count != sched_count:
        raise ValueError(f"Adam's count {count} differs from the schedule's {sched_count}")
    mini_step = int(np.asarray(ms["mini_step"]))
    out = {"acc": params_from_jax(ms["acc_grads"]), "mu": params_from_jax(adam["mu"]),
           "nu": params_from_jax(adam["nu"])}
    if mini_step == 0:
        out["acc"] = {n: torch.zeros_like(t) for n, t in out["acc"].items()}
    if names is not None:
        out = {k: {n: v[n] for n in names if n in v} for k, v in out.items()}
    out.update(mini_step=mini_step, count=count,
               n_skipped=int(np.asarray(aif["total_notfinite"])))
    return out


def _map(params: dict, batch_stats: dict | None) -> dict[str, torch.Tensor]:
    wr = _Writer()
    pe = params["pillar_encoder"]
    wr.linear("pillar_encoder.fc_pos", pe["fc_pos"])
    wr.linear("pillar_encoder.fc_c", pe["fc_c"])
    for i in range(sum(k.startswith("block") for k in pe)):
        blk = pe[f"block{i}"]
        for name in ("fc_0", "fc_1", "shortcut"):
            if name in blk:
                wr.linear(f"pillar_encoder.blocks.{i}.{name}", blk[name])

    wr.unet_levels("unet", params["unet"])
    wr.conv2d("unet.conv_final", params["unet"]["conv_final"])
    for head in ("semseg_head", "ego_feats_head"):
        wr.seg_head(head, params[head], _sub(batch_stats, head), conv=True)
    for name in ("alpha", "beta"):
        wr.sd[f"ego_motion_head.{name}"] = _tensor(params["ego_motion_head"][name])

    mh, mh_stats = params["motionhead"], _sub(batch_stats, "motionhead")
    for i in range(4):
        if f"init_conv{i}" in mh:
            wr.conv3d(f"motionhead.init_conv.{2 * i}", mh[f"init_conv{i}"])
        else:
            wr.conv2d(f"motionhead.post_conv{i}", mh[f"post_conv{i}"])
    wr.unet_levels("motionhead", mh["unet"])
    wr.mlp("motionhead.positional_encoding", mh["positional_encoding"])
    wr.linear("motionhead.final_proj.0", mh["final_proj"])
    for head in ("mos_seg", "offset_head"):
        wr.seg_head(f"motionhead.{head}", mh[head], _sub(mh_stats, head), conv=False)

    al = params["reconstructor"]["alignment"]
    al_stats = _sub(batch_stats, "reconstructor", "alignment")
    pre = "reconstructor.alignment"
    for name in ("geo_embed", "motion_embed", "pos_embed"):
        wr.mlp(f"{pre}.{name}", al[name])
    wr.linear(f"{pre}.regressor.0", al["reg_fc0"])
    wr.bn(f"{pre}.regressor.1", al["reg_bn0"], _sub(al_stats, "reg_bn0"))
    wr.linear(f"{pre}.regressor.3", al["reg_fc1"])
    wr.bn(f"{pre}.regressor.4", al["reg_bn1"], _sub(al_stats, "reg_bn1"))
    wr.linear(f"{pre}.regressor.6", al["reg_fc2"])
    return wr.sd


def jax_fans(module: nn.Module) -> tuple[int, int]:
    """(fan_in, fan_out) of a Linear / Conv layer as flax counts them on the
    JAX kernel layout: [in, out] for Dense, [k..., in, out] for a
    convolution and for a transpose convolution (torch's [in, out, k...]
    weight of ConvTranspose2d has the fans the other way round from torch's
    `_calculate_fan_in_and_fan_out`)."""
    w = module.weight
    if isinstance(module, nn.Linear):
        return w.shape[1], w.shape[0]
    field = math.prod(w.shape[2:])
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        return w.shape[0] * field, w.shape[1] * field
    return w.shape[1] * field, w.shape[0] * field


def init_std(module: nn.Module) -> float:
    """The standard deviation of the kernel `init_parameters` draws for a
    Linear / Conv layer (0 for a zero kernel): flax's
    `variance_scaling(1, mode, "truncated_normal")` gives sqrt(1 / fan)."""
    kind = getattr(module, "init_kind", "lecun")
    if kind == "zeros":
        return 0.0
    fan_in, fan_out = jax_fans(module)
    return math.sqrt(1.0 / (fan_in if kind == "lecun" else (fan_in + fan_out) / 2))


def truncated_normal(shape, generator: torch.Generator | None) -> torch.Tensor:
    """A float32 CPU draw of a unit normal truncated to [-2, 2], by the
    inverse CDF as `jax.random.truncated_normal` draws it: uniform between
    erf(-2 / sqrt 2) and erf(2 / sqrt 2), then sqrt 2 * erfinv, clipped to
    the interval. (torch's `trunc_normal_` drew this way up to torch 2.11;
    torch 2.13's samples by rejection, ~10x as long on the CPU.)"""
    edge = math.erf(2.0 / math.sqrt(2.0))
    draw = torch.empty(shape, dtype=torch.float32).uniform_(-edge, edge, generator=generator)
    return draw.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Draw every parameter of a port model as the JAX package's
    `MotionNet.init` draws its counterpart; `generator` is a CPU
    `torch.Generator` (None: torch's default one). Kernels are
    `truncated_normal * sqrt(1 / fan) / TRUNC_STD`, fan_in
    ("lecun", flax's `lecun_normal`) or the mean of fan_in and fan_out
    ("xavier", `xavier_normal`) from `jax_fans`; biases are zero. The
    buffers are reset (running mean 0, var 1; the ego head's pair lists
    rebuilt), so a model built on the meta device and `to_empty` is whole.
    Raises if a parameter or buffer has no rule. Each port name (`*` for
    indices) with its JAX leaf, initialiser and source line (files of
    `pcaccumulation_tpu/models/`):

    pillar_encoder.fc_pos.weight, pillar_encoder.fc_c.weight
        fc_pos, fc_c kernel: lecun; pillar_encoder.py:299,306 (Dense)
    pillar_encoder.blocks.*.fc_0.weight, .shortcut.weight
        block*/fc_0, shortcut: lecun; layers.py:49,55 (Dense)
    pillar_encoder.blocks.*.fc_1.weight
        block*/fc_1 kernel: zeros; layers.py:50
    unet.{down,up}_convs.*.conv{1,2}.weight, unet.conv_final.weight
        unet down*/up* conv1, conv2, conv_final: xavier; unet.py:27 (conv3x3),
        at the s2d level 0 unet.py:43,55 (S2DConv3x3)
    unet.up_convs.*.upconv.weight
        up*/upconv, (2, 2, cin, cout): xavier; unet.py:171 (ConvTranspose),
        s2d unet.py:91
    semseg_head.seg_head.{0,3}.weight
        semseg_head/conv0, conv1: lecun; layers.py:441,449 (Conv), padded
        layers.py:219, s2d layers.py:356,305
    ego_feats_head.seg_head.{0,3}.weight
        ego_feats_head/conv0, conv1: lecun; layers.py:441,449, sparse
        layers.py:428,378, folded layers.py:147
    *.seg_head.1.weight, .bias (the 2-D heads' BatchNorm)
        */bn scale, bias: ones, zeros; flax BatchNorm (layers.py:442,189),
        s2d layers.py:255-256
    ego_motion_head.alpha, .beta
        alpha, beta: -5; egomotion.py:166-167
    motionhead.init_conv.{0,2,4,6}.weight
        motionhead/init_conv{i}, (3, 3, 3, c, c): lecun; stpn.py:45
        (TemporalBandedConv)
    motionhead.post_conv{i}.weight
        motionhead/post_conv{i}: lecun; stpn.py:129 (Conv)
    motionhead.{down,up}_convs.*.weight
        motionhead/unet down*/up*: xavier; unet.py:27,171 (UNetCustomWidths)
    motionhead.positional_encoding.{0,2}.weight, motionhead.final_proj.0.weight
        positional_encoding/fc*, final_proj: lecun; stpn.py:145 with
        layers.py:30 (MLP Dense), stpn.py:149 (Dense)
    motionhead.{mos_seg,offset_head}.seg_head.{0,3}.weight
        */fc0, fc1: lecun; layers.py:108,111 (Dense)
    motionhead.{mos_seg,offset_head}.seg_head.1.weight, .bias
        */bn scale, bias: ones, zeros; layers.py:76-77
    reconstructor.alignment.{motion,geo,pos}_embed.*.weight
        alignment/*_embed/fc*: lecun; tpointnet.py:138,139,149, layers.py:30
    reconstructor.alignment.regressor.{0,3,6}.weight
        reg_fc0, reg_fc1, reg_fc2: lecun; tpointnet.py:197,200,203 (Dense)
    reconstructor.alignment.regressor.{1,4}.weight, .bias
        reg_bn0, reg_bn1 scale, bias: ones, zeros; tpointnet.py:198,201,
        layers.py:76-77
    every .bias of a Linear / Conv
        bias: zeros; flax's default and the `self.param` lines above

    The JAX package's TPU forms keep the parameter shape of the plain
    layer the port has (BlockDiagConv: one [3, 3, cin, cout] kernel per
    frame, TemporalBandedConv: [3, 3, 3, c, c], the s2d convolutions: the
    narrow [3, 3, cin, cout] kernel), so the fans are those of the port's
    weight.
    """
    from pcaccumulation_tpu_torch.models.egomotion import EgoMotionHead
    from pcaccumulation_tpu_torch.models.layers import MaskedBatchNorm

    done = set()
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.modules.conv._ConvNd)):
            std = init_std(module)
            if std == 0.0:
                module.weight.zero_()
            else:
                module.weight.copy_(truncated_normal(module.weight.shape, generator)
                                    .mul_(std / TRUNC_STD))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, MaskedBatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
            module.num_batches_tracked.zero_()
        elif isinstance(module, EgoMotionHead):
            module.reset_parameters()
        else:
            continue
        done.update(id(t) for t in (*module.parameters(recurse=False),
                                    *module.buffers(recurse=False)))
    missed = [n for n, t in (*model.named_parameters(), *model.named_buffers())
              if id(t) not in done]
    if missed:
        raise ValueError(f"no initialisation rule for {missed}")
    return model
