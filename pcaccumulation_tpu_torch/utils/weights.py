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
"""

from __future__ import annotations

import numpy as np
import torch


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
        self.bn(f"{prefix}.seg_head.1", p["bn"], s["bn"])
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


def state_dict_from_jax(params: dict, batch_stats: dict) -> dict[str, torch.Tensor]:
    """JAX MotionNet (params, batch_stats) -> state_dict (CPU float32 tensors)."""
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
        wr.seg_head(head, params[head], batch_stats[head], conv=True)
    for name in ("alpha", "beta"):
        wr.sd[f"ego_motion_head.{name}"] = _tensor(params["ego_motion_head"][name])

    mh, mh_stats = params["motionhead"], batch_stats["motionhead"]
    for i in range(4):
        if f"init_conv{i}" in mh:
            wr.conv3d(f"motionhead.init_conv.{2 * i}", mh[f"init_conv{i}"])
        else:
            wr.conv2d(f"motionhead.post_conv{i}", mh[f"post_conv{i}"])
    wr.unet_levels("motionhead", mh["unet"])
    wr.mlp("motionhead.positional_encoding", mh["positional_encoding"])
    wr.linear("motionhead.final_proj.0", mh["final_proj"])
    for head in ("mos_seg", "offset_head"):
        wr.seg_head(f"motionhead.{head}", mh[head], mh_stats[head], conv=False)

    al = params["reconstructor"]["alignment"]
    al_stats = batch_stats["reconstructor"]["alignment"]
    pre = "reconstructor.alignment"
    for name in ("geo_embed", "motion_embed", "pos_embed"):
        wr.mlp(f"{pre}.{name}", al[name])
    wr.linear(f"{pre}.regressor.0", al["reg_fc0"])
    wr.bn(f"{pre}.regressor.1", al["reg_bn0"], al_stats["reg_bn0"])
    wr.linear(f"{pre}.regressor.3", al["reg_fc1"])
    wr.bn(f"{pre}.regressor.4", al["reg_bn1"], al_stats["reg_bn1"])
    wr.linear(f"{pre}.regressor.6", al["reg_fc2"])
    return wr.sd
