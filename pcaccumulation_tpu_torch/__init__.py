"""PyTorch/CUDA port of pcaccumulation_tpu for one NVIDIA H100.

The MotionNet forward in train, val and test mode, training
(train/trainer.py) and the test path (train/tester.py, evaluation.py), all
driven by main.py, at the default config, with hand-written CUDA kernels,
and gradients that launch them, for the segment pool (kernels/segscan.py),
the shear-warp row shift (kernels/row_shift.py) and the nearest neighbour
of ICP and the Chamfer distance (kernels/chamfer.py). Entry points run on
the card unless the caller asks for the CPU with `device="cpu"`; without a
CUDA device they raise instead of falling back. Training runs in one
process or data-parallel, one process per card (parallel/mesh.py).
"""

from __future__ import annotations

import os

# cuBLAS takes its workspace configuration from the environment when its
# first handle is made; deterministic algorithms (the Trainer's steps) need
# this one, and torch raises inside the first product without it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pcaccumulation_tpu_torch.models.motionnet import MotionNet  # noqa: E402

__all__ = ["MotionNet", "build_model", "resolve_device", "to_device"]


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; a CUDA device with no card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def build_model(cfg: dict, device=None) -> MotionNet:
    """A MotionNet for the (derived) config on the device, in eval mode.

    Weights come from torch's default initialisation (seed it with
    `torch.manual_seed`) or from `load_state_dict`. TF32 is switched off
    for matrix products and convolutions: the float32 config and the
    geometry are float32 throughout, as in the JAX package.
    """
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return MotionNet(cfg).to(dev).eval()


def to_device(batch: dict, device=None) -> dict:
    """A collated numpy batch (`data.loader.collate`) as tensors on the device."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
