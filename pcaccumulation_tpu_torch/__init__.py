"""PyTorch/CUDA port of pcaccumulation_tpu for one NVIDIA H100.

The MotionNet forward in train, val and test mode, training
(train/trainer.py) and the test path (train/tester.py, evaluation.py), all
driven by main.py, at the default config, with hand-written CUDA kernels,
and gradients that launch them, for the segment pool (kernels/segscan.py),
the shear-warp row shift (kernels/row_shift.py) and the nearest neighbour
of ICP and the Chamfer distance (kernels/chamfer.py). Entry points run on
the card unless the caller asks for the CPU with `device="cpu"`; without a
CUDA device they raise instead of falling back. Training and serving run
in one process or on a (data, frame, spatial) mesh of processes, one card
each (parallel/mesh.py).
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
from pcaccumulation_tpu_torch.utils.weights import init_parameters  # noqa: E402

__all__ = ["MotionNet", "build_model", "model_generator", "resolve_device", "to_device"]


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; a CUDA device with no card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def build_model(cfg: dict, device=None, generator: torch.Generator | None = None) -> MotionNet:
    """A MotionNet for the (derived) config on the device, in eval mode.

    Its weights are drawn on the CPU from `generator` (a CPU
    `torch.Generator`; None: torch's default one) from the JAX package's
    initial distributions (`utils.weights.init_parameters`): truncated
    normal lecun kernels, xavier kernels in the UNets, zero biases, BatchNorm
    at ones and zeros, the affinity's alpha and beta at -5. So the same
    generator seed gives the same weights on every device and rank.
    `model_generator(cfg)` is the one seeded from `misc.seed`. The modules
    are built on the meta device, so `init_parameters` makes the only draw
    and writes every value: with a generator, torch's default generator is
    left as it was. Reading a checkpoint (`load_state_dict`) overwrites
    them. TF32 is switched off for matrix products and convolutions: the
    float32 config and the geometry are float32 throughout, as in the JAX
    package.
    """
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = MotionNet(cfg)  # no storage and no draws: init_parameters writes every value
    return init_parameters(model.to_empty(device="cpu"), generator).to(dev).eval()


def model_generator(cfg: dict) -> torch.Generator:
    """The CPU generator a run draws its initial weights from, seeded from
    `misc.seed`."""
    return torch.Generator().manual_seed(int(cfg["misc"]["seed"]))


def to_device(batch: dict, device=None) -> dict:
    """A collated numpy batch (`data.loader.collate`) as tensors on the device."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
