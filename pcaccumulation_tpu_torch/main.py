"""CLI entry point of the port, shaped like the JAX package's `main.py`.

    python -m pcaccumulation_tpu_torch.main <config.yaml> <batch_size> <iter_size> [--a.b.c=value ...]
    torchrun --nproc_per_node=<cards> -m pcaccumulation_tpu_torch.main <config.yaml> ...

Modes (--misc.mode=train|val|test):
  train: the training loop with per-epoch validation and rolling checkpoints
  val:   one validation epoch
  test:  per-scene flow_error.npz dumps under results/<misc.exp_name> and the
         MOS / cluster evaluation (then: python -m
         pcaccumulation_tpu_torch.evaluation results/<exp_name> <dataset>)
It runs on the card unless --misc.device=cpu is given. The run directory is
snapshot/<misc.exp_name> under the working directory.

Under torchrun each process takes one card (NCCL; gloo with
--misc.device=cpu) and trains on its slice of the data: <batch_size> is per
process, the joined batch is world x batch_size (`parallel/mesh.py`).
`parallel.num_devices` is the number of processes, or 0 (all). Rank 0
writes the run directory's config, source snapshot and logs.
"""

from __future__ import annotations

import os
import shutil
import sys

import torch.distributed as dist

from pcaccumulation_tpu_torch import build_model
from pcaccumulation_tpu_torch.config import check_supported, load_config, save_config
from pcaccumulation_tpu_torch.data.dataset import SceneDataset
from pcaccumulation_tpu_torch.data.loader import make_loader
from pcaccumulation_tpu_torch.parallel import mesh
from pcaccumulation_tpu_torch.utils.logging import setup_seed

_PKG = os.path.dirname(os.path.abspath(__file__))


def build_loaders(cfg: dict, rank: int = 0, world: int = 1) -> dict:
    """The train and val loaders of the process `rank` of `world`."""
    loaders = {}
    for split in ("train", "val"):
        try:
            ds = SceneDataset(cfg, split)
        except FileNotFoundError:
            continue
        loaders[split] = make_loader(ds, batch_size=cfg[split]["batch_size"],
                                     shuffle=split == "train",
                                     num_workers=cfg[split]["num_workers"],
                                     drop_last=True, seed=cfg["misc"]["seed"],
                                     mode=cfg[split].get("worker_mode", "thread"),
                                     process_id=rank, process_count=world)
    return loaders


def snapshot_source(save_dir: str) -> None:
    """Copy the port's source into the run directory."""
    dst = os.path.join(save_dir, "src_snapshot", os.path.basename(_PKG))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_PKG, dst, ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so"))


def main(argv: list[str]) -> int:
    if len(argv) < 4:
        print(__doc__)
        return 1
    config_path, batch_size, iter_size = argv[1], int(argv[2]), int(argv[3])
    cfg = load_config(config_path, overrides=argv[4:])
    cfg["train"]["batch_size"] = batch_size
    cfg["train"]["iter_size"] = iter_size
    mode = cfg["misc"]["mode"]
    if mode not in ("train", "val", "test"):
        raise ValueError(f"mode={mode!r}: train, val or test")
    world_env = int(os.environ.get("WORLD_SIZE", 1)) if not dist.is_initialized() else None
    check_supported(cfg, world_env)  # before joining a group: a refusal costs no rendezvous
    own_group = not dist.is_initialized()
    device = mesh.init_distributed(cfg["misc"].get("device"))
    try:
        group = mesh.default_group()
        rank, world = mesh.rank(group), mesh.world(group)
        check_supported(cfg, world)
        setup_seed(cfg["misc"]["seed"])

        save_dir = os.path.join("snapshot", cfg["misc"]["exp_name"])
        os.makedirs(save_dir, exist_ok=True)
        if rank == 0:
            save_config(cfg, os.path.join(save_dir, "config.json"))
            snapshot_source(save_dir)

        model = build_model(cfg, device)
        if mode == "test":
            from pcaccumulation_tpu_torch.train.tester import Tester

            Tester(cfg, model, save_dir=save_dir, device=device).test()
            return 0

        from pcaccumulation_tpu_torch.train.trainer import Trainer

        trainer = Trainer(cfg, model, build_loaders(cfg, rank, world), save_dir=save_dir,
                          device=device)
        if mode == "train":
            trainer.train()
        else:
            trainer.eval()
        return 0
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main(sys.argv))
