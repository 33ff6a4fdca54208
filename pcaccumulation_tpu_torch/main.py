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
--misc.device=cpu), and the processes form a (data, frame, spatial) mesh
(`parallel/mesh.py`) of `parallel.frame_devices` x
`parallel.spatial_devices` processes per sequence:

    torchrun --nproc_per_node=N -m pcaccumulation_tpu_torch.main <config.yaml> <batch_size> <iter_size> \
        --parallel.num_devices=N --parallel.frame_devices=F --parallel.spatial_devices=S

Each data coordinate trains on its slice of the data: <batch_size> is per
data coordinate, the joined batch is N / (F * S) x batch_size; the F * S
processes of one sequence split its UNet over its frames and its BEV rows.
`parallel.num_devices` is the number of processes, or 0 (all); 1 with
F * S > 1 means F * S, as in the JAX CLI. Rank 0 writes the run
directory's config, source snapshot and logs.
"""

from __future__ import annotations

import os
import shutil
import sys

import torch.distributed as dist

from pcaccumulation_tpu_torch import build_model, model_generator
from pcaccumulation_tpu_torch.config import check_supported, load_config, save_config
from pcaccumulation_tpu_torch.data.dataset import SceneDataset
from pcaccumulation_tpu_torch.data.loader import make_loader
from pcaccumulation_tpu_torch.parallel import mesh
from pcaccumulation_tpu_torch.utils.logging import setup_seed

_PKG = os.path.dirname(os.path.abspath(__file__))


def build_loaders(cfg: dict, rank: int = 0, world: int = 1) -> dict:
    """The train and val loaders of the data coordinate `rank` of `world`."""
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

        model = build_model(cfg, device, model_generator(cfg))
        if mode == "test":
            from pcaccumulation_tpu_torch.train.tester import Tester

            Tester(cfg, model, save_dir=save_dir, device=device).test()
            return 0

        from pcaccumulation_tpu_torch.train.trainer import Trainer

        par = cfg["parallel"]
        on = mesh.make_mesh(par.get("frame_devices", 1), par.get("spatial_devices", 1))
        trainer = Trainer(cfg, model, build_loaders(cfg, on.coords[0], on.data),
                          save_dir=save_dir, device=device, mesh=on)
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
