"""CLI entry point of the port, shaped like the JAX package's `main.py`.

    python -m pcaccumulation_tpu_torch.main <config.yaml> <batch_size> <iter_size> [--a.b.c=value ...]

Modes (--misc.mode=train|val|test):
  train: the training loop with per-epoch validation and rolling checkpoints
  val:   one validation epoch
  test:  per-scene flow_error.npz dumps under results/<misc.exp_name> and the
         MOS / cluster evaluation (then: python -m
         pcaccumulation_tpu_torch.evaluation results/<exp_name> <dataset>)
It runs on the card unless --misc.device=cpu is given. The run directory is
snapshot/<misc.exp_name> under the working directory.
"""

from __future__ import annotations

import os
import shutil
import sys

from pcaccumulation_tpu_torch import build_model
from pcaccumulation_tpu_torch.config import check_supported, load_config, save_config
from pcaccumulation_tpu_torch.data.dataset import SceneDataset
from pcaccumulation_tpu_torch.data.loader import make_loader
from pcaccumulation_tpu_torch.utils.logging import setup_seed

_PKG = os.path.dirname(os.path.abspath(__file__))


def build_loaders(cfg: dict) -> dict:
    loaders = {}
    for split in ("train", "val"):
        try:
            ds = SceneDataset(cfg, split)
        except FileNotFoundError:
            continue
        loaders[split] = make_loader(ds, batch_size=cfg[split]["batch_size"],
                                     shuffle=split == "train",
                                     num_workers=cfg[split]["num_workers"],
                                     drop_last=True, seed=cfg["misc"]["seed"])
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
    check_supported(cfg)
    mode = cfg["misc"]["mode"]
    if mode not in ("train", "val", "test"):
        raise ValueError(f"mode={mode!r}: train, val or test")
    setup_seed(cfg["misc"]["seed"])

    save_dir = os.path.join("snapshot", cfg["misc"]["exp_name"])
    os.makedirs(save_dir, exist_ok=True)
    save_config(cfg, os.path.join(save_dir, "config.json"))
    snapshot_source(save_dir)

    device = cfg["misc"].get("device")
    model = build_model(cfg, device)
    if mode == "test":
        from pcaccumulation_tpu_torch.train.tester import Tester

        Tester(cfg, model, save_dir=save_dir, device=device).test()
        return 0

    from pcaccumulation_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, model, build_loaders(cfg), save_dir=save_dir, device=device)
    if mode == "train":
        trainer.train()
    else:
        trainer.eval()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
