"""The port refuses config values whose feature it does not implement: the
CLI, the Trainer and the Tester raise NotImplementedError before any work,
instead of ignoring the value. The options it does implement, the
data-parallel ones included (a `parallel.num_devices` equal to the number
of processes or 0, `parallel.zero1`, `train.ckpt_backend: orbax`), pass
the check and build a Trainer."""

from pathlib import Path

import pytest

from pcaccumulation_tpu_torch import build_model
from pcaccumulation_tpu_torch.config import check_supported, load_config
from pcaccumulation_tpu_torch.main import main
from pcaccumulation_tpu_torch.train import tester
from pcaccumulation_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
DEFAULT = str(REPO / "configs" / "default.yaml")


@pytest.mark.parametrize("override", [
    "--parallel.num_devices=8",
    "--parallel.num_devices=2",
    "--parallel.frame_devices=2",
    "--parallel.spatial_devices=2",
    "--train.ckpt_backend=tensorstore",
])
def test_unported_config_value_is_refused(override, tmp_path, monkeypatch):
    """In one process: a device count other than 1 or 0 (the port runs one
    process per card), the frame and spatial axes, an unknown backend."""
    key = override[2:].split("=")[0]
    cfg = load_config(DEFAULT, overrides=[override])
    with pytest.raises(NotImplementedError, match=key):
        check_supported(cfg)
    with pytest.raises(NotImplementedError, match=key):
        Trainer(cfg, None, {}, save_dir=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match=key):
        tester.Tester(cfg, build_model(cfg, device="cpu"), save_dir=str(tmp_path), device="cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=key):
        main(["main", DEFAULT, "1", "1", "--misc.device=cpu", override])
    assert not (tmp_path / "snapshot").exists()  # refused before the run directory


@pytest.mark.parametrize("override", [
    "--train.remat=true",
    "--train.worker_mode=process",
    "--val.worker_mode=process",
    "--test.worker_mode=process",
    "--pose_estimation.seq_pose=chain",
    "--pose_estimation.seq_pose=full",
    "--stpn.n_band_layers=1",
    "--stpn.n_band_layers=2",
    "--stpn.n_band_layers=3",
    "--parallel.num_devices=0",
    "--parallel.zero1=true",
    "--train.ckpt_backend=orbax",
])
def test_ported_option_passes_the_check(override, tmp_path):
    """Each option of configs/default.yaml that the port implements passes
    `check_supported` and builds a model and a Trainer."""
    cfg = load_config(DEFAULT, overrides=[override])
    check_supported(cfg)
    trainer = Trainer(cfg, build_model(cfg, device="cpu"), {}, save_dir=str(tmp_path),
                      device="cpu")
    assert trainer.remat == (override == "--train.remat=true")


@pytest.mark.parametrize("path", ["default.yaml", "synthetic.yaml"])
def test_shipped_configs_pass_the_check(path):
    """The one-card configs pass, with the options the port does implement
    (s2d level 0, the sparse ego-feature evaluation, the approximate draw)."""
    cfg = load_config(str(REPO / "configs" / path))
    assert cfg["unet"]["s2d_level0"] and cfg["pose_estimation"]["sparse_eval"]
    assert cfg["pose_estimation"]["approx_sampling"]
    check_supported(cfg)


@pytest.mark.parametrize("path", ["waymo.yaml", "nuscene.yaml"])
def test_orbax_configs_are_refused(path, tmp_path):
    """The presets that checkpoint with orbax pass the check and write a
    torch.distributed.checkpoint directory; what stays refused is the JAX
    package's own orbax directory at a checkpoint path, with its message."""
    cfg = load_config(str(REPO / "configs" / path))
    assert cfg["train"]["ckpt_backend"] == "orbax"
    check_supported(cfg)
    (tmp_path / "model_latest.ckpt.orbax").mkdir()
    cfg["misc"]["pretrain"] = str(tmp_path / "model_latest.ckpt")
    with pytest.raises(NotImplementedError, match="orbax checkpoints are not read"):
        tester.Tester(cfg, build_model(cfg, device="cpu"), save_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("world,override,ok", [
    (2, "--parallel.num_devices=2", True),
    (2, "--parallel.num_devices=0", True),
    (4, "--parallel.num_devices=0", True),
    (2, "--parallel.num_devices=1", False),
    (2, "--parallel.num_devices=4", False),
    (2, "--misc.mode=test", False),
    (2, "--parallel.frame_devices=2", False),
])
def test_check_supported_in_a_process_group(world, override, ok):
    """With `world` processes: `parallel.num_devices` must be the world or
    0; test mode is refused (the Tester runs on one process, as the JAX
    CLI's runs on one device); the frame and spatial axes stay refused.
    Each refusal names its key."""
    cfg = load_config(DEFAULT, overrides=[override, "--parallel.zero1=true"]
                      + (["--parallel.num_devices=2"] if "num_devices" not in override else []))
    if ok:
        check_supported(cfg, world)
        return
    key = override[2:].split("=")[0]
    with pytest.raises(NotImplementedError, match=key):
        check_supported(cfg, world)
