"""The port refuses config values whose feature it does not implement: the
CLI, the Trainer and the Tester raise NotImplementedError before any work,
instead of ignoring the value."""

from pathlib import Path

import pytest

from pcaccumulation_tpu_torch.config import check_supported, load_config
from pcaccumulation_tpu_torch.main import main
from pcaccumulation_tpu_torch.train import tester
from pcaccumulation_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
DEFAULT = str(REPO / "configs" / "default.yaml")


@pytest.mark.parametrize("override", [
    "--parallel.num_devices=8",
    "--parallel.num_devices=0",
    "--parallel.frame_devices=2",
    "--parallel.spatial_devices=2",
    "--parallel.zero1=true",
    "--train.remat=true",
    "--train.ckpt_backend=orbax",
    "--train.worker_mode=process",
    "--val.worker_mode=process",
    "--test.worker_mode=process",
])
def test_unported_config_value_is_refused(override, tmp_path, monkeypatch):
    key = override[2:].split("=")[0]
    cfg = load_config(DEFAULT, overrides=[override])
    with pytest.raises(NotImplementedError, match=key):
        check_supported(cfg)
    with pytest.raises(NotImplementedError, match=key):
        Trainer(cfg, None, {}, save_dir=str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match=key):
        tester.Tester(cfg, None, save_dir=str(tmp_path), device="cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=key):
        main(["main", DEFAULT, "1", "1", "--misc.device=cpu", override])
    assert not (tmp_path / "snapshot").exists()  # refused before the run directory


@pytest.mark.parametrize("path", ["default.yaml", "synthetic.yaml"])
def test_shipped_configs_pass_the_check(path):
    """The one-card configs pass, with the options the port does implement
    (s2d level 0, the sparse ego-feature evaluation, the approximate draw)."""
    cfg = load_config(str(REPO / "configs" / path))
    assert cfg["unet"]["s2d_level0"] and cfg["pose_estimation"]["sparse_eval"]
    assert cfg["pose_estimation"]["approx_sampling"]
    check_supported(cfg)


@pytest.mark.parametrize("path", ["waymo.yaml", "nuscene.yaml"])
def test_orbax_configs_are_refused(path):
    with pytest.raises(NotImplementedError, match="ckpt_backend='orbax'"):
        check_supported(load_config(str(REPO / "configs" / path)))
