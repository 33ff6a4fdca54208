"""The port refuses config values whose feature it does not implement, and
mesh geometries that do not fit its processes: the CLI, the Trainer and
the Tester raise NotImplementedError before any work, instead of ignoring
the value. The options it does implement, the mesh's included (a
`parallel.num_devices` equal to the number of processes or 0, frame and
spatial factors whose product divides it, `parallel.zero1`,
`train.ckpt_backend: orbax`), pass the check and build a Trainer; a config
saved by a run on a frame or spatial mesh runs the Tester and the
Predictor in one process."""

from pathlib import Path

import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

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
    process per card), a frame or spatial factor of 2 (a mesh of 2
    processes cannot be laid out on 1), an unknown backend. The Tester
    runs one process's forward whatever the saved frame and spatial
    factors say, as the JAX package's Tester does outside a mesh."""
    key = override[2:].split("=")[0]
    cfg = load_config(DEFAULT, overrides=[override])
    with pytest.raises(NotImplementedError, match=key):
        check_supported(cfg)
    with pytest.raises(NotImplementedError, match=key):
        Trainer(cfg, None, {}, save_dir=str(tmp_path), device="cpu")
    model = build_model(cfg, device="cpu")
    if key in ("parallel.frame_devices", "parallel.spatial_devices"):
        tester.Tester(cfg, model, save_dir=str(tmp_path), device="cpu")
    else:
        with pytest.raises(NotImplementedError, match=key):
            tester.Tester(cfg, model, save_dir=str(tmp_path), device="cpu")
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
    torch.distributed.checkpoint directory, and the Tester reads the JAX
    package's own orbax directory at a checkpoint path: a real save by the
    JAX package's `save_checkpoint(..., backend="orbax")` at the preset's
    full width (the parameter tree `convert_state_dict` makes of a port
    state_dict) loads every weight bit for bit. What stays refused is a
    `<path>.orbax/` that is not a whole checkpoint, with its message."""
    from pcaccumulation_tpu.utils.checkpoint import save_checkpoint as jax_save
    from pcaccumulation_tpu.utils.torch_convert import convert_state_dict
    from pcaccumulation_tpu_torch.utils.orbax_read import OrbaxFormatError

    cfg = load_config(str(REPO / "configs" / path))
    assert cfg["train"]["ckpt_backend"] == "orbax"
    check_supported(cfg)
    (tmp_path / "empty.ckpt.orbax").mkdir()
    cfg["misc"]["pretrain"] = str(tmp_path / "empty.ckpt")
    with pytest.raises(OrbaxFormatError, match="not a whole orbax checkpoint"):
        tester.Tester(cfg, build_model(cfg, device="cpu"), save_dir=str(tmp_path), device="cpu")

    torch.manual_seed(1)
    want = build_model(cfg, device="cpu").state_dict()
    params, stats = convert_state_dict({k: v.numpy() for k, v in want.items()},
                                       cfg["pillar_encoder"]["depth"], cfg["unet"]["depth"])
    jax_save(str(tmp_path / "model_latest.ckpt"),
             {"epoch": 1, "params": params, "batch_stats": stats}, backend="orbax")
    cfg["misc"]["pretrain"] = str(tmp_path / "model_latest.ckpt")
    got = tester.Tester(cfg, build_model(cfg, device="cpu"), save_dir=str(tmp_path),
                        device="cpu").model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("world,override,ok", [
    (2, "--parallel.num_devices=2", True),
    (2, "--parallel.num_devices=0", True),
    (4, "--parallel.num_devices=0", True),
    (2, "--parallel.num_devices=1", False),
    (2, "--parallel.num_devices=4", False),
    (2, "--misc.mode=test", False),
    (2, "--parallel.frame_devices=2", True),
    (2, "--parallel.spatial_devices=2", True),
    (4, "--parallel.frame_devices=2 --parallel.spatial_devices=2 --parallel.num_devices=4",
     True),
    (8, "--parallel.frame_devices=2 --parallel.spatial_devices=2 --parallel.num_devices=0",
     True),
    (2, "--parallel.frame_devices=2 --parallel.num_devices=1", True),
    (3, "--parallel.frame_devices=2 --parallel.num_devices=0", False),
    (6, "--parallel.spatial_devices=4 --parallel.num_devices=0", False),
    (4, "--parallel.num_devices=1 --parallel.frame_devices=2", False),
    (19, "--parallel.spatial_devices=19 --parallel.num_devices=0", False),
    (6, "--parallel.frame_devices=6 --parallel.num_devices=0", False),
])
def test_check_supported_in_a_process_group(world, override, ok):
    """With `world` processes: `parallel.num_devices` must be the world or
    0 (1 with frame x spatial = F*S > 1 means F*S, as in the JAX CLI); F*S
    must divide the world, F be at most the T=5 frames, and S at most the
    288 / 2^(5-1) = 18 bands of the UNet's pools; test mode is refused
    (the Tester runs on one process, as the JAX CLI's runs on one device).
    Each refusal names its key (the first override's)."""
    overrides = override.split()
    cfg = load_config(DEFAULT, overrides=overrides + ["--parallel.zero1=true"]
                      + (["--parallel.num_devices=2"] if "num_devices" not in override else []))
    if ok:
        check_supported(cfg, world)
        return
    key = overrides[0][2:].split("=")[0]
    with pytest.raises(NotImplementedError, match=key):
        check_supported(cfg, world)


@pytest.mark.parametrize("axis", ["frame_devices", "spatial_devices"])
def test_saved_mesh_config_runs_one_process(axis, tmp_path):
    """A config saved by a run on a mesh of 2 (F=2 or S=2), used in one
    process: the Tester and the Predictor build without a mesh and compute
    what they compute on the same config without the factor, bit for bit
    (the Tester's test-mode step, a predict)."""
    import copy

    from pcaccumulation_tpu_torch import to_device
    from pcaccumulation_tpu_torch.serve import Predictor
    from test_torch_mesh import scan, tiny_cfg
    import __graft_entry__ as ge

    plain = tiny_cfg(4)
    saved = copy.deepcopy(plain)
    saved["parallel"][axis] = 2
    torch.manual_seed(0)
    state = build_model(plain, device="cpu").state_dict()
    batch = to_device(ge._batch(plain, batch_size=1), "cpu")
    out = {}
    for name, cfg in (("plain", plain), ("saved", saved)):
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        t = tester.Tester(cfg, model, save_dir=str(tmp_path / name), device="cpu")
        with torch.no_grad():
            step = t.step(batch)
        pred = Predictor(cfg, state_dict=state, device="cpu").predict(*scan(4))
        out[name] = (step, pred)
    (step0, pred0), (step1, pred1) = out["plain"], out["saved"]
    for k in ("epe", "rel", "inst_labels_est"):
        assert torch.equal(step0[k], step1[k]), k
    assert sorted(pred0) == sorted(pred1)
    for k in pred0:
        np.testing.assert_array_equal(pred0[k], pred1[k], err_msg=k)
