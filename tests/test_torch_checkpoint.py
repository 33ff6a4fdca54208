"""The port's one checkpoint reader (`utils/checkpoint.py::read_checkpoint`)
and its two backends on the CPU.

The five forms through `misc.pretrain`, in train mode (the Trainer) and in
test mode (the Tester), with the weights equal after the load: the
reference's `.pth` (built with `torch.save` from a port state_dict), the
JAX package's pickle and orbax directory (with its Trainer's optax state),
the port's `torch.save` file and a `torch.distributed.checkpoint` (DCP)
directory. Then the DCP round trip with the optimizer's state, the rolling
overwrite, the migration between the backends, the refusal of an orbax
directory that is not whole, and a ZeRO-1 checkpoint of two ranks restored
into one rank and into two (two gloo subprocesses of this file, as in
tests/test_torch_parallel.py).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from test_torch_parallel import _load_setup, _rows, run_ranks, tiny_setup


def _cfg(setup, pretrain="", backend="pickle", mode="train"):
    cfg = dict(setup["cfg"])
    cfg["misc"] = dict(cfg["misc"], pretrain=pretrain, mode=mode)
    cfg["train"] = dict(cfg["train"], ckpt_backend=backend)
    return cfg


def _trainer(cfg, tmp_path, name, state=None):
    from pcaccumulation_tpu_torch import build_model
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    model = build_model(cfg, device="cpu")
    if state is not None:
        model.load_state_dict(state)
    return Trainer(cfg, model, {"train": [None] * 4}, save_dir=str(tmp_path / name),
                   device="cpu")


def _assert_weights(model, want: dict) -> None:
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v.reshape(got[k].shape).to(got[k].dtype)), k


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return tiny_setup(str(tmp_path_factory.mktemp("setup")), batch_size=1)


def _write_form(form, setup, tmp_path):
    """A checkpoint of `form` at a path; returns (path, the state_dict the
    model must hold after the load, the epoch it names)."""
    from pcaccumulation_tpu_torch import build_model

    torch.manual_seed(7)
    sd = build_model(setup["cfg"], device="cpu").state_dict()
    if form == "pth":
        path = str(tmp_path / "reference.pth")
        torch.save({"state_dict": sd, "epoch": 3, "best_loss": 0.5}, path)
        return path, sd, 3
    if form in ("jax_pickle", "jax_orbax"):
        import jax

        import pcaccumulation_tpu.train.trainer as jtrainer
        from pcaccumulation_tpu.utils.checkpoint import save_checkpoint as jax_save
        from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
        from test_torch_motionnet import random_variables

        params, stats = random_variables(setup["cfg"], setup["batches"][0], seed=3)
        tx = jtrainer.make_optimizer(setup["cfg"], 10)[0]
        path = str(tmp_path / "model_latest.ckpt")
        jax_save(path, {"epoch": 5, "params": params, "batch_stats": stats,
                        "opt_state": tx.init(jax.tree.map(np.asarray, params)),
                        "best_loss": 1.5, "best_metric": 0.25},
                 backend="orbax" if form == "jax_orbax" else "pickle")
        return path, state_dict_from_jax(params, stats), 5
    backend = {"port": "pickle", "dcp": "orbax"}[form]
    tr = _trainer(_cfg(setup, backend=backend), tmp_path, "src", state=sd)
    tr.snapshot(2, "latest")
    return str(tmp_path / "src" / "model_latest.ckpt"), sd, 2


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("form", ["pth", "jax_pickle", "jax_orbax", "port", "dcp"])
def test_pretrain_reads_every_form(form, mode, setup, tmp_path):
    """`misc.pretrain` names a checkpoint of each form: the Trainer (train
    mode) and the Tester (test mode) load its weights exactly; the Trainer
    takes the epoch, keeps the port's optimizer state and the JAX
    package's mapped optax state, and reinitialises the reference's
    torch.optim state, which does not map (logged), with no KeyError."""
    from pcaccumulation_tpu_torch import build_model
    from pcaccumulation_tpu_torch.train.tester import Tester

    path, want, epoch = _write_form(form, setup, tmp_path)
    cfg = _cfg(setup, pretrain=path, mode=mode)
    if mode == "test":
        tester = Tester(cfg, build_model(cfg, device="cpu"), save_dir=str(tmp_path / "t"),
                        device="cpu", results_dir=str(tmp_path / "r"))
        _assert_weights(tester.model, want)
        return
    tr = _trainer(cfg, tmp_path, "dst")
    _assert_weights(tr.model, want)
    assert tr.start_epoch == epoch + 1
    log = (tmp_path / "dst" / "log").read_text()
    assert ("reinitialised" in log) == (form == "pth"), log


def test_dcp_round_trip_with_the_optimizer(setup, tmp_path):
    """An orbax (DCP) snapshot after an optimizer update restores the
    weights, the running statistics, Adam's moments, the accumulators, the
    counters, the epoch and the best values."""
    from pcaccumulation_tpu_torch import to_device

    tr = _trainer(_cfg(setup, backend="orbax"), tmp_path, "a")
    batch = to_device(setup["batches"][0], "cpu")
    for i in range(3):  # one update at iter_size 2, one micro-step accumulated
        tr.train_step(batch, tr.step_generator(1, "train", i))
    tr.best_loss, tr.best_metric = 0.75, 0.5
    tr.snapshot(4, "best_loss")
    path = str(tmp_path / "a" / "model_best_loss.ckpt")
    assert os.path.isfile(os.path.join(path + ".dcp", ".metadata"))
    assert not os.path.exists(path)
    tr2 = _trainer(_cfg(setup, pretrain=path, backend="orbax"), tmp_path, "b")
    _assert_weights(tr2.model, tr.model.state_dict())
    for key in ("acc", "mu", "nu"):
        for a, b in zip(getattr(tr.optimizer, key), getattr(tr2.optimizer, key)):
            assert torch.equal(a, b), key
    assert (tr2.optimizer.count, tr2.optimizer.mini_step) == (1, 1)
    assert (tr2.start_epoch, tr2.best_loss, tr2.best_metric) == (5, 0.75, 0.5)


def test_rolling_overwrite_and_backend_migration(setup, tmp_path):
    """A snapshot overwrites its own backend's checkpoint at the path (no
    temporary left), and removes the other backend's there, so the reader
    never takes an older one."""
    from pcaccumulation_tpu_torch.utils.checkpoint import read_checkpoint

    path = str(tmp_path / "run" / "model_latest.ckpt")
    tr = _trainer(_cfg(setup, backend="orbax"), tmp_path, "run")
    tr.snapshot(1, "latest")
    tr.snapshot(2, "latest")
    assert read_checkpoint(path)["epoch"] == 2
    assert sorted(os.listdir(tmp_path / "run")) == ["log", "model_arch.txt",
                                                    "model_latest.ckpt.dcp"]
    tr.cfg["train"]["ckpt_backend"] = "pickle"
    tr.snapshot(3, "latest")
    assert not os.path.exists(path + ".dcp") and os.path.isfile(path)
    assert read_checkpoint(path)["epoch"] == 3
    tr.cfg["train"]["ckpt_backend"] = "orbax"
    tr.snapshot(4, "latest")
    assert not os.path.exists(path) and os.path.isdir(path + ".dcp")
    state = read_checkpoint(path + ".dcp")  # the directory itself reads too
    assert state["epoch"] == 4
    _assert_weights(tr.model, state["model"])


def test_jax_orbax_directory_is_refused(setup, tmp_path):
    """The JAX package's orbax checkpoints (`<path>.orbax/`) are read
    (`test_pretrain_reads_every_form[jax_orbax]`, tests/test_torch_orbax.py);
    what is refused is a `<path>.orbax/` that is not a whole one (here an
    empty directory), by the reader and by the Trainer, with the missing
    files named; a missing path is a FileNotFoundError."""
    from pcaccumulation_tpu_torch.utils.checkpoint import read_checkpoint
    from pcaccumulation_tpu_torch.utils.orbax_read import OrbaxFormatError

    path = str(tmp_path / "model_latest.ckpt")
    os.makedirs(path + ".orbax")
    with pytest.raises(OrbaxFormatError, match="not a whole orbax checkpoint"):
        read_checkpoint(path)
    with pytest.raises(OrbaxFormatError, match="_METADATA or manifest.ocdbt"):
        _trainer(_cfg(setup, pretrain=path), tmp_path, "t")
    with pytest.raises(FileNotFoundError):
        read_checkpoint(str(tmp_path / "absent.ckpt"))


# --------------------------------------------------------------- the ranks
def _zero1_child(rank: int, world: int, port: int, out: str) -> None:
    """ZeRO-1 at world 2: one update and a micro-step, an orbax snapshot,
    the full state written by rank 0; then every rank restores the
    snapshot into a fresh Trainer and checks the entries it owns."""
    import json

    from pcaccumulation_tpu_torch import build_model, to_device
    from pcaccumulation_tpu_torch.parallel import mesh
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    mesh.init_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                          rank=rank, timeout_s=60)
    cfg, batches, state = _load_setup(out)
    cfg = json.loads(json.dumps(cfg))
    cfg["parallel"].update(zero1=True, num_devices=world)
    cfg["train"]["ckpt_backend"] = "orbax"
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    tr = Trainer(cfg, model, {"train": [None] * 4}, save_dir=os.path.join(out, "z"),
                 device="cpu")
    for i in range(3):
        tr.train_step(to_device(_rows(batches[i % 2], rank, world), "cpu"),
                      tr.step_generator(1, "train", i))
    tr.snapshot(1, "latest")
    full = tr.optimizer.full_state_dict()
    if rank == 0:
        torch.save({"optimizer": full, "model": model.state_dict()},
                   os.path.join(out, "zero1_full.pt"))
    cfg["misc"]["pretrain"] = os.path.join(out, "z", "model_latest.ckpt")
    tr2 = Trainer(cfg, build_model(cfg, device="cpu"), {"train": [None] * 4},
                  save_dir=os.path.join(out, "z2"), device="cpu")
    for key in ("acc", "mu", "nu"):
        mine = getattr(tr2.optimizer, key)
        for i, name in enumerate(tr2.optimizer.names):
            if i in tr2.optimizer.owned:
                assert torch.equal(mine[i], full[key][name]), (key, name)
            else:
                assert mine[i] is None
    assert tr2.optimizer.count == 1 and tr2.optimizer.mini_step == 1
    with open(os.path.join(out, f"restored_r{rank}"), "w") as f:
        f.write(f"{len(tr2.optimizer.owned)} of {len(tr2.params)}\n")
    torch.distributed.destroy_process_group()


def test_zero1_checkpoint_of_two_ranks_restores_into_one_and_two(tmp_path):
    """Each rank of a ZeRO-1 run writes the moments of the parameters it
    owns into the DCP directory, under their names; restored at world 2
    each rank gets its own entries back (checked in the ranks), and at
    world 1 one process gets every entry (here)."""
    from pcaccumulation_tpu_torch import build_model
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    out = str(tmp_path)
    setup = tiny_setup(out)
    run_ranks("zero1_ckpt", 2, out, script=os.path.abspath(__file__))
    owned = [open(os.path.join(out, f"restored_r{r}")).read().split()[0] for r in (0, 1)]
    full = torch.load(os.path.join(out, "zero1_full.pt"))
    n_params = len(full["optimizer"]["mu"])
    assert sum(int(x) for x in owned) == n_params and all(int(x) > 0 for x in owned)
    cfg = _cfg(setup, pretrain=os.path.join(out, "z", "model_latest.ckpt"), backend="orbax")
    cfg["parallel"] = dict(cfg["parallel"], zero1=True)
    tr = Trainer(cfg, build_model(cfg, device="cpu"), {"train": [None] * 4},
                 save_dir=str(tmp_path / "w1"), device="cpu")
    _assert_weights(tr.model, full["model"])
    for key in ("acc", "mu", "nu"):
        for i, name in enumerate(tr.optimizer.names):
            assert torch.equal(getattr(tr.optimizer, key)[i], full["optimizer"][key][name])
    assert tr.optimizer.count == 1 and tr.optimizer.mini_step == 1


if __name__ == "__main__":
    assert sys.argv[1] == "zero1_ckpt"
    _zero1_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
