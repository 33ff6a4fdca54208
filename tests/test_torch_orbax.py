"""The port's reader of the JAX package's orbax checkpoints
(`utils/orbax_read.py`) and the JAX Trainer's optax state carried into the
port (`utils/weights.py::optimizer_state_from_jax`), on the CPU.

One module-scoped JAX run at the tiny training config of
tests/test_torch_train.py (`_tiny_cfg(iter_size=2)`, the clip at 1.0):
seeded parameters, the JAX package's `make_optimizer` fed seeded gradients
(not the model's: the carried state is held apart from the composed
gradient's own spread), saved by the JAX package's `save_checkpoint` in
both backends at two points:
- "mid_window": after 2 updates and one further micro-step (Adam's count
  2, mini_step 1, a nonzero accumulator);
- "after_skip": after 2 updates and a window whose second micro-step is
  non-finite (the update skipped: total_notfinite 1, the accumulator
  0 * nan).
"""

from __future__ import annotations

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

import pcaccumulation_tpu.train.trainer as jtrainer
from pcaccumulation_tpu.utils.checkpoint import load_checkpoint as jax_load
from pcaccumulation_tpu.utils.checkpoint import save_checkpoint as jax_save
from pcaccumulation_tpu_torch import build_model
from pcaccumulation_tpu_torch.train.trainer import Optimizer
from pcaccumulation_tpu_torch.utils.checkpoint import read_checkpoint
from pcaccumulation_tpu_torch.utils.orbax_read import OcdbtStore, OrbaxFormatError, read_orbax
from pcaccumulation_tpu_torch.utils.weights import params_from_jax, state_dict_from_jax
from test_torch_motionnet import make_batch, random_variables
from test_torch_train import _tiny_cfg

UPDATES_PER_EPOCH = 2  # the LR decays after two applied updates
N_MICRO = {"mid_window": 5, "after_skip": 6}
_STEPS: dict = {}  # one jitted optax step per optimizer


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.02).astype(np.float32), params)


def _apply(tx, state, params, grads):
    step = _STEPS.setdefault(id(tx), jax.jit(
        lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(*tx.update(g, s, p))))
    p, state = step(grads, state, params)
    return jax.tree.map(np.asarray, p), state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_run")
    cfg = _tiny_cfg(iter_size=2)
    cfg["train"]["grad_clip"] = 1.0
    batch = make_batch(cfg, seed=0, batch_size=1)
    params, stats = random_variables(cfg, batch, seed=3)
    tx = jtrainer.make_optimizer(cfg, UPDATES_PER_EPOCH)[0]
    grads = [_grads(params, 100 + i) for i in range(12)]
    grads[5] = jax.tree.map(lambda g: g.copy(), grads[5])
    grads[5]["unet"]["conv_final"]["bias"][0] = np.nan  # window 3 of after_skip
    res = {"cfg": cfg, "tx": tx, "grads": grads, "stats": stats}
    for case, n in N_MICRO.items():
        p, st = params, tx.init(jax.tree.map(jnp.asarray, params))
        for g in grads[:n]:
            p, st = _apply(tx, st, p, g)
        st = jax.tree.map(np.asarray, st)
        state = {"epoch": 5, "params": p, "batch_stats": stats, "opt_state": st,
                 "best_loss": 1.5, "best_metric": 0.25}
        for backend in ("orbax", "pickle"):
            path = str(out / f"{case}_{backend}" / "model_latest.ckpt")
            jax_save(path, state, backend=backend)
            res[case, backend] = path
        res[case] = {"params": p, "opt_state": st}
    assert int(res["mid_window"]["opt_state"].mini_step) == 1
    assert int(res["after_skip"]["opt_state"].inner_opt_state.total_notfinite) == 1
    return res


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _assert_same_tree(got, want):
    assert type(got) is type(want) or (isinstance(got, dict) and isinstance(want, dict)), \
        (type(got), type(want))
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k, wv in w.items():
        gv = g[k]
        if torch.is_tensor(gv):  # bfloat16
            assert wv.dtype == jnp.bfloat16 and gv.dtype == torch.bfloat16, k
            assert np.array_equal(gv.view(torch.int16).numpy(),
                                  np.asarray(wv).view(np.int16)), k
        elif isinstance(wv, np.ndarray):
            assert isinstance(gv, np.ndarray) and gv.dtype == wv.dtype, (k, gv, wv.dtype)
            assert gv.shape == wv.shape and gv.tobytes() == wv.tobytes(), k
        else:
            assert type(gv) is type(wv) and (gv == wv or (gv != gv and wv != wv)), (k, gv, wv)


@pytest.mark.parametrize("case", ["mid_window", "after_skip"])
def test_reader_is_bit_equal_to_the_orbax_restore(case, run):
    """Every leaf of the JAX package's orbax save as `load_checkpoint`
    (orbax's restore without a target) gives it: the same nesting (dicts,
    lists for optax's chain tuples, None, ()), dtypes (float32, int32,
    int64, float64, bool) and bytes, NaN included."""
    _assert_same_tree(read_orbax(run[case, "orbax"]), jax_load(run[case, "orbax"]))


def test_reader_dtypes_scalars_and_chunks(tmp_path):
    """bfloat16 (as a torch.bfloat16 view), uint32, float64, int64, bool,
    orbax's "scalar" leaves (Python numbers) and a 0-d array against
    orbax's restore; and a zarr array that tensorstore writes in several
    chunks into an OCDBT store, edge chunks cut and unwritten chunks at
    the fill value, against the array written."""
    import orbax.checkpoint as ocp
    import tensorstore as ts

    from pcaccumulation_tpu_torch.utils.orbax_read import read_zarr

    rng = np.random.default_rng(0)
    tree = {"bf16": jnp.asarray(rng.normal(size=(7, 5)), jnp.bfloat16),
            "u4": rng.integers(0, 2 ** 32, size=(4,), dtype=np.uint32),
            "f8": rng.normal(size=(3, 2)), "i8": np.arange(6, dtype=np.int64).reshape(2, 3),
            "b1": rng.random(9) < 0.5, "zero_d": np.float32(2.5),
            "n": 7, "x": 0.125, "seq": (np.int32(1), {"k": np.ones(2, np.float32)})}
    with ocp.StandardCheckpointer() as ck:
        ck.save(str(tmp_path / "c.orbax"), tree)
    want = jax_load(str(tmp_path / "c"))
    got = read_orbax(str(tmp_path / "c"))
    _assert_same_tree(got, want)
    assert isinstance(got["n"], int) and isinstance(got["x"], float)

    arr = ts.open({"driver": "zarr", "path": "big",
                   "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/z/"},
                   "metadata": {"shape": [70, 110], "chunks": [30, 40], "dtype": "<f4",
                                "fill_value": 1.5, "compressor": {"id": "zstd", "level": 1}}},
                  create=True).result()
    data = np.full((70, 110), 1.5, np.float32)
    data[5:65, 10:75] = rng.normal(size=(60, 65))
    arr[5:65, 10:75].write(data[5:65, 10:75]).result()
    items = OcdbtStore(str(tmp_path / "z")).items
    assert len([k for k in items if k.startswith("big/") and k != "big/.zarray"]) < 9
    np.testing.assert_array_equal(read_zarr(items, "big"), data)


def test_store_with_interior_and_version_tree_nodes(tmp_path):
    """An OCDBT store that tensorstore writes with 300-byte nodes, 8-byte
    inline values and a version tree of arity 2 over 45 commits (interior
    B+tree nodes with subtree prefixes, indirect values, version-tree node
    references, zstd at level 5): the newest version's keys and values, as
    written, after each few commits."""
    import random

    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/s/",
                          "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 8,
                                     "version_tree_arity_log2": 1,
                                     "compression": {"id": "zstd", "level": 5}}}).result()
    rnd, want = random.Random(1), {}
    for commit in range(45):
        key = f"key/{rnd.randrange(100):03d}/{'x' * rnd.randrange(4)}"
        want[key] = bytes(rnd.randrange(256) for _ in range(rnd.randrange(30)))
        kv[key] = want[key]
        if commit % 11 == 10:
            assert OcdbtStore(str(tmp_path / "s")).items == want, commit
    assert OcdbtStore(str(tmp_path / "s")).items == want


def _copy(run, tmp_path):
    src = os.path.dirname(run["mid_window", "orbax"])
    dst = tmp_path / "copy"
    shutil.copytree(src, dst)
    return str(dst / "model_latest.ckpt"), dst / "model_latest.ckpt.orbax"


def test_corrupt_or_truncated_store_raises(run, tmp_path):
    """A flipped byte in a B+tree node fails its CRC-32C, and a truncated
    data file or manifest fails its length check: each raises an
    OrbaxFormatError naming the file; nothing is returned."""
    path, d = _copy(run, tmp_path)
    (node,) = (d / "d").iterdir()  # the root tree's node (the values lie under ocdbt.process_0/)
    assert node.read_bytes()[:4] == bytes.fromhex("0cdb20de")
    blob = bytearray(node.read_bytes())
    blob[len(blob) // 2] ^= 0x40
    node.write_bytes(bytes(blob))
    with pytest.raises(OrbaxFormatError, match=f"{node.name}.*CRC-32C"):
        read_orbax(path)
    node.write_bytes(bytes(blob[:len(blob) // 2]))
    with pytest.raises(OrbaxFormatError, match=node.name):
        read_orbax(path)

    path, d = _copy(run, tmp_path / "b")
    big = max(d.rglob("d/*"), key=lambda p: p.stat().st_size)  # the values
    big.write_bytes(big.read_bytes()[:big.stat().st_size // 2])
    with pytest.raises(OrbaxFormatError, match=f"{big.name}: truncated"):
        read_checkpoint(path)
    manifest = d / "manifest.ocdbt"
    manifest.write_bytes(manifest.read_bytes()[:-3])
    with pytest.raises(OrbaxFormatError, match="manifest.ocdbt: truncated"):
        read_checkpoint(path)


def _want_state(opt_state, case):
    """The port's state from the JAX optax state by hand: the layout mapping
    of each tree and the counters optax's next update reads."""
    adam = opt_state.inner_opt_state.inner_state[1][0]
    acc = params_from_jax(opt_state.acc_grads)
    if case == "after_skip":
        assert all(not bool(torch.isfinite(t).all()) for n, t in acc.items()
                   if n == "unet.conv_final.bias")
        acc = {n: torch.zeros_like(t) for n, t in acc.items()}
    return {"acc": acc, "mu": params_from_jax(adam.mu), "nu": params_from_jax(adam.nu),
            "mini_step": int(opt_state.mini_step), "count": int(adam.count),
            "n_skipped": int(opt_state.inner_opt_state.total_notfinite)}


def _assert_state_equal(got, want):
    assert {k: got[k] for k in ("mini_step", "count", "n_skipped")} == \
        {k: want[k] for k in ("mini_step", "count", "n_skipped")}
    for key in ("acc", "mu", "nu"):
        assert got[key].keys() == want[key].keys(), key
        for n, t in want[key].items():
            assert torch.equal(got[key][n].reshape(t.shape), t), (key, n)


@pytest.mark.parametrize("backend", ["orbax", "pickle"])
@pytest.mark.parametrize("case", ["mid_window", "after_skip"])
def test_optax_state_maps_leaf_by_leaf(case, backend, run):
    """`read_checkpoint`'s optimizer state, from the pickle's stand-ins and
    from the orbax tree, against the JAX state mapped by hand: every leaf
    of Adam's moments and of the accumulator bit-equal, Adam's count
    (= the schedule's), mini_step and the skip count; the state of the
    parameters of `state_dict_from_jax`, name for name."""
    got = read_checkpoint(run[case, backend])
    want = _want_state(run[case]["opt_state"], case)
    _assert_state_equal(got["optimizer"], want)
    assert set(got["optimizer"]["mu"]) == {
        n for n in state_dict_from_jax(run[case]["params"], run["stats"])
        if not n.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    assert (got["epoch"], got["best_loss"], got["best_metric"]) == (5, 1.5, 0.25)


@pytest.mark.parametrize("backend", ["orbax", "pickle"])
@pytest.mark.parametrize("case", ["mid_window", "after_skip"])
def test_resumed_update_matches_optax(case, backend, run):
    """The resume parity: the JAX state restored by the JAX package
    (`load_checkpoint` with the optax template) and the port's Optimizer
    loaded with the mapped state take the same seeded gradients; the
    parameters after the next update and after one more whole accumulation
    agree within test_torch_loss.py's optimizer tolerance (1e-6 relative).
    After a skipped update optax keeps 0 * nan in its accumulator and skips
    every later window (checked); the port starts afresh, so it is held to
    optax's run with the skipped window left out: the restored state with
    a zero accumulator."""
    cfg, tx = run["cfg"], run["tx"]
    template = {"epoch": 0, "params": run[case]["params"], "batch_stats": run["stats"],
                "opt_state": run[case]["opt_state"], "best_loss": 0.0, "best_metric": 0.0}
    restored = jax_load(run[case, backend], target=template)
    st = jax.tree.map(jnp.asarray, restored["opt_state"])
    params = restored["params"]
    seq = run["grads"][6:9 if case == "mid_window" else 10]  # finite gradients
    if case == "after_skip":
        stuck, s2 = params, st
        for g in seq[:2]:
            stuck, s2 = _apply(tx, s2, stuck, g)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(stuck),
                                                        jax.tree.leaves(params)))
        st = st._replace(acc_grads=jax.tree.map(jnp.zeros_like, st.acc_grads))
    want = []
    for g in seq:
        params, st = _apply(tx, st, params, g)
        want.append(params_from_jax(params))

    start = params_from_jax(restored["params"])
    names = list(start)
    ps = [start[k].clone() for k in names]
    opt = Optimizer(ps, cfg, updates_per_epoch=UPDATES_PER_EPOCH, names=names)
    opt.load_state_dict(read_checkpoint(run[case, backend])["optimizer"])
    applied = []
    for i, g in enumerate(seq):
        gm = params_from_jax(g)
        applied.append(opt.update([gm[k] for k in names]))
        for k, p in zip(names, ps):
            np.testing.assert_allclose(p.numpy(), want[i][k].numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=f"micro-step {i} {k}")
    assert applied == ([True, None, True] if case == "mid_window" else [None, True, None, True])
    assert opt.count == 4 and opt.n_skipped == (1 if case == "after_skip" else 0)
    assert opt.lr() == pytest.approx(cfg["optimizer"]["learning_rate"]
                                     * cfg["scheduler"]["exp_gamma"] ** 2)


@pytest.mark.parametrize("backend", ["orbax", "pickle"])
def test_trainer_resumes_the_jax_state(backend, run, tmp_path):
    """`Trainer.load_pretrain` (`misc.pretrain`) from both forms: the
    weights of `state_dict_from_jax`, the mapped optimizer state exactly,
    the epoch, and no "reinitialised" in the log."""
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    path = run["mid_window", backend]
    cfg = dict(run["cfg"], misc=dict(run["cfg"]["misc"], pretrain=path, mode="train"))
    tr = Trainer(cfg, build_model(cfg, device="cpu"), {"train": [None] * 4},
                 save_dir=str(tmp_path / "t"), device="cpu")
    want = state_dict_from_jax(run["mid_window"]["params"], run["stats"])
    got = tr.model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v.reshape(got[k].shape)), k
    _assert_state_equal(tr.optimizer.state_dict(),
                        _want_state(run["mid_window"]["opt_state"], "mid_window"))
    assert tr.start_epoch == 6
    log = (tmp_path / "t" / "log").read_text()
    assert "reinitialised" not in log, log


def test_tester_and_predictor_read_the_orbax_directory(run, tmp_path):
    """The Tester's `misc.pretrain` and the Predictor's `ckpt_path` name
    `<path>` of a JAX orbax save (and the directory itself): the weights of
    `state_dict_from_jax` on the parameter tree."""
    from pcaccumulation_tpu_torch.serve import Predictor
    from pcaccumulation_tpu_torch.train.tester import Tester

    path = run["mid_window", "orbax"]
    want = state_dict_from_jax(run["mid_window"]["params"], run["stats"])
    cfg = dict(run["cfg"], misc=dict(run["cfg"]["misc"], pretrain=path + ".orbax", mode="test"))
    tester = Tester(cfg, build_model(cfg, device="cpu"), save_dir=str(tmp_path / "t"),
                    device="cpu", results_dir=str(tmp_path / "r"))
    pred = Predictor(run["cfg"], ckpt_path=path, device="cpu")
    for model in (tester.model, pred.model):
        got = model.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v.reshape(got[k].shape)), k


def test_two_process_store_reads():
    """The tracked orbax save of two JAX processes (tests/data/
    jax_orbax_two_process, `tools/make_jax_orbax_fixture.py --two-process`):
    arrays sharded over both processes' devices, each process's shards
    under its own `ocdbt.process_<i>/` and one chunk per shard, a
    replicated array, None: the global values of `expected.npz`, dtypes
    kept (bfloat16 as torch.bfloat16)."""
    root = os.path.join(os.path.dirname(__file__), "data", "jax_orbax_two_process")
    want = np.load(os.path.join(root, "expected.npz"))
    got = read_orbax(os.path.join(root, "model_latest.ckpt"))
    items = OcdbtStore(os.path.join(root, "model_latest.ckpt.orbax")).items
    assert {k for k in items if k.startswith("params.w/") and k[-1].isdigit()} == {
        f"params.w/{i}.0" for i in range(4)}
    for key in ("w", "rep"):
        assert got["params"][key].dtype == np.float32
        np.testing.assert_array_equal(got["params"][key], want[f"params/{key}"])
    assert got["params"]["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["params"]["h"].view(torch.int16).numpy().view(np.uint16),
                                  want["params/h"])
    assert got["opt_state"][0].dtype == np.int32 and got["opt_state"][1] is None
    np.testing.assert_array_equal(got["opt_state"][0], want["opt_state/0"])


def test_tracked_jax_fixture_resumes_on_the_cpu(tmp_path):
    """The tracked JAX Trainer checkpoint (tests/data/jax_orbax_tiny,
    `tools/make_jax_orbax_fixture.py`; chip_smoke.py holds it on the card):
    the port's val forward of its weights against the JAX package's
    (`expected.npz`, test_torch_motionnet.py's eval-BN tolerances), and the
    port's Trainer resumed from it: one micro-step on batch 1 ends the
    accumulation, and the leaves the JAX update moved land on the JAX
    package's next parameters, within 1e-4 of each leaf's update norm
    (measured 1.3e-5; the composed train-BN gradients of the two packages
    differ by reduction order), the others unchanged bit for bit."""
    import json

    from pcaccumulation_tpu_torch import to_device
    from pcaccumulation_tpu_torch.train.trainer import Trainer
    from test_torch_motionnet import TOL

    root = os.path.join(os.path.dirname(__file__), "data", "jax_orbax_tiny")
    ckpt = os.path.join(root, "model_latest.ckpt")
    with open(os.path.join(root, "cfg.json")) as f:
        cfg = json.load(f)
    exp = np.load(os.path.join(root, "expected.npz"))
    part = {p: {k.split("/", 1)[1]: exp[k] for k in exp.files if k.startswith(p + "/")}
            for p in ("batch0", "batch1", "val", "next")}
    cfg["misc"].update(pretrain=ckpt, mode="train")
    tr = Trainer(cfg, build_model(cfg, device="cpu"), {"train": [None] * 2},
                 save_dir=str(tmp_path), device="cpu")
    assert (tr.optimizer.count, tr.optimizer.mini_step) == (2, 1)
    with torch.no_grad():
        out = tr.model.eval()(to_device(part["batch0"], "cpu"), mode="val")
    for key in ("fb_seg_est", "ego_motion_est", "mos_est", "offset_est",
                "transformed_points", "rec_est"):
        np.testing.assert_allclose(out[key].numpy(), part["val"][key], atol=TOL[False][key],
                                   err_msg=key)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.train_step(to_device(part["batch1"], "cpu"))
    assert (tr.optimizer.count, tr.optimizer.mini_step) == (3, 0)
    moved = 0
    for n, p in tr.model.named_parameters():
        if n not in part["next"]:
            assert torch.equal(p.detach(), before[n]), n
        elif not n.endswith("seg_head.0.bias"):  # BatchNorm-cancelled: residue
            want = torch.from_numpy(part["next"][n]).reshape(p.shape)
            step = float((want - before[n]).norm())
            assert float((p.detach() - want).norm()) < 1e-4 * step, n
            moved += 1
    assert moved > 20


def test_adamw_state_maps_and_resumes(run, tmp_path):
    """With `optimizer.weight_decay` > 0 the JAX package's chain is adamw's
    (scale_by_adam, add_decayed_weights, scale_by_learning_rate: three
    states, the schedule's count last). Saved in both forms after one
    update and a micro-step, its state maps (Adam's count 1, mini_step 1)
    and the port's Optimizer resumed from it takes optax's next updates
    (1e-6 relative)."""
    cfg = dict(run["cfg"], optimizer=dict(run["cfg"]["optimizer"], weight_decay=0.01))
    tx = jtrainer.make_optimizer(cfg, UPDATES_PER_EPOCH)[0]
    params = run["mid_window"]["params"]
    st = tx.init(jax.tree.map(jnp.asarray, params))
    for g in run["grads"][:3]:
        params, st = _apply(tx, st, params, g)
    st = jax.tree.map(np.asarray, st)
    assert len(st.inner_opt_state.inner_state[1]) == 3
    want, jp, jst = [], params, jax.tree.map(jnp.asarray, st)
    for g in run["grads"][6:9]:
        jp, jst = _apply(tx, jst, jp, g)
        want.append(params_from_jax(jp))
    for backend in ("orbax", "pickle"):
        path = str(tmp_path / backend / "model_latest.ckpt")
        jax_save(path, {"epoch": 1, "params": params, "batch_stats": run["stats"],
                        "opt_state": st}, backend=backend)
        state = read_checkpoint(path)["optimizer"]
        assert (state["count"], state["mini_step"], state["n_skipped"]) == (1, 1, 0)
        start = params_from_jax(params)
        names = list(start)
        ps = [start[k].clone() for k in names]
        opt = Optimizer(ps, cfg, updates_per_epoch=UPDATES_PER_EPOCH, names=names)
        opt.load_state_dict(state)
        for i, g in enumerate(run["grads"][6:9]):
            gm = params_from_jax(g)
            opt.update([gm[k] for k in names])
            for k, p in zip(names, ps):
                np.testing.assert_allclose(p.numpy(), want[i][k].numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{backend} micro-step {i} {k}")
        assert opt.count == 3
