"""The port's frame and spatial mesh axes (`pcaccumulation_tpu_torch/
parallel/mesh.py`, the split UNet of `models/motionnet.py`, the Trainer and
the Predictor on a mesh) on the CPU, ranks on gloo.

Each rank is a spawned subprocess of this file (`python
tests/test_torch_mesh.py <case> <rank> <world> <port> <dir>`), which
imports neither JAX nor the JAX package; the pytest process writes the
configs, the weights and the batches to a directory, starts every group
of ranks at once, runs the JAX side while they run, and reads what they
wrote. Every subprocess and every rendezvous has a time limit.

Held here, at the tiny config of tests/test_parallel.py (64x64 grid, UNet
depth 3, T=4; T=5 for an uneven frame split):
- the val forward at world 2 with F=2 (T=5, B=1: rows 3/2) and with S=2,
  against one process on the same weights and batch, at the atol of
  tests/test_parallel.py (1e-5 the ego pose, 1e-4 rec, offset and MOS
  scores), decisions equal, every rank the same bits;
- the banded UNet at S=3 (24/20/20 rows) against the whole UNet, forward
  and gradient;
- one Trainer micro-step at world 4 (2 frame x 2 spatial) against one
  process on the same batch: loss, every gradient leaf by the per-leaf
  criterion of tests/test_torch_parallel.py, the BatchNorm running
  statistics; the mesh's coordinates, an orbax snapshot of the four ranks
  read back, a world that does not factor, and a subgroup a rank does not
  join;
- the world-2 forwards against the JAX package's 2-device frame and
  spatial meshes, on one parameter tree (`utils/weights.py`);
- the Predictor at world 2 on each axis against the one-process predict
  of the same saved config, and `export` refused under the mesh;
- the CLI under torchrun at F=2 (a val epoch over data/synthetic) against
  the one-process CLI;
- the nuScenes-style bf16 train micro-step at F=2 against the one-process
  float32 step (ROADMAP item 31): three processes of
  `tools/mesh_bf16_spread.py` (the two ranks of F=2, each running the
  split step in bf16 and in float32, and one process running both
  one-process steps) at the tool's small config (64 x 64 grid, UNet depth
  3, B=2, T=3: rows 2/1, the random keypoint draw).
"""

from __future__ import annotations

import copy
import os
import sys
import time

import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(REPO, "tools")]

import mesh_bf16_spread as spread  # noqa: E402
import ranks  # noqa: E402

from pcaccumulation_tpu_torch.utils.leaf_criteria import bf16_misses  # noqa: E402

RANK_TIMEOUT_S = 240  # each subprocess; the rendezvous times out after 60 s
JOIN_TIMEOUT_S = 5    # the subgroup a rank does not join
AXES = {"frame": (2, 1), "spatial": (1, 2)}
T_OF = {"frame": 5, "spatial": 4}   # T=5 over 2 frame ranks: rows 3/2
FWD_KEYS = ("ego_motion_est", "rec_est", "offset_est", "mos_est", "fb_seg_est",
            "fb_est_per_points", "fb_mask", "rec_mask", "transformed_points")
# tests/test_parallel.py's atol of a sharded forward against one device
ATOL = {"ego_motion_est": 1e-5, "rec_est": 1e-4, "offset_est": 1e-4, "mos_est": 1e-4,
        "fb_seg_est": 1e-4, "transformed_points": 1e-4}
DECISIONS = ("fb_est_per_points", "fb_mask", "rec_mask")
PRED_FLOATS = ("rec_points", "flow", "offset", "ego_motion", "transformed_points")
PRED_LABELS = ("mos", "fb", "inst_labels", "time_idx")
BAND_TOL = 1e-5  # float32: the bands' convolutions sum in another order
# the F=2 bf16 step against the one-process bf16 step, per leaf: on the CPU
# the two round alike but for each rank's bf16 weight gradient (worst 0.0264,
# unet.conv_final.bias; a split UNet left in float32 put 105 of 134 leaves
# beyond 0.1, PERF.md §6)
SPLIT_BF16_REL, SPLIT_BF16_COS = 0.1, 0.99


def start_ranks(case: str, world: int, out: str) -> list:
    """The `world` ranks of `case` as subprocesses of this file (world 1:
    one process, no group)."""
    return ranks.start(ranks.script_commands(__file__, case, world, ranks.free_port(), out))


def start_cli(out: str) -> list:
    """The CLI's val epoch over data/synthetic at a cut-down grid: under
    torchrun with 2 processes at F=2 (in <out>/cli_mesh), and in one
    process (in <out>/cli_one)."""
    args = ["-m", "pcaccumulation_tpu_torch.main", os.path.join(REPO, "configs", "default.yaml"),
            "1", "1", "--misc.mode=val", "--misc.device=cpu", "--misc.exp_name=cli",
            f"--path.dataset_base={os.path.join(REPO, 'data', 'synthetic')}",
            "--voxel_generator.range=[-16,-16,-5,16,16,3]",
            "--voxel_generator.crop_range=[16,-5,3]", "--capacity.max_points=16000",
            "--capacity.max_pillars=8000", "--capacity.max_fg_points=1024", "--unet.depth=3",
            "--pose_estimation.n_kpts=256", "--val.num_workers=0"]
    cmds = {"cli_mesh": [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
                         f"--master_port={ranks.free_port()}", *args,
                         "--parallel.frame_devices=2"],
            "cli_one": [sys.executable, *args]}
    procs = []
    try:
        for name, cmd in cmds.items():
            os.makedirs(os.path.join(out, name))
            procs += ranks.start([cmd], cwd=os.path.join(out, name))
    except BaseException:
        ranks.stop(procs)
        raise
    return procs


def tiny_cfg(t: int, axis: str | None = None) -> dict:
    """tests/test_parallel.py's tiny config at T=t, deterministic keypoints
    (so that the JAX package draws the same), the clusterer's capacity at
    `max_points`, with the mesh factors of `axis` set in `parallel`."""
    import __graft_entry__ as ge

    cfg = ge._cfg(grid_half=8.0, n_sweeps=t, max_points=2048, max_pillars=1024, n_kpts=64,
                  tiny_graph=True)
    cfg["pose_estimation"].update({"deterministic_sampling": True, "approx_sampling": False})
    # the clusterer's capacity cut to the points there are (serving's test mode)
    cfg["cluster"]["max_cluster_points"] = cfg["capacity"]["max_points"]
    if axis is not None:
        cfg["parallel"]["frame_devices"], cfg["parallel"]["spatial_devices"] = AXES[axis]
    return cfg


def scan(t: int, seed: int = 5) -> tuple:
    """A raw sensor scan of t frames (points, time_idx)."""
    from pcaccumulation_tpu_torch.data.synthetic import generate_sample

    s = generate_sample(seed=seed, n_frames=t, n_static_clusters=6, n_dynamic=2,
                        pts_per_cluster=150, pts_per_object=80, area=6.0)
    return s["raw_points"], s["time_indice"]


# --------------------------------------------------------------- the ranks
def _load(out: str, name: str):
    return torch.load(os.path.join(out, name), weights_only=False)


def _forwards(out: str, world: int) -> dict:
    """The val forward and the Predictor on each axis: on its mesh at world
    2, in one process at world 1 (the same saved config)."""
    from pcaccumulation_tpu_torch import build_model, to_device
    from pcaccumulation_tpu_torch.parallel import mesh
    from pcaccumulation_tpu_torch.serve import Predictor

    setup = _load(out, "forward_setup.pt")
    res = {}
    for axis, (f, s) in AXES.items():
        cfg, state, batch = setup[axis]["cfg"], setup[axis]["state"], setup[axis]["batch"]
        m = mesh.make_mesh(f, s) if world > 1 else None
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        with torch.no_grad(), mesh.model_parallel(m):
            r = model(to_device(batch, "cpu"), mode="val")
        res[axis] = {k: r[k].clone() for k in FWD_KEYS}
        pred = Predictor(cfg, state_dict=state, device="cpu", mesh=m)
        res[f"predict_{axis}"] = pred.predict(*scan(cfg["voxel_generator"]["n_sweeps"]))
        if m is not None:
            try:
                pred.export(os.path.join(out, f"never_{axis}.pt2"))
            except NotImplementedError as e:
                res[f"export_{axis}"] = str(e)
        res[f"coords_{axis}"] = None if m is None else m.coords
    return res


def _bands(world: int) -> dict:
    """The UNet on S=`world` bands of 64 rows (units of 4: 24/20/20 at
    S=3) against the whole UNet on this rank: the joined forward, and the
    mean over the ranks of the input's and the parameters' gradients."""
    from pcaccumulation_tpu_torch.models.unet import UNet
    from pcaccumulation_tpu_torch.parallel import mesh

    torch.manual_seed(0)
    unet = UNet(in_channels=8, depth=3, start_filts=8)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 64, 16, 8), generator=gen)
    cot = torch.randn((2, 64, 16, 8), generator=gen)

    def grads(xg):
        return [xg.grad] + [p.grad for p in unet.parameters()]

    xw = x.clone().requires_grad_(True)
    whole = unet(xw)
    (whole * cot).sum().backward()
    want = [g.clone() for g in grads(xw)]
    unet.zero_grad()

    m = mesh.make_mesh(1, world)
    sizes = mesh.bands(64, unet.band_unit, world)
    h0 = sum(sizes[:m.coords[2]])
    xb = x.clone().requires_grad_(True)
    y = unet(xb[:, h0:h0 + sizes[m.coords[2]]], mesh.halo_rows(m.spatial_group))
    joined = mesh.gather_blocks(y, 1, sizes, m.spatial_group)
    (joined * cot).sum().backward()
    got = mesh.mean_over_ranks(grads(xb), m.world_group)
    try:
        mesh.make_mesh(2, 1)
        factor_error = None
    except ValueError as e:
        factor_error = str(e)
    return {"sizes": sizes, "whole": whole.detach(), "joined": joined.detach(), "want": want,
            "got": got, "factor_error": factor_error}


def _step(out: str, rank: int, world: int) -> dict:
    """One Trainer micro-step on the whole batch: at world 4 on the
    config's 2 x 2 (frame x spatial) mesh, at world 1 in one process."""
    from pcaccumulation_tpu_torch import build_model, to_device
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    setup = _load(out, "step_setup.pt")
    cfg = copy.deepcopy(setup["cfg"])
    if world == 1:
        cfg["parallel"].update(frame_devices=1, spatial_devices=1, num_devices=1)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(setup["state"])
    tr = Trainer(cfg, model, {"train": [None] * 4}, save_dir=os.path.join(out, f"run_step_{world}"),
                 device="cpu")
    seen = {}
    update = tr.optimizer.update

    def record(grads):
        seen["grads"] = {n: g.clone() for (n, _), g in zip(model.named_parameters(), grads)}
        return update(grads)

    tr.optimizer.update = record
    st = tr.train_step(to_device(setup["batch"], "cpu"), tr.step_generator(1, "train", 0))
    res = {"stats": {k: v for k, v in st.items() if not isinstance(v, dict)},
           "grads": seen["grads"],
           "buffers": {n: b.clone() for n, b in model.named_buffers() if "running_" in n},
           "coords": tr.mesh.coords,
           "shape": (tr.mesh.data, tr.mesh.frame, tr.mesh.spatial)}
    if world > 1:
        # an orbax (torch.distributed.checkpoint) snapshot written by the four
        # ranks, whose model coordinates hold the same entries, read back whole
        from pcaccumulation_tpu_torch.utils.checkpoint import read_checkpoint

        tr.cfg["train"]["ckpt_backend"] = "orbax"
        tr.snapshot(1, "latest")
        back = read_checkpoint(os.path.join(tr.save_dir, "model_latest.ckpt"))
        res["snapshot"] = all(torch.equal(back["model"][n], v)
                              for n, v in model.state_dict().items())
        # a subgroup that rank 3 never joins: the others raise in time
        if rank < 3:
            from pcaccumulation_tpu_torch.parallel import mesh

            t0 = time.monotonic()
            try:
                mesh.make_mesh(2, 2, timeout_s=JOIN_TIMEOUT_S)
                res["join"] = None
            except Exception as e:  # the backend's timeout error: recorded and checked
                res["join"] = (type(e).__name__, time.monotonic() - t0)
        else:
            time.sleep(JOIN_TIMEOUT_S + 5)
    return res


def _child(case: str, rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    from pcaccumulation_tpu_torch.parallel import mesh

    if world > 1:
        mesh.init_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}",
                              world_size=world, rank=rank, timeout_s=60)
    if case == "forward":
        res = _forwards(out, world)
    elif case == "bands":
        res = _bands(world)
    elif case == "step":
        res = _step(out, rank, world)
    elif case == "reference":
        res = {"forward": _forwards(out, 1), "step": _step(out, 0, 1)}
    else:
        raise ValueError(case)
    torch.save(res, os.path.join(out, f"{case}_w{world}_r{rank}.pt"))
    if world > 1 and case != "step":  # the step group's store is broken on purpose
        torch.distributed.destroy_process_group()


# --------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of ranks started at once, the JAX meshes' forwards run
    meanwhile; then what each rank wrote."""
    import jax
    import jax.numpy as jnp

    from pcaccumulation_tpu.models import MotionNet as JaxMotionNet
    from pcaccumulation_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
    import __graft_entry__ as ge
    from test_torch_motionnet import place_fb_threshold, random_variables
    from test_torch_parallel import tiny_setup

    out = str(tmp_path_factory.mktemp("mesh"))
    setup, jax_inputs = {}, {}
    for axis in AXES:
        cfg = tiny_cfg(T_OF[axis], axis)
        batch = ge._batch(cfg, batch_size=1)
        params, stats = random_variables(cfg, batch, seed=0)
        params = place_fb_threshold(cfg, params, stats, batch, train_bn=False)
        setup[axis] = {"cfg": cfg, "batch": batch, "state": state_dict_from_jax(params, stats)}
        jax_inputs[axis] = (cfg, batch, params, stats)
    torch.save(setup, os.path.join(out, "forward_setup.pt"))
    step = tiny_setup(os.path.join(out, "step"), batch_size=2)
    step_cfg = copy.deepcopy(step["cfg"])
    step_cfg["parallel"].update(frame_devices=2, spatial_devices=2, num_devices=4)
    step_cfg["pose_estimation"]["deterministic_sampling"] = True
    torch.save({"cfg": step_cfg, "batch": step["batches"][0], "state": step["state"]},
               os.path.join(out, "step_setup.pt"))

    bf16_out = os.path.join(out, "bf16")
    os.makedirs(bf16_out)
    spread.write_setup(bf16_out)
    procs = []
    try:
        for case, world in (("forward", 2), ("bands", 3), ("step", 4), ("reference", 1)):
            procs += start_ranks(case, world, out)
        procs += start_cli(out)
        procs += ranks.start(spread.child_commands(bf16_out, ranks.free_port()))
    except BaseException:
        ranks.stop(procs)
        raise
    jax_out = {}
    try:
        for axis, (cfg, batch, params, stats) in jax_inputs.items():
            model = JaxMotionNet(cfg)
            jmesh = make_mesh(2, **{f"{axis}_devices": 2})
            with jmesh:
                r = jax.jit(lambda v, b: model.apply(
                    v, b, train=False, mode="val", rngs={"sample": jax.random.key(7)}))(
                    replicate({"params": params, "batch_stats": stats}, jmesh),
                    shard_batch(jax.tree.map(jnp.asarray, batch), jmesh))
            jax_out[axis] = {k: np.asarray(r[k]) for k in FWD_KEYS}
    finally:
        ranks.wait(procs, RANK_TIMEOUT_S)
    load = lambda n: _load(out, n)  # noqa: E731
    return {"forward": [load(f"forward_w2_r{r}.pt") for r in (0, 1)],
            "bands": [load(f"bands_w3_r{r}.pt") for r in range(3)],
            "step": [load(f"step_w4_r{r}.pt") for r in range(4)],
            "reference": load("reference_w1_r0.pt"), "jax": jax_out,
            "lr": step_cfg["optimizer"]["learning_rate"], "cli": out,
            "bf16": spread.load_steps(bf16_out)}


@pytest.mark.parametrize("axis", list(AXES))
def test_split_forward_equals_one_process(runs, axis, record_property):
    """The val forward at world 2 with F=2 (T=5: rows 3/2) or S=2 (bands
    32/32): every rank the same bits, and against one process on the same
    weights and batch the floats within tests/test_parallel.py's atol and
    every decision equal."""
    r0, r1 = (r[axis] for r in runs["forward"])
    want = runs["reference"]["forward"][axis]
    for k in FWD_KEYS:
        assert torch.equal(r0[k], r1[k]), k
    for k in DECISIONS:
        assert torch.equal(r0[k], want[k]), k
    for k, atol in ATOL.items():
        err = float((r0[k] - want[k]).abs().max())
        record_property(f"max_abs_err.{k}", err)
        torch.testing.assert_close(r0[k], want[k], atol=atol, rtol=0, msg=lambda m: f"{k}: {m}")
    assert [r[f"coords_{axis}"] for r in runs["forward"]] == (
        [(0, 0, 0), (0, 1, 0)] if axis == "frame" else [(0, 0, 0), (0, 0, 1)])


def test_banded_unet_equals_whole_unet(runs):
    """S=3 over 64 rows in units of 4 (24/20/20): the joined forward and
    the mean over the ranks of the gradients (input and every parameter)
    against the whole UNet's; a world of 3 does not factor into F=2."""
    for r in runs["bands"]:
        assert r["sizes"] == [24, 20, 20]
        torch.testing.assert_close(r["joined"], r["whole"], atol=BAND_TOL, rtol=BAND_TOL)
        for got, want in zip(r["got"], r["want"]):
            torch.testing.assert_close(got, want, atol=BAND_TOL, rtol=BAND_TOL)
        assert "do not factor" in r["factor_error"]
    assert torch.equal(runs["bands"][0]["joined"], runs["bands"][2]["joined"])


def test_mesh_step_equals_one_process(runs, record_property):
    """One Trainer micro-step at world 4 on a 2 x 2 (frame x spatial) mesh
    (B=2, T=3: rows 3/3, bands 32/32) against one process: the loss terms
    within rtol 1e-5 (the error metrics 1e-4), every gradient leaf by the
    per-leaf criterion of tests/test_torch_parallel.py (the same bits on
    every rank), the running statistics; the ranks' coordinates in the JAX
    axis order; an orbax snapshot written by the four ranks (whose model
    coordinates hold the same entries) reads back as the model; a subgroup
    one rank does not join raises on the others within its time limit."""
    from test_torch_parallel import leaf_check

    ranks, ref = runs["step"], runs["reference"]["step"]
    assert [r["coords"] for r in ranks] == [(0, f, s) for f in (0, 1) for s in (0, 1)]
    assert all(r["shape"] == (1, 2, 2) for r in ranks)
    for key, want in ref["stats"].items():
        rtol = 1e-4 if key.endswith("_error") else 1e-5
        for r in ranks:
            torch.testing.assert_close(r["stats"][key], want, rtol=rtol, atol=1e-6,
                                       msg=lambda m: f"{key}: {m}")
    for n in ref["grads"]:
        assert all(torch.equal(ranks[0]["grads"][n], r["grads"][n]) for r in ranks[1:]), n
    checked, noise, (rel, cos, leaf) = leaf_check(ref["grads"], ranks[0]["grads"],
                                                  whole_objective=True)
    record_property("worst_leaf", f"{leaf} rel {rel:.3e} cos {cos:.8f}; {checked}/{noise}")
    assert ref["buffers"]
    for n, want in ref["buffers"].items():
        for r in ranks:
            torch.testing.assert_close(r["buffers"][n], want, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{n}: {m}")
    for r in ranks[:3]:
        assert r["join"] is not None and r["join"][1] < JOIN_TIMEOUT_S + 30, r["join"]
    assert all(r["snapshot"] for r in ranks)


@pytest.mark.parametrize("axis", list(AXES))
def test_split_forward_matches_jax_mesh(runs, axis, record_property):
    """The port's world-2 forward (F=2 or S=2) against the JAX package's
    forward on `make_mesh(2, frame_devices=2)` / `spatial_devices=2` (GSPMD
    on 2 forced CPU devices), one parameter tree: decisions equal, floats
    within tests/test_torch_motionnet.py's eval-BN tolerances."""
    from test_torch_motionnet import TOL

    got, want = runs["forward"][0][axis], runs["jax"][axis]
    for k in DECISIONS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("fb_seg_est", "ego_motion_est", "mos_est", "offset_est", "transformed_points",
              "rec_est"):
        err = float(np.abs(got[k].numpy() - want[k]).max())
        record_property(f"max_abs_err.{k}", err)
        assert err <= TOL[False][k], (k, err)
    assert np.abs(got["ego_motion_est"][:, 1:, :3, 3].numpy()).max() > 1e-2  # a real pose


def test_cli_val_epoch_on_a_frame_mesh(runs):
    """`torchrun --nproc_per_node=2 -m pcaccumulation_tpu_torch.main ...
    --parallel.frame_devices=2 --misc.mode=val` over data/synthetic: rank 0
    writes the run directory, and the epoch's metrics are the one-process
    CLI's on the same config and data, bit for bit (on the CPU the split
    keeps every convolution's arithmetic)."""
    import json

    def epoch(name):
        run = os.path.join(runs["cli"], name, "snapshot", "cli")
        assert "val Epoch: 0" in open(os.path.join(run, "log")).read()
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return [r for r in recs if r["phase"] == "epoch_val"]

    mesh_run, one_run = epoch("cli_mesh"), epoch("cli_one")
    assert len(mesh_run) == len(one_run) == 1
    assert mesh_run == one_run
    cfg = json.load(open(os.path.join(runs["cli"], "cli_mesh", "snapshot", "cli", "config.json")))
    assert cfg["parallel"]["frame_devices"] == 2


@pytest.mark.parametrize("axis", list(AXES))
def test_mesh_predictor_equals_one_process(runs, axis):
    """`Predictor(cfg, mesh=make_mesh(...))` at world 2 on each axis: both
    ranks return the one-process predict of the same saved config (floats
    within 1e-4, labels equal), and `export` raises under the mesh."""
    want = runs["reference"]["forward"][f"predict_{axis}"]
    for r in runs["forward"]:
        got = r[f"predict_{axis}"]
        assert sorted(got) == sorted(want)
        for k in PRED_FLOATS:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
        for k in PRED_LABELS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert "single-device" in r[f"export_{axis}"]
    assert runs["reference"]["forward"][f"coords_{axis}"] is None


def test_split_bf16_step_is_held_against_float32(runs, record_property):
    """The F=2 bf16 step's gradient against the one-process float32 step's
    and against the one-process bf16 step's, every leaf finite in all four
    steps.

    A bf16 step is a noisy estimate of the float32 one: bf16 rounds each
    product to 8 significant bits, and the FB decisions and the keypoints
    they choose move with an ulp. Against the one-process float32 step, the
    yardstick of every bf16 check in chip_smoke.py, the split step meets
    `leaf_criteria.bf16_misses`'s rule (rel-norm < 0.5, cosine > 0.85 per
    leaf above its noise floor; the biases directly before a train-mode
    BatchNorm set aside) at every leaf where the one-process bf16 step
    meets it. At this size bf16 is another sample of the gradient
    upstream of the TPointNet's max pools and at the heads after them (the
    STPN, the alignment's embeddings and regressor), in one process as in
    the split, so those leaves are held by the second rule: against the
    one-process bf16 step every leaf lies within SPLIT_BF16_REL and
    SPLIT_BF16_COS. A rounding that the split made in another place than
    one process would move it there. More leaves held than below the
    noise floor."""
    steps = runs["bf16"]
    assert spread.non_finite(steps) == []
    names = spread.leaf_names(steps["one_float32"]["grads"])
    split, one, one32 = (steps[k]["grads"] for k in ("split_bf16", "one_bf16", "one_float32"))
    dist, split_misses = bf16_misses(split, one32, names)
    _, one_misses = bf16_misses(one, one32, names)
    assert len(dist) > len(names) - len(dist), (len(dist), len(names))
    assert set(split_misses) <= set(one_misses), sorted(set(split_misses) - set(one_misses))
    mutual = spread.distances(steps)[("split_bf16", "one_bf16")]
    over = {n: rc for n, rc in mutual.items()
            if not (rc[0] < SPLIT_BF16_REL and rc[1] > SPLIT_BF16_COS)}
    worst = max(mutual, key=lambda n: mutual[n][0])
    record_property("against_float32", f"{len(dist)} leaves, {len(one_misses)} beyond the rule "
                                       f"in one process, {len(split_misses)} in the split")
    record_property("against_one_process_bf16", f"worst {worst} {mutual[worst]}")
    assert not over, over


def test_split_bf16_and_float32_steps_ranks_and_statistics(runs):
    """Both ranks hold the same averaged gradient (NaN where the other has
    NaN); the split steps' loss terms within one rounding to their dtype of
    one process's (1e-5 in float32; the error metrics 10x), the running
    statistics within rel-norm 0.05 in bf16 and rtol 1e-5 in float32; the
    float32 split step's gradient against one process's by the per-leaf
    criterion of tests/test_torch_parallel.py."""
    from test_torch_parallel import leaf_check

    steps = runs["bf16"]
    for dtype, u in (("float32", 1e-5), ("bf16", 2.0 ** -8)):
        assert steps[f"split_{dtype}_ranks_equal"], dtype
        split, one = steps[f"split_{dtype}"], steps[f"one_{dtype}"]
        for key, want in one["stats"].items():
            rtol = u * (10 if key.endswith("_error") else 1)
            assert abs(split["stats"][key] - want) <= rtol * abs(want) + 1e-6, (dtype, key)
        for n, want in one["buffers"].items():
            got = split["buffers"][n]
            if dtype == "float32":
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            else:
                assert float((got - want).norm()) < 0.05 * float(want.norm()), n
    leaf_check(steps["one_float32"]["grads"], steps["split_float32"]["grads"],
               whole_objective=True)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
