"""The port's data-parallel step (`pcaccumulation_tpu_torch/parallel/mesh.py`,
the Trainer in a process group) on the CPU, two ranks on gloo.

Each rank is a spawned subprocess of this file (`python
tests/test_torch_parallel.py <case> <rank> <world> <port> <dir>`), which
imports neither JAX nor the JAX package; the pytest process writes the
config, the weights and the joined batches to a directory, reads what the
ranks wrote, and runs the JAX side itself. Every subprocess and every
rendezvous has a time limit.

Held here:
- world 2 at B=2 per rank against one process at B=4 on the joined batch
  (deterministic keypoints and the random draw): the first micro-step's
  loss, every gradient leaf, the BatchNorm running statistics, and the
  parameters after 3 updates at iter_size 2;
- the port's world-2 step against the JAX package's step on a 2-device
  CPU mesh (GSPMD), on one parameter tree;
- ZeRO-1 against plain Adam at world 2;
- the loader's per-process slices against the JAX loader's;
- the step runs under deterministic algorithms and restores the flag, and
  the card's deterministic segment sums (`ops/segment.py`) against
  `index_put_`.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import ranks  # noqa: E402

RANK_TIMEOUT_S = 240  # each subprocess; the rendezvous times out after 60 s
N_MICRO = 6           # 3 updates at iter_size 2

# The DDP step against one process on the joined batch, float32 on the CPU
# in one thread: the two compute one function and differ only in the order
# of their sums (the ranks' partial sums, added by the all-reduce). Loss and
# loss terms: rtol 1e-5 (the error metrics 1e-4). Gradients: the per-leaf criterion of
# tests/test_parallel.py (noise: a leaf whose larger norm is under 1e-3;
# checked leaves within rel-norm 0.05 and cosine 0.995, more than 3x the
# noise leaves), with two additions:
# - a bias directly before a train-mode BatchNorm is set aside too: its
#   gradient is zero in exact arithmetic, and what float32 computes there is
#   cancellation residue, here up to 2e-2 (ego_feats_head.seg_head.0.bias);
# - the tighter bound GRAD_REL, measured on `build_model`'s seed-0 weights
#   (the JAX package's initial distributions): worst 1.20e-3 without the
#   TPointNet objective, motionhead.down_convs.1.conv1.bias, with the margin
#   the bound had over its measured worst at torch's default initialisation
#   (1e-3 over 8.1e-4). One process against itself with its batch rows
#   reordered moves them by 1.07e-3 and 8.9e-3 (the two orders of
#   ROW_ORDERS, test_row_order_alone_moves_the_step_as_far). It
#   holds every leaf without the TPointNet objective
#   and, with it, every leaf not upstream of the TPointNet's max pools. The
#   leaves upstream of them (POOLED) move by 2-6 % with the objective: the
#   pools' near ties (top-2 margins down to ~2e-7, tests/test_torch_train.py
#   WEIGHT_SEED) let a reordered sum pick another winner. They are held to
#   the cosine of tests/test_parallel.py.
# Parameters after 3 updates: tests/test_parallel.py's bound (atol 2 k lr,
# rtol 2e-3): Adam's m / sqrt(v) lifts reduction noise to O(lr).
GRAD_REL = 1.5e-3
ROW_ORDERS = ((2, 3, 0, 1), (1, 0, 3, 2))
STRUCTURAL_ZERO = ("seg_head.0.bias", "regressor.0.bias", "regressor.3.bias")
POOLED = ("motionhead.", "reconstructor.alignment.motion_embed.",
          "reconstructor.alignment.geo_embed.", "reconstructor.alignment.pos_embed.")


def run_ranks(case: str, world: int, out: str, with_reference: bool = False,
              script: str = __file__) -> None:
    """Start the `world` ranks of `case` as subprocesses of `script` (and,
    with_reference, the one-process run on the joined batch) and wait for
    all of them."""
    cmds = ranks.script_commands(script, case, world, ranks.free_port(), out)
    if with_reference:
        cmds.append([sys.executable, script, case, "0", "1", "0", out])
    ranks.wait(ranks.start(cmds), RANK_TIMEOUT_S)


def tiny_setup(out: str, batch_size: int = 4, seed: int = 0) -> dict:
    """The tiny training config of tests/test_torch_train.py, two joined
    batches of `batch_size` samples and seeded weights, written to `out`."""
    from pcaccumulation_tpu_torch import build_model
    from test_torch_motionnet import make_batch
    from test_torch_train import _tiny_cfg

    cfg = _tiny_cfg(iter_size=2)
    cfg["train"]["grad_clip"] = 1.0  # the clip acts: its norm comes from every rank
    batches = [make_batch(cfg, seed=s, batch_size=batch_size) for s in (0, 1)]
    torch.manual_seed(seed)
    model = build_model(cfg, device="cpu")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    for i, b in enumerate(batches):
        np.savez(os.path.join(out, f"batch{i}.npz"), **b)
    torch.save(model.state_dict(), os.path.join(out, "weights.pt"))
    return {"cfg": cfg, "batches": batches, "state": model.state_dict()}


# --------------------------------------------------------------- the ranks
def _load_setup(out: str):
    with open(os.path.join(out, "cfg.json")) as f:
        cfg = json.load(f)
    batches = [dict(np.load(os.path.join(out, f"batch{i}.npz"))) for i in (0, 1)]
    return cfg, batches, torch.load(os.path.join(out, "weights.pt"))


def _rows(batch: dict, rank: int, world: int) -> dict:
    b = len(batch["points"]) // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def _ddp_run(cfg, batches, state, rank, world, out, tag, n_micro):
    """n_micro Trainer micro-steps on this rank's rows: the first step's
    stats, its reduced gradients and the running statistics after it, and
    the parameters and optimizer after the last."""
    from pcaccumulation_tpu_torch import build_model, to_device
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    tr = Trainer(cfg, model, {"train": [None] * 4}, save_dir=os.path.join(out, f"run_{tag}"),
                 device="cpu")
    seen = {}
    update = tr.optimizer.update

    def record(grads):
        if "grads" not in seen:
            seen["grads"] = {n: g.clone() for (n, _), g in
                             zip([(n, p) for n, p in model.named_parameters()], grads)}
        return update(grads)

    tr.optimizer.update = record
    res = {}
    for i in range(n_micro):
        st = tr.train_step(to_device(_rows(batches[i % 2], rank, world), "cpu"),
                           tr.step_generator(1, "train", i))
        if i == 0:
            res["stats"] = {k: (v.clone() if not isinstance(v, dict) else
                                {kk: vv.clone() for kk, vv in v.items()}) for k, v in st.items()}
            res["grads"] = seen["grads"]
            res["buffers"] = {n: b.clone() for n, b in model.named_buffers()}
    res["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    res["count"] = tr.optimizer.count
    res["state_elems"] = sum(t.numel() for key in ("acc", "mu", "nu")
                             for t in getattr(tr.optimizer, key) if t is not None)
    res["total_elems"] = 3 * sum(p.numel() for p in tr.params)
    return res


def _child(case: str, rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    from pcaccumulation_tpu_torch.parallel import mesh

    if world > 1:
        mesh.init_distributed("cpu", init_method=f"tcp://127.0.0.1:{port}",
                              world_size=world, rank=rank, timeout_s=60)
    cfg, batches, state = _load_setup(out)
    name = f"{case}_w{world}_r{rank}"
    if case == "ddp":
        runs = {}
        for tag, det, zero1, n_micro in (("det", True, False, 1), ("det_noobj", True, False, 1),
                                         ("random", False, False, N_MICRO),
                                         ("zero1", False, True, N_MICRO)):
            if zero1 and world == 1:
                continue
            c = json.loads(json.dumps(cfg))
            if tag == "det_noobj":
                c["loss"]["w_obj_loss"] = 0.0
            c["pose_estimation"]["deterministic_sampling"] = det
            c["parallel"]["zero1"] = zero1
            c["parallel"]["num_devices"] = world
            runs[tag] = _ddp_run(c, batches, state, rank, world, out, f"{tag}_{world}_{rank}",
                                 n_micro)
            if world == 1 and tag == "det_noobj":
                for order in ROW_ORDERS:
                    rows = [{k: v[list(order)] for k, v in b.items()} for b in batches]
                    runs[f"{tag}_rows{order}"] = _ddp_run(c, rows, state, rank, world, out,
                                                          f"{tag}_rows", n_micro)
        torch.save(runs, os.path.join(out, f"{name}.pt"))
    elif case == "jax":
        c = json.loads(json.dumps(cfg))
        c["parallel"]["num_devices"] = world
        runs = {"det": _ddp_run(c, batches, state, rank, world, out, f"jax_{rank}", 1)}
        torch.save(runs, os.path.join(out, f"{name}.pt"))
    else:
        raise ValueError(case)
    if world > 1:
        torch.distributed.destroy_process_group()


# --------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ddp"))
    tiny_setup(out)
    run_ranks("ddp", 2, out, with_reference=True)
    load = lambda n: torch.load(os.path.join(out, n))  # noqa: E731
    return {"w2": [load("ddp_w2_r0.pt"), load("ddp_w2_r1.pt")], "w1": load("ddp_w1_r0.pt"),
            "lr": json.load(open(os.path.join(out, "cfg.json")))["optimizer"]["learning_rate"]}


def leaf_check(a: dict, b: dict, whole_objective: bool):
    """The gradient criterion above; returns (checked, noise, worst
    (rel-norm, cosine, leaf) of the tightly held leaves)."""
    checked = noise = 0
    worst = (0.0, 1.0, "")
    for n in a:
        x, y = a[n].double().ravel(), b[n].double().ravel()
        scale = max(float(x.norm()), float(y.norm()))
        if scale < 1e-3 or n.endswith(STRUCTURAL_ZERO):
            noise += scale > 0
            continue
        rel = float((x - y).norm()) / scale
        cos = float(x @ y / (x.norm() * y.norm()))
        assert cos > 0.995, (n, cos)
        if not (whole_objective and n.startswith(POOLED)):
            assert rel < GRAD_REL, (n, rel)
            worst = max(worst, (rel, cos, n))
        else:
            assert rel < 0.1, (n, rel)
        checked += 1
    if whole_objective:
        assert checked > 3 * noise, (checked, noise)
    return checked, noise, worst


def leaf_spread(a: dict, b: dict) -> tuple[float, str]:
    """The largest rel-norm over the leaves that GRAD_REL holds without the
    TPointNet objective, and its leaf."""
    worst = (0.0, "")
    for n in a:
        x, y = a[n].double().ravel(), b[n].double().ravel()
        scale = max(float(x.norm()), float(y.norm()))
        if scale >= 1e-3 and not n.endswith(STRUCTURAL_ZERO):
            worst = max(worst, (float((x - y).norm()) / scale, n))
    return worst


@pytest.mark.parametrize("draw", ["det", "det_noobj", "random"])
def test_ddp_step_equals_one_process_on_the_joined_batch(ddp_runs, draw, record_property):
    """World 2 at B=2 per rank against one process at B=4, deterministic
    keypoints (with and without the TPointNet objective) and the random
    draw: the first micro-step's loss and loss terms on both ranks, its
    reduced gradient (the same bits on both ranks) by the criterion above,
    the BatchNorm running statistics on both ranks; with the random draw the
    parameters after 3 updates at iter_size 2."""
    r0, r1 = (r[draw] for r in ddp_runs["w2"])
    ref = ddp_runs["w1"][draw]
    for key, want in ref["stats"].items():
        if isinstance(want, dict):
            for k2, w2 in want.items():
                torch.testing.assert_close(r0["stats"][key][k2], w2, rtol=1e-5, atol=1e-6)
            continue
        # the error metrics are no loss terms; the rotation error (degrees) is
        # an arccos near 1, which amplifies trace rounding (3.4e-5 measured)
        rtol = 1e-4 if key.endswith("_error") else 1e-5
        for r in (r0, r1):
            torch.testing.assert_close(r["stats"][key], want, rtol=rtol, atol=1e-6,
                                       msg=lambda m: f"{key}: {m}")
    for n in ref["grads"]:
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
    checked, noise, (rel, cos, leaf) = leaf_check(ref["grads"], r0["grads"],
                                                  whole_objective=draw != "det_noobj")
    record_property("worst_leaf", f"{leaf} rel {rel:.3e} cos {cos:.8f}; {checked}/{noise}")
    running = [n for n in ref["buffers"] if "running_" in n]
    assert running
    for n in running:
        assert torch.equal(r0["buffers"][n], r1["buffers"][n]), n
        torch.testing.assert_close(r0["buffers"][n], ref["buffers"][n], rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{n}: {m}")
    if draw == "random":
        k_steps, lr = N_MICRO // 2, ddp_runs["lr"]
        assert r0["count"] == ref["count"] == k_steps
        for n, want in ref["params"].items():
            assert torch.equal(r0["params"][n], r1["params"][n]), n
            torch.testing.assert_close(r0["params"][n], want, rtol=2e-3, atol=2 * k_steps * lr,
                                       msg=lambda m: f"{n}: {m}")


def test_row_order_alone_moves_the_step_as_far(ddp_runs, record_property):
    """The measurement GRAD_REL is set from: one process on the joined
    batch against itself with the batch rows in another order (the same
    four samples; only the order of the batch sums changes), deterministic
    keypoints without the TPointNet objective. The leaves GRAD_REL holds
    move under a reordering as far as the world-2 step moves them, so the
    bound is no looser than the function's own rounding."""
    ref = ddp_runs["w1"]["det_noobj"]
    ddp = leaf_spread(ref["grads"], ddp_runs["w2"][0]["det_noobj"]["grads"])
    rows = {order: leaf_spread(ref["grads"], ddp_runs["w1"][f"det_noobj_rows{order}"]["grads"])
            for order in ROW_ORDERS}
    record_property("worst_leaf", f"world 2 {ddp}; " + "; ".join(
        f"rows {order} {w}" for order, w in rows.items()))
    assert max(w[0] for w in rows.values()) >= ddp[0], (ddp, rows)


def test_zero1_equals_plain_adam(ddp_runs):
    """ZeRO-1 at world 2: each rank holds about half of the optimizer's
    state elements, and the parameters after 3 updates are bit-equal to
    those of plain Adam at world 2 (the same reduced gradients, a global
    norm of the same bits, each parameter updated by its owner and
    broadcast)."""
    for rank, r in enumerate(ddp_runs["w2"]):
        z, plain = r["zero1"], r["random"]
        assert z["count"] == plain["count"] == N_MICRO // 2
        for n, want in plain["params"].items():
            assert torch.equal(z["params"][n], want), (rank, n)
        share = z["state_elems"] / z["total_elems"]
        assert 0.4 < share < 0.6, (rank, share)
        assert plain["state_elems"] == plain["total_elems"]
    total = sum(r["zero1"]["state_elems"] for r in ddp_runs["w2"])
    assert total == ddp_runs["w2"][0]["zero1"]["total_elems"]


def test_ddp_step_matches_the_jax_mesh_step(tmp_path, record_property):
    """The port's world-2 step (B=2 per rank) against the JAX package's
    step on a 2-device CPU mesh (the joined batch sharded on its data axis,
    GSPMD), on one parameter tree loaded through `state_dict_from_jax`,
    train-mode BatchNorm, deterministic keypoints: every loss term within
    the tolerance of tests/test_torch_train.py for train BN, and the whole
    gradient's cosine above 0.99 (its criterion there: the batch
    statistics amplify rounding per layer, so single leaves are not held)."""
    import jax
    import jax.numpy as jnp

    from pcaccumulation_tpu.models import MotionNet as JaxMotionNet
    from pcaccumulation_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from pcaccumulation_tpu.train.loss import fuse_loss as j_fuse_loss
    from pcaccumulation_tpu_torch.utils.weights import state_dict_from_jax
    from test_torch_motionnet import random_variables
    from test_torch_train import TERM_TOL

    out = str(tmp_path)
    setup = tiny_setup(out)
    cfg, batch = setup["cfg"], setup["batches"][0]
    params, stats = random_variables(cfg, batch, seed=0)
    torch.save(state_dict_from_jax(params, stats), os.path.join(out, "weights.pt"))
    run_ranks("jax", 2, out)
    got = [torch.load(os.path.join(out, f"jax_w2_r{r}.pt"))["det"] for r in (0, 1)]

    model = JaxMotionNet(cfg)
    mesh = make_mesh(2)
    jbatch = shard_batch(jax.tree.map(jnp.asarray, batch), mesh)

    def loss_fn(p):
        res, _ = model.apply({"params": p, "batch_stats": stats}, jbatch,
                             train=True, mode="train", mutable=["batch_stats"])
        s = j_fuse_loss(res, jbatch, cfg["loss"], cfg["capacity"]["max_instances"])
        return s["loss"], s

    with mesh:
        (_, want_s), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            replicate(jax.tree.map(jnp.asarray, params), mesh))
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, grads),
                                 jax.tree.map(np.zeros_like, stats))
    for key, w in want_s.items():
        if isinstance(w, dict):
            continue
        for r in got:
            err = abs(float(r["stats"][key]) - float(w))
            assert err < TERM_TOL[True] * max(1.0, abs(float(w))), (key, float(r["stats"][key]),
                                                                     float(w))
    names = sorted(got[0]["grads"])
    a = np.concatenate([want_g[n].numpy().ravel() for n in names]).astype(np.float64)
    b = np.concatenate([got[0]["grads"][n].numpy().ravel() for n in names]).astype(np.float64)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    ratio = float(np.linalg.norm(b) / np.linalg.norm(a))
    record_property("whole_gradient", f"cosine {cos:.6f} norm ratio {ratio:.6f}")
    assert cos > 0.99, cos
    # a missing or doubled reduction over the ranks shows as a norm ratio of ~2
    assert abs(ratio - 1.0) < 0.05, ratio


@pytest.mark.parametrize("count", [1, 2, 3])
def test_loader_slices_match_jax(count):
    """Every process shuffles with one seed and takes the batches
    `process_id::process_count`, trimmed to one length: the port's slices
    are the JAX loader's, and `len()` is per process."""
    from pcaccumulation_tpu.data import loader as jloader
    from pcaccumulation_tpu_torch.data import loader as tloader

    class Idx:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return {"i": np.asarray(i)}

    for pid in range(count):
        kw = dict(batch_size=2, num_workers=0, seed=5, process_id=pid, process_count=count)
        jl, tl = jloader.make_loader(Idx(), **kw), tloader.make_loader(Idx(), **kw)
        want = [b["i"].tolist() for _ in range(2) for b in jl]  # two epochs
        got = [b["i"].tolist() for _ in range(2) for b in tl]
        assert got == want, (pid, count)
        assert len(tl) == len(jloader.make_loader(Idx(), **kw)) == 11 // count


def test_train_step_runs_under_deterministic_algorithms(tmp_path):
    """Inside `Trainer.train_step` and `val_step` deterministic algorithms
    are on; after each, torch's setting is as it was (on or off)."""
    from pcaccumulation_tpu_torch import build_model, to_device
    from pcaccumulation_tpu_torch.train.trainer import Trainer

    setup = tiny_setup(str(tmp_path / "setup"), batch_size=1)
    cfg = setup["cfg"]
    model = build_model(cfg, device="cpu")
    seen = []
    model.register_forward_pre_hook(
        lambda *_: seen.append(torch.are_deterministic_algorithms_enabled()))
    tr = Trainer(cfg, model, {}, save_dir=str(tmp_path / "run"), device="cpu")
    batch = to_device(setup["batches"][0], "cpu")
    for before in (False, True):
        torch.use_deterministic_algorithms(before, warn_only=True)
        try:
            tr.train_step(batch, tr.step_generator(1, "train", 0))
            assert torch.are_deterministic_algorithms_enabled() == before
            assert torch.is_deterministic_algorithms_warn_only_enabled()
            tr.val_step(batch, tr.step_generator(1, "val", 0))
            assert torch.are_deterministic_algorithms_enabled() == before
        finally:
            torch.use_deterministic_algorithms(False)
    assert seen == [True] * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_scan_sum_matches_index_put(dtype):
    """The card's form of `ops.segment.sorted_segment_sum` (a stable sort
    and a segmented scan by doubling) and of `take_rows`'s gradient, run
    here on the CPU, where `sorted_segment_sum` itself is `index_put_`'s
    pass in row order: skewed segments (one holds most rows), empty
    segments, dropped rows; the sums within log2(N) float32 roundings of
    the sum of |x| of the float64 sums, then one rounding to the dtype;
    two calls bit-equal; the gradient
    the cotangent gathered per row (zero for dropped rows); the gather's
    gradient the per-row sum of its cotangent."""
    from pcaccumulation_tpu_torch.ops.segment import _SegmentSum, _TakeRows, _safe_ids

    gen = torch.Generator().manual_seed(0)
    n, s, c = 6000, 41, 5
    ids = torch.randint(0, s, (n,), generator=gen)
    ids[torch.randperm(n, generator=gen)[:4000]] = 5      # one long segment
    ids[ids == 7] = 8                                      # an empty one
    ids[-300:-150] = s                                     # dropped: past the end
    ids[-150:] = -2                                        # dropped: negative
    data = torch.randn((n, c), generator=gen).to(dtype).requires_grad_(True)
    safe = _safe_ids(ids, s)
    got = _SegmentSum.apply(data, safe, s)
    want = torch.zeros((s + 1, c), dtype=torch.float64).index_put_(
        (safe,), data.detach().double(), accumulate=True)[:s]
    # a tree of float32 adds: log2(n) roundings of at most the sum of |x|,
    # then one rounding to the dtype
    abs_sum = torch.zeros((s + 1, c), dtype=torch.float64).index_put_(
        (safe,), data.detach().double().abs(), accumulate=True)[:s]
    bound = (np.log2(n) * torch.finfo(torch.float32).eps * abs_sum
             + torch.finfo(dtype).eps * want.abs())
    assert got.dtype == dtype and bool(((got.double() - want).abs() <= bound).all())
    assert torch.equal(got, _SegmentSum.apply(data, safe, s))
    assert bool((got[7] == 0).all())
    gout = torch.randn((s, c), generator=gen).to(dtype)
    got.backward(gout)
    want_g = torch.cat([gout, torch.zeros((1, c), dtype=dtype)])[safe]
    assert torch.equal(data.grad, want_g)

    arr = torch.randn((s, c), generator=gen).requires_grad_(True)
    idx = safe.clamp(max=s - 1)
    rows = _TakeRows.apply(arr, idx)
    assert torch.equal(rows, arr.detach()[idx])
    g = torch.randn((n, c), generator=gen)
    rows.backward(g)
    want_a = torch.zeros((s, c), dtype=torch.float64).index_add_(0, idx, g.double())
    abs_a = torch.zeros((s, c), dtype=torch.float64).index_add_(0, idx, g.double().abs())
    assert bool(((arr.grad.double() - want_a).abs()
                 <= np.log2(n) * torch.finfo(torch.float32).eps * abs_a).all())


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
