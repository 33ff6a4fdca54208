"""Write `tests/data/jax_orbax_tiny/`: a JAX training run's orbax checkpoint
for the PyTorch port to take over where no JAX is installed.

    JAX_PLATFORMS=cpu python tools/make_jax_orbax_fixture.py [--out DIR]
    JAX_PLATFORMS=cpu python tools/make_jax_orbax_fixture.py --waymo-full DIR
    JAX_PLATFORMS=cpu python tools/make_jax_orbax_fixture.py --two-process [DIR]

Runs on the CPU with the JAX package (jax, optax, orbax) and the port, from
the repository root. The first form runs the JAX package's `Trainer` at the
tiny training config of tests/test_torch_train.py (`_tiny_cfg(iter_size=2)`,
the clip at 1.0, deterministic keypoints) on two seeded batches of one
sample: two updates and one further micro-step, so that Adam's moments,
its count, the accumulator and `mini_step` are all nonzero, then the
Trainer's own `snapshot` with `train.ckpt_backend: orbax`. It writes to DIR:
- `model_latest.ckpt.orbax/`: that checkpoint (epoch 1);
- `cfg.json`: the derived config;
- `expected.npz`: the two batches (`batch0/<key>`, `batch1/<key>`), the JAX
  val forward (eval BN, `mode="val"`) of the saved weights on batch 0
  (`val/<key>`), and the parameters after the JAX Trainer's next
  micro-step on batch 1, which ends the accumulation and applies the third
  update (`next/<port parameter name>`, by `state_dict_from_jax`'s names
  and layouts).

To keep the tracked directory small (~2 MB), the config is narrowed
(`unet.start_filts` 8, `pillar_encoder.num_filters` 8, `stpn.feat_dim` 8,
`pose_estimation.feats_dim` 16) and the losses that reach the STPN and the
TPointNet (MOS, offsets, the TPointNet objective) are weighted 0. Their
parameters (the STPN's UNet has fixed widths, 2.9 M parameters) then take
no gradient, keep Adam's moments and the accumulator at zero, and each
repeats the first 1,024 entries the JAX package's initialisation drew for
it, so that zstd compresses it; `expected.npz` holds only the parameters
the next update changes. Every other parameter trains as drawn.

The second form saves the Waymo preset's full-width state (the JAX
package's `MotionNet.init` at `configs/waymo.yaml`, its batch statistics and
`make_optimizer`'s state after one update, all with seeded values) with
the JAX package's orbax backend into DIR, reads it with the port
(`read_checkpoint`), holds every leaf bit-equal to the JAX package's
restore, and prints the port's read time.

The third form has two JAX CPU processes save one small tree sharded over
both with orbax (each process writes its own shards), into DIR
(default `tests/data/jax_orbax_two_process/`) with the global values in
`expected.npz`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

FROZEN_LOSSES = ("w_pose_l1_loss", "w_perm_loss", "w_mos_bce_loss", "w_mos_lovasz_loss",
                 "w_offset_norm_loss", "w_offset_dir_loss", "w_obj_l1_loss", "w_obj_pose_loss",
                 "w_obj_loss")
PERIOD = 1024  # a frozen leaf repeats its first PERIOD drawn entries


def fixture_config() -> dict:
    from test_torch_train import _tiny_cfg

    cfg = _tiny_cfg(iter_size=2)
    cfg["train"].update(grad_clip=1.0, ckpt_backend="orbax")
    cfg["pose_estimation"]["deterministic_sampling"] = True
    cfg["unet"]["depth"] = 2
    cfg["loss"].update(dict.fromkeys(FROZEN_LOSSES, 0.0))
    return cfg


def periodic(a: np.ndarray, period: int = PERIOD) -> np.ndarray:
    """`a` with its first `period` entries (C order) repeated over it."""
    flat = np.asarray(a).ravel()
    return np.resize(flat[:period], flat.size).reshape(np.shape(a))


def make_fixture(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from pcaccumulation_tpu.models import MotionNet as JaxMotionNet
    from pcaccumulation_tpu.train.trainer import Trainer as JaxTrainer
    from pcaccumulation_tpu_torch.utils.weights import params_from_jax
    from test_torch_motionnet import make_batch

    cfg = fixture_config()
    batches = [make_batch(cfg, seed=s, batch_size=1) for s in (0, 1)]
    work = tempfile.mkdtemp(prefix="jax_fixture_")
    try:
        tr = JaxTrainer(cfg, JaxMotionNet(cfg), {"train": batches, "val": batches[:1]},
                        save_dir=work)
        # the leaves the frozen losses alone reach take no gradient: found
        # on the first micro-step's gradient, then made periodic
        jb = [jax.tree.map(jnp.asarray, b) for b in batches]
        grads = jax.jit(jax.grad(lambda p: _loss(tr, p, jb[0])))(tr.params)
        frozen = jax.tree.map(lambda g: not bool(jnp.any(g != 0)), grads)
        tr.params = jax.tree.map(lambda p, f: jnp.asarray(periodic(np.asarray(p))) if f else p,
                                 tr.params, frozen)
        n_frozen = sum(int(np.prod(p.shape)) for p, f in zip(jax.tree.leaves(tr.params),
                                                            jax.tree.leaves(frozen)) if f)
        n_all = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(tr.params))
        rng = jax.random.key(0)
        for it in range(5):
            tr.params, tr.batch_stats, tr.opt_state, _ = tr._train_step(
                tr.params, tr.batch_stats, tr.opt_state, jb[it % 2], jax.random.fold_in(rng, it))
        assert int(tr.opt_state.mini_step) == 1 and int(tr.opt_state.gradient_step) == 2
        os.makedirs(out, exist_ok=True)
        shutil.rmtree(os.path.join(out, "model_latest.ckpt.orbax"), ignore_errors=True)
        tr.save_dir = out
        tr.snapshot(1, "latest")
        model = JaxMotionNet(cfg)
        val = jax.jit(lambda p, s, b: model.apply({"params": p, "batch_stats": s}, b,
                                                  train=False, mode="val"))(
            tr.params, tr.batch_stats, jb[0])
        saved = jax.tree.map(np.asarray, tr.params)
        params, _, _, _ = tr._train_step(tr.params, tr.batch_stats, tr.opt_state, jb[1],
                                         jax.random.fold_in(rng, 5))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    expected = {f"batch{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()}
    expected.update({f"val/{k}": np.asarray(v) for k, v in val.items()
                     if not isinstance(v, dict)})
    before = params_from_jax(jax.tree.map(np.asarray, saved))
    expected.update({f"next/{k}": v.numpy() for k, v in
                     params_from_jax(jax.tree.map(np.asarray, params)).items()
                     if not np.array_equal(v.numpy(), before[k].numpy())})
    np.savez_compressed(os.path.join(out, "expected.npz"), **expected)
    with open(os.path.join(out, "cfg.json"), "w") as f:
        json.dump(cfg, f, indent=1, sort_keys=True)
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(out) for n in ns)
    print(f"wrote {out}: {size / 2 ** 20:.3f} MiB; {n_all} parameters, {n_frozen} frozen "
          f"and periodic ({PERIOD})")


def _loss(tr, params, batch):
    """The JAX Trainer's training loss (train-mode BN) at the fixture's
    weights, as its train step computes it."""
    import jax

    from pcaccumulation_tpu.train.loss import fuse_loss

    res, _ = tr.model.apply({"params": params, "batch_stats": tr.batch_stats}, batch,
                            train=True, mode="train", rngs={"sample": jax.random.key(0)},
                            mutable=["batch_stats"])
    return fuse_loss(res, batch, tr.cfg["loss"], tr.cfg["capacity"]["max_instances"])["loss"]


def waymo_full(out: str) -> None:
    import jax
    import jax.numpy as jnp

    import pcaccumulation_tpu.train.trainer as jtrainer
    from pcaccumulation_tpu.config import load_config
    from pcaccumulation_tpu.data.dataset import prep_sample
    from pcaccumulation_tpu.data.loader import collate
    from pcaccumulation_tpu.data.synthetic import generate_sample
    from pcaccumulation_tpu.models import MotionNet as JaxMotionNet
    from pcaccumulation_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
    from pcaccumulation_tpu_torch.utils.checkpoint import read_checkpoint
    from pcaccumulation_tpu_torch.utils.orbax_read import read_orbax
    from test_torch_orbax import _assert_same_tree

    cfg = load_config(os.path.join(REPO, "configs", "waymo.yaml"))
    batch = collate([prep_sample(generate_sample(seed=0, n_frames=5), cfg)])
    shapes = jax.eval_shape(
        lambda b: JaxMotionNet(cfg).init({"params": jax.random.key(0),
                                          "sample": jax.random.key(1)}, b, train=False,
                                         mode="val"), jax.tree.map(jnp.asarray, batch))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32) * 0.05,
                             shapes)
    params = variables["params"]
    tx = jtrainer.make_optimizer(cfg, 10)[0]
    st = tx.init(params)
    for _ in range(cfg["train"]["iter_size"]):
        g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        _, st = jax.jit(tx.update)(g, st, params)
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    path = os.path.join(out, "model_latest.ckpt")
    save_checkpoint(path, {"epoch": 3, "params": params, "batch_stats": variables["batch_stats"],
                           "opt_state": jax.tree.map(np.asarray, st), "best_loss": 1.0,
                           "best_metric": 0.5}, backend="orbax")
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path + ".orbax")
               for f in fs)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        tree = read_orbax(path)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    state = read_checkpoint(path)
    t_state = time.perf_counter() - t0
    _assert_same_tree(tree, load_checkpoint(path))
    print(f"Waymo preset, full width: {n} parameters, {size / 2 ** 20:.1f} MiB on disk; every "
          f"leaf of the port's read bit-equal to the JAX package's restore; read_orbax "
          f"{', '.join(f'{t:.3f}' for t in times)} s (warm file cache), read_checkpoint with "
          f"the mapping {t_state:.3f} s; Adam's count {state['optimizer']['count']}")


def two_process(out: str) -> None:
    """Two JAX CPU processes (2 devices each, joined by
    `jax.distributed`, as tests/test_multihost.py joins them) save one tree
    of arrays sharded over the 4 devices with orbax's StandardCheckpointer:
    each process writes its own shards under `ocdbt.process_<i>/`. Process
    0 writes the global values to `expected.npz`."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               str(port), out], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"a saving process failed:\n{text[-3000:]}")
    print(f"wrote {out}: {sorted(os.listdir(os.path.join(out, 'model_latest.ckpt.orbax')))}")


def two_process_rank(rank: int, port: int, out: str) -> None:
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from pcaccumulation_tpu.parallel.mesh import initialize_multihost

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    initialize_multihost(f"localhost:{port}", num_processes=2, process_id=rank)
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4), ("d",))
    rng = np.random.default_rng(0)  # the same values on both processes
    values = {"w": rng.normal(size=(8, 6)).astype(np.float32),
              "step": np.arange(12, dtype=np.int32).reshape(4, 3),
              "h": rng.normal(size=(4, 5)).astype(np.float32),
              "rep": rng.normal(size=(3,)).astype(np.float32)}
    specs = {"w": P("d"), "step": P("d"), "h": P("d"), "rep": P()}

    def put(k):
        arr = values[k] if k != "h" else values[k].astype(jnp.bfloat16)
        sharding = NamedSharding(mesh, specs[k])
        return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])

    tree = {"params": {k: put(k) for k in ("w", "h", "rep")},
            "opt_state": [put("step"), None]}
    with ocp.StandardCheckpointer() as ck:
        ck.save(os.path.join(out, "model_latest.ckpt.orbax"), tree)
    if rank == 0:
        np.savez(os.path.join(out, "expected.npz"), **{
            "params/w": values["w"], "params/rep": values["rep"],
            "params/h": np.asarray(values["h"].astype(jnp.bfloat16)).view(np.uint16),
            "opt_state/0": values["step"]})
    jax.distributed.shutdown()


def main() -> None:
    if sys.argv[1:2] == ["--rank"]:  # one process of `two_process`
        two_process_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data", "jax_orbax_tiny"))
    ap.add_argument("--waymo-full", metavar="DIR")
    ap.add_argument("--two-process", metavar="DIR", nargs="?",
                    const=os.path.join(REPO, "tests", "data", "jax_orbax_two_process"))
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.waymo_full:
        waymo_full(args.waymo_full)
    elif args.two_process:
        two_process(args.two_process)
    else:
        make_fixture(args.out)


if __name__ == "__main__":
    main()
