"""The port's initial weights against the JAX package's `MotionNet.init`.

No test before this one compared the two packages' initial weights: every
parity test carries JAX parameters into the port. Here the JAX init (as
`train/trainer.py` runs it) is mapped to the port's names by
`state_dict_from_jax` and set beside `build_model(cfg, "cpu", generator)`
at two configs: the parity config of `tests/test_torch_motionnet.py` (UNet
depth 3, T=3, plain heads) and the `configs/synthetic.yaml` widths (UNet
depth 5, T=5, the s2d level 0, the sparse ego head) on a smaller grid.

Each leaf's distribution is derived here from the JAX kernel layout, apart
from the port's code: biases 0, BatchNorm scale 1 and statistics 0 / 1,
the affinity's alpha / beta -5, the ResNet blocks' second kernel 0, and
kernels a normal truncated at +-2 sd with sd sqrt(1 / fan): fan_in =
prod(shape[:-1]) (lecun_normal) and, in both UNets, the mean of fan_in and
fan_out = prod(shape[:-2]) * shape[-1] (xavier_normal). Criteria per leaf
of n elements, on both sides: the same set of leaves is exactly zero;
constants equal; a drawn leaf's sample sd within 5 / sqrt(2n) of its sd
(relative), |mean| within 5 sd / sqrt(n), max |w| at most the cut, 2 sd /
0.8796 (the truncated normal's own sd is 0.8796 of the untruncated one).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_threads  # noqa: F401  (torch's threads: this xdist worker's share of the cores)

from pcaccumulation_tpu.config import derive, load_config
from pcaccumulation_tpu.models import MotionNet as JaxMotionNet
from pcaccumulation_tpu_torch import build_model, model_generator
from pcaccumulation_tpu_torch.utils.weights import TRUNC_STD, state_dict_from_jax
from test_torch_motionnet import config as parity_config
from test_torch_motionnet import make_batch


def synthetic_config() -> dict:
    """configs/synthetic.yaml's widths and options on a 64 x 64 grid."""
    cfg = load_config("configs/synthetic.yaml")
    cfg["voxel_generator"].update({"range": [-8, -8, -5, 8, 8, 3], "crop_range": [8, -5, 3]})
    cfg["capacity"].update({"max_points": 8000, "max_pillars": 3000, "max_fg_points": 512})
    cfg["pose_estimation"]["n_kpts"] = 128
    return derive(cfg)


def configs() -> dict:
    cfgs = {"parity": parity_config("parity"), "synthetic": synthetic_config()}
    for cfg in cfgs.values():
        cfg["misc"]["seed"] = 42
    return cfgs


@pytest.fixture(scope="module")
def jax_inits():
    """{variant: the JAX package's (params, batch_stats) as numpy trees},
    drawn as its Trainer draws them (`model.init` jitted, the params key
    from `misc.seed`). The two programs compile at the same time, at XLA's
    backend optimisation level 0: their cost is the ~150 initialisers'
    random-bit and erf_inv code. The draws are the default level's within
    3.4e-7 (relative), rounding in the float steps."""
    lowered = {}
    for name, cfg in configs().items():
        model = JaxMotionNet(cfg)
        rngs = {"params": jax.random.key(cfg["misc"]["seed"]), "sample": jax.random.key(0)}
        batch = jax.tree.map(jnp.asarray, make_batch(cfg, batch_size=1))
        init = jax.jit(lambda r, b, model=model: model.init(r, b, train=False, mode="val"))
        lowered[name] = (init.lower(rngs, batch), rngs, batch)

    def run(name):
        low, rngs, batch = lowered[name]
        v = low.compile(compiler_options={"xla_backend_optimization_level": 0})(rngs, batch)
        return jax.tree.map(np.asarray, v["params"]), jax.tree.map(np.asarray, v["batch_stats"])

    with ThreadPoolExecutor(len(lowered)) as pool:
        futures = {name: pool.submit(run, name) for name in lowered}
        return {name: f.result() for name, f in futures.items()}


def expected(params, stats):
    """(sd, const) trees shaped as the JAX trees: a drawn leaf has its sd
    and const NaN, a constant leaf sd 0 and its value."""
    def leaf_rule(path, leaf):
        keys = [p.key for p in path]
        name, shape = keys[-1], leaf.shape
        if name == "kernel":
            if keys[-2] == "fc_1" and keys[0] == "pillar_encoder":
                return 0.0, 0.0
            fan_in = np.prod(shape[:-1])
            fan_out = np.prod(shape[:-2]) * shape[-1]
            fan = (fan_in + fan_out) / 2 if "unet" in keys else fan_in
            return float(np.sqrt(1.0 / fan)), np.nan
        const = {"bias": 0.0, "scale": 1.0, "mean": 0.0, "var": 1.0, "alpha": -5.0, "beta": -5.0}
        return 0.0, const[name]

    def fill(which):
        def f(path, leaf):
            return np.full(leaf.shape, leaf_rule(path, leaf)[which], np.float32)
        return f

    sd = state_dict_from_jax(jax.tree_util.tree_map_with_path(fill(0), params),
                             jax.tree_util.tree_map_with_path(fill(0), stats))
    const = state_dict_from_jax(jax.tree_util.tree_map_with_path(fill(1), params),
                                jax.tree_util.tree_map_with_path(fill(1), stats))
    return ({k: float(v.reshape(-1)[0]) for k, v in sd.items() if v.is_floating_point()},
            {k: float(v.reshape(-1)[0]) for k, v in const.items() if v.is_floating_point()})


def check_leaf(side: str, key: str, w: np.ndarray, sd: float, const: float) -> list[str]:
    w = w.astype(np.float64).ravel()
    if sd == 0.0:
        return [] if np.all(w == const) else [f"{side} {key}: not the constant {const}"]
    n = w.size
    bad = []
    if abs(w.std() / sd - 1) > 5 / np.sqrt(2 * n):
        bad.append(f"{side} {key}: sd {w.std():.5f} against {sd:.5f} (n={n})")
    if abs(w.mean()) > 5 * sd / np.sqrt(n):
        bad.append(f"{side} {key}: mean {w.mean():.5f}, sd {sd:.5f} (n={n})")
    if np.abs(w).max() > 2 * sd / TRUNC_STD * (1 + 1e-6):
        bad.append(f"{side} {key}: max |w| {np.abs(w).max():.5f} over the cut "
                   f"{2 * sd / TRUNC_STD:.5f}")
    return bad


@pytest.mark.parametrize("variant", ["parity", "synthetic"])
def test_initial_weights_match_jax_init(jax_inits, variant):
    cfg = configs()[variant]
    params, stats = jax_inits[variant]
    want = {k: v.numpy() for k, v in state_dict_from_jax(params, stats).items()
            if v.is_floating_point()}
    model = build_model(cfg, "cpu", model_generator(cfg))
    got = {k: v.numpy() for k, v in model.state_dict().items() if v.is_floating_point()}
    assert set(got) == set(want)
    sds, consts = expected(params, stats)

    zero_jax = {k for k, v in want.items() if not v.any()}
    zero_port = {k for k, v in got.items() if not v.any()}
    assert zero_port == zero_jax, (sorted(zero_port - zero_jax)[:10],
                                   sorted(zero_jax - zero_port)[:10])
    bad = []
    for key in sorted(want):
        bad += check_leaf("jax", key, want[key], sds[key], consts[key])
        bad += check_leaf("port", key, got[key], sds[key], consts[key])
    assert not bad, "\n".join(bad[:40])

    # the same generator seed gives the same weights; another seed others
    again = build_model(cfg, "cpu", model_generator(cfg)).state_dict()
    other = build_model(cfg, "cpu", torch.Generator().manual_seed(43)).state_dict()
    key = "unet.down_convs.0.conv1.weight"
    assert all(torch.equal(again[k], v) for k, v in model.state_dict().items())
    assert not torch.equal(other[key], again[key])
