"""Per-leaf distances between two gradients of the same model, and the
criterion that holds a bf16 gradient against the float32 one.

A bf16 step's gradient is a noisy estimate of the float32 one, not a
rounding of it: bf16 rounds each product to 8 significant bits, and the FB
decisions and the keypoints they choose move with an ulp. So a bf16 leaf is
held by its rel-norm and cosine against the float32 leaf, within
BF16_LEAF_REL and BF16_LEAF_COS, above a noise floor of 1e-5 of the largest
float32 leaf norm. chip_smoke.py, tools/mesh_bf16_spread.py and
tests/test_torch_mesh.py measure with these functions.
"""

from __future__ import annotations

BF16_LEAF_REL, BF16_LEAF_COS = 0.5, 0.85  # set before the first bf16 run on the card (PERF.md §6)
NOISE_FLOOR = 1e-5  # of the largest float32 leaf norm

# biases directly before a train-mode BatchNorm: zero in exact arithmetic,
# cancellation residue in a step
STRUCTURAL_ZERO = ("seg_head.0.bias", "regressor.0.bias", "regressor.3.bias")
# the leaves upstream of the TPointNet's max pools, whose bf16 gradient
# also moves with the points the pools pick
POOLED = ("motionhead.", "reconstructor.alignment.motion_embed.",
          "reconstructor.alignment.geo_embed.", "reconstructor.alignment.pos_embed.")


def noise_floor(g32: dict, names: list) -> float:
    """NOISE_FLOOR times the largest norm of the leaves `names` of g32."""
    return max(float(g32[n].norm()) for n in names) * NOISE_FLOOR


def leaf_distances(a: dict, b: dict, names: list, floor: float) -> dict:
    """{leaf: (rel-norm, cosine)} of a against b for the leaves of `names`
    whose norm in b is at least `floor`; the rel-norm is |a - b| over the
    larger of |a| and |b|. A NaN in a leaf gives NaN distances."""
    out = {}
    for n in names:
        x, y = a[n].double().ravel(), b[n].double().ravel()
        if float(y.norm()) < floor:
            continue
        rel = float((x - y).norm()) / max(float(x.norm()), float(y.norm()))
        out[n] = (rel, float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300)))
    return out


def bf16_misses(g16: dict, g32: dict, names: list) -> tuple[dict, list]:
    """The leaves of `names` above the noise floor of g32, with g16's
    (rel-norm, cosine) against g32, and those of them that miss
    rel-norm < BF16_LEAF_REL and cosine > BF16_LEAF_COS (a NaN misses)."""
    dist = leaf_distances(g16, g32, names, noise_floor(g32, names))
    return dist, [n for n, (rel, cos) in dist.items()
                  if not (rel < BF16_LEAF_REL and cos > BF16_LEAF_COS)]
