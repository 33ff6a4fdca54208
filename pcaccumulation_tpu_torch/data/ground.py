"""Iterative ground-plane fitting (host-side, numpy; the port's copy of the
JAX package's `data/ground.py`).

Rebuilds the reference's plane-fit ground segmentation
(its toolbox/remove_ground.py:15-46, the ICRA'17 "Fast
Segmentation of 3D Point Clouds" seed-and-refit method): seed the ground set
from the lowest points, then alternate {fit plane to ground set via the
smallest principal axis, re-threshold all points by signed distance}.

The main data path removes ground by height threshold exactly like the
reference's runtime does (libs/dataset.py:179-183 -> data/dataset.py here);
this module is the alternative the reference evaluated, kept as a library
utility for preprocessing pipelines on sloped scenes.

Differences from the reference, on purpose:
 - the covariance/eigenvector fit is one ``np.cov`` + ``eigh`` instead of
   six explicit mean-product scalars (remove_ground.py:30-38);
 - the plane normal's sign is fixed to point UP (+z) each iteration; the
   reference leaves the SVD sign ambiguity unresolved, which silently flips
   the inequality for some inputs.
"""

from __future__ import annotations

import numpy as np


def fit_ground_plane(
    points: np.ndarray,
    n_lowest: int = 20,
    seed_margin: float = 1.2,
    n_iter: int = 10,
    dist_threshold: float = 0.3,
):
    """Fit a ground plane and classify points against it.

    Input:
        points:         [N, >=3] (only xyz used)
        n_lowest:       seed = points below mean(z of n_lowest lowest) + margin
        seed_margin:    th_seeds_ in the reference (1.2 m)
        n_iter:         refit iterations (10)
        dist_threshold: signed distance below which a point is ground (0.3 m)

    Returns:
        (normal [3], d, is_ground [N] bool): plane as n.p + d = 0 with n
        pointing up, and the final ground classification.
    """
    pts = np.asarray(points, np.float64)[:, :3]
    n = pts.shape[0]
    if n == 0:
        return np.array([0.0, 0.0, 1.0]), 0.0, np.zeros(0, bool)

    # seed from the lowest points (remove_ground.py:9-12,26-28)
    z = pts[:, 2]
    k = min(n_lowest, n)
    lpr = np.mean(np.partition(z, k - 1)[:k])
    ground = pts[z < lpr + seed_margin]
    if ground.shape[0] < 3:  # degenerate scene: everything above the seed band
        return np.array([0.0, 0.0, 1.0]), -lpr, z < lpr + dist_threshold

    normal = np.array([0.0, 0.0, 1.0])
    d = -np.mean(ground[:, 2])
    for _ in range(n_iter):
        mean = ground.mean(0)
        cov = np.cov(ground.T, bias=True)
        w, v = np.linalg.eigh(cov)          # ascending eigenvalues
        normal = v[:, 0]                    # smallest principal axis
        if normal[2] < 0:                   # fix the sign ambiguity: up
            normal = -normal
        d = -normal @ mean
        signed = pts @ normal + d
        is_ground = signed < dist_threshold
        if not is_ground.any():             # plane lost every point: stop
            break
        ground = pts[is_ground]

    is_ground = (pts @ normal + d) < dist_threshold
    return normal, float(d), is_ground


def non_ground_mask(points: np.ndarray, **kwargs) -> np.ndarray:
    """[N] bool, True for non-ground points (remove_ground.py:15-46 API)."""
    _, _, is_ground = fit_ground_plane(points, **kwargs)
    return ~is_ground
