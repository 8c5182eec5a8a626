"""Synthetic scenes (the port's own copy of bench.py:make_scene)."""

from __future__ import annotations

import numpy as np


def make_scene(n: int = 1_000_000, width: int = 1297, height: int = 840,
               seed: int = 0):
    """Garden-like synthetic scene: points clustered in a disk with a
    realistic opacity/scale mix, SH degree 3, one camera 6 units back.
    Returns numpy (means, quats, scales, opacities, colors [n,16,3],
    viewmats [1,4,4], Ks [1,3,3]); scales and opacities are linear."""
    rng = np.random.default_rng(seed)
    means = np.empty((n, 3), np.float32)
    means[:, 0] = rng.standard_normal(n) * 2.5
    means[:, 1] = rng.standard_normal(n) * 1.5
    means[:, 2] = rng.standard_normal(n) * 2.5
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-4.6, 0.7, (n, 3))).astype(np.float32)
    opacities = (rng.beta(0.7, 1.2, n)).astype(np.float32)
    sh0 = (rng.random((n, 1, 3)) - 0.5).astype(np.float32)
    shN = (0.1 * rng.standard_normal((n, 15, 3))).astype(np.float32)
    colors = np.concatenate([sh0, shN], axis=1)
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, 3] = [0, 0, 6.0]
    f = 1100.0
    Ks = np.array(
        [[[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]]], np.float32
    )
    return means, quats, scales, opacities, colors, viewmat[None], Ks
