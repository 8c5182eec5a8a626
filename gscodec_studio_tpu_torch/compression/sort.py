"""Sort splats onto a square 2D grid for the image codecs (port of
gscodec_studio_tpu/compression/sort.py), with the port's own PLAS
(compression/native.py)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from gscodec_studio_tpu_torch.compression import native


def sort_splats(
    splats: Dict[str, np.ndarray],
    verbose: bool = False,
    sort_keys=None,
    sweeps_per_level: int = 2,
    seed: int = 0,
) -> Tuple[Dict[str, np.ndarray], int]:
    """Crop to a square count (dropping the lowest-opacity splats), then
    PLAS-sort all attributes onto the grid by the standardized attributes
    of ``sort_keys`` (all but shN by default).

    Returns (sorted splats, grid side length)."""
    del verbose
    n = len(splats["means"])
    side = int(np.floor(np.sqrt(n)))
    keep_n = side * side
    if keep_n < n:
        order = np.argsort(np.asarray(splats["opacities"]))[::-1]
        keep = np.sort(order[:keep_n])
        splats = {k: np.asarray(v)[keep] for k, v in splats.items()}

    if sort_keys is None:
        sort_keys = [k for k in splats if k != "shN"]
    feats = []
    for k in sort_keys:
        v = np.asarray(splats[k], np.float32).reshape(keep_n, -1)
        std = v.std(axis=0)
        std[std == 0] = 1
        feats.append((v - v.mean(axis=0)) / std)
    data = np.concatenate(feats, axis=1)
    perm = native.plas_sort(data, side, sweeps_per_level=sweeps_per_level,
                            seed=seed)
    out = {k: np.asarray(v)[perm] for k, v in splats.items()}
    return out, side
