"""Opacity-based splat filtering before compression (port of
gscodec_studio_tpu/compression/outlier_filter.py)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def filter_splats(
    splats: Dict[str, np.ndarray], opacity_threshold: float = 0.005
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Drop splats whose sigmoid(opacity) is below threshold. Returns
    (filtered splats, keep mask)."""
    op = 1.0 / (1.0 + np.exp(-np.asarray(splats["opacities"])))
    keep = op >= opacity_threshold
    out = {k: np.asarray(v)[keep] for k, v in splats.items()}
    return out, keep
