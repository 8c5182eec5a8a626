"""K-means vector quantization (port of
gscodec_studio_tpu/compression/kmeans.py), the shN codec's: Lloyd
iterations with the initial centroids drawn as the JAX package draws them
(numpy's default_rng(seed).choice), each row assigned to its nearest
centroid by the matmul identity |x|^2 - 2 x.c + |c|^2 and argmin, and the
centroids moved to their rows' means by index_add_; a cluster left empty
keeps its centroid.

The assignment runs in chunks of rows, each chunk's [chunk, K] distance
matrix bounded to ``CHUNK_ELEMS`` floats (1 GiB), so that K = 32,768 fits
on the card beside the rest.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device

CHUNK_ELEMS = 1 << 28  # floats of one chunk's distance matrix


def assign(x: torch.Tensor, x_sq: torch.Tensor,
           centroids: torch.Tensor) -> torch.Tensor:
    """The nearest centroid of each row of x [N, D] -> labels [N] int64."""
    k = centroids.shape[0]
    c_sq = (centroids * centroids).sum(1)
    chunk = max(1, CHUNK_ELEMS // k)
    parts = []
    for lo in range(0, x.shape[0], chunk):
        xc = x[lo:lo + chunk]
        d2 = x_sq[lo:lo + chunk, None] - 2.0 * (xc @ centroids.T) \
            + c_sq[None, :]
        parts.append(torch.argmin(d2, dim=1))
    return torch.cat(parts)


def kmeans(x: np.ndarray, n_clusters: int, iters: int = 10, seed: int = 0,
           device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """x [N, D] -> (centroids [K, D] float32, labels [N] int64), computed
    on ``device`` (None means the CUDA card), K = min(n_clusters, N)."""
    dev = resolve_device(device)
    n = x.shape[0]
    k = min(n_clusters, n)
    rng = np.random.default_rng(seed)
    first = rng.choice(n, k, replace=False)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    centroids = xt[torch.as_tensor(first, device=dev)].clone()
    x_sq = (xt * xt).sum(1)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    labels = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(iters):
        labels = assign(xt, x_sq, centroids)
        sums = torch.zeros_like(centroids).index_add_(0, labels, xt)
        counts = torch.zeros(k, dtype=torch.float32,
                             device=dev).index_add_(0, labels, ones)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    return centroids.cpu().numpy(), labels.cpu().numpy()
