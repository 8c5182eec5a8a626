"""SelectiveAdam (port of gscodec_studio_tpu/optimizers/selective_adam.py):
Adam whose moments and update are frozen on the rows that no camera of the
batch saw (Taming-3DGS).

Three behaviours of the JAX version are kept as they are:
  * raw moments: the step is -lr mu / (sqrt(nu) + eps), with no bias
    correction (the reference's CUDA step does the same);
  * a row whose visibility is 0 keeps its parameter and both moments, which
    nothing decays;
  * the learning-rate schedule is read at count + 1, one step later than
    optax.adam (and builders.AdamGroup.lr_at(count)) reads it.

The state is the port's Adam layout, {"count", "exp_avg", "exp_avg_sq"},
which the strategies edit row by row. ``selective_adam_step`` updates a
group in place: on CUDA tensors by the kernel of csrc/selective_adam.cu
(one launch, counted in ops.raster_v2.LAUNCHES["selective_adam"]), on CPU
tensors by ``selective_adam_plain``, the same arithmetic in PyTorch.
"""

from __future__ import annotations

import torch

from gscodec_studio_tpu_torch import native
from gscodec_studio_tpu_torch.ops import raster_v2 as rv


def _row_mask(vis: torch.Tensor, ndim: int) -> torch.Tensor:
    return vis.reshape(vis.shape + (1,) * (ndim - vis.ndim))


def selective_adam_plain(p: torch.Tensor, g: torch.Tensor,
                         exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                         visibility: torch.Tensor, lr: float, b1: float,
                         b2: float, eps: float) -> None:
    """The step in PyTorch, in place: the kernel's plain version. Each
    product and sum rounds on its own, in the JAX version's order."""
    v = _row_mask(visibility != 0, p.ndim)
    mu = torch.where(v, b1 * exp_avg + (1 - b1) * g, exp_avg)
    nu = torch.where(v, b2 * exp_avg_sq + (1 - b2) * g * g, exp_avg_sq)
    step = -lr * mu / (torch.sqrt(nu) + eps)
    p.copy_(torch.where(v, p + step, p))
    exp_avg.copy_(mu)
    exp_avg_sq.copy_(nu)


def selective_adam_step(p: torch.Tensor, g: torch.Tensor,
                        exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                        visibility: torch.Tensor, lr: float, b1: float,
                        b2: float, eps: float) -> None:
    """One SelectiveAdam step of one group, in place on ``p``, ``exp_avg``
    and ``exp_avg_sq``. ``visibility`` is [N] over the group's leading dim
    (bool or uint8; nonzero means seen), ``lr`` the rate for this step."""
    if p.shape != g.shape or p.shape != exp_avg.shape or \
            p.shape != exp_avg_sq.shape:
        raise ValueError("selective_adam: p, g and the moments differ in "
                         "shape")
    if visibility.ndim != 1 or visibility.shape[0] != p.shape[0]:
        raise ValueError(f"selective_adam: visibility "
                         f"{tuple(visibility.shape)} for a group of "
                         f"{tuple(p.shape)}")
    if rv._on_cpu(p, "selective_adam"):
        selective_adam_plain(p, g, exp_avg, exp_avg_sq, visibility, lr, b1,
                             b2, eps)
        return
    dev = p.device
    # a gradient can be a strided view (sh0's is a slice of the colours'
    # gradient); the state is written in place and must be contiguous
    g = g.contiguous()
    for name, t in (("p", p), ("g", g), ("exp_avg", exp_avg),
                    ("exp_avg_sq", exp_avg_sq)):
        rv._check_cuda(f"selective_adam {name}", t, torch.float32, dev)
    if visibility.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"selective_adam: visibility dtype "
                         f"{visibility.dtype}, expected bool or uint8")
    rv._check_cuda("selective_adam visibility", visibility, visibility.dtype,
                   dev)
    n = p.numel()
    inner = n // p.shape[0] if p.shape[0] else 1
    err = native.lib().gsc_selective_adam(
        p.data_ptr(), g.data_ptr(), exp_avg.data_ptr(),
        exp_avg_sq.data_ptr(), visibility.data_ptr(), n, max(inner, 1),
        -lr, b1, 1 - b1, b2, 1 - b2, eps, rv._stream())
    native.check(err, "gsc_selective_adam")
    rv.LAUNCHES["selective_adam"] += 1


def selective_adam_bytes(p: torch.Tensor, visibility: torch.Tensor) -> int:
    """The bytes one step must move: the visibility read (a byte a row),
    and on the visible rows p, g, mu and nu read and p, mu and nu written
    (the rows left as they are need nothing else)."""
    inner = p.numel() // p.shape[0] if p.shape[0] else 0
    return 28 * inner * int((visibility != 0).sum()) + p.shape[0]
