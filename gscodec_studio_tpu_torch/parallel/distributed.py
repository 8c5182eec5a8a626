"""Gaussian-sharded rendering and training over ``torch.distributed`` (port
of gscodec_studio_tpu/parallel/distributed.py, "Grendel-style" data
parallelism, arXiv:2406.18533).

One process a rank, each holding one contiguous shard of the Gaussians:
rank r owns rows [r * N / G, (r + 1) * N / G) of every per-Gaussian tensor
(parameters, Adam moments, strategy statistics), and the cameras are split
the same way, C / G a rank. A step projects the rank's Gaussians for ALL
cameras, then one ``all_to_all`` re-partitions the projected attributes
from camera-major to Gaussian-major, [C, N/G, F] -> [C/G, N, F], and each
rank rasterizes its own cameras through the fused pipeline
(ops/raster_v2.py: B9a, B3, B1 forward; B2, B9b, B4 backward). The
exchange is an autograd Function: its backward is the reverse exchange of
the gradient, so gradients reach the remote shards' Gaussians.

``exchange_cap`` switches the dense exchange to the capacity-bounded one:
each rank ships a destination only the Gaussians visible in that
destination's cameras, visible first, at most ``exchange_cap`` of them;
visible rows past the cap are dropped (radii 0) and counted.

Every projected attribute of a rank rides ONE collective: the float rows
(and the radii, exact as floats below 2^24) are concatenated along the
last axis before the exchange and split after it.

A ``Mesh`` names the group, the rank, the world size and the rank's device;
its collectives take the device's tensors (NCCL, or gloo, which takes CUDA
tensors too).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device
from gscodec_studio_tpu_torch.models.splats import splat_activations
from gscodec_studio_tpu_torch.optimizers.builders import apply_updates
from gscodec_studio_tpu_torch.ops.raster_v2 import rasterize_to_pixels_v2
from gscodec_studio_tpu_torch.rendering import project_and_shade
from gscodec_studio_tpu_torch.training.losses import combined_loss

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks; this process is ``rank`` and computes
    on ``device``; ``group`` is the world group it was built over (None
    without one). A mesh of size 1 needs no process group: without one,
    its collectives return their input (with one, they run on it)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    @property
    def solo(self) -> bool:
        """One rank and no process group: nothing to communicate."""
        return self.size == 1 and not (dist.is_available()
                                       and dist.is_initialized())

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block g of ``x`` (x.shape[0] / size rows) goes to rank g; block
        s of the result came from rank s."""
        if self.solo:
            return x
        src = x.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: ``x`` reduced over the ranks by "sum", "max" or
        "min"."""
        buf = x.detach().clone()
        if not self.solo:
            dist.all_reduce(buf, op=_OPS[op], group=self.group)
        return buf

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated along axis 0 in rank order (every
        rank's x has the same shape)."""
        if self.solo:
            return x.detach().clone()
        src = x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, 0)

    def barrier(self) -> None:
        if not self.solo:
            dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """The mesh of the initialised (world) process group; without one, the
    single-rank mesh. ``n_devices``, when given, must be the group's size.
    ``device`` None means the card this rank uses (cuda:LOCAL_RANK under
    torchrun, else the current card)."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks needs a process group "
                         f"of that size; this process's has {size}")
    if device is None:
        dev = resolve_device(None)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = resolve_device(device)
    return Mesh(rank, size, dev, group)


def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of ``x`` (x.shape[0] divisible by the
    mesh size)."""
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n]


class _Exchange(torch.autograd.Function):
    """mesh.all_to_all with autograd: the exchange is its own transpose
    (the gradient of the block that rank s sent comes back to rank s)."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return mesh.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh.all_to_all(g.contiguous())


def _exchange(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The dense exchange [C, Nl, F] -> [C/G, N, F]: camera block g goes to
    rank g, and the received blocks are concatenated on axis 1 in source-rank
    order (all_to_all tiled=True)."""
    G = mesh.size
    C, Nl, F = x.shape
    y = _Exchange.apply(mesh, x)  # [G_src * Cl, Nl, F]
    return y.reshape(G, C // G, Nl, F).transpose(0, 1).reshape(
        C // G, G * Nl, F)


def _exchange_bucketed(mesh: Mesh, x: torch.Tensor, radii: torch.Tensor,
                       exchange_cap: int):
    """The capacity-bounded exchange. ``x`` [C, Nl, F] rows, ``radii``
    [C, Nl] the scalar radii. For each destination rank d, the rank's
    Gaussians visible (radius > 0) in any of d's cameras come first, in a
    stable order, and the first cap = min(exchange_cap, Nl) of them ship
    for each of d's cameras; the radii of rows kept past the visible ones
    are zeroed. Returns (rows [C/G, G * cap, F] source-major, radii
    [C/G, G * cap], diagnostics of this rank: ``overflow``, the visible
    rows past the cap summed over destinations, ``sent_rows`` and
    ``dense_rows``)."""
    G = mesh.size
    C, Nl, F = x.shape
    Cl = C // G
    cap = min(exchange_cap, Nl)
    vis = (radii > 0).reshape(G, Cl, Nl).any(1)  # [G, Nl] visible for dest
    order = torch.sort((~vis).to(torch.int32), dim=1,
                       stable=True).indices[:, :cap]  # [G, cap]
    kept_vis = vis.gather(1, order)
    overflow = torch.clamp(vis.sum(1) - cap, min=0).sum()
    idx = order[:, None, :].expand(G, Cl, cap)
    packed = x.reshape(G, Cl, Nl, F).gather(
        2, idx[..., None].expand(G, Cl, cap, F))  # differentiable gather
    radii_p = radii.reshape(G, Cl, Nl).gather(2, idx)
    radii_p = torch.where(kept_vis[:, None, :], radii_p,
                          torch.zeros_like(radii_p))
    # the radii ride the same collective as one more float column
    y = _Exchange.apply(mesh, torch.cat(
        [packed, radii_p[..., None].to(packed.dtype)], -1))
    y = y.reshape(G, Cl, cap, F + 1).transpose(0, 1).reshape(
        Cl, G * cap, F + 1)
    diag = {"overflow": overflow,
            "sent_rows": torch.tensor(G * Cl * cap, device=x.device),
            "dense_rows": torch.tensor(C * Nl, device=x.device)}
    return y[..., :F], y[..., F].round().to(torch.int32), diag


def _pack(tree: List[Tuple[str, torch.Tensor]], C: int, Nl: int):
    """The tree's [C, Nl, ...] leaves as one [C, Nl, F] float tensor and
    the (name, width, trailing shape) of each."""
    cols, layout = [], []
    for name, t in tree:
        flat = t.reshape(C, Nl, -1).to(torch.float32)
        cols.append(flat)
        layout.append((name, flat.shape[-1], t.shape[2:], t.dtype))
    return torch.cat(cols, -1), layout


def _unpack(y: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    out, lo = {}, 0
    C, N = y.shape[:2]
    for name, width, trailing, dtype in layout:
        v = y[..., lo:lo + width].reshape((C, N) + tuple(trailing))
        if not dtype.is_floating_point:
            v = v.round().to(dtype)
        out[name] = v
        lo += width
    return out


def _exchanged(mesh: Mesh, tree, radii, exchange_cap):
    """The tree [(name, [C, Nl, ...])] exchanged (dense, or bucketed by the
    scalar ``radii`` [C, Nl]) -> ({name: [C/G, N', ...]}, radii [C/G, N'],
    diagnostics). The dense exchange carries the radii as a leaf."""
    C, Nl = radii.shape
    if exchange_cap is None:
        x, layout = _pack(tree + [("radii", radii)], C, Nl)
        ex = _unpack(_exchange(mesh, x), layout)
        n = torch.tensor(radii.numel(), device=radii.device)
        diag = {"overflow": torch.zeros((), dtype=torch.int64,
                                        device=radii.device),
                "sent_rows": n, "dense_rows": n}
        radii_ex = ex.pop("radii")
    else:
        x, layout = _pack(tree, C, Nl)
        y, radii_ex, diag = _exchange_bucketed(mesh, x, radii, exchange_cap)
        ex = _unpack(y, layout)
    diag["exchange_bytes"] = diag["sent_rows"] * (x.shape[-1] + (
        exchange_cap is not None)) * 4
    return ex, radii_ex, diag


def sharded_rasterization(
    mesh: Mesh,
    means, quats, scales, opacities,  # the rank's shard [Nl, ...]
    colors,  # [Nl, K, 3] SH coefficients (sh_degree given) or [C, Nl, ch]
    viewmats,  # [C, 4, 4] ALL cameras (C divisible by the mesh size)
    Ks,
    width: int,
    height: int,
    sh_degree: Optional[int],
    isect_capacity: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    tile_size: int = 16,
    backgrounds=None,  # [C, ch], every camera's
    means2d_probe=None,  # [C, Nl, 2] zeros
    absgrad_probe=None,  # [C, Nl, 2] zeros
    exchange_cap: Optional[int] = None,
    antialiased: bool = False,
    cutoff_mode: str = "soft",
    grad_dtype: str = "f32",
    attr_dtype: str = "f32",
    log_composite: bool = False,
    render_mode: str = "RGB",
    elliptical: bool = True,
):
    """The trainer's sharded render on the fused backend: projects the
    rank's shard for all C cameras (per-axis radii with ``elliptical``,
    culled at opacity 1/255), exchanges the projected rows, and rasterizes
    the rank's C/G cameras. Returns ([C/G, H, W, ch], alphas, meta): meta
    carries the rank's per-Gaussian radii [C, Nl] (the scalar radius),
    width, height, n_cameras = C, n_isects (the largest over the ranks) and
    the exchange's diagnostics (this rank's). The probes' gradients are
    dL/d means2d and the |per-pixel| sums, as in rendering.rasterization.
    ``render_mode`` "RGB+ED" adds the expected depth channel, with a zero
    background and divided by the alpha."""
    if render_mode not in ("RGB", "RGB+ED"):
        raise ValueError(f"unknown render_mode {render_mode!r}")
    C = viewmats.shape[0]
    G = mesh.size
    if C % G:
        raise ValueError(f"{C} cameras do not split over {G} ranks")
    Cl = C // G
    (radii2, means2d, depths, conics, cols, opac_cn, _) = project_and_shade(
        means, quats, scales, opacities, colors, viewmats, Ks, width, height,
        near_plane=near_plane, far_plane=far_plane, sh_degree=sh_degree,
        antialiased=antialiased, elliptical=elliptical)
    radii = radii2.amax(-1) if elliptical else radii2
    if means2d_probe is not None:
        means2d = means2d + means2d_probe
    if render_mode == "RGB+ED":
        cols = torch.cat([cols, depths[..., None]], -1)
    tree = [("means2d", means2d), ("depths", depths), ("conics", conics),
            ("colors", cols), ("opacities", opac_cn)]
    if elliptical:
        tree.append(("radii2", radii2))
    if absgrad_probe is not None:
        tree.append(("ag", absgrad_probe))
    ex, radii_ex, diag = _exchanged(mesh, tree, radii, exchange_cap)
    if elliptical:
        # dropped and padding rows must not bin: zero their boxes too
        r_ex = torch.where((radii_ex > 0)[..., None], ex["radii2"],
                           torch.zeros_like(ex["radii2"]))
    else:
        r_ex = radii_ex
    bg_l = None
    if backgrounds is not None:
        bg_l = torch.as_tensor(backgrounds, dtype=torch.float32,
                               device=means.device)[mesh.rank * Cl:
                                                    (mesh.rank + 1) * Cl]
        if render_mode == "RGB+ED":
            bg_l = torch.cat([bg_l, torch.zeros((Cl, 1), device=bg_l.device)],
                             -1)
    img, alp, vmeta = rasterize_to_pixels_v2(
        ex["means2d"], ex["conics"], ex["colors"], ex["opacities"],
        ex["depths"], r_ex, width, height, tile_size=tile_size,
        isect_capacity=isect_capacity, backgrounds=bg_l,
        absgrad_probe=ex.get("ag"), cutoff_mode=cutoff_mode,
        grad_dtype=grad_dtype, attr_dtype=attr_dtype,
        log_composite=log_composite, device=means.device)
    if render_mode == "RGB+ED":
        img = torch.cat([img[..., :-1],
                         img[..., -1:] / torch.clamp(alp, min=1e-10)], -1)
    meta = dict(radii=radii, width=width, height=height, n_cameras=C,
                n_isects=mesh.all_reduce(vmeta["n_isects"], "max"),
                exchange_overflow=diag["overflow"],
                exchange_sent_rows=diag["sent_rows"],
                exchange_dense_rows=diag["dense_rows"],
                exchange_bytes=diag["exchange_bytes"])
    return img, alp, meta


def rasterize_sharded(mesh: Mesh, means, quats, scales, opacities, sh_coeffs,
                      viewmats, Ks, width: int, height: int, sh_degree: int,
                      isect_capacity: int, near_plane: float = 0.01,
                      far_plane: float = 1e10, tile_size: int = 16,
                      backgrounds=None, exchange_cap: Optional[int] = None,
                      cutoff_mode: str = "exact", grad_dtype: str = "f32"):
    """The render path's sharded rasterization: the scalar radius (as the
    JAX package's rasterize_sharded bins), the exact cutoff by default.
    Returns this rank's ([C/G, H, W, 3] renders, alphas, diagnostics:
    overflow, sent_rows, dense_rows, exchange_bytes of this rank)."""
    img, alp, meta = sharded_rasterization(
        mesh, means, quats, scales, opacities, sh_coeffs, viewmats, Ks,
        width, height, sh_degree, isect_capacity, near_plane=near_plane,
        far_plane=far_plane, tile_size=tile_size, backgrounds=backgrounds,
        exchange_cap=exchange_cap, cutoff_mode=cutoff_mode,
        grad_dtype=grad_dtype, elliptical=False)
    diag = {k: meta["exchange_" + k] for k in (
        "overflow", "sent_rows", "dense_rows", "bytes")}
    return img, alp, diag


def distributed_render(mesh: Mesh, splats: Dict[str, torch.Tensor],
                       viewmats, Ks, width: int, height: int,
                       sh_degree: int = 3, isect_capacity: int = 1 << 20,
                       exchange_cap: Optional[int] = None) -> torch.Tensor:
    """Renders the Gaussians sharded over the mesh (``splats``: this rank's
    rows) from every camera ([C, 4, 4], C divisible by the mesh size); each
    rank renders its C/G. Returns [C, H, W, 3], gathered on every rank."""
    dev = mesh.device
    vm = torch.as_tensor(viewmats, dtype=torch.float32, device=dev)
    K = torch.as_tensor(Ks, dtype=torch.float32, device=dev)
    with torch.no_grad():
        means, quats, scales, opac = splat_activations(splats)
        shs = torch.cat([splats["sh0"], splats["shN"]], 1)
        img, _, _ = rasterize_sharded(mesh, means, quats, scales, opac, shs,
                                      vm, K, width, height, sh_degree,
                                      isect_capacity,
                                      exchange_cap=exchange_cap)
    return mesh.all_gather(img)


def distributed_train_step(mesh: Mesh, splats: Dict[str, torch.Tensor],
                           opt_states, groups, images, viewmats, Ks,
                           sh_degree: int = 3, isect_capacity: int = 1 << 20,
                           ssim_lambda: float = 0.2,
                           exchange_cap: Optional[int] = None):
    """One training step over the mesh: the sharded render of this rank's
    cameras (``images`` [C, H, W, 3] holds every camera's target; the rank
    reads its C/G), the combined loss, whose mean over the ranks is the
    step's loss, the backward through the exchange (each rank's gradients
    are those of that mean on its own rows), and each rank's Adam
    (optimizers.builders) on its own shard. Returns (splats, opt_states,
    loss, diagnostics: overflow, sent_rows, dense_rows, exchange_bytes,
    the largest over the ranks)."""
    dev = mesh.device
    vm = torch.as_tensor(viewmats, dtype=torch.float32, device=dev)
    K = torch.as_tensor(Ks, dtype=torch.float32, device=dev)
    target = shard_rows(mesh, torch.as_tensor(images, dtype=torch.float32,
                                              device=dev))
    H, W = target.shape[1:3]
    params = {k: v.detach().requires_grad_(True) for k, v in splats.items()}
    means, quats, scales, opac = splat_activations(params)
    shs = torch.cat([params["sh0"], params["shN"]], 1)
    img, _, diag = rasterize_sharded(mesh, means, quats, scales, opac, shs,
                                     vm, K, W, H, sh_degree, isect_capacity,
                                     exchange_cap=exchange_cap)
    local = combined_loss(img, target, ssim_lambda)
    names = list(params)
    grads = torch.autograd.grad(local / mesh.size,
                                [params[k] for k in names],
                                allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(names, grads)}
    loss = mesh.all_reduce(local.detach()) / mesh.size
    diag = {k: mesh.all_reduce(v.detach(), "max") for k, v in diag.items()}
    new_params, new_states = apply_updates(
        groups, opt_states, {k: v.detach() for k, v in params.items()},
        grads)
    return new_params, new_states, loss, diag
