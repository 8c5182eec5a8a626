"""The operating curve of the capacity-bounded exchange's drop policy
(port of examples/exchange_cap_sweep.py), on the CUDA card unless
``--device cpu``:

    python -m gscodec_studio_tpu_torch.exchange_cap_sweep \
        --splats results/garden_ab_f32/splats_final.npz \
        --caps 8192 16384 32768 65536 --mesh 8

parallel/distributed.py's bucketed exchange ships each destination rank,
from each source rank, at most ``exchange_cap`` Gaussians, the visible
ones first; visible rows past the cap are dropped (radii 0: no
contribution, no gradient). This simulates that rule in one process for G
contiguous shards of a trained model and G contiguous camera groups, and
reports for each cap the renders' PSNR against the uncapped renders, the
exchange's volume sent_rows / dense_rows and the dropped visible rows. The
views are an orbit rig around the model's live Gaussians
(utils/ply_render.orbit_cameras; the JAX script takes the garden
benchmark's arc). Only destination groups that own cameras count: with
fewer cameras than ranks the trailing groups own none and ship nothing
(the JAX script counts them in sent_rows).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--splats", required=True,
                   help="a splat npz (flat keys) or a trainer checkpoint "
                   "(splats/<name> keys)")
    p.add_argument("--caps", type=int, nargs="*",
                   default=[8192, 16384, 32768, 65536])
    p.add_argument("--mesh", type=int, default=8, help="simulated G shards")
    p.add_argument("--n_views", type=int, default=8)
    p.add_argument("--width", type=int, default=1297)
    p.add_argument("--height", type=int, default=840)
    p.add_argument("--isect_capacity", type=int, default=6 << 20)
    p.add_argument("--out", default="results/exchange_cap_sweep.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def load_splats(path: str, dev) -> dict:
    with np.load(path) as z:
        d = {k.removeprefix("splats/"): z[k] for k in z.files
             if k.startswith("splats/") or "/" not in k}
    d.pop("step", None)
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in d.items()}


def sweep(splats: dict, caps, G: int, n_views: int, width: int,
          height: int, isect_capacity: int = 6 << 20) -> dict:
    """The sweep's rows for the splat dict (log scales, logit opacities)."""
    from gscodec_studio_tpu_torch.models.splats import (num_live,
                                                        splat_activations)
    from gscodec_studio_tpu_torch.ops.projection import (
        fully_fused_projection)
    from gscodec_studio_tpu_torch.rendering import rasterization
    from gscodec_studio_tpu_torch.training.losses import psnr
    from gscodec_studio_tpu_torch.utils.ply_render import orbit_cameras

    dev = splats["means"].device
    with torch.no_grad():
        means, quats, scales, opac = splat_activations(splats)
    colors = torch.cat([splats["sh0"], splats["shN"]], 1)
    N = means.shape[0]
    Nl = -(-N // G)  # contiguous shards, as the mesh Runner lays them
    live = (torch.sigmoid(splats["opacities"]) > 0.005).cpu().numpy()
    cams = orbit_cameras(splats["means"].cpu().numpy()[live], n_views,
                         width, height)
    vms = torch.as_tensor(np.stack([np.linalg.inv(c["camtoworld"])
                                    for c in cams]), device=dev)
    Ks = torch.as_tensor(np.stack([c["K"] for c in cams]), device=dev)
    C = n_views
    Cl = -(-C // G)
    with torch.no_grad():
        radii, *_ = fully_fused_projection(means, None, quats, scales, vms,
                                           Ks, width, height,
                                           opacities=opac)
        radii = (radii * (opac[None] >= 1.0 / 255.0)).cpu().numpy()

    def render(cams_, mask):
        with torch.no_grad():
            img, _, _ = rasterization(
                means, quats, scales, opac * mask, colors, vms[cams_],
                Ks[cams_], width, height, sh_degree=3,
                isect_capacity=isect_capacity, device=dev)
        return torch.clamp(img, 0.0, 1.0)

    # groups past the cameras own none: they render and ship nothing
    groups = {g: slice(g * Cl, min((g + 1) * Cl, C)) for g in range(G)
              if g * Cl < C}
    full = {g: render(cs, torch.ones(N, device=dev))
            for g, cs in groups.items()}
    rows = []
    for cap in caps:
        t0 = time.time()
        keep = np.zeros((G, N), bool)  # [destination, Gaussian]
        dropped = 0
        for g, cs in groups.items():
            vis = (radii[cs] > 0).any(axis=0)
            for sg in range(G):
                sl = slice(sg * Nl, min((sg + 1) * Nl, N))
                v = vis[sl]
                # visible first, stable, the first cap kept: the exchange's
                # own rule
                k = np.zeros(v.shape, bool)
                k[np.argsort(~v, kind="stable")[:cap]] = True
                keep[g, sl] = k & v
                dropped += int(v.sum() - (k & v).sum())
        psnrs = [float(psnr(render(cs, torch.as_tensor(
            keep[g], dtype=torch.float32, device=dev)), full[g]))
            for g, cs in groups.items()]
        sent = sum(cs.stop - cs.start for cs in groups.values()) * G * cap
        rows.append({
            "exchange_cap": cap,
            "psnr_vs_uncapped": float(np.mean(psnrs)),
            "sent_over_dense": sent / (C * N),
            "dropped_visible_rows": dropped,
            "visible_rows": int((radii > 0).any(axis=0).sum()),
            "seconds": time.time() - t0})
        print(json.dumps(rows[-1]), flush=True)
    return {"n_gaussians": int(N), "live": num_live(splats), "mesh": G,
            "n_views": C, "live_groups": len(groups), "rows": rows}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from gscodec_studio_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    out = sweep(load_splats(args.splats, dev), args.caps, args.mesh,
                args.n_views, args.width, args.height, args.isect_capacity)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
