"""The GeS-TM (G-PCC) anchor leg of the MPEG comparison (port of
examples/ges_tm_anchor.py): quantize a trained .ply, run tmc3 over the
rate ladder where a tmc3 binary is found (GES_TM_TMC3 or PATH, as
compression/ges_tm.find_tmc3 looks), dequantize, render the decoded model
from an orbit rig and report its PSNR against the uncompressed model and
its size; on the CUDA card unless ``--device cpu``:

    python -m gscodec_studio_tpu_torch.ges_tm_anchor --ply model.ply \
        [--rate-points r04 r06 r08]

Without tmc3 it says so and reports the quantization-only leg once (the
pre/post loss every rate point shares), as the JAX script does.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ply", required=True, help="trained Inria .ply")
    p.add_argument("--out", default="results/ges_tm")
    p.add_argument("--rate-points", nargs="*", default=["r04", "r06", "r08"])
    p.add_argument("--width", type=int, default=648)
    p.add_argument("--height", type=int, default=420)
    p.add_argument("--n-views", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def main(argv=None) -> list:
    """Runs as the command line says; returns the rows it writes to
    out/ges_tm_results.json."""
    args = build_parser().parse_args(argv)
    from gscodec_studio_tpu_torch.compression import ges_tm
    from gscodec_studio_tpu_torch.models.splats import from_jax_splats
    from gscodec_studio_tpu_torch.utils.ply import load_ply
    from gscodec_studio_tpu_torch.utils.ply_render import (orbit_cameras,
                                                           render_splats)

    splats = load_ply(args.ply)
    os.makedirs(args.out, exist_ok=True)
    qply = ges_tm.pre_process(splats, args.out)
    base_bytes = os.path.getsize(qply)
    cams = orbit_cameras(splats["means"], args.n_views, args.width,
                         args.height)

    def render(s):
        model = from_jax_splats(s, device=args.device)
        return [img.cpu().numpy() for img, _, _ in render_splats(model,
                                                                  cams)]

    def psnr_between(a, b):
        mse = float(np.mean((a - b) ** 2))
        return 10.0 * np.log10(1.0 / max(mse, 1e-12))

    ref_imgs = render(splats)
    if ges_tm.find_tmc3() is None:
        print("ges_tm_anchor: no tmc3 binary (GES_TM_TMC3 or PATH): the "
              "quantization-only leg alone", flush=True)
    rows = []
    for rp in args.rate_points:
        dec = ges_tm.run_gpcc(qply, args.out, rp)
        if dec is None:
            out = ges_tm.post_process(qply)
            size = base_bytes
            tag = f"{rp} (quant-only; tmc3 unavailable)"
        else:
            out = ges_tm.post_process(dec[0],
                                      os.path.join(args.out, "meta.npz"))
            size, tag = dec[1], rp
        ps = float(np.mean([psnr_between(a, b)
                            for a, b in zip(ref_imgs, render(out))]))
        rows.append({"rate_point": tag, "psnr_vs_uncompressed": round(ps, 3),
                     "size_bytes": int(size)})
        print(json.dumps(rows[-1]), flush=True)
        if dec is None:
            break  # every rate point is the same quantization-only leg
    with open(os.path.join(args.out, "ges_tm_results.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
