"""GeS-TM (MPEG G-PCC) anchor pre- and post-processing (port of
gscodec_studio_tpu/compression/ges_tm.py): a splat model quantized into the
integer-attribute .ply that the G-PCC codec (tmc3) takes, and floats
rebuilt from a decoded one. The fixed mappings:

  * positions: sign(x) log1p(|x|), min/max-normalized to ``b_pos`` bits
    (the range saved to meta.npz);
  * opacity (logit): (x + 7) / 25 at ``b_attr`` bits;
  * scales (log): (x + 26) / 30;
  * rotations: (x + 1) / 2;
  * SH (DC and rest): RGB -> YUV (BT.601), then x / 8 + 0.5 per level.

``run_gpcc`` runs tmc3 where it is found (GES_TM_TMC3 or the PATH) and
returns None where it is not.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np

from gscodec_studio_tpu_torch.utils.ply import load_ply, save_ply

_RGB2YUV = np.array([[0.299, 0.587, 0.114],
                     [-0.14713, -0.28886, 0.436],
                     [0.615, -0.51498, -0.10001]], np.float64)
_YUV2RGB = np.array([[1.0, 0.0, 1.13983],
                     [1.0, -0.39465, -0.58060],
                     [1.0, 2.03211, 0.0]], np.float64)

# fixed normalization ranges (domain -> [0, 1])
_OP_OFF, _OP_SCALE = 7.0, 25.0
_SC_OFF, _SC_SCALE = 26.0, 30.0


def _quant(x01, bits):
    s = 2 ** bits
    return np.clip(np.round(x01 * s), 0, s - 1).astype(np.int64)


def _dequant(q, bits):
    return q.astype(np.float64) / (2 ** bits)


def _log_transform(x):
    return np.sign(x) * np.log1p(np.abs(x))


def _inv_log_transform(y):
    return np.sign(y) * np.expm1(np.abs(y))


def pre_process(splats: Dict[str, np.ndarray], out_dir: str,
                b_pos: int = 16, b_attr: int = 10) -> str:
    """Quantizes a splat dict (log scales, logit opacities, raw SH) into
    out_dir/quant_splats.ply and meta.npz; returns the ply's path."""
    os.makedirs(out_dir, exist_ok=True)
    means = _log_transform(np.asarray(splats["means"], np.float64))
    mins, maxs = means.min(axis=0), means.max(axis=0)
    span = np.where(maxs > mins, maxs - mins, 1.0)
    np.savez(os.path.join(out_dir, "meta.npz"), min_xyz=mins, max_xyz=maxs,
             bitwidth=b_pos, b_attr=b_attr)
    q = {"means": _quant((means - mins) / span, b_pos).astype(np.float32)}
    for k, off, sc in (("opacities", _OP_OFF, _OP_SCALE),
                       ("scales", _SC_OFF, _SC_SCALE),
                       ("quats", 1.0, 2.0)):
        q[k] = _quant((np.asarray(splats[k], np.float64) + off) / sc,
                      b_attr).astype(np.float32)
    for k in ("sh0", "shN"):
        yuv = np.asarray(splats[k], np.float64) @ _RGB2YUV.T
        q[k] = _quant(yuv / 8.0 + 0.5, b_attr).astype(np.float32)
    path = os.path.join(out_dir, "quant_splats.ply")
    save_ply(path, q)
    return path


def post_process(quant_ply: str, meta_path: Optional[str] = None
                 ) -> Dict[str, np.ndarray]:
    """Dequantizes a (decoded) GeS-TM ply back to float splats."""
    if meta_path is None:
        meta_path = os.path.join(os.path.dirname(quant_ply), "meta.npz")
    with np.load(meta_path) as meta:
        b_pos = int(meta["bitwidth"])
        b_attr = int(meta["b_attr"]) if "b_attr" in meta else 10
        mins, maxs = meta["min_xyz"], meta["max_xyz"]
    span = np.where(maxs > mins, maxs - mins, 1.0)
    q = load_ply(quant_ply)
    out = {"means": _inv_log_transform(
        _dequant(q["means"], b_pos) * span + mins).astype(np.float32)}
    for k, off, sc in (("opacities", _OP_OFF, _OP_SCALE),
                       ("scales", _SC_OFF, _SC_SCALE),
                       ("quats", 1.0, 2.0)):
        out[k] = (_dequant(q[k], b_attr) * sc - off).astype(np.float32)
    for k in ("sh0", "shN"):
        yuv = (_dequant(q[k], b_attr) - 0.5) * 8.0
        out[k] = (yuv @ _YUV2RGB.T).astype(np.float32)
    return out


# the attribute-qp ladder of the encoder_r04..r08 configurations
RATE_POINTS = {"r04": 24, "r05": 30, "r06": 36, "r07": 42, "r08": 48}


def find_tmc3() -> Optional[str]:
    return os.environ.get("GES_TM_TMC3") or shutil.which("tmc3")


def write_encoder_cfg(path: str, qp: int, bitdepth: int = 12) -> str:
    """A tmc3 encoder configuration with the ladder's knobs."""
    with open(path, "w") as f:
        f.write("mode: 0\n"
                "qtbtEnabled: 0\n"
                "trisoupNodeSize: 0\n"
                "convertPlyColourspace: 0\n"
                "mergeDuplicatedPoints: 1\n"
                "inferredDirectCodingMode: 0\n"
                "positionQuantizationScale: 1\n"
                "neighbourAvailBoundaryLog2: 8\n"
                "transformType: 0\n"
                "attrOffset: 0\n"
                "attrScale: 1\n"
                f"qp: {qp}\n"
                f"bitdepth: {bitdepth}\n"
                "qpChromaOffset: 4\n")
    return path


def run_gpcc(quant_ply: str, out_dir: str, rate_point: str = "r04"
             ) -> Optional[Tuple[str, int]]:
    """Encodes and decodes the quantized ply with tmc3: (decoded ply,
    stream bytes), or None where no tmc3 binary is found."""
    tmc3 = find_tmc3()
    if tmc3 is None:
        return None
    os.makedirs(out_dir, exist_ok=True)
    cfg = write_encoder_cfg(
        os.path.join(out_dir, f"encoder_{rate_point}.cfg"),
        RATE_POINTS[rate_point])
    stream = os.path.join(out_dir, f"{rate_point}.bin")
    decoded = os.path.join(out_dir, f"{rate_point}_decoded.ply")
    subprocess.run([tmc3, "-c", cfg, f"--uncompressedDataPath={quant_ply}",
                    f"--compressedStreamPath={stream}"],
                   check=True, capture_output=True)
    subprocess.run([tmc3, "--mode=1", f"--compressedStreamPath={stream}",
                    f"--reconstructedDataPath={decoded}"],
                   check=True, capture_output=True)
    return decoded, os.path.getsize(stream)
