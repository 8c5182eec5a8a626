"""The rANS test-time codec (port of
gscodec_studio_tpu/compression/entropy_coding.py): the PNG pipeline, but
the attributes that the training-time simulation quantizes (scales,
quats, opacities, sh0) are coded with rANS as per-channel 8-bit symbols
on the simulation's bounds, against one of three kinds of table:

  * histograms, quantized and shipped beside the stream
    (``<name>_freqs.npy``);
  * the learned factorized entropy model's PMF on the symbol grid: only
    the model's parameters ship (``<name>_model.pkl``);
  * the hash-grid Gaussian model's context tables: each symbol is coded
    against the (mean, log-scale) bin that the model regresses from its
    decoded position, and only the binarized model ships
    (``<name>_gmodel.pkl``).

The files and the meta are the JAX package's, and the coder is the same
C++ source built with the same flags (native.py): each package decodes
the other's directories. Encoder and decoder must derive identical
tables and contexts, whatever the device of the models and of the
k-means: the factorized tables are computed in numpy with the JAX
package's float32 bits (f32_math.factorized_likelihood_table), the
Gaussian model's means and scales always on the CPU.

Every pickle of a stream is read by a restricted unpickler: numpy's array
reconstruction, the builtin containers and scalars, and the hash grid's
config, whose JAX class path (which the JAX package writes) maps onto
the port's own HashGridCfg. The port writes that same class path, so the
JAX package reads the port's Gaussian-context streams too.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from gscodec_studio_tpu_torch.compression import codecs, f32_math, native
from gscodec_studio_tpu_torch.compression.outlier_filter import filter_splats
from gscodec_studio_tpu_torch.compression.sort import sort_splats
from gscodec_studio_tpu_torch.compression_sim.hash_grid import (
    HashGridCfg, gaussian_conditional_apply)
# the simulation's tables: train-time fake quantization matches the codec
from gscodec_studio_tpu_torch.compression_sim.simulation import (BOUNDS,
                                                                 Q_BITWIDTH)
from gscodec_studio_tpu_torch.device import DeviceLike

TABLE_DEVICE = torch.device("cpu")  # where the Gaussian contexts are made

# the class path the JAX package's pickles name for the hash grid's config
_JAX_CFG = ("gscodec_studio_tpu.compression_sim.hash_grid", "HashGridCfg")
_PORT_CFG = (HashGridCfg.__module__, HashGridCfg.__qualname__)
_SAFE_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    ("_codecs", "encode"),  # bytes below pickle protocol 3
} | {("builtins", n) for n in ("bytearray", "set", "frozenset", "complex")}


class _StreamUnpickler(pickle.Unpickler):
    """Admits numpy arrays, builtin containers and scalars, and the hash
    grid's config (as the port's class); refuses any other global."""

    def find_class(self, module, name):
        if (module, name) in (_JAX_CFG, _PORT_CFG):
            return HashGridCfg
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the stream names {module}.{name}, which is not admitted")


def load_stream_pickle(path: str):
    """Read one of a stream's pickles with the restricted unpickler."""
    with open(path, "rb") as fh:
        return _StreamUnpickler(fh).load()


class _GmodelPickler(pickle._Pickler):
    """The pure-Python pickler, naming the hash grid's config by the JAX
    package's class path (without importing it), so that either package
    reads the file."""

    def save_global(self, obj, name=None):
        if obj is not HashGridCfg:
            return super().save_global(obj, name)
        self.save(_JAX_CFG[0])
        self.save(_JAX_CFG[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _dump_gmodel(path: str, obj) -> None:
    with open(path, "wb") as fh:
        _GmodelPickler(fh, protocol=4).dump(obj)


def _symbols(arr2d: np.ndarray, lo, hi, bits):
    nsym = 2**bits
    q_step = (hi - lo) / (nsym - 1)
    symbols = np.clip(
        np.round((np.clip(arr2d, lo, hi) - lo) / q_step), 0, nsym - 1
    ).astype(np.uint8)
    return symbols, nsym, q_step


def _write_blobs(compress_dir, name, blobs) -> None:
    with open(os.path.join(compress_dir, f"{name}.ans"), "wb") as fh:
        for b in blobs:
            fh.write(len(b).to_bytes(8, "little"))
            fh.write(b)


def _read_blobs(compress_dir, name, C):
    with open(os.path.join(compress_dir, f"{name}.ans"), "rb") as fh:
        for _ in range(C):
            ln = int.from_bytes(fh.read(8), "little")
            yield fh.read(ln)


def _as_cpu_tree(tree):
    """A parameter tree (dicts and lists of arrays or tensors) as float32
    tensors on TABLE_DEVICE."""
    if isinstance(tree, dict):
        return {k: _as_cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_cpu_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(TABLE_DEVICE, torch.float32)
    return torch.as_tensor(np.array(tree, np.float32), device=TABLE_DEVICE)


def factorized_freqs(params, nsym: int, q_step: float,
                     lo: float) -> np.ndarray:
    """The factorized model's coding tables [C, nsym] (uint32, each row
    summing to 2^14): its PMF on the symbol grid with the JAX package's
    float32 bits, times 1e9 in float32, quantized."""
    host = {k: [_as_cpu_tree(x).numpy() for x in v]
            for k, v in params.items()}
    probs = f32_math.factorized_likelihood_table(host, nsym, q_step, lo)
    return np.stack([
        native.quantize_freqs(np.maximum((p * 1e9).astype(np.uint64), 1))
        for p in probs])


def _encode_attr_ans(compress_dir, name, arr2d, lo, hi, bits,
                     entropy_params=None) -> Dict:
    """arr2d [N, C] -> per-channel rANS streams against histograms (shipped)
    or the factorized model's tables (its parameters shipped)."""
    n, C = arr2d.shape
    symbols, nsym, q_step = _symbols(arr2d, lo, hi, bits)
    if entropy_params is not None:
        freqs = factorized_freqs(entropy_params, nsym, q_step, lo)
        with open(os.path.join(compress_dir, f"{name}_model.pkl"),
                  "wb") as fh:
            pickle.dump({k: [_as_cpu_tree(x).numpy() for x in v]
                         for k, v in entropy_params.items()}, fh)
    else:
        freqs = np.stack([native.quantize_freqs(np.bincount(
            symbols[:, c], minlength=nsym).astype(np.uint64))
            for c in range(C)])
        np.save(os.path.join(compress_dir, f"{name}_freqs.npy"), freqs)
    _write_blobs(compress_dir, name, [native.rans_encode(symbols[:, c],
                                                         freqs[c])
                                      for c in range(C)])
    return {
        "kind": "ans", "n": n, "channels": C, "bits": bits, "lo": lo,
        "hi": hi, "model": entropy_params is not None,
    }


def _decode_attr_ans(compress_dir, name, meta) -> np.ndarray:
    n, C, bits = meta["n"], meta["channels"], meta["bits"]
    lo, hi = meta["lo"], meta["hi"]
    nsym = 2**bits
    q_step = (hi - lo) / (nsym - 1)
    if meta["model"]:
        params = load_stream_pickle(os.path.join(compress_dir,
                                                 f"{name}_model.pkl"))
        freqs = factorized_freqs(params, nsym, q_step, lo)
    else:
        freqs = np.load(os.path.join(compress_dir, f"{name}_freqs.npy"))
    out = np.zeros((n, C), np.float32)
    for c, blob in enumerate(_read_blobs(compress_dir, name, C)):
        syms = native.rans_decode(blob, freqs[c], n)
        out[:, c] = syms.astype(np.float32) * q_step + lo
    return out


def _gauss_ctx_freqs(lo, hi, nsym, q_step, n_mu, n_sig):
    """One rANS table per (mu bin, log-sigma bin) of the discretized
    Gaussian, in float64 on the host: derived alike on both sides, so only
    the binarized model ships."""
    sig_lo, sig_hi = q_step * 0.25, (hi - lo)
    mu_c = np.linspace(lo, hi, n_mu)
    sig_c = np.exp(np.linspace(math.log(sig_lo), math.log(sig_hi), n_sig))
    v = lo + np.arange(nsym, dtype=np.float64) * q_step
    erf = np.vectorize(math.erf)

    def cdf(x):
        return 0.5 * (1.0 + erf(x / math.sqrt(2.0)))

    rows = np.empty((n_mu * n_sig, nsym), np.uint32)
    for i, mu in enumerate(mu_c):
        for j, sg in enumerate(sig_c):
            up = cdf((v + 0.5 * q_step - mu) / sg)
            dn = cdf((v - 0.5 * q_step - mu) / sg)
            p = up - dn
            p[0] += dn[0]  # fold the tails into the edge symbols
            p[-1] += 1.0 - up[-1]
            rows[i * n_sig + j] = native.quantize_freqs(
                np.maximum((p * 1e9).astype(np.uint64), 1))
    return rows, (sig_lo, sig_hi)


def _gauss_ctx_ids(mean, scale, lo, hi, sig_lo, sig_hi, n_mu, n_sig):
    mu_idx = np.clip(
        np.round((mean - lo) / (hi - lo) * (n_mu - 1)), 0, n_mu - 1
    ).astype(np.int64)
    s = np.clip(scale, sig_lo, sig_hi)
    sig_idx = np.clip(
        np.round(
            (np.log(s) - np.log(sig_lo))
            / (np.log(sig_hi) - np.log(sig_lo)) * (n_sig - 1)
        ),
        0, n_sig - 1,
    ).astype(np.int64)
    return (mu_idx * n_sig + sig_idx).astype(np.uint16)


def _pack_gauss_model(params) -> Dict:
    """The binarized export: the grids as sign bits (the model is trained
    through the STE sign, so +-1 tables reproduce its inference)."""
    def host(x):
        return _as_cpu_tree(x).numpy()

    return {
        "grid3d_bits": np.packbits(host(params["grid3d"]) >= 0),
        "grid3d_shape": tuple(params["grid3d"].shape),
        "planes_bits": [np.packbits(host(p) >= 0) for p in params["planes"]],
        "planes_shape": tuple(params["planes"][0].shape),
        "mlp": [{k: host(v) for k, v in layer.items()}
                for layer in params["mlp"]],
    }


def _unpack_gauss_model(packed) -> Dict:
    def bits_to_pm1(bits, shape):
        n = int(np.prod(shape))
        return torch.as_tensor(
            (np.unpackbits(bits)[:n].astype(np.float32) * 2.0 - 1.0)
            .reshape(shape), device=TABLE_DEVICE)

    return {
        "grid3d": bits_to_pm1(packed["grid3d_bits"], packed["grid3d_shape"]),
        "planes": [bits_to_pm1(b, packed["planes_shape"])
                   for b in packed["planes_bits"]],
        "mlp": [{k: torch.as_tensor(np.asarray(v, np.float32),
                                    device=TABLE_DEVICE)
                 for k, v in layer.items()} for layer in packed["mlp"]],
    }


def gauss_mean_scale(params, cfgs, positions: np.ndarray):
    """The Gaussian model's (mean, scale) [N, C] at the normalized
    positions, read through the sign (binarize), on the CPU."""
    with torch.no_grad():
        mean, scale = gaussian_conditional_apply(
            _as_cpu_tree(params), tuple(cfgs),
            torch.as_tensor(positions, device=TABLE_DEVICE), binarize=True)
    return mean.numpy(), scale.numpy()


def _encode_attr_ans_gauss(compress_dir, name, arr2d, lo, hi, bits, payload,
                           positions, n_mu=48, n_sig=16) -> Dict:
    """Context rANS against the position-conditioned Gaussian model: a
    symbol's context is the (mu, sigma) bin the model gives at its decoded
    position; only the binarized model ships."""
    params, cfgs = payload
    n, C = arr2d.shape
    symbols, nsym, q_step = _symbols(arr2d, lo, hi, bits)
    packed = _pack_gauss_model(params)
    # the shipped +-1 model, as the decoder reads it
    mean, scale = gauss_mean_scale(_unpack_gauss_model(packed), cfgs,
                                   positions)
    freqs, (sig_lo, sig_hi) = _gauss_ctx_freqs(lo, hi, nsym, q_step, n_mu,
                                               n_sig)
    blobs = []
    for c in range(C):
        ctx = _gauss_ctx_ids(mean[:, c], scale[:, c], lo, hi, sig_lo,
                             sig_hi, n_mu, n_sig)
        blobs.append(native.rans_encode_ctx(symbols[:, c], ctx, freqs))
    _write_blobs(compress_dir, name, blobs)
    cfg3d, cfg2d, channel = cfgs
    _dump_gmodel(os.path.join(compress_dir, f"{name}_gmodel.pkl"),
                 {"packed": packed,
                  "cfgs": (HashGridCfg(*cfg3d), HashGridCfg(*cfg2d),
                           int(channel))})
    return {
        "kind": "ans_gauss", "n": n, "channels": C, "bits": bits,
        "lo": lo, "hi": hi, "n_mu": n_mu, "n_sig": n_sig,
    }


def _decode_attr_ans_gauss(compress_dir, name, meta,
                           positions) -> np.ndarray:
    n, C, bits = meta["n"], meta["channels"], meta["bits"]
    lo, hi = meta["lo"], meta["hi"]
    n_mu, n_sig = meta["n_mu"], meta["n_sig"]
    nsym = 2**bits
    q_step = (hi - lo) / (nsym - 1)
    stored = load_stream_pickle(os.path.join(compress_dir,
                                             f"{name}_gmodel.pkl"))
    mean, scale = gauss_mean_scale(_unpack_gauss_model(stored["packed"]),
                                   stored["cfgs"], positions)
    freqs, (sig_lo, sig_hi) = _gauss_ctx_freqs(lo, hi, nsym, q_step, n_mu,
                                               n_sig)
    out = np.zeros((n, C), np.float32)
    for c, blob in enumerate(_read_blobs(compress_dir, name, C)):
        ctx = _gauss_ctx_ids(mean[:, c], scale[:, c], lo, hi, sig_lo,
                             sig_hi, n_mu, n_sig)
        syms = native.rans_decode_ctx(blob, ctx, freqs, n)
        out[:, c] = syms.astype(np.float32) * q_step + lo
    return out


def _norm_positions(means: np.ndarray, lo_p, hi_p) -> np.ndarray:
    return np.clip(
        (means - lo_p) / np.maximum(hi_p - lo_p, 1e-6), 0.0, 1.0
    ).astype(np.float32)


def _is_gaussian(em) -> bool:
    return isinstance(em, tuple) and em[0] == "gaussian"


@dataclasses.dataclass
class EntropyCodingCompression:
    """compress(dir, splats[, entropy_models]) / decompress(dir) -> splats.
    ``entropy_models`` maps an attribute to its factorized model's
    parameters or to ("gaussian", (params, cfgs)); the rest of the coded
    attributes take histograms. The shN k-means runs on ``device`` (None
    means the CUDA card). ``seconds`` holds the last compress's stages:
    filter, plas (the crop and the sort), kmeans, ans (the rANS
    attributes, their tables included) and png_write (the other
    attributes' codecs)."""

    use_sort: bool = True
    shn_clusters: int = 32768
    kmeans_iters: int = 10
    ans_attrs: tuple = ("scales", "quats", "opacities", "sh0")
    device: DeviceLike = None
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def compress(self, compress_dir: str, splats: Dict,
                 entropy_models: Optional[Dict] = None) -> None:
        os.makedirs(compress_dir, exist_ok=True)
        entropy_models = entropy_models or {}
        seconds = {"filter": 0.0, "plas": 0.0, "kmeans": 0.0, "ans": 0.0,
                   "png_write": 0.0}
        t0 = time.perf_counter()
        splats = {k: np.asarray(v) for k, v in splats.items()}
        splats, _ = filter_splats(splats)
        q = splats["quats"]
        q = q / np.clip(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12,
                        None)
        splats["quats"] = np.where(q[:, :1] >= 0, q, -q)
        t1 = time.perf_counter()
        seconds["filter"] = t1 - t0
        if self.use_sort:
            splats, side = sort_splats(splats)
        else:
            n = len(splats["means"])
            side = int(np.floor(np.sqrt(n)))
            keep = np.argsort(splats["opacities"])[::-1][: side * side]
            splats = {k: v[np.sort(keep)] for k, v in splats.items()}
        seconds["plas"] = time.perf_counter() - t1

        meta = {"side": side, "attrs": {}}
        # the means go first: the Gaussian contexts come from the DECODED
        # positions, which the decoder reproduces bit for bit
        positions = None
        needs_ctx = any(_is_gaussian(entropy_models.get(a))
                        for a in self.ans_attrs)
        order = ["means"] + [k for k in splats if k != "means"]
        for name in order:
            t1 = time.perf_counter()
            v = splats[name]
            flat = v.reshape(len(v), -1)
            stage = "png_write"
            if name in self.ans_attrs and name in BOUNDS:
                lo, hi = BOUNDS[name]
                bits = Q_BITWIDTH.get(name, 8)
                em = entropy_models.get(name)
                if _is_gaussian(em):
                    meta["attrs"][name] = _encode_attr_ans_gauss(
                        compress_dir, name, flat, lo, hi, bits, em[1],
                        positions)
                else:
                    meta["attrs"][name] = _encode_attr_ans(
                        compress_dir, name, flat, lo, hi, bits, em)
                stage = "ans"
            elif name == "means":
                grid = v.reshape(side, side, -1)
                meta["attrs"][name] = codecs.compress_png_16bit(
                    compress_dir, name, grid, log_space=True)
                if needs_ctx:
                    dec_means = np.asarray(codecs.decompress_png_16bit(
                        compress_dir, name, meta["attrs"][name]),
                        np.float32).reshape(side * side, -1)
                    lo_p = np.percentile(dec_means, 1.0, axis=0)
                    hi_p = np.percentile(dec_means, 99.0, axis=0)
                    meta["pos_lo"] = lo_p.tolist()
                    meta["pos_hi"] = hi_p.tolist()
                    positions = _norm_positions(dec_means, lo_p, hi_p)
            elif name == "shN":
                grid = v.reshape(side, side, *v.shape[1:])
                meta["attrs"][name] = codecs.compress_kmeans(
                    compress_dir, name, grid, self.shn_clusters,
                    iters=self.kmeans_iters, device=self.device)
                stage = "kmeans"
            else:
                meta["attrs"][name] = codecs.compress_npz(compress_dir, name,
                                                          v)
            seconds[stage] += time.perf_counter() - t1
        with open(os.path.join(compress_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        self.seconds = seconds

    def decompress(self, compress_dir: str) -> Dict[str, np.ndarray]:
        with open(os.path.join(compress_dir, "meta.json")) as f:
            meta = json.load(f)
        side = meta["side"]
        n = side * side
        out = {}
        positions = None
        # the means first, so the Gaussian contexts can take the positions
        for name in sorted(meta["attrs"], key=lambda k: k != "means"):
            m = meta["attrs"][name]
            if m["kind"] == "ans_gauss":
                arr = _decode_attr_ans_gauss(compress_dir, name, m,
                                             positions)
            elif m["kind"] == "ans":
                arr = _decode_attr_ans(compress_dir, name, m)
            elif m["kind"] == "png16":
                arr = codecs.decompress_png_16bit(compress_dir, name, m)
            elif m["kind"] == "kmeans":
                arr = codecs.decompress_kmeans(compress_dir, name, m)
            else:
                arr = codecs.decompress_npz(compress_dir, name, m)
            arr = np.asarray(arr, np.float32)
            if name == "means" and "pos_lo" in meta:
                positions = _norm_positions(
                    arr.reshape(n, -1),
                    np.asarray(meta["pos_lo"], np.float32),
                    np.asarray(meta["pos_hi"], np.float32))
            if name == "opacities":
                out[name] = arr.reshape(n)
            elif name == "sh0":
                out[name] = arr.reshape(n, 1, 3)
            elif name == "shN":
                out[name] = arr.reshape(n, -1, 3)
            else:
                out[name] = arr.reshape(n, -1)
        return out
