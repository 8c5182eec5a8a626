"""The port's rANS codec against the JAX package on the CPU: the coder's
streams (one table and context tables) and quantize_freqs, the
factorized model's tables and the Gaussian model's contexts, the
EntropyCodingCompression round trip of the three table kinds (histograms,
factorized, Gaussian contexts) with each package decoding the other's
directories, the restricted unpickler, a decode of JAX-written
directories in a process that must load neither JAX nor the JAX package,
and Runner.run_compression("entropy_coding") beside the JAX Runner's.

Tolerances: streams, tables, context ids and the decoded arrays bit for
bit (both libraries compile the same source with the same flags, and the
tables are derived with the JAX package's float32 bits); the decode
within q_step/2 of the clipped input; run_compression's PSNR within 0.1 dB
of JAX's (the renders agree to 1e-4) and size_bytes within 10% (the shN
k-means may differ in a few labels, test_torch_codec).
"""

import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.compression import native as jnative
from gscodec_studio_tpu.compression import entropy_coding as jec
from gscodec_studio_tpu.compression_sim.entropy_model import (
    factorized_likelihood_table as jtable, init_factorized)
from gscodec_studio_tpu.compression_sim.hash_grid import (
    gaussian_conditional_apply as japply, gaussian_conditional_init)
from gscodec_studio_tpu.compression_sim.simulation import BOUNDS
from gscodec_studio_tpu.training.trainer import Config as JConfig
from gscodec_studio_tpu.training.trainer import Runner as JRunner
from gscodec_studio_tpu_torch.compression import EntropyCodingCompression
from gscodec_studio_tpu_torch.compression import entropy_coding as tec
from gscodec_studio_tpu_torch.compression import f32_math
from gscodec_studio_tpu_torch.compression import native as tnative
from gscodec_studio_tpu_torch.compression_sim.hash_grid import HashGridCfg
from gscodec_studio_tpu_torch.models.splats import (codec_models_from_jax,
                                                    from_jax_sim_params)
from gscodec_studio_tpu_torch.training.trainer import Config, Runner

from tests.test_torch_train import (_to_torch, fake_scene,  # noqa: F401
                                    one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
SIDE = 34
Q = {k: (hi - lo) / 255 for k, (lo, hi) in BOUNDS.items()}


@pytest.fixture(autouse=True)
def plas_on_one_thread(monkeypatch):
    """PLAS on one thread in both packages: the same permutation."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "plas_sort", functools.partial(
            mod.plas_sort, n_threads=1))


def _splats(rng, n=SIDE * SIDE):
    """A scene the filter keeps whole (a square count, opaque, no
    outliers), its scales tied to the positions."""
    pos = rng.random((n, 3)).astype(np.float32)
    scales = (-5.0 + 2.0 * np.sin(4 * pos[:, :1]) + pos[:, 1:2]
              + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    return dict(
        means=(pos * 4.0 - 2.0).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        scales=scales,
        opacities=(3.0 + rng.standard_normal(n)).astype(np.float32),
        sh0=(0.3 * rng.standard_normal((n, 1, 3))).astype(np.float32),
        shN=(0.1 * rng.standard_normal((n, 3, 3))).astype(np.float32),
    )


def _jax_models(kind):
    """The JAX package's models for a stream kind, and the same as numpy
    trees for the port (codec_models_from_jax)."""
    if kind == "histogram":
        return None, None
    if kind == "factorized":
        ems = {"quats": init_factorized(jax.random.PRNGKey(1), 4),
               "scales": init_factorized(jax.random.PRNGKey(2), 3, (3, 3)),
               "sh0": init_factorized(jax.random.PRNGKey(3), 3, (3, 3))}
        rng = np.random.default_rng(7)  # away from the constant init
        ems = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + rng.normal(
                0, 0.3, np.shape(a)).astype(np.float32)), ems)
    else:
        ems = {}
        for i, (name, c) in enumerate((("scales", 3), ("quats", 4))):
            p, cfgs = gaussian_conditional_init(
                jax.random.PRNGKey(10 + i), channel=c, n_levels_3d=2,
                n_levels_2d=1, mlp_width=16, log2_hashmap_3d=10,
                log2_hashmap_2d=8)
            ems[name] = ("gaussian", (p, cfgs))
    return ems, codec_models_from_jax(ems, device="cpu")


def test_rans_streams_byte_identical_to_jax(rng):
    for nsym, n in ((256, 5000), (7, 1), (256, 0)):
        counts = rng.integers(0, 1000, nsym).astype(np.uint64)
        counts[rng.random(nsym) < 0.3] = 0
        counts[0] = max(int(counts[0]), 1)
        f = tnative.quantize_freqs(counts)
        np.testing.assert_array_equal(f, jnative.quantize_freqs(counts))
        assert int(f.sum()) == 1 << 14
        syms = rng.choice(np.flatnonzero(f), n).astype(np.uint8)
        blob = tnative.rans_encode(syms, f)
        assert blob == jnative.rans_encode(syms, f)
        np.testing.assert_array_equal(tnative.rans_decode(blob, f, n), syms)
    tables = np.stack([tnative.quantize_freqs(
        rng.integers(1, 500, 256).astype(np.uint64)) for _ in range(12)])
    syms = rng.integers(0, 256, 20_000).astype(np.uint8)
    ctx = rng.integers(0, 12, 20_000).astype(np.uint16)
    blob = tnative.rans_encode_ctx(syms, ctx, tables)
    assert blob == jnative.rans_encode_ctx(syms, ctx, tables)
    np.testing.assert_array_equal(
        tnative.rans_decode_ctx(blob, ctx, tables, syms.size), syms)
    with pytest.raises(RuntimeError):
        tnative.rans_encode(np.array([3], np.uint8),
                            np.full(4, 1 << 12, np.uint32) * 2)


@pytest.mark.parametrize("attr,channels,filters,perturb", [
    ("quats", 4, (3, 3, 3), 0.0), ("scales", 3, (3, 3), 0.5),
    ("sh0", 3, (3, 3), 1.0), ("opacities", 1, (3, 3, 3), 0.3)])
def test_factorized_tables_equal_jax(attr, channels, filters, perturb):
    p = init_factorized(jax.random.PRNGKey(channels), channels, filters)
    rng = np.random.default_rng(channels)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(
        0, perturb, np.shape(a)).astype(np.float32), p)
    lo, hi = BOUNDS[attr]
    want = np.asarray(jtable(p, jnp.arange(256), Q[attr], lo))
    got = f32_math.factorized_likelihood_table(p, 256, Q[attr], lo)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    freqs = np.stack([jnative.quantize_freqs(np.maximum(
        (w * 1e9).astype(np.uint64), 1)) for w in want])
    port = codec_models_from_jax({attr: p}, device="cpu")[attr]
    assert isinstance(port["matrices"][0], torch.Tensor)
    np.testing.assert_array_equal(
        tec.factorized_freqs(port, 256, Q[attr], lo), freqs)


def test_gaussian_contexts_equal_jax(rng):
    """The context tables, and the context ids at 3,000 positions from the
    binarized model at the simulation's levels (8 and 2), both packages'."""
    p, cfgs = gaussian_conditional_init(jax.random.PRNGKey(4), channel=3,
                                        n_levels_3d=8, n_levels_2d=2)
    lo, hi = BOUNDS["scales"]
    want_f, (s_lo, s_hi) = jec._gauss_ctx_freqs(lo, hi, 256, Q["scales"], 48,
                                                16)
    got_f, sig = tec._gauss_ctx_freqs(lo, hi, 256, Q["scales"], 48, 16)
    np.testing.assert_array_equal(got_f, want_f)
    assert sig == (s_lo, s_hi)
    pos = rng.random((3000, 3)).astype(np.float32)
    packed = jec._pack_gauss_model(p)
    jm, js = map(np.asarray, japply(jec._unpack_gauss_model(packed), cfgs,
                                    jnp.asarray(pos), binarize=True))
    tparams = tec._unpack_gauss_model(tec._pack_gauss_model(
        codec_models_from_jax({"s": ("gaussian", (p, cfgs))},
                              device="cpu")["s"][1][0]))
    tm, ts = tec.gauss_mean_scale(tparams, cfgs, pos)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
    for c in range(3):
        np.testing.assert_array_equal(
            tec._gauss_ctx_ids(tm[:, c], ts[:, c], lo, hi, s_lo, s_hi, 48, 16),
            jec._gauss_ctx_ids(jm[:, c], js[:, c], lo, hi, s_lo, s_hi, 48,
                               16))


@pytest.mark.parametrize("kind", ["histogram", "factorized", "gaussian"])
def test_codec_round_trip_and_cross_decode(rng, tmp_path, kind):
    splats = _splats(rng)
    jems, tems = _jax_models(kind)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jec.EntropyCodingCompression(shn_clusters=64, kmeans_iters=2).compress(
        jdir, splats, entropy_models=jems)
    codec = EntropyCodingCompression(shn_clusters=64, kmeans_iters=2,
                                     device="cpu")
    codec.compress(tdir, splats, entropy_models=tems)
    assert set(codec.seconds) == {"filter", "plas", "kmeans", "ans",
                                  "png_write"}
    names = sorted(f for f in os.listdir(jdir) if f.endswith(".ans"))
    assert names == sorted(f for f in os.listdir(tdir) if f.endswith(".ans"))
    for f in names:
        assert (Path(jdir) / f).read_bytes() == (Path(tdir) / f).read_bytes()
    want = jec.EntropyCodingCompression().decompress(jdir)
    got = codec.decompress(tdir)
    cross = codec.decompress(jdir)
    back = jec.EntropyCodingCompression().decompress(tdir)
    for k in want:
        if k != "shN":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(cross[k], want[k], err_msg=k)
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)
    for k in ("scales", "quats", "opacities", "sh0"):
        lo, hi = BOUNDS[k]
        orig = splats[k].reshape(SIDE * SIDE, -1)
        if k == "quats":
            orig = orig / np.linalg.norm(orig, axis=-1, keepdims=True)
            orig = np.where(orig[:, :1] >= 0, orig, -orig)
        err = np.abs(np.clip(np.sort(orig, axis=0), lo, hi)
                     - np.sort(got[k].reshape(len(orig), -1), axis=0))
        assert float(err.max()) <= 0.5 * Q[k] * (1 + 1e-5) + 1e-6, k
    if kind == "gaussian":
        with open(Path(tdir) / "scales_gmodel.pkl", "rb") as fh:
            data = fh.read()
        assert b"gscodec_studio_tpu.compression_sim.hash_grid" in data
        assert b"gscodec_studio_tpu_torch" not in data
        cfgs = tec.load_stream_pickle(str(Path(jdir) / "scales_gmodel.pkl"))[
            "cfgs"]
        assert type(cfgs[0]) is HashGridCfg


class _Foreign:
    def __reduce__(self):
        return (os.getcwd, ())


def test_restricted_unpickler_refuses_foreign_globals(tmp_path):
    for i, obj in enumerate((_Foreign(), {"a": [np.float64(1.0)],
                                          "b": _Foreign()})):
        path = tmp_path / f"bad{i}.pkl"
        path.write_bytes(pickle.dumps(obj))
        with pytest.raises(pickle.UnpicklingError, match="not admitted"):
            tec.load_stream_pickle(str(path))
    ok = {"m": [np.arange(6, dtype=np.float32).reshape(2, 3)], "s": (1, 2),
          "f": np.float32(2.5)}
    for proto in (2, 4, 5):
        path = tmp_path / f"ok{proto}.pkl"
        path.write_bytes(pickle.dumps(ok, protocol=proto))
        back = tec.load_stream_pickle(str(path))
        np.testing.assert_array_equal(back["m"][0], ok["m"][0])
        assert back["s"] == (1, 2) and back["f"] == np.float32(2.5)


def test_port_decodes_jax_streams_without_loading_jax(rng, tmp_path):
    """A fresh process decodes JAX-written directories of the three kinds
    to the JAX decoder's arrays, and holds neither jax nor the JAX package
    in sys.modules afterwards."""
    splats = _splats(rng)
    dirs = []
    for kind in ("histogram", "factorized", "gaussian"):
        jems, _ = _jax_models(kind)
        d = tmp_path / kind
        jec.EntropyCodingCompression(shn_clusters=32, kmeans_iters=2) \
            .compress(str(d), splats, entropy_models=jems)
        np.savez(tmp_path / f"{kind}.npz",
                 **jec.EntropyCodingCompression().decompress(str(d)))
        dirs.append(kind)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from gscodec_studio_tpu_torch.compression import "
        "EntropyCodingCompression\n"
        f"root = {str(tmp_path)!r}\n"
        f"for kind in {dirs!r}:\n"
        "    got = EntropyCodingCompression(device='cpu').decompress(\n"
        "        root + '/' + kind)\n"
        "    with np.load(root + '/' + kind + '.npz') as z:\n"
        "        assert sorted(got) == sorted(z.files), kind\n"
        "        for k in z.files:\n"
        "            assert np.array_equal(got[k], z[k]), (kind, k)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'gscodec_studio_tpu']\n"
        "assert not bad, bad\n"
        "print('decoded', len(" + repr(dirs) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert "decoded 3" in out.stdout


@pytest.mark.parametrize("kind", ["histogram", "factorized"])
def test_runner_entropy_coding_matches_jax(fake_scene, tmp_path,  # noqa
                                           kind):
    """run_compression("entropy_coding") of the same splats (and entropy
    models) in both packages' Runners at 64x48, on the reference
    rasterizer: the rANS streams byte for byte, the metrics alike."""
    parser, trainset, valset = fake_scene
    kw = dict(rasterizer="reference", isect_capacity=8192, tb_every=0)
    if kind == "factorized":
        kw.update(compression_sim=True, entropy_model_opt=True)
    jr = JRunner(JConfig(result_dir=str(tmp_path / "jax"), **kw),
                 parser=parser, trainset=trainset, valset=valset)
    want = jr.run_compression(3, method="entropy_coding")
    tr = Runner(Config(result_dir=str(tmp_path / "port"), **kw),
                parser=parser, trainset=trainset, valset=valset,
                device="cpu")
    tr.splats = _to_torch(jr.splats)
    if kind == "factorized":
        tr.sim_params = from_jax_sim_params(
            jax.tree_util.tree_map(np.asarray, jr.sim_params), device="cpu")
        assert set(tr.entropy_models()) == {"scales", "quats", "sh0"}
    else:
        assert tr.entropy_models() is None
    got = tr.run_compression(3, method="entropy_coding")
    jd, td = tmp_path / "jax" / "compression_3", tmp_path / "port" / \
        "compression_3"
    names = sorted(f.name for f in jd.glob("*.ans"))
    assert len(names) == 4
    for f in names:
        assert (jd / f).read_bytes() == (td / f).read_bytes(), f
    assert (kind == "factorized") == (td / "quats_model.pkl").exists()
    assert abs(got["psnr"] - want["psnr"]) <= 0.1
    assert got["size_bytes"] == pytest.approx(want["size_bytes"], rel=0.10)
    assert set(tr.compression_seconds) == {
        "filter", "plas", "kmeans", "ans", "png_write", "decode", "eval"}
    for k, v in jr.splats.items():  # the trained splats are back
        np.testing.assert_array_equal(tr.splats[k].numpy(), np.asarray(v))
