"""gscodec_studio_tpu_torch's dynamic-path codecs against the JAX package's
on the CPU: the sequence codec (pngseq), the STG PNG codec in each of its
branches, the HEVC-grid codec's PNG fallback and the hybrid codec, the
GeS-TM pre- and post-processing, the multiview-video preprocessing, and
the compress_ply_sequence command line. PLAS runs on one thread in both
packages (its only deterministic mode).

Tolerances:
  * SeqCodec: meta.json equal (files, bits, shapes, ranges to their
    float32 bits) and every decoded array bit for bit; the committed
    sequence results/dyn_stand_in/frames compressed again at qp 30: its
    meta.json equal to the committed one written by the JAX package
    (results/dyn_stand_in/seq_codec/rp0/meta.json) but the file names;
  * STGPngCompression, HevcCompression (pngseq), HybridCompression: every
    attribute that does not go through k-means decodes to the same bits
    as JAX's, and each package decodes the other's bitstream to the same
    bits; the k-means banks (the port's k-means is its own, as
    tests/test_torch_codec holds it: 99% of labels equal) decode to the
    same shapes and zero rows;
  * GeS-TM pre/post, the YUV frames, the PNG folders and the COLMAP plan:
    bit for bit (numpy on both sides).
"""

import functools
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from gscodec_studio_tpu.compression import native as jnative
from gscodec_studio_tpu.compression import ges_tm as jges
from gscodec_studio_tpu.compression.hevc_compression import (
    HevcCompression as JHevc, HybridCompression as JHybrid)
from gscodec_studio_tpu.compression.seq_codec import SeqCodec as JSeqCodec
from gscodec_studio_tpu.compression.stg_compression import (
    STGPngCompression as JSTGPng)
from gscodec_studio_tpu.utils import mv_preprocess as jmv
from gscodec_studio_tpu_torch import compress_ply_sequence
from gscodec_studio_tpu_torch.compression import ges_tm, native
from gscodec_studio_tpu_torch.compression.hevc_compression import (
    HevcCompression, HybridCompression)
from gscodec_studio_tpu_torch.compression.png_io import read_png
from gscodec_studio_tpu_torch.compression.seq_codec import SeqCodec
from gscodec_studio_tpu_torch.compression.stg_compression import (
    STGPngCompression)
from gscodec_studio_tpu_torch.utils import mv_preprocess as mv
from gscodec_studio_tpu_torch.utils.ply import load_ply, save_ply

ROOT = Path(__file__).resolve().parents[1]
STAND_IN = ROOT / "results" / "dyn_stand_in"


@pytest.fixture(autouse=True)
def one_thread_plas(monkeypatch):
    for mod in (jnative, native):
        monkeypatch.setattr(mod, "plas_sort", functools.partial(
            mod.plas_sort, n_threads=1))


def _frames(rng, T=3, n=420):
    """A tracked sequence: one set of Gaussians moving over T frames."""
    base = dict(
        means=(rng.standard_normal((n, 3)) * 2).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        scales=rng.normal(-4, 1, (n, 3)).astype(np.float32),
        opacities=rng.normal(0, 3, n).astype(np.float32),
        sh0=rng.standard_normal((n, 1, 3)).astype(np.float32),
        shN=np.zeros((n, 0, 3), np.float32))
    vel = (rng.standard_normal((n, 3)) * 0.1).astype(np.float32)
    return [dict(base, means=base["means"] + vel * t) for t in range(T)]


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("qp,all_intra", [(30, False), (15, True)])
def test_seq_codec_pngseq_matches_jax(rng, tmp_path, qp, all_intra):
    frames = _frames(rng)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JSeqCodec(backend="pngseq", qp=qp, all_intra=all_intra).compress(
        jdir, frames)
    codec = SeqCodec(backend="pngseq", qp=qp, all_intra=all_intra)
    codec.compress(tdir, frames)
    with open(os.path.join(jdir, "meta.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(tdir, "meta.json")) as f:
        tmeta = json.load(f)
    assert tmeta == jmeta
    assert tmeta["attrs"]["quats"]["bits"] == codec.pngseq_bits() == (
        4 if qp == 30 else 8)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    got = codec.decompress(tdir)
    _assert_frames_equal(got, JSeqCodec().decompress(jdir))
    _assert_frames_equal(SeqCodec().decompress(jdir), got)  # JAX's stream


def test_seq_codec_refuses_unknown_backend(rng, tmp_path, monkeypatch):
    with pytest.raises(ValueError):
        SeqCodec(backend="av1").compress(str(tmp_path), _frames(rng))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        SeqCodec(backend="hevc").compress(str(tmp_path / "h"), _frames(rng))
    assert SeqCodec()._backend() == "pngseq"


def test_committed_sequence_meta_matches_jax(tmp_path):
    """The committed 12-frame sequence (33,659 Gaussians) at qp 30 gives
    the committed meta.json of the JAX package's run."""
    frames = [load_ply(str(p))
              for p in sorted((STAND_IN / "frames").glob("*.ply"))]
    assert len(frames) == 12 and len(frames[0]["means"]) == 33_659
    out = str(tmp_path / "rp0")
    SeqCodec(backend="pngseq", qp=30).compress(out, frames)
    with open(os.path.join(out, "meta.json")) as f:
        got = json.load(f)
    with open(STAND_IN / "seq_codec" / "rp0" / "meta.json") as f:
        want = json.load(f)
    for m in (got, want):
        for a in m["attrs"].values():
            a.pop("files", None)
    assert got == want


def _stg_splats(rng, n=700):
    sp = dict(
        means=(rng.standard_normal((n, 3)) * 2).astype(np.float32),
        scales=rng.normal(-4, 1, (n, 3)).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        opacities=rng.normal(0, 3, n).astype(np.float32),
        trbf_center=rng.random(n).astype(np.float32),
        trbf_scale=rng.normal(0, 0.3, n).astype(np.float32),
        motion=(rng.standard_normal((n, 9)) * 0.2).astype(np.float32),
        omega=(rng.standard_normal((n, 4)) * 0.1).astype(np.float32),
        colors=rng.standard_normal((n, 3)).astype(np.float32),
        features_dir=rng.standard_normal((n, 3)).astype(np.float32),
        features_time=rng.standard_normal((n, 3)).astype(np.float32),
        decoder_head=rng.standard_normal((n, 2)).astype(np.float32))
    sp["features_dir"][rng.random(n) < 0.2] = 0.0  # rows k-means masks out
    return sp


@pytest.mark.parametrize("kw", [
    dict(), dict(quantization=6), dict(use_sort=False),
    dict(use_kmeans=True)], ids=["png", "kbit", "nosort", "kmeans"])
def test_stg_png_compression_matches_jax(rng, tmp_path, kw):
    splats = _stg_splats(rng)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JSTGPng(**kw).compress(jdir, splats)
    codec = STGPngCompression(device="cpu", **kw)
    codec.compress(tdir, splats)
    with open(os.path.join(tdir, "meta.json")) as f:
        kinds = {k: m["kind"] for k, m in json.load(f)["attrs"].items()}
    assert kinds["means"] == "png16" and kinds["motion"] == "multi_png"
    assert kinds["decoder_head"] == "npz"
    assert kinds["features_dir"] == ("kmeans" if kw.get("use_kmeans")
                                     else "png")
    got, want = codec.decompress(tdir), JSTGPng().decompress(jdir)
    back = codec.decompress(jdir)  # the port reads JAX's bitstream
    assert sorted(got) == sorted(want) == sorted(splats)
    for k in got:
        if kinds[k] == "kmeans":
            assert got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k] == 0, want[k] == 0)
            continue
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    if kw.get("use_kmeans"):
        side = int(np.floor(np.sqrt(len(got["means"]))))
        assert got["features_dir"].shape == (side * side, 3)


def test_hevc_compression_pngseq_fallback_matches_jax(rng, tmp_path):
    from tests.test_torch_codec import _splats

    splats = _splats(rng, 1024)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JHevc(backend="pngseq", shn_clusters=64).compress(jdir, splats)
    codec = HevcCompression(backend="pngseq", shn_clusters=64, device="cpu")
    codec.compress(tdir, splats)
    with open(os.path.join(tdir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["backend"] == "pngseq"
    got, want = codec.decompress(tdir), JHevc().decompress(jdir)
    for k in ("means", "quats", "scales", "opacities", "sh0"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(codec.decompress(jdir)[k], want[k])
    assert got["shN"].shape == want["shN"].shape
    np.testing.assert_array_equal(got["shN"] != 0, want["shN"] != 0)


def test_hybrid_compression_matches_jax(rng, tmp_path):
    from tests.test_torch_codec import _splats

    splats = _splats(rng, 1024)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JHybrid(shn_clusters=64).compress(jdir, splats)
    codec = HybridCompression(shn_clusters=64, device="cpu")
    codec.compress(tdir, splats)
    got, want = codec.decompress(tdir), JHybrid().decompress(jdir)
    for k in ("means", "quats", "scales", "opacities", "sh0"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("scales", "quats"):  # the rANS streams, byte for byte
        for fn in sorted(os.listdir(jdir)):
            if fn.startswith(k) and fn.endswith(".bin"):
                assert Path(tdir, fn).read_bytes() == Path(
                    jdir, fn).read_bytes(), fn


def test_ges_tm_matches_jax(rng, tmp_path):
    from tests.test_torch_codec import _splats

    splats = _splats(rng, 500)
    tq = ges_tm.pre_process(splats, str(tmp_path / "port"))
    jq = jges.pre_process(splats, str(tmp_path / "jax"))
    assert Path(tq).read_bytes() == Path(jq).read_bytes()
    with np.load(str(tmp_path / "port" / "meta.npz")) as a, \
            np.load(str(tmp_path / "jax" / "meta.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    got, want = ges_tm.post_process(tq), jges.post_process(jq)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["opacities"], splats["opacities"].clip(
        -7, 18), atol=25 / 1024)
    cfg = ges_tm.write_encoder_cfg(str(tmp_path / "a.cfg"), 30)
    jcfg = jges.write_encoder_cfg(str(tmp_path / "b.cfg"), 30)
    assert Path(cfg).read_text() == Path(jcfg).read_text()
    assert ges_tm.RATE_POINTS == jges.RATE_POINTS
    if ges_tm.find_tmc3() is None:
        assert ges_tm.run_gpcc(tq, str(tmp_path / "g")) is None


def _yuv_file(rng, path, W=16, H=8, T=3):
    raw = rng.integers(0, 256, T * W * H * 3 // 2 + 5).astype(np.uint8)
    raw.tofile(path)  # a partial last frame, which the reader drops
    return path


def test_mv_preprocess_matches_jax(rng, tmp_path, monkeypatch):
    paths = [_yuv_file(rng, str(tmp_path / f"v{i}.yuv")) for i in range(2)]
    for mf in (None, 2):
        got = mv.yuv420_to_rgb_frames(paths[0], 16, 8, max_frames=mf)
        want = jmv.yuv420_to_rgb_frames(paths[0], 16, 8, max_frames=mf)
        assert len(got) == len(want) == (mf or 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    tdirs = mv.yuv_to_png_dirs(paths, 16, 8, str(tmp_path / "port"))
    jdirs = jmv.yuv_to_png_dirs(paths, 16, 8, str(tmp_path / "jax"))
    assert [os.path.relpath(d, tmp_path / "port") for d in tdirs] == [
        os.path.relpath(d, tmp_path / "jax") for d in jdirs]
    for td, jd in zip(tdirs, jdirs):
        for name in ("v0.png", "v1.png"):
            np.testing.assert_array_equal(
                read_png(os.path.join(td, "images", name)),
                read_png(os.path.join(jd, "images", name)))
    assert mv.per_frame_colmap_commands("f", "s") == \
        jmv.per_frame_colmap_commands("f", "s")
    assert mv.run_per_frame_colmap(tdirs, "s", dry_run=True) == {
        d: mv.per_frame_colmap_commands(d, "s") for d in tdirs}
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="colmap"):
        mv.run_per_frame_colmap(tdirs, "s")


def test_compress_ply_sequence_main(rng, tmp_path):
    frames = _frames(rng, T=3, n=300)
    ply_dir = tmp_path / "plys"
    ply_dir.mkdir()
    for i, fr in enumerate(frames):
        save_ply(str(ply_dir / f"frame_{i:04d}.ply"), fr)
    out = tmp_path / "out"
    rows = compress_ply_sequence.main([
        "--ply_dir", str(ply_dir), "--output_dir", str(out),
        "--rate_points", "rp0", "rp3", "--backend", "pngseq",
        "--eval_views", "2", "--eval_width", "48", "--eval_height", "32",
        "--device", "cpu"])
    assert [r["rate_point"] for r in rows] == ["rp0", "rp3"]
    for r in rows:
        stats = json.loads((out / r["rate_point"] / "stats.json").read_text())
        assert stats == r and stats["backend"] == "pngseq"
        assert stats["bits"]["quats"] == (4 if r["rate_point"] == "rp0"
                                          else 8)
        assert np.isfinite(stats["psnr_rgb"]) and stats["bytes"] > 0
        dec = sorted(os.listdir(out / r["rate_point"] / "decoded"))
        assert dec == [f"frame_{i:04d}.ply" for i in range(3)]
    assert rows[0]["bytes"] < rows[1]["bytes"]  # fewer bits, fewer bytes
    assert rows[0]["psnr_rgb"] < rows[1]["psnr_rgb"]
