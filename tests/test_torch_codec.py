"""The PNG compression path of gscodec_studio_tpu_torch against the JAX
package on the CPU: the port's PNG reader and writer against imageio (a
test-only import), its PLAS build against the JAX package's, the decode
of the committed bitstream results/garden_ab_f32/compression_1500/, the
k-means, a PngCompression round trip, the means' float32 log transforms,
the PLY files and the opacity filter.

Tolerances: PNG pixels, PLAS permutations (one thread: with more, which
thread sorts which band depends on timing), decodes, the log transforms,
PLY arrays and the filter bit for bit; k-means at least 99% of labels
equal and the distortion within 1% relative (the assignment's matmul
sums in another order, which can flip a near tie, and the centroids
follow); the round trip's size_bytes within 10% (the two PNG encoders
choose other filters and deflate settings).
"""

import functools
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest

import jax.numpy as jnp

from gscodec_studio_tpu.compression import native as jnative
from gscodec_studio_tpu.compression import PngCompression as JPng
from gscodec_studio_tpu.compression import compressed_size as jsize
from gscodec_studio_tpu.compression.kmeans import kmeans as jkmeans
from gscodec_studio_tpu.compression.outlier_filter import (
    filter_splats as jfilter)
from gscodec_studio_tpu.compression_sim.ops import (
    inverse_log_transform as jinv_log, log_transform as jlog)
from gscodec_studio_tpu.utils import ply as jply
from gscodec_studio_tpu_torch.compression import (PngCompression,
                                                  compressed_size,
                                                  filter_splats)
from gscodec_studio_tpu_torch.compression import f32_math, native
from gscodec_studio_tpu_torch.compression.kmeans import kmeans
from gscodec_studio_tpu_torch.compression.png_io import read_png, write_png
from gscodec_studio_tpu_torch.utils import ply

ROOT = Path(__file__).resolve().parents[1]
BITSTREAM = ROOT / "results" / "garden_ab_f32" / "compression_1500"


def _splats(rng, n=4096):
    return dict(
        means=(rng.standard_normal((n, 3)) * 3).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        scales=rng.normal(-4, 1, (n, 3)).astype(np.float32),
        opacities=rng.normal(0, 3, n).astype(np.float32),
        sh0=rng.standard_normal((n, 1, 3)).astype(np.float32),
        shN=(rng.standard_normal((n, 15, 3)) * 0.1
             * (rng.random((n, 1, 1)) < 0.7)).astype(np.float32),
    )


def test_png_reader_matches_imageio_on_the_committed_files():
    files = sorted(BITSTREAM.glob("*.png"))
    assert len(files) == 6
    for fn in files:
        np.testing.assert_array_equal(read_png(str(fn)),
                                      np.asarray(imageio.imread(fn)))


@pytest.mark.parametrize("shape", [(37, 53), (40, 29, 3), (64, 64, 4),
                                   (1, 1), (1, 7, 3)])
def test_png_writer_is_read_alike_by_imageio(rng, tmp_path, shape):
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    smooth = np.cumsum(rng.integers(0, 3, shape), axis=0).astype(np.uint8)
    for i, img in enumerate((noise, smooth)):
        path = str(tmp_path / f"img{i}.png")
        write_png(path, img)
        np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
        np.testing.assert_array_equal(read_png(path), img)


def test_plas_permutation_matches_jax(rng):
    data = rng.standard_normal((48 * 48, 7)).astype(np.float32)
    data[:, 0] += np.linspace(-3, 3, 48 * 48, dtype=np.float32)
    for seed in (0, 5):
        want = jnative.plas_sort(data, 48, seed=seed, n_threads=1)
        got = native.plas_sort(data, 48, seed=seed, n_threads=1)
        np.testing.assert_array_equal(got, want)
    assert str(native.library_path()).startswith(
        str(ROOT / "gscodec_studio_tpu_torch" / "_build"))


def test_decode_of_the_committed_bitstream_matches_jax():
    want = JPng().decompress(str(BITSTREAM))
    got = PngCompression(device="cpu").decompress(str(BITSTREAM))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["means"].shape == (205 * 205, 3)


def test_log_transforms_have_the_jax_bits(rng):
    x = np.concatenate([
        rng.uniform(-30, 30, 200_000), rng.normal(0, 0.4, 100_000),
        rng.normal(0, 1e-3, 10_000),
        [0.0, -0.0, 0.5, -0.5, 0.41421356, 1e-30, 88.0, -88.0],
    ]).astype(np.float32)
    np.testing.assert_array_equal(f32_math.log_transform(x),
                                  np.asarray(jlog(jnp.asarray(x))))
    y = np.concatenate([x[np.abs(x) < 12], rng.uniform(-16, 16, 50_000)
                        .astype(np.float32)])
    np.testing.assert_array_equal(f32_math.inverse_log_transform(y),
                                  np.asarray(jinv_log(jnp.asarray(y))))


def test_kmeans_matches_jax(rng):
    centers = rng.standard_normal((40, 6)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, 3000)]
         + rng.standard_normal((3000, 6)) * 0.5).astype(np.float32)
    jc, jl = jkmeans(x, 64, iters=10)
    tc, tl = kmeans(x, 64, iters=10, device="cpu")
    assert tc.shape == jc.shape and tl.dtype == np.int64
    assert float(np.mean(tl == jl)) >= 0.99

    def distortion(c, lab):
        return float(((x - c[lab]) ** 2).sum())

    assert distortion(tc, tl) == pytest.approx(distortion(jc, jl), rel=0.01)


def test_png_compression_round_trip_matches_jax(rng, tmp_path, monkeypatch):
    """Both packages compress the same 4,096-Gaussian scene
    (shn_clusters=256, PLAS on one thread in both); every attribute but
    shN decodes to the same bits, and each package reads the other's
    bitstream as its own."""
    for mod in (jnative, native):
        monkeypatch.setattr(mod, "plas_sort", functools.partial(
            mod.plas_sort, n_threads=1))
    splats = _splats(rng)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JPng(shn_clusters=256).compress(jdir, splats)
    codec = PngCompression(shn_clusters=256, device="cpu")
    codec.compress(tdir, splats)
    want = JPng().decompress(jdir)
    got = codec.decompress(tdir)
    side = int(np.floor(np.sqrt(int((1 / (1 + np.exp(-splats["opacities"]))
                                    >= 0.005).sum()))))
    assert got["means"].shape == (side * side, 3)
    for k in ("means", "quats", "scales", "opacities", "sh0"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["shN"] != 0, want["shN"] != 0)
    assert compressed_size(tdir) == pytest.approx(jsize(jdir), rel=0.10)
    cross = JPng().decompress(tdir)
    for k in got:
        np.testing.assert_array_equal(cross[k], got[k], err_msg=k)
    assert set(codec.seconds) == {"filter", "plas", "kmeans", "png_write"}


def test_ply_files_interchange_with_jax(rng, tmp_path):
    splats = _splats(rng, n=50)
    ply.save_ply(str(tmp_path / "port.ply"), splats)
    jply.save_ply(str(tmp_path / "jax.ply"), splats)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()
    back = ply.load_ply(str(tmp_path / "jax.ply"))
    for k, v in splats.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_outlier_filter_matches_jax(rng):
    splats = _splats(rng, n=500)
    got, keep = filter_splats(splats)
    want, jkeep = jfilter(splats)
    np.testing.assert_array_equal(keep, jkeep)
    for k in splats:
        np.testing.assert_array_equal(got[k], want[k])
