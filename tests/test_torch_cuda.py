"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: each test skips where there is no CUDA device. This
file imports no JAX, so it also runs on a machine without it:

    python3 -m pytest tests/test_torch_cuda.py -m cuda --noconftest \
        -o addopts= -p no:cacheprovider -q

Tolerances: pack and expansion bit for bit (no pair of these seeds lies on
the cull bound); tile forward max abs 1e-4 (summation order on the card).
"""

import numpy as np
import pytest
import torch

from gscodec_studio_tpu_torch.ops import raster_v2 as tr
from gscodec_studio_tpu_torch.rendering import rasterization

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(seed, C=2, N=3000, W=200, H=136, CH=3):
    rng = np.random.default_rng(seed)
    m2 = np.stack([rng.random((C, N)) * W, rng.random((C, N)) * H],
                  -1).astype(np.float32)
    L = rng.random((C, N, 2, 2)).astype(np.float32) - 0.5
    cov = 6.0 * (L @ np.swapaxes(L, -1, -2)) + 2.0 * np.eye(2)
    inv = np.linalg.inv(cov)
    con = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]],
                   -1).astype(np.float32)
    col = rng.random((C, N, CH)).astype(np.float32)
    op = (0.05 + 0.95 * rng.random((C, N))).astype(np.float32)
    dep = (0.5 + rng.random((C, N))).astype(np.float32)
    radii = rng.integers(0, 14, (C, N, 2)).astype(np.int32)
    return m2, con, col, op, dep, radii


def _cfg(C, N, W, H, ts, CH, cutoff="exact", cap=1 << 16):
    return tr.V2Cfg(C=C, tile_width=-(-W // ts), tile_height=-(-H // ts),
                    tile_size=ts, channels=CH, cap=cap, n=N, cutoff=cutoff)


def test_pack_kernel_matches_plain(cuda):
    g = torch.Generator(device="cpu").manual_seed(0)
    inter = torch.randn(5000, 7, generator=g).to(cuda)
    rows = list(inter.unbind(1))  # strided views
    perm = torch.randperm(5000, generator=g).to(cuda)
    for p in (None, perm):
        assert torch.equal(tr.pack_rows(rows, 8, p),
                           tr._pack_rows_plain(rows, 8, p))


def test_expand_kernel_matches_plain(cuda):
    m2, con, col, op, dep, radii = _scene(1)
    C, N = dep.shape
    t = [torch.as_tensor(x, device=cuda) for x in (m2, con, col, op, dep)]
    rad = torch.as_tensor(radii, device=cuda)
    for ts in (16, 32):
        cfg = _cfg(C, N, 200, 136, ts, 3)
        order, cum, base, nx, n_isects = tr._compact(cfg, t[0], rad, t[4])
        table = tr.pack_rows(tr._attr_rows(cfg, *t[:4]), cfg.n_attr, order)
        tile, rows = tr.expand(cum, base, nx, table, n_isects, cfg)
        tile_p, rows_p = tr._expand_plain(cum, base, nx, table, n_isects,
                                          cfg)
        assert int(n_isects) > 1000
        assert torch.equal(tile, tile_p) and torch.equal(rows, rows_p)


def test_forward_kernel_matches_plain(cuda):
    m2, con, col, op, dep, radii = _scene(2)
    C, N = dep.shape
    g = torch.Generator(device="cpu").manual_seed(2)
    for ts in (16, 32):
        for cutoff in ("exact", "soft"):
            cfg = _cfg(C, N, 200, 136, ts, 3, cutoff)
            S, starts = tr._build_sorted(
                cfg, *[torch.as_tensor(x, device=cuda)
                       for x in (m2, con, col, op, dep, radii)])[:2]
            masks = (torch.rand(cfg.n_tiles, generator=g) > 0.2).to(
                device=cuda, dtype=torch.int32)
            out = tr.raster_fwd(S, starts, masks, cfg)
            ref = tr._fwd_plain(S, starts, masks, cfg)
            assert float((out - ref).abs().max()) <= 1e-4, (ts, cutoff)
            assert float(out[..., -1].max()) > 0.5


def test_rasterization_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    N, W, H = 4000, 160, 120
    means = (rng.standard_normal((N, 3)) * [1.5, 1.0, 1.5]).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.5, 0.5, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    sh = (rng.standard_normal((N, 16, 3)) * 0.3).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 5.0
    K = np.array([[[150, 0, W / 2], [0, 150, H / 2], [0, 0, 1]]], np.float32)
    args = (means, quats, scales, opac, sh, vm[None], K, W, H)
    before = dict(tr.LAUNCHES)
    img, alp, meta = rasterization(*args, sh_degree=3, device=cuda)
    assert all(tr.LAUNCHES[k] > before[k] for k in before)
    img_c, alp_c, meta_c = rasterization(*args, sh_degree=3, device="cpu")
    assert int(meta["n_isects"][0]) == int(meta_c["n_isects"][0]) > 0
    assert float((img.cpu() - img_c).abs().max()) <= 1e-4
    assert float((alp.cpu() - alp_c).abs().max()) <= 1e-4
