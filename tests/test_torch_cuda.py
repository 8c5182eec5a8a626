"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: each test skips where there is no CUDA device. This
file imports no JAX, so it also runs on a machine without it:

    python3 -m pytest tests/test_torch_cuda.py -m cuda --noconftest \
        -o addopts= -p no:cacheprovider -q

Tolerances: pack, expansion and unpack bit for bit (no pair of these
seeds lies on the cull bound); tile forward max abs 1e-4 (summation order
on the card; for 2DGS relative to each output channel's max(1, |largest|),
the median bit for bit; the redesigned B1 and B5 also the same bits twice,
and no passing slot outside their regions); tile backward 1e-4 of each
gradient row's largest |value| and segment sums 1e-5 of the largest |sum|
(the kernels sum in another order than their plain versions); every
backward kernel gives the same bits when it runs twice on the same
inputs. The packed-pair
branches (grad_dtype "bf16"): the packed tile backward is the f32 branch's
output truncated, bit for bit, and each half lies within one bf16 step
(2^-7 of its value) plus the f32 tolerance of its plain version's half;
the packed segment sums within 1e-6 of each row's largest |sum| (the same
summands in another order); the unpack of packed words bit for bit.
The sorted table's precision branches (attr_dtype "bf16", geom_dtype
"u16", log_composite): the packed expansion bit for bit (its words), the
tile kernels that read packed rows or scan in log space at the f32
branches' tolerances against their plain versions (which walk the log
scan's sums in the kernels' order), and 2DGS's log branch as its product
branch.
The legacy v1 kernels (rasterizer="pallas"): B7 at the tile forward's
tolerance and B8 at the tile backward's, against their plain versions,
B8 bit for bit across two runs, both the same bits in the
longest-run-first tile order, no passing slot outside their regions, and
rasterization(rasterizer="pallas") on the card against the CPU. B10
(cumsum_rows) within the rounding bound of its own order of additions
(raster_v2.cumsum_rows_bound: gamma of its depth
times the sum of |x| up to the element) of a float64 cumsum, on
signed and non-negative rows, and the same bits twice; B11 (the skeleton
composite) within 1e-4 of its plain version, the same bits twice, and no
composited slot outside the cells its test keeps. The expansion B3 also bit for
bit on synthetic counts in every branch: runs over many blocks, a Gaussian
a row (the block's widest staged window), zero counts inside a window,
n_isects at the capacity and at 0, capacities that are no multiple of 4,
and one Gaussian. SelectiveAdam's step (csrc/selective_adam.cu) bit for
bit against its plain version on every splat group's shape, with no row,
every row and some rows visible, on sizes that are no multiple of 4 and on
a misaligned group (its one-element path). The shN k-means on the card
against its CPU run: at least 99% of labels equal and the distortion
within 1% (the assignment's matmul sums in another order). The ortho and
fisheye cameras through rasterization forward and backward against the
CPU (the forward's and the training step's tolerances); rANS streams
written with the models and the k-means on the card decoded on the CPU
to the same bits; honest_timer on CUDA events.
"""

import dataclasses

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


def _cfg(C, N, W, H, ts, CH, cutoff="exact", cap=1 << 16, **knobs):
    return tr.V2Cfg(C=C, tile_width=-(-W // ts), tile_height=-(-H // ts),
                    tile_size=ts, channels=CH, cap=cap, n=N, cutoff=cutoff,
                    **knobs)


# the sorted table's precision branches, each alone and all together
KNOBS = [dict(attr_dtype="bf16"), dict(geom_dtype="u16"),
         dict(log_composite=True),
         dict(attr_dtype="bf16", geom_dtype="u16", log_composite=True)]


def _pack_case_rows(n, L, layout, g, dev):
    """n float32 rows [L]: "records", the fields of [L, 2], [L, 3] and
    [L, n - 5] blocks, as the binning's attribute rows are; "rows", the
    unit-stride rows of one [n, L] block, as the sorted table's are;
    "mixed", 5 such rows and then n - 5 fields of one record."""
    if layout == "rows":
        return list(torch.randn(n, L, generator=g).to(dev).unbind(0))
    if layout == "mixed":
        return (list(torch.randn(5, L, generator=g).to(dev).unbind(0))
                + list(torch.randn(L, n - 5, generator=g).to(dev).unbind(1)))
    rows = []
    for w in (2, 3, max(n - 5, 1)):
        rows += list(torch.randn(L, w, generator=g).to(dev).unbind(1))
    return rows[:n]


# (rows, source columns, layout): 1 to the widest table's 144 rows at a
# length that no block's columns divide, then the 1M scene's lengths (1M
# Gaussians, 3.3M-4.6M intersections), where unit-stride rows (>= 8 MB a
# row) are gathered two at a time
@pytest.mark.parametrize("n,L,layout", [
    (1, 70_001, "records"), (10, 70_001, "records"), (20, 70_001, "records"),
    (144, 70_001, "records"), (10, 70_001, "rows"), (2, 2_100_003, "rows"),
    (3, 2_300_007, "rows"), (10, 3_500_017, "rows"),
    (12, 2_100_003, "mixed"), (10, 3_500_017, "records"),
    (2, 4_600_001, "records")])
def test_pack_kernel_matches_plain(cuda, n, L, layout):
    """Bit for bit: record fields (gathered a record at a time), unit-stride
    rows (at these lengths two at a time) and both, zero-filled rows beyond
    them, no permutation, a full one and a gather of fewer columns."""
    g = torch.Generator(device="cpu").manual_seed(n)
    rows = _pack_case_rows(n, L, layout, g, cuda)
    if layout == "records":
        assert [r.stride(0) for r in rows[:5]] == [2, 2, 3, 3, 3][:n]
    perm = torch.randperm(L, generator=g).to(cuda)
    before = tr.LAUNCHES["pack_rows"]
    for p in (None, perm, perm[:L - 13]):
        for R in (n, n + 3):
            out = tr.pack_rows(rows, R, p)
            assert torch.equal(out, tr._pack_rows_plain(rows, R, p)), (p is
                                                                       None, R)
    assert tr.LAUNCHES["pack_rows"] == before + 6


def test_expand_kernel_matches_plain(cuda):
    m2, con, col, op, dep, radii = _scene(1)
    C, N = dep.shape
    t = [torch.as_tensor(x, device=cuda) for x in (m2, con, col, op, dep)]
    rad = torch.as_tensor(radii, device=cuda)
    for ts in (16, 32):
        cfg = _cfg(C, N, 200, 136, ts, 3)
        order, cum, base, nx, n_isects = tr._compact(cfg, t[0], rad, t[4])
        table = tr.pack_rows(tr._attr_rows(cfg, *t[:4]), cfg.n_attr_eff, order)
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
    assert all(tr.LAUNCHES[k] > before[k]
               for k in ("pack_rows", "expand", "raster_fwd"))
    img_c, alp_c, meta_c = rasterization(*args, sh_degree=3, device="cpu")
    assert int(meta["n_isects"][0]) == int(meta_c["n_isects"][0]) > 0
    assert float((img.cpu() - img_c).abs().max()) <= 1e-4
    assert float((alp.cpu() - alp_c).abs().max()) <= 1e-4


def _sorted_case(cuda, seed, ts, cutoff, CH=3, **knobs):
    m2, con, col, op, dep, radii = _scene(seed, CH=CH)
    C, N = dep.shape
    cfg = _cfg(C, N, 200, 136, ts, CH, cutoff, **knobs)
    b = tr._build_sorted(cfg, *[torch.as_tensor(x, device=cuda)
                                for x in (m2, con, col, op, dep, radii)])
    g = torch.Generator(device="cpu").manual_seed(seed)
    masks = (torch.rand(cfg.n_tiles, generator=g) > 0.2).to(
        device=cuda, dtype=torch.int32)
    tiles = tr.raster_fwd(b.S, b.starts, masks, cfg)
    v_tiles = torch.randn(tiles.shape, generator=g).to(cuda)
    return cfg, b, masks, tiles, v_tiles


def _rows_close(out, ref, tol):
    scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    return float(((out - ref).abs() / scale).max()) <= tol


def test_backward_kernel_matches_plain(cuda):
    for ts in (16, 32):
        for cutoff in ("exact", "soft"):
            cfg, b, masks, tiles, v_tiles = _sorted_case(cuda, 5, ts, cutoff)
            for absgrad in (False, True):
                args = (b.S, b.starts, masks, tiles, v_tiles, cfg, absgrad)
                out = tr.raster_bwd(*args)
                ref = tr._bwd_plain(*args)
                assert out.shape == (cfg.d_g(absgrad), cfg.cap)
                assert _rows_close(out, ref, 1e-4), (ts, cutoff, absgrad)
                assert torch.equal(out, tr.raster_bwd(*args))
                assert float(out[:2].abs().max()) > 0


def test_unpack_and_segsum_kernels_match_plain(cuda):
    cfg, b, masks, tiles, v_tiles = _sorted_case(cuda, 6, 16, "exact")
    gbuf = tr.raster_bwd(b.S, b.starts, masks, tiles, v_tiles, cfg, True)
    for perm in (None, b.perm):
        out = tr.unpack_rows(gbuf, gbuf.shape[0], perm)
        assert torch.equal(out, tr._unpack_rows_plain(gbuf, gbuf.shape[0],
                                                      perm))
    rows = tr.unpack_rows(gbuf, gbuf.shape[0], b.perm)
    seg = tr.segsum_rows(rows, b.cum, b.n_isects)
    ref = tr._segsum_plain(rows, b.cum, b.n_isects)
    scale = float(ref.abs().max())
    assert scale > 0 and float((seg - ref).abs().max()) <= 1e-5 * scale
    assert torch.equal(seg, tr.segsum_rows(rows, b.cum, b.n_isects))
    # truncation: a capacity below the total leaves partial sums
    cut = torch.full_like(b.n_isects, int(b.n_isects) // 2)
    seg = tr.segsum_rows(rows, torch.clamp(b.cum, max=int(cut)), cut)
    ref = tr._segsum_plain(rows, torch.clamp(b.cum, max=int(cut)), cut)
    assert float((seg - ref).abs().max()) <= 1e-5 * scale


def _halves(words):
    hi, lo = tr.unpack_pairs(words)
    return torch.cat([hi, lo])


@pytest.mark.parametrize("CH", [3, 4])  # 9 and 10 attribute rows
def test_packed_backward_kernel_matches_plain(cuda, CH):
    for ts in (16, 32):
        for cutoff in ("exact", "soft"):
            cfg, b, masks, tiles, v_tiles = _sorted_case(cuda, 8, ts, cutoff,
                                                         CH)
            for absgrad in (False, True):
                args = (b.S, b.starts, masks, tiles, v_tiles, cfg, absgrad)
                out = tr.raster_bwd(*args, packed=True)
                assert out.dtype == torch.int32
                assert out.shape == (cfg.d_gp(absgrad), cfg.cap)
                assert torch.equal(out, tr.raster_bwd(*args, packed=True))
                # the f32 branch's sums, truncated at the final write
                f32 = tr.raster_bwd(*args)
                assert torch.equal(out, tr._pack_grad_rows(
                    f32, cfg.n_attr_eff, absgrad))
                ref = tr._bwd_packed_plain(*args)
                h, hr = _halves(out), _halves(ref)
                scale = hr.abs().amax(dim=1, keepdim=True)
                tol = 2.0 ** -7 * hr.abs() + 1e-4 * (1 + 2.0 ** -7) * scale
                assert bool(((h - hr).abs() <= tol).all())
                assert float((out == ref).float().mean()) > 0.9
                assert float(h[:2].abs().max()) > 0


def test_packed_unpack_and_segsum_kernels_match_plain(cuda):
    cfg, b, masks, tiles, v_tiles = _sorted_case(cuda, 9, 16, "exact")
    packed = tr.raster_bwd(b.S, b.starts, masks, tiles, v_tiles, cfg, True,
                           packed=True)
    d = packed.shape[0]
    rows = tr.unpack_rows(packed, d, b.perm)
    assert rows.dtype == torch.int32
    assert torch.equal(rows, tr._unpack_rows_plain(packed, d, b.perm))
    seg = tr.segsum_rows(rows, b.cum, b.n_isects)
    assert seg.shape == (2 * d, cfg.C * cfg.n)
    ref = tr._segsum_plain(rows, b.cum, b.n_isects)
    assert _rows_close(seg, ref, 1e-6)
    assert torch.equal(seg, tr.segsum_rows(rows, b.cum, b.n_isects))
    cut = torch.full_like(b.n_isects, int(b.n_isects) // 2)
    cum = torch.clamp(b.cum, max=int(cut))
    assert _rows_close(tr.segsum_rows(rows, cum, cut),
                       tr._segsum_plain(rows, cum, cut), 1e-6)


def test_rasterization_gradients_on_card_match_cpu(cuda):
    rng = np.random.default_rng(7)
    N, W, H = 3000, 160, 120
    means = (rng.standard_normal((N, 3)) * [1.5, 1.0, 1.5]).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.5, 0.5, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    sh = (rng.standard_normal((N, 16, 3)) * 0.3).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 5.0
    K = np.array([[[150, 0, W / 2], [0, 150, H / 2], [0, 0, 1]]], np.float32)
    ct = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [torch.tensor(x, device=dev, requires_grad=True)
                  for x in (means, quats, scales, opac, sh)]
        probe = torch.zeros((1, N, 2), device=dev, requires_grad=True)
        before = dict(tr.LAUNCHES)
        img, _, _ = rasterization(*leaves, vm[None], K, W, H, sh_degree=3,
                                  means2d_probe=probe, device=dev)
        (img * torch.as_tensor(ct, device=dev)).sum().backward()
        if dev.type == "cuda":
            for name in ("raster_bwd", "segsum_rows"):
                assert tr.LAUNCHES[name] == before[name] + 1
            assert tr.LAUNCHES["unpack_rows"] == before["unpack_rows"] + 2
        grads[dev.type] = [t.grad.cpu() for t in leaves + [probe]]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-3 * scale


def test_per_camera_rgb_ed_on_card_matches_cpu(cuda):
    """B1 and B2 at 4 channels with per-camera colours, as the trainer
    renders under app_opt and depth_loss: [C, N, 3] colours with no SH,
    render_mode "RGB+ED", two cameras; the colours and alphas within 1e-4,
    the expected depth times the alpha (the kernel's depth channel, before
    the division that would amplify its rounding where the alpha is small)
    within 1e-4 of the largest depth, and every gradient within 1e-3 of its
    largest |.| of the CPU's plain versions; one launch of each kernel a
    pass."""
    rng = np.random.default_rng(11)
    C, N, W, H = 2, 3000, 160, 120
    means = (rng.standard_normal((N, 3)) * [1.5, 1.0, 1.5]).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.5, 0.5, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    colors = rng.random((C, N, 3)).astype(np.float32)
    vm = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    vm[:, 2, 3] = 5.0
    vm[1, 0, 3] = 0.3
    K = np.tile(np.array([[150, 0, W / 2], [0, 150, H / 2], [0, 0, 1]],
                         np.float32), (C, 1, 1))
    ct = rng.standard_normal((C, H, W, 4)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [torch.tensor(x, device=dev, requires_grad=True)
                  for x in (means, quats, scales, opac, colors)]
        before = dict(tr.LAUNCHES)
        img, alpha, _ = rasterization(*leaves, vm, K, W, H, sh_degree=None,
                                      render_mode="RGB+ED", device=dev)
        assert img.shape == (C, H, W, 4)
        (img * torch.as_tensor(ct, device=dev)).sum().backward()
        if dev.type == "cuda":
            for name in ("raster_fwd", "raster_bwd"):
                assert tr.LAUNCHES[name] == before[name] + 1, name
        img, alpha = img.detach().cpu(), alpha.detach().cpu()
        out[dev.type] = (torch.cat([img[..., :3], alpha,
                                    img[..., 3:] * alpha], -1),
                         [t.grad.cpu() for t in leaves])
    diff = (out["cuda"][0] - out["cpu"][0]).abs()
    assert float(diff[..., :4].max()) <= 1e-4
    assert float(diff[..., 4].max()) <= 1e-4 * float(
        out["cpu"][0][..., 4].max())
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-3 * scale


def test_bf16_rasterization_gradients_on_card_match_cpu(cuda):
    """grad_dtype="bf16" through the packed branches on the card against
    the plain versions on the CPU: within 1e-2 of each gradient's scale, as
    a sum that differs in its last f32 bits may truncate one bf16 step
    (2^-7 of its value) apart."""
    rng = np.random.default_rng(8)
    N, W, H = 3000, 160, 120
    means = (rng.standard_normal((N, 3)) * [1.5, 1.0, 1.5]).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.5, 0.5, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    sh = (rng.standard_normal((N, 16, 3)) * 0.3).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 5.0
    K = np.array([[[150, 0, W / 2], [0, 150, H / 2], [0, 0, 1]]], np.float32)
    ct = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [torch.tensor(x, device=dev, requires_grad=True)
                  for x in (means, quats, scales, opac, sh)]
        before = dict(tr.LAUNCHES)
        img, _, _ = rasterization(*leaves, vm[None], K, W, H, sh_degree=3,
                                  grad_dtype="bf16", device=dev)
        (img * torch.as_tensor(ct, device=dev)).sum().backward()
        if dev.type == "cuda":
            for name in ("raster_bwd_packed", "segsum_rows_packed"):
                assert tr.LAUNCHES[name] == before[name] + 1
            for name in ("raster_bwd", "segsum_rows"):
                assert tr.LAUNCHES[name] == before[name]
            assert tr.LAUNCHES["unpack_rows"] == before["unpack_rows"] + 2
        grads[dev.type] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("CH", [40, 128])
def test_wide_channel_kernels_match_plain(cuda, CH):
    """B1 and B2 at the template bounds above 32 channels (64 and 128)."""
    for cutoff in ("exact", "soft"):
        cfg, b, masks, tiles, v_tiles = _sorted_case(cuda, 9, 16, cutoff,
                                                     CH=CH)
        ref = tr._fwd_plain(b.S, b.starts, masks, cfg)
        assert float((tiles - ref).abs().max()) <= 1e-4, (CH, cutoff)
        args = (b.S, b.starts, masks, tiles, v_tiles, cfg, False)
        out = tr.raster_bwd(*args)
        assert _rows_close(out, tr._bwd_plain(*args), 1e-4), (CH, cutoff)
        assert torch.equal(out, tr.raster_bwd(*args))


@pytest.mark.parametrize("D", [40, 130])
def test_wide_renders_on_card_match_cpu(cuda, D):
    """rasterization at D = 40 (one binning) and D = 130 (128 + 2),
    forward and backward, on the card against the CPU."""
    rng = np.random.default_rng(D)
    N, W, H = 2000, 128, 96
    means = (rng.standard_normal((N, 3)) * [1.5, 1.0, 1.5]).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.5, 0.5, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    colors = rng.random((N, D)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 5.0
    K = np.array([[[120, 0, W / 2], [0, 120, H / 2], [0, 0, 1]]], np.float32)
    ct = rng.standard_normal((1, H, W, D)).astype(np.float32)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [torch.tensor(x, device=dev, requires_grad=True)
                  for x in (means, quats, scales, opac, colors)]
        img, alp, _ = rasterization(*leaves, vm[None], K, W, H, device=dev)
        (img * torch.as_tensor(ct, device=dev)).sum().backward()
        outs[dev.type] = [img.detach().cpu(), alp.detach().cpu()] + [
            t.grad.cpu() for t in leaves]
    assert outs["cuda"][0].shape == (1, H, W, D)
    for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
        assert float((a - b).abs().max()) <= 1e-4
    for a, b in zip(outs["cuda"][2:], outs["cpu"][2:]):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-3 * scale


def _surfel_case(cuda, seed, cutoff, N=3000, W=200, H=136,
                 log_composite=False, ts=16, CB=7, tiny=0):
    """Projected surfels of a seeded scene, binned for the 2DGS kernels at
    tile ``ts``. CB composited channels: CB - 4 user channels (the
    scene's 3 colours, or seeded uniform ones), the depth, 3 normals.
    ``tiny`` adds surfels that composite one pixel each: the ray transform
    [[s, 0, u0], [0, s, v0], [0, 0, 1]] at a pixel centre (u0, v0), s = 0.1,
    so alpha = op * exp(-d^2) at a pixel d away, and op = 0.008 passes the
    1/255 test at the centre alone."""
    from gscodec_studio_tpu_torch.ops import raster_v2_2dgs as t2
    from gscodec_studio_tpu_torch.rendering import project_and_shade_2dgs

    rng = np.random.default_rng(seed)
    means = (rng.standard_normal((N, 3)) * [1.5, 1.0, 1.5]).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.0, 0.5, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    colors = rng.random((N, 3)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 5.0
    K = np.array([[[150, 0, W / 2], [0, 150, H / 2], [0, 0, 1]]], np.float32)
    t = [torch.as_tensor(x, device=cuda) for x in (means, quats, scales,
                                                   opac, colors)]
    radii, m2, dep, trans, nrm, col, op = project_and_shade_2dgs(
        *t, torch.as_tensor(vm[None], device=cuda),
        torch.as_tensor(K, device=cuda), W, H)
    g = torch.Generator(device="cpu").manual_seed(seed)
    user = col[..., :3] if CB == 7 else torch.rand(
        (1, N, CB - 4), generator=g).to(cuda)
    colors_full = torch.cat([user, col[..., 3:], nrm], -1)
    if tiny:
        u = (torch.randint(0, W, (tiny,), generator=g) + 0.5).to(cuda)
        v = (torch.randint(0, H, (tiny,), generator=g) + 0.5).to(cuda)
        one, zero = torch.ones_like(u), torch.zeros_like(u)
        m2 = torch.cat([m2, torch.stack([u, v], -1)[None]], 1)
        trans = torch.cat([trans, torch.stack(
            [0.1 * one, zero, u, zero, 0.1 * one, v, zero, zero, one],
            -1).reshape(1, tiny, 3, 3)], 1)
        colors_full = torch.cat([colors_full, torch.rand(
            (1, tiny, CB), generator=g).to(cuda)], 1)
        op = torch.cat([op, torch.full((1, tiny), 0.008, device=cuda)], 1)
        dep = torch.cat([dep, (4.0 + 2.0 * torch.rand(
            (1, tiny), generator=g)).to(cuda)], 1)
        radii = torch.cat([radii, torch.ones(
            (1, tiny, 2), dtype=radii.dtype, device=cuda)], 1)
        N += tiny
    cfg = t2.cfg_2dgs(1, -(-W // ts), -(-H // ts), ts, CB, 1 << 17, N,
                      cutoff=cutoff, log_composite=log_composite)
    b = t2._build_sorted_2dgs(cfg, m2.contiguous(), trans.contiguous(),
                              colors_full.contiguous(), op.contiguous(),
                              dep.contiguous(), radii.contiguous())
    masks = (torch.rand(cfg.n_tiles, generator=g) > 0.2).to(
        device=cuda, dtype=torch.int32)
    return t2, cfg, b, masks, g


@pytest.mark.parametrize("knobs", KNOBS[:2] + KNOBS[3:])
def test_packed_expand_kernel_matches_plain(cuda, knobs):
    m2, con, col, op, dep, radii = _scene(1)
    C, N = dep.shape
    t = [torch.as_tensor(x, device=cuda) for x in (m2, con, col, op, dep)]
    rad = torch.as_tensor(radii, device=cuda)
    cfg = _cfg(C, N, 200, 136, 16, 3, **knobs)
    order, cum, base, nx, n_isects = tr._compact(cfg, t[0], rad, t[4])
    table = tr.pack_rows(tr._attr_rows(cfg, *t[:4]), cfg.n_attr_eff, order)
    before = tr.LAUNCHES["expand_packed"]
    tile, rows = tr.expand(cum, base, nx, table, n_isects, cfg)
    assert tr.LAUNCHES["expand_packed"] == before + 1
    tile_p, rows_p = tr._expand_plain(cum, base, nx, table, n_isects, cfg)
    assert rows.shape == (cfg.d_s, cfg.cap)
    assert torch.equal(tile, tile_p)
    assert torch.equal(rows.view(torch.int32), rows_p.view(torch.int32))


@pytest.mark.parametrize("knobs", KNOBS)
def test_precision_branches_match_plain(cuda, knobs):
    """B1 and B2 (f32 and packed-pair gradient rows, absgrad off and on)
    for each branch, at tiles 16 and 32 and both cutoffs."""
    for ts in (16, 32):
        for cutoff in ("exact", "soft"):
            cfg, b, masks, tiles, v_tiles = _sorted_case(cuda, 5, ts, cutoff,
                                                         **knobs)
            ref = tr._fwd_plain(b.S, b.starts, masks, cfg)
            assert float((tiles - ref).abs().max()) <= 1e-4, (ts, cutoff)
            assert float(tiles[..., -1].max()) > 0.5
            for absgrad in (False, True):
                args = (b.S, b.starts, masks, tiles, v_tiles, cfg, absgrad)
                out = tr.raster_bwd(*args)
                assert _rows_close(out, tr._bwd_plain(*args), 1e-4), (
                    ts, cutoff, absgrad)
                assert torch.equal(out, tr.raster_bwd(*args))
                gp = tr.raster_bwd(*args, packed=True)
                assert torch.equal(gp, tr._pack_grad_rows(
                    out, cfg.n_attr_eff, absgrad))


def test_bench_configuration_on_card_matches_cpu(cuda):
    """bench.py's packed configuration (tile 32, soft, bf16 attribute and
    gradient rows, the log scan) through rasterization, card against CPU:
    images within 5e-4 (the log scan's log1p and exp come from two math
    libraries here, and its sums of up to 128 terms carry their ulps into
    T; the same device's kernel and plain version agree within 1e-4 above),
    gradients within 2^-6 of each tensor's scale (the bf16 rows truncate
    f32 sums taken in another order)."""
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
    kw = dict(sh_degree=3, tile_size=32, cutoff_mode="soft",
              grad_dtype="bf16", attr_dtype="bf16", log_composite=True)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        means_t = torch.tensor(means, device=dev, requires_grad=True)
        img, alp, _ = rasterization(means_t, quats, scales, opac, sh,
                                    vm[None], K, W, H, device=dev, **kw)
        loss = ((img - 0.5) ** 2).mean() + 0.1 * alp.mean()
        loss.backward()
        res[dev.type] = (img.detach().cpu(), means_t.grad.cpu())
    assert float((res["cuda"][0] - res["cpu"][0]).abs().max()) <= 5e-4
    g, gc = res["cuda"][1], res["cpu"][1]
    assert float((g - gc).abs().max()) <= 2.0 ** -6 * float(gc.abs().max())


def test_no_cull_expand_kernel_matches_plain(cuda):
    t2, cfg, b, masks, _ = _surfel_case(cuda, 12, "exact")
    n = int(b.n_isects[0])
    assert n > 1000 and not cfg.cull
    tile_p, rows_p = tr._expand_plain(b.cum, b.base, b.nx, b.table,
                                      b.n_isects, cfg)
    assert torch.equal(b.tile, tile_p) and torch.equal(b.rows, rows_p)
    assert int((b.tile[:n] == cfg.n_tiles).sum()) == 0


@pytest.mark.parametrize("CB", [4, 7, 40, 128])
@pytest.mark.parametrize("ts", [8, 16, 32])
@pytest.mark.parametrize("log_composite", [False, True])
def test_2dgs_kernels_match_plain(cuda, log_composite, ts, CB):
    """B5 within 1e-4 of each output channel's scale (max(1, |largest|)),
    the median bit for bit; B6 within 1e-4 of each gradient row's largest
    |value| and the same bits twice; in the product and the log branch, at
    tiles 8 to 32 and 4 to 128 channels (each of B6's builds and
    pixels-a-thread layouts, the halved partials of the widest tables, and
    B5's tile-32 builds: 512 threads, and 1024 at 1 pixel a thread)."""
    key = "raster_fwd_2dgs_log" if log_composite else "raster_fwd_2dgs"
    for cutoff in ("exact", "soft"):
        t2, cfg, b, masks, g = _surfel_case(cuda, 13, cutoff,
                                            log_composite=log_composite,
                                            ts=ts, CB=CB)
        zch = cfg.channels - 4
        before = dict(tr.LAUNCHES)
        out = t2.raster_fwd_2dgs(b.S, b.starts, masks, cfg, zch)
        assert tr.LAUNCHES[key] == before[key] + 1
        ref = t2._fwd_2dgs_plain(b.S, b.starts, masks, cfg, zch)
        scale = ref.abs().amax(dim=(0, 1)).clamp(min=1.0)
        assert float(((out - ref).abs().amax(dim=(0, 1)) / scale).max()) \
            <= 1e-4, cutoff
        assert torch.equal(out[..., -1], ref[..., -1]), cutoff
        assert float(out[..., cfg.channels].max()) > 0.5
        v_tiles = torch.randn(out.shape, generator=g).to(cuda)
        args = (b.S, b.starts, masks, out, v_tiles, cfg, zch)
        gbuf = t2.raster_bwd_2dgs(*args)
        assert gbuf.shape == (12 + cfg.channels, cfg.cap)
        assert _rows_close(gbuf, t2._bwd_2dgs_plain(*args), 1e-4), cutoff
        assert torch.equal(gbuf, t2.raster_bwd_2dgs(*args))
        assert float(gbuf[:11].abs().max()) > 0


@pytest.mark.parametrize("log_composite", [False, True])
def test_2dgs_backward_single_lane_pairs_match_plain(cuda, log_composite):
    """B6 on a scene where many pairs are composited by one pixel of a warp
    (the ballot shortcut: that lane's values are the warp's sums), counted
    by the plain walk, within 1e-4 of each gradient row's largest |value|
    of its plain version and the same bits twice."""
    for cutoff in ("exact", "soft"):
        t2, cfg, b, masks, g = _surfel_case(cuda, 15, cutoff,
                                            log_composite=log_composite,
                                            tiny=400)
        counts = t2._bwd_2dgs_counts(b.S, b.starts, masks, cfg)
        assert counts["single_lane_hits"] >= 100, counts["single_lane_hits"]
        zch = cfg.channels - 4
        out = t2.raster_fwd_2dgs(b.S, b.starts, masks, cfg, zch)
        v_tiles = torch.randn(out.shape, generator=g).to(cuda)
        args = (b.S, b.starts, masks, out, v_tiles, cfg, zch)
        gbuf = t2.raster_bwd_2dgs(*args)
        assert _rows_close(gbuf, t2._bwd_2dgs_plain(*args), 1e-4), cutoff
        assert torch.equal(gbuf, t2.raster_bwd_2dgs(*args))


def test_rasterization_2dgs_on_card_matches_cpu(cuda):
    from gscodec_studio_tpu_torch.rendering import rasterization_2dgs

    rng = np.random.default_rng(14)
    N, W, H = 3000, 160, 120
    means = (rng.standard_normal((N, 3)) * [1.5, 1.0, 1.5]).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.0, 0.5, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    sh = (rng.standard_normal((N, 16, 3)) * 0.3).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 5.0
    K = np.array([[[150, 0, W / 2], [0, 150, H / 2], [0, 0, 1]]], np.float32)
    cts = [rng.standard_normal((1, H, W, c)).astype(np.float32)
           for c in (3, 1, 3, 1)]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [torch.tensor(x, device=dev, requires_grad=True)
                  for x in (means, quats, scales, opac, sh)]
        before = dict(tr.LAUNCHES)
        out = rasterization_2dgs(*leaves, vm[None], K, W, H, sh_degree=3,
                                 rasterizer="fused", device=dev)
        loss = sum((o * torch.as_tensor(c, device=dev)).sum()
                   for o, c in zip((out[0], out[1], out[2], out[4]), cts))
        loss.backward()
        if dev.type == "cuda":
            for name in ("raster_fwd_2dgs", "raster_bwd_2dgs", "expand"):
                assert tr.LAUNCHES[name] == before[name] + 1, name
        outs[dev.type] = ([o.detach().cpu() for o in out[:6]],
                          [t.grad.cpu() for t in leaves])
    # the projection's products round differently on the card, which can
    # move a pair across the 1/255 alpha test or the 1e-4 cutoff: the
    # image tolerance of test_torch_rendering (5e-3 at most, 99.9% within
    # 1e-4), relative to max(1, the output's largest |value|)
    for a, b in zip(outs["cuda"][0], outs["cpu"][0]):
        d = (a - b).abs() / max(1.0, float(b.abs().max()))
        assert float(d.max()) <= 5e-3
        assert float((d <= 1e-4).float().mean()) >= 0.999
    for a, b in zip(outs["cuda"][1], outs["cpu"][1]):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-3 * scale


def _v1_case(cuda, seed, ts, cutoff, CH=3, C=2, N=3000, W=200, H=136):
    """The aligned table of a _scene's scalar-radius binning: (packed,
    starts, ends, cfg) for the v1 kernels."""
    from gscodec_studio_tpu_torch.ops import isect as ti
    from gscodec_studio_tpu_torch.ops import rasterize_pallas as rp
    m2, con, col, op, dep, radii = _scene(seed, C=C, N=N, W=W, H=H, CH=CH)
    TW, TH = -(-W // ts), -(-H // ts)
    dev = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    isect = ti.isect_tiles(dev(m2), dev(radii).amax(-1), dev(dep), ts, TW,
                           TH, 1 << 17)
    al = ti.align_isects(isect, C, TW, TH, rp.K_CHUNK)
    cfg = rp.RasterCfg(C=C, tile_width=TW, tile_height=TH, tile_size=ts,
                       channels=CH, cap=1 << 17, cap2=al.ids.shape[0],
                       m=C * N, cutoff=cutoff)
    flat = torch.cat([dev(m2).reshape(-1, 2), dev(con).reshape(-1, 3),
                      dev(op).reshape(-1, 1), dev(col).reshape(-1, CH)], -1)
    return rp._pack(flat, al.ids), al.starts, al.ends, cfg, isect, al


def _v1_kernels_close(packed, starts, ends, cfg, seed):
    """B7 and B8 against their plain versions (max abs 1e-4; 1e-4 of each
    gradient row's largest |value|), one launch each, B8 twice for the same
    bits, both the same bits in the longest-run-first tile order, and no
    slot that passes the alpha test outside its pair's candidate region.
    Returns (colors, alphas, B8's rows)."""
    from gscodec_studio_tpu_torch.ops import rasterize_pallas as rp
    tr.reset_launch_counts()
    col, alp = rp.raster_v1_fwd(packed, starts, ends, cfg)
    col_p, alp_p = rp._fwd_plain(packed, starts, ends, cfg)
    assert tr.LAUNCHES["raster_v1_fwd"] == 1
    assert float((col - col_p).abs().max()) <= 1e-4
    assert float((alp - alp_p).abs().max()) <= 1e-4
    g = torch.Generator(device="cpu").manual_seed(seed)
    v_col = torch.randn(col.shape, generator=g).to(packed.device)
    v_alp = torch.randn(alp.shape, generator=g).to(packed.device)
    bargs = (packed, starts, ends, col, alp, v_col, v_alp, cfg)
    out = rp.raster_v1_bwd(*bargs)
    again = rp.raster_v1_bwd(*bargs)
    assert tr.LAUNCHES["raster_v1_bwd"] == 2
    assert torch.equal(out, again)
    q0 = (col * v_col).sum(1, keepdim=True)
    ref = rp._bwd_plain(packed, starts, ends, v_col, v_alp, alp, q0, cfg)
    assert _rows_close(out.T, ref.T, 1e-4)
    order = rp.run_order(starts, ends)
    col_o, alp_o = rp.raster_v1_fwd(packed, starts, ends, cfg, order=order)
    assert torch.equal(col_o, col) and torch.equal(alp_o, alp)
    assert torch.equal(rp.raster_v1_bwd(*bargs, order=order), out)
    assert rp._region_counts(packed, starts, ends, cfg)["missed_slots"] == 0
    return col, alp, out


@pytest.mark.parametrize("CH", [3, 40, 64, 128])
@pytest.mark.parametrize("cutoff", ["exact", "soft"])
@pytest.mark.parametrize("ts", [16, 32])
def test_v1_kernels_match_plain(cuda, ts, cutoff, CH):
    """B7 and B8 (redesigned: 2 pixels a thread up to 32 channels, 1 above;
    tile 32 at 512 threads, and 1024 at 64 and 128 channels) as
    _v1_kernels_close holds them, and the per-Gaussian reductions."""
    from gscodec_studio_tpu_torch.ops import rasterize_pallas as rp
    packed, starts, ends, cfg, isect, al = _v1_case(cuda, 11, ts, cutoff,
                                                    CH=CH)
    _, alp, out = _v1_kernels_close(packed, starts, ends, cfg, ts)
    assert float(alp.max()) > 0.5
    # the per-Gaussian reductions: within 2 gamma(cap2) of each column's
    # sum of |rows| of a float64 sum (the "sort" and "cumsum" modes take
    # differences of f32 running sums over the whole table)
    ids = torch.where(al.ids >= 0, al.ids, cfg.m).long()
    exact = torch.zeros((cfg.m + 1, cfg.d), dtype=torch.float64,
                        device=cuda).index_add_(0, ids, out.double())[:-1]
    ku = cfg.cap2 * 2.0 ** -24
    bound = 2 * ku / (1 - ku) * out.abs().double().sum(0)
    for mode in rp.SEGRED_MODES:
        before = tr.LAUNCHES["cumsum_rows"]
        got = rp.segment_reduce(out, al.ids, isect.exp_offsets, al.inv_perm,
                                isect.n_isects,
                                dataclasses.replace(cfg, segred=mode))
        assert bool(((got.double() - exact).abs() <= bound).all()), mode
        # the "sort" and "cumsum" running sums go through B10
        assert tr.LAUNCHES["cumsum_rows"] == before + (mode != "scatter")


@pytest.mark.parametrize("CH", [3, 64])
@pytest.mark.parametrize("cutoff", ["exact", "soft"])
@pytest.mark.parametrize("ts", [16, 32])
def test_v1_kernels_adversarial_regions(cuda, ts, cutoff, CH):
    """B7 and B8 as _v1_kernels_close holds them on the scenes of
    tests/test_torch_raster_v1_counts.py: near-degenerate conics,
    opacities just above 1/255, box edges on the cells' pixel centres, and
    opaque Gaussians under them (the exact cutoff, the tile's stop)."""
    from test_torch_raster_v1_counts import _scene as v1_counts_scene
    packed, starts, ends, cfg = v1_counts_scene(ts + CH, ts, cutoff, CH)
    _v1_kernels_close(packed.to(cuda), starts.to(cuda), ends.to(cuda), cfg,
                      ts + CH)


def test_v1_rasterization_on_card_matches_cpu(cuda):
    from gscodec_studio_tpu_torch.ops import rasterize_pallas as rp
    rng = np.random.default_rng(5)
    N, W, H = 4000, 160, 120
    means = (rng.standard_normal((N, 3)) * [1.5, 1.0, 1.5]).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.5, 0.5, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    colors = rng.random((N, 3)).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 5.0
    K = np.array([[[150, 0, W / 2], [0, 150, H / 2], [0, 0, 1]]], np.float32)
    args = [means, quats, scales, opac, colors, vm[None], K]
    # the "scatter" reduction sums each Gaussian's own rows: the CPU and
    # the card then differ by the kernels' summation order alone (the
    # "sort" one's f32 running sums over the whole table, taken in float64
    # by torch.cumsum on the CPU and in float32 on the card, differ by
    # more: test_v1_kernels_match_plain bounds them)
    for cutoff in ("exact", "soft"):
        rp.CUTOFF_MODE, rp.SEGRED_MODE = cutoff, "scatter"
        try:
            outs = {}
            for dev in ("cpu", "cuda"):
                leaves = [torch.tensor(a, device=dev, requires_grad=True)
                          for a in args[:5]]
                tr.reset_launch_counts()
                img, alp, meta = rasterization(
                    *leaves, *args[5:], W, H, rasterizer="pallas",
                    isect_capacity=1 << 16, device=dev)
                loss = (img ** 2).sum() + alp.sum()
                grads = torch.autograd.grad(loss, leaves)
                outs[dev] = (img, alp, grads, dict(tr.LAUNCHES))
        finally:
            rp.CUTOFF_MODE, rp.SEGRED_MODE = "soft", "sort"
        assert outs["cuda"][3]["raster_v1_fwd"] == 1
        assert outs["cuda"][3]["raster_v1_bwd"] == 1
        assert outs["cpu"][3]["raster_v1_fwd"] == 0
        for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
            assert float((a.cpu() - b).abs().max()) <= 1e-4
        for a, b in zip(outs["cuda"][2], outs["cpu"][2]):
            scale = float(b.abs().max()) + 1e-12
            assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale


# B10's lengths: a segment and a group of segments (the chain's unit) +-1,
# rows whose starts are not 16-byte aligned, up to 134 rows, the v1
# reduction's [9, cap2] at scene_1m_v1, and four groups a row
_SEG, _GRP = tr.CUMSUM_SEG, tr.CUMSUM_GROUP * tr.CUMSUM_SEG
CUMSUM_SHAPES = ((1, 1), (134, 3), (3, _SEG - 1), (2, _SEG + 1),
                 (9, 3 * 8192), (1, _GRP - 1), (2, _GRP + 1),
                 (134, _SEG * 5 + 17), (2, 3 * _GRP + _SEG + 3),
                 (9, 8_557_056))


@pytest.mark.parametrize("draw", ["randn", "rand"])
def test_cumsum_rows_kernel_matches_torch(cuda, draw):
    g = torch.Generator(device="cpu").manual_seed(3)
    for shape in CUMSUM_SHAPES:
        x = getattr(torch, draw)(shape, generator=g).to(cuda)
        tr.reset_launch_counts()
        out = tr.cumsum_rows(x)
        assert tr.LAUNCHES["cumsum_rows"] == 1
        assert torch.equal(out, tr.cumsum_rows(x))
        ref = torch.cumsum(x.double(), 1)
        bound = tr.cumsum_rows_bound(x)
        assert bool(((out.double() - ref).abs() <= bound).all()), shape


def _expand_case(cuda, counts, cap, knobs, seed, CH=3, TW=12, TH=9, ts=16):
    """B3's inputs for per-Gaussian intersection ``counts`` (clamped at
    ``cap``): random first tiles, rect widths and table values (positions
    over the grid, conics whose ellipse cull keeps some pairs and not
    others)."""
    rng = np.random.default_rng(seed)
    M = len(counts)
    cfg = tr.V2Cfg(C=1, tile_width=TW, tile_height=TH, tile_size=ts,
                   channels=CH, cap=cap, n=M, **knobs)
    total = np.cumsum(np.asarray(counts, np.int64))
    dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=cuda)  # noqa
    cum = dev(np.minimum(total, cap), torch.int32)
    n_isects = dev([min(int(total[-1]), cap)], torch.int32)
    base = dev(rng.integers(0, TW * TH, M), torch.int32)
    nx = dev(rng.integers(1, TW + 1, M), torch.int32)
    table = rng.random((cfg.n_attr_eff, M)).astype(np.float32)
    table[0] *= TW * ts
    table[1] *= TH * ts
    if cfg.cull:
        table[2] = 10.0 ** rng.uniform(-3, 0, M)
        table[3] = (rng.random(M) - 0.5) * 0.1 * table[2]
        table[4] = 10.0 ** rng.uniform(-3, 0, M)
    return cfg, (cum, base, nx, dev(table, torch.float32), n_isects)


def _expand_counts_case(name, rng):
    """(counts, capacity) of the named case."""
    if name == "runs":  # short runs and one over many blocks, a tail
        counts = rng.integers(1, 40, 3000)
        counts[1500] = 5000
        return counts, int(counts.sum()) + 1001
    if name == "one_each":  # every block's window at its widest
        return np.ones(7000, np.int64), 7500
    if name == "zeros_inside":  # windows wider than a block
        return rng.choice([0, 0, 0, 1, 2], 9000), 9001
    if name == "full":  # n_isects == cap, cum clamped
        counts = rng.integers(1, 9, 2000)
        return counts, int(counts.sum()) - 777
    if name == "empty":
        return np.zeros(500, np.int64), 2050
    return np.array([50]), 62  # "one_gaussian"


EXPAND_BRANCHES = {
    "cull": (dict(), 3), "cull_40": (dict(), 40),
    "u16": (dict(geom_dtype="u16"), 3),
    "bf16_odd": (dict(attr_dtype="bf16"), 3),
    "bf16_even": (dict(attr_dtype="bf16"), 4),
    "u16_bf16": (dict(attr_dtype="bf16", geom_dtype="u16"), 3),
    "no_cull": (dict(n_attr=15, cull=False), 3),
    "no_cull_52": (dict(n_attr=52, cull=False), 40),
}


@pytest.mark.parametrize("case", ["runs", "one_each", "zeros_inside",
                                  "full", "empty", "one_gaussian"])
@pytest.mark.parametrize("branch", list(EXPAND_BRANCHES))
def test_expand_kernel_redesign_matches_plain(cuda, branch, case):
    knobs, CH = EXPAND_BRANCHES[branch]
    counts, cap = _expand_counts_case(case, np.random.default_rng(7))
    cfg, args = _expand_case(cuda, counts, cap, knobs, 8, CH=CH)
    key = tr.launch_keys("expand", [(cfg.geom_packed or cfg.attr_packed,
                                     "_packed")])[0]
    before = tr.LAUNCHES[key]
    tile, rows = tr.expand(*args, cfg)
    assert tr.LAUNCHES[key] == before + 1
    tile_p, rows_p = tr._expand_plain(*args, cfg)
    assert rows.shape == (cfg.d_s, cap)
    assert torch.equal(tile, tile_p)
    assert torch.equal(rows.view(torch.int32), rows_p.view(torch.int32))
    if cfg.cull and case == "runs":  # the cull kept some pairs, not all
        n = int(args[4][0])
        culled = int((tile[:n] == cfg.n_tiles).sum())
        assert 0 < culled < n


def test_skel_kernel_matches_plain(cuda):
    """B11 within 1e-4 of its plain version on small draws of the JAX
    script's four inputs' shapes (and of runs of 200), on an input whose
    tiles stop mid-run and on the constructed pairs of make_edges; the same
    bits from two launches, one launch a call, and no composited slot
    outside the cells its test keeps."""
    from gscodec_studio_tpu_torch.profiling import kernel_skel_bench as sk
    cases = [sk.make(300, avg, term, seed=1)
             for _, avg, term, _ in sk.INPUTS]
    cases += [sk.make(300, 200, term, seed=1) for term in (None, 24.0)]
    cases += [sk.make_stop(300, 640, seed=1), sk.make_edges(300, seed=1)]
    for i, (rows, starts, ends, _) in enumerate(cases):
        rows, starts, ends = (torch.as_tensor(a, device=cuda)
                              for a in (rows, starts, ends))
        tr.reset_launch_counts()
        out = sk.skel_composite(rows, starts, ends)
        assert tr.LAUNCHES["skel_composite"] == 1
        assert torch.equal(out, sk.skel_composite(rows, starts, ends))
        assert tr.LAUNCHES["skel_composite"] == 2
        ref, c = sk._skel_plain(rows, starts, ends, with_counts=True)
        assert float((out - ref).abs().max()) <= 1e-4, i
        assert c["missed"] == 0 and c["composited"] > 0, i
        if i == len(cases) - 2:  # make_stop's
            assert c["tiles_stopped"] > 0


@pytest.mark.parametrize("ts", [8, 16, 32])
@pytest.mark.parametrize("CH", [1, 3, 40, 128])
def test_backward_kernel_redesign_matches_plain(cuda, ts, CH):
    """B2 (the redesigned kernel) in every branch at tiles 8, 16 and 32: both
    cutoffs, the product and the log scan, f32 and packed (u16 and bf16)
    input rows, absgrad off and on, f32 and packed-pair output rows, and at
    up to 8 channels both the dense build (3000 Gaussians a camera) and the
    other (60000); within 1e-4 of each row's largest |value| of the plain
    version, the same bits twice, the packed output the f32 one truncated;
    and no slot that passes the alpha test outside its pair's candidate
    region. The forward's tiles come from the plain version."""
    cases = [(n, cutoff, knobs)
             for n in ((3000, 60000) if CH <= 8 else (3000,))
             for cutoff in ("exact", "soft") for knobs in ({}, KNOBS[3])]
    for n, cutoff, knobs in cases:
        m2, con, col, op, dep, radii = _scene(11, N=n, CH=CH)
        C, N = dep.shape
        cfg = _cfg(C, N, 200, 136, ts, CH, cutoff, cap=1 << 20, **knobs)
        b = tr._build_sorted(cfg, *[torch.as_tensor(x, device=cuda)
                                    for x in (m2, con, col, op, dep,
                                              radii)])
        assert int(b.n_isects) < cfg.cap
        g = torch.Generator(device="cpu").manual_seed(ts + CH)
        masks = (torch.rand(cfg.n_tiles, generator=g) > 0.2).to(
            device=cuda, dtype=torch.int32)
        tiles = tr._fwd_plain(b.S, b.starts, masks, cfg)
        v_tiles = torch.randn(tiles.shape, generator=g).to(cuda)
        before = tr.LAUNCHES["raster_bwd_packed"]
        for absgrad in (False, True):
            args = (b.S, b.starts, masks, tiles, v_tiles, cfg, absgrad)
            out = tr.raster_bwd(*args)
            assert out.shape == (cfg.d_g(absgrad), cfg.cap)
            assert _rows_close(out, tr._bwd_plain(*args), 1e-4), (
                cutoff, knobs, absgrad)
            assert torch.equal(out, tr.raster_bwd(*args))
            gp = tr.raster_bwd(*args, packed=True)
            assert torch.equal(gp, tr._pack_grad_rows(
                out, cfg.n_attr_eff, absgrad))
            assert float(out[:2].abs().max()) > 0
        assert tr.LAUNCHES["raster_bwd_packed"] == before + 2
        c = tr._bwd_counts(b.S, b.starts, masks, cfg)
        assert c["missed_slots"] == 0
        assert c["candidate_slots"] < c["evaluated_slots"]
        assert tr.bwd_dense(cfg) == (n == 3000 and ts < 32)


@pytest.mark.parametrize("log_composite", [False, True])
def test_2dgs_backward_absgrad_matches_plain(cuda, log_composite):
    """B6's absgrad rows (tiles 16 and 32, both cutoffs) against the plain
    version within 1e-4 of each row's largest |value|, the same bits twice,
    the other rows those of the build without them, bit for bit, and one
    launch under the "_absgrad" key."""
    import dataclasses as dc

    for ts in (16, 32):
        for cutoff in ("exact", "soft"):
            t2, cfg, b, masks, g = _surfel_case(
                cuda, 12, cutoff, log_composite=log_composite, ts=ts,
                tiny=40)
            cfg = dc.replace(cfg, absgrad=True)
            tiles = t2.raster_fwd_2dgs(b.S, b.starts, masks, cfg, 3)
            v = torch.randn(tiles.shape, generator=g).to(cuda)
            args = (b.S, b.starts, masks, tiles, v, cfg, 3)
            before = tr.LAUNCHES["raster_bwd_2dgs_absgrad"]
            out = t2.raster_bwd_2dgs(*args)
            assert tr.LAUNCHES["raster_bwd_2dgs_absgrad"] == before + 1
            assert out.shape == (12 + 7 + 2, cfg.cap)
            assert _rows_close(out, t2._bwd_2dgs_plain(*args), 1e-4), (
                ts, cutoff)
            assert torch.equal(out, t2.raster_bwd_2dgs(*args))
            assert float(out[-2:].abs().max()) > 0
            off = t2.raster_bwd_2dgs(b.S, b.starts, masks, tiles, v,
                                     dc.replace(cfg, absgrad=False), 3)
            assert torch.equal(out[:-2], off)


def _forward_close(out, ref):
    return float((out - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("ts", [8, 16, 32])
@pytest.mark.parametrize("CH", [1, 3, 8, 40, 64, 128])
def test_forward_kernel_redesign_matches_plain(cuda, ts, CH):
    """B1 (the redesigned kernel) in every branch at tiles 8, 16 and 32 and
    1 to 128 channels: both cutoffs, the product and the log scan, f32,
    bf16 and u16 input rows (each alone and all together), and at up to 8
    channels both the dense build (3000 Gaussians a camera) and the other
    (60000); within 1e-4 (max abs) of the plain version, the same bits
    twice and in the longest-run-first tile order, one launch under its
    branch's key, and no slot that passes the alpha test outside its
    pair's candidate region in B1's layout."""
    cases = [(n, cutoff, knobs)
             for n in ((3000, 60000) if CH <= 8 else (3000,))
             for cutoff in ("exact", "soft") for knobs in [{}] + KNOBS]
    for n, cutoff, knobs in cases:
        m2, con, col, op, dep, radii = _scene(11, N=n, CH=CH)
        C, N = dep.shape
        cfg = _cfg(C, N, 200, 136, ts, CH, cutoff, cap=1 << 20, **knobs)
        b = tr._build_sorted(cfg, *[torch.as_tensor(x, device=cuda)
                                    for x in (m2, con, col, op, dep,
                                              radii)])
        assert int(b.n_isects) < cfg.cap
        g = torch.Generator(device="cpu").manual_seed(ts + CH)
        masks = (torch.rand(cfg.n_tiles, generator=g) > 0.2).to(
            device=cuda, dtype=torch.int32)
        keys = tr.launch_keys("raster_fwd", tr._input_branches(cfg))
        before = {k: tr.LAUNCHES[k] for k in keys}
        out = tr.raster_fwd(b.S, b.starts, masks, cfg)
        assert all(tr.LAUNCHES[k] == before[k] + 1 for k in keys)
        ref = tr._fwd_plain(b.S, b.starts, masks, cfg)
        assert _forward_close(out, ref), (n, cutoff, knobs)
        assert torch.equal(out, tr.raster_fwd(b.S, b.starts, masks, cfg))
        assert torch.equal(out, tr.raster_fwd(
            b.S, b.starts, masks, cfg, order=tr.run_order(b.starts, cfg)))
        assert float(out[..., -1].max()) > 0.5
        c = tr._fwd_counts(b.S, b.starts, masks, cfg)
        assert c["missed_slots"] == 0
        assert c["candidate_slots"] < c["evaluated_slots"]
        assert tr.bwd_dense(cfg) == (n == 3000 and ts < 32)


@pytest.mark.parametrize("CH", [40, 64, 128])
def test_forward_kernel_tile32_wide_channels(cuda, CH):
    """B1 at tile 32 above 32 channels (the 64- and 128-channel bounds at
    1024 pixels a tile, which the first design could not launch: error 701,
    too many registers for the block) against the plain version, both
    cutoffs, within 1e-4."""
    for cutoff in ("exact", "soft"):
        cfg, b, masks, tiles, _ = _sorted_case(cuda, 9, 32, cutoff, CH=CH)
        ref = tr._fwd_plain(b.S, b.starts, masks, cfg)
        assert _forward_close(tiles, ref), cutoff
        assert float(tiles[..., -1].max()) > 0.5


@pytest.mark.parametrize("CB", [4, 7, 16, 40, 64, 128])
@pytest.mark.parametrize("ts", [8, 16, 32])
def test_2dgs_forward_redesign_matches_plain(cuda, ts, CB):
    """B5 (the redesigned kernel) at tiles 8 to 32 and 4 to 128 channels,
    both cutoffs, the product and the log scan, with surfels that
    composite one pixel each among the scene's: within 1e-4 of each output
    channel's scale (max(1, |largest|)) of the plain version, the median
    bit for bit, the same bits twice and in the longest-run-first tile
    order, and no slot that passes the alpha test outside its pair's
    candidate region in B5's layout."""
    for log_composite in (False, True):
        for cutoff in ("exact", "soft"):
            t2, cfg, b, masks, g = _surfel_case(
                cuda, 14, cutoff, log_composite=log_composite, ts=ts, CB=CB,
                tiny=40)
            zch = cfg.channels - 4
            args = (b.S, b.starts, masks, cfg, zch)
            out = t2.raster_fwd_2dgs(*args)
            ref = t2._fwd_2dgs_plain(*args)
            scale = ref.abs().amax(dim=(0, 1)).clamp(min=1.0)
            assert float(((out - ref).abs().amax(dim=(0, 1))
                          / scale).max()) <= 1e-4, (log_composite, cutoff)
            assert torch.equal(out[..., -1], ref[..., -1])
            assert torch.equal(out, t2.raster_fwd_2dgs(*args))
            assert torch.equal(out, t2.raster_fwd_2dgs(
                *args, order=tr.run_order(b.starts, cfg)))
            assert float(out[..., cfg.channels].max()) > 0.5
            c = t2._fwd_2dgs_counts(b.S, b.starts, masks, cfg)
            assert c["missed_slots"] == 0
            assert c["candidate_slots"] < c["evaluated_slots"]


def _segsum_counts_case(name):
    """Range lengths (and a truncation, or None) that cut B4's merge-path
    warps of SEG_WARP_ITEMS items (8 a block) in each way the kernel must
    handle."""
    rng = np.random.default_rng(21)
    items = tr.SEG_WARP_ITEMS
    if name == "id_over_many_warps":
        return np.array([3, 90 * items + 77, 2, 5, 0, 4]), None
    if name == "end_at_warp_edge":
        # id 0's end item is warp 0's last item, id 2's columns fill warp 1
        # and its end item opens warp 2
        return np.array([items - 1, 0, items - 1, 3, 4]), None
    if name == "empty_runs":
        c = rng.integers(0, 6, 6000)
        c[100:400], c[1000:1000 + 30 * items] = 0, 0
        c[500] = 30 * items
        return c, None
    if name == "one_id":
        return np.array([1700]), None
    if name == "ragged":  # M not a multiple of a block's items
        return rng.integers(0, 4, 24 * items + 37), None
    if name == "all_empty":
        return np.zeros(5000, np.int64), None
    if name == "truncated":  # a truncation inside the long range
        c = np.array([5, 40 * items + 13, 7, 3, 0, 9])
        return c, 5 + 20 * items + 100
    raise ValueError(name)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", [
    "id_over_many_warps", "end_at_warp_edge", "empty_runs", "one_id",
    "ragged", "all_empty", "truncated"])
def test_segsum_kernel_merge_path_cases(cuda, name, packed):
    """B4 (f32) and B4p (packed pairs) on ranges that cross B4's warps,
    end at a warp's edge, run empty, stand alone (M = 1), leave a ragged
    last block, are all empty or are truncated inside: within
    segsum_rows_bound of the plain version (the same summands in another
    order), 0 for every empty id, and the same bits twice."""
    counts, cut = _segsum_counts_case(name)
    cum = torch.tensor(np.cumsum(counts), dtype=torch.int32, device=cuda)
    total = int(counts.sum())
    n = torch.tensor([total if cut is None else cut], dtype=torch.int32,
                     device=cuda)
    L = max(-(-total // 512) * 512, 512)
    g = torch.Generator(device="cpu").manual_seed(len(counts))
    d = 5
    vals = torch.randn((2 * d, L), generator=g).to(cuda)
    rows = tr.pack_pairs(vals[:d], vals[d:]) if packed else vals[:d]
    out = tr.segsum_rows(rows, cum, n)
    ref = tr._segsum_plain(rows, cum, n)
    assert out.shape == ((2 if packed else 1) * d, len(counts))
    assert bool(((out - ref).abs().double()
                 <= tr.segsum_rows_bound(rows, cum, n)).all())
    e = np.minimum(np.cumsum(counts), int(n))
    empty = torch.tensor(np.diff(e, prepend=0) == 0, device=cuda)
    assert not bool(out[:, empty].any())
    assert torch.equal(out, tr.segsum_rows(rows, cum, n))


@pytest.mark.parametrize("words", ["f32", "packed"])
@pytest.mark.parametrize("n", [1, 2, 3, 9, 19])
def test_unpack_kernel_row_groups_match_plain(cuda, n, words):
    """B9b at 1 to 19 rows of 3M columns (12 MB a row, so the gather takes
    the rows in groups of unpack_row_group; 19 rows are not a multiple of
    it), f32 and packed-pair words, with and without a permutation: bit for
    bit its plain version, and the [d, M] sums' shape (all rows in one
    group) likewise."""
    L = 3_000_000
    g = torch.Generator(device="cpu").manual_seed(n)
    if words == "f32":
        block = torch.randn((n + 1, L), generator=g).to(cuda)
    else:
        block = torch.randint(-2**31, 2**31, (n + 1, L), dtype=torch.int32,
                              generator=g).to(cuda)
    group = tr.unpack_row_group(L, n)
    assert group < n or n <= 2
    if n == 19:
        assert n % group
    perm = torch.randperm(L, generator=g).to(cuda)
    for idx in (None, perm):
        out = tr.unpack_rows(block, n, idx)
        assert torch.equal(out, tr._unpack_rows_plain(block, n, idx))
    sums = block[:, :1_000_000].contiguous()
    if 4 * n * sums.shape[1] <= tr.UNPACK_L2_BYTES:
        assert tr.unpack_row_group(sums.shape[1], n) == n
    out = tr.unpack_rows(sums, n, perm[perm < 1_000_000])
    assert torch.equal(out, tr._unpack_rows_plain(
        sums, n, perm[perm < 1_000_000]))


SPLAT_GROUPS = {"means": (3,), "quats": (4,), "scales": (3,),
                "opacities": (), "sh0": (1, 3), "shN": (15, 3)}


@pytest.mark.parametrize("rows", [4096, 1001])
@pytest.mark.parametrize("vis", ["none", "all", "mixed"])
@pytest.mark.parametrize("group", sorted(SPLAT_GROUPS))
def test_selective_adam_kernel_matches_plain(cuda, group, vis, rows):
    from gscodec_studio_tpu_torch.optimizers.selective_adam import (
        selective_adam_plain, selective_adam_step)

    g = torch.Generator(device="cpu").manual_seed(rows + len(group))
    shape = (rows,) + SPLAT_GROUPS[group]
    p, grad, mu = (torch.randn(shape, generator=g) for _ in range(3))
    nu = torch.rand(shape, generator=g) * 1e-3
    visible = {"none": torch.zeros(rows, dtype=torch.bool),
               "all": torch.ones(rows, dtype=torch.bool),
               "mixed": torch.rand(rows, generator=g) < 0.4}[vis]
    args = [t.to(cuda) for t in (p, grad, mu, nu)]
    ref = [t.clone() for t in args]
    vis_c = visible.to(cuda)
    coef = (1.6e-4 * 0.01 ** 0.3, 0.9, 0.999, 1e-15)
    selective_adam_plain(*ref, vis_c, *coef)
    before = tr.LAUNCHES["selective_adam"]
    selective_adam_step(*args, vis_c, *coef)
    torch.cuda.synchronize()
    assert tr.LAUNCHES["selective_adam"] == before + 1
    for a, b in zip(args, ref):
        assert torch.equal(a, b)
    rows_off = ~visible.to(cuda)
    assert torch.equal(args[0][rows_off], p.to(cuda)[rows_off])


def test_selective_adam_kernel_strided_gradient(cuda):
    """sh0's gradient is a slice of the colours' gradient, a strided view:
    the step takes it as it comes, with the plain version's bits."""
    from gscodec_studio_tpu_torch.optimizers.selective_adam import (
        selective_adam_plain, selective_adam_step)

    g = torch.Generator(device="cpu").manual_seed(11)
    colors_grad = torch.randn(3000, 16, 3, generator=g).to(cuda)
    grad = colors_grad[:, :1]
    assert not grad.is_contiguous()
    args = [torch.randn(3000, 1, 3, generator=g).to(cuda) for _ in range(3)]
    args[2].abs_()
    ref = [t.clone() for t in args]
    vis = (torch.rand(3000, generator=g) < 0.5).to(cuda)
    selective_adam_plain(ref[0], grad, ref[1], ref[2], vis, 1e-3, 0.9,
                         0.999, 1e-15)
    selective_adam_step(args[0], grad, args[1], args[2], vis, 1e-3, 0.9,
                        0.999, 1e-15)
    torch.cuda.synchronize()
    for a, b in zip(args, ref):
        assert torch.equal(a, b)


def test_selective_adam_kernel_misaligned_group(cuda):
    """A group that starts 4 bytes past a 16-byte boundary takes the
    one-element path; the bits are the plain version's."""
    from gscodec_studio_tpu_torch.optimizers.selective_adam import (
        selective_adam_plain, selective_adam_step)

    g = torch.Generator(device="cpu").manual_seed(7)
    flat = [torch.randn(1 + 2000 * 3, generator=g).to(cuda)
            for _ in range(4)]
    args = [t[1:].view(2000, 3) for t in flat]
    args[3].abs_()
    ref = [t.clone() for t in args]
    vis = (torch.rand(2000, generator=g) < 0.5).to(cuda)
    selective_adam_plain(*ref, vis, 1e-3, 0.9, 0.999, 1e-15)
    selective_adam_step(*args, vis, 1e-3, 0.9, 0.999, 1e-15)
    torch.cuda.synchronize()
    for a, b in zip(args, ref):
        assert torch.equal(a, b)


def test_kmeans_on_the_card_matches_cpu(cuda):
    from gscodec_studio_tpu_torch.compression.kmeans import kmeans

    rng = np.random.default_rng(3)
    centers = rng.standard_normal((300, 45)).astype(np.float32)
    x = (centers[rng.integers(0, 300, 20_000)]
         + 0.3 * rng.standard_normal((20_000, 45))).astype(np.float32)
    cc, cl = kmeans(x, 512, iters=5, device="cpu")
    gc, gl = kmeans(x, 512, iters=5, device=cuda)
    assert float(np.mean(gl == cl)) >= 0.99

    def distortion(c, lab):
        return float(((x - c[lab]) ** 2).sum())

    assert distortion(gc, gl) == pytest.approx(distortion(cc, cl), rel=0.01)


@pytest.mark.parametrize("model", ["ortho", "fisheye"])
def test_other_cameras_on_card_match_cpu(cuda, model):
    """rasterization(camera_model="ortho" / "fisheye") forward and
    backward on the card (B9a, B3, B1, B2, B4, B9b) against the CPU's
    plain versions: images and alphas within 1e-4, every gradient within
    1e-3 of its largest |.|; ortho views take fx = fy = width over the
    scene's extent."""
    rng = np.random.default_rng(12)
    N, W, H = 3000, 160, 120
    means = (rng.standard_normal((N, 3)) * [1.5, 1.0, 1.5]).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.5, 0.5, (N, 3))).astype(np.float32)
    opac = rng.random(N).astype(np.float32)
    sh = (rng.standard_normal((N, 16, 3)) * 0.3).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 5.0
    f = W / 6.0 if model == "ortho" else 100.0
    K = np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]], np.float32)
    ct = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [torch.tensor(x, device=dev, requires_grad=True)
                  for x in (means, quats, scales, opac, sh)]
        before = dict(tr.LAUNCHES)
        img, alp, meta = rasterization(*leaves, vm[None], K, W, H,
                                       sh_degree=3, camera_model=model,
                                       device=dev)
        (img * torch.as_tensor(ct, device=dev)).sum().backward()
        if dev.type == "cuda":
            for name in ("pack_rows", "expand", "raster_fwd", "raster_bwd",
                         "segsum_rows", "unpack_rows"):
                assert tr.LAUNCHES[name] > before[name], name
        out[dev.type] = (img.detach().cpu(), alp.detach().cpu(),
                         int(meta["n_isects"][0]),
                         [t.grad.cpu() for t in leaves])
    (img, alp, n, grads), (img_c, alp_c, n_c, grads_c) = \
        out["cuda"], out["cpu"]
    assert n == n_c > 0 and float(alp_c.mean()) > 0.05
    assert float((img - img_c).abs().max()) <= 1e-4
    assert float((alp - alp_c).abs().max()) <= 1e-4
    for a, b in zip(grads, grads_c):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-3 * scale


@pytest.mark.parametrize("kind", ["histogram", "factorized", "gaussian"])
def test_entropy_stream_from_card_decodes_on_cpu(cuda, tmp_path, kind):
    """EntropyCodingCompression with its models on the card (and the shN
    k-means there) writes a stream that decodes on the CPU to the same
    bits as its own decode, within q_step/2 of the clipped input."""
    from gscodec_studio_tpu_torch.compression import (
        EntropyCodingCompression)
    from gscodec_studio_tpu_torch.compression_sim.entropy_model import (
        init_factorized)
    from gscodec_studio_tpu_torch.compression_sim.hash_grid import (
        gaussian_conditional_cfgs, gaussian_conditional_init)
    from gscodec_studio_tpu_torch.compression_sim.simulation import BOUNDS

    rng = np.random.default_rng(13)
    n = 48 * 48
    pos = rng.random((n, 3)).astype(np.float32)
    splats = dict(
        means=(pos * 4 - 2).astype(np.float32),
        quats=rng.standard_normal((n, 4)).astype(np.float32),
        scales=(-5 + 2 * np.sin(4 * pos) + rng.normal(0, 0.2, (n, 3)))
        .astype(np.float32),
        opacities=(3 + rng.standard_normal(n)).astype(np.float32),
        sh0=(0.3 * rng.standard_normal((n, 1, 3))).astype(np.float32),
        shN=(0.1 * rng.standard_normal((n, 15, 3))).astype(np.float32))
    g = torch.Generator(device=cuda).manual_seed(5)
    ems = None
    if kind == "factorized":
        ems = {"scales": init_factorized(3, (3, 3), generator=g,
                                         device=cuda),
               "quats": init_factorized(4, generator=g, device=cuda)}
    elif kind == "gaussian":
        ems = {}
        for name, c in (("scales", 3), ("sh0", 3)):
            p, _ = gaussian_conditional_init(c, n_levels_3d=8,
                                             n_levels_2d=2, generator=g,
                                             device=cuda)
            ems[name] = ("gaussian", (p, gaussian_conditional_cfgs(p)))
    codec = EntropyCodingCompression(shn_clusters=256, kmeans_iters=3,
                                     device=cuda)
    codec.compress(str(tmp_path), splats, entropy_models=ems)
    own = codec.decompress(str(tmp_path))
    cpu = EntropyCodingCompression(device="cpu").decompress(str(tmp_path))
    assert sorted(own) == sorted(cpu)
    for k in own:
        np.testing.assert_array_equal(own[k], cpu[k], err_msg=k)
    lo, hi = BOUNDS["scales"]
    err = np.abs(np.clip(np.sort(splats["scales"], 0), lo, hi)
                 - np.sort(cpu["scales"], 0))
    assert float(err.max()) <= 0.5 * (hi - lo) / 255 * (1 + 1e-5) + 1e-6


def test_honest_timer_on_cuda_events(cuda):
    from gscodec_studio_tpu_torch.utils.profiling import honest_timer

    x = torch.randn(2048, 2048, device=cuda)
    per_iter = honest_timer(lambda c, m: c + (m @ m)[0, 0] * 0, (x,), K=8,
                            device=cuda)
    # one 2048^3 product: at least 0.01 ms on any card, under 50 ms
    assert 1e-5 < per_iter < 5e-2


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_nine_channel_kernels_match_plain(cuda, ts):
    """B1 and B2 at the dynamic path's 9 feature channels (their chm-16
    builds): within 1e-4 of their plain versions (B2 of each row's largest
    |value|), the same bits twice, both cutoffs, and no passing slot
    outside a pair's candidate region in either layout."""
    assert tr.fwd_build(9, ts)["chm"] == tr.bwd_build(9, ts)["chm"] == 16
    for cutoff in ("exact", "soft"):
        m2, con, col, op, dep, radii = _scene(20, N=20000, CH=9)
        C, N = dep.shape
        cfg = _cfg(C, N, 200, 136, ts, 9, cutoff, cap=1 << 20)
        b = tr._build_sorted(cfg, *[torch.as_tensor(x, device=cuda)
                                    for x in (m2, con, col, op, dep,
                                              radii)])
        masks = torch.ones(cfg.n_tiles, dtype=torch.int32, device=cuda)
        out = tr.raster_fwd(b.S, b.starts, masks, cfg)
        assert out.shape[-1] == 10
        assert _forward_close(out, tr._fwd_plain(b.S, b.starts, masks, cfg))
        assert torch.equal(out, tr.raster_fwd(b.S, b.starts, masks, cfg))
        g = torch.Generator(device="cpu").manual_seed(ts)
        v = torch.randn(out.shape, generator=g).to(cuda)
        args = (b.S, b.starts, masks, out, v, cfg, False)
        grad = tr.raster_bwd(*args)
        assert _rows_close(grad, tr._bwd_plain(*args), 1e-4), cutoff
        assert torch.equal(grad, tr.raster_bwd(*args))
        assert tr._fwd_counts(b.S, b.starts, masks, cfg)["missed_slots"] \
            == 0
        assert tr._bwd_counts(b.S, b.starts, masks, cfg)["missed_slots"] \
            == 0


def _dyn_samples(seed=21, n_views=3, n_frames=3, W=64, H=48):
    rng = np.random.default_rng(seed)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    out = []
    for vi in range(n_views):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.3 * vi, 0.0, -4.0]
        for fi in range(n_frames):
            out.append({"camtoworld": c2w, "K": K,
                        "timestamp": fi / max(n_frames - 1, 1),
                        "image": rng.random((H, W, 3)).astype(np.float32)})
    pts = (rng.random((400, 3)) - 0.5).astype(np.float32) * 2
    return out, pts, rng.random((400, 3)).astype(np.float32)


def test_dyn_runner_on_card_matches_cpu(cuda, tmp_path):
    """Four DynRunner steps (ModifiedSTG, the Sandwich decoder's 9 feature
    channels, the STG simulation with its entropy gates open, a refine at
    step 2) on the card and on the CPU from the same state and draws: each
    loss within 1e-4 relative, every leaf within 1e-4 of its largest
    |value| or 5e-5 absolute, and one launch a step of each fused
    kernel."""
    from gscodec_studio_tpu_torch.training.dyn_trainer import (DynConfig,
                                                               DynRunner)

    samples, pts, rgbs = _dyn_samples()
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        cfg = DynConfig(result_dir=str(tmp_path / dev.type), max_steps=4,
                        capacity=800, strategy="modified_stg",
                        color_mode="sandwich", compression_sim=True,
                        entropy_model_opt=True, refine_start_iter=1,
                        refine_every=2, steps_per_dispatch=2)
        r = DynRunner(cfg, pts, rgbs, samples, samples, device=dev)
        r.compression_sim.entropy_steps = {
            k: -1 for k in r.compression_sim.entropy_steps}
        r.splats["scales"] = r.splats["scales"] + torch.as_tensor(
            np.random.default_rng(1).normal(0, 0.3, (800, 3)).astype(
                np.float32), device=dev)
        if dev.type == "cpu":  # the card run's draws and initial models
            card = runs["cuda"]
            r.decoder_params = {k: v.cpu() for k, v in card["dec0"].items()}
            r.sim_params = {k: v.cpu() for k, v in card["sim0"].items()}
            it = iter(card["splits"])
            r._split_samples = lambda cap: next(it)
        else:
            dec0 = {k: v.clone() for k, v in r.decoder_params.items()}
            sim0 = {k: v.clone() for k, v in r.sim_params.items()}
            splits = []
            draw = r._split_samples
            r._split_samples = lambda cap: splits.append(
                draw(cap).cpu()) or splits[-1].to(cuda)
        before = dict(tr.LAUNCHES)
        losses = r.train(log_every=0)
        launches = {k: tr.LAUNCHES[k] - before[k] for k in before}
        runs[dev.type] = dict(losses=losses, splats={
            k: v.cpu() for k, v in r.splats.items()}, launches=launches)
        if dev.type == "cuda":
            runs["cuda"].update(dec0=dec0, sim0=sim0, splits=splits)
    card, cpu = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-4)
    for k, v in card["splats"].items():
        w = cpu["splats"][k]
        tol = max(1e-4 * float(w.abs().max()), 5e-5)
        assert float((v - w).abs().max()) <= tol, k
    for name in ("pack_rows", "expand", "raster_fwd", "raster_bwd",
                 "segsum_rows"):
        assert card["launches"][name] >= 4, name
    assert card["launches"]["unpack_rows"] >= 8


def test_seq_codec_on_card_frames_decodes_on_cpu(cuda, tmp_path):
    """The card runner's exported frames through the sequence codec
    (pngseq): the CPU decode within each attribute's quantization step of
    the exported values."""
    from gscodec_studio_tpu_torch.compression.seq_codec import SeqCodec
    from gscodec_studio_tpu_torch.training.dyn_trainer import (DynConfig,
                                                               DynRunner)

    samples, pts, rgbs = _dyn_samples()
    r = DynRunner(DynConfig(result_dir=str(tmp_path / "run"), max_steps=3,
                            strategy="mcmc", mcmc_cap_max=800),
                  pts, rgbs, samples, samples, device=cuda)
    r.train(log_every=0)
    frames = r.export_frames([0.0, 0.5, 1.0])
    n = min(len(f["means"]) for f in frames)
    assert n > 100
    tracked = [{k: v[:n] for k, v in f.items()} for f in frames]
    codec = SeqCodec(backend="pngseq", qp=15)
    codec.compress(str(tmp_path / "seq"), tracked)
    dec = SeqCodec().decompress(str(tmp_path / "seq"))
    side = int(np.floor(np.sqrt(n)))
    assert len(dec) == 3 and dec[0]["means"].shape == (side * side, 3)
    for name in ("opacities", "scales"):
        lo = min(float(f[name].min()) for f in tracked)
        hi = max(float(f[name].max()) for f in tracked)
        step = (hi - lo) / 255
        got = np.sort(dec[1][name].reshape(-1))
        assert float(got.min()) >= lo - step and float(got.max()) <= \
            hi + step


def _mesh_scene(n=4000, C=4, W=160, H=120):
    from gscodec_studio_tpu_torch.utils.scenes import make_scene

    means, quats, scales, opac, colors, vm, _ = make_scene(
        n=n, width=W, height=H, seed=9)
    vm = np.concatenate([vm] * C)
    vm[:, 0, 3] += np.linspace(-0.2, 0.2, C, dtype=np.float32)
    opac = np.clip(opac, 1e-4, 1 - 1e-4)
    splats = dict(means=means, quats=quats,
                  scales=np.log(scales).astype(np.float32),
                  opacities=np.log(opac / (1 - opac)).astype(np.float32),
                  sh0=colors[:, :1], shN=colors[:, 1:])
    f = 0.9 * W
    Ks = np.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]] * C,
                  np.float32)
    return splats, vm, Ks, W, H


def _single_scalar(splats, vm, Ks, W, H, dev, groups=1):
    """The render path's pipeline on one device: the scalar radius binned
    by the fused kernels, as distributed_render bins, the cameras in
    ``groups`` batches as the ranks split them (under the exact cutoff a
    camera's render depends on where its batch's table puts its tiles'
    runs on the 128-row chunk grid)."""
    from gscodec_studio_tpu_torch.models.splats import splat_activations
    from gscodec_studio_tpu_torch.rendering import project_and_shade

    sp = {k: torch.as_tensor(v, device=dev) for k, v in splats.items()}
    with torch.no_grad():
        m, q, s, o = splat_activations(sp)
        r, m2, d, con, col, op, _ = project_and_shade(
            m, q, s, o, torch.cat([sp["sh0"], sp["shN"]], 1),
            torch.as_tensor(vm, device=dev), torch.as_tensor(Ks, device=dev),
            W, H, sh_degree=3, elliptical=False)
        n = len(vm) // groups
        return torch.cat([tr.rasterize_to_pixels_v2(
            m2[g:g + n], con[g:g + n], col[g:g + n], op[g:g + n],
            d[g:g + n], r[g:g + n], W, H, isect_capacity=1 << 20,
            device=dev)[0] for g in range(0, len(vm), n)])


@pytest.fixture
def nccl_world_1(cuda, tmp_path):
    """A process group of one rank on NCCL (a file store), destroyed
    after the test."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


def test_exchange_on_cuda_world_size_1(nccl_world_1):
    """The exchange's all_to_all on the card's tensors through NCCL at world
    size 1: it moves every row to itself, and its backward brings the
    gradient back unchanged; the bucketed exchange keeps the visible rows
    first."""
    from gscodec_studio_tpu_torch.parallel.distributed import (
        _exchange, _exchange_bucketed, make_mesh)

    dev = nccl_world_1
    mesh = make_mesh(1, device=dev)
    assert not mesh.solo
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(3, 50, 7, generator=g).to(dev).requires_grad_(True)
    w = torch.randn(3, 50, 7, generator=g).to(dev)
    y = _exchange(mesh, x)
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    assert torch.equal(y, x) and torch.equal(gx, w)
    radii = torch.zeros(3, 50, dtype=torch.int32, device=dev)
    radii[1, 10:20] = 3
    yb, rb, diag = _exchange_bucketed(mesh, x, radii, 16)
    assert torch.equal(yb[:, :10], x[:, 10:20])
    assert int(diag["overflow"]) == 0 and int(diag["sent_rows"]) == 48
    assert bool((rb[:, :10] == torch.tensor([0, 3, 0], device=dev)[:, None]
                 ).all()) and not bool(rb[:, 10:].any())


def test_mesh_render_on_cuda_world_size_1(nccl_world_1):
    """distributed_render at world size 1 on NCCL against the same
    projection's single-device render: the forward's tolerance."""
    from gscodec_studio_tpu_torch.parallel.distributed import (
        distributed_render, make_mesh)

    dev = nccl_world_1
    splats, vm, Ks, W, H = _mesh_scene()
    sp = {k: torch.as_tensor(v, device=dev) for k, v in splats.items()}
    img = distributed_render(make_mesh(1, device=dev), sp, vm, Ks, W, H,
                             sh_degree=3, isect_capacity=1 << 20)
    ref = _single_scalar(splats, vm, Ks, W, H, dev)
    assert float(ref.mean()) > 0.01
    assert float((img - ref).abs().max()) <= 1e-4


def _gloo_render_rank(rank, world, splats, vm, Ks, W, H):
    from gscodec_studio_tpu_torch.parallel.distributed import (
        distributed_render, make_mesh, shard_rows)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh(world, device=dev)
    loc = {k: shard_rows(mesh, torch.as_tensor(v, device=dev))
           for k, v in splats.items()}
    out = [distributed_render(mesh, loc, vm, Ks, W, H, sh_degree=3,
                              isect_capacity=1 << 20, exchange_cap=cap).cpu()
           for cap in (None, len(splats["means"]) // world)]
    return out


def test_mesh_render_on_cuda_two_gloo_ranks(cuda):
    """distributed_render over 2 gloo ranks sharing the card, dense and
    bucketed at a covering cap, against the single-device render: the
    forward's tolerance."""
    from gscodec_studio_tpu_torch.parallel import launcher

    splats, vm, Ks, W, H = _mesh_scene()
    outs = launcher.spawn(_gloo_render_rank, 2, splats, vm, Ks, W, H,
                          timeout=300)
    ref = _single_scalar(splats, vm, Ks, W, H, cuda, groups=2).cpu()
    for dense, bucketed in outs:
        assert float((dense - ref).abs().max()) <= 1e-4
        assert float((bucketed - dense).abs().max()) <= 1e-4
