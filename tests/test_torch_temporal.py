"""gscodec_studio_tpu_torch's temporal model, STG compression tables and STG
strategies against the JAX package on the CPU. Inputs are made from seeds
with numpy and fed to both packages.

Tolerances:
  * slice_at_time, trbf, dyn_colors, dyn_features, sandwich_apply and
    get_rays: values within 1e-6 of each output's largest |value|, their
    gradients (of a seeded weighted sum) within 1e-5 of each gradient's
    largest |value| (float32 in another order: exp, rsqrt and the
    einsums' sums);
  * create_dyn_splats: bit for bit (the same numpy draws and float32
    arithmetic);
  * extract_frame: the same kept rows; the baked means, quats and scales
    within 1e-6 of their largest |value|, the folded logits within 1e-5
    (a sigmoid and a log in another library);
  * STGCompressionSimulation.simulate: as tests/test_torch_compression_sim
    holds the static tables: the quantized splats bit for bit, the bits
    rtol 1e-5, the splats' gradients within 1e-5 and the entropy models'
    within 2e-3 of their largest |value|;
  * the STG strategies (omega mask and freeze, gradient masks, the
    budgeted refine, the bounds prune, the visibility-gated statistics):
    bit for bit, but the split's means and scales (1e-6, as
    tests/test_torch_train holds the default strategy's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.compression_sim import simulation as jsimulation
from gscodec_studio_tpu.models import splats as jsplats
from gscodec_studio_tpu.models import temporal as jt
from gscodec_studio_tpu.strategy.stg import (
    ModifiedSTGStrategy as JModifiedSTG, STGStrategy as JSTG)
from gscodec_studio_tpu_torch.compression_sim import simulation as tsimulation
from gscodec_studio_tpu_torch.models import temporal as tt
from gscodec_studio_tpu_torch.models.splats import (from_jax_sim_params,
                                                    from_jax_stg_state)
from gscodec_studio_tpu_torch.strategy.stg import (ModifiedSTGStrategy,
                                                   STGStrategy)

from tests.test_torch_train import (_assert_state_equal,  # noqa: F401
                                    _state_with_moments, _to_torch, close,
                                    one_torch_thread)


def dyn_params(rng, cap=96):
    """Seeded dynamic splats with every leaf non-trivial."""
    return {
        "means": rng.standard_normal((cap, 3)).astype(np.float32),
        "scales": rng.normal(-1.3, 0.6, (cap, 3)).astype(np.float32),
        "quats": rng.standard_normal((cap, 4)).astype(np.float32),
        "opacities": rng.normal(0.5, 2, cap).astype(np.float32),
        "trbf_center": rng.random(cap).astype(np.float32),
        "trbf_scale": rng.normal(-1, 0.5, cap).astype(np.float32),
        "motion": (rng.standard_normal((cap, 9)) * 0.3).astype(np.float32),
        "omega": (rng.standard_normal((cap, 4)) * 0.2).astype(np.float32),
        "colors": rng.standard_normal((cap, 3)).astype(np.float32),
        "features_dir": rng.standard_normal((cap, 3)).astype(np.float32),
        "features_time": rng.standard_normal((cap, 3)).astype(np.float32),
    }


def _fn_case(name, rng):
    """(JAX function, port function, numpy inputs) of one temporal
    function, each returning a tuple of arrays."""
    cap, C, H, W = 64, 2, 6, 8
    p = dyn_params(rng, cap)
    t = np.float32(0.37)
    if name == "slice":
        return (lambda q: jt.slice_at_time(q, jnp.float32(t)),
                lambda q: tt.slice_at_time(q, torch.tensor(t)), (p,))
    if name == "colors":
        dirs = rng.standard_normal((cap, 3)).astype(np.float32)
        tw = rng.random(cap).astype(np.float32)
        return jt.dyn_colors, tt.dyn_colors, (p, dirs, tw)
    if name == "features":
        dt = (t - p["trbf_center"]).astype(np.float32)
        return jt.dyn_features, tt.dyn_features, (p, dt)
    if name == "sandwich":
        dec = {"w1": rng.standard_normal((12, 6)).astype(np.float32),
               "w2": rng.standard_normal((6, 3)).astype(np.float32)}
        feat = rng.standard_normal((C, H, W, 9)).astype(np.float32)
        rays = rng.standard_normal((C, H, W, 6)).astype(np.float32)
        return jt.sandwich_apply, tt.sandwich_apply, (dec, feat, rays)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    c2w[:3, 3] = rng.standard_normal(3)
    K = np.array([[7.5, 0, 4.1], [0, 6.5, 2.9], [0, 0, 1]], np.float32)
    return (lambda c, k: jt.get_rays(c, k, W, H),
            lambda c, k: tt.get_rays(c, k, W, H), (c2w, K))


@pytest.mark.parametrize("name", ["slice", "colors", "features", "sandwich",
                                  "rays"])
def test_temporal_function_matches_jax(name, rng):
    jfn, tfn, args = _fn_case(name, rng)
    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    jout = jax.tree_util.tree_leaves(jfn(*jargs))
    weights = [rng.standard_normal(np.shape(o)).astype(np.float32)
               for o in jout]

    def jloss(*a):
        outs = jax.tree_util.tree_leaves(jfn(*a))
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    jgrads = jax.tree_util.tree_leaves(
        jax.grad(jloss, argnums=tuple(range(len(args))))(*jargs))
    targs = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), args)
    tout = [o for o in jax.tree_util.tree_leaves(
        tfn(*targs), is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        assert close(a, b, 1e-6)
    loss = sum((o * torch.as_tensor(w)).sum() for o, w in zip(tout,
                                                             weights))
    tleaves = jax.tree_util.tree_leaves(
        targs, is_leaf=lambda x: isinstance(x, torch.Tensor))
    tgrads = torch.autograd.grad(loss, tleaves, allow_unused=True)
    assert len(tgrads) == len(jgrads)
    for g, jg in zip(tgrads, jgrads):
        jg = np.asarray(jg)
        if g is None:  # no path from this input (dt is held constant)
            assert not jg.any()
        else:
            assert close(g, jg, 1e-5)


def test_features_hold_dt_constant(rng):
    p = _to_torch(dyn_params(rng, 16))
    dt = torch.rand(16, requires_grad=True)
    p["features_time"].requires_grad_(True)
    out = tt.dyn_features(p, dt)
    assert out.shape == (16, 9)
    g_dt, g_ft = torch.autograd.grad(out.sum(), [dt, p["features_time"]],
                                     allow_unused=True)
    assert g_dt is None and torch.equal(g_ft,
                                        dt.detach()[:, None].expand(16, 3))


@pytest.mark.parametrize("with_rgb", [True, False])
def test_create_dyn_splats_bit_for_bit(with_rgb, rng):
    pts = rng.standard_normal((70, 3)).astype(np.float32)
    rgb = rng.random((70, 3)) if with_rgb else None
    ref = jt.create_dyn_splats(pts, rgb, cap=100, seed=5, init_opacity=0.3,
                               init_scale=1.4)
    got = tt.create_dyn_splats(pts, rgb, cap=100, seed=5, init_opacity=0.3,
                               init_scale=1.4, device="cpu")
    assert list(got) == list(ref) == [
        "means", "scales", "quats", "opacities", "trbf_center", "trbf_scale",
        "motion", "omega", "colors", "features_dir", "features_time"]
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_extract_frame_matches_jax(rng):
    p = dyn_params(rng, 300)
    p["opacities"][:20] = jsplats.DEAD_OPACITY_LOGIT
    for t in (0.0, 0.45, 1.0):
        ref = jt.extract_frame({k: jnp.asarray(v) for k, v in p.items()}, t)
        got = tt.extract_frame(_to_torch(p), t)
        assert sorted(got) == sorted(ref)
        assert 0 < len(got["means"]) < 280
        for k in got:
            assert got[k].shape == ref[k].shape, k
            if k in ("sh0", "shN"):
                np.testing.assert_array_equal(got[k], ref[k])
            else:
                tol = 1e-5 if k == "opacities" else 1e-6
                assert close(got[k], ref[k], tol), k


def test_stg_tables_are_jax_tables():
    for name in ("STG_SIM_OPTION", "STG_Q_BITWIDTH", "STG_BOUNDS",
                 "STG_ENTROPY_OPTION", "STG_ENTROPY_STEPS",
                 "STG_ENTROPY_CHANNELS"):
        assert getattr(tsimulation, name) == getattr(jsimulation, name), name
    sim = tsimulation.STGCompressionSimulation(entropy_model_opt=True,
                                               cap=8)
    assert sim.entropy_steps == jsimulation.STG_ENTROPY_STEPS
    names = sorted(sim.init_params(torch.Generator().manual_seed(0),
                                   "cpu"))
    jsim = jsimulation.STGCompressionSimulation(entropy_model_opt=True,
                                                cap=8)
    jparams = jsim.init_params(jax.random.PRNGKey(0))
    want = sorted(from_jax_sim_params(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    assert names == want
    # the (3, 3) filters only for scales (sh0 has no STG model)
    for attr in ("colors", "features_dir", "features_time", "quats"):
        assert f"entropy.{attr}.matrices.3" in names, attr
    assert "entropy.scales.matrices.3" not in names


@pytest.mark.parametrize("step", [0, 7_001])
def test_stg_simulate_matches_jax(step, rng):
    """Step 0: fake quantization only; step 7,001: past every STG entropy
    gate. The temporal leaves and the means pass through unquantized."""
    cap = 128
    p = dyn_params(rng, cap)
    jsim = jsimulation.STGCompressionSimulation(entropy_model_opt=True,
                                                cap=cap, max_steps=30_000)
    jparams = jsim.init_params(jax.random.PRNGKey(4))
    sim = tsimulation.STGCompressionSimulation(entropy_model_opt=True,
                                               cap=cap, max_steps=30_000)
    tparams = from_jax_sim_params(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device="cpu")
    w = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}

    def jloss(splats, sp):
        new, bits, _ = jsim.simulate(splats, sp, jnp.int32(step),
                                     jax.random.PRNGKey(0))
        return sum(jnp.sum(new[k] * w[k]) for k in new) + 0.01 * bits, (
            new, bits)

    (_, (jnew, jbits)), (jgs, jgp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()}, jparams)
    ts = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
    new, bits, _ = sim.simulate(ts, tp, step)
    loss = sum((new[k] * torch.as_tensor(w[k])).sum() for k in new) \
        + 0.01 * bits
    loss.backward()
    for k in p:
        np.testing.assert_array_equal(new[k].detach().numpy(),
                                      np.asarray(jnew[k]), err_msg=k)
        if not tsimulation.STG_SIM_OPTION[k]:
            assert new[k] is ts[k], k  # unquantized: the leaf itself
        assert close(ts[k].grad, jgs[k], 1e-5), k
    np.testing.assert_allclose(bits.item(), float(jbits), rtol=1e-5)
    assert (bits.item() > 0.0) == (step > 7_000)
    jg = from_jax_sim_params(jax.tree_util.tree_map(np.asarray, jgp),
                             device="cpu")
    for k, t in tp.items():
        if step == 0:
            assert t.grad is None or not t.grad.any(), k
        else:
            assert close(t.grad, jg[k].numpy(), 2e-3), k


def _stg_case(rng, cap=96):
    """Dynamic splats (some dead, some at the omega rule's corners) with
    one Adam step's moments in both layouts, and seeded statistics."""
    p = dyn_params(rng, cap)
    p["opacities"][rng.random(cap) < 0.25] = jsplats.DEAD_OPACITY_LOGIT
    p["opacities"][:4] = -6.0  # below prune_opa
    p["scales"][: cap // 2] = rng.normal(-6, 0.5, (cap // 2, 3))  # small
    keep = slice(cap // 2, cap // 2 + 16)  # the omega rule's rows
    p["scales"][keep] = np.log(rng.uniform(0.25, 0.55, (16, 3)))
    p["opacities"][keep] = 2.5
    p["motion"][keep, :3] = 0.2
    p, jst, tst = _state_with_moments(rng, p)
    return p, jst, tst


def _stats(rng, cap, js, ts):
    jstate = js.initialize_state(cap, 1.7)
    tstate = ts.initialize_state(cap, 1.7)
    grad2d = (rng.random(cap) * 8e-4).astype(np.float32)
    count = rng.integers(0, 4, cap).astype(np.float32)
    dcount = rng.integers(0, 8, cap).astype(np.int32)
    for st in (jstate, tstate):
        conv = jnp.asarray if st is jstate else torch.as_tensor
        st.update(grad2d=conv(grad2d), count=conv(count),
                  densify_count=conv(dcount))
    return jstate, tstate


def _assert_stg_state_equal(tstate, jstate):
    want = from_jax_stg_state(jax.tree_util.tree_map(np.asarray, jstate),
                              device="cpu")
    assert sorted(tstate) == sorted(want)
    for k, v in tstate.items():
        assert v.dtype == want[k].dtype, k
        assert torch.equal(v, want[k]), k


def test_omega_freeze_and_gradient_masks_match_jax(rng):
    cap = 96
    p, _, _ = _stg_case(rng, cap)
    js, ts = JSTG(), STGStrategy()
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _to_torch(p)
    keep = ts.compute_omega_mask(tp)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(
        js.compute_omega_mask(jp)))
    assert 0 < int(keep.sum()) < cap
    jstate, tstate = _stats(rng, cap, js, ts)
    a, tstate2 = ts.apply_omega_freeze(tp, tstate)
    c, jstate2 = js.apply_omega_freeze(jp, jstate)
    np.testing.assert_array_equal(a["omega"].numpy(), np.asarray(c["omega"]))
    assert not a["omega"][~keep].any() and a["omega"][keep].any()
    _assert_stg_state_equal(tstate2, jstate2)
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    for step in (100, 9_000):  # before and after freeze_start_iter
        for state in (None, "stored"):
            jg = js.mask_gradients(jp, {k: jnp.asarray(v) for k, v in
                                        g.items()}, step,
                                   None if state is None else jstate2)
            tg = ts.mask_gradients(tp, _to_torch(g), step,
                                   None if state is None else tstate2)
            for k in g:
                np.testing.assert_array_equal(tg[k].numpy(),
                                              np.asarray(jg[k]), err_msg=k)
    assert ModifiedSTGStrategy().mask_gradients(tp, _to_torch(g), 9_000) \
        is not None
    tg = ModifiedSTGStrategy().mask_gradients(tp, _to_torch(g), 9_000)
    assert all(np.array_equal(tg[k].numpy(), g[k]) for k in g)


@pytest.mark.parametrize("kind,step", [("stg", 500), ("stg", 9_000),
                                       ("modified_stg", 9_000)])
def test_stg_refine_matches_jax(kind, step, rng):
    """The budgeted grow and prune, the densification counts and (STG
    past freeze_start_iter) the refreshed omega mask."""
    cap = 96
    p, jst, tst = _stg_case(rng, cap)
    js, ts = (JSTG(), STGStrategy()) if kind == "stg" else \
        (JModifiedSTG(), ModifiedSTGStrategy())
    jstate, tstate = _stats(rng, cap, js, ts)
    key = jax.random.PRNGKey(7)
    samples = torch.as_tensor(np.array(jax.random.normal(
        jax.random.split(key)[1], (2, cap, 3))))
    c, d, jstate2 = js.refine({k: jnp.asarray(v) for k, v in p.items()},
                              jst, jstate, step, key)
    a, b, tstate2 = ts.refine(_to_torch(p), tst, tstate, step,
                              split_samples=samples)
    _assert_state_equal(a, b, c, d, approx=("means", "scales"))
    _assert_stg_state_equal(tstate2, jstate2)
    grew = tstate2["densify_count"] - tstate["densify_count"]
    assert int(grew.sum()) > 0
    at_budget = tstate["densify_count"] >= ts.desicnt
    assert at_budget.any() and not grew[at_budget].any()
    if kind == "stg" and step >= ts.freeze_start_iter:
        assert not tstate2["omega_keep"].all()


def test_prune_bounds_matches_jax(rng):
    cap = 96
    p, jst, tst = _stg_case(rng, cap)
    p = {k: np.array(v) for k, v in p.items()}
    p["means"][:10, 2] = 5.0  # beyond z_far
    js, ts = JSTG(), STGStrategy()
    for kw in ({}, {"maxbounds": [1.5, 1.5, 1.5], "minbounds": [-1.5] * 3},
               {"z_far": 0.5}):
        a, b = ts.prune_bounds(_to_torch(p), tst, **kw)
        c, d = js.prune_bounds({k: jnp.asarray(v) for k, v in p.items()},
                               jst, **kw)
        _assert_state_equal(a, b, c, d)
        assert (a["opacities"] != torch.as_tensor(p["opacities"])).any()


@pytest.mark.parametrize("ndim", [1, 2])
def test_modified_stats_gate_matches_jax(ndim, rng):
    """The temporal-visibility gate zeroes the radii the default
    accumulation reads: invisible splats gain neither gradient nor
    count."""
    cap, C = 96, 2
    js, ts = JModifiedSTG(), ModifiedSTGStrategy()
    jstate = js.initialize_state(cap, 1.7)
    tstate = ts.initialize_state(cap, 1.7)
    radii = rng.integers(0, 3, (C, cap)).astype(np.int32)
    v2d = (rng.standard_normal((C, cap, 2)) * 1e-3).astype(np.float32)
    t_vis = rng.random((C, cap) if ndim == 2 else cap) < 0.6
    info = dict(width=64, height=48, n_cameras=C)
    for _ in range(2):
        jstate = js.update_state(jstate, dict(
            info, radii=jnp.asarray(radii), t_vis_mask=jnp.asarray(t_vis)),
            jnp.asarray(v2d))
        tstate = ts.update_state(tstate, dict(
            info, radii=torch.as_tensor(radii),
            t_vis_mask=torch.as_tensor(t_vis)), torch.as_tensor(v2d))
    for k in ("grad2d", "count"):
        assert close(tstate[k], jstate[k], 1e-6), k
    vis = np.broadcast_to(t_vis, (C, cap))
    unseen = ~((radii > 0) & vis).any(0)
    assert unseen.any() and not tstate["count"][unseen].any()
    assert not tstate["grad2d"][unseen].any()
