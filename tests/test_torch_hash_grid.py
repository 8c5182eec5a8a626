"""The hash-grid entropy model of gscodec_studio_tpu_torch against the JAX
package on the CPU: the spatial hash, the grid encoding, the Gaussian
likelihood's bits and the position-conditioned model with their
gradients, and the compression simulation's gaussian_model branch with
JAX's own subsample draw. Small tables (2^10 3D, 2^8 planes) keep it
quick; the level counts are the simulation's (8 and 2).

Tolerances: the hash exact; the encoding within 1e-6 of its largest
|value| (the same float32 products, summed over the corners in another
order); bits and every gradient (tables, MLP, values, positions, and
through the simulation the positions) within 1e-5 of the largest |value|
(float32 chains of a few dozen operations; the tables' gradients are
scatter-adds in another order); the simulation's total bits rtol 1e-5,
its gradients to the quantized attributes and the models 1e-4 (see
there). The bits
divide by the likelihood, a difference of two float32 CDFs: where it is
small the bits amplify an ulp of their inputs, so the end-to-end model
test runs at a coarse step about the model's prediction.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.compression_sim import hash_grid as jhg
from gscodec_studio_tpu.compression_sim import simulation as jsim
from gscodec_studio_tpu.compression_sim.entropy_model import (
    gaussian_bits as jgaussian_bits)
from gscodec_studio_tpu_torch.compression_sim import hash_grid as thg
from gscodec_studio_tpu_torch.compression_sim import simulation as tsim
from gscodec_studio_tpu_torch.compression_sim.entropy_model import (
    gaussian_bits)
from gscodec_studio_tpu_torch.models.splats import (flatten_tree,
                                                    from_jax_sim_params,
                                                    jax_leaf_order,
                                                    unflatten_tree)

LOG2_3D, LOG2_2D = 10, 8


def _close(a, b, tol, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, what
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float32,
                        requires_grad=grad)


def test_hash_wraps_uint32_like_jax(rng):
    coords = rng.integers(0, 1 << 31, (4096, 3)).astype(np.int32)
    coords[:4] = [[0, 0, 0], [1, 1, 1], [2**31 - 1] * 3, [7, 2**31 - 1, 3]]
    for dim, table in ((3, 1 << 19), (2, 1 << 17), (3, 1000)):
        ref = np.asarray(jhg._hash(jnp.asarray(coords[:, :dim]), table))
        got = thg._hash(torch.as_tensor(coords[:, :dim]), table)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dim,levels", [(3, 3), (2, 2)])
@pytest.mark.parametrize("binarize", [False, True])
def test_hash_grid_encode_matches_jax(rng, dim, levels, binarize):
    tables, cfg = jhg.hash_grid_init(jax.random.PRNGKey(dim), levels,
                                     log2_hashmap_size=10, dim=dim)
    tables = tables * 1e4 * 0.5  # values of both signs around 1
    x = rng.random((500, dim)).astype(np.float32)
    x[:3] = [[0.0] * dim, [1.0] * dim, [0.5] * dim]
    ref = jhg.hash_grid_encode(tables, cfg, jnp.asarray(x), binarize)
    tcfg = thg.HashGridCfg(*cfg)
    got = thg.hash_grid_encode(_t(tables), tcfg, _t(x), binarize)
    _close(got, ref, 1e-6, "encode")


def test_gaussian_bits_and_gradients_match_jax(rng):
    n, c, q = 400, 3, 0.05
    x = (rng.standard_normal((n, c)) * 0.5).astype(np.float32)
    mean = (x + rng.standard_normal((n, c)) * 0.2).astype(np.float32)
    scale = np.exp(rng.normal(-2, 1.5, (n, c))).astype(np.float32)
    scale[0, 0] = 1e-7  # clipped at 1e-5
    w = rng.random((n, c)).astype(np.float32)
    f = lambda a, b, s: jnp.sum(jgaussian_bits(a, b, s, q) * w)  # noqa
    ref = jgaussian_bits(jnp.asarray(x), jnp.asarray(mean),
                         jnp.asarray(scale), q)
    refg = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(mean),
                                          jnp.asarray(scale))
    tx, tm, ts = _t(x, True), _t(mean, True), _t(scale, True)
    got = gaussian_bits(tx, tm, ts, q)
    (got * _t(w)).sum().backward()
    _close(got, ref, 1e-5, "bits")
    for a, b, what in zip((tx, tm, ts), refg, ("x", "mean", "scale")):
        _close(a.grad, b, 1e-5, what)


def _jax_model(channel, key=0, head=1.0):
    params, cfgs = jhg.gaussian_conditional_init(
        jax.random.PRNGKey(key), channel, n_levels_3d=8, n_levels_2d=2,
        log2_hashmap_3d=LOG2_3D, log2_hashmap_2d=LOG2_2D)
    # tables away from their +-1e-4 start, so that the encoding matters
    params["mlp"][1]["w"] = params["mlp"][1]["w"] * head
    k = jax.random.PRNGKey(key + 100)
    params["grid3d"] = jax.random.normal(k, params["grid3d"].shape) * 0.3
    params["planes"] = [jax.random.normal(jax.random.fold_in(k, i),
                                          p.shape) * 0.3
                        for i, p in enumerate(params["planes"])]
    return params, cfgs


@pytest.mark.parametrize("binarize", [False, True])
def test_gaussian_conditional_bits_and_gradients_match_jax(rng, binarize):
    # A coarse step and values about the model's own prediction: the MLP
    # sums in another order (mean and scale 1e-7 apart), and the bits
    # amplify that by 1 / likelihood, which a fine step makes large
    # (gaussian_bits is held at fine steps on equal inputs above).
    n, c, q = 300, 4, 0.5
    params, cfgs = _jax_model(c)
    pos = rng.random((n, 3)).astype(np.float32)
    mu, sd = jhg.gaussian_conditional_apply(params, cfgs, jnp.asarray(pos),
                                            binarize)
    x = np.asarray(mu + sd * rng.standard_normal((n, c)), np.float32)
    w = rng.random((n, c)).astype(np.float32)

    def f(p, a, ps):
        return jnp.sum(jhg.gaussian_conditional_bits(p, cfgs, a, ps, q,
                                                     binarize) * w)

    ref = jhg.gaussian_conditional_bits(params, cfgs, jnp.asarray(x),
                                        jnp.asarray(pos), q, binarize)
    gp, gx, gpos = jax.grad(f, argnums=(0, 1, 2))(params, jnp.asarray(x),
                                                  jnp.asarray(pos))
    flat = {k: v.requires_grad_(True) for k, v in
            from_jax_sim_params(params, device="cpu").items()}
    model = unflatten_tree(flat)
    tx, tpos = _t(x, True), _t(pos, True)
    got = thg.gaussian_conditional_bits(model,
                                        thg.gaussian_conditional_cfgs(model),
                                        tx, tpos, q, binarize)
    (got * _t(w)).sum().backward()
    _close(got, ref, 1e-5, "bits")
    _close(tx.grad, gx, 1e-5, "x")
    _close(tpos.grad, gpos, 1e-5, "pos")
    for k, g in flatten_tree(gp).items():
        _close(flat[k].grad, g, 1e-5, k)


def test_flatten_order_is_the_jax_pytree_order():
    params, _ = _jax_model(3)
    tree = {"entropy": {"sh0": params, "quats": params}, "ada_mask":
            jnp.zeros(5)}
    leaves = jax.tree_util.tree_leaves(tree)
    names = jax_leaf_order(flatten_tree(tree))
    assert names[:6] == ["ada_mask", "entropy.quats.grid3d",
                         "entropy.quats.mlp.0.b", "entropy.quats.mlp.0.w",
                         "entropy.quats.mlp.1.b", "entropy.quats.mlp.1.w"]
    flat = flatten_tree(tree)
    for name, leaf in zip(names, leaves):
        assert flat[name] is leaf


def test_simulation_gaussian_branch_matches_jax(rng, monkeypatch):
    """CompressionSimulation.simulate with entropy_model_type
    "gaussian_model" in both packages, the port fed the JAX run's
    jax.random.randint subsample: the bits, and the gradients to the
    splats and every sim parameter.

    3001 rows put both position quantiles on a sample (ranks 30 and
    2970), where torch.quantile and jnp.percentile give the same bits.
    Between samples the two interpolate with other roundings, 1 ulp
    apart: the normalized positions then differ by an ulp, and a point
    that lies on a grid cell's edge takes the other cell's corners, a
    different gradient (the forward is continuous there; the test below
    holds the bits at a cap between samples)."""
    cap = 3001
    sim_j = jsim.CompressionSimulation(
        entropy_model_opt=True, entropy_model_type="gaussian_model",
        cap=cap, gaussian_sample=1024)
    sim_j.entropy_steps = {k: -1 for k in sim_j.entropy_steps}
    ems, sim_j._gauss_cfgs = {}, {}
    for i, (name, c) in enumerate(sim_j.entropy_channels.items()):
        ems[name], sim_j._gauss_cfgs[name] = _jax_model(c, key=i,
                                                        head=0.05)
    sim_params = {"entropy": ems}
    # values about the models' predictions (a small head keeps them near
    # its zero bias), where the bits are well conditioned at the
    # simulation's fine quantization steps (test above)
    splats = {
        "means": rng.standard_normal((cap, 3)).astype(np.float32),
        "quats": rng.normal(0, 0.3, (cap, 4)).astype(np.float32),
        "scales": rng.normal(0, 0.3, (cap, 3)).astype(np.float32),
        "opacities": rng.normal(0, 2, cap).astype(np.float32),
        "sh0": rng.normal(0, 0.3, (cap, 1, 3)).astype(np.float32),
        "shN": np.zeros((cap, 0, 3), np.float32),
    }
    draws = []
    randint = jax.random.randint

    def spy(*args, **kw):
        out = randint(*args, **kw)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "randint", spy)

    def jloss(sp, prm):
        _, bits, _ = sim_j.simulate(sp, prm, jnp.int32(5),
                                    jax.random.PRNGKey(3))
        return bits

    # in the sorted key order that jax.grad (and the Runner's jit) hand
    # simulate, which draws its keys attribute by attribute
    jsp = {k: jnp.asarray(splats[k]) for k in sorted(splats)}
    ref_bits = jloss(jsp, sim_params)
    monkeypatch.setattr(jax.random, "randint", randint)
    assert len(draws) == 3  # quats, scales, sh0: the sorted order
    gsp, gprm = jax.grad(jloss, argnums=(0, 1))(jsp, sim_params)

    sim_t = tsim.CompressionSimulation(
        entropy_model_opt=True, entropy_model_type="gaussian_model",
        cap=cap, gaussian_sample=1024)
    sim_t.entropy_steps = {k: -1 for k in sim_t.entropy_steps}
    it = iter(draws)
    monkeypatch.setattr(tsim, "sample_subset",
                        lambda *a, **kw: torch.as_tensor(next(it)))
    tsp = {k: _t(v, True) for k, v in splats.items()}
    tprm = {k: v.requires_grad_(True) for k, v in
            from_jax_sim_params(sim_params, device="cpu").items()}
    _, bits, _ = sim_t.simulate(tsp, tprm, 5)
    bits.backward()
    assert float(bits) == pytest.approx(float(ref_bits), rel=1e-5)
    _close(tsp["means"].grad, gsp["means"], 1e-5, "means")
    # the bits' gradients to the values and to the predicted mean and
    # scale divide by the likelihood, a difference of two CDFs each
    # rounded to 6e-8: at the quantization steps of 2/255 to 12/255 and
    # likelihoods ~5e-3 that is ~1e-5 of it, which the division carries
    for k in ("quats", "scales", "sh0"):
        _close(tsp[k].grad, gsp[k], 1e-4, k)
    for k, g in flatten_tree(gprm).items():
        _close(tprm[k].grad, g, 1e-4, k)


def test_init_params_shapes_match_jax():
    """The port's hash-grid sim parameters have the JAX package's names,
    shapes and leaf count at the simulation's table sizes."""
    kw = dict(entropy_model_opt=True, entropy_model_type="gaussian_model",
              shN_ada_mask_opt=True, cap=10)
    jtree = jax.eval_shape(
        lambda: jsim.CompressionSimulation(**kw).init_params(
            jax.random.PRNGKey(0)))
    jflat = {k: tuple(v.shape) for k, v in flatten_tree(jtree).items()}
    tflat = tsim.CompressionSimulation(**kw).init_params(
        torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in tflat.items()} == jflat
    assert len(jax.tree_util.tree_leaves(jtree)) == len(tflat) == 25


def test_position_quantiles_between_samples(rng):
    """At a count whose quantiles fall between samples, the port's
    normalization bounds are within 2 ulp of jnp.percentile's."""
    means = rng.standard_normal((3000, 3)).astype(np.float32)
    want = np.stack([np.asarray(jnp.percentile(jnp.asarray(means), p,
                                               axis=0)) for p in (1, 99)])
    got = torch.quantile(torch.as_tensor(means),
                         torch.tensor(tsim.POSITION_QUANTILES), dim=0)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
