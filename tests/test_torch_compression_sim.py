"""gscodec_studio_tpu_torch's compression simulation against the JAX
package on the CPU: fake quantization and its straight-through gradient,
the factorized entropy model (its parameters carried across from JAX), the
lower bound's gradient rule, the shN annealing mask, the whole simulate at
a step before and after every gate, and the simulation's Adam.

Tolerances:
  * fake quantization: values bit for bit, the straight-through gradient
    the identity;
  * entropy bits and the likelihood table: rtol 1e-5; their gradients
    with respect to the values within 1e-5 of the largest |value|, with
    respect to the model's parameters within 5e-5: each is a sum over
    every value, in float32 in another order (against a float64
    evaluation the JAX package's are up to 6e-6 off and the port's 3.4e-6,
    measured; the two differ by up to 1.5e-5);
  * the lower bound's gradient: exactly JAX's pass/block pattern;
  * the annealing temperature, mask and sparsity loss: rtol 1e-6;
  * simulate: the quantized splats bit for bit (the masked shN rtol
    1e-6, as the mask), the bits and auxiliary
    loss rtol 1e-5, the splats' and the mask logits' gradients within
    1e-5 of their largest |value|, the entropy models' within 2e-3: at
    the models' initial parameters, where each likelihood is the
    difference of two sigmoids of nearly equal logits, both packages' are
    up to 7.1e-4 off a float64 evaluation (measured);
  * the simulation's Adam over two steps: 1e-6 of each tensor's scale,
    except the entropy models' factors, 2e-5: they start at 0 and hold
    only the two updates, and optax takes the bias correction 1 - b2^t in
    float32, where at t = 2 it is 1e-5 off (the port's Adam, in float64,
    is not).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.compression_sim import ada_mask as jmask
from gscodec_studio_tpu.compression_sim import entropy_model as jent
from gscodec_studio_tpu.compression_sim import ops as jops
from gscodec_studio_tpu.compression_sim.simulation import (
    CompressionSimulation as JSim)
from gscodec_studio_tpu_torch.compression_sim import ada_mask as tmask
from gscodec_studio_tpu_torch.compression_sim import entropy_model as tent
from gscodec_studio_tpu_torch.compression_sim import ops as tops
from gscodec_studio_tpu_torch.compression_sim.simulation import (
    CompressionSimulation, entropy_model_params)
from gscodec_studio_tpu_torch.models.splats import (from_jax_adam_state,
                                                    from_jax_sim_params)
from gscodec_studio_tpu_torch.optimizers import apply_updates

from tests.test_torch_train import _params, close, one_torch_thread  # noqa


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def test_fake_quantize_round_matches_jax(rng):
    x = (rng.standard_normal(2000) * 5).astype(np.float32)
    for lo, hi, bw in ((-10.0, 2.0, 8), (-1.0, 1.0, 8), (-15.0, 15.0, 4)):
        ref, q = jops.fake_quantize_ste(jnp.asarray(x), lo, hi, bw)
        xt = torch.tensor(x, requires_grad=True)
        got, tq = tops.fake_quantize_ste(xt, lo, hi, bw)
        assert tq == q
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
        w = torch.as_tensor(rng.standard_normal(x.shape).astype(np.float32))
        (got * w).sum().backward()
        assert torch.equal(xt.grad, w)  # straight through


def test_fake_quantize_noise_and_log_transform(rng):
    x = torch.as_tensor((rng.standard_normal(500) * 5).astype(np.float32))
    u = torch.rand(500) - 0.5
    got, q = tops.fake_quantize_ste(x, -2.0, 4.0, 8, "noise", u)
    assert torch.equal(got, torch.clamp(x, -2.0, 4.0) + u * q)
    with pytest.raises(ValueError):
        tops.fake_quantize_ste(x, -2.0, 4.0, 8, "noise")
    y = x * 10
    np.testing.assert_allclose(tops.log_transform(y).numpy(),
                               np.asarray(jops.log_transform(y.numpy())),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tops.inverse_log_transform(tops.log_transform(y)).numpy(), y.numpy(),
        rtol=1e-5, atol=1e-5)
    xt = (x / 3).clone().requires_grad_(True)
    b = tops.ste_binary(xt)
    jb, jvjp = jax.vjp(jops.ste_binary, jnp.asarray(xt.detach().numpy()))
    np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jb))
    b.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(jvjp(jnp.ones(500))[0]))


@pytest.mark.parametrize("channel,filters", [(3, (3, 3)), (4, (3, 3, 3))])
def test_factorized_bits_match_jax(rng, channel, filters):
    jparams = jent.init_factorized(jax.random.PRNGKey(channel), channel,
                                   filters)
    # move the constant initial matrices off their start
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.3 * jnp.asarray(rng.standard_normal(a.shape),
                                        jnp.float32), jparams)
    tparams = entropy_model_params(
        from_jax_sim_params({"entropy": {"a": _np_tree(jparams)}},
                            device="cpu"), "a")
    x = np.round(rng.standard_normal((700, channel)) * 4).astype(np.float32)
    q = 0.7

    def jf(p, x):
        return jnp.sum(jent.factorized_bits(p, x, q) * w)

    w = rng.random((700, channel)).astype(np.float32)
    ref = jent.factorized_bits(jparams, jnp.asarray(x), q)
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jparams, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for part in ("matrices", "biases",
                                                  "factors")
              for t in tparams[part]]
    xt = torch.tensor(x, requires_grad=True)
    bits = tent.factorized_bits(tparams, xt, q)
    np.testing.assert_allclose(bits.detach().numpy(), np.asarray(ref),
                               rtol=1e-5)
    (bits * torch.as_tensor(w)).sum().backward()
    assert close(xt.grad, jgx, 1e-5)
    jleaves = [a for part in ("matrices", "biases", "factors")
               for a in jgp[part]]
    for t, g in zip(leaves, jleaves):
        assert close(t.grad, g, 5e-5)
    sym = jnp.arange(-8, 9)
    np.testing.assert_allclose(
        tent.factorized_likelihood_table(
            tparams, torch.as_tensor(np.array(sym)), q, -2.0).detach()
        .numpy(),
        np.asarray(jent.factorized_likelihood_table(jparams, sym, q, -2.0)),
        rtol=1e-5)


def test_lower_bound_gradient_rule():
    x = np.array([0.5, 0.5, 1e-8, 1e-8, 1e-6, 2e-6], np.float32)
    g = np.array([1.0, -1.0, 1.0, -1.0, 0.5, -0.5], np.float32)
    y, vjp = jax.vjp(lambda a: jent._lower_bound(a, 1e-6), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    yt = tent.lower_bound(xt, 1e-6)
    yt.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    # blocked only where x sits below the bound and g pulls it down
    np.testing.assert_array_equal(xt.grad.numpy() != 0,
                                  [True, True, False, True, True, True])


@pytest.mark.parametrize("step", [0, 9_999, 10_000, 10_001, 17_500, 30_000,
                                  40_000])
def test_annealing_mask_matches_jax(rng, step):
    logits = rng.normal(0.5, 2.0, 300).astype(np.float32)
    x = rng.standard_normal((300, 15, 3)).astype(np.float32)
    kw = dict(total_iters=30_000, annealing_start_iter=10_000)
    np.testing.assert_allclose(
        float(tmask.annealing_temperature(step, **kw)),
        float(jmask.annealing_temperature(jnp.int32(step), **kw)), rtol=1e-6)
    for training in (True, False):
        np.testing.assert_allclose(
            tmask.annealing_mask_apply(torch.as_tensor(logits),
                                       torch.as_tensor(x), step, training,
                                       **kw).numpy(),
            np.asarray(jmask.annealing_mask_apply(
                jnp.asarray(logits), jnp.asarray(x), jnp.int32(step),
                training, **kw)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(tmask.annealing_mask_sparsity_loss(torch.as_tensor(logits),
                                                 step, **kw)),
        float(jmask.annealing_mask_sparsity_loss(jnp.asarray(logits),
                                                 jnp.int32(step), **kw)),
        rtol=1e-6)
    np.testing.assert_array_equal(
        tmask.binary_mask(torch.as_tensor(logits)).numpy(),
        np.asarray(jmask.binary_mask(jnp.asarray(logits))))


def _sim_case(rng, cap=160):
    jsim = JSim(entropy_model_opt=True, shN_ada_mask_opt=True, cap=cap,
                max_steps=30_000)
    jparams = jsim.init_params(jax.random.PRNGKey(4))
    jparams["ada_mask"] = jnp.asarray(
        rng.normal(0.5, 1.0, cap).astype(np.float32))
    p = _params(rng, cap)
    p["sh0"] = (rng.standard_normal((cap, 1, 3)) * 0.8).astype(np.float32)
    return jsim, jparams, p


@pytest.mark.parametrize("step", [0, 25_000])
def test_simulate_matches_jax(rng, step):
    """Step 0: fake quantization only; step 25,000: the entropy terms of
    quats, scales and sh0 and the shN mask are all on."""
    cap = 160
    jsim, jparams, p = _sim_case(rng, cap)
    sim = CompressionSimulation(entropy_model_opt=True, shN_ada_mask_opt=True,
                                cap=cap, max_steps=30_000)
    tparams = from_jax_sim_params(_np_tree(jparams), device="cpu")
    assert set(tparams) == set(sim.init_params(device="cpu"))
    w = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}

    def jloss(splats, sp):
        new, bits, aux = jsim.simulate(splats, sp, jnp.int32(step),
                                       jax.random.PRNGKey(0))
        return (sum(jnp.sum(new[k] * w[k]) for k in new) + 0.01 * bits
                + aux), (new, bits, aux)

    (_, (jnew, jbits, jaux)), (jgs, jgp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()}, jparams)
    ts = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tp = {k: v.requires_grad_(True) for k, v in tparams.items()}
    new, bits, aux = sim.simulate(ts, tp, step)
    loss = sum((new[k] * torch.as_tensor(w[k])).sum() for k in new) \
        + 0.01 * bits + aux
    loss.backward()
    for k in p:
        if k == "shN":  # under the mask: sigmoid rounds in another order
            np.testing.assert_allclose(new[k].detach().numpy(),
                                       np.asarray(jnew[k]), rtol=1e-6,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(new[k].detach().numpy(),
                                          np.asarray(jnew[k]), err_msg=k)
        assert close(ts[k].grad, jgs[k], 1e-5), k
    np.testing.assert_allclose(bits.item(), float(jbits), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    if step == 0:
        assert bits.item() == 0.0 and aux.item() == 0.0
    else:
        assert bits.item() > 0.0 and aux.item() > 0.0
    jg = from_jax_sim_params(_np_tree(jgp), device="cpu")
    for k, t in tp.items():
        if t.grad is None:  # the mask before its gate: no path to the loss
            assert step == 0 and k == "ada_mask"
            assert not np.asarray(jg[k]).any()
        else:
            tol = 1e-5 if k == "ada_mask" else 2e-3
            assert close(t.grad, jg[k].numpy(), tol), k


def test_simulation_adam_matches_optax(rng):
    cap = 64
    jsim, jparams, _ = _sim_case(rng, cap)
    tx, jstate = jsim.build_optimizer(jparams)
    sim = CompressionSimulation(entropy_model_opt=True, shN_ada_mask_opt=True,
                                cap=cap)
    tparams = from_jax_sim_params(_np_tree(jparams), device="cpu")
    groups, _ = sim.build_optimizer(tparams)
    grads = [jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32)
        * 10.0 ** rng.uniform(-3, 1), jparams) for _ in range(2)]
    upd, jstate = tx.update(grads[0], jstate, jparams)
    jparams = jax.tree_util.tree_map(lambda a, u: a + u, jparams, upd)
    # carry JAX's state after one step across, then take one more in both
    adam = jstate[0]
    tstates = from_jax_adam_state(adam.count, _np_tree(adam.mu),
                                  _np_tree(adam.nu), device="cpu")
    tparams = from_jax_sim_params(_np_tree(jparams), device="cpu")
    upd, jstate = tx.update(grads[1], jstate, jparams)
    jparams = jax.tree_util.tree_map(lambda a, u: a + u, jparams, upd)
    tparams, tstates = apply_updates(
        groups, tstates, tparams,
        from_jax_sim_params(_np_tree(grads[1]), device="cpu"))
    ref = from_jax_sim_params(_np_tree(jparams), device="cpu")
    mu = from_jax_sim_params(_np_tree(jstate[0].mu), device="cpu")
    for k in ref:
        # the factors start at 0: they are the updates alone
        tol = 2e-5 if ".factors." in k else 1e-6
        assert close(tparams[k], ref[k].numpy(), tol), k
        assert close(tstates[k]["exp_avg"], mu[k].numpy(), 1e-6), k
        assert tstates[k]["count"] == 2
