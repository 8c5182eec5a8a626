"""gscodec_studio_tpu_torch's MCMC strategy against the JAX package on the
CPU: the relocation table and split, the relocation of dead slots, the
position noise and the strategy's refine. Inputs are made from seeds with
numpy; every random draw of the JAX package (its categorical source draw,
its normal noise) is handed to the port, which takes draws as arguments.

Tolerances:
  * compute_relocation: rtol 1e-5 (powers and sums in another order);
  * relocate_dead and MCMCStrategy.refine: parameters and moments within
    1e-6 of each tensor's largest |value|, the allocated mask equal;
  * inject_noise_to_position: means within 1e-6 of their largest |value|.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gscodec_studio_tpu.ops.relocation import (
    _cum_binom_table as jtable, compute_relocation as jcompute)
from gscodec_studio_tpu.strategy import MCMCStrategy as JMCMCStrategy
from gscodec_studio_tpu.strategy import ops as jops
from gscodec_studio_tpu_torch.models.splats import from_jax_mcmc_state
from gscodec_studio_tpu_torch.ops.relocation import (_cum_binom_table,
                                                     compute_relocation)
from gscodec_studio_tpu_torch.strategy import MCMCStrategy
from gscodec_studio_tpu_torch.strategy import ops as tops

from tests.test_torch_train import (_params, _state_with_moments, _to_torch,
                                    close, one_torch_thread)  # noqa: F401


def _assert_close_state(tp, tst, jp, jst, tol=1e-6):
    for k in jp:
        assert close(tp[k], jp[k], tol), k
        assert close(tst[k]["exp_avg"], jst[k][0].mu, tol), k
        assert close(tst[k]["exp_avg_sq"], jst[k][0].nu, tol), k


def _jax_sampled(params, dead, key):
    """The categorical draw of the JAX package's relocate_dead."""
    op = jax.nn.sigmoid(params["opacities"])
    logits = jnp.where(~dead, jnp.log(jnp.clip(op, 1e-12, 1.0)), -jnp.inf)
    return jax.random.categorical(key, logits, shape=(op.shape[0],))


def test_compute_relocation_matches_jax(rng):
    np.testing.assert_array_equal(_cum_binom_table(51), jtable(51))
    n = 300
    op = rng.uniform(0.001, 0.999, n).astype(np.float32)
    sc = np.exp(rng.normal(-3, 1, (n, 3))).astype(np.float32)
    ratios = rng.integers(1, 60, n).astype(np.int32)  # some above n_max
    jo, js = jcompute(jnp.asarray(op), jnp.asarray(sc), jnp.asarray(ratios))
    to, ts = compute_relocation(torch.as_tensor(op), torch.as_tensor(sc),
                                torch.as_tensor(ratios))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


def test_relocate_dead_matches_jax(rng):
    cap = 96
    p = _params(rng, cap)
    p["opacities"][rng.random(cap) < 0.3] = -9.0  # dead
    p, jst, tst = _state_with_moments(rng, p)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    dead = np.asarray(jax.nn.sigmoid(jp["opacities"])) <= 0.005
    key = jax.random.PRNGKey(5)
    sampled = _jax_sampled(jp, jnp.asarray(dead), key)
    c, d = jops.relocate_dead(jp, jst, key, jnp.asarray(dead))
    a, b = tops.relocate_dead(_to_torch(p), tst,
                              torch.as_tensor(np.array(sampled)),
                              torch.as_tensor(dead))
    _assert_close_state(a, b, c, d)
    assert not dead[np.asarray(sampled)[dead]].any()  # sources were alive


def test_relocation_never_births_dead(rng):
    """A source barely above the death threshold splits into slots that
    the min-opacity clamp keeps alive (the JAX package's f4a915e)."""
    cap = 128
    p = _params(rng, cap)
    p["opacities"][:] = np.log(0.006 / 0.994)
    p, jst, tst = _state_with_moments(rng, p)
    dead = np.arange(cap) >= cap // 2
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    key = jax.random.PRNGKey(0)
    sampled = torch.as_tensor(np.array(_jax_sampled(jp, jnp.asarray(dead),
                                                      key)))
    a, b = tops.relocate_dead(_to_torch(p), tst, sampled,
                              torch.as_tensor(dead))
    c, d = jops.relocate_dead(jp, jst, key, jnp.asarray(dead))
    _assert_close_state(a, b, c, d)
    assert float(torch.sigmoid(a["opacities"]).min()) >= 0.005 - 1e-6


def test_inject_noise_matches_jax(rng):
    cap = 200
    p = _params(rng, cap)
    p["opacities"][:50] = -9.0  # dead: no noise
    p["opacities"][50:100] = -4.0  # near transparent: the gate is open
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    key = jax.random.PRNGKey(3)
    noise = jax.random.normal(key, (cap, 3))
    ref = jops.inject_noise_to_position(jp, key, 1e-3)
    got = tops.inject_noise_to_position(_to_torch(p),
                                        torch.as_tensor(np.array(noise)),
                                        1e-3)
    assert close(got["means"], ref["means"], 1e-6)
    moved = (got["means"] - torch.as_tensor(p["means"])).abs().sum(-1)
    assert float(moved[:50].max()) == 0.0 and float(moved[50:100].min()) > 0


def test_sample_sources_draws_live_slots_by_opacity():
    cap = 4000
    logit = np.full(cap, -9.0, np.float32)
    logit[:2] = [2.0, -1.0]  # two live slots, op 0.881 and 0.269
    dead = torch.zeros(cap, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    s = tops.sample_sources(torch.as_tensor(logit), dead, g)
    assert s.shape == (cap,) and s.dtype == torch.int64
    counts = np.bincount(s.numpy(), minlength=cap)
    # the dead-opacity slots still count, with weight sigmoid(-9) each, as
    # in the JAX package: 3998 * 1.2e-4 = 0.49 against 0.88 and 0.27
    w = 1.0 / (1.0 + np.exp(-logit.astype(np.float64)))
    p = w / w.sum()
    assert abs(counts[0] / cap - p[0]) < 0.03
    assert abs(counts[1] / cap - p[1]) < 0.03
    dead = torch.as_tensor(np.arange(cap) >= 2)
    s = tops.sample_sources(torch.as_tensor(logit), dead, g)
    assert set(s.unique().tolist()) <= {0, 1}


def test_mcmc_refine_matches_jax(rng, monkeypatch):
    cap, n_init = 256, 150
    p = _params(rng, cap)
    p["opacities"][n_init:] = -15.0  # unallocated slots are dead
    p["opacities"][rng.random(cap) < 0.1] = -9.0  # dead allocated ones
    p, jst, tst = _state_with_moments(rng, p)
    js, ts = JMCMCStrategy(cap_max=cap), MCMCStrategy(cap_max=cap)
    jstate = js.initialize_state(cap, 1.3, n_init=n_init)
    tstate = from_jax_mcmc_state(jstate, device="cpu")
    assert torch.equal(tstate["allocated"],
                       ts.initialize_state(cap, 1.3, n_init=n_init)[
                           "allocated"])
    draws = []
    orig = jops.relocate_dead

    def spy(params, opt_states, key, dead, *a, **kw):
        draws.append(np.array(_jax_sampled(params, dead, key)))
        return orig(params, opt_states, key, dead, *a, **kw)

    monkeypatch.setattr(jops, "relocate_dead", spy)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _to_torch(p)
    n_alloc = [n_init]
    for i in range(3):
        jp, jst, jstate = js.refine(jp, jst, jstate, 1000,
                                    jax.random.PRNGKey(i))
        tp, tst, tstate = ts.refine(tp, tst, tstate, 1000,
                                    sampled=torch.as_tensor(draws[-1]))
        np.testing.assert_array_equal(tstate["allocated"].numpy(),
                                      np.asarray(jstate["allocated"]))
        _assert_close_state(tp, tst, jp, jst)
        n_alloc.append(int(tstate["allocated"].sum()))
    # ceil(1.05 n) each time: 150 -> 158 -> 166 -> 175
    assert n_alloc == [150, 158, 166, 175]
    op = torch.sigmoid(tp["opacities"])
    assert float(op[tstate["allocated"]].min()) > 0.004


def test_mcmc_growth_stops_at_capacity():
    cap = 100
    p = {"opacities": torch.full((cap,), 1.0), "scales": torch.zeros(cap, 3),
         "means": torch.zeros(cap, 3)}
    ts = MCMCStrategy(cap_max=cap)
    state = ts.initialize_state(cap, 1.0, n_init=98)
    g = torch.Generator().manual_seed(0)
    p, _, state = ts.refine(p, {}, state, 0, generator=g)
    assert int(state["allocated"].sum()) == cap
    p, _, state = ts.refine(p, {}, state, 0, generator=g)
    assert int(state["allocated"].sum()) == cap
