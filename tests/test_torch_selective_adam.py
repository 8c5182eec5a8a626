"""SelectiveAdam in gscodec_studio_tpu_torch against the JAX package's
``selective_adam`` on the CPU, on groups of the splats' shapes with a
partial visibility, over three steps with the means' decayed rate, and the
JAX optimizer states carried across.

Tolerances: parameters and moments within 1e-6 relative (the same float32
chain; the decayed rate is formed in float64 here and in float32 by
optax, 1e-7 apart); the rows the visibility masks bit for bit unchanged,
parameters and moments.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gscodec_studio_tpu.optimizers.builders import (
    apply_updates as japply_updates,
    build_splat_optimizers as jbuild_optimizers,
)
from gscodec_studio_tpu.optimizers.selective_adam import selective_adam
from gscodec_studio_tpu_torch.models.splats import (
    from_jax_selective_adam_states)
from gscodec_studio_tpu_torch.optimizers import (apply_updates,
                                                 build_splat_optimizers)
from gscodec_studio_tpu_torch.optimizers.builders import AdamGroup
from gscodec_studio_tpu_torch.optimizers.selective_adam import (
    selective_adam_plain, selective_adam_step)

SHAPES = {"means": (3,), "quats": (4,), "scales": (3,), "opacities": (),
          "sh0": (1, 3), "shN": (15, 3)}
CAP = 200
MAX_STEPS = 50  # a short schedule, so that the means' rate decays visibly


def _params(rng):
    return {k: rng.standard_normal((CAP,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(rng):
    return {k: (rng.standard_normal((CAP,) + s)
                * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
            for k, s in SHAPES.items()}


def _copy(d):
    return {k: torch.tensor(np.array(v)) for k, v in d.items()}


def _close(a, b, tol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


def test_selective_adam_matches_jax_over_three_steps(rng):
    p0 = _params(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jtx, jst = jbuild_optimizers(jp, scene_scale=2.5, max_steps=MAX_STEPS,
                                 visible_adam=True)
    groups, st = build_splat_optimizers(_copy(p0), scene_scale=2.5,
                                        max_steps=MAX_STEPS,
                                        visible_adam=True)
    assert all(g.selective for g in groups.values())
    tp = _copy(p0)
    for step in range(3):
        g = _grads(rng)
        vis = rng.random(CAP) < 0.6
        before = {k: v.clone() for k, v in tp.items()}
        moments = {k: (s["exp_avg"].clone(), s["exp_avg_sq"].clone())
                   for k, s in st.items()}
        jp, jst = japply_updates(
            jtx, jst, jp, {k: jnp.asarray(v) for k, v in g.items()},
            visibility=jnp.asarray(vis, jnp.float32), visible_adam=True)
        tp, st = apply_updates(groups, st, tp, _copy(g),
                               visibility=torch.as_tensor(vis),
                               visible_adam=True)
        for k in SHAPES:
            _close(tp[k], jp[k])
            _close(st[k]["exp_avg"], jst[k].mu)
            _close(st[k]["exp_avg_sq"], jst[k].nu)
            assert st[k]["count"] == int(jst[k].count) == step + 1
            # masked rows: parameter and both moments keep their bits
            assert torch.equal(tp[k][~vis], before[k][~vis]), k
            assert torch.equal(st[k]["exp_avg"][~vis], moments[k][0][~vis])
            assert torch.equal(st[k]["exp_avg_sq"][~vis],
                               moments[k][1][~vis])
            assert not torch.equal(tp[k][vis], before[k][vis]), k


def test_schedule_is_read_at_count_plus_one():
    """The step after `count` updates uses lr_at(count + 1), as the JAX
    version's schedule(count + 1); optax.adam (and the port's plain Adam)
    read lr_at(count)."""
    lr0, decay = 1e-2, 4
    sched = lambda c: lr0 * 0.01 ** (c / decay)  # noqa: E731
    tx = selective_adam(sched, b1=0.9, b2=0.999, eps=1e-15)
    g = np.full((1, 2), 0.5, np.float32)
    jparams = jnp.zeros((1, 2))
    jst = tx.init(jparams)
    upd, jst = tx.update(jnp.asarray(g), jst, jparams,
                         visibility=jnp.ones(1))
    group = AdamGroup(lr0, 0.9, 0.999, 1e-15, decay, selective=True)
    state = {"count": 0, "exp_avg": torch.zeros(1, 2),
             "exp_avg_sq": torch.zeros(1, 2)}
    p, _ = apply_updates({"x": group}, {"x": state}, {"x": torch.zeros(1, 2)},
                         {"x": torch.as_tensor(g)},
                         visibility=torch.ones(1, dtype=torch.bool),
                         visible_adam=True)
    # the raw-moment step: -lr mu / sqrt(nu) = -lr (0.1 g) / (sqrt(1e-3) g)
    want = -group.lr_at(1) * 0.1 / np.sqrt(1e-3)
    assert float(p["x"][0, 0]) == pytest.approx(want, rel=1e-6)
    assert float(upd[0, 0]) == pytest.approx(want, rel=1e-6)
    assert group.lr_at(1) != group.lr_at(0)


def test_carried_jax_states_continue_alike(rng):
    """A JAX SelectiveAdam state after one step, carried into the port,
    gives JAX's second step."""
    jp = {k: jnp.asarray(v) for k, v in _params(rng).items()}
    jtx, jst = jbuild_optimizers(jp, max_steps=MAX_STEPS, visible_adam=True)
    vis = rng.random(CAP) < 0.5
    jvis = jnp.asarray(vis, jnp.float32)
    g1, g2 = ({k: jnp.asarray(v) for k, v in _grads(rng).items()}
              for _ in range(2))
    jp, jst = japply_updates(jtx, jst, jp, g1, visibility=jvis,
                             visible_adam=True)
    groups, _ = build_splat_optimizers(_copy(jp), max_steps=MAX_STEPS,
                                       visible_adam=True)
    st = from_jax_selective_adam_states(jst, device="cpu")
    tp, st = apply_updates(groups, st, _copy(jp), _copy(g2),
                           visibility=torch.as_tensor(vis),
                           visible_adam=True)
    jp, jst = japply_updates(jtx, jst, jp, g2, visibility=jvis,
                             visible_adam=True)
    for k in SHAPES:
        _close(tp[k], jp[k])
        _close(st[k]["exp_avg_sq"], jst[k].nu)
        assert st[k]["count"] == 2


@pytest.mark.parametrize("vis_kind", ["none", "all", "mixed"])
def test_step_wrapper_runs_the_plain_version_on_the_cpu(rng, vis_kind):
    """On CPU tensors the wrapper is the plain version, in place, for a
    size that is no multiple of 4."""
    shape = (37, 5)
    p, g, mu = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
                for _ in range(3))
    nu = torch.tensor(rng.random(shape), dtype=torch.float32)
    vis = {"none": np.zeros(37, bool), "all": np.ones(37, bool),
           "mixed": rng.random(37) < 0.5}[vis_kind]
    vis = torch.as_tensor(vis)
    ref = [t.clone() for t in (p, g, mu, nu)]
    selective_adam_plain(ref[0], ref[1], ref[2], ref[3], vis, 1e-3, 0.9,
                         0.999, 1e-15)
    selective_adam_step(p, g, mu, nu, vis, 1e-3, 0.9, 0.999, 1e-15)
    for a, b in zip((p, mu, nu), (ref[0], ref[2], ref[3])):
        assert torch.equal(a, b)
