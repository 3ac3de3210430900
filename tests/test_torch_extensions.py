"""The port's extensions (``repro_torch.core.extensions``) against
``repro.core.extensions``: Plackett-Luce listwise feedback, pointwise
clicks, the mixed duel + click ring and estimator, and the two policies on
them.

Seeded numpy inputs go through both packages on the CPU. Continuous
outputs match to fp32 tolerance (potentials rtol 1e-5, gradients rtol 1e-4:
the same formulas summed in another order); discrete ones (rankings, ring
contents, routed pairs through ``env.run`` on replayed draws) exactly.
The JAX mixed estimator runs each of its backends as its own tests run
them on the CPU ("xla" is the Pallas kernel's interpret lowering).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import extensions as jext
from repro.core import fgts as jfgts
from repro.core import model_pool as jmp
from repro_torch import convert
from repro_torch.core import env as tenv
from repro_torch.core import extensions as text
from repro_torch.core import fgts as tfgts
from repro_torch.core import model_pool as tmp
from repro_torch.core.btl import sample_preference
from test_torch_env import JaxDraws, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
K, D, T, H = 6, 16, 48, 40


def n(v):
    return np.asarray(v)


# ---------------------------------------------------------------------------
# Plackett-Luce and pointwise terms
# ---------------------------------------------------------------------------

def test_pl_functions_match():
    rng = np.random.default_rng(0)
    s = rng.standard_normal((5, 4)).astype(np.float32)
    perm = np.stack([rng.permutation(4) for _ in range(5)]).astype(np.int32)
    want = n(jax.vmap(jext.pl_log_likelihood)(s, perm))
    np.testing.assert_allclose(text.pl_log_likelihood(t(s), t(perm)).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(
        text.pl_log_likelihood(t(s[0]), t(perm[0])).numpy(), want[0], **TOL)
    key = jax.random.PRNGKey(3)
    for i in range(5):
        k = jax.random.fold_in(key, i)
        np.testing.assert_array_equal(
            text.sample_pl_ranking(JaxDraws(k), t(s[i])).numpy(),
            n(jext.sample_pl_ranking(k, s[i])))
    a = rng.standard_normal((K, D)).astype(np.float32)
    x = rng.standard_normal(D).astype(np.float32)
    th = rng.standard_normal(D).astype(np.float32)
    arms = np.array([4, 1, 3], np.int32)
    rank = np.array([2, 0, 1], np.int32)
    np.testing.assert_allclose(
        text.pl_likelihood_term(t(th), t(x), t(arms), t(rank), t(a),
                                1.3).numpy(),
        n(jext.pl_likelihood_term(th, x, arms, rank, a, 1.3)), **TOL)
    for m in (1, 3, K):        # random scores: no ties for top_k to order
        np.testing.assert_array_equal(
            text.select_top_m(t(th), t(x), t(a), m).numpy(),
            n(jext.select_top_m(th, x, a, m)))
    for arm, y in ((2, 1.0), (2, 0.0), (5, 1.0)):
        np.testing.assert_allclose(
            text.pointwise_likelihood_term(t(th), t(x), arm, y, t(a),
                                           0.7).numpy(),
            n(jext.pointwise_likelihood_term(th, x, jnp.int32(arm),
                                             jnp.float32(y), a, 0.7)), **TOL)


# ---------------------------------------------------------------------------
# the mixed ring and estimator
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    base = dict(n_models=K, dim=D, horizon=H, eta=1.5, sgld_steps=3,
                sgld_minibatch=8, n_chains=2)
    base.update(kw)
    return jfgts.FGTSConfig(**base), tfgts.FGTSConfig(**base)


def _mixed_rows(rng, b, k=K):
    a1 = rng.integers(0, k, b).astype(np.int32)
    a2 = ((a1 + rng.integers(1, k, b)) % k).astype(np.int32)
    a2[::5] = a1[::5]                                    # self-duels
    duel = rng.random(b) < 0.5
    y = np.where(duel, np.where(rng.random(b) < 0.5, 1.0, -1.0),
                 (rng.random(b) < 0.5).astype(np.float64)).astype(np.float32)
    return (rng.standard_normal((b, D)).astype(np.float32), a1, a2, y, duel)


def _both_rings(batches, cfg_j, cfg_t):
    hj, ht = jext.init_mixed(cfg_j), text.init_mixed(cfg_t, device="cpu")
    for x, a1, a2, y, duel in batches:
        hj = jext.observe_mixed_batch(hj, jnp.asarray(x), jnp.asarray(a1),
                                      jnp.asarray(a2), jnp.asarray(y),
                                      jnp.asarray(duel))
        ht = text.observe_mixed_batch(ht, t(x), t(a1), t(a2), t(y), t(duel))
    return hj, ht


@pytest.mark.parametrize("sizes", [(5, 7), (17, 30), (60,)])
def test_mixed_ring_contents_exact(sizes):
    """Batched folds, wraparound and a batch larger than the ring, against
    the reference; one row at a time through ``observe_mixed`` too."""
    cfg_j, cfg_t = _cfgs()
    rng = np.random.default_rng(len(sizes))
    batches = [_mixed_rows(rng, b) for b in sizes]
    hj, ht = _both_rings(batches, cfg_j, cfg_t)
    for f in jext.MixedHistory._fields:
        np.testing.assert_array_equal(getattr(ht, f).numpy(),
                                      n(getattr(hj, f)), err_msg=f)
    hs = text.init_mixed(cfg_t, device="cpu")
    for x, a1, a2, y, duel in batches:
        for i in range(x.shape[0]):
            hs = text.observe_mixed(hs, t(x[i]), int(a1[i]), int(a2[i]),
                                    float(y[i]), bool(duel[i]))
    for f in jext.MixedHistory._fields:
        np.testing.assert_array_equal(getattr(hs, f).numpy(),
                                      getattr(ht, f).numpy(), err_msg=f)


@pytest.mark.parametrize("backend", ["fused", "xla", "autodiff"])
def test_mixed_potential_and_grad_match(backend):
    """U and dU/dtheta of the mixed estimator on a ring of duels, clicks
    and self-duels with some idx beyond the fill (invalid rows), per
    backend against the reference's same-named backend (its "fused" runs
    the Pallas kernel in interpret mode); theta (d,) as in the reference
    and (C,d) chains at once."""
    cfg_j, cfg_t = _cfgs(sgld_backend=backend)
    rng = np.random.default_rng(7)
    hj, ht = _both_rings([_mixed_rows(rng, 30)], cfg_j, cfg_t)
    a = rng.standard_normal((K, D)).astype(np.float32)
    th = rng.standard_normal((3, D)).astype(np.float32)
    idx = rng.integers(0, 36, (3, 8)).astype(np.int32)
    pot = jax.jit(jext.mixed_potential, static_argnums=(4,))
    grad = jax.jit(jax.grad(jext.mixed_potential), static_argnums=(4,))
    want_u = np.stack([n(pot(th[c], idx[c], hj, a, cfg_j)) for c in range(3)])
    want_g = np.stack([n(grad(th[c], idx[c], hj, a, cfg_j))
                       for c in range(3)])
    u = text.mixed_potential(t(th), t(idx), ht, t(a), cfg_t)
    np.testing.assert_allclose(u.numpy(), want_u, **TOL)
    u0 = text.mixed_potential(t(th[0]), t(idx[0]), ht, t(a), cfg_t)
    assert u0.dim() == 0
    np.testing.assert_allclose(u0.numpy(), want_u[0], **TOL)
    g = text._mixed_potential_grad(t(th), t(idx), ht, t(a), cfg_t)
    np.testing.assert_allclose(g.numpy(), want_g, **GRAD_TOL)


@pytest.mark.parametrize("fill", [5, 30, 55])
def test_mixed_chain_energy_is_the_windowed_potential(fill):
    """``mixed_chain_energy`` is U(theta) of every chain on the newest
    minibatch-sized window of the ring: equal to the JAX potential on the
    same rows (fewer rows than the window, more, and a wrapped ring)."""
    cfg_j, cfg_t = _cfgs(sgld_backend="xla")
    rng = np.random.default_rng(fill)
    hj, ht = _both_rings([_mixed_rows(rng, fill)], cfg_j, cfg_t)
    a = rng.standard_normal((K, D)).astype(np.float32)
    th = rng.standard_normal((3, D)).astype(np.float32)
    e = text.mixed_chain_energy(text.MixedState(ht, t(th)), t(a), cfg_t)
    rows = jnp.asarray((fill - 1 - np.arange(8)) % H)
    for c in range(3):
        want = jext.mixed_potential(th[c], rows, hj, a, cfg_j)
        np.testing.assert_allclose(e[c].item(), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# the policies through env.run, and clicks injected between ticks
# ---------------------------------------------------------------------------

def _world(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, D)).astype(np.float32),
            rng.standard_normal((T, D)).astype(np.float32),
            rng.random((T, 8)).astype(np.float32),
            rng.random(K).astype(np.float32))


@pytest.mark.parametrize("name,pooled", [("mixed_feedback", False),
                                         ("mixed_feedback", True),
                                         ("pl_pair", False),
                                         ("pl_pair", True)])
def test_policy_env_run_matches_reference(name, pooled):
    a, x, u, costs = _world(3)
    cfg_j, cfg_t = _cfgs(n_models=8 if pooled else K)
    jkw, tkw = {}, {}
    if pooled:
        arms_j, arms_t = jmp.init_pool(a, costs, 8), tmp.init_pool(
            a, costs, 8, device="cpu")
        ev = [(1, 2, None, None), (2, 6, a[0] * 0.5, 0.4)]
        jkw["pool_schedule"] = jmp.schedule(ev, D)
        tkw["pool_schedule"] = tmp.schedule(ev, D, device="cpu")
    else:
        arms_j, arms_t, u = jnp.asarray(a), t(a), u[:, :K]
    mk_j = getattr(jext, f"{name}_policy")
    mk_t = getattr(text, f"{name}_policy")
    key = jax.random.PRNGKey(1)
    aux = lambda s, a1, a2: (a1, a2)
    j_cum, j_st, (j1, j2) = jenv.run(
        key, jenv.EnvData(jnp.asarray(x), jnp.asarray(u)),
        mk_j(arms_j, cfg_j), batch=8, aux_fn=aux, **jkw)
    t_cum, t_st, (t1, t2) = tenv.run(
        JaxDraws(key), tenv.EnvData(t(x), t(u)), mk_t(arms_t, cfg_t),
        batch=8, aux_fn=aux, **tkw)
    np.testing.assert_array_equal(t1.numpy(), n(j1))
    np.testing.assert_array_equal(t2.numpy(), n(j2))
    np.testing.assert_allclose(t_cum.numpy(), n(j_cum), rtol=1e-5, atol=1e-5)
    ji = j_st.inner if pooled else j_st
    ti = t_st.inner if pooled else t_st
    if name == "mixed_feedback":
        theta_j, theta_t = ji[1], ti.theta
    else:
        theta_j, theta_t = ji.theta1, ti.theta1
    np.testing.assert_allclose(theta_t.numpy(), n(theta_j), rtol=1e-4,
                               atol=1e-5)


def test_mixed_policy_with_injected_clicks_matches_reference():
    """act -> BTL feedback -> update -> inject_clicks, tick by tick: exact
    pairs and ring, chains to 1e-4; the JAX state moves into the port
    through ``convert`` half way."""
    a, x, u, _ = _world(4)
    cfg_j, cfg_t = _cfgs(sgld_steps=2)
    jp, tp = jext.mixed_feedback_policy(jnp.asarray(a), cfg_j), \
        text.mixed_feedback_policy(t(a), cfg_t)
    key = jax.random.PRNGKey(2)
    j_act, j_upd = jax.jit(jp.act), jax.jit(jp.update)
    js, ts = jp.init(key), tp.init(JaxDraws(key))
    np.testing.assert_allclose(ts.theta.numpy(), n(js[1]), **TOL)
    rng = np.random.default_rng(5)
    rows = np.arange(4)
    for s, k in enumerate(jax.random.split(jax.random.PRNGKey(6), 6)):
        if s == 3:
            host = jax.device_get(js[0])
            ts = convert.mixed_state_from_numpy(
                {f: getattr(host, f) for f in host._fields}, js[1],
                device="cpu")
        xb = x[4 * s:4 * s + 4]
        k_act, k_fb = jax.random.split(k)
        js, j1, j2 = j_act(k_act, js, jnp.asarray(xb))
        ts, t1, t2 = tp.act(JaxDraws(k_act), ts, t(xb))
        np.testing.assert_array_equal(t1.numpy(), n(j1))
        np.testing.assert_array_equal(t2.numpy(), n(j2))
        ub = u[4 * s:4 * s + 4]
        y = sample_preference(JaxDraws(k_fb), t(5.0 * ub[rows, t1.numpy()]),
                              t(5.0 * ub[rows, t2.numpy()]))
        js = j_upd(js, jnp.asarray(xb), j1, j2, jnp.asarray(y.numpy()))
        ts = tp.update(ts, t(xb), t1, t2, y)
        xc = rng.standard_normal((3, D)).astype(np.float32)
        arms = rng.integers(0, K, 3).astype(np.int32)
        yc = (rng.random(3) < 0.5).astype(np.float32)
        js = jext.inject_clicks(js, jnp.asarray(xc), jnp.asarray(arms),
                                jnp.asarray(yc))
        ts = text.inject_clicks(ts, t(xc), t(arms), t(yc))
    for f in jext.MixedHistory._fields:
        np.testing.assert_array_equal(getattr(ts.h, f).numpy(),
                                      n(getattr(js[0], f)), err_msg=f)
    assert not bool(ts.h.is_duel[4:7].any())            # the first clicks
    np.testing.assert_allclose(ts.theta.numpy(), n(js[1]), rtol=1e-4,
                               atol=1e-5)


def test_inject_clicks_descends_a_pooled_state():
    a, x, _, costs = _world(5)
    _, cfg_t = _cfgs(n_models=8)
    pol = text.mixed_feedback_policy(tmp.init_pool(a, costs, 8, device="cpu"),
                                     cfg_t)
    st = pol.init(JaxDraws(jax.random.PRNGKey(0)))
    st = text.inject_clicks(st, t(x[:3]), torch.tensor([0, 1, 2]),
                            torch.tensor([1.0, 0.0, 1.0]))
    assert int(st.inner.h.t) == 3 and not bool(st.inner.h.is_duel.any())
    assert st.pool.a_emb.shape == (8, D)
    back = convert.state_to_numpy(st)
    np.testing.assert_array_equal(back["inner"]["h"]["a1"][:3], [0, 1, 2])
    cfg_auto = dataclasses.replace(cfg_t, sgld_backend="autodiff")
    th = torch.zeros((2, D))
    idx = torch.zeros((2, 4), dtype=torch.int64)
    u = text.mixed_potential(th, idx, st.inner.h, t(a), cfg_auto)
    assert u.shape == (2,) and bool(torch.isfinite(u).all())
