"""Parity of the port's deterministic core with the JAX package.

Seeded numpy inputs go through both; continuous outputs match to fp32
tolerance (rtol 1e-5: the same float32 formulas, summed in another order),
discrete ones (arm indices, ring contents, masks) exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import btl as jbtl
from repro.core import ccft as jccft
from repro.core import fgts as jfgts
from repro.core import model_pool as jmp
from repro.core import policy as jpol
from repro.core import regret as jreg
from repro.optim import sgld as jsgld
from repro_torch import convert
from repro_torch.core import btl as tbtl
from repro_torch.core import ccft as tccft
from repro_torch.core import fgts as tfgts
from repro_torch.core import model_pool as tmp
from repro_torch.core import policy as tpol
from repro_torch.core import regret as treg
from repro_torch.core.draws import HostDraws
from repro_torch.device import as_f32
from repro_torch.optim import sgld as tsgld

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def n(v):
    return np.asarray(v)


# ---------------------------------------------------------------------------
# btl, regret, sgld
# ---------------------------------------------------------------------------

def test_btl_matches():
    rng = np.random.default_rng(0)
    z = (4 * rng.standard_normal(200)).astype(np.float32)
    z[:3] = [-30.0, 30.0, 0.0]
    r1, r2 = z[:100], z[100:]
    np.testing.assert_allclose(tbtl.logistic_loss(t(z)).numpy(),
                               n(jbtl.logistic_loss(z)), **TOL)
    np.testing.assert_allclose(tbtl.preference_prob(t(r1), t(r2)).numpy(),
                               n(jbtl.preference_prob(r1, r2)), **TOL)


class _FixedUniform:
    """A draw source whose uniforms are given (the JAX side's, replayed)."""

    def __init__(self, u):
        self.u = u

    def uniform(self, shape, device):
        return t(self.u).reshape(shape).to(device)


def test_sample_preference_replays_uniforms():
    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(1)
    r1 = rng.standard_normal(64).astype(np.float32)
    r2 = rng.standard_normal(64).astype(np.float32)
    ref = jbtl.sample_preference(key, r1, r2)
    u = n(jax.random.uniform(key, (64,)))
    got = tbtl.sample_preference(_FixedUniform(u), t(r1), t(r2))
    np.testing.assert_array_equal(got.numpy(), n(ref))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("with_active", [False, True])
def test_instant_regret_matches(with_active):
    rng = np.random.default_rng(2)
    u = rng.random((9, 7)).astype(np.float32)
    a1 = rng.integers(0, 7, 9)
    a2 = rng.integers(0, 7, 9)
    active = np.array([1, 0, 1, 1, 0, 1, 1], bool) if with_active else None
    ref = jax.vmap(lambda uu, i, j: jreg.instant_regret(
        uu, i, j, active=active))(u, a1, a2)
    got = treg.instant_regret(t(u), t(a1), t(a2),
                              active=None if active is None else t(active))
    np.testing.assert_allclose(got.numpy(), n(ref), **TOL)


def test_instant_regret_edge_cases():
    u = t(np.array([0.2, 0.9, 0.4], np.float32))
    solo = t(np.array([False, True, False]))
    assert float(treg.instant_regret(u, 1, 1, active=solo)) == 0.0
    none = t(np.zeros(3, bool))
    assert float(treg.instant_regret(u, 0, 0, active=none)) == -np.inf


def test_slope_ratio_matches():
    for cum in (np.cumsum(np.linspace(1, 0.1, 50)), np.arange(3.0),
                np.array([1.0])):
        assert treg.slope_ratio(t(cum)) == pytest.approx(
            jreg.slope_ratio(cum), rel=1e-12)


def test_sgld_math_matches():
    for tt in (0.0, 7.0, 250.0):
        got = tsgld.decayed_step_size(5e-4, torch.tensor(tt), 100.0, 0.55)
        ref = jsgld.decayed_step_size(5e-4, jnp.float32(tt), 100.0, 0.55)
        np.testing.assert_allclose(got.numpy(), n(ref), rtol=1e-6)
    key = jax.random.PRNGKey(3)
    theta = {"b": jnp.ones((4,)), "a": jnp.arange(6.0).reshape(2, 3)}
    grad = {"b": jnp.full((4,), 2.0), "a": jnp.ones((2, 3))}
    ref = jsgld.sgld_step(theta, grad, 1e-2, key)
    # the JAX tree flattens dicts in sorted-key order: leaf i <- split(key)[i]
    noise = [n(jax.random.normal(k, s)) for k, s in
             zip(jax.random.split(key, 2), [(2, 3), (4,)])]

    class Replay:
        def split(self, k):
            return [_Noise(v) for v in noise[:k]]

    got = tsgld.sgld_step({k: t(n(v)) for k, v in theta.items()},
                          {k: t(n(v)) for k, v in grad.items()}, 1e-2,
                          Replay())
    for k in theta:
        np.testing.assert_allclose(got[k].numpy(), n(ref[k]), **TOL)


class _Noise:
    def __init__(self, v):
        self.v = v

    def normal(self, shape, device):
        return t(self.v).reshape(shape).to(device)


# ---------------------------------------------------------------------------
# ccft
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighting", ["perf", "perf_cost", "excel_perf_cost",
                                       "excel_mask"])
@pytest.mark.parametrize("tau", [1, 3])
def test_model_embeddings_match(weighting, tau):
    rng = np.random.default_rng(tau)
    xi = rng.standard_normal((24, 6)).astype(np.float32)
    scores = rng.random((9, 6)).astype(np.float32)
    scores[3, 2] = scores[5, 2]                   # dense-rank tie
    scores[1, 4] = scores[2, 4] = scores[7, 4]    # three-way tie
    ref = jccft.model_embeddings(xi, scores, weighting, tau)
    got = tccft.model_embeddings(t(xi), t(scores), weighting, tau)
    np.testing.assert_allclose(got.numpy(), n(ref), **TOL)


def test_dense_tau_threshold_ties():
    """Near-equal values within 1e-9 share a dense rank (paper Tab. 1)."""
    s = np.array([[0.920, 0.5], [0.920, 0.4], [0.91, 0.3], [0.90, 0.2],
                  [0.80, 0.1]], np.float32)
    for tau in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            tccft._dense_tau_threshold(t(s), tau).numpy(),
            n(jccft._dense_tau_threshold(s, tau)))
        np.testing.assert_array_equal(tccft.mask_tau(t(s), tau).numpy(),
                                      n(jccft.mask_tau(s, tau)))


def test_phi_and_scores_match():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 16)).astype(np.float32)
    a = rng.standard_normal((5, 16)).astype(np.float32)
    th = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(tccft.phi(t(x[:, None]), t(a[None])).numpy(),
                               n(jccft.phi(x[:, None], a[None])), **TOL)
    np.testing.assert_allclose(tccft.scores_all(t(x[0]), t(a), t(th)).numpy(),
                               n(jccft.scores_all(x[0], a, th)), **TOL)
    np.testing.assert_allclose(tccft.scores_batch(t(x), t(a), t(th)).numpy(),
                               n(jccft.scores_batch(x, a, th)), **TOL)
    cats = rng.integers(0, 4, 7)
    np.testing.assert_allclose(
        tccft.category_embeddings(t(x), t(cats), 4).numpy(),
        n(jccft.category_embeddings(x, cats, 4)), **TOL)


# ---------------------------------------------------------------------------
# fgts: likelihood, select_arms, observe, ring
# ---------------------------------------------------------------------------

def _ring(h, d, t_count, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((h, d)).astype(np.float32),
                a1=rng.integers(0, 5, h).astype(np.int32),
                a2=rng.integers(0, 5, h).astype(np.int32),
                y=np.sign(rng.standard_normal(h)).astype(np.float32),
                t=np.int32(t_count),
                theta1=rng.standard_normal((2, d)).astype(np.float32),
                theta2=rng.standard_normal((2, d)).astype(np.float32),
                pref=rng.random(h).astype(np.float32))


def _states(h, d, t_count, seed):
    r = _ring(h, d, t_count, seed)
    js = jfgts.FGTSState(**{k: jnp.asarray(v) for k, v in r.items()})
    return js, convert.fgts_state_from_numpy(**r, device="cpu")


def _assert_state_equal(ts, js):
    for k, v in convert.state_to_numpy(ts).items():
        ref = getattr(js, k)
        if v is None:
            assert ref is None
        else:
            np.testing.assert_array_equal(v, n(ref), err_msg=k)


@pytest.mark.parametrize("b,t_count,masked", [
    (5, 3, False), (5, 10, False), (17, 6, False),    # wrap, B > H
    (5, 3, True), (9, 10, True), (17, 6, True), (4, 0, True)])
def test_observe_batch_ring_contents_exact(b, t_count, masked):
    h, d = 12, 6
    js, ts = _states(h, d, t_count, seed=b)
    rng = np.random.default_rng(b + 100)
    xb = rng.standard_normal((b, d)).astype(np.float32)
    a1 = rng.integers(0, 5, b).astype(np.int32)
    a2 = rng.integers(0, 5, b).astype(np.int32)
    y = np.sign(rng.standard_normal(b)).astype(np.float32)
    pref = rng.random(b).astype(np.float32)
    mask = rng.random(b) < 0.6 if masked else None
    if masked and b == 4:
        mask[:] = False                              # nothing kept
    ref = jfgts.observe_batch(js, xb, a1, a2, y, mask=mask, pref=pref)
    got = tfgts.observe_batch(ts, t(xb), t(a1), t(a2), t(y),
                              mask=None if mask is None else t(mask),
                              pref=t(pref))
    _assert_state_equal(got, ref)


def test_observe_batch_keeps_input_state():
    _, ts = _states(6, 3, 2, seed=1)
    before = convert.state_to_numpy(ts)
    tfgts.observe_batch(ts, torch.ones(4, 3), torch.zeros(4, dtype=torch.int32),
                        torch.ones(4, dtype=torch.int32), torch.ones(4),
                        mask=t(np.array([1, 0, 1, 1], bool)))
    for k, v in convert.state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, before[k])


def test_scatter_drop_drops_out_of_range():
    """torch has no scatter mode="drop": index len(buf) must vanish."""
    buf = torch.arange(5.0)
    out = tfgts.scatter_drop(buf, torch.tensor([5, 1, 5, 3]),
                             torch.tensor([9.0, 7.0, 9.0, 8.0]))
    np.testing.assert_array_equal(out.numpy(), [0.0, 7.0, 2.0, 8.0, 4.0])
    np.testing.assert_array_equal(buf.numpy(), np.arange(5.0))


def test_observe_and_ring_slots_match():
    js, ts = _states(4, 3, 6, seed=2)
    ref = jfgts.observe(js, jnp.ones(3), 2, 3, -1.0, pref=0.5)
    got = tfgts.observe(ts, torch.ones(3), 2, 3, -1.0, pref=0.5)
    _assert_state_equal(got, ref)
    for tc, cap, b in ((3, 8, 5), (7, 4, 9), (0, 4, 4)):
        d_ref, i_ref = jfgts.ring_slots(jnp.int32(tc), cap, b)
        d_got, i_got = tfgts.ring_slots(torch.tensor(tc, dtype=torch.int32),
                                        cap, b)
        assert d_got == d_ref
        np.testing.assert_array_equal(i_got.numpy(), n(i_ref))


@pytest.mark.parametrize("j", [1, 2])
@pytest.mark.parametrize("tilted", [False, True])
def test_likelihood_batch_matches(j, tilted):
    rng = np.random.default_rng(j)
    m, k, d = 20, 6, 12
    x = rng.standard_normal((m, d)).astype(np.float32)
    a = rng.standard_normal((k, d)).astype(np.float32)
    th = rng.standard_normal(d).astype(np.float32)
    a1 = rng.integers(0, k, m)
    a2 = rng.integers(0, k, m)
    y = np.sign(rng.standard_normal(m)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1], bool)
    pref = rng.random(m).astype(np.float32) if tilted else None
    costs = rng.random(k).astype(np.float32) if tilted else None
    jc = jfgts.FGTSConfig(n_models=k, dim=d, horizon=m, eta=2.0, mu=0.3)
    tc = tfgts.FGTSConfig(n_models=k, dim=d, horizon=m, eta=2.0, mu=0.3)
    ref = jfgts.likelihood_batch(th, x, a1, a2, y, a, j, jc, mask, pref,
                                 costs)
    got = tfgts.likelihood_batch(t(th), t(x), t(a1), t(a2), t(y), t(a), j,
                                 tc, t(mask),
                                 None if pref is None else t(pref),
                                 None if costs is None else t(costs))
    np.testing.assert_allclose(got.numpy(), n(ref), **TOL)


@pytest.mark.parametrize("distinct", [False, True])
def test_select_arms_matches(distinct):
    rng = np.random.default_rng(9)
    a = rng.standard_normal((6, 10)).astype(np.float32)
    for s in range(6):
        x = rng.standard_normal(10).astype(np.float32)
        th1, th2 = rng.standard_normal((2, 10)).astype(np.float32)
        mask = rng.random(6) < 0.5
        mask[s] = True
        ref = jfgts.select_arms(th1, th2, x, a, distinct, mask)
        got = tfgts.select_arms(t(th1), t(th2), t(x), t(a), distinct,
                                t(mask))
        assert (int(got[0]), int(got[1])) == (int(ref[0]), int(ref[1]))


# ---------------------------------------------------------------------------
# policy helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("opts", ["none", "tilt_k", "mask_bk", "both"])
def test_select_pair_both_paths(use_kernel, opts):
    rng = np.random.default_rng(21)
    b, k, d = 9, 7, 16
    x = rng.standard_normal((b, d)).astype(np.float32)
    a = rng.standard_normal((k, d)).astype(np.float32)
    th1, th2 = rng.standard_normal((2, d)).astype(np.float32)
    tilt = (0.2 * rng.random(k)).astype(np.float32) \
        if opts in ("tilt_k", "both") else None
    mask = rng.random((b, k)) < 0.4 if opts in ("mask_bk", "both") else None
    if mask is not None:
        mask[0] = False
        mask[1, 3] = True
    ref = jpol.select_pair(x, a, th1, th2, tilt=tilt, mask=mask,
                           distinct=True, use_kernel=use_kernel)
    got = tpol.select_pair(t(x), t(a), t(th1), t(th2),
                           tilt=None if tilt is None else t(tilt),
                           mask=None if mask is None else t(mask),
                           distinct=True, use_kernel=use_kernel)
    np.testing.assert_array_equal(got[0].numpy(), n(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), n(ref[1]))


def test_pair_propensity_and_tilts_match():
    rng = np.random.default_rng(22)
    b, k, d = 6, 5, 8
    x = rng.standard_normal((b, d)).astype(np.float32)
    a = rng.standard_normal((k, d)).astype(np.float32)
    th1, th2 = rng.standard_normal((2, d)).astype(np.float32)
    a1 = rng.integers(0, k, b).astype(np.int32)
    a2 = rng.integers(0, k, b).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 1], bool)
    a1[a1 == 2] = 0
    a2[a2 == 2] = 1
    ref = jpol.pair_propensity(x, a, th1, th2, a1, a2, mask=mask)
    got = tpol.pair_propensity(t(x), t(a), t(th1), t(th2), t(a1), t(a2),
                               mask=t(mask))
    np.testing.assert_allclose(got.numpy(), n(ref), **TOL)
    costs = rng.random(k).astype(np.float32)
    pref = rng.random(b).astype(np.float32)
    assert tpol.cost_tilt_vector(None, 1.0) is None
    assert tpol.cost_tilt_vector(t(costs), 0.0) is None
    np.testing.assert_allclose(tpol.cost_tilt_vector(t(costs), 0.5).numpy(),
                               n(jpol.cost_tilt_vector(costs, 0.5)), **TOL)
    pt = tpol.pref_tilt(t(pref), t(costs))
    np.testing.assert_allclose(pt.numpy(), n(jpol.pref_tilt(pref, costs)),
                               **TOL)
    merged = tpol.merge_tilt(t(costs), pt)
    np.testing.assert_allclose(merged.numpy(),
                               n(jpol.merge_tilt(costs,
                                                 jpol.pref_tilt(pref, costs))),
                               **TOL)
    assert tpol.merge_tilt(None, pt) is pt and tpol.merge_tilt(pt, None) is pt


def test_with_staleness_discounts_labels():
    seen = {}

    def update(state, x, a1, a2, y):
        seen["y"] = y
        return state

    pol = tpol.with_staleness(tpol.RoutingPolicy(None, None, update), 2.0)
    pol.update_delayed(None, None, None, None, torch.ones(3),
                       torch.tensor([0, 2, 4]))
    np.testing.assert_allclose(seen["y"].numpy(), [1.0, 0.5, 0.25])
    np.testing.assert_array_equal(
        tpol.staleness_weight(torch.tensor([5]), 0.0).numpy(), [1.0])


# ---------------------------------------------------------------------------
# model pool
# ---------------------------------------------------------------------------

def _pool_pair(k=4, k_max=7, d=5, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((k, d))                  # float64 on purpose
    c = rng.random(k)
    return jmp.init_pool(a, c, k_max), tmp.init_pool(a, c, k_max,
                                                     device="cpu")


def _assert_pool_equal(tp, jp):
    for k, v in convert.state_to_numpy(tp).items():
        np.testing.assert_array_equal(v, n(getattr(jp, k)), err_msg=k)


def test_pool_ops_match():
    jp, tp = _pool_pair()
    assert tp.a_emb.dtype == torch.float32     # no float64 from numpy
    _assert_pool_equal(tp, jp)
    emb = np.arange(5, dtype=np.float32)
    _assert_pool_equal(tmp.set_arm(tp, 5, emb, 0.7),
                       jmp.set_arm(jp, 5, emb, 0.7))
    _assert_pool_equal(tmp.retire_arm(tp, 2), jmp.retire_arm(jp, 2))
    table = np.ones((7, 5), np.float32)
    _assert_pool_equal(tmp.set_table(tp, table), jmp.set_table(jp, table))
    with pytest.raises(ValueError):
        tmp.set_table(tp, np.ones((3, 5), np.float32))
    with pytest.raises(ValueError):
        tmp.init_pool(np.ones((4, 5)), k_max=3, device="cpu")


def test_pool_schedule_apply_events_match():
    jp, tp = _pool_pair(seed=1)
    emb = np.full(5, 0.5, np.float32)
    events = [(0, 4, emb, 0.3), (0, 1, None, None), (2, 5, emb, 0.9),
              (3, 4, None, None)]
    js = jmp.schedule(events, 5)
    ts = tmp.schedule(events, 5, device="cpu")
    for s in range(4):
        jp = jmp.apply_events(jp, js, s)
        tp = tmp.apply_events(tp, ts, s)
        _assert_pool_equal(tp, jp)


def test_pooled_state_accessors():
    _, tp = _pool_pair()
    inner = tfgts.init_state(tfgts.FGTSConfig(7, 5, 4), HostDraws(0), "cpu")
    st = tmp.PooledState(inner, tp)
    assert tmp.get_pool(st) is tp and tmp.is_pooled(st)
    assert not tmp.is_pooled(inner)
    with pytest.raises(TypeError):
        tmp.get_pool(inner)
    new = tmp.retire_arm(tp, 0)
    assert tmp.get_pool(tmp.set_pool(st, new)) is new


def test_as_f32_casts_numpy_float64():
    v = as_f32(np.linspace(0, 1, 5), "cpu")
    assert v.dtype == torch.float32
    st = convert.fgts_state_from_numpy(**_ring(4, 3, 1, seed=0) | dict(
        x=np.zeros((4, 3)), y=np.ones(4)), device="cpu")
    assert st.x.dtype == torch.float32 and st.y.dtype == torch.float32
    assert st.a1.dtype == torch.int32 and st.t.dtype == torch.int32
