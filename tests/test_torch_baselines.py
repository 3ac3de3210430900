"""The port's baselines (``repro_torch.core.baselines``) against
``repro.core.baselines``, static and pooled, through ``env.run`` on
replayed draws (``JaxDraws``): exact pairs and regret to 1e-5, final
estimates to fp32 tolerance. Both sides run on the CPU at small shapes
(the reference's ``dueling_select`` in Pallas interpret mode).

LinUCB solves its ridge systems with ``torch.linalg.solve`` where the
reference inverts, so its UCB scores differ in the last bits. Its pairs
must match exactly up to the first tick with a near-tie (a row whose two
best candidates for a1, or for a2 once a1 is taken, lie within 1e-5 of the
largest UCB magnitude), where the two runs may rightly part; near-ties are
counted from the port's own UCB scores. At the first tick every arm's
bound is alpha up to rounding, so an untilted row would be all near-ties:
the per-request grid here has no zero, and on these inputs no near-tie
occurs, so the whole runs are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import env as jenv
from repro.core import model_pool as jmp
from repro_torch import convert
from repro_torch.core import baselines as tbase
from repro_torch.core import env as tenv
from repro_torch.core import model_pool as tmp
from test_torch_env import JaxDraws, t

torch.set_num_threads(2)
K, K_MAX, D, T, BATCH = 5, 8, 16, 48, 8
EVENTS = [(1, 1, None, None), (2, 6, "new", 0.4)]
GRID = np.array([0.25, 0.5, 2.0], np.float32)   # no untilted row


def n(v):
    return np.asarray(v)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return dict(a=rng.standard_normal((K, D)).astype(np.float32),
                x=rng.standard_normal((T, D)).astype(np.float32),
                u=rng.random((T, K_MAX)).astype(np.float32),
                costs=rng.random(K).astype(np.float32),
                new=rng.standard_normal(D).astype(np.float32))


def _policies(name, pooled, opt, dat):
    """(reference policy, port policy) for one case."""
    a, costs = dat["a"], dat["costs"]
    if pooled:
        arms_j = jmp.init_pool(a, costs, K_MAX)
        arms_t = tmp.init_pool(a, costs, K_MAX, device="cpu")
    else:
        arms_j, arms_t = jnp.asarray(a), t(a)
    kw_j, kw_t = {}, {}
    if opt == "tilt":
        kw_j, kw_t = dict(tilt=jnp.asarray(0.3 * costs)), dict(
            tilt=t(0.3 * costs))
    elif opt == "cost_tilt":
        kw_j = kw_t = dict(cost_tilt=0.3)
    k = K_MAX if pooled else K
    if name == "uniform":
        return (jbase.uniform_policy(arms_j if pooled else K),
                tbase.uniform_policy(arms_t if pooled else K, device="cpu"))
    if name == "best_fixed":
        um = dat["u"][:, :k].mean(0)
        return (jbase.best_fixed_policy(jnp.asarray(um),
                                        arms_j if pooled else None),
                tbase.best_fixed_policy(t(um), arms_t if pooled else None))
    if name == "eps_greedy":
        cfg = dict(n_models=k, dim=D, eps=0.3)
        return (jbase.eps_greedy_policy(arms_j, jbase.EpsGreedyConfig(**cfg),
                                        **kw_j),
                tbase.eps_greedy_policy(arms_t, tbase.EpsGreedyConfig(**cfg),
                                        **kw_t))
    cfg = dict(n_models=k, dim=D)
    return (jbase.linucb_duel_policy(arms_j, jbase.LinUCBConfig(**cfg),
                                     **kw_j),
            tbase.linucb_duel_policy(arms_t, tbase.LinUCBConfig(**cfg), **kw_t))


CASES = [
    # (baseline, pooled, option)
    ("uniform", False, None),
    ("uniform", True, None),
    ("best_fixed", False, None),
    ("best_fixed", True, None),
    ("eps_greedy", False, "tilt"),
    ("eps_greedy", True, "cost_tilt"),
    ("eps_greedy", True, "pref"),
    ("linucb_duel", False, "tilt"),
    ("linucb_duel", True, "cost_tilt"),
    ("linucb_duel", True, "pref"),
]


@pytest.mark.parametrize("name,pooled,opt", CASES)
def test_baseline_env_run_matches_reference(name, pooled, opt):
    dat = _data(CASES.index((name, pooled, opt)))
    jpolicy, tpolicy = _policies(name, pooled, opt, dat)
    u = dat["u"] if pooled else dat["u"][:, :K]
    jkw = dict(aux_fn=lambda s, a1, a2: (a1, a2))
    tkw = dict(aux_fn=lambda s, a1, a2: (a1, a2))
    if name == "linucb_duel":        # the state each act starts from
        tkw["aux_fn"] = lambda s, a1, a2: (
            a1, a2, (s.inner if pooled else s).A,
            (s.inner if pooled else s).b,
            s.pool.active if pooled else torch.ones(K, dtype=torch.bool))
    if pooled:
        ev = [(s, sl, None if e is None else dat["new"], c)
              for s, sl, e, c in EVENTS]
        jkw["pool_schedule"] = jmp.schedule(ev, D)
        tkw["pool_schedule"] = tmp.schedule(ev, D, device="cpu")
    if opt == "pref":
        jkw["pref_fn"] = lambda s, xb: jnp.asarray(GRID)[
            (s + jnp.arange(BATCH)) % 3]
        tkw["pref_fn"] = lambda s, xb: t(GRID)[(s + torch.arange(BATCH)) % 3]
    key = jax.random.PRNGKey(5)
    j_cum, j_st, (j1, j2) = jenv.run(
        key, jenv.EnvData(jnp.asarray(dat["x"]), jnp.asarray(u)), jpolicy,
        batch=BATCH, **jkw)
    t_cum, t_st, (t1, t2, *rest) = tenv.run(
        JaxDraws(key), tenv.EnvData(t(dat["x"]), t(u)), tpolicy, batch=BATCH,
        **tkw)
    upto = T // BATCH
    if name == "linucb_duel":
        upto = _first_near_tie_tick(dat, pooled, opt, t1, *rest)
    np.testing.assert_array_equal(t1.numpy()[:upto], n(j1)[:upto])
    np.testing.assert_array_equal(t2.numpy()[:upto], n(j2)[:upto])
    if upto < T // BATCH:
        return                       # the runs may part after a near-tie
    np.testing.assert_allclose(t_cum.numpy(), n(j_cum), rtol=1e-5, atol=1e-5)
    ji = j_st.inner if pooled else j_st
    ti = t_st.inner if pooled else t_st
    if name == "eps_greedy":
        np.testing.assert_allclose(ti.theta.numpy(), n(ji["theta"]),
                                   rtol=1e-5, atol=1e-6)
    elif name == "linucb_duel":
        for f in ("A", "b"):
            np.testing.assert_allclose(getattr(ti, f).numpy(), n(ji[f]),
                                       rtol=1e-5, atol=1e-5)
    if pooled:
        np.testing.assert_array_equal(t_st.pool.active.numpy(),
                                      n(j_st.pool.active))


def _first_near_tie_tick(dat, pooled, opt, a1, big_a, big_b, active):
    """The first tick with a near-tie row in the port's own UCB scores
    (T // BATCH when there is none). ``big_a``/``big_b``/``active`` are the
    per-tick post-update state; tick s acted on tick s-1's."""
    n_ticks = T // BATCH
    k = K_MAX if pooled else K
    emb = t(dat["a"])
    costs = t(dat["costs"])
    if pooled:
        emb = torch.cat([emb, torch.zeros(k - K, D)])
        emb[6] = t(dat["new"])
        costs = torch.cat([costs, torch.zeros(k - K)])
        costs[6] = 0.4
    x = t(dat["x"]).reshape(n_ticks, BATCH, D)
    for s in range(n_ticks):
        if s == 0:
            st = tbase.LinUCBState(torch.eye(D).expand(k, D, D),
                                   torch.zeros(k, D))
        else:
            st = tbase.LinUCBState(big_a[s - 1], big_b[s - 1])
        ucb = tbase.linucb_ucb(st, emb, x[s], 0.5)
        if opt == "tilt" or opt == "cost_tilt":
            ucb = ucb - 0.3 * costs
        elif opt == "pref":
            ucb = ucb - t(GRID)[(s + torch.arange(BATCH)) % 3][:, None] * costs
        ucb = torch.where(active[s], ucb, -torch.inf)
        thr = 1e-5 * float(torch.nan_to_num(ucb, neginf=0.0).abs().max())
        top = torch.topk(ucb, 3, dim=-1).values
        s2 = torch.where(torch.arange(k) == a1[s][:, None].long(),
                         -torch.inf, ucb)
        top2 = torch.topk(s2, 2, dim=-1).values
        gaps = torch.stack([top[:, 0] - top[:, 1], top2[:, 0] - top2[:, 1]])
        if bool((gaps <= thr).any()):
            return s
    return n_ticks


@pytest.mark.parametrize("name,pooled", [("eps_greedy", True),
                                         ("linucb_duel", False),
                                         ("uniform", True)])
def test_mid_run_state_carries_through_convert(name, pooled):
    """A reference baseline state after a run, moved into the port by
    ``convert.baseline_state_from_numpy``, acts alike on the next tick."""
    dat = _data(20)
    jpolicy, _ = _policies(name, pooled, None, dat)
    u = dat["u"] if pooled else dat["u"][:, :K]
    _, jst = jenv.run(jax.random.PRNGKey(6), jenv.EnvData(
        jnp.asarray(dat["x"][:24]), jnp.asarray(u[:24])), jpolicy,
        batch=BATCH)
    host = jax.device_get(jst)
    fields = lambda nt: {f: getattr(nt, f) for f in nt._fields}
    tst = convert.baseline_state_from_numpy(
        name, host.inner if pooled else host,
        fields(host.pool) if pooled else None, device="cpu")
    k = K_MAX if pooled else K
    arms = tst.pool if pooled else t(dat["a"])
    if name == "eps_greedy":
        tpolicy = tbase.eps_greedy_policy(arms, tbase.EpsGreedyConfig(
            n_models=k, dim=D, eps=0.3))
    elif name == "linucb_duel":
        tpolicy = tbase.linucb_duel_policy(arms, tbase.LinUCBConfig(k, D))
    else:
        tpolicy = tbase.uniform_policy(arms)
    key = jax.random.PRNGKey(7)
    xb = dat["x"][24:32]
    _, j1, j2 = jpolicy.act(key, jst, jnp.asarray(xb))
    _, t1, t2 = tpolicy.act(JaxDraws(key), tst, t(xb))
    np.testing.assert_array_equal(t1.numpy(), n(j1))
    np.testing.assert_array_equal(t2.numpy(), n(j2))


@pytest.mark.parametrize("mask_kind", ["k", "bk"])
def test_masked_pair_choice_matches_reference(mask_kind):
    """Gumbel top-2 over active arms, (K,) or per-row (B,K) masks, with
    single-survivor rows duelling (k, k)."""
    rng = np.random.default_rng(2)
    b, k = 12, 7
    if mask_kind == "k":
        active = rng.random(k) > 0.4
        active[3] = True
    else:
        active = rng.random((b, k)) > 0.5
        active[:, 0] = True
        active[0] = False
        active[0, 5] = True                        # single survivor
    key = jax.random.PRNGKey(9)
    j1, j2 = jmp.masked_pair_choice(key, jnp.asarray(active), b)
    t1, t2 = tmp.masked_pair_choice(JaxDraws(key), t(active), b)
    np.testing.assert_array_equal(t1.numpy(), n(j1))
    np.testing.assert_array_equal(t2.numpy(), n(j2))
    act2 = np.atleast_2d(active)
    rows = np.arange(b)
    assert act2[rows % act2.shape[0], t1.numpy()].all()
    if mask_kind == "bk":
        assert (t1[0].item(), t2[0].item()) == (5, 5)


def test_static_state_devices_and_guards():
    """Static baselines place their state where asked; a cost tilt needs a
    pool; best_fixed refuses utilities of the wrong width."""
    st = tbase.uniform_policy(4, device="cpu").init(None)
    assert st.device.type == "cpu" and st.shape == ()
    with pytest.raises(ValueError, match="ModelPool"):
        tbase.eps_greedy_policy(torch.zeros(3, 4), tbase.EpsGreedyConfig(3, 4),
                                cost_tilt=0.1)
    pool = tmp.init_pool(np.ones((3, 4), np.float32), k_max=5, device="cpu")
    with pytest.raises(ValueError, match="K_max"):
        tbase.best_fixed_policy(np.ones(3, np.float32), pool)
