"""The port's pool autopilot (``repro_torch.autopilot``) against
``repro.autopilot``.

Seeded numpy inputs go through both packages on the CPU: the JAX side runs
its Pallas score kernel in interpret mode (or ``posterior_scores_ref``),
the port its plain versions. Scores match to rtol = atol = 1e-5. The
dominance matrix, a discrete readout of strict ``>`` and ``==`` score
comparisons, must match exactly outside near-ties: arm pairs whose scores
lie within 1e-5 * max|s| in some sample are counted, not compared.
Controller decisions and counters are exact and lambda agrees to 1e-6.
Through ``env.run`` on replayed draws (``JaxDraws``) the wrapped policies
route the reference's exact pairs, with regret to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import autopilot as jap
from repro.core import baselines as jbase
from repro.core import env as jenv
from repro.core import fgts as jfgts
from repro.core import model_pool as jmp
from repro.core import policy as jpol
from repro.kernels.dueling_score import posterior_scores as jax_post_scores
from repro_torch import autopilot as tap
from repro_torch import convert
from repro_torch.core import baselines as tbase
from repro_torch.core import env as tenv
from repro_torch.core import fgts as tfgts
from repro_torch.core import model_pool as tmp
from repro_torch.core import policy as tpol
from repro_torch.kernels import dueling_score as tds
from test_torch_env import JaxDraws, t

torch.set_num_threads(2)
K, D = 5, 16
NEAR_TIE = 1e-5
CTRL_FLOATS = ("lam", "cost_ema")


def n(v):
    return np.asarray(v)


def near_tie_pairs(scores) -> np.ndarray:
    """(K, K) bool: pairs (i, j) whose scores lie within NEAR_TIE * max|s|
    of each other in some sample (the diagonal included)."""
    s = n(scores)
    thr = NEAR_TIE * np.abs(s).max()
    return (np.abs(s[:, :, None] - s[:, None, :]) <= thr).any(axis=0)


# ---------------------------------------------------------------------------
# dominance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,c,d", [(4, 2, 32), (11, 6, 64), (40, 3, 128),
                                   (8, 16, 32)])
def test_posterior_scores_and_dominance_match(k, c, d):
    rng = np.random.default_rng(k * 31 + c)
    a = rng.standard_normal((k, d)).astype(np.float32)
    a[k - 1] = a[0]                                   # a duplicated arm
    th = rng.standard_normal((c, d)).astype(np.float32)
    ref = n(jap.posterior_scores_ref(a, th))
    np.testing.assert_allclose(n(jax_post_scores(a, th)), ref, rtol=1e-5,
                               atol=1e-5)
    for got in (tds.posterior_scores(t(a), t(th)),
                tds.posterior_scores_plain(t(a), t(th)),
                tap.posterior_scores_ref(t(a), t(th))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    tie = near_tie_pairs(ref)
    assert tie[0, k - 1] and tie.sum() >= k + 2      # diagonal + duplicate
    for use_kernel in (True, False):
        want = n(jap.dominance_matrix(th, a, use_kernel=use_kernel))
        got = tap.dominance_matrix(t(th), t(a), use_kernel=use_kernel).numpy()
        np.testing.assert_array_equal(got[~tie], want[~tie])
        np.testing.assert_array_equal(np.diag(got), 0.5)
        np.testing.assert_array_equal(got + got.T, 1.0)


def test_win_matrix_and_dominated_by_cheaper_exact():
    """On given scores (ties included) both functions are exact."""
    rng = np.random.default_rng(5)
    s = rng.integers(0, 4, (7, 6)).astype(np.float32)   # many exact ties
    np.testing.assert_array_equal(tap.win_matrix(t(s)).numpy(),
                                  n(jap.win_matrix(s)))
    dom = n(jap.win_matrix(s))
    costs = np.array([0.1, 0.5, 0.5, 0.2, 1.0, 0.1], np.float32)
    win = rng.random(6) > 0.3
    lose = rng.random(6) > 0.3
    for tau in (0.3, 0.5, 0.75, 1.0):
        want = jap.dominated_by_cheaper(dom, costs, win, lose, tau)
        got = tap.dominated_by_cheaper(t(dom), t(costs), t(win), t(lose), tau)
        np.testing.assert_array_equal(got.numpy(), n(want))


# ---------------------------------------------------------------------------
# controller.step: the cases of the reference's tests, on both packages
# ---------------------------------------------------------------------------

def _aligned(a, best, worst, reps=6):
    e = a / np.linalg.norm(a, axis=-1, keepdims=True)
    return np.tile((e[best] - e[worst])[None], (reps, 1)).astype(np.float32)


_A = np.random.default_rng(11).standard_normal((K, D)).astype(np.float32)
_RAND_POST = np.random.default_rng(27).standard_normal((4, D)).astype(
    np.float32)
_C5 = [0.1, 0.2, 0.3, 0.4, 0.5]

# name -> (costs, retired slots, AutopilotConfig kwargs, ctrl overrides,
#          steps: a posterior (S, d), None, or ("set", ctrl overrides))
STEP_CASES = {
    "retire_after_window": (_C5, [], dict(tau=0.9, window=3), {},
                            [_aligned(_A, 0, 4)] * 3),
    "streak_resets": (_C5, [], dict(tau=0.9, window=3), {},
                      [_aligned(_A, 0, 4), None, _aligned(_A, 0, 4)]),
    "pricier_winner_spared": ([0.1, 0.2, 0.3, 0.4, 5.0], [],
                              dict(tau=0.9, window=1), {},
                              [_aligned(_A, 4, 0)]),
    "min_active_floor": (_C5, [2, 3, 4], dict(tau=0.9, window=1,
                                              min_active=2), {},
                         [_aligned(_A, 0, 1)]),
    "promote_and_rollback": (
        None, [], dict(promote_wins=4.0, max_cand_duels=10.0),
        dict(candidate=[False, False, True, True, False],
             cand_wins=[0.0, 0.0, 5.0, 1.0, 0.0],
             cand_duels=[0.0, 0.0, 8.0, 12.0, 0.0]), [None]),
    "budget_lambda": ([1.0] * K, [], dict(budget=0.5, budget_lr=0.5,
                                          lam_max=1.0),
                      dict(cost_ema=1.5),
                      [None] * 5 + [("set", dict(cost_ema=0.0))]
                      + [None] * 10),
    "permissive_tau": ([1.0] * K, [1, 2, 3, 4], dict(tau=0.3, window=1), {},
                       [_RAND_POST] * 3),
}


def _over(ctrl, fields, lib):
    return ctrl._replace(**{f: lib(np.asarray(v, np.asarray(
        getattr(ctrl, f)).dtype)) for f, v in fields.items()})


def _assert_ctrl_equal(tc, jc, what):
    for f in jap.ControllerState._fields:
        got, want = getattr(tc, f).numpy(), n(getattr(jc, f))
        if f in CTRL_FLOATS:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what}: {f}")


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_reference(case, use_kernel):
    """The port's ``step`` (scores through the kernel wrapper) against the
    reference's, scoring through its kernel or ``posterior_scores_ref``."""
    costs, retired, cfg_kw, ctrl_kw, steps = STEP_CASES[case]
    jp = jmp.init_pool(_A, None if costs is None else np.float32(costs))
    tp = tmp.init_pool(_A, None if costs is None else np.float32(costs),
                       device="cpu")
    for k in retired:
        jp, tp = jmp.retire_arm(jp, k), tmp.retire_arm(tp, k)
    jcfg, tcfg = jap.AutopilotConfig(**cfg_kw), tap.AutopilotConfig(**cfg_kw)
    jc = _over(jap.init_controller(jp.active), ctrl_kw, jnp.asarray)
    tc = _over(tap.init_controller(tp.active), ctrl_kw, torch.from_numpy)
    for i, post in enumerate(steps):
        if isinstance(post, tuple):
            jc = _over(jc, post[1], jnp.asarray)
            tc = _over(tc, post[1], torch.from_numpy)
            continue
        jc, jd = jap.step(jc, None if post is None else jnp.asarray(post), jp,
                          jcfg, use_kernel=use_kernel)
        tc, td = tap.step(tc, None if post is None else t(post), tp, tcfg)
        for f in jap.Decisions._fields:
            tol = dict(rtol=0, atol=1e-6) if f == "lam" else dict(rtol=0,
                                                                  atol=0)
            np.testing.assert_allclose(getattr(td, f).numpy(),
                                       n(getattr(jd, f)), **tol,
                                       err_msg=f"{case} step {i}: {f}")
        _assert_ctrl_equal(tc, jc, f"{case} step {i}")
        jp, tp = jap.apply_decisions(jp, jd), tap.apply_decisions(tp, td)
        np.testing.assert_array_equal(tp.active.numpy(), n(jp.active))
        assert int(tp.generation) == int(jp.generation)


# ---------------------------------------------------------------------------
# wrap(...) through env.run
# ---------------------------------------------------------------------------

T, BATCH, K_MAX = 48, 4, 6
AP_KW = dict(every=2, tau=0.75, window=2, quota=0.25, budget=0.35,
             budget_lr=0.5)


def _world(seed=0):
    """Linear world: slot K-1 is a bent copy of the best arm at 10x cost;
    slot K_MAX-1 arrives at tick 2 through a pool schedule."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((K, D)).astype(np.float32)
    theta = rng.standard_normal(D).astype(np.float32)
    x = rng.standard_normal((T, D)).astype(np.float32)

    def scores(a):
        num = (x * theta) @ a.T
        den = np.sqrt(np.maximum((x * x) @ (a * a).T, 1e-24))
        return num / den

    a = a[np.argsort(-scores(a).mean(0))]
    a[K - 1] = a[0] - 0.6 * theta * np.sign(a[0] @ theta) \
        + 0.2 * rng.standard_normal(D)
    new = rng.standard_normal(D).astype(np.float32)
    u = scores(np.concatenate([a, new[None]]))
    u = ((u - u.min()) / (u.max() - u.min())).astype(np.float32)
    costs = np.array([0.1, 0.2, 0.3, 0.2, 2.0], np.float32)
    return a.astype(np.float32), costs, x, u, new


def _inner_policies(pool_j, pool_t, kind):
    if kind == "fgts":
        kw = dict(n_models=K_MAX, dim=D, horizon=T, eta=8.0, sgld_steps=3,
                  sgld_minibatch=8, n_chains=2, force_distinct=True)
        return (jpol.fgts_policy(pool_j, jfgts.FGTSConfig(**kw)),
                tpol.fgts_policy(pool_t, tfgts.FGTSConfig(**kw)))
    if kind == "eps_greedy":
        return (jbase.eps_greedy_policy(pool_j, jbase.EpsGreedyConfig(K_MAX,
                                                                      D)),
                tbase.eps_greedy_policy(pool_t, tbase.EpsGreedyConfig(K_MAX,
                                                                      D)))
    return jbase.uniform_policy(pool_j), tbase.uniform_policy(pool_t)


WRAP_CASES = [
    # (inner policy, delay, per-request pref)
    ("fgts", 0, False),
    ("fgts", 2, True),
    ("eps_greedy", 0, False),
    ("uniform", 0, False),
]


@pytest.mark.parametrize("kind,delay,pref", WRAP_CASES)
def test_wrapped_env_run_matches_reference(kind, delay, pref):
    a, costs, x, u, new = _world()
    jp = jmp.init_pool(a, costs, K_MAX)
    tp = tmp.init_pool(a, costs, K_MAX, device="cpu")
    jinner, tinner = _inner_policies(jp, tp, kind)
    jw = jap.wrap(jinner, jap.AutopilotConfig(**AP_KW))
    tw = tap.wrap(tinner, tap.AutopilotConfig(**AP_KW))
    ev = [(2, K_MAX - 1, new, 0.3)]
    grid = np.array([0.0, 0.5, 2.0], np.float32)
    jkw = dict(delay=delay, pool_schedule=jmp.schedule(ev, D),
               aux_fn=lambda s, a1, a2: (a1, a2, jmp.get_pool(s).active))
    tkw = dict(delay=delay, pool_schedule=tmp.schedule(ev, D, device="cpu"),
               aux_fn=lambda s, a1, a2: (a1, a2, tmp.get_pool(s).active))
    if pref:
        jkw["pref_fn"] = lambda s, xb: jnp.asarray(grid)[
            (s + jnp.arange(BATCH)) % 3]
        tkw["pref_fn"] = lambda s, xb: t(grid)[(s + torch.arange(BATCH)) % 3]
    key = jax.random.PRNGKey(3)
    j_cum, j_st, (j1, j2, j_act) = jenv.run(
        key, jenv.EnvData(jnp.asarray(x), jnp.asarray(u)), jw, batch=BATCH,
        **jkw)
    t_cum, t_st, (t1, t2, t_act) = tenv.run(
        JaxDraws(key), tenv.EnvData(t(x), t(u)), tw, batch=BATCH, **tkw)
    np.testing.assert_array_equal(t1.numpy(), n(j1))
    np.testing.assert_array_equal(t2.numpy(), n(j2))
    np.testing.assert_array_equal(t_act.numpy(), n(j_act))
    np.testing.assert_allclose(t_cum.numpy(), n(j_cum), rtol=1e-5, atol=1e-5)
    _assert_ctrl_equal(t_st.ctrl, j_st.ctrl, kind)
    np.testing.assert_array_equal(tmp.get_pool(t_st).active.numpy(),
                                  n(jmp.get_pool(j_st).active))
    # every routed arm is active in its tick's post-act pool, and the
    # arrival registered
    rows = np.arange(T // BATCH)[:, None]
    act = t_act.numpy()
    assert act[rows, t1.numpy()].all() and act[rows, t2.numpy()].all()
    assert bool(t_st.ctrl.known[K_MAX - 1])


@pytest.mark.parametrize("kind", ["uniform", "fgts"])
def test_candidate_counts_fold_duplicate_indices(kind):
    """Resolved duels fold into the candidate counters as the reference's
    ``.at[].add`` does: duplicate indices accumulate, a lone survivor's
    a1 == a2 counts on both sides, a tie (y = 0) is no win, and a masked
    row is absent (``update_masked``, on the FGTS arm)."""
    a, costs, x, _, _ = _world(2)
    jp = jmp.init_pool(a, costs, K_MAX)
    tp = tmp.init_pool(a, costs, K_MAX, device="cpu")
    jinner, tinner = _inner_policies(jp, tp, kind)
    jw = jap.wrap(jinner, jap.AutopilotConfig(**AP_KW))
    tw = tap.wrap(tinner, tap.AutopilotConfig(**AP_KW))
    key = jax.random.PRNGKey(6)
    jst, tst = jw.init(key), tw.init(JaxDraws(key))
    cand = dict(candidate=[False, True, True, False, False, False],
                cand_wins=[0.0, 2.0, 0.0, 0.0, 0.0, 0.0],
                cand_duels=[0.0, 3.0, 1.0, 0.0, 0.0, 0.0])
    jst = jst._replace(ctrl=_over(jst.ctrl, cand, jnp.asarray))
    tst = tst._replace(ctrl=_over(tst.ctrl, cand, torch.from_numpy))
    a1 = np.array([1, 1, 2, 0, 2, 1, 3, 2], np.int32)
    a2 = np.array([1, 0, 2, 1, 3, 2, 1, 2], np.int32)
    y = np.array([1, -1, 1, -1, 1, 0, -1, -1], np.float32)
    xb = x[:8]
    if kind == "uniform":
        jst = jw.update(jst, jnp.asarray(xb), jnp.asarray(a1),
                        jnp.asarray(a2), jnp.asarray(y))
        tst = tw.update(tst, t(xb), t(a1), t(a2), t(y))
    else:
        mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
        jst = jw.update_masked(jst, jnp.asarray(xb), jnp.asarray(a1),
                               jnp.asarray(a2), jnp.asarray(y),
                               jnp.asarray(mask))
        tst = tw.update_masked(tst, t(xb), t(a1), t(a2), t(y), t(mask))
    _assert_ctrl_equal(tst.ctrl, jst.ctrl, kind)
    assert float(tst.ctrl.cand_duels[1]) > 3.0


def test_wrap_requires_act_masked_and_autopilot_state_carries():
    """``wrap`` refuses a static policy; a mid-run JAX autopilot state moved
    into the port through ``convert`` routes the same pairs."""
    a, costs, x, u, _ = _world(1)
    with pytest.raises(ValueError, match="act_masked"):
        tap.wrap(tbase.uniform_policy(K, device="cpu"),
                 tap.AutopilotConfig())
    jp = jmp.init_pool(a, costs, K_MAX)
    jinner, _ = _inner_policies(jp, tmp.init_pool(a, costs, K_MAX,
                                                  device="cpu"), "fgts")
    cfg = dict(AP_KW, every=1)
    jw = jap.wrap(jinner, jap.AutopilotConfig(**cfg))
    j_act, j_upd = jax.jit(jw.act), jax.jit(jw.update)
    rng = np.random.default_rng(0)
    jst = jw.init(jax.random.PRNGKey(4))
    ticks = jax.random.split(jax.random.PRNGKey(5), 6)
    for s, k in enumerate(ticks[:3]):          # the reference alone
        xb = jnp.asarray(x[4 * s:4 * s + 4])
        jst, j1, j2 = j_act(k, jst, xb)
        y = np.where(rng.random(4) < 0.5, 1.0, -1.0).astype(np.float32)
        jst = j_upd(jst, xb, j1, j2, jnp.asarray(y))
    host = jax.device_get(jst)
    fields = lambda nt: {f: getattr(nt, f) for f in nt._fields}
    tst = convert.autopilot_state_from_numpy(
        fields(host.inner.inner), fields(host.inner.pool), fields(host.ctrl),
        device="cpu")
    _assert_ctrl_equal(tst.ctrl, host.ctrl, "converted")
    tw = tap.wrap(tpol.fgts_policy(tst.inner.pool, tfgts.FGTSConfig(
        n_models=K_MAX, dim=D, horizon=T, eta=8.0, sgld_steps=3,
        sgld_minibatch=8, n_chains=2, force_distinct=True)),
        tap.AutopilotConfig(**cfg))
    for s, k in enumerate(ticks[3:], start=3):  # both, from one state
        xb = x[4 * s:4 * s + 4]
        jst, j1, j2 = j_act(k, jst, jnp.asarray(xb))
        tst, t1, t2 = tw.act(JaxDraws(k), tst, t(xb))
        np.testing.assert_array_equal(t1.numpy(), n(j1))
        np.testing.assert_array_equal(t2.numpy(), n(j2))
        y = np.where(rng.random(4) < 0.5, 1.0, -1.0).astype(np.float32)
        jst = j_upd(jst, jnp.asarray(xb), j1, j2, jnp.asarray(y))
        tst = tw.update(tst, t(xb), t1, t2, t(y))
    _assert_ctrl_equal(tst.ctrl, jst.ctrl, "continued")
