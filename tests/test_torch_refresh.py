"""The online representation refresh loop: the JAX package's ``refresh/``,
``env.run(refresh_schedule=...)`` and ``RouterService(refresh=...)``
against the port's, on the CPU.

* The duel log (masked folds, wraparound, a batch wider than the ring,
  the export) and ``category_mix`` equal the reference's exactly;
  ``duel_scores`` (IPW and naive; scatter-add order differs, so to rtol
  1e-6) and ``assign_categories`` (exactly); IPW restores the true order
  that opponent-selection bias inverts for the naive estimator;
  ``apply_refresh`` and ``schedule`` exactly.
* ``refresh_table`` end to end at a reduced encoder (1 layer, d 16) from
  the reference's weights under ``JaxDraws``: the live mix and the duel
  scores to 1e-6, the losses to 1e-5, the table to 1e-4 (lr 1e-6, so
  Adam's sign steps on near-zero gradients stay far below it); at the
  default lr 1e-3 the encoder's step to 1e-6, against controls with
  uniform and reversed row weights that land 4e-3 away.
* ``env.run(refresh_schedule=...)`` with and without delay: pairs
  exactly, regret to 1e-5, the swapped tables and the generation.
* The service on both paths (tick batch and streaming): propensities and
  categories recorded in the ring and the log (log leaves to 1e-5, the
  rest exactly), the sentinel 1.0 of a propensity-less policy, the
  ``refresh_due`` cadence, the duel log in checkpoints across both
  packages, a failed refresh job that leaves the old table serving, a
  refresh cycle that captures nothing anew, and the launcher's
  ``--refresh-every`` on both paths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import refresh as jref
from repro.core import env as jenv
from repro.core import model_pool as jmp
from repro.core import policy as jpol
from repro.data import pool as jpool
from repro.encoder import model as jenc
from repro.serving import router_service as jrs
from repro_torch import convert
from repro_torch import refresh as tref
from repro_torch.core import baselines as tbase
from repro_torch.core import env as tenv
from repro_torch.core import model_pool as tmp
from repro_torch.core import policy as tpol
from repro_torch.core.draws import KeyedDraws
from repro_torch.data import pool as tpool
from repro_torch.encoder import model as tenc
from repro_torch.launch import serve as tserve
from repro_torch.models.layers import tree_leaves
from repro_torch.serving import router_service as trs

from test_torch_env import JaxDraws
from test_torch_serving import (D, FACTORIES, K, KMAX, SEED, _close,
                                _entries, _np, _pool_data, _votes)

torch.set_num_threads(2)
M = 3


def t(a):
    return torch.from_numpy(np.array(a))


def _same(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


# ---------------------------------------------------------------------------
# the duel log
# ---------------------------------------------------------------------------

def test_init_log_requires_pow2():
    for pkg in (jref, tref):
        with pytest.raises(ValueError, match="power of two"):
            pkg.init_log(12, D) if pkg is jref else \
                pkg.init_log(12, D, device="cpu")
    _same(jref.init_log(16, D), tref.init_log(16, D, device="cpu"))


FOLDS = {
    # capacity, batches of (n rows, mask)
    "masked": (8, [(4, [True, False, True, False])]),
    "wraparound": (4, [(2, [True, True])] * 3),
    "wider_than_ring": (4, [(6, [True] * 6)]),
    "mixed": (8, [(5, [True, False, True, True, False]),
                  (7, [False, True, True, True, True, True, False])]),
}


@pytest.mark.parametrize("case", sorted(FOLDS))
def test_fold_and_export_match_reference(case):
    cap, batches = FOLDS[case]
    rng = np.random.default_rng(len(case))
    jl = jref.init_log(cap, D)
    tl = tref.init_log(cap, D, device="cpu")
    for n, mask in batches:
        x = rng.standard_normal((n, D)).astype(np.float32)
        a1, a2 = rng.integers(0, K, (2, n)).astype(np.int32)
        y = _votes(rng, n)
        pref, prop = rng.random((2, n)).astype(np.float32)
        cat = rng.integers(-1, M, n).astype(np.int32)
        issued = rng.integers(0, 9, n).astype(np.int32)
        args = (x, a1, a2, y, pref, prop, cat, issued, np.asarray(mask))
        jl = jref.fold(jl, *map(jnp.asarray, args))
        tl = tref.fold(tl, *map(t, args))
        _same(jl, tl)
    je, te = jref.export(jl), tref.export(tl)
    assert sorted(je) == sorted(te) and te["count"] == je["count"]
    for k in je:
        if k != "count":
            np.testing.assert_array_equal(te[k], je[k])
            assert te[k].dtype == je[k].dtype


def test_category_mix_matches_reference():
    for cat in ([0, 0, 2, -1, 7], [-1, -1], [], [1, 1, 1]):
        c = np.asarray(cat, np.int32)
        np.testing.assert_array_equal(
            tref.category_mix(t(c), M).numpy(),
            np.asarray(jref.category_mix(jnp.asarray(c), M)))


def _biased_log(n=2000, seed=7):
    """Opponent-selection bias: arm 1 (strong) duels the champion 90% of
    the time, arm 2 (mediocre) the weakest arm; BTL outcomes."""
    utils = np.array([0.9, 0.8, 0.5, 0.2])
    rng = np.random.default_rng(seed)
    anchor = rng.integers(1, 3, n)
    easy = rng.random(n) < 0.9
    opp = np.where(anchor == 1, np.where(easy, 0, 3), np.where(easy, 3, 0))
    prop = np.where(easy, 0.9, 0.1).astype(np.float32)
    p_win = 1.0 / (1.0 + np.exp(-8.0 * (utils[anchor] - utils[opp])))
    y = np.where(rng.random(n) < p_win, 1.0, -1.0).astype(np.float32)
    cat = rng.integers(-1, 2, n).astype(np.int32)     # -1: dropped
    return anchor.astype(np.int32), opp.astype(np.int32), y, cat, prop


@pytest.mark.parametrize("causal", [True, False])
def test_duel_scores_match_reference(causal):
    a1, a2, y, cat, prop = _biased_log()
    want = np.asarray(jref.duel_scores(a1, a2, y, cat, prop, 4, 2,
                                       causal=causal, prop_floor=0.05))
    got = tref.duel_scores(t(a1), t(a2), t(y), t(cat), t(prop), 4, 2,
                           causal=causal, prop_floor=0.05).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # one category: IPW ranks the strong arm first, the naive estimator
    # is fooled by the bias this log builds
    s = tref.duel_scores(t(a1), t(a2), t(y), t(np.zeros_like(cat)), t(prop),
                         4, 1, causal=causal)[:, 0]
    assert (s[1] > s[2]) == causal


def test_duel_scores_unseen_cells_and_dropped_arms():
    s = tref.duel_scores(t([0, 9]), t([1, 1]), t([1.0, 1.0]), t([0, 0]),
                         t([1.0, 1.0]), 4, 2)
    np.testing.assert_allclose(s[2:, :].numpy(), 0.5)    # never duelled
    np.testing.assert_allclose(s[:, 1].numpy(), 0.5)     # other category
    want = jref.duel_scores(jnp.asarray([0, 9]), jnp.asarray([1, 1]),
                            jnp.asarray([1.0, 1.0]), jnp.asarray([0, 0]),
                            jnp.asarray([1.0, 1.0]), 4, 2)
    np.testing.assert_allclose(s.numpy(), np.asarray(want), rtol=1e-6)


def test_assign_categories_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, D)).astype(np.float32)
    x[0] = 0.0                                        # a zero row
    xi = rng.standard_normal((D, M)).astype(np.float32)
    np.testing.assert_array_equal(
        tref.assign_categories(t(x), t(xi)).numpy(),
        np.asarray(jref.assign_categories(jnp.asarray(x), jnp.asarray(xi))))


def test_refresh_config_validates_like_reference():
    for kw in (dict(weighting="nope"), dict(capacity=0), dict(prop_floor=0),
               dict(prop_floor=1.5)):
        with pytest.raises(ValueError):
            jref.RefreshConfig(**kw)
        with pytest.raises(ValueError):
            tref.RefreshConfig(**kw)
    assert [f.name for f in jref.RefreshConfig.__dataclass_fields__
            .values()] == [f.name for f in tref.RefreshConfig
                           .__dataclass_fields__.values()]


# ---------------------------------------------------------------------------
# the offline trainer and the env schedule
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=64, d_model=D, n_layers=1, n_heads=2, d_ff=32,
             max_len=8)


def _refresh_case(lr):
    """One refresh cycle at ``lr`` by both packages from the same log (a
    quarter of its categories unknown, inferred from the refreshed
    prototypes), the same offline corpus and the reference's encoder
    weights, under the same draws. Returns (reference (table, info),
    port (table, info), the input weights as numpy leaves, a port rerun of
    the fine-tuning alone on the same draws: ``row_weights`` -> params)."""
    from repro_torch.contrastive import finetune_categorical
    jc, tc = jenc.EncoderConfig(**SMALL), tenc.EncoderConfig(**SMALL)
    params = jax.device_get(jenc.init_encoder(jax.random.PRNGKey(4), jc))
    rng = np.random.default_rng(8)
    tok = rng.integers(0, 64, (24, 8)).astype(np.int32)
    mask = np.ones(tok.shape, np.float32)
    cats = (np.arange(24) % M).astype(np.int32)
    n = 40
    log = dict(x=rng.standard_normal((n, D)).astype(np.float32),
               a1=rng.integers(0, K, n).astype(np.int32),
               a2=rng.integers(0, K, n).astype(np.int32), y=_votes(rng, n),
               pref=np.zeros(n, np.float32),
               prop=rng.uniform(0.01, 1.0, n).astype(np.float32),
               cat=np.where(rng.random(n) < 0.25, -1,
                            rng.integers(0, M, n)).astype(np.int32),
               issued_at=np.zeros(n, np.int32), count=n)
    costs = rng.random(K).astype(np.float32)
    kw = dict(n_categories=M, epochs=1, steps_per_epoch=2, batch=8, lr=lr)
    key = jax.random.PRNGKey(6)
    offline = tuple(map(t, (tok, mask, cats)))
    ref = jref.refresh_table(key, log, params, jc,
                             tuple(map(jnp.asarray, (tok, mask, cats))),
                             jref.RefreshConfig(**kw), K, costs=costs)
    port = tref.refresh_table(
        JaxDraws(key), log, convert.encoder_params_from_numpy(params,
                                                              device="cpu"),
        tc, offline, tref.RefreshConfig(**kw), K, costs=t(costs))

    def finetune(row_weights):
        return finetune_categorical(
            JaxDraws(key), convert.encoder_params_from_numpy(params,
                                                             device="cpu"),
            *offline, tc, epochs=1, steps_per_epoch=2, batch=8, lr=lr,
            row_weights=row_weights)[0]
    return ref, port, jax.tree.leaves(params), finetune, offline[2]


def test_refresh_table_matches_reference():
    (jt, ji), (tt, ti), _, _, _ = _refresh_case(1e-6)
    assert tt.shape == (K, D) and ti["n_duels"] == ji["n_duels"] == 40
    np.testing.assert_array_equal(ti["mix"].numpy(), np.asarray(ji["mix"]))
    np.testing.assert_allclose(ti["scores"].numpy(), np.asarray(ji["scores"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ti["losses"], ji["losses"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-4)


def test_refresh_table_update_matches_reference():
    """The fine-tuning's update at the default lr 1e-3: the refreshed
    encoder moves from the input weights by the reference's step, leaf by
    leaf, to 1e-6 (seen: 3e-8 of a 2e-3 step). Controls on the same
    draws: the step with uniform or reversed row weights lands 4e-3
    away, so an update made with the wrong live mix, or none, fails."""
    (_, ji), (_, ti), before, finetune, cats = _refresh_case(1e-3)
    ref_step = [np.asarray(a) - b
                for a, b in zip(jax.tree.leaves(ji["params"]), before)]

    def gap(tparams):
        return max(float(np.abs(p.numpy() - b - r).max()) for p, b, r in
                   zip(tree_leaves(tparams), before, ref_step))

    assert max(float(np.abs(r).max()) for r in ref_step) > 1e-3
    assert gap(ti["params"]) <= 1e-6
    for rows in (None, ti["mix"].flip(0)[cats.long()]):
        assert gap(finetune(rows)) > 1e-3


def test_schedule_and_apply_refresh_match_reference():
    rng = np.random.default_rng(9)
    t0, t1 = rng.standard_normal((2, K, D)).astype(np.float32)
    ev = [(1, t0), (3, t1)]
    js, ts = jref.schedule(ev), tref.schedule(ev, device="cpu")
    _same(js, ts)
    jp = jmp.init_pool(rng.standard_normal((K, D)).astype(np.float32))
    tp = tmp.init_pool(t(np.asarray(jp.a_emb)), device="cpu")
    for s in range(5):
        jp, tp = jref.apply_refresh(jp, js, s), tref.apply_refresh(tp, ts, s)
        _same(jp, tp)
    assert int(tp.generation) == 2


@pytest.mark.parametrize("delay", [0, 2])
def test_env_refresh_schedule_matches_reference(delay):
    """Table swaps at steps 1 and 3 of a pooled FGTS run (4 queries a
    tick): routed pairs exactly, regret to 1e-5, the last table in the
    final pool and two generation bumps."""
    from test_torch_env import _cfgs
    jcfg, tcfg = _cfgs(n_models=8, horizon=32)
    rng = np.random.default_rng(10)
    a = rng.standard_normal((K, D)).astype(np.float32)
    x = rng.standard_normal((24, D)).astype(np.float32)
    u = rng.random((24, 8)).astype(np.float32)
    tables = rng.standard_normal((2, 8, D)).astype(np.float32)
    ev = [(1, tables[0]), (3, tables[1])]
    jpol_ = jpol.fgts_policy(jmp.init_pool(a, None, 8), jcfg)
    tpol_ = tpol.fgts_policy(tmp.init_pool(a, None, 8, device="cpu"), tcfg)
    key = jax.random.PRNGKey(12)
    pairs = lambda s, a1, a2: (a1, a2)
    jcum, jst, jaux = jenv.run(key, jenv.EnvData(jnp.asarray(x),
                                                 jnp.asarray(u)), jpol_,
                               batch=4, delay=delay, aux_fn=pairs,
                               refresh_schedule=jref.schedule(ev))
    tcum, tst, taux = tenv.run(JaxDraws(key), tenv.EnvData(t(x), t(u)),
                               tpol_, batch=4, delay=delay, aux_fn=pairs,
                               refresh_schedule=tref.schedule(ev,
                                                              device="cpu"))
    for ja, ta in zip(jaux, taux):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tcum.numpy(), np.asarray(jcum), rtol=1e-5,
                               atol=1e-5)
    pool = tmp.get_pool(tst)
    np.testing.assert_array_equal(pool.a_emb.numpy(), tables[1])
    assert int(pool.generation) == 2
    static = tpol.fgts_policy(t(a), dataclasses.replace(tcfg, n_models=K))
    with pytest.raises(TypeError, match="PooledState"):
        tenv.run(KeyedDraws(0), tenv.EnvData(t(x), t(u)), static, batch=4,
                 refresh_schedule=tref.schedule(ev, device="cpu"))


POOL = tmp.init_pool(t(np.random.default_rng(0).standard_normal((K, D))
                       .astype(np.float32)), t([0.1, 0.2, 0.3, 0.4, 0.5]),
                     device="cpu")
POOLED = {
    "fgts": lambda: tpol.fgts_policy(POOL, trs.fgts.FGTSConfig(
        n_models=K, dim=D, horizon=32, sgld_steps=2, sgld_minibatch=4)),
    "uniform": lambda: tbase.uniform_policy(POOL),
    "eps_greedy": lambda: tbase.eps_greedy_policy(
        POOL, tbase.EpsGreedyConfig(n_models=K, dim=D)),
    "linucb": lambda: tbase.linucb_duel_policy(
        POOL, tbase.LinUCBConfig(n_models=K, dim=D)),
}


@pytest.mark.parametrize("name", sorted(POOLED))
def test_identity_swap_is_behavioural_noop(name):
    """Swapping in the table the pool already holds changes nothing but
    the generation: act and update bitwise as without the swap."""
    pol = POOLED[name]()
    state = pol.init(KeyedDraws(1))
    pool = tmp.get_pool(state)
    swapped = tmp.set_pool(state, tmp.set_table(pool, pool.a_emb))
    assert int(tmp.get_pool(swapped).generation) == int(pool.generation) + 1
    x = torch.randn(4, D, generator=torch.Generator().manual_seed(2))
    s_a, a1_a, a2_a = pol.act(KeyedDraws(3), state, x)
    s_b, a1_b, a2_b = pol.act(KeyedDraws(3), swapped, x)
    assert torch.equal(a1_a, a1_b) and torch.equal(a2_a, a2_b)
    y = torch.ones(4)
    for la, lb in zip(tree_leaves(pol.update(s_a, x, a1_a, a2_a, y)),
                      tree_leaves(pol.update(s_b, x, a1_b, a2_b, y))):
        if la.dim():               # generation is the one moving scalar
            assert torch.equal(la, lb)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

def _refresh_services(factory=None, buckets=None, every=0, capacity=32):
    """(reference, port) services with refresh on (the port under
    ``JaxDraws``), a dynamic pool of KMAX slots."""
    embs, costs = _pool_data(0, K)
    fkw = dict(n_models=KMAX, dim=D, horizon=32, eta=2.0, mu=0.3,
               sgld_steps=2, sgld_minibatch=8, n_chains=2,
               force_distinct=True)
    jfac, tfac = FACTORIES[factory]
    base = dict(k_max=KMAX, seed=SEED, feedback_capacity=32, buckets=buckets,
                cost_tilt=0.2 if factory else 0.0)
    rkw = dict(every=every, capacity=capacity, n_categories=M)
    js = jrs.RouterService(
        _entries(jpool.PoolEntry, embs, costs), None, None,
        jrs.RouterServiceConfig(
            fgts=jrs.fgts.FGTSConfig(**fkw), policy_factory=jfac,
            refresh=jref.RefreshConfig(**rkw), **base))
    ts = trs.RouterService(
        _entries(tpool.PoolEntry, embs, costs), None, None,
        trs.RouterServiceConfig(
            fgts=trs.fgts.FGTSConfig(**fkw), policy_factory=tfac,
            refresh=tref.RefreshConfig(**rkw), **base),
        device="cpu", draws=JaxDraws(jax.random.PRNGKey(SEED)))
    return js, ts


def _drive(js, ts, rounds, rng, n=8, check=None):
    """Route ``rounds`` batches with categories (a few unknown) and deliver
    each batch's votes at once, shuffled with a duplicate."""
    for r in range(rounds):
        x = rng.standard_normal((n, D)).astype(np.float32)
        c = np.where(np.arange(n) % 5 == 4, -1, np.arange(n) % M) \
            .astype(np.int32)
        ja = js.route_batch(jnp.asarray(x), cats=jnp.asarray(c))
        ta = ts.route_batch(t(x), cats=t(c))
        for a, b in zip(ja, ta):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
        tk = np.asarray(ja[2])
        tk = np.concatenate([rng.permutation(tk), tk[:1]])[:n]
        y = _votes(rng, tk.shape[0])
        nj = js.feedback_batch(jnp.asarray(tk), jnp.asarray(y))
        nt = ts.feedback_batch(t(tk), t(y))
        assert int(nt) == int(nj)
        _close(js.pending, ts.pending)
        _close(js.duel_log, ts.duel_log)
        if check is not None:
            check(r)


@pytest.mark.parametrize("factory,buckets", [(None, None), (None, (8,)),
                                             ("uniform", None),
                                             ("eps_greedy", (8,))])
def test_refresh_service_matches_reference(factory, buckets):
    """The tick-batch and the streaming path with refresh on: pairs and
    tickets exactly; the ring (propensities and categories in it) and the
    duel log to 1e-5; ``export_log``, ``refresh_due``, ``apply_table`` and
    ``service_stats`` alike. FGTS records soft-Thompson propensities in
    (0, 1]; the propensity-less policies the sentinel 1.0."""
    js, ts = _refresh_services(factory, buckets, every=12)
    rng = np.random.default_rng(11)

    def check(r):
        assert ts.refresh_due() == js.refresh_due() == (r == 1)
        if r == 1:
            table = rng.standard_normal((KMAX, D)).astype(np.float32)
            js.apply_table(jnp.asarray(table))
            ts.apply_table(t(table))
            assert not ts.refresh_due() and not js.refresh_due()
    _drive(js, ts, 3, rng, check=check)
    je, te = js.export_log(), ts.export_log()
    assert te["count"] == je["count"] == 24
    for k in ("x", "a1", "a2", "y", "pref", "cat", "issued_at"):
        np.testing.assert_array_equal(te[k], je[k])
    np.testing.assert_allclose(te["prop"], je["prop"], rtol=1e-5)
    if ts.policy.propensity is None:         # uniform, eps-greedy
        np.testing.assert_array_equal(te["prop"], 1.0)
    else:
        assert (te["prop"] > 0).all() and (te["prop"] <= 1).all()
        assert np.unique(te["prop"]).size > 1
    np.testing.assert_array_equal(np.unique(te["cat"]), [-1, 0, 1, 2])
    st, sj = ts.service_stats(), js.service_stats()
    np.testing.assert_allclose(st.pop("duel_cost"), sj.pop("duel_cost"),
                               rtol=1e-5)
    assert st == sj and st["table_swaps"] == 1


@pytest.mark.parametrize("buckets", [None, (8,)])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_duel_log_checkpoints_restore_across_packages(tmp_path, direction,
                                                      buckets):
    """The duel log rides the checkpoint (propensities included): saved by
    one package after a table swap and restored by the other, the logs
    agree, the cadence re-anchors at the restored head, and both keep
    serving alike."""
    js, ts = _refresh_services(buckets=buckets, every=8)
    rng = np.random.default_rng(12)
    _drive(js, ts, 2, rng)
    src, dst = (js, ts) if direction == "reference_to_port" else (ts, js)
    table = rng.standard_normal((KMAX, D)).astype(np.float32)
    src.apply_table(jnp.asarray(table) if src is js else t(table))
    src.save(str(tmp_path), step=7)
    dst.restore(str(tmp_path), step=7)
    _close(js.duel_log, ts.duel_log)
    _close(js.state, ts.state)
    assert not ts.refresh_due() and not js.refresh_due()
    ja, ta = js.export_log(), ts.export_log()
    assert ja["count"] == ta["count"] == 16
    _drive(js, ts, 1, rng)
    assert ts.refresh_due() and js.refresh_due()


def _port_refresh(buckets=None, **rkw):
    embs, costs = _pool_data(0, K)
    cfg = trs.RouterServiceConfig(
        fgts=trs.fgts.FGTSConfig(n_models=KMAX, dim=D, horizon=32,
                                 sgld_steps=2, sgld_minibatch=4),
        k_max=KMAX, feedback_capacity=32, buckets=buckets,
        refresh=tref.RefreshConfig(**{"capacity": 32, "n_categories": M,
                                      **rkw}))
    return trs.RouterService(_entries(tpool.PoolEntry, embs, costs), None,
                             None, cfg, device="cpu")


def _port_drive(svc, rounds, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        x = t(rng.standard_normal((8, D)).astype(np.float32))
        _, _, tk = svc.route_batch(x, cats=torch.arange(8) % M)
        svc.feedback_batch(tk, t(_votes(rng, 8)))


def test_failed_refresh_job_keeps_the_old_table():
    """The offline job dies after the export: the serving state has not
    moved, the old table keeps serving and no swap is counted."""
    svc = _port_refresh()
    _port_drive(svc, 2)
    before = tmp.get_pool(svc.state).a_emb.clone()
    log = svc.export_log()
    assert log["count"] == 16
    with pytest.raises(ValueError):
        tref.refresh_table(KeyedDraws(0), log, None, None,
                           (torch.zeros((4, 8), dtype=torch.int32),
                            torch.ones((4, 8)), torch.zeros(4)),
                           tref.RefreshConfig(weighting="nope"), KMAX)
    assert torch.equal(tmp.get_pool(svc.state).a_emb, before)
    _port_drive(svc, 1, seed=3)
    assert svc.service_stats()["table_swaps"] == 0


def test_refresh_needs_dynamic_pool_and_refresh_calls_need_it():
    with pytest.raises(ValueError, match="dynamic pool"):
        trs.RouterServiceConfig(fgts=trs.fgts.FGTSConfig(n_models=K, dim=D,
                                                         horizon=8),
                                refresh=tref.RefreshConfig())
    from test_torch_serving import _port_dynamic
    plain = _port_dynamic(K, KMAX)
    with pytest.raises(RuntimeError, match="refresh"):
        plain.export_log()
    assert not plain.refresh_due()


def test_stream_refresh_cycle_captures_nothing():
    """Streaming with refresh: route, fold, export, ``refresh_table`` at a
    reduced encoder, ``apply_table``, route on: program counts flat and
    the live tensors keep their addresses (on a card the graphs are never
    captured again)."""
    from repro_torch.data.synth import CorpusConfig, make_split
    svc = _port_refresh(buckets=(4, 8), every=12)
    counts = svc.compiled_program_counts()
    ptrs = [u.data_ptr() for u in svc._live_leaves()]
    _port_drive(svc, 2)
    assert svc.refresh_due()
    corpus = CorpusConfig(n_categories=M, seq_len=8)
    enc_cfg = tenc.EncoderConfig(**{**SMALL,
                                    "vocab_size": corpus.vocab_size})
    enc = tenc.init_encoder(torch.Generator().manual_seed(0), enc_cfg,
                            device="cpu")
    offline = make_split(torch.Generator().manual_seed(1), 4, corpus, "cpu")
    table, info = tref.refresh_table(
        KeyedDraws(2), svc.export_log(), enc, enc_cfg, offline,
        tref.RefreshConfig(n_categories=M, epochs=1, steps_per_epoch=2,
                           batch=8), KMAX, costs=svc.costs)
    assert table.shape == (KMAX, D) and bool(torch.isfinite(table).all())
    assert info["n_duels"] == 16
    svc.apply_table(table)
    assert not svc.refresh_due()
    assert torch.equal(tmp.get_pool(svc.state).a_emb, table)
    _port_drive(svc, 1, seed=4)
    assert svc.compiled_program_counts() == counts
    assert ptrs == [u.data_ptr() for u in svc._live_leaves()]
    assert svc.service_stats()["table_swaps"] == 1


@pytest.mark.parametrize("argv", [
    ["--rounds", "4", "--batch", "4", "--refresh-every", "8"],
    ["--rounds", "4", "--batch", "4", "--refresh-every", "8",
     "--refresh-naive", "--arrival", "bursty:2000,4", "--buckets", "2,4"],
])
def test_serve_launcher_refreshes_on_cpu(argv, capsys):
    out = tserve.main(["--device", "cpu"] + argv)
    assert out["stats"]["n_routed"] == 16
    assert out["stats"]["table_swaps"] >= 1
    assert out["stats"]["duels_logged"] == 16
    assert "representation refresh on" in capsys.readouterr().out
