"""The serving slice: the JAX ``RouterService`` against the port's on the
same inputs and draws, both on the CPU.

Both services get the same pool, config and numpy-made queries and votes;
the port draws through ``JaxDraws`` (``test_torch_env.py``), which replays
the reference's key tree, so routed pairs, tickets, ring slots, masks, ages
and ``ok`` flags must match exactly, and thetas and the fp32 rings to 1e-5.
Covered: the tick-batch path (out-of-order, duplicate, stale, expired,
overwritten and unknown tickets; prefs; staleness; expiry; the direct
fold), the dynamic pool (hot add with a warm-start replay, retire, swap,
table swap, the slot rules and guard rails), the autopilot, the baseline
policies' compaction fold, the int32 wrap of ticks and tickets, the pool
registry, checkpoints in both directions (and byte for byte where the
states are equal), the launcher and the example.
"""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import autopilot as jap
from repro.core import fgts as jfgts
from repro.core import model_pool as jmp
from repro.core import policy as jpol
from repro.data import pool as jpool
from repro.launch import serve as jserve
from repro.serving import feedback_queue as jfq
from repro.serving import router_service as jrs
from repro_torch import autopilot as tap
from repro_torch.checkpoint import msgpack_ckpt as tckpt
from repro_torch.core import fgts as tfgts
from repro_torch.core import model_pool as tmp
from repro_torch.core import policy as tpol
from repro_torch.core.draws import KeyedDraws
from repro_torch.data import pool as tpool
from repro_torch.launch import serve as tserve
from repro_torch.models.layers import tree_leaves
from repro_torch.serving import feedback_queue as tfq
from repro_torch.serving import router_service as trs

from test_torch_env import JaxDraws

torch.set_num_threads(2)

D, K, KMAX, B = 16, 5, 8, 8
SEED = 3
GRID = np.array([0.0, 0.5, 2.0], np.float32)
AP = dict(every=2, tau=0.75, window=1, quota=0.5, budget=0.3,
          promote_wins=4.0, max_cand_duels=12.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FACTORIES = {
    None: (None, None),
    "fgts_nocost": (lambda arms, costs, cfg: jpol.fgts_policy(arms,
                                                              cfg.fgts),
                    lambda arms, costs, cfg: tpol.fgts_policy(arms,
                                                              cfg.fgts)),
    **{n: (jserve.POLICIES[n], tserve.POLICIES[n])
       for n in ("eps_greedy", "linucb", "uniform")},
}


def _pool_data(seed=0, n=K):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)).astype(np.float32),
            (0.1 + rng.random(n)).astype(np.float32))


def _entries(cls, embs, costs, names=None):
    names = names or [f"m{i}" for i in range(len(embs))]
    return [cls(name=n, arch="granite-3-2b", cost_per_1k_tokens=float(c),
                embedding=e) for n, e, c in zip(names, embs, costs)]


def _services(k_max=None, factory=None, autopilot=False, n_arms=K,
              **cfg_kw):
    """(reference service, port service) from one config; the port draws
    through ``JaxDraws`` under the reference's own key."""
    embs, costs = _pool_data(0, n_arms)
    fkw = dict(n_models=k_max or n_arms, dim=D, horizon=32, eta=2.0,
               mu=0.3, sgld_steps=3, sgld_minibatch=8, n_chains=2,
               force_distinct=True)
    jfac, tfac = FACTORIES[factory]
    base = dict(k_max=k_max, seed=SEED, **{"feedback_capacity": 16,
                                           **cfg_kw})
    js = jrs.RouterService(
        _entries(jpool.PoolEntry, embs, costs), None, None,
        jrs.RouterServiceConfig(
            fgts=jfgts.FGTSConfig(**fkw), policy_factory=jfac,
            autopilot=jap.AutopilotConfig(**AP) if autopilot else None,
            **base))
    ts = trs.RouterService(
        _entries(tpool.PoolEntry, embs, costs), None, None,
        trs.RouterServiceConfig(
            fgts=tfgts.FGTSConfig(**fkw), policy_factory=tfac,
            autopilot=tap.AutopilotConfig(**AP) if autopilot else None,
            **base),
        device="cpu", draws=JaxDraws(jax.random.PRNGKey(SEED)))
    return js, ts


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close(jtree, ttree, tol=1e-5):
    """Leaves in flatten order: same shapes and dtypes; floats to ``tol``,
    everything else exactly."""
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(b, a)


def _route(js, ts, x, prefs=None):
    ja = js.route_batch(jnp.asarray(x), prefs=None if prefs is None
                        else jnp.asarray(prefs))
    ta = ts.route_batch(torch.from_numpy(x), prefs=None if prefs is None
                        else torch.from_numpy(prefs))
    for a, b in zip(ja, ta):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    return [np.array(a) for a in ja]


def _feed(js, ts, tickets, y):
    tickets = np.asarray(tickets, np.int32)
    y = np.asarray(y, np.float32)
    nj = js.feedback_batch(jnp.asarray(tickets), jnp.asarray(y))
    nt = ts.feedback_batch(torch.from_numpy(tickets), torch.from_numpy(y))
    assert int(nt) == int(nj)
    return int(nj)


def _votes(rng, n):
    return np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)


def _drive(js, ts, rounds, rng, prefs=False, direct=False, expire=False,
           check=None):
    """Route and resolve ``rounds`` batches. Each round delivers, in one
    call: 6 of the previous batch's tickets shuffled, two of them again
    (duplicates), the 2 held back the round before (late: overwritten or
    expired by now), a ticket resolved already (stale), a ticket never
    issued, and the newest batch's first ticket (age 0)."""
    issued, held, stale = [], np.zeros(0, np.int32), None
    for r in range(rounds):
        x = rng.standard_normal((B, D)).astype(np.float32)
        p = GRID[(np.arange(B) + r) % 3] if prefs else None
        a1, a2, t = _route(js, ts, x, p)
        issued.append(t)
        parts = [t[:1]]
        if r >= 1:
            perm = rng.permutation(issued[r - 1])
            parts += [perm[:6], perm[:2], held]
            held = perm[6:]
        if stale is not None:
            parts.append(stale)
        parts.append(np.array([100_000], np.int32))
        tk = np.concatenate(parts).astype(np.int32)
        _feed(js, ts, tk, _votes(rng, tk.shape[0]))
        stale = tk[:1]
        if direct and r == 2:        # the direct fold, ring untouched
            y = _votes(rng, B)
            js.feedback_direct(jnp.asarray(x), jnp.asarray(a1),
                               jnp.asarray(a2), jnp.asarray(y))
            ts.feedback_direct(torch.from_numpy(x), torch.from_numpy(a1),
                               torch.from_numpy(a2), torch.from_numpy(y))
        if direct and r == 3:        # ... and clearing its tickets
            y = _votes(rng, B)
            js.feedback_direct(jnp.asarray(x), jnp.asarray(a1),
                               jnp.asarray(a2), jnp.asarray(y),
                               tickets=jnp.asarray(t))
            ts.feedback_direct(torch.from_numpy(x), torch.from_numpy(a1),
                               torch.from_numpy(a2), torch.from_numpy(y),
                               tickets=torch.from_numpy(t))
        if expire:
            assert ts.expire_pending() == js.expire_pending()
        assert ts.pending_count() == js.pending_count()
        _close(js.state, ts.state)
        _close(js.pending, ts.pending)
        if check is not None:
            check(r)
    assert ts.service_stats()["n_folded"] == js.service_stats()["n_folded"]
    np.testing.assert_allclose(ts.service_stats()["duel_cost"],
                               js.service_stats()["duel_cost"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the tick-batch path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["static_pref_direct", "delayed_expiry",
                                  "masked_staleness"])
def test_route_and_feedback_match_reference(case):
    """Six rounds of routing and out-of-order feedback. ``static_pref``:
    the pref fold at capacity 16 (held-back votes find their slots
    overwritten) and the direct fold; ``delayed_expiry``: capacity 20
    rounded to 32, expiry 1 tick and a staleness half-life (late votes are
    consumed but rejected) with ``expire_pending``; ``masked_staleness``:
    a policy without a pref path takes the masked fold with staleness."""
    kw = dict(static_pref_direct=dict(),
              delayed_expiry=dict(feedback_capacity=20, feedback_expiry=1,
                                  stale_half_life=2.0),
              masked_staleness=dict(factory="fgts_nocost",
                                    stale_half_life=3.0))[case]
    js, ts = _services(**kw)
    assert ts.pending.x.shape[0] == js.pending.x.shape[0]
    _drive(js, ts, 6, np.random.default_rng(1),
           prefs=case == "static_pref_direct",
           direct=case == "static_pref_direct",
           expire=case == "delayed_expiry")


def test_feedback_batch_counts_stay_on_device_and_shapes_are_checked():
    ts = _port_dynamic(K, KMAX)
    x = np.random.default_rng(2).standard_normal((B, D)).astype(np.float32)
    _, _, t = ts.route_batch(torch.from_numpy(x))
    n = ts.feedback_batch(t, torch.ones(B))
    assert isinstance(n, torch.Tensor) and n.dtype == torch.int32
    assert int(n) == B
    with pytest.raises(ValueError, match="tickets shape"):
        ts.feedback_batch(t, torch.ones(B + 1))


@pytest.mark.parametrize("factory", ["eps_greedy", "linucb", "uniform"])
def test_baseline_policies_fold_by_compaction(factory):
    """Policies without a masked update resolve, then fold only the
    surviving rows (``_fold_compact``, a host int); linucb also through a
    staleness-wrapped delayed update. The pool is dynamic so that the
    factories take a live cost tilt, which separates the arms: on LinUCB's
    fresh ridge prior every UCB is alpha * |phi| = alpha, a tie that only
    rounding breaks."""
    kw = dict(stale_half_life=2.0) if factory == "linucb" else {}
    js, ts = _services(k_max=KMAX, factory=factory, cost_tilt=0.2, **kw)
    assert ts._update_masked is None and ts._update_pref is None
    rng = np.random.default_rng(4)
    for r in range(3):
        x = rng.standard_normal((B, D)).astype(np.float32)
        _, _, t = _route(js, ts, x)
        tk = np.concatenate([t[:5], t[:2], [100_000]]).astype(np.int32)
        y = _votes(rng, tk.shape[0])
        nj = js.feedback_batch(jnp.asarray(tk), jnp.asarray(y))
        nt = ts.feedback_batch(torch.from_numpy(tk), torch.from_numpy(y))
        assert isinstance(nt, int) and nt == int(nj) == 5
        _close(js.state, ts.state)
    st, sj = ts.service_stats(), js.service_stats()
    np.testing.assert_allclose(st.pop("duel_cost"), sj.pop("duel_cost"),
                               rtol=1e-5)
    assert st == sj


# ---------------------------------------------------------------------------
# the dynamic pool
# ---------------------------------------------------------------------------

def test_dynamic_pool_membership_matches_reference():
    """Rounds with prefs around a retirement, a hot add seeded by
    ``warm_start_duels``, a swap and a whole-table swap."""
    js, ts = _services(k_max=KMAX)
    rng = np.random.default_rng(5)
    new_e, new_c = _pool_data(9, 2)
    jnew = _entries(jpool.PoolEntry, new_e, new_c, ["new", "succ"])
    tnew = _entries(tpool.PoolEntry, new_e, new_c, ["new", "succ"])

    def events(r):
        if r == 0:
            js.retire_model(1)
            ts.retire_model(1)
        elif r == 1:
            x_off = rng.standard_normal((12, D)).astype(np.float32)
            u_off = rng.random((12, KMAX)).astype(np.float32)
            key = jax.random.PRNGKey(11)
            jrep = jmp.warm_start_duels(key, jnp.asarray(x_off),
                                        jnp.asarray(u_off), K,
                                        jnp.asarray(js.active_mask()))
            trep = tmp.warm_start_duels(JaxDraws(key),
                                        torch.from_numpy(x_off),
                                        torch.from_numpy(u_off), K,
                                        ts.active_mask())
            for a, b in zip(jrep, trep):
                np.testing.assert_array_equal(_np(b), np.asarray(a))
            assert js.add_model(jnew[0], replay=jrep) == K
            assert ts.add_model(tnew[0], replay=trep) == K
        elif r == 2:
            js.swap_model(2, jnew[1])
            ts.swap_model(2, tnew[1])
        elif r == 3:
            table = rng.standard_normal((KMAX, D)).astype(np.float32)
            js.apply_table(jnp.asarray(table))
            ts.apply_table(torch.from_numpy(table))
        np.testing.assert_array_equal(ts.active_mask(), js.active_mask())
        np.testing.assert_allclose(_np(ts.costs), np.asarray(js.costs))
        assert ts._ever_used == js._ever_used

    _drive(js, ts, 4, rng, prefs=True, check=events)


def _port_dynamic(n_arms, k_max, **kw):
    embs, costs = _pool_data(0, n_arms)
    cfg = trs.RouterServiceConfig(
        fgts=tfgts.FGTSConfig(n_models=k_max, dim=D, horizon=16,
                              sgld_steps=2, sgld_minibatch=4),
        k_max=k_max, **kw)
    return trs.RouterService(_entries(tpool.PoolEntry, embs, costs), None,
                             None, cfg, device="cpu")


def test_add_model_prefers_virgin_slots_and_warns_on_reuse():
    svc = _port_dynamic(2, 3)
    new = _entries(tpool.PoolEntry, *_pool_data(9, 2), ["a", "b"])
    svc.retire_model(0)
    assert svc.add_model(new[0]) == 2          # virgin slot, not freed 0
    svc.retire_model(1)
    with pytest.warns(UserWarning, match="reuses retired slot"):
        assert svc.add_model(new[1]) == 0      # no virgin slot left
    act = svc.active_mask()
    assert act[0] and not act[1] and act[2]


def test_service_guard_rails():
    """The reference's guard rails (tests/test_dynamic_pool.py, the
    membership ones; tests/test_pref.py, prefs and config)."""
    svc = _port_dynamic(2, 3)
    svc.add_model(_entries(tpool.PoolEntry, *_pool_data(6, 1), ["f"])[0])
    with pytest.raises(RuntimeError, match="capacity"):
        svc.add_model(_entries(tpool.PoolEntry, *_pool_data(7, 1),
                               ["g"])[0])
    svc.retire_model(0)
    svc.retire_model(1)
    with pytest.raises(RuntimeError, match="last active"):
        svc.retire_model(2)
    with pytest.raises(ValueError, match="not active"):
        svc.retire_model(0)
    with pytest.raises(ValueError, match="outside capacity"):
        svc.swap_model(3, svc.pool[2])
    _, static = _services()
    for call in (lambda: static.add_model(svc.pool[2]),
                 lambda: static.retire_model(0),
                 lambda: static.apply_table(torch.zeros(K, D))):
        with pytest.raises(RuntimeError, match="k_max"):
            call()
    x = torch.zeros((B, D))
    with pytest.raises(ValueError, match="prefs shape"):
        static.route_batch(x, prefs=torch.zeros(5))
    with pytest.raises(ValueError, match="prefs shape"):
        static.route_batch(x, prefs=torch.zeros((B, 1)))
    _, nopref = _services(factory="fgts_nocost")
    nopref.route_batch(x)
    with pytest.raises(ValueError, match="no act_pref path"):
        nopref.route_batch(x, prefs=torch.zeros(B))
    fcfg = tfgts.FGTSConfig(n_models=K, dim=D, horizon=8)
    with pytest.raises(ValueError, match="stale_half_life=NaN"):
        trs.RouterServiceConfig(fgts=fcfg, stale_half_life=float("nan"))
    with pytest.raises(ValueError, match="feedback_capacity"):
        trs.RouterServiceConfig(fgts=fcfg, feedback_capacity=0)
    with pytest.raises(ValueError, match="feedback_expiry"):
        trs.RouterServiceConfig(fgts=fcfg, feedback_expiry=-1)
    for hl in (0.0, -1.0, float("inf"), None):
        trs.RouterServiceConfig(fgts=fcfg, stale_half_life=hl)
    with pytest.raises(ValueError, match="must equal"):
        trs.RouterService(svc.pool[:2], None, None,
                          trs.RouterServiceConfig(fgts=fcfg, k_max=3),
                          device="cpu")
    with pytest.raises(ValueError, match="autopilot manages"):
        trs.RouterService(svc.pool[:1] * K, None, None,
                          trs.RouterServiceConfig(
                              fgts=fcfg,
                              autopilot=tap.AutopilotConfig()),
                          device="cpu")


@pytest.mark.parametrize("what", ["mesh", "use_kernel"])
def test_paths_not_yet_ported_name_their_roadmap_item(what):
    """Both paths are in the port now: ``use_kernel=False`` serves the
    plain selection as the reference's XLA path does (same pairs and
    posterior), and a mesh over another device type than the service's
    is refused (the gloo worlds of ``test_torch_mesh.py`` serve meshes)."""
    if what == "mesh":
        fcfg = tfgts.FGTSConfig(n_models=K, dim=D, horizon=8)
        pool = _entries(tpool.PoolEntry, *_pool_data(0, K))
        cfg = trs.RouterServiceConfig(fgts=fcfg)
        with pytest.raises(ValueError, match="mesh for a service"):
            trs.RouterService(pool, None, None, cfg, device="cpu",
                              mesh=types.SimpleNamespace(device_type="cuda"))
        return
    js, ts = _services(use_kernel=False)
    assert ts.cfg.use_kernel is False
    rng = np.random.default_rng(5)
    for _ in range(3):
        x = rng.standard_normal((B, D)).astype(np.float32)
        _, _, tk = _route(js, ts, x)
        _feed(js, ts, tk, _votes(rng, B))
    _close(js.state, ts.state)


# ---------------------------------------------------------------------------
# the autopilot
# ---------------------------------------------------------------------------

def test_autopilot_service_matches_reference():
    """A candidate arrival (with a replay that must not count toward its
    promotion), control ticks every 2 acts and the cost governor:
    ``autopilot_status`` equal after every round."""
    js, ts = _services(k_max=KMAX, autopilot=True)
    rng = np.random.default_rng(6)
    new_e, new_c = _pool_data(9, 1)

    def check(r):
        if r == 1:
            x_off = rng.standard_normal((8, D)).astype(np.float32)
            y_off = _votes(rng, 8)
            a1 = np.full(8, K, np.int32)
            a2 = np.arange(8, dtype=np.int32) % K
            js.add_model(_entries(jpool.PoolEntry, new_e, new_c, ["n"])[0],
                         replay=tuple(map(jnp.asarray,
                                          (x_off, a1, a2, y_off))))
            ts.add_model(_entries(tpool.PoolEntry, new_e, new_c, ["n"])[0],
                         replay=tuple(map(torch.from_numpy,
                                          (x_off, a1, a2, y_off))))
        sj, st = js.autopilot_status(), ts.autopilot_status()
        assert sorted(sj) == sorted(st)
        for k in sj:
            if k in ("lambda", "cost_ema"):
                np.testing.assert_allclose(st[k], sj[k], rtol=1e-5,
                                           atol=1e-7)
            else:
                np.testing.assert_array_equal(np.asarray(st[k]),
                                              np.asarray(sj[k]))
    _drive(js, ts, 6, rng, check=check)
    assert ts.autopilot_status()["cand_duels"][K] > 0


# ---------------------------------------------------------------------------
# int32 wraparound
# ---------------------------------------------------------------------------

def test_pending_ring_wraps_at_int32_boundary_like_reference():
    """Tickets cross 2^31 mid-batch, the clock wraps negative before the
    votes land, a duel 2^31 ticks old never validates and expires; a batch
    larger than the ring keeps its tail."""
    big = 2 ** 31 - 1
    x = np.arange(4, dtype=np.float32)[:, None] * np.ones((4, D), np.float32)
    a = np.zeros(4, np.int32)
    jq = jfq.init_pending(8, D)._replace(
        next_ticket=jnp.asarray(big - 1, jnp.int32))
    tq = tfq.init_pending(8, D, device="cpu")._replace(
        next_ticket=torch.tensor(big - 1, dtype=torch.int32))
    jq, jt = jfq.enqueue(jq, jnp.asarray(x), jnp.asarray(a), jnp.asarray(a),
                         jnp.asarray(big - 2, jnp.int32))
    tq, tt = tfq.enqueue(tq, torch.from_numpy(x), torch.from_numpy(a),
                         torch.from_numpy(a), big - 2)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    assert _np(tt)[2] == -2 ** 31
    _close(jq, tq)
    now = big - 2 + 5 - 2 ** 32                    # wrapped negative
    jq2, jres = jfq.resolve(jq, jt, jnp.ones(4), jnp.asarray(now, jnp.int32),
                            max_age=10)
    tq2, tres = tfq.resolve(tq, tt, torch.ones(4), now, max_age=10)
    _close(jres, tres)
    _close(jq2, tq2)
    assert _np(tres.ok).all() and (_np(tres.age) == 5).all()
    # age exactly 2^31: wrapped negative, rejected, consumed, expired
    jq, jt = jfq.enqueue(jfq.init_pending(8, D), jnp.asarray(x),
                         jnp.asarray(a), jnp.asarray(a), 0)
    tq, tt = tfq.enqueue(tfq.init_pending(8, D, device="cpu"),
                         torch.from_numpy(x), torch.from_numpy(a),
                         torch.from_numpy(a), 0)
    far = -2 ** 31
    jq3, jres = jfq.resolve(jq, jt, jnp.ones(4), jnp.asarray(far, jnp.int32))
    tq3, tres = tfq.resolve(tq, tt, torch.ones(4), far)
    _close(jres, tres)
    assert not _np(tres.ok).any() and (_np(tres.age) < 0).all()
    assert int(tfq.pending_count(tq3)) == int(jfq.pending_count(jq3)) == 0
    jq4, jd = jfq.expire(jq, jnp.asarray(far, jnp.int32), big)
    tq4, td = tfq.expire(tq, far, big)
    assert int(td) == int(jd) == 4
    _close(jq4, tq4)
    # a batch of 12 into 8 slots: the first 4 are issued already expired
    x12 = np.arange(12, dtype=np.float32)[:, None] * np.ones((12, D),
                                                            np.float32)
    a12 = np.zeros(12, np.int32)
    jq, jt = jfq.enqueue(jfq.init_pending(8, D), jnp.asarray(x12),
                         jnp.asarray(a12), jnp.asarray(a12), 0)
    tq, tt = tfq.enqueue(tfq.init_pending(8, D, device="cpu"),
                         torch.from_numpy(x12), torch.from_numpy(a12),
                         torch.from_numpy(a12), 0)
    _close(jq, tq)
    _, jres = jfq.resolve(jq, jt, jnp.ones(12), 1)
    _, tres = tfq.resolve(tq, tt, torch.ones(12), 1)
    _close(jres, tres)
    assert (~_np(tres.ok)[:4]).all() and _np(tres.ok)[4:].all()
    with pytest.raises(ValueError, match="power of two"):
        tfq.init_pending(12, D, device="cpu")


def test_service_clock_and_tickets_wrap_like_reference():
    js, ts = _services()
    big = 2 ** 31 - 1
    js.tick = ts.tick = 2 ** 31 - 2
    js.pending = js.pending._replace(next_ticket=jnp.asarray(big - 11,
                                                             jnp.int32))
    ts.pending = ts.pending._replace(next_ticket=torch.tensor(
        big - 11, dtype=torch.int32))
    rng = np.random.default_rng(7)
    for _ in range(3):                  # ticks 2^31-1 .. 2^31+1
        x = rng.standard_normal((B, D)).astype(np.float32)
        _, _, t = _route(js, ts, x)
        assert _feed(js, ts, t, np.ones(B, np.float32)) == B
    assert ts.tick == js.tick == 2 ** 31 + 1
    assert ts.pending_count() == js.pending_count() == 0
    _close(js.state, ts.state)
    _close(js.pending, ts.pending)


# ---------------------------------------------------------------------------
# the pool registry and warm starts
# ---------------------------------------------------------------------------

def test_pool_registry_matches_reference():
    key = jax.random.PRNGKey(5)
    archs = tserve.DEFAULT_POOL + ["arctic-480b"]
    je, jsk, jpr = jpool.synthetic_pool(key, archs, 5, D)
    te, tsk, tpr = tpool.synthetic_pool(JaxDraws(key), archs, 5, D,
                                        device="cpu")
    np.testing.assert_allclose(_np(tsk), np.asarray(jsk), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tpr), np.asarray(jpr), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(je, te):
        assert (a.name, a.arch, a.cost_per_1k_tokens) == \
            (b.name, b.arch, b.cost_per_1k_tokens)
        assert b.embedding.dtype == np.float32
        np.testing.assert_allclose(b.embedding, a.embedding, rtol=1e-5,
                                   atol=1e-6)
    assert tpool.CATEGORIES == jpool.CATEGORIES
    assert tpool.SKILLS == jpool.SKILLS
    assert tpool.arch_ids() == jpool.arch_ids()
    np.testing.assert_array_equal(tpool.skill_matrix(), jpool.skill_matrix())
    np.testing.assert_array_equal(tpool.serving_cost_per_1k(),
                                  jpool.serving_cost_per_1k())
    cats = np.random.default_rng(0).integers(0, 7, 20)
    for lam in (0.0, 0.3):
        np.testing.assert_array_equal(tpool.utilities(cats, lam),
                                      jpool.utilities(cats, lam))
    with pytest.raises(ValueError, match="pool shapes disagree"):
        tpool.build_entries(["a"], np.zeros((2, D)), [0.1])


@pytest.mark.parametrize("active", ["mixed", "one_arm"])
def test_warm_start_duels_match_reference(active):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((20, D)).astype(np.float32)
    u = rng.random((20, KMAX)).astype(np.float32)
    mask = np.zeros(KMAX, bool)
    mask[[5] if active == "one_arm" else [0, 2, 3, 5]] = True
    key = jax.random.PRNGKey(4)
    jout = jmp.warm_start_duels(key, jnp.asarray(x), jnp.asarray(u), 5,
                                jnp.asarray(mask), feedback_scale=8.0)
    tout = tmp.warm_start_duels(JaxDraws(key), torch.from_numpy(x),
                                torch.from_numpy(u), 5,
                                torch.from_numpy(mask), feedback_scale=8.0)
    for a, b in zip(jout, tout):
        assert _np(b).dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    if active == "one_arm":
        assert (_np(tout[2]) == 5).all() and (_np(tout[3]) == 0).all()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_treedef_prints_as_jax_does():
    from typing import NamedTuple

    class Rec(NamedTuple):
        a: object
        b: object = None
        c: object = None

    tree = {"z": Rec(np.zeros(2), None, (np.ones(1),)),
            "a": [np.zeros(1), (np.zeros(1), np.zeros(2))],
            "m": Rec(Rec(np.zeros(1)), np.zeros(1)), "n": None, "e": ()}
    assert tckpt._treedef(tree) == str(jax.tree.flatten(tree)[1])
    assert len(tree_leaves(tree)) == len(jax.tree.leaves(tree))


def _bytes(path, step):
    with open(os.path.join(path, f"ckpt_{step:08d}.msgpack"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["static", "dynamic", "autopilot"])
def test_fresh_service_checkpoints_byte_identical(tmp_path, kind):
    """Equal states save to equal files (treedef string included), and a
    reference file restored into the port saves back byte for byte."""
    kw = dict(static={}, dynamic=dict(k_max=KMAX),
              autopilot=dict(k_max=KMAX, autopilot=True))[kind]
    js, ts = _services(**kw)
    js.save(str(tmp_path / "j"), step=1)
    ts.save(str(tmp_path / "t"), step=1)
    assert _bytes(tmp_path / "t", 1) == _bytes(tmp_path / "j", 1)
    x = np.random.default_rng(9).standard_normal((B, D)).astype(np.float32)
    _, _, t = js.route_batch(jnp.asarray(x),
                             prefs=jnp.asarray(GRID[np.arange(B) % 3]))
    js.feedback_batch(t[:3], jnp.ones(3))
    js.save(str(tmp_path / "j"), step=2)
    ts.restore(str(tmp_path / "j"))
    ts.save(str(tmp_path / "t"), step=2)
    assert _bytes(tmp_path / "t", 2) == _bytes(tmp_path / "j", 2)


@pytest.mark.parametrize("factory", ["eps_greedy", "linucb"])
def test_baseline_checkpoints_restore_across_packages(tmp_path, factory):
    """The baselines' states are NamedTuples here and dicts in the
    reference: the files differ in their treedef string only, and each
    package restores the other's."""
    js, ts = _services(k_max=KMAX, factory=factory)
    js.save(str(tmp_path / "j"), step=1)
    ts.save(str(tmp_path / "t"), step=1)
    import msgpack
    jp, tp = (msgpack.unpackb(_bytes(tmp_path / w, 1)) for w in "jt")
    assert jp["leaves"] == tp["leaves"] and jp["treedef"] != tp["treedef"]
    ts.restore(str(tmp_path / "j"))
    js.restore(str(tmp_path / "t"))
    _close(js.state, ts.state)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoint_restores_across_packages(tmp_path, direction):
    """Two batches in flight and one resolved, saved by one package and
    restored into a fresh service of the other; both then take the late
    votes and route two more batches: pairs and tickets exactly, states
    to 1e-5."""
    js, ts = _services(k_max=KMAX)
    rng = np.random.default_rng(10)
    xs = [rng.standard_normal((B, D)).astype(np.float32) for _ in range(4)]
    prefs = GRID[np.arange(B) % 3]
    src_j = direction == "reference_to_port"
    if src_j:
        _, _, t0 = js.route_batch(jnp.asarray(xs[0]),
                                  prefs=jnp.asarray(prefs))
        _, _, t1 = js.route_batch(jnp.asarray(xs[1]))
        js.feedback_batch(t0, jnp.ones(B))
        js.save(str(tmp_path))
        ts.restore(str(tmp_path))
    else:
        _, _, t0 = ts.route_batch(torch.from_numpy(xs[0]),
                                  prefs=torch.from_numpy(prefs))
        _, _, t1 = ts.route_batch(torch.from_numpy(xs[1]))
        ts.feedback_batch(t0, torch.ones(B))
        ts.save(str(tmp_path))
        js.restore(str(tmp_path))
    assert ts.tick == js.tick == 2 and ts.n_routed == js.n_routed == 2 * B
    assert ts.pending_count() == js.pending_count() == B
    assert ts._ever_used == js._ever_used
    _close(js.state, ts.state)
    _close(js.pending, ts.pending)
    t1 = _np(t1)
    assert _feed(js, ts, t1[::-1].copy(), -np.ones(B, np.float32)) == B
    for x in xs[2:]:
        _route(js, ts, x, prefs)
    _close(js.state, ts.state)


def test_port_checkpoint_continues_bitwise_under_keyed_draws(tmp_path):
    """The port saved mid-flight under its own ``KeyedDraws`` and restored
    into a fresh service routes bitwise the pairs and tickets of the
    uninterrupted one."""
    def make():
        svc = _port_dynamic(K, KMAX, seed=2, feedback_capacity=32)
        assert isinstance(svc._draws, KeyedDraws)
        return svc
    rng = np.random.default_rng(11)
    xs = [torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
          for _ in range(5)]
    a = make()
    _, _, t0 = a.route_batch(xs[0])
    _, _, t1 = a.route_batch(xs[1], prefs=torch.full((B,), 0.5))
    a.feedback_batch(t0, torch.ones(B))
    a.save(str(tmp_path))
    b = make()
    b.route_batch(xs[4])              # a different history, overwritten
    b.restore(str(tmp_path))
    assert b._draws.key == a._draws.key
    for s in (a, b):
        s.feedback_batch(t1, -torch.ones(B))
    for x in xs[2:4]:
        ra, rb = a.route_batch(x), b.route_batch(x)
        for u, v in zip(ra, rb):
            assert torch.equal(u, v)
    for u, v in zip(tree_leaves((a.state, a.pending)),
                    tree_leaves((b.state, b.pending))):
        assert torch.equal(u, v)
    with pytest.raises(RuntimeError, match="incompatible router"):
        _port_dynamic(K, KMAX + 1).restore(str(tmp_path))


def test_keyed_draws_follow_their_key():
    k = KeyedDraws(7)
    assert k.key == (0, 7)
    np.testing.assert_array_equal(k.key_leaf(), np.array([0, 7], np.uint32))
    c1, c2 = k.split(2)
    assert c1.key != c2.key and k.split(2)[0].key == c1.key
    assert torch.equal(c1.normal((4,), "cpu"), c1.normal((4,), "cpu"))
    back = k.from_leaf(torch.from_numpy(c2.key_leaf()))
    assert back.key == c2.key and torch.equal(back.uniform((3,), "cpu"),
                                              c2.uniform((3,), "cpu"))
    h = KeyedDraws(7, host=True)
    assert h.split(2)[0].key == c1.key and h.from_leaf(c1.key_leaf()).host
    idx, noise = h.sgld(2, 3).step(1, 5, torch.tensor(3), D, "cpu")
    assert idx.shape == (2, 5) and int(idx.max()) < 3
    assert noise.shape == (2, D)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--policy", "eps_greedy", "--feedback-delay", "1",
     "--feedback-expiry", "2", "--stale-half-life", "2"],
    ["--autopilot", "--budget", "0.3", "--autopilot-every", "1",
     "--pool-schedule", "+arctic-480b@1,-0@1", "--pref-dist",
     "grid:0,0.5,2", "--with-generation", "--gen-tokens", "2"],
])
def test_serve_launcher_runs_on_cpu(argv, capsys):
    out = tserve.main(["--device", "cpu", "--rounds", "2", "--batch", "4"]
                      + argv)
    assert len(out["regrets"]) == 2 and np.isfinite(out["regrets"]).all()
    assert out["stats"]["n_routed"] == 8
    assert "[serve] regret early=" in capsys.readouterr().out


@pytest.mark.parametrize("arch", tserve.DEFAULT_POOL)
def test_greedy_decode_runs_every_default_pool_family(arch):
    """``--with-generation`` decodes the routed arms' reduced LMs: every
    family of the default pool prefills and steps on the port."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    cfg = ARCHS[arch].reduced()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    prompt = torch.arange(8, dtype=torch.int32)[None] % cfg.vocab_size
    out = tserve.greedy_decode(cfg, params, prompt, 3)
    assert len(out) == 3 and all(0 <= t < cfg.vocab_size for t in out)


@pytest.mark.parametrize("flag", ["--mesh"])
def test_serve_launcher_names_missing_paths(flag):
    """Every flag of the reference is in the port: ``--mesh`` serves (the
    gloo world in ``test_torch_mesh.py``) and refuses a malformed mesh and
    a batch that does not divide over its data axis."""
    with pytest.raises(SystemExit, match="DATA,MODEL"):
        tserve.main(["--device", "cpu", flag, "1"])
    with pytest.raises(SystemExit, match="divide"):
        tserve.main(["--device", "cpu", "--batch", "4", flag, "3,1"])


def test_routed_serving_example_runs_on_cpu(capsys):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import routed_serving_e2e_torch as ex
    finally:
        sys.path.pop(0)
    out = ex.main(["--device", "cpu", "--rounds", "2", "--batch", "4",
                   "--decode-every", "1", "--finetune-steps", "2"])
    assert out["n_routed"] == 8 and np.isfinite(out["regrets"]).all()
    assert "generated" in capsys.readouterr().out
