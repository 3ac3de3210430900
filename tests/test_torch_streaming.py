"""Streaming serving: the JAX package's ``serving/stream.py``, shard-local
ring and ``RouterService(buckets=...)`` against the port's, on the CPU.

Host layer: arrival specs and times, bucket ladders, batch forming equal to
the reference's from the same seed. Ring: ``enqueue_stream`` /
``resolve_stream`` at 1, 2 and 4 shards (padding, strided tickets,
ownership, duplicates, stale and over-age tickets, overwrite) equal to the
reference's, exactly. Service: ``route_stream`` / ``feedback_stream`` over
mixed batch sizes under ``JaxDraws`` against the reference's bucket
programs: pairs, tickets and folded counts exactly, the posterior and the
ring to 1e-5 (fp32); checkpoints written mid-stream by either package
restore in the other. Port only: padding identity (a batch through a
padded bucket routes bitwise as through a tight one) for every policy of
``launch/serve.py::POLICIES`` and with prefs, a mixed-size sweep with
flat program counts, the delegation of ``route_batch``, the tick's host
mirror, the validation errors, the stream path routing bitwise as a
tick-batch twin, and the draw plan (recorded from one run, filled from a
new key and replayed through ``TapeDraws``: bitwise ``KeyedDraws``
drawing directly) for FGTS, eps-greedy, uniform and the autopilot. On the
CPU every bucket program runs eagerly; the card runs the same bodies as
captured CUDA graphs (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import feedback_queue as jfq
from repro.serving import stream as jstream
from repro_torch.core.draws import (BucketDraws, DrawPlan, KeyedDraws,
                                    PlanRecorder, TapeDraws, TorchDraws)
from repro_torch.data import pool as tpool
from repro_torch.launch import serve as tserve
from repro_torch.models.layers import tree_leaves
from repro_torch.serving import feedback_queue as tfq
from repro_torch.serving import router_service as trs
from repro_torch.serving import stream as tstream

from test_torch_serving import (B, D, GRID, K, KMAX, _close, _entries, _np,
                                _pool_data, _port_dynamic, _services, _votes)

torch.set_num_threads(2)

SPECS = ["poisson:800", "bursty:400,8", "bursty:400", "diurnal:100,0.25,30",
         "diurnal:100"]


# ---------------------------------------------------------------------------
# the host layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_arrivals_match_reference(spec):
    """Same spec fields, and the same arrival times from the same seed."""
    js, ts = jstream.parse_arrival(spec), tstream.parse_arrival(spec)
    assert (ts.kind, ts.rate, ts.burst, ts.depth, ts.period) == \
        (js.kind, js.rate, js.burst, js.depth, js.period)
    for seed in (0, 3):
        np.testing.assert_array_equal(
            tstream.arrival_times(ts, 700, seed=seed),
            jstream.arrival_times(js, 700, seed=seed))


def test_arrival_spec_errors():
    for bad in ("poisson", "poisson:", "poisson:a", "weibull:3",
                "poisson:1,2", "diurnal:100,0.5,60,9", "poisson:-5",
                "diurnal:100,1.5", "bursty:100,0.5"):
        with pytest.raises(ValueError):
            jstream.parse_arrival(bad)
        with pytest.raises(ValueError):
            tstream.parse_arrival(bad)


def test_bucket_ladders():
    assert tstream.validate_buckets([16, 4, 4, 8]) == (4, 8, 16)
    assert tstream.validate_buckets([8, 16], n_shards=4) == (8, 16)
    for bad, shards in (([], 1), ([12], 1), ([0], 1), ([8, 10], 1),
                        ([2, 16], 4)):
        with pytest.raises(ValueError):
            tstream.validate_buckets(bad, n_shards=shards)
    for n, want in ((1, 4), (4, 4), (5, 8), (8, 8)):
        assert tstream.bucket_for(n, (4, 8)) == want == \
            jstream.bucket_for(n, (4, 8))
    with pytest.raises(ValueError, match="largest"):
        tstream.bucket_for(9, (4, 8))


@pytest.mark.parametrize("spec,buckets,max_wait", [
    ("bursty:800,8", (4, 16), 0.01), ("poisson:2000", (8,), 0.002),
    ("diurnal:500,0.5,2", (2, 4, 8), 0.0)])
def test_form_batches_match_reference(spec, buckets, max_wait):
    times = jstream.arrival_times(jstream.parse_arrival(spec), 600, seed=1)
    want = jstream.form_batches(times, buckets, max_wait)
    got = tstream.form_batches(times, buckets, max_wait)
    assert [tuple(f) for f in got] == [tuple(f) for f in want]
    assert got[-1].start + got[-1].n == 600
    with pytest.raises(ValueError, match="max_wait"):
        tstream.form_batches(times, buckets, -1.0)


def test_pad_rows():
    x = np.ones((3, 2), np.float32)
    p = tstream.pad_rows(x, 8)
    assert p.shape == (8, 2) and (p[3:] == 0).all() and (p[:3] == 1).all()
    assert tstream.pad_rows(x, 3) is x
    t = tstream.pad_rows(torch.ones((3,), dtype=torch.int32), 4)
    assert t.dtype == torch.int32 and t.tolist() == [1, 1, 1, 0]
    with pytest.raises(ValueError, match="fit"):
        tstream.pad_rows(x, 2)


# ---------------------------------------------------------------------------
# the shard-local ring
# ---------------------------------------------------------------------------

def test_init_pending_shard_layout():
    q = tfq.init_pending(16, D, device="cpu", shards=2)
    assert tuple(q.next_ticket.shape) == (2,)
    jq = jfq.init_pending(16, D, shards=2)
    for a, b in zip(jax.tree.leaves(jq), tree_leaves(q)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    with pytest.raises(ValueError, match="shards"):
        tfq.init_pending(64, D, device="cpu", shards=3)
    with pytest.raises(ValueError, match="divide"):
        tfq.init_pending(4, D, device="cpu", shards=8)
    with pytest.raises(ValueError, match="power of two"):
        tfq.init_pending(24, D, device="cpu", shards=1)


def _same(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_stream_ring_matches_reference(shards):
    """Each shard's local ring (8 slots) through 4 rounds: a masked issue
    of 6 rows (padding), then a delivery of its own tickets shuffled, a
    duplicate, another shard's tickets, padding rows, a ticket resolved
    already and, in round 3, over-age ones (max_age 1); the ring overwrites
    its oldest duels. Tickets, ring and resolved batches exactly."""
    rng = np.random.default_rng(shards)
    cap = 8
    for shard in range(shards):
        jq = jfq.init_pending(cap, D, shards=1)
        tq = tfq.init_pending(cap, D, device="cpu", shards=1)
        issued = []
        for r in range(4):
            x = rng.standard_normal((6, D)).astype(np.float32)
            a = rng.integers(0, K, (2, 6)).astype(np.int32)
            pref = rng.random(6).astype(np.float32)
            prop = rng.random(6).astype(np.float32)
            cat = rng.integers(-1, 3, 6).astype(np.int32)
            mask = np.arange(6) < 4 + r % 3
            jargs = tuple(map(jnp.asarray, (x, a[0], a[1])))
            targs = tuple(map(torch.from_numpy, (x, a[0], a[1])))
            jq, jt = jfq.enqueue_stream(
                jq, *jargs, jnp.int32(r), jnp.asarray(pref),
                jnp.asarray(mask), shard, shards, prop=jnp.asarray(prop),
                cat=jnp.asarray(cat))
            tq, tt = tfq.enqueue_stream(
                tq, *targs, r, torch.from_numpy(pref),
                torch.from_numpy(mask), shard, shards,
                prop=torch.from_numpy(prop), cat=torch.from_numpy(cat))
            np.testing.assert_array_equal(_np(tt), np.asarray(jt))
            _same(jq, tq)
            live = np.asarray(jt)[mask]
            issued.append(live)
            deliver = np.concatenate([
                rng.permutation(live), live[:1],
                live + 1 if shards > 1 else [live[0] + 100],
                issued[r - 1][:2] if r else [-1], [0, 0]]).astype(np.int32)
            dmask = np.ones(deliver.shape, bool)
            dmask[-2:] = False                     # padding rows
            y = _votes(rng, deliver.shape[0])
            now, age = r + 1, (1 if r == 3 else None)
            jq, jres = jfq.resolve_stream(
                jq, jnp.asarray(deliver), jnp.asarray(y),
                jnp.asarray(dmask), jnp.int32(now), shard, shards,
                max_age=age)
            tq, tres = tfq.resolve_stream(
                tq, torch.from_numpy(deliver), torch.from_numpy(y),
                torch.from_numpy(dmask), now, shard, shards, max_age=age)
            _same(jres, tres)
            _same(jq, tq)


# ---------------------------------------------------------------------------
# the streaming service against the reference
# ---------------------------------------------------------------------------

def _route_stream(js, ts, x, prefs=None):
    ja = js.route_stream(jnp.asarray(x), prefs=None if prefs is None
                         else jnp.asarray(prefs))
    ta = ts.route_stream(torch.from_numpy(x), prefs=None if prefs is None
                         else torch.from_numpy(prefs))
    for a, b in zip(ja, ta):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    return [np.array(a) for a in ja]


def _feed_stream(js, ts, tickets, y):
    nj = js.feedback_stream(jnp.asarray(tickets), jnp.asarray(y))
    nt = ts.feedback_stream(torch.from_numpy(tickets), torch.from_numpy(y))
    assert int(nt) == int(nj)
    return int(nj)


@pytest.mark.parametrize("factory", [None, "eps_greedy"])
def test_stream_service_matches_reference(factory):
    """Formed batches of 3, 8, 5, 1, 8 and 6 rows through buckets (4, 8)
    (prefs on every other batch); each batch delivers the previous one's
    votes shuffled with a duplicate, a ticket resolved already and an
    unknown one. FGTS takes the fused feedback program (and, at batch 2,
    ``feedback_direct`` clearing through the stream ring); eps-greedy the
    resolve program and the compaction fold."""
    kw = dict(cost_tilt=0.2) if factory else {}
    js, ts = _services(k_max=KMAX, factory=factory, buckets=(4, 8), **kw)
    rng = np.random.default_rng(12)
    prev, stale = None, None
    for r, n in enumerate((3, 8, 5, 1, 8, 6)):
        x = rng.standard_normal((n, D)).astype(np.float32)
        p = GRID[(np.arange(n) + r) % 3] if r % 2 else None
        a1, a2, t = _route_stream(js, ts, x, p)
        if prev is not None:
            parts = [rng.permutation(prev)[:5], prev[:1],
                     [100_000] if stale is None else stale]
            tk = np.concatenate(parts)[:8].astype(np.int32)
            _feed_stream(js, ts, tk, _votes(rng, tk.shape[0]))
            stale = tk[:1]
        prev = t
        if factory is None and r == 2:
            y = _votes(rng, n)
            js.feedback_direct(jnp.asarray(x), jnp.asarray(a1),
                               jnp.asarray(a2), jnp.asarray(y),
                               tickets=jnp.asarray(t))
            ts.feedback_direct(torch.from_numpy(x), torch.from_numpy(a1),
                               torch.from_numpy(a2), torch.from_numpy(y),
                               tickets=torch.from_numpy(t))
            prev = None
        assert ts.pending_count() == js.pending_count()
        assert ts.tick == js.tick == int(ts._tick_dev)
        _close(js.state, ts.state)
        _close(js.pending, ts.pending)
    st, sj = ts.service_stats(), js.service_stats()
    np.testing.assert_allclose(st.pop("duel_cost"), sj.pop("duel_cost"),
                               rtol=1e-5)
    assert st == sj
    counts = {k: v for k, v in ts.compiled_program_counts().items()
              if k != "captures"}
    assert counts == {k: v for k, v in js.compiled_program_counts().items()
                      if k.startswith("s_")}


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_stream_checkpoint_restores_across_packages(tmp_path, direction):
    """Mid-stream: two formed batches in flight, one resolved; saved by
    one package, restored by the other (the stream ring's per-shard
    counter, the tick, the key); both then take the late votes and route
    two more batches alike."""
    js, ts = _services(k_max=KMAX, buckets=(8,))
    rng = np.random.default_rng(13)
    xs = [rng.standard_normal((n, D)).astype(np.float32)
          for n in (6, 8, 5, 7)]
    if direction == "reference_to_port":
        src, dst = js, ts
        t0 = np.asarray(src.route_stream(jnp.asarray(xs[0]))[2])
        t1 = np.asarray(src.route_stream(jnp.asarray(xs[1]))[2])
        src.feedback_stream(jnp.asarray(t0), jnp.ones(6))
    else:
        src, dst = ts, js
        t0 = src.route_stream(torch.from_numpy(xs[0]))[2].numpy()
        t1 = src.route_stream(torch.from_numpy(xs[1]))[2].numpy()
        src.feedback_stream(torch.from_numpy(t0), torch.ones(6))
    src.save(str(tmp_path))
    dst.restore(str(tmp_path))
    assert ts.tick == js.tick == int(ts._tick_dev) == 2
    assert ts.pending_count() == js.pending_count() == 8
    _close(js.state, ts.state)
    _close(js.pending, ts.pending)
    assert _feed_stream(js, ts, t1[::-1].copy(),
                        -np.ones(8, np.float32)) == 8
    for x in xs[2:]:
        _route_stream(js, ts, x)
    _close(js.state, ts.state)
    _close(js.pending, ts.pending)


# ---------------------------------------------------------------------------
# the streaming service, port only
# ---------------------------------------------------------------------------

def _stream_svc(buckets, factory=None, draws=None, **kw):
    embs, costs = _pool_data(0, K)
    fcfg = trs.fgts.FGTSConfig(n_models=KMAX, dim=D, horizon=64,
                               sgld_steps=2, sgld_minibatch=4, n_chains=2)
    cfg = trs.RouterServiceConfig(
        fgts=fcfg, k_max=KMAX, feedback_capacity=64, buckets=buckets,
        policy_factory=None if factory is None
        else tserve.POLICIES[factory], seed=5, **kw)
    return trs.RouterService(_entries(tpool.PoolEntry, embs, costs), None,
                             None, cfg, device="cpu", draws=draws)


def _same_service(a, b):
    for u, v in zip(tree_leaves((a.state, a.pending)),
                    tree_leaves((b.state, b.pending))):
        assert torch.equal(u, v)


@pytest.mark.parametrize("policy", sorted(tserve.POLICIES))
def test_bucket_padding_identity_every_policy(policy):
    """8 rows through a bucket of 8 and through one of 16 (8 rows of
    padding): pairs, tickets, folded counts, posterior and ring bitwise
    equal, for every policy the serving launcher hosts (masked folds and the
    compaction fallback)."""
    kw = dict(cost_tilt=0.2) if policy != "fgts" else {}
    svc_a = _stream_svc((8,), policy, **kw)
    svc_b = _stream_svc((16,), policy, **kw)
    rng = np.random.default_rng(14)
    for r in range(3):
        x = torch.from_numpy(rng.standard_normal((8, D)).astype(np.float32))
        out_a, out_b = svc_a.route_stream(x), svc_b.route_stream(x)
        for u, v in zip(out_a, out_b):
            assert torch.equal(u, v)
        y = torch.from_numpy(_votes(rng, 8))
        assert int(svc_a.feedback_stream(out_a[2], y)) == \
            int(svc_b.feedback_stream(out_b[2], y)) == 8
    _same_service(svc_a, svc_b)
    assert svc_a.pending_count() == svc_b.pending_count() == 0


def test_bucket_padding_identity_with_prefs_and_refresh():
    """The pref route and the duel-log fold: bucket 8 against 16 with
    per-request prefs and categories, bitwise (the duel logs too)."""
    from repro_torch.refresh import RefreshConfig
    rc = RefreshConfig(capacity=32, n_categories=3)
    svc_a, svc_b = (_stream_svc(b, refresh=rc) for b in ((8,), (16,)))
    rng = np.random.default_rng(15)
    for r in range(2):
        x = torch.from_numpy(rng.standard_normal((6, D)).astype(np.float32))
        p = torch.from_numpy(GRID[(np.arange(6) + r) % 3])
        c = torch.arange(6) % 3
        out_a = svc_a.route_stream(x, prefs=p, cats=c)
        out_b = svc_b.route_stream(x, prefs=p, cats=c)
        for u, v in zip(out_a, out_b):
            assert torch.equal(u, v)
        y = torch.from_numpy(_votes(rng, 6))
        svc_a.feedback_stream(out_a[2], y)
        svc_b.feedback_stream(out_b[2], y)
    _same_service(svc_a, svc_b)
    for u, v in zip(svc_a.duel_log, svc_b.duel_log):
        assert torch.equal(u, v)


def test_stream_mixed_sizes_keep_program_counts_flat():
    """Every n from 1 to the ladder top (prefs on and off, feedback after
    each) reuses the bucket programs; so do add_model, retire_model,
    apply_table, seed_replay, expire_pending and restore, which write the
    live tensors in place (the state's tensors keep their addresses)."""
    svc = _stream_svc((4, 16), feedback_expiry=4)
    counts = svc.compiled_program_counts()
    assert counts["s_route"] == counts["s_resolve"] == 2
    ptrs = [t.data_ptr() for t in tree_leaves((svc.state, svc.pending))]
    rng = np.random.default_rng(16)
    for i, n in enumerate([1, 3, 4, 5, 11, 16, 2, 7, 13]):
        x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
        prefs = None if i % 2 else torch.rand(n)
        a1, a2, t = svc.route_stream(x, prefs=prefs)
        assert a1.shape == a2.shape == t.shape == (n,)
        assert int(svc.feedback_stream(t, torch.ones(n))) == n
        if i == 4:
            new = _entries(tpool.PoolEntry, *_pool_data(9, 1), ["new"])[0]
            svc.add_model(new)
            svc.retire_model(0)
            svc.apply_table(torch.randn(KMAX, D))
            svc.seed_replay(x, a1, a2, torch.ones(n))
            svc.expire_pending()
    assert svc.n_routed == 62 and svc.pending_count() == 0
    assert svc.compiled_program_counts() == counts
    assert ptrs == [t.data_ptr()
                    for t in tree_leaves((svc.state, svc.pending))]


def test_route_batch_delegates_and_tick_is_mirrored():
    svc = _stream_svc((8,))
    x = torch.randn(5, D)
    for _ in range(3):
        a1, a2, t = svc.route_batch(x)
        assert t.shape == (5,)
        assert int(svc.feedback_batch(t, torch.ones(5))) == 5
    assert svc.pending_count() == 0
    assert svc.tick == int(svc._tick_dev) == 3


def test_feedback_direct_clears_the_stream_ring():
    svc = _stream_svc((8,))
    x = torch.randn(4, D)
    a1, a2, t = svc.route_stream(x)
    assert svc.pending_count() == 4
    svc.feedback_direct(x, a1, a2, torch.ones(4), tickets=t)
    assert svc.pending_count() == 0


def test_streaming_validation_errors():
    svc = _stream_svc((8,))
    x = torch.randn(9, D)
    with pytest.raises(ValueError, match="largest"):
        svc.route_stream(x)
    with pytest.raises(ValueError, match="prefs shape"):
        svc.route_stream(x[:4], prefs=torch.zeros(3))
    with pytest.raises(ValueError, match="tickets shape"):
        svc.feedback_stream(torch.zeros(4, dtype=torch.int32),
                            torch.zeros(3))
    plain = _port_dynamic(K, KMAX)
    with pytest.raises(RuntimeError, match="buckets"):
        plain.route_stream(x[:4])
    with pytest.raises(RuntimeError, match="buckets"):
        plain.feedback_stream(torch.zeros(4, dtype=torch.int32),
                              torch.zeros(4))
    assert plain.compiled_program_counts() == {}
    with pytest.raises(ValueError, match="powers of two"):
        _stream_svc((6,))
    from repro_torch.core.policy import fgts_policy
    nocost = trs.RouterService(
        _entries(tpool.PoolEntry, *_pool_data(0, K)), None, None,
        trs.RouterServiceConfig(
            fgts=trs.fgts.FGTSConfig(n_models=K, dim=D, horizon=8,
                                     sgld_steps=1, sgld_minibatch=2),
            policy_factory=lambda arms, costs, cfg: fgts_policy(arms,
                                                                cfg.fgts),
            buckets=(8,)), device="cpu")
    assert "s_route_pref" not in nocost.compiled_program_counts()
    with pytest.raises(ValueError, match="no act_pref path"):
        nocost.route_stream(x[:4], prefs=torch.zeros(4))


@pytest.mark.parametrize("refresh", [False, True])
def test_stream_routes_as_the_tick_batch_twin(refresh):
    """Under the same ``KeyedDraws`` the streaming service routes formed
    batches bitwise as a tick-batch twin's ``route_batch`` routes them
    unpadded (the card runs the same comparison through the graphs)."""
    from repro_torch.refresh import RefreshConfig
    kw = dict(refresh=RefreshConfig(capacity=32, n_categories=3)) \
        if refresh else {}
    svc, twin = _stream_svc((4, 8), **kw), _stream_svc(None, **kw)
    rng = np.random.default_rng(17)
    prev = None
    for r, n in enumerate((8, 3, 5, 8, 1)):
        x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
        p = torch.from_numpy(GRID[(np.arange(n) + r) % 3])
        c = torch.arange(n) % 3
        out = svc.route_batch(x, prefs=p, cats=c)
        want = twin.route_batch(x, prefs=p, cats=c)
        for u, v in zip(out, want):
            assert torch.equal(u, v)
        if prev is not None:
            y = torch.from_numpy(_votes(rng, prev.shape[0]))
            assert int(svc.feedback_batch(prev, y)) == \
                int(twin.feedback_batch(prev, y))
        prev = out[2]
    for u, v in zip(tree_leaves(svc.state), tree_leaves(twin.state)):
        assert torch.equal(u, v)
    if refresh:
        a, b = svc.export_log(), twin.export_log()
        for f in ("x", "a1", "a2", "y", "pref", "prop", "cat", "issued_at"):
            np.testing.assert_array_equal(a[f], b[f])


# ---------------------------------------------------------------------------
# the draw plan
# ---------------------------------------------------------------------------

def _plan_svc(policy):
    from repro_torch.autopilot import AutopilotConfig
    if policy == "autopilot":
        return _stream_svc((4, 8), autopilot=AutopilotConfig(
            every=1, quota=0.5, budget=0.3))
    return _stream_svc((4, 8), None if policy == "fgts" else policy,
                       cost_tilt=0.0 if policy == "fgts" else 0.2)


@pytest.mark.parametrize("policy", ["fgts", "eps_greedy", "uniform",
                                    "autopilot"])
def test_draw_plan_replays_keyed_draws_bitwise(policy):
    """The route programs' draw plan, recorded from one run under a
    throwaway key, filled from a new key and replayed through
    ``TapeDraws`` (as a captured graph replays it): outputs and every live
    tensor bitwise those of ``KeyedDraws`` drawing directly, at the low
    bucket (per-row draws made at the top bucket and cut) and the top
    one, with and without prefs."""
    svc = _plan_svc(policy)
    x = torch.randn(3, D)
    svc.route_stream(x)                     # a non-empty ring to sample
    svc.feedback_stream(torch.arange(3, dtype=torch.int32), torch.ones(3))
    for progs in (svc._s_route, svc._s_route_pref):
        assert progs is not None
        for b, prog in progs.items():
            svc._stage(b, 3, x=x, pref=torch.rand(3))
            live = svc._live_leaves()
            before = [t.clone() for t in live]

            def run(draws):
                for t, v in zip(live, before):
                    t.copy_(v)
                out = prog.body(BucketDraws(draws, b, 8))
                return [t.clone() for t in list(out) + live]
            rec = PlanRecorder(KeyedDraws(99))
            run(rec)
            assert rec.plan.entries
            key = KeyedDraws(7).split(3)[2]
            bufs = rec.plan.buffers("cpu")
            rec.plan.fill(key, bufs)
            tape = TapeDraws(rec.plan, bufs)
            replayed = run(tape)
            assert tape.pos == len(bufs)
            direct = run(key)
            for u, v in zip(replayed, direct):
                assert torch.equal(u, v)


def test_draw_plan_refuses_what_it_cannot_replay():
    plan = DrawPlan()
    rec = PlanRecorder(KeyedDraws(1), plan)
    rec.split(2)[1].uniform((3,), "cpu")
    bufs = plan.buffers("cpu")
    with pytest.raises(TypeError, match="KeyedDraws"):
        plan.fill(TorchDraws(0, "cpu"), bufs)
    plan.fill(KeyedDraws(2), bufs)
    tape = TapeDraws(plan, bufs)
    with pytest.raises(RuntimeError, match="recorded"):
        tape.normal((3,), "cpu")
    tape.uniform((3,), "cpu")
    with pytest.raises(RuntimeError, match="exhausted"):
        tape.uniform((3,), "cpu")


def test_bucket_draws_widen_per_row_draws_only():
    """A per-row draw at 3 rows of a ladder topped at 8 is the first 3 rows
    of the 8-row draw; SGLD draws pass through untouched."""
    k = KeyedDraws(4)
    w = BucketDraws(k, 3, 8)
    assert torch.equal(w.gumbel((3, 5), "cpu"), k.gumbel((8, 5), "cpu")[:3])
    assert torch.equal(w.uniform((3,), "cpu"), k.uniform((8,), "cpu")[:3])
    assert torch.equal(w.distinct_pair(3, 5, "cpu"),
                       k.distinct_pair(8, 5, "cpu")[:3])
    assert torch.equal(w.normal((2, 5), "cpu"), k.normal((2, 5), "cpu"))
    hi = torch.tensor(6)
    ws, ks = w.sgld(3, 2).step(1, 4, hi, 5, "cpu"), \
        k.sgld(3, 2).step(1, 4, hi, 5, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(ws, ks))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--arrival", "poisson:2000", "--buckets", "4,8"],
    ["--arrival", "bursty:2000,4", "--buckets", "2,4,8", "--max-wait",
     "0.001", "--policy", "eps_greedy"],
    ["--arrival", "diurnal:3000", "--pref-dist", "grid:0,0.5,2"],
])
def test_serve_launcher_streams_on_cpu(argv, capsys):
    out = tserve.main(["--device", "cpu", "--rounds", "2", "--batch", "8"]
                      + argv)
    assert out["stats"]["n_routed"] == 16 and out["stats"]["pending"] == 0
    assert np.isfinite(out["regrets"]).all()
    assert out["p99_s"] >= out["p50_s"] > 0 and out["qps"] > 0
    assert "[serve] streaming done: qps=" in capsys.readouterr().out


@pytest.mark.parametrize("bad", [["--autopilot"], ["--feedback-delay", "1"],
                                 ["--buckets", "6"]])
def test_serve_launcher_refuses_bad_stream_flags(bad):
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--arrival", "poisson:100"] + bad)
