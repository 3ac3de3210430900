"""The mesh paths of the routing service: ``RouterService(mesh=...)`` on
gloo worlds of spawned CPU ranks, held against the reference's unsharded
``RouterService`` and the port's on the same numpy inputs and draws.

The port's unsharded run draws through a ``Recorder`` around ``JaxDraws``
(the reference's key tree) and each rank replays that tape
(``torch_mesh_cases.py``, which the ranks import without JAX). Contracts:
pairs and tickets exactly, the policy state to 1e-5 (1e-4 after the
16-round lagged loop) against the reference and bitwise against the
port's unsharded service, the same on every rank; duplicate and stale
tickets; a batch that does not divide over the shards; a factory policy's
per-row draws (shards differ, (1,1) equals (4,1)) and its compaction fold;
a checkpoint across the sharded/unsharded boundary both ways; streaming
(strided tickets, padding identity, flat program counts); the refresh and
autopilot lanes (the autopilot streaming too); ``use_kernel=False``;
``routing_rules`` as pure functions and the router dry-run's reckoning (a
fake world, in this process). Four gloo worlds are spawned in all, each
joined with a time limit.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import autopilot as jap
from repro.core import fgts as jfgts
from repro.data import pool as jpool
from repro.launch import serve as jserve
from repro.refresh import trainer as jref
from repro.serving import router_service as jrs
from repro.sharding import routing_rules as jrr
from repro_torch.core.draws import KeyedDraws, ShardDraws
from repro_torch.encoder import EncoderConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import router_dryrun
from repro_torch.serving import feedback_queue as tfq
from repro_torch.sharding import routing_rules as rr

import torch_mesh_cases as C
from test_torch_env import JaxDraws

torch.set_num_threads(2)
WORLD_TIMEOUT = 90.0


def jax_backend():
    def entry(name, emb, cost):
        return jpool.PoolEntry(name=name, arch="granite-3-2b",
                               cost_per_1k_tokens=float(cost), embedding=emb)
    return C.Backend(arr=jnp.asarray, leaves=jax.tree.leaves, entry=entry)


def ref_service(kind, **over):
    """The reference's unsharded service of ``kind``; its XLA scoring and
    SGLD paths (the math of its kernels, fast under tests)."""
    kw = dict(C.KINDS[kind], **over)
    factory = kw.pop("factory", None)
    auto = kw.pop("autopilot", False)
    refresh = kw.pop("refresh", False)
    kw["use_kernel"] = False
    n = C.K if kw.get("k_max") is None else kw["k_max"]
    embs, costs = C.pool_data()
    cfg = jrs.RouterServiceConfig(
        fgts=jfgts.FGTSConfig(n_models=n, sgld_backend="xla", **C.FKW),
        seed=C.SEED,
        policy_factory=None if factory is None else jserve.POLICIES[factory],
        autopilot=jap.AutopilotConfig(**C.AP) if auto else None,
        refresh=jref.RefreshConfig(every=0, capacity=32, n_categories=C.M)
        if refresh else None, **kw)
    bk = jax_backend()
    svc = jrs.RouterService([bk.entry(f"m{i}", embs[i], costs[i])
                             for i in range(C.K)], None, None, cfg)
    if auto and cfg.buckets is not None:
        # the controller's initial ``known`` is the pool's ``active``
        # array, which the streaming route donates twice: the same
        # values in buffers of their own
        svc.state = jax.tree.map(jnp.copy, svc.state)
    return svc


def port_recorded(kind):
    """The port's unsharded service of ``kind`` under the reference's key
    tree, recording its draws: (service, tape)."""
    rec = C.Recorder(JaxDraws(jax.random.PRNGKey(C.SEED)))
    return C.port_service(kind, None, rec), rec.tape


def spawn(shape, jobs, tmp):
    return mesh_lib.spawn_world(C.run_on_mesh, shape[0] * shape[1],
                                (shape, jobs), timeout=WORLD_TIMEOUT,
                                rdv_dir=str(tmp))


def same(a, b):
    """Nested outputs bitwise equal."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            same(u, v)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def close(ref, got, tol):
    """State leaves: floats to ``tol``, the rest exactly."""
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        a = np.asarray(a)
        assert a.shape == b.shape
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype))


def _all_ranks_agree(outs, name):
    for o in outs[1:]:
        same(outs[0][name], o[name])
    return outs[0][name]


def _run(kind, scen, *args, **ref_over):
    """(reference outputs, port outputs, port tape) of one scenario."""
    js, (ts, tape) = ref_service(kind, **ref_over), port_recorded(kind)
    return (C.SCENARIOS[scen](js, jax_backend(), *args),
            C.SCENARIOS[scen](ts, C.torch_backend(), *args), tape)


# ---------------------------------------------------------------------------
# world (2, 1): the tick-batch service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tick_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh21")
    out = {"tick": _run("tick", "tick")}
    # a checkpoint of the reference with one batch in flight
    js = ref_service("tick")
    rng = np.random.default_rng(13)
    js.route_batch(jnp.asarray(C.queries(rng, 32)))
    ck_in, ck_out = str(tmp / "ref_ckpt"), str(tmp / "mesh_ckpt")
    js.save(ck_in)
    ts, tape = port_recorded("tick")
    port_out = C.scenario_restore(ts, C.torch_backend(), ck_in,
                                  str(tmp / "port_ckpt"))
    out["restore"] = (None, port_out, tape)
    # the plain selection draws as the kernel path does: the tick tape
    jobs = [(name, kind, scen, out[tape][2], args, {})
            for name, kind, scen, tape, args in (
                ("tick", "tick", "tick", "tick", ()),
                ("plain", "tick", "tick", "tick", ()),
                ("restore", "tick", "restore", "restore",
                 (ck_in, ck_out)))]
    jobs[1] = jobs[1][:5] + (dict(use_kernel=False),)
    jobs.append(("indivisible", "tick", "indivisible", None, (), {}))
    jobs.append(("collectives", "tick", "collectives", None, (), {}))
    return out, spawn((2, 1), jobs, tmp), ck_out


def test_route_and_feedback_match_reference_on_mesh(tick_world):
    """16 rounds of 32 queries, votes lagged a round, prefs on odd
    rounds, expiry after 6 ticks: pairs, tickets and folded counts of the
    (2, 1) mesh equal the reference's; the state within 1e-4 of it and
    bitwise the port's unsharded one, on both ranks."""
    out, ranks, _ = tick_world
    ref, port, _ = out["tick"]
    got = _all_ranks_agree(ranks, "tick")
    same([p.astype(np.int32) for p in port["pairs"]], got["pairs"])
    for a, b in zip(ref["pairs"], got["pairs"]):
        np.testing.assert_array_equal(b, a)
    assert got["n_ok"] == ref["n_ok"] == [32] * 15
    assert got["expired"] == ref["expired"]
    close(ref["state"], got["state"], 1e-4)
    same(port["state"], got["state"])
    assert got["pending"] == ref["pending"] == 32
    assert got["stats"][:2] == ref["stats"][:2]
    assert got["stats"][3] == ref["stats"][3]
    np.testing.assert_allclose(got["stats"][2], ref["stats"][2], rtol=1e-5)


def test_duplicate_and_stale_tickets_fold_once_on_mesh(tick_world):
    """A duplicated ticket inside one sharded resolve folds once (16 of
    32), and a stale half of the next batch folds nothing (16 of 32):
    state within 1e-5 of the reference."""
    out, ranks, _ = tick_world
    ref, port, _ = out["tick"]
    got = _all_ranks_agree(ranks, "tick")
    assert (got["dup"], got["mixed"]) == (ref["dup"], ref["mixed"]) == \
        (16, 16)
    close(ref["state_dup"], got["state_dup"], 1e-5)
    same(port["state_dup"], got["state_dup"])


def test_use_kernel_false_serves_on_mesh(tick_world):
    """``RouterServiceConfig(use_kernel=False)``: the plain selection on
    every rank, the same pairs and state as the reference."""
    out, ranks, _ = tick_world
    ref, port, _ = out["tick"]
    got = _all_ranks_agree(ranks, "plain")
    for a, b in zip(ref["pairs"], got["pairs"]):
        np.testing.assert_array_equal(b, a)
    close(ref["state"], got["state"], 1e-4)
    same(port["state"], got["state"])


def test_tick_batch_collectives(tick_world):
    """One all-gather of the routed pairs (2 words a row) a route, one
    all-reduce of the resolved batch (d + 7 words a row) a feedback."""
    _, ranks, _ = tick_world
    got = _all_ranks_agree(ranks, "collectives")
    assert got["route"] == {"all_gather": {"bytes": 16 * 2 * 4, "count": 1}}
    assert got["feedback"] == {
        "all_reduce": {"bytes": 16 * (C.D + 7) * 4, "count": 1}}


def test_indivisible_batch_is_refused_on_mesh(tick_world):
    _, ranks, _ = tick_world
    msg = _all_ranks_agree(ranks, "indivisible")
    assert msg is not None and "divide" in msg


def test_checkpoint_crosses_the_mesh_boundary(tick_world):
    """The reference's unsharded checkpoint restores onto the mesh (its
    in-flight batch resolves there); the mesh's checkpoint restores into
    the reference's and the port's unsharded services, which route the
    next batch alike."""
    out, ranks, ck_out = tick_world
    _, port, _ = out["restore"]
    got = _all_ranks_agree(ranks, "restore")
    assert got["pending0"] == 32 and got["n_ok"] == 32
    same(port["pairs"], got["pairs"])
    same(port["state"], got["state"])
    js = ref_service("tick")
    step = js.restore(ck_out)
    ts = C.port_service("tick", None, JaxDraws(jax.random.PRNGKey(0)))
    assert ts.restore(ck_out) == step
    close(jax.tree.leaves(js.state), got["state"], 1e-5)
    assert js.pending_count() == ts.pending_count() == 32
    x = C.queries(np.random.default_rng(99), 32)
    a = js.route_batch(jnp.asarray(x))
    b = ts.route_batch(torch.from_numpy(x))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(v.numpy(), np.asarray(u))


# ---------------------------------------------------------------------------
# worlds (4, 1) and (1, 1): a factory policy with per-row draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uniform_worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh41")
    ref, port, tape = _run("uniform", "uniform")
    job = [("uniform", "uniform", "uniform", tape, (), {})]
    return (ref, port, _all_ranks_agree(spawn((4, 1), job, tmp), "uniform"),
            _all_ranks_agree(spawn((1, 1), job, tmp), "uniform"))


def test_factory_policy_draws_are_the_unsharded_stream(uniform_worlds):
    """Per-row draws are made for the whole batch and cut to each rank's
    rows: the (4, 1) mesh equals the (1, 1) mesh and the reference's
    unsharded service, and the four shards' rows differ."""
    ref, port, m41, m11 = uniform_worlds
    same(m11["pairs"], m41["pairs"])
    same(port["pairs"], m41["pairs"])
    for a, b in zip(ref["pairs"], m41["pairs"]):
        np.testing.assert_array_equal(b, a)
    pairs = m41["pairs"][0][:2].T
    assert not all(np.array_equal(pairs[:8], pairs[8 * i:8 * (i + 1)])
                   for i in range(1, 4))


def test_compaction_fold_on_mesh(uniform_worlds):
    """13 survivors of 32 (no masked fold): the compaction fallback on
    the mesh folds 13, as the reference does."""
    ref, _, m41, m11 = uniform_worlds
    assert m41["n_ok"] == m11["n_ok"] == ref["n_ok"] == 13
    assert m41["pending"] == ref["pending"]
    close(ref["state"], m41["state"], 1e-5)


# ---------------------------------------------------------------------------
# world (2, 2): streaming, the refresh lane, the autopilot lane
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh22")
    # the reference streams on the top bucket alone: padding changes no
    # pair and no fold, and it compiles half the programs
    out = {k: _run(k, k, **({"buckets": (16,)} if k == "stream" else {}))
           for k in ("stream", "refresh", "autopilot")}
    out["stream_autopilot"] = _run("stream_autopilot", "autopilot")
    jobs = [(k, k, "autopilot" if k == "stream_autopilot" else k,
             out[k][2], (), {}) for k in out]
    jobs.append(("collectives", "stream", "collectives", None, (), {}))
    jobs.append(("ap_collectives", "stream_autopilot", "collectives", None,
                 (8,), {}))
    for name, factory, buckets in (("pad8", None, (8,)),
                                   ("pad16", None, (16,)),
                                   ("upad8", "uniform", (8,)),
                                   ("upad16", "uniform", (16,))):
        jobs.append((name, "stream", "pad", None, (),
                     dict(buckets=buckets, factory=factory)))
    return out, spawn((2, 2), jobs, tmp)


def test_stream_on_mesh_matches_reference(grid_world):
    """Mixed batch sizes on buckets (8, 16), prefs on odd batches: pairs
    and folded counts equal the reference's unsharded streaming service
    (on its top bucket, 16),
    the state within 1e-5 of it and bitwise the port's; tickets are
    strided by the issuing shard (ticket % 2 is the shard of the row's
    position in its bucket)."""
    out, ranks = grid_world
    ref, port, _ = out["stream"]
    got = _all_ranks_agree(ranks, "stream")
    for a, b in zip(ref["pairs"], got["pairs"]):
        np.testing.assert_array_equal(b, a)
    assert got["n_ok"] == ref["n_ok"]
    close(ref["state"], got["state"], 1e-5)
    same(port["state"], got["state"])
    assert got["pending"] == 0
    for t in got["tickets"]:
        b = 8 if t.shape[0] <= 8 else 16
        np.testing.assert_array_equal(t % 2, np.arange(t.shape[0]) // (b // 2))


def test_stream_padding_identity_and_flat_counts_on_mesh(grid_world):
    """A (16,) ladder routes 8-row batches as an (8,) ladder does, pairs
    and state bitwise, for FGTS (prefs after the first batch) and for the
    uniform factory (per-row draws); the program counts stay flat at one
    per bucket and surface."""
    _, ranks = grid_world
    for a, b in (("pad8", "pad16"), ("upad8", "upad16")):
        x, y = _all_ranks_agree(ranks, a), _all_ranks_agree(ranks, b)
        same(x["pairs"], y["pairs"])
        same(x["state"], y["state"])
        assert x["pending"] == y["pending"] == 0
    got = _all_ranks_agree(ranks, "stream")
    before, after = got["programs"]
    assert before == after == {"s_route": 2, "s_route_pref": 2,
                               "s_feedback": 2, "s_resolve": 2,
                               "captures": 0}


def _no_collective_in_route_program(ranks, name, bucket):
    got = _all_ranks_agree(ranks, name)
    assert got["route_program"] == {}
    assert got["route"] == {
        "all_gather": {"bytes": bucket * 3 * 4, "count": 1}}
    assert got["feedback"] == {
        "all_gather": {"bytes": bucket * (C.D + 8) * 4, "count": 1}}


def test_stream_route_program_holds_no_collective(grid_world):
    """The streaming route program calls no collective (its enqueue is
    shard-local); ``route_stream`` gathers the pairs and tickets after it
    (3 words a row of the bucket) and ``feedback_stream`` the shard-local
    resolved rows (d + 8 words a row) between its two programs."""
    _no_collective_in_route_program(grid_world[1], "collectives", 16)


def test_stream_autopilot_route_program_holds_no_collective(grid_world):
    """Under the autopilot too: its realized-cost EMA is folded after the
    route's gather, outside the program."""
    _no_collective_in_route_program(grid_world[1], "ap_collectives", 8)


def test_refresh_lane_on_mesh_matches_reference(grid_world):
    """Refresh logging on the mesh: the replicated duel log exports the
    reference's duels (propensities to 1e-5); a table swap, a hot add and
    a retirement are replicated data updates."""
    out, ranks = grid_world
    ref, port, _ = out["refresh"]
    got = _all_ranks_agree(ranks, "refresh")
    for a, b in zip(ref["pairs"], got["pairs"]):
        np.testing.assert_array_equal(b, a)
    assert got["slot"] == ref["slot"] and got["count"] == ref["count"]
    for k, v in ref["log"].items():
        if k == "prop" or v.dtype.kind == "f":
            np.testing.assert_allclose(got["log"][k], v, rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got["log"][k], v)
    close(ref["state"], got["state"], 1e-5)
    same(port["state"], got["state"])
    assert got["stats"] == ref["stats"]


def _autopilot_matches(out, ranks, kind):
    ref, port, _ = out[kind]
    got = _all_ranks_agree(ranks, kind)
    for a, b in zip(ref["pairs"], got["pairs"]):
        np.testing.assert_array_equal(b[:2], a[:2])
        if kind == "autopilot":
            np.testing.assert_array_equal(b[2], a[2])
        else:
            np.testing.assert_array_equal(b[2] % 2, np.arange(8) // 4)
    for sr, sg in zip(ref["status"], got["status"]):
        for k in sr:
            if k in ("lambda", "cost_ema"):
                np.testing.assert_allclose(sg[k], sr[k], rtol=1e-5)
            else:
                np.testing.assert_array_equal(sg[k], sr[k])
    close(ref["state"], got["state"], 1e-5)
    same(port["state"], got["state"])


def test_autopilot_lane_on_mesh_matches_reference(grid_world):
    """The autopilot on the mesh: the quota gate's per-row draws cut from
    the whole batch's, the realized-cost EMA over the whole batch's pairs
    (folded after their gather): pairs, tickets and every controller
    field as the reference's, round by round."""
    _autopilot_matches(*grid_world, "autopilot")


def test_stream_autopilot_lane_on_mesh_matches_reference(grid_world):
    """The same through the streaming service's bucket programs: pairs
    and controller as the reference's unsharded streaming service;
    tickets strided by the issuing shard (4 rows a shard)."""
    _autopilot_matches(*grid_world, "stream_autopilot")


# ---------------------------------------------------------------------------
# routing_rules, ShardDraws and the dry-run
# ---------------------------------------------------------------------------

def _stub_mesh(shape, names, local=None):
    local = local or {}
    return types.SimpleNamespace(
        mesh_dim_names=names, mesh=torch.zeros(shape),
        get_local_rank=lambda a: local.get(a, 0))


def _norm(spec):
    """A spec's entries as tuples of axis names (or None): JAX writes a
    single axis as its name."""
    return tuple(e if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


def _jax_stub(shape, names):
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


@pytest.mark.parametrize("shape,names", [
    ((2, 1), ("data", "model")), ((4, 2), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")), ((3, 2), ("data", "model"))])
def test_routing_rules_match_reference(shape, names):
    """Batch axes, shard counts, ``round_capacity`` (the power-of-two
    rule) and every spec tree's partitioned fields as the reference's."""
    m, jm = _stub_mesh(shape, names), _jax_stub(shape, names)
    assert rr.batch_axes(m) == jrr.batch_axes(jm)
    assert rr.n_batch_shards(m) == jrr.n_batch_shards(jm)
    for cap in (1, 5, 64, 1000):
        try:
            want = jrr.round_capacity(cap, jm)
        except ValueError:
            with pytest.raises(ValueError, match="power-of-two"):
                rr.round_capacity(cap, m)
            continue
        assert rr.round_capacity(cap, m) == want
    bx = rr.batch_axes(m)
    for ours, theirs in ((rr.pending_specs, jrr.pending_specs),
                         (rr.stream_pending_specs, jrr.stream_pending_specs),
                         (rr.resolved_specs, jrr.resolved_specs)):
        a, b = ours(m), theirs(jm)
        assert a._fields == b._fields
        for u, v in zip(a, b):
            assert _norm(u) == _norm(v)
    assert all(tuple(p) == () for p in rr.duel_log_specs(m))
    assert rr.query_batch_spec(m) == (bx, None)
    assert _norm(rr.route_step_specs(m)[0]) == \
        _norm(jrr.route_step_specs(jm)[0])


def test_shard_index_and_local_shapes():
    m = _stub_mesh((2, 4, 2), ("pod", "data", "model"),
                   dict(pod=1, data=2, model=1))
    assert rr.shard_index(m) == 6
    assert rr.local_shape(rr.query_batch_spec(m), (64, 7), m) == (8, 7)
    assert rr.local_shape(rr.pending_specs(m).next_ticket, (), m) == ()
    with pytest.raises(ValueError, match="divide"):
        rr.local_shape(rr.per_query_spec(m), (12,), m)


def test_pack_rows_round_trips_bitwise():
    x = torch.tensor([[0.0, -0.0], [float("nan"), -1.5]])
    cols = [x, torch.tensor([3, -7], dtype=torch.int32),
            torch.tensor([True, False]), torch.tensor([1.25, -0.0])]
    packed = rr.pack_rows(cols)
    assert packed.dtype == torch.int32 and packed.shape == (2, 5)
    for a, b in zip(rr.unpack_rows(packed, cols), cols):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)
    # a share's rows plus zeros elsewhere sum to the share's rows, bitwise
    assert torch.equal(packed + torch.zeros_like(packed), packed)


def test_ring_shares_resolve_as_the_whole_ring():
    """Four shares of a 16-slot ring, enqueued and resolved with
    ``share=``, give by a word sum the whole ring's resolved batch
    (duplicates first-wins, stale rows), and their slots the whole
    ring's."""
    d, cap, s = 3, 16, 4
    rng = np.random.default_rng(0)
    whole = tfq.init_pending(cap, d, device="cpu")
    shares = [tfq.init_pending(cap // s, d, device="cpu") for _ in range(s)]
    for n in (10, 12, 20):
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
        a = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))
        whole, tw = tfq.enqueue(whole, x, a, a, 3)
        for i in range(s):
            shares[i], ti = tfq.enqueue(shares[i], x, a, a, 3,
                                        share=(i * cap // s, cap))
            assert torch.equal(ti, tw)
    for i in range(s):
        for f in ("x", "a1", "ticket", "valid"):
            assert torch.equal(getattr(shares[i], f),
                               getattr(whole, f)[i * 4:(i + 1) * 4])
    tk = torch.tensor([40, 41, 41, 3, 30, 35, 39, 40], dtype=torch.int32)
    y = torch.ones(8)
    whole, rw = tfq.resolve(whole, tk, y, 5)
    parts = []
    for i in range(s):
        shares[i], ri = tfq.resolve(shares[i], tk, y, 5,
                                    share=(i * cap // s, cap))
        parts.append(rr.pack_rows([ri.x, ri.a1, ri.age, ri.ok]))
    got = rr.unpack_rows(sum(parts), [rw.x, rw.a1, rw.age, rw.ok])
    for a, b in zip(got, [rw.x, rw.a1, rw.age, rw.ok]):
        assert torch.equal(a, b)
    assert rw.ok.tolist() == [True, True, False, False, True, True, True,
                              False]


def test_shard_draws_cut_the_whole_batch():
    src = KeyedDraws(3)
    whole = src.uniform((8, 2), "cpu")
    for r in range(4):
        d = ShardDraws(src, 2, 8, 2 * r)
        assert torch.equal(d.uniform((2, 2), "cpu"), whole[2 * r:2 * r + 2])
        assert torch.equal(d.normal((5,), "cpu"), src.normal((5,), "cpu"))
        assert torch.equal(d.distinct_pair(2, 4, "cpu"),
                           src.distinct_pair(8, 4, "cpu")[2 * r:2 * r + 2])


def test_router_dryrun_reckons_both_meshes():
    """The dry-run on fake worlds of 256 and 512 ranks at a global batch
    of 8192 (a 2-layer encoder): each rank's rows, the pairs' all-gather
    and the resolved batch's all-reduce by their shapes, the replicated
    refresh's FLOPs alike on both meshes, the encoder's halved with the
    rows."""
    enc_cfg = EncoderConfig(vocab_size=512, d_model=64, n_layers=2,
                            n_heads=4, d_ff=128, max_len=16)
    recs = {(r["step"], r["mesh"]): r for r in
            router_dryrun.reckon(8192, horizon=4096, enc_cfg=enc_cfg)}
    dim = router_dryrun.DIM
    for mesh, rows in (("16x16", 512), ("2x16x16", 256)):
        assert all(recs[(s, mesh)]["rows"] == rows for s in
                   ("route_step", "update_step", "resolve_step",
                    "encode_route_step"))
        assert recs[("route_step", mesh)]["collectives"] == {
            "all_gather": {"bytes": 8192 * 2 * 4, "count": 1}}
        assert recs[("resolve_step", mesh)]["collectives"] == {
            "all_reduce": {"bytes": 8192 * (dim + 7) * 4, "count": 1}}
        assert recs[("update_step", mesh)]["collective_bytes"] == 0
    assert recs[("update_step", "16x16")]["flops"] == \
        recs[("update_step", "2x16x16")]["flops"] > 0
    assert recs[("encode_route_step", "16x16")]["flops"] == \
        2 * recs[("encode_route_step", "2x16x16")]["flops"]
