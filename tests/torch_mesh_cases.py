"""Scenarios of the mesh service tests (``test_torch_mesh.py``), importable
without JAX: the spawned ranks of a gloo world run them on
``RouterService(mesh=...)``, and the test process runs the same functions
on the reference's unsharded service and the port's.

A scenario takes a service and a ``Backend`` (how to make arrays, pool
entries and state leaves of its package) and returns numpy outputs. The
port's unsharded run draws through ``Recorder`` around the reference's
key tree (``JaxDraws``); the ranks replay that tape through ``Replay``,
so every service of a comparison consumes the reference's numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

D, K, KMAX, M = 16, 4, 6, 3
SEED = 7
AP = dict(every=2, tau=0.75, window=1, quota=0.5, budget=0.3,
          promote_wins=4.0, max_cand_duels=12.0)
FKW = dict(dim=D, horizon=64, eta=2.0, mu=0.3, sgld_steps=2,
           sgld_minibatch=4, n_chains=2, force_distinct=True)

# service kinds: the RouterServiceConfig fields both packages take, and
# "factory" / "autopilot" / "refresh" switches each builder maps
KINDS = {
    "tick": dict(feedback_capacity=128, feedback_expiry=6),
    "uniform": dict(feedback_capacity=128, factory="uniform"),
    "stream": dict(feedback_capacity=128, buckets=(8, 16)),
    "refresh": dict(feedback_capacity=64, k_max=KMAX, refresh=True),
    "autopilot": dict(feedback_capacity=64, k_max=KMAX, autopilot=True),
    "stream_autopilot": dict(feedback_capacity=64, k_max=KMAX,
                             autopilot=True, buckets=(8,)),
}


def pool_data(n=KMAX):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, D)).astype(np.float32),
            (0.1 + rng.random(n)).astype(np.float32))


def queries(rng, n):
    return rng.standard_normal((n, D)).astype(np.float32)


def votes(rng, n):
    return np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)


@dataclasses.dataclass
class Backend:
    arr: Callable           # numpy -> the package's array
    leaves: Callable        # state tree -> leaves in flatten order
    entry: Callable         # (name, embedding, cost) -> PoolEntry


def _np(v):
    if hasattr(v, "detach"):
        v = v.detach().cpu()
    return np.asarray(v)


def state_of(svc, bk):
    return [_np(v).copy() for v in bk.leaves(svc.state)]


# ---------------------------------------------------------------------------
# Draw tapes
# ---------------------------------------------------------------------------

def _host(v):
    if isinstance(v, tuple):
        return tuple(_host(u) for u in v)
    return _np(v).copy()


class Recorder:
    """A draw source that hands out its source's draws and records each
    (by the path of split / fold_in steps from the root and the call's
    order on that path), and the key leaves it gives out."""

    def __init__(self, src, tape=None, path=()):
        self.src, self.path = src, path
        self.tape = {"calls": {}, "leaves": {}} if tape is None else tape

    def _put(self, name, out):
        self.tape["calls"].setdefault(self.path, []).append(
            (name, _host(out)))
        return out

    def split(self, n):
        return [Recorder(c, self.tape, self.path + (("s", n, i),))
                for i, c in enumerate(self.src.split(n))]

    def fold_in(self, i):
        return Recorder(self.src.fold_in(i), self.tape,
                        self.path + (("f", int(i)),))

    def normal(self, shape, device):
        return self._put("normal", self.src.normal(shape, device))

    def uniform(self, shape, device):
        return self._put("uniform", self.src.uniform(shape, device))

    def gumbel(self, shape, device):
        return self._put("gumbel", self.src.gumbel(shape, device))

    def distinct_pair(self, b, n, device):
        return self._put("distinct_pair",
                         self.src.distinct_pair(b, n, device))

    def randint(self, shape, lo, hi, device):
        return self._put("randint", self.src.randint(shape, lo, hi, device))

    def sgld(self, n_chains, n_steps):
        return _RecordedSgld(self, self.src.sgld(n_chains, n_steps))

    def key_leaf(self):
        leaf = self.src.key_leaf()
        self.tape["leaves"][self.path] = _np(leaf).copy()
        return leaf

    def from_leaf(self, leaf):
        return Recorder(self.src.from_leaf(leaf), self.tape,
                        (("leaf",) + tuple(int(v) for v in _np(leaf)),))


class _RecordedSgld:
    def __init__(self, rec, inner):
        self.rec, self.inner = rec, inner

    def step(self, i, m, hi, d, device):
        return self.rec._put(("sgld", i), self.inner.step(i, m, hi, d,
                                                          device))


class Replay:
    """Replays a ``Recorder``'s tape: the same calls on the same paths get
    the recorded numbers on the asked device, and ``key_leaf`` the leaf
    recorded on the path (a source restored from a leaf is on the leaf's
    own path)."""

    def __init__(self, tape, path=(), pos=None):
        self.tape, self.path = tape, path
        self.pos = {} if pos is None else pos

    def _get(self, name, device):
        import torch
        k = self.pos.get(self.path, 0)
        self.pos[self.path] = k + 1
        got, val = self.tape["calls"][self.path][k]
        if got != name:
            raise RuntimeError(f"tape at {self.path}[{k}]: {got} recorded, "
                               f"{name} drawn")
        if isinstance(val, tuple):
            return tuple(torch.from_numpy(v).to(device) for v in val)
        return torch.from_numpy(val).to(device)

    def split(self, n):
        return [Replay(self.tape, self.path + (("s", n, i),), self.pos)
                for i in range(n)]

    def fold_in(self, i):
        return Replay(self.tape, self.path + (("f", int(i)),), self.pos)

    def normal(self, shape, device):
        return self._get("normal", device)

    def uniform(self, shape, device):
        return self._get("uniform", device)

    def gumbel(self, shape, device):
        return self._get("gumbel", device)

    def distinct_pair(self, b, n, device):
        return self._get("distinct_pair", device)

    def randint(self, shape, lo, hi, device):
        return self._get("randint", device)

    def sgld(self, n_chains, n_steps):
        return self

    def step(self, i, m, hi, d, device):
        return self._get(("sgld", i), device)

    def key_leaf(self):
        return self.tape["leaves"][self.path]

    def from_leaf(self, leaf):
        return Replay(self.tape,
                      (("leaf",) + tuple(int(v) for v in _np(leaf)),),
                      self.pos)


# ---------------------------------------------------------------------------
# The port's services
# ---------------------------------------------------------------------------

def torch_backend() -> Backend:
    import torch

    from repro_torch.data.pool import PoolEntry
    from repro_torch.models.layers import tree_leaves

    def entry(name, emb, cost):
        return PoolEntry(name=name, arch="granite-3-2b",
                         cost_per_1k_tokens=float(cost), embedding=emb)
    return Backend(arr=torch.from_numpy, leaves=tree_leaves, entry=entry)


def port_service(kind, mesh=None, draws=None, **over):
    """The port's service of ``kind`` (``KINDS``) on the CPU."""
    from repro_torch import autopilot as ap
    from repro_torch.core import fgts
    from repro_torch.launch.serve import POLICIES
    from repro_torch.refresh import RefreshConfig
    from repro_torch.serving import RouterService, RouterServiceConfig
    kw = dict(KINDS[kind], **over)
    bk = torch_backend()
    factory = kw.pop("factory", None)
    auto = kw.pop("autopilot", False)
    refresh = kw.pop("refresh", False)
    n = K if kw.get("k_max") is None else kw["k_max"]
    embs, costs = pool_data()
    cfg = RouterServiceConfig(
        fgts=fgts.FGTSConfig(n_models=n, **FKW), seed=SEED,
        policy_factory=None if factory is None else POLICIES[factory],
        autopilot=ap.AutopilotConfig(**AP) if auto else None,
        refresh=RefreshConfig(every=0, capacity=32, n_categories=M)
        if refresh else None, **kw)
    entries = [bk.entry(f"m{i}", embs[i], costs[i]) for i in range(K)]
    return RouterService(entries, None, None, cfg, device="cpu", mesh=mesh,
                         draws=draws)


# ---------------------------------------------------------------------------
# Scenarios (any backend)
# ---------------------------------------------------------------------------

def scenario_tick(svc, bk, rounds=16, batch=32):
    """Duplicate and stale tickets in one resolve, then ``rounds`` rounds
    of ``batch`` queries with the votes lagged one round (prefs on odd
    rounds) and ``expire_pending`` after each."""
    rng = np.random.default_rng(11)
    x, y = queries(rng, batch), votes(rng, batch)
    _, _, t0 = svc.route_batch(bk.arr(x))
    _, _, t1 = svc.route_batch(bk.arr(x))
    t0, t1 = _np(t0), _np(t1)
    dup = svc.feedback_batch(bk.arr(np.concatenate([t0[:16], t0[:16]])),
                             bk.arr(y))
    mixed = svc.feedback_batch(bk.arr(np.concatenate([t0[:16], t1[:16]])),
                               bk.arr(y))
    out = {"dup": int(dup), "mixed": int(mixed),
           "state_dup": state_of(svc, bk), "pairs": [], "n_ok": [],
           "expired": []}
    lag = None
    for r in range(rounds):
        x, y = queries(rng, batch), votes(rng, batch)
        p = np.linspace(0.0, 2.0, batch).astype(np.float32) if r % 2 \
            else None
        a1, a2, t = svc.route_batch(bk.arr(x), prefs=None if p is None
                                    else bk.arr(p))
        out["pairs"].append(np.stack([_np(a1), _np(a2), _np(t)]))
        if lag is not None:
            out["n_ok"].append(int(svc.feedback_batch(*lag)))
        lag = (bk.arr(_np(t).copy()), bk.arr(y))
        out["expired"].append(svc.expire_pending())
    out["state"] = state_of(svc, bk)
    out["pending"] = svc.pending_count()
    st = svc.service_stats()
    out["stats"] = (st["n_routed"], st["n_folded"], st["duel_cost"],
                    st["pending"])
    return out


def scenario_uniform(svc, bk, batch=32):
    """A factory policy with per-row draws and no masked fold: two routed
    batches, then 13 survivors of 32 through the compaction fold."""
    rng = np.random.default_rng(12)
    x = queries(rng, batch)
    pairs = []
    for _ in range(2):
        a1, a2, t = svc.route_batch(bk.arr(x))
        pairs.append(np.stack([_np(a1), _np(a2), _np(t)]))
    t = pairs[-1][2]
    dup = np.concatenate([t[:13], np.broadcast_to(t[:1], (batch - 13,))])
    n = svc.feedback_batch(bk.arr(dup), bk.arr(np.ones(batch, np.float32)))
    return {"pairs": pairs, "n_ok": int(n), "pending": svc.pending_count(),
            "state": state_of(svc, bk)}


def scenario_restore(svc, bk, ckpt_in, ckpt_out, batch=32):
    """Restore a checkpoint with one batch in flight (routed from
    ``queries`` of seed 13), deliver its votes, route one more batch and
    save to ``ckpt_out``."""
    rng = np.random.default_rng(13)
    queries(rng, batch)
    x1, y = queries(rng, batch), votes(rng, batch)
    svc.restore(ckpt_in)
    out = {"pending0": svc.pending_count(), "tick0": svc.tick}
    tickets = np.arange(batch, dtype=np.int32)
    out["n_ok"] = int(svc.feedback_batch(bk.arr(tickets), bk.arr(y)))
    a1, a2, t = svc.route_batch(bk.arr(x1))
    out["pairs"] = np.stack([_np(a1), _np(a2), _np(t)])
    svc.save(ckpt_out)
    out["state"] = state_of(svc, bk)
    return out


def scenario_stream(svc, bk, sizes=(8, 12, 16, 5, 16, 8)):
    """Formed batches of mixed sizes through ``route_stream`` (prefs on
    odd batches) and their votes through ``feedback_stream``."""
    rng = np.random.default_rng(14)
    out = {"pairs": [], "tickets": [], "n_ok": []}
    for i, n in enumerate(sizes):
        x, y = queries(rng, n), votes(rng, n)
        p = np.linspace(0.0, 1.0, n).astype(np.float32) if i % 2 else None
        a1, a2, t = svc.route_stream(bk.arr(x), prefs=None if p is None
                                     else bk.arr(p))
        out["pairs"].append(np.stack([_np(a1), _np(a2)]))
        out["tickets"].append(_np(t).copy())
        out["n_ok"].append(int(svc.feedback_stream(bk.arr(_np(t).copy()),
                                                   bk.arr(y))))
    out["state"] = state_of(svc, bk)
    out["pending"] = svc.pending_count()
    return out


def scenario_refresh(svc, bk, rounds=4, batch=8):
    """Routed batches with query categories and their votes (shuffled,
    with a duplicate), a refreshed table swapped in after round 1, a hot
    add and a retirement after round 2; the exported log at the end."""
    rng = np.random.default_rng(15)
    embs, costs = pool_data()
    out = {"pairs": []}
    for r in range(rounds):
        x = queries(rng, batch)
        c = np.where(np.arange(batch) % 5 == 4, -1,
                     np.arange(batch) % M).astype(np.int32)
        a1, a2, t = svc.route_batch(bk.arr(x), cats=bk.arr(c))
        out["pairs"].append(np.stack([_np(a1), _np(a2), _np(t)]))
        tk = _np(t).copy()
        tk = np.concatenate([rng.permutation(tk), tk[:1]])[:batch]
        svc.feedback_batch(bk.arr(tk), bk.arr(votes(rng, batch)))
        if r == 1:
            svc.apply_table(bk.arr(rng.standard_normal((KMAX, D))
                                   .astype(np.float32)))
        if r == 2:
            out["slot"] = svc.add_model(bk.entry("new", embs[K], costs[K]))
            svc.retire_model(0)
    log = svc.export_log()
    out["log"] = {k: _np(log[k]).copy() for k in
                  ("x", "a1", "a2", "y", "pref", "prop", "cat",
                   "issued_at")}
    out["count"] = int(log["count"])
    out["state"] = state_of(svc, bk)
    st = svc.service_stats()
    out["stats"] = (st["n_folded"], st["duels_logged"], st["table_swaps"])
    return out


def scenario_autopilot(svc, bk, rounds=6, batch=8):
    """Control ticks every 2 acts, a candidate arrival with a seeding
    replay after round 1, the cost governor; the controller's status after
    every round. A streaming service routes and folds through its bucket
    programs."""
    rng = np.random.default_rng(16)
    embs, costs = pool_data()
    out = {"pairs": [], "status": []}
    for r in range(rounds):
        x = queries(rng, batch)
        a1, a2, t = svc.route_batch(bk.arr(x))
        out["pairs"].append(np.stack([_np(a1), _np(a2), _np(t)]))
        svc.feedback_batch(bk.arr(_np(t).copy()), bk.arr(votes(rng, batch)))
        if r == 1:
            x_off = queries(rng, 8)
            a1o = np.full(8, K, np.int32)
            a2o = np.arange(8, dtype=np.int32) % K
            svc.add_model(bk.entry("new", embs[K], costs[K]),
                          replay=tuple(bk.arr(v) for v in
                                       (x_off, a1o, a2o, votes(rng, 8))))
        st = svc.autopilot_status()
        out["status"].append({k: np.asarray(v) for k, v in st.items()})
    out["state"] = state_of(svc, bk)
    return out


def scenario_pad(svc, bk, rounds=3, n=8):
    """Batches of ``n`` rows (prefs after the first, for a policy that
    takes them) and their votes: the same on every bucket ladder that
    holds ``n``."""
    rng = np.random.default_rng(17)
    pairs = []
    for r in range(rounds):
        x, y = queries(rng, n), votes(rng, n)
        p = None if r == 0 or svc.policy.act_pref is None \
            else np.linspace(0.0, 2.0, n).astype(np.float32)
        a1, a2, t = svc.route_stream(bk.arr(x), prefs=None if p is None
                                     else bk.arr(p))
        pairs.append(np.stack([_np(a1), _np(a2)]))
        svc.feedback_stream(bk.arr(_np(t).copy()), bk.arr(y))
    return {"pairs": pairs, "state": state_of(svc, bk),
            "pending": svc.pending_count()}


def scenario_collectives(svc, bk, n=16):
    """The collectives (``routing_rules.tally``: bytes and calls by
    operation) of one route and one feedback, and, on a streaming
    service, of one run of its top bucket's route program alone."""
    from repro_torch.sharding import routing_rules as rr
    rng = np.random.default_rng(18)
    route = svc.route_stream if svc.streaming else svc.route_batch
    feed = svc.feedback_stream if svc.streaming else svc.feedback_batch
    with rr.tally() as t_route:
        _, _, t = route(bk.arr(queries(rng, n)))
    with rr.tally() as t_feed:
        feed(bk.arr(_np(t).copy()), bk.arr(votes(rng, n)))
    out = {"route": t_route, "feedback": t_feed}
    if svc.streaming:
        with rr.tally() as t_prog:
            svc._s_route[svc.buckets[-1]](svc._next_key())
        out["route_program"] = t_prog
    return out


def scenario_indivisible(svc, bk):
    """The error of a batch that does not divide over the batch shards."""
    try:
        svc.route_batch(bk.arr(np.zeros((33, D), np.float32)))
    except ValueError as e:
        return str(e)
    return None


SCENARIOS = {"tick": scenario_tick, "uniform": scenario_uniform,
             "restore": scenario_restore, "stream": scenario_stream,
             "refresh": scenario_refresh, "autopilot": scenario_autopilot,
             "pad": scenario_pad, "indivisible": scenario_indivisible,
             "collectives": scenario_collectives}


# ---------------------------------------------------------------------------
# What the ranks of a world run
# ---------------------------------------------------------------------------

def run_on_mesh(shape, jobs):
    """On every rank: a (data, model) mesh of ``shape``, then each job
    (name, kind, scenario, tape or None, extra args, config overrides) on
    a mesh service replaying its tape (``KeyedDraws(SEED)`` without one).
    Returns {name: outputs}."""
    import torch

    from repro_torch.core.draws import KeyedDraws
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    mesh = mesh_lib.make_debug_mesh(*shape, device="cpu")
    bk = torch_backend()
    out = {}
    for name, kind, scen, tape, args, over in jobs:
        draws = KeyedDraws(SEED) if tape is None else Replay(tape)
        svc = port_service(kind, mesh, draws, **over)
        before = svc.compiled_program_counts()
        got = SCENARIOS[scen](svc, bk, *args)
        if isinstance(got, dict):
            got["programs"] = (before, svc.compiled_program_counts())
        out[name] = got
    return out
