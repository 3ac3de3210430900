"""Batched routing service: the production wrapper around a RoutingPolicy
(counterpart of ``repro/serving/router_service.py``).

A deployment keeps one ``RouterService`` per model pool. Requests arrive
in batches; the service embeds them (encoder), then drives a batched
``RoutingPolicy``: one ``act`` per batch (for FGTS.CDB one multi-chain
SGLD refresh, 20 steps of the ``sgld_potential`` gradient kernel per
posterior sample, and one ``dueling_select`` launch) and one masked
``update`` per feedback batch (a single scatter into the replay ring).

Act and update run at independent cadences: ``route_batch`` issues every
duel into a fixed-capacity ``PendingDuels`` ring and returns one int32
ticket per query; ``feedback_batch(tickets, y)`` resolves the tickets
whenever the votes land, drops stale and expired ones and folds the rest
into the policy. The ring checkpoints with the posterior and the draw
source's key, so a restarted service routes exactly the pairs the
uninterrupted one would have.

Streaming (``cfg.buckets``): ``route_stream`` / ``feedback_stream`` pad a
formed batch of any size to the next bucket of a power-of-two ladder and
run one fused program per bucket: route (selection, masked enqueue into a
shard-local ring, cost accounting, the device tick advanced in place),
feedback (resolve and masked fold), resolve (for policies without a
masked fold). On the CPU each runs eagerly; on a card each is captured
once, at construction, as a CUDA graph over static buffers (the
counterpart of the reference's ahead-of-time programs with donated
buffers) and replayed: the graph writes the state, ring, tick and
accumulators back in place, and every control-plane change writes into
the same tensors, so nothing is ever captured again. The act's draws
replay through a ``core.draws.DrawPlan`` filled before each replay.

Refresh (``cfg.refresh``): every issued duel carries its act-time pair
propensity and query category through the ring, and every fold also
appends the resolved duels to an exportable ``refresh.DuelLog``;
``export_log`` / ``refresh_due`` / ``apply_table`` run the cycle.

Mesh (``mesh=``, a ``DeviceMesh`` from ``launch.mesh``): SPMD, one
process per rank, every rank running the same host program over the
global batch (``sharding/routing_rules.py``). Each rank acts on its own
rows, B / S of them for S batch shards, with the policy state replicated:
the SGLD refresh is recomputed from the same draws on every rank, and a
per-row draw is made for the whole batch and cut to the rank's rows
(``core.draws.ShardDraws``), so the pairs are the unsharded service's
whatever the mesh. The tick-batch ring splits its capacity over the
ranks with the unsharded tickets: ``route_batch`` gathers the routed
pairs over the batch ranks and each rank writes the rows whose slots it
holds; ``feedback_batch`` resolves every vote against each rank's share
and sums the shares' batches word by word (``routing_rules.sum_rows``),
so every rank folds the unsharded resolved batch in the unsharded order.
The streaming ring is shard-local (ticket = seq * S + shard): the route
program holds no collective (``route_stream`` gathers its outputs after
it), and the feedback gathers its shard-local resolve over the batch
ranks between a resolve program and a fold program. Every rank launches
the kernels: ``dueling_select`` on its rows, the ``sgld_potential``
gradient on the replicated refresh.

Host syncs: ``route_batch``, the masked and pref folds of
``feedback_batch``, ``route_stream``, the fused ``feedback_stream``,
``feedback_direct``, ``spend`` and ``seed_replay`` never read the card
(host scalars enter as fills, counts stay 0-d device tensors). The
control-plane reads (``pending_count``, ``expire_pending``,
``service_stats``, ``active_mask``, ``autopilot_status``, ``add_model``,
``restore``, ``export_log``, ``refresh_due``, ``apply_table`` with
refresh, and the compaction fold of policies without a masked update)
each make one explicit ``.cpu()`` transfer of the tensors they need, and
say so.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import autopilot as ap
from repro_torch.core import fgts
from repro_torch.core import model_pool as mp
from repro_torch.core.draws import (BucketDraws, KeyedDraws, PlanRecorder,
                                    ShardDraws, TapeDraws)
from repro_torch.core.policy import (RoutingPolicy, fgts_policy,
                                     staleness_weight, with_staleness)
from repro_torch.data.pool import PoolEntry
from repro_torch.device import as_f32, resolve_device
from repro_torch.encoder.model import EncoderConfig, encode
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.refresh import duel_log as dl
from repro_torch.refresh.trainer import RefreshConfig

from repro_torch.sharding import routing_rules as rr

from . import feedback_queue as fq
from . import stream


@dataclasses.dataclass
class RouterServiceConfig:
    fgts: fgts.FGTSConfig
    cost_tilt: float = 0.0         # lambda applied at serve time
    seed: int = 0
    # Dynamic-pool capacity K_max: enables hot add_model / retire_model /
    # swap_model (the policy carries a ModelPool in its state and
    # cfg.fgts.n_models must equal k_max). None = static pool.
    k_max: Optional[int] = None
    # (arms, costs, cfg) -> RoutingPolicy; None = FGTS.CDB with cost tilt.
    policy_factory: Optional[Callable] = None
    # The selection kernel (True or None: dispatched by the tensors'
    # device, on every rank of a mesh too); False selects with its plain
    # version, dueling_select_plain (and the autopilot's dominance with
    # posterior_scores' plain version). Factories receive the resolved
    # bool.
    use_kernel: Optional[bool] = None
    # Mesh act draws. True: each rank draws its own rows' per-row numbers
    # from the replicated source, so every shard repeats the same draws
    # (the reference's shard_map). False: per-row draws are made for the
    # whole batch and cut to the rank's rows (ShardDraws), equal to the
    # unsharded stream. None = auto: True for the built-in FGTS default
    # (its act draws nothing per row), False for factory policies and the
    # autopilot (whose quota gate is a per-row draw).
    act_shard_map: Optional[bool] = None
    # -- async feedback -----------------------------------------------------
    feedback_capacity: int = 1024  # max in-flight duels (ring: oldest expire)
    feedback_expiry: Optional[int] = None   # max age in ticks; None = never
    stale_half_life: Optional[float] = None  # age-discount stale votes
    # -- streaming serving --------------------------------------------------
    # Padding-bucket ladder (sorted powers of two): route_stream /
    # feedback_stream run one fused program per bucket (a CUDA graph on a
    # card), and route_batch / feedback_batch delegate to them. None = the
    # tick-batch surface.
    buckets: Optional[tuple] = None
    # -- online representation refresh --------------------------------------
    # Standing CCFT refresh loop (needs k_max): act-time propensities and
    # query categories ride the ring with every duel, resolved duels fold
    # into an exportable refresh.DuelLog, apply_table swaps the refreshed
    # table in. None = no logging.
    refresh: Optional[RefreshConfig] = None
    # -- pool autopilot -----------------------------------------------------
    autopilot: Optional[ap.AutopilotConfig] = None

    def __post_init__(self):
        hl = self.stale_half_life
        if hl is not None and hl != hl:      # NaN
            raise ValueError(
                "stale_half_life=NaN would silently poison every delayed "
                "update — use None (no staleness wrap), a positive "
                "half-life, or <= 0 / inf for an explicit no-discount")
        if self.feedback_capacity < 1:
            raise ValueError(
                f"feedback_capacity={self.feedback_capacity} — the pending "
                f"ring needs at least one slot")
        if self.feedback_expiry is not None and self.feedback_expiry < 0:
            raise ValueError(
                f"feedback_expiry={self.feedback_expiry} must be >= 0 "
                f"ticks (None disables age expiry)")
        if self.refresh is not None and self.k_max is None:
            raise ValueError(
                "RouterServiceConfig(refresh=...) needs a dynamic pool "
                "(k_max=...): the refreshed table swaps through the "
                "policy's ModelPool (apply_table / model_pool.set_table)")


class RouterService:
    """Online routing service state: host-side orchestration over tensor
    programs on one device, or on every rank of a mesh.

    ``device`` None means the card. ``draws`` is the service's draw source
    (``core.draws``), split once per act as the reference splits its key;
    None means ``KeyedDraws(cfg.seed)`` in device mode. It must checkpoint
    (``key_leaf`` / ``from_leaf``) for ``save`` / ``restore``. ``mesh`` is
    a ``DeviceMesh`` over the started world (``launch.mesh``) whose device
    type is ``device``'s: every rank constructs the service with the same
    arguments."""

    def __init__(self, pool: list[PoolEntry], enc_params,
                 enc_cfg: EncoderConfig, cfg: RouterServiceConfig, *,
                 mesh=None, device=None, draws=None):
        self.device = resolve_device(device)
        dev = self.device
        self.mesh = mesh
        self._n_shards, self._shard, self._group = 1, 0, None
        if mesh is not None:
            if mesh.device_type != dev.type:
                raise ValueError(
                    f"a {mesh.device_type} mesh for a service on {dev}: "
                    f"build the mesh over the service's device type")
            self._n_shards = rr.n_batch_shards(mesh)
            self._shard = rr.shard_index(mesh)
            self._group = rr.batch_group(mesh)
        cfg = dataclasses.replace(cfg, use_kernel=cfg.use_kernel is not False)
        # mesh acts cut per-row draws from the whole batch's (ShardDraws)
        # unless the act draws each rank's rows itself (act_shard_map)
        shard_map = cfg.act_shard_map if cfg.act_shard_map is not None \
            else (cfg.policy_factory is None and cfg.autopilot is None)
        self._cut_draws = mesh is not None and not shard_map
        self.dynamic = cfg.k_max is not None
        if self.dynamic:
            if len(pool) > cfg.k_max:
                raise ValueError(f"{len(pool)} pool entries exceed "
                                 f"k_max={cfg.k_max}")
            if cfg.fgts.n_models != cfg.k_max:
                raise ValueError(
                    f"dynamic pools size every arm buffer for capacity: "
                    f"cfg.fgts.n_models={cfg.fgts.n_models} must equal "
                    f"k_max={cfg.k_max}")
        elif len(pool) != cfg.fgts.n_models:
            raise ValueError(f"{len(pool)} pool entries for "
                             f"cfg.fgts.n_models={cfg.fgts.n_models}")
        self.pool = list(pool) + [None] * (
            (cfg.k_max - len(pool)) if self.dynamic else 0)
        # slots that have ever hosted an arm: add_model prefers virgin
        # slots, so a newcomer never inherits a retired arm's history
        self._ever_used = [p is not None for p in self.pool]
        self.enc_params = enc_params
        self.enc_cfg = enc_cfg
        self.cfg = cfg
        self.a_emb = as_f32(np.stack([p.embedding for p in pool]), dev)
        entry_costs = as_f32([p.cost_per_1k_tokens for p in pool], dev)
        if self.dynamic:
            pool0 = mp.init_pool(self.a_emb, entry_costs, k_max=cfg.k_max,
                                 device=dev)
            self.costs = pool0.costs.clone()     # (K_max,) padded mirror
            arms = pool0
        else:
            self.costs = entry_costs
            arms = self.a_emb
        if cfg.policy_factory is not None:
            self.policy: RoutingPolicy = cfg.policy_factory(
                arms, self.costs, cfg)
        else:
            self.policy = fgts_policy(arms, cfg.fgts, costs=self.costs,
                                      cost_tilt=cfg.cost_tilt,
                                      use_kernel=cfg.use_kernel)
        if cfg.autopilot is not None:
            if not self.dynamic:
                raise ValueError(
                    "autopilot manages pool membership: construct the "
                    "service with RouterServiceConfig(k_max=...) so the "
                    "policy carries a ModelPool it can retire into")
            self.policy = ap.wrap(
                self.policy, cfg.autopilot, use_kernel=cfg.use_kernel,
                act_folds_cost=mesh is None)
        self._staleness_wrapped = (cfg.stale_half_life is not None
                                   and self.policy.update_delayed is None)
        if self._staleness_wrapped:
            self.policy = with_staleness(self.policy, cfg.stale_half_life)
        self._draws = KeyedDraws(cfg.seed) if draws is None else draws
        self.state = self.policy.init(self._next_key())
        if self.dynamic and not mp.is_pooled(self.state):
            raise ValueError(
                f"policy '{self.policy.name}' ignored the ModelPool: a "
                f"dynamic service needs a pool-backed policy (state must "
                f"be a PooledState) — build it from the ModelPool first "
                f"argument the factory receives")
        # the ring's wrapping slot arithmetic needs a power-of-two
        # capacity (dividing over a mesh's batch shards): round the
        # configured one up. Under a mesh self.pending is this rank's
        # share: C / S rows.
        capacity = fq.next_pow2(cfg.feedback_capacity) if mesh is None \
            else rr.round_capacity(cfg.feedback_capacity, mesh)
        share = capacity // self._n_shards
        self._share = None if mesh is None \
            else (self._shard * share, capacity)
        dim = self.a_emb.shape[1]
        self.streaming = cfg.buckets is not None
        if self.streaming:
            self.buckets = stream.validate_buckets(cfg.buckets,
                                                   self._n_shards)
            self.pending = fq.init_pending(share, dim, device=dev, shards=1)
        else:
            self.pending = fq.init_pending(share, dim, device=dev)
        self.tick = 0                  # route calls (the clock)
        self.n_routed = 0
        # online representation refresh: the exportable duel log rides next
        # to the state and is folded with every feedback batch
        self.refresh_on = cfg.refresh is not None
        self.duel_log = None
        if self.refresh_on:
            self.duel_log = dl.init_log(fq.next_pow2(cfg.refresh.capacity),
                                        dim, device=dev)
            self._count_at_swap = 0    # log.count at the last apply_table
            self._table_swaps = 0
        # on-device traffic accumulators: the hot path only adds to them;
        # service_stats() reads them. Process-local: not checkpointed.
        self._n_folded = torch.zeros((), dtype=torch.int32, device=dev)
        self._duel_cost = torch.zeros((), dtype=torch.float32, device=dev)
        self._build_programs()
        if self.streaming:
            self._build_stream_programs()

    def _build_programs(self):
        """The service's programs that add to the policy's own slots: the
        pref act, the masked and pref folds (with the staleness weight)
        and, for a dynamic pool, the membership writes and the replay
        fold."""
        cfg = self.cfg
        pol = self.policy
        half_life = cfg.stale_half_life if self._staleness_wrapped else None

        # The masked path subsumes update_delayed only when the staleness
        # semantics are the generic label shrink (with_staleness); a policy
        # with its own delayed path keeps the compaction route.
        masked = pol.update_masked
        masked_update = None
        if masked is not None and (pol.update_delayed is None
                                   or self._staleness_wrapped):
            def masked_update(state, x, a1, a2, y, age, ok):
                if half_life is not None:
                    y = y * staleness_weight(age, half_life)
                return masked(state, x, a1, a2, y, ok)

        # preference-conditioned twins: selection with a (B,) per-request
        # pref, feedback with the pref each duel was served under
        act_pref = None
        if pol.act_pref is not None:
            def act_pref(key, state, x, pref):
                return pol.act_pref(key, state, x, None, pref)
        masked_update_pref = None
        if pol.update_pref is not None and (pol.update_delayed is None
                                            or self._staleness_wrapped):
            def masked_update_pref(state, x, a1, a2, y, age, ok, pref):
                if half_life is not None:
                    y = y * staleness_weight(age, half_life)
                return pol.update_pref(state, x, a1, a2, y, pref, ok)

        self._act_pref = act_pref
        self._update_masked = masked_update
        self._update_pref = masked_update_pref
        # the act-time pair propensity the refresh log records: the
        # policy's readout, or 1.0 (IPW then degrades to the naive
        # estimator)
        prop_fn = pol.propensity
        if prop_fn is None:
            def prop_fn(state, x, a1, a2):
                return torch.ones(a1.shape, dtype=torch.float32,
                                  device=a1.device)
        self._prop = prop_fn
        if not self.dynamic:
            return

        # membership writes: fixed-shape state updates (a row write and a
        # mask flip), so act and update see the same shapes throughout
        def pool_set(state, emb, cost, slot):
            return mp.set_pool(state, mp.set_arm(mp.get_pool(state), slot,
                                                 emb, cost))

        def pool_retire(state, slot):
            return mp.set_pool(state, mp.retire_arm(mp.get_pool(state),
                                                    slot))

        def table_swap(state, table):
            return mp.set_pool(state, mp.set_table(mp.get_pool(state),
                                                   table))

        self._pool_set = pool_set
        self._pool_retire = pool_retire
        self._table_swap = table_swap
        seed = masked_update if masked_update is not None else pol.update
        if cfg.autopilot is not None:
            # synthetic offline duels (warm_start_duels pairing a newcomer
            # against incumbents mid-A/B) shape the posterior only, never a
            # live candidate's win and duel tallies
            def seeded(state, *args, _fn=seed):
                ctrl = state.ctrl
                blank = state._replace(ctrl=ctrl._replace(
                    candidate=torch.zeros_like(ctrl.candidate)))
                out = _fn(blank, *args)
                return out._replace(ctrl=out.ctrl._replace(
                    candidate=ctrl.candidate))
            self._update_seed = seeded
        else:
            self._update_seed = seed

    # -- the live tensors, rebound or written in place ------------------------

    def _live(self) -> dict:
        """The service's live tensors by name (trees for state, pending and
        log): the operands and results of the streaming programs."""
        live = dict(state=self.state, pending=self.pending,
                    n_folded=self._n_folded, duel_cost=self._duel_cost)
        if self.refresh_on:
            live["log"] = self.duel_log
        if self.streaming:
            live["tick"] = self._tick_dev
        return live

    def _commit(self, **new) -> None:
        """Install new values of live tensors (``state``, ``pending``,
        ``log``, ``tick``, ``n_folded``, ``duel_cost``). The tick-batch
        service rebinds them. A streaming service copies them into the
        tensors it has: its programs (CUDA graphs on a card) read and write
        those addresses, so they are never rebound, on the CPU too. A new
        value that shares memory with a live tensor is cloned first, so no
        copy reads a tensor an earlier copy of the same commit wrote."""
        if not self.streaming:
            for name, v in new.items():
                setattr(self, _LIVE_ATTR[name], v)
            return
        live = self._live()
        ptrs = {t.untyped_storage().data_ptr()
                for tree in live.values() for t in tree_leaves(tree)}
        pairs = []
        for name, v in new.items():
            dst, src = tree_leaves(live[name]), tree_leaves(v)
            if len(dst) != len(src):
                raise ValueError(f"{name}: {len(src)} leaves for "
                                 f"{len(dst)}")
            for d, t in zip(dst, src):
                if t is d:
                    continue
                if t.shape != d.shape or t.dtype != d.dtype:
                    raise ValueError(
                        f"{name}: a leaf {tuple(t.shape)} {t.dtype} for "
                        f"{tuple(d.shape)} {d.dtype}")
                if t.untyped_storage().data_ptr() in ptrs:
                    t = t.clone()
                pairs.append((d, t))
        for d, t in pairs:
            d.copy_(t)

    # -- streaming serving (cfg.buckets) -------------------------------------

    def _build_stream_programs(self):
        """The fused per-bucket programs of the streaming surface: route
        (and route_pref where the policy has ``act_pref``), feedback (with
        the duel-log fold under refresh) where it has a masked fold, and
        resolve for the compaction fallback and ``feedback_direct``. Each
        reads the bucket's staged inputs and the live tensors and writes
        its results back in place (``_commit``): the counterpart of the
        reference's donated buffers.

        Padding never changes a live row: padded rows are masked out of
        the ring, the fold and the log, and every per-row draw is made at
        the ladder's top bucket and cut (``BucketDraws``). On a card each
        program is captured once here as a CUDA graph (``_capture``).

        Under a mesh each rank's programs read and write its rows of the
        padded batch and its share of the shard-local ring; the feedback
        is two programs, the shard-local resolve and the fold, with the
        resolved rows gathered over the batch ranks between them
        (``feedback_stream``), and the autopilot's realized-cost EMA
        is folded after the route's gather (``_fold_cost``), so no
        captured graph holds a collective."""
        dev, cfg = self.device, self.cfg
        on_card = dev.type == "cuda"
        if on_card and not isinstance(self._draws, KeyedDraws):
            raise ValueError(
                f"a streaming service on a card replays its act's draws "
                f"through a draw plan, which needs KeyedDraws; got "
                f"{type(self._draws).__name__}")
        # live tensors of distinct memory: a program writes each in place
        self.state = _cloned(self.state)
        self._tick_dev = fq.as_i32(self.tick, dev)
        self._costs_dev = self.costs.clone()
        d = self.a_emb.shape[1]
        mesh = self.mesh is not None

        def f32(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def i32(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=dev)
        # each bucket's staged inputs: this rank's rows of the padded batch
        # (``rows``: their positions in it)
        self._inputs = {}
        for b in self.buckets:
            lo, n = self._rows(b)
            self._inputs[b] = dict(
                x=f32(n, d), mask=torch.zeros((n,), dtype=torch.bool,
                                              device=dev),
                pref=f32(n), cat=i32(n, fill=-1), tickets=i32(n, fill=-1),
                y=f32(n), rows=torch.arange(lo, lo + n, device=dev))
        # under a mesh: each bucket's gathered resolved batch, which the
        # fold program reads
        self._gathered = {b: fq.ResolvedDuels(
            x=f32(b, d), a1=i32(b), a2=i32(b), y=f32(b), age=i32(b),
            ok=torch.zeros((b,), dtype=torch.bool, device=dev), pref=f32(b),
            prop=f32(b), cat=i32(b)) for b in self.buckets} if mesh else {}

        if self._update_pref is not None:
            # preference-conditioned fold: each duel under the pref it was
            # served with (zeros when the caller passed none)
            def fb_fold(state, res):
                return self._update_pref(state, res.x, res.a1, res.a2, res.y,
                                         res.age, res.ok, res.pref)
        elif self._update_masked is not None:
            def fb_fold(state, res):
                return self._update_masked(state, res.x, res.a1, res.a2,
                                           res.y, res.age, res.ok)
        else:
            fb_fold = None

        def resolve(b):
            inp = self._inputs[b]
            return fq.resolve_stream(self.pending, inp["tickets"], inp["y"],
                                     inp["mask"], self._tick_dev,
                                     self._shard, self._n_shards,
                                     max_age=cfg.feedback_expiry)

        def route(b, draws, with_pref: bool):
            inp = self._inputs[b]
            x, mask, pref = inp["x"], inp["mask"], inp["pref"]
            if draws is not None:
                lo, n = self._rows(b)
                draws = self._act_draws(draws, n, b, lo)
            if with_pref:
                state, a1, a2 = self._act_pref(draws, self.state, x, pref)
            else:
                state, a1, a2 = self.policy.act(draws, self.state, x)
            prop = cat = None
            if self.refresh_on:
                prop, cat = self._prop(state, x, a1, a2), inp["cat"]
            now = self._tick_dev + 1
            pending, tickets = fq.enqueue_stream(
                self.pending, x, a1, a2, now, pref, mask, self._shard,
                self._n_shards, prop=prop, cat=cat)
            costs = self._costs_dev
            live = torch.where(mask, costs[a1.long()] + costs[a2.long()],
                               0.0)
            self._commit(state=state, pending=pending, tick=now,
                         duel_cost=self._duel_cost + torch.sum(live))
            return a1, a2, tickets

        def fold(res, **new):
            n_ok = torch.sum(res.ok, dtype=torch.int32)
            if self.refresh_on:
                new["log"] = self._fold_log(self.duel_log, res,
                                            self._tick_dev)
            self._commit(state=fb_fold(self.state, res),
                         n_folded=self._n_folded + n_ok, **new)
            return (n_ok,)

        def feedback(b, draws):
            if mesh:                      # the fold of the gathered batch
                return fold(self._gathered[b])
            pending, res = resolve(b)
            return fold(res, pending=pending)

        def resolve_only(b, draws):
            pending, res = resolve(b)
            self._commit(pending=pending)
            return res

        self._graph_pool = torch.cuda.graph_pool_handle() if on_card \
            else None
        self._n_captures = 0

        top = self.buckets[-1]

        def build(body, draws: bool):
            """One program per bucket: eager on the CPU, a CUDA graph on a
            card (``draws``: the body takes the act's draw source)."""
            progs = {}
            for b in self.buckets:
                fn = functools.partial(body, b)
                progs[b] = self._capture(fn, b, top, draws) if on_card \
                    else _StreamProgram(fn, b, top)
            return progs
        self._s_route = build(lambda b, dr: route(b, dr, False), True)
        self._s_route_pref = None if self._act_pref is None else build(
            lambda b, dr: route(b, dr, True), True)
        self._s_feedback = None if fb_fold is None else build(feedback,
                                                              False)
        self._s_resolve = build(resolve_only, False)

    def _capture(self, body, b: int, top: int, draws: bool):
        """Capture ``body`` as a CUDA graph. A warm-up run on a side stream
        first (library handles, kernel attributes, the draw plan from a
        throwaway key); the live tensors are then put back as they were, so
        the first replay routes as a service that captured nothing. The
        capture runs in the thread-local error mode: an operation a graph
        cannot hold (a host sync, a host-to-device copy) on this thread
        raises; there is no eager retry. A call from another thread of the
        process that a global-mode capture forbids (a ``cudaMalloc``)
        leaves the capture whole; one that waits on the capturing stream
        (a device-wide sync) still breaks it. Python's cyclic collector is
        off while capturing: a dropped service is cyclic garbage, and a
        collection that destroyed its graphs inside the capture would
        break it (``tools/capture_gc.py``)."""
        before = [t.clone() for t in self._live_leaves()]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        plan = None
        with torch.cuda.stream(side):
            if draws:
                rec = PlanRecorder(KeyedDraws(0, host=self._draws.host))
                body(BucketDraws(rec, b, top))
                plan = rec.plan
            else:
                body(None)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for t, v in zip(self._live_leaves(), before):
            t.copy_(v)
        tape = None if plan is None else plan.buffers(self.device)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  capture_error_mode="thread_local"):
                src = None if plan is None else TapeDraws(plan, tape)
                outs = body(None if src is None
                            else BucketDraws(src, b, top))
        finally:
            if collecting:
                gc.enable()
        if src is not None and src.pos != len(tape):
            raise RuntimeError(
                f"bucket {b}: the capture drew {src.pos} of the plan's "
                f"{len(tape)} draws")
        self._n_captures += 1
        return _StreamProgram(body, b, top, graph=graph, outs=outs,
                              plan=plan, tape=tape)

    def _live_leaves(self) -> list:
        return [t for tree in self._live().values() for t in tree_leaves(tree)]

    def _stage(self, b: int, n: int, **rows) -> None:
        """Write this rank's rows of a formed batch of ``n`` rows into
        bucket ``b``'s input buffers (padding rows zeroed) and set its
        mask. No host sync for device tensors."""
        inp = self._inputs[b]
        lo, width = self._rows(b)
        live = min(max(n - lo, 0), width)
        for name, v in rows.items():
            buf = inp[name]
            buf[:live].copy_(v[lo:lo + live])
            buf[live:].zero_()
        torch.lt(inp["rows"], n, out=inp["mask"])

    def route_stream(self, x, prefs=None, cats=None):
        """Route a formed batch of any size up to the ladder's top: pad to
        the smallest bucket >= n, run the bucket's fused route program
        (selection, masked ring enqueue, cost accounting, the device tick
        advanced), cut the padding off. Returns (a1 (n,), a2 (n,), tickets
        (n,)) as ``route_batch``; the live rows route bitwise as an
        unpadded batch would. ``cats`` (n,) are the refresh log's query
        categories (-1 = unknown). No host sync for device inputs."""
        if not self.streaming:
            raise RuntimeError(
                "route_stream needs RouterServiceConfig(buckets=...): the "
                "tick-batch service builds no bucket programs")
        dev = self.device
        x = as_f32(x, dev)
        n = x.shape[0]
        b = stream.bucket_for(n, self.buckets)
        if prefs is None:
            prog, pref_row = self._s_route[b], None
        else:
            if self._s_route_pref is None:
                raise ValueError(
                    f"policy '{self.policy.name}' has no act_pref path — "
                    f"per-request prefs need a preference-aware policy "
                    f"(the pooled FGTS/eps-greedy/LinUCB families)")
            pref_row = as_f32(prefs, dev)
            if tuple(pref_row.shape) != (n,):
                raise ValueError(
                    f"prefs shape {tuple(pref_row.shape)} != ({n},) — one "
                    f"scalar cost weight per query row")
            prog = self._s_route_pref[b]
        rows = dict(x=x)
        if pref_row is None:
            self._inputs[b]["pref"].zero_()
        else:
            rows["pref"] = pref_row
        if self.refresh_on:
            rows["cat"] = self._cat_row(cats, n)
        self._stage(b, n, **rows)
        draws = self._next_key()
        self.tick += 1                 # host mirror of the device clock
        # under a mesh: this rank's rows, then the whole batch's
        a1, a2, tickets = self._gather(prog(draws))
        self._fold_cost(a1, a2)
        self.n_routed += n
        return a1[:n].clone(), a2[:n].clone(), tickets[:n].clone()

    def feedback_stream(self, tickets, y):
        """Streaming twin of ``feedback_batch``: pad the delivered votes to
        the next bucket (padding masked out of the resolve) and run the
        bucket's fused program, resolve and masked fold (and the duel-log
        fold under refresh). Same delivery semantics as ``feedback_batch``.
        Returns the folded count: a 0-d device tensor on the masked path,
        no host sync; a host int on the compaction fallback (one sync)."""
        if not self.streaming:
            raise RuntimeError(
                "feedback_stream needs RouterServiceConfig(buckets=...): "
                "the tick-batch service builds no bucket programs")
        dev = self.device
        tickets = torch.as_tensor(tickets, device=dev).to(torch.int32)
        y = as_f32(y, dev)
        if tickets.shape != y.shape:
            raise ValueError(
                f"feedback_stream: tickets shape {tuple(tickets.shape)} != "
                f"votes shape {tuple(y.shape)} — one vote per delivered "
                f"ticket")
        n = tickets.shape[0]
        b = stream.bucket_for(n, self.buckets)
        self._stage(b, n, tickets=tickets, y=y)
        if self.mesh is not None:
            # the shard-local resolve, its rows gathered over the batch
            # ranks, then (masked fold) the fold program on the gathered
            # batch
            res = self._gather_resolved(self._s_resolve[b]())
            if self._s_feedback is not None:
                for dst, src in zip(self._gathered[b], res):
                    dst.copy_(src)
                (n_ok,) = self._s_feedback[b]()
                return n_ok.clone()
        elif self._s_feedback is not None:
            (n_ok,) = self._s_feedback[b]()
            return n_ok.clone()
        else:
            res = fq.ResolvedDuels(*(None if t is None else t.clone()
                                     for t in self._s_resolve[b]()))
        if self.refresh_on:
            self._commit(log=self._fold_log(self.duel_log, res,
                                            self._tick_dev))
        return self._fold_compact(res)

    def compiled_program_counts(self) -> dict:
        """Programs per streaming surface, ``len(buckets)`` each (on a card
        each is one captured CUDA graph), and ``captures``, the graphs
        captured so far: flat across membership changes, table swaps and
        restores, which write the live tensors in place. The tick-batch
        service runs eagerly and compiles nothing: {}."""
        if not self.streaming:
            return {}
        counts = {"s_route": len(self._s_route)}
        if self._s_route_pref is not None:
            counts["s_route_pref"] = len(self._s_route_pref)
        if self._s_feedback is not None:
            counts["s_feedback_log" if self.refresh_on
                   else "s_feedback"] = len(self._s_feedback)
        counts["s_resolve"] = len(self._s_resolve)
        counts["captures"] = self._n_captures
        return counts

    # -- the mesh: this rank's rows and the gathers over the batch ranks ----

    def _check_divides(self, n: int, what: str) -> None:
        if n % self._n_shards:
            raise ValueError(
                f"{what} size {n} does not divide over the mesh's "
                f"{self._n_shards} batch shards — pad or rebatch")

    def _rows(self, b: int) -> tuple[int, int]:
        """(first row, row count) of this rank's share of a b-row batch."""
        rows = b // self._n_shards
        return self._shard * rows, rows

    def _act_draws(self, draws, rows: int, total: int, lo: int):
        """The act's draw source for this rank's rows [lo, lo + rows) of a
        ``total``-row batch."""
        return ShardDraws(draws, rows, total, lo) if self._cut_draws \
            else draws

    def _gather(self, cols) -> list:
        """Per-row columns of this rank's rows -> the whole batch's, in
        row order: one all-gather over the batch ranks of their 4-byte
        words (identity without a mesh)."""
        if self.mesh is None:
            return list(cols)
        packed = rr.gather_rows(rr.pack_rows(cols), self._group,
                                self._n_shards)
        return rr.unpack_rows(packed, cols)

    def _gather_col(self, col: torch.Tensor) -> torch.Tensor:
        return self._gather([col])[0]

    def _fold_cost(self, a1: torch.Tensor, a2: torch.Tensor) -> None:
        """Under a mesh with the autopilot: its realized-cost EMA over the
        whole batch's pairs, once they are gathered (each rank's act saw
        only its own rows)."""
        if self.mesh is not None and self.cfg.autopilot is not None:
            self._commit(state=ap.fold_cost(self.state, a1, a2,
                                            self.cfg.autopilot))

    def _gather_resolved(self, res: fq.ResolvedDuels) -> fq.ResolvedDuels:
        """A resolved batch of this rank's rows -> the whole batch's."""
        return fq.ResolvedDuels(*self._gather(list(res)))

    def _sum_shares(self, res: fq.ResolvedDuels) -> fq.ResolvedDuels:
        """The tick-batch ring's resolved batch from the ranks' shares:
        each row is held by one rank and zeros by the others, so one sum
        of their words over the batch ranks is the unsharded batch (the
        votes ``y`` are every rank's already)."""
        if self.mesh is None:
            return res
        cols = [res.x, res.a1, res.a2, res.age, res.ok, res.pref, res.prop,
                res.cat]
        x, a1, a2, age, ok, pref, prop, cat = rr.unpack_rows(
            rr.sum_rows(rr.pack_rows(cols), self._group), cols)
        return fq.ResolvedDuels(x=x, a1=a1, a2=a2, y=res.y, age=age, ok=ok,
                                pref=pref, prop=prop, cat=cat)

    def _sum_count(self, n: torch.Tensor) -> int:
        """A count over the batch ranks' shares on the host. Syncs: one
        transfer (after one all-reduce under a mesh)."""
        n = n.to(torch.int32).reshape(1)
        if self.mesh is not None:
            n = rr.sum_rows(n.clone(), self._group)
        n = n.cpu()
        return int(n[0])

    def _clock(self) -> torch.Tensor:
        """The service tick as a wrapping int32 device scalar, made by a
        fill on the device (no host copy, so no sync)."""
        return fq.as_i32(self.tick, self.device)

    def _next_key(self):
        self._draws, k = self._draws.split(2)
        return k

    def embed(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encode(self.enc_params, tokens, mask, self.enc_cfg)

    def route_batch(self, x, prefs=None, cats=None):
        """x: (B, d) query features. Returns (a1 (B,), a2 (B,), tickets
        (B,)).

        One policy act per batch (for FGTS.CDB the SGLD refresh amortized
        over the whole batch, then every pair in one ``dueling_select``
        launch). Every issued duel enters the pending ring; redeem its
        ticket in ``feedback_batch`` whenever the vote lands.

        ``prefs`` (B,) float are per-request cost weights: row i is scored
        under the extra tilt ``prefs[i] * cost_k`` and the duel records its
        pref, so the fold conditions on it. ``cats`` (B,) int are the
        query categories the refresh log records (-1 = unknown); with
        refresh off they are ignored. In streaming mode this delegates to
        ``route_stream``. No host sync.

        Under a mesh every rank passes the whole batch (B must divide over
        the batch shards), acts on its own rows and gets the whole batch's
        pairs and tickets back, the unsharded service's (one all-gather of
        the pairs over the batch ranks)."""
        if self.streaming:
            return self.route_stream(x, prefs=prefs, cats=cats)
        dev = self.device
        x = as_f32(x, dev)
        b = x.shape[0]
        self._check_divides(b, "route_batch")
        lo, rows = self._rows(b)
        xl = x[lo:lo + rows]
        draws = self._act_draws(self._next_key(), rows, b, lo)
        if prefs is None:
            self.state, a1, a2 = self.policy.act(draws, self.state, xl)
            pref_row = torch.zeros((b,), dtype=torch.float32, device=dev)
        else:
            if self._act_pref is None:
                raise ValueError(
                    f"policy '{self.policy.name}' has no act_pref path — "
                    f"per-request prefs need a preference-aware policy "
                    f"(the pooled FGTS/eps-greedy/LinUCB families)")
            pref_row = as_f32(prefs, dev)
            if tuple(pref_row.shape) != (b,):
                raise ValueError(
                    f"prefs shape {tuple(pref_row.shape)} != ({b},) — one "
                    f"scalar cost weight per query row")
            self.state, a1, a2 = self._act_pref(draws, self.state, xl,
                                                pref_row[lo:lo + rows])
        # clock first, then issue at the new tick: feedback redeemed before
        # the next routing round reports age 0
        self.tick += 1
        prop = cat_row = None
        if self.refresh_on:
            # the act-time propensity and the category ride the ring with
            # the duel, into the log when it resolves
            a1, a2, prop = self._gather(
                [a1, a2, self._prop(self.state, xl, a1, a2)])
            cat_row = self._cat_row(cats, b)
        else:
            a1, a2 = self._gather([a1, a2])
        self._fold_cost(a1, a2)
        self.pending, tickets = fq.enqueue(
            self.pending, x, a1, a2, self._clock(), pref_row, prop, cat_row,
            share=self._share)
        self.n_routed += b
        self._commit(duel_cost=self._duel_cost + self.spend(a1)
                     + self.spend(a2))
        return a1, a2, tickets

    def feedback_batch(self, tickets, y):
        """Resolve a batch of votes by ticket and fold them in.

        Out-of-order, partial and duplicate deliveries are all fine: one
        gather and one clearing scatter against the ring (duplicates fold
        once, first wins); stale tickets (resolved, expired, overwritten)
        are dropped. Policies with a masked update fold the whole resolved
        batch, rejected rows dropped inside the scatter, with no host sync:
        the return value is then the folded count as a 0-d device tensor.
        Policies without one take ``_fold_compact`` (a host sync, host
        int). With refresh the resolved duels also fold into the duel log.
        In streaming mode this delegates to ``feedback_stream``.

        Under a mesh every rank passes the whole batch and resolves it
        against its share of the ring; one all-reduce over the batch ranks
        assembles the unsharded resolved batch, which every rank folds."""
        if self.streaming:
            return self.feedback_stream(tickets, y)
        dev = self.device
        tickets = torch.as_tensor(tickets, device=dev).to(torch.int32)
        y = as_f32(y, dev)
        if tickets.shape != y.shape:
            raise ValueError(
                f"feedback_batch: tickets shape {tuple(tickets.shape)} != "
                f"votes shape {tuple(y.shape)} — one vote per delivered "
                f"ticket")
        self._check_divides(tickets.shape[0], "feedback_batch")
        self.pending, res = fq.resolve(self.pending, tickets, y,
                                       self._clock(),
                                       max_age=self.cfg.feedback_expiry,
                                       share=self._share)
        res = self._sum_shares(res)
        if self.refresh_on:
            self.duel_log = self._fold_log(self.duel_log, res, self._clock())
        n_ok = torch.sum(res.ok, dtype=torch.int32)    # lazy device count
        if self._update_pref is not None and res.pref is not None:
            # each duel updates under the pref it was served with
            self.state = self._update_pref(
                self.state, res.x, res.a1, res.a2, res.y, res.age, res.ok,
                res.pref)
            self._commit(n_folded=self._n_folded + n_ok)
            return n_ok
        if self._update_masked is not None:
            self.state = self._update_masked(
                self.state, res.x, res.a1, res.a2, res.y, res.age, res.ok)
            self._commit(n_folded=self._n_folded + n_ok)
            return n_ok
        return self._fold_compact(res)

    @staticmethod
    def _fold_log(log: dl.DuelLog, res: fq.ResolvedDuels, now) -> dl.DuelLog:
        """Append the validated rows of a resolved batch to the duel log."""
        return dl.fold(log, res.x, res.a1, res.a2, res.y, res.pref, res.prop,
                       res.cat, now - res.age, res.ok)

    def _cat_row(self, cats, b: int) -> torch.Tensor:
        if cats is None:
            return torch.full((b,), -1, dtype=torch.int32, device=self.device)
        return torch.as_tensor(cats, device=self.device).to(torch.int32)

    def _fold_compact(self, res: fq.ResolvedDuels) -> int:
        """Compaction fold for policies without a masked update. Shaping
        the compacted batch needs the survivor count on the host: this
        syncs, with one transfer of ``res.ok``."""
        ok = res.ok.cpu()
        keep = torch.nonzero(ok)[:, 0]
        n_host = keep.shape[0]
        self._commit(n_folded=self._n_folded + n_host)
        if n_host == 0:
            return 0
        if n_host == ok.shape[0]:
            x, a1, a2, yv, age = res.x, res.a1, res.a2, res.y, res.age
        else:
            keep = keep.to(res.x.device)
            x, a1, a2, yv, age = (res.x[keep], res.a1[keep], res.a2[keep],
                                  res.y[keep], res.age[keep])
        if self.policy.update_delayed is not None:
            state = self.policy.update_delayed(self.state, x, a1, a2, yv, age)
        else:
            state = self.policy.update(self.state, x, a1, a2, yv)
        self._commit(state=state)
        return n_host

    def feedback_direct(self, x, a1, a2, y, tickets=None):
        """Fold a feedback batch in directly, bypassing the ring (callers
        that kept the duel data, e.g. offline replay). Pass the batch's
        ``tickets`` to also clear its ring slots (in streaming mode through
        the bucket's resolve program). No host sync. Under a mesh every
        rank passes the whole batch and folds it."""
        dev = self.device
        y = as_f32(y, dev)
        self._check_divides(y.shape[0], "feedback_direct")
        if tickets is not None:
            t = torch.as_tensor(tickets, device=dev).to(torch.int32)
            if self.streaming:
                n = t.shape[0]
                b = stream.bucket_for(n, self.buckets)
                self._stage(b, n, tickets=t, y=y)
                self._s_resolve[b]()
            else:
                self.pending, _ = fq.resolve(
                    self.pending, t, y, self._clock(),
                    max_age=self.cfg.feedback_expiry, share=self._share)
        self._commit(state=self.policy.update(
            self.state, as_f32(x, dev), torch.as_tensor(a1, device=dev),
            torch.as_tensor(a2, device=dev), y))

    def pending_count(self) -> int:
        """In-flight duels (issued, unresolved, unexpired), over every
        share of the ring. Syncs: one transfer of the count."""
        return self._sum_count(fq.pending_count(self.pending))

    def expire_pending(self) -> int:
        """Age out pending duels past ``cfg.feedback_expiry`` (no-op when
        unset); returns the number dropped. Syncs: one transfer of the
        count."""
        if self.cfg.feedback_expiry is None:
            return 0
        pending, dropped = fq.expire(self.pending, self._clock(),
                                     self.cfg.feedback_expiry)
        self._commit(pending=pending)
        return self._sum_count(dropped)

    def spend(self, arms, tokens_out: int = 1000) -> torch.Tensor:
        """Cost of a batch of dispatches, a 0-d device tensor (no sync)."""
        return torch.sum(self.costs[torch.as_tensor(arms).long()]) * (
            tokens_out / 1000.0)

    def service_stats(self) -> dict:
        """The traffic accumulators on the host: routed and folded duel
        counts, realized duel cost (both sides of every issued pair), the
        in-flight count. Syncs: one transfer of each accumulator. A
        streaming mesh service's ranks each add their own rows' costs:
        their sum is taken here (one all-reduce)."""
        n_folded = self._n_folded.cpu()
        duel_cost = self._duel_cost.reshape(1).clone()
        if self.streaming and self.mesh is not None:
            duel_cost = rr.sum_rows(duel_cost, self._group)
        duel_cost = duel_cost.cpu()
        out = {"tick": self.tick, "n_routed": self.n_routed,
               "n_folded": int(n_folded), "duel_cost": float(duel_cost[0]),
               "pending": self.pending_count()}
        if self.refresh_on:
            logged = self.duel_log.count.cpu()
            out["duels_logged"] = int(logged)
            out["table_swaps"] = self._table_swaps
        return out

    # -- online representation refresh (cfg.refresh) -------------------------

    def _require_refresh(self, what: str):
        if not self.refresh_on:
            raise RuntimeError(
                f"{what} needs the refresh loop: construct the service "
                f"with RouterServiceConfig(refresh=RefreshConfig(...))")

    def _log_count(self) -> int:
        """The duel log's write head on the host. Syncs: one transfer."""
        count = self.duel_log.count.cpu()
        return int(count)

    def export_log(self) -> dict:
        """Host export of the logged duels, the input of the offline
        refresh job (``refresh.refresh_table``). Syncs: one transfer of the
        whole log."""
        self._require_refresh("export_log")
        return dl.export(self.duel_log)

    def refresh_due(self) -> bool:
        """True once ``cfg.refresh.every`` new duels were folded into the
        log since the last ``apply_table`` (always False when every=0).
        Syncs: one transfer of the log's count."""
        if not self.refresh_on or self.cfg.refresh.every <= 0:
            return False
        return self._log_count() - self._count_at_swap >= \
            self.cfg.refresh.every

    def apply_table(self, table, replay=None) -> None:
        """Swap in a whole (K_max, d) embedding table (a row write of the
        pool's table and a generation bump; costs and membership stay), in
        place in streaming mode, so no program is captured again. The
        posterior is kept unless ``replay=(x, a1, a2, y)`` re-seeds it
        through ``seed_replay``. With refresh, re-anchors the cadence at
        the log's count (syncs: one transfer)."""
        self._require_dynamic("apply_table")
        self._commit(state=self._table_swap(self.state,
                                            as_f32(table, self.device)))
        if self.refresh_on:
            self._count_at_swap = self._log_count()
            self._table_swaps += 1
        if replay is not None:
            self.seed_replay(*replay)

    # -- dynamic pool membership (requires cfg.k_max) ------------------------

    def _require_dynamic(self, what: str):
        if not self.dynamic:
            raise RuntimeError(
                f"{what} needs a dynamic pool: construct the service with "
                f"RouterServiceConfig(k_max=...) (and fgts.n_models == "
                f"k_max) to reserve hot-swap capacity")

    def model_pool(self) -> mp.ModelPool:
        """The live arm registry (embeddings, costs, active mask)."""
        self._require_dynamic("model_pool")
        return mp.get_pool(self.state)

    def active_mask(self) -> np.ndarray:
        """The pool's active mask on the host. Syncs: one transfer."""
        return self.model_pool().active.to("cpu", copy=True).numpy()

    def controller_state(self) -> "ap.ControllerState":
        """The live autopilot controller state (device tensors)."""
        if self.cfg.autopilot is None:
            raise RuntimeError(
                "no autopilot: construct the service with "
                "RouterServiceConfig(autopilot=AutopilotConfig(...))")
        return self.state.ctrl

    def autopilot_status(self) -> dict:
        """Host snapshot of the control loops: governor lambda, realized
        cost EMA, candidate slots and their duel tallies, dominance
        streaks. Syncs: one transfer of each controller field (a copy on
        the CPU too: a streaming service writes its live tensors in
        place)."""
        ctrl = type(self.controller_state())(
            *(t.to("cpu", copy=True) for t in self.controller_state()))
        return {
            "lambda": float(ctrl.lam),
            "cost_ema": float(ctrl.cost_ema),
            "tick": int(ctrl.tick),
            "active": self.active_mask(),
            "candidate": ctrl.candidate.numpy(),
            "cand_wins": ctrl.cand_wins.numpy(),
            "cand_duels": ctrl.cand_duels.numpy(),
            "dominated_ticks": ctrl.dominated_ticks.numpy(),
        }

    def add_model(self, entry: PoolEntry, replay=None) -> int:
        """Hot-add a model into a free slot; returns the slot.

        ``entry.embedding`` should come from ``ccft.model_embeddings`` on
        the model's offline skill scores, and ``replay=(x, a1, a2, y)``
        (e.g. ``model_pool.warm_start_duels``) pre-shapes the posterior
        through ``seed_replay`` before the arm takes traffic. Under an
        autopilot the arm enters as an A/B candidate at the next act.

        Never-used slots come first: a retired arm's slot would hand the
        newcomer that arm's replay history. When only retired slots remain
        the first is reused with a warning. Syncs: one transfer of the
        active mask."""
        self._require_dynamic("add_model")
        mask = self.active_mask()
        if mask.all():
            raise RuntimeError(
                f"pool at capacity k_max={self.cfg.k_max}: retire an arm "
                f"first (or rebuild with more headroom)")
        free = [i for i in range(self.cfg.k_max) if not mask[i]]
        virgin = [i for i in free if not self._ever_used[i]]
        if virgin:
            slot = virgin[0]
        else:
            slot = free[0]                   # first retired slot
            warnings.warn(
                f"add_model: no never-used slot left — '{entry.name}' "
                f"reuses retired slot {slot} and inherits its replay "
                f"history / per-slot stats; grow k_max (or use swap_model "
                f"if this is a successor model)", stacklevel=2)
        self._set_slot(slot, entry)
        if replay is not None:
            self.seed_replay(*replay)
        return slot

    def retire_model(self, k: int) -> None:
        """Take arm ``k`` out of rotation (a mask flip). Its row and replay
        history stay, so in-flight duels that name it still resolve.
        Syncs: one transfer of the active mask."""
        self._require_dynamic("retire_model")
        mask = self.active_mask()
        if not mask[k]:
            raise ValueError(f"arm {k} is not active")
        if mask.sum() <= 1:
            raise RuntimeError("cannot retire the last active arm")
        self._commit(state=self._pool_retire(self.state, k))
        self._sync_costs()

    def swap_model(self, k: int, entry: PoolEntry, replay=None) -> None:
        """Replace slot ``k``'s model in place (a retrained successor):
        row write and activate, replay history inherited."""
        self._require_dynamic("swap_model")
        if not 0 <= k < self.cfg.k_max:
            raise ValueError(f"slot {k} outside capacity {self.cfg.k_max}")
        self._set_slot(k, entry)
        if replay is not None:
            self.seed_replay(*replay)

    def _set_slot(self, slot: int, entry: PoolEntry) -> None:
        self._commit(state=self._pool_set(
            self.state, as_f32(entry.embedding, self.device),
            as_f32(entry.cost_per_1k_tokens, self.device), slot))
        self.pool[slot] = entry
        self._ever_used[slot] = True
        self._sync_costs()

    def _sync_costs(self) -> None:
        """Re-read the cost mirror from the pool (and, in streaming mode,
        the route programs' cost buffer, in place)."""
        self.costs = mp.get_pool(self.state).costs.clone()
        if self.streaming:
            self._costs_dev.copy_(self.costs)

    def seed_replay(self, x, a1, a2, y) -> int:
        """Offline -> online seeding: fold a batch of historical duels into
        the posterior (no ring, no tickets), through the policy's masked
        update when it has one. Returns the number of duels. No host sync
        for device inputs."""
        self._require_dynamic("seed_replay")
        dev = self.device
        x = as_f32(x, dev)
        a1 = torch.as_tensor(a1, device=dev).to(torch.int32)
        a2 = torch.as_tensor(a2, device=dev).to(torch.int32)
        y = as_f32(y, dev)
        b = x.shape[0]
        if self._update_masked is not None:
            age = torch.zeros((b,), dtype=torch.int32, device=dev)
            ok = torch.ones((b,), dtype=torch.bool, device=dev)
            self._commit(state=self._update_seed(self.state, x, a1, a2, y,
                                                 age, ok))
        else:
            self._commit(state=self._update_seed(self.state, x, a1, a2, y))
        return b

    # -- persistence (posterior, ring and key survive restarts) --------------

    def _ring_whole(self) -> fq.PendingDuels:
        """The whole pending ring in the unsharded layout: under a mesh the
        ranks' shares gathered over the batch ranks (the streaming ring's
        per-shard counters too)."""
        q = self.pending
        if self.mesh is None:
            return q
        cols = [q.x, q.a1, q.a2, q.ticket, q.issued_at, q.valid, q.pref,
                q.prop, q.cat]
        x, a1, a2, ticket, issued_at, valid, pref, prop, cat = \
            self._gather(cols)
        nt = self._gather_col(q.next_ticket) if self.streaming \
            else q.next_ticket
        return fq.PendingDuels(x=x, a1=a1, a2=a2, ticket=ticket,
                               issued_at=issued_at, valid=valid,
                               next_ticket=nt, pref=pref, prop=prop, cat=cat)

    def _ring_share(self, q: fq.PendingDuels) -> fq.PendingDuels:
        """This rank's share of a whole ring (``_ring_whole``'s inverse)."""
        if self.mesh is None:
            return q
        lo, n = self._share[0], self.pending.x.shape[0]
        nt = q.next_ticket
        if self.streaming:
            nt = nt[self._shard:self._shard + 1]
        return fq.PendingDuels(*(t[lo:lo + n] for t in q[:6]), nt,
                               *(t[lo:lo + n] for t in q[7:]))

    def _payload(self) -> dict:
        payload = {"state": self.state,
                   "key": self._draws.key_leaf(),
                   "pending": self._ring_whole(),
                   "tick": torch.tensor(self.tick, dtype=torch.int32),
                   "n_routed": torch.tensor(self.n_routed,
                                            dtype=torch.int32)}
        if self.dynamic:
            # slot-usage history, so add_model's virgin-slot preference
            # survives a restart
            payload["ever_used"] = torch.tensor(self._ever_used,
                                                dtype=torch.bool)
        if self.refresh_on:
            # the refresh loop's evidence restarts with the posterior
            payload["duel_log"] = self.duel_log
        return payload

    def save(self, path: str, step: int | None = None) -> str:
        """Checkpoint the state, the draw source's key, the pending ring,
        the clock and the routed count (and the slot history) in the
        reference's msgpack layout. Under a mesh every rank calls it: the
        ring's shares are gathered into the unsharded layout, the world's
        rank 0 writes, and every rank returns once the file is there."""
        from repro_torch.checkpoint import save_checkpoint
        step = step if step is not None else self.n_routed
        payload = self._payload()
        if self.mesh is None:
            return save_checkpoint(path, step, payload)
        if dist.get_rank() == 0:
            save_checkpoint(path, step, payload)
        dist.barrier()
        return os.path.join(path, f"ckpt_{step:08d}.msgpack")

    def restore(self, path: str, step: int | None = None) -> int:
        """Load a checkpoint of this service's structure (the reference's
        or the port's, sharded or not); returns its step. Under a mesh
        every rank calls it and keeps its share of the ring. Syncs: the
        clock and the slot history come back to the host."""
        from repro_torch.checkpoint import latest_step, restore_checkpoint
        step = latest_step(path) if step is None else step
        try:
            payload = restore_checkpoint(path, step, self._payload())
        except ValueError as e:
            raise RuntimeError(
                f"incompatible router checkpoint at {path} step {step}: "
                f"structure/shape mismatch with policy "
                f"'{self.policy.name}' — {e}") from e
        self._draws = self._draws.from_leaf(payload["key"])
        self.tick = int(payload["tick"])
        self.n_routed = int(payload["n_routed"])
        restored = dict(state=payload["state"],
                        pending=self._ring_share(payload["pending"]))
        if self.streaming:
            # re-seat the device clock behind the restored host tick
            restored["tick"] = fq.as_i32(self.tick, self.device)
        if self.refresh_on:
            restored["log"] = payload["duel_log"]
        self._commit(**restored)
        if self.dynamic:
            # the pool travels with the state: re-sync the cost mirror
            # (entry names are host bookkeeping, not checkpointed)
            self._sync_costs()
            self._ever_used = [bool(v) for v in payload["ever_used"]]
        if self.refresh_on:
            # the cadence marker is process-local: re-anchor it at the
            # restored log head, so a restart fires no spurious refresh
            self._count_at_swap = self._log_count()
        return step


# _commit's names of the live tensors, as attributes of the service
_LIVE_ATTR = dict(state="state", pending="pending", log="duel_log",
                  tick="_tick_dev", n_folded="_n_folded",
                  duel_cost="_duel_cost")


def _cloned(tree):
    """``tree`` with every tensor leaf cloned (distinct memory)."""
    return tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)])


class _StreamProgram:
    """One fused streaming program at one bucket. ``program(draws)`` runs
    it: eagerly (``graph`` None), or by filling the draw plan's buffers
    from the act's source ``draws`` and replaying the captured graph,
    whose outputs are the tensors ``outs`` the capture returned (the
    caller copies what it keeps: the next replay overwrites them)."""

    def __init__(self, body, rows: int, top: int, *, graph=None, outs=None,
                 plan=None, tape=None):
        self.body, self.rows, self.top = body, rows, top
        self.graph, self.outs, self.plan, self.tape = graph, outs, plan, tape

    def __call__(self, draws=None):
        if self.graph is None:
            return self.body(None if draws is None
                             else BucketDraws(draws, self.rows, self.top))
        if self.plan is not None:
            self.plan.fill(draws, self.tape)
        self.graph.replay()
        return self.outs
