"""Batched routing service: the production wrapper around a RoutingPolicy
(counterpart of ``repro/serving/router_service.py``, tick-batch path on
one device).

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

Host syncs: ``route_batch``, the masked and pref folds of
``feedback_batch``, ``feedback_direct``, ``spend`` and ``seed_replay``
never read the card (host scalars enter as fills, counts stay 0-d device
tensors). The control-plane reads (``pending_count``, ``expire_pending``,
``service_stats``, ``active_mask``, ``autopilot_status``, ``add_model``,
``restore`` and the compaction fold of policies without a masked update)
each make one explicit ``.cpu()`` transfer of the tensors they need, and
say so.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import autopilot as ap
from repro_torch.core import fgts
from repro_torch.core import model_pool as mp
from repro_torch.core.draws import KeyedDraws
from repro_torch.core.policy import (RoutingPolicy, fgts_policy,
                                     staleness_weight, with_staleness)
from repro_torch.data.pool import PoolEntry
from repro_torch.device import as_f32, resolve_device
from repro_torch.encoder.model import EncoderConfig, encode

from . import feedback_queue as fq


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
    # device). The reference turns it off only under a mesh; False comes
    # with the mesh paths.
    use_kernel: Optional[bool] = None
    # Mesh act mechanism of the reference; the port has no mesh yet.
    act_shard_map: Optional[bool] = None
    # -- async feedback -----------------------------------------------------
    feedback_capacity: int = 1024  # max in-flight duels (ring: oldest expire)
    feedback_expiry: Optional[int] = None   # max age in ticks; None = never
    stale_half_life: Optional[float] = None  # age-discount stale votes
    # -- streaming serving (ROADMAP Queue 1 item 2, streaming part) ---------
    buckets: Optional[tuple] = None
    # -- online representation refresh (ROADMAP Queue 1 item 3) -------------
    refresh: Optional[object] = None
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
    programs on one device.

    ``device`` None means the card. ``draws`` is the service's draw source
    (``core.draws``), split once per act as the reference splits its key;
    None means ``KeyedDraws(cfg.seed)`` in device mode. It must checkpoint
    (``key_leaf`` / ``from_leaf``) for ``save`` / ``restore``."""

    def __init__(self, pool: list[PoolEntry], enc_params,
                 enc_cfg: EncoderConfig, cfg: RouterServiceConfig, *,
                 mesh=None, device=None, draws=None):
        if mesh is not None:
            raise NotImplementedError(
                "RouterService(mesh=...): the mesh paths come with "
                "multi-device serving (ROADMAP Queue 1 item 5)")
        if cfg.buckets is not None:
            raise NotImplementedError(
                "RouterServiceConfig(buckets=...): streaming serving "
                "(route_stream / feedback_stream on one CUDA graph per "
                "bucket) comes with the streaming part of ROADMAP Queue 1 "
                "item 2")
        if cfg.refresh is not None:
            raise NotImplementedError(
                "RouterServiceConfig(refresh=...): the representation "
                "refresh loop comes with ROADMAP Queue 1 item 3")
        if cfg.use_kernel is False:
            raise NotImplementedError(
                "RouterServiceConfig(use_kernel=False): the plain selection "
                "serves the mesh paths, which come with multi-device "
                "serving (ROADMAP Queue 1 item 5)")
        self.device = resolve_device(device)
        dev = self.device
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
                                      cost_tilt=cfg.cost_tilt)
        if cfg.autopilot is not None:
            if not self.dynamic:
                raise ValueError(
                    "autopilot manages pool membership: construct the "
                    "service with RouterServiceConfig(k_max=...) so the "
                    "policy carries a ModelPool it can retire into")
            self.policy = ap.wrap(self.policy, cfg.autopilot)
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
        # capacity: round the configured one up
        self.pending = fq.init_pending(fq.next_pow2(cfg.feedback_capacity),
                                       self.a_emb.shape[1], device=dev)
        self.tick = 0                  # route_batch calls (the clock)
        self.n_routed = 0
        # on-device traffic accumulators: the hot path only adds to them;
        # service_stats() reads them. Process-local: not checkpointed.
        self._n_folded = torch.zeros((), dtype=torch.int32, device=dev)
        self._duel_cost = torch.zeros((), dtype=torch.float32, device=dev)
        self._build_programs()

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
        pref, so the fold conditions on it. ``cats`` are the refresh log's
        query categories; with refresh off (always, until ROADMAP Queue 1
        item 3) they are ignored. No host sync."""
        dev = self.device
        x = as_f32(x, dev)
        b = x.shape[0]
        if prefs is None:
            key = self._next_key()
            self.state, a1, a2 = self.policy.act(key, self.state, x)
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
            self.state, a1, a2 = self._act_pref(self._next_key(),
                                                self.state, x, pref_row)
        # clock first, then issue at the new tick: feedback redeemed before
        # the next routing round reports age 0
        self.tick += 1
        self.pending, tickets = fq.enqueue(
            self.pending, x, a1, a2, self._clock(), pref_row)
        self.n_routed += b
        self._duel_cost = self._duel_cost + self.spend(a1) + self.spend(a2)
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
        int)."""
        dev = self.device
        tickets = torch.as_tensor(tickets, device=dev).to(torch.int32)
        y = as_f32(y, dev)
        if tickets.shape != y.shape:
            raise ValueError(
                f"feedback_batch: tickets shape {tuple(tickets.shape)} != "
                f"votes shape {tuple(y.shape)} — one vote per delivered "
                f"ticket")
        self.pending, res = fq.resolve(self.pending, tickets, y,
                                       self._clock(),
                                       max_age=self.cfg.feedback_expiry)
        n_ok = torch.sum(res.ok, dtype=torch.int32)    # lazy device count
        if self._update_pref is not None and res.pref is not None:
            # each duel updates under the pref it was served with
            self.state = self._update_pref(
                self.state, res.x, res.a1, res.a2, res.y, res.age, res.ok,
                res.pref)
            self._n_folded = self._n_folded + n_ok
            return n_ok
        if self._update_masked is not None:
            self.state = self._update_masked(
                self.state, res.x, res.a1, res.a2, res.y, res.age, res.ok)
            self._n_folded = self._n_folded + n_ok
            return n_ok
        return self._fold_compact(res)

    def _fold_compact(self, res: fq.ResolvedDuels) -> int:
        """Compaction fold for policies without a masked update. Shaping
        the compacted batch needs the survivor count on the host: this
        syncs, with one transfer of ``res.ok``."""
        ok = res.ok.cpu()
        keep = torch.nonzero(ok)[:, 0]
        n_host = keep.shape[0]
        self._n_folded = self._n_folded + n_host
        if n_host == 0:
            return 0
        if n_host == ok.shape[0]:
            x, a1, a2, yv, age = res.x, res.a1, res.a2, res.y, res.age
        else:
            keep = keep.to(res.x.device)
            x, a1, a2, yv, age = (res.x[keep], res.a1[keep], res.a2[keep],
                                  res.y[keep], res.age[keep])
        if self.policy.update_delayed is not None:
            self.state = self.policy.update_delayed(self.state, x, a1, a2,
                                                    yv, age)
        else:
            self.state = self.policy.update(self.state, x, a1, a2, yv)
        return n_host

    def feedback_direct(self, x, a1, a2, y, tickets=None):
        """Fold a feedback batch in directly, bypassing the ring (callers
        that kept the duel data, e.g. offline replay). Pass the batch's
        ``tickets`` to also clear its ring slots. No host sync."""
        dev = self.device
        y = as_f32(y, dev)
        if tickets is not None:
            t = torch.as_tensor(tickets, device=dev).to(torch.int32)
            self.pending, _ = fq.resolve(self.pending, t, y, self._clock(),
                                         max_age=self.cfg.feedback_expiry)
        self.state = self.policy.update(self.state, as_f32(x, dev),
                                  torch.as_tensor(a1, device=dev),
                                  torch.as_tensor(a2, device=dev), y)

    def pending_count(self) -> int:
        """In-flight duels (issued, unresolved, unexpired). Syncs: one
        transfer of the count."""
        n = fq.pending_count(self.pending).cpu()
        return int(n)

    def expire_pending(self) -> int:
        """Age out pending duels past ``cfg.feedback_expiry`` (no-op when
        unset); returns the number dropped. Syncs: one transfer of the
        count."""
        if self.cfg.feedback_expiry is None:
            return 0
        self.pending, dropped = fq.expire(
            self.pending, self._clock(),
            self.cfg.feedback_expiry)
        dropped = dropped.cpu()
        return int(dropped)

    def spend(self, arms, tokens_out: int = 1000) -> torch.Tensor:
        """Cost of a batch of dispatches, a 0-d device tensor (no sync)."""
        return torch.sum(self.costs[torch.as_tensor(arms).long()]) * (
            tokens_out / 1000.0)

    def service_stats(self) -> dict:
        """The traffic accumulators on the host: routed and folded duel
        counts, realized duel cost (both sides of every issued pair), the
        in-flight count. Syncs: one transfer of each accumulator."""
        n_folded = self._n_folded.cpu()
        duel_cost = self._duel_cost.cpu()
        pending = fq.pending_count(self.pending).cpu()
        return {"tick": self.tick, "n_routed": self.n_routed,
                "n_folded": int(n_folded), "duel_cost": float(duel_cost),
                "pending": int(pending)}

    def apply_table(self, table, replay=None) -> None:
        """Swap in a whole (K_max, d) embedding table (a row write of the
        pool's table and a generation bump; costs and membership stay).
        The posterior is kept unless ``replay=(x, a1, a2, y)`` re-seeds it
        through ``seed_replay``."""
        self._require_dynamic("apply_table")
        self.state = self._table_swap(self.state, as_f32(table, self.device))
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
        return self.model_pool().active.cpu().numpy()

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
        streaks. Syncs: one transfer of each controller field."""
        ctrl = type(self.controller_state())(
            *(t.cpu() for t in self.controller_state()))
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
        self.state = self._pool_retire(self.state, k)
        self.costs = mp.get_pool(self.state).costs.clone()

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
        self.state = self._pool_set(
            self.state, as_f32(entry.embedding, self.device),
            as_f32(entry.cost_per_1k_tokens, self.device), slot)
        self.pool[slot] = entry
        self._ever_used[slot] = True
        self.costs = mp.get_pool(self.state).costs.clone()

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
            self.state = self._update_seed(self.state, x, a1, a2, y, age, ok)
        else:
            self.state = self._update_seed(self.state, x, a1, a2, y)
        return b

    # -- persistence (posterior, ring and key survive restarts) --------------

    def _payload(self) -> dict:
        payload = {"state": self.state,
                   "key": self._draws.key_leaf(),
                   "pending": self.pending,
                   "tick": torch.tensor(self.tick, dtype=torch.int32),
                   "n_routed": torch.tensor(self.n_routed,
                                            dtype=torch.int32)}
        if self.dynamic:
            # slot-usage history, so add_model's virgin-slot preference
            # survives a restart
            payload["ever_used"] = torch.tensor(self._ever_used,
                                                dtype=torch.bool)
        return payload

    def save(self, path: str, step: int | None = None) -> str:
        """Checkpoint the state, the draw source's key, the pending ring,
        the clock and the routed count (and the slot history) in the
        reference's msgpack layout."""
        from repro_torch.checkpoint import save_checkpoint
        return save_checkpoint(path, step if step is not None
                               else self.n_routed, self._payload())

    def restore(self, path: str, step: int | None = None) -> int:
        """Load a checkpoint of this service's structure (the reference's
        or the port's); returns its step. Syncs: the clock and the slot
        history come back to the host."""
        from repro_torch.checkpoint import latest_step, restore_checkpoint
        step = latest_step(path) if step is None else step
        try:
            payload = restore_checkpoint(path, step, self._payload())
        except ValueError as e:
            raise RuntimeError(
                f"incompatible router checkpoint at {path} step {step}: "
                f"structure/shape mismatch with policy "
                f"'{self.policy.name}' — {e}") from e
        self.state = payload["state"]
        self._draws = self._draws.from_leaf(payload["key"])
        self.pending = payload["pending"]
        self.tick = int(payload["tick"])
        self.n_routed = int(payload["n_routed"])
        if self.dynamic:
            # the pool travels with the state: re-sync the cost mirror
            # (entry names are host bookkeeping, not checkpointed)
            self.costs = mp.get_pool(self.state).costs.clone()
            self._ever_used = [bool(v) for v in payload["ever_used"]]
        return step
