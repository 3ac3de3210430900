"""Dynamic model pools: arms that arrive, retire and swap (counterpart of
``repro/core/model_pool.py``).

    a_emb       (K_max, d)  padded embedding table
    costs       (K_max,)    per-arm serving cost
    active      (K_max,)    bool arm mask: which arms may be duelled now
    generation  ()          int32, bumped on every add / retire / swap

Pool-backed policies carry the pool in their state (``PooledState``), so a
membership change is a data update of fixed shapes. The functions here are
functional: they return a new pool and leave their input untouched.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import as_f32, resolve_device

from .btl import sample_preference
from .fgts import scatter_drop, set_at


class ModelPool(NamedTuple):
    a_emb: torch.Tensor       # (K_max, d) float32
    costs: torch.Tensor       # (K_max,)  float32
    active: torch.Tensor      # (K_max,)  bool
    generation: torch.Tensor  # ()        int32


class PooledState(NamedTuple):
    """Policy state carrying its pool: ``inner`` is the policy's own state,
    ``pool`` the live arm set."""
    inner: Any
    pool: ModelPool


def init_pool(a_emb, costs=None, k_max: int | None = None,
              device=None) -> ModelPool:
    """Pool from (K, d) embeddings (+ optional (K,) costs), padded to
    ``k_max``; the first K slots are active. ``device`` None keeps the
    device of a tensor ``a_emb`` and otherwise means the default device."""
    if device is None and isinstance(a_emb, torch.Tensor):
        device = a_emb.device
    dev = resolve_device(device)
    a_emb = as_f32(a_emb, dev)
    k, d = a_emb.shape
    k_max = k if k_max is None else k_max
    if k_max < k:
        raise ValueError(f"k_max={k_max} below initial pool size {k}")
    costs = torch.zeros((k,), device=dev) if costs is None \
        else as_f32(costs, dev)
    pad = k_max - k
    return ModelPool(
        a_emb=torch.nn.functional.pad(a_emb, (0, 0, 0, pad)),
        costs=torch.nn.functional.pad(costs, (0, pad)),
        active=torch.arange(k_max, device=dev) < k,
        generation=torch.zeros((), dtype=torch.int32, device=dev),
    )


def get_pool(state) -> ModelPool:
    """The ``ModelPool`` of a pool-backed state, descending ``inner``."""
    if isinstance(state, PooledState):
        return state.pool
    inner = getattr(state, "inner", None)
    if inner is None:
        raise TypeError(
            "expected a PooledState (a policy built on a ModelPool); got "
            f"{type(state).__name__} — construct the policy with a "
            "ModelPool first argument to make its arm set dynamic")
    return get_pool(inner)


def is_pooled(state) -> bool:
    try:
        get_pool(state)
        return True
    except TypeError:
        return False


def set_pool(state, pool: ModelPool):
    """Functional pool swap, descending wrapper states like ``get_pool``."""
    if isinstance(state, PooledState):
        return state._replace(pool=pool)
    get_pool(state)
    return state._replace(inner=set_pool(state.inner, pool))


def set_arm(pool: ModelPool, slot, emb, cost) -> ModelPool:
    """Install (or replace) an arm: row write + activate + bump."""
    slot = torch.as_tensor(slot, device=pool.a_emb.device).long()
    return ModelPool(
        a_emb=set_at(pool.a_emb, slot, as_f32(emb, pool.a_emb.device)),
        costs=set_at(pool.costs, slot, as_f32(cost, pool.a_emb.device)),
        active=set_at(pool.active, slot, True),
        generation=pool.generation + 1,
    )


def set_table(pool: ModelPool, a_emb) -> ModelPool:
    """Whole-table embedding refresh; costs and membership untouched."""
    a_emb = as_f32(a_emb, pool.a_emb.device)
    if a_emb.shape != pool.a_emb.shape:
        raise ValueError(f"refreshed table shape {tuple(a_emb.shape)} != "
                         f"pool table shape {tuple(pool.a_emb.shape)}")
    return pool._replace(a_emb=a_emb, generation=pool.generation + 1)


def retire_arm(pool: ModelPool, slot) -> ModelPool:
    """Mask flip only: the row and its replay history stay."""
    slot = torch.as_tensor(slot, device=pool.a_emb.device).long()
    return pool._replace(active=set_at(pool.active, slot, False),
                         generation=pool.generation + 1)


def masked_pair_choice(draws, active: torch.Tensor, b: int):
    """Uniform random distinct pair among active arms for B rows, by
    Gumbel top-2 (``draws.gumbel``). ``active`` is (K,) or (B, K) per-row
    eligibility; a row with a single eligible arm duels (k, k)."""
    act2 = torch.atleast_2d(active)
    g = draws.gumbel((b, active.shape[-1]), active.device)
    g = torch.where(act2, g, -torch.inf)
    top2 = torch.topk(g, 2, dim=-1).indices
    a1 = top2[:, 0].to(torch.int32)
    n_act = act2.sum(dim=-1)
    a2 = torch.where(n_act > 1, top2[:, 1].to(torch.int32), a1)
    return a1, a2


def n_active_mask(active: torch.Tensor) -> torch.Tensor:
    """The number of active arms, a 0-d int32 tensor."""
    return torch.sum(active.to(torch.int32)).to(torch.int32)


class PoolSchedule(NamedTuple):
    """E membership events for ``env.run``: at step ``step[e]`` slot
    ``slot[e]`` is activated with ``emb[e]``/``cost[e]`` or retired."""
    step: torch.Tensor      # (E,) int32
    slot: torch.Tensor      # (E,) int32
    activate: torch.Tensor  # (E,) bool
    emb: torch.Tensor       # (E, d) float32
    cost: torch.Tensor      # (E,) float32


def schedule(events, dim: int, device=None) -> PoolSchedule:
    """PoolSchedule from host tuples ``(step, slot, emb|None, cost)``; emb
    None is a retirement."""
    dev = resolve_device(device)
    steps, slots, acts, embs, costs = [], [], [], [], []
    for step, slot, emb, cost in events:
        steps.append(step)
        slots.append(slot)
        acts.append(emb is not None)
        embs.append(torch.zeros((dim,), device=dev) if emb is None
                    else as_f32(emb, dev))
        costs.append(0.0 if cost is None else float(cost))
    return PoolSchedule(
        step=torch.tensor(steps, dtype=torch.int32, device=dev),
        slot=torch.tensor(slots, dtype=torch.int32, device=dev),
        activate=torch.tensor(acts, dtype=torch.bool, device=dev),
        emb=torch.stack(embs),
        cost=torch.tensor(costs, dtype=torch.float32, device=dev))


def apply_events(pool: ModelPool, sched: PoolSchedule, s) -> ModelPool:
    """Fold every event due at step ``s`` into the pool (misses scatter to
    the dropped index K_max)."""
    k_max = pool.a_emb.shape[0]
    hit = sched.step == int(s)
    on = torch.where(hit & sched.activate, sched.slot, k_max).long()
    off = torch.where(hit & ~sched.activate, sched.slot, k_max).long()
    active = scatter_drop(scatter_drop(pool.active, on, True), off, False)
    return ModelPool(
        a_emb=scatter_drop(pool.a_emb, on, sched.emb),
        costs=scatter_drop(pool.costs, on, sched.cost),
        active=active,
        generation=pool.generation + hit.sum(dtype=torch.int32),
    )


# ---------------------------------------------------------------------------
# Offline -> online warm-start seeding
# ---------------------------------------------------------------------------

def warm_start_duels(draws, x_off, utils_off, new_arm: int, active,
                     feedback_scale: float = 5.0):
    """A historical-duel replay batch for a hot-added arm: the new arm
    against a Gumbel-drawn *active* incumbent per offline query, with BTL
    votes on the utility scale (the feedback the arm would have drawn had
    it been live). Feed it to ``RouterService.add_model(entry,
    replay=...)`` or any policy's ``update``.

    x_off (N, d) offline query features; utils_off (N, K_max) utilities;
    ``active`` (K_max,) bool. Returns (x, a1, a2, y) with a1 == new_arm. In
    a one-arm pool there is no incumbent: every row degrades to an
    uninformative self-duel (a2 == new_arm, y == 0)."""
    k_opp, k_y = draws.split(2)
    dev = utils_off.device
    active = torch.as_tensor(active, device=dev).to(torch.bool)
    n, k = x_off.shape[0], active.shape[0]
    opp_ok = active & (torch.arange(k, device=dev) != new_arm)
    g = k_opp.gumbel((n, k), dev)
    opp = torch.argmax(torch.where(opp_ok[None, :], g, -torch.inf),
                       dim=-1).to(torch.int32)
    a1 = torch.full((n,), new_arm, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    y = sample_preference(k_y, feedback_scale * utils_off[rows, a1.long()],
                          feedback_scale * utils_off[rows, opp.long()])
    has_opp = torch.any(opp_ok)
    opp = torch.where(has_opp, opp, a1)
    y = torch.where(has_opp, y, 0.0)
    return x_off, a1, opp, y
