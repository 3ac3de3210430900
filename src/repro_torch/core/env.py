"""Online routing environment and the online learning loop (counterpart of
``repro/core/env.py``).

The environment is a pre-generated stream of query features x_t and true
per-model utilities u_t; preference feedback is drawn from the BTL model
on the utility scale. ``run`` drives any ``RoutingPolicy`` over the stream
B queries per tick (act -> BTL feedback -> update), as the reference's
``lax.scan`` does, here as a Python loop over ticks.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple

import torch

from . import model_pool as mp
from .btl import sample_preference
from .policy import RoutingPolicy
from .regret import instant_regret


class EnvData(NamedTuple):
    x: torch.Tensor        # (T, dim) query features
    utils: torch.Tensor    # (T, K)   true utilities
    feedback_scale: float = 5.0   # BTL sharpness


@dataclasses.dataclass(frozen=True)
class DelaySpec:
    """When a tick's feedback lands: a batch acted at tick s resolves at
    s + L, L = clip(delay + Geometric(geom_p), 1, cap), through a lag ring
    of cap + 1 slots addressed by due tick (a later batch on an occupied
    slot overwrites it: the older feedback expires unseen). ``per_item``
    draws one lag per query and folds each due slot's rows through the
    policy's masked update. See the reference ``repro.core.env.DelaySpec``.
    """
    delay: int = 0
    geom_p: float = 0.0
    max_lag: int | None = None
    per_item: bool = False

    @property
    def trivial(self) -> bool:
        return self.delay == 0 and self.geom_p == 0.0

    @property
    def cap(self) -> int:
        if self.max_lag is not None:
            return max(self.max_lag, 1)
        return max(self.delay, 1) if self.geom_p == 0.0 \
            else self.delay + 16


def _as_delay(delay) -> DelaySpec:
    if delay is None:
        return DelaySpec()
    if isinstance(delay, DelaySpec):
        if delay.geom_p > 0.0 and delay.max_lag is None:
            tail = (1.0 - delay.geom_p) ** max(delay.cap - delay.delay + 1, 0)
            warnings.warn(
                f"DelaySpec(geom_p={delay.geom_p}, max_lag=None): geometric "
                f"lag is truncated at the default cap delay+16 = {delay.cap} "
                f"ticks (~{100.0 * tail:.1f}% of draws clip to it); set "
                f"max_lag explicitly when the tail matters", stacklevel=3)
        return delay
    return DelaySpec(delay=int(delay))


def _stack(outs: list):
    """Stack per-tick aux outputs: tensors, or tuples/lists of them."""
    if isinstance(outs[0], (tuple, list)):
        return type(outs[0])(_stack(list(v)) for v in zip(*outs))
    return torch.stack(outs)


def run(draws, env: EnvData, policy: RoutingPolicy, batch: int = 1,
        delay: DelaySpec | int | None = 0,
        pool_schedule: "mp.PoolSchedule | None" = None,
        refresh_schedule=None, aux_fn: Callable | None = None,
        pref_fn: Callable | None = None):
    """Run a RoutingPolicy over the stream. Returns (cum_regret (T',),
    state), or (cum_regret, state, aux) with ``aux_fn``.

    ``draws`` is the run's draw source (``core.draws``). Arguments follow
    the reference: ``delay`` (int or ``DelaySpec``) holds feedback in a lag
    ring, regret charged at act time; ``pool_schedule`` folds arm arrivals
    and retirements before each tick's act, regret against the best active
    arm; ``aux_fn(state, a1, a2)`` is read after each act and stacked;
    ``pref_fn(step, x_b) -> (B,)`` serves each query under the tilt
    pref_i*cost_k through ``act_pref``/``update_pref``;
    ``refresh_schedule`` (``refresh.RefreshSchedule``) swaps the pool's
    whole embedding table at its steps, after that step's membership
    events and before its act."""
    spec = _as_delay(delay)
    t_total = env.x.shape[0] - env.x.shape[0] % batch
    if t_total == 0:
        raise ValueError(
            f"batch={batch} exceeds the stream length {env.x.shape[0]}: "
            f"no full batch can be formed")
    n_steps = t_total // batch
    x = env.x[:t_total].reshape(n_steps, batch, -1)
    utils = env.utils[:t_total].reshape(n_steps, batch, -1)
    dev = x.device

    k_init, k_loop = draws.split(2)
    state = policy.init(k_init)
    any_sched = pool_schedule is not None or refresh_schedule is not None
    if any_sched:
        mp.get_pool(state)        # fail fast on a non-pooled policy
    if refresh_schedule is not None:
        from repro_torch.refresh.trainer import apply_refresh

    def fold_pool_events(state, s):
        """Membership events first, then the table swap due at step s."""
        pool = mp.get_pool(state)
        if pool_schedule is not None:
            pool = mp.apply_events(pool, pool_schedule, s)
        if refresh_schedule is not None:
            pool = apply_refresh(pool, refresh_schedule, s)
        return mp.set_pool(state, pool)
    keys = k_loop.split(n_steps)
    rows = torch.arange(batch, device=dev)
    ones_b = torch.ones((batch,), dtype=torch.bool, device=dev)

    prefs = None
    if pref_fn is not None:
        if policy.act_pref is None:
            raise ValueError(
                f"pref_fn needs a preference-aware policy: "
                f"'{policy.name}' has no act_pref path")
        prefs = torch.stack([torch.as_tensor(pref_fn(s, x[s]),
                                             dtype=torch.float32, device=dev)
                             for s in range(n_steps)])
        if prefs.shape != (n_steps, batch):
            raise ValueError(
                f"pref_fn(step, x_b) must return a ({batch},) row per "
                f"step; got sequence shape {tuple(prefs.shape)}")

    def do_act(k, state, s):
        if prefs is None:
            return policy.act(k, state, x[s])
        return policy.act_pref(k, state, x[s], None, prefs[s])

    def feedback(k, u_b, a1, a2):
        a1l, a2l = a1.long(), a2.long()
        return sample_preference(k, env.feedback_scale * u_b[rows, a1l],
                                 env.feedback_scale * u_b[rows, a2l])

    def regret(state, u_b, a1, a2, masked):
        # against the best active arm: the reference's ticks with any
        # schedule, its delayed ticks with a pool schedule
        active = mp.get_pool(state).active if masked else None
        return instant_regret(u_b, a1, a2, active=active)

    regrets, aux = [], []
    if spec.trivial:
        for s in range(n_steps):
            if any_sched:
                state = fold_pool_events(state, s)
            k_act, k_fb = keys[s].split(2)
            state, a1, a2 = do_act(k_act, state, s)
            y = feedback(k_fb, utils[s], a1, a2)
            if prefs is not None and policy.update_pref is not None:
                state = policy.update_pref(state, x[s], a1, a2, y, prefs[s],
                                           ones_b)
            else:
                state = policy.update(state, x[s], a1, a2, y)
            regrets.append(regret(state, utils[s], a1, a2, any_sched))
            if aux_fn is not None:
                aux.append(aux_fn(state, a1, a2))
        return _finish(regrets, state, aux, aux_fn)

    per_item = spec.per_item
    if per_item:
        if prefs is not None:
            if policy.update_pref is None:
                raise ValueError(
                    f"DelaySpec(per_item=True) with pref_fn folds each "
                    f"slot's survivors through update_pref; policy "
                    f"'{policy.name}' has none")
        elif policy.update_masked is None:
            raise ValueError(
                f"DelaySpec(per_item=True) folds each slot's survivors "
                f"through the policy's masked update; '{policy.name}' has "
                f"no update_masked path")
    r = spec.cap + 1
    dim = x.shape[-1]
    ring = dict(
        x=torch.zeros((r, batch, dim), dtype=x.dtype, device=dev),
        a1=torch.zeros((r, batch), dtype=torch.int32, device=dev),
        a2=torch.zeros((r, batch), dtype=torch.int32, device=dev),
        y=torch.zeros((r, batch), dtype=torch.float32, device=dev),
        pref=torch.zeros((r, batch), dtype=torch.float32, device=dev))
    if per_item:
        ring["valid"] = torch.zeros((r, batch), dtype=torch.bool, device=dev)
    else:
        # per-tick validity and issue tick are host facts: no device sync
        slot_valid, slot_issued = [False] * r, [0] * r

    for s in range(n_steps):
        k_act, k_fb, k_lag = keys[s].split(3)
        if any_sched:
            state = fold_pool_events(state, s)
        slot = s % r
        args = (ring["x"][slot], ring["a1"][slot], ring["a2"][slot],
                ring["y"][slot])
        if per_item:
            m = ring["valid"][slot]
            if prefs is not None:
                state = policy.update_pref(state, *args, ring["pref"][slot],
                                           m)
            else:
                state = policy.update_masked(state, *args, m)
            ring["valid"][slot] = False
        elif slot_valid[slot]:
            if prefs is not None and policy.update_pref is not None:
                state = policy.update_pref(state, *args, ring["pref"][slot],
                                           ones_b)
            elif policy.update_delayed is not None:
                age = torch.full((batch,), s - slot_issued[slot],
                                 dtype=torch.int32, device=dev)
                state = policy.update_delayed(state, *args, age)
            else:
                state = policy.update(state, *args)
            slot_valid[slot] = False

        state, a1, a2 = do_act(k_act, state, s)
        y = feedback(k_fb, utils[s], a1, a2)

        # schedule at s + L (an occupied slot is overwritten; the ring is
        # written in place: every fold above copied its rows into state)
        geo = 0
        if spec.geom_p > 0.0:
            u = k_lag.uniform((batch,) if per_item else (), dev)
            geo = torch.floor(torch.log1p(-u) / torch.log1p(
                torch.tensor(-spec.geom_p, dtype=torch.float32)))
            geo = geo.to(torch.int32) if per_item else int(geo)
        if per_item:
            lag = torch.clamp(torch.full((batch,), spec.delay,
                                         dtype=torch.int32, device=dev) + geo,
                              1, spec.cap)
            w = ((s + lag) % r).long()
            ring["x"][w, rows] = x[s]
            ring["a1"][w, rows] = a1
            ring["a2"][w, rows] = a2
            ring["y"][w, rows] = y
            ring["valid"][w, rows] = True
            if prefs is not None:
                ring["pref"][w, rows] = prefs[s]
        else:
            # one host sync per tick, on geometric lags only
            w = (s + min(max(spec.delay + geo, 1), spec.cap)) % r
            ring["x"][w], ring["a1"][w], ring["a2"][w] = x[s], a1, a2
            ring["y"][w] = y
            if prefs is not None:
                ring["pref"][w] = prefs[s]
            slot_valid[w], slot_issued[w] = True, s
        regrets.append(regret(state, utils[s], a1, a2,
                              pool_schedule is not None))
        if aux_fn is not None:
            aux.append(aux_fn(state, a1, a2))
    return _finish(regrets, state, aux, aux_fn)


def _finish(regrets, state, aux, aux_fn):
    cum = torch.cumsum(torch.stack(regrets).reshape(-1), dim=0)
    return (cum, state, _stack(aux)) if aux_fn is not None else (cum, state)


def averaged_runs(run_fn: Callable, draws, n_runs: int = 5):
    """The paper's 'average of n runs': one sub-source per run; ``run_fn``
    returns a (T,) curve or a tuple starting with one. Returns
    (mean (T,), curves (n, T))."""
    outs = [run_fn(sub) for sub in draws.split(n_runs)]
    curves = torch.stack([o[0] if isinstance(o, (tuple, list)) else o
                          for o in outs])
    if curves.dim() != 2:
        raise ValueError(
            f"run_fn must return a (T,) curve or a tuple starting with one; "
            f"got stacked shape {tuple(curves.shape)} for n_runs={n_runs}")
    return curves.mean(dim=0), curves
