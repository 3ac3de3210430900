"""The batched ``RoutingPolicy`` protocol and FGTS.CDB on it (counterpart of
``repro/core/policy.py``).

    init(draws)                      -> state
    act(draws, state, x)             -> (state, a1, a2)    x: (B,d); a: (B,)
    update(state, x, a1, a2, y)      -> state              y: (B,) in {+1,-1}

``draws`` is a draw source (``core.draws``), passed where the reference
passes a PRNG key, so the slot arities are the reference's. The optional
slots keep the reference's contracts: ``update_masked`` (masked rows leave
the state as their absence would), ``act_masked`` (per-row arm gate and an
extra tilt), ``act_pref``/``update_pref`` (per-request cost weight),
``update_delayed`` (feedback age) and ``propensity``.

Selection goes through the ``dueling_select`` kernel wrapper, which
dispatches by the tensors' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.kernels.dueling_score import (dueling_select,
                                               dueling_select_plain)

from . import fgts
from .model_pool import ModelPool, PooledState


class RoutingPolicy(NamedTuple):
    """Batched policy protocol: functions over a NamedTuple-of-tensors
    state (see the module docstring for each slot's contract)."""
    init: Callable[[Any], Any]
    act: Callable[[Any, Any, torch.Tensor], tuple]
    update: Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor], Any]
    name: str = "policy"
    update_delayed: Callable[..., Any] | None = None
    update_masked: Callable[..., Any] | None = None
    act_masked: Callable[..., tuple] | None = None
    act_pref: Callable[..., tuple] | None = None
    update_pref: Callable[..., Any] | None = None
    propensity: Callable[..., torch.Tensor] | None = None


def staleness_weight(age: torch.Tensor, half_life: float) -> torch.Tensor:
    """2^(-age / half_life); ``half_life <= 0`` means no discount."""
    if half_life <= 0:
        return torch.ones(age.shape, dtype=torch.float32, device=age.device)
    return torch.exp2(-age.to(torch.float32) / half_life)


def with_staleness(pol: RoutingPolicy, half_life: float) -> RoutingPolicy:
    """Give any policy an age-discounted ``update_delayed``: the duel label
    is shrunk toward 0, y * 2^(-age/half_life)."""
    def update_delayed(state, x, a1, a2, y, age):
        return pol.update(state, x, a1, a2,
                          y * staleness_weight(age, half_life))
    return pol._replace(update_delayed=update_delayed)


def select_pair(x, a_emb, theta1, theta2, *, tilt=None, mask=None,
                distinct: bool = False, use_kernel: bool = True):
    """argmax_k of both samples' (tilted) scores for a (B,d) batch.

    ``use_kernel`` routes through ``dueling_select`` (the CUDA kernel on a
    CUDA device); otherwise its plain PyTorch version on any device.
    ``mask`` (K,) or (B,K) bool; inactive arms score -inf, and a lone
    survivor duels itself."""
    select = dueling_select if use_kernel else dueling_select_plain
    return select(x, a_emb, torch.stack([theta1, theta2]), tilt=tilt,
                  mask=mask, distinct=distinct)


# inverse temperature of the soft-Thompson propensity estimate
PROPENSITY_BETA = 8.0


def pair_propensity(x, a_emb, theta1, theta2, a1, a2, mask=None,
                    beta: float = PROPENSITY_BETA) -> torch.Tensor:
    """softmax(beta s^1)[a1] * softmax(beta s^2)[a2] per row; inactive arms
    get zero mass."""
    den = torch.sqrt(torch.clamp_min((x * x) @ (a_emb * a_emb).T, 1e-24))
    s1 = ((x * theta1[None, :]) @ a_emb.T) / den
    s2 = ((x * theta2[None, :]) @ a_emb.T) / den
    if mask is not None:
        m2 = torch.atleast_2d(mask)
        s1 = torch.where(m2, s1, -torch.inf)
        s2 = torch.where(m2, s2, -torch.inf)
    p1 = torch.softmax(beta * s1, dim=-1)
    p2 = torch.softmax(beta * s2, dim=-1)
    rows = torch.arange(x.shape[0], device=x.device)
    return p1[rows, a1.long()] * p2[rows, a2.long()]


def cost_tilt_vector(costs, cost_tilt: float):
    """Serve-time score penalty lambda * cost_k, or None when disabled."""
    if costs is None or cost_tilt == 0.0:
        return None
    return cost_tilt * costs


def merge_tilt(base, extra):
    """Sum of two score penalties, None-transparent; (K,) and (B,K) mix
    into (B,K)."""
    if base is None:
        return extra
    if extra is None:
        return base
    if base.dim() != extra.dim():
        return torch.atleast_2d(base) + torch.atleast_2d(extra)
    return base + extra


def pref_tilt(pref, costs) -> torch.Tensor:
    """(B,) cost weights x (K,) arm costs -> the (B,K) penalty."""
    return pref[:, None] * costs[None, :]


# ---------------------------------------------------------------------------
# FGTS.CDB as a RoutingPolicy
# ---------------------------------------------------------------------------

def init_fgts_state(cfg: fgts.FGTSConfig, draws, device=None) -> fgts.FGTSState:
    """FGTSState with (n_chains, dim) warm-start thetas."""
    k_buf, k1, k2 = draws.split(3)
    st = fgts.init_state(cfg, k_buf, device)
    dev = st.x.device
    shape = (cfg.n_chains, cfg.dim)
    return st._replace(theta1=k1.normal(shape, dev) * cfg.prior_var ** 0.5,
                       theta2=k2.normal(shape, dev) * cfg.prior_var ** 0.5)


def _refresh(draws, inner, a_emb, cfg, arm_mask=None, costs=None):
    """Both samples' SGLD chains, warm-started from the state's chains."""
    k1, k2 = draws.split(2)
    th1 = fgts.sgld_sample(k1, inner.theta1, inner, a_emb, 1, cfg,
                           arm_mask=arm_mask, costs=costs)
    th2 = fgts.sgld_sample(k2, inner.theta2, inner, a_emb, 2, cfg,
                           arm_mask=arm_mask, costs=costs)
    return inner._replace(theta1=th1, theta2=th2)


def fgts_policy(a_emb, cfg: fgts.FGTSConfig, *, costs=None,
                cost_tilt: float = 0.0) -> RoutingPolicy:
    """FGTS.CDB (paper Alg. 1) on the batched protocol.

    Each ``act`` runs cfg.n_chains SGLD chains per posterior sample (the
    chain mean is the round's theta^j), then selects every query's pair.
    A ``ModelPool`` as ``a_emb`` makes the arm set dynamic (state is a
    ``PooledState``; ``costs`` is then taken from the pool)."""
    if isinstance(a_emb, ModelPool):
        return _fgts_policy_pooled(a_emb, cfg, cost_tilt=cost_tilt)
    tilt = cost_tilt_vector(costs, cost_tilt)

    def init(draws):
        return init_fgts_state(cfg, draws, a_emb.device)

    def _act(draws, state, x, extra_tilt=None):
        state = _refresh(draws, state, a_emb, cfg, costs=costs)
        a1, a2 = select_pair(x, a_emb, state.theta1.mean(dim=0),
                             state.theta2.mean(dim=0),
                             tilt=merge_tilt(tilt, extra_tilt),
                             distinct=cfg.force_distinct)
        return state, a1, a2

    def act(draws, state, x):
        return _act(draws, state, x)

    def update(state, x, a1, a2, y):
        return fgts.observe_batch(state, x, a1, a2, y)

    def update_masked(state, x, a1, a2, y, mask):
        return fgts.observe_batch(state, x, a1, a2, y, mask=mask)

    act_pref = update_pref = None
    if costs is not None:
        def act_pref(draws, state, x, row_mask, pref):
            del row_mask                       # static policy: no arm gating
            return _act(draws, state, x, pref_tilt(pref, costs))

        def update_pref(state, x, a1, a2, y, pref, mask):
            return fgts.observe_batch(state, x, a1, a2, y, mask=mask,
                                      pref=pref)

    def propensity(state, x, a1, a2):
        return pair_propensity(x, a_emb, state.theta1.mean(dim=0),
                               state.theta2.mean(dim=0), a1, a2)

    return RoutingPolicy(init, act, update, name="fgts_cdb",
                         update_masked=update_masked,
                         act_pref=act_pref, update_pref=update_pref,
                         propensity=propensity)


def _fgts_policy_pooled(pool0: ModelPool, cfg: fgts.FGTSConfig, *,
                        cost_tilt: float = 0.0) -> RoutingPolicy:
    """FGTS.CDB over a dynamic ``ModelPool`` carried in the state;
    ``cfg.n_models`` is the capacity K_max."""

    def init(draws):
        return PooledState(init_fgts_state(cfg, draws, pool0.a_emb.device),
                           pool0)

    def _act(draws, state, x, row_mask=None, extra_tilt=None):
        pool = state.pool
        inner = _refresh(draws, state.inner, pool.a_emb, cfg,
                         arm_mask=pool.active, costs=pool.costs)
        tilt = merge_tilt(cost_tilt * pool.costs if cost_tilt != 0.0
                          else None, extra_tilt)
        mask = pool.active if row_mask is None \
            else row_mask & pool.active[None, :]
        a1, a2 = select_pair(x, pool.a_emb, inner.theta1.mean(dim=0),
                             inner.theta2.mean(dim=0), tilt=tilt, mask=mask,
                             distinct=cfg.force_distinct)
        return PooledState(inner, pool), a1, a2

    def act(draws, state, x):
        return _act(draws, state, x)

    def act_masked(draws, state, x, row_mask, tilt):
        return _act(draws, state, x, row_mask, tilt)

    def act_pref(draws, state, x, row_mask, pref):
        return _act(draws, state, x, row_mask,
                    pref_tilt(pref, state.pool.costs))

    def update(state, x, a1, a2, y):
        return state._replace(
            inner=fgts.observe_batch(state.inner, x, a1, a2, y))

    def update_masked(state, x, a1, a2, y, mask):
        return state._replace(
            inner=fgts.observe_batch(state.inner, x, a1, a2, y, mask=mask))

    def update_pref(state, x, a1, a2, y, pref, mask):
        return state._replace(
            inner=fgts.observe_batch(state.inner, x, a1, a2, y, mask=mask,
                                     pref=pref))

    def propensity(state, x, a1, a2):
        inner, pool = state.inner, state.pool
        return pair_propensity(x, pool.a_emb, inner.theta1.mean(dim=0),
                               inner.theta2.mean(dim=0), a1, a2,
                               mask=pool.active)

    return RoutingPolicy(init, act, update, name="fgts_cdb",
                         update_masked=update_masked, act_masked=act_masked,
                         act_pref=act_pref, update_pref=update_pref,
                         propensity=propensity)


def vanilla_ts_policy(a_emb, cfg: fgts.FGTSConfig, **kw) -> RoutingPolicy:
    """Feel-good ablation: FGTS.CDB with mu = 0 (paper's vanilla TS)."""
    pol = fgts_policy(a_emb, dataclasses.replace(cfg, mu=0.0), **kw)
    return pol._replace(name="vanilla_ts")
