"""Baseline routing policies (counterpart of ``repro/core/baselines.py``;
paper §5, App. B.3).

* ``uniform``     — random pair each round.
* ``best_fixed``  — oracle best single arm in hindsight (plays (k*, k*)).
* ``eps_greedy``  — MAP theta by SGD on the preference loss + epsilon
                    exploration over arms.
* ``linucb_duel`` — MixLLM-style per-arm LinUCB on phi features with
                    pointwise pseudo-rewards (y+1)/2 for a1 and (1-y)/2 for
                    a2, UCB selection of the top two arms.

Each takes a ``ModelPool`` in place of the arm table (or count) to make its
arm set dynamic; the pooled ``uniform`` and ``eps_greedy`` then carry the
``act_masked``/``act_pref`` slots that ``autopilot.wrap`` needs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.dueling_score import mask_fallback_pair

from .btl import logistic_loss
from .ccft import phi
from .model_pool import ModelPool, PooledState, masked_pair_choice
from .policy import RoutingPolicy, merge_tilt, pref_tilt, select_pair


def _zero_state(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def uniform_policy(n_models: int | ModelPool, device=None) -> RoutingPolicy:
    """Random pair each round. A ``ModelPool`` instead of a count samples
    over the active arms only (pool in the state). ``device`` places the
    static policy's (empty) state; a pool's device is its own."""
    pooled = isinstance(n_models, ModelPool)
    pool0 = n_models if pooled else None

    def init(draws):
        if pooled:
            return PooledState(_zero_state(pool0.active.device), pool0)
        return _zero_state(resolve_device(device))

    def act(draws, state, x):
        b = x.shape[0]
        if pooled:
            a1, a2 = masked_pair_choice(draws, state.pool.active, b)
            return state, a1, a2
        pairs = draws.distinct_pair(b, n_models, x.device)
        return state, pairs[:, 0].to(torch.int32), pairs[:, 1].to(torch.int32)

    def act_masked(draws, state, x, row_mask, tilt):
        # uniform draws have no scores for a tilt to bend; the row mask
        # narrows each row's eligible arms (candidate quota gating)
        del tilt
        if row_mask is None:
            return act(draws, state, x)
        a1, a2 = masked_pair_choice(
            draws, row_mask & state.pool.active[None, :], x.shape[0])
        return state, a1, a2

    def act_pref(draws, state, x, row_mask, pref):
        del pref                      # no scores to tilt; gating still holds
        return act_masked(draws, state, x, row_mask, None)

    def update(state, x, a1, a2, y):
        return state

    return RoutingPolicy(init, act, update, name="uniform",
                         act_masked=act_masked if pooled else None,
                         act_pref=act_pref if pooled else None)


def best_fixed_policy(utils_mean: torch.Tensor | np.ndarray,
                      pool: ModelPool | None = None,
                      device=None) -> RoutingPolicy:
    """utils_mean: (K,) average utility per arm over the stream
    (hindsight). With a ``pool``, plays the best active arm. The state
    lives on the pool's device, else on ``device`` or that of a tensor
    ``utils_mean``."""
    if pool is not None:
        dev = pool.a_emb.device
    elif device is None and isinstance(utils_mean, torch.Tensor):
        dev = utils_mean.device
    else:
        dev = resolve_device(device)
    utils_mean = as_f32(utils_mean, dev)
    if pool is not None and utils_mean.shape[0] != pool.active.shape[0]:
        raise ValueError(
            f"utils_mean has {utils_mean.shape[0]} arms but the pool's "
            f"capacity is {pool.active.shape[0]} — pad it to K_max")
    k_star = torch.argmax(utils_mean).to(torch.int32)

    def init(draws):
        if pool is not None:
            return PooledState(_zero_state(dev), pool)
        return _zero_state(dev)

    def act(draws, state, x):
        k = k_star if pool is None else torch.argmax(torch.where(
            state.pool.active, utils_mean, -torch.inf)).to(torch.int32)
        a = k.expand(x.shape[0])
        return state, a, a

    def update(state, x, a1, a2, y):
        return state

    return RoutingPolicy(init, act, update, name="best_fixed")


@dataclasses.dataclass(frozen=True)
class EpsGreedyConfig:
    n_models: int
    dim: int
    eps: float = 0.1
    lr: float = 0.05


class EpsGreedyState(NamedTuple):
    theta: torch.Tensor    # (dim,) MAP estimate


def preference_loss(theta, x, a1, a2, y, a_emb) -> torch.Tensor:
    """Mean BTL logistic loss over a batch of duels (eps-greedy's
    objective), on the phi features as the reference computes it."""
    z = y * torch.sum((phi(x, a_emb[a1.long()]) - phi(x, a_emb[a2.long()]))
                      * theta[None, :], dim=-1)
    return torch.mean(logistic_loss(z))


def eps_greedy_policy(a_emb: torch.Tensor | ModelPool, cfg: EpsGreedyConfig,
                      *, tilt: torch.Tensor | None = None,
                      cost_tilt: float = 0.0) -> RoutingPolicy:
    """SGD-MAP on the preference loss with epsilon-uniform exploration.

    ``tilt``: an optional (K,) serve-time score penalty. With a
    ``ModelPool`` the greedy argmax and the exploration draw range over
    active arms only; pass ``cost_tilt`` there to penalize by live costs.
    Selection goes through ``select_pair`` (the ``dueling_select`` kernel
    on CUDA tensors)."""
    pooled = isinstance(a_emb, ModelPool)
    pool0 = a_emb if pooled else None
    if cost_tilt != 0.0 and not pooled:
        raise ValueError(
            "cost_tilt reads live per-arm costs from a ModelPool — for a "
            "static embedding table pass the precomputed tilt= vector")
    dev = pool0.a_emb.device if pooled else a_emb.device

    def init(draws):
        s = EpsGreedyState(draws.normal((cfg.dim,), dev) * 0.1)
        return PooledState(s, pool0) if pooled else s

    def _act(draws, state, x, row_mask=None, extra_tilt=None):
        b = x.shape[0]
        k_e, k_a = draws.split(2)
        inner = state.inner if pooled else state
        emb = state.pool.a_emb if pooled else a_emb
        mask = state.pool.active if pooled else None
        if row_mask is not None:
            mask = row_mask & state.pool.active[None, :]
        eff_tilt = tilt
        if pooled and tilt is None and cost_tilt != 0.0:
            eff_tilt = cost_tilt * state.pool.costs
        eff_tilt = merge_tilt(eff_tilt, extra_tilt)
        a1_g, a2_g = select_pair(x, emb, inner.theta, inner.theta,
                                 tilt=eff_tilt, mask=mask, distinct=True)
        explore = k_e.uniform((b,), x.device) < cfg.eps
        if pooled:
            # exploration honours the same per-row gate as the greedy path
            r1, r2 = masked_pair_choice(
                k_a, state.pool.active if row_mask is None else mask, b)
        else:
            rand = k_a.distinct_pair(b, cfg.n_models, x.device)
            r1, r2 = rand[:, 0], rand[:, 1]
        a1 = torch.where(explore, r1.to(torch.int32), a1_g)
        a2 = torch.where(explore, r2.to(torch.int32), a2_g)
        return state, a1, a2

    def act(draws, state, x):
        return _act(draws, state, x)

    def act_masked(draws, state, x, row_mask, tilt_extra):
        return _act(draws, state, x, row_mask, tilt_extra)

    def act_pref(draws, state, x, row_mask, pref):
        return _act(draws, state, x, row_mask,
                    pref_tilt(pref, state.pool.costs))

    def update(state, x, a1, a2, y):
        inner = state.inner if pooled else state
        emb = state.pool.a_emb if pooled else a_emb
        with torch.enable_grad():
            th = inner.theta.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(
                preference_loss(th, x, a1, a2, y, emb), th)
        out = EpsGreedyState(inner.theta - cfg.lr * g)
        return state._replace(inner=out) if pooled else out

    return RoutingPolicy(init, act, update, name="eps_greedy",
                         act_masked=act_masked if pooled else None,
                         act_pref=act_pref if pooled else None)


@dataclasses.dataclass(frozen=True)
class LinUCBConfig:
    n_models: int
    dim: int
    alpha: float = 0.5       # exploration bonus
    lam: float = 1.0         # ridge prior


class LinUCBState(NamedTuple):
    A: torch.Tensor    # (K, d, d) per-arm ridge matrices
    b: torch.Tensor    # (K, d) per-arm reward sums


def _phi_rows(x, emb):
    """phi of every query against every arm: x (B,d), emb (K,d) ->
    (B,K,d)."""
    return phi(x[:, None, :], emb[None, :, :])


def linucb_ucb(state: LinUCBState, emb, x, alpha: float) -> torch.Tensor:
    """(B, K) upper confidence bounds theta_k . phi + alpha sqrt(phi^T
    A_k^{-1} phi) of the queries x (B,d) on the arms emb (K,d), before any
    tilt or mask."""
    feats = _phi_rows(x, emb)                                   # (B, K, d)
    theta = torch.linalg.solve(state.A, state.b[..., None])[..., 0]
    z = torch.linalg.solve(state.A, feats.permute(1, 2, 0))     # (K, d, B)
    mean = torch.einsum("bki,ki->bk", feats, theta)
    var = torch.einsum("bki,kib->bk", feats, z)
    return mean + alpha * torch.sqrt(torch.clamp_min(var, 0.0))


def linucb_duel_policy(a_emb: torch.Tensor | ModelPool, cfg: LinUCBConfig, *,
                       tilt: torch.Tensor | None = None,
                       cost_tilt: float = 0.0) -> RoutingPolicy:
    """MixLLM-style per-arm LinUCB with pointwise pseudo-feedback.

    Per arm k: A_k = lam I + sum phi phi^T, b_k = sum r phi, UCB_k =
    theta_k . phi + alpha sqrt(phi^T A_k^{-1} phi) with theta_k = A_k^{-1}
    b_k, both solved with ``torch.linalg.solve`` (plain math: the reference
    has no kernel here). With a ``ModelPool`` the argmax sees only active
    arms; pass ``cost_tilt`` there to penalize by live costs."""
    d = cfg.dim
    pooled = isinstance(a_emb, ModelPool)
    pool0 = a_emb if pooled else None
    if cost_tilt != 0.0 and not pooled:
        raise ValueError(
            "cost_tilt reads live per-arm costs from a ModelPool — for a "
            "static embedding table pass the precomputed tilt= vector")
    dev = pool0.a_emb.device if pooled else a_emb.device

    def init(draws):
        eye = torch.eye(d, device=dev) * cfg.lam
        s = LinUCBState(A=eye.expand(cfg.n_models, d, d).clone(),
                        b=torch.zeros((cfg.n_models, d), device=dev))
        return PooledState(s, pool0) if pooled else s

    def _act(draws, state, x, row_mask=None, extra_tilt=None):
        inner = state.inner if pooled else state
        emb = state.pool.a_emb if pooled else a_emb
        ucb = linucb_ucb(inner, emb, x, cfg.alpha)
        eff_tilt = tilt
        if pooled and tilt is None and cost_tilt != 0.0:
            eff_tilt = cost_tilt * state.pool.costs
        eff_tilt = merge_tilt(eff_tilt, extra_tilt)
        if eff_tilt is not None:
            ucb = ucb - torch.atleast_2d(eff_tilt)
        if pooled:
            mask = state.pool.active[None, :] if row_mask is None \
                else row_mask & state.pool.active[None, :]
            ucb = torch.where(mask, ucb, -torch.inf)
        a1 = torch.argmax(ucb, dim=-1)
        cols = torch.arange(cfg.n_models, device=x.device)
        masked = torch.where(cols[None, :] == a1[:, None], -torch.inf, ucb)
        a2 = torch.argmax(masked, dim=-1)
        if pooled:
            a2 = mask_fallback_pair(masked, a1, a2)
        return state, a1.to(torch.int32), a2.to(torch.int32)

    def act(draws, state, x):
        return _act(draws, state, x)

    def act_masked(draws, state, x, row_mask, extra_tilt):
        return _act(draws, state, x, row_mask, extra_tilt)

    def act_pref(draws, state, x, row_mask, pref):
        return _act(draws, state, x, row_mask,
                    pref_tilt(pref, state.pool.costs))

    def update(state, x, a1, a2, y):
        inner = state.inner if pooled else state
        emb = state.pool.a_emb if pooled else a_emb
        feats = _phi_rows(x, emb)
        rows = torch.arange(x.shape[0], device=x.device)
        i1, i2 = a1.long(), a2.long()
        f1, f2 = feats[rows, i1], feats[rows, i2]               # (B, d)
        r1, r2 = (y + 1) / 2, (1 - y) / 2
        new_a = inner.A.index_add(0, i1, f1[:, :, None] * f1[:, None, :]) \
            .index_add(0, i2, f2[:, :, None] * f2[:, None, :])
        new_b = inner.b.index_add(0, i1, r1[:, None] * f1) \
            .index_add(0, i2, r2[:, None] * f2)
        out = LinUCBState(A=new_a, b=new_b)
        return state._replace(inner=out) if pooled else out

    return RoutingPolicy(init, act, update, name="linucb_duel",
                         act_masked=act_masked if pooled else None,
                         act_pref=act_pref if pooled else None)
