"""Beyond-paper extensions to the dueling router core (counterpart of
``repro/core/extensions.py``).

1. **Plackett-Luce listwise feedback**: present m >= 2 candidates and
   observe a full ranking; the PL likelihood generalizes BTL.

       P(rank pi | scores s) = prod_j exp(s_{pi_j}) / sum_{l >= j} exp(s_{pi_l})

2. **Pointwise feedback**: like/dislike signals y in {0,1} on a single arm
   enter the same posterior through a Bernoulli likelihood on
   sigma(<theta, phi(x,a)>); mixed streams of duels and clicks update one
   theta. Its SGLD gradient is the "mixed" mode of the SGLD kernel
   (``kernels.sgld_update.mixed_potential_grad_rows``), all chains of a
   step in one launch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.sgld_update import (mixed_potential_grad_rows,
                                             mixed_potential_rows,
                                             resolve_sgld_backend)

from . import fgts
from .btl import logistic_loss
from .ccft import phi, scores_all
from .model_pool import ModelPool, PooledState
from .policy import RoutingPolicy, init_fgts_state, select_pair


# ---------------------------------------------------------------------------
# Plackett-Luce listwise feedback
# ---------------------------------------------------------------------------

def pl_log_likelihood(scores: torch.Tensor,
                      ranking: torch.Tensor) -> torch.Tensor:
    """Log P(ranking | scores) under Plackett-Luce, over the last axis:
    scores (..., m) of the presented candidates, ranking (..., m) a
    permutation (ranking[0] = the winner's index into scores)."""
    s = torch.gather(scores, -1, ranking.long())          # sorted by rank
    m = s.shape[-1]
    idx = torch.arange(m, device=s.device)
    mask = idx[None, :] >= idx[:, None]                   # (stage, candidate)
    suffix_lse = torch.logsumexp(torch.where(mask, s[..., None, :],
                                             -torch.inf), dim=-1)
    return torch.sum(s - suffix_lse, dim=-1)


def sample_pl_ranking(draws, scores: torch.Tensor) -> torch.Tensor:
    """A ranking by the Gumbel-max representation of PL (``draws.gumbel``;
    a stable sort, as ``jnp.argsort``)."""
    g = draws.gumbel(tuple(scores.shape), scores.device)
    return torch.argsort(-(scores + g), dim=-1, stable=True).to(torch.int32)


def pl_likelihood_term(theta, x, arms, ranking, a_emb,
                       eta: float) -> torch.Tensor:
    """-eta * log PL-likelihood of one listwise observation: x (d,), arms
    (m,) presented arm ids, ranking (m,) a permutation of 0..m-1."""
    feats = phi(x[None, :], a_emb[arms.long()])           # (m, d)
    return -eta * pl_log_likelihood(feats @ theta, ranking)


def select_top_m(theta, x, a_emb, m: int) -> torch.Tensor:
    """Listwise analogue of Alg. 1 line 6: the m best arms under theta."""
    return torch.topk(scores_all(x, a_emb, theta), m).indices.to(torch.int32)


# ---------------------------------------------------------------------------
# Pointwise (like/dislike) feedback in the same posterior
# ---------------------------------------------------------------------------

def pointwise_likelihood_term(theta, x, arm, y, a_emb,
                              eta: float) -> torch.Tensor:
    """Bernoulli NLL of a click: y in {0,1} on sigma(<theta, phi(x,a)>)."""
    arm = torch.as_tensor(arm, device=x.device).long()
    s = phi(x[None, :], a_emb[arm[None]])[0] @ theta
    y = torch.as_tensor(y, device=x.device)
    return eta * torch.where(y > 0.5, logistic_loss(s), logistic_loss(-s))


class MixedHistory(NamedTuple):
    """Fixed-capacity ring of a mixed duel + click stream."""
    x: torch.Tensor          # (H, d)
    a1: torch.Tensor         # (H,) int32
    a2: torch.Tensor         # (H,) int32, ignored on click rows
    y: torch.Tensor          # (H,) duels +-1, clicks 0/1
    is_duel: torch.Tensor    # (H,) bool
    t: torch.Tensor          # () int32


class MixedState(NamedTuple):
    """``mixed_feedback_policy``'s state: the ring and the warm-started
    chains (n_chains, dim)."""
    h: MixedHistory
    theta: torch.Tensor


def init_mixed(cfg: fgts.FGTSConfig, device=None) -> MixedHistory:
    dev = resolve_device(device)
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
    return MixedHistory(x=z(cfg.horizon, cfg.dim),
                        a1=z(cfg.horizon, dt=torch.int32),
                        a2=z(cfg.horizon, dt=torch.int32),
                        y=z(cfg.horizon), is_duel=z(cfg.horizon, dt=torch.bool),
                        t=z(dt=torch.int32))


def observe_mixed(h: MixedHistory, x, a1, a2, y, is_duel) -> MixedHistory:
    """Append one observation (ring on overflow)."""
    i = (h.t % h.x.shape[0]).long()
    return h._replace(x=fgts.set_at(h.x, i, x), a1=fgts.set_at(h.a1, i, a1),
                      a2=fgts.set_at(h.a2, i, a2), y=fgts.set_at(h.y, i, y),
                      is_duel=fgts.set_at(h.is_duel, i, is_duel), t=h.t + 1)


def observe_mixed_batch(h: MixedHistory, x, a1, a2, y,
                        is_duel) -> MixedHistory:
    """Fold B observations with one scatter per buffer, as B sequential
    ``observe_mixed`` calls would (cf. ``fgts.observe_batch``)."""
    b = x.shape[0]
    drop, idx = fgts.ring_slots(h.t, h.x.shape[0], b)
    put = lambda buf, v: buf.index_put((idx,), v[drop:].to(buf.dtype))
    return h._replace(x=put(h.x, x), a1=put(h.a1, a1), a2=put(h.a2, a2),
                      y=put(h.y, y), is_duel=put(h.is_duel, is_duel),
                      t=h.t + b)


def _mixed_terms_autodiff(theta, xb, a1b, a2b, yb, duelb, a_emb, eta):
    """Per-row mixed terms on explicit phi features (the "autodiff"
    backend's oracle, as the reference writes it): theta (C,d), rows
    (C,m,...) -> (C,m)."""
    phi1 = phi(xb, a_emb[a1b])
    phi2 = phi(xb, a_emb[a2b])
    th = theta[:, None, :]
    duel_term = eta * logistic_loss(yb * torch.sum((phi1 - phi2) * th, -1))
    s1 = torch.sum(phi1 * th, dim=-1)
    click_term = eta * torch.where(yb > 0.5, logistic_loss(s1),
                                   logistic_loss(-s1))
    return torch.where(duelb, duel_term, click_term)


def mixed_potential(theta, idx, h: MixedHistory, a_emb,
                    cfg: fgts.FGTSConfig) -> torch.Tensor:
    """U(theta) over a minibatch of mixed observations + Gaussian prior:
    theta (d,) with ring indices idx (m,) gives a scalar, theta (C,d) with
    idx (C,m) one potential per chain. Duel rows use the preference term,
    click rows the Bernoulli term (no feel-good: a click has no opponent).
    ``cfg.sgld_backend``: "fused" (the mixed kernel on CUDA) / "xla" (its
    plain version) / "autodiff" (``_mixed_terms_autodiff``)."""
    single = theta.dim() == 1
    th = theta[None] if single else theta
    ix = idx[None] if idx.dim() == 1 else idx
    valid = (ix < h.t).to(torch.float32)
    backend = resolve_sgld_backend(cfg.sgld_backend)
    if backend == "autodiff":
        i = ix.long()
        terms = _mixed_terms_autodiff(th, h.x[i], h.a1[i].long(),
                                      h.a2[i].long(), h.y[i], h.is_duel[i],
                                      a_emb, cfg.eta)
        data = torch.sum(terms * valid, dim=-1)
    else:
        data = mixed_potential_rows(th, h.x, h.a1, h.a2, h.y, h.is_duel, ix,
                                    valid, a_emb, eta=cfg.eta,
                                    plain=backend == "xla")
    prior = torch.sum(th * th, dim=-1) / (2.0 * cfg.prior_var)
    out = fgts._scale(valid, h.t) * data + prior
    return out[0] if single else out


def _mixed_potential_grad(theta, idx, h: MixedHistory, a_emb,
                          cfg: fgts.FGTSConfig) -> torch.Tensor:
    """dU/dtheta (C,d): the mixed gradient kernel (or its plain version)
    with g = T/m per chain, or autograd through ``mixed_potential``."""
    backend = resolve_sgld_backend(cfg.sgld_backend)
    if backend == "autodiff":
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            u = mixed_potential(th, idx, h, a_emb, cfg)
            return torch.autograd.grad(u.sum(), th)[0]
    valid = (idx < h.t).to(torch.float32)
    data = mixed_potential_grad_rows(theta, h.x, h.a1, h.a2, h.y, h.is_duel,
                                     idx, valid, a_emb,
                                     fgts._scale(valid, h.t), eta=cfg.eta,
                                     plain=backend == "xla")
    return data + theta / cfg.prior_var


def mixed_sgld_sample(draws, theta0, h: MixedHistory, a_emb,
                      cfg: fgts.FGTSConfig) -> torch.Tensor:
    """cfg.sgld_steps of SGLD for the chains theta0 (C,d) on the mixed
    pseudo-posterior; every step evaluates all chains' gradients in one
    call (one kernel launch on CUDA)."""
    return fgts.sgld_loop(
        draws.sgld(theta0.shape[0], cfg.sgld_steps), theta0,
        lambda th, idx: _mixed_potential_grad(th, idx, h, a_emb, cfg),
        h.t, h.x.shape[0], cfg)


def mixed_chain_energy(state: MixedState, a_emb,
                       cfg: fgts.FGTSConfig) -> torch.Tensor:
    """(C,) potentials U(theta) of every chain on the newest
    ``sgld_minibatch`` rows of the mixed ring (a fixed window, no draws):
    the mixed estimator's energy trace, as ``fgts.chain_energy`` is
    FGTS's. It runs the mixed forward (the kernel on CUDA)."""
    h, theta = state
    m, cap = cfg.sgld_minibatch, h.x.shape[0]
    back = torch.arange(m, device=h.x.device)
    rows = torch.remainder(h.t - 1 - back, cap).expand(theta.shape[0], m)
    return mixed_potential(theta, rows, h, a_emb, cfg)


# ---------------------------------------------------------------------------
# RoutingPolicy adapters
# ---------------------------------------------------------------------------

def _table(a_emb):
    return a_emb.a_emb if isinstance(a_emb, ModelPool) else a_emb


def mixed_feedback_policy(a_emb, cfg: fgts.FGTSConfig) -> RoutingPolicy:
    """The mixed duel + click estimator as a batched ``RoutingPolicy``.

    Protocol updates enter the ring as duel rows; click streams are folded
    in with ``inject_clicks``. State: ``MixedState`` (ring, chains). A
    ``ModelPool`` first argument makes the arm set dynamic."""
    pooled = isinstance(a_emb, ModelPool)
    pool0 = a_emb if pooled else None
    dev = _table(a_emb).device

    def init(draws):
        theta = draws.fold_in(1).normal((cfg.n_chains, cfg.dim), dev) \
            * cfg.prior_var ** 0.5
        s = MixedState(init_mixed(cfg, dev), theta)
        return PooledState(s, pool0) if pooled else s

    def act(draws, state, x):
        h, theta0 = state.inner if pooled else state
        emb = state.pool.a_emb if pooled else a_emb
        mask = state.pool.active if pooled else None
        theta = mixed_sgld_sample(draws, theta0, h, emb, cfg)
        th = theta.mean(dim=0)
        a1, a2 = select_pair(x, emb, th, th, mask=mask, distinct=True)
        out = MixedState(h, theta)
        return (state._replace(inner=out) if pooled else out), a1, a2

    def update(state, x, a1, a2, y):
        h, theta = state.inner if pooled else state
        duel = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
        out = MixedState(observe_mixed_batch(h, x, a1, a2, y, duel), theta)
        return state._replace(inner=out) if pooled else out

    return RoutingPolicy(init, act, update, name="mixed_feedback")


def inject_clicks(state, x, arms, y):
    """Fold a batch of pointwise like/dislike signals (y in {0,1}) into a
    ``mixed_feedback_policy`` state (pooled or not), outside the duel
    protocol."""
    if isinstance(state, PooledState):
        return state._replace(inner=inject_clicks(state.inner, x, arms, y))
    h, theta = state
    click = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
    return MixedState(observe_mixed_batch(h, x, arms, arms, y, click), theta)


def _pl_pair_potential(theta, idx, state: fgts.FGTSState, a_emb,
                       cfg: fgts.FGTSConfig) -> torch.Tensor:
    """U(theta) (C,) with the Plackett-Luce likelihood on the observed pair
    rankings, for chains theta (C,d) and ring indices idx (C,m). For m = 2
    PL is BTL, but the potential runs through the listwise machinery."""
    i = idx.long()
    xb, yb = state.x[i], state.y[i]
    th = theta[:, None, :]
    s = torch.stack(
        [torch.sum(phi(xb, a_emb[state.a1[i].long()]) * th, dim=-1),
         torch.sum(phi(xb, a_emb[state.a2[i].long()]) * th, dim=-1)],
        dim=-1)                                                # (C, m, 2)
    won = (yb > 0).to(torch.int64)
    ranking = torch.stack([1 - won, won], dim=-1)              # winner first
    ll = pl_log_likelihood(s, ranking)
    valid = (idx < state.t).to(torch.float32)
    prior = torch.sum(theta * theta, dim=-1) / (2.0 * cfg.prior_var)
    return fgts._scale(valid, state.t) * torch.sum(
        -cfg.eta * ll * valid, dim=-1) + prior


def _pl_pair_grad(theta, idx, state, a_emb, cfg) -> torch.Tensor:
    """dU/dtheta (C,d) by autograd (the reference takes ``jax.grad``; no
    kernel)."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        u = _pl_pair_potential(th, idx, state, a_emb, cfg)
        return torch.autograd.grad(u.sum(), th)[0]


def pl_pair_policy(a_emb, cfg: fgts.FGTSConfig) -> RoutingPolicy:
    """Listwise-likelihood router on the batched protocol (pairs
    presented): SGLD chains sample theta from the PL pseudo-posterior,
    selection is the distinct top-2 through ``select_pair``, updates fold
    into the FGTS replay ring. A ``ModelPool`` first argument makes the arm
    set dynamic."""
    pooled = isinstance(a_emb, ModelPool)
    pool0 = a_emb if pooled else None
    dev = _table(a_emb).device

    def init(draws):
        # single-theta policy: theta2 is a placeholder, not a chain set
        s = init_fgts_state(cfg, draws, dev)._replace(
            theta2=torch.zeros((1, cfg.dim), device=dev))
        return PooledState(s, pool0) if pooled else s

    def act(draws, state, x):
        inner = state.inner if pooled else state
        emb = state.pool.a_emb if pooled else a_emb
        mask = state.pool.active if pooled else None
        th1 = fgts.sgld_loop(
            draws.sgld(inner.theta1.shape[0], cfg.sgld_steps), inner.theta1,
            lambda th, idx: _pl_pair_grad(th, idx, inner, emb, cfg),
            inner.t, inner.x.shape[0], cfg)
        inner = inner._replace(theta1=th1)
        th = th1.mean(dim=0)
        a1, a2 = select_pair(x, emb, th, th, mask=mask, distinct=True)
        return (state._replace(inner=inner) if pooled else inner), a1, a2

    def update(state, x, a1, a2, y):
        if pooled:
            return state._replace(
                inner=fgts.observe_batch(state.inner, x, a1, a2, y))
        return fgts.observe_batch(state, x, a1, a2, y)

    return RoutingPolicy(init, act, update, name="pl_pair")
