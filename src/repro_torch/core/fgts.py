"""FGTS.CDB — Feel-Good Thompson Sampling for Contextual Dueling Bandits,
instantiated for LLM routing (paper Alg. 1); counterpart of
``repro/core/fgts.py``.

Per round t:
  1. sample theta^j (j = 1,2) from the pseudo-posterior
         p^j(theta | S_{t-1}) ∝ exp(-sum_i L^j(theta, x_i, a1_i, a2_i, y_i)) p0(theta)
     by SGLD, warm-started from the previous round's chains;
  2. select a^j_t = argmax_k <theta^j, phi(x_t, a_k)>;
  3. observe y_t and append it to the replay ring.

The chains of a sample are one leading axis (C, d) throughout: every SGLD
step draws all chains' minibatches at once and evaluates all their
gradients in one call of ``kernels.potential_grad_rows`` (one kernel launch
on CUDA). Randomness comes from a draw source (``core.draws``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.dueling_score import mask_fallback_pair
from repro_torch.kernels.sgld_update import (potential_grad_rows,
                                             potential_rows,
                                             resolve_sgld_backend)
from repro_torch.optim.sgld import decayed_step_size

from .btl import logistic_loss
from .ccft import scores_all, scores_batch


@dataclasses.dataclass(frozen=True)
class FGTSConfig:
    n_models: int
    dim: int
    horizon: int                     # replay-ring capacity H
    eta: float = 1.0                 # preference-likelihood weight
    mu: float = 0.2                  # feel-good weight
    prior_var: float = 1.0           # Gaussian prior p0 variance
    sgld_steps: int = 15
    sgld_eps: float = 5e-4           # SGLD base step size
    sgld_minibatch: int = 128
    sgld_decay_t0: float = 100.0     # eps_t = eps0 * (t0/(t0+t))^pow
    sgld_decay_pow: float = 0.0      # 0 = constant steps
    sgld_temp: float = 1.0           # noise *= sqrt(temp)
    force_distinct: bool = False     # force a2 != a1 at selection
    n_chains: int = 1                # SGLD chains per theta sample
    # "auto"/"fused": the CUDA kernel on a CUDA device, the plain version
    # on the CPU; "xla": the plain version, forced; "autodiff":
    # torch.autograd through likelihood_batch
    sgld_backend: str = "auto"


class FGTSState(NamedTuple):
    x: torch.Tensor        # (H, dim) query features
    a1: torch.Tensor       # (H,) int32
    a2: torch.Tensor       # (H,) int32
    y: torch.Tensor        # (H,) float32 (+1/-1)
    t: torch.Tensor        # () int32 — rounds seen
    theta1: torch.Tensor   # (dim,) or (C, dim) current posterior samples
    theta2: torch.Tensor
    pref: torch.Tensor | None = None   # (H,) pref each duel was served under


def init_state(cfg: FGTSConfig, draws, device=None) -> FGTSState:
    dev = resolve_device(device)
    k1, k2 = draws.split(2)
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
    return FGTSState(
        x=z(cfg.horizon, cfg.dim),
        a1=z(cfg.horizon, dt=torch.int32),
        a2=z(cfg.horizon, dt=torch.int32),
        y=z(cfg.horizon),
        t=torch.zeros((), dtype=torch.int32, device=dev),
        theta1=k1.normal((cfg.dim,), dev) * cfg.prior_var ** 0.5,
        theta2=k2.normal((cfg.dim,), dev) * cfg.prior_var ** 0.5,
        pref=z(cfg.horizon),
    )


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(v, -1, idx.long()[..., None])[..., 0]


def likelihood_batch(theta, x, a1, a2, y, a_emb, j: int, cfg: FGTSConfig,
                     arm_mask=None, pref=None, costs=None) -> torch.Tensor:
    """L^j over a minibatch: theta (..., d), x (..., m, d) -> (..., m).

    ``arm_mask`` (K,) bool restricts the feel-good max to active arms;
    ``pref`` (..., m) with ``costs`` (K,) tilts it per row by pref_i*cost_k
    and weights it mu / (1 + max(pref_i, 0)). The autograd oracle of the
    SGLD kernel."""
    s_all = scores_batch(x, a_emb, theta)                  # (..., m, K)
    s1, s2 = _take(s_all, a1), _take(s_all, a2)
    pref_ll = cfg.eta * logistic_loss(y * (s1 - s2))
    tilted = pref is not None and costs is not None
    if tilted:
        t = pref[..., None] * costs
        s_all = s_all - t
        t_opp = _take(t, a2 if j == 1 else a1)
    else:
        t_opp = 0.0
    if arm_mask is not None:
        s_all = torch.where(arm_mask, s_all, -torch.inf)
    s_opp = (s2 if j == 1 else s1) - t_opp
    feelgood = s_all.amax(dim=-1) - s_opp
    if tilted:
        mu_row = cfg.mu / (1.0 + torch.clamp_min(pref, 0.0))
        return pref_ll - mu_row * feelgood
    return pref_ll - cfg.mu * feelgood


def _scale(valid: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """T / n_valid per chain: the minibatch estimate of the full sum."""
    return t.to(torch.float32) / torch.clamp_min(valid.sum(dim=-1), 1.0)


def _rows_pref(state: FGTSState, costs):
    return None if (state.pref is None or costs is None) else state.pref


def _potential(theta, idx, state: FGTSState, a_emb, j: int, cfg: FGTSConfig,
               arm_mask=None, costs=None, valid=None) -> torch.Tensor:
    """U(theta_c) = (T/m) * sum_minibatch L^j + ||theta_c||^2/(2 prior_var)
    for theta (C,d) and minibatch ring indices idx (C,m) -> (C,). ``valid``
    defaults to the drawn slots below the round count."""
    if valid is None:
        valid = (idx < state.t).to(torch.float32)
    scale = _scale(valid, state.t)
    pref = _rows_pref(state, costs)
    backend = resolve_sgld_backend(cfg.sgld_backend)
    if backend == "autodiff":
        i = idx.long()
        terms = likelihood_batch(theta, state.x[i], state.a1[i], state.a2[i],
                                 state.y[i], a_emb, j, cfg, arm_mask=arm_mask,
                                 pref=None if pref is None else pref[i],
                                 costs=costs)
        data = torch.sum(terms * valid, dim=-1)
    else:
        data = potential_rows(theta, state.x, state.a1, state.a2, state.y,
                              pref, idx, valid, a_emb, arm_mask,
                              None if pref is None else costs, j=j,
                              eta=cfg.eta, mu=cfg.mu,
                              plain=backend == "xla")
    prior = torch.sum(theta * theta, dim=-1) / (2.0 * cfg.prior_var)
    return scale * data + prior


def _potential_grad(theta, idx, state: FGTSState, a_emb, j: int,
                    cfg: FGTSConfig, arm_mask=None, costs=None):
    """dU/dtheta (C,d). The fused / xla backends call the gradient kernel
    (or its plain version) directly, with g = T/m per chain — no forward
    pass; autodiff differentiates ``_potential`` with torch.autograd."""
    backend = resolve_sgld_backend(cfg.sgld_backend)
    if backend == "autodiff":
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            u = _potential(th, idx, state, a_emb, j, cfg, arm_mask, costs)
            return torch.autograd.grad(u.sum(), th)[0]
    valid = (idx < state.t).to(torch.float32)
    pref = _rows_pref(state, costs)
    data = potential_grad_rows(theta, state.x, state.a1, state.a2, state.y,
                               pref, idx, valid, a_emb, arm_mask,
                               None if pref is None else costs,
                               _scale(valid, state.t), j=j, eta=cfg.eta,
                               mu=cfg.mu, plain=backend == "xla")
    return data + theta / cfg.prior_var


def sgld_loop(sgld_draws, theta0, grad_fn, n_obs, capacity: int,
              cfg: FGTSConfig, eps=None):
    """SGLD chains theta0 (C,d) over a ring-buffered history.

    Minibatch indices are drawn over the valid slots [0, max(min(n_obs,
    capacity), 1)); ``grad_fn(theta, idx) -> dU/dtheta`` for all chains;
    ``sgld_draws.step`` gives each step's indices and noise."""
    eps = cfg.sgld_eps if eps is None else eps
    hi = torch.clamp_min(torch.clamp_max(n_obs, capacity), 1)
    c, d = theta0.shape
    theta = theta0
    for i in range(cfg.sgld_steps):
        idx, noise = sgld_draws.step(i, cfg.sgld_minibatch, hi, d,
                                     theta.device)
        g = grad_fn(theta, idx)
        theta = theta - 0.5 * eps * g + torch.sqrt(
            torch.as_tensor(eps * cfg.sgld_temp)) * noise
    return theta


def sgld_sample(draws, theta0, state: FGTSState, a_emb, j: int,
                cfg: FGTSConfig, arm_mask=None, costs=None):
    """cfg.sgld_steps of SGLD for the chains theta0 (C,d) of sample j, with
    the decaying step size in the round count. ``draws`` is the sample's
    source: its ``sgld(C, steps)`` replays the reference's per-chain keys.
    A single theta0 (d,) is one chain drawn from ``draws`` itself
    (``sgld(None, steps)``), as the reference's unbatched call."""
    t = state.t.to(torch.float32)
    eps = decayed_step_size(cfg.sgld_eps, t, cfg.sgld_decay_t0,
                            cfg.sgld_decay_pow)
    single = theta0.dim() == 1
    chains = theta0[None] if single else theta0
    theta = sgld_loop(
        draws.sgld(None if single else chains.shape[0], cfg.sgld_steps),
        chains,
        lambda th, idx: _potential_grad(th, idx, state, a_emb, j, cfg,
                                        arm_mask, costs),
        state.t, state.x.shape[0], cfg, eps=eps)
    return theta[0] if single else theta


def chain_energy(state: FGTSState, a_emb, cfg: FGTSConfig, arm_mask=None,
                 costs=None) -> torch.Tensor:
    """(2, C) potentials U(theta) of every chain of both samples on the
    newest ``sgld_minibatch`` duels of the ring (a fixed window, no draws):
    the SGLD energy trace, read per tick to watch the chains mix. It runs
    the potential's forward (the kernel on CUDA)."""
    m, cap = cfg.sgld_minibatch, state.x.shape[0]
    back = torch.arange(m, device=state.x.device)
    rows = torch.remainder(state.t - 1 - back, cap)
    valid = (back < torch.clamp_max(state.t, cap)).to(torch.float32)
    out = []
    for j, th in ((1, state.theta1), (2, state.theta2)):
        c = th.shape[0]
        out.append(_potential(th, rows.expand(c, m), state, a_emb, j, cfg,
                              arm_mask, costs, valid.expand(c, m)))
    return torch.stack(out)


def select_arms(theta1, theta2, x_t, a_emb, force_distinct: bool = False,
                arm_mask=None):
    """Alg. 1 line 6 for one query x_t (d,), over active arms when
    ``arm_mask`` is given (single survivor: (k, k))."""
    s1 = scores_all(x_t, a_emb, theta1)
    s2 = scores_all(x_t, a_emb, theta2)
    if arm_mask is not None:
        s1 = torch.where(arm_mask, s1, -torch.inf)
        s2 = torch.where(arm_mask, s2, -torch.inf)
    a1 = torch.argmax(s1)
    if force_distinct:
        s2 = s2.clone()
        s2[a1] = -torch.inf
    a2 = torch.argmax(s2)
    if arm_mask is not None:
        a2 = mask_fallback_pair(s2, a1, a2)
    return a1.to(torch.int32), a2.to(torch.int32)


def fgts_round(draws, state: FGTSState, x_t, a_emb, cfg: FGTSConfig):
    """One full FGTS.CDB round before feedback, for the state's single
    thetas (d,) and one query x_t (d,): both samples' SGLD, then the pair.
    Returns (state', a1, a2)."""
    k1, k2 = draws.split(2)
    theta1 = sgld_sample(k1, state.theta1, state, a_emb, 1, cfg)
    theta2 = sgld_sample(k2, state.theta2, state, a_emb, 2, cfg)
    a1, a2 = select_arms(theta1, theta2, x_t, a_emb, cfg.force_distinct)
    return state._replace(theta1=theta1, theta2=theta2), a1, a2


def set_at(buf: torch.Tensor, i, v) -> torch.Tensor:
    """``buf.at[i].set(v)``: a copy of ``buf`` with row ``i`` replaced."""
    out = buf.clone()
    out[i] = torch.as_tensor(v, device=buf.device).to(buf.dtype)
    return out


def observe(state: FGTSState, x_t, a1, a2, y, pref=0.0) -> FGTSState:
    """Append one duel to the ring (ring on overflow)."""
    i = (state.t % state.x.shape[0]).long()
    return state._replace(
        x=set_at(state.x, i, x_t), a1=set_at(state.a1, i, a1),
        a2=set_at(state.a2, i, a2), y=set_at(state.y, i, y), t=state.t + 1,
        pref=None if state.pref is None else set_at(state.pref, i, pref))


def ring_slots(t: torch.Tensor, capacity: int, b: int):
    """Write slots of a B-item sequential append at count t: drop the first
    ``drop`` items (only the last ``capacity`` survive), scatter the rest
    at ``idx`` (unique)."""
    drop = max(0, b - capacity)
    idx = (t + drop + torch.arange(b - drop, device=t.device)) % capacity
    return drop, idx.long()


def scatter_drop(buf: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``buf.at[idx].set(vals, mode="drop")`` for indices in [0, len(buf)]:
    torch's scatter has no drop mode, so write into a copy with one spare
    row, where every dropped index (== len(buf)) lands, and cut the spare
    row off. No host sync (filtering the indices first would need one)."""
    n = buf.shape[0]
    out = torch.cat([buf, buf[:1]])
    vals = torch.as_tensor(vals, device=buf.device).to(buf.dtype)
    out.index_put_((idx,), vals.expand((idx.shape[0],) + buf.shape[1:]))
    return out[:n]


def observe_batch(state: FGTSState, x_b, a1, a2, y, mask=None,
                  pref=None) -> FGTSState:
    """Fold B duels into the ring with one scatter per buffer, as B
    sequential ``observe`` calls would (wraparound included).

    With ``mask`` (B,) bool only kept rows are folded: kept row i lands at
    (t + rank_i) mod H, rank counted over kept rows; masked rows and kept
    rows beyond the last H are dropped; t advances by the kept count."""
    b = x_b.shape[0]
    cap = state.x.shape[0]
    if pref is None:
        pref = torch.zeros((b,), dtype=torch.float32, device=x_b.device)
    if mask is None:
        drop, idx = ring_slots(state.t, cap, b)
        put = lambda buf, v: buf.index_put((idx,), v[drop:].to(buf.dtype))
        return state._replace(
            x=put(state.x, x_b), a1=put(state.a1, a1), a2=put(state.a2, a2),
            y=put(state.y, y), t=state.t + b,
            pref=None if state.pref is None else put(state.pref, pref))
    mask = mask.to(torch.bool)
    rank = torch.cumsum(mask.to(torch.int32), dim=0) - 1
    n = mask.sum().to(state.t.dtype)
    write = mask & (rank >= n - cap)          # last `cap` kept rows only
    idx = torch.where(write, (state.t + rank) % cap, cap).long()
    put = lambda buf, v: scatter_drop(buf, idx, v)
    return state._replace(
        x=put(state.x, x_b), a1=put(state.a1, a1), a2=put(state.a2, a2),
        y=put(state.y, y), t=state.t + n,
        pref=None if state.pref is None else put(state.pref, pref))
