"""Posterior dominance: which arms the posterior says are strictly beaten,
and with what probability (counterpart of ``repro/autopilot/dominance.py``).

For arms (i, j) the context-free preference direction is the sign of
theta . (e_i - e_j) on the normalized embeddings, so the fraction of
posterior samples preferring i over j estimates

    P[ theta . (e_i - e_j) > 0 | history ].

``dominance_matrix`` computes that (K, K) matrix in one shot from the
per-sample arm scores of ``kernels.dueling_score.posterior_scores`` (the
``dueling_score`` kernel on CUDA tensors) or the reference formula below.
"""
from __future__ import annotations

import torch

from repro_torch.core.model_pool import ModelPool
from repro_torch.kernels.dueling_score import posterior_scores


def posterior_scores_ref(a: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """s_ck = <theta_c, a_k> / ||a_k||: a (K, d), thetas (C, d) -> (C, K)."""
    den = torch.sqrt(torch.clamp_min(torch.sum(a * a, dim=-1), 1e-24))
    return (thetas @ a.T) / den[None, :]


def win_matrix(scores: torch.Tensor) -> torch.Tensor:
    """(C, K) per-sample arm scores -> (K, K) pairwise win fractions:
    P[i, j] = mean over samples of 1[s_i > s_j], ties counting 1/2. The
    mean is the sum times 1/C, rounded as ``jnp.mean`` rounds it, so the
    fractions compare with tau exactly as the reference's do."""
    gt = (scores[:, :, None] > scores[:, None, :]).to(torch.float32)
    eq = (scores[:, :, None] == scores[:, None, :]).to(torch.float32)
    return torch.sum(gt + 0.5 * eq, dim=0) * (1.0 / scores.shape[0])


def dominance_matrix(chains: torch.Tensor, pool: ModelPool | torch.Tensor, *,
                     use_kernel: bool = True) -> torch.Tensor:
    """P[theta . (e_i - e_j) > 0] over the posterior samples ``chains``
    (C, d), all pairs, for a ``ModelPool`` (its padded table; mask with
    ``pool.active`` downstream) or a raw (K, d) table. ``use_kernel=False``
    takes ``posterior_scores_ref``. Returns (K, K) float32."""
    a = pool.a_emb if isinstance(pool, ModelPool) else pool
    s = posterior_scores(a, chains) if use_kernel \
        else posterior_scores_ref(a, chains)
    return win_matrix(s)


def dominated_by_cheaper(dom: torch.Tensor, costs: torch.Tensor,
                         eligible_winner: torch.Tensor,
                         eligible_loser: torch.Tensor,
                         tau: float) -> torch.Tensor:
    """The cost-aware retire predicate: arm j is dominated iff some arm i
    with ``eligible_winner[i]`` and costs[i] <= costs[j] has dom[i, j] >=
    tau; only ``eligible_loser`` arms can be, and never by themselves.
    Returns (K,) bool."""
    k = dom.shape[0]
    cheaper = costs[:, None] <= costs[None, :]
    eye = torch.eye(k, dtype=torch.bool, device=dom.device)
    beats = (dom >= tau) & cheaper & eligible_winner[:, None] & ~eye
    return torch.any(beats, dim=0) & eligible_loser
