"""Category-Calibrated Fine-Tuning model embeddings and the feature map
(counterpart of ``repro/core/ccft.py``).

    perf            a_k = xi softmax(s_k)                      (eq. 3)
    perf_cost       same, with s_km = perf_km - lambda*cost_km (eq. 3)
    excel_perf_cost a_k = xi softmax(top^tau(s_k))             (eq. 4)
    excel_mask      a_k = xi mask^tau(s_k) / tau               (eq. 5)

``top``/``mask`` rank each category column across models by dense rank.
phi(x, a) = (x*a)/||x*a||, scored through the two-matmul identity.
"""
from __future__ import annotations

import torch

WEIGHTINGS = ("perf", "perf_cost", "excel_perf_cost", "excel_mask")


def perf_cost_scores(perf, cost, lam: float = 0.05):
    """s = perf - lambda*cost (paper uses lambda = 0.05)."""
    return perf - lam * cost


def _dense_tau_threshold(s: torch.Tensor, tau: int) -> torch.Tensor:
    """tau-th largest *distinct* value per category column (dense ranking;
    values within 1e-9 of the previous one share its rank)."""
    srt = -torch.sort(-s, dim=0).values                   # (K, M) descending
    newv = torch.cat([torch.ones((1, s.shape[1]), dtype=torch.bool,
                                 device=s.device),
                      srt[1:] < srt[:-1] - 1e-9], dim=0)
    rank = torch.cumsum(newv.to(torch.int32), dim=0)       # dense rank 1..K
    masked = torch.where(rank <= tau, srt, torch.inf)
    return masked.amin(dim=0)


def top_tau(s: torch.Tensor, tau: int) -> torch.Tensor:
    """Keep s_km iff among the top-tau (dense-ranked) of its column (eq. 4)."""
    thresh = _dense_tau_threshold(s, tau)
    return torch.where(s >= thresh - 1e-9, s, 0.0)


def mask_tau(s: torch.Tensor, tau: int) -> torch.Tensor:
    """Binary version of top_tau (eq. 5's mask fn)."""
    thresh = _dense_tau_threshold(s, tau)
    return (s >= thresh - 1e-9).to(s.dtype)


def model_embeddings(xi: torch.Tensor, scores: torch.Tensor, weighting: str,
                     tau: int = 3) -> torch.Tensor:
    """xi: (d, M) category embeddings; scores: (K, M). Returns A: (K, d)."""
    if weighting in ("perf", "perf_cost"):
        w = torch.softmax(scores, dim=-1)
    elif weighting == "excel_perf_cost":
        w = torch.softmax(top_tau(scores, tau), dim=-1)
    elif weighting == "excel_mask":
        w = mask_tau(scores, tau) / tau
    else:
        raise ValueError(weighting)
    return w @ xi.T


def category_embeddings(query_emb: torch.Tensor, categories: torch.Tensor,
                        n_categories: int) -> torch.Tensor:
    """xi_m = mean embedding of offline queries in category m. (d, M)."""
    onehot = torch.nn.functional.one_hot(categories.long(), n_categories)
    onehot = onehot.to(query_emb.dtype)
    sums = onehot.T @ query_emb
    counts = torch.clamp_min(onehot.sum(dim=0)[:, None], 1.0)
    return (sums / counts).T


def phi(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """phi(x, a) = (x * a)/||x * a||, broadcasting (..., d)."""
    p = x * a
    n = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    return p / torch.clamp_min(n, 1e-12)


def scores_all(x: torch.Tensor, a_all: torch.Tensor,
               theta: torch.Tensor) -> torch.Tensor:
    """<theta, phi(x, a_k)> for all k: x (d,), a_all (K,d) -> (K,)."""
    num = a_all @ (x * theta)
    den = torch.sqrt(torch.clamp_min((a_all * a_all) @ (x * x), 1e-24))
    return num / den


def scores_batch(x: torch.Tensor, a_all: torch.Tensor,
                 theta: torch.Tensor) -> torch.Tensor:
    """Batched ``scores_all``: x (..., m, d), theta (..., d) -> (..., m, K),
    two matmuls (no (m, K, d) Hadamard features)."""
    num = (x * theta[..., None, :]) @ a_all.T
    den = torch.sqrt(torch.clamp_min((x * x) @ (a_all * a_all).T, 1e-24))
    return num / den
