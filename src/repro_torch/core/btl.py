"""Bradley-Terry-Luce preference model (counterpart of ``repro/core/btl.py``).

P(y = +1 | r1, r2) = exp(-sigma(r1 - r2)) = sigmoid(r1 - r2), with
sigma(z) = log(1 + exp(-z)). y = +1 means a1 preferred, -1 means a2.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sgld_update import softplus


def logistic_loss(z: torch.Tensor) -> torch.Tensor:
    """sigma(z) = log(1 + exp(-z)) — the paper's preference loss."""
    return softplus(-z)


def preference_prob(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """P(y = +1 | r1, r2) = sigmoid(r1 - r2)."""
    return torch.sigmoid(r1 - r2)


def sample_preference(draws, r1: torch.Tensor,
                      r2: torch.Tensor) -> torch.Tensor:
    """Draw y in {+1, -1} from the BTL model; the uniforms come from the
    draw source ``draws`` (see ``core.draws``)."""
    p = preference_prob(r1, r2)
    u = draws.uniform(tuple(p.shape), p.device)
    return torch.where(u < p, 1.0, -1.0).to(torch.float32)
