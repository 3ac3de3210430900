"""Plain oracles for the port's kernels (counterpart of ``repro/kernels/ref.py``;
only the dueling-score oracle is on the ported path so far)."""
from __future__ import annotations

import torch


def dueling_score_ref(x, a, theta1, theta2) -> torch.Tensor:
    """phi(x, a_k) = (x*a_k)/||x*a_k||; s_jk = <theta_j, phi>.

    x: (B,d), a: (K,d), theta: (d,). Returns scores (2,B,K) float32 through
    the explicit (B,K,d) Hadamard features (no matmul identity)."""
    xf, af = x.to(torch.float32), a.to(torch.float32)
    prod = xf[:, None, :] * af[None, :, :]                 # (B,K,d)
    norm = torch.clamp_min(torch.sqrt(torch.sum(prod * prod, dim=-1)), 1e-12)
    s1 = torch.einsum("bkd,d->bk", prod, theta1.to(torch.float32)) / norm
    s2 = torch.einsum("bkd,d->bk", prod, theta2.to(torch.float32)) / norm
    return torch.stack([s1, s2])
