"""Plain oracles for the port's kernels (counterpart of ``repro/kernels/ref.py``).

``dueling_score_ref`` is the dueling-score oracle; ``ssd_ref`` the
sequential SSD recurrence, against which the chunked SSD arithmetic
(``ssd_scan.ssd_scan_plain`` and the kernels' roundings) is held. The
reference's ``attention_ref`` and ``rglru_ref`` have no port counterpart
yet: ``flash_attention_plain`` and ``rglru_scan_plain`` compute the same
functions."""
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


def ssd_ref(x, bt, ct, log_a, dt, h0=None):
    """Sequential SSD recurrence oracle.

    x: (B,S,H,P); bt/ct: (B,S,N); log_a/dt: (B,S,H); h0: (B,H,P,N) or None.
    h_t = a_t h_{t-1} + dt_t x_t B_t^T ; y_t = h_t C_t, in float32.
    Returns (y (B,S,H,P), h_last (B,H,P,N))."""
    b, s, h, p = x.shape
    n = bt.shape[-1]
    f32 = torch.float32
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    x, bt, ct = x.to(f32), bt.to(f32), ct.to(f32)
    ys = []
    for t in range(s):
        a = torch.exp(log_a[:, t].to(f32))                        # (B,H)
        state = a[:, :, None, None] * state + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t].to(f32), x[:, t], bt[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, ct[:, t]))
    return torch.stack(ys, dim=1), state
