"""Plain oracles for the port's kernels (counterpart of ``repro/kernels/ref.py``).

``attention_ref`` is dense masked softmax attention, differentiable by
autograd: the oracle the attention backward's plain version
(``flash_attention.flash_attention_bwd_plain``) is held against;
``rglru_ref`` the RG-LRU recurrence as a sequential loop;
``dueling_score_ref`` the dueling-score oracle; ``ssd_ref`` the
sequential SSD recurrence, against which the chunked SSD arithmetic
(``ssd_scan.ssd_scan_plain`` and the kernels' roundings) is held."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  scale=None) -> torch.Tensor:
    """q: (B,H,S,D); k/v: (B,KV,T,D). Dense masked softmax attention in
    float32 (masked scores filled with -1e30), cast back to q's type."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5 if scale is None else scale
    f32 = torch.float32
    qr = q.reshape(b, kvh, g, s, d).to(f32)
    scores = torch.einsum("bkgsd,bktd->bkgst", qr, k.to(f32)) * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(f32))
    return out.reshape(b, h, s, d).to(q.dtype)


def rglru_ref(log_a, x_in, h0=None):
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) x_t, a sequential loop.

    log_a, x_in: (B,S,D) float32. Returns (h (B,S,D), h_last (B,D))."""
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp_min(1 - torch.exp(2 * log_a), 0.0)) * x_in
    h = torch.zeros_like(x_in[:, 0]) if h0 is None else h0
    hs = []
    for t in range(x_in.shape[1]):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


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
