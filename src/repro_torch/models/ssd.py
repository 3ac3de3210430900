"""Mamba-2 block on the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060; counterpart of ``repro/models/ssd.py``):

    dt_t = softplus(dt_raw_t + dt_bias)            (H,)
    a_t  = exp(-exp(A_log) * dt_t)                 scalar decay per head
    h_t  = a_t h_{t-1} + dt_t (x_t B_t^T)          h: (H, P, N)
    y_t  = h_t C_t + D x_t

The chunked core runs on the ``ssd_scan`` wrapper (the hand-written CUDA
kernel on the card, the Pallas kernel's chunked arithmetic on the CPU),
where the reference uses an associative scan over chunks and keeps its
Pallas kernel as the TPU drop-in. The softplus is ``logaddexp(v, 0)`` as
``jax.nn.softplus`` computes it (``F.softplus`` turns into the identity
above 20), and the gated RMSNorm runs in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.sgld_update import softplus
from repro_torch.kernels.ssd_scan import ssd_scan

from .config import ModelConfig
from .hooks import LOCAL
from .layers import causal_conv, normal


def init_ssd(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    f32 = torch.float32

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((h,), generator=gen,
                                           device=gen.device, dtype=f32)
    return {
        # in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": normal(gen, (d, 2 * di + 2 * n + h), d ** -0.5, dtype,
                          device),
        "conv": normal(gen, (cfg.conv_width, di + 2 * n), 0.1, dtype, device),
        "dt_bias": torch.log(torch.expm1(uniform(1e-3, 0.1))).to(device),
        "a_log": torch.log(uniform(1.0, 16.0)).to(device),
        "d_skip": torch.ones((h,), dtype=f32, device=device),
        "norm_z": torch.zeros((di,), dtype=f32, device=device),
        "out_proj": normal(gen, (di, d), di ** -0.5, dtype, device),
    }


def _split_proj(params, x, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ params["in_proj"]
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(w, u, conv_state=None):
    """``layers.causal_conv`` then SiLU in float32, back to u's dtype.
    Returns (out, the last W-1 inputs)."""
    out, state = causal_conv(w, u, conv_state)
    return F.silu(out).to(u.dtype), state


def ssd_chunked(xh, bt, ct, log_a, dt, chunk: int, h0=None, hooks=LOCAL):
    """Chunked SSD core on the ``ssd_scan`` wrapper.

    xh:    (B, S, H, P)  inputs per head
    bt,ct: (B, S, N)     input/output state projections (shared by heads)
    log_a: (B, S, H)     per-step log decay (negative)
    dt:    (B, S, H)     step sizes
    Returns (y (B,S,H,P), h_last (B,H,P,N)), float32.
    """
    f32 = torch.float32
    return hooks.impl(ssd_scan)(xh, bt, ct, log_a.to(f32), dt.to(f32),
                                None if h0 is None else h0.to(f32),
                                chunk=chunk)


def _gated_norm(params, y, z):
    """Mamba-2's gated RMSNorm before out_proj, in float32."""
    y = y * F.silu(z.to(torch.float32))
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-6) * (1.0 + params["norm_z"])


def ssd_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                hooks=LOCAL):
    """Full-sequence Mamba-2 block that also returns the decode cache
    ({"h": h_last, "conv": the last W-1 conv inputs}); the reference's
    ``blocks._ssd_prefill``, which ``ssd_fwd`` repeats without the cache.
    ``hooks``: ``models/hooks.py``."""
    b, s, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xbc, conv_state = _causal_conv(params["conv"], xbc)
    xs = xbc[..., :di].reshape(b, s, h, p)
    bt, ct = xbc[..., di:di + n], xbc[..., di + n:]
    dt = softplus(dt_raw.to(f32) + params["dt_bias"])          # (B,S,H)
    log_a = -torch.exp(params["a_log"]) * dt
    y, h_last = ssd_chunked(xs, bt, ct, log_a, dt, cfg.ssm_chunk,
                            hooks=hooks)
    y = y + params["d_skip"][:, None] * xs.to(f32)
    y = hooks.keep(_gated_norm(params, y.reshape(b, s, di), z), "out_proj")
    out = hooks.leave(y @ params["out_proj"].to(f32), "out_proj")
    return out.to(x.dtype), {"h": h_last, "conv": conv_state}


def ssd_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig,
            hooks=LOCAL) -> torch.Tensor:
    """Full-sequence Mamba-2 block. x: (B,S,d) -> (B,S,d)."""
    return ssd_prefill(params, x, cfg, hooks)[0]


def init_ssd_cache(batch: int, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
    }


def ssd_step(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token decode. x: (B,1,d). The new state is written into
    ``cache`` in place (the reference returns a new one), rounded as
    ``a * h + b`` is. Returns (out (B,1,d), cache)."""
    b = x.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xbc, conv_state = _causal_conv(params["conv"], xbc, cache["conv"])
    xbc = xbc[:, 0]
    xs = xbc[..., :di].reshape(b, h, p).to(f32)
    bt = xbc[..., di:di + n].to(f32)
    ct = xbc[..., di + n:].to(f32)
    dt = softplus(dt_raw[:, 0].to(f32) + params["dt_bias"])   # (B,H)
    a = torch.exp(-torch.exp(params["a_log"]) * dt)           # (B,H)
    hs = cache["h"].mul_(a[:, :, None, None]).add_(torch.einsum(
        "bh,bhp,bn->bhpn", dt, xs, bt))
    cache["conv"].copy_(conv_state)
    y = torch.einsum("bhpn,bn->bhp", hs, ct) + params["d_skip"][:, None] * xs
    y = _gated_norm(params, y.reshape(b, di), z[:, 0])
    out = (y @ params["out_proj"].to(f32)).to(x.dtype)
    return out[:, None], cache
