"""Shared primitive layers: RMSNorm, RoPE, gated MLP, embeddings
(counterpart of ``repro/models/layers.py``).

Initializers draw from an explicit ``torch.Generator`` on the generator's
device (a CPU generator gives a card run and a CPU run the same weights)
and move the result to ``device``.
"""
from __future__ import annotations

import numpy as np
import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in float32, back to x's
    dtype (the gain is ``1 + scale``: a zero scale is the identity)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Rotary frequencies, computed in numpy float32 as the reference does."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the
    two halves of the head dim against each other (not interleaved
    pairs)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                     # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gated_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: w2( silu(w1 x) * w3 x )."""
    h = torch.nn.functional.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]


def normal(gen: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    """std * N(0, 1) of ``shape`` from ``gen`` (on its own device), cast to
    ``dtype`` and moved to ``device``."""
    z = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (z * std).to(dtype=dtype, device=device)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device) -> dict:
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "w1": normal(gen, (d_model, d_ff), s_in, dtype, device),
        "w3": normal(gen, (d_model, d_ff), s_in, dtype, device),
        "w2": normal(gen, (d_ff, d_model), s_ff, dtype, device),
    }


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype,
                   device) -> torch.Tensor:
    return normal(gen, (vocab, d_model), d_model ** -0.5, dtype, device)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
