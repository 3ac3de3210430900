"""RG-LRU recurrent block (Griffin / RecurrentGemma; counterpart of
``repro/models/rglru.py``):

    y   = GeLU(W_y x)                         gate branch (tanh form)
    u   = causal depthwise Conv1D(W_x x)      recurrent branch input
    r_t = sigmoid(W_a u_t + b_a),  i_t = sigmoid(W_i u_t + b_i)
    log a_t = c * r_t * log sigmoid(Lambda)   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)
    out = W_o (y * h)

The full-sequence scan runs on the ``rglru_scan`` wrapper (the hand-written
CUDA kernel on the card, the sequential plain version on the CPU), where
the reference uses ``lax.associative_scan`` and keeps its Pallas kernel as
the TPU drop-in. Decode is one step with the carried state.

``jax.nn.gelu`` defaults to the tanh approximation and
``torch.nn.functional.gelu`` to the exact erf form (they differ by up to
4e-4 on [-3, 3]), so the gate branch asks for ``approximate="tanh"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import rglru_scan

from .config import ModelConfig
from .hooks import LOCAL
from .layers import causal_conv, normal

C_GATE = 8.0


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, dr = cfg.d_model, cfg.d_rnn
    f32 = torch.float32
    # Lambda so that a = sigmoid(Lambda)^c spans ~[0.9, 0.999] (Griffin)
    u = 0.9 + 0.099 * torch.rand((dr,), generator=gen, device=gen.device,
                                 dtype=f32)
    u = u ** (1 / C_GATE)
    return {
        "wy": normal(gen, (d, dr), d ** -0.5, dtype, device),
        "wx": normal(gen, (d, dr), d ** -0.5, dtype, device),
        "wo": normal(gen, (dr, d), dr ** -0.5, dtype, device),
        "conv": normal(gen, (cfg.conv_width, dr), 0.1, dtype, device),
        "wa": normal(gen, (dr, dr), dr ** -0.5, dtype, device),
        "ba": torch.zeros((dr,), dtype=f32, device=device),
        "wi": normal(gen, (dr, dr), dr ** -0.5, dtype, device),
        "bi": torch.zeros((dr,), dtype=f32, device=device),
        "lambda": torch.log(u / (1 - u)).to(device),
    }


def _gates(params, u, u_gates=None):
    """u: (..., dr) -> (log_a, x_in), both float32. The gates read
    ``u_gates`` where given (a rank's gates read every channel of u)."""
    f32 = torch.float32
    uf = u.to(f32)
    ug = uf if u_gates is None or u_gates is u else u_gates.to(f32)
    r = torch.sigmoid(ug @ params["wa"].to(f32) + params["ba"])
    i = torch.sigmoid(ug @ params["wi"].to(f32) + params["bi"])
    log_a = C_GATE * r * F.logsigmoid(params["lambda"])
    return log_a, i * uf


def _causal_conv(params, u, conv_state=None):
    """``layers.causal_conv`` with the block's taps, back to u's dtype.
    Returns (out, the last W-1 inputs)."""
    out, state = causal_conv(params["conv"], u, conv_state)
    return out.to(u.dtype), state


def linear_scan(log_a: torch.Tensor, x_in: torch.Tensor,
                h0: torch.Tensor | None = None, hooks=LOCAL):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) x_t over axis 1 on the
    ``rglru_scan`` wrapper. log_a, x_in: (B,S,dr) float32. Returns
    (h (B,S,dr), h_last (B,dr))."""
    return hooks.impl(rglru_scan)(log_a, x_in, h0)


def rglru_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  hooks=LOCAL):
    """Full-sequence forward that also returns the decode cache
    ({"h": h_last, "conv": the last W-1 conv inputs}). ``hooks``:
    ``models/hooks.py``."""
    f32 = torch.float32
    x = hooks.enter(x, "wx")
    y = gelu(x @ params["wy"])
    u, conv_state = _causal_conv(params, x @ params["wx"])
    log_a, x_in = _gates(params, u, hooks.channels(u))
    h, h_last = linear_scan(log_a, x_in, hooks=hooks)
    out = hooks.leave((y.to(f32) * h) @ params["wo"].to(f32), "wo")
    return out.to(x.dtype), {"h": h_last, "conv": conv_state}


def rglru_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig,
              hooks=LOCAL) -> torch.Tensor:
    """Full-sequence forward. x: (B,S,d) -> (B,S,d)."""
    return rglru_prefill(params, x, cfg, hooks)[0]


def init_rglru_cache(batch: int, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn),
                            dtype=dtype, device=device),
    }


def rglru_step(params: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token decode. x: (B,1,d). The new state is written into
    ``cache`` in place (the reference returns a new one), rounded as
    ``a * h + b`` is. Returns (out (B,1,d), cache)."""
    f32 = torch.float32
    y = gelu(x @ params["wy"])                          # (B,1,dr)
    u, conv_state = _causal_conv(params, x @ params["wx"], cache["conv"])
    log_a, x_in = _gates(params, u[:, 0])               # (B,dr)
    a = torch.exp(log_a)
    h = cache["h"].mul_(a).add_(
        torch.sqrt(torch.clamp_min(1 - a * a, 0.0)) * x_in)
    cache["conv"].copy_(conv_state)
    out = (y[:, 0].to(f32) * h) @ params["wo"].to(f32)
    return out[:, None].to(x.dtype), cache
