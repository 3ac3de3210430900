"""Full-sequence attention: GQA, causal / sliding-window / bidirectional,
with the Gemma-2 logit soft cap and RoPE (counterpart of
``repro/models/attention.py``).

The reference computes this contraction with XLA einsums and keeps its
Pallas flash kernel as the TPU drop-in; here the core always runs on the
flash wrapper (``kernels/flash_attention.py``), which dispatches by device:
the hand-written CUDA kernel on the card, the plain version on the CPU.
The projections stay ``torch.einsum``, as the reference leaves them to XLA
outside any kernel. Two things follow from the kernel's interface:

* the mask is by sequence index, where the reference's ``_mask`` compares
  positions. The two agree whenever each row's positions run
  consecutively (``arange(S)`` plus a per-row offset, kv positions equal
  to query positions), which is every full-sequence caller's case (the
  encoder, prefill from position 0);
* softmax and the p @ v product stay in fp32 for bf16 weights too (the
  reference's einsum path casts p to the weights' type first).

``cfg.gqa_impl`` does not matter here: the kernel maps each query head to
its kv head itself. Cross attention, ``cfg.attn_q_chunk`` and the decode
path with its KV caches come with the LM substrate slice and raise
``NotImplementedError`` until then.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .config import ModelConfig
from .layers import apply_rope, normal


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": normal(gen, (d, h, hd), d ** -0.5, dtype, device),
        "wk": normal(gen, (d, kv, hd), d ** -0.5, dtype, device),
        "wv": normal(gen, (d, kv, hd), d ** -0.5, dtype, device),
        "wo": normal(gen, (h, hd, d), (h * hd) ** -0.5, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=device)
    return p


def _project_qkv(params, x, kv_src, cfg):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_src, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_src, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return q, k, v


def _mask(mode: str, window: int) -> tuple[bool, int]:
    """The reference's mask of ``mode`` as the kernel's index mask:
    (causal, window)."""
    if mode == "causal":
        return True, 0
    if mode == "local":
        if window <= 0:
            raise ValueError("mode 'local' needs window > 0")
        return True, window
    if mode == "bidir":
        return False, 0
    raise ValueError(f"unknown attention mode {mode!r}")


def full_attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, *, mode: str, window: int = 0,
                   kv_src: torch.Tensor | None = None,
                   kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence self-attention of x (B,S,d) at ``positions`` (B,S);
    mode 'causal' | 'local' | 'bidir'. Returns (B,S,d)."""
    if mode == "cross" or kv_src is not None or kv_positions is not None:
        raise NotImplementedError(
            "cross attention comes with the LM substrate slice of the port")
    if cfg.attn_q_chunk:
        raise NotImplementedError(
            "attn_q_chunk comes with the LM substrate slice of the port")
    causal, win = _mask(mode, window)
    q, k, v = _project_qkv(params, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=win,
                          softcap=cfg.attn_softcap, scale=cfg.hd ** -0.5)
    return torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), params["wo"])


def init_kv_cache(*args, **kwargs):
    raise NotImplementedError(
        "KV caches come with the LM substrate slice of the port")


def decode_attention(*args, **kwargs):
    raise NotImplementedError(
        "one-token decode comes with the LM substrate slice of the port")
