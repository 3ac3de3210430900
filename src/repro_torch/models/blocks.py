"""Transformer blocks: pre-norm mixer + pre-norm FFN, dispatched by
``LayerSpec`` (counterpart of ``repro/models/blocks.py``).

A *unit* is one repetition of ``cfg.pattern``; its parameters and caches
are dicts keyed by the layer's index in the pattern, as in the reference.
The port runs every mixer (global, local, bidirectional and cross
attention, RG-LRU, SSD) and every FFN (gated MLP, the MoE FFNs of
``models/moe.py``), for the full sequence, prefill (which also fills the
decode cache) and one-token decode. A cross-attention layer is causal
self-attention, then attention to the encoder's memory; its cache holds
the memory's K/V (``xk``, ``xv``), written once by prefill.
"""
from __future__ import annotations

import torch

from . import attention as attn_lib
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import ssd as ssd_lib
from .config import (FFN_MLP, FFN_MOE, FFN_MOE_DENSE, FFN_NONE,
                     MIXER_BIDIR_ATTN, MIXER_CROSS_ATTN, MIXER_GLOBAL_ATTN,
                     MIXER_LOCAL_ATTN, MIXER_RGLRU, MIXER_SSD, LayerSpec,
                     ModelConfig)
from .hooks import LOCAL
from .layers import gated_mlp, init_mlp, rms_norm

# the self-attention mode of each attention mixer (a cross-attention
# layer's own tokens attend causally)
_MODES = {MIXER_GLOBAL_ATTN: "causal", MIXER_LOCAL_ATTN: "local",
          MIXER_BIDIR_ATTN: "bidir", MIXER_CROSS_ATTN: "causal"}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               dtype, device) -> dict:
    d = cfg.d_model
    p: dict = {"norm1": torch.zeros((d,), dtype=torch.float32, device=device)}
    if spec.mixer == MIXER_RGLRU:
        p["mixer"] = rglru_lib.init_rglru(gen, cfg, dtype, device)
    elif spec.mixer == MIXER_SSD:
        p["mixer"] = ssd_lib.init_ssd(gen, cfg, dtype, device)
    else:
        p["mixer"] = attn_lib.init_attn(gen, cfg, dtype, device)
        if spec.mixer == MIXER_CROSS_ATTN:
            p["norm_x"] = torch.zeros((d,), dtype=torch.float32,
                                      device=device)
            p["xattn"] = attn_lib.init_attn(gen, cfg, dtype, device)
    if spec.ffn != FFN_NONE:
        p["norm2"] = torch.zeros((d,), dtype=torch.float32, device=device)
    if spec.ffn == FFN_MLP:
        p["ffn"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    elif spec.ffn in (FFN_MOE, FFN_MOE_DENSE):
        p["ffn"] = moe_lib.init_moe(gen, cfg, dtype, device)
    return p


def init_unit(gen: torch.Generator, cfg: ModelConfig, specs, dtype,
              device) -> dict:
    return {str(i): init_block(gen, cfg, s, dtype, device)
            for i, s in enumerate(specs)}


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _ffn(params, x, cfg, spec, moe_impl, hooks=LOCAL):
    """x plus the block's FFN of its norm, and the FFN's aux loss (None
    without an MoE). ``hooks``: the FFN's (``models/hooks.py``)."""
    if spec.ffn == FFN_NONE:
        return x, None
    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    if spec.ffn == FFN_MLP:
        f = gated_mlp(params["ffn"], hooks.enter(h, "w2"))
        return x + hooks.leave(f, "w2"), None
    f, aux = hooks.impl(moe_lib.moe_ffn)(params["ffn"], h, cfg,
                                         impl=moe_impl)
    return x + f, aux


def _memory_positions(enc_memory):
    b, t = enc_memory.shape[:2]
    return torch.arange(t, dtype=torch.int32,
                        device=enc_memory.device).expand(b, t)


def block_fwd(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, spec: LayerSpec, *,
              enc_memory: torch.Tensor | None = None,
              moe_impl: str | None = None, hooks=LOCAL):
    """Returns (x, aux_loss): the MoE's load-balance loss, 0 for other
    FFNs. ``moe_impl`` None defers to ``cfg.moe_impl``. ``hooks``: one
    device, or one rank of a sharded program (``models/hooks.py``)."""
    moe_impl = moe_impl or cfg.moe_impl
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    mh = hooks.sub("mixer")
    if spec.mixer == MIXER_RGLRU:
        m = rglru_lib.rglru_fwd(params["mixer"], h, cfg, mh)
    elif spec.mixer == MIXER_SSD:
        m = ssd_lib.ssd_fwd(params["mixer"], h, cfg, mh)
    else:
        m = attn_lib.full_attention(params["mixer"], h, positions, cfg,
                                    mode=_MODES[spec.mixer],
                                    window=cfg.window, hooks=mh)
    x = x + m
    if spec.mixer == MIXER_CROSS_ATTN:
        h = rms_norm(x, params["norm_x"], cfg.norm_eps)
        x = x + attn_lib.full_attention(
            params["xattn"], h, positions, cfg, mode="cross",
            kv_src=enc_memory, kv_positions=_memory_positions(enc_memory),
            hooks=hooks.sub("xattn"))
    x, aux = _ffn(params, x, cfg, spec, moe_impl, hooks.sub("ffn"))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_block_cache(batch: int, cfg: ModelConfig, spec: LayerSpec,
                     cache_len: int, dtype, device, enc_len: int = 0) -> dict:
    if spec.mixer == MIXER_GLOBAL_ATTN:
        return {"kv": attn_lib.init_kv_cache(batch, cache_len, cfg, dtype,
                                             device)}
    if spec.mixer == MIXER_LOCAL_ATTN:
        return {"kv": attn_lib.init_kv_cache(
            batch, min(cfg.window, cache_len), cfg, dtype, device)}
    if spec.mixer == MIXER_CROSS_ATTN:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.hd)
        return {"kv": attn_lib.init_kv_cache(batch, cache_len, cfg, dtype,
                                             device),
                "xk": torch.zeros(shape, dtype=dtype, device=device),
                "xv": torch.zeros(shape, dtype=dtype, device=device)}
    if spec.mixer == MIXER_RGLRU:
        return {"rnn": rglru_lib.init_rglru_cache(batch, cfg, dtype, device)}
    if spec.mixer == MIXER_SSD:
        return {"ssm": ssd_lib.init_ssd_cache(batch, cfg, dtype, device)}
    raise ValueError(f"mixer {spec.mixer!r} has no decode cache")


def init_unit_cache(batch: int, cfg: ModelConfig, specs, cache_len: int,
                    dtype, device, enc_len: int = 0) -> dict:
    return {str(i): init_block_cache(batch, cfg, s, cache_len, dtype, device,
                                     enc_len)
            for i, s in enumerate(specs)}


# ---------------------------------------------------------------------------
# One-token decode
# ---------------------------------------------------------------------------

def _cross_attn_cached(params, x, xk, xv, cfg):
    """x (B,1,d) attends to the cached memory K/V (B,T,KV,hd): plain
    PyTorch, as the reference has no kernel there, and no soft cap (the
    reference applies none here)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    scores = attn_lib._gqa_scores(q, xk).to(torch.float32) * (cfg.hd ** -0.5)
    p = torch.softmax(scores, dim=-1).to(xv.dtype)
    out = attn_lib._gqa_out(p, xv)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def block_step(params: dict, x: torch.Tensor, cache: dict, pos,
               cfg: ModelConfig, spec: LayerSpec):
    """One-token decode. x: (B,1,d). The mixer writes the step's state
    into ``cache`` in place (views of a stacked cache write through), where
    the reference returns a new cache. MoE FFNs dispatch by
    ``cfg.moe_decode_impl``. Returns (x, cache)."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if spec.mixer in (MIXER_GLOBAL_ATTN, MIXER_CROSS_ATTN):
        m, _ = attn_lib.decode_attention(params["mixer"], h, cache["kv"], pos,
                                         cfg, mode="causal")
    elif spec.mixer == MIXER_LOCAL_ATTN:
        m, _ = attn_lib.decode_attention(params["mixer"], h, cache["kv"], pos,
                                         cfg, mode="local", window=cfg.window)
    elif spec.mixer == MIXER_RGLRU:
        m, _ = rglru_lib.rglru_step(params["mixer"], h, cache["rnn"], cfg)
    elif spec.mixer == MIXER_SSD:
        m, _ = ssd_lib.ssd_step(params["mixer"], h, cache["ssm"], cfg)
    else:
        raise ValueError(f"mixer {spec.mixer!r} has no one-token decode")
    x = x + m
    if spec.mixer == MIXER_CROSS_ATTN:
        h = rms_norm(x, params["norm_x"], cfg.norm_eps)
        x = x + _cross_attn_cached(params["xattn"], h, cache["xk"],
                                   cache["xv"], cfg)
    return _ffn(params, x, cfg, spec, cfg.moe_decode_impl)[0], cache


# ---------------------------------------------------------------------------
# Prefill (full sequence, also returns the filled cache)
# ---------------------------------------------------------------------------

def _attn_prefill(params, h, positions, cfg, spec, cache_len):
    """Attention over the prompt, then its K/V written into a fresh cache:
    the first S slots, or for a local layer whose window the prompt
    overruns the last ``window`` tokens at their ring slots."""
    b, s, _ = h.shape
    local = spec.mixer == MIXER_LOCAL_ATTN
    m, k, v = attn_lib.self_attention_kv(params, h, positions, cfg,
                                         mode=_MODES[spec.mixer],
                                         window=cfg.window)
    clen = min(cfg.window, cache_len) if local else cache_len
    kv = attn_lib.init_kv_cache(b, clen, cfg, h.dtype, h.device)
    if local and s > clen:
        pos_tail = positions[0, -clen:]
        slots = (pos_tail % clen).long()
        kv["k"][:, slots] = k[:, -clen:].to(h.dtype)
        kv["v"][:, slots] = v[:, -clen:].to(h.dtype)
        kv["slot_pos"][slots] = pos_tail.to(torch.int32)
    else:
        kv["k"][:, :s] = k.to(h.dtype)
        kv["v"][:, :s] = v.to(h.dtype)
        kv["slot_pos"][:s] = positions[0].to(torch.int32)
    return m, kv


def block_prefill(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, spec: LayerSpec, cache_len: int, *,
                  enc_memory: torch.Tensor | None = None,
                  moe_impl: str | None = None):
    """Full-sequence forward that also produces the decode cache; a
    cross-attention layer's cache also holds the memory's K/V (biases
    included), computed once for the attention and the cache."""
    moe_impl = moe_impl or cfg.moe_impl
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    cache: dict = {}
    if spec.mixer == MIXER_RGLRU:
        m, cache["rnn"] = rglru_lib.rglru_prefill(params["mixer"], h, cfg)
    elif spec.mixer == MIXER_SSD:
        m, cache["ssm"] = ssd_lib.ssd_prefill(params["mixer"], h, cfg)
    elif spec.mixer in (MIXER_GLOBAL_ATTN, MIXER_LOCAL_ATTN,
                        MIXER_CROSS_ATTN):
        m, cache["kv"] = _attn_prefill(params["mixer"], h, positions, cfg,
                                       spec, cache_len)
    else:
        raise ValueError(f"mixer {spec.mixer!r} has no decode cache")
    x = x + m
    if spec.mixer == MIXER_CROSS_ATTN:
        hx = rms_norm(x, params["norm_x"], cfg.norm_eps)
        m, xk, xv = attn_lib.cross_attention_kv(params["xattn"], hx,
                                                enc_memory, cfg)
        x = x + m
        cache["xk"], cache["xv"] = xk.to(x.dtype), xv.to(x.dtype)
    return _ffn(params, x, cfg, spec, moe_impl)[0], cache
