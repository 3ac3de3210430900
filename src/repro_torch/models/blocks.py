"""Transformer blocks: pre-norm mixer + pre-norm FFN, dispatched by
``LayerSpec`` (counterpart of ``repro/models/blocks.py``).

A *unit* is one repetition of ``cfg.pattern``; its parameters and caches
are dicts keyed by the layer's index in the pattern, as in the reference.
The port runs the attention mixers (global, local, bidirectional), the
RG-LRU and SSD mixers and the gated MLP, for the full sequence, prefill
(which also fills the decode cache) and one-token decode. Cross attention
(the encoder-decoder models) and the MoE FFNs raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from . import attention as attn_lib
from . import rglru as rglru_lib
from . import ssd as ssd_lib
from .config import (FFN_MLP, FFN_NONE, MIXER_BIDIR_ATTN, MIXER_GLOBAL_ATTN,
                     MIXER_LOCAL_ATTN, MIXER_RGLRU, MIXER_SSD, LayerSpec,
                     ModelConfig)
from .layers import gated_mlp, init_mlp, rms_norm

_MODES = {MIXER_GLOBAL_ATTN: "causal", MIXER_LOCAL_ATTN: "local",
          MIXER_BIDIR_ATTN: "bidir"}


def _check(spec: LayerSpec) -> None:
    if spec.mixer not in (*_MODES, MIXER_RGLRU, MIXER_SSD):
        raise NotImplementedError(
            f"mixer {spec.mixer!r} (cross attention) comes with the "
            f"encoder-decoder models")
    if spec.ffn not in (FFN_MLP, FFN_NONE):
        raise NotImplementedError(
            f"ffn {spec.ffn!r} comes with the MoE models")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               dtype, device) -> dict:
    _check(spec)
    d = cfg.d_model
    p: dict = {"norm1": torch.zeros((d,), dtype=torch.float32, device=device)}
    if spec.mixer == MIXER_RGLRU:
        p["mixer"] = rglru_lib.init_rglru(gen, cfg, dtype, device)
    elif spec.mixer == MIXER_SSD:
        p["mixer"] = ssd_lib.init_ssd(gen, cfg, dtype, device)
    else:
        p["mixer"] = attn_lib.init_attn(gen, cfg, dtype, device)
    if spec.ffn == FFN_MLP:
        p["norm2"] = torch.zeros((d,), dtype=torch.float32, device=device)
        p["ffn"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def init_unit(gen: torch.Generator, cfg: ModelConfig, specs, dtype,
              device) -> dict:
    return {str(i): init_block(gen, cfg, s, dtype, device)
            for i, s in enumerate(specs)}


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _ffn(params, x, cfg, spec):
    if spec.ffn == FFN_NONE:
        return x
    return x + gated_mlp(params["ffn"], rms_norm(x, params["norm2"],
                                                 cfg.norm_eps))


def block_fwd(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, spec: LayerSpec):
    """Returns (x, aux_loss); aux_loss is 0 (no MoE here)."""
    _check(spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if spec.mixer == MIXER_RGLRU:
        m = rglru_lib.rglru_fwd(params["mixer"], h, cfg)
    elif spec.mixer == MIXER_SSD:
        m = ssd_lib.ssd_fwd(params["mixer"], h, cfg)
    else:
        m = attn_lib.full_attention(params["mixer"], h, positions, cfg,
                                    mode=_MODES[spec.mixer],
                                    window=cfg.window)
    return _ffn(params, x + m, cfg, spec), aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_block_cache(batch: int, cfg: ModelConfig, spec: LayerSpec,
                     cache_len: int, dtype, device) -> dict:
    _check(spec)
    if spec.mixer == MIXER_GLOBAL_ATTN:
        return {"kv": attn_lib.init_kv_cache(batch, cache_len, cfg, dtype,
                                             device)}
    if spec.mixer == MIXER_LOCAL_ATTN:
        return {"kv": attn_lib.init_kv_cache(
            batch, min(cfg.window, cache_len), cfg, dtype, device)}
    if spec.mixer == MIXER_RGLRU:
        return {"rnn": rglru_lib.init_rglru_cache(batch, cfg, dtype, device)}
    if spec.mixer == MIXER_SSD:
        return {"ssm": ssd_lib.init_ssd_cache(batch, cfg, dtype, device)}
    raise ValueError(f"mixer {spec.mixer!r} has no decode cache")


def init_unit_cache(batch: int, cfg: ModelConfig, specs, cache_len: int,
                    dtype, device) -> dict:
    return {str(i): init_block_cache(batch, cfg, s, cache_len, dtype, device)
            for i, s in enumerate(specs)}


# ---------------------------------------------------------------------------
# One-token decode
# ---------------------------------------------------------------------------

def block_step(params: dict, x: torch.Tensor, cache: dict, pos,
               cfg: ModelConfig, spec: LayerSpec):
    """One-token decode. x: (B,1,d). The mixer writes the step's state
    into ``cache`` in place (views of a stacked cache write through), where
    the reference returns a new cache. Returns (x, cache)."""
    _check(spec)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if spec.mixer == MIXER_GLOBAL_ATTN:
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
    return _ffn(params, x + m, cfg, spec), cache


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
                  cfg: ModelConfig, spec: LayerSpec, cache_len: int):
    """Full-sequence forward that also produces the decode cache."""
    _check(spec)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    cache: dict = {}
    if spec.mixer == MIXER_RGLRU:
        m, cache["rnn"] = rglru_lib.rglru_prefill(params["mixer"], h, cfg)
    elif spec.mixer == MIXER_SSD:
        m, cache["ssm"] = ssd_lib.ssd_prefill(params["mixer"], h, cfg)
    elif spec.mixer in (MIXER_GLOBAL_ATTN, MIXER_LOCAL_ATTN):
        m, cache["kv"] = _attn_prefill(params["mixer"], h, positions, cfg,
                                       spec, cache_len)
    else:
        raise ValueError(f"mixer {spec.mixer!r} has no decode cache")
    return _ffn(params, x + m, cfg, spec), cache
