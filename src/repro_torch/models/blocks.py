"""Transformer blocks: pre-norm mixer + pre-norm FFN, dispatched by
``LayerSpec`` (counterpart of ``repro/models/blocks.py``).

A *unit* is one repetition of ``cfg.pattern``; its parameters are a dict
keyed by the layer's index in the pattern, as in the reference. The port
runs the attention mixers (global, local, bidirectional) and the gated
MLP so far; the RG-LRU, SSD and cross-attention mixers, the MoE FFNs and
the decode path come with the LM substrate slice and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from . import attention as attn_lib
from .config import (FFN_MLP, FFN_NONE, MIXER_BIDIR_ATTN, MIXER_GLOBAL_ATTN,
                     MIXER_LOCAL_ATTN, LayerSpec, ModelConfig)
from .layers import gated_mlp, init_mlp, rms_norm

_MODES = {MIXER_GLOBAL_ATTN: "causal", MIXER_LOCAL_ATTN: "local",
          MIXER_BIDIR_ATTN: "bidir"}


def _check(spec: LayerSpec) -> None:
    if spec.mixer not in _MODES:
        raise NotImplementedError(
            f"mixer {spec.mixer!r} comes with the LM substrate slice of the "
            f"port")
    if spec.ffn not in (FFN_MLP, FFN_NONE):
        raise NotImplementedError(
            f"ffn {spec.ffn!r} comes with the LM substrate slice of the port")


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               dtype, device) -> dict:
    _check(spec)
    d = cfg.d_model
    p: dict = {"norm1": torch.zeros((d,), dtype=torch.float32, device=device),
               "mixer": attn_lib.init_attn(gen, cfg, dtype, device)}
    if spec.ffn == FFN_MLP:
        p["norm2"] = torch.zeros((d,), dtype=torch.float32, device=device)
        p["ffn"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def init_unit(gen: torch.Generator, cfg: ModelConfig, specs, dtype,
              device) -> dict:
    return {str(i): init_block(gen, cfg, s, dtype, device)
            for i, s in enumerate(specs)}


def block_fwd(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, spec: LayerSpec):
    """Returns (x, aux_loss); aux_loss is 0 (no MoE here)."""
    _check(spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    x = x + attn_lib.full_attention(params["mixer"], h, positions, cfg,
                                    mode=_MODES[spec.mixer],
                                    window=cfg.window)
    if spec.ffn == FFN_NONE:
        return x, aux
    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    return x + gated_mlp(params["ffn"], h), aux
