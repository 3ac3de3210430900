"""Architecture registry (counterpart of ``repro/configs/__init__.py``):
the reference's ten candidate-LM configurations as port ``ModelConfig``s,
field for field; the port runs each of them end to end (``models/lm.py``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from . import (arctic_480b, gemma2_9b, granite_3_2b, granite_moe_3b,
               llava_next_34b, mamba2_1_3b, mistral_large_123b, qwen2_7b,
               recurrentgemma_9b, seamless_m4t_medium)
from .shapes import SHAPES, InputShape  # noqa: F401

ARCHS: dict[str, ModelConfig] = {
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
    "qwen2-7b": qwen2_7b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    "gemma2-9b": gemma2_9b.CONFIG,
    "granite-3-2b": granite_3_2b.CONFIG,
    "mistral-large-123b": mistral_large_123b.CONFIG,
    "llava-next-34b": llava_next_34b.CONFIG,
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
}

# Serving-mode overrides: arch -> config used for long_500k decode.
LONGCTX_OVERRIDES: dict[str, ModelConfig] = {
    "gemma2-9b": gemma2_9b.CONFIG_LONGCTX,
}

# The reference's optimized settings (its §Perf levers): q-chunked
# attention for every attention arch, repeat-KV where the heads allow it,
# and its MoE dispatch choices.
_REPEAT_OK = ("recurrentgemma-9b", "gemma2-9b", "granite-3-2b",
              "mistral-large-123b", "seamless-m4t-medium")
OPTIMIZED_OVERRIDES: dict[str, dict] = {
    name: {"attn_q_chunk": 2048} for name in (
        "recurrentgemma-9b", "qwen2-7b", "granite-moe-3b-a800m",
        "arctic-480b", "gemma2-9b", "granite-3-2b", "mistral-large-123b",
        "llava-next-34b", "seamless-m4t-medium")
}
for _n in _REPEAT_OK:
    OPTIMIZED_OVERRIDES[_n]["gqa_impl"] = "repeat"
OPTIMIZED_OVERRIDES["arctic-480b"]["moe_decode_impl"] = "sparse"
OPTIMIZED_OVERRIDES["granite-moe-3b-a800m"]["moe_impl"] = "dense"
OPTIMIZED_OVERRIDES["mamba2-1.3b"] = {}


def get_arch(name: str, shape: str | None = None,
             optimized: bool = False) -> ModelConfig:
    cfg = ARCHS[name]
    if shape == "long_500k" and name in LONGCTX_OVERRIDES:
        cfg = LONGCTX_OVERRIDES[name]
    if optimized and OPTIMIZED_OVERRIDES.get(name):
        ov = dict(OPTIMIZED_OVERRIDES[name])
        if shape in ("decode_32k", "long_500k"):
            # the attention levers target full-sequence compute; decode
            # keeps the grouped cache layout
            ov.pop("gqa_impl", None)
            ov.pop("attn_q_chunk", None)
        if ov:
            cfg = dataclasses.replace(cfg, **ov)
    return cfg


def long_ctx_supported(name: str) -> bool:
    """True if the arch can serve long_500k (sub-quadratic decode)."""
    return get_arch(name, "long_500k").sub_quadratic
