"""Model configuration (counterpart of ``repro/models/config.py``).

``LayerSpec`` and ``ModelConfig`` keep the reference's field names and
defaults, so a reference configuration builds a port object field for
field. The port runs only the attention and gated-MLP layers so far (the
encoder's ``(MIXER_BIDIR_ATTN, FFN_MLP)`` stack); the other mixers and
FFNs are named here and raise in ``models/blocks.py`` until the LM
substrate slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Mixer types: how tokens mix along the sequence axis.
MIXER_GLOBAL_ATTN = "attn"        # full causal attention
MIXER_LOCAL_ATTN = "lattn"        # sliding-window causal attention
MIXER_BIDIR_ATTN = "battn"        # bidirectional attention (encoder)
MIXER_CROSS_ATTN = "xattn"        # self-causal + cross attention
MIXER_RGLRU = "rglru"             # Real-Gated Linear Recurrent Unit
MIXER_SSD = "ssd"                 # Mamba-2 state-space dual block

# FFN types.
FFN_MLP = "mlp"                   # gated SwiGLU MLP
FFN_MOE = "moe"                   # top-k mixture of experts
FFN_MOE_DENSE = "moe_dense"       # MoE beside a dense residual MLP
FFN_NONE = "none"                 # no FFN (Mamba-2 blocks are mixer-only)

MIXERS = (MIXER_GLOBAL_ATTN, MIXER_LOCAL_ATTN, MIXER_BIDIR_ATTN,
          MIXER_CROSS_ATTN, MIXER_RGLRU, MIXER_SSD)
FFNS = (FFN_MLP, FFN_MOE, FFN_MOE_DENSE, FFN_NONE)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str
    ffn: str

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in FFNS:
            raise ValueError(f"unknown ffn {self.ffn!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # Decoder stack: `pattern` repeated `n_units` times, then `remainder`.
    pattern: Tuple[LayerSpec, ...]
    n_units: int
    remainder: Tuple[LayerSpec, ...] = ()
    # Encoder stack (enc-dec models only).
    enc_pattern: Tuple[LayerSpec, ...] = ()
    enc_n_units: int = 0
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    window: int = 0                   # sliding-window size for MIXER_LOCAL_ATTN
    attn_softcap: float = 0.0         # Gemma-2 attention-logit soft cap
    logit_softcap: float = 0.0        # Gemma-2 final-logit soft cap
    rope_theta: float = 10000.0
    # MoE.
    n_experts: int = 0
    top_k: int = 0
    dense_residual_ff: int = 0
    # SSM (Mamba-2 SSD).
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    # RG-LRU (RecurrentGemma).
    rnn_width: int = 0
    conv_width: int = 4
    # Modality frontend stub.
    frontend: str = ""
    n_frontend_tokens: int = 0
    enc_frames: int = 0
    # Numerics.
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # Sharding hints.
    fsdp: bool = False
    # Perf levers of the reference.
    gqa_impl: str = "grouped"
    attn_q_chunk: int = 0
    moe_impl: str = "sparse"
    moe_decode_impl: str = "dense"
    citation: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return self.n_units * len(self.pattern) + len(self.remainder)

    def all_specs(self) -> Tuple[LayerSpec, ...]:
        return self.pattern * self.n_units + self.remainder
