"""Model configuration (counterpart of ``repro/models/config.py``).

``LayerSpec`` and ``ModelConfig`` keep the reference's field names and
defaults, so a reference configuration builds a port object field for
field, and ``reduced()`` and ``param_count()`` give what the reference's
give. The port runs every mixer and FFN named here.
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

    @property
    def n_enc_layers(self) -> int:
        return self.enc_n_units * len(self.enc_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.enc_n_units > 0

    @property
    def d_rnn(self) -> int:
        return self.rnn_width if self.rnn_width else self.d_model

    @property
    def d_inner(self) -> int:          # Mamba-2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def all_specs(self) -> Tuple[LayerSpec, ...]:
        return self.pattern * self.n_units + self.remainder

    @property
    def sub_quadratic(self) -> bool:
        """True if no decoder layer needs a full-context KV cache. Cross-
        attention decoder blocks carry full causal self-attention, so
        enc-dec stacks count as quadratic too."""
        return all(s.mixer not in (MIXER_GLOBAL_ATTN, MIXER_CROSS_ATTN)
                   for s in self.all_specs())

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + decoder + encoder),
        counted as the reference counts it."""
        d, hd = self.d_model, self.hd
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for spec in self.all_specs() + self.enc_pattern * self.enc_n_units:
            p = 2 * d  # norms
            if spec.mixer in (MIXER_GLOBAL_ATTN, MIXER_LOCAL_ATTN,
                              MIXER_BIDIR_ATTN, MIXER_CROSS_ATTN):
                n_att = 2 if spec.mixer == MIXER_CROSS_ATTN else 1
                p += n_att * (d * self.n_heads * hd
                              + 2 * d * self.n_kv_heads * hd
                              + self.n_heads * hd * d)
            elif spec.mixer == MIXER_RGLRU:
                dr = self.d_rnn
                p += 2 * d * dr + dr * d + 2 * dr * dr + self.conv_width * dr
            elif spec.mixer == MIXER_SSD:
                di = self.d_inner
                p += d * (2 * di + 2 * self.ssm_state + self.ssm_heads) + di * d
            if spec.ffn == FFN_MLP:
                p += 3 * d * self.d_ff
            elif spec.ffn in (FFN_MOE, FFN_MOE_DENSE):
                p += d * self.n_experts + self.n_experts * 3 * d * self.d_ff
                if spec.ffn == FFN_MOE_DENSE:
                    p += 3 * d * self.dense_residual_ff
            total += p
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.n_experts == 0:
            return self.param_count()
        n_moe = sum(1 for s in self.all_specs()
                    if s.ffn in (FFN_MOE, FFN_MOE_DENSE))
        inactive = (n_moe * (self.n_experts - self.top_k) * 3 * self.d_model
                    * self.d_ff)
        return self.param_count() - inactive

    def reduced(self, d_model: int = 256, max_units: int = 1,
                n_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant: a unit or two, d_model <= 512, <= 4 experts,
        fp32 (the reference's ``reduced``, field for field)."""
        n_heads = max(2, min(4, self.n_heads))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=max(1, min(self.n_kv_heads, n_heads)),
            head_dim=d_model // n_heads,
            d_ff=4 * d_model if self.d_ff else 0,
            vocab_size=vocab,
            n_units=min(self.n_units, max_units),
            remainder=self.remainder[:1],
            enc_n_units=min(self.enc_n_units, max_units),
            n_experts=min(self.n_experts, n_experts) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            dense_residual_ff=2 * d_model if self.dense_residual_ff else 0,
            ssm_state=min(self.ssm_state, 64) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            rnn_width=d_model if self.rnn_width else 0,
            window=min(self.window, 128) if self.window else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
            enc_frames=min(self.enc_frames, 32),
            dtype="float32",
            fsdp=False,
        )
