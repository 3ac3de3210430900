"""In-framework text embedding encoder, MiniLM class (counterpart of
``repro/encoder/model.py``): a small bidirectional transformer with masked
mean pooling and L2-normalized sentence embeddings.

Parameters are a plain dict shaped as the reference's: ``embed`` (V,d),
``final_norm`` (d,) and ``units``, the one-block unit with every leaf
stacked over a leading layer axis. ``encode`` walks that axis where the
reference scans it. The attention of every layer runs on the flash kernel
(``kernels/flash_attention.py``) on the card.

Padding tokens do attend in self-attention (the bidirectional mask is
all ones); the pooling mask excludes them from the sentence embedding.

``encode`` is differentiable on both devices (``contrastive/finetune.py``
trains through it), with respect to the parameter leaves themselves: the
per-layer slices of the stacked ``units`` pass their gradients back into
the stacked leaves. Everything but attention is autograd over plain
PyTorch; attention goes through ``flash_attention``'s
``autograd.Function``, whose backward is the plain version on the CPU
and the fp32 backward kernel (``csrc/flash_attention_bwd.cu``) on the
card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.config import (FFN_MLP, MIXER_BIDIR_ATTN, LayerSpec,
                                       ModelConfig)
from repro_torch.models.layers import (init_embedding, rms_norm, stack_trees,
                                       tree_map)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 2048
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    max_len: int = 64
    name: str = "minilm-repro"

    def to_model_config(self) -> ModelConfig:
        return ModelConfig(
            name=self.name, family="encoder",
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_heads, head_dim=self.d_model // self.n_heads,
            d_ff=self.d_ff, vocab_size=self.vocab_size,
            pattern=(LayerSpec(MIXER_BIDIR_ATTN, FFN_MLP),),
            n_units=self.n_layers, dtype="float32",
        )


def init_encoder(gen: torch.Generator, cfg: EncoderConfig,
                 device=None) -> dict:
    """Random weights from ``gen`` (drawn on the generator's device, then
    moved to ``device``): N(0, 1/fan_in) matrices, zero norm scales."""
    dev = resolve_device(device)
    mc = cfg.to_model_config()
    f32 = torch.float32
    embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, f32, dev)
    layers = [blk.init_unit(gen, mc, mc.pattern, f32, dev)
              for _ in range(cfg.n_layers)]
    return {"embed": embed, "units": stack_trees(layers),
            "final_norm": torch.zeros((cfg.d_model,), dtype=f32, device=dev)}


def encode(params: dict, tokens: torch.Tensor, mask: torch.Tensor,
           cfg: EncoderConfig) -> torch.Tensor:
    """tokens: (B, L) int; mask: (B, L) {0,1}. Returns L2-normed (B, d)."""
    mc = cfg.to_model_config()
    x = params["embed"][tokens.long()]
    b, l, _ = x.shape
    positions = torch.arange(l, dtype=torch.int32,
                             device=x.device).expand(b, l)
    n_layers = params["units"]["0"]["norm1"].shape[0]
    for i in range(n_layers):
        unit = tree_map(lambda w: w[i], params["units"])
        x, _ = blk.block_fwd(unit["0"], x, positions, mc, mc.pattern[0])
    x = rms_norm(x, params["final_norm"])
    m = mask[..., None].to(torch.float32)
    pooled = torch.sum(x * m, dim=1) / torch.clamp_min(torch.sum(m, dim=1),
                                                       1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp_min(norm, 1e-12)
