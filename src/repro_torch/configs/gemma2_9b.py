"""gemma2-9b [dense] — alternating local/global attention with logit softcaps.

42 layers, d_model=3584, 16 heads (GQA kv=8), d_ff=14336, vocab=256000.
[arXiv:2408.00118]
"""
from repro_torch.models.config import (FFN_MLP, MIXER_GLOBAL_ATTN, MIXER_LOCAL_ATTN,
                                 LayerSpec, ModelConfig)

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    pattern=(LayerSpec(MIXER_LOCAL_ATTN, FFN_MLP),
             LayerSpec(MIXER_GLOBAL_ATTN, FFN_MLP)),
    n_units=21,
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    citation="arXiv:2408.00118",
)

# Long-context serving mode (long_500k): global layers fall back to the same
# 4096-token sliding window — a beyond-paper block-local serving variant that
# makes the KV cache O(window) instead of O(context).
import dataclasses

CONFIG_LONGCTX = dataclasses.replace(
    CONFIG,
    name="gemma2-9b-swa",
    pattern=(LayerSpec(MIXER_LOCAL_ATTN, FFN_MLP),
             LayerSpec(MIXER_LOCAL_ATTN, FFN_MLP)),
)
