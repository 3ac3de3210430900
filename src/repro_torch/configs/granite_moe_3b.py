"""granite-moe-3b-a800m [moe] — 40 experts, top-8, fine-grained (d_ff=512).

32 layers, d_model=1536, 24 heads (GQA kv=8), d_ff=512/expert, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base family, 3b-a800m scale]
"""
from repro_torch.models.config import FFN_MOE, MIXER_GLOBAL_ATTN, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    pattern=(LayerSpec(MIXER_GLOBAL_ATTN, FFN_MOE),),
    n_units=32,
    n_experts=40,
    top_k=8,
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
