"""granite-3-2b [dense] — GQA.

40 layers, d_model=2048, 32 heads (GQA kv=8), d_ff=8192, vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base]
"""
from repro_torch.models.config import FFN_MLP, MIXER_GLOBAL_ATTN, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    pattern=(LayerSpec(MIXER_GLOBAL_ATTN, FFN_MLP),),
    n_units=40,
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-2b-base",
)
