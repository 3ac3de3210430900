"""qwen2-7b [dense] — GQA with QKV bias.

28 layers, d_model=3584, 28 heads (GQA kv=4), d_ff=18944, vocab=152064.
[arXiv:2407.10671]
"""
from repro_torch.models.config import FFN_MLP, MIXER_GLOBAL_ATTN, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    pattern=(LayerSpec(MIXER_GLOBAL_ATTN, FFN_MLP),),
    n_units=28,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    citation="arXiv:2407.10671",
)
