"""mistral-large-123b [dense] — deep dense GQA.

88 layers, d_model=12288, 96 heads (GQA kv=8), d_ff=28672, vocab=32768.
[hf:mistralai/Mistral-Large-Instruct-2407]
"""
from repro_torch.models.config import FFN_MLP, MIXER_GLOBAL_ATTN, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32_768,
    pattern=(LayerSpec(MIXER_GLOBAL_ATTN, FFN_MLP),),
    n_units=88,
    fsdp=True,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
)
