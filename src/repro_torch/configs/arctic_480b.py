"""arctic-480b [moe] — 128 experts top-2 with a parallel dense residual MLP.

35 layers, d_model=7168, 56 heads (GQA kv=8), expert d_ff=4864, vocab=32000.
Arctic's dense-MoE hybrid: every block runs a dense residual MLP in parallel
with the routed experts. [hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.models.config import FFN_MOE_DENSE, MIXER_GLOBAL_ATTN, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    pattern=(LayerSpec(MIXER_GLOBAL_ATTN, FFN_MOE_DENSE),),
    n_units=35,
    n_experts=128,
    top_k=2,
    dense_residual_ff=4864,
    fsdp=True,
    citation="hf:Snowflake/snowflake-arctic-base",
)
