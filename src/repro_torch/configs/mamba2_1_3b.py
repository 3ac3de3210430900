"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality).

48 layers, d_model=2048, ssm_state=128, vocab=50280, mixer-only blocks
(d_ff=0: Mamba-2 blocks carry their own channel mixing). [arXiv:2405.21060]
"""
from repro_torch.models.config import FFN_NONE, MIXER_SSD, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    d_model=2048,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    pattern=(LayerSpec(MIXER_SSD, FFN_NONE),),
    n_units=48,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
    citation="arXiv:2405.21060",
)
