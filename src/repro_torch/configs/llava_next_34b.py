"""llava-next-34b [vlm] — anyres tiling; vision tower STUBBED per assignment.

60 layers, d_model=7168, 56 heads (GQA kv=8), d_ff=20480, vocab=64000.
The SigLIP/ViT vision encoder + projector frontend is a stub:
``input_specs()`` provides precomputed patch embeddings of shape
(batch, n_frontend_tokens, d_model) — anyres = 4 tiles + 1 base image of
576 patches each = 2880 tokens. The language transformer that consumes them
is fully implemented. [hf:llava-hf/llava-v1.6 family at 34B scale]
"""
from repro_torch.models.config import FFN_MLP, MIXER_GLOBAL_ATTN, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    pattern=(LayerSpec(MIXER_GLOBAL_ATTN, FFN_MLP),),
    n_units=60,
    frontend="vision",
    n_frontend_tokens=2880,  # anyres: (4 tiles + base) x 576 patches
    fsdp=True,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf (34B scale)",
)
