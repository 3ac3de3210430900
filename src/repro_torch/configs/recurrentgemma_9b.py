"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 attn:rnn ratio.

38 layers, d_model=4096, 16 heads (GQA kv=1 / MQA), d_ff=12288, vocab=256000.
[arXiv:2402.19427 (Griffin/RecurrentGemma)]
"""
from repro_torch.models.config import (FFN_MLP, MIXER_LOCAL_ATTN, MIXER_RGLRU,
                                 LayerSpec, ModelConfig)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    # Griffin block ordering: (RG-LRU, RG-LRU, local-attn) repeated; 38 layers
    # = 12 full pattern units + 2 trailing RG-LRU layers.
    pattern=(LayerSpec(MIXER_RGLRU, FFN_MLP),
             LayerSpec(MIXER_RGLRU, FFN_MLP),
             LayerSpec(MIXER_LOCAL_ATTN, FFN_MLP)),
    n_units=12,
    remainder=(LayerSpec(MIXER_RGLRU, FFN_MLP),
               LayerSpec(MIXER_RGLRU, FFN_MLP)),
    window=2048,
    rnn_width=4096,
    tie_embeddings=True,
    citation="arXiv:2402.19427",
)
