"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

12 encoder + 12 decoder layers, d_model=1024, 16 heads (kv=16, full MHA),
d_ff=4096, vocab=256206. The mel-spectrogram + conformer feature frontend is
a stub: ``input_specs()`` provides precomputed frame embeddings
(batch, enc_frames, d_model); the enc-dec transformer is fully implemented.
[arXiv:2308.11596]
"""
from repro_torch.models.config import (FFN_MLP, MIXER_BIDIR_ATTN, MIXER_CROSS_ATTN,
                                 LayerSpec, ModelConfig)

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    pattern=(LayerSpec(MIXER_CROSS_ATTN, FFN_MLP),),
    n_units=12,
    enc_pattern=(LayerSpec(MIXER_BIDIR_ATTN, FFN_MLP),),
    enc_n_units=12,
    frontend="audio",
    enc_frames=1024,
    citation="arXiv:2308.11596",
)
