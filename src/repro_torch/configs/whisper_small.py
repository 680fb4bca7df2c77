"""Whisper-small — enc-dec, conv frontend stubbed. [arXiv:2212.04356; unverified]

12L (decoder; 12 encoder) d_model=768 12H d_ff=3072 vocab=51865.
``input_specs()`` provides precomputed frame embeddings [B, 1500, d].
Decode shapes lower the decoder step (self-attn KV cache of seq_len +
cross-attn cache over the 1500 encoder frames).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    enc_layers=12,
    enc_frames=1500,
    qkv_bias=True,
    source="arXiv:2212.04356; unverified",
)

REDUCED = ModelConfig(
    arch_id="whisper-small-reduced",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    enc_layers=2,
    enc_frames=30,
    qkv_bias=True,
    source="reduced smoke config",
)
