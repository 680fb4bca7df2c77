"""Mamba2-370M — SSD (state-space duality). [arXiv:2405.21060; unverified]

48L d_model=1024 (attn-free) vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)

REDUCED = ModelConfig(
    arch_id="mamba2-370m-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv=4,
    ssm_chunk=32,
    tie_embeddings=True,
    source="reduced smoke config",
)
