"""Hymba-1.5B — parallel attn+mamba heads. [arXiv:2411.13676; hf]

32L d_model=1600 25H (GQA kv=5) d_ff=5504, ssm_state=16, sliding-window
attention (3 global full-attention layers), 128 meta tokens.
25 heads / 5 kv heads are NOT divisible by the 16-way model axis: sharding
falls back to d_model / d_ff sharding (see DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    attn_window=1024,
    global_layers=(0, 15, 31),
    meta_tokens=128,
    source="arXiv:2411.13676; hf",
)

REDUCED = ModelConfig(
    arch_id="hymba-1.5b-reduced",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    ssm_state=8,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv=4,
    ssm_chunk=16,
    attn_window=32,
    global_layers=(0,),
    meta_tokens=8,
    source="reduced smoke config",
)
