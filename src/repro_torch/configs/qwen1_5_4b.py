"""Qwen1.5-4B — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.
20 heads is NOT divisible by the 16-way model axis: the sharding layer
falls back to d_model / d_ff sharding for attention (see DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)

REDUCED = ModelConfig(
    arch_id="qwen1.5-4b-reduced",
    family="dense",
    n_layers=2,
    d_model=60,
    n_heads=5,
    n_kv_heads=5,
    d_ff=96,
    vocab_size=512,
    qkv_bias=True,
    head_dim=12,
    source="reduced smoke config",
)
