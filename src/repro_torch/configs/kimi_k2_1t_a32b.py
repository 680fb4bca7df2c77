"""Kimi K2 — trillion-param MoE (paper-table). [arXiv:2501.kimi2; unverified]

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8,
1 shared expert, first layer dense (n_dense_layers=1).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    moe_top_k=8,
    n_shared_experts=1,
    n_dense_layers=1,
    head_dim=112,
    source="arXiv:2501.kimi2; unverified",
)

REDUCED = ModelConfig(
    arch_id="kimi-k2-1t-a32b-reduced",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=512,
    n_experts=8,
    moe_top_k=2,
    n_shared_experts=1,
    n_dense_layers=1,
    head_dim=16,
    capacity_factor=8.0,  # no-drop regime so decode==forward in tests
    source="reduced smoke config",
)
