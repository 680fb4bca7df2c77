"""DBRX-132B — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    moe_top_k=4,
    source="hf:databricks/dbrx-base; unverified",
)

REDUCED = ModelConfig(
    arch_id="dbrx-132b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    n_experts=4,
    moe_top_k=2,
    capacity_factor=8.0,  # no-drop regime so decode==forward in tests
    source="reduced smoke config",
)
