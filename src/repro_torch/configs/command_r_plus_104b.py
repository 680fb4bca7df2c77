"""Command R+ 104B — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    tie_embeddings=True,  # command-r ties input/output embeddings
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)

REDUCED = ModelConfig(
    arch_id="command-r-plus-104b-reduced",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    tie_embeddings=True,
    source="reduced smoke config",
)
