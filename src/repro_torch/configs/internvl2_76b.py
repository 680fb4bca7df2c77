"""InternVL2-76B backbone (InternViT frontend stubbed; InternLM2 LM).

[arXiv:2404.16821; unverified] — 80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256. Vision frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings merged into the token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    vision_tokens=256,
    source="arXiv:2404.16821; unverified",
)

REDUCED = ModelConfig(
    arch_id="internvl2-76b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    vision_tokens=8,
    source="reduced smoke config",
)
