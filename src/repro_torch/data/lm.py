"""Synthetic LM data: port of ``repro/data/lm.py``.

Stateless: ``batch_at(dcfg, cfg, step)`` is a pure function of (seed,
step). Tokens follow a Zipf-like marginal with local n-gram structure
(with probability 0.5 a token is an affine function of the one before),
as in the reference. The draws come from a ``torch.Generator``, so the
token streams differ from the reference's ``jax.random`` ones; tests
that compare the two packages feed both the same numpy tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, check_family
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch_size: int = 8
    seq_len: int = 256


def batch_at(dcfg: DataConfig, cfg: ModelConfig, step: int,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """{"tokens": [B, S], "labels": [B, S]} int64 on ``device`` (the CUDA
    card unless ``device="cpu"``); labels are the next tokens, -1 at the
    end. The modality stubs follow, f32 standard normal, drawn after the
    tokens from the same generator: the vlm family's ``vision_embeds``
    [B, vision_tokens, d] (its labels -1 under them, as those positions
    carry no loss), the audio family's ``frames`` [B, enc_frames, d]. The
    stream depends only on (seed, step), not on the device."""
    check_family(cfg)   # the modality stubs come with their families
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(dcfg.seed * 1_000_003 + step)
    b, s, v = dcfg.batch_size, dcfg.seq_len, cfg.vocab_size
    probs = torch.arange(1, v + 1, dtype=torch.float64) ** -1.1
    base = torch.multinomial(probs, b * s, replacement=True,
                             generator=gen).view(b, s)
    follow = (base * 31 + 17) % v
    coin = torch.rand((b, s), generator=gen) < 0.5
    tokens = torch.where(coin, torch.roll(follow, 1, dims=1), base)
    labels = torch.cat([tokens[:, 1:], torch.full((b, 1), -1)], dim=1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(
            (b, cfg.vision_tokens, cfg.d_model), generator=gen)
        labels[:, :cfg.vision_tokens] = -1
    if cfg.enc_layers:
        batch["frames"] = torch.randn((b, cfg.enc_frames, cfg.d_model),
                                      generator=gen)
    return {key: t.to(dev) for key, t in batch.items()}
