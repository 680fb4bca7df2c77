"""GQA attention: ports of ``repro/models/attention.py``.

Prefill (full-sequence) attention goes to the ``flash_attention`` kernel
through ``kernels.ops``, the computation the reference's jnp chunked
online softmax performs and its Pallas kernel targets. It is
differentiable: when an input requires grad it runs through
``kernels.flash_attention.FlashAttention``, whose backward is the
``flash_attention_bwd`` kernel (the reference's ``custom_vjp`` backward,
scores recomputed per tile from q, k, v, the output and its
log-sum-exp). Decode is one
query token against the KV cache and stays plain PyTorch: it has no
Pallas counterpart.

The dense and moe families need causal or full attention without a
sliding window or meta tokens. ``window > 0`` and ``meta_tokens > 0``
(the hybrid family) raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    NEG_INF,
    flash_attention_plain,
)


def _dense_only(window: int, meta_tokens: int) -> None:
    if window or meta_tokens:
        raise NotImplementedError(
            f"sliding-window attention (window={window}, "
            f"meta_tokens={meta_tokens}) belongs to the hybrid family, "
            "which is not ported yet")


def attention(q, k, v, *, causal=True, window=0, meta_tokens=0):
    """q [B, Sq, H, D]; k, v [B, Sk, KVH, D] -> [B, Sq, H, D]. Positions
    follow from the shapes: q is the causal suffix of k."""
    _dense_only(window, meta_tokens)
    return ops.flash_attention(q, k, v, causal=bool(causal))


def attention_reference(q, k, v, *, causal=True, window=0, meta_tokens=0):
    """Materialised-scores oracle (the kernel's plain version), on any
    device."""
    _dense_only(window, meta_tokens)
    return flash_attention_plain(q, k, v, causal=bool(causal))


def decode_attention(q, k_cache, v_cache, *, k_pos, cur_pos, window=0,
                     meta_tokens=0):
    """One-token decode: q [B, 1, H, D]; caches [B, Smax, KVH, D].

    ``k_pos`` [Smax] holds the absolute position stored in each cache
    slot; slots with position > ``cur_pos`` are masked out."""
    _dense_only(window, meta_tokens)
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qg = (q.float() * (1.0 / d ** 0.5)).reshape(b, n_kv, h // n_kv, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    s = s.masked_fill((k_pos > cur_pos)[None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
