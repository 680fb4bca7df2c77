"""Dispatcher of the port's kernels.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the hand-written CUDA kernel, which launches or raises — there
is no fallback from the card to the plain version. Launch counts let a
caller show that a run went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import l2_topk as _l2
from repro_torch.kernels import pq_adc as _pq
from repro_torch.kernels.l2_topk import on_cpu


def l2_topk(q, x, k: int = 10):
    """q [Q, d], x [N, d] -> (d2 [Q, k] ascending, ids [Q, k]) by
    (d2, id); N < k pads (3.4e38, -1)."""
    if on_cpu(q):
        return _l2.l2_topk_plain(q, x, k)
    return _l2.l2_topk(q, x, k)


def l2_topk_masked(q, pools, ids, k: int = 10):
    """q [Q, d], pools [Q, C, d], ids [Q, C] (-1 pads ragged rows)
    -> (d2 [Q, k] ascending, ids [Q, k]); short rows pad (3.4e38, -1)."""
    if on_cpu(q):
        return _l2.l2_topk_masked_plain(q, pools, ids, k)
    return _l2.l2_topk_masked(q, pools, ids, k)


def pq_adc(lut, codes):
    """lut [M, 256] f32, codes [N, M] -> dists [N] f32."""
    if on_cpu(lut):
        return _pq.pq_adc_plain(lut, codes)
    return _pq.pq_adc(lut, codes)


def pq_adc_rows(luts, table, rows, offsets):
    """luts [Q, M, 256] f32, table [n, M] u8, rows [T] i32 ids, offsets
    [Q + 1] i32 -> dists [T] f32: row t scored under the LUT of the query
    whose segment [offsets[q], offsets[q + 1]) holds it."""
    if on_cpu(luts):
        return _pq.pq_adc_rows_plain(luts, table, rows, offsets)
    return _pq.pq_adc_rows(luts, table, rows, offsets)


def pq_adc_masked(luts, codes, ids, k: int = 10):
    """luts [Q, M, 256] f32, codes [Q, C, M] u8, ids [Q, C] (-1 pads
    ragged rows) -> (d2 [Q, k] ascending, ids [Q, k]); short rows pad
    (3.4e38, -1)."""
    if on_cpu(luts):
        return _pq.pq_adc_masked_plain(luts, codes, ids, k)
    return _pq.pq_adc_masked(luts, codes, ids, k)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    meta_tokens: int = 0):
    """q [B, Sq, H, D]; k, v [B, Sk, KVH, D] (H % KVH == 0) ->
    [B, Sq, H, D] in q's dtype; causal masks ``k_pos > q_pos + Sk - Sq``,
    and ``window > 0`` also ``k_pos <= q_pos - window`` unless ``k_pos <
    meta_tokens``. When autograd records and an input requires grad,
    through ``FlashAttention``, whose backward is ``flash_attention_bwd``
    (with the same mask)."""
    causal, window, meta_tokens = bool(causal), int(window), int(meta_tokens)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _fa.FlashAttention.apply(q, k, v, causal, window, meta_tokens)
    fn = _fa.flash_attention_plain if on_cpu(q) else _fa.flash_attention
    return fn(q, k, v, causal, window=window, meta_tokens=meta_tokens)


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel since the last ``reset_launch_counts``."""
    return {**_l2.launches, **_pq.launches, **_fa.launches}


def reset_launch_counts() -> None:
    for counts in (_l2.launches, _pq.launches, _fa.launches):
        for name in counts:
            counts[name] = 0
