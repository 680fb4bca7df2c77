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
Pallas counterpart. Over a cache whose slots a mesh splits
(``models/model.py:init_cache``: the self-attention's slots, meta tokens
included, or the cross-attention's frames), each rank attends to its
slots and the partial softmaxes merge across the ranks
(``decode_attention_merged``). Over a cache whose head dim ``model``
splits (``shard_head_dim_fallback``), each rank scores its block of
every head's dims, the partial scores are summed over ``model``, and the
rank reads its block of the values (``decode_attention_merged``'s
``head_dim_axes``).

The hybrid family's mask is the reference's ``_mask_block``: with
``window > 0`` a key is visible when it is causal and inside the window,
or one of the first ``meta_tokens`` positions (cache slots), or the
layer is global (``disable_window``, a Python bool here where the
reference traces a flag). A global layer sends ``window=0`` to the
kernel. A sliding window needs causal attention (no model asks for
another); its backward is the kernel's, with the same mask.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.distributed import gather_axis, psum
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    NEG_INF,
    flash_attention_plain,
)


def attention(q, k, v, *, causal=True, window=0, meta_tokens=0,
              disable_window=False):
    """q [B, Sq, H, D]; k, v [B, Sk, KVH, D] -> [B, Sq, H, D]. Positions
    follow from the shapes: q is the causal suffix of k. The kernel takes
    contiguous inputs: a view (case M's kv heads of the rank's query
    heads, ``Attention.kv_for_queries``) is copied first."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    return ops.flash_attention(q, k, v, causal=bool(causal),
                               window=0 if disable_window else window,
                               meta_tokens=meta_tokens)


def attention_reference(q, k, v, *, causal=True, window=0, meta_tokens=0,
                        disable_window=False):
    """Materialised-scores oracle (the kernel's plain version), on any
    device."""
    return flash_attention_plain(q, k, v, causal=bool(causal),
                                 window=0 if disable_window else window,
                                 meta_tokens=meta_tokens)


def _hidden_slots(k_pos, cur_pos, window, meta_tokens, disable_window):
    hidden = k_pos > cur_pos
    if window > 0 and not disable_window:
        hidden |= (k_pos <= cur_pos - window) & (k_pos >= meta_tokens)
    return hidden


def decode_attention_merged(q, k_cache, v_cache, mesh, axes, *, k_pos,
                            cur_pos, window=0, meta_tokens=0,
                            disable_window=False, head_dim_axes=()):
    """``decode_attention`` over a cache whose slots the mesh ``axes``
    split: this rank's caches [B, n, KVH, D] hold the slots at positions
    ``k_pos`` [n]. Each rank takes the partial softmax over its slots
    (the max m, the sum l of exp(s - m), the unnormalised output o), and
    the partials merge over each axis in turn, in rank order (a
    flash-decoding merge: m = max m_r, l = sum exp(m_r - m) l_r, o the
    same over o_r), then o / l: the values of one rank holding every
    slot, the same bits on every rank of the axes. A rank with no
    visible slot adds nothing (its m is -1e30 below a visible one).
    ``k_pos`` are global slot positions, so the hybrid family's window
    and meta tokens (the first ``meta_tokens`` slots, on the rank holding
    the first slots) mask as over the whole cache.

    ``head_dim_axes``: q and the caches hold this rank's block of the head
    dim, split over those axes; the scores are this rank's partial
    products summed over them (``psum``, the same bits on every rank) and
    the output is the rank's block of the head dim."""
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    whole_d = d * math.prod(mesh.shape[a] for a in head_dim_axes)
    qg = (q.float() * (1.0 / whole_d ** 0.5)).reshape(b, n_kv, h // n_kv, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    if head_dim_axes:
        s = psum(mesh, head_dim_axes, s)
    hidden = _hidden_slots(k_pos, cur_pos, window, meta_tokens,
                           disable_window)
    s = s.masked_fill(hidden[None, None, None, :], NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    part = torch.cat([m[..., None], p.sum(-1)[..., None], o], -1)
    for a in axes:
        parts = gather_axis(mesh, a, part[None], dim=0)
        m = parts[..., 0].amax(0)
        w = torch.exp(parts[..., 0] - m)
        acc = parts[0, ..., 1:] * w[0, ..., None]
        for r in range(1, parts.shape[0]):
            acc = acc + parts[r, ..., 1:] * w[r, ..., None]
        part = torch.cat([m[..., None], acc], -1)
    out = part[..., 2:] / part[..., 1:2]
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, k_pos, cur_pos, window=0,
                     meta_tokens=0, disable_window=False):
    """One-token decode: q [B, 1, H, D]; caches [B, Smax, KVH, D].

    ``k_pos`` [Smax] holds the absolute position stored in each cache
    slot; slots with position > ``cur_pos`` are masked out, and with
    ``window > 0`` (unless ``disable_window``) so are those at or before
    ``cur_pos - window`` that are not among the first ``meta_tokens``."""
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qg = (q.float() * (1.0 / d ** 0.5)).reshape(b, n_kv, h // n_kv, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    hidden = _hidden_slots(k_pos, cur_pos, window, meta_tokens,
                           disable_window)
    s = s.masked_fill(hidden[None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
