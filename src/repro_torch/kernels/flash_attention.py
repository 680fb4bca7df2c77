"""Causal (or full) attention with an online softmax (CUDA, Hopper).

Port of the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
at the model's own layout: q ``[B, Sq, H, D]``, k and v ``[B, Sk, KVH, D]``
(grouped-query: query head h reads KV head ``h // (H // KVH)``), f32 or
bf16, gives ``[B, Sq, H, D]`` in q's dtype. Numerics are the TPU
kernel's: float32 scores, the causal mask ``k_pos <= q_pos + (Sk - Sq)``
at -1e30, float32 running (max, sum, accumulator) and
``acc / max(sum, 1e-30)`` rounded once. Sq and Sk take any length (the
kernel masks the ragged tail itself).

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors,
one of two variants chosen by dtype, both counted as ``flash_attention``:
bf16 runs on the tensor cores (``mma.sync``; the scale applied to the f32
scores after the product, P rounded to bf16 before P.V), f32 on the CUDA
cores (q scaled before the product, as the TPU kernel does). A refused
launch raises; neither variant stands in for the other. The kernel is
compiled for the head widths ``HEAD_DIMS``; any other D up to the widest
runs padded with zero columns to the next compiled width
(``pad_head_dim``), with the scale 1/sqrt(D) of the true D, and the
output's padding columns are cut off.
``flash_attention_plain`` beside it materialises the scores, as the
reference oracle ``repro/kernels/ref.py:flash_attention_ref`` does, and is
used on the CPU and as the kernel's yardstick on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.l2_topk import bind, call, check_cuda_args

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 112, 128)   # the kernel's compiled head widths

# CUDA launches of this process per kernel (see ops.launch_counts)
launches = {"flash_attention": 0}


def head_width(d: int) -> int:
    """The compiled head width a launch at head dim ``d`` runs at: ``d``
    itself, else the next wider of ``HEAD_DIMS``. Raises for 0 and above
    the widest."""
    for width in HEAD_DIMS:
        if 1 <= d <= width:
            return width
    raise ValueError(f"flash_attention: head dim {d} outside [1, "
                     f"{HEAD_DIMS[-1]}]")


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 width: int):
    """q, k, v with their last axis zero-padded to ``width`` columns (as
    they are when it already has that width). Zero columns add nothing to
    any score q.k, and the output's padding columns (P.0) are cut off by
    the caller, so attention at the true D's scale is unchanged."""
    pad = width - q.shape[-1]
    if pad == 0:
        return q, k, v
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, H, D]; k, v [B, Sk, KVH, D] -> [B, Sq, H, D] (q's dtype),
    through the whole [Sq, Sk] score matrix of each head. ``scale``
    multiplies q (default 1/sqrt(D))."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / d ** 0.5
    # [B, KVH, G, Sq, D] against [B, KVH, 1, Sk, D]: no copy of K/V per group
    qg = (q.float() * scale).reshape(b, sq, kvh, h // kvh, d) \
        .permute(0, 2, 3, 1, 4)
    kg = k.float().permute(0, 2, 1, 3)[:, :, None]
    vg = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = qg @ kg.transpose(-1, -2)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        s = s.masked_fill(torch.arange(sk, device=q.device)[None, :] > q_pos,
                          NEG_INF)
    out = torch.softmax(s, dim=-1) @ vg
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel. q [B, Sq, H, D]; k, v [B, Sk, KVH, D];
    contiguous, one dtype (float32 or bfloat16), 16-byte aligned, H % KVH
    == 0, 1 <= D <= 128 (padded up to the next of ``HEAD_DIMS``), Sk >=
    1, and Sq <= Sk when causal (a longer query would hold rows with no
    key to attend to). Sq == 0 or B == 0
    returns an empty tensor without a launch. Raises on anything else, and
    on a non-CUDA tensor."""
    check_cuda_args("flash_attention", (q, k, v),
                    ((torch.float32, torch.bfloat16),) * 3, 1)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    width = head_width(d)
    if sk == 0 or (causal and sq > sk):
        raise ValueError(f"flash_attention: Sq={sq}, Sk={sk} "
                         f"(causal={causal}) leaves rows with no key")
    if sq == 0 or b == 0:
        return torch.empty_like(q)
    qp, kp, vp = pad_head_dim(q, k, v, width)
    if any(t.data_ptr() % 16 for t in (qp, kp, vp)):
        raise ValueError("flash_attention: inputs must be 16-byte aligned "
                         "(the kernel stages them with 16-byte copies)")
    out = torch.empty_like(qp)
    from repro_torch.kernels import build
    fn_name = ("flash_attention_bf16" if q.dtype == torch.bfloat16
               else "flash_attention_f32")
    # the true D's scale, rounded once to f32 by ctypes
    call(bind(build.load("flash_attention"), fn_name, 4, 7, 1), fn_name,
         q.device, [qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    out.data_ptr()],
         [b, sq, sk, h, kvh, width, int(causal), 1.0 / math.sqrt(d)])
    launches["flash_attention"] += 1
    return out if width == d else out[..., :d].contiguous()
