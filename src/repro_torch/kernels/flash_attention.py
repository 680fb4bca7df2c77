"""Causal (or full) attention with an online softmax (CUDA, Hopper).

Port of the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
at the model's own layout: q ``[B, Sq, H, D]``, k and v ``[B, Sk, KVH, D]``
(grouped-query: query head h reads KV head ``h // (H // KVH)``), f32 or
bf16, gives ``[B, Sq, H, D]`` in q's dtype. Numerics are the TPU
kernel's: float32 scores, the causal mask ``k_pos <= q_pos + (Sk - Sq)``
at -1e30, float32 running (max, sum, accumulator) and
``acc / max(sum, 1e-30)`` rounded once. Sq and Sk take any length (the
kernel masks the ragged tail itself).

Causal attention also takes the hybrid family's sliding window and meta
tokens, the mask of the reference's jnp attention
(``repro/models/attention.py:50 _mask_block``; its Pallas kernel has
none): with ``window > 0``, key j is visible to the query at position p
when ``j <= p`` and either ``j > p - window`` or ``j < meta_tokens``.
``window = 0`` is plain causal attention (a global layer's), and so is
any window of at least Sk, bit for bit. The kernel loads only the key
tiles that some row of a query block can see: the meta tokens' and those
from the block's first window on. A window needs ``causal``.

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

For training, both can also return the residuals the reference's
``_flash_fwd_impl`` keeps (``repro/models/attention.py:113-116``): ``lse``
f32 ``[B, H, Sq]``, the natural log-sum-exp of each row's scaled scores,
and the output in f32 before its rounding to q's dtype (``out_g``). And
``flash_attention_bwd`` launches ``csrc/flash_attention_bwd.cu``, the
counterpart of the reference's ``custom_vjp`` backward
(``repro/models/attention.py:136 bwd``): dQ, dK and dV from (q, k, v, the
f32 O, lse, dO), recomputing the scores tile by tile, never storing them.
Three launches: delta = rowsum(dO * O) (launch 0; from the f32 O, as the
reference forms it: a bf16 O's rounding would enter every dS of its row
alike), then dK/dV and dQ, each on
``wgmma`` with a TMA ring (bf16; the f32 variant runs on the CUDA cores),
at the head widths ``BWD_HEAD_DIMS`` (any other D zero-padded to the next).
Both take the forward's window and meta tokens (the mask and the key
tiles a block walks are the forward's, ``csrc/attention_mask.cuh``).
Its plain version ``flash_attention_bwd_plain`` follows the reference's
formula on the materialised scores in f32. ``FlashAttention`` is the
``torch.autograd.Function`` over the two: the kernels on CUDA tensors, the
plain versions on CPU tensors, and no fallback from one to the other.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.l2_topk import bind, call, check_cuda_args, on_cpu

NEG_INF = -1e30
LOG2E = 1.4426950408889634
HEAD_DIMS = (16, 32, 64, 112, 128)   # the kernel's compiled head widths
BWD_HEAD_DIMS = (16, 32, 64, 128)    # the backward's (112 runs at 128)
# delta's row stride: each (b, h) row padded to whole 128-row query blocks
# for the bf16 kernels' 16-byte bulk copies
DELTA_ROWS = 128

# CUDA launches of this process per kernel (see ops.launch_counts)
launches = {"flash_attention": 0, "flash_attention_bwd": 0}


def head_width(d: int, widths=HEAD_DIMS) -> int:
    """The compiled head width a launch at head dim ``d`` runs at: ``d``
    itself, else the next wider of ``widths`` (the forward's
    ``HEAD_DIMS`` or the backward's ``BWD_HEAD_DIMS``). Raises for 0 and
    above the widest."""
    for width in widths:
        if 1 <= d <= width:
            return width
    raise ValueError(f"flash_attention: head dim {d} outside [1, "
                     f"{widths[-1]}]")


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


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, S, H, D] -> f32 [B, KVH, G, S, D] (query head h = kvh G + g)."""
    b, s, h, d = x.shape
    return x.float().reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)


def _ungrouped(x: torch.Tensor) -> torch.Tensor:
    """[B, KVH, G, S, D] -> [B, S, H, D]."""
    b, kvh, g, s, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, d)


def _hidden(sq: int, sk: int, device, causal: bool, window: int = 0,
            meta_tokens: int = 0) -> Optional[torch.Tensor]:
    """[Sq, Sk], True where the mask hides the key from the query row (row
    r at position p = r + Sk - Sq): past the diagonal, and with a window
    at or before p - window unless among the first ``meta_tokens``; None
    when nothing is hidden (full attention)."""
    if not causal:
        return None
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=device)[None, :]
    hidden = k_pos > q_pos
    if window > 0:
        hidden |= (k_pos <= q_pos - window) & (k_pos >= meta_tokens)
    return hidden


def _check_window(name: str, causal: bool, window: int,
                 meta_tokens: int) -> None:
    """Raise unless (window, meta_tokens) is a mask the kernel takes: two
    ints >= 0, and a window only with causal attention."""
    if window < 0 or meta_tokens < 0:
        raise ValueError(f"{name}: window={window}, meta_tokens="
                         f"{meta_tokens} must be >= 0")
    if window > 0 and not causal:
        raise ValueError(f"{name}: a sliding window needs causal "
                         f"attention")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          scale: Optional[float] = None,
                          return_lse: bool = False, window: int = 0,
                          meta_tokens: int = 0):
    """q [B, Sq, H, D]; k, v [B, Sk, KVH, D] -> [B, Sq, H, D] (q's dtype),
    through the whole [Sq, Sk] score matrix of each head. ``scale``
    multiplies q (default 1/sqrt(D)). ``window`` and ``meta_tokens`` as
    ``flash_attention``'s. With ``return_lse``, (out, lse, out_f32): also
    the log-sum-exp of each row's scaled scores, f32 [B, H, Sq], and the
    output before its rounding to q's dtype, f32."""
    _check_window("flash_attention", causal, window, meta_tokens)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / d ** 0.5
    # [B, KVH, G, Sq, D] against [B, KVH, 1, Sk, D]: no copy of K/V per group
    qg = _grouped(q, kvh) * scale
    kg = k.float().permute(0, 2, 1, 3)[:, :, None]
    vg = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = qg @ kg.transpose(-1, -2)
    hidden = _hidden(sq, sk, q.device, causal, window, meta_tokens)
    if hidden is not None:
        s = s.masked_fill(hidden, NEG_INF)
    out32 = _ungrouped(torch.softmax(s, dim=-1) @ vg)
    if return_lse:
        return out32.to(q.dtype), _row_lse(s).reshape(b, h, sq), out32
    return out32.to(q.dtype)


def _row_lse(s: torch.Tensor) -> torch.Tensor:
    """The log-sum-exp of each row of ``s`` [..., Sk] (f32), read off
    ``log_softmax`` at the row's max, where it is max - lse. Not
    ``torch.logsumexp`` (nor ``torch.exp``): on the CPU their exp goes to
    MKL's vector math, which splits a long call over its threads, and the
    part computed on the calling thread came out up to 1.5e-4 off
    (against 3e-7) now and then in processes sharing busy cores.
    ``log_softmax``, ``softmax`` and ``exp2`` are PyTorch's own kernels."""
    top = s.argmax(-1, keepdim=True)
    return (s.gather(-1, top) - torch.log_softmax(s, -1).gather(-1, top))[..., 0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor,
                              causal: bool = True,
                              scale: Optional[float] = None, window: int = 0,
                              meta_tokens: int = 0):
    """(dq, dk, dv) of attention, the reference's backward
    (``repro/models/attention.py:136``) on the materialised scores in f32:
    P = exp(scale q.k - lse) (0 where the forward's mask hides the key: the
    causal mask and, with ``window > 0``, the window and meta tokens),
    delta = rowsum(dO * O), dV = P^T dO, dS = P (dO V^T - delta) scale,
    dQ = dS K, dK = dS^T Q, dK and dV summed over each KV head's query
    heads. Shapes as ``flash_attention``'s; ``out`` the forward's output
    (in f32 before its rounding, as ``flash_attention_bwd`` takes it, or
    any dtype); lse f32 [B, H, Sq]; each gradient in its input's
    dtype."""
    _check_window("flash_attention_bwd", causal, window, meta_tokens)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / d ** 0.5
    qg, og, dog = (_grouped(t, kvh) for t in (q, out, dout))
    kg = k.float().permute(0, 2, 1, 3)[:, :, None]
    vg = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = scale * (qg @ kg.transpose(-1, -2))
    # exp(x) as exp2(x log2 e): see _row_lse for why not torch.exp
    lse = lse.float().reshape(b, kvh, h // kvh, sq)[..., None]
    p = torch.exp2((s - lse) * LOG2E)
    hidden = _hidden(sq, sk, q.device, causal, window, meta_tokens)
    if hidden is not None:
        p = p.masked_fill(hidden, 0.0)
    delta = (dog * og).sum(-1)
    dv = (p.transpose(-1, -2) @ dog).sum(2)
    ds = p * (dog @ vg.transpose(-1, -2) - delta[..., None]) * scale
    dq = _ungrouped(ds @ kg)
    dk = (ds.transpose(-1, -2) @ qg).sum(2)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _check_args(name: str, q, k, v, causal: bool, extra=(),
                widths=HEAD_DIMS) -> int:
    """Raise unless the kernels take these inputs; returns the compiled
    head width (of ``widths``) they run at."""
    check_cuda_args(name, (q, k, v, *extra),
                    ((torch.float32, torch.bfloat16),) * (3 + len(extra)), 1)
    if not all(t.dtype == q.dtype for t in (k, v, *extra)):
        raise TypeError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                        f"differ")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2] \
            or any(t.shape != q.shape for t in extra):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    sq, sk, d = q.shape[1], k.shape[1], q.shape[3]
    width = head_width(d, widths)
    if sk == 0 or (causal and sq > sk):
        raise ValueError(f"{name}: Sq={sq}, Sk={sk} "
                         f"(causal={causal}) leaves rows with no key")
    return width


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, return_lse: bool = False,
                    window: int = 0, meta_tokens: int = 0):
    """Launch the CUDA kernel. q [B, Sq, H, D]; k, v [B, Sk, KVH, D];
    contiguous, one dtype (float32 or bfloat16), 16-byte aligned, H % KVH
    == 0, 1 <= D <= 128 (padded up to the next of ``HEAD_DIMS``), Sk >=
    1, and Sq <= Sk when causal (a longer query would hold rows with no
    key to attend to). ``window > 0`` (causal only) hides the keys at or
    before p - window from the query at position p, except the first
    ``meta_tokens``. Sq == 0 or B == 0
    returns an empty tensor without a launch. Raises on anything else, and
    on a non-CUDA tensor. With ``return_lse`` the kernel also writes the
    rows' log-sum-exp and (bf16) the output in f32 before its rounding,
    returned as ``(out, lse, out_f32)`` (for f32 inputs ``out_f32`` is
    ``out``): the residuals ``flash_attention_bwd`` takes."""
    width = _check_args("flash_attention", q, k, v, causal)
    _check_window("flash_attention", causal, window, meta_tokens)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if sq == 0 or b == 0:
        out = torch.empty_like(q)
        return (out, lse, out.float()) if return_lse else out
    qp, kp, vp = pad_head_dim(q, k, v, width)
    if any(t.data_ptr() % 16 for t in (qp, kp, vp)):
        raise ValueError("flash_attention: inputs must be 16-byte aligned "
                         "(the kernel stages them with 16-byte copies)")
    out = torch.empty_like(qp)
    out32 = torch.empty(qp.shape, dtype=torch.float32, device=q.device) \
        if return_lse and bf16 else None
    from repro_torch.kernels import build
    fn_name = "flash_attention_bf16" if bf16 else "flash_attention_f32"
    # the true D's scale, rounded once to f32 by ctypes
    call(bind(build.load("flash_attention"), fn_name, 6, 9, 1), fn_name,
         q.device, [qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                    0 if out32 is None else out32.data_ptr()],
         [b, sq, sk, h, kvh, width, int(causal), int(window),
          int(meta_tokens), 1.0 / math.sqrt(d)])
    launches["flash_attention"] += 1
    if width != d:
        out = out[..., :d].contiguous()
        out32 = None if out32 is None else out32[..., :d].contiguous()
    if not return_lse:
        return out
    return out, lse, out if out32 is None else out32


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        window: int = 0, meta_tokens: int = 0):
    """Launch the backward kernels: (dq, dk, dv) in the inputs' dtype from
    the forward's inputs, its residuals ``out`` (the output in f32 before
    its rounding: ``flash_attention(..., return_lse=True)``'s third) and
    ``lse`` (f32 [B, H, Sq]), and the output's gradient ``dout`` [B, Sq, H,
    D]. Takes what ``flash_attention`` takes (``dout`` with q's shape and
    dtype, ``out`` with q's shape in f32) and raises on anything else.
    Three launches, counted together as one ``flash_attention_bwd``: delta
    = rowsum(dO * O) in f32, then dK/dV, then dQ. D runs at the next of
    ``BWD_HEAD_DIMS``, zero-padded.
    ``window`` and ``meta_tokens`` are the forward's mask. Sq == 0 or B ==
    0 gives zeros without a launch."""
    width = _check_args("flash_attention_bwd", q, k, v, causal,
                        extra=(dout,), widths=BWD_HEAD_DIMS)
    if out.shape != q.shape or out.dtype != torch.float32 \
            or out.device != q.device or not out.is_contiguous():
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} "
                         f"{out.dtype} is not the f32 output of q's shape "
                         f"on q's device")
    _check_window("flash_attention_bwd", causal, window, meta_tokens)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} is not f32 [B, H, Sq] on q's device")
    if sq == 0 or b == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    qp, kp, vp = pad_head_dim(q, k, v, width)
    outp, dop = pad_head_dim(out, dout, dout, width)[:2]
    if any(t.data_ptr() % 16 for t in (qp, kp, vp, outp, dop)):
        raise ValueError("flash_attention_bwd: inputs must be 16-byte "
                         "aligned (the kernels read them with 16-byte "
                         "copies)")
    bf16 = q.dtype == torch.bfloat16
    ld = -(-sq // DELTA_ROWS) * DELTA_ROWS if bf16 else sq
    delta = torch.empty((b, h, ld), dtype=torch.float32, device=q.device)
    lse2 = torch.empty_like(delta) if bf16 else None
    dq, dk, dv = (torch.empty_like(t) for t in (qp, kp, vp))
    from repro_torch.kernels import build
    fn_name = ("flash_attention_bwd_bf16" if bf16
               else "flash_attention_bwd_f32")
    call(bind(build.load("flash_attention_bwd"), fn_name, 11, 10, 1),
         fn_name, q.device,
         [t.data_ptr() for t in (qp, kp, vp, outp, dop, lse, delta)]
         + [0 if lse2 is None else lse2.data_ptr()]
         + [t.data_ptr() for t in (dq, dk, dv)],
         [b, sq, sk, h, kvh, width, int(causal), int(window),
          int(meta_tokens), ld, 1.0 / math.sqrt(d)])
    launches["flash_attention_bwd"] += 1
    if width != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose gradient is the flash backward: the forward keeps
    (q, k, v, the f32 output, lse), the backward recomputes the scores
    from them. On CUDA tensors both directions are the kernels (a refused
    launch raises); on CPU tensors both are the plain versions. The
    sliding window and meta tokens go to both directions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int = 0,
                meta_tokens: int = 0):
        fwd = flash_attention_plain if on_cpu(q) else flash_attention
        out, lse, out32 = fwd(q, k, v, causal=causal, return_lse=True,
                              window=window, meta_tokens=meta_tokens)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.mask = dict(causal=causal, window=window,
                        meta_tokens=meta_tokens)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if on_cpu(q) \
            else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), **ctx.mask)
        return dq, dk, dv, None, None, None
