"""Masked ragged-pool squared-L2 scan + exact top-k (CUDA, Hopper).

Port of the TPU kernel ``repro/kernels/l2_topk.py:l2_topk_masked``. The
CUDA source is ``csrc/l2_topk_masked.cu`` (design and bound noted there);
``l2_topk_masked`` launches it on CUDA tensors, and
``l2_topk_masked_plain`` is the plain PyTorch version of the same
function, used on the CPU and as the kernel's yardstick on the card.

Both return ``(d2 [Q, k] f32 ascending, ids [Q, k] i32)`` ordered by
``(d2, pool position)``; rows with fewer than k candidates pad with
``(3.4e38, -1)``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

INF = 3.4e38
MAX_K = 256
MAX_D = 1024

launches = 0   # kernel launches of this process (see ops.launch_counts)


def l2_topk_masked_plain(q: torch.Tensor, pools: torch.Tensor,
                         ids: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [Q, d]; pools [Q, C, d]; ids [Q, C] (-1 = padding). Same
    arithmetic as ``repro.kernels.ref.l2_topk_masked_ref``; the stable
    sort gives its tie rule (lower pool position first)."""
    q = q.float()
    pools = pools.float()
    d2 = ((q * q).sum(-1)[:, None]
          - 2 * torch.einsum("qd,qcd->qc", q, pools)
          + (pools * pools).sum(-1))
    return _masked_select(d2.clamp_min(0.0), ids, k)


def _masked_select(d2: torch.Tensor, ids: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared tail of the plain versions: mask padding, pad to k
    columns, stable ascending top-k, sentinel rows."""
    ids = ids.to(torch.int32)
    d2 = torch.where(ids >= 0, d2, torch.full_like(d2, INF))
    c = d2.shape[1]
    if c < k:  # pad so there are k columns to select from
        d2 = torch.nn.functional.pad(d2, (0, k - c), value=INF)
        ids = torch.nn.functional.pad(ids, (0, k - c), value=-1)
    d_sorted, pos = torch.sort(d2, dim=1, stable=True)
    out_d, pos = d_sorted[:, :k], pos[:, :k]
    out_i = torch.gather(ids, 1, pos)
    valid = out_i >= 0
    out_d = torch.where(valid, out_d, torch.full_like(out_d, INF))
    out_i = torch.where(valid, out_i, torch.full_like(out_i, -1))
    return out_d, out_i


def check_cuda_args(name: str, tensors, dtypes, k: int):
    """Raise unless every tensor is contiguous, on one CUDA device, with
    the given dtypes (one tuple of allowed dtypes per tensor)."""
    dev = tensors[0].device
    for t, allowed in zip(tensors, dtypes):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all inputs must lie on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype not in allowed:
            raise TypeError(f"{name}: dtype {t.dtype} not in {allowed}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k={k} outside [1, {MAX_K}]")


def launch(lib, fn_name: str, tensors, sizes, k: int, c: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate the scratch row [Q, C] and the outputs, launch
    ``fn_name(*tensors, scratch, out_d, out_i, *sizes, k, stream)`` on the
    current stream (no synchronise), raise on a refused launch."""
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * (len(tensors) + 3) + \
            [ctypes.c_int] * (len(sizes) + 1) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    device = tensors[0].device
    q_count = sizes[0]
    scratch = torch.empty((q_count, c), dtype=torch.float32, device=device)
    out_d = torch.empty((q_count, k), dtype=torch.float32, device=device)
    out_i = torch.empty((q_count, k), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], scratch.data_ptr(),
                 out_d.data_ptr(), out_i.data_ptr(), *sizes, k, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed "
                           f"(cudaError {err})")
    return out_d, out_i


def l2_topk_masked(q: torch.Tensor, pools: torch.Tensor, ids: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. q [Q, d] f32; pools [Q, C, d] f32 or bf16;
    ids [Q, C] i32 (-1 = padding); 1 <= k <= 256, C >= 1, d <= 1024.
    Raises on anything else, and on a non-CUDA tensor."""
    global launches
    check_cuda_args("l2_topk_masked", (q, pools, ids),
                    ((torch.float32,), (torch.float32, torch.bfloat16),
                     (torch.int32,)), k)
    q_count, d = q.shape
    if pools.dim() != 3 or pools.shape[0] != q_count \
            or pools.shape[2] != d or tuple(ids.shape) != pools.shape[:2]:
        raise ValueError(f"l2_topk_masked: shapes q {tuple(q.shape)}, "
                         f"pools {tuple(pools.shape)}, ids "
                         f"{tuple(ids.shape)} do not agree")
    c = pools.shape[1]
    if c < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"l2_topk_masked: needs C >= 1 and 1 <= d <= "
                         f"{MAX_D}, got C={c}, d={d}")
    if q_count == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    from repro_torch.kernels import build
    fn_name = "l2_topk_masked_f32" if pools.dtype == torch.float32 \
        else "l2_topk_masked_bf16"
    out = launch(build.load("l2_topk_masked"), fn_name, (q, pools, ids),
                 (q_count, c, d), k, c)
    launches += 1
    return out
