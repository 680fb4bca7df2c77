"""PQ asymmetric-distance scans (CUDA, Hopper).

Ports of the two TPU kernels of ``repro/kernels/pq_adc.py``:

* ``pq_adc``: one query's ADC table ``lut [M, 256]`` against code rows
  ``codes [N, M]`` gives ``d [N]`` (``csrc/pq_adc.cu``; the DiskANN
  baseline's in-memory guidance distances);
* ``pq_adc_masked``: per query, its own LUT against its own ragged pool
  of code rows, with exact top-k (``csrc/pq_adc_masked.cu``; the PQ
  plane's selection). Selection, tie rule and sentinels are those of
  ``l2_topk_masked``.

Each CUDA wrapper launches its kernel on CUDA tensors; the ``*_plain``
function beside it is the plain PyTorch version, used on the CPU and as
the kernel's yardstick on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.l2_topk import (
    _masked_select,
    bind,
    call,
    check_cuda_args,
    launch,
    sentinels,
)

MAX_M = 64   # the [M, 256] f32 LUT must fit shared memory

# CUDA launches of this process per kernel (see ops.launch_counts)
launches = {"pq_adc": 0, "pq_adc_masked": 0}


def pq_adc_plain(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [M, 256]; codes [N, M] (uint8 or int32, values in [0, 256)) ->
    d [N] f32: ``repro.kernels.ref.pq_adc_ref``, summed in the order
    m = 0 .. M-1 as the kernel sums (so the two agree bit for bit)."""
    lut = lut.float()
    codes = codes.long()
    d = torch.zeros(codes.shape[0], dtype=torch.float32, device=lut.device)
    for m in range(codes.shape[1]):
        d = d + lut[m][codes[:, m]]
    return d


def pq_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. lut [M, 256] f32; codes [N, M] u8 or i32
    with values in [0, 256); 1 <= M <= 64. N == 0 returns an empty
    tensor without a launch. Raises on anything else, and on a non-CUDA
    tensor."""
    check_cuda_args("pq_adc", (lut, codes),
                    ((torch.float32,), (torch.uint8, torch.int32)), 1)
    if lut.dim() != 2 or lut.shape[1] != 256 or codes.dim() != 2 \
            or codes.shape[1] != lut.shape[0]:
        raise ValueError(f"pq_adc: shapes lut {tuple(lut.shape)}, codes "
                         f"{tuple(codes.shape)} do not agree")
    n, m = codes.shape
    if not 1 <= m <= MAX_M:
        raise ValueError(f"pq_adc: M={m} outside [1, {MAX_M}]")
    out = torch.empty(n, dtype=torch.float32, device=lut.device)
    if n == 0:
        return out
    from repro_torch.kernels import build
    fn_name = "pq_adc_u8" if codes.dtype == torch.uint8 else "pq_adc_i32"
    call(bind(build.load("pq_adc"), fn_name, 3, 2), fn_name, lut.device,
         [lut.data_ptr(), codes.data_ptr(), out.data_ptr()], [n, m])
    launches["pq_adc"] += 1
    return out


def pq_adc_masked_plain(luts: torch.Tensor, codes: torch.Tensor,
                        ids: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """luts [Q, M, 256]; codes [Q, C, M]; ids [Q, C] (-1 = padding). Same
    arithmetic as ``repro.kernels.ref.pq_adc_masked_ref``."""
    q_count, c, m = codes.shape
    if c == 0:
        return sentinels(q_count, k, luts.device)
    # lut[q, m, codes[q, c, m]] gathered as [Q, M, C], summed over m
    idx = codes.long().transpose(1, 2)
    d2 = torch.gather(luts.float(), 2, idx).sum(1)
    return _masked_select(d2, ids, k)


def pq_adc_masked(luts: torch.Tensor, codes: torch.Tensor,
                  ids: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. luts [Q, M, 256] f32; codes [Q, C, M] u8;
    ids [Q, C] i32 (-1 = padding); 1 <= k <= 256, 1 <= M <= 64. C == 0
    returns the sentinels without a launch. Raises on anything else, and
    on a non-CUDA tensor."""
    check_cuda_args("pq_adc_masked", (luts, codes, ids),
                    ((torch.float32,), (torch.uint8,), (torch.int32,)), k)
    if luts.dim() != 3 or luts.shape[2] != 256 or codes.dim() != 3 \
            or codes.shape[0] != luts.shape[0] \
            or codes.shape[2] != luts.shape[1] \
            or tuple(ids.shape) != tuple(codes.shape[:2]):
        raise ValueError(f"pq_adc_masked: shapes luts {tuple(luts.shape)}, "
                         f"codes {tuple(codes.shape)}, ids "
                         f"{tuple(ids.shape)} do not agree")
    q_count, c, m = codes.shape
    if not 1 <= m <= MAX_M:
        raise ValueError(f"pq_adc_masked: M={m} outside [1, {MAX_M}]")
    if c == 0 or q_count == 0:
        return sentinels(q_count, k, luts.device)
    from repro_torch.kernels import build
    out = launch(build.load("pq_adc_masked"), "pq_adc_masked",
                 (luts, codes, ids), (q_count, c, m), k, c, head=1024 * m)
    launches["pq_adc_masked"] += 1
    return out
