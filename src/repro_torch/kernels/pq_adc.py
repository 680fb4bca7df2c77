"""Masked ragged-pool PQ asymmetric-distance scan + exact top-k (CUDA).

Port of the TPU kernel ``repro/kernels/pq_adc.py:pq_adc_masked``. The
CUDA source is ``csrc/pq_adc_masked.cu`` (design and bound noted there);
``pq_adc_masked`` launches it on CUDA tensors, and ``pq_adc_masked_plain``
is the plain PyTorch version, used on the CPU and as the kernel's
yardstick on the card. Selection, tie rule and sentinels are those of
``l2_topk``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.l2_topk import (
    INF,
    _masked_select,
    check_cuda_args,
    launch,
)

MAX_M = 64   # the [M, 256] f32 LUT of one query must fit shared memory

launches = 0   # kernel launches of this process (see ops.launch_counts)


def _empty(q_count: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """C == 0: every row is padding (the TPU wrapper's early return)."""
    return (torch.full((q_count, k), INF, dtype=torch.float32, device=device),
            torch.full((q_count, k), -1, dtype=torch.int32, device=device))


def pq_adc_masked_plain(luts: torch.Tensor, codes: torch.Tensor,
                        ids: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """luts [Q, M, 256]; codes [Q, C, M]; ids [Q, C] (-1 = padding). Same
    arithmetic as ``repro.kernels.ref.pq_adc_masked_ref``."""
    q_count, c, m = codes.shape
    if c == 0:
        return _empty(q_count, k, luts.device)
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
    global launches
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
        return _empty(q_count, k, luts.device)
    from repro_torch.kernels import build
    out = launch(build.load("pq_adc_masked"), "pq_adc_masked",
                 (luts, codes, ids), (q_count, c, m), k, c)
    launches += 1
    return out
