"""PQ asymmetric-distance scans (CUDA, Hopper).

Ports of the two TPU kernels of ``repro/kernels/pq_adc.py``:

* ``pq_adc``: one query's ADC table ``lut [M, 256]`` against code rows
  ``codes [N, M]`` gives ``d [N]`` (``csrc/pq_adc.cu``);
* ``pq_adc_rows``: the same sums for many queries in one launch, each
  query's LUT against its own segment of node ids, whose code rows the
  kernel reads from a resident code table (``csrc/pq_adc.cu``; one launch
  per DiskANN wave, the baseline's in-memory guidance distances);
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
# pq_adc_rows copies each query's LUT to shared memory when its segments
# hold at least this many rows on average, and reads it through the
# read-only cache below that: at M = 8 and 1000 queries the read-only
# variant is faster at 32 rows and the staged one at 64
# (scripts/kernel_bench.py --only adc, PERF.md)
STAGE_ROWS = 64

# CUDA launches of this process per kernel (see ops.launch_counts)
launches = {"pq_adc": 0, "pq_adc_rows": 0, "pq_adc_masked": 0}


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


def pq_adc_rows_plain(luts: torch.Tensor, table: torch.Tensor,
                      rows: torch.Tensor, offsets: torch.Tensor
                      ) -> torch.Tensor:
    """luts [Q, M, 256]; table [n, M] (uint8 or int32 codes in [0, 256));
    rows [T] node ids; offsets [Q + 1], nondecreasing from 0 to T -> d [T]
    f32 with d[t] = sum_m luts[q, m, table[rows[t], m]] for the query q
    whose segment [offsets[q], offsets[q + 1]) holds t, summed in the
    order m = 0 .. M-1 as ``pq_adc_plain`` and the kernel sum."""
    q_count, m_count = luts.shape[0], luts.shape[1]
    t_count = rows.shape[0]
    offsets = offsets.long()
    seg = torch.repeat_interleave(
        torch.arange(q_count, device=luts.device), offsets[1:] - offsets[:-1],
        output_size=t_count)
    codes = table[rows.long()].long()
    luts = luts.float()
    d = torch.zeros(t_count, dtype=torch.float32, device=luts.device)
    for m in range(m_count):
        d = d + luts[seg, m, codes[:, m]]
    return d


def pq_adc_rows(luts: torch.Tensor, table: torch.Tensor, rows: torch.Tensor,
                offsets: torch.Tensor, stage=None) -> torch.Tensor:
    """Launch the CUDA kernel. luts [Q, M, 256] f32, 16-byte aligned;
    table [n, M] u8; rows [T] i32 ids in [0, n) (any other id gives NaN);
    offsets [Q + 1] i32, nondecreasing from 0 to T; 1 <= M <= 64. The LUTs
    are staged in shared memory when the segments average ``STAGE_ROWS``
    rows or more; ``stage`` forces either variant (the crossover
    measurement and the edge checks time and test both). T == 0 returns an
    empty tensor without a launch. Raises on anything else, and on a
    non-CUDA tensor."""
    check_cuda_args("pq_adc_rows", (luts, table, rows, offsets),
                    ((torch.float32,), (torch.uint8,), (torch.int32,),
                     (torch.int32,)), 1)
    if luts.dim() != 3 or luts.shape[2] != 256 or table.dim() != 2 \
            or table.shape[1] != luts.shape[1] or rows.dim() != 1 \
            or tuple(offsets.shape) != (luts.shape[0] + 1,):
        raise ValueError(f"pq_adc_rows: shapes luts {tuple(luts.shape)}, "
                         f"table {tuple(table.shape)}, rows "
                         f"{tuple(rows.shape)}, offsets "
                         f"{tuple(offsets.shape)} do not agree")
    q_count, m = luts.shape[0], luts.shape[1]
    t_count = rows.shape[0]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"pq_adc_rows: M={m} outside [1, {MAX_M}]")
    if luts.data_ptr() % 16:
        raise ValueError("pq_adc_rows: luts must be 16-byte aligned")
    out = torch.empty(t_count, dtype=torch.float32, device=luts.device)
    if t_count == 0 or q_count == 0:
        return out
    if stage is None:
        stage = t_count >= STAGE_ROWS * q_count
    from repro_torch.kernels import build
    call(bind(build.load("pq_adc"), "pq_adc_rows", 5, 5), "pq_adc_rows",
         luts.device, [luts.data_ptr(), table.data_ptr(), rows.data_ptr(),
                       offsets.data_ptr(), out.data_ptr()],
         [table.shape[0], m, t_count, q_count, int(bool(stage))])
    launches["pq_adc_rows"] += 1
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
