"""Squared-L2 scans with exact top-k (CUDA, Hopper).

Ports of the two TPU kernels of ``repro/kernels/l2_topk.py``:

* ``l2_topk``: every query against a shared database, ``q [Q, d]`` and
  ``x [N, d]`` give ``(d2 [Q, k], ids [Q, k])`` ordered by ``(d2, id)``
  (``csrc/l2_topk.cu``; ground truth, SPANN's closure assignment,
  ``exact_pg``);
* ``l2_topk_masked``: every query against its own ragged candidate pool,
  ordered by ``(d2, pool position)`` (``csrc/l2_topk_masked.cu``; the
  search path's scan).

Each CUDA wrapper launches its kernel on CUDA tensors; the ``*_plain``
function beside it is the plain PyTorch version of the same function,
used on the CPU and as the kernel's yardstick on the card. Both return
d2 float32 ascending and ids int32; rows with fewer than k candidates pad
with ``(3.4e38, -1)``. The design and bound of each kernel are noted in
its source.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

INF = 3.4e38
MAX_K = 256
MAX_D = 1024

# CUDA launches of this process per kernel (see ops.launch_counts)
launches = {"l2_topk": 0, "l2_topk_masked": 0}


def l2_topk_plain(q: torch.Tensor, x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [Q, d]; x [N, d]. The arithmetic of
    ``repro.kernels.ref.l2_topk_ref``; the stable sort gives its tie rule
    (lower id first). N < k pads ``(3.4e38, -1)``, as the TPU kernel's
    padded rows do."""
    q = q.float()
    x = x.float()
    d2 = ((q * q).sum(-1)[:, None] - 2 * (q @ x.T)
          + (x * x).sum(-1)[None, :])
    ids = torch.arange(x.shape[0], dtype=torch.int32, device=q.device)
    return _masked_select(d2.clamp_min(0.0), ids.expand(q.shape[0], -1), k)


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


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version's), False for a CUDA one
    (the kernel's); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"unsupported device {t.device}")


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


def bind(lib, fn_name: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """``lib.fn_name`` with its C signature: ``n_ptrs`` pointers,
    ``n_ints`` ints, ``n_floats`` floats and the stream; returns a
    cudaError_t."""
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + \
            [ctypes.c_int] * n_ints + [ctypes.c_float] * n_floats + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def call(fn, fn_name: str, device, ptrs, ints) -> None:
    """Launch ``fn(*ptrs, *ints, stream)`` (``ints`` ends with the float
    arguments, if any) on the current stream of
    ``device`` (no synchronise); raise on a refused launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed "
                           f"(cudaError {err})")


def launch(lib, fn_name: str, tensors, sizes, k: int, c: int, head: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked scans: allocate the outputs, and the scratch key rows [Q, C
    rounded up to 4] when ``select_smem`` puts the keys in device memory;
    launch ``fn_name(*tensors, scratch or NULL, out_d, out_i, *sizes, k,
    smem, stream)``. ``head``: bytes of the kernel's own shared arrays."""
    fn = bind(lib, fn_name, len(tensors) + 3, len(sizes) + 2)
    device = tensors[0].device
    q_count = sizes[0]
    shared, smem = select_smem(c, head)
    scratch = None if shared else torch.empty(
        (q_count, _cdiv(c, 4) * 4), dtype=torch.int32, device=device)
    out_d = torch.empty((q_count, k), dtype=torch.float32, device=device)
    out_i = torch.empty((q_count, k), dtype=torch.int32, device=device)
    call(fn, fn_name, device,
         [t.data_ptr() for t in tensors]
         + [0 if scratch is None else scratch.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr()],
         [*sizes, k, smem])
    return out_d, out_i


# Shared memory of a masked scan block (csrc/topk_select.cuh): the
# survivors (MAX_K u64) and the radix histogram (2048 i32), the kernel's
# own arrays (q, or the LUT), then one u32 key per pool position (C rounded
# up to 4: the keys are read as uint4) when the whole fits SMEM_BUDGET of
# the 227 KB a block may take
SELECT_HEAD = MAX_K * 8 + 2048 * 4
SMEM_BUDGET = 200 * 1024


def select_smem(c: int, head: int) -> Tuple[bool, int]:
    """(keys in shared memory, dynamic shared bytes) of a masked scan block
    over a pool of C positions whose own arrays take ``head`` bytes:
    ``l2_topk_masked`` 4 d (q), ``pq_adc_masked`` 1024 M (the LUT). Keys
    that do not fit go to scratch rows in device memory, and the block
    keeps the rest."""
    base = SELECT_HEAD + _cdiv(head, 16) * 16
    keys = 16 * _cdiv(c, 4)
    if base + keys <= SMEM_BUDGET:
        return True, base + keys
    return False, base


def sentinels(q_count: int, k: int, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows with no candidate at all: ``(3.4e38, -1)`` everywhere."""
    return (torch.full((q_count, k), INF, dtype=torch.float32, device=device),
            torch.full((q_count, k), -1, dtype=torch.int32, device=device))


# the scan kernel's tiles (csrc/l2_topk.cu): queries per block, rows per
# tile; the rows are split into at most N / MIN_SPLIT_ROWS slices so that
# at most SCAN_BLOCKS blocks run (one wave, one per SM of the H100)
TILE_Q, TILE_N = 128, 128
SCAN_BLOCKS = 132
MIN_SPLIT_ROWS = 1024


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_rows(q_count: int, n: int) -> Tuple[int, int]:
    """(S, rows_per_split): the row slices of the scan kernel's grid, at
    most SCAN_BLOCKS blocks in all (one wave) unless the query tiles alone
    are more."""
    s = max(1, min(SCAN_BLOCKS // _cdiv(q_count, TILE_Q),
                   _cdiv(n, MIN_SPLIT_ROWS)))
    rows = _cdiv(_cdiv(n, s), TILE_N) * TILE_N
    return _cdiv(n, rows), rows


def l2_topk(q: torch.Tensor, x: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. q [Q, d] f32; x [N, d] f32; 1 <= k <= 256.
    N == 0 returns the sentinels without a launch. Raises on anything
    else, and on a non-CUDA tensor."""
    check_cuda_args("l2_topk", (q, x), ((torch.float32,), (torch.float32,)),
                    k)
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1] \
            or q.shape[1] < 1:
        raise ValueError(f"l2_topk: shapes q {tuple(q.shape)}, x "
                         f"{tuple(x.shape)} do not agree")
    (q_count, d), n = q.shape, x.shape[0]
    if q_count == 0 or n == 0:
        return sentinels(q_count, k, q.device)
    from repro_torch.kernels import build
    s, rows = split_rows(q_count, n)
    # the partial lists of the row slices (and the running lists when k
    # is too large for shared memory)
    part = torch.empty((q_count, s, k), dtype=torch.int64, device=q.device)
    out_d = torch.empty((q_count, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((q_count, k), dtype=torch.int32, device=q.device)
    call(bind(build.load("l2_topk"), "l2_topk", 5, 6), "l2_topk", q.device,
         [q.data_ptr(), x.data_ptr(), part.data_ptr(), out_d.data_ptr(),
          out_i.data_ptr()], [q_count, n, d, k, s, rows])
    launches["l2_topk"] += 1
    return out_d, out_i


def l2_topk_masked(q: torch.Tensor, pools: torch.Tensor, ids: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. q [Q, d] f32; pools [Q, C, d] f32 or bf16;
    ids [Q, C] i32 (-1 = padding); 1 <= k <= 256, C >= 1, d <= 1024.
    Raises on anything else, and on a non-CUDA tensor."""
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
                 (q_count, c, d), k, c, head=4 * d)
    launches["l2_topk_masked"] += 1
    return out
