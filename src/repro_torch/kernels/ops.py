"""Dispatcher of the port's kernels.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the hand-written CUDA kernel, which launches or raises — there
is no fallback from the card to the plain version. Launch counts let a
caller show that a run went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import l2_topk as _l2
from repro_torch.kernels import pq_adc as _pq


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"unsupported device {t.device}")


def l2_topk_masked(q, pools, ids, k: int = 10):
    """q [Q, d], pools [Q, C, d], ids [Q, C] (-1 pads ragged rows)
    -> (d2 [Q, k] ascending, ids [Q, k]); short rows pad (3.4e38, -1)."""
    if _on_cpu(q):
        return _l2.l2_topk_masked_plain(q, pools, ids, k)
    return _l2.l2_topk_masked(q, pools, ids, k)


def pq_adc_masked(luts, codes, ids, k: int = 10):
    """luts [Q, M, 256] f32, codes [Q, C, M] u8, ids [Q, C] (-1 pads
    ragged rows) -> (d2 [Q, k] ascending, ids [Q, k]); short rows pad
    (3.4e38, -1)."""
    if _on_cpu(luts):
        return _pq.pq_adc_masked_plain(luts, codes, ids, k)
    return _pq.pq_adc_masked(luts, codes, ids, k)


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel since the last ``reset_launch_counts``."""
    return {"l2_topk_masked": _l2.launches, "pq_adc_masked": _pq.launches}


def reset_launch_counts() -> None:
    _l2.launches = 0
    _pq.launches = 0
