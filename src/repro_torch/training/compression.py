"""Gradient compression for the data-parallel all-reduce.

Port of ``repro/training/compression.py``: symmetric int8 quantization
with one scale shared by every rank (the all-reduce MAX of the ranks'
absmax), an all-reduce SUM of the int8 values widened to int32, as the
reference sums them (exact, and no overflow below 2^23 ranks), and one
dequantization. The
reference runs it inside ``shard_map`` with ``pmax``/``psum`` over a mesh
axis; the port takes a ``torch.distributed`` process group. Quantization
error is at most scale/2 per element and rank.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization with the given scale (an f32 scalar):
    round half to even, clipped to [-127, 127]."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127) \
        .to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grad: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """The sum of ``grad`` over the ranks of ``group`` (the default group
    if None), moved as int8 under a shared scale; in ``grad``'s dtype."""
    absmax = grad.float().abs().max()
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    total = quantize(grad, scale).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return dequantize(total, scale).to(grad.dtype)


def compressed_psum_tree(grads: Dict[str, torch.Tensor],
                         group: Optional[dist.ProcessGroup] = None
                         ) -> Dict[str, torch.Tensor]:
    return {k: compressed_psum(g, group) for k, g in grads.items()}
