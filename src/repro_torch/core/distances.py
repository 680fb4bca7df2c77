"""Distance primitives. δ(·,·) is SQUARED Euclidean throughout, matching
the paper's notation (§II Table II). ``topk_l2`` (every query against a
shared set, exact top-k) goes through the ``l2_topk`` CUDA kernel on the
card and its plain version on the CPU (``kernels/ops``); ``cdist2`` is a
plain tensor op for the graph phase and the build.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.float()), dim=-1)


def cdist2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [Q, N] = |q|^2 - 2 q.x + |x|^2, clamped at 0
    (the reference's expanded form, not ``torch.cdist``)."""
    q = q.float()
    x = x.float()
    d2 = sq_norms(q)[:, None] - 2.0 * (q @ x.T) + sq_norms(x)[None, :]
    return d2.clamp_min(0.0)


def topk_l2(q: torch.Tensor, x: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k nearest (ids [Q, k] int32, sq-dists [Q, k]) of each
    query row against x, ascending; ties go to the lower id, as with
    ``jax.lax.top_k``. Where x has fewer than k rows the rest pad with
    (-1, 3.4e38)."""
    d2, ids = ops.l2_topk(q.float().contiguous(), x.float().contiguous(), k)
    return ids, d2
