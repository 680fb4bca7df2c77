"""Distance primitives. δ(·,·) is SQUARED Euclidean throughout, matching
the paper's notation (§II Table II). The hot path (the masked pool scan
with top-k) is the CUDA kernel in ``kernels/l2_topk``; these are plain
tensor ops for the graph phase, the build and ground truth.
"""
from __future__ import annotations

from typing import Tuple

import torch


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
    """Exact top-k nearest (ids, sq-dists) of each query row against x;
    ties go to the lower id, as with ``jax.lax.top_k``."""
    d2, idx = torch.sort(cdist2(q, x), dim=1, stable=True)
    return idx[:, :k], d2[:, :k]
