"""K-means (kmeans++ init) with optional SPANN-style balance penalty.

Used by the SPANN baseline (hierarchical balanced clustering stand-in), by
CIC's locality partitioning and by the PQ codebooks. The distances, the
assignment (``argmin``, in chunks of points), the kmeans++ running
distance and the center update (``index_add_`` of the points and their
counts, in f64) stay on the device; only the index a kmeans++ draw picks
crosses to the host. Every random draw is numpy's, in the reference's
order (``rng.choice`` with its probabilities is one ``rng.random()``
against their cumulative sum), so the seeds match the reference's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.distances import cdist2
from repro_torch.device import DeviceLike, resolve_device

# points an assignment pass takes at a time: its [chunk, k] distances stay
# that small
ASSIGN_CHUNK = 1 << 14


def kmeanspp_init(x: np.ndarray, k: int, rng, x_dev: torch.Tensor
                  ) -> torch.Tensor:
    """The k initial centers [k, d] on the device. ``x_dev`` is ``x`` there;
    the running squared distance to the nearest center stays there, and
    each draw is ``rng.choice(n, p=d2 / d2.sum())``: the first index whose
    cumulative probability (f64, normalised by its last entry) exceeds
    ``rng.random()``."""
    n = x.shape[0]
    first = int(rng.integers(n))
    d2 = cdist2(x_dev, x_dev[first][None])[:, 0]
    chosen = torch.empty(k, dtype=torch.long, device=x_dev.device)
    chosen[0] = first
    for j in range(1, k):
        probs = d2 / torch.clamp(d2.sum(), min=1e-12)
        cdf = torch.cumsum(probs.double(), 0)
        u = torch.tensor([rng.random()], dtype=torch.float64,
                         device=x_dev.device)
        idx = torch.searchsorted(cdf / cdf[-1], u, right=True).clamp(
            max=n - 1)
        chosen[j] = idx[0]
        d2 = torch.minimum(d2, cdist2(x_dev, x_dev[idx])[:, 0])
    return x_dev[chosen].clone()


def _assign(x_dev: torch.Tensor, centers: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nearest center [n] int64, its squared distance [n]) of every point,
    ASSIGN_CHUNK points at a time; ties to the lower center."""
    best, dmin = [], []
    for s in range(0, x_dev.shape[0], ASSIGN_CHUNK):
        d, a = cdist2(x_dev[s:s + ASSIGN_CHUNK], centers).min(dim=1)
        best.append(a)
        dmin.append(d)
    return torch.cat(best), torch.cat(dmin)


def _balanced_assign(x_dev: torch.Tensor, centers: torch.Tensor,
                     balance_weight: float, rng) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """The reference's chunked greedy balance: the points in a random order
    (numpy's permutation), 256 at a time, each to the center of least
    cost d2 + w * mean_d2 * count / (n/k), the counts growing chunk by
    chunk; the cost in f64, as numpy promotes it. Returns (assignment,
    each point's nearest squared distance)."""
    n, k = x_dev.shape[0], centers.shape[0]
    d2 = torch.cat([cdist2(x_dev[s:s + ASSIGN_CHUNK], centers)
                    for s in range(0, n, ASSIGN_CHUNK)])
    scale = balance_weight * float(d2.sum(dtype=torch.float64) / d2.numel())
    target = n / k
    counts = torch.zeros(k, dtype=torch.float64, device=x_dev.device)
    ones = torch.ones(256, dtype=torch.float64, device=x_dev.device)
    assign = torch.zeros(n, dtype=torch.long, device=x_dev.device)
    order = torch.from_numpy(rng.permutation(n)).to(x_dev.device)
    for s in range(0, n, 256):  # chunked greedy balance
        idx = order[s:s + 256]
        cost = d2[idx].double() + scale * counts[None, :] / target
        a = cost.argmin(dim=1)
        assign[idx] = a
        counts.index_add_(0, a, ones[:a.shape[0]])
    return assign, d2.min(dim=1).values


def kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0,
           balance_weight: float = 0.0, device: DeviceLike = None
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (centers [k, d], assignment [n]).

    balance_weight > 0 adds a running-size penalty to the assignment
    distance (Liu et al. flexible-balance trick SPANN builds on): cost =
    δ(x, c_j) + w * mean_d2 * count_j / (n/k).
    """
    x_dev = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        resolve_device(device))
    rng = np.random.default_rng(seed)
    centers = kmeanspp_init(x, k, rng, x_dev)
    assign = torch.zeros(x.shape[0], dtype=torch.long, device=x_dev.device)
    x64 = x_dev.double()
    for _ in range(iters):
        if balance_weight > 0:
            assign, dmin = _balanced_assign(x_dev, centers, balance_weight,
                                            rng)
        else:
            assign, dmin = _assign(x_dev, centers)
        sums = torch.zeros(k, x_dev.shape[1], dtype=torch.float64,
                           device=x_dev.device).index_add_(0, assign, x64)
        counts = torch.bincount(assign, minlength=k)
        # an empty cluster is re-seeded at the worst-served point
        centers = torch.where(
            (counts > 0)[:, None],
            (sums / counts.clamp(min=1)[:, None]).float(),
            x_dev[dmin.argmax()][None])
    return centers.cpu().numpy(), assign.cpu().numpy().astype(np.int64)
