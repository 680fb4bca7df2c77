"""K-means (kmeans++ init) with optional SPANN-style balance penalty.

Used by the SPANN baseline (hierarchical balanced clustering stand-in) and
by CIC's locality partitioning. Lloyd iterations run as batched distance
computations on the device; the bookkeeping is numpy, as in the
reference.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.distances import cdist2
from repro_torch.device import DeviceLike, resolve_device


def _dist2(x_dev: torch.Tensor, c: np.ndarray) -> np.ndarray:
    """cdist2 of the on-device points against host centers -> numpy."""
    c_dev = torch.from_numpy(np.ascontiguousarray(c, np.float32)).to(
        x_dev.device)
    return cdist2(x_dev, c_dev).cpu().numpy()


def kmeanspp_init(x: np.ndarray, k: int, rng, x_dev: torch.Tensor
                  ) -> np.ndarray:
    """``x_dev`` is ``x`` on the device (the distance passes run there;
    the sampling stays numpy, so the seeds match the reference)."""
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    d2 = _dist2(x_dev, np.asarray(centers[-1])[None])[:, 0]
    for _ in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(x[rng.choice(n, p=probs)])
        nd = _dist2(x_dev, np.asarray(centers[-1])[None])[:, 0]
        d2 = np.minimum(d2, nd)
    return np.stack(centers)


def kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0,
           balance_weight: float = 0.0, device: DeviceLike = None
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (centers [k, d], assignment [n]).

    balance_weight > 0 adds a running-size penalty to the assignment
    distance (Liu et al. flexible-balance trick SPANN builds on): cost =
    δ(x, c_j) + w * mean_d2 * count_j / (n/k).
    """
    n = x.shape[0]
    x_dev = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        resolve_device(device))
    rng = np.random.default_rng(seed)
    centers = kmeanspp_init(x, k, rng, x_dev)
    assign = np.zeros(n, np.int64)
    target = n / k
    for _ in range(iters):
        d2 = _dist2(x_dev, centers)
        if balance_weight > 0:
            scale = balance_weight * float(d2.mean())
            counts = np.zeros(k, np.float64)
            order = rng.permutation(n)
            for s in range(0, n, 256):  # chunked greedy balance
                idx = order[s:s + 256]
                cost = d2[idx] + scale * counts[None, :] / target
                a = cost.argmin(axis=1)
                assign[idx] = a
                np.add.at(counts, a, 1)
        else:
            assign = d2.argmin(axis=1)
        for j in range(k):
            sel = assign == j
            if sel.any():
                centers[j] = x[sel].mean(axis=0)
            else:  # re-seed empty cluster at the worst-served point
                centers[j] = x[int(d2.min(axis=1).argmax())]
    return centers.astype(np.float32), assign.astype(np.int64)
