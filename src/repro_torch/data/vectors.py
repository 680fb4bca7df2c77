"""Synthetic vector datasets with exact ground truth.

`clustered` mimics SIFT/GIST-like local density structure (Gaussian
mixture with zipf-weighted cluster sizes and per-cluster anisotropy) so
partition-balance pathologies the paper targets (long-tail partitions,
boundary effects) actually appear. `uniform` is the adversarial no-structure
case. Ground truth is exact brute force, computed in query chunks by
``topk_l2`` (the ``l2_topk`` kernel on the card). The numpy generator is the reference's, call for call, so a seed
gives bit-identical vectors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.distances import topk_l2
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class VectorDataset:
    name: str
    base: np.ndarray       # [n, d] float32
    queries: np.ndarray    # [q, d] float32
    gt_ids: np.ndarray     # [q, k_gt] int32 exact nearest neighbors
    gt_d2: np.ndarray      # [q, k_gt] squared distances

    @property
    def n(self):
        return self.base.shape[0]

    @property
    def d(self):
        return self.base.shape[1]


def brute_force_knn(base: np.ndarray, queries: np.ndarray, k: int,
                    chunk: int = 512, device: DeviceLike = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k nearest of each query, ascending by (d2, id): ties go to
    the lower id, as ``jax.lax.top_k`` gives them."""
    device = resolve_device(device)
    base_dev = torch.from_numpy(np.ascontiguousarray(base, np.float32)).to(
        device)
    ids, d2s = [], []
    for i in range(0, queries.shape[0], chunk):
        q = torch.from_numpy(np.ascontiguousarray(
            queries[i:i + chunk], np.float32)).to(device)
        idx, dd = topk_l2(q, base_dev, k)
        ids.append(idx.cpu().numpy())
        d2s.append(dd.cpu().numpy())
    return (np.concatenate(ids).astype(np.int32),
            np.concatenate(d2s).astype(np.float32))


def make_dataset(kind: str = "clustered", n: int = 20000, d: int = 32,
                 n_queries: int = 200, k_gt: int = 100,
                 seed: int = 0, device: DeviceLike = None) -> VectorDataset:
    """Vectors from the reference's numpy generator; the ground truth runs
    on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        base = rng.standard_normal((n, d), dtype=np.float32)
    elif kind == "clustered":
        n_clusters = max(n // 400, 8)
        weights = 1.0 / np.arange(1, n_clusters + 1) ** 1.1  # zipf sizes
        weights /= weights.sum()
        # moderate separation (SIFT-like overlap): inter-center distance a
        # couple of cluster radii, not a disconnected archipelago
        centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
        assign = rng.choice(n_clusters, size=n, p=weights)
        scales = (0.3 + rng.gamma(2.0, 0.3, size=(n_clusters, d))).astype(
            np.float32)
        base = centers[assign] + rng.standard_normal(
            (n, d)).astype(np.float32) * scales[assign]
    else:
        raise ValueError(kind)
    # queries follow the base distribution (held-out perturbations)
    q_src = rng.choice(n, size=n_queries, replace=False)
    queries = base[q_src] + 0.1 * rng.standard_normal(
        (n_queries, d)).astype(np.float32)
    gt_ids, gt_d2 = brute_force_knn(base, queries, k_gt, device=device)
    return VectorDataset(f"{kind}-{n}x{d}", base.astype(np.float32),
                         queries.astype(np.float32), gt_ids, gt_d2)


def recall_at_k(result_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """Paper Eq. 1."""
    hits = 0
    for r, g in zip(result_ids[:, :k], gt_ids[:, :k]):
        hits += len(set(r.tolist()) & set(g.tolist()))
    return hits / (gt_ids.shape[0] * k)
