"""Product Quantization (Jégou et al., TPAMI'11): codebook training,
encoding and ADC lookup tables for the compressed data plane (the
``pq_adc_masked`` CUDA kernel scores the codes against the tables).

Training, encoding and the ADC tables run on a torch device. The
reference's per-query ``adc_lut`` and numpy ``adc_distances`` serve its
DiskANN baseline and come with that port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.clustering import kmeans
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class PQCodebook:
    centroids: np.ndarray   # [M, 256, d_sub]
    M: int
    d: int

    @property
    def d_sub(self) -> int:
        return self.d // self.M


def train_pq(x: np.ndarray, M: int = 8, n_train: int = 4096,
             seed: int = 0, device: DeviceLike = None) -> PQCodebook:
    n, d = x.shape
    assert d % M == 0
    d_sub = d // M
    rng = np.random.default_rng(seed)
    sample = x[rng.choice(n, size=min(n_train, n), replace=False)]
    cents = np.zeros((M, 256, d_sub), np.float32)
    for m in range(M):
        sub = sample[:, m * d_sub:(m + 1) * d_sub]
        k = min(256, len(sub))
        c, _ = kmeans(sub, k, iters=6, seed=seed + m, device=device)
        cents[m, :k] = c
        if k < 256:
            cents[m, k:] = c[0]
    return PQCodebook(cents, M, d)


def encode_pq(cb: PQCodebook, x: np.ndarray, chunk: int = 8192,
              device: DeviceLike = None) -> np.ndarray:
    """x [n, d] -> codes [n, M] uint8. Row-wise, so encoding a whole base
    once and slicing it gives the codes of every slice."""
    device = resolve_device(device)
    n = x.shape[0]
    cents = torch.from_numpy(cb.centroids).to(device)
    codes = np.zeros((n, cb.M), np.uint8)
    for s in range(0, n, chunk):
        xb = torch.from_numpy(np.ascontiguousarray(
            x[s:s + chunk], np.float32)).to(device)
        for m in range(cb.M):
            sub = xb[:, m * cb.d_sub:(m + 1) * cb.d_sub]
            d2 = ((sub[:, None, :] - cents[m][None]) ** 2).sum(-1)
            codes[s:s + chunk, m] = d2.argmin(1).cpu().numpy()
    return codes


def adc_lut_batch(cb: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """ADC lookup tables for a query batch: q [Q, d] -> [Q, M, 256] f32
    on q's device (row q holds the squared distances of query q's
    subvectors to every centroid of each subspace)."""
    qb = q.float().reshape(len(q), cb.M, 1, cb.d_sub)
    cents = torch.from_numpy(np.ascontiguousarray(cb.centroids,
                                                  np.float32)).to(q.device)
    diff = cents[None] - qb                     # [Q, M, 256, d_sub]
    return torch.einsum("qmcd,qmcd->qmc", diff, diff)
