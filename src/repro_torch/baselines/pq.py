"""Product Quantization (Jégou et al., TPAMI'11): codebook training,
encoding and ADC lookup tables, for the compressed data plane (the
``pq_adc_masked`` CUDA kernel scores pooled codes against per-query
tables) and for the DiskANN baseline's in-memory guidance distances
(``adc_luts`` for a query batch, ``adc_distances_rows`` through the
``pq_adc_rows`` CUDA kernel on the card, one launch per search wave).

Training, encoding and the ADC tables run on a torch device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.clustering import kmeans
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass
class PQCodebook:
    centroids: np.ndarray   # [M, 256, d_sub]
    M: int
    d: int

    @property
    def d_sub(self) -> int:
        return self.d // self.M

    def centroids_on(self, device) -> torch.Tensor:
        """The centroids as a float32 tensor on ``device``."""
        return torch.from_numpy(np.ascontiguousarray(
            self.centroids, np.float32)).to(device)


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
    diff = cb.centroids_on(q.device)[None] - qb     # [Q, M, 256, d_sub]
    return torch.einsum("qmcd,qmcd->qmc", diff, diff)


def adc_lut(cb: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """Asymmetric-distance lookup table for one query q [d]: [M, 256] f32
    on q's device, the reference's ``adc_lut`` (row m: squared distances
    of q's m-th subvector to every centroid of subspace m)."""
    diff = cb.centroids_on(q.device) - q.float().reshape(cb.M, 1, cb.d_sub)
    return (diff * diff).sum(-1)


def adc_luts(cb: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """``adc_lut`` of every query of q [Q, d] -> [Q, M, 256] f32 on q's
    device, in one batched op with ``adc_lut``'s own arithmetic (the
    elementwise square, then the sum over the subvector's last axis), so
    row q equals ``adc_lut(cb, q[q])`` bit for bit (``adc_lut_batch``
    sums through ``einsum``, whose order may differ)."""
    diff = cb.centroids_on(q.device)[None] \
        - q.float().reshape(len(q), cb.M, 1, cb.d_sub)
    return (diff * diff).sum(-1)


def adc_distances_rows(luts: torch.Tensor, table: torch.Tensor,
                       rows: np.ndarray, offsets: np.ndarray
                       ) -> torch.Tensor:
    """Approximate sq-distances of many queries' code rows in one call:
    luts [Q, M, 256] and the code table [n, M] on one device, rows [T]
    node ids and offsets [Q + 1] on the host (query q owns rows
    [offsets[q], offsets[q + 1])) -> [T] f32 on the device. The ids and
    offsets go up in one copy; the ``pq_adc_rows`` kernel gathers the code
    rows itself (its plain version for CPU tensors)."""
    q_count = luts.shape[0]
    packed = torch.from_numpy(np.concatenate(
        [np.asarray(offsets), np.asarray(rows)]).astype(np.int32)).to(
        luts.device)
    return ops.pq_adc_rows(luts, table, packed[q_count + 1:],
                           packed[:q_count + 1])
