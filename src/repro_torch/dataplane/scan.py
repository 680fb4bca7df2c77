"""Scan stage of the staged data plane: the CUDA kernel launches.

``ScanStage`` wraps the two masked ragged-pool launches — ``l2_topk``
(exact distance/top-k over the pooled candidates) and ``pq_adc`` (ADC
scoring of pooled PQ codes + cover-aware refine-partition selection) —
behind one object that owns padding, id bookkeeping, host wall-clock
timing of the pooling and the launches, and the dedup rule for redundant
copies (Def 5). Pools are padded on the host, as in the reference, and
moved to the stage's device with ``torch.from_numpy(...).to(device)``;
on a CUDA device the launches reach the hand-written kernels, on the CPU
their plain versions (``kernels.ops``).

Wall times go to the installed metrics registry
(``search.pool_wall_s``, ``kernels.launch_s``) and, when tracing, to
``kernel_launch`` wall spans; each clock stops after the results' copy
back to the host, which waits for the kernel.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.obs import get_metrics, get_tracer

INF = np.float32(3.4e38)
ID_SENTINEL = 2 ** 62   # invalid-id marker used during dedup


def dedup_first(ids: np.ndarray) -> np.ndarray:
    """Keep-mask of the first occurrence of each id (redundant copies,
    Def 5). Invalid ids (< 0) map to the ID_SENTINEL and are dropped."""
    ids = np.where(ids >= 0, ids, ID_SENTINEL)
    _, first = np.unique(ids, return_index=True)
    mask = np.zeros(len(ids), bool)
    mask[first] = True
    mask &= ids < ID_SENTINEL
    return mask


def _wall_timed() -> bool:
    return get_tracer().enabled or get_metrics().enabled


def _record_launch(name: str, dt: float, args: dict):
    get_tracer().wall_span(f"kernel_launch {name}", dt, args)
    get_metrics().observe("kernels.launch_s", dt)


class ScanStage:
    """The compute stage: one masked kernel launch per scan kind."""

    def __init__(self, device: torch.device):
        self.device = device

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---------------------------------------------------------- exact topk
    def topk(self, queries: np.ndarray, pool_ids: List[np.ndarray],
             pool_vecs: List[np.ndarray], k: int
             ) -> Tuple[np.ndarray, np.ndarray]:
        """One vectorized distance/top-k pass over every query's candidate
        pool (ragged rows padded with id -1), routed through the masked
        l2_topk kernel. Returns (ids [Q, k] int64, d2 [Q, k])."""
        timed = _wall_timed()
        t0 = time.perf_counter() if timed else 0.0
        q_count, d = queries.shape
        c_max = max((len(p) for p in pool_ids), default=0)
        if c_max == 0:
            return (np.full((q_count, k), -1, np.int64),
                    np.full((q_count, k), INF, np.float32))
        ids_pad = np.full((q_count, c_max), -1, np.int32)
        vecs_pad = np.zeros((q_count, c_max, d), np.float32)
        for qi in range(q_count):
            n = len(pool_ids[qi])
            if n:
                ids_pad[qi, :n] = pool_ids[qi]
                vecs_pad[qi, :n] = pool_vecs[qi]
        if timed:
            t1 = time.perf_counter()
            get_metrics().observe("search.pool_wall_s", t1 - t0)
        d2, ids = ops.l2_topk_masked(
            self._to_dev(queries.astype(np.float32)),
            self._to_dev(vecs_pad), self._to_dev(ids_pad), k=k)
        out = ids.cpu().numpy().astype(np.int64), d2.cpu().numpy()
        if timed:  # the copies back waited for the kernel
            _record_launch("l2_topk", time.perf_counter() - t1,
                           {"queries": q_count, "c_max": c_max, "k": k})
        return out

    # ------------------------------------------------------------ ADC pass
    def adc_select(self, codebook, queries: np.ndarray,
                   probes_all: List[List[int]],
                   objs: Dict[int, np.ndarray], pag, rerank_k: int
                   ) -> List[List[int]]:
        """The ADC stage of the compressed plane: pool every query's
        fetched code objects (rows mapped to original ids via the
        in-memory ``pag.plist``, deduped like the exact pool), score ALL
        pools in one masked kernel launch, and return, per query, the
        partitions holding its ADC-top ``rerank_k`` candidates (ordered
        by ADC rank) — the exact refine wave's fetch list. Redundant
        copies (Def 5) make the partition choice a covering problem: a
        candidate counts as covered by ANY already-selected partition
        holding one of its copies, so the refine wave fetches the fewest
        partitions that cover the ADC top."""
        from repro_torch.baselines.pq import adc_lut_batch
        timed = _wall_timed()
        t0 = time.perf_counter() if timed else 0.0
        q_count = len(probes_all)
        cand_pids: List[np.ndarray] = []
        cand_codes: List[np.ndarray] = []
        cand_ids: List[np.ndarray] = []
        id_pids: List[Dict[int, List[int]]] = []  # id -> probed pids
        for qi in range(q_count):
            ids_l, pids_l, codes_l = [], [], []
            for pid in probes_all[qi]:
                codes = objs.get(pid)
                if codes is None:
                    continue
                cnt = codes.shape[0]
                ids_l.append(pag.plist[pid, :cnt].astype(np.int64))
                pids_l.append(np.full(cnt, pid, np.int32))
                codes_l.append(codes)
            if ids_l:
                ids_c = np.concatenate(ids_l)
                pids_c = np.concatenate(pids_l)
                keep = dedup_first(ids_c)  # redundant copies score once
                cand_pids.append(pids_c[keep])
                cand_codes.append(np.concatenate(codes_l)[keep])
                cand_ids.append(ids_c[keep])
                by_id: Dict[int, List[int]] = {}
                for i, cid in zip(pids_c, ids_c):
                    by_id.setdefault(int(cid), []).append(int(i))
                id_pids.append(by_id)
            else:
                cand_pids.append(np.zeros(0, np.int32))
                cand_codes.append(np.zeros((0, codebook.M), np.uint8))
                cand_ids.append(np.zeros(0, np.int64))
                id_pids.append({})

        c_max = max((len(p) for p in cand_pids), default=0)
        if c_max == 0:
            return [[] for _ in range(q_count)]
        m = codebook.M
        codes_pad = np.zeros((q_count, c_max, m), np.uint8)
        pos_pad = np.full((q_count, c_max), -1, np.int32)
        for qi in range(q_count):
            n = len(cand_pids[qi])
            if n:
                codes_pad[qi, :n] = cand_codes[qi]
                pos_pad[qi, :n] = np.arange(n, dtype=np.int32)
        if timed:
            t1 = time.perf_counter()
            get_metrics().observe("search.pool_wall_s", t1 - t0)
        luts = adc_lut_batch(codebook,
                             self._to_dev(queries.astype(np.float32)))
        _, pos = ops.pq_adc_masked(luts, self._to_dev(codes_pad),
                                   self._to_dev(pos_pad), k=rerank_k)
        pos = pos.cpu().numpy()
        if timed:  # the copy back waited for the kernel
            _record_launch("pq_adc", time.perf_counter() - t1,
                           {"queries": q_count, "c_max": c_max, "M": m,
                            "rerank_k": rerank_k})

        refine_all: List[List[int]] = []
        for qi in range(q_count):
            chosen: List[int] = []
            chosen_set: set = set()
            for p in pos[qi]:
                if p < 0:
                    continue
                copies = id_pids[qi].get(int(cand_ids[qi][p]))
                if copies is None:  # defensive: scored row has copies
                    copies = [int(cand_pids[qi][p])]
                if chosen_set.intersection(copies):
                    continue  # a selected partition already holds a copy
                pid = int(cand_pids[qi][p])
                chosen.append(pid)
                chosen_set.add(pid)
            refine_all.append(chosen)
        return refine_all
