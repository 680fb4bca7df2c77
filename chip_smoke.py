#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of DSANN on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (one process per source, all at once), holds each kernel
against its plain PyTorch version on the card (edge cases and exact-tie
inputs), then drives three paths, each with its kernel launches counted
from zero and checked:

* quality and main: ``make_dataset`` (ground truth through ``l2_topk``)
  -> ``build_pag`` -> ``write_partitions`` (PQ payloads, "dfs" storage
  preset, 4 shards) -> every query through ``AnnsFrontend`` over
  ``ShardedServing``, once on the float plane and once on the PQ plane
  (``l2_topk_masked``, ``pq_adc_masked``). At 30,000 x 128 with 512
  queries the recall floor of the algorithm's working regime must hold;
  the main run is SIFT1M's shape (1,000,000 x 128 float32, made from a
  seed) with 2048 queries.
* compare: the paper's comparison (Table IV, Figs 8-10) at 100,000 x 128
  with 1000 queries: PAG, DiskANN (``pq_adc`` per hop), SPANN (closure
  assignment through ``l2_topk``) and HNSW built and searched, the CIC
  build on half the rows, and a checkpoint round trip of the PAG. One
  JSON row per method and setting (recall@10, simulated QPS, build and
  wall seconds), then the PAG/DiskANN QPS ratio at recall >= 0.85 and
  at the highest recall both reach.

Last, each kernel is timed with CUDA events on the inputs its path gave
it, beside its plain version, one PyTorch library formulation of the
same function and its bound.

Prints each phase's wall time, the card's name and power limit, one JSON
line of kernel numbers, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
there is no CUDA card or any check fails. Imports nothing of JAX or of
the reference package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# SIFT1M shape; index and search at the repo's DFS/PQ operating point
# (benchmarks/qps_recall.py pq_main: p=0.01, lam=8, redundancy=2,
# n_probe_max=32, rerank_k from its sweep (16, 32, 64))
N, D, N_QUERIES, K = 1_000_000, 128, 2048, 10
PAG_ARGS = dict(p=0.01, lam=8, redundancy=2, R=16)
N_SHARDS, MAX_BATCH = 4, 256
SEARCH_ARGS = dict(L=32, k=K, n_probe_max=32, rerank_k=64)
PQ_M = 8
PQ_RECALL_GAP = 0.02        # PQ plane within this of the float plane
# Float recall@10 floors. The same index parameters at 30k points serve
# at 0.95 (the algorithm's working regime) and must clear 0.80. At 1M,
# build_pag promotes ~40% of the residuals into the graph as empty
# partitions, reachable mostly through their random edges, and recall
# falls to 0.38 (H100 runs, PERF.md); the 1M floor guards that level
# against regressions.
QUALITY_N, QUALITY_QUERIES, QUALITY_FLOOR = 30_000, 512, 0.80
SCALE_FLOOR = 0.35

# The paper's comparison (Table IV, Figs 8-10) at SIFT width, a tenth of
# SIFT1M's depth: benchmarks/common.py:128-165 builds and
# benchmarks/qps_recall.py _curves with its smoke sweeps (the first two
# settings; DiskANN's whole sweep, so that it reaches the recall of the
# PAG/DiskANN ratio). 100k because SPANN's kmeans holds a
# [n, n/16] float32 distance matrix (250 GB at 1M).
CMP_N, CMP_QUERIES = 100_000, 1000
CMP_PAG_ARGS = dict(p=0.2, lam=3.0, redundancy=4)
CMP_PAG_SWEEP = [(32, 16), (64, 32)]
CMP_DK_SWEEP = [16, 32, 64]
CMP_SP_SWEEP = [(32, 8), (32, 16)]
CMP_HN_SWEEP = [16, 32]
CIC_N, CIC_L = 50_000, 32
RATIO_RECALL = 0.85
# recall@10 floors, 0.03 below the value measured on the H100 (beside
# each; deterministic seeds). 128-dimensional Gaussian clusters are hard
# for R=16 graphs: no method reaches the ratio's 0.85 here (PERF.md).
CMP_FLOORS = {("PAG", "L32/p16"): 0.2372,          # 0.2672
              ("PAG", "L64/p32"): 0.3657,          # 0.3957
              ("DiskANN", "L16"): 0.1694,          # 0.1994
              ("DiskANN", "L32"): 0.2711,          # 0.3011
              ("DiskANN", "L64"): 0.4251,          # 0.4551
              ("SPANN", "L32/p8"): 0.4726,         # 0.5026
              ("SPANN", "L32/p16"): 0.5281,        # 0.5581
              ("HNSW", "L16"): 0.4645,             # 0.4945
              ("HNSW", "L32"): 0.5686,             # 0.5986
              ("CIC", f"c4/n{CIC_N}/L{CIC_L}"): 0.1747}   # 0.2047

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
INF = 3.4e38


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want, exact: bool,
            atol: float = 1e-4) -> float:
    """Hold a kernel's (d2, ids) against its plain version's. Exact inputs
    must agree bit for bit, ids included (the tie rule); float inputs to
    |a - b| <= atol + 1e-4 |b| on d2, and ids may differ only at
    positions whose distances agree to that tolerance (a near-tie).
    Returns the max abs error over real entries."""
    gd, gi = (t.cpu() for t in got)
    wd, wi = (t.cpu() for t in want)
    if exact:
        if not (torch.equal(gi, wi) and torch.equal(gd, wd)):
            bad = (gi != wi).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: exact inputs disagree at {bad}")
        return 0.0
    if not torch.equal(gi < 0, wi < 0):
        raise AssertionError(f"{name}: padding positions disagree")
    real = wi >= 0
    err = (gd - wd).abs()
    tol = atol + 1e-4 * wd.abs()
    if (err > tol)[real].any():
        raise AssertionError(f"{name}: d2 off by {err[real].max():.3g}")
    if ((gi != wi) & real & (err > tol)).any():
        raise AssertionError(f"{name}: ids differ beyond near-ties")
    return float(err[real].max()) if real.any() else 0.0


def ragged_ids(rng, q: int, c: int, dev) -> torch.Tensor:
    """Distinct ids per row with ragged lengths 0..C (row 0 all padding)."""
    ids = np.tile(rng.permutation(1 << 20)[:c].astype(np.int32), (q, 1))
    lens = np.linspace(0, c, q).astype(int)
    ids[np.arange(c)[None, :] >= lens[:, None]] = -1
    return torch.from_numpy(ids).to(dev)


def norm_atol(q: torch.Tensor, x: torch.Tensor) -> float:
    """The expanded form |q|^2 - 2 q.x + |x|^2 loses float32 digits
    against the norms, not against the (small) distance itself."""
    return 1e-5 * float((q * q).sum(-1).max() + (x * x).sum(-1).max())


def check_unmasked_edges(dev) -> None:
    """l2_topk and pq_adc against their plain versions on the card."""
    from repro_torch.kernels import l2_topk, pq_adc
    rng = np.random.default_rng(1)
    # (Q, N, d, k): N < k; N, d off every tile; k = 1, 100, 256; Q >> N
    # (SPANN's closure shape); N >> Q (the ground truth's, rows split)
    for qn, n, d, k in [(5, 7, 16, 10), (9, 1000, 24, 10),
                        (33, 777, 128, 1), (40, 5000, 128, 100),
                        (7, 3000, 64, 256), (20_000, 6250, 128, 8),
                        (3, 200_000, 128, 10)]:
        q = torch.from_numpy(rng.standard_normal((qn, d), np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(dev)
        compare(f"l2_topk {qn}x{n}x{d} k={k}", l2_topk.l2_topk(q, x, k),
                l2_topk.l2_topk_plain(q, x, k), exact=False,
                atol=norm_atol(q, x))
    # small integers: exact distances; duplicate rows tie at the k-th
    # place, within one row slice and across the merged slices
    for qn, n, k in [(6, 3000, 64), (4, 100_000, 10), (5, 2, 3)]:
        q = rng.integers(-2, 3, (qn, 16)).astype(np.float32)
        x = rng.integers(-2, 3, (n, 16)).astype(np.float32)
        x[n // 2:n // 2 + 4] = q[0]            # four exact ties at d2 = 0
        q, x = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
        compare(f"l2_topk ties {qn}x{n} k={k}", l2_topk.l2_topk(q, x, k),
                l2_topk.l2_topk_plain(q, x, k), exact=True)

    # pq_adc sums in the plain version's order: bit for bit
    for n, m, dtype in [(1, 8, np.uint8), (64, 8, np.uint8),
                        (1000, 16, np.uint8), (777, 16, np.int32),
                        (50_000, 8, np.uint8)]:
        lut = torch.from_numpy(rng.random((m, 256), np.float32)).to(dev)
        codes = rng.integers(0, 256, (n, m)).astype(dtype)
        codes[0] = 0
        codes[-1] = 255
        codes = torch.from_numpy(codes).to(dev)
        got, want = pq_adc.pq_adc(lut, codes), pq_adc.pq_adc_plain(lut, codes)
        if not torch.equal(got, want):
            raise AssertionError(f"pq_adc {n}x{m} {dtype.__name__}: off by "
                                 f"{(got - want).abs().max():.3g}")
    lut = torch.zeros((8, 256), device=dev)
    codes = torch.zeros((4, 8), dtype=torch.uint8, device=dev)
    for bad in (lambda: l2_topk.l2_topk(q, x, 257),
                lambda: l2_topk.l2_topk(q.cpu(), x, 5),
                lambda: l2_topk.l2_topk(q, x[:, :8], 5),
                lambda: pq_adc.pq_adc(lut, codes.float()),
                lambda: pq_adc.pq_adc(torch.zeros((65, 256), device=dev),
                                      codes[:, :1].expand(4, 65)
                                      .contiguous()),
                lambda: pq_adc.pq_adc(lut.cpu(), codes)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("a kernel took arguments it must refuse")
    torch.cuda.synchronize()


def check_kernel_edges(dev) -> None:
    """Kernel vs plain version on edge shapes and exact-tie inputs."""
    from repro_torch.kernels import l2_topk, ops, pq_adc
    check_unmasked_edges(dev)
    rng = np.random.default_rng(0)
    for q, c, d, k, dtype in [(4, 96, 16, 5, torch.float32),
                              (9, 257, 32, 10, torch.float32),
                              (6, 40, 24, 64, torch.float32),   # C < k
                              (3, 1000, 128, 200, torch.float32),
                              (5, 777, 128, 10, torch.bfloat16)]:
        qv = torch.from_numpy(rng.standard_normal((q, d), np.float32)).to(dev)
        pools = torch.from_numpy(
            rng.standard_normal((q, c, d), np.float32)).to(dev, dtype)
        ids = ragged_ids(rng, q, c, dev)
        compare(f"l2_topk_masked {q}x{c}x{d} k={k} {dtype}",
                l2_topk.l2_topk_masked(qv, pools, ids, k),
                l2_topk.l2_topk_masked_plain(qv, pools, ids, k), exact=False)
    # small integers: every distance exact, many exact ties
    qv = torch.from_numpy(rng.integers(-2, 3, (8, 16)).astype(np.float32))
    pools = torch.from_numpy(rng.integers(-2, 3, (8, 600, 16)).astype(
        np.float32))
    ids = ragged_ids(rng, 8, 600, "cpu")
    args = (qv.to(dev), pools.to(dev), ids.to(dev), 64)
    compare("l2_topk_masked ties", l2_topk.l2_topk_masked(*args),
            l2_topk.l2_topk_masked_plain(*args), exact=True)

    for q, c, m, k in [(4, 96, 8, 5), (7, 257, 4, 10), (5, 40, 16, 64),
                       (3, 1000, 64, 200)]:
        luts = torch.from_numpy(rng.random((q, m, 256), np.float32)).to(dev)
        codes = torch.from_numpy(
            rng.integers(0, 256, (q, c, m), dtype=np.uint8)).to(dev)
        ids = ragged_ids(rng, q, c, dev)
        compare(f"pq_adc_masked {q}x{c}x{m} k={k}",
                pq_adc.pq_adc_masked(luts, codes, ids, k),
                pq_adc.pq_adc_masked_plain(luts, codes, ids, k), exact=False)
    luts = torch.from_numpy(rng.integers(0, 4, (6, 8, 256)).astype(
        np.float32)).to(dev)
    codes = torch.from_numpy(
        rng.integers(0, 256, (6, 900, 8), dtype=np.uint8)).to(dev)
    ids = ragged_ids(rng, 6, 900, dev)
    compare("pq_adc_masked ties", pq_adc.pq_adc_masked(luts, codes, ids, 32),
            pq_adc.pq_adc_masked_plain(luts, codes, ids, 32), exact=True)
    # C == 0: sentinels without a launch
    before = ops.launch_counts()["pq_adc_masked"]
    out_d, out_i = pq_adc.pq_adc_masked(luts, codes[:, :0].contiguous(),
                                        ids[:, :0].contiguous(), 5)
    if not ((out_i == -1).all() and (out_d == INF).all()
            and ops.launch_counts()["pq_adc_masked"] == before):
        raise AssertionError("pq_adc_masked: C == 0 must return sentinels")
    # what the kernels do not take raises: C == 0 for l2, k > 256, a CPU
    # tensor, a non-contiguous pool
    q2, p2 = args[0], args[1]
    i2 = args[2]
    for bad in (lambda: l2_topk.l2_topk_masked(
                    q2, p2[:, :0].contiguous(), i2[:, :0].contiguous(), 5),
                lambda: l2_topk.l2_topk_masked(q2, p2, i2, 257),
                lambda: l2_topk.l2_topk_masked(q2.cpu(), p2, i2, 5),
                lambda: l2_topk.l2_topk_masked(q2, p2[:, ::2], i2[:, ::2],
                                               5),
                lambda: pq_adc.pq_adc_masked(luts, codes, ids, 257),
                lambda: pq_adc.pq_adc_masked(luts.cpu(), codes, ids, 5)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("a kernel took arguments it must refuse")
    torch.cuda.synchronize()


class Capture:
    """Keeps the inputs of the first call of a kernel entry point in
    ``repro_torch.kernels.ops`` that ``want(args)`` accepts (for timing at
    a path's own shapes); the call itself goes on to the real wrapper
    unchanged."""

    def __init__(self, ops, name: str, want):
        self.ops, self.name, self.want = ops, name, want
        self.orig = getattr(ops, name)
        self.args = None

    def __enter__(self):
        def wrapped(*args, **kw):
            if self.args is None and self.want(args):
                self.args = (args, kw)
            return self.orig(*args, **kw)
        setattr(self.ops, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)


def serve(plane: str, pag, store, ds, dev,
          rerank_k: int = SEARCH_ARGS["rerank_k"]):
    """Every query of ``ds`` through AnnsFrontend over ShardedServing;
    returns (ids, d2, report)."""
    from repro_torch.core.distributed import ShardedServing
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.vectors import recall_at_k
    from repro_torch.obs import observe
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serving.engine import AnnsFrontend
    cfg = SearchConfig(**{**SEARCH_ARGS, "rerank_k": rerank_k},
                       compression=plane)
    frontend = AnnsFrontend(
        ShardedServing(pag=pag, store=store, n_shards=N_SHARDS, dim=D,
                       device=dev), cfg, max_batch=MAX_BATCH)
    metrics = MetricsRegistry()
    t0 = time.perf_counter()
    with observe(metrics=metrics):
        tickets = [frontend.submit(q) for q in ds.queries]
        results = frontend.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ids = np.stack([results[t][0] for t in tickets])
    d2 = np.stack([results[t][1] for t in tickets])
    snap = metrics.snapshot()
    report = {
        "recall@10": recall_at_k(ids, ds.gt_ids, K),
        "wall_qps": len(tickets) / wall,
        "batch_qps": len(tickets) / frontend.clock_s,
        "wall_s": wall,
        "graph_wall_s": snap["search.graph_wall_s.sum"],
        "pool_wall_s": snap["search.pool_wall_s.sum"],
        "kernel_wall_s": snap["kernels.launch_s.sum"],
        "pool_size_mean": snap["search.pool_size.mean"],
    }
    return ids, d2, report


def check_results(ids, d2, ds, dev) -> None:
    """Shapes, finiteness, and returned distances re-derived exactly on
    the card for a sample of queries."""
    nq = len(ds.queries)
    if ids.shape != (nq, K) or d2.shape != (nq, K):
        raise AssertionError(f"result shapes {ids.shape}, {d2.shape}")
    if not ((ids >= 0).all() and np.isfinite(d2).all()
            and (ids < ds.n).all()):
        raise AssertionError("results hold padding, ids out of range or "
                             "non-finite distances")
    if (np.diff(d2, axis=1) < 0).any():
        raise AssertionError("result distances are not ascending")
    sample = np.arange(0, nq, 16)
    x = torch.from_numpy(ds.base[ids[sample]]).to(dev)
    q = torch.from_numpy(ds.queries[sample]).to(dev)
    true = ((x - q[:, None, :]) ** 2).sum(-1).cpu().numpy()
    if not np.allclose(d2[sample], true, rtol=1e-3, atol=1e-3):
        raise AssertionError("returned distances do not match the base")


def index_and_serve(tag: str, n: int, n_queries: int, floor: float, dev,
                    other_rerank=()):
    """make_dataset -> build_pag -> write_partitions -> both planes
    through the frontend, each step a phase; checks results and floors.
    ``other_rerank`` lists rerank_k values whose PQ-plane recall is
    reported beside (no floor). Returns the reports."""
    from repro_torch.core.pag import build_pag
    from repro_torch.core.search import write_partitions
    from repro_torch.data.vectors import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.storage.simulator import ObjectStore, StorageConfig
    with phase(f"{tag}: make_dataset n={n}"):
        ds = make_dataset("clustered", n=n, d=D, n_queries=n_queries,
                          k_gt=K, seed=0, device=dev)
    with phase(f"{tag}: build_pag"):
        pag = build_pag(ds.base, **PAG_ARGS, device=dev)
        nonempty = int((pag.pcount[:pag.n_parts] > 0).sum())
        print(f"{tag} partitions: {pag.n_parts} ({nonempty} nonempty, cap "
              f"{pag.cap}), build stats {json.dumps(pag.build_stats)}")
    with phase(f"{tag}: write_partitions"):
        store = ObjectStore(StorageConfig.preset("dfs", seed=1))
        write_partitions(pag, ds.base, store, n_shards=N_SHARDS,
                         compression="pq", pq_m=PQ_M, device=dev)
    reports = {}
    with phase(f"{tag}: serve float and pq planes"):
        for plane in ("none", "pq"):
            before = ops.launch_counts()
            ids, d2, rep = serve(plane, pag, store, ds, dev)
            rep["launches"] = {name: c - before[name]
                               for name, c in ops.launch_counts().items()}
            check_results(ids, d2, ds, dev)
            reports[plane] = rep
            print(f"{tag} serve {plane}: {json.dumps(rep)}", flush=True)
    fl, pq = reports["none"]["recall@10"], reports["pq"]["recall@10"]
    if fl < floor or pq < fl - PQ_RECALL_GAP:
        raise AssertionError(f"{tag} recall floors: float {fl:.4f} (>= "
                             f"{floor}), pq {pq:.4f} (>= float - "
                             f"{PQ_RECALL_GAP})")
    for rk in other_rerank:
        with phase(f"{tag}: serve pq plane at rerank_k={rk}"):
            rep = serve("pq", pag, store, ds, dev, rerank_k=rk)[2]
            print(f"{tag} serve pq rerank_k={rk}: {json.dumps(rep)}")
    return reports


def comparison(dev, n: int = CMP_N, n_queries: int = CMP_QUERIES,
               cic_n: int = CIC_N) -> list:
    """The paper's comparison (benchmarks/qps_recall.py _curves and
    benchmarks/build_time.py, smoke sweeps): PAG, DiskANN, SPANN and HNSW
    built and searched on one clustered dataset, the CIC build, and a
    checkpoint round trip of the PAG. Prints one JSON row per method and
    setting, the PAG/DiskANN QPS ratio at recall >= RATIO_RECALL and
    Table IV's build-time claim; checks each row's recall floor and
    returns the rows."""
    import tempfile
    from repro_torch.baselines.diskann import build_diskann, search_diskann
    from repro_torch.baselines.hnsw import build_hnsw, search_hnsw
    from repro_torch.baselines.spann import build_spann, search_spann
    from repro_torch.core.cic import cic_build
    from repro_torch.core.graph_search import greedy_search
    from repro_torch.core.index import load_index, save_index
    from repro_torch.core.pag import build_pag
    from repro_torch.core.search import (
        SearchConfig,
        search_pag,
        write_partitions,
    )
    from repro_torch.data.vectors import (
        brute_force_knn,
        make_dataset,
        recall_at_k,
    )
    from repro_torch.storage.simulator import ObjectStore, StorageConfig
    with phase(f"compare: make_dataset n={n}"):
        ds = make_dataset("clustered", n=n, d=D, n_queries=n_queries,
                          seed=0, device=dev)
    rows, build_s = [], {}

    def row(method, setting, ids, qps, wall):
        r = {"method": method, "setting": setting,
             "recall@10": recall_at_k(ids, ds.gt_ids, K), "qps_sim": qps,
             "build_s": build_s[method], "wall_s": wall}
        rows.append(r)
        print(f"compare row: {json.dumps(r)}", flush=True)

    def pag_store():
        store = ObjectStore(StorageConfig.preset("dfs", seed=1))
        write_partitions(pag, ds.base, store, n_shards=N_SHARDS, device=dev)
        return store

    with phase("compare: PAG build"):
        t0 = time.perf_counter()
        pag = build_pag(ds.base, **CMP_PAG_ARGS, device=dev)
        build_s["PAG"] = time.perf_counter() - t0
    first_ids = None
    for L, npb in CMP_PAG_SWEEP:
        with phase(f"compare: PAG L{L}/p{npb}"):
            store = pag_store()
            t0 = time.perf_counter()
            ids, _, st = search_pag(
                pag, D, ds.queries, store,
                SearchConfig(L=L, k=K, n_probe_max=npb, mode="async"),
                n_shards=N_SHARDS, device=dev)
            row("PAG", f"L{L}/p{npb}", ids, st.batch_qps(),
                time.perf_counter() - t0)
            first_ids = ids if first_ids is None else first_ids
    with phase("compare: PAG checkpoint round trip"):
        with tempfile.TemporaryDirectory(prefix="pag_ckpt_") as tmp:
            save_index(tmp, pag)
            loaded = load_index(tmp)
        L, npb = CMP_PAG_SWEEP[0]
        ids, _, _ = search_pag(
            loaded, D, ds.queries, pag_store(),
            SearchConfig(L=L, k=K, n_probe_max=npb, mode="async"),
            n_shards=N_SHARDS, device=dev)
        if not np.array_equal(ids, first_ids):
            raise AssertionError("the loaded index serves other ids")

    with phase("compare: DiskANN build"):
        dk_store = ObjectStore(StorageConfig.preset("dfs"))
        t0 = time.perf_counter()
        dk = build_diskann(ds.base, dk_store, R=16, L=48, M=8, device=dev)
        build_s["DiskANN"] = time.perf_counter() - t0
    for L in CMP_DK_SWEEP:
        with phase(f"compare: DiskANN L{L}"):
            t0 = time.perf_counter()
            ids, _, lats = search_diskann(dk, ds.queries, dk_store, k=K, L=L)
            row("DiskANN", f"L{L}", ids, 1.0 / np.mean(lats),
                time.perf_counter() - t0)
    del dk, dk_store

    with phase("compare: SPANN build"):
        sp_store = ObjectStore(StorageConfig.preset("dfs"))
        t0 = time.perf_counter()
        sp = build_spann(ds.base, sp_store, points_per_part=16, device=dev)
        build_s["SPANN"] = time.perf_counter() - t0
        print(f"SPANN build stats {json.dumps(sp.build_stats)}")
    for L, npb in CMP_SP_SWEEP:
        with phase(f"compare: SPANN L{L}/p{npb}"):
            t0 = time.perf_counter()
            ids, _, lats = search_spann(sp, ds.queries, sp_store, k=K, L=L,
                                        n_probe_max=npb)
            row("SPANN", f"L{L}/p{npb}", ids, 1.0 / np.mean(lats),
                time.perf_counter() - t0)
    del sp, sp_store

    with phase("compare: HNSW build"):
        t0 = time.perf_counter()
        hn = build_hnsw(ds.base, R=16, L=48, device=dev)
        build_s["HNSW"] = time.perf_counter() - t0
    for L in CMP_HN_SWEEP:
        with phase(f"compare: HNSW L{L} (mem)"):
            t0 = time.perf_counter()
            ids, _, lats = search_hnsw(hn, ds.queries, k=K, L=L)
            row("HNSW", f"L{L}", ids, 1.0 / np.mean(lats),
                time.perf_counter() - t0)
    del hn

    with phase(f"compare: CIC build c=4 n={cic_n}"):
        stats = {}
        x = ds.base[:cic_n]
        pg = cic_build(x, c=4, stats=stats, device=dev)
        gt, _ = brute_force_knn(x, ds.queries, K, device=dev)
        A, nbrs, n_nodes, entry = pg.device_arrays(dev)
        res = greedy_search(A, nbrs, n_nodes, entry,
                            torch.from_numpy(ds.queries).to(dev), L=CIC_L,
                            K=K)
        build_s["CIC"] = stats["total_s"]
        cic = {"method": "CIC", "setting": f"c4/n{cic_n}/L{CIC_L}",
               "recall@10": recall_at_k(res.ids.cpu().numpy(), gt, K),
               "sequential_s": stats["total_s"],
               "parallel_equivalent_s": stats["parallel_total_s"],
               "stats": stats}
        rows.append(cic)
        print(f"compare row: {json.dumps(cic)}", flush=True)

    def ratio(at):
        """PAG over DiskANN: each one's best QPS at recall >= ``at``."""
        best = [max((r["qps_sim"] for r in rows if r["method"] == m
                     and r["recall@10"] >= at), default=None)
                for m in ("PAG", "DiskANN")]
        return {"at_recall": at, "pag_qps": best[0], "diskann_qps": best[1],
                "pag_over_diskann": best[0] / best[1] if all(best)
                else None}
    # ... and at the highest recall both reach (iso-recall)
    iso = min(max(r["recall@10"] for r in rows if r["method"] == m)
              for m in ("PAG", "DiskANN"))
    print(json.dumps({
        "qps_ratio": ratio(RATIO_RECALL), "qps_ratio_iso": ratio(iso),
        # Table IV's claim (build_time.py), reported, not asserted
        "pag_builds_faster_than_diskann": build_s["PAG"] < build_s["DiskANN"],
        "build_s": build_s}), flush=True)
    low = [(r["method"], r["setting"], r["recall@10"]) for r in rows
           if r["recall@10"] < CMP_FLOORS[(r["method"], r["setting"])]]
    if low:
        raise AssertionError(f"compare recall below its floor: {low}")
    return rows


def kernel_report(name, fn, plain, library, args, launches, nbytes, n_ops,
                  source, replaces, check, shape) -> dict:
    """Times one kernel on captured path inputs beside its plain version,
    a library formulation and its bound; ``check(got, want)`` holds the
    kernel to the plain version and returns the max abs error."""
    err = check(fn(*args), plain(*args))
    ms = cuda_time_ms(lambda: fn(*args), reps=20)
    plain_ms = cuda_time_ms(lambda: plain(*args), reps=5)
    library_ms = cuda_time_ms(library, reps=10)
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": n_ops / FP32_OPS_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[bound_by],
            "bound_by": bound_by, "library_ms": library_ms, "shape": shape}


def time_kernels(caps, counts) -> list:
    """One row per kernel at the shapes its path gave it. ``caps`` and
    ``counts`` map each kernel to its captured inputs and to the launch
    counts of the path they came from."""
    from repro_torch.core.distances import cdist2
    from repro_torch.kernels import l2_topk, pq_adc
    rows = []

    def masked_check(atol):
        return lambda got, want: compare("main path", got, want,
                                         exact=False, atol=atol)

    (q, pools, ids), kw = caps["l2_topk_masked"].args
    k = kw["k"]
    real = int((ids >= 0).sum())
    qn, c, d = pools.shape

    def l2_masked_library():
        xn = torch.einsum("qcd,qcd->qc", pools, pools)
        d2 = torch.baddbmm((xn + (q * q).sum(-1)[:, None])[:, :, None],
                           pools, q[:, :, None], alpha=-2.0)[:, :, 0]
        d2 = d2.clamp_min_(0.0).masked_fill_(ids < 0, INF)
        return torch.topk(d2, k, dim=1, largest=False)

    rows.append(kernel_report(
        "l2_topk_masked", lambda *a: l2_topk.l2_topk_masked(*a, k=k),
        lambda *a: l2_topk.l2_topk_masked_plain(*a, k=k), l2_masked_library,
        (q, pools, ids), counts["l2_topk_masked"]["l2_topk_masked"],
        nbytes=qn * d * 4 + qn * c * 4 + real * d * 4 + qn * k * 8,
        n_ops=real * d * 4,
        source="src/repro_torch/kernels/csrc/l2_topk_masked.cu",
        replaces="src/repro/kernels/l2_topk.py:138",
        check=masked_check(norm_atol(q, pools.reshape(-1, d))),
        shape={"Q": qn, "C": c, "real_rows": real, "d": d, "k": k}))

    (luts, codes, pos), kw = caps["pq_adc_masked"].args
    k = kw["k"]
    real = int((pos >= 0).sum())
    qn, c, m = codes.shape

    def adc_masked_library():
        d2 = torch.gather(luts, 2, codes.long().transpose(1, 2)).sum(1)
        return torch.topk(d2.masked_fill_(pos < 0, INF), k, dim=1,
                          largest=False)

    rows.append(kernel_report(
        "pq_adc_masked", lambda *a: pq_adc.pq_adc_masked(*a, k=k),
        lambda *a: pq_adc.pq_adc_masked_plain(*a, k=k), adc_masked_library,
        (luts, codes, pos), counts["pq_adc_masked"]["pq_adc_masked"],
        nbytes=qn * m * 256 * 4 + qn * c * 4 + real * m + qn * k * 8,
        n_ops=real * m,
        source="src/repro_torch/kernels/csrc/pq_adc_masked.cu",
        replaces="src/repro/kernels/pq_adc.py:100",
        check=masked_check(1e-4),
        shape={"Q": qn, "C": c, "real_rows": real, "M": m, "k": k}))

    (q, x, k), _ = caps["l2_topk"].args
    (qn, d), n = q.shape, x.shape[0]
    rows.append(kernel_report(
        "l2_topk", l2_topk.l2_topk, l2_topk.l2_topk_plain,
        lambda: torch.topk(cdist2(q, x), k, dim=1, largest=False),
        (q, x, k), counts["l2_topk"]["l2_topk"],
        nbytes=(qn + n) * d * 4 + qn * k * 8,
        # q.x for every pair, both norms, the combine and clamp
        n_ops=2 * qn * n * d + 2 * (qn + n) * d + 4 * qn * n,
        source="src/repro_torch/kernels/csrc/l2_topk.cu",
        replaces="src/repro/kernels/l2_topk.py:70",
        check=lambda got, want: compare("ground-truth chunk", got, want,
                                        exact=False, atol=norm_atol(q, x)),
        shape={"Q": qn, "N": n, "d": d, "k": k}))

    (lut, codes), _ = caps["pq_adc"].args
    n, m = codes.shape

    def adc_check(got, want):
        if not torch.equal(got, want):   # same summation order
            raise AssertionError("pq_adc: the DiskANN hop disagrees")
        return 0.0

    rows.append(kernel_report(
        "pq_adc", pq_adc.pq_adc, pq_adc.pq_adc_plain,
        lambda: torch.gather(lut, 1, codes.long().T).sum(0),
        (lut, codes), counts["pq_adc"]["pq_adc"],
        nbytes=m * 256 * 4 + n * m + n * 4, n_ops=n * m,
        source="src/repro_torch/kernels/csrc/pq_adc.cu",
        replaces="src/repro/kernels/pq_adc.py:44", check=adc_check,
        shape={"N": n, "M": m}))
    for r, path in zip(rows, ("main", "main", "main", "compare")):
        r["path"] = path
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda", 0)
    with phase("device"):
        card = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
    with phase("build"):
        secs = build.build_all()
        print(f"nvcc build seconds: {json.dumps(secs)}")
    with phase("kernels vs plain (edge cases, exact ties)"):
        check_kernel_edges(dev)

    counts = {}

    @contextlib.contextmanager
    def path(name: str, kernels):
        """Counts every launch of one path (from 0) and fails if one of
        its kernels was launched no time on it."""
        ops.reset_launch_counts()
        yield
        counts[name] = ops.launch_counts()
        print(f"[launches] {name}: {json.dumps(counts[name])}", flush=True)
        missing = [k for k in kernels if counts[name][k] == 0]
        if missing:
            raise AssertionError(f"{name}: not launched: {missing}")

    serve_kernels = ("l2_topk", "l2_topk_masked", "pq_adc_masked")
    # rerank_k=32 (the search default) beside 64: the PQ gap it leaves
    # is why SEARCH_ARGS takes 64
    with path("quality", serve_kernels):
        index_and_serve("quality", QUALITY_N, QUALITY_QUERIES,
                        QUALITY_FLOOR, dev, other_rerank=(32,))

    caps = {"l2_topk_masked": Capture(ops, "l2_topk_masked",
                                      lambda a: a[0].shape[0] == MAX_BATCH),
            "pq_adc_masked": Capture(ops, "pq_adc_masked",
                                     lambda a: a[0].shape[0] == MAX_BATCH),
            # the first ground-truth chunk of make_dataset
            "l2_topk": Capture(ops, "l2_topk",
                               lambda a: a[1].shape[0] == N),
            # a DiskANN hop (the entry point's launch scores one row)
            "pq_adc": Capture(ops, "pq_adc", lambda a: a[1].shape[0] > 1)}
    with path("main", serve_kernels), caps["l2_topk_masked"], \
            caps["pq_adc_masked"], caps["l2_topk"]:
        index_and_serve("main", N, N_QUERIES, SCALE_FLOOR, dev)
    with path("compare", ("l2_topk", "l2_topk_masked", "pq_adc")), \
            caps["pq_adc"]:
        comparison(dev)

    with phase("kernel timing at path shapes"):
        by_kernel = {"l2_topk_masked": counts["main"],
                     "pq_adc_masked": counts["main"],
                     "l2_topk": counts["main"], "pq_adc": counts["compare"]}
        rows = time_kernels(caps, by_kernel)
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in counts.items()}
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
