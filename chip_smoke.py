#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of DSANN on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card
(edge cases and exact-tie inputs), then drives the port's main path:
``make_dataset`` -> ``build_pag`` -> ``write_partitions`` (PQ payloads,
"dfs" storage preset, 4 shards) -> every query through ``AnnsFrontend``
over ``ShardedServing``, once on the float plane and once on the PQ
plane. It does so twice: at 30,000 x 128 with 512 queries, where the
recall floor of the algorithm's working regime must hold, and at SIFT1M
shape (1,000,000 x 128 float32, made from a seed) with 2048 queries, the
run whose kernel launches are counted. Last, each kernel is timed with
CUDA events on the inputs the 1M run gave it, beside its plain version,
one PyTorch library formulation of the same function and its memory
bound.

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


def check_kernel_edges(dev) -> None:
    """Kernel vs plain version on edge shapes and exact-tie inputs."""
    from repro_torch.kernels import l2_topk, ops, pq_adc
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
    """Keeps the inputs of the first full-batch launch of a kernel entry
    point in ``repro_torch.kernels.ops`` (for timing at the main path's
    shapes); the call itself goes on to the real wrapper unchanged."""

    def __init__(self, ops, name: str):
        self.ops, self.name = ops, name
        self.orig = getattr(ops, name)
        self.args = None

    def __enter__(self):
        def wrapped(*args, **kw):
            if self.args is None and args[0].shape[0] == MAX_BATCH:
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
                    on_serve=contextlib.nullcontext, other_rerank=()):
    """make_dataset -> build_pag -> write_partitions -> both planes
    through the frontend, each step a phase; checks results and floors.
    ``on_serve`` wraps the serving of both planes; ``other_rerank`` lists
    rerank_k values whose PQ-plane recall is reported beside (no floor).
    Returns the reports."""
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
    with phase(f"{tag}: serve float and pq planes"), on_serve():
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


def kernel_report(name, fn, plain, library, args, kw, launches,
                  nbytes, n_ops, source, replaces, atol) -> dict:
    """Times one kernel on captured main-path inputs beside its plain
    version, a library formulation and its bound."""
    err = compare(f"{name} main path", fn(*args, **kw), plain(*args, **kw),
                  exact=False, atol=atol)
    ms = cuda_time_ms(lambda: fn(*args, **kw), reps=20)
    plain_ms = cuda_time_ms(lambda: plain(*args, **kw), reps=5)
    library_ms = cuda_time_ms(library, reps=10)
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": n_ops / FP32_OPS_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[bound_by],
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": {"Q": int(args[1].shape[0]), "C": int(args[1].shape[1]),
                      "real_rows": int((args[2] >= 0).sum()),
                      "k": int(args[3] if len(args) > 3 else kw["k"])}}


def time_kernels(caps, counts) -> list:
    from repro_torch.kernels import l2_topk, pq_adc
    (q, pools, ids), kw = caps["l2_topk_masked"].args
    k = kw["k"]
    real = int((ids >= 0).sum())
    qn, c, d = pools.shape

    def l2_library():
        xn = torch.einsum("qcd,qcd->qc", pools, pools)
        d2 = torch.baddbmm((xn + (q * q).sum(-1)[:, None])[:, :, None],
                           pools, q[:, :, None], alpha=-2.0)[:, :, 0]
        d2 = d2.clamp_min_(0.0).masked_fill_(ids < 0, INF)
        return torch.topk(d2, k, dim=1, largest=False)

    rows = [kernel_report(
        "l2_topk_masked", l2_topk.l2_topk_masked,
        l2_topk.l2_topk_masked_plain, l2_library, (q, pools, ids), kw,
        counts["l2_topk_masked"],
        nbytes=qn * d * 4 + qn * c * 4 + real * d * 4 + qn * k * 8,
        n_ops=real * d * 4,
        source="src/repro_torch/kernels/csrc/l2_topk_masked.cu",
        replaces="src/repro/kernels/l2_topk.py:138",
        # the expanded form |q|^2 - 2 q.x + |x|^2 loses float32 digits
        # against the norms, not against the (small) distance itself
        atol=1e-5 * float((q * q).sum(-1).max()
                          + (pools * pools).sum(-1).max()))]

    (luts, codes, pos), kw = caps["pq_adc_masked"].args
    k = kw["k"]
    real = int((pos >= 0).sum())
    qn, c, m = codes.shape

    def adc_library():
        d2 = torch.gather(luts, 2, codes.long().transpose(1, 2)).sum(1)
        return torch.topk(d2.masked_fill_(pos < 0, INF), k, dim=1,
                          largest=False)

    rows.append(kernel_report(
        "pq_adc_masked", pq_adc.pq_adc_masked, pq_adc.pq_adc_masked_plain,
        adc_library, (luts, codes, pos), kw, counts["pq_adc_masked"],
        nbytes=qn * m * 256 * 4 + qn * c * 4 + real * m + qn * k * 8,
        n_ops=real * m,
        source="src/repro_torch/kernels/csrc/pq_adc_masked.cu",
        replaces="src/repro/kernels/pq_adc.py:100", atol=1e-4))
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

    # rerank_k=32 (the search default) beside 64: the PQ gap it leaves
    # is why SEARCH_ARGS takes 64
    index_and_serve("quality", QUALITY_N, QUALITY_QUERIES, QUALITY_FLOOR,
                    dev, other_rerank=(32,))

    caps = {name: Capture(ops, name)
            for name in ("l2_topk_masked", "pq_adc_masked")}

    @contextlib.contextmanager
    def counted_and_captured():
        ops.reset_launch_counts()
        with caps["l2_topk_masked"], caps["pq_adc_masked"]:
            yield

    index_and_serve("main", N, N_QUERIES, SCALE_FLOOR, dev,
                    on_serve=counted_and_captured)
    counts = ops.launch_counts()
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {counts}")

    with phase("kernel timing at main-path shapes"):
        rows = time_kernels(caps, counts)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
