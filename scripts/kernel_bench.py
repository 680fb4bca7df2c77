#!/usr/bin/env python3
"""Times the port's kernels on one NVIDIA GPU, at the shapes the smoke
run's paths give them.

    python3 scripts/kernel_bench.py [--src DIR] [--label NAME] [--edges]
                                    [--only masked|unmasked|adc|train|all]
                                    [--clocks]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds the kernels it times with ``nvcc``, prints ``nvcc``'s register and
spill report for them, and times each on seeded inputs, after holding it
against its plain version: ``ms`` from CUDA events around back-to-back
wrapper calls, ``device_ms`` the kernel's own time from ``torch.profiler``.

* ``--only masked``: the main path's scan kernels at its captured shapes,
  ``l2_topk_masked`` at Q=256 x C=14,973 x d=128, k=10 (f32 pools) and
  ``pq_adc_masked`` at Q=256 x C=14,941 x M=8, k=64, each query's pool
  real over a tail-padded length drawn uniformly around the captured mean
  (10,201 real rows of 14,973);
* ``--only unmasked``: ``l2_topk`` at Q=512 x N=1,000,000 x d=128, k=10 (a ground-truth chunk
  of the 1M index) and at Q=8,192 x N=6,250 x d=128, k=8 (a chunk of
  SPANN's closure assignment on the 100k comparison), and
  ``flash_attention`` at B=8, Sq=Sk=500, H=32, KVH=4, D=64, bf16, causal
  (one prefill layer of TinyLlama-1.1B on the RAG path), beside
  ``scaled_dot_product_attention`` on the same inputs.

* ``--only train``: ``flash_attention`` (with its ``lse``) and
  ``flash_attention_bwd`` at one training layer of TinyLlama-1.1B on the
  smoke run's train path (B=8, Sq=Sk=2048, H=32, KVH=4, D=64, bf16,
  causal), seeded q, k, v and dO, each beside its plain version and its
  library call (``scaled_dot_product_attention`` forward, and its
  backward), with the bound (``chip_smoke.flash_bwd_row``'s count); then
  the backward at one training layer of hymba-1.5b (B=8, Sq=Sk=2176 with
  its 128 meta tokens, H=25, KVH=5, D=64, bf16): a windowed layer
  (window 1024, the library call SDPA's backward with the boolean mask)
  and a global, causal one.

* ``--only adc``: one DiskANN wave of the 100k comparison, seeded: Q=1000
  queries with ~50 node ids each (a uniform length in [25, 75]; every
  tenth query done, with none) in a code table of 100,000 x 8 u8 on the
  card, each query with its own LUT. The pattern of one wave before the
  lock-step traversal, per query one H2D copy of its ids, the index of
  its code rows, one ``pq_adc`` launch and one ``.cpu()`` (host wall over
  the wave), against one ``pq_adc_rows`` wave (one packed H2D copy, one
  launch, one ``.cpu()``); the kernel alone (event and device ms, bound,
  the gather + sum library call); and the crossover of its two LUT
  variants over mean segment lengths 8 .. 4096.

``--only all`` (the default) times every group but ``adc`` and
``train``. ``--clocks`` adds, for
the two masked kernels, the clock64 cycles of each phase of a block
(setup, scan, threshold, survivors, rank and output), median and max
over the blocks, from the kernels rebuilt with -DREPRO_PHASE_CLOCKS
(this checkout's kernels only). ``--edges`` first runs
``chip_smoke.py``'s edge checks of the kernels it times (and the SASS
check that the bf16 flash kernel uses the tensor cores); it holds this
checkout's wrappers only. To compare two trees on one card, unpack the
other tree with ``git archive`` and run this script once per tree in one command, in
turns (A, B, B, A), each with ``--src`` naming its ``src``. One JSON line
per run, with the card's name and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
L2_SHAPES = [(512, 1_000_000, 128, 10), (8192, 6250, 128, 8)]
FLASH_SHAPE = (8, 500, 500, 32, 4, 64)   # B, Sq, Sk, H, KVH, D
TRAIN_SHAPE = (8, 2048, 2048, 32, 4, 64)
HYMBA_TRAIN_SHAPE = (8, 2176, 2176, 25, 5, 64)
HYMBA_WINDOW, HYMBA_META = 1024, 128
# the main path's first full serving batch (PERF.md): Q, C, d or M, k
L2_MASKED_SHAPE = (256, 14_973, 128, 10)
ADC_MASKED_SHAPE = (256, 14_941, 8, 64)
REAL_SHARE = 10_201 / 14_973   # mean real rows of a pool over C
ADC_WAVE = (1000, 100_000, 8)   # Q, table rows, M
ADC_CROSSOVER_ROWS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
GROUPS = {"masked": ("l2_topk_masked", "pq_adc_masked"),
          "unmasked": ("flash_attention", "l2_topk"),
          "adc": ("pq_adc",),
          "train": ("flash_attention", "flash_attention_bwd"),
          "all": ("flash_attention", "l2_topk", "l2_topk_masked",
                  "pq_adc_masked")}


def ragged_pool_ids(gen, q: int, c: int, dev) -> torch.Tensor:
    """ids [Q, C]: distinct ids, each row real over a length drawn
    uniformly in [2 m - C, C] (mean m = REAL_SHARE C), padded at its
    tail as the serving path pads its pools."""
    mean = round(REAL_SHARE * c)
    lens = torch.randint(2 * mean - c, c + 1, (q, 1), generator=gen,
                         device=dev)
    ids = torch.randperm(1 << 24, generator=gen, device=dev)[:c].int()
    ids = ids.expand(q, c).clone()
    ids[torch.arange(c, device=dev)[None, :] >= lens] = -1
    return ids


PHASES = ("setup", "scan", "threshold", "survivors", "rank_out")


def phase_split(name: str, fn, blocks: int) -> dict:
    """clock64 cycles of each phase of the masked kernel ``name``'s blocks
    over one call of ``fn()``, through the kernel rebuilt with
    -DREPRO_PHASE_CLOCKS (csrc/topk_select.cuh): median and max over the
    first ``blocks`` blocks, and the median total."""
    import ctypes
    from repro_torch.kernels import build
    path = build.BUILD_DIR / f"lib{name}-phase-clocks.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DREPRO_PHASE_CLOCKS",
                    "-o", str(path), str(build.CSRC / f"{name}.cu")],
                   check=True, capture_output=True)
    plain_lib = build.load(name)
    build._loaded[name] = lib = ctypes.CDLL(str(path))
    try:
        fn()
        torch.cuda.synchronize()
        clocks = np.zeros((1024, 6), np.int64)
        if lib.read_phase_clocks(ctypes.c_void_p(clocks.ctypes.data)) != 0:
            raise RuntimeError(f"{name}: reading the phase clocks failed")
    finally:
        build._loaded[name] = plain_lib
    spans = np.diff(clocks[:min(blocks, 1024)], axis=1)
    out = {p: {"median": int(np.median(spans[:, i])),
               "max": int(spans[:, i].max())} for i, p in enumerate(PHASES)}
    out["total_median"] = int(np.median(spans.sum(1)))
    return out


def bench_masked(cs, dev, report, clocks: bool = False) -> None:
    from repro_torch.kernels import l2_topk, pq_adc
    gen = torch.Generator(device=dev).manual_seed(0)
    qn, c, d, k = L2_MASKED_SHAPE
    q = torch.randn((qn, d), generator=gen, device=dev)
    pools = torch.randn((qn, c, d), generator=gen, device=dev)
    ids = ragged_pool_ids(gen, qn, c, dev)
    err = cs.compare("l2_topk_masked main shape",
                     l2_topk.l2_topk_masked(q, pools, ids, k),
                     l2_topk.l2_topk_masked_plain(q, pools, ids, k),
                     exact=False, atol=cs.norm_atol(q, pools.reshape(-1, d)))
    real = int((ids >= 0).sum())
    fn = lambda: l2_topk.l2_topk_masked(q, pools, ids, k)  # noqa: E731
    dev_ms = cs.device_ms(fn, 20, ("l2_topk_masked_kernel",))
    report[f"l2_topk_masked_{qn}x{c}x{d}_k{k}"] = {
        "ms": cs.cuda_time_ms(fn, reps=20), "device_ms": dev_ms,
        "max_abs_err": err, "real_rows": real,
        "real_row_gb_per_s": real * d * 4 / dev_ms / 1e6 if dev_ms else None}
    if clocks:
        report["l2_topk_masked_phase_cycles"] = phase_split(
            "l2_topk_masked", fn, qn)
    del q, pools, ids

    qn, c, m, k = ADC_MASKED_SHAPE
    luts = torch.rand((qn, m, 256), generator=gen, device=dev)
    codes = torch.randint(0, 256, (qn, c, m), generator=gen, device=dev,
                          dtype=torch.uint8)
    ids = ragged_pool_ids(gen, qn, c, dev)
    err = cs.compare("pq_adc_masked main shape",
                     pq_adc.pq_adc_masked(luts, codes, ids, k),
                     pq_adc.pq_adc_masked_plain(luts, codes, ids, k),
                     exact=False)
    fn = lambda: pq_adc.pq_adc_masked(luts, codes, ids, k)  # noqa: E731
    report[f"pq_adc_masked_{qn}x{c}x{m}_k{k}"] = {
        "ms": cs.cuda_time_ms(fn, reps=20),
        "device_ms": cs.device_ms(fn, 20, ("pq_adc_masked_kernel",)),
        "max_abs_err": err, "real_rows": int((ids >= 0).sum())}
    if clocks:
        report["pq_adc_masked_phase_cycles"] = phase_split(
            "pq_adc_masked", fn, qn)


def adc_wave(gen, q: int, n: int, m: int, mean: int, dev, done=10):
    """Seeded inputs of one DiskANN wave: luts [Q, M, 256] f32 and a code
    table [n, M] u8 on the card, node ids [T] and offsets [Q + 1] on the
    host (int32 numpy; segment lengths uniform in [mean/2, 3 mean/2],
    every ``done``-th query empty)."""
    luts = torch.rand((q, m, 256), generator=gen, device=dev)
    table = torch.randint(0, 256, (n, m), generator=gen, device=dev,
                          dtype=torch.uint8)
    rng = np.random.default_rng(mean)
    lens = rng.integers(mean // 2, mean + mean // 2 + 1, q)
    lens[::done] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ids = rng.integers(0, n, int(offsets[-1])).astype(np.int32)
    return luts, table, ids, offsets


def bench_adc(cs, dev, report) -> None:
    from repro_torch.baselines.pq import adc_distances_rows
    from repro_torch.kernels import pq_adc
    gen = torch.Generator(device=dev).manual_seed(0)
    qn, n, m = ADC_WAVE
    luts, table, ids, offsets = adc_wave(gen, qn, n, m, 50, dev)
    t_count = len(ids)
    segs = [(q, ids[offsets[q]:offsets[q + 1]].astype(np.int64))
            for q in range(qn) if offsets[q + 1] > offsets[q]]

    def per_hop():
        """The parent's pattern: per query one H2D copy, the index, one
        pq_adc launch and one .cpu()."""
        return [pq_adc.pq_adc(luts[q], table[torch.from_numpy(s).to(dev)])
                .cpu() for q, s in segs]

    def wave():
        return adc_distances_rows(luts, table, ids, offsets).cpu()

    got = wave().numpy()
    want = np.concatenate([d.numpy() for d in per_hop()])
    if not np.array_equal(got, want):
        raise AssertionError("pq_adc_rows: the wave disagrees with the "
                             "per-hop launches")

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    rows_t = torch.from_numpy(ids).to(dev)
    offsets_t = torch.from_numpy(offsets).to(dev)
    args = (luts, table, rows_t, offsets_t)
    fn = lambda: pq_adc.pq_adc_rows(*args)  # noqa: E731
    err = 0.0 if torch.equal(fn(), pq_adc.pq_adc_rows_plain(*args)) else 1.0
    if err:
        raise AssertionError("pq_adc_rows: off its plain version")
    lens = np.diff(offsets)
    seg = np.repeat(np.arange(qn), lens)
    codes = table[rows_t.long()].long().cpu().numpy()
    lut_entries = len(np.unique((seg[:, None] * m + np.arange(m)) * 256
                                + codes))
    nbytes = (2 * t_count + qn + 1) * 4 + len(np.unique(ids)) * m \
        + lut_entries * 4

    def library():
        s = torch.repeat_interleave(torch.arange(qn, device=dev),
                                    (offsets_t[1:] - offsets_t[:-1]).long(),
                                    output_size=t_count)
        flat = (s[:, None] * m + torch.arange(m, device=dev)) * 256 \
            + table[rows_t.long()].long()
        return luts.view(-1)[flat].sum(1)

    report["adc_wave"] = {
        "Q": qn, "T": t_count, "M": m, "segments": len(segs),
        "per_hop_host_ms": host_ms(per_hop, 5),
        "wave_host_ms": host_ms(wave, 50),
        "ms": cs.cuda_time_ms(fn, reps=50),
        "device_ms": cs.device_ms(fn, 20, ("pq_adc_rows_kernel",)),
        "per_hop_device_ms": cs.device_ms(
            lambda: [pq_adc.pq_adc(luts[q], table[rows_t[offsets[q]:
                                                         offsets[q + 1]]
                                                  .long()])
                     for q, _ in segs], 2, ("pq_adc_kernel",)),
        "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
        "library_ms": cs.cuda_time_ms(library, reps=20),
        "plain_ms": cs.cuda_time_ms(
            lambda: pq_adc.pq_adc_rows_plain(*args), reps=10)}
    # per_hop_device_ms: the profiler's median pq_adc_kernel launch times
    # the number of launches of one wave
    if report["adc_wave"]["per_hop_device_ms"] is not None:
        report["adc_wave"]["per_hop_device_ms"] *= len(segs)
    del luts, table
    cross = {}
    for mean in ADC_CROSSOVER_ROWS:
        luts, table, ids, offsets = adc_wave(gen, qn, n, m, mean, dev)
        args = tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                     else a for a in (luts, table, ids, offsets))
        want = pq_adc.pq_adc_rows_plain(*args)
        cross[mean] = {}
        for stage in (False, True):
            f = lambda: pq_adc.pq_adc_rows(*args, stage=stage)  # noqa: E731
            if not torch.equal(f(), want):
                raise AssertionError(f"pq_adc_rows stage={stage} mean "
                                     f"{mean}: off its plain version")
            cross[mean]["staged" if stage else "read_only"] = cs.device_ms(
                f, 20, ("pq_adc_rows_kernel",))
        print(f"adc crossover mean rows {mean}: {json.dumps(cross[mean])}",
              flush=True)
    report["adc_crossover_device_ms"] = cross


def bench_unmasked(cs, dev, report) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import l2_topk
    rng = np.random.default_rng(0)
    for qn, n, d, k in L2_SHAPES:
        q = torch.from_numpy(rng.standard_normal((qn, d), np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(dev)
        err = cs.compare(f"l2_topk {qn}x{n}", l2_topk.l2_topk(q, x, k),
                         l2_topk.l2_topk_plain(q, x, k), exact=False,
                         atol=cs.norm_atol(q, x))
        ms = cs.cuda_time_ms(lambda: l2_topk.l2_topk(q, x, k), reps=20)
        dev_ms = cs.device_ms(lambda: l2_topk.l2_topk(q, x, k), 20,
                              ("l2_topk_scan", "l2_topk_merge"))
        report[f"l2_topk_{qn}x{n}x{d}_k{k}"] = {
            "ms": ms, "device_ms": dev_ms, "max_abs_err": err,
            "tflops": 2 * qn * n * d / ms / 1e9}
        del q, x

    b, sq, sk, h, kvh, d = FLASH_SHAPE
    q = torch.from_numpy(rng.standard_normal((b, sq, h, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, sk, kvh, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, sk, kvh, d), np.float32))
    q, k, v = (t.to(dev, torch.bfloat16) for t in (q, k, v))
    err = cs.flash_check(fa.flash_attention(q, k, v),
                         fa.flash_attention_plain(q, k, v), "prefill layer")
    ms = cs.cuda_time_ms(lambda: fa.flash_attention(q, k, v), reps=50)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_ms = cs.cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=50)
    report["flash_attention_bf16_prefill"] = {
        "ms": ms, "max_abs_err": err, "sdpa_ms": sdpa_ms}


def bench_train(cs, dev, report) -> None:
    """The attention forward and backward of one training layer, seeded."""
    from repro_torch.kernels import flash_attention as fa
    b, sq, sk, h, kvh, d = TRAIN_SHAPE
    gen = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16) for shape in
               ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    err = cs.flash_check(fa.flash_attention(q, k, v),
                         fa.flash_attention_plain(q, k, v), "train layer")

    def fwd():
        return fa.flash_attention(q, k, v, return_lse=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    report["flash_attention_bf16_train_fwd"] = {
        "ms": cs.cuda_time_ms(fwd, reps=20),
        "device_ms": cs.device_ms(fwd, 20, ("flash_fwd",)),
        "max_abs_err": err,
        "sdpa_ms": cs.cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)}
    print(f"train forward: "
          f"{json.dumps(report['flash_attention_bf16_train_fwd'])}",
          flush=True)
    report["flash_attention_bwd_bf16_train"] = cs.flash_bwd_row(
        ((q, k, v), dict(causal=True)), None, "train layer")
    print(f"train backward: "
          f"{json.dumps(report['flash_attention_bwd_bf16_train'])}",
          flush=True)
    b, sq, sk, h, kvh, d = HYMBA_TRAIN_SHAPE
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16) for shape in
               ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
    for kind, window in (("windowed", HYMBA_WINDOW), ("global", 0)):
        key = f"flash_attention_bwd_bf16_hymba_{kind}"
        report[key] = cs.flash_bwd_row(
            ((q, k, v), dict(causal=True, window=window,
                             meta_tokens=HYMBA_META if window else 0)),
            None, f"hymba {kind} layer")
        print(f"hymba {kind} backward: {json.dumps(report[key])}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--edges", action="store_true")
    ap.add_argument("--only", choices=sorted(GROUPS), default="all")
    ap.add_argument("--clocks", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    names = GROUPS[args.only]
    t0 = time.perf_counter()
    secs = build.build_all(names)
    report = {"label": args.label, "src": args.src,
              "nvcc_s": secs, "build_wall_s": time.perf_counter() - t0}
    for name in names:
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():
            print(f"--- nvcc {name}\n{log.read_text()}", flush=True)
    if args.edges:
        t0 = time.perf_counter()
        if "flash_attention" in names:
            cs.check_flash_tensor_cores()
            cs.check_flash_edges(dev)
        if "l2_topk" in names:
            cs.check_unmasked_edges(dev)
        if "l2_topk_masked" in names:
            cs.check_masked_edges(dev)
        if names == GROUPS["adc"]:
            cs.check_adc_rows_edges(dev)
        if "flash_attention_bwd" in names:
            cs.check_flash_bwd_edges(dev)
        report["edges_s"] = time.perf_counter() - t0
    if "l2_topk_masked" in names:
        bench_masked(cs, dev, report, clocks=args.clocks)
    if "l2_topk" in names:
        bench_unmasked(cs, dev, report)
    if names == GROUPS["adc"]:
        bench_adc(cs, dev, report)
    if "flash_attention_bwd" in names:
        bench_train(cs, dev, report)
    report["card"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
