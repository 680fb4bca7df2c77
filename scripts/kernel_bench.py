#!/usr/bin/env python3
"""Times the port's ``l2_topk`` and ``flash_attention`` kernels on one
NVIDIA GPU, at the shapes the smoke run's paths give them.

    python3 scripts/kernel_bench.py [--src DIR] [--label NAME] [--edges]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds its two kernels with ``nvcc``, prints ``nvcc``'s register and
spill report for them, and times each with CUDA events on seeded inputs,
after holding it against its plain version:

* ``l2_topk`` at Q=512 x N=1,000,000 x d=128, k=10 (a ground-truth chunk
  of the 1M index) and at Q=8,192 x N=6,250 x d=128, k=8 (a chunk of
  SPANN's closure assignment on the 100k comparison);
* ``flash_attention`` at B=8, Sq=Sk=500, H=32, KVH=4, D=64, bf16, causal
  (one prefill layer of TinyLlama-1.1B on the RAG path), beside
  ``scaled_dot_product_attention`` on the same inputs.

``--edges`` first runs ``chip_smoke.py``'s edge checks of the two
kernels (and the SASS check that the bf16 flash kernel uses the tensor
cores). To compare two trees on one card, unpack the other tree with
``git archive`` and run this script once per tree in one command, in
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--edges", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import l2_topk

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    secs = build.build_all(("flash_attention", "l2_topk"))
    report = {"label": args.label, "src": args.src,
              "nvcc_s": secs, "build_wall_s": time.perf_counter() - t0}
    for name in ("flash_attention", "l2_topk"):
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():
            print(f"--- nvcc {name}\n{log.read_text()}", flush=True)
    if args.edges:
        t0 = time.perf_counter()
        cs.check_flash_tensor_cores()
        cs.check_flash_edges(dev)
        cs.check_unmasked_edges(dev)
        report["edges_s"] = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    for qn, n, d, k in L2_SHAPES:
        q = torch.from_numpy(rng.standard_normal((qn, d), np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(dev)
        err = cs.compare(f"l2_topk {qn}x{n}", l2_topk.l2_topk(q, x, k),
                         l2_topk.l2_topk_plain(q, x, k), exact=False,
                         atol=cs.norm_atol(q, x))
        ms = cs.cuda_time_ms(lambda: l2_topk.l2_topk(q, x, k), reps=20)
        report[f"l2_topk_{qn}x{n}x{d}_k{k}"] = {
            "ms": ms, "max_abs_err": err,
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
    report["card"] = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
