#!/usr/bin/env python3
"""Profile the index builds of chip_smoke.py's paths on the card.

    python3 scripts/build_profile.py [--n 1000000] [--compare-n 50000]
        [--top 25] [--src TREE/src]

Draws the main path's dataset (``make_dataset("clustered")``, seed 0,
d 128) and builds it with ``build_pag`` at the main path's arguments,
then draws the compare path's (50,000 rows) and builds one ``build_pg``
(R 16, L 48, seed 0: HNSW's level 0 and DiskANN's graph), each under
``cProfile``. Prints each build's wall, and its functions by own time
and by cumulative time. ``--src`` profiles another tree's package.
"""
import argparse
import cProfile
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profiled(what: str, fn, top: int, card: str):
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    out = fn()
    prof.disable()
    wall = time.perf_counter() - t0
    print(f"{what}: {wall:.3f} s under cProfile ({card})", flush=True)
    for key in ("tottime", "cumulative"):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(top)
        lines = buf.getvalue().splitlines()
        start = next(i for i, x in enumerate(lines) if "ncalls" in x)
        print(f"{what}, by {key}:")
        print("\n".join(lines[start:start + top + 1]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--compare-n", type=int, default=50_000)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("build_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core.build import build_pg
    from repro_torch.core.pag import build_pag
    from repro_torch.data.vectors import make_dataset
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    build.build_all(("l2_topk",))
    ds = make_dataset("clustered", n=args.n, d=chip_smoke.D, n_queries=16,
                      k_gt=chip_smoke.K, seed=0, device=dev)
    pag = profiled(f"build_pag n={args.n}", lambda: build_pag(
        ds.base, **chip_smoke.PAG_ARGS, device=dev), args.top, card)
    print(f"build stats: {pag.build_stats}")
    del ds, pag
    ds = make_dataset("clustered", n=args.compare_n, d=chip_smoke.D,
                      n_queries=16, k_gt=chip_smoke.K, seed=0, device=dev)
    profiled(f"build_pg n={args.compare_n}", lambda: build_pg(
        ds.base, R=16, L=48, seed=0, device=dev), args.top, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
