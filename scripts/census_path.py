#!/usr/bin/env python3
"""The census path of chip_smoke.py alone, on the card.

    python3 scripts/census_path.py

Builds the two scan kernels (``l2_topk``, ``l2_topk_masked``), then runs
``chip_smoke.census``: ``launch/dryrun.py``'s whole grid in process, one
rank's share of anns-bigann-1b and anns-deep-1b at the 16x16 mesh
(serve and assign scans held to their plain versions, placed bytes
against the census) and the long_500k decode of mamba2-370m and
hymba-1.5b (placed bytes, the bf16 logits against the f32 step). Prints
the path's lines, its ``[phase]`` times and its kernel rows as one JSON
line; exits non-zero if a gate fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("census_path: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t0 = time.perf_counter()
    print(f"nvcc build seconds: "
          f"{json.dumps(build.build_all(('l2_topk', 'l2_topk_masked')))}")
    rows = []
    run = chip_smoke.census(torch.device("cuda", 0), rows)
    chip_smoke.report_census(run, card)
    print(json.dumps({"kernels": rows}))
    print(f"census path: {time.perf_counter() - t0:.3f} s ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
