#!/usr/bin/env python3
"""The ``ep`` path of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/ep_path.py

Builds the ``flash_attention`` kernel, serves DBRX-132B (4 of 40 layers)
unsharded as the smoke's ``moe`` path does, keeps its unsharded side
(``ep_reference``), frees it, then runs the ``ep`` path (4 gloo ranks
sharing the card) with its checks and report. Prints the card's name and
power limit and, last, ``EP PATH OK``; exits non-zero when a check fails
or there is no CUDA card.
"""
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("ep_path: no CUDA device")
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import build
    print(build.build_all(("flash_attention",)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    arch, depth = cs.MOE_ARCHS[0]
    r = cs.moe_serve(torch.device("cuda", 0), arch, depth)
    with cs.phase("ep reference"):
        ref = cs.ep_reference(r)
    cfg, published = r["cfg"], r["published_layers"]
    del r
    torch.cuda.empty_cache()
    with cs.phase("ep"):
        run = cs.ep(ref)
    with cs.phase("ep checks"):
        checks = cs.check_ep(run, ref, cfg)
    cs.report_ep(run, checks, cfg, published, card)
    print("EP PATH OK")
