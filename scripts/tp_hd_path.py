#!/usr/bin/env python3
"""The ``tp_hd`` path of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/tp_hd_path.py

Builds the two attention kernels, starts the path's 8 gloo ranks
(``spawn_ranks``), takes its unsharded side (``tp_reference``, tp's)
while they start, runs them (``tp_hd``: M1 and M2, case M of the
head-dim placement on (data 1, model 8)), its checks and report, then
times ``flash_attention`` at M1's layer-0 shape of a rank and
``flash_attention_bwd`` at M2's (the rows the smoke adds). Prints the
card's name and power limit and, last, ``TP HD PATH OK``; exits non-zero
when a check fails or there is no CUDA card.
"""
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("tp_hd_path: no CUDA device")
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import build
    with cs.phase("build"):
        print(build.build_all(("flash_attention", "flash_attention_bwd")),
              flush=True)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda", 0)
    ranks = cs.spawn_ranks(cs.tphd_rank, cs.TP_HD_RANKS)
    with cs.phase("tp_hd: reference (tp's unsharded side)"):
        ref = cs.tp_reference(dev)
    with cs.phase("tp_hd: ranks"):
        run = cs.tp_hd(ref, ranks)
    for tag in ("M1", "M2"):
        print(f"[phase] tp_hd {tag}: {run['ranks'][0][f'{tag}_s']:.3f} s",
              flush=True)
    with cs.phase("tp_hd: checks"):
        checks = cs.check_tp_hd(run, ref)
    cs.report_tp_hd(run, checks, card)
    with cs.phase("tp_hd: kernel rows"):
        rows = cs.tphd_kernel_rows(run, dev)
    print(card)
    print(json.dumps({"kernels": rows}))
    print("TP HD PATH OK")
