#!/usr/bin/env python3
"""The ``tp_ssd`` path of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/tp_ssd_path.py

Builds the two attention kernels, starts the path's 5 gloo ranks
(``spawn_ranks``), takes its unsharded sides while they start
(``tpf_reference``, tp_families', for S2-S4; ``tpssd_reference`` for
S1), runs them (``tp_ssd``: hymba-1.5b's SSD heads split over a whole
``in_proj`` on (data 1, model 5), then mamba2-370m's conv cut across its
parts on (1, 3)), its checks and report, then times ``flash_attention``
at S1's layer shape of a rank and ``flash_attention_bwd`` at S2's (the
rows the smoke adds). Prints the card's name and power limit and, last,
``TP SSD PATH OK``; exits non-zero when a check fails or there is no
CUDA card.
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
        sys.exit("tp_ssd_path: no CUDA device")
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
    ranks = cs.spawn_ranks(cs.tpssd_rank, cs.TP_SSD_RANKS)
    with cs.phase("tp_ssd: reference (tp_families' unsharded side)"):
        tpf_ref = cs.tpf_reference(dev)
    with cs.phase("tp_ssd: reference (S1's unsharded side)"):
        ref = cs.tpssd_reference(dev)
    with cs.phase("tp_ssd: ranks"):
        run = cs.tp_ssd(ref, tpf_ref, ranks)
    for tag in ("S1", "S2", "S3", "S4"):
        print(f"[phase] tp_ssd {tag}: {run['ranks'][0][f'{tag}_s']:.3f} s",
              flush=True)
    with cs.phase("tp_ssd: checks"):
        checks = cs.check_tp_ssd(run, ref, tpf_ref)
    cs.report_tp_ssd(run, checks, card)
    with cs.phase("tp_ssd: kernel rows"):
        rows = cs.tpssd_kernel_rows(run, dev)
    print(card)
    print(json.dumps({"kernels": rows}))
    print("TP SSD PATH OK")
