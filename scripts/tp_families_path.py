#!/usr/bin/env python3
"""The ``tp_families`` path of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/tp_families_path.py

Builds the two attention kernels, starts the path's 4 gloo ranks
(``spawn_ranks``), takes its unsharded side (``tpf_reference``) while they
start, runs them (``tp_families``), its checks and report, then times
``flash_attention`` at a rank's hymba-1.5b windowed layer, whisper-small
encoder layer and hymba-1.5b windowed layer under the head-dim placement
(phase E; the rows ``time_kernels`` adds). Prints the card's name and
power limit and, last, ``TP FAMILIES PATH OK``; exits non-zero when a
check fails or there is no CUDA card.
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
        sys.exit("tp_families_path: no CUDA device")
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
    ranks = cs.spawn_ranks(cs.tpf_rank, cs.TP_RANKS)
    with cs.phase("tp_families: reference"):
        ref = cs.tpf_reference(dev)
    with cs.phase("tp_families: ranks"):
        run = cs.tp_families(ref, ranks)
    with cs.phase("tp_families: checks"):
        checks = cs.check_tp_families(run, ref)
    cs.report_tp_families(run, checks, card)
    with cs.phase("tp_families: kernel rows"):
        rows = cs.tpf_kernel_rows(run, dev)
    print(card)
    print(json.dumps({"kernels": rows}))
    print("TP FAMILIES PATH OK")
