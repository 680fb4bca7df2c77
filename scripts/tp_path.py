#!/usr/bin/env python3
"""The ``tp`` path of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/tp_path.py

Builds the two attention kernels, starts the path's 4 gloo ranks
(``spawn_ranks``), takes its unsharded side (``tp_reference``) while they
start, runs them (``tp``), its checks and report, then times
``flash_attention`` at phase A's layer-0 shape of a rank (the row
``time_kernels`` adds). Prints the card's name and power limit and, last,
``TP PATH OK``; exits non-zero when a check fails or there is no CUDA
card.
"""
import json
import subprocess
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("tp_path: no CUDA device")
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
    ranks = cs.spawn_ranks(cs.tp_rank, cs.TP_RANKS)
    with cs.phase("tp: reference"):
        ref = cs.tp_reference(dev)
    with cs.phase("tp: ranks"):
        run = cs.tp(ref, ranks)
    with cs.phase("tp: checks"):
        checks = cs.check_tp(run, ref)
    cs.report_tp(run, checks, card)
    launches = sum(x["launches"].get("flash_attention", 0)
                   for x in run["ranks"])
    with cs.phase("tp: kernel row"):
        (q, k, v), kw = run["ranks"][0]["A_call"]
        cap = types.SimpleNamespace(
            args=(tuple(t.to(dev) for t in (q, k, v)), kw))
        rows = [cs.flash_row(cap, launches, "tp phase A layer 0 a rank")]
    print(card)
    print(json.dumps({"kernels": rows}))
    print("TP PATH OK")
