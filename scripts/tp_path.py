#!/usr/bin/env python3
"""The ``tp`` path of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/tp_path.py

Builds the two attention kernels, starts the path's 4 gloo ranks
(``spawn_ranks``), takes its unsharded sides while they start (T3's,
``dp_reference``'s DBRX step, then ``tp_reference``), runs them (``tp``:
phases A, B and T3), its checks and report, then times
``flash_attention`` at phase A's layer-0 shape of a rank and both
attention kernels at T3's (the rows ``time_kernels`` adds). Prints the
card's name and power limit and, last, ``TP PATH OK``; exits non-zero
when a check fails or there is no CUDA card.
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
    with cs.phase("tp: T3's one-process side (dp_train's reference)"):
        t3_ref, t3_in = cs.t3_side(cs.dp_reference(dev))
    with cs.phase("tp: reference"):
        ref = cs.tp_reference(dev)
    with cs.phase("tp: ranks"):
        run = cs.tp(ref, ranks, t3_in)
    print(f"[phase] tp T3: {run['ranks'][0]['T3_s']:.3f} s", flush=True)
    with cs.phase("tp: checks"):
        checks = cs.check_tp(run, ref, t3_ref)
    cs.report_tp(run, checks, card)

    def on_card(call):
        (q, k, v), kw = call
        return types.SimpleNamespace(
            args=(tuple(t.to(dev) for t in (q, k, v)), kw))

    x0 = run["ranks"][0]
    a_launches = sum(x["launches"].get("flash_attention", 0)
                     for x in run["ranks"])
    t3 = {k: sum(x["T3"]["launches"].get(k, 0) for x in run["ranks"])
          for k in ("flash_attention", "flash_attention_bwd")}
    what = "tp T3 dbrx-132b layer 0 a rank"
    with cs.phase("tp: kernel rows"):
        cap = on_card(x0["T3"]["call"])
        rows = [cs.flash_row(on_card(x0["A_call"]), a_launches,
                             "tp phase A layer 0 a rank"),
                cs.flash_row(cap, t3["flash_attention"], what),
                cs.flash_bwd_row(cap.args, t3["flash_attention_bwd"], what)]
    print(card)
    print(json.dumps({"kernels": rows}))
    print("TP PATH OK")
