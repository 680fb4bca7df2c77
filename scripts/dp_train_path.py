#!/usr/bin/env python3
"""The ``dp_train`` path of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/dp_train_path.py

Builds the two attention kernels, starts the path's 2 gloo ranks
(``spawn_ranks``), takes its one-process steps (``dp_reference``) while
they start, runs them (``dp_train``), its checks and
report, then times both kernels at the layer-0 shapes of a rank (the
rows ``time_kernels`` adds). Prints the card's name and power limit and,
last, ``DP_TRAIN PATH OK``; exits non-zero when a check fails or there is
no CUDA card.
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
        sys.exit("dp_train_path: no CUDA device")
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
    ranks = cs.spawn_ranks(cs.dp_rank, cs.DP_RANKS)
    with cs.phase("dp_train reference"):
        ref = cs.dp_reference(dev)
    with cs.phase("dp_train"):
        run = cs.dp_train(ref, ranks)
    with cs.phase("dp_train checks"):
        checks = cs.check_dp_train(run, ref)
    cs.report_dp_train(run, checks, card)
    launches = {k: sum(x[f"{t}_launches"][k] for x in run["ranks"]
                       for t in cs.DP_RANK_PHASES)
                for k in ("flash_attention", "flash_attention_bwd")}
    rows = []
    with cs.phase("dp_train kernel rows"):
        for tag in cs.DP_RANK_PHASES:
            (q, k, v), kw = run["ranks"][0][f"{tag}_call"]
            cap = types.SimpleNamespace(
                args=(tuple(t.to(dev) for t in (q, k, v)), kw))
            rows.append(cs.flash_row(cap, launches["flash_attention"],
                                     f"dp_train {tag}"))
            rows.append(cs.flash_bwd_row(cap.args,
                                         launches["flash_attention_bwd"],
                                         f"dp_train {tag}"))
    print(card)
    print(json.dumps({"kernels": rows}))
    print("DP_TRAIN PATH OK")
