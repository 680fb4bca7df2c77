#!/usr/bin/env python3
"""What stays allocated on the card after the tp path's T3 step.

    python3 scripts/t3_memory.py

Starts ``chip_smoke.py``'s 4 gloo ranks on one card, sets up its phase T3
(DBRX-132B, 1 of 40 layers, ``launch/train.py``'s setup on (data 2, model
2)) and takes one step with the CUDA caching allocator's history on
(``torch.cuda.memory._record_memory_history``). Then each rank lists the
allocator's live blocks that are neither a parameter nor optimizer
state, largest first, each with the innermost frames of the Python stack
that allocated it. Prints the card's name and power limit and
``T3 MEMORY OK`` last.
"""
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def rank_main(rank: int, tmp: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.data.lm import batch_at
    from repro_torch.distributed import compat

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    compat.init_ranks("gloo", f"file://{tmp}/rendezvous", rank, cs.TP_RANKS)
    try:
        cfg, dcfg, model, opt, step_fn = cs.dp_setup("T3", dev, ranks=True)
        batch = batch_at(dcfg, cfg, 0, device=dev)
        torch.cuda.memory._record_memory_history(max_entries=200_000)
        _, opt, m = step_fn(model, opt, batch)
        torch.cuda.synchronize()
        known = {t.data_ptr() for t in list(model.parameters())
                 + cs.opt_tensors(opt)}
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        live = []
        for seg in snap["segments"]:
            for blk in seg["blocks"]:
                if blk["state"] == "active_allocated" \
                        and blk["address"] not in known:
                    frames = [f"{f['filename'].split('/')[-1]}:{f['line']} "
                              f"{f['name']}" for f in blk.get("frames", [])
                              if f["filename"].endswith(".py")][:6]
                    live.append((blk["size"], frames))
        live.sort(key=lambda x: -x[0])
        print(f"rank {rank}: allocated {torch.cuda.memory_allocated()} "
              f"bytes after the step, {sum(s for s, _ in live)} of them "
              f"outside the parameters and optimizer state in "
              f"{len(live)} blocks", flush=True)
        for size, frames in live[:8]:
            print(f"rank {rank}:   {size} bytes from {frames}", flush=True)
    finally:
        compat.shutdown()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("t3_memory: no CUDA device")
    import torch.multiprocessing as mp
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.build_all(("flash_attention", "flash_attention_bwd"))
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(tmp,), nprocs=4,
                           start_method="spawn")
    print(card)
    print("T3 MEMORY OK")
