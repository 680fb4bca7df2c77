#!/usr/bin/env python3
"""The smoke run's train path at several learning rates, on one NVIDIA GPU.

    python3 scripts/train_lr_sweep.py [--lr 3e-5 1e-4 3e-4]

For each learning rate, ``chip_smoke.train`` (TinyLlama-1.1B at full
width with seeded weights, B=8 x S=2048, ``chip_smoke.TRAIN_STEPS`` AdamW
steps of ``launch/train.py``'s step on one repeated batch) and its
checks (``chip_smoke.check_train``): the loss at each step, the gradient
norms, step 0's loss through the plain attention, the peak memory, and
whether the checks pass (the loss must fall over the run). This is how
``chip_smoke.TRAIN_LR`` was chosen. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-5, 1e-4, 3e-4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_lr_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    failed = 0
    for lr in args.lr:
        cs.TRAIN_LR = lr
        cap = cs.Capture(ops, "flash_attention",
                         lambda a: a[0].requires_grad)
        ops.reset_launch_counts()
        with cap:
            r = cs.train(dev)
        counts = ops.launch_counts()
        print(f"lr {lr}: losses {json.dumps(r['losses'])} grad norms "
              f"{json.dumps(r['gnorms'])} plain step 0 {r['plain_loss']} "
              f"peak {r['peak_bytes'] / 2 ** 30:.2f} GiB", flush=True)
        try:
            cs.report_train(r, cs.check_train(r, cap.args[0]), counts)
        except AssertionError as e:
            failed += 1
            print(f"lr {lr}: check failed: {e}", flush=True)
        del r, cap
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0 if failed < len(args.lr) else 1


if __name__ == "__main__":
    sys.exit(main())
