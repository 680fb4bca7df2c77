#!/usr/bin/env python3
"""The smoke run's train paths at several learning rates, on one NVIDIA GPU.

    python3 scripts/train_lr_sweep.py [--arch tinyllama-1.1b] [--lr 3e-5 1e-4]

For each learning rate, the smoke run's training of ``--arch`` at full
width with seeded weights, ``chip_smoke.TRAIN_STEPS`` AdamW steps of
``launch/train.py``'s step on one repeated batch: TinyLlama-1.1B through
``chip_smoke.train``, mamba2-370m and hymba-1.5b through
``chip_smoke.long_train`` (B=8 x S=2048), whisper-small and
internvl2-76b through ``chip_smoke.modal_train`` (the audio_train and
vlm_train paths' batches, internvl2 cut to
``chip_smoke.VLM_TRAIN_DEPTH`` layers), each with
``chip_smoke.check_train`` (the loss must fall at every step). Prints
the loss at each step, the gradient norms, step 0's loss through the
plain attention, the peak memory, and whether the checks pass. This is
how ``chip_smoke.TRAIN_LR``, ``chip_smoke.LONG_TRAIN_LR`` and
``chip_smoke.MODAL_TRAIN_LR`` were chosen: the largest learning rate
whose checks pass. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
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
    modal = {cs.AUDIO_ARCH: "audio_train", cs.VLM_ARCH: "vlm_train"}
    long = args.arch in cs.LONG_TRAIN_ARCHS
    if not long and args.arch not in modal and args.arch != cs.TRAIN_ARCH:
        ap.error(f"--arch: one of {(cs.TRAIN_ARCH,) + cs.LONG_TRAIN_ARCHS}"
                 f" or {tuple(modal)}")
    for lr in args.lr:
        if args.arch in modal:
            cs.MODAL_TRAIN_LR[args.arch] = lr
            caps = cs.modal_train_captures(modal[args.arch])
        elif long:
            cs.LONG_TRAIN_LR[args.arch] = lr
            caps = {"layer 1": cs.Capture(
                ops, "flash_attention", lambda a, kw: a[0].requires_grad
                and kw.get("window", 0) > 0)}
        else:
            cs.TRAIN_LR = lr
            caps = {"layer 0": cs.Capture(
                ops, "flash_attention", lambda a, kw: a[0].requires_grad)}
        ops.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            for cap in caps.values():
                stack.enter_context(cap)
            r = cs.modal_train(dev, modal[args.arch]) \
                if args.arch in modal else \
                cs.long_train(dev, args.arch) if long else cs.train(dev)
        counts = ops.launch_counts()
        print(f"{args.arch} lr {lr}: losses {json.dumps(r['losses'])} grad "
              f"norms {json.dumps(r['gnorms'])} plain step 0 "
              f"{r['plain_loss']} peak {r['peak_bytes'] / 2 ** 30:.2f} GiB",
              flush=True)
        try:
            cs.report_train(r, cs.check_train(r, caps, every_step=True),
                            counts)
        except AssertionError as e:
            failed += 1
            print(f"lr {lr}: check failed: {e}", flush=True)
        del r, caps
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0 if failed < len(args.lr) else 1


if __name__ == "__main__":
    sys.exit(main())
