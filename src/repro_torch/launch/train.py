"""Training launcher: an arch of any of the seven families (dense, moe,
ssm, hybrid, audio, vlm; reduced or full config) on one device, with
checkpoint/resume. Port of ``repro/launch/train.py``. The audio family's
batches carry ``frames`` and the vlm family's ``vision_embeds``
(``batch_at``'s stubs), which the step splits into microbatches with the
tokens.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --reduced --steps 100 [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (and raises when
no card is found rather than move to the CPU). Attention runs forward and
backward through the ``flash_attention`` and ``flash_attention_bwd``
kernels on the card, through their plain versions on the CPU. The
reference's ``mesh_context`` and sharding constraints are no-ops on one
device and are not part of this port. Weights come from the port's
seeded ``init_params`` and batches from its ``batch_at`` (a
``torch.Generator`` stream: the tokens differ from the reference's).
With ``--ckpt-dir``, parameters (``<dir>/p``) and optimizer state
(``<dir>/o``) are saved every ``--ckpt-every`` steps, and a run resumes
from the latest step found there.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.lm import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.training.optimizer import OptimizerConfig, init_state
from repro_torch.training.train_step import TrainConfig, make_train_step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def setup(args: argparse.Namespace):
    """(cfg, dcfg, model, opt_state, step_fn) for ``args``: the model
    seeded and trainable on the device, the AdamW state at zero; every
    family alike, as the reference sets them up."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps)
    tcfg = TrainConfig(microbatches=args.microbatches)
    dcfg = DataConfig(seed=0, batch_size=args.batch, seq_len=args.seq)
    model = init_params(cfg, seed=0, device=dev).requires_grad_()
    opt = init_state(dict(model.named_parameters()), ocfg)
    return cfg, dcfg, model, opt, make_train_step(cfg, ocfg, tcfg)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Train; returns the last step's metrics as floats."""
    args = parser().parse_args(argv)
    cfg, dcfg, model, opt, step_fn = setup(args)
    dev = model.device
    n = sum(p.numel() for p in model.parameters())
    print(f"{cfg.arch_id}: {n/1e6:.1f}M params on {dev}")

    params = dict(model.named_parameters())
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir + "/p") is not None:
        start, saved, _ = load_checkpoint(args.ckpt_dir + "/p", like=params)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(saved[name])
        _, opt, _ = load_checkpoint(args.ckpt_dir + "/o", like=opt)
        print(f"resumed at step {start}")

    out: Dict[str, float] = {}
    t0 = time.time()
    for s in range(start, args.steps):
        _, opt, m = step_fn(model, opt, batch_at(dcfg, cfg, s, device=dev))
        if s % 10 == 0 or s == args.steps - 1:
            out = {k: float(v) for k, v in m.items()}
            print(f"step {s:4d} loss={out['loss']:.4f} "
                  f"gnorm={out['grad_norm']:.2f} "
                  f"({(s - start + 1) / max(time.time() - t0, 1e-9):.1f}"
                  " steps/s)")
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir + "/p", s + 1, params)
            save_checkpoint(args.ckpt_dir + "/o", s + 1, opt)
    return out


if __name__ == "__main__":
    main()
