"""Training launcher: an arch of any of the seven families (dense, moe,
ssm, hybrid, audio, vlm; reduced or full config), on one device or on
the ranks of a ``torch.distributed`` process group, with
checkpoint/resume. Port of ``repro/launch/train.py``. The audio family's
batches carry ``frames`` and the vlm family's ``vision_embeds``
(``batch_at``'s stubs), which the step splits into microbatches with the
tokens.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --reduced --steps 100 [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch dbrx-132b --device cpu [--model-axis 2]

Runs on the CUDA card unless ``--device cpu`` is given (and raises when
no card is found rather than move to the CPU). Attention runs forward and
backward through the ``flash_attention`` and ``flash_attention_bwd``
kernels on the card, through their plain versions on the CPU. Weights
come from the port's seeded ``init_params`` and batches from its
``batch_at`` (a ``torch.Generator`` stream: the tokens differ from the
reference's).

When a process group is up (``distributed.compat.init_ranks``, or
torchrun's ``env://`` variables, which ``main`` joins: gloo on the CPU,
nccl with one card a rank), ``setup`` does what the reference's ``main``
does with ``make_local_mesh()`` and ``mesh_context``: it lays the ranks
out as a (data, model) mesh (``--model-axis`` ranks a model line), builds
the model under it (the rank holds its blocks of the weights by the
reference's specs, the SSD's concatenated leaves per part or
contiguous, and of an
expert-parallel MoE layer's experts) and returns a step that takes
``batch_at``'s whole batch, keeps this rank's ``batch_spec`` block and
runs the train step under ``mesh_context(mesh, batch=B)``
(``training/train_step.py``). With ``--shard-hd-fallback`` the mesh
places attention by ``DistConfig(shard_head_dim_fallback=True)``: the
head dim split over ``model`` where the heads do not divide it
(``models/model.py:Attention``). Only rank 0 prints.

With ``--ckpt-dir``, parameters (``<dir>/p``) and optimizer state
(``<dir>/o``) are saved every ``--ckpt-every`` steps, and a run resumes
from the latest step found there. On a mesh the blocks are gathered
whole (``sharding.whole_tensor``; every rank takes part; a per-part
leaf joined part by part) and rank 0 writes them, in the layout of a
run on one device; at resume every
rank reads the whole tensors and keeps its blocks, so a checkpoint
moves between meshes and to one device.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.lm import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.distributed import compat
from repro_torch.distributed.context import mesh_context
from repro_torch.distributed.sharding import (
    DistConfig,
    batch_spec,
    local_block,
    stat_spec,
    whole_tensor,
)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_params
from repro_torch.models.moe import block_specs
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
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks a model line of the mesh, under a process "
                         "group")
    ap.add_argument("--shard-hd-fallback", action="store_true",
                    help="split the head dim over the model axis where "
                         "the heads do not divide it (DistConfig's "
                         "shard_head_dim_fallback)")
    return ap


def setup(args: argparse.Namespace, cfg: Optional[ModelConfig] = None,
          factored: bool = False):
    """(cfg, dcfg, model, opt_state, step_fn) for ``args``: the model
    seeded and trainable on the device, the AdamW state at zero; every
    family alike, as the reference sets them up. ``cfg`` replaces
    ``args.arch``'s config (a cut of it); ``factored`` factors the
    optimizer's second moment. Under a process group, the mesh's (see the
    module docstring): ``step_fn(model, opt_state, batch)`` takes the
    whole batch."""
    dev = resolve_device(args.device)
    cfg = cfg or get_config(args.arch, reduced=args.reduced)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps, factored=factored)
    tcfg = TrainConfig(microbatches=args.microbatches)
    dcfg = DataConfig(seed=0, batch_size=args.batch, seq_len=args.seq)
    mesh = make_local_mesh(args.model_axis) if dist.is_initialized() \
        else None
    dist_cfg = DistConfig(shard_head_dim_fallback=args.shard_hd_fallback)
    on_mesh = mesh_context(mesh, dist_cfg, batch=args.batch) if mesh \
        else contextlib.nullcontext()
    with on_mesh:
        model = init_params(cfg, seed=0, device=dev).requires_grad_()
    specs = block_specs(model)
    opt = init_state(dict(model.named_parameters()), ocfg, mesh, specs)
    step = make_train_step(cfg, ocfg, tcfg)
    if mesh is None:
        return cfg, dcfg, model, opt, step
    spec = batch_spec(args.batch, mesh, dist_cfg)

    def step_on_mesh(model, opt_state, batch):
        block = {k: local_block(v, spec + (None,) * (v.dim() - 2), mesh)
                 for k, v in batch.items()}
        with mesh_context(mesh, dist_cfg, batch=args.batch):
            return step(model, opt_state, block)
    return cfg, dcfg, model, opt, step_on_mesh


def join_env_ranks(device: Optional[str]) -> Optional[str]:
    """Join the process group torchrun's ``env://`` variables describe, if
    they are set and no group is up: gloo on the CPU, nccl with this
    rank's own card (``LOCAL_RANK``). Returns the device this rank trains
    on."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if resolve_device(device).type == "cpu":
        compat.init_ranks("gloo", "env://", rank, world)
        return device
    card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    compat.init_ranks("nccl", "env://", rank, world, device=card)
    return str(card)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Train; returns the last step's metrics as floats."""
    args = parser().parse_args(argv)
    joined = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    args.device = join_env_ranks(args.device)
    try:
        return train(args)
    finally:
        if joined:
            compat.shutdown()


def train(args: argparse.Namespace) -> Dict[str, float]:
    cfg, dcfg, model, opt, step_fn = setup(args)
    dev = model.device
    lead = not dist.is_initialized() or dist.get_rank() == 0
    mesh, specs = model.mesh, block_specs(model)
    n = sum(p.numel() for p in model.parameters())
    if lead:
        where = f"a rank of {dist.get_world_size()}" \
            if dist.is_initialized() else "on"
        print(f"{cfg.arch_id}: {n/1e6:.1f}M params {where} {dev}")

    params = dict(model.named_parameters())
    start = 0
    cut = _cut(specs, mesh) if specs else None
    if args.ckpt_dir and latest_step(args.ckpt_dir + "/p") is not None:
        start, saved, _ = load_checkpoint(args.ckpt_dir + "/p", like=params,
                                          cut=cut)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(saved[name])
        _, opt, _ = load_checkpoint(args.ckpt_dir + "/o", like=opt, cut=cut)
        if lead:
            print(f"resumed at step {start}")

    out: Dict[str, float] = {}
    t0 = time.time()
    for s in range(start, args.steps):
        _, opt, m = step_fn(model, opt, batch_at(dcfg, cfg, s, device=dev))
        if s % 10 == 0 or s == args.steps - 1:
            out = {k: float(v) for k, v in m.items()}
            if lead:
                print(f"step {s:4d} loss={out['loss']:.4f} "
                      f"gnorm={out['grad_norm']:.2f} "
                      f"({(s - start + 1) / max(time.time() - t0, 1e-9):.1f}"
                      " steps/s)")
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            p_out, o_out = (params, opt) if not specs else \
                whole_state(params, opt, specs, mesh)
            if lead:
                save_checkpoint(args.ckpt_dir + "/p", s + 1, p_out)
                save_checkpoint(args.ckpt_dir + "/o", s + 1, o_out)
            if dist.is_initialized():
                dist.barrier()
    return out


def _spec_of(key: str, specs):
    """The spec of a checkpoint key: a parameter (``<name>``), a moment
    (``m/<name>``, ``v/<name>``) or a factored statistic
    (``v/<name>/row``, ``.../col``); None where it is whole."""
    parts = key.split("/")
    if parts[0] in ("m", "v") and len(parts) > 1:
        spec = specs.get(parts[1])
        if spec is not None and len(parts) == 3:
            return stat_spec(spec, parts[2])
        return spec
    return specs.get(key)


def _cut(specs, mesh):
    def cut(key, t):
        spec = _spec_of(key, specs)
        return t if spec is None else local_block(t, spec, mesh)
    return cut


def whole_state(params, opt, specs, mesh):
    """(parameters, optimizer state) with every block gathered whole, a
    per-part leaf (``sharding.PartSpec``) and its moments joined part by
    part (a collective: every rank of the mesh calls it)."""
    def whole(key, t):
        spec = _spec_of(key, specs)
        return t if spec is None else whole_tensor(t, spec, mesh)
    p_out = {n: whole(n, p.detach()) for n, p in params.items()}
    o_out = {"step": opt["step"], "m": {}, "v": {}}
    for n, t in opt["m"].items():
        o_out["m"][n] = whole(f"m/{n}", t)
    for n, t in opt["v"].items():
        o_out["v"][n] = {k: whole(f"v/{n}/{k}", u) for k, u in t.items()} \
            if isinstance(t, dict) else whole(f"v/{n}", t)
    return p_out, o_out


if __name__ == "__main__":
    main()
