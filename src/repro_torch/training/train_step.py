"""Training step: loss, grads, microbatch accumulation, optimizer update.

Port of ``repro/training/train_step.py``. ``make_train_step`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``:
the forward and the loss, gradients by autograd (attention's through the
``flash_attention_bwd`` kernel on the card), optionally accumulated over
microbatches in ``grad_accum_dtype``, then one AdamW update written into
the model's parameters.

Under an ambient mesh (``distributed.context``, the whole batch's size
given as ``mesh_context(..., batch=B)``) each rank is called with its
block of the batch (``sharding.batch_spec``) and the step is the
reference's jitted step on the global arrays:

* microbatch i is the whole batch's rows ``[i B/n, (i+1) B/n)``, of
  which a rank takes its block (the blocks all-gathered over the data
  axes first), and the context's batch is the microbatch's size while
  it runs: MoE capacities and drops depend on which tokens share a
  forward;
* the cross-entropy's sums (``nll``, ``z``, the mask) and the MoE
  statistics are the whole (micro)batch's, summed over the data axes
  with the identity as their gradient, so each rank back-propagates its
  own tokens' part;
* each gradient is then summed over every data axis its spec does not
  shard it on (every data axis for a whole parameter; ``pod`` for an
  expert block whose ``d`` is split over ``data`` alone), never over
  ``model``; where the data axes do not divide the (micro)batch every
  rank computed the whole gradient, and the sum is divided by their
  size;
* where the model holds its weights as blocks (``models/model.py``:
  heads, ``d_ff`` and the vocabulary over ``model``, ``d`` over the data
  axes) the loss is vocab-parallel (``cross_entropy``'s ``vocab``); a
  block's gradient is the rank's own (the FSDP gathers' reduce-scatters
  have summed it over the data axes its spec splits), and a weight whole
  across ``model`` gets its whole gradient on every rank of the line
  (the blocks read their inputs through ``copy_over``);
* the update reads the specs of the blocks (``optimizer.apply_updates``).

Under no mesh nothing of this applies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import (
    gather_axis,
    max_over,
    psum,
    sum_over,
)
from repro_torch.distributed.context import (
    get_mesh,
    mesh_context,
    whole_batch,
)
from repro_torch.distributed.sharding import (
    batch_spec,
    entry_axes,
    local_block,
)
from repro_torch.launch.mesh import data_axes
from repro_torch.models.model import LM, forward
from repro_torch.models.moe import block_specs
from repro_torch.training.optimizer import OptimizerConfig, apply_updates

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]
VocabSplit = Optional[Tuple[Any, int]]
MODEL = ("model",)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # gradient accumulation steps
    aux_loss_weight: float = 0.01    # MoE load-balance loss
    z_loss_weight: float = 1e-4      # logit z-loss (stability)
    grad_accum_dtype: str = "float32"  # bf16 for memory-bound 1T models


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, z_loss_weight: float = 0.0,
                  reduce: Reduce = None, vocab: VocabSplit = None
                  ) -> torch.Tensor:
    """logits [B, S, Vpad] f32; labels [B, S] (-1 = ignore). Mean negative
    log-likelihood over the unmasked tokens, plus ``z_loss_weight`` times
    the mean squared log-partition over them. ``reduce`` maps the sums
    (a [3] tensor: nll, squared log-partition, mask) to the whole batch's
    (a rank's block of it under a mesh). ``vocab`` = (mesh, v0): the
    logits are the columns [v0, v0 + n) of the vocabulary, which ``model``
    splits (vocab-parallel: the max and the sum of exponentials over
    ``model``, the label's logit from the rank holding it; the vocabulary
    is never gathered)."""
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0).long()
    if vocab is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        mesh, v0 = vocab
        n = logits.shape[-1]
        top = max_over(mesh, MODEL, logits.amax(-1))
        sum_exp = sum_over(mesh, MODEL,
                           torch.exp(logits - top[..., None]).sum(-1))
        logz = top + torch.log(sum_exp)
        local = labels - v0
        mine = (local >= 0) & (local < n)
        held = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
        gold = sum_over(mesh, MODEL, torch.where(
            mine, held[..., 0], torch.zeros_like(held[..., 0])))
    nll = (logz - gold) * mask
    sums = torch.stack([nll.sum(), (logz.square() * mask).sum(),
                        mask.sum()])
    nll_sum, z_sum, n = sums if reduce is None else reduce(sums)
    denom = torch.clamp(n, min=1.0)
    loss = nll_sum / denom
    if z_loss_weight:
        loss = loss + z_loss_weight * z_sum / denom
    return loss


def loss_fn(model: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            tcfg: TrainConfig, reduce: Reduce = None):
    """(total, {"loss", "aux_loss"}): total = loss + aux_loss_weight *
    aux. ``reduce``: as ``cross_entropy`` takes it; the loss is
    vocab-parallel where the model's logits are a block of the
    vocabulary."""
    logits, aux = forward(model, batch, cfg, return_aux=True)
    vocab = (model.mesh, model.vocab_block()[0]) \
        if model.split("tok_embed", 0) else None
    loss = cross_entropy(logits, batch["labels"], cfg.vocab_padded,
                         tcfg.z_loss_weight, reduce, vocab)
    total = loss + tcfg.aux_loss_weight * aux
    return total, {"loss": loss, "aux_loss": aux}


def _microbatches(batch: Dict[str, torch.Tensor], n: int, mesh, whole: int):
    """The reference's split: microbatch i the whole batch's rows
    ``[i B/n, (i+1) B/n)``; under ``mesh`` this rank's ``batch_spec``
    block of each, from its block of the batch (``whole``: B)."""
    assert whole % n == 0, f"batch {whole} % microbatches {n} != 0"
    if n == 1:
        return [batch]
    if mesh is None:
        return [dict(zip(batch, mb))
                for mb in zip(*(v.chunk(n) for v in batch.values()))]
    size = whole // n
    out = [{} for _ in range(n)]
    for key, v in batch.items():
        if v.shape[0] != whole:     # a block: the whole batch first
            for a in reversed(data_axes(mesh)):
                v = gather_axis(mesh, a, v, dim=0)
        spec = batch_spec(size, mesh, extra_dims=v.dim() - 1)
        for i in range(n):
            out[i][key] = local_block(v[i * size:(i + 1) * size], spec, mesh)
    return out


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    tcfg: Optional[TrainConfig] = None):
    tcfg = tcfg or TrainConfig()

    def grads_of(model, params, mb, reduce=None):
        total, metrics = loss_fn(model, mb, cfg, tcfg, reduce)
        grads = torch.autograd.grad(total, list(params.values()))
        return dict(zip(params, grads)), total.detach(), metrics

    def train_step(model: LM, opt_state, batch):
        params = {n: p for n, p in model.named_parameters()
                  if p.requires_grad}
        mesh, dist = get_mesh()
        specs = block_specs(model)
        n = tcfg.microbatches
        b = batch["tokens"].shape[0]
        whole, dp = (b, 1) if mesh is None else whole_batch(mesh, b)
        size = whole // n
        mbs = _microbatches(batch, n, mesh, whole)
        # where the data axes divide the microbatch, the loss's sums are
        # the whole microbatch's; else every rank holds all of it
        shared = dp > 1 and size % dp == 0
        reduce = (lambda t: sum_over(mesh, data_axes(mesh), t)) \
            if shared else None

        def run(mb):
            if mesh is None:
                return grads_of(model, params, mb)
            with mesh_context(mesh, dist, batch=size):
                return grads_of(model, params, mb, reduce)
        if n > 1:
            acc_dt = getattr(torch, tcfg.grad_accum_dtype)
            g_sum = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for k, p in params.items()}
            total = torch.zeros((), dtype=torch.float32,
                                device=model.device)
            for mb in mbs:
                g, t, _ = run(mb)
                for k in g_sum:
                    g_sum[k] += g[k].to(acc_dt)
                total = total + t
                del g
            grads = {k: g / n for k, g in g_sum.items()}
            total = total / n
            metrics = {"loss": total, "aux_loss": torch.zeros(())}
        else:
            grads, total, metrics = run(mbs[0])
            metrics = {k: v.detach() for k, v in metrics.items()}
        if dp > 1:
            for k, g in grads.items():
                held = {a for e in specs.get(k, ()) for a in entry_axes(e)}
                g = psum(mesh, [a for a in data_axes(mesh)
                                if a not in held], g)
                grads[k] = g if shared else g / dp
        on_mesh = {} if mesh is None else {"mesh": mesh, "specs": specs}
        _, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                                  ocfg, **on_mesh)
        metrics.update(opt_metrics)
        metrics["total_loss"] = total
        return model, opt_state, metrics

    return train_step
