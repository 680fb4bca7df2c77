"""Training step: loss, grads, microbatch accumulation, optimizer update.

Port of ``repro/training/train_step.py``. ``make_train_step`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``:
the forward and the loss, gradients by autograd (attention's through the
``flash_attention_bwd`` kernel on the card), optionally accumulated over
microbatches in ``grad_accum_dtype``, then one AdamW update written into
the model's parameters. On one card the reference's sharding constraints
on the microbatch split drop out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import LM, forward
from repro_torch.training.optimizer import OptimizerConfig, apply_updates


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # gradient accumulation steps
    aux_loss_weight: float = 0.01    # MoE load-balance loss
    z_loss_weight: float = 1e-4      # logit z-loss (stability)
    grad_accum_dtype: str = "float32"  # bf16 for memory-bound 1T models


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, z_loss_weight: float = 0.0
                  ) -> torch.Tensor:
    """logits [B, S, Vpad] f32; labels [B, S] (-1 = ignore). Mean negative
    log-likelihood over the unmasked tokens, plus ``z_loss_weight`` times
    the mean squared log-partition over them."""
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    if z_loss_weight:
        loss = loss + z_loss_weight * (logz.square() * mask).sum() / denom
    return loss


def loss_fn(model: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            tcfg: TrainConfig):
    """(total, {"loss", "aux_loss"}): total = loss + aux_loss_weight *
    aux."""
    logits, aux = forward(model, batch, cfg, return_aux=True)
    loss = cross_entropy(logits, batch["labels"], cfg.vocab_padded,
                         tcfg.z_loss_weight)
    total = loss + tcfg.aux_loss_weight * aux
    return total, {"loss": loss, "aux_loss": aux}


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    tcfg: Optional[TrainConfig] = None):
    tcfg = tcfg or TrainConfig()

    def grads_of(model, params, mb):
        total, metrics = loss_fn(model, mb, cfg, tcfg)
        grads = torch.autograd.grad(total, list(params.values()))
        return dict(zip(params, grads)), total.detach(), metrics

    def train_step(model: LM, opt_state, batch):
        params = {n: p for n, p in model.named_parameters()
                  if p.requires_grad}
        n = tcfg.microbatches
        if n > 1:
            acc_dt = getattr(torch, tcfg.grad_accum_dtype)
            b = batch["tokens"].shape[0]
            assert b % n == 0, f"batch {b} % microbatches {n} != 0"
            g_sum = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for k, p in params.items()}
            total = torch.zeros((), dtype=torch.float32,
                                device=model.device)
            for mb in zip(*(v.chunk(n) for v in batch.values())):
                g, t, _ = grads_of(model, params, dict(zip(batch, mb)))
                for k in g_sum:
                    g_sum[k] += g[k].to(acc_dt)
                total = total + t
                del g
            grads = {k: g / n for k, g in g_sum.items()}
            total = total / n
            metrics = {"loss": total, "aux_loss": torch.zeros(())}
        else:
            grads, total, metrics = grads_of(model, params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        _, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                                  ocfg)
        metrics.update(opt_metrics)
        metrics["total_loss"] = total
        return model, opt_state, metrics

    return train_step
