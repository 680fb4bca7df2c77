"""Top-k mixture of experts with sort-based token dispatch: port of
``repro/models/moe.py``.

The layer routes each token to ``moe_top_k`` of ``n_experts`` SwiGLU
experts (``route``), sorts the T*k assignments by expert (stable, so an
expert takes its tokens in token order), gives each expert the first
``cap`` of them (GShard capacity: a token past ``cap`` gets nothing from
that expert), runs the experts as batched products over an ``[E, cap,
d]`` buffer and sums each token's weighted outputs (``dispatch_compute``);
shared experts, where the config has them, add a dense SwiGLU of every
token (``shared_experts``).

The reference's expert einsums run outside any Pallas kernel, and so do
these ``torch.bmm`` products: the layer holds no kernel of its own. Its
forward is deterministic on the card: a buffer slot holds at most one
kept assignment, so the dispatch is a gather (not a scatter-add), and
the combine gathers each token's k contributions ``[T, k, d]`` and sums
them in ascending expert order in the model dtype, the order in which
the reference's scatter-add sums them. No float atomics, so two calls on
the same input give the same bits. (The backward of those gathers is
autograd's, which accumulates with ``index_put``.)

The reference's ``moe_forward`` takes its local path (``_moe_local``)
without a mesh, as on one card; expert parallelism over a ``model`` mesh
axis (``_moe_sharded``) is pod-scale work not ported here.

Weights keep the reference's layouts, so carrying them is a copy:
``router [d, E]``, ``w_gate``/``w_up [E, d, f]``, ``w_down [E, f, d]``,
``shared_gate``/``shared_up [d, f·n_shared]``, ``shared_down [f·n_shared,
d]``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, softmax_fp32

Params = Mapping[str, torch.Tensor]


def moe_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {
        "router": (d, e),
        "w_gate": (e, d, f),
        "w_up": (e, d, f),
        "w_down": (e, f, d),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shapes.update({
            "shared_gate": (d, fs), "shared_up": (d, fs),
            "shared_down": (fs, d),
        })
    return shapes


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Assignments each expert takes from a call of ``n_tokens`` tokens."""
    return max(int(cfg.capacity_factor * n_tokens * cfg.moe_top_k
                   / cfg.n_experts), 1)


def route(xf: torch.Tensor, router: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xf [T, d] -> (gate weights [T, k] f32, summing to 1 per token,
    expert ids [T, k] int64, by descending probability). The router
    product is in the model dtype, the softmax in f32. Among equal
    probabilities the lower expert id comes first, as
    ``jax.lax.top_k`` orders them: a stable descending sort (``topk``
    promises no order)."""
    probs = softmax_fp32((xf @ router).float())
    gate_w, gate_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = gate_w[:, :top_k], gate_e[:, :top_k]
    return gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9), \
        gate_e


def _by_expert(gate_e: torch.Tensor, n_experts: int, cap: int):
    """The T*k assignments (token-major) sorted stably by expert: (order,
    expert of each sorted assignment, its position in its expert's queue,
    whether that position is under ``cap``)."""
    flat_e = gate_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.bincount(flat_e, minlength=n_experts)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=flat_e.device) \
        - offsets[e_sorted]
    return order, e_sorted, pos, pos < cap


def capacity_keep(gate_e: torch.Tensor, n_experts: int, cap: int
                  ) -> torch.Tensor:
    """[T, k] bool: whether each of a token's assignments is among the
    first ``cap`` its expert receives (in token order), i.e. not dropped."""
    order, _, _, keep = _by_expert(gate_e, n_experts, cap)
    out = torch.empty_like(keep)
    out[order] = keep
    return out.view(gate_e.shape)


def dispatch_compute(xf: torch.Tensor, gate_w: torch.Tensor,
                     gate_e: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor, *,
                     n_experts: int, top_k: int, cap: int) -> torch.Tensor:
    """Sort-based dispatch, the expert products and the weighted combine
    over tokens xf [T, d] -> [T, d] (the reference's
    ``_dispatch_compute`` with every expert local)."""
    t, d = xf.shape
    order, e_sorted, pos, keep = _by_expert(gate_e, n_experts, cap)
    slot = torch.where(keep, e_sorted * cap + pos, n_experts * cap)
    # each slot holds at most one kept assignment: the buffer gathers its
    # token (row t of the padded input is zeros, for empty slots)
    src = torch.full((n_experts * cap + 1,), t, dtype=torch.long,
                     device=xf.device)
    src[slot] = torch.where(keep, order // top_k, t)
    buf = F.pad(xf, (0, 0, 0, 1))[src[:-1]].view(n_experts, cap, d)

    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = F.silu(g.float()).to(xf.dtype) * u
    out_buf = F.pad(torch.bmm(h, w_down).view(n_experts * cap, d),
                    (0, 0, 0, 1))          # row E*cap: dropped, zeros

    # each token's k contributions in ascending expert order, summed in
    # the model dtype in that order, as the reference's scatter-add does
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    by_expert = gate_e.argsort(dim=1)
    slot_of = slot_of.view(t, top_k).gather(1, by_expert)
    w = gate_w.gather(1, by_expert).to(xf.dtype)
    contrib = out_buf[slot_of] * w[..., None]           # [T, k, d]
    out = contrib[:, 0]
    for j in range(1, top_k):
        out = out + contrib[:, j]
    return out


def shared_experts(params: Params, xf: torch.Tensor) -> torch.Tensor:
    sg = xf @ params["shared_gate"]
    su = xf @ params["shared_up"]
    sh = F.silu(sg.float()).to(xf.dtype) * su
    return sh @ params["shared_down"]


def moe_forward(params: Params, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: the reference's ``moe_forward`` on one
    device (its ``_moe_local``); the capacity follows from this call's
    B*S tokens, so a decode step (S = 1) has its own."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gate_w, gate_e = route(xf, params["router"], cfg.moe_top_k)
    out = dispatch_compute(xf, gate_w, gate_e, params["w_gate"],
                           params["w_up"], params["w_down"],
                           n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                           cap=capacity(cfg, t))
    if cfg.n_shared_experts:
        out = out + shared_experts(params, xf)
    return out.view(b, s, d)


def moe_aux_loss(params: Params, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance loss, f32 scalar: E times the sum over
    experts of (share of tokens whose top-1 it is) x (mean router
    probability). The gradient flows through the probabilities."""
    b, s, d = x.shape
    t = b * s
    probs = softmax_fp32((x.reshape(t, d) @ params["router"]).float())
    frac_tokens = torch.bincount(probs.argmax(-1),
                                 minlength=cfg.n_experts).float() / t
    return cfg.n_experts * (frac_tokens * probs.mean(0)).sum()


class MoE(nn.Module):
    """One MoE layer's weights (``moe_param_shapes``, the reference's
    layouts) and its forward."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        for name, shape in moe_param_shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=dtype, device=device),
                requires_grad=False))

    def forward(self, x: torch.Tensor, with_aux: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(moe_forward of x, its aux loss when ``with_aux`` else None)."""
        params = dict(self.named_parameters())
        aux = moe_aux_loss(params, x, self.cfg) if with_aux else None
        return moe_forward(params, x, self.cfg), aux


@torch.no_grad()
def init_moe(moe: MoE, gen: torch.Generator) -> None:
    """The reference's ``init_moe``: fan-in normal weights, the fan-in
    along d for the router, ``w_gate``, ``w_up`` and the shared gate and
    up, along f for ``w_down`` and ``shared_down`` (``in_axis=1`` for the
    ``w_*`` experts). Each expert is drawn on its own, so no f32 copy of a
    whole ``[E, d, f]`` tensor is made (Kimi-K2's would be 22.5 GB)."""
    for name, w in moe.named_parameters():
        if name.startswith("w_"):
            for e in range(w.shape[0]):
                w[e].copy_(dense_init(gen, w.shape[1:], 0, w.dtype))
        else:
            w.copy_(dense_init(gen, w.shape, 0, w.dtype))
