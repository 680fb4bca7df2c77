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

Two paths, as in the reference's ``moe_forward``. Without a mesh (one
card) every expert is local (``_moe_local``). Under an ambient mesh
(``distributed.context``) whose ``model`` axis divides ``n_experts``,
``moe_sharded`` (the reference's ``_moe_sharded``, expert parallelism
over ``torch.distributed`` ranks): each rank holds its data block of the
tokens, whole across the ``model`` axis (the whole batch's size, which
sets the capacity, from the context), and ``E/mp`` experts, their
``d`` dim FSDP-sharded over the data axes (``sharding.param_specs``'
rules: ``w_gate [E/mp, d/dp, f]``). It all-gathers its experts' blocks
over the data axes, routes with the whole router, dispatches only to its
own experts (``expert_offset``), and the ranks of a ``model`` line add
their partial outputs in rank order in the model dtype
(``core/distributed.py:psum``), so every rank of the line holds the same
bits under gloo as under nccl. Shared experts run on the rank's own
tokens: in a model that places its weights (``models/model.py``), as the
dense MLP runs (``MoE.shared``: column- and row-parallel over ``model``,
their rank's part summed over it).

The backward across ranks is ``shard_map``'s transpose (the collectives
of ``core/distributed.py``): the experts' side reads the tokens and the
router through a copy whose gradient is summed over ``model`` (each rank
back-propagates its own experts' part), the partial sum's gradient is
the identity, and the FSDP gather's is a reduce-scatter over the data
axes. What a rank computes whole (the aux loss, unplaced shared
experts) is not summed over ``model``. Each rank's gradients then cover its own
tokens; the train step sums them over the data axes.

Under data parallelism without expert parallelism (a ``model`` axis of
1, or one that does not divide the experts), every expert is local and
the layer is the reference's ``_moe_local`` over the whole batch: the
capacity comes from the whole batch's tokens, and a rank's place in
each expert's queue follows the assignments of the data ranks before it
(all-gathered counts; the batch's blocks are contiguous rows, and the
queue is token-major). The load-balance loss under data parallelism
takes the whole batch's statistics: the top-1 counts and probability
sums summed over the data axes.

Weights keep the reference's layouts, so carrying them is a copy:
``router [d, E]``, ``w_gate``/``w_up [E, d, f]``, ``w_down [E, f, d]``,
``shared_gate``/``shared_up [d, f·n_shared]``, ``shared_down [f·n_shared,
d]``.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import copy_over, gather_axis, psum, sum_over
from repro_torch.distributed import sharding
from repro_torch.distributed.context import get_mesh, whole_batch
from repro_torch.launch.mesh import data_axes
from repro_torch.models.layers import Placed, dense_init, softmax_fp32

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


def _by_expert(gate_e: torch.Tensor, n_local: int, cap: int,
               offset: int = 0, queue_start: Optional[torch.Tensor] = None):
    """The T*k assignments (token-major) sorted stably by local expert
    ``id - offset``; ids outside ``[offset, offset + n_local)`` park in
    bucket ``n_local``, after every local one, and are never kept.
    ``queue_start`` [n_local]: where each expert's queue starts (the
    assignments it took before these; default 0). Returns (order, bucket
    of each sorted assignment, its position in its bucket's queue,
    whether it is kept: local and under ``cap``)."""
    flat_e = gate_e.reshape(-1) - offset
    local = (flat_e >= 0) & (flat_e < n_local)
    flat_e = torch.where(local, flat_e, n_local)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.bincount(flat_e, minlength=n_local + 1)
    offsets = torch.cumsum(counts, 0) - counts
    if queue_start is not None:
        offsets = offsets - F.pad(queue_start, (0, 1))
    pos = torch.arange(flat_e.numel(), device=flat_e.device) \
        - offsets[e_sorted]
    return order, e_sorted, pos, (pos < cap) & local[order]


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
                     n_experts: int, top_k: int, cap: int,
                     expert_offset: int = 0,
                     queue_start: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Sort-based dispatch, the expert products and the weighted combine
    over tokens xf [T, d] -> [T, d] (the reference's
    ``_dispatch_compute``). The weights hold experts ``[expert_offset,
    expert_offset + E_local)`` (``E_local = w_gate.shape[0]``); an
    assignment to any other expert contributes zero, for the ranks of a
    ``model`` line to add up. ``queue_start``: as ``_by_expert`` takes
    it."""
    t, d = xf.shape
    e_local = w_gate.shape[0]
    order, e_sorted, pos, keep = _by_expert(gate_e, e_local, cap,
                                            expert_offset, queue_start)
    slot = torch.where(keep, e_sorted * cap + pos, e_local * cap)
    # each slot holds at most one kept assignment: the buffer gathers its
    # token (row t of the padded input is zeros, for empty slots)
    src = torch.full((e_local * cap + 1,), t, dtype=torch.long,
                     device=xf.device)
    src[slot] = torch.where(keep, order // top_k, t)
    buf = F.pad(xf, (0, 0, 0, 1))[src[:-1]].view(e_local, cap, d)

    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = F.silu(g.float()).to(xf.dtype) * u
    out_buf = F.pad(torch.bmm(h, w_down).view(e_local * cap, d),
                    (0, 0, 0, 1))   # row E_local*cap: dropped or not local

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


Shared = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _shared(params: Params, xf: torch.Tensor, shared: Shared
            ) -> torch.Tensor:
    return shared_experts(params, xf) if shared is None else shared(xf)


def _queue_start(mesh, gate_e: torch.Tensor, n_experts: int
                 ) -> torch.Tensor:
    """[E]: the assignments to each expert on the data ranks before this
    one, in the data axes' row-major order (the order of their blocks in
    the batch), from their counts all-gathered."""
    axes = data_axes(mesh)
    counts = torch.bincount(gate_e.reshape(-1), minlength=n_experts)[None]
    for a in reversed(axes):
        counts = gather_axis(mesh, a, counts, dim=0)
    me = 0
    for a in axes:
        me = me * mesh.shape[a] + mesh.axis_index(a)
    return counts[:me].sum(0)


def _moe_local(params: Params, x: torch.Tensor, cfg: ModelConfig,
               mesh=None, shared: Shared = None) -> torch.Tensor:
    """Every expert local: the capacity follows from this call's B*S
    tokens, so a decode step (S = 1) has its own. Under ``mesh``, where
    the rank holds a block of the batch, it is the whole batch's, and
    the rank's queues start after the ranks before it (``_queue_start``)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gate_w, gate_e = route(xf, params["router"], cfg.moe_top_k)
    n_tokens, queue_start = t, None
    if mesh is not None:
        whole, _ = whole_batch(mesh, b)
        if whole != b:
            n_tokens = whole * s
            queue_start = _queue_start(mesh, gate_e, cfg.n_experts)
    out = dispatch_compute(xf, gate_w, gate_e, params["w_gate"],
                           params["w_up"], params["w_down"],
                           n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                           cap=capacity(cfg, n_tokens),
                           queue_start=queue_start)
    if cfg.n_shared_experts:
        out = out + _shared(params, xf, shared)
    return out.view(b, s, d)


EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def expert_parallel(cfg: ModelConfig, mesh) -> bool:
    """Whether the layer takes the sharded path under ``mesh``: the
    reference's test, a ``model`` axis above 1 that divides the experts."""
    mp = 1 if mesh is None else mesh.shape.get("model", 1)
    return mp > 1 and cfg.n_experts % mp == 0


def expert_specs(cfg: ModelConfig, mesh,
                 dist: Optional[sharding.DistConfig] = None
                 ) -> Dict[str, sharding.Spec]:
    """The specs of the expert weights under ``mesh``: ``param_specs``'
    rules, experts over ``model``, ``d`` over the data axes that divide
    it."""
    shapes = moe_param_shapes(cfg)
    dist = dist or sharding.DistConfig()
    return {name: sharding.spec_for_leaf(("moe", name), shapes[name], mesh,
                                         dist, stacked=False)
            for name in EXPERT_WEIGHTS}


def gather_experts(params: Params, cfg: ModelConfig, mesh,
                   dist: Optional[sharding.DistConfig] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """This rank's experts with their whole ``d``: each weight's block
    all-gathered over the data axes its spec shards ``d`` on, the minor
    axis first so that the blocks fall in place (``w_gate``/``w_up``
    along dim 1, ``w_down`` along dim 2)."""
    out = []
    for name, spec in expert_specs(cfg, mesh, dist).items():
        w, dim = params[name], (2 if name == "w_down" else 1)
        for ax in reversed(sharding.entry_axes(spec[dim])):
            w = gather_axis(mesh, ax, w, dim=dim)
        out.append(w)
    return tuple(out)


def sum_over_model(mesh, out: torch.Tensor) -> torch.Tensor:
    """The reference's ``psum`` over ``model``: the line's partials added
    in rank order, in ``out``'s dtype, so that every rank of the line
    holds the same bits. Its gradient is the identity: each rank
    back-propagates its own partial."""
    return sum_over(mesh, ("model",), out)


def moe_sharded(params: Params, x: torch.Tensor, cfg: ModelConfig, mesh,
                dist: Optional[sharding.DistConfig] = None,
                shared: Shared = None) -> torch.Tensor:
    """The reference's ``_moe_sharded`` on this rank: x is its tokens
    [b, S, d] (its block of the batch by ``sharding.batch_spec``, the
    whole batch where the data axes do not divide it), ``params`` its
    blocks of the expert weights (``expert_specs``) and the whole router
    and shared experts. Returns this rank's [b, S, d].

    The capacity comes from the reference's per-rank token count, ``(B
    S) // dp``, also where the batch is replicated (``B % dp != 0``): such
    a rank routes all B S tokens at that capacity (ROADMAP queue 3). B,
    the whole batch's size, is the ambient context's (``whole_batch``).
    The experts' side reads ``x`` and the router through ``copy_over``
    ``model``, so that their gradients sum the experts of every rank of
    the line."""
    b_loc, s, d = x.shape
    b, dp = whole_batch(mesh, b_loc)
    e_local = cfg.n_experts // mesh.shape["model"]
    if tuple(params["w_gate"].shape[:1]) != (e_local,):
        raise ValueError(f"w_gate {tuple(params['w_gate'].shape)} holds not "
                         f"this rank's {e_local} experts")
    t_local = (b * s) // dp if (b * s) % dp == 0 else b * s
    w_gate, w_up, w_down = gather_experts(params, cfg, mesh, dist)
    xf = x.reshape(b_loc * s, d)
    xe = copy_over(mesh, ("model",), xf)
    router = copy_over(mesh, ("model",), params["router"])
    gate_w, gate_e = route(xe, router, cfg.moe_top_k)
    out = dispatch_compute(xe, gate_w, gate_e, w_gate, w_up, w_down,
                           n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                           cap=capacity(cfg, t_local),
                           expert_offset=mesh.axis_index("model") * e_local)
    out = sum_over_model(mesh, out)
    if cfg.n_shared_experts:
        out = out + _shared(params, xf, shared)
    return out.view(b_loc, s, d)


def moe_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                shared: Shared = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: ``moe_sharded`` under an ambient mesh
    whose ``model`` axis divides the experts, else every expert local
    (under a mesh, the reference's local path over the whole batch).
    ``shared``: the shared experts of the tokens [T, d] (default:
    ``shared_experts`` of ``params``' whole weights)."""
    mesh, dist = get_mesh()
    if expert_parallel(cfg, mesh):
        return moe_sharded(params, x, cfg, mesh, dist, shared)
    return _moe_local(params, x, cfg, mesh, shared)


def moe_aux_loss(params: Params, x: torch.Tensor, cfg: ModelConfig,
                 mesh=None) -> torch.Tensor:
    """Switch-style load-balance loss, f32 scalar: E times the sum over
    experts of (share of tokens whose top-1 it is) x (mean router
    probability). The gradient flows through the probabilities. Under
    ``mesh``, where the rank holds a block of the batch, both shares are
    the whole batch's: the counts and the probability sums summed over
    the data axes (``sum_over``: each rank's gradient covers its own
    tokens), over the whole batch's tokens."""
    b, s, d = x.shape
    t = b * s
    probs = softmax_fp32((x.reshape(t, d) @ params["router"]).float())
    top1 = torch.bincount(probs.argmax(-1), minlength=cfg.n_experts)
    if mesh is not None:
        whole, _ = whole_batch(mesh, b)
        if whole != b:
            n = whole * s
            axes = data_axes(mesh)
            frac_tokens = psum(mesh, axes, top1).float() / n
            frac_probs = sum_over(mesh, axes, probs.sum(0)) / n
            return cfg.n_experts * (frac_tokens * frac_probs).sum()
    frac_tokens = top1.float() / t
    return cfg.n_experts * (frac_tokens * probs.mean(0)).sum()


class MoE(Placed):
    """One MoE layer's weights (``moe_param_shapes``, the reference's
    layouts) and its forward. Built under an ambient mesh where the layer
    is expert-parallel (``expert_parallel``), it holds this rank's blocks
    of the expert weights (``expert_specs``: ``w_gate [E/mp, d/dp, f]``)
    and must run under that mesh; the router stays whole, and a model
    that places its weights (``models.model.place``) holds the shared
    experts as the dense MLP's blocks (``shared_gate``/``shared_up``
    column-parallel, ``shared_down`` row-parallel over ``model``, ``d``
    over the data axes)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        self.mesh, self.dist = get_mesh()
        self.specs = expert_specs(cfg, self.mesh, self.dist) \
            if expert_parallel(cfg, self.mesh) else {}
        for name, shape in moe_param_shapes(cfg).items():
            if name in self.specs:
                shape = tuple(n // sharding.group_size(self.mesh, entry)
                              for n, entry in zip(shape, self.specs[name]))
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=dtype, device=device),
                requires_grad=False))

    def forward(self, x: torch.Tensor, with_aux: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(moe_forward of x, its aux loss when ``with_aux`` else None)."""
        if get_mesh()[0] is not self.mesh:
            raise RuntimeError("an MoE layer runs under the mesh context it "
                               "was built under")
        params = dict(self.named_parameters())
        aux = moe_aux_loss(params, x, self.cfg, self.mesh) if with_aux \
            else None
        return moe_forward(params, x, self.cfg, self.shared), aux

    def shared(self, xf: torch.Tensor) -> torch.Tensor:
        """The shared experts of the tokens xf [T, d] from this rank's
        blocks: the FSDP dims gathered, and where ``model`` splits their
        width the tokens through ``copy_over`` and the rank's part summed
        over ``model``."""
        params = {n: self.weight(n) for n in
                  ("shared_gate", "shared_up", "shared_down")}
        if not self.split("shared_gate", 1):
            return shared_experts(params, xf)
        out = shared_experts(params, copy_over(self.mesh, ("model",), xf))
        return sum_over(self.mesh, ("model",), out)


def block_specs(model: nn.Module) -> Dict[str, sharding.Spec]:
    """{parameter name: spec} of every parameter ``model`` holds as a block
    of the whole weight (``Placed.specs`` of each module: the placed
    weights and the experts of its expert-parallel MoE layers). Every
    other parameter is whole on every rank."""
    return {f"{path}.{name}" if path else name: spec
            for path, mod in model.named_modules()
            for name, spec in getattr(mod, "specs", {}).items()}


@torch.no_grad()
def init_moe(moe: MoE, gen: torch.Generator) -> None:
    """The reference's ``init_moe``: fan-in normal weights, the fan-in
    along d for the router, ``w_gate``, ``w_up`` and the shared gate and
    up, along f for ``w_down`` and ``shared_down`` (``in_axis=1`` for the
    ``w_*`` experts). Each expert is drawn whole and on its own, in order,
    so no f32 copy of a whole ``[E, d, f]`` tensor is made (Kimi-K2's
    would be 22.5 GB); a layer built under a mesh keeps its block of each
    of its own experts, so it holds the unsharded layer's weights for the
    same generator."""
    shapes = moe_param_shapes(moe.cfg)
    for name, w in moe.named_parameters():
        if not name.startswith("w_"):
            moe.fill(name, lambda shape, dt=w.dtype: dense_init(gen, shape, 0,
                                                               dt))
            continue
        spec = moe.specs.get(name)
        first = moe.mesh.axis_index("model") * w.shape[0] if spec else 0
        for e in range(shapes[name][0]):
            expert = dense_init(gen, shapes[name][1:], 0, w.dtype)
            if first <= e < first + w.shape[0]:
                w[e - first].copy_(expert if spec is None else
                                   sharding.local_block(expert, spec[1:],
                                                        moe.mesh))
