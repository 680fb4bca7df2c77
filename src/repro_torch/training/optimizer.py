"""AdamW, as the reference implements it (``repro/training/optimizer.py``).

With a configurable state dtype, an optional Adafactor-style factored
second moment (row and column statistics on the trailing two dims),
global-norm gradient clipping and a linear warmup + cosine schedule with
a floor of 0.1. The arithmetic is the reference's, in float32, cast back
to each parameter's dtype.

Parameters, gradients and the moments are dicts keyed by the model's
parameter names (``model.named_parameters()``); the state is
``{"step": int32 scalar, "m": {name: tensor}, "v": {name: tensor or
{"row", "col"}}}``. ``apply_updates`` writes the new parameters and
moments in place (the reference returns new arrays; in place, a step at
TinyLlama-1.1B's width holds no second copy of them), a parameter of
more than ``UPDATE_BLOCK`` elements a block of rows at a time.

The reference stacks a layer's parameters on a leading ``[L, ...]`` axis
where the port keeps one tensor per layer (``blocks.<i>.<name>``,
``dense_blocks.<i>.<name>``). The rule "weight decay only on leaves with
ndim >= 2" sees the stacked leaf: a layer's norm scale, or an SSD's
``A_log``, ``D`` and ``dt_bias`` ``[H]``, is ``[L, ...]`` there and
decays. So the port counts a layer's parameter with its layer axis
(``reference_ndim``), and decays what the reference decays. The factored
moment reads the trailing two dims, which are the same either way for a
per-layer matrix; a per-layer vector ``[d]`` is the reference's stacked
``[L, d]``, factored when both L and d reach ``min_dim_size_to_factor``
(at 16, the norm scales of every ported config at full depth): then its statistics span the
layers, a row entry per layer and one column ``[d]`` shared by all of
them, and the port updates the layers of such a vector together
(``stacked_vectors``), each layer's state holding its row entry (a 0-d
tensor) and a copy of the shared column.

Under a mesh (``apply_updates(..., mesh=, specs=)``) a parameter that a
rank holds as a block (``specs``, ``moe.block_specs``: every weight a
placed model splits, ``wq [d/dp, H/mp, hd]``, ``tok_embed [V/mp, d/dp]``,
the SSD's ``in_proj [d/dp, (2 di + 2 N + H)/mp]`` per part or as the
reference's contiguous block, and the
experts of an expert-parallel MoE layer, ``w_gate [E/mp, d/dp, f]``)
updates as the reference's global array does: its squares enter the
global norm summed over the mesh axes its spec shards it on (a whole
parameter counts once), whether its
second moment factors is decided on its global shape (``global_shape``),
and a factored statistic that averages over a sharded dim is averaged
over that dim's axes too (an expert's, ``wo``'s or ``lm_head``'s column
statistic over ``d``'s axes, a row statistic's mean over the last dim's:
``sharding.stat_spec`` gives their blocks; a per-part leaf's column
statistic keeps its parts). A per-layer vector held as a block (``b_fc``,
``ssm_norm``, ``conv_b``) factors across the layers by its whole length,
its row entries' means over ``d`` completed over ``d``'s axes. The
moments are the rank's blocks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch.core.distributed import psum

Tensors = Mapping[str, torch.Tensor]
# the reference's [L, ...] stacks
STACKS = ("blocks", "dense_blocks", "encoder")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: str = "float32"
    factored: bool = False           # Adafactor-style factored 2nd moment
    min_dim_size_to_factor: int = 128


# A parameter's f32 update runs over blocks of its leading dim of at most
# this many elements, so that its f32 temporaries (the gradient, the new
# moments, the reconstructed second moment, the step: about eight of its
# size at once) stay that small. At InternVL2-76B's width a whole [128256,
# 8192] embedding would hold eight temporaries of 4.2 GB each
UPDATE_BLOCK = 1 << 26


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(cfg: OptimizerConfig,
             step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate at ``step``, f32: linear warmup, then cosine decay
    to 0.1 of ``lr`` at ``total_steps``."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """The ndim of the reference's leaf holding ``p``: a layer's parameter
    (``blocks.<i>.…``, or ``dense_blocks.<i>.…`` in the moe family's dense
    prefix) carries the stacked layer axis there."""
    stacked = name.partition(".")[0] in STACKS
    return p.dim() + (1 if stacked else 0)


def _factorable(shape, cfg: OptimizerConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def _axes(spec, dim: int) -> Tuple[str, ...]:
    """The mesh axes a spec (``distributed.sharding``'s tuples) splits
    ``dim`` over; none without a spec."""
    entry = spec[dim] if spec else None
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def global_shape(p: torch.Tensor, spec, mesh) -> Tuple[int, ...]:
    """The shape of the whole parameter of which ``p`` is the block under
    ``spec`` (``p``'s own shape without one)."""
    return tuple(n * math.prod(mesh.shape[a] for a in _axes(spec, i))
                 for i, n in enumerate(p.shape))


def stacked_vectors(params: Tensors, cfg: OptimizerConfig, mesh=None,
                    specs: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, List[str]]:
    """The per-layer vectors whose stacked ``[L, d]`` leaf the reference
    factors: ``{"<stack>.<name>": [the layers' names in layer order]}``
    (none unless ``cfg.factored``); under ``mesh``, by a block's whole
    length (``specs``)."""
    if not cfg.factored:
        return {}
    specs = specs or {}
    groups: Dict[str, list] = {}
    for name, p in params.items():
        stack, _, rest = name.partition(".")
        if stack in STACKS and p.dim() == 1:
            layer, _, leaf = rest.partition(".")
            groups.setdefault(f"{stack}.{leaf}", []).append((int(layer), name))

    def length(name):
        return global_shape(params[name], specs.get(name), mesh)[0]
    return {key: [n for _, n in sorted(members)]
            for key, members in groups.items()
            if _factorable((len(members), length(members[0][1])), cfg)}


def _row_blocks(p: torch.Tensor) -> list:
    """Index blocks of ``p`` along its leading dim, each of at most
    UPDATE_BLOCK elements; ``[...]`` (all of it) when ``p`` is no larger
    or has fewer than two dims."""
    if p.dim() < 2 or p.numel() <= UPDATE_BLOCK:
        return [...]
    rows = max(1, UPDATE_BLOCK // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _factored_v_hat(grad_of, v: Dict[str, torch.Tensor], ndim: int,
                    blocks: list, cfg: OptimizerConfig, mean_last=None,
                    mean_rows=None):
    """A factored second moment's step: writes the new row and column
    statistics of the (clipped) gradient, ``grad_of(block)`` f32, into
    ``v`` and returns the function of a block giving the reconstructed
    v = row x col / mean(row) there. Over several blocks of a matrix the
    column statistic's mean over the rows is summed block by block; a
    block of a higher-rank leaf holds whole matrices. ``mean_last`` and
    ``mean_rows`` complete a mean over the last and the second-to-last
    dim of a parameter held as a block (None: the dim is whole)."""
    def whole(mean, t):
        return t if mean is None else mean(t)
    rows, cols = [], []
    for blk in blocks:
        g2 = grad_of(blk).square() + 1e-30
        rows.append(g2.mean(-1))
        cols.append(g2.mean(-2) if ndim > 2 or len(blocks) == 1
                    else g2.sum(-2))
    row = cfg.b2 * v["row"].float() \
        + (1 - cfg.b2) * whole(mean_last, torch.cat(rows))
    g2_col = torch.cat(cols) if ndim > 2 or len(blocks) == 1 \
        else torch.stack(cols).sum(0) / sum(r.shape[0] for r in rows)
    col = cfg.b2 * v["col"].float() + (1 - cfg.b2) * whole(mean_rows, g2_col)
    denom = torch.clamp(whole(mean_rows, row.mean(-1, keepdim=True)),
                        min=1e-30)
    v["row"].copy_(row)
    v["col"].copy_(col)
    ratio = row / denom
    return lambda blk: ratio[blk][..., None] \
        * (col if ndim == 2 else col[blk])[..., None, :]


def init_state(params: Tensors, cfg: OptimizerConfig, mesh=None,
               specs: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Zero moments in ``cfg.state_dtype`` on each parameter's device;
    under ``mesh``, a parameter held as a block (``specs``) factors by its
    global shape and holds the statistics of its block."""
    dt = getattr(torch, cfg.state_dtype)
    specs = specs or {}
    across = {n for names in stacked_vectors(params, cfg, mesh,
                                             specs).values()
              for n in names}

    def init_v(name, p):
        if name in across:   # a row entry and the shared column
            return {"row": p.new_zeros((), dtype=dt),
                    "col": p.new_zeros(p.shape, dtype=dt)}
        whole = global_shape(p, specs[name], mesh) if name in specs \
            else p.shape
        if cfg.factored and _factorable(whole, cfg):
            return {"row": p.new_zeros(p.shape[:-1], dtype=dt),
                    "col": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=dt)}
        return p.new_zeros(p.shape, dtype=dt)

    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": {n: p.new_zeros(p.shape, dtype=dt)
                  for n, p in params.items()},
            "v": {n: init_v(n, p) for n, p in params.items()}}


def global_norm(tensors, mesh=None,
                specs: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (a dict's values or a
    sequence), in f32. Under ``mesh``, a dict's tensor held as a block
    (``specs``) adds its squares summed over the axes its spec shards it
    on (``psum``, the same bits on every rank); the others count once."""
    if isinstance(tensors, Mapping) and specs:
        by_axes: Dict[Tuple[str, ...], list] = {}
        for name, x in tensors.items():
            spec = specs.get(name)
            axes = tuple(a for i in range(x.dim()) for a in _axes(spec, i))
            by_axes.setdefault(axes, []).append(x.float().square().sum())
        return torch.sqrt(torch.stack([
            psum(mesh, axes, torch.stack(sq).sum())
            for axes, sq in sorted(by_axes.items())]).sum())
    if isinstance(tensors, Mapping):
        tensors = tensors.values()
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tensors]).sum())


def _mean_over(mesh, axes: Tuple[str, ...]):
    """The function completing a mean over a dim split over ``axes`` (its
    blocks equal), or None where the dim is whole."""
    if not axes:
        return None
    n = math.prod(mesh.shape[a] for a in axes)
    return lambda t: psum(mesh, axes, t) / n


@torch.no_grad()
def apply_updates(params: Tensors, grads: Tensors, state: Dict[str, Any],
                  cfg: OptimizerConfig, mesh=None,
                  specs: Optional[Mapping[str, Any]] = None
                  ) -> Tuple[Tensors, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: writes the new parameters into ``params`` and the
    new moments into ``state`` (both in place) and returns (params, state,
    {"grad_norm", "lr"}). Under ``mesh``, ``specs`` names the parameters
    held as blocks (see the module docstring)."""
    specs = specs or {}
    step = state["step"] + 1
    lr = schedule(cfg, step).to(step.device)
    gnorm = global_norm(grads, mesh, specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm else 1.0
    stepf = step.float()
    b1c = 1 - _f32(cfg.b1).to(step.device) ** stepf
    b2c = 1 - _f32(cfg.b2).to(step.device) ** stepf
    dt = getattr(torch, cfg.state_dtype)

    # per-layer vectors factored as the reference's stacked [L, d]: the row
    # statistic of each layer, the column's over the layers
    v_across = {}
    for names in stacked_vectors(params, cfg, mesh, specs).values():
        vs = [state["v"][n] for n in names]
        g2 = torch.stack([(grads[n].float() * scale).square()
                          for n in names]) + 1e-30
        mean_last = _mean_over(mesh, _axes(specs.get(names[0]), 0))
        row = cfg.b2 * torch.stack([v["row"].float() for v in vs]) \
            + (1 - cfg.b2) * (g2.mean(-1) if mean_last is None
                              else mean_last(g2.mean(-1)))
        col = cfg.b2 * vs[0]["col"].float() + (1 - cfg.b2) * g2.mean(-2)
        denom = torch.clamp(row.mean(-1, keepdim=True), min=1e-30)
        v_hat = (row / denom)[..., None] * col[..., None, :]
        for i, (n, v) in enumerate(zip(names, vs)):
            v["row"].copy_(row[i])
            v["col"].copy_(col)
            v_across[n] = v_hat[i]

    for name, p in params.items():
        v = state["v"][name]
        blocks = _row_blocks(p)

        def grad_of(blk, name=name):
            return grads[name][blk].float() * scale
        if name in v_across:
            v_hat_of = v_across[name].__getitem__
        elif isinstance(v, dict):
            means = [_mean_over(mesh, _axes(specs.get(name), dim))
                     for dim in (p.dim() - 1, p.dim() - 2)]
            v_hat_of = _factored_v_hat(grad_of, v, p.dim(), blocks, cfg,
                                       *means)
        else:
            v_hat_of = None
        decay = cfg.weight_decay and reference_ndim(name, p) >= 2
        for blk in blocks:
            g = grad_of(blk)
            m = state["m"][name][blk]
            m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
            if v_hat_of is None:
                v_hat = cfg.b2 * v[blk].float() + (1 - cfg.b2) * g.square()
                v[blk].copy_(v_hat)
            else:
                v_hat = v_hat_of(blk)
            delta = (m_new / b1c) / (torch.sqrt(v_hat / b2c) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * p[blk].float()
            p[blk].copy_(p[blk].float() - lr * delta)
            m.copy_(m_new.to(dt))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
