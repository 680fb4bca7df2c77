"""Abstract inputs and their specs for every (arch x shape) cell: port of
``repro/launch/specs.py``.

Nothing is allocated. Parameters, optimizer state, batches and caches
are tensors on the meta device (the reference's ``ShapeDtypeStruct``s):
``abstract_params`` builds the model there, whose parameters are zeros
made with no generator (``init_params`` draws from a ``torch.Generator``,
which the meta device has not). The dtypes are the reference's: tokens
and labels int32, the audio family's frames and the vlm family's vision
embeddings f32, ``cur_pos`` a 0-d int32.

The ``*_shardings`` give one spec a leaf (``distributed.sharding``'s
tuples, the reference's ``PartitionSpec`` entry for entry) on a mesh's
axes and sizes alone (a ``sharding.MeshShape``: no ranks needed). The
port holds a layer's parameter, and its moments, as one tensor a layer
where the reference stacks ``[L, ...]``; each gets the reference's spec
of its stacked leaf without the layer's leading ``None``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.context import mesh_context
from repro_torch.distributed.sharding import (
    DistConfig,
    Spec,
    batch_spec,
    cache_spec,
    group_size,
    param_specs,
    reference_path,
    spec_for_leaf,
)
from repro_torch.models.model import LM, init_cache
from repro_torch.models.moe import block_specs
from repro_torch.training.optimizer import OptimizerConfig, init_state

META = torch.device("meta")


def abstract_params(cfg: ModelConfig, mesh=None,
                    dist: Optional[DistConfig] = None) -> LM:
    """The model on the meta device. Under ``mesh`` (a ``MeshShape`` will
    do) it is one rank's, as the port places it: every parameter its
    ``param_specs`` block (the experts as their expert-parallel layer
    takes them; the SSD's concatenated leaves per part where every
    part divides ``model``, the same bytes)."""
    if mesh is None:
        return LM(cfg, device=META)
    with mesh_context(mesh, dist):
        return LM(cfg, device=META)


def abstract_opt_state(cfg: ModelConfig, ocfg: OptimizerConfig,
                       model: Optional[LM] = None, mesh=None
                       ) -> Dict[str, Any]:
    """``init_state`` of the (meta) parameters of ``model`` (default:
    ``abstract_params(cfg)``); ``mesh``: the one ``model`` was built
    under, whose blocks factor by their whole shapes."""
    model = model if model is not None else abstract_params(cfg)
    params = dict(model.named_parameters())
    return init_state(params, ocfg, mesh, block_specs(model))


def train_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META),
             "labels": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.empty(
            (b, cfg.vision_tokens, cfg.d_model), device=META)
    if cfg.enc_layers:
        batch["frames"] = torch.empty((b, cfg.enc_frames, cfg.d_model),
                                      device=META)
    return batch


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    batch = train_inputs(cfg, shape)
    del batch["labels"]
    return batch


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig):
    """(tokens [B, 1] int32, the decode cache of ``shape.seq_len`` slots
    (and the meta tokens'), cur_pos 0-d int32)."""
    b, s = shape.global_batch, shape.seq_len
    tokens = torch.empty((b, 1), dtype=torch.int32, device=META)
    cache = init_cache(cfg, b, s, device=META)
    cur_pos = torch.empty((), dtype=torch.int32, device=META)
    return tokens, cache, cur_pos


def batch_shardings(batch: Dict[str, torch.Tensor], mesh,
                    dist: Optional[DistConfig] = None) -> Dict[str, Spec]:
    return {key: batch_spec(t.shape[0], mesh, dist, extra_dims=t.dim() - 1)
            for key, t in batch.items()}


def cache_shardings(cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                    batch_size: int, mesh,
                    dist: Optional[DistConfig] = None) -> Dict[str, Spec]:
    out = {}
    for name, leaf in cache.items():
        seq_len = leaf.shape[2] if name in ("k", "v", "xk", "xv") else None
        spec = cache_spec(cfg, batch_size, mesh, dist,
                          seq_len=seq_len).get(name, ())
        # clip the spec to the leaf's rank (the conv cache has rank 4)
        out[name] = tuple(spec[:leaf.dim()]) \
            + (None,) * (leaf.dim() - len(spec))
    return out


def params_shardings(cfg: ModelConfig, mesh,
                     dist: Optional[DistConfig] = None) -> Dict[str, Spec]:
    return param_specs(abstract_params(cfg), mesh, dist)


def opt_shardings(cfg: ModelConfig, ocfg: OptimizerConfig, mesh,
                  dist: Optional[DistConfig] = None,
                  state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The optimizer state's specs, in its own tree: ``m`` and ``v`` take
    their parameter's rule; a factored ``v``'s ``row`` and ``col`` the
    parent's without the dim each reduces; ``step`` whole. A per-layer
    vector factored across the layers (``optimizer.stacked_vectors``)
    holds a 0-d row entry and a copy of the reference's ``[d]`` column,
    whose spec is the reference's for that column."""
    dist = dist or DistConfig()
    state = state if state is not None else abstract_opt_state(cfg, ocfg)

    def one(tag, name, t, leaf=(), across=False):
        path = (tag,) + reference_path(name)[0] + leaf
        return spec_for_leaf(path, tuple(t.shape), mesh, dist,
                             stacked=across)

    v = {}
    for name, t in state["v"].items():
        if isinstance(t, dict):
            across = t["row"].dim() == 0
            v[name] = {key: one("v", name, t[key], (key,), across)
                       for key in ("row", "col")}
        else:
            v[name] = one("v", name, t)
    return {"step": (), "v": v,
            "m": {name: one("m", name, t) for name, t in state["m"].items()}}


def block_bytes(t: torch.Tensor, spec: Spec, mesh) -> int:
    """The bytes of one rank's block of ``t`` under ``spec``."""
    n = math.prod(group_size(mesh, e) for e in spec)
    return t.numel() // n * t.element_size()
