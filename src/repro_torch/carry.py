"""Carry an index built elsewhere into the port.

``PAG.arrays()`` is a plain dict of numpy arrays and a store's objects are
numpy arrays, so an index and its partition objects built by the
reference package (or saved from an earlier run) load here unchanged:

    pag = pag_from_arrays(ref_pag.arrays())
    store = store_from_objects(ref_store._data, StorageConfig.preset("mem"))

A language model's weights carry the same way: the reference's params
pytree as numpy arrays (``jax.tree.map(np.asarray, params)``) becomes the
port's model with ``lm_params_from_arrays(cfg, params)``, and its AdamW
state (``repro.training.optimizer.init_state`` or a later step's) the
port's with ``opt_state_from_arrays(cfg, state)``. With ``mesh=`` both
give this rank's blocks of what the rank holds as blocks.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pag import PAG
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.context import mesh_context
from repro_torch.distributed.sharding import local_block, stat_spec
from repro_torch.models.model import LM
from repro_torch.models.moe import block_specs
from repro_torch.storage.simulator import ObjectStore, StorageConfig
from repro_torch.training.optimizer import STACKS


def pag_from_arrays(arrays: Dict[str, np.ndarray]) -> PAG:
    """A port ``PAG`` from the output of ``PAG.arrays()`` (copies, so the
    source index is never aliased)."""
    return PAG.from_arrays({k: np.array(v) for k, v in arrays.items()})


def store_from_objects(objects: Dict[str, np.ndarray],
                       cfg: StorageConfig) -> ObjectStore:
    """A fresh port ``ObjectStore`` under ``cfg`` holding every object,
    re-put one by one so the put-time checksums are computed here."""
    store = ObjectStore(cfg)
    for key, obj in objects.items():
        store.put(key, np.asarray(obj))
    return store


def _tensor(a) -> torch.Tensor:
    """A numpy array (``ml_dtypes.bfloat16`` included) as a CPU tensor."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def _per_layer(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's nested leaves by the port's parameter names, each
    stacked ``[L, ...]`` leaf under ``blocks``, ``dense_blocks`` or
    ``encoder`` split into its layers (``blocks.<i>.…``, …)."""
    given = {}
    for name, arr in _flatten(tree).items():
        stack, _, rest = name.partition(".")
        if stack in STACKS:
            for i, layer in enumerate(_tensor(arr).unbind(0)):
                given[f"{stack}.{i}.{rest}"] = layer
        else:
            given[name] = _tensor(arr)
    return given


def lm_params_from_arrays(cfg: ModelConfig, params: Dict[str, Any],
                          device: DeviceLike = None, mesh=None,
                          dist=None) -> LM:
    """The port's model holding the reference's weights. ``params`` is the
    reference's params pytree as numpy arrays, with the per-layer leaves
    stacked ``[L, ...]`` under ``blocks`` (and ``dense_blocks``, the moe
    family's dense prefix; ``encoder``, the audio family's encoder, beside
    its ``enc_norm`` and the decoder layers' ``xattn_norm`` and ``xattn``;
    an SSD's leaves under ``blocks`` ``ssm``, the hybrid family's
    ``meta_tokens`` at the top); each layer's slice goes
    to its own module, cast to the parameter's dtype (``cfg.dtype``, but
    float32 for the SSD's ``A_log``, ``D`` and ``dt_bias``, as in the
    reference). With ``mesh`` (and ``dist``, a
    ``distributed.sharding.DistConfig``) the model is this rank's, built
    under that mesh context: the parameters it holds as blocks (every
    weight ``sharding.placed_specs`` splits, the SSD's concatenated
    ``in_proj`` and conv per part or contiguous, and the experts of an
    expert-parallel MoE layer) get this rank's block of the whole weight
    (``moe.block_specs``, cut by ``local_block``); run it under the same
    context.
    Raises unless every parameter of the model is given exactly once,
    with its shape."""
    if mesh is None:
        model = LM(cfg, device)
    else:
        with mesh_context(mesh, dist):
            model = LM(cfg, device)
    specs = block_specs(model)
    target = dict(model.named_parameters())
    given = _per_layer(params)
    if set(given) != set(target):
        raise ValueError(f"parameters missing: {sorted(set(target) - set(given))}"
                         f", unknown: {sorted(set(given) - set(target))}")
    with torch.no_grad():
        for name, t in given.items():
            if name in specs:
                t = local_block(t, specs[name], mesh)
            if t.shape != target[name].shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, the model "
                                 f"holds {tuple(target[name].shape)}")
            target[name].copy_(t)
    return model


def _split_factored(v: Dict[str, Any]):
    """The reference's v tree -> (plain leaves, {"row"}, {"col"}) trees:
    a factored leaf is a dict of exactly ``row`` and ``col``."""
    plain, row, col = {}, {}, {}
    for key, val in v.items():
        if isinstance(val, dict) and set(val) == {"row", "col"}:
            row[key], col[key] = val["row"], val["col"]
        elif isinstance(val, dict):
            plain[key], row[key], col[key] = _split_factored(val)
        else:
            plain[key] = val
    return plain, row, col


def opt_state_from_arrays(cfg: ModelConfig, state: Dict[str, Any],
                          device: DeviceLike = None, mesh=None,
                          dist=None) -> Dict[str, Any]:
    """The port's optimizer state (``repro_torch.training.optimizer``)
    holding the reference's: ``state`` is its ``{"step", "m", "v"}`` as
    numpy arrays, per-layer moments stacked ``[L, ...]`` under
    ``blocks`` and ``dense_blocks`` and factored second moments as
    ``{"row", "col"}`` leaves. Each layer's slice goes to its
    parameter's name (a stacked ``[L, d]`` leaf's column, shared by the
    layers, to each of them), in the stored dtype (``state_dtype``), on
    ``device`` (the CUDA card unless ``"cpu"``). With ``mesh`` (and
    ``dist``), the state of this rank's model as ``lm_params_from_arrays``
    builds it there: for a parameter it holds as a block
    (``moe.block_specs``), its block of ``m`` and of a plain ``v`` by the
    parameter's spec, and of a factored ``v``'s ``row`` and ``col`` by
    ``sharding.stat_spec`` (the parameter's spec without the reduced
    dim).
    Raises unless ``m`` names every parameter of ``cfg``'s model."""
    dev = resolve_device(device)
    if mesh is None:
        model = LM(cfg, "meta")
    else:
        with mesh_context(mesh, dist):
            model = LM(cfg, "meta")
    names = set(dict(model.named_parameters()))
    specs = block_specs(model)
    m = _per_layer(state["m"])
    if set(m) != names:
        raise ValueError(f"moments missing: {sorted(names - set(m))}, "
                         f"unknown: {sorted(set(m) - names)}")
    plain, row, col = (_flatten(t) for t in _split_factored(state["v"]))
    for name, r in row.items():
        if name.partition(".")[0] in STACKS and np.ndim(r) == 1:
            # a stacked [L, d] leaf: one column for all L layers
            col[name] = np.broadcast_to(np.asarray(col[name]),
                                        (len(r),) + np.shape(col[name]))
    plain, row, col = (_per_layer(t) for t in (plain, row, col))

    def block(name, t, stat=None):
        if name not in specs:
            return t.to(dev)
        spec = specs[name] if stat is None else stat_spec(specs[name], stat)
        return local_block(t, spec, mesh).clone().to(dev)
    v = {n: block(n, t) for n, t in plain.items()}
    v.update({n: {"row": block(n, row[n], "row"),
                  "col": block(n, col[n], "col")} for n in row})
    if set(v) != names:
        raise ValueError(f"second moments do not name the parameters: "
                         f"{sorted(set(v) ^ names)}")
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev),
            "m": {n: block(n, t) for n, t in m.items()}, "v": v}
