"""Logical-to-physical sharding rules with a divisibility fallback: port
of ``repro/distributed/sharding.py``.

Every parameter is matched by its *name* to a per-dimension list of
candidate logical axes; each candidate resolves to mesh axes ("data" may
expand to ("pod", "data") for FSDP over pods). A candidate is taken only
if the dimension divides the axis group's size and no mesh axis is used
twice within the spec; otherwise the next candidate (or replication)
applies. This absorbs qwen's 20 heads, hymba's 25 / 5, whisper's 12 and
every kv_heads below 16.

A spec is a plain tuple with one entry a dimension, entry for entry the
reference's ``PartitionSpec``: ``None`` (whole), an axis name, or a tuple
of axis names (the dimension split over their product, the first axis
major). The functions read only ``axis_names`` and ``shape`` of their
mesh: a ``launch.mesh.Mesh`` of live ranks, or a ``MeshShape`` with no
process groups (the production meshes, for the specs alone).

The reference stacks each per-layer leaf ``[L, ...]`` under ``blocks``,
``dense_blocks`` or ``encoder``, and its spec for such a leaf starts with
``None`` for L. The port holds one module a layer, so ``param_specs``
gives a layer's parameter the reference's spec without that ``None``.

``local_block`` cuts this rank's block of a whole tensor by its spec: the
port's counterpart of placing an array under a ``NamedSharding``;
``placed_specs`` names the parameters a model built under a mesh holds as
blocks (``models/model.py:place``; every family), ``stat_spec`` the
blocks of their factored optimizer statistics, ``gather_data`` the FSDP
gather before use and ``whole_tensor`` the whole tensor again (a
checkpoint).

A concatenated leaf is cut per part where every part divides the axis.
The SSD's ``in_proj [d, 2 di + 2 N + H]`` holds z, x, B, C and dt side by
side, and ``conv_w``, ``conv_b`` and the ``conv`` cache hold x, B and C
(``LEAF_PARTS``). The reference's block of such a leaf is a contiguous
run of columns, which on mamba2-370m over 4 ranks would straddle z and x;
there the port's block is the rank's share of each part, in part order
(``PartSpec``): the same bytes in another order. Where the whole dim
divides the axis and a part does not (mamba2-370m's conv, 2048 + 128 +
128 channels, over 3), the port takes the reference's contiguous block:
the plain spec. ``local_block``, ``whole_tensor`` and ``stat_spec`` cut
and join by the spec (``cut_cols``); checkpoints are written whole, so
they do not see it.

The reference's ``constrain`` (``with_sharding_constraint``) is not
ported: it is a hint to XLA's partitioner, which the port does not have,
and changes no value; the port's layers lay their tensors out the way
the hints say.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from repro_torch.core.distributed import gather_axis
from repro_torch.launch.mesh import data_axes
from repro_torch.training.optimizer import STACKS

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes, with no ranks behind it (the reference's
    ``AbstractMesh``)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_index(self, axis: str) -> int:
        """The first rank's coordinate: blocks of the same shapes as every
        rank's, for counting bytes."""
        return 0


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """How logical axes map onto the mesh."""
    data: Tuple[str, ...] = ("data",)
    model: Tuple[str, ...] = ("model",)
    fsdp_over_pod: bool = False  # fold "pod" into the FSDP (data) axes
    # when n_heads % model != 0, shard head_dim over model (an activation
    # all-reduce a product) instead of replicating attention over it
    shard_head_dim_fallback: bool = False

    def logical(self, name: str, mesh) -> Tuple[str, ...]:
        axes = {"data": self.data, "model": self.model}[name]
        if name == "data" and self.fsdp_over_pod and "pod" in mesh.axis_names:
            axes = ("pod",) + tuple(a for a in axes if a != "pod")
        return tuple(a for a in axes if a in mesh.axis_names)


# per-leaf-name rules: a tuple over the trailing dims; each entry is a
# priority list of logical axis names (() = replicate)
_RULES: Dict[str, Tuple[Sequence[str], ...]] = {
    # embeddings
    "tok_embed": (("model",), ("data",)),
    "lm_head": (("data",), ("model",)),
    "meta_tokens": ((), ()),
    # attention
    "wq": (("data",), ("model",), ("model",)),
    "wk": (("data",), ("model",), ("model",)),
    "wv": (("data",), ("model",), ("model",)),
    "wo": (("model",), ("model",), ("data",)),
    "bq": (("model",), ("model",)),
    "bk": (("model",), ("model",)),
    "bv": (("model",), ("model",)),
    # dense mlp
    "w_gate": (("data",), ("model",)),
    "w_up": (("data",), ("model",)),
    "w_down": (("model",), ("data",)),
    "w_fc": (("data",), ("model",)),
    "b_fc": (("model",),),
    "w_out": (("model",), ("data",)),
    "b_out": ((),),
    # moe (leading expert dim); the router replicated (small, read by
    # every token)
    "router": ((), ()),
    "moe/w_gate": (("model",), ("data",), ()),
    "moe/w_up": (("model",), ("data",), ()),
    "moe/w_down": (("model",), (), ("data",)),
    "shared_gate": (("data",), ("model",)),
    "shared_up": (("data",), ("model",)),
    "shared_down": (("model",), ("data",)),
    # ssm
    "in_proj": (("data",), ("model",)),
    "out_proj": (("model",), ("data",)),
    "conv_w": ((), ("model",)),
    "conv_b": (("model",),),
    "A_log": ((),),
    "D": ((),),
    "dt_bias": ((),),
    "ssm_norm": (("model",),),
}


def _xbc(cfg) -> Tuple[int, ...]:
    return cfg.d_inner, cfg.ssm_state, cfg.ssm_state


# the parts of a concatenated leaf along its last dim, by leaf name: the
# SSD's input projection (z, x, B, C, dt) and its conv's weight, bias and
# cache window (x, B, C)
LEAF_PARTS = {
    "in_proj": lambda cfg: (cfg.d_inner, *_xbc(cfg), cfg.ssm_heads),
    "conv_w": _xbc, "conv_b": _xbc, "conv": _xbc,
}


class PartSpec(tuple):
    """A spec (equal to the plain tuple) of a leaf whose last dim
    concatenates parts of the widths ``parts``: a rank's block of that dim
    is its block of each part, in part order."""
    parts: Tuple[int, ...]

    def __new__(cls, spec: Sequence[Entry], parts: Sequence[int]):
        self = super().__new__(cls, spec)
        self.parts = tuple(parts)
        return self

    def __getnewargs__(self):
        return tuple(self), self.parts


def with_parts(name: str, spec: Spec, mesh, cfg) -> Spec:
    """``spec`` as a ``PartSpec`` where the leaf ``name`` (a port name;
    its last component is the leaf's) concatenates parts, its spec splits
    the last dim and every part divides that dim's group; else ``spec``
    (where a part does not divide, the rank's contiguous block of the
    whole dim, the reference's)."""
    leaf = name.split(".")[-1]
    if leaf not in LEAF_PARTS or spec[-1] is None:
        return spec
    parts = LEAF_PARTS[leaf](cfg)
    if any(w % group_size(mesh, spec[-1]) for w in parts):
        return spec
    return PartSpec(spec, parts)


def parts_of(spec: Spec) -> Optional[Tuple[int, ...]]:
    """The part widths a ``PartSpec`` cuts its last dim by; None for a
    plain spec (contiguous blocks)."""
    return spec.parts if isinstance(spec, PartSpec) else None


def cut_parts(t: torch.Tensor, dim: int, parts: Sequence[int], n: int,
              index: int) -> torch.Tensor:
    """Block ``index`` of ``n`` of each part of ``t`` along ``dim`` (the
    parts' widths ``parts``), concatenated in part order."""
    out, start = [], 0
    for w in parts:
        size = w // n
        out.append(t.narrow(dim, start + index * size, size))
        start += w
    return torch.cat(out, dim)


def join_parts(t: torch.Tensor, dim: int, parts: Sequence[int], n: int
               ) -> torch.Tensor:
    """The whole tensor of which ``t`` holds the ``n`` ranks' per-part
    blocks (``cut_parts``) concatenated on ``dim`` in rank order."""
    blocks = [b.split([w // n for w in parts], dim)
              for b in t.chunk(n, dim)]
    return torch.cat([blocks[r][j] for j in range(len(parts))
                      for r in range(n)], dim)


def cut_cols(t: torch.Tensor, dim: int, parts: Optional[Sequence[int]],
             n: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``n`` of ``t`` along ``dim``: of each part
    (``cut_parts``) where ``parts`` is given, else the contiguous one."""
    if parts is not None:
        return cut_parts(t, dim, parts, n, index)
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size)


def _leaf_rule(path: Tuple[str, ...]
               ) -> Optional[Tuple[Sequence[str], ...]]:
    name = path[-1]
    if name in ("row", "col") and len(path) >= 2:
        # factored optimizer statistics: the parent parameter's rule
        # without the reduced dim (row: the last; col: the second-to-last)
        parent = _leaf_rule(path[:-1])
        if parent is None:
            return None
        if name == "row":
            return parent[:-1]
        return parent[:-2] + parent[-1:]
    if len(path) >= 2 and path[-2] == "moe" and f"moe/{name}" in _RULES:
        return _RULES[f"moe/{name}"]
    return _RULES.get(name)


# attention leaves: (the heads dim's position within the rule, head_dim's)
_ATTN_HD_DIMS = {"wq": (1, 2), "wk": (1, 2), "wv": (1, 2), "wo": (0, 1),
                 "bq": (0, 1), "bk": (0, 1), "bv": (0, 1)}


def spec_for_leaf(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                  dist: DistConfig, stacked: bool) -> Spec:
    """The spec of the leaf at ``path`` (names, outermost first) of
    ``shape``; ``stacked``: its first dim is the reference's layer stack,
    never sharded."""
    rule = _leaf_rule(path)
    ndim = len(shape)
    offset = 1 if stacked and ndim >= 1 else 0
    entries: list = [None] * ndim
    if rule is None:
        return tuple(entries)
    if not dist.shard_head_dim_fallback and path[-1] in _ATTN_HD_DIMS:
        _, hd_dim = _ATTN_HD_DIMS[path[-1]]
        if hd_dim < len(rule):
            rule = tuple(() if i == hd_dim else c
                         for i, c in enumerate(rule))
    used: set = set()
    for i, candidates in enumerate(rule):
        dim = i + offset
        if dim >= ndim:
            break
        size = shape[dim]
        for logical in candidates:
            axes = dist.logical(logical, mesh)
            if not axes or any(a in used for a in axes):
                continue
            group = _group(mesh, axes)
            if group > 1 and size % group == 0:
                entries[dim] = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
    return tuple(entries)


def reference_path(name: str) -> Tuple[Tuple[str, ...], bool]:
    """A port parameter name -> (the reference's leaf path, whether the
    reference stacks it): ``blocks.3.attn.wq`` -> (("blocks", "attn",
    "wq"), True), the layer index dropped."""
    parts = tuple(name.split("."))
    if parts[0] in STACKS:
        return (parts[0],) + parts[2:], True
    return parts, False


def param_specs(model: nn.Module, mesh,
                dist: Optional[DistConfig] = None) -> Dict[str, Spec]:
    """{parameter name: spec} over ``model.named_parameters()`` at their
    shapes, so ``model`` holds whole parameters (built with no ambient
    mesh; on the meta device it allocates nothing). A layer's parameter
    gets the reference's spec of its stacked leaf without the leading
    ``None``."""
    dist = dist or DistConfig()
    out = {}
    for name, p in model.named_parameters():
        path, _ = reference_path(name)
        out[name] = spec_for_leaf(path, tuple(p.shape), mesh, dist,
                                  stacked=False)
    return out


def placed_specs(named_shapes: Mapping[str, Tuple[int, ...]], mesh,
                 dist: Optional[DistConfig], cfg) -> Dict[str, Spec]:
    """{name: spec} of the parameters (port names and whole shapes) of a
    model of ``cfg`` whose ``param_specs`` spec splits a dim on ``mesh``:
    those a rank holds as a block (``local_block``; a concatenated leaf's
    spec a ``PartSpec``). The others it holds whole."""
    dist = dist or DistConfig()
    out = {}
    for name, shape in named_shapes.items():
        path, _ = reference_path(name)
        spec = spec_for_leaf(path, tuple(shape), mesh, dist, stacked=False)
        if any(entry is not None for entry in spec):
            out[name] = with_parts(name, spec, mesh, cfg)
    return out


def block_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a whole tensor of ``shape``."""
    return tuple(n // group_size(mesh, entry)
                 for n, entry in zip(shape, spec))


def stat_spec(spec: Spec, stat: str) -> Spec:
    """The spec of a factored second moment's ``row`` (the parameter's
    mean over its last dim) or ``col`` (over its second-to-last) of a
    parameter placed by ``spec``: the rank's block of the statistic is the
    statistic of its block, its mean completed over the reduced dim's
    axes. Wherever a statistic factors in the placed families this is the
    reference's ``_leaf_rule`` spec of it (``tests/test_torch_census.py``
    holds the bytes equal). A ``col`` keeps a ``PartSpec``'s parts (it
    keeps the last dim)."""
    if stat == "row":
        return spec[:-1]
    col = spec[:-2] + spec[-1:]
    return PartSpec(col, spec.parts) if isinstance(spec, PartSpec) else col


def whole_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of the whole tensor of which a block of ``shape`` is a
    rank's under ``spec``."""
    return tuple(n * group_size(mesh, entry)
                 for n, entry in zip(shape, spec))


def block_index(mesh, entry: Entry) -> int:
    """This rank's block index along a dim split by ``entry``: its
    coordinates row-major over the entry's axes (the first major)."""
    index = 0
    for a in entry_axes(entry):
        index = index * mesh.shape[a] + mesh.axis_index(a)
    return index


def gather_data(mesh, spec: Spec, t: torch.Tensor) -> torch.Tensor:
    """``t`` (a block under ``spec``) with every dim split over the data
    axes all-gathered (FSDP: the parameter whole along them, still split
    over ``model``). Its gradient is the reduce-scatter: each rank keeps
    its block of the gradient summed over those axes."""
    daxes = data_axes(mesh)
    for dim, entry in enumerate(spec):
        for a in reversed([a for a in entry_axes(entry) if a in daxes]):
            t = gather_axis(mesh, a, t, dim=dim)
    return t


def whole_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's block under
    ``spec``: every split dim all-gathered over its axes, the minor axis
    first, a ``PartSpec``'s last dim joined part by part (a collective:
    every rank of the mesh calls it)."""
    with torch.no_grad():
        for dim, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                t = gather_axis(mesh, a, t, dim=dim)
        if parts_of(spec) is not None:
            t = join_parts(t, t.dim() - 1, spec.parts,
                           group_size(mesh, spec[-1]))
    return t


def _group(mesh, axes: Sequence[str]) -> int:
    g = 1
    for a in axes:
        g *= mesh.shape[a]
    return g


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry splits its dim over (major first)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def group_size(mesh, entry: Entry) -> int:
    """How many blocks a spec entry splits its dim into."""
    return _group(mesh, entry_axes(entry))


def local_block(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``: each
    sharded dim split into even blocks, the block index row-major over the
    entry's axes (the first major), as jax lays out a ``NamedSharding``.
    ``mesh`` gives this rank's coordinates (``axis_index``). A
    ``PartSpec``'s last dim is cut part by part (``cut_parts``)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} for a tensor of {t.dim()} dims")
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = _group(mesh, axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {axes} ({n})")
        t = cut_cols(t, dim, parts_of(spec) if dim == t.dim() - 1 else None,
                     n, block_index(mesh, entry))
    return t


# ------------------------------ activations -------------------------------

def _dp_entry(mesh, batch: int) -> Entry:
    axes = data_axes(mesh)
    group = _group(mesh, axes)
    if group <= 1 or batch % group != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def batch_spec(batch_size: int, mesh, dist: Optional[DistConfig] = None,
               extra_dims: int = 1) -> Spec:
    """Spec for [B, ...] token-level inputs: B over (pod, data) when they
    divide it, else replicated (e.g. a batch of one)."""
    return (_dp_entry(mesh, batch_size),) + (None,) * extra_dims


def cache_spec(cfg, batch_size: int, mesh,
               dist: Optional[DistConfig] = None,
               seq_len: Optional[int] = None) -> Dict[str, Spec]:
    """Specs for the decode cache: [L, B, S, KVH, hd] k/v (and the SSD's
    h, conv). B over (pod, data) when divisible, else the sequence dim
    takes them; the kv heads over model when divisible, else head_dim
    (with ``shard_head_dim_fallback``), else the sequence dim also takes
    model (minor axes dropped until ``seq_len`` divides)."""
    dist = dist or DistConfig()
    daxes = data_axes(mesh)
    dgroup = _group(mesh, daxes)
    b_ax = daxes if (dgroup > 1 and batch_size % dgroup == 0) else None
    s_axes = [] if b_ax is not None else list(daxes if dgroup > 1 else ())

    m = mesh.shape.get("model", 1)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    kv_ax = hd_ax = None
    if m > 1 and kvh and kvh % m == 0:
        kv_ax = "model"
    elif m > 1 and dist.shard_head_dim_fallback and hd and hd % m == 0:
        hd_ax = "model"
    elif m > 1:
        s_axes.append("model")

    if seq_len is not None:
        while s_axes and seq_len % _group(mesh, s_axes) != 0:
            s_axes = s_axes[:-1]

    def flat(ax) -> Entry:
        if not ax:
            return None
        ax = tuple(ax)
        return ax[0] if len(ax) == 1 else ax

    kv = (None, flat(b_ax), flat(s_axes), kv_ax, hd_ax)
    specs: Dict[str, Spec] = {key: kv for key in ("k", "v", "xk", "xv")}
    # ssm state [L, B, H, P, N]; conv [L, B, K-1, C]
    h_ax = "model" if ssd_heads_split(cfg, mesh) else None
    specs["h"] = (None, flat(b_ax), h_ax, None, None)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state if cfg.ssm_state else 0
    c_ax = "model" if (m > 1 and conv_dim and conv_dim % m == 0) else None
    specs["conv"] = (None, flat(b_ax), None, c_ax)
    return specs


def ssd_heads_split(cfg, mesh) -> bool:
    """Whether ``model`` splits the SSD's heads: the decode state ``h``
    by ``cache_spec``, and the placed layer's scan (``models/ssm.py``)."""
    m = mesh.shape.get("model", 1)
    return bool(m > 1 and cfg.ssm_state and cfg.ssm_heads % m == 0)


def token_act_spec(mesh, batch: int) -> Spec:
    """[B, S, D] activations: B over (pod, data) when divisible."""
    return (_dp_entry(mesh, batch), None, None)


def head_act_spec(mesh, batch: int, n_heads: int, head_dim: int,
                  dist: Optional[DistConfig] = None) -> Spec:
    """[B, S, H, hd]: heads over model when divisible; head_dim only when
    ``shard_head_dim_fallback`` allows it."""
    dist = dist or DistConfig()
    m = mesh.shape.get("model", 1)
    if m > 1 and n_heads % m == 0:
        h_ax, d_ax = "model", None
    elif m > 1 and head_dim % m == 0 and dist.shard_head_dim_fallback:
        h_ax, d_ax = None, "model"
    else:
        h_ax, d_ax = None, None
    return (_dp_entry(mesh, batch), None, h_ax, d_ax)


def ff_act_spec(mesh, batch: int, ff: int) -> Spec:
    """[B, S, F] MLP hidden: F over model when divisible."""
    m = mesh.shape.get("model", 1)
    f_ax = "model" if (m > 1 and ff % m == 0) else None
    return (_dp_entry(mesh, batch), None, f_ax)
