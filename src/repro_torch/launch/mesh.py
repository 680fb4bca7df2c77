"""Mesh construction over ``torch.distributed`` ranks (port of
``repro/launch/mesh.py``).

A ``Mesh`` names the axes of the world's ranks, laid out row-major over
``axis_names``: the order in which ``jax.make_mesh`` lays out devices and
in which ``core/distributed.py`` linearises a rank's coordinates, so the
global row ids of a sharded database depend on it. Each axis has one
process group per line of ranks that differ only along that axis; a
rank keeps the group of its own line. The process group must be up
(``repro_torch.distributed.compat.init_ranks``) before a mesh is made.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Tuple[int, ...]             # this rank's index along each axis
    groups: Dict[str, dist.ProcessGroup]  # this rank's line of each axis
    # each axis's shared host segment, made by core/distributed.py on the
    # axis's first exchange of a CUDA tensor under gloo
    segments: Dict[str, object] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, like ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The world's ranks as a row-major mesh. Every rank must call this
    with the same arguments: each one creates every axis group, in the
    same order, those it is not in included, as ``dist.new_group``
    requires."""
    axis_sizes, axis_names = tuple(axis_sizes), tuple(axis_names)
    world = _world_size()
    if math.prod(axis_sizes) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, axis_sizes))} needs "
                         f"{math.prod(axis_sizes)} ranks, the world has "
                         f"{world}")
    rank = dist.get_rank()
    # row-major: the last axis varies fastest
    grid = np.arange(world).reshape(axis_sizes)
    coords = tuple(int(c) for c in np.unravel_index(rank, axis_sizes))
    groups = {}
    for a, name in enumerate(axis_names):
        for line in np.moveaxis(grid, a, -1).reshape(-1, axis_sizes[a]):
            group = dist.new_group(line.tolist())
            if rank in line:
                groups[name] = group
    return Mesh(axis_names, axis_sizes, coords, groups)


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "distributed.compat.init_ranks first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks);
    raises for a world of any other size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh(model_axis: int = 1) -> Mesh:
    """(data, model) mesh over whatever ranks the world has."""
    n = _world_size()
    if n % model_axis:
        raise ValueError(f"a world of {n} ranks has no model axis of "
                         f"{model_axis}")
    return make_mesh((n // model_axis, model_axis), ("data", "model"))


def data_axes(mesh: Mesh) -> tuple:
    """Mesh axes that act as data parallelism (pod folds into data)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a == "model")
