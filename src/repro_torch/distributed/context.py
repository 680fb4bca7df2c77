"""Ambient mesh context: port of ``repro/distributed/context.py``.

Model code reads the mesh it runs under here (``get_mesh``), so that a
layer can take its distributed path (the MoE layer's expert parallelism,
``models/moe.py``) without a mesh threaded through every signature.
Launch code sets it (``mesh_context``); on one device it stays unset.

A layer built under the context holds only this rank's block of its
sharded weights, and must run under the same context.

Each rank holds its block of the batch (``sharding.batch_spec``: the
whole batch where the data axes do not divide it), whereas the
reference's model sees the whole batch. Where a result depends on the
whole batch's size (the MoE layer's capacities, the train step's
microbatches), the code that lays the batch out gives that size to the
context (``batch``) and the code that needs it reads it
(``whole_batch``).

The reference's ``constrain_tokens`` / ``constrain_heads`` /
``constrain_ff`` are not ported: they tell XLA's partitioner where
activations should live and change no value. The port has no
partitioner; each rank computes on the blocks it holds, laid out as
those hints say (``models/model.py``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

from repro_torch.distributed.sharding import DistConfig
from repro_torch.launch.mesh import Mesh, data_axes

_STATE: dict = {"mesh": None, "dist": None, "batch": None}


def set_mesh(mesh: Optional[Mesh], dist: Optional[DistConfig] = None,
             batch: Optional[int] = None):
    """``batch``: the whole batch's size, of which the ranks hold blocks
    (None: not given)."""
    _STATE["mesh"] = mesh
    _STATE["dist"] = dist or (DistConfig() if mesh is not None else None)
    _STATE["batch"] = batch if mesh is not None else None


def get_mesh() -> Tuple[Optional[Mesh], Optional[DistConfig]]:
    return _STATE["mesh"], _STATE["dist"]


def get_batch() -> Optional[int]:
    return _STATE["batch"]


def whole_batch(mesh: Mesh, b_loc: int) -> Tuple[int, int]:
    """(the whole batch's size B, the data ranks dp) for a rank holding
    ``b_loc`` rows under ``mesh``: B is the ambient context's
    (``mesh_context(..., batch=B)``). Under data parallelism this raises
    without it, as a rank's block does not tell a block of a larger batch
    from a whole replicated one, and raises where ``b_loc`` rows do not
    lay out B (its ``batch_spec`` block, or all of it where the data axes
    do not divide it)."""
    dp = 1
    for a in data_axes(mesh):
        dp *= mesh.shape[a]
    b = get_batch()
    if b is None:
        if dp > 1:
            raise ValueError(f"a block of a batch over {dp} data ranks "
                             f"needs the whole batch's size: "
                             f"mesh_context(..., batch=B)")
        b = b_loc
    if b_loc != (b // dp if b % dp == 0 else b):
        raise ValueError(f"{b_loc} rows a rank do not lay out a batch of {b}"
                         f" over {dp} data ranks")
    return b, dp


@contextlib.contextmanager
def mesh_context(mesh: Mesh, dist: Optional[DistConfig] = None,
                 batch: Optional[int] = None):
    prev = dict(_STATE)
    set_mesh(mesh, dist, batch)
    try:
        yield
    finally:
        _STATE.update(prev)
