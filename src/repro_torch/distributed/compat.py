"""Process-group start-up: the port's counterpart of
``repro/distributed/compat.py``.

The reference's ``compat.py`` makes one collective API (``shard_map``)
work on the installed jax. Under PyTorch the collectives are
``torch.distributed``'s, and what has to be set up is the process group
each rank joins. The backend is the caller's choice, never found by
trying one and catching its error:

* ``"nccl"`` where every rank has a card of its own (a multi-card host:
  the collectives run on the cards). NCCL refuses two ranks on one
  device ("Duplicate GPU detected").
* ``"gloo"`` where ranks share one card, or run on the CPU. Ranks that
  share a card exchange their CUDA tensors through a host segment shared
  by each axis's ranks (``distributed/shm.py``); gloo itself carries the
  CPU tensors and each segment's set-up.
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def init_ranks(backend: str, init_method: str, rank: int, world_size: int,
               device: Optional[torch.device] = None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """Join the process group of ``world_size`` ranks as ``rank``.
    ``init_method`` is the rendezvous (``tcp://host:port`` or
    ``file:///path``); nothing tells a rank of a cluster otherwise.
    Under ``"nccl"``, ``device`` is this rank's own card and becomes the
    current device. ``timeout`` bounds each collective's wait (None:
    ``torch.distributed``'s default)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "nccl":
        if device is None or torch.device(device).type != "cuda":
            raise ValueError("nccl needs this rank's own CUDA device")
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)


def shutdown() -> None:
    """Leave the process group (and every group made from it), if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
