"""Index persistence + the disaggregated-serving view of a PAG.

The in-memory half (agg points, PG, radii, partition map) checkpoints via
the port's checkpoint module (atomic-rename crash safety, JSON manifest);
residual partitions live in the ObjectStore. A restarted serving node
needs only the checkpoint — no residual reload — which is the paper's
failover argument (§I: shared storage removes index-copy reload from
recovery).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.pag import PAG


def save_index(directory: str, pag: PAG, step: int = 0,
               extra: Optional[Dict] = None) -> str:
    return save_checkpoint(directory, step, pag.arrays(),
                           extra={"build_stats": pag.build_stats,
                                  **(extra or {})})


def load_index(directory: str, step: Optional[int] = None) -> PAG:
    _, flat, extra = load_checkpoint(directory, step)
    pag = PAG.from_arrays(flat)
    pag.build_stats = extra.get("build_stats", {})
    return pag
