"""Carry an index built elsewhere into the port.

``PAG.arrays()`` is a plain dict of numpy arrays and a store's objects are
numpy arrays, so an index and its partition objects built by the
reference package (or saved from an earlier run) load here unchanged:

    pag = pag_from_arrays(ref_pag.arrays())
    store = store_from_objects(ref_store._data, StorageConfig.preset("mem"))
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.pag import PAG
from repro_torch.storage.simulator import ObjectStore, StorageConfig


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
