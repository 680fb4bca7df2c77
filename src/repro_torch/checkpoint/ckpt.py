"""npz checkpoints with JSON manifests.

Layout: <dir>/step_<N>/ {manifest.json, arrays.npz}. Writes go to a temp
dir and are atomically renamed — a crash mid-save never corrupts the
latest complete checkpoint. The reference (``repro/checkpoint/ckpt.py``)
writes a msgpack manifest and flattens JAX pytrees; the port takes a flat
``{name: numpy array}`` mapping and writes its manifest as JSON, so
``extra`` must be JSON-serialisable.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np


def save_checkpoint(directory: str, step: int, arrays: Mapping[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = {k: np.asarray(v) for k, v in arrays.items()}
    manifest = {
        "step": int(step),
        "keys": list(flat.keys()),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extra": extra or {},
    }
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
    """Returns (step, {name: array}, extra); the latest step by default."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in manifest["keys"]}
    return manifest["step"], flat, manifest["extra"]
