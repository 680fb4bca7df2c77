"""npz checkpoints with JSON manifests.

Layout: <dir>/step_<N>/ {manifest.json, arrays.npz}. Writes go to a temp
dir and are atomically renamed — a crash mid-save never corrupts the
latest complete checkpoint. As the reference (``repro/checkpoint/ckpt.py``)
does, a tree of nested dicts (model parameters by name, or an optimizer
state ``{"step", "m", "v"}`` with factored ``{"row", "col"}`` leaves) is
flattened into keys joined with ``/``, and bfloat16, which numpy lacks, is
stored as a ``uint16`` view tagged ``"bfloat16"`` in the manifest and
read back as ``torch.bfloat16``. The reference writes a msgpack manifest;
the port writes JSON, so ``extra`` must be JSON-serialisable.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            flat.update(_flatten(val, f"{prefix}{key}/"))
        else:
            flat[prefix + str(key)] = val
    return flat


def _to_numpy(v) -> Tuple[np.ndarray, str]:
    """(array to store, dtype tag): a bf16 tensor as its uint16 bits."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.uint16).numpy(), "bfloat16"
        v = v.numpy()
    arr = np.asarray(v)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, tag: str):
    if tag == "bfloat16":
        return torch.from_numpy(np.array(arr)).view(torch.bfloat16)
    return arr


def save_checkpoint(directory: str, step: int, tree: Mapping[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Save a (nested) dict of tensors or arrays as step ``step``."""
    os.makedirs(directory, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    manifest = {
        "step": int(step),
        "keys": list(arrays.keys()),
        "dtypes": dtypes,
        "extra": extra or {},
    }
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
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


Cut = Optional[Callable[[str, torch.Tensor], torch.Tensor]]


def _restore(like: Mapping[str, Any], flat: Dict[str, Any],
             prefix: str = "", cut: Cut = None) -> Dict[str, Any]:
    """``like``'s nesting filled from ``flat``; a tensor leaf of ``like``
    gives its device (and dtype, which the stored one must equal);
    ``cut(key, stored)``: the part of the stored tensor the leaf holds."""
    out = {}
    for key, ref in like.items():
        name = prefix + str(key)
        if isinstance(ref, Mapping):
            out[key] = _restore(ref, flat, name + "/", cut)
            continue
        val = flat[name]
        if isinstance(ref, torch.Tensor):
            val = torch.as_tensor(val)
            if cut is not None:
                val = cut(name, val)
            if val.dtype != ref.dtype or val.shape != ref.shape:
                raise ValueError(f"checkpoint {name}: {val.dtype} "
                                 f"{tuple(val.shape)}, the tree holds "
                                 f"{ref.dtype} {tuple(ref.shape)}")
            val = val.to(ref.device)
        out[key] = val
    return out


def load_checkpoint(directory: str, step: Optional[int] = None,
                    like: Optional[Mapping[str, Any]] = None, cut: Cut = None
                    ) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """Returns (step, tree, extra); the latest step by default. Without
    ``like`` the tree is the flat ``{key: array}`` dict (bf16 entries as
    ``torch.bfloat16`` tensors); with it, a dict nested as ``like`` whose
    tensor leaves come back as tensors on ``like``'s devices, each
    ``cut(key, stored)`` where given (a rank's block of a whole tensor,
    keys joined with ``/``). Raises if the keys differ from ``like``'s."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: _from_numpy(z[k], manifest["dtypes"][k])
                for k in manifest["keys"]}
    if like is None:
        return manifest["step"], flat, manifest["extra"]
    want = set(_flatten(like))
    if want != set(flat):
        raise ValueError(f"checkpoint/tree mismatch: {sorted(want ^ set(flat))}")
    return manifest["step"], _restore(like, flat, cut=cut), manifest["extra"]
