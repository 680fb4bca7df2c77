"""Device selection and float32 policy for the port.

Distances are compared against the float32 reference, so TF32 is switched
off for matrix products and convolutions when this module is imported:
TF32 keeps about three decimal digits and would break distance parity
(and the tie order of near-equal candidates).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is asked for (or
    defaulted to) and missing: the port never falls back to the CPU on
    its own; callers that want the CPU pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
