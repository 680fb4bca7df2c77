"""Shared layer primitives: RMS and layer norms, rotary and sinusoidal
position embeddings, the f32 softmax, init helpers, and ``Placed``, the
base of a module whose weights a rank may hold as blocks.

Ports of ``repro/models/layers.py``. Norms and rotary embeddings compute
in float32 and cast back to the input's dtype, as the reference does.
Initialisers draw from an explicit ``torch.Generator``: the numbers
differ from ``jax.random``'s, so the tests carry the reference's weights
across (``repro_torch.carry.lm_params_from_arrays``) instead.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core.distributed import copy_over, sum_over
from repro_torch.distributed import sharding


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             split: Optional[Tuple[object, Sequence[str]]] = None
             ) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)``: the scale is stored around zero.

    ``split`` = (mesh, axes): ``x`` and ``scale`` hold this rank's block of
    the normed (last) dim, split over ``axes``; the sum of squares is
    summed over them (``sum_over``) and, since each rank scales its own
    block by the total, its gradient too (``copy_over``)."""
    dtype = x.dtype
    x = x.float()
    if split is None:
        var = x.square().mean(-1, keepdim=True)
    else:
        mesh, axes = split
        n = x.shape[-1] * math.prod(mesh.shape[a] for a in axes)
        ss = x.square().sum(-1, keepdim=True)
        var = copy_over(mesh, axes, sum_over(mesh, axes, ss)) / n
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) / std * (1 + scale) + bias`` in float32, cast back."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float()) + bias.float()).to(dtype)


def softmax_fp32(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax in float32, as the reference writes it: shift by the max
    (outside the gradient), exponentiate, divide by the sum."""
    s = scores.float()
    s = s - s.amax(dim, keepdim=True).detach()
    e = torch.exp(s)
    return e / e.sum(dim, keepdim=True)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...]; returns cos/sin [..., head_dim // 2] in float32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, n, head_dim]; cos/sin [..., S, head_dim // 2]. Rotates
    the two halves of each head (not interleaved pairs)."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def sinusoidal_embedding(length: int, dim: int) -> np.ndarray:
    """[length, dim] float32: the sines of position / 10000^(2i / dim) for
    i < dim / 2, then their cosines; computed in float64 and rounded once,
    as the reference computes it, so the tables are equal bit for bit."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return emb.astype(np.float32)


def dense_init(gen: torch.Generator, shape: Sequence[int],
               in_axis: Union[int, Tuple[int, ...]] = 0,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Normal with std 1/sqrt(fan_in), fan-in along ``in_axis`` (an axis or
    a tuple of axes), drawn in float32 on ``gen``'s device."""
    axes = (in_axis,) if isinstance(in_axis, int) else in_axis
    fan_in = int(np.prod([shape[a] for a in axes]))
    std = 1.0 / np.sqrt(max(fan_in, 1))
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * 0.02).to(dtype)


class Placed(nn.Module):
    """A module whose parameters a model built under a mesh may hold as
    blocks: ``specs`` names them ({name: spec}, ``distributed.sharding``'s
    tuples; empty: every parameter whole) and ``mesh`` is that mesh."""
    specs: Dict[str, sharding.Spec] = {}
    mesh = None

    def weight(self, name: str) -> torch.Tensor:
        """The parameter ``name`` with every dim the data axes split
        gathered (FSDP; its gradient reduce-scattered back), still split
        over ``model`` where its spec says so."""
        p = getattr(self, name)
        spec = self.specs.get(name)
        return p if spec is None else sharding.gather_data(self.mesh, spec,
                                                           p)

    def split(self, name: str, dim: int) -> bool:
        """Whether the ``model`` axis splits ``dim`` of ``name``."""
        spec = self.specs.get(name)
        return spec is not None and "model" in sharding.entry_axes(spec[dim])

    def model_index(self) -> int:
        return self.mesh.axis_index("model")

    @torch.no_grad()
    def fill(self, name: str,
             draw: Callable[[Tuple[int, ...]], torch.Tensor]) -> None:
        """Write ``draw(whole shape)`` into the parameter ``name``: its
        block of it where the rank holds a block, so a placed model holds
        the unsharded model's weights for the same draws."""
        p = getattr(self, name)
        spec = self.specs.get(name)
        if spec is None:
            p.copy_(draw(tuple(p.shape)))
            return
        whole = draw(sharding.whole_shape(p.shape, spec, self.mesh))
        p.copy_(sharding.local_block(whole, spec, self.mesh))
