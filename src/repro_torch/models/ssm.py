"""Mamba-2 SSD (state-space duality) block: the chunked full-sequence
path and the O(1) recurrent decode step. Port of ``repro/models/ssm.py``
(arXiv:2405.21060 §6: intra-chunk quadratic form plus an inter-chunk
state recurrence).

Layout: d_inner = expand * d_model; H = d_inner / head_dim SSD heads;
one B/C group (n_groups = 1), state size N = ``cfg.ssm_state``.

The reference computes the SSD as jnp outside any Pallas kernel, and
this port computes it as torch tensor ops: the einsums are batched f32
products (cuBLAS on the card, with TF32 off, ``device.py``), the
``[B, nc, H, Q, Q]`` decay weights elementwise passes. Numerics follow
the reference: ``A_log``, ``dt_bias`` and ``D`` are float32 in any model
dtype; the conv sums its taps in f32, in tap order; the scan, its states
and the decode state ``h`` are f32; the output is cast to the model
dtype before the gated RMS norm. The intra-chunk mask clamps the
exponent (to -1e30), not the exponential, so the upper triangle is 0
and its gradient 0, never inf times 0.

Weights keep the reference's layouts (``in_proj [d, 2 di + 2 N + H]``
holding z, x, B, C, dt; ``conv_w [K, di + 2 N]``; ``out_proj [di, d]``),
so carrying them is a copy.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm

Params = Mapping[str, torch.Tensor]
State = Dict[str, torch.Tensor]

NEG_INF = -1e30
F32_PARAMS = ("A_log", "D", "dt_bias")   # float32 in any model dtype


def ssm_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        "in_proj": (d, 2 * di + 2 * n + nh),   # z, x, B, C, dt
        "conv_w": (cfg.ssm_conv, conv_dim),
        "conv_b": (conv_dim,),
        "A_log": (nh,),
        "D": (nh,),
        "dt_bias": (nh,),
        "ssm_norm": (di,),
        "out_proj": (di, d),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * n], \
        proj[..., 2 * di + 2 * n:]


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence, then SiLU: xbc [B, S, C],
    conv_w [K, C] -> [B, S, C] in xbc's dtype, the K taps summed in f32
    in tap order."""
    k, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    w = conv_w.float()
    out = pad[:, 0:s].float() * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s].float() * w[i]
    return F.silu(out + conv_b.float()).to(xbc.dtype)


def _dt(dt_raw: torch.Tensor, params: Params) -> torch.Tensor:
    """softplus(dt_raw + dt_bias), f32."""
    return F.softplus(dt_raw.float() + params["dt_bias"].float())


def _gate_out(y: torch.Tensor, z: torch.Tensor, params: Params,
              cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """y (f32) gated by SiLU(z), cast to ``dtype``, RMS-normed by
    ``ssm_norm`` and projected out."""
    y = y * F.silu(z.float())
    return rms_norm(y.to(dtype), params["ssm_norm"], cfg.norm_eps) \
        @ params["out_proj"]


def ssd_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Full-sequence SSD. x [B, S, d] -> [B, S, d] in x's dtype.

    With ``return_state`` also returns {"h": the final recurrent state
    [B, H, P, N] f32, "conv": the last K - 1 raw (pre-conv) conv inputs
    [B, K - 1, di + 2 N], left-padded with zeros when S < K - 1}, from
    which ``ssd_decode_step`` continues."""
    b, s0, _ = x.shape
    di, n, nh, p_dim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s0)
    pad = (-s0) % q
    s = s0 + pad
    nc = s // q

    z, xbc_raw, dt_raw = _split_proj(x @ params["in_proj"], cfg)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    dt = _dt(dt_raw, params)                                   # [B,S0,H]
    if pad:  # pad the tail after the conv; dt is 0 there, so state and
        # outputs are unaffected
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    A = -torch.exp(params["A_log"].float())                    # [H]

    # chunk views, heads ahead of positions: [B, nc, H, Q(, P)]
    xs = xbc[..., :di].float().reshape(b, nc, q, nh, p_dim) \
        .permute(0, 1, 3, 2, 4)
    B_c = xbc[..., di:di + n].float().reshape(b, nc, q, n)
    C_c = xbc[..., di + n:].float().reshape(b, nc, q, n)
    dt_c = dt.reshape(b, nc, q, nh).transpose(2, 3)            # [B,nc,H,Q]
    cum = torch.cumsum(dt_c * A[:, None], dim=-1)              # [B,nc,H,Q]

    # ---- intra-chunk (quadratic within a chunk) ----------------------
    # L[i, j] = exp(cum[i] - cum[j]) for i >= j, the exponent clamped to
    # -1e30 above the diagonal (never the exponential: its gradient
    # would be inf * 0 there)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]               # [B,nc,H,Q,Q]
    L = torch.exp(diff.masked_fill(~tri, NEG_INF))
    cb = C_c @ B_c.transpose(-1, -2)                           # [B,nc,Q,Q]
    w = cb[:, :, None] * L * dt_c[:, :, :, None, :]
    y = w @ xs                                                 # [B,nc,H,Q,P]

    # ---- chunk states and the inter-chunk recurrence -----------------
    seg = torch.exp(cum[..., -1:] - cum) * dt_c                # [B,nc,H,Q]
    states = (xs * seg[..., None]).transpose(-1, -2) \
        @ B_c[:, :, None]                                      # [B,nc,H,P,N]
    decay = torch.exp(cum[..., -1])                            # [B,nc,H]
    h = torch.zeros((b, nh, p_dim, n), dtype=torch.float32,
                    device=x.device)
    h_prev = []
    for c in range(nc):   # the state entering each chunk
        h_prev.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # [B,nc,H,P,N]

    y = y + (C_c[:, :, None] @ h_prev.transpose(-1, -2)) \
        * torch.exp(cum)[..., None]
    y = y + params["D"].float()[:, None, None] * xs
    y = y.permute(0, 1, 3, 2, 4).reshape(b, s, di)[:, :s0]
    out = _gate_out(y, z, params, cfg, x.dtype)
    if not return_state:
        return out
    k = cfg.ssm_conv
    conv = xbc_raw[:, s0 - (k - 1):] if s0 >= k - 1 \
        else F.pad(xbc_raw, (0, 0, k - 1 - s0, 0))
    return out, {"h": h, "conv": conv}


def ssm_cache_shapes(cfg: ModelConfig, batch: int
                     ) -> Dict[str, Tuple[int, ...]]:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "h": (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv": (batch, cfg.ssm_conv - 1, conv_dim),
    }


def ssd_decode_step(params: Params, x: torch.Tensor, cache: State,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """One-token recurrent update. x [B, 1, d]; ``cache`` as
    ``ssm_cache_shapes``. Returns (y [B, 1, d], the new cache: ``h`` in
    the cache's dtype, ``conv`` in the conv cache's); the cache passed in
    is not written."""
    b = x.shape[0]
    di, n, nh, p_dim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim

    z, xbc, dt_raw = _split_proj(x[:, 0] @ params["in_proj"], cfg)
    # the conv over the window [cache ; new row]
    win = torch.cat([cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)],
                    dim=1)                                     # [B,K,C]
    conv = (win.float() * params["conv_w"].float()).sum(1)
    conv = F.silu(conv + params["conv_b"].float())
    xs = conv[:, :di].reshape(b, nh, p_dim)
    B = conv[:, di:di + n]
    C = conv[:, di + n:]

    dt = _dt(dt_raw, params)                                   # [B,H]
    decay = torch.exp(dt * -torch.exp(params["A_log"].float()))
    h = cache["h"].float() * decay[:, :, None, None] \
        + (dt[:, :, None] * xs)[..., None] * B[:, None, None, :]
    y = (h @ C[:, None, :, None])[..., 0] \
        + params["D"].float()[None, :, None] * xs              # [B,H,P]
    y = _gate_out(y.reshape(b, 1, di), z[:, None], params, cfg, x.dtype)
    return y, {"h": h.to(cache["h"].dtype), "conv": win[:, 1:]}


class SSM(nn.Module):
    """One SSD layer's weights (``ssm_param_shapes``; ``A_log``, ``D`` and
    ``dt_bias`` in float32, the rest in the model dtype), its
    full-sequence forward and its decode step."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        for name, shape in ssm_param_shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, device=device,
                            dtype=torch.float32 if name in F32_PARAMS
                            else dtype),
                requires_grad=False))

    def forward(self, x: torch.Tensor, return_state: bool = False):
        return ssd_forward(dict(self.named_parameters()), x, self.cfg,
                           return_state)

    def decode(self, x: torch.Tensor, cache: State
               ) -> Tuple[torch.Tensor, State]:
        return ssd_decode_step(dict(self.named_parameters()), x, cache,
                               self.cfg)


@torch.no_grad()
def init_ssm(ssm: SSM, gen: torch.Generator) -> None:
    """The reference's ``init_ssm``, drawn from ``gen``: A = exp(A_log)
    uniform in [1, 16); dt_bias the softplus inverse of a dt uniform in
    [1e-3, 1e-1]; D ones; ``conv_b`` and ``ssm_norm`` zeros; the
    projections and the conv fan-in normal along their first axis."""
    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=gen.device) \
            * (hi - lo) + lo
    for name, w in ssm.named_parameters():
        if name == "A_log":
            w.copy_(torch.log(uniform(w.shape, 1.0, 16.0)))
        elif name == "dt_bias":
            dt = uniform(w.shape, 1e-3, 1e-1)
            w.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif name == "D":
            w.fill_(1.0)
        elif name in ("conv_b", "ssm_norm"):
            w.zero_()
        else:
            w.copy_(dense_init(gen, w.shape, 0, w.dtype))
