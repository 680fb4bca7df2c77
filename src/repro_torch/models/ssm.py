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

Built under a mesh (``models/model.py:place``) the layer holds its
``param_specs`` blocks and runs on them (``Split``). A concatenated leaf
(``in_proj``: z, x, B, C, dt; ``conv_w``/``conv_b``: x, B, C) is held per
part where every part divides ``model`` (``sharding.PartSpec``), as the
reference's contiguous block where only the whole leaf does, and whole
where it does not divide. Three facts, each read from the specs, set the
layer's work: how ``in_proj``'s output columns are held (per part,
contiguous or whole), how the conv's channels are (the same three), and
whether the SSD heads (and so ``h``) are split. One rule sets every
backward: a value every rank computes whole and alike has the same
gradient on every rank, and the gradient is summed over ``model`` once,
where the ranks' work first differs (``copy_over``); a value gathered
whole that every rank then uses alike keeps only its own block of the
gradient (``gather_own``).

1. ``in_proj`` per part (its parts, and so the heads, divide ``model``;
   mamba2-370m on 2, 4, 8, 16, 32): column-parallel, its input read
   through ``copy_over``; the conv runs on the rank's channels of each
   part; the one B/C group is all-gathered over ``model`` after it
   (``gather_axis``: each rank's heads use B and C, so the gradient is
   reduce-scattered); the SSD runs on the rank's heads.
2. ``in_proj`` contiguous (hymba-1.5b on 7 and 14): column-parallel on
   the rank's run of columns, its input read through ``copy_over``, its
   output gathered whole (``gather_own``); from there every rank holds
   z, x, B, C and dt whole and alike, as with ``in_proj`` whole.
3. The conv split where ``in_proj``'s output is whole (per part:
   hymba-1.5b on 2 and 4; contiguous: mamba2-370m on 3, 6, 9 and 12):
   the conv runs on the rank's channels of the whole raw xBC (read
   through ``copy_over``: there the ranks' work first differs) and its
   output is gathered whole (``gather_own``); else every rank runs the
   whole conv alike.
4. The heads split where ``in_proj``'s output is whole (hymba-1.5b on 5
   and 10: 50 heads, ``in_proj`` 6482 and conv 3232 columns): z, the
   conv's whole output and dt, whole and alike, are read through
   ``copy_over`` and cut to the rank's heads (z, x, dt; B and C whole);
   the SSD runs on the rank's heads.

Where the heads are split (1, 4), ``A_log``, ``D`` and ``dt_bias`` (whole)
are read through ``copy_over`` and sliced to the rank's heads, and the
gated RMS norm over the rank's ``d_inner`` channels sums its split sum of
squares over ``model`` (``rms_norm(..., split=)``: each rank scales its
channels by the total, so its backward sums too). Where they are whole,
the SSD, the gate and the norm's statistic run on every head alike, and
where ``ssm_norm``'s rows split the ranks differ where each takes its
``d_inner`` rows of the normed output (read through ``copy_over``).
Either way a split ``out_proj`` is row-parallel and summed over
``model``.

The decode cache follows ``sharding.cache_spec``: ``h`` holds the rank's
heads where they divide ``model`` (else all of them, alike), ``conv`` the
raw conv inputs of the rank's channels as the conv's weights hold them
(per part, contiguous, or whole and alike).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import (
    copy_over,
    gather_axis,
    gather_own,
    sum_over,
)
from repro_torch.distributed.sharding import (
    LEAF_PARTS,
    cut_cols,
    join_parts,
    parts_of,
    ssd_heads_split,
)
from repro_torch.models.layers import Placed, dense_init, rms_norm

Params = Mapping[str, torch.Tensor]
State = Dict[str, torch.Tensor]

NEG_INF = -1e30
F32_PARAMS = ("A_log", "D", "dt_bias")   # float32 in any model dtype
MODEL = ("model",)


PART, BLOCK = "part", "block"   # a leaf's columns per part, contiguous


@dataclasses.dataclass(frozen=True)
class Split:
    """How a placed SSD layer's work is split over ``model`` (``m`` ranks,
    this one ``index``): ``proj`` and ``conv`` say how ``in_proj``'s
    output columns and the conv's channels are held (``PART``: the rank's
    block of each part; ``BLOCK``: its contiguous block, the reference's;
    None: whole), ``heads`` whether the SSD heads (and ``h``) are split,
    ``rows`` whether ``ssm_norm`` and ``out_proj``'s ``d_inner`` rows
    are."""
    mesh: object
    m: int
    index: int
    proj: Optional[str]
    conv: Optional[str]
    heads: bool
    rows: bool

    def local(self, n: int) -> int:
        """A width ``n`` split over ``model`` where the heads are."""
        return n // self.m if self.heads else n


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


def _split_proj(proj: torch.Tensor, di: int, n: int):
    """z, xBC and dt of ``in_proj``'s output (``di``, ``n``: the widths
    of its x and of its B and C parts)."""
    return proj[..., :di], proj[..., di:2 * di + 2 * n], \
        proj[..., 2 * di + 2 * n:]


def _project(x: torch.Tensor, params: Params, cfg: ModelConfig,
             sp: Optional[Split]):
    """z, raw xBC and dt: the rank's block of each part where ``in_proj``
    is held per part (its input read through ``copy_over``), else whole
    and alike on every rank (a contiguous ``in_proj`` column-parallel,
    its input read through ``copy_over``, its output gathered whole with
    ``gather_own``)."""
    if sp is not None and sp.proj is not None:
        x = copy_over(sp.mesh, MODEL, x)
    proj = x @ params["in_proj"]
    if sp is not None and sp.proj == PART:
        return _split_proj(proj, sp.local(cfg.d_inner),
                           sp.local(cfg.ssm_state))
    if sp is not None and sp.proj == BLOCK:
        proj = gather_own(sp.mesh, "model", proj, -1)
    return _split_proj(proj, cfg.d_inner, cfg.ssm_state)


def _mine(xbc: torch.Tensor, cfg: ModelConfig, sp: Optional[Split]):
    """The raw xBC of the rank's conv channels: where ``in_proj``'s output
    is whole and the conv split, the rank's channels of it (read through
    ``copy_over``, since each rank's conv uses only its channels); else
    ``xbc``."""
    if sp is None or sp.proj == PART or sp.conv is None:
        return xbc
    parts = LEAF_PARTS["conv"](cfg) if sp.conv == PART else None
    return cut_cols(copy_over(sp.mesh, MODEL, xbc), -1, parts, sp.m,
                    sp.index)


def _after_conv(xbc: torch.Tensor, cfg: ModelConfig, sp: Optional[Split]):
    """The conv's output on the rank's channels -> (x of the rank's heads,
    the whole B, the whole C): with ``in_proj`` per part B and C are
    gathered over ``model`` (reduce-scattered back); else a split conv's
    output is gathered whole (``gather_own``), and where the heads split
    the whole output is read through ``copy_over`` (there the ranks' work
    first differs) and its x cut to the rank's heads."""
    di, n = cfg.d_inner, cfg.ssm_state
    if sp is not None and sp.proj == PART:
        dl = di // sp.m
        bc = join_parts(gather_axis(sp.mesh, "model", xbc[..., dl:], -1),
                        -1, (n, n), sp.m)
        return xbc[..., :dl], bc[..., :n], bc[..., n:]
    if sp is not None and sp.conv is not None:
        xbc = gather_own(sp.mesh, "model", xbc, -1)
        if sp.conv == PART:
            xbc = join_parts(xbc, -1, LEAF_PARTS["conv"](cfg), sp.m)
    x0, x1 = 0, di
    if sp is not None and sp.heads:
        xbc = copy_over(sp.mesh, MODEL, xbc)
        x0, x1 = sp.index * di // sp.m, (sp.index + 1) * di // sp.m
    return xbc[..., x0:x1], xbc[..., di:di + n], xbc[..., di + n:]


def _own_heads(z: torch.Tensor, dt_raw: torch.Tensor, cfg: ModelConfig,
               sp: Optional[Split]):
    """z and dt of the rank's heads where the heads are split but
    ``in_proj``'s output is whole: each read through ``copy_over`` and
    cut; else as they are."""
    if sp is None or not sp.heads or sp.proj == PART:
        return z, dt_raw
    dl, hl = cfg.d_inner // sp.m, cfg.ssm_heads // sp.m
    return tuple(copy_over(sp.mesh, MODEL, t).narrow(-1, sp.index * w, w)
                 for t, w in ((z, dl), (dt_raw, hl)))


def _heads(params: Params, name: str, sp: Optional[Split]) -> torch.Tensor:
    """A whole per-head parameter; where the heads are split, read through
    ``copy_over`` (its gradient summed) and sliced to the rank's heads."""
    t = params[name]
    if sp is None or not sp.heads:
        return t
    n = t.shape[0] // sp.m
    return copy_over(sp.mesh, MODEL, t).narrow(0, sp.index * n, n)


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


def _dt(dt_raw: torch.Tensor, params: Params,
        sp: Optional[Split] = None) -> torch.Tensor:
    """softplus(dt_raw + dt_bias), f32."""
    return F.softplus(dt_raw.float() + _heads(params, "dt_bias", sp).float())


def _gate_out(y: torch.Tensor, z: torch.Tensor, params: Params,
              cfg: ModelConfig, dtype: torch.dtype,
              sp: Optional[Split] = None) -> torch.Tensor:
    """y (f32) gated by SiLU(z), cast to ``dtype``, RMS-normed by
    ``ssm_norm`` and projected out. Heads split: y and z are the rank's
    channels (the norm's statistic summed over ``model``); heads whole and
    rows split: whole, the rank's rows of the normed output taken; either
    way the row-parallel product is summed over ``model``."""
    y = (y * F.silu(z.float())).to(dtype)
    if sp is None or not sp.rows:
        return rms_norm(y, params["ssm_norm"], cfg.norm_eps) \
            @ params["out_proj"]
    if sp.heads:
        y = rms_norm(y, params["ssm_norm"], cfg.norm_eps,
                     split=(sp.mesh, MODEL))
    else:
        yf = y.float()
        normed = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True)
                                  + cfg.norm_eps)
        n = normed.shape[-1] // sp.m
        normed = copy_over(sp.mesh, MODEL, normed).narrow(-1, sp.index * n,
                                                          n)
        y = (normed * (1.0 + params["ssm_norm"].float())).to(dtype)
    return sum_over(sp.mesh, MODEL, y @ params["out_proj"])


def ssd_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False, sp: Optional[Split] = None):
    """Full-sequence SSD. x [B, S, d] -> [B, S, d] in x's dtype.

    With ``return_state`` also returns {"h": the final recurrent state
    [B, H, P, N] f32, "conv": the last K - 1 raw (pre-conv) conv inputs
    [B, K - 1, di + 2 N], left-padded with zeros when S < K - 1}, from
    which ``ssd_decode_step`` continues. With ``sp`` (a placed layer's
    ``Split``), ``params`` are the rank's blocks and the state its
    ``cache_spec`` block (the module docstring's cases)."""
    b, s0, _ = x.shape
    n, p_dim = cfg.ssm_state, cfg.ssm_head_dim
    di = sp.local(cfg.d_inner) if sp else cfg.d_inner
    nh = sp.local(cfg.ssm_heads) if sp else cfg.ssm_heads
    q = min(cfg.ssm_chunk, s0)
    pad = (-s0) % q
    s = s0 + pad
    nc = s // q

    z, xbc_raw, dt_raw = _project(x, params, cfg, sp)
    xbc_raw = _mine(xbc_raw, cfg, sp)
    xs, B, C = _after_conv(
        _causal_conv(xbc_raw, params["conv_w"], params["conv_b"]), cfg, sp)
    z, dt_raw = _own_heads(z, dt_raw, cfg, sp)
    dt = _dt(dt_raw, params, sp)                               # [B,S0,H]
    if pad:  # pad the tail after the conv; dt is 0 there, so state and
        # outputs are unaffected
        xs, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (xs, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    A = -torch.exp(_heads(params, "A_log", sp).float())        # [H]

    # chunk views, heads ahead of positions: [B, nc, H, Q(, P)]
    xs = xs.float().reshape(b, nc, q, nh, p_dim).permute(0, 1, 3, 2, 4)
    B_c = B.float().reshape(b, nc, q, n)
    C_c = C.float().reshape(b, nc, q, n)
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
    y = y + _heads(params, "D", sp).float()[:, None, None] * xs
    y = y.permute(0, 1, 3, 2, 4).reshape(b, s, di)[:, :s0]
    out = _gate_out(y, z, params, cfg, x.dtype, sp)
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
                    cfg: ModelConfig, sp: Optional[Split] = None
                    ) -> Tuple[torch.Tensor, State]:
    """One-token recurrent update. x [B, 1, d]; ``cache`` as
    ``ssm_cache_shapes`` (with ``sp``, its ``cache_spec`` block). Returns
    (y [B, 1, d], the new cache: ``h`` in the cache's dtype, ``conv`` in
    the conv cache's); the cache passed in is not written."""
    b = x.shape[0]
    n, p_dim = cfg.ssm_state, cfg.ssm_head_dim
    di = sp.local(cfg.d_inner) if sp else cfg.d_inner
    nh = sp.local(cfg.ssm_heads) if sp else cfg.ssm_heads

    z, xbc, dt_raw = _project(x[:, 0], params, cfg, sp)
    # the conv over the window [cache ; new row]
    xbc = _mine(xbc, cfg, sp)
    win = torch.cat([cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)],
                    dim=1)                                     # [B,K,C]
    conv = (win.float() * params["conv_w"].float()).sum(1)
    conv = F.silu(conv + params["conv_b"].float())
    xs, B, C = _after_conv(conv, cfg, sp)
    z, dt_raw = _own_heads(z, dt_raw, cfg, sp)
    xs = xs.reshape(b, nh, p_dim)

    dt = _dt(dt_raw, params, sp)                               # [B,H]
    decay = torch.exp(dt * -torch.exp(_heads(params, "A_log", sp).float()))
    h = cache["h"].float() * decay[:, :, None, None] \
        + (dt[:, :, None] * xs)[..., None] * B[:, None, None, :]
    y = (h @ C[:, None, :, None])[..., 0] \
        + _heads(params, "D", sp).float()[None, :, None] * xs  # [B,H,P]
    y = _gate_out(y.reshape(b, 1, di), z[:, None], params, cfg, x.dtype, sp)
    return y, {"h": h.to(cache["h"].dtype), "conv": win[:, 1:]}


class SSM(Placed):
    """One SSD layer's weights (``ssm_param_shapes``; ``A_log``, ``D`` and
    ``dt_bias`` in float32, the rest in the model dtype), its
    full-sequence forward and its decode step. Placed under a mesh, the
    rank's blocks (``in_proj``'s and the conv's per part), ``d`` over the
    data axes gathered before use (``Placed.weight``), run as
    ``split_of`` says."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        for name, shape in ssm_param_shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, device=device,
                            dtype=torch.float32 if name in F32_PARAMS
                            else dtype),
                requires_grad=False))

    def split_of(self) -> Optional[Split]:
        """This layer's ``Split`` over ``model``, or None where nothing is
        split over it: ``in_proj``'s and the conv's cuts as their specs
        give them, the heads as ``sharding.ssd_heads_split`` says (the
        decode state's ``cache_spec``)."""
        proj, conv = self._cut("in_proj"), self._cut("conv_w")
        heads = self.mesh is not None and ssd_heads_split(self.cfg,
                                                          self.mesh)
        rows = self.split("ssm_norm", 0)
        if not (proj or conv or heads or rows):
            return None
        return Split(self.mesh, self.mesh.shape["model"], self.model_index(),
                     proj, conv, heads, rows)

    def _cut(self, name: str) -> Optional[str]:
        """How the rank holds the last dim of the concatenated leaf
        ``name``: ``PART``, ``BLOCK`` or None (whole)."""
        if not self.split(name, -1):
            return None
        return PART if parts_of(self.specs[name]) is not None else BLOCK

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: self.weight(name) for name, _ in
                self.named_parameters()}

    def forward(self, x: torch.Tensor, return_state: bool = False):
        return ssd_forward(self.params(), x, self.cfg, return_state,
                           self.split_of())

    def decode(self, x: torch.Tensor, cache: State
               ) -> Tuple[torch.Tensor, State]:
        return ssd_decode_step(self.params(), x, cache, self.cfg,
                               self.split_of())


@torch.no_grad()
def init_ssm(ssm: SSM, gen: torch.Generator) -> None:
    """The reference's ``init_ssm``, drawn from ``gen``: A = exp(A_log)
    uniform in [1, 16); dt_bias the softplus inverse of a dt uniform in
    [1e-3, 1e-1]; D ones; ``conv_b`` and ``ssm_norm`` zeros; the
    projections and the conv fan-in normal along their first axis, each
    drawn whole (a placed layer keeps its block, ``Placed.fill``)."""
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
            ssm.fill(name, lambda shape, dt=w.dtype: dense_init(gen, shape, 0,
                                                               dt))
