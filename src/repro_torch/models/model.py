"""Language models of all seven families (dense, moe, ssm, hybrid, audio,
vlm): parameters, full-sequence forward (prefill), decode caches and
single-token decode. Port of ``repro/models/model.py``.

A pre-norm llama-style stack: per layer an RMS norm, GQA attention with
rotary embeddings (``flash_attention`` kernel in the full-sequence
forward), a second RMS norm and a feed-forward; a final norm and the LM
head, whose padded vocabulary entries are masked to -1e30. The dense
family's feed-forward is a SwiGLU MLP (``DenseBlock``); the moe family's
layers take a top-k mixture of experts in its place (``MoEBlock``,
``models/moe.py``), after ``n_dense_layers`` dense layers
(``dense_blocks``; Kimi-K2 has one), and ``forward(...,
return_aux=True)`` sums their load-balance losses. The ssm family
(Mamba-2) is attention-free: each layer is an RMS norm and a Mamba-2 SSD
(``SSMBlock``, ``models/ssm.py``), with a recurrent state ``h`` and a
conv window in place of a KV cache. The hybrid family (Hymba) runs
attention and the SSD side by side on the same normed input and adds the
mean of their separately normed outputs (``HybridBlock``); its
attention has a sliding window except on ``global_layers``, and
``meta_tokens`` learned rows are prepended to every sequence, count in
the rotary positions, take the first slots of the KV cache, and are cut
off the logits.

The audio family (Whisper) is an encoder-decoder. The encoder
(``encoder``, ``enc_layers`` dense blocks, then ``enc_norm``) runs over
precomputed frame embeddings ``batch["frames"]`` [B, F, d] (the conv
stem is stubbed, as in the reference) plus a sinusoidal table, with
full (bidirectional) attention; its blocks apply the rotary embedding
at the frame positions, as the reference's do. Each decoder layer
(``CrossBlock``) runs causal self-attention, then cross-attention of the
normed stream over the encoder's output (no rotary embedding), then the
audio feed-forward: fc, tanh-approximated GELU, fc, with biases
(``GeluMLP``, the encoder's too). The decode cache keeps each layer's
cross-attention keys and values ``xk``/``xv`` [L, B, F, KVH, hd] from
the prefill, so a decode step never runs the encoder again. Full
attention goes over the F real keys: the reference's chunked jnp
attention pads K and V to a multiple of its chunk (512) with zero keys
that only a causal mask hides, which at F = 1500 gives 36 zero keys
weight in its prefill (not in its decode); the port does not copy that.
The vlm family (InternVL2) is the dense family whose first
``vision_tokens`` token embeddings a prompt's
``batch["vision_embeds"]`` [B, vision_tokens, d] replace (the vision
frontend is stubbed); decode has no overlay.

The weights keep the reference's layouts (``wq [d, H, hd]``, ``wk``/``wv
[d, KVH, hd]``, ``wo [H, hd, d]``, ``w_gate``/``w_up [d, f]``, ``w_down
[f, d]``, ``tok_embed [Vpad, d]``, ``lm_head [d, Vpad]``, the experts'
in ``models/moe.py``), one module per layer where the reference stacks
layers on a leading axis (``blocks``, ``dense_blocks`` and ``encoder``),
so carrying its weights across is a copy
(``repro_torch.carry.lm_params_from_arrays``). Parameters are made
without gradients, for serving; a trainer switches them on
(``model.requires_grad_()``, as ``repro_torch.launch.train`` does).
Then the full-sequence forward recomputes each block in the backward
when ``cfg.remat`` is set, as the reference's ``jax.checkpoint`` over
its layer scan does, so activation memory holds one block's input per
layer.

Under an ambient mesh (``repro_torch.distributed.context.mesh_context``)
the model is one rank's: its inputs are the rank's block of the batch
(``sharding.batch_spec``), whose whole size the context is given
(``mesh_context(..., batch=B)``) where the data axes are above 1. A model
built there holds every parameter as the block ``sharding.param_specs``
gives the rank (``place``; an expert-parallel MoE layer's experts as
``models/moe.py`` takes them; the SSD's concatenated ``in_proj`` and conv
per part, ``sharding.PartSpec``, or contiguous), and seeded there it
holds the unsharded model's weights for the same seed (each drawn whole
and cut). The
products follow the reference's activation specs (``constrain_*``),
which the port does not port but lays its tensors out by: between
blocks ``[B, S, d]`` is the rank's rows, whole across ``model``; inside
a block the heads, ``d_inner`` channels and ``d_ff`` are split over
``model`` where they divide it: ``wq``/``wk``/``wv``, ``w_gate``/``w_up``
and ``w_fc`` column-parallel, ``wo``, ``w_down`` and ``w_out``
row-parallel and summed over ``model`` (``sum_over``; ``b_out`` added
once after the sum), their input read through ``copy_over`` (its
gradient summed); where the heads do not divide ``model`` the rank
computes the whole attention, where the kv heads do not it computes
every kv head and takes those of its query heads; under
``DistConfig(shard_head_dim_fallback=True)`` ``model`` splits the head
dim there instead (``Attention``: each rank projects its head-dim block,
the blocks are gathered and rotated whole). The SSD's layouts are
``models/ssm.py``'s (``Split``). The dims the specs
split over the data axes are all-gathered before use (FSDP,
``Placed.weight``; reduce-scattered in the backward). The embedding and
the LM head are vocab-parallel: each rank looks up its vocabulary block
(the rows summed over ``model``) and gives the logits of its block
(``gather_vocab`` makes them whole; the train step's loss and the
engine's greedy choice never do). The meta tokens, the norms and the
encoder's input are whole. The decode cache is the rank's
``sharding.cache_spec`` block (``init_cache``), the cross-attention's
``xk``/``xv`` by their own spec at the encoder's length: where it splits
the slots, a decode step merges the ranks' partial softmaxes
(``models/attention.py:decode_attention_merged``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, check_family
from repro_torch.core.distributed import copy_over, gather_axis, sum_over
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.context import get_mesh, whole_batch
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (
    attention,
    decode_attention,
    decode_attention_merged,
)
from repro_torch.models.layers import (
    Placed,
    apply_rope,
    dense_init,
    embed_init,
    rms_norm,
    rope_cos_sin,
    sinusoidal_embedding,
)

MODEL = ("model",)


class Cache(dict):
    """The decode cache: its tensors by name. Under a mesh that splits its
    sequence dim (``sharding.cache_spec``), this rank holds the slots
    ``[first_slot, first_slot + n)`` of every row it holds, and
    ``seq_axes`` names the axes of ``mesh`` the slots are split over
    (major first); on one device, every slot. ``x_first_slot`` and
    ``x_seq_axes`` are the same for the cross-attention's ``xk``/``xv``
    (the encoder's frames)."""
    first_slot: int = 0
    seq_axes: Tuple[str, ...] = ()
    x_first_slot: int = 0
    x_seq_axes: Tuple[str, ...] = ()
    mesh = None
    LAYOUT = ("first_slot", "seq_axes", "x_first_slot", "x_seq_axes", "mesh")

    def layer(self, i: int) -> "Cache":
        """Layer ``i``'s views, with this cache's slot layout."""
        out = Cache({key: c[i] for key, c in self.items()})
        for attr in self.LAYOUT:
            setattr(out, attr, getattr(self, attr))
        return out

    def cross(self) -> "Cache":
        """This layer's ``xk``/``xv`` as the k/v of a cache of their own
        slot layout."""
        out = Cache({"k": self["xk"], "v": self["xv"]})
        out.first_slot, out.seq_axes = self.x_first_slot, self.x_seq_axes
        out.mesh = self.mesh
        return out


def write_slot(cache: Cache, pos: int, k, v) -> None:
    """Write one token's k and v [B, 1, KVH, hd] into slot ``pos`` of a
    layer's ``cache["k"]``, ``cache["v"]``, in place, on the rank holding
    that slot (where the slots are split; elsewhere nothing)."""
    slot = pos - cache.first_slot
    if 0 <= slot < cache["k"].shape[1]:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(Placed):
    """GQA projections. Placed under a mesh (``LM``), the rank holds its
    block of each weight: ``wq`` column-parallel over its heads (``wk``/
    ``wv`` too where the kv heads divide ``model``, else whole), ``wo``
    row-parallel, and ``d`` split over the data axes where it divides
    (gathered before use, ``Placed.weight``). Where the heads do not divide
    ``model`` every rank computes the whole attention.

    Under ``DistConfig(shard_head_dim_fallback=True)`` ``model`` splits
    the head dim where the heads do not divide it: of ``wk``/``wv`` (and
    ``bk``/``bv``) where the kv heads do not (case M), and of ``wq``,
    ``bq`` and ``wo`` too where the query heads do not either (case H).
    The rank projects its head-dim block of each head; the rotary
    embedding pairs column i with column i + hd/2, which another rank
    holds, so the blocks are gathered over ``model`` (``gather_axis``: its
    gradient the reduce-scatter) and rotated whole. Case H then runs the
    whole attention on every rank, and its output's head-dim block goes
    through the rank's ``wo`` block, summed over ``model``; case M's query
    heads are split as without the flag, over every kv head. The decode
    cache holds the rank's head-dim block of the rotated k and of v
    (``cache_block``), and a decode step sums the partial scores over
    ``model`` (``attend_cache``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kvh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        self.n_heads, self.n_kv_heads = h, kvh
        self.wq = _param((d, h, hd), dtype, device)
        self.wk = _param((d, kvh, hd), dtype, device)
        self.wv = _param((d, kvh, hd), dtype, device)
        self.wo = _param((h, hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((h, hd), dtype, device)
            self.bk = _param((kvh, hd), dtype, device)
            self.bv = _param((kvh, hd), dtype, device)

    @property
    def tp(self) -> bool:
        """Whether the rank holds a block of the heads (over ``model``)."""
        return self.split("wq", 1)

    def _kv_whole(self) -> bool:
        """Heads split while the kv heads are whole on every rank (after
        the head-dim gather, in case M)."""
        return self.tp and not self.split("wk", 1)

    @property
    def hd(self) -> bool:
        """Whether the rank projects a head-dim block of k and v (over
        ``model``: ``shard_head_dim_fallback``, cases H and M)."""
        return self.split("wk", 2)

    def _proj(self, x, name: str, gather: bool = True):
        """x [B, S, d] through ``w<name>`` [d, n, hd] -> [B, S, n, hd], plus
        ``b<name>`` where the config has qkv biases (this rank's heads);
        where ``model`` splits the weight's head dim, the ranks' blocks
        gathered over it (``gather_axis``: its gradient the
        reduce-scatter) unless ``gather`` is false."""
        w = self.weight("w" + name)
        y = (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:2], *w.shape[1:])
        if "b" + name in self._parameters:
            y = y + self.weight("b" + name)
        if gather and self.split("w" + name, 2):
            y = gather_axis(self.mesh, "model", y, dim=3)
        return y

    def query(self, x):
        """x [B, S, d] -> q [B, S, H, hd], no rotary embedding."""
        return self._proj(x, "q")

    def qkv(self, x, kv):
        """q [B, S, H, hd] from x, k and v [B, Skv, KVH, hd] from kv, no
        rotary embedding (cross-attention's projections). With the heads
        split, x enters through ``copy_over(model)`` (each rank's heads
        add their part of its gradient); where the kv heads are whole on
        every rank, k and v leave through it instead (each rank reads the
        kv heads of its own query heads). Where ``model`` splits the head
        dim, x and kv enter through ``copy_over`` and the blocks leave
        through the head-dim gather (``_proj``; k's and v's in one
        exchange)."""
        same = kv is x
        if self.tp or self.split("wq", 2):
            x = copy_over(self.mesh, MODEL, x)
        if (self.tp and not self._kv_whole()) or self.hd:
            kv = x if same else copy_over(self.mesh, MODEL, kv)
        q, k, v = self._proj(x, "q"), self._proj(kv, "k", False), \
            self._proj(kv, "v", False)
        if self.hd:
            k, v = gather_axis(self.mesh, "model", torch.cat([k, v], 2),
                               dim=3).split(k.shape[2], dim=2)
        if self._kv_whole() and not self.hd:
            k, v = copy_over(self.mesh, MODEL, k), copy_over(self.mesh, MODEL,
                                                             v)
        return q, k, v

    def project(self, x, cos, sin):
        """x [B, S, d] -> q [B, S, H, hd], k and v [B, S, KVH, hd], with
        rotary embeddings applied to q and k."""
        q, k, v = self.qkv(x, x)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def kv_for_queries(self, t):
        """k or v [B, S, KVH, hd] holding every kv head -> the kv heads of
        this rank's query heads, in the grouping the kernel reads (query
        head j of G = local heads / local kv heads to kv head j // G); the
        whole ``t`` unless the heads are split and the kv heads not."""
        if not self._kv_whole() or t.shape[2] != self.n_kv_heads:
            return t
        hl = self.wq.shape[1]
        g = self.n_heads // self.n_kv_heads
        h0 = self.model_index() * hl
        idx = (h0 + torch.arange(hl)) // g
        lo, n = int(idx[0]), int(idx[-1]) - int(idx[0]) + 1
        if hl % n == 0 and torch.equal(idx,
                                       lo + torch.arange(hl) // (hl // n)):
            return t[:, :, lo:lo + n]
        return t[:, :, idx.to(t.device)]

    def cache_block(self, t):
        """k or v [B, S, KVH, hd] as every rank holds it -> as this rank's
        decode cache holds it: its head-dim block where ``model`` splits
        the head dim, else ``t``."""
        if not self.hd:
            return t
        n = self.wk.shape[2]
        return t.narrow(3, self.model_index() * n, n)

    def out(self, a):
        """a [B, S, H, hd] -> [B, S, d]: with the heads split, this rank's
        heads' part summed over ``model`` (``sum_over``: each rank
        back-propagates its own part); with the head dim split (case H),
        the part of this rank's head-dim block of a (or a itself, where it
        holds just that block: ``attend_cache``), summed the same way."""
        b, s = a.shape[:2]
        wo = self.weight("wo")
        hd_split = self.split("wo", 1)
        if hd_split and a.shape[3] != wo.shape[1]:
            n = wo.shape[1]
            a = a.narrow(3, self.model_index() * n, n)
        y = a.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
        return sum_over(self.mesh, MODEL, y) if self.tp or hd_split else y

    def attend_cache(self, q, cache: "Cache", pos: int, slot_pos, **mask):
        """One token's attention over this layer's ``cache["k"]``,
        ``cache["v"]`` [B, n, KVH, hd] (slot positions ``slot_pos``).
        Where the cache's slots are split over mesh axes, each rank takes
        the partial softmax over its slots and the partials merge over
        those axes (``decode_attention_merged``); where they are split over
        ``model`` while the heads are too, the query is gathered over
        ``model`` first (every head reads every slot) and the rank keeps its
        heads of the result. Where ``model`` splits the head dim, the
        cache holds the rank's block of it: the rank scores its block of
        every head's q (in case M the query gathered over ``model``
        first), the scores are summed over ``model``, and the rank reads
        its block of v: the result in case H, which ``out`` takes so; in
        case M gathered over the head dim, the rank keeping its heads."""
        k, v = cache["k"], cache["v"]
        if self.hd:
            i, n, hl = self.model_index(), k.shape[3], q.shape[2]
            if self.tp:
                q = gather_axis(self.mesh, "model", q, dim=2)
            a = decode_attention_merged(
                q.narrow(3, i * n, n), k, v, self.mesh, cache.seq_axes,
                k_pos=slot_pos, cur_pos=pos, head_dim_axes=MODEL, **mask)
            if not self.tp:
                return a
            a = gather_axis(self.mesh, "model", a, dim=3)
            return a.narrow(2, i * hl, hl)
        if not cache.seq_axes:
            return decode_attention(q, self.kv_for_queries(k),
                                    self.kv_for_queries(v), k_pos=slot_pos,
                                    cur_pos=pos, **mask)
        gather = self.tp and "model" in cache.seq_axes
        hl = q.shape[2]
        if gather:
            q = gather_axis(self.mesh, "model", q, dim=2)
        else:
            k, v = self.kv_for_queries(k), self.kv_for_queries(v)
        a = decode_attention_merged(q, k, v, cache.mesh, cache.seq_axes,
                                    k_pos=slot_pos, cur_pos=pos, **mask)
        return a.narrow(2, self.model_index() * hl, hl) if gather else a


class MLP(Placed):
    """SwiGLU. Placed under a mesh: ``w_gate``/``w_up`` column-parallel
    and ``w_down`` row-parallel over ``model`` where ``d_ff`` divides it
    (the input through ``copy_over``, the output summed over ``model``),
    ``d`` over the data axes (gathered before use)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)

    def forward(self, x):
        tp = self.split("w_gate", 1)
        if tp:
            x = copy_over(self.mesh, MODEL, x)
        g = x @ self.weight("w_gate")
        u = x @ self.weight("w_up")
        h = nn.functional.silu(g.float()).to(x.dtype) * u
        y = h @ self.weight("w_down")
        return sum_over(self.mesh, MODEL, y) if tp else y


class GeluMLP(Placed):
    """The audio family's feed-forward (Whisper's): fc, GELU, fc, with
    biases. The GELU is the tanh approximation, ``jax.nn.gelu``'s default
    (torch's default, the erf form, is another function). Placed under a
    mesh: ``w_fc`` and ``b_fc`` column-parallel and ``w_out`` row-parallel
    over ``model`` where ``d_ff`` divides it (the input through
    ``copy_over``, the output summed over ``model``, then ``b_out`` added
    once)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_fc = _param((d, f), dtype, device)
        self.b_fc = _param((f,), dtype, device)
        self.w_out = _param((f, d), dtype, device)
        self.b_out = _param((d,), dtype, device)

    def forward(self, x):
        tp = self.split("w_fc", 1)
        if tp:
            x = copy_over(self.mesh, MODEL, x)
        h = x @ self.weight("w_fc") + self.weight("b_fc")
        h = nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
        y = h @ self.weight("w_out")
        if tp:
            y = sum_over(self.mesh, MODEL, y)
        return y + self.b_out


class DenseBlock(nn.Module):
    """Pre-norm attention (causal, or full in an encoder's block) and a
    feed-forward: the SwiGLU MLP, or ``GeluMLP`` in the audio family."""

    def __init__(self, cfg: ModelConfig, dtype, device, causal: bool = True):
        super().__init__()
        self.eps, self.causal = cfg.norm_eps, causal
        self.attn_norm = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp_norm = _param((cfg.d_model,), dtype, device)
        self.add_ffn(cfg, dtype, device)

    def add_ffn(self, cfg: ModelConfig, dtype, device) -> None:
        mlp = GeluMLP if cfg.family == "audio" else MLP
        self.mlp = mlp(cfg, dtype, device)

    def ffn(self, h, with_aux: bool = False):
        """(the feed-forward of h, its aux loss or None)."""
        return self.mlp(h), None

    def self_attn(self, x, cos, sin):
        """x plus its attention over the whole sequence -> (x, k, v): the
        rank's kv heads as its decode cache holds them."""
        q, k, v = self.attn.project(rms_norm(x, self.attn_norm, self.eps),
                                    cos, sin)
        a = attention(q, self.attn.kv_for_queries(k),
                      self.attn.kv_for_queries(v), causal=self.causal)
        return x + self.attn.out(a), self.attn.cache_block(k), \
            self.attn.cache_block(v)

    def forward(self, x, cos, sin, with_aux: bool = False,
                collect: bool = False):
        """Full sequence. Returns (x, this layer's cache entries {"k",
        "v"} when ``collect``, else None, the aux loss when ``with_aux``
        and the block has one, else None)."""
        x, k, v = self.self_attn(x, cos, sin)
        y, aux = self.ffn(rms_norm(x, self.mlp_norm, self.eps), with_aux)
        return x + y, ({"k": k, "v": v} if collect else None), aux

    def self_attn_step(self, x, cos, sin, cache: Cache, pos: int, slot_pos):
        """x plus one token's attention over the cache, its k/v written
        into slot ``pos`` of this layer's caches ``cache["k"]``,
        ``cache["v"]`` [B, Smax, KVH, hd] in place (by the rank holding
        that slot, where the slots are split)."""
        q, k, v = self.attn.project(rms_norm(x, self.attn_norm, self.eps),
                                    cos, sin)
        write_slot(cache, pos, self.attn.cache_block(k),
                   self.attn.cache_block(v))
        return x + self.attn.out(self.attn.attend_cache(q, cache, pos,
                                                        slot_pos))

    def decode(self, x, cos, sin, cache: Cache, pos: int, slot_pos):
        """One token in cache slot ``pos`` (``self_attn_step``), then the
        feed-forward."""
        x = self.self_attn_step(x, cos, sin, cache, pos, slot_pos)
        return x + self.ffn(rms_norm(x, self.mlp_norm, self.eps))[0]


class CrossBlock(DenseBlock):
    """The audio family's decoder layer: the dense block's causal
    self-attention, then cross-attention (``xattn_norm``, ``xattn``, no
    rotary embedding) of the normed stream over the encoder's output, then
    the ``GeluMLP`` feed-forward."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(cfg, dtype, device)
        self.enc_frames = cfg.enc_frames
        self.xattn_norm = _param((cfg.d_model,), dtype, device)
        self.xattn = Attention(cfg, dtype, device)

    def cross(self, x, enc_out):
        """x plus its full attention over ``enc_out`` [B, F, d] -> (x, xk,
        xv), the keys and values [B, F, KVH, hd] the decode cache keeps."""
        q, xk, xv = self.xattn.qkv(rms_norm(x, self.xattn_norm, self.eps),
                                   enc_out)
        a = attention(q, self.xattn.kv_for_queries(xk),
                      self.xattn.kv_for_queries(xv), causal=False)
        return x + self.xattn.out(a), self.xattn.cache_block(xk), \
            self.xattn.cache_block(xv)

    def forward(self, x, cos, sin, with_aux: bool = False,
                collect: bool = False, enc_out=None):
        """Full sequence over ``enc_out``. Returns (x, this layer's cache
        entries {"k", "v", "xk", "xv"} when ``collect``, else None,
        None)."""
        x, k, v = self.self_attn(x, cos, sin)
        x, xk, xv = self.cross(x, enc_out)
        x = x + self.mlp(rms_norm(x, self.mlp_norm, self.eps))
        return x, ({"k": k, "v": v, "xk": xk, "xv": xv} if collect
                   else None), None

    def decode(self, x, cos, sin, cache: Cache, pos: int, slot_pos):
        """One token: self-attention as the dense block's, then its
        cross-attention over every slot of the layer's ``xk``/``xv`` (the
        rank's, merged over the axes splitting them)."""
        x = self.self_attn_step(x, cos, sin, cache, pos, slot_pos)
        q = self.xattn.query(rms_norm(x, self.xattn_norm, self.eps))
        xc = cache.cross()
        frames = xc.first_slot + torch.arange(xc["k"].shape[1],
                                              device=x.device)
        a = self.xattn.attend_cache(q, xc, self.enc_frames, frames)
        x = x + self.xattn.out(a)
        return x + self.mlp(rms_norm(x, self.mlp_norm, self.eps))


class MoEBlock(DenseBlock):
    """The dense block with a top-k MoE (``self.moe``) in place of the
    MLP; built under an ambient mesh, the MoE holds this rank's expert
    blocks."""

    def add_ffn(self, cfg: ModelConfig, dtype, device) -> None:
        self.moe = moe_lib.MoE(cfg, dtype, device)

    def ffn(self, h, with_aux: bool = False):
        return self.moe(h, with_aux)


def _update_state(cache: Cache, new: Cache) -> None:
    """Write an SSD step's new ``h`` and ``conv`` into the layer's cache
    views in place."""
    cache["h"].copy_(new["h"])
    cache["conv"].copy_(new["conv"])


class SSMBlock(nn.Module):
    """The ssm family's layer: x + SSD(rms_norm(x)) (the SSD placed as
    ``models/ssm.py`` says)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.ssm_in_norm = _param((cfg.d_model,), dtype, device)
        self.ssm = ssm_lib.SSM(cfg, dtype, device)

    def forward(self, x, cos, sin, with_aux: bool = False,
                collect: bool = False):
        """Full sequence (``cos``, ``sin`` unused). Returns (x, this layer's
        decode state {"h", "conv"} when ``collect``, else None, None)."""
        h = rms_norm(x, self.ssm_in_norm, self.eps)
        if not collect:
            return x + self.ssm(h), None, None
        y, state = self.ssm(h, return_state=True)
        return x + y, state, None

    def decode(self, x, cos, sin, cache: Cache, pos: int, slot_pos):
        """One token: updates this layer's ``cache["h"]`` and
        ``cache["conv"]`` in place."""
        y, state = self.ssm.decode(rms_norm(x, self.ssm_in_norm, self.eps),
                                   cache)
        _update_state(cache, state)
        return x + y


class HybridBlock(nn.Module):
    """The hybrid family's layer: attention (sliding window and meta
    tokens, or global) and the SSD on the same normed input, each output
    RMS-normed by its own scale, their mean added to x; then the SwiGLU
    MLP as in the dense block. Placed, its attention, SSD and MLP are
    their own; both branches' outputs are whole on every rank, so the
    branch norms and the fuse are the unplaced ones."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 is_global: bool = False):
        super().__init__()
        self.cfg, self.eps, self.is_global = cfg, cfg.norm_eps, is_global
        d = cfg.d_model
        self.attn_norm = _param((d,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ssm = ssm_lib.SSM(cfg, dtype, device)
        self.attn_branch_norm = _param((d,), dtype, device)
        self.ssm_branch_norm = _param((d,), dtype, device)
        self.mlp_norm = _param((d,), dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    def _fuse(self, x, attn_out, ssm_out):
        fused = 0.5 * (rms_norm(attn_out, self.attn_branch_norm, self.eps)
                       + rms_norm(ssm_out, self.ssm_branch_norm, self.eps))
        x = x + fused
        return x + self.mlp(rms_norm(x, self.mlp_norm, self.eps))

    def forward(self, x, cos, sin, with_aux: bool = False,
                collect: bool = False):
        """Full sequence, meta tokens first. Returns (x, this layer's
        cache entries {"k", "v", "h", "conv"} when ``collect``, else None,
        None)."""
        cfg = self.cfg
        h = rms_norm(x, self.attn_norm, self.eps)
        q, k, v = self.attn.project(h, cos, sin)
        a = attention(q, self.attn.kv_for_queries(k),
                      self.attn.kv_for_queries(v), causal=True,
                      window=cfg.attn_window, meta_tokens=cfg.meta_tokens,
                      disable_window=self.is_global)
        if not collect:
            return self._fuse(x, self.attn.out(a), self.ssm(h)), None, None
        y, state = self.ssm(h, return_state=True)
        return self._fuse(x, self.attn.out(a), y), \
            {"k": self.attn.cache_block(k), "v": self.attn.cache_block(v),
             **state}, None

    def decode(self, x, cos, sin, cache: Cache, pos: int, slot_pos):
        """One token in cache slot ``pos`` (its position, meta tokens
        counted): writes its k/v into slot ``pos`` (by the rank holding it,
        where the slots are split) and updates ``h`` and ``conv``, all in
        place."""
        cfg = self.cfg
        h = rms_norm(x, self.attn_norm, self.eps)
        q, k, v = self.attn.project(h, cos, sin)
        write_slot(cache, pos, self.attn.cache_block(k),
                   self.attn.cache_block(v))
        a = self.attn.attend_cache(q, cache, pos, slot_pos,
                                   window=cfg.attn_window,
                                   meta_tokens=cfg.meta_tokens,
                                   disable_window=self.is_global)
        y, state = self.ssm.decode(h, cache)
        _update_state(cache, state)
        return self._fuse(x, self.attn.out(a), y)


def global_flags(cfg: ModelConfig, n: int) -> List[bool]:
    """Which of the ``n`` blocks attend globally (no window): the hybrid
    family's ``global_layers``; none elsewhere."""
    flags = [False] * n
    if cfg.family == "hybrid":
        for i in cfg.global_layers:
            flags[i] = True
    return flags


class LM(Placed):
    """Embedding, ``n_dense_layers`` dense blocks (``dense_blocks``; none
    outside the moe family), the family's ``n_layers - n_dense_layers``
    blocks (``blocks``), the hybrid family's ``meta_tokens`` rows
    ``[meta_tokens, d]``, the audio family's ``enc_layers`` encoder blocks
    (``encoder``; none elsewhere) and ``enc_norm``, final norm, LM head
    (the transposed embedding when ``tie_embeddings``).

    Built under an ambient mesh, the model is one rank's (``mesh``,
    ``dist``): every parameter whose ``param_specs`` spec splits a dim is
    held as the rank's block (``place``); the modules are made on the
    meta device first, so no whole weight is ever allocated."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        check_family(cfg)
        dev = resolve_device(device)
        dtype = _dtype(cfg)
        self.cfg = cfg
        mesh, dist = get_mesh()
        self.mesh, self.dist = mesh, dist
        placing = mesh is not None
        built = torch.device("meta") if placing else dev
        self.tok_embed = _param((cfg.vocab_padded, cfg.d_model), dtype,
                                built)
        n_main = cfg.n_layers - cfg.n_dense_layers
        self.dense_blocks = nn.ModuleList(
            DenseBlock(cfg, dtype, built) for _ in range(cfg.n_dense_layers))
        if cfg.family == "hybrid":
            self.blocks = nn.ModuleList(
                HybridBlock(cfg, dtype, built, is_global=flag)
                for flag in global_flags(cfg, n_main))
        else:
            block = {"moe": MoEBlock, "ssm": SSMBlock,
                     "audio": CrossBlock}.get(cfg.family, DenseBlock)
            self.blocks = nn.ModuleList(block(cfg, dtype, built)
                                        for _ in range(n_main))
        self.encoder = nn.ModuleList(
            DenseBlock(cfg, dtype, built, causal=False)
            for _ in range(cfg.enc_layers))
        if cfg.enc_layers:
            self.enc_norm = _param((cfg.d_model,), dtype, built)
        if cfg.meta_tokens:
            self.meta_tokens = _param((cfg.meta_tokens, cfg.d_model), dtype,
                                      built)
        self.final_norm = _param((cfg.d_model,), dtype, built)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_padded), dtype,
                                  built)
        if placing:
            place(self, dev)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def layers(self):
        """Every block in depth order: the dense prefix, then ``blocks``."""
        return [*self.dense_blocks, *self.blocks]

    def vocab_block(self) -> Tuple[int, int]:
        """(the first vocabulary id, the ids) of this rank's block of the
        embedding and of the logits: the whole padded vocabulary unless
        ``model`` splits it."""
        n = self.tok_embed.shape[0]
        return (self.model_index() * n if self.split("tok_embed", 0)
                else 0), n

    def embed_tokens(self, tokens):
        """tokens [B, S] -> their embeddings [B, S, d]. Where ``model``
        splits the vocabulary, each rank looks up the ids of its block,
        zeros the others, and the ranks' rows are summed over ``model``
        (one of them nonzero: the sum is the row, bit for bit)."""
        table = self.weight("tok_embed")
        if not self.split("tok_embed", 0):
            return table[tokens]
        v0, n = self.vocab_block()
        local = tokens - v0
        mine = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return sum_over(self.mesh, MODEL, rows)

    def embed(self, tokens, vision_embeds=None):
        """tokens [B, S] -> [B, meta_tokens + S, d]: the meta tokens' rows
        (if any) ahead of each sequence's embeddings. In the vlm family,
        ``vision_embeds`` [B, vision_tokens, d] (cast to the model's dtype)
        replace the first ``vision_tokens`` embeddings."""
        x = self.embed_tokens(tokens)
        if self.cfg.family == "vlm" and vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype),
                           x[:, self.cfg.vision_tokens:]], dim=1)
        if self.cfg.meta_tokens:
            meta = self.meta_tokens[None].expand(x.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        return x

    def encode(self, frames, remat: bool = False):
        """The audio encoder over frame embeddings [B, F, d] (under a mesh,
        the rank's rows): the frames and the sinusoidal table, each cast to
        the model's dtype, added; the ``encoder`` blocks (full attention,
        rotary embeddings at the frame positions; each recomputed in the
        backward when ``remat``; placed as the decoder's are);
        ``enc_norm``. Returns [B, F, d] in the model's dtype."""
        cfg, dtype = self.cfg, self.tok_embed.dtype
        f = frames.shape[1]
        table = torch.from_numpy(sinusoidal_embedding(f, cfg.d_model))
        x = frames.to(dtype) + table.to(frames.device, dtype)[None]
        cos, sin = rope_cos_sin(torch.arange(f, device=x.device),
                                cfg.resolved_head_dim, cfg.rope_theta)
        for blk in self.encoder:
            if remat:
                x = checkpoint(lambda x_, b=blk: b(x_, cos, sin)[0], x,
                               use_reentrant=False)
            else:
                x = blk(x, cos, sin)[0]
        return rms_norm(x, self.enc_norm, cfg.norm_eps)

    def logits(self, x):
        """x [B, S, d] -> logits [B, S, n] f32 over this rank's vocabulary
        block (``vocab_block``: all of it unless ``model`` splits it; the
        normed x enters through ``copy_over(model)`` then), the padded
        entries (global ids past ``vocab_size``) at -1e30."""
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        head = self.weight("tok_embed").T if cfg.tie_embeddings \
            else self.weight("lm_head")
        if self.split("tok_embed", 0):
            x = copy_over(self.mesh, MODEL, x)
        logits = (x @ head).float()
        v0, n = self.vocab_block()
        if v0 + n > cfg.vocab_size:  # mask padded vocab entries
            logits[..., max(cfg.vocab_size - v0, 0):] = -1e30
        return logits


# --------------------------------------------------------------------------
# public entry points (the reference's names; the model takes the place
# of its params pytree)
# --------------------------------------------------------------------------

def place(model: LM, device) -> None:
    """Give every parameter of ``model`` (built on the meta device under
    its mesh) its storage on ``device``: the rank's block where
    ``sharding.placed_specs`` splits it, else the whole tensor. An MoE
    layer's experts keep the blocks the layer took (``moe.MoE``: by the
    same rules where it is expert-parallel, whole where it is not). Each
    module holding blocks records their specs (``Placed.specs``)."""
    mesh, dist = model.mesh, model.dist
    experts = {f"{path}.{name}" for path, mod in model.named_modules()
               if isinstance(mod, moe_lib.MoE)
               for name in moe_lib.EXPERT_WEIGHTS}
    specs = sharding.placed_specs(
        {n: tuple(p.shape) for n, p in model.named_parameters()
         if n not in experts}, mesh, dist, model.cfg)
    for path, mod in model.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            spec = specs.get(f"{path}.{name}" if path else name)
            shape = sharding.block_shape(p.shape, spec, mesh) if spec \
                else p.shape
            mod._parameters[name] = nn.Parameter(
                torch.zeros(shape, dtype=p.dtype, device=device),
                requires_grad=False)
            if spec is not None:
                mod.specs = {**mod.specs, name: spec}
                mod.mesh = mesh


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> LM:
    """A model with the reference's initialisation (zero norms and
    biases, fan-in normal projections and experts, 0.02-normal
    embeddings and meta tokens, the SSD's as ``ssm.init_ssm``), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    CUDA card unless ``device="cpu"``). Under an ambient mesh each weight
    the rank holds as a block is drawn whole and cut (``Placed.fill``),
    and each MoE layer draws every expert whole and keeps this rank's
    blocks: the unsharded model's weights for the same seed."""
    model = LM(cfg, device)
    gen = torch.Generator(model.device).manual_seed(seed)
    dtype = _dtype(cfg)

    def dense(in_axis):
        return lambda shape: dense_init(gen, shape, in_axis, dtype)
    with torch.no_grad():
        model.fill("tok_embed", lambda shape: embed_init(gen, shape, dtype))
        if cfg.meta_tokens:
            model.meta_tokens.copy_(embed_init(gen, model.meta_tokens.shape,
                                               dtype))
        for blk in [*model.layers(), *model.encoder]:
            if hasattr(blk, "ssm"):
                ssm_lib.init_ssm(blk.ssm, gen)
            if isinstance(blk, SSMBlock):
                continue
            attns = [blk.attn, blk.xattn] if isinstance(blk, CrossBlock) \
                else [blk.attn]
            for a in attns:
                for name in ("wq", "wk", "wv"):
                    a.fill(name, dense(0))
                a.fill("wo", dense((0, 1)))
            if isinstance(blk, MoEBlock):
                moe_lib.init_moe(blk.moe, gen)
                continue
            for name, _ in list(blk.mlp.named_parameters()):
                if name.startswith("w_"):   # the biases stay zero
                    blk.mlp.fill(name, dense(0))
        if not cfg.tie_embeddings:
            model.fill("lm_head", dense(0))
    return model


def gather_vocab(model: LM, logits: torch.Tensor) -> torch.Tensor:
    """Logits over the rank's vocabulary block -> over the whole padded
    vocabulary (all-gathered over ``model`` where it splits them)."""
    if not model.split("tok_embed", 0):
        return logits
    return gather_axis(model.mesh, "model", logits, dim=-1)


def greedy(model: LM, logits: torch.Tensor) -> torch.Tensor:
    """logits [..., n] over the rank's vocabulary block -> the argmax over
    the whole real vocabulary [...] (int64), the same on every rank: each
    rank's max and its lowest id, then the max over ``model`` with the
    lowest global id among equals, as ``argmax`` over the whole row picks
    (a lower rank holds lower ids)."""
    vocab = model.cfg.vocab_size
    v0, n = model.vocab_block()
    local = logits[..., :max(min(vocab - v0, n), 1)]
    if not model.split("tok_embed", 0):
        return local.argmax(-1)
    idx = local.argmax(-1)
    val = local.gather(-1, idx[..., None])[..., 0]
    best = torch.stack([val.double(), (idx + v0).double()], -1)
    parts = gather_axis(model.mesh, "model", best[None], dim=0)
    pick = parts[..., 0].argmax(0)     # the first rank among equal maxima
    return parts[..., 1].gather(0, pick[None])[0].long()


def _rope(model: LM, positions: torch.Tensor):
    """cos, sin at ``positions`` (None, None for an attention-free
    model)."""
    cfg = model.cfg
    if cfg.is_attention_free:
        return None, None
    return rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


def forward(model: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            collect_cache: bool = False, return_aux: bool = False):
    """Teacher-forced full-sequence forward -> logits [B, S, Vpad] f32
    (the meta tokens' rows, which the hybrid family prepends, are cut
    off). ``batch`` holds ``tokens`` [B, S] and the family's modality
    stub: the audio family's ``frames`` [B, F, d] (the encoder runs once
    over them), the vlm family's optional ``vision_embeds`` [B,
    vision_tokens, d]; other entries are ignored.

    With ``collect_cache``, also returns each layer's cache entries
    stacked per layer, the dense prefix first: ``{"k", "v"}`` ``[L, B,
    S', KVH, hd]`` (after the rotary embedding, as cached; S' = S plus
    the meta tokens) where the layers attend, ``{"h", "conv"}`` (``[L,
    B, H, P, N]`` f32 and ``[L, B, K - 1, di + 2 N]``) where they run the
    SSD, ``{"xk", "xv"}`` ``[L, B, F, KVH, hd]`` where they attend to the
    encoder's output. With ``return_aux``, also the load-balance aux loss summed over
    the MoE layers, an f32 scalar (zero for the other families).

    A model built under a mesh runs under the same mesh context, on the
    rank's block of the batch; its logits are over its vocabulary block
    (``LM.vocab_block``; ``gather_vocab`` makes them whole), its cache
    entries hold its kv heads."""
    check_family(cfg)
    _check_mesh(model)
    x = model.embed(batch["tokens"], batch.get("vision_embeds"))
    cos, sin = _rope(model, torch.arange(x.shape[1], device=x.device))
    remat = cfg.remat and not collect_cache and torch.is_grad_enabled() \
        and x.requires_grad
    # the audio decoder's blocks attend to the encoder's output
    enc = {"enc_out": model.encode(batch["frames"], remat)} \
        if cfg.enc_layers else {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for blk in model.layers():
        if remat:   # (x, aux): no cache is collected under remat
            x, a = checkpoint(
                lambda x_, b=blk: b(x_, cos, sin, return_aux, **enc)[::2],
                x, use_reentrant=False)
        else:
            x, c, a = blk(x, cos, sin, return_aux, collect_cache, **enc)
            if collect_cache:
                caches.append(c)
        if a is not None:
            aux = aux + a
    out = (model.logits(x[:, cfg.meta_tokens:]),)
    if collect_cache:
        out += ({key: torch.stack([c[key] for c in caches])
                 for key in caches[0]},)
    if return_aux:
        out += (aux,)
    return out if len(out) > 1 else out[0]


def _check_mesh(model: LM) -> None:
    if model.mesh is not None and model.mesh is not get_mesh()[0]:
        raise RuntimeError("a model runs under the mesh context it was "
                           "built under")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Cache:
    """Decode cache of zeros, every layer (the dense prefix first): k, v
    ``[L, B, max_len + meta_tokens, KVH, hd]`` where the layers attend
    (slot i holds position i, the meta tokens first); the SSD's ``h``
    ``[L, B, H, P, N]`` f32 and ``conv`` ``[L, B, K - 1, di + 2 N]``
    where they run it; the cross-attention's ``xk``, ``xv`` ``[L, B,
    enc_frames, KVH, hd]`` where the layers attend to an encoder.

    Under an ambient mesh, ``batch`` is the whole batch's size and the
    cache is this rank's ``sharding.cache_spec`` block of each entry: its
    rows (the data axes, where they divide the batch), its kv heads where
    ``model`` splits them, its block of the head dim where ``model``
    splits that instead (``shard_head_dim_fallback``), its slots where
    the data axes (a batch they do not divide) or ``model`` (kv heads it
    does not divide) split the sequence (``Cache.first_slot``, ``Cache.seq_axes``; ``xk``/``xv`` by
    their own spec at ``enc_frames``, ``Cache.x_first_slot``,
    ``Cache.x_seq_axes``), the SSD's heads of ``h`` and channels of
    ``conv`` (as the conv's weights hold them) where they divide
    ``model``."""
    check_family(cfg)
    dtype = dtype or _dtype(cfg)
    dev = resolve_device(device)
    L, hd, kvh = cfg.n_layers, cfg.resolved_head_dim, cfg.n_kv_heads
    shapes = {}
    if not cfg.is_attention_free:
        shapes["k"] = shapes["v"] = (L, batch, max_len + cfg.meta_tokens,
                                     kvh, hd)
    if cfg.family in ("ssm", "hybrid"):
        for key, shape in ssm_lib.ssm_cache_shapes(cfg, batch).items():
            shapes[key] = (L,) + shape
    if cfg.enc_layers:
        shapes["xk"] = shapes["xv"] = (L, batch, cfg.enc_frames, kvh, hd)
    cache = Cache()
    mesh, dist = get_mesh()
    for key, shape in shapes.items():
        if mesh is not None:
            spec = sharding.cache_spec(
                cfg, batch, mesh, dist,
                seq_len=shape[2] if key in KV_KEYS else None)[key]
            shape = sharding.block_shape(shape, spec, mesh)
            if key in ("k", "xk"):
                x = "x_" if key == "xk" else ""
                setattr(cache, f"{x}first_slot",
                        sharding.block_index(mesh, spec[2]) * shape[2])
                setattr(cache, f"{x}seq_axes", sharding.entry_axes(spec[2]))
            cache.mesh = mesh
        cache[key] = torch.zeros(shape, dtype=torch.float32 if key == "h"
                                 else dtype, device=dev)
    return cache


KV_KEYS = ("k", "v", "xk", "xv")


def prefill(model: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Process a full prompt (``batch`` as ``forward``'s) -> (logits [B,
    S, Vpad], decode cache with slots [0, meta_tokens + S) filled, the SSD
    states after the prompt, and the cross-attention's keys and values
    over the encoder's output). Under a mesh, the rank's: its vocabulary
    block of the logits, its block of the cache (``init_cache``; each rank
    writes the slots and frames it holds, its heads of ``h`` and channels
    of ``conv`` as the forward leaves them)."""
    b, s = batch["tokens"].shape
    logits, states = forward(model, batch, cfg, collect_cache=True)
    whole = b if model.mesh is None else whole_batch(model.mesh, b)[0]
    cache = init_cache(cfg, whole, max_len or s, device=model.device)
    for key, val in states.items():
        if key in KV_KEYS:   # the slots this rank holds
            first = cache.x_first_slot if key in ("xk", "xv") \
                else cache.first_slot
            n = cache[key].shape[2]
            held = max(min(val.shape[2] - first, n), 0)
            cache[key][:, :, :held] = val[:, :, first:first + held]
        else:
            cache[key].copy_(val)
    return logits, cache


def decode_step(model: LM, tokens: torch.Tensor, cache: Cache, cur_pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, 1]; ``cur_pos`` the position of this token (its cache
    slot and rotary position are ``cur_pos + meta_tokens``). Returns
    (logits [B, 1, Vpad], cache): the cache is the one passed in, its
    slot written and its SSD states updated in place (the reference
    returns a new one). Under a mesh, the rank's (as ``prefill``'s)."""
    check_family(cfg)
    _check_mesh(model)
    if not isinstance(cache, Cache):
        cache = Cache(cache)
    pos = int(cur_pos) + cfg.meta_tokens
    x = model.embed_tokens(tokens)
    cos, sin = _rope(model, torch.tensor([pos], device=x.device))
    slot_pos = cache.first_slot + torch.arange(
        cache["k"].shape[2], device=x.device) if "k" in cache else None
    for i, blk in enumerate(model.layers()):
        x = blk.decode(x, cos, sin, cache.layer(i), pos, slot_pos)
    return model.logits(x), cache
