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
(``mesh_context(..., batch=B)``) where the data axes are above 1, and a
model built and seeded there holds, in
each expert-parallel MoE layer, only the rank's blocks of the experts
(``models/moe.py``), the same weights as the unsharded model of the same
seed. Every other weight stays whole on every rank. The reference's
sharding hints (``constrain_*``) place values and change none: the port
has no partitioner to give them to.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, check_family
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    embed_init,
    rms_norm,
    rope_cos_sin,
    sinusoidal_embedding,
)

Cache = Dict[str, torch.Tensor]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kvh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        self.wq = _param((d, h, hd), dtype, device)
        self.wk = _param((d, kvh, hd), dtype, device)
        self.wv = _param((d, kvh, hd), dtype, device)
        self.wo = _param((h, hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((h, hd), dtype, device)
            self.bk = _param((kvh, hd), dtype, device)
            self.bv = _param((kvh, hd), dtype, device)

    def _proj(self, x, name: str):
        """x [B, S, d] through ``w<name>`` [d, n, hd] -> [B, S, n, hd], plus
        ``b<name>`` where the config has qkv biases."""
        w = getattr(self, "w" + name)
        y = (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:2], *w.shape[1:])
        bias = getattr(self, "b" + name, None)
        return y if bias is None else y + bias

    def query(self, x):
        """x [B, S, d] -> q [B, S, H, hd], no rotary embedding."""
        return self._proj(x, "q")

    def qkv(self, x, kv):
        """q [B, S, H, hd] from x, k and v [B, Skv, KVH, hd] from kv, no
        rotary embedding (cross-attention's projections)."""
        return self._proj(x, "q"), self._proj(kv, "k"), self._proj(kv, "v")

    def project(self, x, cos, sin):
        """x [B, S, d] -> q [B, S, H, hd], k and v [B, S, KVH, hd], with
        rotary embeddings applied to q and k."""
        q, k, v = self.qkv(x, x)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def out(self, a):
        """a [B, S, H, hd] -> [B, S, d]."""
        b, s = a.shape[:2]
        return a.reshape(b, s, -1) @ self.wo.reshape(-1, self.wo.shape[-1])


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _param((d, f), dtype, device)
        self.w_up = _param((d, f), dtype, device)
        self.w_down = _param((f, d), dtype, device)

    def forward(self, x):
        g = x @ self.w_gate
        u = x @ self.w_up
        h = nn.functional.silu(g.float()).to(x.dtype) * u
        return h @ self.w_down


class GeluMLP(nn.Module):
    """The audio family's feed-forward (Whisper's): fc, GELU, fc, with
    biases. The GELU is the tanh approximation, ``jax.nn.gelu``'s default
    (torch's default, the erf form, is another function)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_fc = _param((d, f), dtype, device)
        self.b_fc = _param((f,), dtype, device)
        self.w_out = _param((f, d), dtype, device)
        self.b_out = _param((d,), dtype, device)

    def forward(self, x):
        h = x @ self.w_fc + self.b_fc
        h = nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
        return h @ self.w_out + self.b_out


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
        """x plus its attention over the whole sequence -> (x, k, v)."""
        q, k, v = self.attn.project(rms_norm(x, self.attn_norm, self.eps),
                                    cos, sin)
        return x + self.attn.out(attention(q, k, v, causal=self.causal)), \
            k, v

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
        ``cache["v"]`` [B, Smax, KVH, hd] in place."""
        q, k, v = self.attn.project(rms_norm(x, self.attn_norm, self.eps),
                                    cos, sin)
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        a = decode_attention(q, cache["k"], cache["v"], k_pos=slot_pos,
                             cur_pos=pos)
        return x + self.attn.out(a)

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
        self.xattn_norm = _param((cfg.d_model,), dtype, device)
        self.xattn = Attention(cfg, dtype, device)

    def cross(self, x, enc_out):
        """x plus its full attention over ``enc_out`` [B, F, d] -> (x, xk,
        xv), the keys and values [B, F, KVH, hd] the decode cache keeps."""
        q, xk, xv = self.xattn.qkv(rms_norm(x, self.xattn_norm, self.eps),
                                   enc_out)
        return x + self.xattn.out(attention(q, xk, xv, causal=False)), xk, xv

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
        cross-attention over every slot of the layer's ``xk``/``xv``."""
        x = self.self_attn_step(x, cos, sin, cache, pos, slot_pos)
        q = self.xattn.query(rms_norm(x, self.xattn_norm, self.eps))
        n = cache["xk"].shape[1]
        a = decode_attention(q, cache["xk"], cache["xv"],
                             k_pos=torch.arange(n, device=x.device),
                             cur_pos=n)
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
    """The ssm family's layer: x + SSD(rms_norm(x))."""

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
    MLP as in the dense block."""

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
        a = attention(q, k, v, causal=True, window=cfg.attn_window,
                      meta_tokens=cfg.meta_tokens,
                      disable_window=self.is_global)
        if not collect:
            return self._fuse(x, self.attn.out(a), self.ssm(h)), None, None
        y, state = self.ssm(h, return_state=True)
        return self._fuse(x, self.attn.out(a), y), \
            {"k": k, "v": v, **state}, None

    def decode(self, x, cos, sin, cache: Cache, pos: int, slot_pos):
        """One token in cache slot ``pos`` (its position, meta tokens
        counted): writes its k/v into slot ``pos`` and updates ``h`` and
        ``conv``, all in place."""
        cfg = self.cfg
        h = rms_norm(x, self.attn_norm, self.eps)
        q, k, v = self.attn.project(h, cos, sin)
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        a = decode_attention(q, cache["k"], cache["v"], k_pos=slot_pos,
                             cur_pos=pos, window=cfg.attn_window,
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


class LM(nn.Module):
    """Embedding, ``n_dense_layers`` dense blocks (``dense_blocks``; none
    outside the moe family), the family's ``n_layers - n_dense_layers``
    blocks (``blocks``), the hybrid family's ``meta_tokens`` rows
    ``[meta_tokens, d]``, the audio family's ``enc_layers`` encoder blocks
    (``encoder``; none elsewhere) and ``enc_norm``, final norm, LM head
    (the transposed embedding when ``tie_embeddings``)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        check_family(cfg)
        dev = resolve_device(device)
        dtype = _dtype(cfg)
        self.cfg = cfg
        self.tok_embed = _param((cfg.vocab_padded, cfg.d_model), dtype, dev)
        n_main = cfg.n_layers - cfg.n_dense_layers
        self.dense_blocks = nn.ModuleList(
            DenseBlock(cfg, dtype, dev) for _ in range(cfg.n_dense_layers))
        if cfg.family == "hybrid":
            self.blocks = nn.ModuleList(
                HybridBlock(cfg, dtype, dev, is_global=flag)
                for flag in global_flags(cfg, n_main))
        else:
            block = {"moe": MoEBlock, "ssm": SSMBlock,
                     "audio": CrossBlock}.get(cfg.family, DenseBlock)
            self.blocks = nn.ModuleList(block(cfg, dtype, dev)
                                        for _ in range(n_main))
        self.encoder = nn.ModuleList(
            DenseBlock(cfg, dtype, dev, causal=False)
            for _ in range(cfg.enc_layers))
        if cfg.enc_layers:
            self.enc_norm = _param((cfg.d_model,), dtype, dev)
        if cfg.meta_tokens:
            self.meta_tokens = _param((cfg.meta_tokens, cfg.d_model), dtype,
                                      dev)
        self.final_norm = _param((cfg.d_model,), dtype, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab_padded), dtype, dev)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def layers(self):
        """Every block in depth order: the dense prefix, then ``blocks``."""
        return [*self.dense_blocks, *self.blocks]

    def embed(self, tokens, vision_embeds=None):
        """tokens [B, S] -> [B, meta_tokens + S, d]: the meta tokens' rows
        (if any) ahead of each sequence's embeddings. In the vlm family,
        ``vision_embeds`` [B, vision_tokens, d] (cast to the model's dtype)
        replace the first ``vision_tokens`` embeddings."""
        x = self.tok_embed[tokens]
        if self.cfg.family == "vlm" and vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype),
                           x[:, self.cfg.vision_tokens:]], dim=1)
        if self.cfg.meta_tokens:
            meta = self.meta_tokens[None].expand(x.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        return x

    def encode(self, frames, remat: bool = False):
        """The audio encoder over frame embeddings [B, F, d]: the frames
        and the sinusoidal table, each cast to the model's dtype, added;
        the ``encoder`` blocks (full attention, rotary embeddings at the
        frame positions; each recomputed in the backward when ``remat``);
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
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        head = self.tok_embed.T if cfg.tie_embeddings else self.lm_head
        logits = (x @ head).float()
        if cfg.vocab_padded != cfg.vocab_size:  # mask padded vocab entries
            logits[..., cfg.vocab_size:] = -1e30
        return logits


# --------------------------------------------------------------------------
# public entry points (the reference's names; the model takes the place
# of its params pytree)
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> LM:
    """A model with the reference's initialisation (zero norms and
    biases, fan-in normal projections and experts, 0.02-normal
    embeddings and meta tokens, the SSD's as ``ssm.init_ssm``), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    CUDA card unless ``device="cpu"``). Under an ambient mesh each MoE
    layer draws every expert whole and keeps this rank's blocks."""
    model = LM(cfg, device)
    gen = torch.Generator(model.device).manual_seed(seed)
    dtype = _dtype(cfg)
    with torch.no_grad():
        model.tok_embed.copy_(embed_init(gen, model.tok_embed.shape, dtype))
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
                for w in (a.wq, a.wk, a.wv):
                    w.copy_(dense_init(gen, w.shape, 0, dtype))
                a.wo.copy_(dense_init(gen, a.wo.shape, (0, 1), dtype))
            if isinstance(blk, MoEBlock):
                moe_lib.init_moe(blk.moe, gen)
                continue
            for name, w in blk.mlp.named_parameters():
                if name.startswith("w_"):   # the biases stay zero
                    w.copy_(dense_init(gen, w.shape, 0, dtype))
        if not cfg.tie_embeddings:
            model.lm_head.copy_(dense_init(gen, model.lm_head.shape, 0,
                                           dtype))
    return model


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
    the MoE layers, an f32 scalar (zero for the other families)."""
    check_family(cfg)
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None) -> Cache:
    """Decode cache of zeros, every layer (the dense prefix first): k, v
    ``[L, B, max_len + meta_tokens, KVH, hd]`` where the layers attend
    (slot i holds position i, the meta tokens first); the SSD's ``h``
    ``[L, B, H, P, N]`` f32 and ``conv`` ``[L, B, K - 1, di + 2 N]``
    where they run it; the cross-attention's ``xk``, ``xv`` ``[L, B,
    enc_frames, KVH, hd]`` where the layers attend to an encoder."""
    check_family(cfg)
    dtype = dtype or _dtype(cfg)
    dev = resolve_device(device)
    cache: Cache = {}
    if not cfg.is_attention_free:
        shape = (cfg.n_layers, batch, max_len + cfg.meta_tokens,
                 cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros_like(cache["k"])
    if cfg.family in ("ssm", "hybrid"):
        shapes = ssm_lib.ssm_cache_shapes(cfg, batch)
        cache["h"] = torch.zeros((cfg.n_layers,) + shapes["h"],
                                 dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros((cfg.n_layers,) + shapes["conv"],
                                    dtype=dtype, device=dev)
    if cfg.enc_layers:
        cache["xk"] = torch.zeros(
            (cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv_heads,
             cfg.resolved_head_dim), dtype=dtype, device=dev)
        cache["xv"] = torch.zeros_like(cache["xk"])
    return cache


def prefill(model: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Process a full prompt (``batch`` as ``forward``'s) -> (logits [B,
    S, Vpad], decode cache with slots [0, meta_tokens + S) filled, the SSD
    states after the prompt, and the cross-attention's keys and values
    over the encoder's output)."""
    b, s = batch["tokens"].shape
    logits, states = forward(model, batch, cfg, collect_cache=True)
    cache = init_cache(cfg, b, max_len or s, device=model.device)
    for key, val in states.items():
        if key in ("k", "v"):
            cache[key][:, :, :s + cfg.meta_tokens] = val
        else:
            cache[key].copy_(val)
    return logits, cache


def decode_step(model: LM, tokens: torch.Tensor, cache: Cache, cur_pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, 1]; ``cur_pos`` the position of this token (its cache
    slot and rotary position are ``cur_pos + meta_tokens``). Returns
    (logits [B, 1, Vpad], cache): the cache is the one passed in, its
    slot written and its SSD states updated in place (the reference
    returns a new one)."""
    check_family(cfg)
    pos = int(cur_pos) + cfg.meta_tokens
    x = model.tok_embed[tokens]
    cos, sin = _rope(model, torch.tensor([pos], device=x.device))
    slot_pos = torch.arange(cache["k"].shape[2], device=x.device) \
        if "k" in cache else None
    for i, blk in enumerate(model.layers()):
        x = blk.decode(x, cos, sin, {key: c[i] for key, c in cache.items()},
                       pos, slot_pos)
    return model.logits(x), cache
