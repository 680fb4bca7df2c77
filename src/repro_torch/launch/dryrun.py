"""The dry-run census: every (architecture x input shape) cell on the
production meshes, and the paper's ANNS data-plane cells, counted per
rank. Port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell with XLA and records the
compiled module's memory, costs and collectives. The port has no
compiler to lower into, so each cell is counted, from the step's shapes
and specs on a ``sharding.MeshShape`` (no ranks, nothing allocated: the
inputs are meta tensors, ``launch/specs.py``). Per rank, each record
holds:

* ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: the
  blocks of the arguments the reference passes to ``jitted.lower``
  (parameters, optimizer state, batch; prefill: parameters and batch;
  decode: the parameters it reads, tokens, cache, ``cur_pos``) and of
  its outputs, each leaf's local block under its spec. XLA's compiled
  argument size is that sum; its output size adds 8 bytes a leaf of the
  output tuple.
* ``port_argument_bytes``: what the port places on a rank: every
  parameter's ``param_specs`` block (``models/model.py:place``; an
  expert-parallel MoE layer's experts in its blocks, a concatenated SSD
  leaf per part or contiguous; a decode counts the parameters it reads, as the
  argument size does), their optimizer state, the rank's block of the
  batch, the decode cache the rank's ``init_cache`` holds under the mesh
  (its ``cache_spec`` block) and ``cur_pos``: equal to the argument size
  in every cell, which ``tests/test_torch_census.py`` holds on both
  meshes.
* ``cost``: the matmul-class FLOPs of the port's own step on the rank
  (its heads, ``d_ff`` columns and vocabulary block where they are
  placed; its head-dim block of every head in the projections where
  ``--shard-hd-fallback`` splits the head dim, the attention then over
  every head whole (case H) or its heads (case M), and a decode's
  partial scores over its block; a decode step's slots), by part
  (projections, feed-forwards, experts at their capacity and the
  router, the SSD's products,
  attention, the LM head); a train step counts the forward, remat's
  recompute of every block and the backward
  (twice a product's forward; attention 10·D a pair against the
  forward's 4·D) over its microbatches. ``flops`` counts the pairs the
  ``flash_attention`` kernel computes (its mask's visible pairs: causal
  halves); ``attention_flops_materialised`` the same products over every
  (query, key) pair, as the kernel's plain version on the CPU computes
  them. Decode attention (``decode_attention``) reads every cache slot.
* ``collectives``: the bytes each rank receives in the port's own
  collectives for the step, by kind, as ``core/distributed.py`` makes
  them (``_gather``: an all-gather, n x the block; ``_sum_axis``: an
  all-reduce, the tensor's bytes over two ranks, else n x them;
  ``_reduce_scatter``: n x the gathered gradient): the ANNS merges, the
  gradient sums over the data axes, the loss's sums, the MoE layer's
  partial sums and copies over ``model``, its statistics over the data
  axes, the FSDP gathers of the placed weights and of the experts and
  their reduce-scatters, the row-parallel products' sums over ``model``
  and their inputs' copies, the vocab-parallel embedding's sum and
  loss's max and sums, a decode step's query gather and partial
  softmax merges over a cache whose slots are split, and under
  ``--shard-hd-fallback`` the head-dim blocks' gathers of q, k and v
  (reduce-scattered in the backward), a decode's partial scores' sum
  over ``model`` and, in case M, its query's and output's gathers.

This replaces the reference's ``launch/hlo_costs.py`` too, which parses
XLA's HLO text and has no torch input: the counts come from the port's
own ops. A cell that raises is recorded as ``FAIL: ...`` and fails the
run. Nothing falls back.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh both [--anns]

writes one JSON record a cell under ``artifacts/dryrun_torch`` (the
reference's ``cell_path`` layout; ``artifacts/dryrun`` is the
reference's). The reference's ``--attn-p-bf16`` is left out: it sets an
environment variable for its Pallas kernel only.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_is_applicable,
    get_config,
)
from repro_torch.distributed.sharding import (
    DistConfig,
    MeshShape,
    batch_spec,
    entry_axes,
    group_size,
)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import data_axes
from repro_torch.distributed.context import mesh_context
from repro_torch.models.model import (
    MLP,
    Attention,
    CrossBlock,
    GeluMLP,
    HybridBlock,
    MoEBlock,
    SSMBlock,
    global_flags,
    init_cache,
)
from repro_torch.models.ssm import BLOCK, PART, SSM
from repro_torch.models.moe import (
    EXPERT_WEIGHTS,
    MoE,
    block_specs,
    capacity,
    expert_parallel,
)
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import TrainConfig

OUT = "artifacts/dryrun_torch"
METRICS = ("loss", "aux_loss", "grad_norm", "lr", "total_loss")


def production_mesh(multi_pod: bool) -> MeshShape:
    """The reference's production meshes: 16x16 (256 ranks) or 2x16x16
    (512), as axis names and sizes."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in mesh.axis_sizes)


def arch_opt_config(arch: str) -> OptimizerConfig:
    """Per-arch optimizer memory policy (the reference's)."""
    if arch.startswith("kimi"):
        return OptimizerConfig(state_dtype="bfloat16", factored=True)
    if arch in ("command-r-plus-104b", "dbrx-132b", "internvl2-76b"):
        return OptimizerConfig(state_dtype="float32", factored=True)
    return OptimizerConfig()


def arch_train_config(arch: str, shape: ShapeConfig, multi_pod: bool,
                      target_tokens_per_microbatch: int = 32768
                      ) -> TrainConfig:
    """The reference's microbatch (gradient-accumulation) rule: cap the
    attention residuals a chip stashes (~ tokens x d_model a layer)."""
    dp = 32 if multi_pod else 16
    tokens_per_chip = shape.seq_len * max(shape.global_batch // dp, 1)
    micro = max(1, tokens_per_chip // target_tokens_per_microbatch)
    # microbatches must divide the per-shard batch
    per_shard = max(shape.global_batch // dp, 1)
    while per_shard % micro:
        micro -= 1
    accum_dtype = "bfloat16" if arch.startswith("kimi") else "float32"
    return TrainConfig(microbatches=micro, grad_accum_dtype=accum_dtype)


# ------------------------------------------------------------ bytes ----

def tree_bytes(tensors, specs, mesh) -> int:
    """The rank's bytes of a flat {name: tensor} under {name: spec}."""
    return sum(S.block_bytes(t, specs[k], mesh) for k, t in tensors.items())


def _opt_leaves(tree: Dict[str, Any]):
    """Every leaf of an optimizer state, or of its specs, in one order."""
    yield tree["step"]
    for what in ("m", "v"):
        for leaf in tree[what].values():
            if isinstance(leaf, dict):
                yield leaf["row"]
                yield leaf["col"]
            else:
                yield leaf


def opt_bytes(state, specs, mesh) -> int:
    return sum(S.block_bytes(t, spec, mesh) for t, spec in
               zip(_opt_leaves(state), _opt_leaves(specs)))


def whole_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rank_rows(batch: int, mesh) -> int:
    """A rank's rows of a batch (``batch_spec``: the whole batch where the
    data axes do not divide it)."""
    entry = batch_spec(batch, mesh)[0]
    return batch // group_size(mesh, entry)


def data_ranks(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


# ------------------------------------------------------------ FLOPs ----

def visible_pairs(sq: int, sk: int, causal: bool, window: int = 0,
                  meta_tokens: int = 0) -> int:
    """(query, key) pairs the attention mask leaves visible (the
    ``flash_attention`` kernel's mask: query row r at position r + Sk -
    Sq; with a window, the keys inside it or among the first
    ``meta_tokens``)."""
    if not causal:
        return sq * sk
    p = np.arange(sq, dtype=np.int64) + (sk - sq)
    if window <= 0:
        return int((p + 1).sum())
    inside = np.minimum(window, p + 1)
    meta = np.clip(np.minimum(meta_tokens, p - window + 1), 0, None)
    return int((inside + meta).sum())


class Flops:
    """Matmul-class FLOPs by part; attention's apart, over the visible and
    over every (query, key) pair. A forward product also notes how many
    products of its size its backward makes (``backward``: 2, or fewer
    where an operand needs no gradient), and whether a block's
    recompute under remat skips it (``tail``: the block's last product,
    whose output no backward reads; ``torch.utils.checkpoint`` stops the
    recompute once the saved tensors are back)."""

    def __init__(self):
        self.parts: Dict[str, int] = {}
        self.backward: Dict[str, int] = {}
        self.tails: Dict[str, int] = {}
        self.attn = np.zeros(2, dtype=np.int64)   # visible, all

    def add(self, part: str, n: int, backward: int = 2,
            tail: bool = False) -> None:
        for acc, x in ((self.parts, n), (self.backward, backward * n),
                       (self.tails, n if tail else 0)):
            acc[part] = acc.get(part, 0) + int(x)

    def attention(self, visible: int, every: int) -> None:
        self.attn += (visible, every)

    def train(self, remat: bool) -> "Flops":
        """This forward in a train step: the forward, remat's recompute
        (with ``remat``) and the backward; attention's backward is 10·D a
        pair against its forward's 4·D."""
        out = Flops()
        for k, v in self.parts.items():
            out.parts[k] = 2 * v - self.tails[k] if remat else v
            out.parts[k] += self.backward[k]
        out.attn = self.attn // 4 * (18 if remat else 14)
        return out

    def times(self, n: int) -> "Flops":
        out = Flops()
        out.parts = {k: v * n for k, v in self.parts.items()}
        out.attn = self.attn * n
        return out

    def __iadd__(self, other: "Flops") -> "Flops":
        for k, v in other.parts.items():
            self.add(k, v, 0)
        self.attn = self.attn + other.attn
        return self

    def record(self) -> Dict[str, Any]:
        vis, every = (int(x) for x in self.attn)
        matmul = sum(self.parts.values())
        return {"flops": float(matmul + vis),
                "attention_flops": float(vis),
                "attention_flops_materialised": float(every),
                "by_part": {**{k: float(v) for k, v in self.parts.items()},
                            "attention": float(vis)}}


class Share:
    """A rank's share of the placed products (``models/model.py``): the
    query heads it attends with, the q and k/v columns it projects (its
    heads' or, where ``model`` splits the head dim, every head's block of
    it), its ``d_ff`` columns, the shared experts' and its vocabulary block,
    and the SSD's ``in_proj`` columns, its heads (``ssd_heads``: the
    rank's in case 1, all in case 2) and its ``out_proj`` rows; the
    config's whole widths where nothing is placed."""

    def __init__(self, cfg: ModelConfig, model=None):
        hd = cfg.resolved_head_dim
        self.heads = cfg.n_heads
        self.q_cols, self.kv_cols = cfg.n_heads * hd, cfg.n_kv_heads * hd
        self.ff, self.vocab = cfg.d_ff, cfg.vocab_padded
        self.shared_ff = cfg.d_ff * cfg.n_shared_experts
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        self.ssd_in, self.ssd_heads, self.ssd_rows = 2 * di + 2 * n + nh, \
            nh, di
        if model is None or not block_specs(model):
            return
        attn = next((m for m in model.modules() if isinstance(m, Attention)),
                    None)
        if attn is not None:
            self.heads = attn.wq.shape[1]
            self.q_cols = attn.wq.shape[1] * attn.wq.shape[2]
            self.kv_cols = attn.wk.shape[1] * attn.wk.shape[2]
        mlp = next((m for m in model.modules()
                    if isinstance(m, (MLP, GeluMLP))), None)
        if mlp is not None:
            self.ff = (mlp.w_gate if isinstance(mlp, MLP)
                       else mlp.w_fc).shape[1]
        ssm = next((m for m in model.modules() if isinstance(m, SSM)), None)
        if ssm is not None:
            self.ssd_in, self.ssd_rows = ssm.in_proj.shape[1], \
                ssm.out_proj.shape[0]
            sp = ssm.split_of()
            self.ssd_heads = sp.local(nh) if sp else nh
        layer = next((m for m in model.modules() if isinstance(m, MoE)),
                     None)
        if layer is not None and cfg.n_shared_experts:
            self.shared_ff = layer.shared_gate.shape[1]
        self.vocab = model.tok_embed.shape[0]


def _attn_proj(f: Flops, cfg: ModelConfig, sh: Share, tq: int, tkv: int,
               part: str = "attention projections") -> None:
    """q and o over ``tq`` tokens, k and v over ``tkv``."""
    f.add(part, 2 * cfg.d_model * (2 * sh.q_cols * tq + 2 * sh.kv_cols
                                   * tkv))


def _attention(f: Flops, cfg: ModelConfig, sh: Share, b: int, sq: int,
               sk: int, causal: bool, window: int = 0,
               meta_tokens: int = 0) -> None:
    unit = 2 * b * sh.heads * cfg.resolved_head_dim   # q.k or p.v
    f.attention(2 * unit * visible_pairs(sq, sk, causal, window,
                                         meta_tokens),
                2 * unit * sq * sk)


def _decode_attention(f: Flops, b: int, slots: int, cols: int):
    """``decode_attention``: every slot (the rank's), plain products
    either way, over ``cols`` columns of the query heads (heads x the
    head-dim columns the rank holds)."""
    n = 4 * b * cols * slots
    f.attention(n, n)


def _ffn(f: Flops, cfg: ModelConfig, sh: Share, t: int) -> None:
    """SwiGLU (3 products) or the audio family's GELU MLP (2), the last
    of its block."""
    n = 2 if cfg.family == "audio" else 3
    one = 2 * t * cfg.d_model * sh.ff
    f.add("feed-forward", (n - 1) * one)
    f.add("feed-forward", one, tail=True)


def _ssd(f: Flops, cfg: ModelConfig, sh: Share, b: int, s0: int,
         last: bool) -> None:
    """``ssd_forward`` on the rank's share: the projections and the
    chunked products (C.B^T over the whole state); ``last``: its out
    projection is its block's last product."""
    d, n, nh, p = cfg.d_model, cfg.ssm_state, sh.ssd_heads, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s0)
    nc = -(-s0 // q)
    f.add("ssd projections", 2 * b * s0 * d * sh.ssd_in)
    # C.B^T; the decay-weighted product with x
    f.add("ssd products", 2 * b * nc * q * q * n + 2 * b * nc * nh * q * q * p)
    # the chunk states and their contribution through C: over one chunk
    # the states feed only the final state (no gradient in a train step)
    # and the state entering it is zeros (no gradient either)
    states = 2 * b * nc * nh * p * q * n
    f.add("ssd products", states, backward=2 if nc > 1 else 0)
    f.add("ssd products", states, backward=2 if nc > 1 else 1)
    f.add("ssd projections", 2 * b * s0 * sh.ssd_rows * d, tail=last)


def _ssd_decode(f: Flops, cfg: ModelConfig, sh: Share, b: int) -> None:
    d, n, p = cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim
    f.add("ssd projections", 2 * b * d * sh.ssd_in
          + 2 * b * sh.ssd_rows * d)
    f.add("ssd products", 2 * b * sh.ssd_heads * p * n)


class MoeRank:
    """One rank's MoE layer geometry for a call of ``b_loc`` rows x ``s``
    positions out of a (micro)batch of ``whole`` rows: its experts and
    their capacity, as ``moe_forward`` picks them."""

    def __init__(self, cfg: ModelConfig, mesh, whole: int, b_loc: int,
                 s: int, shared_ff: Optional[int] = None):
        self.t = b_loc * s
        self.shared_ff = shared_ff or cfg.d_ff * cfg.n_shared_experts
        self.parallel = expert_parallel(cfg, mesh)
        if self.parallel:
            dp = data_ranks(mesh)
            tokens = whole * s
            self.experts = cfg.n_experts // mesh.shape["model"]
            self.cap = capacity(cfg, tokens // dp if tokens % dp == 0
                                else tokens)
        else:
            self.experts = cfg.n_experts
            self.cap = capacity(cfg, whole * s)

    def flops(self, f: Flops, cfg: ModelConfig, with_aux: bool) -> None:
        d, ff = cfg.d_model, cfg.d_ff
        # routing; the aux loss takes the router product again
        f.add("router", (2 if with_aux else 1) * 2 * self.t * d
              * cfg.n_experts)
        f.add("experts", 3 * 2 * self.experts * self.cap * d * ff)
        if cfg.n_shared_experts:   # the block's last product
            one = 2 * self.t * d * self.shared_ff
            f.add("feed-forward", 2 * one)
            f.add("feed-forward", one, tail=True)


def _layers_forward(cfg: ModelConfig, sh: Share, b: int, s: int,
                    moe: Optional[MoeRank], with_aux: bool) -> Flops:
    """Every block's full-sequence forward (the encoder's included) on
    ``b`` rows of ``s`` tokens (plus the hybrid family's meta tokens)."""
    f = Flops()
    n_main = cfg.n_layers - cfg.n_dense_layers
    s2 = s + cfg.meta_tokens
    t = b * s2
    for _ in range(cfg.n_dense_layers):
        _attn_proj(f, cfg, sh, t, t)
        _attention(f, cfg, sh, b, s2, s2, True)
        _ffn(f, cfg, sh, t)
    if cfg.family == "ssm":
        for _ in range(n_main):
            _ssd(f, cfg, sh, b, s2, last=True)
    elif cfg.family == "hybrid":
        for is_global in global_flags(cfg, n_main):
            _attn_proj(f, cfg, sh, t, t)
            _attention(f, cfg, sh, b, s2, s2, True,
                       0 if is_global else cfg.attn_window, cfg.meta_tokens)
            _ssd(f, cfg, sh, b, s2, last=False)
            _ffn(f, cfg, sh, t)
    else:
        for _ in range(n_main):
            _attn_proj(f, cfg, sh, t, t)
            _attention(f, cfg, sh, b, s2, s2, True)
            if cfg.family == "moe":
                moe.flops(f, cfg, with_aux)
            else:
                _ffn(f, cfg, sh, t)
            if cfg.enc_layers:   # cross-attention over the encoder's frames
                _attn_proj(f, cfg, sh, t, b * cfg.enc_frames,
                           "cross-attention projections")
                _attention(f, cfg, sh, b, s2, cfg.enc_frames, False)
    te = b * cfg.enc_frames
    for _ in range(cfg.enc_layers):
        _attn_proj(f, cfg, sh, te, te)
        _attention(f, cfg, sh, b, cfg.enc_frames, cfg.enc_frames, False)
        _ffn(f, cfg, sh, te)
    return f


def _layers_decode(cfg: ModelConfig, sh: Share, b: int, slots: int,
                   moe: Optional[MoeRank], cols: int,
                   cross: Tuple[int, int] = (0, 0)) -> Flops:
    """Every block's decode step on ``b`` rows over a cache of ``slots``
    k/v slots (the rank's), ``cols`` query columns reading each
    (``_decode_cols``); ``cross``: the same of the cross-attention's
    ``xk``/``xv``."""
    f = Flops()
    n_main = cfg.n_layers - cfg.n_dense_layers
    for _ in range(cfg.n_dense_layers):
        _attn_proj(f, cfg, sh, b, b)
        _decode_attention(f, b, slots, cols)
        _ffn(f, cfg, sh, b)
    for _ in range(n_main):
        if cfg.family == "ssm":
            _ssd_decode(f, cfg, sh, b)
            continue
        _attn_proj(f, cfg, sh, b, b)
        _decode_attention(f, b, slots, cols)
        if cfg.family == "hybrid":
            _ssd_decode(f, cfg, sh, b)
        if cfg.family == "moe":
            moe.flops(f, cfg, with_aux=False)
        else:
            _ffn(f, cfg, sh, b)
        if cfg.enc_layers:   # q and o only: xk and xv are cached
            _attn_proj(f, cfg, sh, b, 0, "cross-attention projections")
            _decode_attention(f, b, *cross)
    return f


def _head(cfg: ModelConfig, sh: Share, t: int) -> Flops:
    f = Flops()
    f.add("lm head", 2 * t * cfg.d_model * sh.vocab)
    return f


def _moe(cfg, mesh, whole, b_loc, s, shared_ff: Optional[int] = None
         ) -> Optional[MoeRank]:
    return MoeRank(cfg, mesh, whole, b_loc, s, shared_ff) \
        if cfg.family == "moe" else None


def decode_cache(cfg: ModelConfig, big: int, slots: int, mesh,
                 dist: Optional[DistConfig] = None):
    """The rank's decode cache (on the meta device) of a batch of ``big``
    rows and ``slots`` positions, as ``init_cache`` lays it out."""
    with mesh_context(mesh, dist):
        return init_cache(cfg, big, slots, device=S.META)


def _decode_cols(cfg: ModelConfig, share: Share, cache,
                 cross: bool = False) -> int:
    """The query columns that read the rank's slots (``cross``: of
    ``xk``/``xv``) in a decode step: every head's where ``model`` splits
    the slots (the query gathered over it), every head's block of the
    head dim the cache holds where ``model`` splits that, else the rank's
    heads'."""
    axes = getattr(cache, "x_seq_axes" if cross else "seq_axes", ())
    width = cache["xk" if cross else "k"].shape[-1]
    if "model" in axes or width < cfg.resolved_head_dim:
        return cfg.n_heads * width
    return share.heads * width


def step_flops(cfg: ModelConfig, shape: ShapeConfig, mesh,
               tcfg: Optional[TrainConfig] = None, model=None,
               dist: Optional[DistConfig] = None) -> Flops:
    """The port's step on one rank of ``mesh``; ``model``: the rank's
    placed (abstract) model, default ``abstract_params(cfg, mesh)``."""
    big, s = shape.global_batch, shape.seq_len
    model = model if model is not None else S.abstract_params(cfg, mesh,
                                                              dist)
    sh = Share(cfg, model)
    if shape.kind == "decode":
        b = rank_rows(big, mesh)
        cache = decode_cache(cfg, big, s, mesh, dist)
        slots = cache["k"].shape[2] if "k" in cache else 0
        cross = (cache["xk"].shape[2], _decode_cols(cfg, sh, cache, True)) \
            if "xk" in cache else (0, 0)
        f = _layers_decode(cfg, sh, b, slots,
                           _moe(cfg, mesh, big, b, 1, sh.shared_ff),
                           _decode_cols(cfg, sh, cache) if "k" in cache
                           else 0, cross)
        f += _head(cfg, sh, b)
        return f
    if shape.kind == "prefill":
        b = rank_rows(big, mesh)
        f = _layers_forward(cfg, sh, b, s,
                            _moe(cfg, mesh, big, b, s, sh.shared_ff), False)
        f += _head(cfg, sh, b * s)
        return f
    n = tcfg.microbatches
    size = big // n
    b = rank_rows(size, mesh)
    layers = _layers_forward(cfg, sh, b, s,
                             _moe(cfg, mesh, size, b, s, sh.shared_ff), True)
    f = layers.train(cfg.remat)
    f += _head(cfg, sh, b * s).train(remat=False)
    return f.times(n)


# ------------------------------------------------------- collectives ---

class Traffic:
    """Bytes a rank receives by kind of collective, as
    ``core/distributed.py`` makes them."""

    def __init__(self):
        self.by_kind: Dict[str, int] = {}

    def add(self, kind: str, nbytes: int) -> None:
        self.by_kind[kind] = self.by_kind.get(kind, 0) + int(nbytes)

    def gather(self, mesh, axis: str, nbytes: int) -> int:
        """``_gather``; returns the gathered bytes."""
        out = mesh.shape[axis] * nbytes
        self.add("all-gather", out)
        return out

    def psum(self, mesh, axes, nbytes: int) -> None:
        """``psum``: ``_sum_axis`` over each axis in turn."""
        for a in axes:
            n = mesh.shape[a]
            self.add("all-reduce", nbytes if n == 2 else n * nbytes)

    def reduce_scatter(self, mesh, axis: str, nbytes: int) -> None:
        self.add("reduce-scatter", mesh.shape[axis] * nbytes)

    def record(self) -> Dict[str, float]:
        out = {k: float(v) for k, v in sorted(self.by_kind.items())}
        out["total"] = float(sum(self.by_kind.values()))
        return out


def _moe_traffic(tr: Traffic, cfg: ModelConfig, model, mesh, moe: MoeRank,
                 whole: int, b_loc: int, *, forwards: int, backward: bool,
                 with_aux: bool) -> None:
    """One MoE layer's collectives: ``forwards`` forward passes (2 under
    remat) and, with ``backward``, one backward."""
    dtype_bytes = getattr(torch, cfg.dtype).itemsize
    d, e = cfg.d_model, cfg.n_experts
    daxes = data_axes(mesh)
    dp = data_ranks(mesh)
    if moe.parallel:
        layer = next(m for m in model.modules() if isinstance(m, MoE))
        for name in EXPERT_WEIGHTS:
            w, spec = getattr(layer, name), layer.specs[name]
            dim = 2 if name == "w_down" else 1
            nbytes, steps = w.numel() * w.element_size(), []
            for ax in reversed(entry_axes(spec[dim])):
                steps.append((ax, nbytes))
                nbytes = mesh.shape[ax] * nbytes
            for ax, block in steps:
                for _ in range(forwards):
                    tr.gather(mesh, ax, block)
            if backward:   # each gather's gradient, the last first
                for ax, block in reversed(steps):
                    tr.reduce_scatter(mesh, ax, mesh.shape[ax] * block)
        tokens = moe.t * d * dtype_bytes
        # the partial sums; remat's recompute stops before them unless the
        # shared experts' products follow
        for _ in range(forwards if cfg.n_shared_experts else 1):
            tr.psum(mesh, ("model",), tokens)
        if backward:   # the copies over model: the tokens' and router's
            tr.psum(mesh, ("model",), tokens)
            tr.psum(mesh, ("model",), d * e * dtype_bytes)
    elif whole != b_loc:   # the queue starts: counts over the data axes
        nbytes = e * 8
        for _ in range(forwards):
            n = nbytes
            for a in reversed(daxes):
                n = tr.gather(mesh, a, n)
    if with_aux and whole != b_loc and dp > 1:
        for _ in range(forwards):   # top-1 counts (int64), probability sums
            tr.psum(mesh, daxes, e * 8)
            tr.psum(mesh, daxes, e * 4)


def _gathers(tr: Traffic, mesh, mod, names, times: int,
             backward: bool) -> None:
    """``Placed.weight``'s FSDP gathers of ``mod``'s blocks ``names``,
    ``times`` forwards, and with ``backward`` their reduce-scatters."""
    daxes = data_axes(mesh)
    for name in names:
        spec = mod.specs.get(name)
        if spec is None:
            continue
        p = getattr(mod, name)
        nbytes, steps = p.numel() * p.element_size(), []
        for entry in spec:
            for ax in reversed([a for a in entry_axes(entry) if a in daxes]):
                steps.append((ax, nbytes))
                nbytes *= mesh.shape[ax]
        for _ in range(times):
            for ax, block in steps:
                tr.gather(mesh, ax, block)
        if backward:
            for ax, block in reversed(steps):
                tr.reduce_scatter(mesh, ax, mesh.shape[ax] * block)


ATTN_WEIGHTS = ("wq", "wk", "wv", "bq", "bk", "bv", "wo")
SSM_WEIGHTS = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
               "ssm_norm", "out_proj")
MODEL = ("model",)


def _attn_traffic(tr: Traffic, cfg: ModelConfig, attn, mesh, b: int,
                  s: int, *, forwards: int, backward: bool, cache=None,
                  kv_len: Optional[int] = None,
                  names=ATTN_WEIGHTS) -> None:
    """An attention's collectives on ``b`` rows x ``s`` positions (its
    keys and values over ``kv_len`` positions of another input, a
    cross-attention's): the FSDP gathers of ``names``, with a decode
    ``cache`` whose slots are split the query's gather and the partial
    softmaxes' merges, the out projection's sum over ``model`` and, in the
    backward, its inputs' copies (k's and v's where the kv heads are
    whole). Where ``model`` splits the head dim: the projections' gathers
    over it (q's in case H; a cached cross-attention's decode gathers q
    alone) and their reduce-scatters, and a decode's query gather over the
    heads (case M), its partial scores' sum over ``model`` and its
    output's gather over the head dim (case M)."""
    dtb = getattr(torch, cfg.dtype).itemsize
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    _gathers(tr, mesh, attn, names, forwards, backward)
    q_hd = attn.split("wq", 2)
    kv = b * (s if kv_len is None else kv_len)
    cached_kv = cache is not None and kv_len is not None
    if attn.hd:
        m = mesh.shape["model"]
        for _ in range(forwards):
            if q_hd:
                tr.gather(mesh, "model", b * s * h * hd // m * dtb)
            if not cached_kv:
                for _ in range(2):
                    tr.gather(mesh, "model", kv * kvh * hd // m * dtb)
        if cache is not None:
            if attn.tp:
                tr.gather(mesh, "model", b * attn.wq.shape[1] * hd * dtb)
            tr.psum(mesh, MODEL, b * h * cache["k"].shape[1] * 4)
            for a in cache.seq_axes:
                tr.gather(mesh, a, b * h * (hd // m + 2) * 4)
            if attn.tp:
                tr.gather(mesh, "model", b * h * hd // m * dtb)
    elif cache is not None and cache.seq_axes:
        heads = attn.wq.shape[1]
        if attn.tp and "model" in cache.seq_axes:
            tr.gather(mesh, "model", b * heads * hd * dtb)
            heads = cfg.n_heads
        for a in cache.seq_axes:
            tr.gather(mesh, a, b * heads * (hd + 2) * 4)
    if not (attn.tp or q_hd):
        return
    for _ in range(forwards):
        tr.psum(mesh, MODEL, b * s * d * dtb)
    if not backward:
        return
    tr.psum(mesh, MODEL, b * s * d * dtb)
    if attn.hd:   # the gathers' reduce-scatters; the other input's copy
        if q_hd:
            tr.reduce_scatter(mesh, "model", b * s * h * hd * dtb)
        for _ in range(2):
            tr.reduce_scatter(mesh, "model", kv * kvh * hd * dtb)
        if kv_len is not None:
            tr.psum(mesh, MODEL, kv * d * dtb)
    elif not attn.split("wk", 1):   # k's and v's copies
        for _ in range(2):
            tr.psum(mesh, MODEL, kv * cfg.n_kv_heads * hd * dtb)
    elif kv_len is not None:      # the other input's copy
        tr.psum(mesh, MODEL, kv * d * dtb)


def _ffn_traffic(tr: Traffic, cfg: ModelConfig, blk, mesh, b: int, s: int,
                 *, forwards: int, backward: bool) -> None:
    """A block's feed-forward (the MoE's shared experts in an MoE block;
    the experts' are ``_moe_traffic``'s): its FSDP gathers, its sum over
    ``model`` (its block's last product: once under remat) and its
    input's copy in the backward."""
    act = b * s * cfg.d_model * getattr(torch, cfg.dtype).itemsize
    if isinstance(blk, MoEBlock):
        ffn, names = blk.moe, ("shared_gate", "shared_up", "shared_down")
    elif isinstance(blk.mlp, GeluMLP):
        ffn, names = blk.mlp, ("w_fc", "b_fc", "w_out")
    else:
        ffn, names = blk.mlp, ("w_gate", "w_up", "w_down")
    _gathers(tr, mesh, ffn, names, forwards, backward)
    if ffn.split(names[0], 1):
        tr.psum(mesh, MODEL, act)
        if backward:
            tr.psum(mesh, MODEL, act)


def _ssm_traffic(tr: Traffic, cfg: ModelConfig, ssm, mesh, b: int, s: int,
                 *, forwards: int, backward: bool, last: bool,
                 decode: bool = False) -> None:
    """An SSD's collectives (``models/ssm.py``'s cases): the FSDP
    gathers; ``in_proj`` per part: the B/C gather (reduce-scattered back)
    and, in the backward, the copy of the input; contiguous: the gather of
    its output (``gather_own``: no backward traffic) and the copy of the
    input; a split conv under a whole output: the gather of the conv's
    output (``gather_own``) and the copy of its input; the heads split
    under a whole output: in the backward, the copies of z, the conv's
    output and dt; the heads split: the norm's sum of squares and, in the
    backward, the copies of ``A_log``, ``D`` and ``dt_bias`` and of the
    norm's sum; the heads whole and the rows split: the copy of the
    normed output in the backward; the out projection's sum over
    ``model`` (once under remat where it is the block's last product). A
    decode step's conv output is f32."""
    _gathers(tr, mesh, ssm, SSM_WEIGHTS, forwards, backward)
    sp = ssm.split_of()
    if sp is None:
        return
    dtb = getattr(torch, cfg.dtype).itemsize
    cb = 4 if decode else dtb
    t, m = b * s, sp.m
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    xbc, whole_heads = di + 2 * n, sp.heads and sp.proj != PART
    for _ in range(forwards):
        if sp.proj == BLOCK:
            tr.gather(mesh, "model", t * (2 * di + 2 * n + nh) // m * dtb)
        if sp.proj == PART:
            tr.gather(mesh, "model", t * 2 * n // m * cb)
        elif sp.conv is not None:
            tr.gather(mesh, "model", t * xbc // m * cb)
        if sp.heads:
            tr.psum(mesh, MODEL, t * 4)
    if sp.rows:
        for _ in range(1 if last else forwards):
            tr.psum(mesh, MODEL, t * d * dtb)
    if not backward:
        return
    if sp.proj is not None:
        tr.psum(mesh, MODEL, t * d * dtb)
    if sp.proj == PART:
        tr.reduce_scatter(mesh, "model", t * 2 * n * dtb)
    elif sp.conv is not None:
        tr.psum(mesh, MODEL, t * xbc * dtb)
    if whole_heads:
        for width in (di, xbc, nh):
            tr.psum(mesh, MODEL, t * width * dtb)
    if sp.heads:
        for _ in range(3):
            tr.psum(mesh, MODEL, nh * 4)
        tr.psum(mesh, MODEL, t * 4)
    elif sp.rows:
        tr.psum(mesh, MODEL, t * di * 4)


def _block_traffic(tr: Traffic, cfg: ModelConfig, blk, mesh, b: int,
                   s: int, *, forwards: int, backward: bool,
                   cache=None) -> None:
    """A block's collectives of the placed weights (the experts' are
    ``_moe_traffic``'s) on ``b`` rows x ``s`` positions: its attention's
    (and a decoder layer's cross-attention's over the encoder's frames,
    whose decode reads its cached ``xk``/``xv``: only ``wq``, ``bq`` and
    ``wo`` are gathered), its SSD's and its feed-forward's; with
    ``forwards`` 2 the block recomputed under remat. ``cache``: a decode
    step's (the rank's layout)."""
    decode = cache is not None
    if isinstance(blk, SSMBlock):
        _ssm_traffic(tr, cfg, blk.ssm, mesh, b, s, forwards=forwards,
                     backward=backward, last=True, decode=decode)
        return
    _attn_traffic(tr, cfg, blk.attn, mesh, b, s, forwards=forwards,
                  backward=backward, cache=cache)
    if isinstance(blk, HybridBlock):
        _ssm_traffic(tr, cfg, blk.ssm, mesh, b, s, forwards=forwards,
                     backward=backward, last=False, decode=decode)
    if isinstance(blk, CrossBlock):
        _attn_traffic(tr, cfg, blk.xattn, mesh, b, s, forwards=forwards,
                      backward=backward,
                      cache=cache.cross() if decode else None,
                      kv_len=cfg.enc_frames,
                      names=("wq", "bq", "wo") if decode else ATTN_WEIGHTS)
    _ffn_traffic(tr, cfg, blk, mesh, b, s, forwards=forwards,
                 backward=backward)


def _embed_head_traffic(tr: Traffic, cfg: ModelConfig, model, mesh,
                        b: int, s: int, t_head: int, *, backward: bool,
                        loss: bool) -> None:
    """The embedding's and the LM head's collectives (``t_head`` tokens
    through the head) and, with ``loss``, the vocab-parallel loss's: the
    embedding's gathers and its sum over ``model`` where the vocabulary
    is split, the head's gathers (the embedding's again when tied) and
    its input's copy in the backward, the max and the two sums of the
    loss over ``model``."""
    dtb = getattr(torch, cfg.dtype).itemsize
    _gathers(tr, mesh, model, ("tok_embed",), 1, backward)
    _gathers(tr, mesh, model, ("tok_embed",) if cfg.tie_embeddings
             else ("lm_head",), 1, backward)
    if not model.split("tok_embed", 0):
        return
    tr.psum(mesh, MODEL, b * s * cfg.d_model * dtb)
    if backward:
        tr.psum(mesh, MODEL, t_head * cfg.d_model * dtb)
    if loss:
        tr.gather(mesh, "model", t_head * 4)
        for _ in range(2):
            tr.psum(mesh, MODEL, t_head * 4)


def _optimizer_traffic(tr: Traffic, model, state, mesh) -> None:
    """``apply_updates`` on a rank holding blocks: the global norm's sums
    over each group of axes, and a factored block's statistics averaged
    over the axes of the dims they average."""
    specs = block_specs(model)
    if not specs:
        return
    groups = set()
    for name, p in model.named_parameters():
        spec = specs.get(name)
        groups.add(tuple(a for i in range(p.dim())
                         for a in (entry_axes(spec[i]) if spec else ())))
    for axes in groups:
        tr.psum(mesh, axes, 4)
    for name, spec in specs.items():
        v = state["v"][name]
        if not isinstance(v, dict):
            continue
        p = v["row"].dim() + 1
        last = entry_axes(spec[p - 1])
        rows = entry_axes(spec[p - 2])
        tr.psum(mesh, last, v["row"].numel() * 4)
        tr.psum(mesh, rows, v["col"].numel() * 4)
        tr.psum(mesh, rows, v["row"].numel() // v["row"].shape[-1] * 4)


def step_traffic(cfg: ModelConfig, shape: ShapeConfig, mesh, model,
                 state=None, batch=None,
                 tcfg: Optional[TrainConfig] = None,
                 dist: Optional[DistConfig] = None) -> Traffic:
    """The collectives of the port's step on one rank of ``mesh``;
    ``model`` (and for a train step ``state`` and ``batch``): the rank's
    abstract model as the port places it, its optimizer state and the
    whole batch."""
    tr = Traffic()
    if all(n == 1 for n in mesh.axis_sizes):
        return tr
    big, s = shape.global_batch, shape.seq_len
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.family == "moe" else 0
    placed = bool(block_specs(model))
    if shape.kind != "train":
        b = rank_rows(big, mesh)
        s_call = 1 if shape.kind == "decode" else s
        moe = _moe(cfg, mesh, big, b, s_call)
        cache = decode_cache(cfg, big, s, mesh, dist) \
            if shape.kind == "decode" else None
        if placed:
            _embed_head_traffic(tr, cfg, model, mesh, b, s_call,
                                b if shape.kind == "decode" else b * s,
                                backward=False, loss=False)
            if cache is None:   # the prefill runs the encoder
                for blk in model.encoder:
                    _block_traffic(tr, cfg, blk, mesh, b, cfg.enc_frames,
                                   forwards=1, backward=False)
            for i, blk in enumerate(model.layers()):
                _block_traffic(tr, cfg, blk, mesh, b,
                               s_call + cfg.meta_tokens * (cache is None),
                               forwards=1, backward=False,
                               cache=None if cache is None
                               else cache.layer(i))
        for _ in range(n_moe):
            _moe_traffic(tr, cfg, model, mesh, moe, big, b, forwards=1,
                         backward=False, with_aux=False)
        return tr
    daxes, dp = data_axes(mesh), data_ranks(mesh)
    n = tcfg.microbatches
    size = big // n
    b = rank_rows(size, mesh)
    if n > 1:   # each batch leaf's block gathered whole first
        for t in batch.values():
            nbytes = t.numel() * t.element_size() // (big // rank_rows(
                big, mesh))
            if rank_rows(big, mesh) != big:
                for a in reversed(daxes):
                    nbytes = tr.gather(mesh, a, nbytes)
    shared = dp > 1 and size % dp == 0
    moe = _moe(cfg, mesh, size, b, s)
    forwards = 2 if cfg.remat else 1
    for _ in range(n):
        if shared:   # the loss's sums
            tr.psum(mesh, daxes, 3 * 4)
        if placed:
            _embed_head_traffic(tr, cfg, model, mesh, b, s, b * s,
                                backward=True, loss=True)
            for blk in model.encoder:
                _block_traffic(tr, cfg, blk, mesh, b, cfg.enc_frames,
                               forwards=forwards, backward=True)
            for blk in model.layers():
                _block_traffic(tr, cfg, blk, mesh, b, s + cfg.meta_tokens,
                               forwards=forwards, backward=True)
        for _ in range(n_moe):
            _moe_traffic(tr, cfg, model, mesh, moe, size, b,
                         forwards=forwards, backward=True, with_aux=True)
    if dp > 1:   # each gradient over the data axes its spec leaves whole
        specs = block_specs(model)
        acc = getattr(torch, tcfg.grad_accum_dtype)
        for name, p in model.named_parameters():
            held = {a for e in specs.get(name, ()) for a in entry_axes(e)}
            nbytes = p.numel() * (acc if n > 1 else p.dtype).itemsize
            tr.psum(mesh, [a for a in daxes if a not in held], nbytes)
    _optimizer_traffic(tr, model, state, mesh)
    return tr


# ------------------------------------------------------------- cells ---

def unread_in_decode(name: str) -> bool:
    """The parameters a decode step never reads, which ``jax.jit`` drops
    from the reference's compiled arguments (``keep_unused=False``): the
    meta tokens' rows (prefill only), the audio encoder, and the
    cross-attention's k and v projections (their keys and values are
    cached)."""
    return name in ("meta_tokens", "enc_norm") \
        or name.startswith("encoder.") \
        or any(name.endswith(f".xattn.{w}") for w in ("wk", "wv", "bk", "bv"))


def lm_record(cfg: ModelConfig, shape: ShapeConfig, mesh,
              dist: Optional[DistConfig] = None,
              ocfg: Optional[OptimizerConfig] = None,
              tcfg: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """The census of one applicable LM cell on ``mesh``: memory, the
    port's placement, FLOPs and collectives of one rank (``ocfg`` and
    ``tcfg`` for a train cell)."""
    dist = dist or DistConfig()
    rec: Dict[str, Any] = {}
    model = S.abstract_params(cfg)
    params = dict(model.named_parameters())
    pspecs = S.param_specs(model, mesh, dist)
    placed = S.abstract_params(cfg, mesh, dist)
    placed_params = dict(placed.named_parameters())
    read = params if shape.kind != "decode" else {
        k: p for k, p in params.items() if not unread_in_decode(k)}
    args = tree_bytes(read, pspecs, mesh)
    port = whole_bytes(p for k, p in placed_params.items() if k in read)
    big = shape.global_batch
    if shape.kind == "train":
        rec["microbatches"] = tcfg.microbatches
        state = S.abstract_opt_state(cfg, ocfg, model)
        ospecs = S.opt_shardings(cfg, ocfg, mesh, dist, state)
        batch = S.train_inputs(cfg, shape)
        bspecs = S.batch_shardings(batch, mesh, dist)
        placed_state = S.abstract_opt_state(cfg, ocfg, placed, mesh)
        state_bytes = opt_bytes(state, ospecs, mesh)
        batch_bytes = tree_bytes(batch, bspecs, mesh)
        out = args + state_bytes + 4 * len(METRICS)
        args += state_bytes + batch_bytes
        port += whole_bytes(_opt_leaves(placed_state)) + batch_bytes
        traffic = step_traffic(cfg, shape, mesh, placed, placed_state, batch,
                               tcfg, dist)
    else:
        if shape.kind == "prefill":
            batch = S.prefill_inputs(cfg, shape)
            cache = init_cache(cfg, big, shape.seq_len, device=S.META)
            logits = (big, shape.seq_len)
            extra = tree_bytes(batch, S.batch_shardings(batch, mesh, dist),
                               mesh)
            args += extra
            port += extra
        else:
            tokens, cache, cur_pos = S.decode_inputs(cfg, shape)
            logits = (big, 1)
            extra = S.block_bytes(tokens, batch_spec(big, mesh, dist, 1),
                                  mesh)
            extra += S.block_bytes(cur_pos, (), mesh)
            args += extra
            own = decode_cache(cfg, big, shape.seq_len, mesh, dist)
            port += extra + whole_bytes(own.values())
        cspecs = S.cache_shardings(cfg, cache, big, mesh, dist)
        cache_bytes = tree_bytes(cache, cspecs, mesh)
        if shape.kind == "decode":
            args += cache_bytes
        out = cache_bytes + math.prod(logits) * cfg.vocab_padded * 4 \
            // group_size(mesh, batch_spec(big, mesh, dist)[0])
        traffic = step_traffic(cfg, shape, mesh, placed, dist=dist)
    rec["memory"] = {"argument_size_in_bytes": int(args),
                     "output_size_in_bytes": int(out)}
    rec["port_argument_bytes"] = int(port)
    rec["cost"] = step_flops(cfg, shape, mesh, tcfg, placed, dist).record()
    rec["collectives"] = traffic.record()
    return rec


def census_cell(arch: str, shape_name: str, multi_pod: bool,
                dist: Optional[DistConfig] = None, tag: str = ""
                ) -> Dict[str, Any]:
    """One (arch x shape) cell on a production mesh: the reference's
    ``lower_cell`` record keys, counted."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_is_applicable(cfg, shape)
    mesh = production_mesh(multi_pod)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_tag(mesh), "kind": shape.kind,
                           "tag": tag}
    if not ok:
        rec["status"] = reason
        return rec
    t0 = time.perf_counter()
    rec.update(lm_record(
        cfg, shape, mesh, dist or DistConfig(), arch_opt_config(arch),
        arch_train_config(arch, shape, multi_pod)))
    rec["census_s"] = round(time.perf_counter() - t0, 3)
    rec["status"] = "OK"
    return rec


ANNS_CELLS = {
    # paper-scale datasets (Table III): the database sharded over ALL
    # mesh devices (the pod's aggregate device memory plays the
    # distributed-storage tier); per-rank probe working set = p_loc probed
    # partitions x cap
    "anns-bigann-1b": {"n": 1_000_000_000, "d": 128, "q": 4096, "k": 100,
                       "cap": 128, "p_loc": 1, "p_agg": 0.01},
    "anns-deep-1b": {"n": 1_000_000_000, "d": 96, "q": 4096, "k": 100,
                     "cap": 128, "p_loc": 1, "p_agg": 0.01},
    "anns-sift-10m": {"n": 10_000_000, "d": 128, "q": 4096, "k": 100,
                      "cap": 16, "p_loc": 2, "p_agg": 0.2},
}
ASSIGN_K, ROW_CHUNK, COL_CHUNK = 8, 4096, 65536


def anns_sizes(spec: Dict[str, Any], mesh, row_chunk: int = ROW_CHUNK,
               col_chunk: int = COL_CHUNK) -> Dict[str, int]:
    """A rank's blocks, sized as the reference's ``lower_anns_cell`` sizes
    them: ``n_local`` database rows (n over every rank), ``rows`` probed
    a query, ``res_local`` residual rows (n / 64 over the data axes) and
    ``agg_local`` aggregation points (p_agg n over model), each rounded
    to the chunked scan's tiling."""
    n_dev = math.prod(mesh.axis_sizes)
    mp = mesh.shape["model"]
    dp = n_dev // mp
    m_agg = max(int(spec["n"] * spec["p_agg"]) // (mp * col_chunk), 1) \
        * mp * col_chunk
    n_res = max(spec["n"] // 64 // (dp * row_chunk), 1) * dp * row_chunk
    return {"n_local": spec["n"] // n_dev, "rows": spec["p_loc"] * spec["cap"],
            "res_local": n_res // dp, "agg_local": m_agg // mp}


def anns_record(spec: Dict[str, Any], mesh, kind: str,
                row_chunk: int = ROW_CHUNK, col_chunk: int = COL_CHUNK
                ) -> Dict[str, Any]:
    """The census of the ANNS serve or assign step on one rank of
    ``mesh`` (``core/distributed.py``): its blocks, the scan's
    matmul-class FLOPs (q.x, 2·d a (query, row) pair; the norms and the
    selection are elementwise) and the merges' all-gathers, axis by
    axis."""
    z = anns_sizes(spec, mesh, row_chunk, col_chunk)
    d, q, k = spec["d"], spec["q"], spec["k"]
    tr = Traffic()
    if kind == "serve":
        args = (q * d + z["n_local"] * d + q * z["rows"]) * 4
        flops = 2 * q * z["rows"] * d
        w = min(k, z["rows"])
        for a in mesh.axis_names:   # d2 (f32) and ids (int32)
            tr.gather(mesh, a, q * w * 4)
            tr.gather(mesh, a, q * w * 4)
            w = min(k, mesh.shape[a] * w)
        out = 2 * q * w * 4
    else:
        n_res, m = z["res_local"], z["agg_local"]
        args = (n_res + m) * d * 4
        flops = 2 * n_res * m * d
        tr.gather(mesh, "model", n_res * ASSIGN_K * 4)
        tr.gather(mesh, "model", n_res * ASSIGN_K * 4)
        out = 2 * n_res * ASSIGN_K * 4
    return {"memory": {"argument_size_in_bytes": int(args),
                       "output_size_in_bytes": int(out)},
            "port_argument_bytes": int(args), "blocks": z,
            "cost": {"flops": float(flops)}, "collectives": tr.record()}


def census_anns_cell(name: str, multi_pod: bool, kind: str = "serve"
                     ) -> Dict[str, Any]:
    """One ANNS data-plane cell on a production mesh."""
    mesh = production_mesh(multi_pod)
    rec: Dict[str, Any] = {"arch": name, "shape": kind,
                           "mesh": mesh_tag(mesh), "kind": kind, "tag": ""}
    t0 = time.perf_counter()
    rec.update(anns_record(ANNS_CELLS[name], mesh, kind))
    rec["census_s"] = round(time.perf_counter() - t0, 3)
    rec["status"] = "OK"
    return rec


def cell_path(out_dir: str, rec_or_arch, shape=None, mesh=None,
              tag: str = "") -> str:
    if isinstance(rec_or_arch, dict):
        r = rec_or_arch
        arch, shape, mesh, tag = r["arch"], r["shape"], r["mesh"], r.get(
            "tag", "")
    else:
        arch = rec_or_arch
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, mesh.replace("x", "_"),
                        f"{arch}__{shape}{suffix}.json")


def failed(arch: str, shape: str, mesh: str, tag: str,
           e: Exception) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape, "mesh": mesh, "tag": tag,
            "status": f"FAIL: {type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def grid(arch_ids=None, shape_names=None, meshes=(False, True),
         dist: Optional[DistConfig] = None, tag: str = "",
         anns: bool = False):
    """Every cell's record, in the order ``main`` takes them: the LM grid,
    or with ``anns`` the ANNS cells (serve and assign)."""
    if anns:
        for name in ANNS_CELLS:
            for kind in ("serve", "assign"):
                for multi_pod in meshes:
                    try:
                        yield census_anns_cell(name, multi_pod, kind)
                    except Exception as e:
                        yield failed(name, kind,
                                     mesh_tag(production_mesh(multi_pod)),
                                     "", e)
        return
    arch_ids = arch_ids or [a.replace("_", "-") for a in ARCH_IDS]
    for arch in arch_ids:
        for shape_name in shape_names or list(SHAPES):
            for multi_pod in meshes:
                try:
                    yield census_cell(arch, shape_name, multi_pod, dist, tag)
                except Exception as e:
                    yield failed(arch, shape_name,
                                 mesh_tag(production_mesh(multi_pod)), tag, e)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag (perf configs)")
    ap.add_argument("--fsdp-over-pod", action="store_true")
    ap.add_argument("--shard-hd-fallback", action="store_true",
                    help="reproduce the pre-optimization baseline sharding")
    ap.add_argument("--anns", action="store_true",
                    help="run the paper's ANNS data-plane cells instead")
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    dist = DistConfig(fsdp_over_pod=args.fsdp_over_pod,
                      shard_head_dim_fallback=args.shard_hd_fallback)
    failures = 0
    for rec in grid(None if args.arch == "all" else args.arch.split(","),
                    None if args.shape == "all" else args.shape.split(","),
                    meshes, dist, "" if args.anns else args.tag, args.anns):
        path = cell_path(args.out, rec)
        if os.path.exists(path) and not args.force:
            print(f"[skip-cached] {rec['arch']} {rec['shape']} "
                  f"{rec['mesh']}")
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        status = rec["status"]
        failures += status.startswith("FAIL")
        mem = rec.get("memory", {})
        print(f"[census] {rec['arch']} {rec['shape']} {rec['mesh']} -> "
              f"{status}"
              + (f" | args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB"
                 f" port={rec['port_argument_bytes'] / 2**30:.2f}GiB"
                 f" flops={rec['cost']['flops']:.3e}"
                 f" coll={rec['collectives']['total'] / 2**30:.2f}GiB"
                 if status == "OK" else ""), flush=True)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
