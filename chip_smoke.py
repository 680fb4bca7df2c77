#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of DSANN on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (one process per source, all at once), counts the tensor-core
instructions of the bf16 ``flash_attention`` kernels with ``cuobjdump``
(HMMA in the forward, HGMMA in the backward's two product kernels), holds
each kernel against its plain PyTorch
version on the card (edge cases, the sliding window and meta tokens
included, in the forward and in the backward, and exact-tie inputs),
prefills each dense, moe, hybrid, audio and vlm REDUCED config through
the attention kernel against the plain attention, then drives twenty
paths, each with its kernel launches counted from zero and checked:

* quality and main: ``make_dataset`` (ground truth through ``l2_topk``)
  -> ``build_pag`` -> ``write_partitions`` (PQ payloads, "dfs" storage
  preset, 4 shards) -> every query through ``AnnsFrontend`` over
  ``ShardedServing``, once on the float plane and once on the PQ plane
  (``l2_topk_masked``, ``pq_adc_masked``). At 30,000 x 128 with 512
  queries the recall floor of the algorithm's working regime must hold;
  the main run is SIFT1M's shape (1,000,000 x 128 float32, made from a
  seed) with 1024 queries.
* rag: the LM half of retrieval-augmented serving (the reference's
  examples/rag_serve.py) at TinyLlama-1.1B's published width, weights
  from a seed: ``search_pag`` on the quality index answers 8 queries
  (``l2_topk_masked``), the retrieved ids open 500-token prompts, and
  ``Engine.generate`` prefills them (``flash_attention`` in each of the
  22 layers) and decodes 32 greedy tokens. Afterwards the prefill logits
  are held against the same forward through the materialised-scores
  attention, and every decode step against the teacher-forced forward.
* moe: the moe family served as rag serves TinyLlama (8 x 500-token
  prompts, 32 greedy tokens, cold, warm and profiled) at its published
  widths with its depth cut to fit one card, seeded weights: DBRX-132B
  (4 of 40 layers: d 6144, 48 / 8 heads, D 128, 16 experts top-4), freed,
  then Kimi-K2 (2 of 61: its dense prefix layer and one MoE layer; d
  7168, 64 / 8 heads, D 112, 384 experts top-8, a shared expert), each
  prefill layer through ``flash_attention``, the experts as batched
  cuBLAS products with capacity 1.25. Afterwards, under the route rule
  (ROUTE_AGREEMENT, ROUTE_TIE_RTOL): the prefill logits against the same
  forward through the plain attention, a second prefill bit for bit, and
  the first decode step against the same step after a plain prefill.
  Prints each arch's cut, walls, tokens/s, idle share, peak memory,
  tokens dropped for capacity and route agreement.
* moe_train: three steps of ``launch/train.py``'s setup for each REDUCED
  moe config (aux loss above 0, one ``flash_attention_bwd`` a layer and
  step).
* ssm and hybrid: the ssm family (mamba2-370m: 48 layers, d 1024,
  attention-free) and the hybrid family (hymba-1.5b: 32 layers, d 1600,
  25 / 5 heads, sliding window 1024 with global layers 0, 15 and 31, 128
  meta tokens) served at their published widths, uncut, seeded bf16
  weights: 8 x 2048-token ``batch_at`` prompts, 32 greedy tokens, cold,
  warm and profiled, and one profiled prefill split into cuBLAS, the
  attention kernel and the rest (the SSD's ``[B, nc, H, Q, Q]`` f32
  passes timed alone). Hymba's prefill runs ``flash_attention`` with the
  window and meta-token mask in each layer; mamba2 runs no kernel.
  Afterwards: two prefills bit for bit, the first decode step against
  the teacher-forced forward (f32 and bf16), hymba's prefill
  against the plain attention, and mamba2's chunked SSD in f32 against
  its recurrence. Prints walls, decode step against its byte bound,
  tokens/s, peak memory and idle share.
* audio and vlm: whisper-small at its published widths, uncut (12
  encoder and 12 decoder layers, d 768, seeded bf16 weights): 8 clips of
  1500 frame embeddings (``batch_at``'s seeded stub for the conv stem's
  output) with 64-token decoder prompts, 64 greedy tokens, cold, warm and
  profiled; each prefill runs ``flash_attention`` 36 times (12 full at
  1500 x 1500, 12 causal, 12 full cross-attention at 64 x 1500). Then
  internvl2-76b at its published widths cut in depth only (24 of 80
  layers, d 8192, 64 / 8 heads of 128: 22.6 B parameters): 8 x
  500-token prompts whose first 256 positions the seeded vision
  embeddings overlay, 32 greedy tokens. Afterwards: one prefill's
  launches counted, its logits against the plain attention, the first
  token and every decode step against the teacher-forced forward (which
  holds whisper's cross-attention cache), whisper's encoder output
  against the plain attention and the reference's zero-padded chunks
  emulated (the size of the fault the port does not copy), and
  internvl2's logits past the vision tokens moved by other embeddings.
* train: ``launch/train.py``'s setup and step at TinyLlama-1.1B's
  published width (22 layers, d 2048, 32 / 4 heads, bf16, seeded weights),
  B=8 x S=2048: 6 AdamW steps on one repeated batch, each layer's
  attention forward through ``flash_attention`` (twice: the block is
  recomputed in the backward) and its gradient through
  ``flash_attention_bwd``; the loss must fall, step 0's must agree with
  the forward through the plain attention, and layer 0's attention
  gradients with autograd through the plain attention. Prints step wall
  time, tokens/s, peak memory and a profile of the last step.
* long_train: the ssm and hybrid families trained as train trains
  TinyLlama, at their published widths, uncut (mamba2-370m, freed, then
  hymba-1.5b; bf16, B=8 x S=2048, hymba's 128 meta tokens first, remat,
  6 AdamW steps on one batch at each arch's swept learning rate, the
  last profiled). Mamba2's SSD backward is autograd's and launches no
  kernel; hymba's attention runs ``flash_attention`` forward twice a
  layer (remat) and ``flash_attention_bwd`` once, with the window and
  meta tokens on its 29 windowed layers. The loss must fall at every
  step; hymba's step 0 must agree with the plain attention's, and its
  first windowed layer's (layer 1) attention gradients with autograd
  through the plain attention; exactly 32 x 6 backward launches on
  hymba and no attention launch on mamba2. Prints step wall time,
  tokens/s, peak memory, idle share, top kernels and launches a step.
* audio_train and vlm_train: the audio and vlm families trained as train
  trains TinyLlama (6 steps on one batch, remat, the last profiled).
  whisper-small uncut through launch/train.py's setup (f32 AdamW), B=16
  clips of 1500 frames with 448 decoder tokens each: 72 flash_attention
  launches a step (12 full at 1500 x 1500, 12 causal at 448 x 448, 12
  full cross-attention at 448 x 1500, each forward twice) and 36
  flash_attention_bwd; then internvl2-76b at its published widths cut to
  6 of 80 layers, factored f32 AdamW, B=4 x S=1024 under 256 vision
  embeddings a row: 12 and 6. The loss must fall, step 0's agree with
  the plain attention's, and the attention gradients of whisper's
  encoder layer 0 (full), decoder layer 0's self-attention (causal) and
  cross-attention (full, Sq < Sk), and of internvl2's layer 0 (causal,
  D 128, G 8) with autograd through the plain attention, each under the
  captured call's own mask; internvl2's loss takes no label under the
  vision tokens.
* pod: the pod-scale data plane (``core/distributed.py``'s serve and
  assign steps) at the reference's anns-sift-10m dry-run shapes, on
  ``make_local_mesh(model_axis=2)`` over 4 gloo ranks that share the card
  (spawned, ``file://`` rendezvous, the kernels built once before): the
  serve step over a 10,000,000 x 128 database (2.5M rows a rank), 4096
  queries, 32 probed rows a rank, k 100 (each rank's scan through
  ``l2_topk_masked``, the merge over data then model); the assign step,
  155,648 residual rows over data against 1,966,080 aggregation points
  over model, k 8 (``l2_topk`` a row chunk of 4096). Each rank counts its
  launches from 0 around its two steps; then the steps are timed (all
  ranks together), the merges, and each rank's gather and scans alone.
  Afterwards: the serve result bit for bit the same on every rank and
  each id within ``norm_atol`` of the plain scan over the query's
  candidates of all ranks (near-ties counted); every rank's assign block
  equal, ids and d2 bit for bit, to one unsharded ``l2_topk``; and both
  steps at world size 1 under nccl equal to the direct kernel calls.
* ep: the moe path's DBRX-132B (published widths, 4 of 40 layers, seed
  0, the same prompts) served with expert parallelism
  (``models/moe.py``'s ``moe_sharded`` under ``mesh_context``) by 4 gloo
  ranks that share the card, each drawing the seeded model and keeping
  its blocks of the experts and, by the reference's specs, of every
  other weight (the heads and the vocabulary over model). Mesh (data 1,
  model 4): 4 of 16 experts a rank, ``Engine.generate`` cold and warm,
  then the prefill and decode steps with the unsharded cold run's tokens
  fed (routes recorded), the partial outputs all-gathered over model and
  added in rank order. Afterwards, against the moe path's unsharded
  model (kept on the host from that path): the ranks' tokens and fed
  logits bit for bit the same, the warm tokens the cold ones, the routes
  of the prefill and every fed decode step under the route rule, the
  logits of the prefill and of every fed decode step within
  RAG_LOGITS_ATOL on the agreeing sequences, the first MoE layer in f32
  within EP_LAYER_RTOL of the unsharded layer, and one
  ``flash_attention`` a layer and prefill on every rank. Prints each
  rank's times (dispatch and expert products alone, the partial sum,
  prefill and decode step), peak and the bytes moved a layer.
* dp_train: ``launch/train.py``'s setup and step on 2 gloo ranks that
  share the card (the trainer's own mesh, ``make_local_mesh``, on the
  process group; each rank keeping its ``batch_spec`` block of the
  batch). T1: TinyLlama-1.1B at its published widths, 2 of 22 layers,
  on (data 2, model 1), B=8 x S=2048 (4 rows a rank), a warm step and 3
  timed ones, every weight's d split over data (FSDP: gathered before
  use, its gradient reduce-scattered), the norms' gradients summed over
  data. T2: DBRX-132B at its
  published widths, 1 of 40 layers, capacity 1.25, on (data 1, model
  2): 8 of 16 experts a rank, factored f32 AdamW, B=4 x S=512, 3 steps,
  the MoE layer's backward across the ranks (its experts' gradients
  summed over model into the tokens' and the router's). The ranks start
  while the ep path runs and wait (DP_WAIT_S); before they get the go,
  one process takes both steps unsharded on the whole batch (the
  references, then freed; with T2's, its MoE layer in f32 on rows 0 and
  1, the tp path's T3 side). Gates: every
  parameter (T1), the router and every dense weight (T2), bit for bit
  the same on both
  ranks after every step (fingerprints of their bits); step 0's loss
  within TRAIN_LOSS_ATOL of the one-process step; T2's routes under the
  route rule; T2's layer in f32 on one input against the unsharded
  layer's autograd (the input's, the router's and each rank's first
  expert's gradients within DP_LAYER_RTOL of their largest); the loss
  falls; exact ``flash_attention`` and ``flash_attention_bwd`` launches
  on each rank. Prints the step walls, the data all-reduce of T1's
  gradients, T2's model-axis sums forward and backward, and each rank's
  peak.
* tp: TinyLlama-1.1B at its published widths with every weight and the
  decode cache placed by the reference's specs (``models/model.py``
  under ``mesh_context``: column- and row-parallel products summed over
  model, the FSDP gathers over data, the vocab-parallel embedding,
  logits, greedy choice and loss, the sequence-split cache) on 4 gloo
  ranks that share the card (started while dp_train's ranks run, each
  waiting for its go). Phase A, (data 1, model 4), all 22 layers: 8
  of 32 query heads, 1 of 4 kv heads, 1408 of d_ff and 8000 vocabulary
  rows a rank;
  the seeded model's parameter bytes against the census's
  (``tree_bytes`` under the specs) and the allocator's; a prefill of 4 x
  512 seeded tokens and 16 decode steps in f32 with the unsharded f32
  run's tokens fed, then ``Engine.generate`` in bf16 (layer 0's attention
  call kept for its kernel row), its collectives timed. Phase B, (data 2,
  model 2), the model cut to TP_B_DEPTH layers, f32: a batch of one
  generated (the cache's slots split over data), then one AdamW step on
  4 x 512, its collectives timed. Against one process unsharded (taken
  just before): the ranks' f32 logits bit for bit the same and within
  TP_LOGITS_RTOL of the row's largest, their greedy choices the
  unsharded tokens, the bf16 tokens the same on the ranks (agreement
  with the unsharded bf16 run reported), B's tokens the unsharded
  decode's, the step's loss and grad norm within TP_LOSS_RTOL and
  TP_GNORM_RTOL and its updated parameters gathered whole within
  TP_PARAM_TOL but for TP_PARAM_OUTLIERS of them (each within 3 lr),
  and exact launches a rank. Then phase T3 (DP_PHASES): DBRX-132B at its
  published widths, 1 of 40 layers, through ``launch/train.py``'s setup
  on the trainer's (data 2, model 2) mesh, one step of T2's batch (4 x
  512, capacity 1.25, factored f32 AdamW): 8 of 16 experts a rank, each
  with half its d (gathered over data before use, its gradient
  reduce-scattered), 24 of 48 query heads, 4 of 8 kv heads and a quarter
  of the embeddings and LM head. Against dp_train's one-process DBRX
  step: the loss the same on the ranks and within TRAIN_LOSS_ATOL, the
  routes under the route rule (the two data ranks' joined in batch
  order, the kept flags under their capacity), the first MoE layer in
  f32 (each data rank on its own row) within DP_LAYER_RTOL, the
  parameter bytes the census's, exactly 2 ``flash_attention`` and 1
  ``flash_attention_bwd`` launches a rank. Prints each rank's walls, its
  collectives' seconds and bytes against them, peaks and parameter
  bytes.
* tp_families: the ssm, hybrid and audio families placed the same way
  on 4 ranks (TPF_PHASES: A mamba2-370m, B hymba-1.5b, C
  whisper-small on (1, 4); D: hymba's decode of one and 2-layer train
  steps on (2, 2)), under tp's gates; then phase E, hymba-1.5b under
  ``DistConfig(shard_head_dim_fallback=True)``: its 25 heads do not
  divide model, so every rank holds 16 of 64 columns of every head of
  ``wq``/``wk``/``wv``/``wo`` on (1, 4), 32 on (2, 2), and of the decode
  cache; the blocks are gathered over model and rotated whole, so the
  ``flash_attention`` kernel (and ``flash_attention_bwd``) runs over
  every head on every rank. E runs B's prompts (f32 forced run, bf16
  generate) and D's hymba decode of one and train step, held to B's and
  D's unsharded runs under the same gates, its launches gated apart.
* tp_hd: case M of the head-dim placement, TinyLlama-1.1B at its
  published widths on (data 1, model 8), 8 gloo ranks on the card: the
  query heads divide model and the 4 kv heads do not, so a rank holds 4
  of the 32 query heads of ``wq``/``wo`` and 8 of the 64 columns of each
  kv head of ``wk``/``wv``, and of its decode cache; k and v are gathered
  over model and rotated whole, and ``flash_attention`` (and
  ``flash_attention_bwd``) runs on the rank's 4 query heads over the kv
  head they read. M1 (all 22 layers) runs tp's phase A, M2 (TP_B_DEPTH
  layers) its phase B on the same mesh, held to tp's unsharded runs under
  tp's gates; the weights' widths and both caches' head-dim blocks
  gated.
* tp_ssd: the SSD layouts where a concatenated leaf divides model only
  as a whole or not at all (``models/ssm.py``'s ``Split``; TP_SSD_WORLDS),
  5 gloo ranks on the card, two worlds in turn. S1: hymba-1.5b uncut on
  (data 1, model 5), its 50 SSD heads split (10 a rank, and ``h``) while
  ``in_proj`` (6482 columns) and the conv (3232 channels, and its window)
  stay whole; tp_families' hymba prompts, the f32 forced run and bf16
  ``Engine.generate``; S2: its 2-layer train step there. S3: the first 3
  ranks on (1, 3), mamba2-370m uncut, its conv's 2304 channels (2048 +
  128 + 128) in contiguous blocks of 768 (and its window), ``in_proj``
  and the heads whole, as tp_families' phase A; S4: its 2-layer step.
  Held under tp_families' gates (the steps' losses within
  TP_SSD_LOSS_RTOL) to the unsharded runs of the same seeds: S1's own,
  S2-S4's tp_families' (kept from that path); each rank's ``in_proj``,
  conv and cache widths gated.
* census: ``launch/dryrun.py``'s whole grid in this process (10 archs
  x 4 shapes x 2 meshes, and the ANNS cells: 3 x 2 kinds x 2 meshes; no
  cell may FAIL), then one rank's share of anns-bigann-1b (d 128) and
  anns-deep-1b (d 96) at the 16x16 mesh and world size 1, drawn on the
  card from a seed: 3,906,250 database rows, 4096 queries probing 128
  local rows each, the serve scan (``gather_pools``, ``serve_scan``:
  ``l2_topk_masked`` at C 128, k 100) and the whole assign scan
  (``assign_scan``: 974,848 residual rows against 589,824 aggregation
  points, 238 ``l2_topk`` chunks of 4096, k 8), launches counted around
  the scans alone (the merges are the identity at world size 1; the pod
  path runs them across ranks). Gates: serve against the plain scan on
  every query, assign on its first and last chunk, ids equal up to
  near-ties and distances within ``norm_atol``; the placed tensors'
  bytes equal to the census's argument bytes, the allocator's within its
  rounding (ALLOC_SMALL, ALLOC_LARGE).
  Then the long_500k decode on one card (census mesh (1, 1)):
  mamba2-370m and hymba-1.5b uncut, seeded weights, a seeded cache of
  524,288 slots at B 1, a warm ``decode_step`` at position 524,287 and
  CENSUS_LONG_STEPS timed ones; the placed bytes against the census's
  ``port_argument_bytes``, the warm step's bf16 logits within
  RAG_LOGITS_ATOL of the same step in f32 (the cache cast a layer at a
  time). Prints the grid's counts and seconds, each scan's wall and
  device ms beside its bound, each decode step beside its byte bound and
  the peak.
* compare: the paper's comparison (Table IV, Figs 8-10) at 50,000 x 128
  with 1000 queries: PAG, DiskANN (one ``pq_adc_rows`` launch per wave of
  its lock-step traversal, the waves of each sweep printed), SPANN (closure
  assignment through ``l2_topk``) and HNSW built and searched, the CIC
  build on half the rows, and a checkpoint round trip of the PAG. One
  JSON row per method and setting (recall@10, simulated QPS, build and
  wall seconds), then the PAG/DiskANN QPS ratio at recall >= 0.85 and
  at the highest recall both reach.

The backward's windowed edge cases (FLASH_BWD_WINDOW_EDGES, bf16 and
f32, against the plain backward) take windows of 1, 17, 64, 100, 128,
1024 and >= Sk, 0, 8 and 128 meta tokens, groups 1, 2, 5 and 8, Sq < Sk
and Sq = Sk with ragged lengths, and hymba's own layer; a window of at
least Sk must give the causal backward bit for bit.

Last, each kernel is timed on the inputs its path gave it
(``l2_topk_masked`` four times: the main path's batch, the pod path's
serve scan and the census path's two 1B serve scans; ``l2_topk`` five
times: SPANN's closure chunk, the 1M ground-truth chunk, the pod path's
assign chunk and the census path's first assign chunk at d 128 and 96,
those two timed within the census path while its inputs are on the
card; the pod path's inputs drawn again from the seed as its rank 0 drew
them;
``pq_adc_rows`` on the first full DiskANN wave; ``flash_attention``
at each of these: rag's first prefill layer, the moe path's two, hymba's first
windowed and first global layer, whisper's encoder layer and
cross-attention, internvl2's first layer, the two train layers
audio_train and vlm_train add, whisper's encoder at B=16 and
internvl2's at 4 x 1024, dp_train's layer 0 of a rank, TinyLlama's
at 4 x 2048 and DBRX's at 4 x 512, tp's layer 0 of a rank in phase
A (4 x 512, 8 / 1 heads, bf16), and a rank's hymba-1.5b windowed layer
in tp_families' phases B and E and whisper-small's encoder layer in its
phase C, tp_hd's M1 layer 0 of a rank (4 x 512, 4 / 1 heads, bf16), and
tp_ssd's S1 windowed layer of a rank (4 x 640, 5 / 1 heads, bf16);
``flash_attention_bwd`` nine times (tp_hd's M2 layer and tp_ssd's S2
layer 0, f32, the last two):
the train path's layer 0, long_train's hymba layer 1, windowed,
whisper's encoder layer and cross-attention, internvl2's layer 0 and
dp_train's two layers, each under its own mask, two calls
bit-identical): CUDA
events around back-to-back wrapper calls (``ms``) and the kernel's own
device time from ``torch.profiler`` (``device_ms``), beside its plain
version,
one PyTorch library call computing the same function
(``scaled_dot_product_attention`` for ``flash_attention``, with the
boolean mask as ``attn_mask`` for a window; its backward, with the mask
likewise, for ``flash_attention_bwd``; timed only, never called by the
port) and its bound.

Each served path's profiled generate decodes PROFILE_NEW tokens. Prints
each phase's wall time, the card's name and power limit, one JSON
line of kernel numbers, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
there is no CUDA card or any check fails. Imports nothing of JAX or of
the reference package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# SIFT1M shape; index and search at the repo's DFS/PQ operating point
# (benchmarks/qps_recall.py pq_main: p=0.01, lam=8, redundancy=2,
# n_probe_max=32, rerank_k from its sweep (16, 32, 64)). 1024 queries
# (four micro-batches a plane; 2048 until the pod path, cut for the
# smoke's clock)
N, D, N_QUERIES, K = 1_000_000, 128, 1024, 10
PAG_ARGS = dict(p=0.01, lam=8, redundancy=2, R=16)
N_SHARDS, MAX_BATCH = 4, 256
SEARCH_ARGS = dict(L=32, k=K, n_probe_max=32, rerank_k=64)
PQ_M = 8
PQ_RECALL_GAP = 0.02        # PQ plane within this of the float plane
# Float recall@10 floors. The same index parameters at 30k points serve
# at 0.95 (the algorithm's working regime) and must clear 0.80. At 1M,
# build_pag promotes ~40% of the residuals into the graph as empty
# partitions, reachable mostly through their random edges, and recall
# falls to 0.38 (H100 runs, PERF.md); the 1M floor guards that level
# against regressions.
QUALITY_N, QUALITY_QUERIES, QUALITY_FLOOR = 30_000, 512, 0.80
SCALE_FLOOR = 0.35

# The paper's comparison (Table IV, Figs 8-10) at SIFT width, a twentieth
# of SIFT1M's depth: benchmarks/common.py:128-165 builds and
# benchmarks/qps_recall.py _curves with its smoke sweeps (the first two
# settings; DiskANN's whole sweep, so that it reaches the recall of the
# PAG/DiskANN ratio). Cut from 1M because SPANN's kmeans holds a
# [n, n/16] float32 distance matrix (250 GB at 1M), and from 100k to 50k
# to keep the whole smoke inside its time limit on a slow host (the
# builds took 300-390 s at 100k, 170 s at 50k)
CMP_N, CMP_QUERIES = 50_000, 1000
CMP_PAG_ARGS = dict(p=0.2, lam=3.0, redundancy=4)
CMP_PAG_SWEEP = [(32, 16), (64, 32)]
CMP_DK_SWEEP = [16, 32, 64]
CMP_SP_SWEEP = [(32, 8), (32, 16)]
CMP_HN_SWEEP = [16, 32]
CIC_N, CIC_L = 25_000, 32
RATIO_RECALL = 0.85
# recall@10 floors, 0.03 below the value measured on the H100 (beside
# each; deterministic seeds). 128-dimensional Gaussian clusters are hard
# for R=16 graphs: no method reaches the ratio's 0.85 here (PERF.md).
CMP_FLOORS = {("PAG", "L32/p16"): 0.3082,          # 0.3382
              ("PAG", "L64/p32"): 0.4620,          # 0.4920
              ("DiskANN", "L16"): 0.2554,          # 0.2854
              ("DiskANN", "L32"): 0.3812,          # 0.4112
              ("DiskANN", "L64"): 0.5251,          # 0.5551
              ("SPANN", "L32/p8"): 0.5002,         # 0.5302
              ("SPANN", "L32/p16"): 0.5516,        # 0.5816
              ("HNSW", "L16"): 0.6075,             # 0.6375
              ("HNSW", "L32"): 0.7129,             # 0.7429
              ("CIC", f"c4/n{CIC_N}/L{CIC_L}"): 0.1391}   # 0.1691

# RAG serving at TinyLlama-1.1B's published width (examples/rag_serve.py
# runs it REDUCED): 8 requests, each its k=10 retrieved ids then synthetic
# tokens up to 500 (not a multiple of the kernel's 64-row tile), 32 greedy
# new tokens
RAG_ARCH, RAG_BATCH, RAG_PROMPT, RAG_NEW = "tinyllama-1.1b", 8, 500, 32
# bf16 tolerances on logits of size ~4 (2^-6 is one bf16 step there):
# the kernel and the plain attention round their bf16 outputs from f32
# sums taken in other orders, and cuBLAS picks other bf16 product kernels
# for the 8-row decode step than for the 4000-row prefill; 22 layers
# carry those single steps into the logits
RAG_LOGITS_ATOL = 0.25
# one bf16 step of the output (both sides sum in f32, round once)
FLASH_BF16_TOL = 2 ** -7
FLASH_F32_TOL = 1e-5        # f32 sums in another order
# A prefill of each dense, moe, hybrid, audio and vlm REDUCED config (2-3
# layers, D = 16, qwen1.5 D = 12; hymba's window 32 and 8 meta tokens over
# 85 slots; whisper's 30 seeded frames through its 2-layer encoder, its
# cross-attention at 77 x 30; internvl2's 8 seeded vision embeddings)
# through the kernel against the plain attention: logits of
# size ~1-5, where 2^-3 is eight bf16 steps; the edge checks hold the
# kernel itself to one step. The moe configs' capacity_factor 8 drops no
# token; their logits are held under the route rule below
REDUCED_ARCHS = ("tinyllama-1.1b", "command-r-plus-104b", "stablelm-1.6b",
                 "qwen1.5-4b", "dbrx-132b", "kimi-k2-1t-a32b", "hymba-1.5b",
                 "whisper-small", "internvl2-76b")
REDUCED_LOGITS_ATOL = 2 ** -3

# The moe family at its published widths, seeded weights, served as rag
# serves TinyLlama: 8 x 500-token batch_at prompts, 32 greedy tokens.
# DBRX-132B (configs/dbrx_132b.py, hf:databricks/dbrx-base: d 6144, 48 / 8
# heads, D 128, d_ff 10752, 16 experts top-4, vocab 100,352) with its depth
# cut from 40 to 4 layers (14.3 B parameters, 28.5 GB bf16); then
# Kimi-K2 (configs/kimi_k2_1t_a32b.py: d 7168, 64 / 8 heads, D 112, d_ff
# 2048, 384 experts top-8, 1 shared expert, vocab 163,840) cut from 61 to
# 2: its dense prefix layer and one MoE layer (19.6 B, 39 GB). Nothing
# else of either config changes: capacity_factor 1.25 drops tokens, in
# the prefill and more at decode (capacity 2 and 1 a step of 8 tokens)
MOE_ARCHS = (("dbrx-132b", 4), ("kimi-k2-1t-a32b", 2))
MOE_BATCH, MOE_PROMPT, MOE_NEW = 8, 500, 32
# The route rule. A bf16 step in an attention output can flip a near-tied
# routing choice, which changes that token's layer output by a whole
# expert's, so logits alone cannot be gated: the kernel run's and the
# plain run's (token, layer) routes (the expert ids taken) must be
# identical for at least ROUTE_AGREEMENT of them, and each token's first
# difference must be a near-tie: the experts swapped within
# ROUTE_TIE_RTOL of each other in the plain run's router probability (a
# router-logit gap of 0.125), or, with the same ids, a kept flag moved by
# an earlier token's change of route to that expert (its queue grew or
# shrank). The bound is not a few bf16 steps: a token whose route
# changed changes its keys and values, and every later token attends to
# them, so a layer's routers see the changes of the layers before it
# (DBRX, 4 layers: first differences up to 7.2% apart at layer 3, H100
# 80GB HBM3 at 700 W). Logits are then held to RAG_LOGITS_ATOL on the
# tokens whose ids and kept flags agree at every layer. Kimi-K2 takes 8
# of 384 experts: its 8th and 9th router probabilities lie within a bf16
# step of the router logit (1-2%) far more often than DBRX's 4th and 5th
# of 16, and 8.2% of its routes differ at its one MoE layer, every first
# difference within 3.1% (same card): its floor is 0.90
ROUTE_AGREEMENT = {"dbrx-132b": 0.95, "kimi-k2-1t-a32b": 0.90}
ROUTE_TIE_RTOL = 2 ** -3
# REDUCED moe training on the card: 3 steps of launch/train.py's setup
# (its defaults: B=8 x S=128, lr 1e-3)
MOE_TRAIN_STEPS = 3

# Training at TinyLlama-1.1B's published width (configs/tinyllama_1_1b.py,
# arXiv:2401.02385: 22 layers, d 2048, 32 / 4 heads, bf16), seeded weights,
# B=8 x S=2048 (its published context): 6 AdamW steps of
# launch/train.py's step on one repeated batch, which it overfits (step 5's
# loss below step 0's); step 5 runs under torch.profiler. With remat the
# step fits one card without microbatches (21.8 GiB peak, H100 80GB). The
# learning rate: the trainer's default of 1e-3 suits REDUCED widths; at
# d 2048 with one warmup step, 1e-3, 3e-4 and 1e-4 made the loss bounce on
# this batch, 3e-5 lowered it at every step (10.94 to 8.76)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "tinyllama-1.1b", 8, 2048, 6
TRAIN_MICROBATCHES = 1
TRAIN_LR = 3e-5
# step 0's loss (~10.4, the mean over 16,384 tokens) against the same
# forward through the plain attention: per-token bf16 logit differences of
# a few bf16 steps (RAG_LOGITS_ATOL at most) average out in the mean
TRAIN_LOSS_ATOL = 2 ** -5
# flash_attention_bwd against its plain version on the same (q, k, v, O,
# lse, dO), each gradient within this share of its largest magnitude: bf16
# rounds P and dS before their products (tests/test_torch_attention_bwd.py
# emulates it at 0.3-0.6%); f32 sums in another order. flash_bwd_check adds
# an f32 floor at the scale of the largest of the three gradients
FLASH_BWD_BF16_TOL = 2 ** -6
FLASH_BWD_F32_TOL = 2e-5
# the forward's lse against the plain log-sum-exp: bf16 P enters l
FLASH_LSE_BF16_TOL = 2 ** -7
FLASH_LSE_F32_TOL = 1e-5

# Training of the ssm and hybrid families at their published widths, uncut,
# seeded bf16 weights, as the train path trains TinyLlama: launch/train.py's
# setup and step, B=8 x S=2048 (hymba: 2176 slots, its 128 meta tokens
# first), remat, TRAIN_STEPS AdamW steps on one repeated batch, the last
# under torch.profiler; mamba2-370m, freed, then hymba-1.5b. The learning
# rates are scripts/train_lr_sweep.py's: the largest of 1e-5, 3e-5, 1e-4,
# 3e-4 and 1e-3 at which the loss fell at every step (H100 80GB HBM3 at
# 700 W: mamba2 fell at all five, 11.03 to 7.05 at 1e-3; hymba at 1e-5
# and 3e-5, 10.83 to 8.64, and bounced from 1e-4 on). Both fit one card
# without microbatches (peaks 20.6 and 27.3 GiB)
LONG_TRAIN_ARCHS = ("mamba2-370m", "hymba-1.5b")
LONG_TRAIN_LR = {"mamba2-370m": 1e-3, "hymba-1.5b": 3e-5}
LONG_TRAIN_MICROBATCHES = {"mamba2-370m": 1, "hymba-1.5b": 1}

# The ssm and hybrid families at their published widths, uncut, seeded
# bf16 weights, served as rag serves TinyLlama but at their training
# context: 8 x 2048-token batch_at prompts, 32 greedy tokens. Mamba2-370m
# (configs/mamba2_370m.py, arXiv:2405.21060, state-spaces/mamba2-370m:
# 48 layers, d 1024, 32 SSD heads of 64, N 128): 8 SSD chunks of 256 a
# sequence, so the inter-chunk recurrence runs. Hymba-1.5B
# (configs/hymba_1_5b.py, arXiv:2411.13676, nvidia/Hymba-1.5B-Base: 32
# layers, d 1600, 25 / 5 heads of 64, window 1024, global layers 0, 15,
# 31, 128 meta tokens): 2176 slots a sequence, past the window, so it
# masks in prefill and in decode
LONG_PATHS = (("ssm", "mamba2-370m"), ("hybrid", "hymba-1.5b"))
LONG_BATCH, LONG_PROMPT, LONG_NEW = 8, 2048, 32
# the first decode step against the teacher-forced forward over prompt +
# token. In float32 (the bf16 model's weights cast up; f32 products, TF32
# off) the chunked SSD and its recurrence differ only in the order of f32
# sums: within DECODE_F32_ATOL, the reference's bound for the families
# without a recurrence (tests/test_decode_consistency.py:10). In bf16 the
# reference allows 0.05 (ssm) and 0.08 (hybrid) on its 2-layer REDUCED
# configs; at full width the decode step's 8-row products round to bf16
# otherwise than the prefill's 16,384-row ones (other cuBLAS kernels) and
# 48 or 32 layers carry those single steps into the logits: mamba2-370m's
# first step was 0.0879 off (H100 80GB HBM3 at 700 W), so bf16 is held
# to RAG_LOGITS_ATOL, the bound rag holds the same comparison to
DECODE_F32_ATOL = 1e-3
DECODE_REFERENCE_ATOL = {"ssm": 0.05, "hybrid": 0.08}
# the chunked SSD against its recurrence on the card: one layer in f32 at
# S = 600 (two whole chunks of 256 and a padded one) against 600 decode
# steps from a zero state, relative to the largest magnitude
SSD_HOLD_S, SSD_HOLD_RTOL = 600, 1e-3
# windowed flash_attention edge cases: (B, H, KVH, Sq, Sk, D, window,
# meta_tokens, dtype). Windows of 1, 17, 64 and 1024 keys (inside a
# 64-key tile, across a tile edge, a whole tile, hymba's), no, 8 and 128
# meta tokens, Sq 1, 63 and 2176 against Sk >= Sq, groups 1 and 5
# (hymba's 25 / 5), D 16, 64 and 112, both dtypes
FLASH_WINDOW_EDGES = [
    (b, h, kvh, sq, sk, d, window, meta, dtype)
    for dtype in (torch.bfloat16, torch.float32)
    for b, h, kvh, sq, sk, d, window, meta in [
        (1, 5, 1, 63, 63, 64, 17, 0),
        (2, 4, 4, 63, 200, 16, 1, 8),
        (1, 10, 2, 1, 300, 112, 64, 128),
        (1, 5, 1, 1, 2176, 64, 17, 0),
        (1, 4, 4, 63, 130, 112, 64, 0),
        (1, 4, 2, 200, 200, 64, 1, 128),
        (1, 2, 2, 100, 100, 16, 17, 8),
        (1, 5, 1, 63, 2176, 112, 1024, 128),
        (1, 25, 5, 2176, 2176, 64, 1024, 128),
        (1, 5, 5, 2176, 2176, 16, 64, 8),
        (2, 5, 1, 300, 2176, 64, 17, 128),
        (1, 5, 1, 2176, 2176, 112, 1, 0)]]

# windowed flash_attention_bwd edge cases: (B, H, KVH, Sq, Sk, D, window,
# meta_tokens), each in bf16 and f32. Windows of 1, 17, 64, 100, 128 and
# 1024 keys and one of at least Sk, no, 8 and 128 meta tokens (8: a key
# block mixing meta and windowed keys), groups 1, 2, 5 (hymba's 25 / 5)
# and 8, Sq < Sk and Sq = Sk, ragged lengths off the 64- and 128-row
# tiles (522: a ragged last query block walking fewer key tiles than the
# whole ones, launched after them), D 16, 32, 64, 112 and 128 (32-row
# query steps), and hymba's layer at B = 1
FLASH_BWD_WINDOW_EDGES = [
    (1, 5, 1, 63, 63, 64, 17, 0),
    (2, 4, 4, 63, 200, 16, 1, 8),
    (1, 10, 2, 100, 300, 112, 64, 128),
    (1, 8, 1, 200, 200, 64, 128, 8),
    (1, 4, 2, 300, 300, 32, 17, 128),
    (1, 5, 1, 1, 2176, 64, 17, 0),
    (1, 5, 5, 333, 333, 16, 64, 8),
    (2, 5, 1, 300, 2176, 64, 1024, 128),
    (1, 16, 2, 522, 522, 128, 100, 0),
    (1, 2, 2, 130, 130, 64, 1, 0),
    (1, 10, 2, 260, 260, 48, 1024, 8),
    (1, 25, 5, 2176, 2176, 64, 1024, 128)]

# The audio family at its published widths, uncut (configs/whisper_small.py,
# arXiv:2212.04356: 12 encoder and 12 decoder layers, d 768, 12 heads of
# 64, d_ff 3072, vocab 51,865 padded to 51,968, qkv biases), seeded bf16
# weights: 8 clips of 1500 frames each (30 s of audio at Whisper's 50
# frames/s after its conv stem, which the reference stubs as precomputed
# frame embeddings: batch_at's seeded normal frames), each with a 64-token
# decoder prompt, and 64 greedy tokens (128 of Whisper's 448 decoder
# positions). A prefill runs flash_attention 36 times: 12 full at 1500 x
# 1500 (the encoder), 12 causal at 64 x 64 (the decoder's self-attention)
# and 12 full at 64 x 1500 (its cross-attention)
AUDIO_ARCH, AUDIO_BATCH, AUDIO_PROMPT, AUDIO_NEW = "whisper-small", 8, 64, 64
# The vlm family at InternVL2-76B's published widths
# (configs/internvl2_76b.py, arXiv:2404.16821: d 8192, 64 / 8 heads of
# 128, d_ff 28,672, vocab 128,256), seeded bf16 weights, cut in depth only,
# from 80 to 24 layers: 24 x 0.856 B + 2.1 B of embedding and head = 22.6 B
# parameters, 45.3 GB in bf16, which leaves room on one card for the
# checks' f32 logits ([8, 532, 128256]: 2.2 GB each). 8 x 500-token
# batch_at prompts whose first 256 positions batch_at's seeded vision
# embeddings overlay (one 448-px tile's 256 tokens, as InternVL2 gives
# them), 32 greedy tokens, as rag serves TinyLlama
VLM_ARCH, VLM_DEPTH, VLM_BATCH, VLM_PROMPT, VLM_NEW = \
    "internvl2-76b", 24, 8, 500, 32
# Training of the audio and vlm families, as the train path trains
# TinyLlama (TRAIN_STEPS AdamW steps of launch/train.py's step on one
# repeated batch, remat, the last under torch.profiler), each freed before
# the next. whisper-small uncut, set up by launch/train.py:setup with
# --full (the trainer's own optimizer: f32 AdamW, unfactored): B = 16
# clips of 1500 frames (30 s of audio), each with S = 448 decoder tokens,
# Whisper's whole decoder context. A step launches flash_attention 72
# times (12 full at 1500 x 1500, 12 causal at 448 x 448, 12 full at 448 x
# 1500, each forward and recomputed in the backward) and
# flash_attention_bwd 36 times
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ = 16, 448
# internvl2-76b at its published widths cut in depth only, from 80 to 6
# layers: 6 x 0.856 B + 2.10 B of embedding and head = 7.24 B parameters,
# whose bf16 weights and gradients, f32 first moment and factored second
# moment take 57.9 GB (53.9 GiB) of the card's 80. Built as the vlm path
# builds it and stepped with make_train_step under the reference's
# optimizer for this arch (repro/launch/dryrun.py arch_opt_config:
# factored, f32 state). B = 4 x S = 1024: one 448-px tile's 256 vision
# embeddings (labels -1), then 768 text tokens, as in InternVL2's
# supervised fine-tuning on single-image samples; the loss counts 4 x 767
# positions (the last label of a row is -1 too). 12 flash_attention and 6
# flash_attention_bwd launches a step
VLM_TRAIN_DEPTH, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ = 6, 4, 1024
# scripts/train_lr_sweep.py's choice (see PERF.md): the largest learning
# rate of 1e-5, 3e-5, 1e-4, 3e-4 and 1e-3 at which the loss fell at
# every step
MODAL_TRAIN_LR = {"whisper-small": 1e-4, "internvl2-76b": 3e-5}
MODAL_TRAIN_PATHS = ("audio_train", "vlm_train")
# the first attention call with gradients of each kind a layer check and a
# kernel row take: whisper's encoder layer 0 (full, 1500 x 1500), decoder
# layer 0's self-attention (causal, 448 x 448) and its cross-attention
# (full, 448 x 1500); internvl2's layer 0 (causal, D 128, G 8)
MODAL_TRAIN_LAYERS = {
    "audio_train": {
        "encoder layer 0": lambda a, kw: not kw["causal"]
        and a[0].shape[1] == a[1].shape[1],
        "decoder layer 0 self-attention": lambda a, kw: kw["causal"],
        "decoder layer 0 cross-attention": lambda a, kw: not kw["causal"]
        and a[0].shape[1] < a[1].shape[1]},
    "vlm_train": {"layer 0": lambda a, kw: True}}
# The pod path: the reference's anns-sift-10m dry-run row
# (src/repro/launch/dryrun.py:221; SIFT10M's shape, the paper's Table
# III: 10M x 128 f32, 4096 queries, k 100, p_loc 2 probed partitions of
# cap 16 a rank, aggregation points p_agg 0.2 of n) on
# make_local_mesh(model_axis=2) over 4 gloo ranks that share the card
# (data 2, model 2): the database sharded over all four (2.5M rows, 1.28
# GB a rank); the assign step's residual rows over data and aggregation
# points over model, rounded to its chunks as lower_anns_cell rounds them
# (k 8, row chunk 4096, column chunk 65,536)
POD_RANKS, POD_MODEL_AXIS = 4, 2
POD_N, POD_D, POD_Q, POD_K = 10_000_000, 128, 4096, 100
POD_P_LOC, POD_CAP, POD_P_AGG = 2, 16, 0.2
POD_ASSIGN_K, POD_ROW_CHUNK, POD_COL_CHUNK = 8, 4096, 65536
POD_DATA = ("queries", "db", "rows", "res", "agg")   # the seeded blocks
POD_TIMEOUT_S = 300   # a collective that waits longer fails the path
# The ep path: the moe path's DBRX-132B (MOE_ARCHS' row: published widths,
# 4 of 40 layers, seed 0, MOE_BATCH x MOE_PROMPT batch_at prompts, MOE_NEW
# greedy tokens) served with expert parallelism by 4 gloo ranks that share
# the card. Phase A, mesh (data 1, model 4): 4 of 16 experts a rank, the
# tokens whole on every rank, so the capacities are the unsharded model's;
# Engine.generate cold and warm. Its phase B (mesh (data 2, model 2), the
# experts' d over data, one prefill at 1 layer: 9.7 s and a 6.1 s gather
# timed on an H100 host) was cut for the smoke's clock; the
# experts' FSDP over data runs on the card in the tp path's phase T3 (a
# DBRX-132B train step on (data 2, model 2)), and tests/test_torch_moe_ep.py
# holds it on the CPU
EP_RANKS = 4
EP_MESH = ((1, 4), ("data", "model"))
# the first MoE layer in f32, sharded against unsharded on the same input:
# a token's contributions are grouped by rank before they are added
EP_LAYER_RTOL = 1e-5
# The dp_train path: launch/train.py's setup and step on 2 gloo ranks
# that share the card, the trainer's own (data, model) mesh
# (make_local_mesh over --model-axis). T1: TinyLlama-1.1B at its
# published widths cut to 2 of 22 layers, (data 2, model 1), B=8 x
# S=2048 (the train path's batch: 4 rows a rank), TRAIN_LR, a warm step
# and 3 timed ones on one repeated batch. T2: DBRX-132B at its published
# widths cut to 1 of 40 layers, capacity 1.25 (its config's), (data 1,
# model 2): 8 of 16 experts a rank, factored f32 AdamW (launch/dryrun.py's
# policy for dbrx), B=4 x S=512, 3 steps. T3, taken by the tp path's four
# ranks after their phase B: T2's model, batch and settings on (data 2,
# model 2), one step: 8 of 16 experts a rank with half of each expert's d
# (FSDP over data), 24 of 48 query heads, 4 of 8 kv heads and a quarter of
# the embeddings and LM head; its one-process side is T2's
DP_RANKS = 2
DP_PHASES = {"T1": dict(arch=TRAIN_ARCH, depth=2, changes={},
                        model_axis=1, batch=8, seq=2048, steps=4,
                        factored=False),
             "T2": dict(arch="dbrx-132b", depth=1,
                        changes={"capacity_factor": 1.25}, model_axis=2,
                        batch=4, seq=512, steps=3, factored=True),
             "T3": dict(arch="dbrx-132b", depth=1,
                        changes={"capacity_factor": 1.25}, model_axis=2,
                        batch=4, seq=512, steps=1, factored=True)}
DP_RANK_PHASES = ("T1", "T2")     # the dp_train ranks'; T3 is the tp ranks'
# The MoE layer in f32, sharded against unsharded, with a seeded
# cotangent: each gradient within this share of its largest magnitude (f32
# sums of a token's contributions grouped by rank, the experts' split over
# model). T2: on the first row of the one-process step's layer input. T3:
# each data rank on its own row (rows 0 and 1: a row holds the capacity of
# its own 512 tokens, as one process on that row alone does), the input's
# gradient against its row's, the router's (summed over data, as the step
# sums it) and the rank's d block of its first expert (summed over data
# by the reduce-scatter) against the two rows' added
DP_LAYER_RTOL = 1e-5
T3_ROWS = 2
# elements a parameter's bit fingerprint sums at a time
FINGERPRINT_ROW = 4096
# The dp_train, tp, tp_families and tp_hd ranks each start (spawn_ranks)
# while the rank path before theirs runs (ep, dp_train, tp and
# tp_families): a fresh rank's
# Python start-up and the torch._dynamo import that its first checkpointed
# step makes (torch.utils.checkpoint's dynamo-disabling wrapper; on an
# H100 host the first step took 15.3 s against 1.0 s for the next) then
# overlap a path that waits on gloo. Started together before the pod
# path, the ten processes' start-up took the host's cores from the pod
# and ep paths (36-38 s slower on an H100 host); started beside their own
# path's short one-process side, they held up the go (dp_train +15-20 s
# on a slow host). A rank waits for its path's go file, at most this
# long, before it touches the card
DP_WAIT_S = 900
# The tp path: TinyLlama-1.1B at its published widths with every weight and the
# decode cache placed by the reference's specs (models/model.py under
# mesh_context), on 4 gloo ranks that share the card (started while dp_train's
# run, each waiting for its go). Phase A, mesh (data 1, model 4), all 22
# layers: 8 of 32 query heads, 1 of 4 kv heads, 1408 of 5632 d_ff and 8000 of
# 32,000 vocabulary rows a rank; a prefill of TP_BATCH x TP_PROMPT seeded
# tokens and TP_NEW - 1 greedy decode steps, in f32 with the unsharded f32
# run's tokens fed (its logits and greedy choices gated) and in bf16 through
# Engine.generate. Phase B, mesh (data 2, model 2), the model cut to TP_B_DEPTH
# layers (each decode step gathers every weight's data block through the
# shared host segment), f32: a batch of one decoded, TP_B_NEW tokens (its cache's slots
# split over data: TP_PROMPT + TP_B_NEW slots), then one AdamW step on TP_BATCH
# x TP_PROMPT
TP_RANKS = 4
TP_MESHES = {"A": ((1, 4), ("data", "model")),
             "B": ((2, 2), ("data", "model"))}
TP_BATCH, TP_PROMPT, TP_NEW = 4, 512, 17
TP_B_DEPTH, TP_B_NEW = 2, 4
TP_SEED = 0
# f32, sharded against unsharded: the logits within this share of the
# row's largest |logit| (sums over model added in another order); the
# step's loss and grad norm relative; the updated parameters to
# tests/test_torch_train.py's tolerance but for a share of elements where
# Adam's g / (|g| + eps) turns f32 noise into up to lr, each within 3 lr
TP_LOGITS_RTOL = 1e-4
TP_LOSS_RTOL, TP_GNORM_RTOL = 1e-5, 1e-4
TP_PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
TP_PARAM_OUTLIERS = 1e-3

# The tp_families path: the ssm, hybrid and audio families at their
# published widths with every weight and decode cache placed by the
# reference's specs (models/model.py and models/ssm.py under
# mesh_context), on 4 gloo ranks sharing the card (started while tp's
# run, each waiting for its go), each phase against the unsharded model of the
# same seed. A: mamba2-370m on (data 1, model 4), all 48 layers (8 of 32
# SSD heads, in_proj 512 + 512 + 32 + 32 + 8 columns a rank); B:
# hymba-1.5b on (1, 4) cut to TPF_B_DEPTH layers (its global layer 0 and
# windowed ones; all 128 meta tokens; attention replicated, the slots
# over model, the SSD's 50 heads whole and its conv's channels split:
# case 2); C: whisper-small on (1, 4), uncut (3 heads and 768 d_ff a
# rank), 4 clips of 1500 frames. Each: a prefill of TPF_BATCH prompts and
# TPF_NEW - 1 greedy decode steps in f32 with the unsharded run's tokens
# fed (logits and greedy choices gated) and in bf16 through
# Engine.generate. D: on (data 2, model 2), hymba-1.5b cut to TPF_D_DEPTH
# layers decodes a batch of one (its slots split over data), then one
# AdamW step each of mamba2-370m and hymba-1.5b at TPF_D_DEPTH layers on
# TP_BATCH x TP_PROMPT (tp's gates). E: hymba-1.5b placed under
# DistConfig(shard_head_dim_fallback=True) (its 25 heads do not divide
# model, so wq, wk, wv and wo are split over the head dim: 16 of 64 columns
# of every head a rank on (1, 4), 32 on (2, 2); the decode cache too), held
# to the unsharded runs B and D already took: on (1, 4) at B's depth, B's
# prompts, f32 forced run and bf16 Engine.generate; on (2, 2) at
# TPF_D_DEPTH, D's decode of one (its slots over data) and D's hymba train
# step
TPF_PHASES = {
    "A": dict(arch="mamba2-370m", depth=None, prompt=512,
              mesh=((1, 4), ("data", "model"))),
    "B": dict(arch="hymba-1.5b", depth=4, prompt=512,
              mesh=((1, 4), ("data", "model"))),
    "C": dict(arch="whisper-small", depth=None, prompt=64,
              mesh=((1, 4), ("data", "model")))}
TPF_BATCH, TPF_NEW = 4, 9
TPF_D_MESH = ((2, 2), ("data", "model"))
TPF_D_ARCHS, TPF_D_DEPTH, TPF_D_NEW = ("mamba2-370m", "hymba-1.5b"), 2, 4
TPF_D_DECODE = "hymba-1.5b"
TPF_E_MESH = ((1, 4), ("data", "model"))
TPF_SEED = 0
# the first block's placed widths each phase reports
TPF_WIDTHS = ("in_proj", "conv_w", "out_proj", "wq", "wk", "wo", "w_fc",
              "w_gate")
# the attention calls kept for the kernel rows: hymba's first windowed
# layer (layer 1: whole heads, window 1024, 128 meta tokens), whisper's
# first encoder layer (3 heads a rank)
TPF_CAPTURE = {
    "A": lambda a, kw: False,
    "B": lambda a, kw: kw.get("window", 0) > 0,
    "E": lambda a, kw: kw.get("window", 0) > 0,
    "C": lambda a, kw: not kw["causal"] and a[0].shape[1] == a[1].shape[1],
    "S1": lambda a, kw: kw.get("window", 0) > 0,
    "S3": lambda a, kw: False}

# The tp_hd path: case M of the reference's head-dim placement
# (DistConfig(shard_head_dim_fallback=True), where the query heads divide
# model and the kv heads do not), TinyLlama-1.1B at its published widths
# on (data 1, model 8): 8 gloo ranks sharing the card (started while
# tp_families' run, each waiting for its go). A rank holds 4 of the 32
# query heads (wq and wo split by heads) and 8 of the 64 dims of each of
# the 4 kv heads (wk and wv), and its decode cache that head-dim block.
# M1, all 22 layers: phase A's prompts, f32 forced run and bf16
# Engine.generate; M2 at TP_B_DEPTH layers, f32: phase B's decode of one
# and train step. Both held to tp_reference's unsharded runs (the same
# seed, prompts and depth) under tp's gates
TP_HD_RANKS = 8
TP_HD_MESH = ((1, 8), ("data", "model"))

# The tp_ssd path: the SSD layouts of the reference's specs where a
# concatenated leaf divides model only as a whole or not at all
# (models/ssm.py's Split), at published widths on gloo ranks sharing the
# card (started while tp_hd's run, each waiting for its go), two worlds in
# turn. World 1, (data 1, model 5), hymba-1.5b: its 50 SSD heads split (10
# a rank, and the decode state h) while in_proj (6482 columns) and the
# conv (3232 channels, and its window) stay whole on every rank; its 25 /
# 5 attention heads split (5 / 1 a rank); the MLP (d_ff 5504) and the
# vocabulary (32,128 padded) whole. S1, all 32 layers: TPF_PHASES' hymba
# prompts (TPF_BATCH x 512, and the 128 meta tokens), the f32 forced run
# of TPF_NEW - 1 decode steps fed the unsharded run's tokens and the bf16
# Engine.generate, as tp_families' serve phases; S2: tp_families' D step
# of hymba (TPF_D_DEPTH layers, f32, TP_BATCH x TP_PROMPT). World 2, the
# first 3 ranks again on (data 1, model 3), mamba2-370m: the conv's 2304
# channels (2048 + 128 + 128) in contiguous blocks of 768 (and its window),
# in_proj (4384 columns) and the 32 SSD heads whole, the vocabulary
# (50,304 padded) split; S3 all 48 layers as tp_families' phase A, S4 its
# D step of mamba2. Held under tp_families' gates (the steps' losses
# within TP_SSD_LOSS_RTOL) to the unsharded runs of the same seeds: S1's
# own (tpssd_reference), S2-S4's tp_families' (kept from that path)
TP_SSD_RANKS = 5
# (serve phase, step phase, arch, mesh, the serve phase's unsharded runs)
TP_SSD_WORLDS = (
    ("S1", "S2", "hymba-1.5b", ((1, 5), ("data", "model")), "S1"),
    ("S3", "S4", "mamba2-370m", ((1, 3), ("data", "model")), "A"))
TP_SSD_LOSS_RTOL = 1e-6

# The reference's chunked attention pads K and V with zero keys to a
# multiple of this chunk (when longer) that only a causal mask hides, so
# its full attention (whisper's encoder and prefill cross-attention) gives
# them weight (ROADMAP queue 3); the port attends to the real keys, and the
# audio checks size the difference at full width by emulating the padding
REF_CHUNK = 512

# The census path: launch/dryrun.py's whole grid in process, then one
# rank's share of the paper's billion-scale rows at the 16x16 mesh (world
# size 1: the merges are the identity; the pod path runs them across
# ranks), then the long_500k decode on one card
CENSUS_ANNS = ("anns-bigann-1b", "anns-deep-1b")
CENSUS_LONG = ("mamba2-370m", "hymba-1.5b")
CENSUS_LONG_STEPS = 3     # timed decode steps after a warm one
CENSUS_SEED = 7
# the caching allocator rounds a block of up to 1 MiB up to a multiple of
# 512 bytes; a larger one may keep the rest of its segment, itself a
# multiple of 2 MiB, when less than 1 MiB of it is left (on an H100, a
# 2,000,000,000-byte block took 683,008 bytes more)
ALLOC_SMALL, ALLOC_LARGE = 512, 2 << 20

# The profiled generate of each served path decodes this many tokens (its
# path's other generates decode theirs): the profiler's own work grows with
# each decode step's launches (~4,000 a step on hymba-1.5b); with all of a
# path's tokens it took 5-35 s a path, 117 s of the smoke on an H100
PROFILE_NEW = 8

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM, dense bf16 tensor cores
INF = 3.4e38


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def hops() -> str:
    """The graph phase's hop loop, named on the build phases' lines."""
    from repro_torch.core.graph_search import HOP_BLOCK
    return f"hops in blocks of {HOP_BLOCK}, CUDA graph replays"


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want, exact: bool,
            atol: float = 1e-4) -> float:
    """Hold a kernel's (d2, ids) against its plain version's. Exact inputs
    must agree bit for bit, ids included (the tie rule); float inputs to
    |a - b| <= atol + 1e-4 |b| on d2, and ids may differ only at
    positions whose distances agree to that tolerance (a near-tie).
    Returns the max abs error over real entries."""
    gd, gi = (t.cpu() for t in got)
    wd, wi = (t.cpu() for t in want)
    if exact:
        if not (torch.equal(gi, wi) and torch.equal(gd, wd)):
            bad = (gi != wi).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: exact inputs disagree at {bad}")
        return 0.0
    if not torch.equal(gi < 0, wi < 0):
        raise AssertionError(f"{name}: padding positions disagree")
    real = wi >= 0
    err = (gd - wd).abs()
    tol = atol + 1e-4 * wd.abs()
    if (err > tol)[real].any():
        raise AssertionError(f"{name}: d2 off by {err[real].max():.3g}")
    if ((gi != wi) & real & (err > tol)).any():
        raise AssertionError(f"{name}: ids differ beyond near-ties")
    return float(err[real].max()) if real.any() else 0.0


def ragged_ids(rng, q: int, c: int, dev) -> torch.Tensor:
    """Distinct ids per row with ragged lengths 0..C (row 0 all padding)."""
    ids = np.tile(rng.permutation(1 << 20)[:c].astype(np.int32), (q, 1))
    lens = np.linspace(0, c, q).astype(int)
    ids[np.arange(c)[None, :] >= lens[:, None]] = -1
    return torch.from_numpy(ids).to(dev)


def norm_atol(q: torch.Tensor, x: torch.Tensor) -> float:
    """The expanded form |q|^2 - 2 q.x + |x|^2 loses float32 digits
    against the norms, not against the (small) distance itself."""
    return 1e-5 * float((q * q).sum(-1).max() + (x * x).sum(-1).max())


def check_unmasked_edges(dev) -> None:
    """l2_topk and pq_adc against their plain versions on the card."""
    from repro_torch.kernels import l2_topk, pq_adc
    rng = np.random.default_rng(1)
    # (Q, N, d, k): N < k; N, d off every tile; k = 1, 100, 256; Q >> N
    # (SPANN's closure shape); N >> Q (the ground truth's, rows split); Q
    # and N off the 128 x 128 tiles; Q = 1; d off the 4-column chunks;
    # k = 1 and 256 at N = 1M
    for qn, n, d, k in [(5, 7, 16, 10), (9, 1000, 24, 10),
                        (33, 777, 128, 1), (40, 5000, 128, 100),
                        (7, 3000, 64, 256), (20_000, 6250, 128, 8),
                        (3, 200_000, 128, 10), (130, 1000, 128, 10),
                        (257, 3001, 64, 17), (129, 129, 32, 129),
                        (1, 50_000, 128, 10), (1, 129, 128, 1),
                        (6, 4099, 13, 10), (4, 1_000_000, 128, 1),
                        (4, 1_000_000, 128, 256)]:
        q = torch.from_numpy(rng.standard_normal((qn, d), np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((n, d), np.float32)).to(dev)
        compare(f"l2_topk {qn}x{n}x{d} k={k}", l2_topk.l2_topk(q, x, k),
                l2_topk.l2_topk_plain(q, x, k), exact=False,
                atol=norm_atol(q, x))
    # small integers: exact distances; duplicate rows tie at the k-th
    # place, within one row slice and across the merged slices
    for qn, n, k in [(6, 3000, 64), (4, 100_000, 10), (5, 2, 3)]:
        q = rng.integers(-2, 3, (qn, 16)).astype(np.float32)
        x = rng.integers(-2, 3, (n, 16)).astype(np.float32)
        x[n // 2:n // 2 + 4] = q[0]            # four exact ties at d2 = 0
        q, x = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
        compare(f"l2_topk ties {qn}x{n} k={k}", l2_topk.l2_topk(q, x, k),
                l2_topk.l2_topk_plain(q, x, k), exact=True)
    # exact ties straddling the k-th place across row splits: each query
    # sits far from the data; 7 rows at d2 = 0 and 20 at d2 = 1, spread
    # over the slices, so places 8-10 go to the three lowest ids of 20
    for qn, n, k in [(3, 200_000, 10), (130, 300_000, 10)]:
        q = np.zeros((qn, 16), np.float32)
        q[:, 0] = 10.0 + 10.0 * np.arange(qn)
        x = rng.integers(-2, 3, (n, 16)).astype(np.float32)
        planted = rng.permutation(n)[:27 * qn].reshape(qn, 27)
        for i in range(qn):
            x[planted[i]] = q[i]
            x[planted[i, 7:], 1] += 1.0
        q, x = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
        got = l2_topk.l2_topk(q, x, k)
        compare(f"l2_topk split ties {qn}x{n} k={k}", got,
                l2_topk.l2_topk_plain(q, x, k), exact=True)
        if l2_topk.split_rows(qn, n)[0] < 8 or not (
                got[0][:, 6] == 0).all() or not (got[0][:, 7:] == 1).all():
            raise AssertionError("l2_topk split ties: the planted ties do "
                                 "not straddle the k-th place over slices")

    # pq_adc sums in the plain version's order: bit for bit
    for n, m, dtype in [(1, 8, np.uint8), (64, 8, np.uint8),
                        (1000, 16, np.uint8), (777, 16, np.int32),
                        (50_000, 8, np.uint8)]:
        lut = torch.from_numpy(rng.random((m, 256), np.float32)).to(dev)
        codes = rng.integers(0, 256, (n, m)).astype(dtype)
        codes[0] = 0
        codes[-1] = 255
        codes = torch.from_numpy(codes).to(dev)
        got, want = pq_adc.pq_adc(lut, codes), pq_adc.pq_adc_plain(lut, codes)
        if not torch.equal(got, want):
            raise AssertionError(f"pq_adc {n}x{m} {dtype.__name__}: off by "
                                 f"{(got - want).abs().max():.3g}")
    lut = torch.zeros((8, 256), device=dev)
    codes = torch.zeros((4, 8), dtype=torch.uint8, device=dev)
    for bad in (lambda: l2_topk.l2_topk(q, x, 257),
                lambda: l2_topk.l2_topk(q.cpu(), x, 5),
                lambda: l2_topk.l2_topk(q, x[:, :8], 5),
                lambda: pq_adc.pq_adc(lut, codes.float()),
                lambda: pq_adc.pq_adc(torch.zeros((65, 256), device=dev),
                                      codes[:, :1].expand(4, 65)
                                      .contiguous()),
                lambda: pq_adc.pq_adc(lut.cpu(), codes)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("a kernel took arguments it must refuse")
    torch.cuda.synchronize()


def check_adc_rows_edges(dev) -> None:
    """pq_adc_rows against its plain version on the card, bit for bit
    (both sum m = 0 .. M-1): empty segments, one segment, segments off the
    64- and 256-thread blocks, ids 0 and n-1, M = 1, 4, 8, 12, 16 and 64
    (8-, 4- and 1-byte code loads; M = 64 stages 64 KB), both LUT variants
    forced and chosen, a table off 8-byte alignment, a long single segment
    (the single-LUT case), T == 0, an id outside the table (NaN), and the
    refusals."""
    from repro_torch.kernels import ops, pq_adc
    rng = np.random.default_rng(3)

    def case(q, lens, m, n, stage=None, table=None, name=""):
        luts = torch.from_numpy(rng.random((q, m, 256), np.float32)).to(dev)
        if table is None:
            table = torch.from_numpy(rng.integers(0, 256, (n, m),
                                                  dtype=np.uint8)).to(dev)
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        rows = rng.integers(0, n, int(offsets[-1])).astype(np.int32)
        if len(rows):
            rows[0], rows[-1] = 0, n - 1
        rows, offsets = (torch.from_numpy(a).to(dev) for a in (rows, offsets))
        got = pq_adc.pq_adc_rows(luts, table, rows, offsets, stage=stage)
        want = pq_adc.pq_adc_rows_plain(luts, table, rows, offsets)
        if not torch.equal(got, want):
            raise AssertionError(f"pq_adc_rows {name} Q={q} M={m} "
                                 f"stage={stage}: off by "
                                 f"{(got - want).abs().max():.3g}")

    # the comparison's waves: 1000 queries, ~50 rows, some done (0 rows)
    lens = rng.integers(0, 100, 1000)
    lens[::7] = 0
    for m in (1, 4, 8, 12, 16, 64):
        for stage in (None, False, True):
            case(1000, lens, m, 100_000, stage, name="wave")
    for q, lens_q, m in [(1, [1], 8), (1, [65], 8), (3, [0, 257, 0], 8),
                         (5, [0, 0, 0, 0, 0], 8), (2, [64, 63], 16),
                         (1, [50_000], 8), (3, [10_000] * 3, 64),
                         (4, [300, 0, 1, 513], 1)]:
        for stage in (None, False, True):
            case(q, np.asarray(lens_q), m, 100_000, stage, name="edge")
    # a table 4 bytes off 8-byte alignment takes the 4-byte loads
    flat = torch.from_numpy(rng.integers(0, 256, 8 * 5000 + 4,
                                         dtype=np.uint8)).to(dev)
    odd = flat[4:].view(5000, 8)
    if odd.data_ptr() % 8 == 0:
        raise AssertionError("the odd table is 8-byte aligned")
    for stage in (False, True):
        case(40, rng.integers(0, 80, 40), 8, 5000, stage, table=odd,
             name="unaligned table")
    luts = torch.rand((2, 8, 256), device=dev)
    table = torch.zeros((10, 8), dtype=torch.uint8, device=dev)
    rows = torch.tensor([0, 9, 10, -1], dtype=torch.int32, device=dev)
    offsets = torch.tensor([0, 2, 4], dtype=torch.int32, device=dev)
    got = pq_adc.pq_adc_rows(luts, table, rows, offsets)
    if not (torch.isfinite(got[:2]).all() and torch.isnan(got[2:]).all()):
        raise AssertionError("pq_adc_rows: an id outside the table must "
                             "give NaN")
    before = ops.launch_counts()["pq_adc_rows"]
    empty = pq_adc.pq_adc_rows(luts, table, rows[:0], torch.zeros(
        3, dtype=torch.int32, device=dev))
    if empty.shape != (0,) or ops.launch_counts()["pq_adc_rows"] != before:
        raise AssertionError("pq_adc_rows: T == 0 must not launch")
    for bad in (lambda: pq_adc.pq_adc_rows(luts, table.int(), rows, offsets),
                lambda: pq_adc.pq_adc_rows(luts, table, rows.long(), offsets),
                lambda: pq_adc.pq_adc_rows(luts.double(), table, rows,
                                           offsets),
                lambda: pq_adc.pq_adc_rows(luts, table, rows, offsets[:2]),
                lambda: pq_adc.pq_adc_rows(
                    torch.zeros((2, 65, 256), device=dev),
                    torch.zeros((10, 65), dtype=torch.uint8, device=dev),
                    rows, offsets),
                lambda: pq_adc.pq_adc_rows(luts.cpu(), table, rows, offsets),
                lambda: pq_adc.pq_adc_rows(luts, table.cpu(), rows, offsets)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("pq_adc_rows took arguments it must refuse")
    torch.cuda.synchronize()


def flash_check(got: torch.Tensor, want: torch.Tensor, name: str) -> float:
    """Hold a flash_attention output against its plain version's: one
    bf16 step for bf16 outputs, FLASH_F32_TOL for f32. Returns the max
    abs error."""
    tol = FLASH_BF16_TOL if want.dtype == torch.bfloat16 else FLASH_F32_TOL
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape} {got.dtype} against "
                             f"{want.shape} {want.dtype}")
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not (torch.isfinite(got).all() and (err <= tol + tol * want.abs())
            .all()):
        raise AssertionError(f"{name}: off by {float(err.max()):.3g}")
    return float(err.max())


def check_flash_edges(dev) -> None:
    """flash_attention against its plain version on the card: causal and
    full, Sq = Sk and Sq < Sk (Sq > Sk when full), lengths off the 64-row
    and 32-key tiles, GQA groups 1, 4 and 8, every compiled D (16, 32, 64,
    112, 128) and padded ones (12, 48, 100), f32 and bf16, and the rag
    path's own shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    rng = np.random.default_rng(2)
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, H, KVH, Sq, Sk, D, causal, dtype)
    for b, h, kvh, sq, sk, d, causal, dtype in [
            (1, 4, 4, 128, 128, 64, True, f32),
            (2, 8, 2, 77, 77, 64, True, bf16),
            (1, 8, 1, 100, 300, 128, True, f32),
            (2, 8, 1, 65, 130, 128, True, bf16),
            (1, 4, 1, 50, 93, 64, False, f32),
            (1, 4, 4, 200, 33, 32, False, bf16),
            (1, 2, 2, 1000, 1000, 128, False, f32),
            (3, 32, 4, 1, 1, 64, True, bf16),
            (1, 32, 4, 31, 531, 64, True, bf16),
            # the bf16 kernel's edges: 64-row q tiles of 4 x 16-row warps,
            # 64-key tiles. Sk < 16; Sq = 1 against 531 keys; Sq = 1
            # (mod 16); Sk off the key tile; causal Sq < Sk at D = 32 and
            # 128; groups 1 and 8
            (2, 4, 2, 9, 9, 64, True, bf16),
            (1, 4, 4, 5, 12, 32, False, bf16),
            (2, 32, 4, 1, 531, 64, True, bf16),
            (1, 8, 2, 17, 17, 64, True, bf16),
            (2, 8, 8, 81, 200, 128, False, bf16),
            (1, 8, 4, 100, 130, 64, True, bf16),
            (1, 8, 2, 40, 300, 32, True, bf16),
            (1, 8, 2, 70, 200, 128, True, bf16),
            (1, 8, 8, 96, 96, 64, True, bf16),
            (1, 16, 2, 96, 96, 64, True, bf16),
            # the REDUCED configs' D = 16 and qwen1.5's D = 12 (padded to
            # 16), kimi-k2's D = 112, and widths padded to 64 and 112:
            # causal and full, ragged Sq and Sk, both dtypes
            (2, 4, 2, 77, 77, 16, True, bf16),
            (2, 4, 2, 77, 77, 16, True, f32),
            (1, 4, 1, 50, 93, 16, False, bf16),
            (1, 4, 1, 50, 93, 16, False, f32),
            (2, 5, 5, 40, 40, 12, True, bf16),
            (2, 5, 5, 40, 40, 12, True, f32),
            (1, 5, 5, 33, 70, 12, False, bf16),
            (1, 5, 5, 33, 70, 12, False, f32),
            (1, 8, 1, 100, 130, 112, True, bf16),
            (1, 8, 1, 100, 130, 112, True, f32),
            (2, 8, 8, 81, 200, 112, False, bf16),
            (2, 8, 8, 81, 200, 112, False, f32),
            (1, 8, 2, 1, 531, 112, True, bf16),
            (1, 4, 2, 65, 65, 48, True, bf16),
            (1, 4, 2, 65, 65, 100, False, f32),
            # whisper's encoder layer (full 1500 x 1500) and its
            # cross-attention (full, 64 x 1500), internvl2's layer (D 128,
            # G 8) at batch 1
            (1, 12, 12, 1500, 1500, 64, False, bf16),
            (2, 12, 12, 64, 1500, 64, False, bf16),
            (2, 12, 12, 64, 1500, 64, False, f32),
            (1, 64, 8, 500, 500, 128, True, bf16),
            # last: the refusals below cut this shape
            (RAG_BATCH, 32, 4, RAG_PROMPT, RAG_PROMPT, 64, True, bf16)]:
        q = torch.from_numpy(rng.standard_normal((b, sq, h, d), np.float32))
        k = torch.from_numpy(rng.standard_normal((b, sk, kvh, d), np.float32))
        v = torch.from_numpy(rng.standard_normal((b, sk, kvh, d), np.float32))
        q, k, v = (t.to(dev, dtype) for t in (q, k, v))
        flash_check(fa.flash_attention(q, k, v, causal),
                    fa.flash_attention_plain(q, k, v, causal),
                    f"flash_attention B{b} H{h}/{kvh} {sq}x{sk} D{d} "
                    f"causal={causal} {dtype}")
    # Sq == 0: an empty output without a launch
    before = ops.launch_counts()["flash_attention"]
    if fa.flash_attention(q[:, :0], k, v).shape != q[:, :0].shape \
            or ops.launch_counts()["flash_attention"] != before:
        raise AssertionError("flash_attention: Sq == 0 must not launch")
    k1 = k[:, :10].contiguous()
    for bad in (lambda: fa.flash_attention(q, k1, k1[:, :10]),  # Sq > Sk
                lambda: fa.flash_attention(  # D above the widest width
                    *(torch.nn.functional.pad(t, (0, 80)) for t in (q, k, v))),
                lambda: fa.flash_attention(q, k.float(), v),
                lambda: fa.flash_attention(q[:, :, :30].contiguous(), k, v),
                lambda: fa.flash_attention(q.transpose(1, 2), k, v),
                lambda: fa.flash_attention(q.cpu(), k, v)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("flash_attention took arguments it must refuse")
    check_flash_window_edges(dev)
    torch.cuda.synchronize()


def check_flash_window_edges(dev) -> None:
    """The sliding window and meta tokens: flash_attention against its
    plain version over FLASH_WINDOW_EDGES; a window of at least Sk
    (meta tokens or none) equal to the causal launch bit for bit; a
    window with causal=False and negative arguments refused."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(4)
    for b, h, kvh, sq, sk, d, window, meta, dtype in FLASH_WINDOW_EDGES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, np.float32)).to(dev, dtype) for shape in
            ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))
        kw = dict(window=window, meta_tokens=meta)
        flash_check(fa.flash_attention(q, k, v, **kw),
                    fa.flash_attention_plain(q, k, v, **kw),
                    f"flash_attention B{b} H{h}/{kvh} {sq}x{sk} D{d} "
                    f"window={window} meta={meta} {dtype}")
        causal = fa.flash_attention(q, k, v)
        for wide, m in ((sk, 0), (sk, meta), (sk + 7, 3)):
            if not torch.equal(fa.flash_attention(
                    q, k, v, window=wide, meta_tokens=m), causal):
                raise AssertionError(
                    f"flash_attention: window {wide} >= Sk {sk} differs "
                    f"from causal ({dtype}, {b}x{h}/{kvh}x{sq}x{sk}x{d})")
    for kw in (dict(causal=False, window=8), dict(window=-1),
               dict(window=8, meta_tokens=-1)):
        try:
            fa.flash_attention(q, k, v, **kw)
        except ValueError:
            continue
        raise AssertionError(f"flash_attention took {kw}")


def flash_bwd_check(got, want, name: str) -> float:
    """Hold (dq, dk, dv) against the plain version's: each within
    FLASH_BWD_BF16_TOL (bf16) or FLASH_BWD_F32_TOL (f32) of its largest
    magnitude, plus FLASH_BWD_F32_TOL of the largest magnitude of the
    three: an f32 rounding floor for a gradient that cancels to about 0
    (at Sq = Sk = 1, dP - delta is 0 in exact arithmetic, so dQ is).
    Returns the max abs error."""
    scale = max((float(w.float().abs().max()) for w in want
                 if w.numel()), default=0.0)
    worst = 0.0
    for part, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {part}: {g.shape} {g.dtype} "
                                 f"against {w.shape} {w.dtype}")
        if not w.numel():
            continue
        tol = FLASH_BWD_BF16_TOL if w.dtype == torch.bfloat16 \
            else FLASH_BWD_F32_TOL
        g, w = g.float(), w.float()
        err = float((g - w).abs().max())
        bound = tol * float(w.abs().max()) + FLASH_BWD_F32_TOL * scale
        if not torch.isfinite(g).all() or err > bound:
            raise AssertionError(f"{name} {part}: off by {err:.3g} "
                                 f"(bound {bound:.3g})")
        worst = max(worst, err)
    return worst


def check_flash_bwd_edges(dev) -> None:
    """flash_attention_bwd against its plain version on the card, fed the
    kernel forward's residuals (lse, held to the plain log-sum-exp, and
    the f32 output, which must round to the output bit for bit): bf16 and
    f32, every compiled D (16, 32, 64, 128) and
    padded ones (12, 48, 112), ragged Sq and Sk off the 64-row tiles and
    the 128-key blocks, causal (Sq <= Sk) and full (Sq < Sk and Sq > Sk),
    H/KVH = 1, 2 and 8, Sk < 16, Sq = 1, B = 2, grids of a few blocks and
    TinyLlama's 32 / 4 heads; then the refusals."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, H, KVH, Sq, Sk, D, causal, dtype)
    for b, h, kvh, sq, sk, d, causal, dtype in [
            (1, 4, 4, 128, 128, 64, True, f32),
            (1, 4, 4, 128, 128, 64, True, bf16),
            (2, 8, 1, 77, 77, 64, True, bf16),
            (1, 8, 1, 65, 130, 64, True, f32),
            (1, 4, 1, 50, 93, 64, False, bf16),
            (1, 4, 4, 200, 33, 32, False, bf16),
            (1, 4, 4, 200, 33, 32, False, f32),
            (1, 8, 1, 100, 130, 112, True, bf16),
            (1, 8, 1, 100, 130, 112, True, f32),
            (2, 8, 8, 81, 200, 112, False, bf16),
            (1, 8, 8, 100, 300, 128, True, bf16),
            (1, 2, 2, 300, 300, 128, False, f32),
            (2, 5, 5, 40, 40, 12, True, bf16),
            (2, 5, 5, 40, 40, 12, True, f32),
            (1, 5, 5, 33, 70, 12, False, bf16),
            (2, 4, 2, 77, 77, 16, True, bf16),
            (1, 4, 1, 50, 93, 16, False, f32),
            (1, 8, 8, 9, 9, 16, True, bf16),
            (1, 4, 2, 65, 65, 48, True, bf16),
            (3, 32, 4, 1, 1, 64, True, bf16),
            (2, 32, 4, 1, 531, 64, True, bf16),
            (1, 32, 4, 256, 256, 64, True, bf16),
            (1, 16, 2, 96, 96, 64, True, bf16),
            # the wgmma tiling: Sk off the 128-key blocks, causal Sq < Sk
            # at G = 8, D = 128 (32-row query steps) and D = 32, grids of
            # a few blocks, B = 2 with ragged rows (a map that read past
            # a batch's last row would read the next batch's)
            (1, 4, 2, 200, 200, 64, True, bf16),
            (1, 8, 1, 70, 250, 64, True, bf16),
            (2, 16, 2, 200, 260, 128, True, bf16),
            (1, 2, 2, 64, 64, 64, True, bf16),
            (2, 4, 4, 100, 100, 64, False, bf16),
            (2, 4, 2, 70, 70, 32, True, bf16)]:
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(
            shape, np.float32)).to(dev, dtype) for shape in
            ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d), (b, sq, h, d)))
        name = (f"flash_attention_bwd B{b} H{h}/{kvh} {sq}x{sk} D{d} "
                f"causal={causal} {dtype}")
        rounded, lse, out = fa.flash_attention(q, k, v, causal,
                                               return_lse=True)
        _, want_lse = fa.flash_attention_plain(q, k, v, causal,
                                               return_lse=True)[:2]
        tol = FLASH_LSE_BF16_TOL if dtype == bf16 else FLASH_LSE_F32_TOL
        lse_err = (lse - want_lse).abs()
        if not (lse_err <= tol + tol * want_lse.abs()).all():
            raise AssertionError(f"{name}: lse off by "
                                 f"{float(lse_err.max()):.3g}")
        # the f32 output the backward takes rounds to the output
        if out.dtype != torch.float32 or not torch.equal(out.to(dtype),
                                                         rounded):
            raise AssertionError(f"{name}: the f32 output does not round "
                                 f"to the output")
        flash_bwd_check(
            fa.flash_attention_bwd(q, k, v, out, lse, dout, causal),
            fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal),
            name)
    # Sq == 0: zeros without a launch
    before = ops.launch_counts()["flash_attention_bwd"]
    z = fa.flash_attention_bwd(q[:, :0], k, v, out[:, :0], lse[:, :, :0],
                               dout[:, :0])
    if ops.launch_counts()["flash_attention_bwd"] != before \
            or z[1].abs().sum() != 0 or z[0].shape != q[:, :0].shape:
        raise AssertionError("flash_attention_bwd: Sq == 0 must not launch")
    k1 = k[:, :10].contiguous()
    for bad in (lambda: fa.flash_attention_bwd(  # causal Sq > Sk
                    q, k1, k1, out, lse, dout, True),
                lambda: fa.flash_attention_bwd(  # D above the widest width
                    *(torch.nn.functional.pad(t, (0, 129 - d))
                      for t in (q, k, v, out)), lse,
                    torch.nn.functional.pad(dout, (0, 129 - d))),
                lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                               dout.float()),
                lambda: fa.flash_attention_bwd(q, k, v, out, lse[:, :1],
                                               dout),
                lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                               dout.transpose(1, 2)),
                lambda: fa.flash_attention_bwd(q.cpu(), k, v, out, lse,
                                               dout),
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                               False, window=8),
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                               window=-1)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("flash_attention_bwd took arguments it must "
                             "refuse")
    check_flash_bwd_window_edges(dev)
    torch.cuda.synchronize()


def check_flash_bwd_window_edges(dev) -> None:
    """The window and meta tokens in flash_attention_bwd: against its plain
    version over FLASH_BWD_WINDOW_EDGES, bf16 and f32, fed the windowed
    kernel forward's (lse, f32 output); and a window of at least Sk (meta
    tokens or none) equal to the causal launch bit for bit, on the causal
    forward's."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(5)
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, kvh, sq, sk, d, window, meta in FLASH_BWD_WINDOW_EDGES:
            q, k, v, dout = (torch.from_numpy(rng.standard_normal(
                shape, np.float32)).to(dev, dtype) for shape in
                ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d),
                 (b, sq, h, d)))
            kw = dict(window=window, meta_tokens=meta)
            name = (f"flash_attention_bwd B{b} H{h}/{kvh} {sq}x{sk} D{d} "
                    f"window={window} meta={meta} {dtype}")
            _, lse, out = fa.flash_attention(q, k, v, return_lse=True,
                                             **kw)
            flash_bwd_check(
                fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw),
                fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw),
                name)
            _, lse, out = fa.flash_attention(q, k, v, return_lse=True)
            causal = fa.flash_attention_bwd(q, k, v, out, lse, dout)
            for wide, m in ((sk, 0), (sk, meta), (sk + 7, 3)):
                got = fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                             window=wide, meta_tokens=m)
                if not all(torch.equal(g, c) for g, c in zip(got, causal)):
                    raise AssertionError(f"{name}: window {wide} >= Sk "
                                         f"differs from causal")


def sass_counts(lib: Path, opcode: str) -> dict:
    """How many ``opcode`` instructions each kernel of a built library
    holds, from ``cuobjdump -sass`` (by mangled function name)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and f" {opcode}" in line:
            counts[fn] += 1
    return counts


def check_flash_tensor_cores() -> None:
    """The bf16 flash kernels run on the tensor cores: the forward's SASS
    holds HMMA (``mma.sync``) instructions at every width of
    ``HEAD_DIMS``, the backward's two product kernels HGMMA (``wgmma``)
    instructions at every width of ``BWD_HEAD_DIMS``. Prints every
    kernel's count (the f32 kernels and ``bwd_delta`` hold none)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS, HEAD_DIMS
    for lib, opcode, widths, variants in (
            ("flash_attention", "HMMA", HEAD_DIMS, ("flash_fwd_bf16",)),
            ("flash_attention_bwd", "HGMMA", BWD_HEAD_DIMS,
             ("bwd_dkdv_wgmma", "bwd_dq_wgmma"))):
        build.build_all((lib,))   # a no-op once built
        counts = sass_counts(build.lib_path(lib), opcode)
        by_variant = {v: {fn: n for fn, n in counts.items() if v in fn}
                      for v in variants}
        print(f"{lib} SASS {opcode} count: "
              f"{json.dumps({v: sum(c.values()) for v, c in by_variant.items()})}"
              f" per kernel {json.dumps(counts)}", flush=True)
        for v in variants:
            if len(by_variant[v]) != len(widths) \
                    or min(by_variant[v].values()) == 0:
                raise AssertionError(f"{lib}: a {v} kernel holds no "
                                     f"{opcode}")


def check_kernel_edges(dev) -> None:
    """Kernel vs plain version on edge shapes and exact-tie inputs."""
    check_unmasked_edges(dev)
    check_adc_rows_edges(dev)
    check_flash_edges(dev)
    check_flash_bwd_edges(dev)
    check_masked_edges(dev)


def interleaved_ids(rng, q: int, c: int, frac: float, dev) -> torch.Tensor:
    """Distinct ids per row with a share ``frac`` of the positions padding
    (-1) anywhere in the row, not only at its tail."""
    ids = np.tile(rng.permutation(1 << 22)[:c].astype(np.int32), (q, 1))
    ids[rng.random((q, c)) < frac] = -1
    return torch.from_numpy(ids).to(dev)


def check_masked_edges(dev) -> None:
    """l2_topk_masked and pq_adc_masked against their plain versions:
    ragged and interleaved padding, C < k, k = 1 .. 256, bf16 pools at the
    main path's C, all-equal and exactly tied distances (bit for bit, ids
    included), pools long enough for the global-key branch, C == 0 and
    the refusals."""
    from repro_torch.kernels import l2_topk, ops, pq_adc
    rng = np.random.default_rng(0)

    def l2(qv, pools, ids, k, name, exact=False):
        compare(f"l2_topk_masked {name} {tuple(pools.shape)} k={k} "
                f"{pools.dtype}", l2_topk.l2_topk_masked(qv, pools, ids, k),
                l2_topk.l2_topk_masked_plain(qv, pools, ids, k), exact)

    def adc(luts, codes, ids, k, name, exact=False):
        compare(f"pq_adc_masked {name} {tuple(codes.shape)} k={k}",
                pq_adc.pq_adc_masked(luts, codes, ids, k),
                pq_adc.pq_adc_masked_plain(luts, codes, ids, k), exact)

    def normal(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)

    def small_ints(*shape):
        return torch.from_numpy(rng.integers(-2, 3, shape).astype(
            np.float32)).to(dev)

    def codes_of(q, c, m):
        return torch.from_numpy(rng.integers(0, 256, (q, c, m),
                                             dtype=np.uint8)).to(dev)

    # the main path's C (14,973) and the global-key C (60,000)
    main_c, l2_global_c, adc_global_c = 14_973, 60_000, 120_000
    if l2_topk.select_smem(main_c, 4 * 128)[0] is not True or \
            l2_topk.select_smem(l2_global_c, 4 * 128)[0] is not False or \
            l2_topk.select_smem(adc_global_c, 1024 * 8)[0] is not False:
        raise AssertionError("the edge shapes miss a branch of the keys")
    for q, c, d, k, dtype in [(4, 96, 16, 5, torch.float32),
                              (9, 257, 32, 10, torch.float32),
                              (6, 40, 24, 64, torch.float32),   # C < k
                              (3, 1000, 128, 200, torch.float32),
                              (5, 777, 128, 10, torch.bfloat16),
                              (4, 3000, 128, 256, torch.float32),
                              (5, 1, 128, 10, torch.float32),
                              (3, 500, 13, 10, torch.float32),  # d % 4 != 0
                              (3, 500, 13, 10, torch.bfloat16),
                              (2, 300, 1024, 10, torch.float32),
                              (16, main_c, 128, 10, torch.bfloat16),
                              (3, l2_global_c, 128, 10, torch.float32)]:
        qv, pools = normal(q, d), normal(q, c, d, dtype=dtype)
        l2(qv, pools, ragged_ids(rng, q, c, dev), k, "ragged")
        l2(qv, pools, interleaved_ids(rng, q, c, 0.3, dev), k, "interleaved")
    # small integers: every distance exact, many exact ties; tail and
    # interleaved padding, k = 64 and 256, the global-key branch
    for q, c, k in [(8, 600, 64), (4, 3000, 256), (3, l2_global_c, 10),
                    (3, l2_global_c, 256)]:
        qv, pools = small_ints(q, 16), small_ints(q, c, 16)
        l2(qv, pools, ragged_ids(rng, q, c, dev), k, "ties", exact=True)
        l2(qv, pools, interleaved_ids(rng, q, c, 0.3, dev), k,
           "ties interleaved", exact=True)
    # all distances equal (every pool row is one vector): the k lowest
    # real positions win
    for q, c, k, dtype in [(4, 900, 10, torch.float32),
                           (4, 900, 64, torch.float32),
                           (3, 5000, 256, torch.bfloat16),
                           (2, l2_global_c, 64, torch.float32)]:
        qv = small_ints(q, 32)
        pools = small_ints(q, 1, 32).expand(q, c, 32).contiguous().to(dtype)
        l2(qv, pools, interleaved_ids(rng, q, c, 0.3, dev), k, "all equal",
           exact=True)

    for q, c, m, k in [(4, 96, 8, 5), (7, 257, 4, 10), (5, 40, 16, 64),
                       (3, 1000, 64, 200), (4, 3000, 8, 256),
                       (5, 1, 8, 10), (6, 500, 12, 10),   # M % 8 != 0
                       (3, 30_000, 64, 64),               # M = 64, shared
                       (2, 40_000, 64, 10),               # M = 64, global
                       (16, main_c, 8, 64), (3, adc_global_c, 8, 64)]:
        luts = torch.from_numpy(rng.random((q, m, 256), np.float32)).to(dev)
        codes = codes_of(q, c, m)
        adc(luts, codes, ragged_ids(rng, q, c, dev), k, "ragged")
        adc(luts, codes, interleaved_ids(rng, q, c, 0.3, dev), k,
            "interleaved")
    # integer LUTs: exact sums and ties; all-equal sums (one value per m)
    for q, c, k in [(6, 900, 32), (4, 3000, 256), (3, adc_global_c, 64)]:
        luts = torch.from_numpy(rng.integers(0, 4, (q, 8, 256)).astype(
            np.float32)).to(dev)
        codes = codes_of(q, c, 8)
        adc(luts, codes, ragged_ids(rng, q, c, dev), k, "ties", exact=True)
        adc(luts, codes, interleaved_ids(rng, q, c, 0.3, dev), k,
            "ties interleaved", exact=True)
    for q, c, k in [(4, 900, 10), (4, 900, 64), (3, 5000, 256),
                    (2, adc_global_c, 10)]:
        luts = torch.from_numpy(np.repeat(rng.integers(0, 4, (q, 8, 1)), 256,
                                          axis=2).astype(np.float32)).to(dev)
        adc(luts, codes_of(q, c, 8), interleaved_ids(rng, q, c, 0.3, dev), k,
            "all equal", exact=True)

    # C == 0: sentinels without a launch
    codes, ids = codes_of(q, 10, 8), ragged_ids(rng, q, 10, dev)
    before = ops.launch_counts()["pq_adc_masked"]
    out_d, out_i = pq_adc.pq_adc_masked(luts, codes[:, :0].contiguous(),
                                        ids[:, :0].contiguous(), 5)
    if not ((out_i == -1).all() and (out_d == INF).all()
            and ops.launch_counts()["pq_adc_masked"] == before):
        raise AssertionError("pq_adc_masked: C == 0 must return sentinels")
    # what the kernels do not take raises: C == 0 for l2, k > 256, a CPU
    # tensor, a non-contiguous pool
    q2, p2, i2 = small_ints(8, 16), small_ints(8, 600, 16), \
        ragged_ids(rng, 8, 600, dev)
    for bad in (lambda: l2_topk.l2_topk_masked(
                    q2, p2[:, :0].contiguous(), i2[:, :0].contiguous(), 5),
                lambda: l2_topk.l2_topk_masked(q2, p2, i2, 257),
                lambda: l2_topk.l2_topk_masked(q2.cpu(), p2, i2, 5),
                lambda: l2_topk.l2_topk_masked(q2, p2[:, ::2], i2[:, ::2],
                                               5),
                lambda: pq_adc.pq_adc_masked(luts, codes, ids, 257),
                lambda: pq_adc.pq_adc_masked(luts.cpu(), codes, ids, 5)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise AssertionError("a kernel took arguments it must refuse")
    torch.cuda.synchronize()


def nth_call(n: int):
    """A ``Capture`` test that accepts the call numbered ``n`` (from 0)."""
    seen = [-1]

    def want(_args, _kw):
        seen[0] += 1
        return seen[0] == n
    return want


class Capture:
    """Keeps the inputs of the first call of a kernel entry point in
    ``repro_torch.kernels.ops`` that ``want(args, kw)`` accepts (for timing at
    a path's own shapes), its tensors detached (so that a training call's
    inputs keep no autograd graph, nor the weights it reaches, alive); the
    call itself goes on to the real wrapper unchanged."""

    def __init__(self, ops, name: str, want):
        self.ops, self.name, self.want = ops, name, want
        self.args = None

    def __enter__(self):
        # the entry point as it stands now: captures of one name nest
        self.orig = getattr(self.ops, self.name)

        def wrapped(*args, **kw):
            if self.args is None and self.want(args, kw):
                self.args = (tuple(a.detach() if torch.is_tensor(a) else a
                                   for a in args), kw)
            return self.orig(*args, **kw)
        setattr(self.ops, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.orig)


def serve(plane: str, pag, store, ds, dev,
          rerank_k: int = SEARCH_ARGS["rerank_k"]):
    """Every query of ``ds`` through AnnsFrontend over ShardedServing;
    returns (ids, d2, report)."""
    from repro_torch.core.distributed import ShardedServing
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.vectors import recall_at_k
    from repro_torch.obs import observe
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serving.engine import AnnsFrontend
    cfg = SearchConfig(**{**SEARCH_ARGS, "rerank_k": rerank_k},
                       compression=plane)
    frontend = AnnsFrontend(
        ShardedServing(pag=pag, store=store, n_shards=N_SHARDS, dim=D,
                       device=dev), cfg, max_batch=MAX_BATCH)
    metrics = MetricsRegistry()
    t0 = time.perf_counter()
    with observe(metrics=metrics):
        tickets = [frontend.submit(q) for q in ds.queries]
        results = frontend.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ids = np.stack([results[t][0] for t in tickets])
    d2 = np.stack([results[t][1] for t in tickets])
    snap = metrics.snapshot()
    report = {
        "recall@10": recall_at_k(ids, ds.gt_ids, K),
        "wall_qps": len(tickets) / wall,
        "batch_qps": len(tickets) / frontend.clock_s,
        "wall_s": wall,
        "graph_wall_s": snap["search.graph_wall_s.sum"],
        "pool_wall_s": snap["search.pool_wall_s.sum"],
        "kernel_wall_s": snap["kernels.launch_s.sum"],
        "pool_size_mean": snap["search.pool_size.mean"],
    }
    return ids, d2, report


def check_results(ids, d2, ds, dev) -> None:
    """Shapes, finiteness, and returned distances re-derived exactly on
    the card for a sample of queries."""
    nq = len(ds.queries)
    if ids.shape != (nq, K) or d2.shape != (nq, K):
        raise AssertionError(f"result shapes {ids.shape}, {d2.shape}")
    if not ((ids >= 0).all() and np.isfinite(d2).all()
            and (ids < ds.n).all()):
        raise AssertionError("results hold padding, ids out of range or "
                             "non-finite distances")
    if (np.diff(d2, axis=1) < 0).any():
        raise AssertionError("result distances are not ascending")
    sample = np.arange(0, nq, 16)
    x = torch.from_numpy(ds.base[ids[sample]]).to(dev)
    q = torch.from_numpy(ds.queries[sample]).to(dev)
    true = ((x - q[:, None, :]) ** 2).sum(-1).cpu().numpy()
    if not np.allclose(d2[sample], true, rtol=1e-3, atol=1e-3):
        raise AssertionError("returned distances do not match the base")


def index_and_serve(tag: str, n: int, n_queries: int, floor: float, dev,
                    other_rerank=()):
    """make_dataset -> build_pag -> write_partitions -> both planes
    through the frontend, each step a phase; checks results and floors.
    ``other_rerank`` lists rerank_k values whose PQ-plane recall is
    reported beside (no floor). Returns the reports and the index
    ``(ds, pag, store)``."""
    from repro_torch.core.pag import build_pag
    from repro_torch.core.search import write_partitions
    from repro_torch.data.vectors import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.storage.simulator import ObjectStore, StorageConfig
    with phase(f"{tag}: make_dataset n={n}"):
        ds = make_dataset("clustered", n=n, d=D, n_queries=n_queries,
                          k_gt=K, seed=0, device=dev)
    with phase(f"{tag}: build_pag ({hops()})"):
        pag = build_pag(ds.base, **PAG_ARGS, device=dev)
        nonempty = int((pag.pcount[:pag.n_parts] > 0).sum())
        print(f"{tag} partitions: {pag.n_parts} ({nonempty} nonempty, cap "
              f"{pag.cap}), build stats {json.dumps(pag.build_stats)}")
    with phase(f"{tag}: write_partitions"):
        store = ObjectStore(StorageConfig.preset("dfs", seed=1))
        write_partitions(pag, ds.base, store, n_shards=N_SHARDS,
                         compression="pq", pq_m=PQ_M, device=dev)
    reports = {}
    with phase(f"{tag}: serve float and pq planes"):
        for plane in ("none", "pq"):
            before = ops.launch_counts()
            ids, d2, rep = serve(plane, pag, store, ds, dev)
            rep["launches"] = {name: c - before[name]
                               for name, c in ops.launch_counts().items()}
            check_results(ids, d2, ds, dev)
            reports[plane] = rep
            print(f"{tag} serve {plane}: {json.dumps(rep)}", flush=True)
    fl, pq = reports["none"]["recall@10"], reports["pq"]["recall@10"]
    if fl < floor or pq < fl - PQ_RECALL_GAP:
        raise AssertionError(f"{tag} recall floors: float {fl:.4f} (>= "
                             f"{floor}), pq {pq:.4f} (>= float - "
                             f"{PQ_RECALL_GAP})")
    for rk in other_rerank:
        with phase(f"{tag}: serve pq plane at rerank_k={rk}"):
            rep = serve("pq", pag, store, ds, dev, rerank_k=rk)[2]
            print(f"{tag} serve pq rerank_k={rk}: {json.dumps(rep)}")
    return reports, (ds, pag, store)


def rag(dev, index) -> dict:
    """Retrieval-augmented generation at TinyLlama-1.1B's width: 8 of the
    index's queries retrieve k=10 ids each through ``search_pag``; each
    prompt is its ids modulo the vocabulary, then ``batch_at`` tokens up
    to RAG_PROMPT; ``Engine.generate`` prefills and decodes RAG_NEW greedy
    tokens, once cold (first use of every kernel and library), once warm
    and once under the profiler. Returns what the checks and the report
    need."""
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig, search_pag
    from repro_torch.data.lm import DataConfig, batch_at
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, ServeConfig
    ds, pag, store = index
    cfg = get_config(RAG_ARCH)
    with phase(f"rag: init {RAG_ARCH} (seeded, on the card)"):
        model = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
    with phase("rag: retrieve"):
        ids, _, _ = search_pag(pag, D, ds.queries[:RAG_BATCH], store,
                               SearchConfig(**SEARCH_ARGS),
                               n_shards=N_SHARDS, device=dev)
        if ids.shape != (RAG_BATCH, K) or (ids < 0).any():
            raise AssertionError(f"rag: retrieval gave {ids.shape} ids "
                                 f"with padding")
    ctx = torch.from_numpy(ids.astype(np.int64) % cfg.vocab_size).to(dev)
    filler = batch_at(DataConfig(seed=0, batch_size=RAG_BATCH,
                                 seq_len=RAG_PROMPT - K), cfg, 0,
                      device=dev)["tokens"]
    prompt = torch.cat([ctx, filler], dim=1)
    engine = Engine(cfg, model, ServeConfig(max_new_tokens=RAG_NEW))
    runs = {}
    for run in ("cold", "warm"):
        with phase(f"rag: generate ({run})"):
            gen = engine.generate({"tokens": prompt})
        runs[run] = dict(engine.timing)
    with phase("rag: generate (profiled)"):
        profile = profile_generate(engine, prompt)
    if gen.shape != (RAG_BATCH, RAG_NEW) or (gen < 0).any() \
            or (gen >= cfg.vocab_size).any():
        raise AssertionError(f"rag: generated {gen.shape} ids out of range")
    return {"cfg": cfg, "model": model, "prompt": prompt, "gen": gen,
            "timing": runs, "retrieved": ids, "profile": profile}


def profile_generate(engine, prompt) -> dict:
    """One more ``generate`` of ``prompt`` (tokens, or a batch dict with
    a modality stub), of PROFILE_NEW tokens, under ``torch.profiler``:
    the device's busy time (the sum of its kernels' times; one stream, so
    they do not overlap) against the host wall time of the traced call,
    and the kernels that took most of it. The profiler slows the host, so the
    idle share is an upper bound. Device times are None where the
    profiler records none. Only the device is traced: host operator
    events would add several times the kernels' count to the trace
    (~4,000 kernels a decode step on hymba-1.5b)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Engine
    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    engine = Engine(engine.cfg, engine.model, dataclasses.replace(
        engine.scfg, max_new_tokens=PROFILE_NEW))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(batch)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"traced_wall_s": wall, **dict(engine.timing),
            "device_busy_s": busy_us / 1e6 if busy_us else None,
            "device_idle_share": 1 - busy_us / 1e6 / wall if busy_us
            else None,
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}


@contextlib.contextmanager
def plain_attention():
    """The model's prefill attention through the materialised-scores
    oracle instead of the kernel, for the duration."""
    from repro_torch.models import attention, model
    saved = model.attention
    model.attention = attention.attention_reference
    try:
        yield
    finally:
        model.attention = saved


def prefill_launches(cfg) -> int:
    """flash_attention launches of one prefill: one a layer, and with an
    encoder one an encoder layer and a second (cross-attention) a decoder
    layer."""
    return cfg.enc_layers + cfg.n_layers * (2 if cfg.enc_layers else 1)


def seeded_batch(cfg, tokens, dev, seed: int = 0) -> dict:
    """``tokens`` with the family's modality stub, seeded numpy standard
    normal f32: whisper's ``frames`` [B, enc_frames, d], internvl2's
    ``vision_embeds`` [B, vision_tokens, d]."""
    rng = np.random.default_rng(seed)

    def normal(n):
        return torch.from_numpy(rng.standard_normal(
            (tokens.shape[0], n, cfg.d_model), np.float32)).to(dev)
    batch = {"tokens": tokens}
    if cfg.enc_layers:
        batch["frames"] = normal(cfg.enc_frames)
    if cfg.family == "vlm":
        batch["vision_embeds"] = normal(cfg.vision_tokens)
    return batch


def check_reduced_prefills(dev) -> dict:
    """A prefill (the teacher-forced forward) of each REDUCED config on
    the card through the flash_attention kernel (``prefill_launches``
    launches) against the same forward through the plain attention, to
    REDUCED_LOGITS_ATOL (a moe config's under the route rule, on the
    tokens whose routes agree). Returns each config's head dim, launches
    and max abs error."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import forward, init_params
    out = {}
    for arch in REDUCED_ARCHS:
        cfg = get_config(arch, reduced=True)
        model = init_params(cfg, seed=0, device=dev)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 77))).to(dev)
        batch = seeded_batch(cfg, tokens, dev)
        moe = cfg.family == "moe"
        routes = [RouteRecorder(cfg) if moe else contextlib.nullcontext()
                  for _ in range(2)]
        before = ops.launch_counts()["flash_attention"]
        with torch.inference_mode():
            with routes[0]:
                got = forward(model, batch, cfg)
            launched = ops.launch_counts()["flash_attention"] - before
            with plain_attention(), routes[1]:
                want = forward(model, batch, cfg)
        agree = torch.ones(tokens.numel(), dtype=torch.bool, device=dev)
        rep = {}
        if moe:
            rep, agree = route_rule(routes[0].calls, routes[1].calls,
                                    cfg.n_experts)
        err = float((got - want)[agree.view(tokens.shape)].abs().max())
        out[arch] = {"head_dim": cfg.resolved_head_dim, "launches": launched,
                     "max_abs": err,
                     "logits_max_abs": float(want.abs().max())}
        if moe:
            out[arch]["routes"] = rep
        if launched != prefill_launches(cfg) \
                or not torch.isfinite(got).all() \
                or err > REDUCED_LOGITS_ATOL or rep.get("violations") \
                or rep.get("agreement", 1.0) < ROUTE_AGREEMENT.get(arch, 0):
            raise AssertionError(f"REDUCED prefill {arch}: {out[arch]}")
    print(f"REDUCED prefills vs plain attention: {json.dumps(out)}",
          flush=True)
    return out


def check_rag(r: dict) -> dict:
    """At full width and in bf16: (1) the prefill logits through the
    kernel against the same forward through the plain attention; (2) the
    first token's logits and every decode step's against the
    teacher-forced forward over prompt + generated tokens. Each to
    RAG_LOGITS_ATOL; returns the max errors and greedy agreement."""
    from repro_torch.models import decode_step, forward, prefill
    cfg, model, prompt, gen = r["cfg"], r["model"], r["prompt"], r["gen"]
    out = {}
    with torch.inference_mode():
        logits = forward(model, {"tokens": prompt}, cfg)
        with plain_attention():
            want = forward(model, {"tokens": prompt}, cfg)
        out["prefill_vs_plain_max_abs"] = float((logits - want).abs().max())
        out["logits_max_abs"] = float(want[..., :cfg.vocab_size].abs().max())
        del logits, want
        gen_t = torch.from_numpy(gen).to(prompt.device).long()
        full = forward(model, {"tokens": torch.cat([prompt, gen_t[:, :-1]],
                                                   1)}, cfg)
        last, cache = prefill(model, {"tokens": prompt}, cfg,
                              max_len=RAG_PROMPT + RAG_NEW)
        errs = [float((last[:, -1] - full[:, RAG_PROMPT - 1]).abs().max())]
        for t in range(RAG_NEW - 1):
            step, cache = decode_step(model, gen_t[:, t:t + 1], cache,
                                      RAG_PROMPT + t, cfg)
            errs.append(float((step[:, 0] - full[:, RAG_PROMPT + t])
                              .abs().max()))
        teacher = full[:, RAG_PROMPT - 1:, :cfg.vocab_size].argmax(-1)
        out["greedy_equal_teacher_argmax"] = float(
            (teacher.cpu().numpy() == gen).mean())
    out["decode_vs_forward_max_abs"] = max(errs)
    print(f"rag checks: {json.dumps(out)}", flush=True)
    if out["prefill_vs_plain_max_abs"] > RAG_LOGITS_ATOL \
            or out["decode_vs_forward_max_abs"] > RAG_LOGITS_ATOL:
        raise AssertionError(f"rag: logits off by more than "
                             f"{RAG_LOGITS_ATOL}: {out}")
    return out


class RouteRecorder:
    """While active, records every routing call of the MoE layers
    (``repro_torch.models.moe.route``, one call a MoE layer a forward or
    decode step): each call's expert ids [T, k], which of them its
    capacity keeps [T, k] and the router probabilities [T, E], on the
    card, in call order."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route
        cfg = self.cfg

        def wrapped(xf, router, top_k):
            gate_w, gate_e = self.orig(xf, router, top_k)
            keep = moe.capacity_keep(gate_e, cfg.n_experts,
                                     moe.capacity(cfg, xf.shape[0]))
            # detached: in a train step the probabilities' autograd graph
            # would keep the step's activations and parameters alive
            probs = moe.softmax_fp32((xf.detach() @ router.detach()).float())
            self.calls.append((gate_e, keep, probs))
            return gate_w, gate_e
        moe.route = wrapped
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def host_calls(self) -> list:
        """The calls recorded so far, each tensor copied to the host."""
        return [tuple(t.cpu() for t in call) for call in self.calls]

    def dropped(self, n_tokens: int) -> dict:
        """Over the calls of ``n_tokens`` tokens: how many (token, expert)
        assignments capacity dropped, and how many tokens lost at least
        one (summed over layers and steps)."""
        calls = [keep for e, keep, _ in self.calls
                 if e.shape[0] == n_tokens]
        return {"calls": len(calls),
                "assignments": sum(int((~k).sum()) for k in calls),
                "token_layers": sum(int((~k).any(1).sum()) for k in calls),
                "of_assignments": sum(k.numel() for k in calls)}


def route_rule(got_calls, want_calls, n_experts: int):
    """The route rule between a kernel run's routing calls (``got``) and a
    plain run's (``want``), layer by layer over the same T tokens: the
    share of (token, layer) routes (expert ids) that are identical, and
    for each token its first difference, in ids (a near-tie) or, with the
    same ids, in a kept flag (displaced). Returns (report, [T] bool: the
    tokens whose ids and kept flags agree at every layer); the report
    lists first differences that are neither under ``violations``."""
    n_tok = got_calls[0][0].shape[0]
    dev = got_calls[0][0].device
    undecided = torch.ones(n_tok, dtype=torch.bool, device=dev)
    ids_same, by_layer, violations = [], [], []
    for layer, ((ge, gk, _), (we, wk, wp)) in enumerate(zip(got_calls,
                                                            want_calls)):
        def member(e, keep):
            routed = torch.zeros(n_tok, n_experts, dtype=torch.bool,
                                 device=dev).scatter_(1, e, True)
            return routed, torch.zeros_like(routed).scatter_(1, e, keep)
        (ra, ka), (rb, kb) = member(ge, gk), member(we, wk)
        routes_same = (ra == rb).all(1)
        same = routes_same & (ka == kb).all(1)
        # experts swapped: the plain run's best one left out against the
        # kernel run's worst one taken, in the plain run's probability
        hi = torch.where(rb & ~ra, wp, 0.0).amax(1)
        lo = torch.where(ra & ~rb, wp, float("inf")).amin(1)
        tie = hi - lo <= ROUTE_TIE_RTOL * hi
        # a kept flag that moved because an earlier token's route to that
        # expert changed
        moved = (ra != rb).int()
        ahead = torch.cumsum(moved, 0) - moved > 0
        displaced = ((ka != kb) & ~ahead).sum(1) == 0
        now = undecided & ~same
        bad = now & torch.where(routes_same, ~displaced, ~tie)
        by_layer.append({"ids_identical": int(routes_same.sum()),
                         "first_in_ids": int((now & ~routes_same).sum()),
                         "first_in_kept": int((now & routes_same).sum()),
                         "max_ids_gap": float(((hi - lo) / hi)[
                             now & ~routes_same].max())
                         if (now & ~routes_same).any() else 0.0})
        for t in torch.nonzero(bad)[:5, 0].tolist():
            union = sorted(set(ge[t].tolist()) | set(we[t].tolist()))
            violations.append({"token": t, "layer": layer,
                               "got": sorted(ge[t].tolist()),
                               "want": sorted(we[t].tolist()),
                               "want_probs": {e: float(wp[t, e])
                                              for e in union}})
        undecided &= same
        ids_same.append(routes_same)
    ids_same = torch.stack(ids_same)
    report = {"routes": ids_same.numel(), "identical": int(ids_same.sum()),
              "agreement": float(ids_same.float().mean()),
              "tokens_all_layers_agree": int(undecided.sum()),
              "by_layer": by_layer, "violations": violations}
    return report, undecided


def moe_serve(dev, arch: str, depth: int) -> dict:
    """One moe arch at its published widths with its depth cut to
    ``depth`` layers, seeded weights on the card: ``Engine.generate`` over
    MOE_BATCH x MOE_PROMPT ``batch_at`` prompts, MOE_NEW greedy tokens,
    cold (with the routes recorded, for the capacity drops), warm (with
    the peak memory) and under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm import DataConfig, batch_at
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, ServeConfig
    published = get_config(arch)
    cfg = dataclasses.replace(published, n_layers=depth)
    with phase(f"moe: init {arch} ({depth} of {published.n_layers} layers, "
               f"seeded, on the card)"):
        model = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
    prompt = batch_at(DataConfig(seed=0, batch_size=MOE_BATCH,
                                 seq_len=MOE_PROMPT), cfg, 0,
                      device=dev)["tokens"]
    engine = Engine(cfg, model, ServeConfig(max_new_tokens=MOE_NEW))
    runs = {}
    with phase(f"moe: {arch} generate (cold, routes recorded)"), \
            RouteRecorder(cfg) as rec:
        cold = engine.generate({"tokens": prompt})
    runs["cold"] = dict(engine.timing)
    drops = {"prefill": rec.dropped(MOE_BATCH * MOE_PROMPT),
             "decode": rec.dropped(MOE_BATCH)}
    cold_routes = rec.host_calls()
    del rec
    torch.cuda.reset_peak_memory_stats()
    with phase(f"moe: {arch} generate (warm)"):
        gen = engine.generate({"tokens": prompt})
    runs["warm"] = dict(engine.timing)
    peak = torch.cuda.max_memory_allocated()
    with phase(f"moe: {arch} generate (profiled)"):
        profile = profile_generate(engine, prompt)
    if gen.shape != (MOE_BATCH, MOE_NEW) or (gen < 0).any() \
            or (gen >= cfg.vocab_size).any():
        raise AssertionError(f"moe {arch}: generated {gen.shape} ids out "
                             f"of range")
    return {"arch": arch, "cfg": cfg, "published_layers": published.n_layers,
            "model": model, "prompt": prompt, "gen": gen, "timing": runs,
            "peak_bytes": peak, "drops": drops, "profile": profile,
            "cold_gen": cold, "cold_routes": cold_routes}


def check_moe(r: dict) -> dict:
    """At full width and in bf16, under the route rule: (1) the prefill
    logits through the kernel against the same forward through the plain
    attention, and a second kernel forward bit for bit against the first
    (no atomics in attention, dispatch or combine); (2) the first decode
    step (the first generated token) after a kernel prefill against the
    same step after a plain prefill (a decode step's own capacity drops
    tokens the prefill keeps, so decode is not held to the teacher-forced
    forward). Routes pooled over both for the arch's ROUTE_AGREEMENT;
    logits within RAG_LOGITS_ATOL on the tokens whose routes agree."""
    from repro_torch.models import decode_step, forward, prefill
    cfg, model, prompt = r["cfg"], r["model"], r["prompt"]
    tokens = {"tokens": prompt}
    first = torch.from_numpy(r["gen"][:, :1]).to(prompt.device).long()
    out = {}
    with torch.inference_mode():
        with RouteRecorder(cfg) as got_r:
            logits = forward(model, tokens, cfg)
        out["prefill_bit_identical"] = bool(torch.equal(
            logits, forward(model, tokens, cfg)))
        with plain_attention(), RouteRecorder(cfg) as want_r:
            want = forward(model, tokens, cfg)
        pre, agree = route_rule(got_r.calls, want_r.calls, cfg.n_experts)
        agree = agree.view(MOE_BATCH, MOE_PROMPT)
        out["prefill_vs_plain_max_abs"] = float(
            (logits - want)[agree].abs().max())
        out["prefill_vs_plain_max_abs_all_tokens"] = float(
            (logits - want).abs().max())
        out["logits_max_abs"] = float(want[..., :cfg.vocab_size].abs().max())
        del logits, want, got_r, want_r
        steps = {}
        for name, ctx in (("kernel", contextlib.nullcontext),
                          ("plain", plain_attention)):
            with ctx():
                _, cache = prefill(model, tokens, cfg,
                                   max_len=MOE_PROMPT + 1)
            with RouteRecorder(cfg) as rec:
                step, _ = decode_step(model, first, cache, MOE_PROMPT, cfg)
            steps[name] = (step[:, 0], rec.calls)
            del cache
        dec, dec_agree = route_rule(steps["kernel"][1], steps["plain"][1],
                                    cfg.n_experts)
        diff = steps["kernel"][0] - steps["plain"][0]
        out["decode_vs_plain_max_abs"] = float(diff[dec_agree].abs().max()) \
            if dec_agree.any() else 0.0
    out["routes_prefill"], out["routes_decode"] = pre, dec
    pooled = (pre["identical"] + dec["identical"]) \
        / (pre["routes"] + dec["routes"])
    out["route_agreement"] = pooled
    print(f"moe {r['arch']} checks: {json.dumps(out)}", flush=True)
    if not out["prefill_bit_identical"]:
        raise AssertionError(f"moe {r['arch']}: two prefills differ")
    if pooled < ROUTE_AGREEMENT[r["arch"]] or pre["violations"] \
            or dec["violations"]:
        raise AssertionError(f"moe {r['arch']}: routes break the route "
                             f"rule")
    if out["prefill_vs_plain_max_abs"] > RAG_LOGITS_ATOL \
            or out["decode_vs_plain_max_abs"] > RAG_LOGITS_ATOL:
        raise AssertionError(f"moe {r['arch']}: logits off by more than "
                             f"{RAG_LOGITS_ATOL} on agreeing routes")
    return out


def report_moe(r: dict, checks: dict, launches: int) -> None:
    """One moe arch's numbers, each on its own line, then one JSON line,
    beside its yardsticks: a decode step reads every weight but the
    embedding table once (bytes over 3.35 TB/s); the prefill's expert
    FLOPs are 2 T k 3 d f a MoE layer (at 989 TFLOP/s)."""
    cfg, model, warm = r["cfg"], r["model"], r["timing"]["warm"]
    arch, n_tok = r["arch"], MOE_BATCH * MOE_NEW
    total = warm["prefill_s"] + warm["decode_s"]
    weight_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters()
                       if n != "tok_embed")
    n_moe = cfg.n_layers - cfg.n_dense_layers
    tokens = MOE_BATCH * MOE_PROMPT
    expert_flops = n_moe * 2 * tokens * cfg.moe_top_k * 3 * cfg.d_model \
        * cfg.d_ff
    rep = {"arch": arch, "reduced": {"n_layers": [r["published_layers"],
                                                  cfg.n_layers]},
           "params": sum(p.numel() for p in model.parameters()),
           "batch": MOE_BATCH, "prompt_len": MOE_PROMPT,
           "new_tokens": MOE_NEW, "capacity_factor": cfg.capacity_factor,
           "flash_attention_launches": launches, "timing": r["timing"],
           "tokens_per_s": n_tok / total,
           "decode_tokens_per_s": MOE_BATCH * (MOE_NEW - 1)
           / warm["decode_s"],
           "prefill_tokens_per_s": tokens / warm["prefill_s"],
           "decode_step_s": warm["decode_s"] / (MOE_NEW - 1),
           "decode_step_bound_s": weight_bytes / HBM_BYTES_PER_S,
           "prefill_expert_tflop": expert_flops / 1e12,
           "prefill_expert_bound_s": expert_flops / BF16_OPS_PER_S,
           "peak_memory_bytes": r["peak_bytes"], "dropped": r["drops"],
           "first_generated_ids_0": r["gen"][0, :10].tolist(),
           "profile": r["profile"], **checks}
    print(f"moe {arch} reduced: {json.dumps(rep['reduced'])}")
    print(f"moe {arch} prefill seconds (warm): {warm['prefill_s']:.4f}")
    print(f"moe {arch} decode seconds (warm, {MOE_NEW - 1} steps): "
          f"{warm['decode_s']:.4f} (bound {rep['decode_step_bound_s']:.4f}"
          f" s a step)")
    print(f"moe {arch} tokens per second (warm): {rep['tokens_per_s']:.1f}")
    print(f"moe {arch} peak memory: {r['peak_bytes'] / 2 ** 30:.2f} GiB")
    print(f"moe {arch} dropped for capacity: {json.dumps(r['drops'])}")
    print(f"moe {arch} route agreement: {checks['route_agreement']:.5f}")
    print(f"moe {arch} report: {json.dumps(rep)}", flush=True)


def moe_train(dev) -> dict:
    """MOE_TRAIN_STEPS steps of ``launch/train.py``'s setup and step for
    each REDUCED moe config on the card (the trainer's defaults): finite
    loss and aux loss, aux loss above 0, one ``flash_attention_bwd`` a
    layer and step."""
    from repro_torch.data.lm import batch_at
    from repro_torch.kernels import ops
    from repro_torch.launch import train as trainer
    out = {}
    for arch, _ in MOE_ARCHS:
        args = trainer.parser().parse_args([
            "--arch", arch, "--steps", str(MOE_TRAIN_STEPS),
            "--device", str(dev)])
        cfg, dcfg, model, opt, step_fn = trainer.setup(args)
        before = ops.launch_counts()["flash_attention_bwd"]
        losses, aux = [], []
        for s in range(MOE_TRAIN_STEPS):
            _, opt, m = step_fn(model, opt, batch_at(dcfg, cfg, s,
                                                     device=dev))
            losses.append(float(m["loss"]))
            aux.append(float(m["aux_loss"]))
        bwd = ops.launch_counts()["flash_attention_bwd"] - before
        out[arch] = {"losses": losses, "aux_losses": aux,
                     "flash_attention_bwd": bwd, "layers": cfg.n_layers}
        if not np.isfinite(losses + aux).all() or min(aux) <= 0 \
                or bwd != MOE_TRAIN_STEPS * cfg.n_layers:
            raise AssertionError(f"moe train {arch}: {out[arch]}")
    print(f"moe train (REDUCED): {json.dumps(out)}", flush=True)
    return out


def long_serve(dev, tag: str, arch: str) -> dict:
    """One long-context path at its published width, uncut, seeded bf16
    weights on the card: ``Engine.generate`` over LONG_BATCH x
    LONG_PROMPT ``batch_at`` prompts, LONG_NEW greedy tokens, cold, warm
    (with the peak memory) and under the profiler; then one profiled warm
    prefill, its device time split by kernel class."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm import DataConfig, batch_at
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, ServeConfig
    cfg = get_config(arch)
    with phase(f"{tag}: init {arch} (seeded, on the card)"):
        model = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
    prompt = batch_at(DataConfig(seed=0, batch_size=LONG_BATCH,
                                 seq_len=LONG_PROMPT), cfg, 0,
                      device=dev)["tokens"]
    engine = Engine(cfg, model, ServeConfig(max_new_tokens=LONG_NEW))
    runs = {}
    with phase(f"{tag}: {arch} generate (cold)"):
        engine.generate({"tokens": prompt})
    runs["cold"] = dict(engine.timing)
    torch.cuda.reset_peak_memory_stats()
    with phase(f"{tag}: {arch} generate (warm)"):
        gen = engine.generate({"tokens": prompt})
    runs["warm"] = dict(engine.timing)
    peak = torch.cuda.max_memory_allocated()
    with phase(f"{tag}: {arch} generate (profiled)"):
        profile = profile_generate(engine, prompt)
    with phase(f"{tag}: {arch} prefill (profiled, by kernel class)"):
        split = prefill_split(model, cfg, prompt)
    if gen.shape != (LONG_BATCH, LONG_NEW) or (gen < 0).any() \
            or (gen >= cfg.vocab_size).any():
        raise AssertionError(f"{tag} {arch}: generated {gen.shape} ids out "
                             f"of range")
    return {"tag": tag, "arch": arch, "cfg": cfg, "model": model,
            "prompt": prompt, "gen": gen, "timing": runs, "peak_bytes": peak,
            "profile": profile, "prefill_split": split}


def kernel_class(name: str) -> str:
    """cuBLAS products, the flash_attention kernel, or the rest
    (elementwise passes, reductions, copies, scans)."""
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_attention"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas",
                              "sm90_")):
        return "cublas"
    return "elementwise_and_other"


def prefill_split(model, cfg, prompt) -> dict:
    """A warm ``prefill`` under ``torch.profiler``: its device time by
    ``kernel_class``, its top kernels, and the SSD's ``[B, nc, H, Q, Q]``
    f32 passes of one layer timed alone (``ssd_quadratic_ms``) times the
    layers, against that device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import prefill
    with torch.inference_mode():
        prefill(model, {"tokens": prompt}, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prefill(model, {"tokens": prompt}, cfg)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_class: dict = {}
    for e in kernels:
        c = kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    busy = sum(by_class.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    s = prompt.shape[1] + cfg.meta_tokens
    quad = ssd_quadratic_ms(cfg, prompt.shape[0], s, prompt.device)
    return {"device_ms": busy, "by_class_ms": by_class,
            "ssd_quadratic_ms_a_layer": quad,
            "ssd_quadratic_ms": quad * cfg.n_layers,
            "ssd_quadratic_share": quad * cfg.n_layers / busy if busy
            else None,
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def ssd_quadratic_ms(cfg, b: int, s: int, dev) -> float:
    """CUDA-event time of one layer's ``[B, nc, H, Q, Q]`` f32 elementwise
    passes of ``ssm.ssd_forward`` at a prefill of ``b`` x ``s`` positions,
    run as it runs them: the exponent difference, its clamp above the
    diagonal, the exponential, and the products with C.B and dt (on
    seeded inputs of those shapes)."""
    q = min(cfg.ssm_chunk, s)
    nc, nh = -(-s // q), cfg.ssm_heads
    gen = torch.Generator(dev).manual_seed(5)
    cum = -torch.rand((b, nc, nh, q), generator=gen, device=dev).cumsum(-1)
    cb = torch.randn((b, nc, q, q), generator=gen, device=dev)
    dt = torch.rand((b, nc, nh, q), generator=gen, device=dev)
    tri = torch.ones((q, q), dtype=torch.bool, device=dev).tril()

    def passes():
        diff = cum[..., :, None] - cum[..., None, :]
        w = torch.exp(diff.masked_fill(~tri, -1e30))
        return cb[:, :, None] * w * dt[:, :, :, None, :]
    return cuda_time_ms(passes, reps=5)


def check_ssd_recurrence(r: dict) -> dict:
    """Layer 0's SSD in f32 on the card: ``ssd_forward`` over S =
    SSD_HOLD_S seeded inputs (ragged chunks, the inter-chunk recurrence)
    against SSD_HOLD_S calls of ``ssd_decode_step`` from a zero state,
    outputs and final state within SSD_HOLD_RTOL of their largest
    magnitudes."""
    from repro_torch.models import ssm
    cfg = dataclasses.replace(r["cfg"], dtype="float32")
    dev = r["prompt"].device
    params = {n: p.float() for n, p in
              r["model"].blocks[0].ssm.named_parameters()}
    gen = torch.Generator(dev).manual_seed(3)
    x = torch.randn((2, SSD_HOLD_S, cfg.d_model), generator=gen,
                    device=dev)
    shapes = ssm.ssm_cache_shapes(cfg, 2)
    state = {k: torch.zeros(v, device=dev) for k, v in shapes.items()}
    with torch.inference_mode():
        want, want_state = ssm.ssd_forward(params, x, cfg, return_state=True)
        ys = []
        for t in range(SSD_HOLD_S):
            y, state = ssm.ssd_decode_step(params, x[:, t:t + 1], state, cfg)
            ys.append(y)
        got = torch.cat(ys, 1)
    out = {"S": SSD_HOLD_S, "chunks": -(-SSD_HOLD_S // cfg.ssm_chunk),
           "y_rel": float((got - want).abs().max() / want.abs().max()),
           "h_rel": float((state["h"] - want_state["h"]).abs().max()
                          / want_state["h"].abs().max())}
    print(f"ssm chunked SSD vs recurrence (f32, layer 0): "
          f"{json.dumps(out)}", flush=True)
    if not (out["y_rel"] <= SSD_HOLD_RTOL and out["h_rel"] <= SSD_HOLD_RTOL):
        raise AssertionError(f"ssm: chunked SSD off its recurrence: {out}")
    return out


def first_step_errors(model, cfg, prompt, first) -> tuple:
    """(the prefill's last logits, the first decode step's logits) against
    the teacher-forced forward over prompt + ``first``, max abs over the
    real vocabulary."""
    from repro_torch.models import decode_step, forward, prefill
    v = cfg.vocab_size
    full = forward(model, {"tokens": torch.cat([prompt, first], 1)},
                   cfg)[:, -2:, :v]
    last, cache = prefill(model, {"tokens": prompt}, cfg,
                          max_len=prompt.shape[1] + 1)
    step, _ = decode_step(model, first, cache, prompt.shape[1], cfg)
    return (float((last[:, -1, :v] - full[:, 0]).abs().max()),
            float((step[:, 0, :v] - full[:, 1]).abs().max()))


def check_long(r: dict) -> dict:
    """At full width: two prefills bit for bit (bf16); the first decode
    step after a prefill against the teacher-forced forward over prompt
    + that token, in float32 (DECODE_F32_ATOL) and in bf16
    (RAG_LOGITS_ATOL; the reference's REDUCED bound printed beside it);
    the hybrid prefill through the kernel against the plain attention
    (RAG_LOGITS_ATOL); the ssm's chunked SSD against its recurrence."""
    from repro_torch.models import forward
    from repro_torch.models.model import LM
    tag, cfg, model, prompt = r["tag"], r["cfg"], r["model"], r["prompt"]
    tokens = {"tokens": prompt}
    v = cfg.vocab_size
    out = {}
    with torch.inference_mode():
        logits = forward(model, tokens, cfg)
        out["prefill_bit_identical"] = bool(torch.equal(
            logits, forward(model, tokens, cfg)))
        out["logits_max_abs"] = float(logits[..., :v].abs().max())
        if tag == "hybrid":
            with plain_attention():
                want = forward(model, tokens, cfg)
            out["prefill_vs_plain_max_abs"] = float(
                (logits - want).abs().max())
            del want
        del logits
        first = torch.from_numpy(r["gen"][:, :1]).to(prompt.device).long()
        out["prefill_last_vs_forward_max_abs"], \
            out["decode_vs_forward_max_abs"] = first_step_errors(
                model, cfg, prompt, first)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = LM(cfg32, prompt.device)
        model32.load_state_dict(model.state_dict())   # cast up
        out["prefill_last_vs_forward_max_abs_f32"], \
            out["decode_vs_forward_max_abs_f32"] = first_step_errors(
                model32, cfg32, prompt, first)
        del model32
    out["decode_reference_atol"] = DECODE_REFERENCE_ATOL[tag]
    if tag == "ssm":
        out["ssd_recurrence"] = check_ssd_recurrence(r)
    print(f"{tag} checks: {json.dumps(out)}", flush=True)
    if not out["prefill_bit_identical"]:
        raise AssertionError(f"{tag}: two prefills differ")
    if out["decode_vs_forward_max_abs_f32"] > DECODE_F32_ATOL \
            or out["decode_vs_forward_max_abs"] > RAG_LOGITS_ATOL:
        raise AssertionError(f"{tag}: the first decode step is off the "
                             f"forward by more than {DECODE_F32_ATOL} in "
                             f"f32 or {RAG_LOGITS_ATOL} in bf16: {out}")
    if out.get("prefill_vs_plain_max_abs", 0.0) > RAG_LOGITS_ATOL:
        raise AssertionError(f"{tag}: prefill off the plain attention by "
                             f"more than {RAG_LOGITS_ATOL}: {out}")
    return out


def decode_bound_bytes(cfg, model, b: int = LONG_BATCH,
                       prompt: int = LONG_PROMPT, new: int = LONG_NEW
                       ) -> float:
    """The bytes a warm decode step must move, averaged over the ``new``
    - 1 steps after a ``b`` x ``prompt`` prefill: every weight it reads
    once (all but the embedding table, which a tied head reads whole,
    and the encoder's), the KV slots each attention layer can see (the
    window and the meta tokens, or every slot on a global layer), its new
    k/v, the cross-attention's ``xk``/``xv``, and each SSD layer's state
    ``h`` (f32) and conv window read and written."""
    weights = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters()
                  if (n != "tok_embed" or cfg.tie_embeddings)
                  and not n.startswith(("encoder.", "enc_norm")))
    elem = 2   # bf16 caches
    slot = 2 * b * cfg.n_kv_heads * cfg.resolved_head_dim * elem
    state = cfg.n_layers * cfg.enc_frames * slot
    if cfg.family in ("ssm", "hybrid"):
        state = cfg.n_layers * 2 * b * (
            cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * elem)
    kv = 0
    if not cfg.is_attention_free:
        for t in range(new - 1):
            pos = cfg.meta_tokens + prompt + t
            for i in range(cfg.n_layers):
                seen = pos + 1
                if cfg.attn_window and i not in cfg.global_layers:
                    seen = min(pos + 1, cfg.attn_window) + max(
                        0, min(cfg.meta_tokens, pos + 1 - cfg.attn_window))
                kv += (seen + 1) * slot
        kv /= new - 1
    return weights + state + kv


def report_long(r: dict, checks: dict, launches: dict) -> None:
    """One long path's numbers, each on its own line, then one JSON
    line."""
    tag, arch, cfg, warm = r["tag"], r["arch"], r["cfg"], r["timing"]["warm"]
    n_tok = LONG_BATCH * LONG_NEW
    step_s = warm["decode_s"] / (LONG_NEW - 1)
    bound = decode_bound_bytes(cfg, r["model"])
    rep = {"arch": arch, "reduced": {}, "params": sum(
        p.numel() for p in r["model"].parameters()),
           "batch": LONG_BATCH, "prompt_len": LONG_PROMPT,
           "meta_tokens": cfg.meta_tokens, "new_tokens": LONG_NEW,
           "launches": launches, "timing": r["timing"],
           "tokens_per_s": n_tok / (warm["prefill_s"] + warm["decode_s"]),
           "decode_tokens_per_s": LONG_BATCH * (LONG_NEW - 1)
           / warm["decode_s"],
           "prefill_tokens_per_s": LONG_BATCH * LONG_PROMPT
           / warm["prefill_s"],
           "decode_step_s": step_s, "decode_step_bound_bytes": bound,
           "decode_step_bound_s": bound / HBM_BYTES_PER_S,
           "peak_memory_bytes": r["peak_bytes"],
           "first_generated_ids_0": r["gen"][0, :10].tolist(),
           "profile": r["profile"], "prefill_split": r["prefill_split"],
           **checks}
    print(f"{tag} {arch} prefill seconds (warm): {warm['prefill_s']:.4f}")
    print(f"{tag} {arch} decode ms a step (warm, {LONG_NEW - 1} steps): "
          f"{step_s * 1e3:.3f} (byte bound "
          f"{rep['decode_step_bound_s'] * 1e3:.3f})")
    print(f"{tag} {arch} tokens per second (warm): "
          f"{rep['tokens_per_s']:.1f}")
    print(f"{tag} {arch} peak memory: {r['peak_bytes'] / 2 ** 30:.2f} GiB")
    print(f"{tag} {arch} idle share (profiled generate): "
          f"{r['profile']['device_idle_share']}")
    print(f"{tag} {arch} prefill device ms by class: "
          f"{json.dumps(r['prefill_split']['by_class_ms'])}, SSD "
          f"[B, nc, H, Q, Q] passes "
          f"{r['prefill_split']['ssd_quadratic_ms']:.3f} ms")
    print(f"{tag} report: {json.dumps(rep)}", flush=True)


def modal_serve(dev, tag: str, arch: str, depth, batch_size: int,
                prompt_len: int, new_tokens: int) -> dict:
    """One modality path: ``arch`` at its published widths (its depth cut
    to ``depth`` layers unless None; bf16, seeded weights) on the card,
    ``Engine.generate`` over ``batch_at``'s prompts with the family's
    modality stub (whisper's frames, internvl2's vision embeddings),
    ``new_tokens`` greedy tokens, cold, warm (with the peak memory) and
    under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm import DataConfig, batch_at
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, ServeConfig
    published = get_config(arch)
    cfg = dataclasses.replace(published, n_layers=depth or
                              published.n_layers)
    with phase(f"{tag}: init {arch} ({cfg.n_layers} of "
               f"{published.n_layers} layers; seeded, on the card)"):
        model = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
    batch = batch_at(DataConfig(seed=0, batch_size=batch_size,
                                seq_len=prompt_len), cfg, 0, device=dev)
    del batch["labels"]
    engine = Engine(cfg, model, ServeConfig(max_new_tokens=new_tokens))
    runs = {}
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        with phase(f"{tag}: {cfg.arch_id} generate ({run})"):
            gen = engine.generate(batch)
        runs[run] = dict(engine.timing)
    peak = torch.cuda.max_memory_allocated()
    with phase(f"{tag}: {cfg.arch_id} generate (profiled)"):
        profile = profile_generate(engine, batch)
    if gen.shape != (batch_size, new_tokens) or (gen < 0).any() \
            or (gen >= cfg.vocab_size).any():
        raise AssertionError(f"{tag}: generated {gen.shape} ids out of "
                             f"range")
    return {"tag": tag, "cfg": cfg, "model": model, "batch": batch,
            "gen": gen, "timing": runs, "peak_bytes": peak,
            "profile": profile, "reduced": {} if depth is None else {
                "n_layers": [published.n_layers, depth]}}


@contextlib.contextmanager
def padded_full_attention():
    """The model's attention as the reference's chunked jnp attention
    computes it (``repro/models/attention.py:67 _chunk_kv``), through the
    materialised scores: full attention over more than REF_CHUNK keys
    attends to zero keys padding them to a multiple of REF_CHUNK."""
    import torch.nn.functional as F
    from repro_torch.models import attention, model
    saved = model.attention

    def padded(q, k, v, causal=True, **kw):
        pad = -k.shape[1] % min(REF_CHUNK, k.shape[1])
        if not causal and pad:
            k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
        return attention.attention_reference(q, k, v, causal=causal, **kw)
    model.attention = padded
    try:
        yield
    finally:
        model.attention = saved


def check_modal(r: dict) -> dict:
    """At full width, in bf16: (1) one prefill's flash_attention launches,
    exactly ``prefill_launches``; (2) its logits through the kernel
    against the same forward through the plain attention; (3) the first
    token's logits and every decode step's against the teacher-forced
    forward over prompt + generated tokens (with the modality stub: this
    holds whisper's cross-attention cache), each to RAG_LOGITS_ATOL.
    Whisper: the encoder's output through the kernel against the plain
    attention, and the reference's zero-padded chunks emulated
    (``padded_full_attention``) against the plain attention, the size of
    the fault the port does not copy. Internvl2: the logits at every
    position from ``vision_tokens`` on must move when the vision
    embeddings change."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, forward, prefill
    tag, cfg, model, batch = r["tag"], r["cfg"], r["model"], r["batch"]
    gen = torch.from_numpy(r["gen"]).to(batch["tokens"].device).long()
    s, new, v = batch["tokens"].shape[1], gen.shape[1], cfg.vocab_size
    out = {}
    with torch.inference_mode():
        before = ops.launch_counts()["flash_attention"]
        logits = forward(model, batch, cfg)
        out["prefill_launches"] = \
            ops.launch_counts()["flash_attention"] - before
        with plain_attention():
            want = forward(model, batch, cfg)
        out["prefill_vs_plain_max_abs"] = float((logits - want).abs().max())
        out["logits_max_abs"] = float(want[..., :v].abs().max())
        if cfg.enc_layers:
            enc = model.encode(batch["frames"])
            with plain_attention():
                enc_plain = model.encode(batch["frames"])
            with padded_full_attention():
                enc_padded = model.encode(batch["frames"])
                padded = forward(model, batch, cfg)
            out["encoder_vs_plain_max_abs"] = float(
                (enc - enc_plain).float().abs().max())
            out["padded_reference_encoder_max_abs"] = float(
                (enc_padded - enc_plain).float().abs().max())
            out["padded_reference_logits_max_abs"] = float(
                (padded - want)[..., :v].abs().max())
            del enc, enc_plain, enc_padded, padded
        del want
        if cfg.family == "vlm":
            moved = forward(model, dict(batch, vision_embeds=-batch[
                "vision_embeds"]), cfg)
            by_pos = (moved - logits)[:, cfg.vision_tokens:, :v].abs() \
                .amax(-1)
            out["overlay_moved_min_abs"] = float(by_pos.min())
            del moved
        del logits
        full = forward(model, dict(batch, tokens=torch.cat(
            [batch["tokens"], gen[:, :-1]], 1)), cfg)[..., :v]
        last, cache = prefill(model, batch, cfg, max_len=s + new)
        errs = [float((last[:, -1, :v] - full[:, s - 1]).abs().max())]
        del last
        for t in range(new - 1):
            step, cache = decode_step(model, gen[:, t:t + 1], cache, s + t,
                                      cfg)
            errs.append(float((step[:, 0, :v] - full[:, s + t]).abs()
                              .max()))
        teacher = full[:, s - 1:].argmax(-1)
        out["greedy_equal_teacher_argmax"] = float(
            (teacher.cpu().numpy() == r["gen"]).mean())
        del full, cache
    out["first_token_vs_forward_max_abs"] = errs[0]
    out["decode_vs_forward_max_abs"] = max(errs)
    print(f"{tag} checks: {json.dumps(out)}", flush=True)
    if out["prefill_launches"] != prefill_launches(cfg):
        raise AssertionError(f"{tag}: {out['prefill_launches']} "
                             f"flash_attention launches in a prefill, want "
                             f"{prefill_launches(cfg)}")
    if out["prefill_vs_plain_max_abs"] > RAG_LOGITS_ATOL \
            or out["decode_vs_forward_max_abs"] > RAG_LOGITS_ATOL:
        raise AssertionError(f"{tag}: logits off by more than "
                             f"{RAG_LOGITS_ATOL}: {out}")
    if out.get("overlay_moved_min_abs", 1.0) <= 0.0:
        raise AssertionError(f"{tag}: a position past the vision tokens "
                             f"kept its logits when they changed")
    return out


def report_modal(r: dict, checks: dict, launches: dict) -> None:
    """One modality path's numbers, each on its own line, then one JSON
    line."""
    tag, cfg, warm = r["tag"], r["cfg"], r["timing"]["warm"]
    b, s = r["batch"]["tokens"].shape
    new = r["gen"].shape[1]
    step_s = warm["decode_s"] / (new - 1)
    bound_s = decode_bound_bytes(cfg, r["model"], b, s, new) \
        / HBM_BYTES_PER_S
    rep = {"arch": cfg.arch_id, "reduced": r["reduced"],
           "layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "params": sum(
               p.numel() for p in r["model"].parameters()),
           "batch": b, "prompt_len": s, "new_tokens": new,
           "inputs": {k: list(t.shape) for k, t in r["batch"].items()},
           "launches": launches, "timing": r["timing"],
           "tokens_per_s": b * new / (warm["prefill_s"] + warm["decode_s"]),
           "decode_tokens_per_s": b * (new - 1) / warm["decode_s"],
           "decode_step_s": step_s, "decode_step_bound_s": bound_s,
           "peak_memory_bytes": r["peak_bytes"],
           "first_generated_ids_0": r["gen"][0, :10].tolist(),
           "profile": r["profile"], **checks}
    print(f"{tag} {cfg.arch_id} prefill seconds (warm): "
          f"{warm['prefill_s']:.4f}")
    print(f"{tag} {cfg.arch_id} decode ms a step (warm, {new - 1} steps): "
          f"{step_s * 1e3:.3f} (byte bound {bound_s * 1e3:.3f})")
    print(f"{tag} {cfg.arch_id} tokens per second (warm): "
          f"{rep['tokens_per_s']:.1f}")
    print(f"{tag} {cfg.arch_id} peak memory: "
          f"{r['peak_bytes'] / 2 ** 30:.2f} GiB")
    print(f"{tag} {cfg.arch_id} idle share (profiled generate): "
          f"{r['profile']['device_idle_share']}")
    print(f"{tag} report: {json.dumps(rep)}", flush=True)


def cut_setup(args, depth: int, factored: bool):
    """``launch/train.py:setup``'s (cfg, dcfg, model, opt_state, step_fn)
    for the published config of ``args.arch`` cut in depth to ``depth``
    layers (as ``modal_serve`` cuts it), with the trainer's schedule, and
    the optimizer's second moment factored when ``factored``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as trainer
    cfg = dataclasses.replace(get_config(args.arch), n_layers=depth)
    return trainer.setup(args, cfg=cfg, factored=factored)


def train_steps(dev, tag: str, arch: str, lr: float, microbatches: int,
                batch_size: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                depth=None, factored: bool = False) -> dict:
    """``arch`` trained at its published width through ``launch/train.py``'s
    own setup and step (B=``batch_size`` x S=``seq``, bf16, remat; with
    ``depth``, cut to that many layers by ``cut_setup``): the seeded model
    and AdamW state on the card, the loss of the first batch through the
    plain attention (before any step; none for an attention-free arch),
    then TRAIN_STEPS steps on that one batch, the last under
    ``torch.profiler``. Returns the losses, walls, peak memory, profile and
    the count of labels the loss takes; frees the model."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm import batch_at
    from repro_torch.launch import train as trainer
    from repro_torch.training.train_step import TrainConfig, loss_fn
    args = trainer.parser().parse_args([
        "--arch", arch, "--full", "--batch", str(batch_size),
        "--seq", str(seq), "--steps", str(TRAIN_STEPS),
        "--microbatches", str(microbatches), "--lr", str(lr),
        "--device", str(dev)])
    with phase(f"{tag}: init {arch}"
               + (f" ({depth} layers)" if depth else "")
               + " and AdamW state (seeded, on the card)"):
        cfg, dcfg, model, opt, step_fn = trainer.setup(args) \
            if depth is None else cut_setup(args, depth, factored)
        batch = batch_at(dcfg, cfg, 0, device=dev)
        torch.cuda.synchronize()
    labels = batch["labels"]
    counted = {"labels_counted": int((labels >= 0).sum())}
    if cfg.family == "vlm":
        counted["vision_labels_all_ignored"] = bool(
            (labels[:, :cfg.vision_tokens] == -1).all())
    plain_loss = None
    if not cfg.is_attention_free:
        with phase(f"{tag}: step 0's loss through the plain attention"), \
                torch.no_grad(), plain_attention():
            plain_loss = float(loss_fn(model, batch, cfg, TrainConfig())[1]
                               ["loss"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from torch.profiler import ProfilerActivity, profile
    losses, gnorms, walls, prof = [], [], [], None
    for s in range(TRAIN_STEPS):
        with phase(f"{tag}: step {s}"):
            ctx = profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) \
                if s == TRAIN_STEPS - 1 else contextlib.nullcontext()
            with ctx as prof_s:
                t0 = time.perf_counter()
                _, opt, m = step_fn(model, opt, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            prof = prof_s or prof
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        print(f"{tag} step {s} loss={losses[-1]:.4f} gnorm={gnorms[-1]:.3f}"
              f" lr={float(m['lr']):.3g} wall={walls[-1]:.4f} s",
              flush=True)
    peak = torch.cuda.max_memory_allocated()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    profile_rep = {
        "traced_wall_s": walls[-1],
        "device_busy_s": busy_us / 1e6 if busy_us else None,
        "device_idle_share": 1 - busy_us / 1e6 / walls[-1] if busy_us
        else None,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in top]}
    n_params = sum(p.numel() for p in model.parameters())
    del model, opt, m, batch
    torch.cuda.empty_cache()
    return {"tag": tag, "arch": arch, "lr": lr, "microbatches": microbatches,
            "cfg": cfg, "batch": batch_size, "seq": seq,
            "reduced": {} if depth is None else {
                "n_layers": [get_config(arch).n_layers, depth]},
            "losses": losses, "gnorms": gnorms, "walls": walls,
            "plain_loss": plain_loss, "peak_bytes": peak,
            "n_params": n_params, "profile": profile_rep, **counted}


def train(dev) -> dict:
    """The train path: TinyLlama-1.1B through ``train_steps``."""
    return train_steps(dev, "train", TRAIN_ARCH, TRAIN_LR,
                       TRAIN_MICROBATCHES)


def long_train(dev, arch: str) -> dict:
    """The long_train path's run of ``arch`` through ``train_steps``, at
    LONG_TRAIN_LR and LONG_TRAIN_MICROBATCHES."""
    return train_steps(dev, f"long_train {arch}", arch, LONG_TRAIN_LR[arch],
                       LONG_TRAIN_MICROBATCHES[arch])


def modal_train(dev, tag: str) -> dict:
    """The audio_train path (whisper-small, uncut, the trainer's setup) or
    the vlm_train path (internvl2-76b cut to VLM_TRAIN_DEPTH layers,
    factored f32 AdamW) through ``train_steps``, at MODAL_TRAIN_LR."""
    if tag == "audio_train":
        return train_steps(dev, tag, AUDIO_ARCH, MODAL_TRAIN_LR[AUDIO_ARCH],
                           1, AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ)
    return train_steps(dev, tag, VLM_ARCH, MODAL_TRAIN_LR[VLM_ARCH], 1,
                       VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, depth=VLM_TRAIN_DEPTH,
                       factored=True)


def modal_train_captures(tag: str) -> dict:
    """One ``Capture`` for each of MODAL_TRAIN_LAYERS[tag]: the first
    ``flash_attention`` call with gradients of that kind."""
    from repro_torch.kernels import ops
    return {what: Capture(ops, "flash_attention",
                          lambda a, kw, t=test: a[0].requires_grad
                          and t(a, kw))
            for what, test in MODAL_TRAIN_LAYERS[tag].items()}


def attention_mask(kw: dict) -> dict:
    """The mask of a captured ``flash_attention`` call: causal, window,
    meta_tokens as its keyword arguments gave them."""
    return dict(causal=kw["causal"], window=kw.get("window", 0),
                meta_tokens=kw.get("meta_tokens", 0))


def layer_grads(cap, what: str) -> dict:
    """The attention gradients of the layer ``cap`` kept (its q, k, v and
    mask, and a seeded dO) through the kernels, against autograd through
    the materialised-scores attention: each within FLASH_BWD_BF16_TOL
    (``flash_bwd_check``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    (q, k, v), kw = cap.args
    mask = attention_mask(kw)
    gen = torch.Generator(q.device).manual_seed(0)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*got, **mask).backward(dout)
    want = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_plain(*want, **mask).backward(dout)
    out = {"layer": what, "mask": mask,
           "q": list(q.shape), "k": list(k.shape),
           "max_abs": flash_bwd_check(
               [t.grad for t in got], [t.grad for t in want],
               f"{what}: attention gradients vs plain autograd"),
           "scale": max(float(t.grad.float().abs().max()) for t in want)}
    del got, want
    torch.cuda.empty_cache()
    return out


def check_train(r: dict, layer_caps: dict, every_step: bool = False) -> dict:
    """A train run's checks: finite losses that fall on the repeated batch
    (the last below step 0's; with ``every_step``, each below the one
    before); with attention, step 0's loss within TRAIN_LOSS_ATOL of the
    forward through the plain attention, and each captured layer's
    attention gradients (``layer_caps``: {what: Capture}) through the
    kernels within FLASH_BWD_BF16_TOL of autograd through the
    materialised-scores attention, under the captured call's own mask. The
    vlm family's loss takes no label under the vision tokens, nor the
    last of a row: B (S - vision_tokens - 1) of them."""
    losses, tag, cfg = r["losses"], r["tag"], r["cfg"]
    out = {"loss_step0": losses[0], "loss_last": losses[-1],
           "labels_counted": r["labels_counted"]}
    if r["plain_loss"] is not None:
        out.update(plain_loss_step0=r["plain_loss"],
                   loss_vs_plain_abs=abs(losses[0] - r["plain_loss"]),
                   layer_grads=[layer_grads(cap, what)
                                for what, cap in layer_caps.items()])
    print(f"{tag} checks: {json.dumps(out)}", flush=True)
    falls = all(b < a for a, b in zip(losses, losses[1:])) if every_step \
        else losses[-1] < losses[0]
    if not all(np.isfinite(losses + r["gnorms"])) or not falls:
        raise AssertionError(f"{tag}: losses {losses} do not fall"
                             + (" at every step" if every_step else ""))
    if r["plain_loss"] is not None \
            and out["loss_vs_plain_abs"] > TRAIN_LOSS_ATOL:
        raise AssertionError(f"{tag}: step 0 loss {losses[0]} against "
                             f"{r['plain_loss']} through plain attention")
    if cfg.family == "vlm" and (
            not r["vision_labels_all_ignored"] or r["labels_counted"]
            != r["batch"] * (r["seq"] - cfg.vision_tokens - 1)):
        raise AssertionError(f"{tag}: the loss takes {r['labels_counted']}"
                             f" labels, some under the vision tokens")
    return out


def report_train(r: dict, checks: dict, counts: dict) -> None:
    """A train run's numbers, each on its own line, then one JSON line.
    Warm: steps 1 .. TRAIN_STEPS - 2 (step 0 pays first use, the last
    runs under the profiler). Tokens are the decoder's; an encoder's
    frames are counted apart."""
    tag, warm, cfg = r["tag"], r["walls"][1:-1], r["cfg"]
    step_s = sum(warm) / len(warm)
    tokens = r["batch"] * r["seq"]
    rep = {"arch": r["arch"], "reduced": r["reduced"],
           "layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
           "batch": r["batch"], "seq": r["seq"],
           "slots": r["seq"] + cfg.meta_tokens, "steps": TRAIN_STEPS,
           "microbatches": r["microbatches"], "lr": r["lr"],
           "params": r["n_params"], "losses": r["losses"],
           "grad_norms": r["gnorms"], "step_walls_s": r["walls"],
           "warm_step_s": step_s, "tokens_per_s": tokens / step_s,
           "peak_memory_bytes": r["peak_bytes"],
           "launches_per_step": {k: counts[k] / TRAIN_STEPS
                                 for k in ("flash_attention",
                                           "flash_attention_bwd")},
           "profile": r["profile"], **checks}
    print(f"{tag} step seconds (warm mean of steps 1-{TRAIN_STEPS - 2}): "
          f"{step_s:.4f}")
    print(f"{tag} tokens per second (warm, {tokens} tokens a step): "
          f"{tokens / step_s:.1f}")
    if cfg.enc_layers:
        frames = r["batch"] * cfg.enc_frames
        rep["frames_per_s"] = frames / step_s
        print(f"{tag} encoder frames per second (warm, {frames} frames a "
              f"step): {frames / step_s:.1f}")
    print(f"{tag} peak memory (torch.cuda.max_memory_allocated): "
          f"{r['peak_bytes'] / 2 ** 30:.2f} GiB")
    print(f"{tag} idle share (profiled step): "
          f"{r['profile']['device_idle_share']}")
    print(f"{tag} report: {json.dumps(rep)}", flush=True)


def comparison(dev, n: int = CMP_N, n_queries: int = CMP_QUERIES,
               cic_n: int = CIC_N) -> list:
    """The paper's comparison (benchmarks/qps_recall.py _curves and
    benchmarks/build_time.py, smoke sweeps): PAG, DiskANN, SPANN and HNSW
    built and searched on one clustered dataset, the CIC build, and a
    checkpoint round trip of the PAG. Prints one JSON row per method and
    setting, the PAG/DiskANN QPS ratio at recall >= RATIO_RECALL and
    Table IV's build-time claim; checks each row's recall floor and
    returns the rows."""
    import tempfile
    from repro_torch.baselines.diskann import build_diskann, search_diskann
    from repro_torch.baselines.hnsw import build_hnsw, search_hnsw
    from repro_torch.baselines.pq import adc_lut, adc_luts
    from repro_torch.baselines.spann import build_spann, search_spann
    from repro_torch.core.cic import cic_build
    from repro_torch.core.graph_search import greedy_search
    from repro_torch.core.index import load_index, save_index
    from repro_torch.core.pag import build_pag
    from repro_torch.core.search import (
        SearchConfig,
        search_pag,
        write_partitions,
    )
    from repro_torch.data.vectors import (
        brute_force_knn,
        make_dataset,
        recall_at_k,
    )
    from repro_torch.kernels import ops
    from repro_torch.storage.simulator import ObjectStore, StorageConfig
    with phase(f"compare: make_dataset n={n}"):
        ds = make_dataset("clustered", n=n, d=D, n_queries=n_queries,
                          seed=0, device=dev)
    rows, build_s = [], {}

    def row(method, setting, ids, qps, wall):
        r = {"method": method, "setting": setting,
             "recall@10": recall_at_k(ids, ds.gt_ids, K), "qps_sim": qps,
             "build_s": build_s[method], "wall_s": wall}
        rows.append(r)
        print(f"compare row: {json.dumps(r)}", flush=True)

    def pag_store():
        store = ObjectStore(StorageConfig.preset("dfs", seed=1))
        write_partitions(pag, ds.base, store, n_shards=N_SHARDS, device=dev)
        return store

    with phase(f"compare: PAG build ({hops()})"):
        t0 = time.perf_counter()
        pag = build_pag(ds.base, **CMP_PAG_ARGS, device=dev)
        build_s["PAG"] = time.perf_counter() - t0
    first_ids = None
    for L, npb in CMP_PAG_SWEEP:
        with phase(f"compare: PAG L{L}/p{npb}"):
            store = pag_store()
            t0 = time.perf_counter()
            ids, _, st = search_pag(
                pag, D, ds.queries, store,
                SearchConfig(L=L, k=K, n_probe_max=npb, mode="async"),
                n_shards=N_SHARDS, device=dev)
            row("PAG", f"L{L}/p{npb}", ids, st.batch_qps(),
                time.perf_counter() - t0)
            first_ids = ids if first_ids is None else first_ids
    with phase("compare: PAG checkpoint round trip"):
        with tempfile.TemporaryDirectory(prefix="pag_ckpt_") as tmp:
            save_index(tmp, pag)
            loaded = load_index(tmp)
        L, npb = CMP_PAG_SWEEP[0]
        ids, _, _ = search_pag(
            loaded, D, ds.queries, pag_store(),
            SearchConfig(L=L, k=K, n_probe_max=npb, mode="async"),
            n_shards=N_SHARDS, device=dev)
        if not np.array_equal(ids, first_ids):
            raise AssertionError("the loaded index serves other ids")

    with phase(f"compare: DiskANN build ({hops()})"):
        dk_store = ObjectStore(StorageConfig.preset("dfs"))
        t0 = time.perf_counter()
        dk = build_diskann(ds.base, dk_store, R=16, L=48, M=8, device=dev)
        build_s["DiskANN"] = time.perf_counter() - t0
    # the search's one batched LUT op must give each query's own LUT bit
    # for bit: one flipped low bit moves a near-tie and the traversal
    q_dev = torch.from_numpy(ds.queries).to(dev)
    if not torch.equal(adc_luts(dk.cb, q_dev), torch.stack(
            [adc_lut(dk.cb, q) for q in q_dev])):
        raise AssertionError("adc_luts differs from the per-query adc_lut")
    for L in CMP_DK_SWEEP:
        with phase(f"compare: DiskANN L{L}"):
            before = ops.launch_counts()["pq_adc_rows"]
            t0 = time.perf_counter()
            ids, _, lats = search_diskann(dk, ds.queries, dk_store, k=K, L=L)
            row("DiskANN", f"L{L}", ids, 1.0 / np.mean(lats),
                time.perf_counter() - t0)
            # one launch scores every entry point, then one launch a wave
            n = ops.launch_counts()["pq_adc_rows"] - before
            print(f"DiskANN L{L}: {n} pq_adc_rows launches (1 + {n - 1} "
                  f"waves)", flush=True)
    del dk, dk_store

    with phase(f"compare: SPANN build ({hops()})"):
        sp_store = ObjectStore(StorageConfig.preset("dfs"))
        t0 = time.perf_counter()
        sp = build_spann(ds.base, sp_store, points_per_part=16, device=dev)
        build_s["SPANN"] = time.perf_counter() - t0
        print(f"SPANN build stats {json.dumps(sp.build_stats)}")
    for L, npb in CMP_SP_SWEEP:
        with phase(f"compare: SPANN L{L}/p{npb}"):
            t0 = time.perf_counter()
            ids, _, lats = search_spann(sp, ds.queries, sp_store, k=K, L=L,
                                        n_probe_max=npb)
            row("SPANN", f"L{L}/p{npb}", ids, 1.0 / np.mean(lats),
                time.perf_counter() - t0)
    del sp, sp_store

    with phase(f"compare: HNSW build ({hops()})"):
        t0 = time.perf_counter()
        hn = build_hnsw(ds.base, R=16, L=48, device=dev)
        build_s["HNSW"] = time.perf_counter() - t0
    for L in CMP_HN_SWEEP:
        with phase(f"compare: HNSW L{L} (mem)"):
            t0 = time.perf_counter()
            ids, _, lats = search_hnsw(hn, ds.queries, k=K, L=L)
            row("HNSW", f"L{L}", ids, 1.0 / np.mean(lats),
                time.perf_counter() - t0)
    del hn

    with phase(f"compare: CIC build c=4 n={cic_n} ({hops()})"):
        stats = {}
        x = ds.base[:cic_n]
        pg = cic_build(x, c=4, stats=stats, device=dev)
        gt, _ = brute_force_knn(x, ds.queries, K, device=dev)
        A, nbrs, n_nodes, entry = pg.device_arrays(dev)
        res = greedy_search(A, nbrs, n_nodes, entry,
                            torch.from_numpy(ds.queries).to(dev), L=CIC_L,
                            K=K)
        build_s["CIC"] = stats["total_s"]
        cic = {"method": "CIC", "setting": f"c4/n{cic_n}/L{CIC_L}",
               "recall@10": recall_at_k(res.ids.cpu().numpy(), gt, K),
               "sequential_s": stats["total_s"],
               "parallel_equivalent_s": stats["parallel_total_s"],
               "stats": stats}
        rows.append(cic)
        print(f"compare row: {json.dumps(cic)}", flush=True)

    def ratio(at):
        """PAG over DiskANN: each one's best QPS at recall >= ``at``."""
        best = [max((r["qps_sim"] for r in rows if r["method"] == m
                     and r["recall@10"] >= at), default=None)
                for m in ("PAG", "DiskANN")]
        return {"at_recall": at, "pag_qps": best[0], "diskann_qps": best[1],
                "pag_over_diskann": best[0] / best[1] if all(best)
                else None}
    # ... and at the highest recall both reach (iso-recall)
    iso = min(max(r["recall@10"] for r in rows if r["method"] == m)
              for m in ("PAG", "DiskANN"))
    print(json.dumps({
        "qps_ratio": ratio(RATIO_RECALL), "qps_ratio_iso": ratio(iso),
        # Table IV's claim (build_time.py), reported, not asserted
        "pag_builds_faster_than_diskann": build_s["PAG"] < build_s["DiskANN"],
        "build_s": build_s}), flush=True)
    low = [(r["method"], r["setting"], r["recall@10"]) for r in rows
           if r["recall@10"] < CMP_FLOORS[(r["method"], r["setting"])]]
    if low:
        raise AssertionError(f"compare recall below its floor: {low}")
    return rows


def pod_sizes() -> tuple:
    """(rows of a database block, residual rows of a data rank,
    aggregation points of a model rank), sized as the reference's
    ``lower_anns_cell`` sizes them for the mesh."""
    dp, mp = POD_RANKS // POD_MODEL_AXIS, POD_MODEL_AXIS
    m_agg = max(int(POD_N * POD_P_AGG) // (mp * POD_COL_CHUNK), 1) \
        * mp * POD_COL_CHUNK
    n_res = max(POD_N // 64 // (dp * POD_ROW_CHUNK), 1) * dp * POD_ROW_CHUNK
    return POD_N // POD_RANKS, n_res // dp, m_agg // mp


def pod_block(what: str, index: int, dev) -> torch.Tensor:
    """Block ``index`` of ``what``, drawn on the card from the seed and the
    block's index, so that any process draws it again: the queries (one
    block, replicated), a rank's database block and its probed rows ([Q,
    p_loc * cap] local ids, drawn with replacement), a data rank's
    residual rows, a model rank's aggregation points."""
    n_loc, r_loc, m_loc = pod_sizes()
    g = torch.Generator(device=dev)
    g.manual_seed(1000 * POD_DATA.index(what) + index)
    if what == "rows":
        return torch.randint(0, n_loc, (POD_Q, POD_P_LOC * POD_CAP),
                             generator=g, device=dev, dtype=torch.int32)
    n = {"queries": POD_Q, "db": n_loc, "res": r_loc, "agg": m_loc}[what]
    return torch.randn((n, POD_D), generator=g, device=dev)


def ranks_wall(fn, reps: int) -> float:
    """Mean s of ``fn()`` from a start every rank shares (a barrier) to
    its result on this rank."""
    import torch.distributed as dist
    ts = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.mean(ts))


def pod_rank(rank: int, init: str, out: str, src: str) -> None:
    """One gloo rank of the pod path (``pod`` spawns it): draws its
    blocks on the card, runs the serve and the assign step once with its
    launches counted from 0, then times the steps (all ranks started
    together), the merges, and, one rank at a time, its gather and local
    scans; saves it all to ``out/pod<rank>.pt``."""
    sys.path.insert(0, src)
    import datetime

    import torch.distributed as dist
    from repro_torch.core import distributed as pd
    from repro_torch.distributed import compat
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    compat.init_ranks("gloo", init, rank, POD_RANKS,
                      timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
    try:
        mesh = pm.make_local_mesh(model_axis=POD_MODEL_AXIS)
        r, mi = pd.linear_rank(mesh), mesh.axis_index("model")
        queries = pod_block("queries", 0, dev)
        db, rows = pod_block("db", r, dev), pod_block("rows", r, dev)
        res = pod_block("res", mesh.axis_index("data"), dev)
        agg = pod_block("agg", mi, dev)
        serve = pd.make_anns_serve_step(mesh, k=POD_K)
        assign = pd.make_anns_assign_step(mesh, k=POD_ASSIGN_K,
                                          row_chunk=POD_ROW_CHUNK,
                                          col_chunk=POD_COL_CHUNK)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        got = {}
        dist.barrier()
        ops.reset_launch_counts()
        rep = {"rank": r, "coords": mesh.coords,
               "serve_first_s": ranks_wall(lambda: got.update(
                   serve=serve(queries, db, rows)), 1),
               "assign_first_s": ranks_wall(lambda: got.update(
                   assign=assign(res, agg)), 1)}
        rep["launches"] = ops.launch_counts()
        rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rep["serve_s"] = ranks_wall(lambda: serve(queries, db, rows), 5)
        rep["assign_s"] = ranks_wall(lambda: assign(res, agg), 2)
        # the local parts, one rank at a time with the card to itself
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for turn in range(POD_RANKS):
            dist.barrier()
            if turn != rank:
                continue
            rep["gather_ms"] = cuda_time_ms(lambda: pd.gather_pools(db, rows),
                                            reps=10)
            pools = pd.gather_pools(db, rows)
            rep["serve_scan_ms"] = cuda_time_ms(
                lambda: pd.serve_scan(queries, pools, rows, POD_K), reps=10)
            d2, local = pd.serve_scan(queries, pools, rows, POD_K)
            start.record()
            a_d2, a_local = pd.assign_scan(res, agg, POD_ASSIGN_K,
                                           POD_ROW_CHUNK)
            end.record()
            torch.cuda.synchronize()
            rep["assign_scan_ms"] = start.elapsed_time(end)
        # the merges alone, every rank in them: all_gathers (through the
        # shared host segment) and the stable top-k
        gids, a_gids = local + r * db.shape[0], a_local + mi * agg.shape[0]
        rep["serve_merge_ms"] = 1e3 * ranks_wall(lambda: pd.merge_topk(
            mesh, mesh.axis_names, d2, gids, POD_K), 10)
        rep["assign_merge_ms"] = 1e3 * ranks_wall(lambda: pd.merge_topk(
            mesh, ("model",), a_d2, a_gids, POD_ASSIGN_K), 10)
        torch.save({**rep, **{k: [t.cpu() for t in v]
                              for k, v in got.items()}},
                   f"{out}/pod{rank}.pt")
    finally:
        compat.shutdown()


def pod_nccl(_: int, init: str, out: str, src: str) -> None:
    """The serve and the assign step at world size 1 (a 1 x 1 mesh) under
    nccl, the backend of one card a rank, against the direct kernel calls
    on rank 0's blocks; saves the verdicts to ``out/nccl.pt``."""
    sys.path.insert(0, src)
    import datetime

    import torch.distributed as dist
    from repro_torch.core import distributed as pd
    from repro_torch.distributed import compat
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm

    dev = torch.device("cuda", 0)
    compat.init_ranks("nccl", init, 0, 1, device=dev,
                      timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
    try:
        mesh = pm.make_local_mesh()
        q, db = pod_block("queries", 0, dev), pod_block("db", 0, dev)
        rows = pod_block("rows", 0, dev)
        ids, d2 = pd.make_anns_serve_step(mesh, k=POD_K)(q, db, rows)
        want_d2, want_ids = ops.l2_topk_masked(q, pd.gather_pools(db, rows),
                                               rows, POD_K)
        w = ids.shape[1]
        rep = {"backend": dist.get_backend(mesh.groups["data"]),
               "serve_width": w,
               "serve_equal": torch.equal(ids, want_ids[:, :w])
               and torch.equal(d2, want_d2[:, :w])}
        res, agg = pod_block("res", 0, dev), pod_block("agg", 0, dev)
        ids, d2 = pd.make_anns_assign_step(
            mesh, k=POD_ASSIGN_K, row_chunk=POD_ROW_CHUNK,
            col_chunk=POD_COL_CHUNK)(res, agg)
        want_d2, want_ids = ops.l2_topk(res, agg, POD_ASSIGN_K)
        rep["assign_equal"] = torch.equal(ids, want_ids) \
            and torch.equal(d2, want_d2)
        torch.save(rep, f"{out}/nccl.pt")
    finally:
        compat.shutdown()


def pod() -> dict:
    """The pod path: POD_RANKS gloo ranks on one card (spawned: a fork
    after CUDA is set up does not work; ``file://`` rendezvous), then one
    nccl rank. A rank that raises fails the path (``join=True``
    re-raises)."""
    import tempfile

    import torch.multiprocessing as mp
    src = str(ROOT / "src")
    r = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(pod_rank, args=(f"file://{tmp}/rendezvous", tmp,
                                           src),
                           nprocs=POD_RANKS, join=True, start_method="spawn")
        r["ranks_s"] = time.perf_counter() - t0
        r["ranks"] = [torch.load(f"{tmp}/pod{i}.pt")
                      for i in range(POD_RANKS)]
        t0 = time.perf_counter()
        mp.start_processes(pod_nccl, args=(f"file://{tmp}/rendezvous_nccl",
                                           tmp, src),
                           nprocs=1, join=True, start_method="spawn")
        r["nccl_s"] = time.perf_counter() - t0
        r["nccl"] = torch.load(f"{tmp}/nccl.pt")
    return r


def check_pod(r: dict, dev) -> dict:
    """The pod path's gates: both kernels launched on every rank; the
    serve result the same on every rank bit for bit, k wide, and each of
    its ids a candidate whose plain distance is within ``norm_atol`` of
    the plain scan's at that place (over the query's candidates of all
    ranks, with global ids: exact cross-rank ties break in merge order,
    so ids may differ at near-ties, counted); the sharded assign equal,
    ids and d2 bit for bit, to one ``l2_topk`` over the whole aggregation
    set; the nccl run equal to the direct calls."""
    from repro_torch.kernels import l2_topk, ops
    ranks = r["ranks"]
    for x in ranks:
        missing = [k for k in ("l2_topk_masked", "l2_topk")
                   if x["launches"][k] == 0]
        if missing:
            raise AssertionError(f"pod rank {x['rank']}: not launched: "
                                 f"{missing}")
    ids, d2 = ranks[0]["serve"]
    for x in ranks[1:]:
        if not (torch.equal(x["serve"][0], ids)
                and torch.equal(x["serve"][1], d2)):
            raise AssertionError(f"pod serve: rank {x['rank']} differs "
                                 f"from rank 0")
    if tuple(ids.shape) != (POD_Q, POD_K):
        raise AssertionError(f"pod serve: width {tuple(ids.shape)}")
    n_loc, r_loc, _ = pod_sizes()
    queries = pod_block("queries", 0, dev)
    pools, gids = [], []
    for rank in range(POD_RANKS):
        rows = pod_block("rows", rank, dev)
        pools.append(pod_block("db", rank, dev)[rows.long()])
        gids.append(rows + rank * n_loc)
    pools, gids = torch.cat(pools, 1), torch.cat(gids, 1)
    c = pools.shape[1]
    atol = norm_atol(queries, pools.reshape(-1, POD_D))
    all_d2, all_ids = (t.cpu() for t in l2_topk.l2_topk_masked_plain(
        queries, pools, gids, c))
    del pools
    want_d2, want_ids = all_d2[:, :POD_K], all_ids[:, :POD_K]
    err = (d2 - want_d2).abs()
    # the plain distance of each id the step returned
    of_got = torch.where(all_ids[:, None, :] == ids[:, :, None],
                         all_d2[:, None, :], INF).amin(-1)
    if (err > atol).any() or ((of_got - want_d2).abs() > atol).any():
        raise AssertionError(f"pod serve: off the plain scan by "
                             f"{err.max():.3g} / "
                             f"{(of_got - want_d2).abs().max():.3g} (atol "
                             f"{atol:.3g})")
    differ = int((ids != want_ids).sum())

    dp = POD_RANKS // POD_MODEL_AXIS
    res = torch.cat([pod_block("res", i, dev) for i in range(dp)])
    agg = torch.cat([pod_block("agg", j, dev)
                     for j in range(POD_MODEL_AXIS)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ops.l2_topk(res, agg, POD_ASSIGN_K)
    torch.cuda.synchronize()
    unsharded_s = time.perf_counter() - t0
    want_d2, want_ids = (t.cpu() for t in want)
    del res, agg, want
    for x in ranks:
        lo = x["coords"][0] * r_loc
        got_ids, got_d2 = x["assign"]
        if not torch.equal(got_ids, want_ids[lo:lo + r_loc]):
            raise AssertionError(f"pod assign: rank {x['rank']}'s ids differ "
                                 f"from the unsharded l2_topk")
        if not torch.equal(got_d2, want_d2[lo:lo + r_loc]):
            raise AssertionError(f"pod assign: rank {x['rank']}'s d2 not bit "
                                 f"for bit the unsharded l2_topk's")
    nccl = r["nccl"]
    if nccl["backend"] != "nccl" or not nccl["serve_equal"] \
            or not nccl["assign_equal"]:
        raise AssertionError(f"pod nccl at world size 1: {nccl}")
    return {"serve_identical_on_ranks": True,
            "serve_max_abs_err": float(err.max()), "serve_atol": atol,
            "serve_ids_differing_at_near_ties": differ,
            "assign_equal_to_unsharded": True,
            "unsharded_assign_s": unsharded_s, "nccl": nccl}


def report_pod(r: dict, checks: dict, card: str) -> None:
    """The pod path's numbers, each on its own line, then one JSON line."""
    n_loc, r_loc, m_loc = pod_sizes()
    ranks = r["ranks"]
    keys = ("serve_first_s", "assign_first_s", "serve_s", "assign_s",
            "gather_ms", "serve_scan_ms", "assign_scan_ms", "serve_merge_ms",
            "assign_merge_ms", "peak_gib")
    rep = {"card": card, "mesh": {"data": POD_RANKS // POD_MODEL_AXIS,
                                  "model": POD_MODEL_AXIS},
           "backend": "gloo", "ranks_on_one_card": POD_RANKS,
           "serve": {"n": POD_N, "d": POD_D, "n_local": n_loc, "Q": POD_Q,
                     "rows_a_rank": POD_P_LOC * POD_CAP, "k": POD_K},
           "assign": {"n_res": r_loc * POD_RANKS // POD_MODEL_AXIS,
                      "m_agg": m_loc * POD_MODEL_AXIS, "n_local": r_loc,
                      "m_local": m_loc, "k": POD_ASSIGN_K,
                      "row_chunk": POD_ROW_CHUNK,
                      "col_chunk": POD_COL_CHUNK},
           "per_rank": [{k: x[k] for k in ("rank", "launches") + keys}
                        for x in ranks],
           "ranks_s": r["ranks_s"], "nccl_s": r["nccl_s"], **checks}
    for key, what in (("serve_s", "serve step wall s (mean of 5)"),
                      ("assign_s", "assign step wall s (mean of 2)")):
        print(f"pod {what}, all ranks started together, by rank: "
              f"{[x[key] for x in ranks]} ({card})")
    for x in ranks:
        print(f"pod rank {x['rank']} {x['coords']}: gather "
              f"{x['gather_ms']:.4f} ms, l2_topk_masked scan "
              f"{x['serve_scan_ms']:.4f} ms, l2_topk scans "
              f"{x['assign_scan_ms']:.2f} ms (alone on the card); merges "
              f"{x['serve_merge_ms']:.3f} / {x['assign_merge_ms']:.3f} ms; "
              f"peak {x['peak_gib']:.3f} GiB ({card})")
    print(f"pod unsharded assign check (one l2_topk, "
          f"{r_loc * POD_RANKS // POD_MODEL_AXIS} x "
          f"{m_loc * POD_MODEL_AXIS}): {checks['unsharded_assign_s']:.3f} s "
          f"({card})")
    print(f"pod report: {json.dumps(rep)}", flush=True)


def ep_reference(r: dict) -> dict:
    """The unsharded side of the ep path, from the moe path's DBRX-132B
    while it is on the card, kept on the host: the prompts, the cold
    generate's tokens and routes, the prefill's last-position logits (with
    the input of the first MoE layer), each decode step's logits with the
    cold tokens fed (the cold generate's own steps again), and the first
    MoE layer in f32 on that input."""
    from repro_torch.models import forward, moe
    cfg, model, prompt = r["cfg"], r["model"], r["prompt"]
    out = {"prompt": prompt.cpu(), "gen": r["cold_gen"],
           "routes": r["cold_routes"]}
    saved, first = moe.moe_forward, []

    def keep_input(params, x, cfg_, *shared):
        if not first:
            first.append(x)
        return saved(params, x, cfg_, *shared)
    with torch.inference_mode():
        moe.moe_forward = keep_input
        try:
            out["logits"] = forward(model, {"tokens": prompt}, cfg)[:, -1]\
                .cpu()
        finally:
            moe.moe_forward = saved
        out["x0"] = first[0].cpu()
        out["forced"] = forced_decode(model, cfg, prompt,
                                      torch.from_numpy(r["cold_gen"]))[1:]
        params = {k: v.float() for k, v in
                  model.blocks[0].moe.named_parameters()}
        out["layer_f32"] = moe.moe_forward(params, first[0].float(), cfg)\
            .cpu()
        del params, first
    torch.cuda.empty_cache()
    return out


def forced_decode(model, cfg, prompt, gen) -> torch.Tensor:
    """Generation with the tokens ``gen`` [B, MOE_NEW] fed instead of the
    model's own, as ``Engine.generate`` feeds them: the prefill, then
    MOE_NEW - 1 decode steps. Returns the last-position logits of each,
    [MOE_NEW, B, V] on the host."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.model import gather_vocab
    gen = gen.to(prompt.device).long()
    logits, cache = prefill(model, {"tokens": prompt}, cfg,
                            max_len=MOE_PROMPT + MOE_NEW)
    out = [gather_vocab(model, logits[:, -1]).cpu()]
    for i in range(MOE_NEW - 1):
        logits, cache = decode_step(model, gen[:, i:i + 1], cache,
                                    MOE_PROMPT + i, cfg)
        out.append(gather_vocab(model, logits[:, -1]).cpu())
    return torch.stack(out)


def ep_rank(rank: int, init: str, tmp: str, src: str) -> None:
    """One gloo rank of the ep path (``ep`` spawns it): on the (data 1,
    model 4) mesh, ``Engine.generate`` cold and warm (peak
    memory), then the prefill and decode steps again with the unsharded
    cold run's tokens fed (``forced_decode``; routes recorded), the first
    MoE layer in f32 on the unsharded side's input, the parts timed, under
    ``mesh_context`` given the whole batch's size. Launches are counted
    from 0 over the generates and the prefill. Saves it all to
    ``tmp/ep<rank>.pt``."""
    sys.path.insert(0, src)
    import datetime

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm
    from repro_torch.models import init_params, moe
    from repro_torch.serving.engine import Engine, ServeConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    compat.init_ranks("gloo", init, rank, EP_RANKS,
                      timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
    try:
        arch, depth = MOE_ARCHS[0]
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        ref = torch.load(f"{tmp}/ep_in.pt")
        rep = {"rank": rank}
        launches = {}

        def serving_part(fn):
            """``fn()`` with its launches added to the path's count."""
            ops.reset_launch_counts()
            try:
                return fn()
            finally:
                for k, c in ops.launch_counts().items():
                    launches[k] = launches.get(k, 0) + c

        mesh = pm.make_mesh(*EP_MESH)
        dcfg = shd.DistConfig()
        with mesh_context(mesh, dcfg):
            t0 = time.perf_counter()
            model = init_params(cfg, seed=0, device=dev)
            torch.cuda.synchronize()
            rep["A_init_s"] = time.perf_counter() - t0
        with mesh_context(mesh, dcfg, batch=MOE_BATCH), \
                torch.inference_mode():
            spec = shd.batch_spec(MOE_BATCH, mesh)
            prompt = shd.local_block(ref["prompt"].to(dev), spec, mesh)
            engine = Engine(cfg, model, ServeConfig(max_new_tokens=MOE_NEW))
            dist.barrier()
            rep["A_gen"] = torch.from_numpy(serving_part(
                lambda: engine.generate({"tokens": prompt})))
            rep["A_cold"] = dict(engine.timing)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            rep["A_gen_warm"] = torch.from_numpy(serving_part(
                lambda: engine.generate({"tokens": prompt})))
            rep["A_warm"] = dict(engine.timing)
            rep["A_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            fed = shd.local_block(ref["gen"].to(dev), spec, mesh)
            with RouteRecorder(cfg) as rec:
                rep["A_forced"] = serving_part(
                    lambda: forced_decode(model, cfg, prompt, fed))
            rep["A_routes"] = rec.host_calls()
            del rec, engine
            layer = dict(model.blocks[0].moe.named_parameters())
            x0 = ref["x0"].to(dev)
            p32 = {k: v.float() for k, v in layer.items()}
            rep["A_layer_f32"] = moe.moe_sharded(p32, x0.float(), cfg, mesh,
                                                 dcfg).cpu()
            del p32
            # the parts of the first MoE layer: this rank's dispatch and
            # expert products alone on the card, at the prefill's and a
            # decode step's token counts; the partial sum with every rank
            # in it
            xf = x0.reshape(-1, cfg.d_model)
            gate_w, gate_e = moe.route(xf, layer["router"], cfg.moe_top_k)
            e_local = cfg.n_experts // mesh.shape["model"]
            off = mesh.axis_index("model") * e_local
            experts = moe.gather_experts(layer, cfg, mesh, dcfg)
            for turn in range(EP_RANKS):
                dist.barrier()
                if turn != rank:
                    continue
                for what, n in (("prefill", xf.shape[0]),
                                ("decode", MOE_BATCH)):
                    cap = moe.capacity(cfg, n)
                    rep[f"A_dispatch_{what}_ms"] = cuda_time_ms(
                        lambda: moe.dispatch_compute(
                            xf[:n], gate_w[:n], gate_e[:n], *experts,
                            n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                            cap=cap, expert_offset=off), reps=5)
                    buf = torch.randn(e_local, cap, cfg.d_model, device=dev,
                                      dtype=xf.dtype)

                    def products():
                        h = torch.bmm(buf, experts[0])
                        h = torch.nn.functional.silu(h.float()).to(
                            buf.dtype) * torch.bmm(buf, experts[1])
                        return torch.bmm(h, experts[2])
                    rep[f"A_products_{what}_ms"] = cuda_time_ms(products,
                                                                reps=5)
                    rep[f"A_capacity_{what}"] = cap
            for what, n, reps in (("prefill", xf.shape[0], 5),
                                  ("decode", MOE_BATCH, 20)):
                part = xf[:n].clone()
                rep[f"A_partial_sum_{what}_ms"] = 1e3 * ranks_wall(
                    lambda: moe.sum_over_model(mesh, part), reps)
            del model, layer, experts, xf, x0, gate_w, gate_e
        torch.cuda.empty_cache()

        rep["launches"] = launches
        torch.save(rep, f"{tmp}/ep{rank}.pt")
    finally:
        compat.shutdown()


def ep(ref: dict) -> dict:
    """The ep path: EP_RANKS gloo ranks on one card (spawned, ``file://``
    rendezvous) given the unsharded side's prompts and first MoE layer
    input (``ep_reference``). A rank that raises fails the path."""
    import tempfile

    import torch.multiprocessing as mp
    src = str(ROOT / "src")
    r = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"prompt": ref["prompt"], "x0": ref["x0"],
                    "gen": torch.from_numpy(ref["gen"])}, f"{tmp}/ep_in.pt")
        t0 = time.perf_counter()
        mp.start_processes(ep_rank, args=(f"file://{tmp}/rendezvous", tmp,
                                          src),
                           nprocs=EP_RANKS, join=True, start_method="spawn")
        r["ranks_s"] = time.perf_counter() - t0
        r["ranks"] = [torch.load(f"{tmp}/ep{i}.pt") for i in range(EP_RANKS)]
    return r


def dp_setup(tag: str, dev, *, ranks: bool):
    """``launch/train.py``'s setup of dp_train's phase ``tag``
    (DP_PHASES): the published config cut in depth, the trainer's
    parser's arguments; on a process group (``ranks``) its mesh of
    ``--model-axis``, else one process on the whole batch."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as trainer
    ph = DP_PHASES[tag]
    args = trainer.parser().parse_args([
        "--arch", ph["arch"], "--full", "--batch", str(ph["batch"]),
        "--seq", str(ph["seq"]), "--steps", str(ph["steps"]),
        "--lr", str(TRAIN_LR), "--device", str(dev),
        "--model-axis", str(ph["model_axis"] if ranks else 1)])
    cfg = dataclasses.replace(get_config(ph["arch"]), n_layers=ph["depth"],
                              **ph["changes"])
    return trainer.setup(args, cfg=cfg, factored=ph["factored"])


def fingerprint(t: torch.Tensor) -> torch.Tensor:
    """Two sums a row of FINGERPRINT_ROW elements of ``t``'s bits (as
    integers: their sum and their sum of squares), int64 [2, rows] on the
    host: equal for equal bits, and for unequal ones unless two changes
    in a row cancel in both."""
    ints = {2: torch.int16, 4: torch.int32}[t.element_size()]
    flat = t.detach().reshape(-1).view(ints)
    out = []
    step = FINGERPRINT_ROW * 4096
    for s in range(0, flat.numel(), step):
        part = flat[s:s + step].long()
        part = torch.nn.functional.pad(part, (0, -part.numel()
                                              % FINGERPRINT_ROW))
        part = part.view(-1, FINGERPRINT_ROW)
        out.append(torch.stack([part.sum(1), (part * part).sum(1)]).cpu())
    return torch.cat(out, 1)


def dp_reference(dev) -> dict:
    """The one-process side of the dp_train path (and of the tp path's
    T3), on the whole batch: each phase's step 0 loss and T2's grad norm
    and routes; before T2's step, its MoE layer in f32 (a forward with no
    gradient for its input), with seeded cotangents, on the first row of
    its layer-0 input (T2's ranks' check) and on the second (with the
    first, T3's): the input's, the router's and experts 0 and E/2's
    gradients (each model rank's first expert). Everything kept on the
    host, the models freed."""
    from repro_torch.data.lm import batch_at
    out = {}
    for tag in DP_RANK_PHASES:
        cfg, dcfg, model, opt, step_fn = dp_setup(tag, dev, ranks=False)
        batch = batch_at(dcfg, cfg, 0, device=dev)
        if cfg.n_experts:
            out[f"{tag}_layer"] = f32_layer_grads(model, batch, cfg, dev)
        with RouteRecorder(cfg) as rec:
            _, opt, m = step_fn(model, opt, batch)
        out[f"{tag}_loss"] = float(m["loss"])
        out[f"{tag}_gnorm"] = float(m["grad_norm"])
        out[f"{tag}_routes"] = rec.host_calls()[:cfg.n_layers]
        del model, opt, m, rec, batch
        torch.cuda.empty_cache()
    return out


def f32_layer_grads(model, batch, cfg, dev) -> list:
    """The first MoE layer of ``model`` in f32, unsharded, back-propagating
    a seeded cotangent, on each of the first T3_ROWS rows of its input in
    ``model``'s forward of ``batch`` alone: for each row, the input, its
    cotangent and gradient, the router's gradient and, for each model
    rank r of T2's and T3's meshes, its first expert's three (expert r E /
    mp), on the host. T2's ranks take row 0's; T3's both."""
    from repro_torch.models import forward, moe
    saved, first = moe.moe_forward, []

    def keep_input(params, x, cfg_, *shared):
        if not first:
            first.append(x[:T3_ROWS].float())
        return saved(params, x, cfg_, *shared)
    moe.moe_forward = keep_input
    try:
        with torch.no_grad():
            forward(model, batch, cfg)
    finally:
        moe.moe_forward = saved
    names = ("router",) + moe.EXPERT_WEIGHTS
    mp = DP_PHASES["T2"]["model_axis"]
    e_local = cfg.n_experts // mp
    out = []
    for row in range(T3_ROWS):
        x = first[0][row:row + 1].clone().requires_grad_()
        gen = torch.Generator(dev).manual_seed(2 + row)
        cot = torch.randn(x.shape, generator=gen, device=dev)
        params = {k: v.detach().float().requires_grad_()
                  for k, v in model.blocks[0].moe.named_parameters()}
        grads = torch.autograd.grad(
            (moe.moe_forward(params, x, cfg).float() * cot).sum(),
            [x] + [params[k] for k in names])
        out.append({"x": x.detach().cpu(), "cot": cot.cpu(),
                    "x_grad": grads[0].cpu(), "router_grad": grads[1].cpu(),
                    "experts": {r * e_local: [g[r * e_local].cpu()
                                              for g in grads[2:]]
                                for r in range(mp)}})
        del params, grads, x
        torch.cuda.empty_cache()
    return out


def t3_side(dp_ref: dict) -> tuple:
    """T3's one-process side from ``dp_reference``'s T2: (its step 0 loss,
    grad norm and routes; ``t3_layer_inputs`` for each model index)."""
    mp = DP_PHASES["T3"]["model_axis"]
    e_local = t3_config().n_experts // mp
    return ({k: dp_ref[k] for k in ("T2_loss", "T2_gnorm", "T2_routes")},
            [t3_layer_inputs(dp_ref["T2_layer"], m, e_local)
             for m in range(mp)])


def t3_layer_inputs(rows: list, m: int, e_local: int) -> dict:
    """What a T3 rank of model index ``m`` is held to (``f32_layer_grads``'
    rows): each row's input, cotangent and input gradient (a data rank
    takes its own), the router's gradients and its first expert's (expert
    ``m e_local``) of the rows added in row order, as the sums over data
    add them (each rank cuts its own d block)."""
    e = m * e_local
    router = rows[0]["router_grad"].clone()
    expert = [g.clone() for g in rows[0]["experts"][e]]
    for r in rows[1:]:
        router += r["router_grad"]
        for acc, g in zip(expert, r["experts"][e]):
            acc += g
    return {"x": [r["x"] for r in rows], "cot": [r["cot"] for r in rows],
            "x_grad": [r["x_grad"] for r in rows], "router_grad": router,
            "expert_id": e, "expert": expert}


def dp_rank(rank: int, init: str, tmp: str, src: str) -> None:
    """One gloo rank of the dp_train path (``dp_train`` spawns it): T1 then
    T2 (DP_PHASES), each through ``dp_setup`` on the process group and
    its steps on ``batch_at``'s batch 0, a barrier before each step, the
    launches counted from 0 around the steps, the parameters'
    fingerprints after each, layer 0's first attention call with
    gradients kept (its kernel rows); T1's data all-reduce of gradients
    shaped as its parameters, timed alone; T2's f32 layer on the
    one-process side's input (before its steps), its routes at step 0,
    and its model-axis sums forward (the partial outputs) and backward
    (the copy's gradient), timed alone at the step's [B S, d]. Saves it
    all to ``tmp/dp<rank>.pt``. Waits for ``tmp/go`` (``dp_train``) before
    it touches the card."""
    sys.path.insert(0, src)
    import datetime

    import torch._dynamo  # noqa: F401  (see DP_WAIT_S)
    import torch.distributed as dist
    from repro_torch.core.distributed import copy_over, psum
    from repro_torch.data.lm import batch_at
    from repro_torch.distributed import compat
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm
    from repro_torch.models import moe

    deadline = time.monotonic() + DP_WAIT_S
    while not Path(tmp, "go").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"dp_train rank {rank}: no go in {DP_WAIT_S} s")
        time.sleep(0.05)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    compat.init_ranks("gloo", init, rank, DP_RANKS,
                      timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
    try:
        rep = {"rank": rank}
        for tag in DP_RANK_PHASES:
            ph = DP_PHASES[tag]
            t0 = time.perf_counter()
            cfg, dcfg, model, opt, step_fn = dp_setup(tag, dev, ranks=True)
            torch.cuda.synchronize()
            rep[f"{tag}_setup_s"] = time.perf_counter() - t0
            mesh = pm.make_local_mesh(ph["model_axis"])
            rep[f"{tag}_coords"] = mesh.coords
            blocks = moe.block_specs(model)
            if tag == "T2":
                ref = torch.load(f"{tmp}/dp_layer{mesh.coords[-1]}.pt")
                layer = model.blocks[0].moe
                p32 = {k: v.detach().float().requires_grad_()
                       for k, v in layer.named_parameters()}
                x = ref["x"].to(dev).requires_grad_()
                names = ("router",) + moe.EXPERT_WEIGHTS
                with mesh_context(mesh, batch=x.shape[0]):
                    grads = torch.autograd.grad(
                        (moe.moe_sharded(p32, x, cfg, mesh).float()
                         * ref["cot"].to(dev)).sum(),
                        [x] + [p32[k] for k in names])
                got = {"x_grad": grads[0], "router_grad": grads[1],
                       **{f"expert_{n}": g[0] for n, g in
                          zip(moe.EXPERT_WEIGHTS, grads[2:])}}
                want = {"x_grad": ref["x_grad"],
                        "router_grad": ref["router_grad"],
                        **{f"expert_{n}": g for n, g in
                           zip(moe.EXPERT_WEIGHTS, ref["expert"])}}
                rep["T2_layer"] = {
                    k: {"max_abs": float((got[k].cpu() - w).abs().max()),
                        "bound": DP_LAYER_RTOL * float(w.abs().max())}
                    for k, w in want.items()}
                rep["T2_layer"]["expert"] = ref["expert_id"]
                del ref, p32, x, grads, got, want
                torch.cuda.empty_cache()
            batch = batch_at(dcfg, cfg, 0, device=dev)
            cap = Capture(ops, "flash_attention",
                          lambda a, kw: a[0].requires_grad)
            losses, aux, gnorms, walls, prints = [], [], [], [], []
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            with cap:
                for s in range(ph["steps"]):
                    rec = RouteRecorder(cfg) if s == 0 and cfg.n_experts \
                        else contextlib.nullcontext()
                    dist.barrier()
                    t0 = time.perf_counter()
                    with rec:
                        _, opt, m = step_fn(model, opt, batch)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    if s == 0 and cfg.n_experts:
                        rep["T2_routes"] = rec.host_calls()[:cfg.n_layers]
                    losses.append(float(m["loss"]))
                    aux.append(float(m["aux_loss"]))
                    gnorms.append(float(m["grad_norm"]))
                    prints.append({n: fingerprint(p) for n, p in
                                   model.named_parameters()
                                   if n not in blocks})
            rep[f"{tag}_launches"] = ops.launch_counts()
            rep[f"{tag}_peak_gib"] = torch.cuda.max_memory_allocated() \
                / 2 ** 30
            rep.update({f"{tag}_losses": losses, f"{tag}_aux": aux,
                        f"{tag}_gnorms": gnorms, f"{tag}_walls": walls,
                        f"{tag}_prints": prints,
                        f"{tag}_blocks": sorted(blocks),
                        f"{tag}_n_params": sum(p.numel() for p in
                                               model.parameters())})
            (q, k, v), kw = cap.args
            rep[f"{tag}_call"] = ((q.cpu(), k.cpu(), v.cpu()), kw)
            del batch, cap, m
            params = [p.detach() for p in model.parameters()]
            if tag == "T1":
                rep["T1_allreduce_s"] = ranks_wall(
                    lambda: [psum(mesh, ("data",), g) for g in params], 1)
                rep["T1_allreduce_bytes"] = sum(
                    g.numel() * g.element_size() for g in params)
            else:
                part = torch.randn(ph["batch"] * ph["seq"], cfg.d_model,
                                   device=dev).to(params[0].dtype)
                leaf = part.clone().requires_grad_()
                rep["T2_model_sum_fwd_ms"] = 1e3 * ranks_wall(
                    lambda: moe.sum_over_model(mesh, part), 5)
                rep["T2_model_sum_bwd_ms"] = 1e3 * ranks_wall(
                    lambda: torch.autograd.grad(
                        copy_over(mesh, ("model",), leaf), leaf, part), 5)
                rep["T2_model_sum_bytes"] = part.numel() \
                    * part.element_size()
                del part, leaf
            del model, opt, params, step_fn
            torch.cuda.empty_cache()
        torch.save(rep, f"{tmp}/dp{rank}.pt")
    finally:
        compat.shutdown()


def spawn_ranks(fn, n: int) -> dict:
    """Start ``n`` gloo ranks running ``fn(rank, init, tmp, src)``
    (spawned, daemonic, ``file://`` rendezvous in a fresh directory
    ``tmp``, removed at exit); each imports what its steps need and waits
    for its path's go file (``join_ranks``). Returns the handle."""
    import atexit
    import shutil
    import tempfile

    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, tmp, True)
    ctx = mp.start_processes(fn, args=(f"file://{tmp}/rendezvous", tmp,
                                       str(ROOT / "src")),
                             nprocs=n, join=False, daemon=True,
                             start_method="spawn")
    return {"ctx": ctx, "tmp": tmp, "t0": time.perf_counter(), "n": n}


def join_ranks(spawned: dict, go: str, out: str) -> dict:
    """Touch the ranks' go file ``go`` and join them (a rank that raises
    fails the path): the seconds they ran, how long they had waited
    since ``spawn_ranks``, and each rank's ``<out><rank>.pt``."""
    import gc
    tmp = spawned["tmp"]
    # the card is the ranks': this process keeps only what it holds
    gc.collect()
    torch.cuda.empty_cache()
    held = {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "card_used_mib": int(subprocess.run(
                ["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.strip())}
    print(f"[ranks] {go}: before the go this process holds "
          f"{held['allocated']} bytes ({held['reserved']} reserved), the "
          f"card {held['card_used_mib']} MiB in use", flush=True)
    t0 = time.perf_counter()
    Path(tmp, go).touch()
    while not spawned["ctx"].join():
        pass
    return {"ranks_s": time.perf_counter() - t0,
            "waited_s": t0 - spawned["t0"], "held_before_go": held,
            "ranks": [torch.load(f"{tmp}/{out}{i}.pt")
                      for i in range(spawned["n"])]}


def dp_train(ref: dict, spawned: dict) -> dict:
    """The dp_train path: the ranks ``spawn_ranks`` started, given the
    one-process side's T2 layer input (``dp_reference``: its first row)
    and then the go; joined. A rank that raises fails the path."""
    row = ref["T2_layer"][0]
    for i, (e, expert) in enumerate(sorted(row["experts"].items())):
        torch.save({**{k: row[k] for k in ("x", "cot", "x_grad",
                                           "router_grad")},
                    "expert_id": e, "expert": expert},
                   f"{spawned['tmp']}/dp_layer{i}.pt")
    return join_ranks(spawned, "go", "dp")


def check_dp_train(r: dict, ref: dict) -> dict:
    """The dp_train path's gates (see the module docstring)."""
    ranks = r["ranks"]
    out, bad = {}, []
    for tag in DP_RANK_PHASES:
        ph = DP_PHASES[tag]
        losses = [x[f"{tag}_losses"] for x in ranks]
        same = all(all(torch.equal(a[n], b[n]) for n in a)
                   for x in ranks[1:]
                   for a, b in zip(x[f"{tag}_prints"],
                                   ranks[0][f"{tag}_prints"]))
        want = {"flash_attention": 2 * ph["depth"] * ph["steps"],
                "flash_attention_bwd": ph["depth"] * ph["steps"]}
        o = out[tag] = {
            "losses": losses[0], "loss_step0_one_process": ref[f"{tag}_loss"],
            "loss_vs_one_process_abs": abs(losses[0][0] - ref[f"{tag}_loss"]),
            "losses_equal_on_ranks": all(x == losses[0] for x in losses),
            "whole_params_identical_on_ranks": same,
            "whole_params_compared": len(ranks[0][f"{tag}_prints"][0]),
            "launches_a_rank": [{k: x[f"{tag}_launches"][k] for k in want}
                                for x in ranks], "launches_want": want}
        if not (o["losses_equal_on_ranks"] and same):
            bad.append(f"{tag}: ranks differ")
        if not np.isfinite(losses[0] + ranks[0][f"{tag}_gnorms"]).all() \
                or losses[0][-1] >= losses[0][0]:
            bad.append(f"{tag}: losses {losses[0]} do not fall")
        if o["loss_vs_one_process_abs"] > TRAIN_LOSS_ATOL:
            bad.append(f"{tag}: step 0 loss off the one-process step's")
        if any(x[f"{tag}_launches"][k] != n for x in ranks
               for k, n in want.items()):
            bad.append(f"{tag}: launches {o['launches_a_rank']}")
    cfg_e = DP_PHASES["T2"]
    from repro_torch.configs import get_config
    n_experts = get_config(cfg_e["arch"]).n_experts
    routes, _ = route_rule(ranks[0]["T2_routes"], ref["T2_routes"],
                           n_experts)
    out["T2"]["routes"] = {k: v for k, v in routes.items()
                           if k != "by_layer"}
    if routes["agreement"] < ROUTE_AGREEMENT[cfg_e["arch"]] \
            or routes["violations"]:
        bad.append("T2: routes break the route rule")
    out["T2"]["layer_f32"] = [x["T2_layer"] for x in ranks]
    for x in ranks:
        for k, e in x["T2_layer"].items():
            if k != "expert" and e["max_abs"] > e["bound"]:
                bad.append(f"T2: rank {x['rank']} f32 layer {k}")
    print(f"dp_train checks: {json.dumps(out)}", flush=True)
    if bad:
        raise AssertionError(f"dp_train: {bad}")
    return out


def report_dp_train(r: dict, checks: dict, card: str) -> None:
    """The dp_train path's numbers, each on its own line, then one JSON
    line: per rank and phase the step walls (T1: the warm step 0, then
    the timed ones), peaks, T1's gradient all-reduce and T2's model-axis
    sums, timed alone."""
    per_rank = []
    for x in r["ranks"]:
        row = {"rank": x["rank"]}
        for tag in DP_RANK_PHASES:
            ph = DP_PHASES[tag]
            walls = x[f"{tag}_walls"]
            timed = walls[1:] if tag == "T1" else walls
            row[tag] = {"coords": x[f"{tag}_coords"],
                        "setup_s": x[f"{tag}_setup_s"],
                        "step_walls_s": walls,
                        "mean_step_s": float(np.mean(timed)),
                        "tokens_per_s_all_ranks": ph["batch"] * ph["seq"]
                        / float(np.mean(timed)),
                        "aux_losses": x[f"{tag}_aux"],
                        "grad_norms": x[f"{tag}_gnorms"],
                        "peak_gib": x[f"{tag}_peak_gib"],
                        "params_a_rank": x[f"{tag}_n_params"],
                        "blocks": x[f"{tag}_blocks"]}
        row["T1"]["grad_allreduce_s"] = x["T1_allreduce_s"]
        row["T1"]["grad_allreduce_bytes"] = x["T1_allreduce_bytes"]
        row["T2"]["model_sum_fwd_ms"] = x["T2_model_sum_fwd_ms"]
        row["T2"]["model_sum_bwd_ms"] = x["T2_model_sum_bwd_ms"]
        row["T2"]["model_sum_bytes"] = x["T2_model_sum_bytes"]
        per_rank.append(row)
        print(f"dp_train rank {x['rank']}: T1 step "
              f"{row['T1']['mean_step_s']:.4f} s (timed mean), gradient "
              f"all-reduce {x['T1_allreduce_s']:.4f} s "
              f"({x['T1_allreduce_bytes'] / 2 ** 20:.0f} MiB), peak "
              f"{x['T1_peak_gib']:.2f} GiB; T2 step "
              f"{row['T2']['mean_step_s']:.4f} s, model sums fwd "
              f"{x['T2_model_sum_fwd_ms']:.3f} / bwd "
              f"{x['T2_model_sum_bwd_ms']:.3f} ms, peak "
              f"{x['T2_peak_gib']:.2f} GiB ({card})")
    rep = {"card": card, "backend": "gloo", "ranks_on_one_card": DP_RANKS,
           "phases": {tag: {**ph, "reduced": {"n_layers": [
               {"tinyllama-1.1b": 22, "dbrx-132b": 40}[ph["arch"]],
               ph["depth"]]}} for tag, ph in DP_PHASES.items()
               if tag in DP_RANK_PHASES},
           "lr": TRAIN_LR, "per_rank": per_rank, "ranks_s": r["ranks_s"],
           "ranks_started_s_before": r["waited_s"],
           **checks}
    print(f"dp_train report: {json.dumps(rep)}", flush=True)


class CollectiveTimer:
    """Times every collective of the port (``core/distributed.py``'s
    ``_gather``, ``_sum_axis`` and ``_reduce_scatter``, through which the
    census counts them all) on the host's clock, the card synchronised
    before and after each, by kind: seconds, calls and the bytes a rank
    receives by the census's count (n x the tensor's for a gather and a
    reduce-scatter; an all-reduce's own bytes on two ranks, else n x)."""
    KINDS = {"_gather": "all-gather", "_sum_axis": "all-reduce",
             "_reduce_scatter": "reduce-scatter"}

    def __enter__(self):
        from repro_torch.core import distributed as pd
        self.pd, self.saved = pd, {}
        self.seconds = {k: 0.0 for k in self.KINDS.values()}
        self.calls = {k: 0 for k in self.KINDS.values()}
        self.bytes = {k: 0 for k in self.KINDS.values()}
        for name, kind in self.KINDS.items():
            fn = self.saved[name] = getattr(pd, name)

            def timed(mesh, axis, t, *a, _fn=fn, _kind=kind, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(mesh, axis, t, *a, **kw)
                torch.cuda.synchronize()
                self.seconds[_kind] += time.perf_counter() - t0
                self.calls[_kind] += 1
                n = mesh.shape[axis]
                self.bytes[_kind] += t.numel() * t.element_size() * (
                    1 if _kind == "all-reduce" and n == 2 else n)
                return out
            setattr(pd, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.pd, name, fn)

    def record(self) -> dict:
        return {"seconds": dict(self.seconds), "calls": dict(self.calls),
                "bytes": dict(self.bytes),
                "total_s": sum(self.seconds.values())}


def tp_configs():
    """(TinyLlama-1.1B bf16, f32, f32 cut to TP_B_DEPTH layers)."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    return cfg, cfg32, dataclasses.replace(cfg32, n_layers=TP_B_DEPTH)


def tp_train_setup(cfg, dev):
    """The phase B step's optimizer config and batch (batch_at's batch 0
    of TP_BATCH x TP_PROMPT)."""
    from repro_torch.data.lm import DataConfig, batch_at
    from repro_torch.training.optimizer import OptimizerConfig
    ocfg = OptimizerConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    dcfg = DataConfig(seed=TP_SEED, batch_size=TP_BATCH, seq_len=TP_PROMPT)
    return ocfg, batch_at(dcfg, cfg, 0, device=dev)


def tp_reference(dev) -> dict:
    """The unsharded side of the tp path, on the host: the seeded prompts;
    phase A's f32 generate's tokens and, those fed, its logits; its bf16
    generate's tokens; phase B's model (TP_B_DEPTH layers, f32): a batch
    of one's generate, then one step's loss, grad norm and updated
    parameters. The models freed."""
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_step import TrainConfig, make_train_step
    cfg, cfg32, cfg_b = tp_configs()
    g = torch.Generator(dev).manual_seed(TP_SEED)
    prompt = torch.randint(0, cfg.vocab_size, (TP_BATCH, TP_PROMPT),
                           generator=g, device=dev)
    out = {"prompt": prompt.cpu()}
    with torch.inference_mode():
        for tag, c in (("f32", cfg32), ("bf16", cfg)):
            model = init_params(c, TP_SEED, dev)
            gen = Engine(c, model, ServeConfig(max_new_tokens=TP_NEW))\
                .generate({"tokens": prompt})
            out[f"{tag}_gen"] = torch.from_numpy(gen)
            if tag == "f32":
                out["f32_logits"], _, _ = forced_run(
                    model, c, {"tokens": prompt}, out["f32_gen"], TP_NEW)
            del model
            torch.cuda.empty_cache()
    model = init_params(cfg_b, TP_SEED, dev)
    with torch.inference_mode():
        out["b_gen"] = torch.from_numpy(Engine(
            cfg_b, model, ServeConfig(max_new_tokens=TP_B_NEW)).generate(
                {"tokens": prompt[:1]}))
    model.requires_grad_()
    ocfg, batch = tp_train_setup(cfg_b, dev)
    state = init_state(dict(model.named_parameters()), ocfg)
    _, state, m = make_train_step(cfg_b, ocfg, TrainConfig())(model, state,
                                                             batch)
    out["b_loss"], out["b_gnorm"] = float(m["loss"]), float(m["grad_norm"])
    out["b_params"] = {n: p.detach().cpu() for n, p in
                       model.named_parameters()}
    del model, state, batch, m
    torch.cuda.empty_cache()
    return out


def tp_census_bytes(cfg, mesh_shape, dist=None) -> int:
    """A rank's parameter bytes under the reference's specs on the mesh
    ``mesh_shape`` ((sizes), (names)) and ``dist`` (a ``DistConfig``;
    None: the default): the census's ``tree_bytes``."""
    from repro_torch.distributed.sharding import MeshShape, param_specs
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as S
    mesh = MeshShape(mesh_shape[1], mesh_shape[0])
    model = S.abstract_params(cfg)
    return dryrun.tree_bytes(dict(model.named_parameters()),
                             param_specs(model, mesh, dist), mesh)


def tp_placed(rep: dict, tag: str, c, mesh, shape, dev, dist_cfg=None,
              seed: int = TP_SEED):
    """The model ``c`` seeded with ``seed`` placed on ``mesh`` (its
    ``shape``) under ``dist_cfg``: its init seconds, its bytes against the
    census's (``placed_bytes_check``) and its blocks into ``rep`` under
    ``tag``."""
    from repro_torch.distributed.context import mesh_context
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import block_specs
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with mesh_context(mesh, dist_cfg):
        model = init_params(c, seed, dev)
    torch.cuda.synchronize()
    rep[f"{tag}_init_s"] = time.perf_counter() - t0
    rep[f"{tag}_bytes"] = placed_bytes_check(
        f"tp {tag} parameters", list(model.parameters()),
        torch.cuda.memory_allocated() - before,
        tp_census_bytes(c, shape, dist_cfg))
    rep[f"{tag}_blocks"] = len(block_specs(model))
    return model


def tp_serve(rep: dict, tag: str, mesh, shape, ref: dict, dev, part,
             dist_cfg=None) -> None:
    """Phase A's runs (``tp_rank``; M1 of ``tphd_rank``) on ``mesh`` (its
    ``shape``) under ``dist_cfg``, every layer of TinyLlama-1.1B: the f32
    model placed, ``forced_run`` with the unsharded run's tokens, its
    decode cache's layout; then the bf16 model's ``Engine.generate`` under
    ``CollectiveTimer``, layer 0's attention call kept. Into ``rep`` under
    ``tag``_...; launches through ``part``."""
    import torch.distributed as dist
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_cache
    from repro_torch.serving.engine import Engine, ServeConfig
    cfg, cfg32, _ = tp_configs()
    prompt = ref["prompt"].to(dev)
    model = tp_placed(rep, f"{tag}_f32", cfg32, mesh, shape, dev, dist_cfg)
    attn = model.blocks[0].attn
    rep[f"{tag}_heads"] = (attn.wq.shape[1], attn.wk.shape[1],
                           model.blocks[0].mlp.w_gate.shape[1],
                           model.tok_embed.shape[0])
    rep[f"{tag}_widths"] = {n: list(getattr(attn, n).shape)
                            for n in ("wq", "wk", "wv", "wo")}
    with mesh_context(mesh, dist_cfg, batch=TP_BATCH), \
            torch.inference_mode():
        dist.barrier()
        with CollectiveTimer() as timer:
            rep[f"{tag}_f32_logits"], rep[f"{tag}_f32_picks"], \
                rep[f"{tag}_f32_walls"] = part(lambda: forced_run(
                    model, cfg32, {"tokens": prompt}, ref["f32_gen"], TP_NEW))
        rep[f"{tag}_f32_collectives"] = timer.record()
        cache = init_cache(cfg32, TP_BATCH, TP_PROMPT + TP_NEW, device=dev)
        rep[f"{tag}_cache"] = {"first_slot": cache.first_slot,
                               "seq_axes": list(cache.seq_axes),
                               "k": list(cache["k"].shape)}
        del cache
    del model
    torch.cuda.empty_cache()
    model = tp_placed(rep, f"{tag}_bf16", cfg, mesh, shape, dev, dist_cfg)
    cap = Capture(ops, "flash_attention", lambda a, kw: True)
    with mesh_context(mesh, dist_cfg, batch=TP_BATCH), \
            torch.inference_mode():
        engine = Engine(cfg, model, ServeConfig(max_new_tokens=TP_NEW))
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        with cap, CollectiveTimer() as timer:
            rep[f"{tag}_bf16_gen"] = torch.from_numpy(part(
                lambda: engine.generate({"tokens": prompt})))
        rep[f"{tag}_bf16_wall_s"] = time.perf_counter() - t0
        rep[f"{tag}_bf16_timing"] = dict(engine.timing)
        rep[f"{tag}_bf16_collectives"] = timer.record()
        rep[f"{tag}_bf16_peak_gib"] = torch.cuda.max_memory_allocated() \
            / 2 ** 30
    (q, k, v), kw = cap.args
    rep[f"{tag}_call"] = ((q.cpu(), k.cpu(), v.cpu()), kw)
    del model, engine, cap
    torch.cuda.empty_cache()


def tp_step(rep: dict, tag: str, mesh, shape, ref: dict, dev, part,
            rank: int, dist_cfg=None) -> None:
    """Phase B's runs (``tp_rank``; M2 of ``tphd_rank``) on ``mesh`` (its
    ``shape``) under ``dist_cfg``, TinyLlama-1.1B at TP_B_DEPTH layers,
    f32: a batch of one's generate (its cache's layout kept), then one
    train step from a barrier under ``CollectiveTimer``, its first
    attention call with gradients kept, its updated parameters gathered
    whole (rank 0 keeps them). Into ``rep`` under ``tag``_...; launches
    through ``part``."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_cache
    from repro_torch.models.moe import block_specs
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_step import TrainConfig, make_train_step
    cfg_b = tp_configs()[2]
    prompt = ref["prompt"].to(dev)
    rep[f"{tag}_coords"] = mesh.coords
    model = tp_placed(rep, tag, cfg_b, mesh, shape, dev, dist_cfg)
    with mesh_context(mesh, dist_cfg, batch=1), torch.inference_mode():
        cache = init_cache(cfg_b, 1, TP_PROMPT + TP_B_NEW, device=dev)
        rep[f"{tag}_cache"] = {"first_slot": cache.first_slot,
                               "seq_axes": list(cache.seq_axes),
                               "k": list(cache["k"].shape)}
        del cache
        engine = Engine(cfg_b, model, ServeConfig(max_new_tokens=TP_B_NEW))
        dist.barrier()
        with CollectiveTimer() as timer:
            rep[f"{tag}_gen"] = torch.from_numpy(part(
                lambda: engine.generate({"tokens": prompt[:1]})))
        rep[f"{tag}_gen_timing"] = dict(engine.timing)
        rep[f"{tag}_gen_collectives"] = timer.record()
    model.requires_grad_()
    specs = block_specs(model)
    ocfg, batch = tp_train_setup(cfg_b, dev)
    state = init_state(dict(model.named_parameters()), ocfg, mesh, specs)
    step = make_train_step(cfg_b, ocfg, TrainConfig())
    block = {key: shd.local_block(v, shd.batch_spec(
        TP_BATCH, mesh, extra_dims=v.dim() - 1), mesh)
        for key, v in batch.items()}
    cap = Capture(ops, "flash_attention", lambda a, kw: a[0].requires_grad)
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    with cap, CollectiveTimer() as timer, \
            mesh_context(mesh, dist_cfg, batch=TP_BATCH):
        _, state, m = part(lambda: step(model, state, block))
    torch.cuda.synchronize()
    rep[f"{tag}_step_s"] = time.perf_counter() - t0
    rep[f"{tag}_step_collectives"] = timer.record()
    rep[f"{tag}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rep[f"{tag}_loss"], rep[f"{tag}_gnorm"] = float(m["loss"]), \
        float(m["grad_norm"])
    (q, k, v), kw = cap.args
    rep[f"{tag}_step_call"] = ((q.cpu(), k.cpu(), v.cpu()), kw)
    whole = {n: shd.whole_tensor(p.detach(), specs[n], mesh)
             if n in specs else p.detach()
             for n, p in model.named_parameters()}
    if rank == 0:
        rep[f"{tag}_params"] = {n: t.cpu() for n, t in whole.items()}
    del model, state, step, batch, block, whole, m, cap
    torch.cuda.empty_cache()


def counting(ops, launches: dict):
    """``part(fn)``: ``fn()`` with the kernels' launches counted from 0
    and added into ``launches``."""
    def part(fn):
        ops.reset_launch_counts()
        try:
            return fn()
        finally:
            for k, c in ops.launch_counts().items():
                launches[k] = launches.get(k, 0) + c
    return part


def tp_rank(rank: int, init: str, tmp: str, src: str) -> None:
    """One gloo rank of the tp path (started by ``spawn_ranks``; waits for
    ``tmp/tp_go``): phase A on (data 1, model 4) (``tp_serve``), phase B on
    (data 2, model 2) at TP_B_DEPTH layers (``tp_step``), launches counted
    from 0 over all of A and B; then phase T3 (``t3_rank``), its launches
    apart. Saves it all to ``tmp/tp<rank>.pt``."""
    sys.path.insert(0, src)
    import datetime

    import torch._dynamo  # noqa: F401  (see DP_WAIT_S)
    from repro_torch.distributed import compat
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm

    deadline = time.monotonic() + DP_WAIT_S
    while not Path(tmp, "tp_go").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"tp rank {rank}: no go in {DP_WAIT_S} s")
        time.sleep(0.05)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    compat.init_ranks("gloo", init, rank, TP_RANKS,
                      timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
    try:
        ref = torch.load(f"{tmp}/tp_in.pt")
        rep, launches = {"rank": rank}, {}
        part = counting(ops, launches)
        tp_serve(rep, "A", pm.make_mesh(*TP_MESHES["A"]), TP_MESHES["A"],
                 ref, dev, part)
        tp_step(rep, "B", pm.make_mesh(*TP_MESHES["B"]), TP_MESHES["B"],
                ref, dev, part, rank)
        rep["launches"] = launches
        t0 = time.perf_counter()
        rep["T3"] = t3_rank(tmp, dev)
        rep["T3_s"] = time.perf_counter() - t0
        torch.save(rep, f"{tmp}/tp{rank}.pt")
    finally:
        compat.shutdown()


def t3_rank(tmp: str, dev) -> dict:
    """Phase T3 on a tp rank (``tp_rank``, after phase B): DP_PHASES' T3
    through ``dp_setup`` on the process group (``make_local_mesh(2)``:
    (data 2, model 2)), its parameter bytes and blocks; one step on
    ``batch_at``'s batch 0 from a barrier, its launches counted from 0,
    its routes recorded and its collectives timed (``CollectiveTimer``),
    the first attention call with gradients kept; the peaks after setup
    and in the step, and what stays allocated after it. Then, the model
    and optimizer freed, the MoE layer in f32 from its initial blocks (kept
    on the host) on this data rank's row (``tmp/t3_in<model index>.pt``,
    the one-process side's): its gradients against the one-process
    side's."""
    import torch.distributed as dist
    from repro_torch.core.distributed import psum
    from repro_torch.data.lm import batch_at
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm
    from repro_torch.models import moe

    ph, rep = DP_PHASES["T3"], {}
    # what phases A and B left allocated on this rank
    rep["before_bytes"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    cfg, dcfg, model, opt, step_fn = dp_setup("T3", dev, ranks=True)
    torch.cuda.synchronize()
    rep["setup_s"] = time.perf_counter() - t0
    rep["setup_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    mesh = pm.make_local_mesh(ph["model_axis"])
    rep["coords"] = mesh.coords
    rep["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in model.parameters())
    rep["opt_bytes"] = sum(t.numel() * t.element_size()
                           for t in opt_tensors(opt))
    rep["n_params"] = sum(p.numel() for p in model.parameters())
    layer, attn = model.blocks[0].moe, model.blocks[0].attn
    rep["widths"] = {"w_gate": list(layer.w_gate.shape),
                     "w_down": list(layer.w_down.shape),
                     "wq": list(attn.wq.shape), "wk": list(attn.wk.shape),
                     "tok_embed": list(model.tok_embed.shape),
                     "lm_head": list(model.lm_head.shape)}
    # the step updates the parameters in place
    initial = {k: v.detach().to("cpu", copy=True)
               for k, v in layer.named_parameters()}
    batch = batch_at(dcfg, cfg, 0, device=dev)
    cap = Capture(ops, "flash_attention", lambda a, kw: a[0].requires_grad)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with cap, RouteRecorder(cfg) as rec, CollectiveTimer() as timer:
        dist.barrier()
        t0 = time.perf_counter()
        _, opt, m = step_fn(model, opt, batch)
        torch.cuda.synchronize()
        rep["step_s"] = time.perf_counter() - t0
    rep["launches"] = ops.launch_counts()
    rep["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rep["after_step_bytes"] = torch.cuda.memory_allocated()
    rep["collectives"] = timer.record()
    rep["loss"], rep["aux"], rep["gnorm"] = (float(m[k]) for k in (
        "loss", "aux_loss", "grad_norm"))
    rep["routes"] = rec.host_calls()[:cfg.n_layers]
    (q, k, v), kw = cap.args
    rep["call"] = ((q.cpu(), k.cpu(), v.cpu()), kw)
    # the modules too: they hold the step's parameters
    del model, layer, attn, opt, m, batch, cap, rec, q, k, v
    torch.cuda.empty_cache()

    row = mesh.coords[0]
    ref = torch.load(f"{tmp}/t3_in{mesh.coords[-1]}.pt")
    p32 = {k: v.to(dev).float().requires_grad_() for k, v in initial.items()}
    x = ref["x"][row].to(dev).requires_grad_()
    names = ("router",) + moe.EXPERT_WEIGHTS
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    with mesh_context(mesh, batch=T3_ROWS):
        grads = torch.autograd.grad(
            (moe.moe_sharded(p32, x, cfg, mesh).float()
             * ref["cot"][row].to(dev)).sum(),
            [x] + [p32[k] for k in names])
    router = psum(mesh, ("data",), grads[1])
    torch.cuda.synchronize()
    rep["layer_s"] = time.perf_counter() - t0
    rep["layer_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    specs = moe.expert_specs(cfg, mesh)
    got = {"x_grad": grads[0], "router_grad": router,
           **{f"expert_{n}": g[0] for n, g in zip(moe.EXPERT_WEIGHTS,
                                                   grads[2:])}}
    want = {"x_grad": ref["x_grad"][row], "router_grad": ref["router_grad"],
            **{f"expert_{n}": shd.local_block(w, specs[n][1:], mesh)
               for n, w in zip(moe.EXPERT_WEIGHTS, ref["expert"])}}
    rep["layer"] = {
        k: {"max_abs": float((got[k].cpu() - w).abs().max()),
            "bound": DP_LAYER_RTOL * float(w.abs().max())}
        for k, w in want.items()}
    rep["layer"]["expert"] = ref["expert_id"]
    del p32, x, grads, got, router, ref
    torch.cuda.empty_cache()
    return rep


def opt_tensors(state) -> list:
    """Every tensor of an optimizer state (nested dicts, lists and
    tuples)."""
    if torch.is_tensor(state):
        return [state]
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (list, tuple)):
        return [t for x in state for t in opt_tensors(x)]
    return []


def tp(ref: dict, spawned: dict, t3_in: list) -> dict:
    """The tp path: the ranks ``spawn_ranks(tp_rank, TP_RANKS)`` started,
    given the unsharded side's prompts and f32 tokens (``tp_reference``)
    and T3's layer inputs and gradients by model index
    (``t3_layer_inputs``), and then the go; joined."""
    torch.save({"prompt": ref["prompt"], "f32_gen": ref["f32_gen"]},
               f"{spawned['tmp']}/tp_in.pt")
    for m, layer in enumerate(t3_in):
        torch.save(layer, f"{spawned['tmp']}/t3_in{m}.pt")
    return join_ranks(spawned, "tp_go", "tp")


def t3_config():
    """T3's config: DP_PHASES' T3 cut of its arch."""
    from repro_torch.configs import get_config
    ph = DP_PHASES["T3"]
    return dataclasses.replace(get_config(ph["arch"]), n_layers=ph["depth"],
                               **ph["changes"])


def check_t3(ranks: list, ref: dict) -> tuple:
    """Phase T3's gates against the one-process step (``dp_reference``'s
    T2, whose arch, depth, seed, batch and capacity factor T3's are): the
    loss the same on every rank and within TRAIN_LOSS_ATOL of the
    one-process step's; the grad norm finite; the routes of the two data
    ranks joined in batch order under the route rule against the
    one-process routes, their kept flags recomputed under the ranks'
    capacity (each data rank's own tokens, (B S) / dp); every rank's f32
    layer gradients within DP_LAYER_RTOL of their largest; each rank's
    parameter bytes the census's (``tp_census_bytes`` on (2, 2)); exactly
    two ``flash_attention`` launches a rank (the forward and its remat)
    and one ``flash_attention_bwd``. Returns (report, failures)."""
    from repro_torch.models import moe
    cfg = t3_config()
    ph = DP_PHASES["T3"]
    xs = [x["T3"] for x in ranks]
    out, bad = {}, []
    losses = [x["loss"] for x in xs]
    out["loss"], out["loss_one_process"] = losses, ref["T2_loss"]
    out["loss_vs_one_process_abs"] = abs(losses[0] - ref["T2_loss"])
    out["gnorm"], out["gnorm_one_process"] = [x["gnorm"] for x in xs], \
        ref["T2_gnorm"]
    if any(v != losses[0] for v in losses):
        bad.append("T3: losses differ between ranks")
    if out["loss_vs_one_process_abs"] > TRAIN_LOSS_ATOL:
        bad.append("T3: step 0 loss off the one-process step's")
    if not np.isfinite(losses + out["gnorm"]).all():
        bad.append("T3: loss or grad norm not finite")
    # the model-index-0 rank of each data index, in data order
    lead = sorted((x for x in xs if x["coords"][-1] == 0),
                  key=lambda x: x["coords"][0])
    t_rank = ph["batch"] * ph["seq"] // len(lead)
    got = [tuple(torch.cat([x["routes"][i][j] for x in lead])
                 for j in range(3)) for i in range(cfg.n_layers)]
    want = []
    for e, keep, probs in ref["T2_routes"]:
        keep_ranks = torch.cat([moe.capacity_keep(
            e[i:i + t_rank], cfg.n_experts, moe.capacity(cfg, t_rank))
            for i in range(0, e.shape[0], t_rank)])
        want.append((e, keep_ranks, probs))
    routes, _ = route_rule(got, want, cfg.n_experts)
    out["routes"] = {k: v for k, v in routes.items() if k != "by_layer"}
    out["dropped_assignments"] = {
        "ranks": int(sum((~k).sum() for _, k, _ in got)),
        "one_process": int(sum((~k).sum() for _, k, _ in ref["T2_routes"])),
        "one_process_under_the_ranks_capacity": int(
            sum((~k).sum() for _, k, _ in want)),
        "of": int(sum(k.numel() for _, k, _ in got))}
    if routes["agreement"] < ROUTE_AGREEMENT[ph["arch"]] \
            or routes["violations"]:
        bad.append("T3: routes break the route rule")
    out["layer_f32"] = [{"coords": x["coords"], **x["layer"]} for x in xs]
    for x in xs:
        for k, e in x["layer"].items():
            if k != "expert" and e["max_abs"] > e["bound"]:
                bad.append(f"T3: rank {x['coords']} f32 layer {k}")
    census = tp_census_bytes(cfg, ((2, 2), ("data", "model")))
    out["param_bytes"], out["census_bytes"] = [x["param_bytes"] for x in
                                               xs], census
    if any(x["param_bytes"] != census for x in xs):
        bad.append(f"T3: parameter bytes {out['param_bytes']}, the census "
                   f"says {census}")
    want_launches = {"flash_attention": 2 * ph["depth"] * ph["steps"],
                     "flash_attention_bwd": ph["depth"] * ph["steps"]}
    out["launches_a_rank"] = [{k: x["launches"].get(k, 0)
                               for k in want_launches} for x in xs]
    out["launches_want"] = want_launches
    if any(x["launches"].get(k, 0) != n for x in xs
           for k, n in want_launches.items()):
        bad.append(f"T3: launches {out['launches_a_rank']}")
    out["widths_rank0"] = xs[0]["widths"]
    return out, bad


def check_tp_serve(tag: str, ranks: list, ref: dict, out: dict,
                   bad: list) -> None:
    """Phase A's gates on the runs under ``tag`` (``tp_serve``), into
    ``out``; failures appended to ``bad``. f32: every rank's logits bit
    for bit the same and, at the prefill's last position and each decode
    step, within TP_LOGITS_RTOL of the row's largest |logit| of the
    unsharded model's; the ranks' greedy choices (the vocab-parallel
    argmax) the unsharded run's tokens. bf16: the ranks' tokens the same
    (their agreement with the unsharded bf16 tokens reported)."""
    cfg = tp_configs()[0]
    logits = ranks[0][f"{tag}_f32_logits"]
    out[f"{tag}_f32_logits_identical_on_ranks"] = all(
        torch.equal(x[f"{tag}_f32_logits"], logits) for x in ranks)
    want = ref["f32_logits"]
    rel = ((logits - want).abs().amax(-1)
           / want.abs().amax(-1)).amax(-1)           # [TP_NEW]
    out[f"{tag}_f32_logits_rel"] = [float(x) for x in rel]
    out[f"{tag}_f32_picks_equal_unsharded"] = all(
        torch.equal(x[f"{tag}_f32_picks"], ref["f32_gen"]) for x in ranks)
    out["unsharded_f32_forced_reproduces_its_tokens"] = bool(
        (want[..., :cfg.vocab_size].argmax(-1).T
         == ref["f32_gen"]).all())
    gen = ranks[0][f"{tag}_bf16_gen"]
    out[f"{tag}_bf16_tokens_identical_on_ranks"] = all(
        torch.equal(x[f"{tag}_bf16_gen"], gen) for x in ranks)
    out[f"{tag}_bf16_generated_equal_unsharded"] = int(
        (gen == ref["bf16_gen"]).sum())
    out[f"{tag}_bf16_generated_of"] = int(gen.numel())
    out[f"{tag}_bf16_first_token_equal_unsharded"] = int(
        (gen[:, 0] == ref["bf16_gen"][:, 0]).sum())
    out[f"{tag}_heads_a_rank"] = ranks[0][f"{tag}_heads"]
    out[f"{tag}_widths_a_rank"] = ranks[0][f"{tag}_widths"]
    out[f"{tag}_cache"] = ranks[0][f"{tag}_cache"]
    if not out[f"{tag}_f32_logits_identical_on_ranks"]:
        bad.append(f"{tag}: ranks' f32 logits differ")
    if max(out[f"{tag}_f32_logits_rel"]) > TP_LOGITS_RTOL:
        bad.append(f"{tag}: f32 logits off the unsharded model's")
    if not out[f"{tag}_f32_picks_equal_unsharded"] \
            or not out["unsharded_f32_forced_reproduces_its_tokens"]:
        bad.append(f"{tag}: f32 greedy tokens differ from the unsharded "
                   f"run's")
    if not out[f"{tag}_bf16_tokens_identical_on_ranks"]:
        bad.append(f"{tag}: ranks generated different bf16 tokens")


def check_tp_step(tag: str, ranks: list, ref: dict, out: dict,
                  bad: list) -> None:
    """Phase B's gates on the runs under ``tag`` (``tp_step``), into
    ``out``; failures appended to ``bad``: the ranks' tokens of the batch
    of one the unsharded run's; the step's loss and grad norm on every
    rank within TP_LOSS_RTOL and TP_GNORM_RTOL of the unsharded step's,
    its updated parameters gathered whole within TP_PARAM_TOL but for
    TP_PARAM_OUTLIERS of their elements, each within 3 lr."""
    out[f"{tag}_cache"] = ranks[0][f"{tag}_cache"]
    out[f"{tag}_tokens_equal_unsharded"] = all(
        torch.equal(x[f"{tag}_gen"], ref["b_gen"]) for x in ranks)
    out[f"{tag}_loss"] = [x[f"{tag}_loss"] for x in ranks]
    out[f"{tag}_loss_unsharded"] = ref["b_loss"]
    out[f"{tag}_gnorm"] = [x[f"{tag}_gnorm"] for x in ranks]
    out[f"{tag}_gnorm_unsharded"] = ref["b_gnorm"]
    beyond, elems, worst = 0, 0, 0.0
    for n, w in ref["b_params"].items():
        g = ranks[0][f"{tag}_params"][n]
        err = (g.float() - w.float()).abs()
        tol = TP_PARAM_TOL["atol"] + TP_PARAM_TOL["rtol"] * w.float().abs()
        beyond += int((err > tol).sum())
        elems += err.numel()
        worst = max(worst, float(err.max()))
    out[f"{tag}_params_beyond_tol"], out[f"{tag}_params_of"] = beyond, elems
    out[f"{tag}_params_max_abs"] = worst
    if not out[f"{tag}_tokens_equal_unsharded"]:
        bad.append(f"{tag}: decode of one sequence")
    for x in ranks:
        if abs(x[f"{tag}_loss"] - ref["b_loss"]) > TP_LOSS_RTOL * abs(
                ref["b_loss"]) or abs(x[f"{tag}_gnorm"] - ref["b_gnorm"]) \
                > TP_GNORM_RTOL * ref["b_gnorm"]:
            bad.append(f"{tag}: rank {x['rank']} loss or grad norm")
    if beyond > TP_PARAM_OUTLIERS * elems or worst > 3 * TRAIN_LR:
        bad.append(f"{tag}: updated parameters off the unsharded step's")


def tp_launches_want() -> dict:
    """A rank's launches over a serve phase and a step phase (tp's A and
    B, tp_hd's M1 and M2): one ``flash_attention`` a layer and prefill
    (the f32 and bf16 runs' and the decode of one's; two a layer in the
    train step's forward, remat) and one ``flash_attention_bwd`` a layer
    in its backward."""
    cfg = tp_configs()[0]
    return {"flash_attention": 2 * cfg.n_layers + TP_B_DEPTH
            + 2 * TP_B_DEPTH, "flash_attention_bwd": TP_B_DEPTH}


def check_launches(key: str, ranks: list, want: dict, out: dict,
                   bad: list) -> None:
    """Every rank's ``key`` launches exactly ``want``."""
    out[f"{key}_a_rank"] = [{k: x[key].get(k, 0) for k in want}
                            for x in ranks]
    out[f"{key}_want"] = want
    for x in ranks:
        if any(x[key].get(k, 0) != n for k, n in want.items()):
            bad.append(f"rank {x['rank']} {key} {x[key]}")


def check_tp(r: dict, ref: dict, t3_ref: dict) -> dict:
    """The tp path's gates: phase A's (``check_tp_serve``) and B's
    (``check_tp_step``, the cache's slots split over data), launches as
    ``tp_launches_want`` on every rank, and T3's (``check_t3``). The
    parameter bytes were held to the census's on the ranks."""
    ranks = r["ranks"]
    out, bad = {}, []
    check_tp_serve("A", ranks, ref, out, bad)
    check_tp_step("B", ranks, ref, out, bad)
    if out["B_cache"]["seq_axes"] != ["data"]:
        bad.append(f"B: the cache's slots not over data ({out['B_cache']})")
    check_launches("launches", ranks, tp_launches_want(), out, bad)
    print(f"tp checks: {json.dumps(out)}", flush=True)
    out["T3"], t3_bad = check_t3(ranks, t3_ref)
    print(f"tp T3 checks: {json.dumps(out['T3'])}", flush=True)
    bad += t3_bad
    if bad:
        raise AssertionError(f"tp: {bad}")
    return out


def tp_rank_row(x: dict, a: str, b: str, path: str, card: str) -> dict:
    """A rank's numbers of a serve phase ``a`` and a step phase ``b``
    (``tp_serve``, ``tp_step``), printed on a line of their own: walls,
    the collectives' seconds and calls (timed with the card synchronised
    around each: the rest of the wall is compute and the host's
    launches), peaks and parameter bytes."""
    f32, bf, st, bg = (x[f"{a}_f32_collectives"], x[f"{a}_bf16_collectives"],
                       x[f"{b}_step_collectives"], x[f"{b}_gen_collectives"])
    row = {"rank": x["rank"], f"{a}_f32_walls": x[f"{a}_f32_walls"],
           f"{a}_f32_collectives": f32,
           f"{a}_bf16_wall_s": x[f"{a}_bf16_wall_s"],
           f"{a}_bf16_timing": x[f"{a}_bf16_timing"],
           f"{a}_bf16_collectives": bf,
           f"{a}_bf16_peak_gib": x[f"{a}_bf16_peak_gib"],
           f"{b}_gen_timing": x[f"{b}_gen_timing"],
           f"{b}_gen_collectives": bg, f"{b}_step_s": x[f"{b}_step_s"],
           f"{b}_step_collectives": st, f"{b}_peak_gib": x[f"{b}_peak_gib"],
           **{f"{t}_init_s": x[f"{t}_init_s"]
              for t in (f"{a}_f32", f"{a}_bf16", b)},
           **{f"{t}_bytes": x[f"{t}_bytes"]
              for t in (f"{a}_f32", f"{a}_bf16", b)}}
    print(f"{path} rank {x['rank']}: {a} f32 prefill "
          f"{x[f'{a}_f32_walls']['prefill_s']:.3f} s, {TP_NEW - 1} decode "
          f"steps {x[f'{a}_f32_walls']['decode_s']:.3f} s (collectives "
          f"{f32['total_s']:.3f} s in {sum(f32['calls'].values())} calls); "
          f"{a} bf16 generate {x[f'{a}_bf16_wall_s']:.3f} s (prefill "
          f"{x[f'{a}_bf16_timing']['prefill_s']:.3f}), collectives "
          f"{bf['total_s']:.3f} s in {sum(bf['calls'].values())} calls; {b} "
          f"generate {sum(x[f'{b}_gen_timing'].values()):.3f} s, "
          f"collectives {bg['total_s']:.3f} s; {b} step "
          f"{x[f'{b}_step_s']:.3f} s, collectives {st['total_s']:.3f} s "
          f"({json.dumps(st['seconds'])}); peaks {a} "
          f"{x[f'{a}_bf16_peak_gib']:.2f} / {b} {x[f'{b}_peak_gib']:.2f} GiB; "
          f"parameter bytes {a} {x[f'{a}_bf16_bytes']['census_bytes']} "
          f"(census) ({card})", flush=True)
    return row


def report_tp(r: dict, checks: dict, card: str) -> None:
    """The tp path's numbers, each on its own line, then one JSON line:
    per rank and phase (``tp_rank_row``; T3's ``t3_report_row``)."""
    per_rank = [tp_rank_row(x, "A", "B", "tp", card) for x in r["ranks"]]
    ph = DP_PHASES["T3"]
    t3 = {"phase": {**ph, "mesh": [[2, 2], ["data", "model"]],
                    "reduced": {"n_layers": [40, ph["depth"]]}},
          "per_rank": [t3_report_row(x, card) for x in r["ranks"]]}
    rep = {"card": card, "backend": "gloo", "ranks_on_one_card": TP_RANKS,
           "meshes": TP_MESHES, "batch": TP_BATCH, "prompt": TP_PROMPT,
           "new": TP_NEW, "B": {"depth": TP_B_DEPTH, "new": TP_B_NEW,
                                "reduced": {"n_layers": [22, TP_B_DEPTH]}},
           "per_rank": per_rank, "ranks_s": r["ranks_s"],
           "ranks_started_s_before": r["waited_s"], **checks,
           "T3": {**checks["T3"], **t3}}
    print(f"tp report: {json.dumps(rep)}", flush=True)


def t3_report_row(x: dict, card: str) -> dict:
    """A rank's T3 numbers (``t3_rank``), printed on a line of their own:
    setup and step walls, the collectives by kind (seconds with the card
    synchronised around each, bytes received by the census's count) and
    their share of the step, tokens/s across the ranks, peaks, and what
    the step left allocated beyond the parameters, the optimizer state and
    what was allocated before T3's setup."""
    t3, ph = x["T3"], DP_PHASES["T3"]
    col = t3["collectives"]
    row = {"rank": x["rank"], "coords": t3["coords"],
           "phase_s": x["T3_s"], "setup_s": t3["setup_s"],
           "step_s": t3["step_s"],
           "tokens_per_s_all_ranks": ph["batch"] * ph["seq"] / t3["step_s"],
           "collectives": col,
           "collectives_share": col["total_s"] / t3["step_s"],
           "setup_peak_gib": t3["setup_peak_gib"],
           "step_peak_gib": t3["step_peak_gib"],
           "before_bytes": t3["before_bytes"],
           "after_step_beyond_state_bytes": t3["after_step_bytes"]
           - t3["before_bytes"] - t3["param_bytes"] - t3["opt_bytes"],
           "param_bytes": t3["param_bytes"], "n_params": t3["n_params"],
           "f32_layer_s": t3["layer_s"],
           "f32_layer_peak_gib": t3["layer_peak_gib"],
           "aux_loss": t3["aux"], "grad_norm": t3["gnorm"]}
    sec, byt = col["seconds"], col["bytes"]
    print(f"tp T3 rank {x['rank']} {tuple(t3['coords'])}: setup "
          f"{t3['setup_s']:.3f} s, step {t3['step_s']:.3f} s "
          f"({row['tokens_per_s_all_ranks']:.1f} tokens/s across the "
          f"ranks), collectives {col['total_s']:.3f} s "
          f"({100 * row['collectives_share']:.1f}% of the step): all-gather "
          f"{sec['all-gather']:.3f} s / {byt['all-gather'] / 1e9:.3f} GB, "
          f"reduce-scatter {sec['reduce-scatter']:.3f} s / "
          f"{byt['reduce-scatter'] / 1e9:.3f} GB, all-reduce "
          f"{sec['all-reduce']:.3f} s / {byt['all-reduce'] / 1e9:.3f} GB; "
          f"peaks setup {t3['setup_peak_gib']:.2f} / step "
          f"{t3['step_peak_gib']:.2f} GiB, after the step "
          f"{row['after_step_beyond_state_bytes']} bytes beyond the "
          f"parameters, optimizer state and the {t3['before_bytes']} "
          f"phases A and B left; f32 layer "
          f"{t3['layer_s']:.3f} s, peak {t3['layer_peak_gib']:.2f} GiB; "
          f"grad norm {t3['gnorm']:.6f} ({card})", flush=True)
    return row


def tpf_cut(arch: str, depth, dtype: str = "bfloat16"):
    """``arch``'s published config in ``dtype``, cut to ``depth`` layers
    (None: uncut; the hybrid family keeps the global layers below it)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth, global_layers=tuple(
            i for i in cfg.global_layers if i < depth))
    return cfg


def tpf_configs() -> dict:
    """Each serve phase's configs: {phase: (bf16 config, f32 config)} at
    published widths, cut to the phase's depth (TPF_PHASES)."""
    return {tag: tuple(tpf_cut(ph["arch"], ph["depth"], dt)
                       for dt in ("bfloat16", "float32"))
            for tag, ph in TPF_PHASES.items()}


def tpf_batch(tag: str, cfg, prompt) -> dict:
    """A phase's batch: the seeded prompt, and whisper's seeded frames."""
    batch = {"tokens": prompt}
    if cfg.enc_layers:
        batch["frames"] = seeded_batch(cfg, prompt, prompt.device,
                                       TPF_SEED)["frames"]
    return batch


def forced_run(model, cfg, batch, gen, new: int) -> tuple:
    """The prefill of ``batch`` (its prompts, and whisper's frames) and
    ``new`` - 1 decode steps fed the tokens ``gen`` [B, new]: (the
    last-position logits of each, whole over the vocabulary, [new, B, V]
    on the host; the model's greedy choice at each, [B, new]; the
    walls)."""
    from repro_torch.models.model import (decode_step, gather_vocab, greedy,
                                          prefill)
    s = batch["tokens"].shape[1]
    gen = gen.to(batch["tokens"].device).long()
    t0 = time.perf_counter()
    logits, cache = prefill(model, batch, cfg, max_len=s + new)
    logits = logits[:, -1:]
    rows, picks = [gather_vocab(model, logits)[:, 0].cpu()], \
        [greedy(model, logits)[:, 0].cpu()]
    t1 = time.perf_counter()
    for i in range(new - 1):
        logits, cache = decode_step(model, gen[:, i:i + 1], cache, s + i,
                                    cfg)
        rows.append(gather_vocab(model, logits)[:, 0].cpu())
        picks.append(greedy(model, logits)[:, 0].cpu())
    return torch.stack(rows), torch.stack(picks, 1), \
        {"prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1}


def tpf_reference(dev) -> dict:
    """The unsharded side of the tp_families path, on the host: each
    serve phase's seeded prompts, its f32 generate's tokens and, those
    fed, its logits, and its bf16 generate's tokens; phase D's 2-layer
    f32 mamba2-370m and hymba-1.5b: a train step's loss, grad norm and
    updated parameters, and hymba's generate of a batch of one first. The
    models freed."""
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_step import TrainConfig, make_train_step
    out = {}
    for tag, (cfg, cfg32) in tpf_configs().items():
        g = torch.Generator(dev).manual_seed(TPF_SEED)
        prompt = torch.randint(0, cfg.vocab_size,
                               (TPF_BATCH, TPF_PHASES[tag]["prompt"]),
                               generator=g, device=dev)
        batch = tpf_batch(tag, cfg, prompt)
        out[f"{tag}_prompt"] = prompt.cpu()
        with torch.inference_mode():
            for kind, c in (("f32", cfg32), ("bf16", cfg)):
                model = init_params(c, TPF_SEED, dev)
                gen = Engine(c, model, ServeConfig(
                    max_new_tokens=TPF_NEW)).generate(batch)
                out[f"{tag}_{kind}_gen"] = torch.from_numpy(gen)
                if kind == "f32":
                    out[f"{tag}_f32_logits"], _, _ = forced_run(
                        model, c, batch, out[f"{tag}_f32_gen"], TPF_NEW)
                del model
                torch.cuda.empty_cache()
    for arch in TPF_D_ARCHS:
        c = tpf_cut(arch, TPF_D_DEPTH, "float32")
        model = init_params(c, TPF_SEED, dev)
        if arch == TPF_D_DECODE:
            g = torch.Generator(dev).manual_seed(TPF_SEED)
            out["D_prompt"] = torch.randint(0, c.vocab_size, (1, TP_PROMPT),
                                            generator=g, device=dev).cpu()
            with torch.inference_mode():
                out["D_gen"] = torch.from_numpy(Engine(c, model, ServeConfig(
                    max_new_tokens=TPF_D_NEW)).generate(
                        {"tokens": out["D_prompt"].to(dev)}))
        model.requires_grad_()
        ocfg, batch = tp_train_setup(c, dev)
        state = init_state(dict(model.named_parameters()), ocfg)
        _, state, m = make_train_step(c, ocfg, TrainConfig())(model, state,
                                                             batch)
        out[f"D_{arch}_loss"] = float(m["loss"])
        out[f"D_{arch}_gnorm"] = float(m["grad_norm"])
        out[f"D_{arch}_params"] = {n: p.detach().cpu() for n, p in
                                   model.named_parameters()}
        del model, state, batch, m
        torch.cuda.empty_cache()
    return out


def tpf_rank(rank: int, init: str, tmp: str, src: str) -> None:
    """One gloo rank of the tp_families path (started by ``spawn_ranks``;
    waits for ``tmp/tpf_go``). Phases A-C on (data 1, model 4), each: the
    seeded f32 model placed (its bytes against the census's),
    ``forced_run`` with the unsharded run's tokens, then the bf16 model's
    ``Engine.generate`` under ``CollectiveTimer`` (hymba's first windowed
    and whisper's first encoder attention call kept). Phase D on (data 2,
    model 2): hymba's generate of a batch of one (the cache's slots split
    over data), then a train step of each 2-layer model under
    ``CollectiveTimer``, its updated parameters gathered whole (rank 0
    keeps them). Phase E: B's serve run on (1, 4) and D's hymba decode
    and train step on (2, 2) again, under ``DistConfig(
    shard_head_dim_fallback=True)`` (its launches also counted apart, as
    ``launches_E``). Launches counted from 0 over all of it. Saves it all
    to ``tmp/tpf<rank>.pt``."""
    sys.path.insert(0, src)
    import datetime

    import torch._dynamo  # noqa: F401  (see DP_WAIT_S)
    import torch.distributed as dist
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm

    deadline = time.monotonic() + DP_WAIT_S
    while not Path(tmp, "tpf_go").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"tp_families rank {rank}: no go in "
                               f"{DP_WAIT_S} s")
        time.sleep(0.05)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    compat.init_ranks("gloo", init, rank, TP_RANKS,
                      timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
    try:
        ref = torch.load(f"{tmp}/tpf_in.pt")
        rep, launches, launches_e = {"rank": rank}, {}, {}
        head_dim = shd.DistConfig(shard_head_dim_fallback=True)

        part = counting(ops, launches)

        def part_e(fn):
            return counting(ops, launches_e)(lambda: part(fn))

        configs = tpf_configs()
        for tag, (cfg, cfg32) in configs.items():
            tpf_serve(rep, ref, dev, part, tag, tag, cfg, cfg32,
                      TPF_PHASES[tag]["mesh"])
        # phase D: (data 2, model 2), TPF_D_DEPTH layers, f32
        mesh = pm.make_mesh(*TPF_D_MESH)
        for arch in TPF_D_ARCHS:
            tpf_step(rep, ref, dev, part, rank, "D", arch, mesh, TPF_D_MESH,
                     decode=arch == TPF_D_DECODE)
        # phase E: hymba-1.5b with the head dim split over model, held to
        # phase B's unsharded runs on (1, 4) and to D's on (2, 2)
        dist.barrier()
        t0 = time.perf_counter()
        tpf_serve(rep, ref, dev, part_e, "E", "B", *configs["B"], TPF_E_MESH,
                  head_dim)
        tpf_step(rep, ref, dev, part_e, rank, "E2", TPF_D_DECODE, mesh,
                 TPF_D_MESH, head_dim, decode=True)
        rep["E_s"] = time.perf_counter() - t0
        rep["launches"], rep["launches_E"] = launches, launches_e
        torch.save(rep, f"{tmp}/tpf{rank}.pt")
    finally:
        compat.shutdown()


def tpf_serve(rep: dict, ref: dict, dev, part, tag: str, held_to: str,
              cfg, cfg32, shape, dist_cfg=None) -> None:
    """A serve phase of a rank (``tpf_rank``, ``tpssd_rank``) on the mesh
    ``shape``: the seeded f32 model placed (its bytes against the
    census's), ``forced_run`` fed the tokens of ``held_to``'s unsharded
    run (``ref``'s ``<held_to>_prompt`` and ``_f32_gen``), its peak and
    cache layout, then the bf16 model's ``Engine.generate`` under
    ``CollectiveTimer`` (the attention call ``TPF_CAPTURE[tag]`` accepts
    kept). Into ``rep`` under ``tag``_...; launches through ``part``."""
    import torch.distributed as dist
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm
    from repro_torch.models.model import init_cache
    from repro_torch.serving.engine import Engine, ServeConfig
    mesh = pm.make_mesh(*shape)
    batch = tpf_batch(held_to, cfg, ref[f"{held_to}_prompt"].to(dev))
    model = tp_placed(rep, f"{tag}_f32", cfg32, mesh, shape, dev, dist_cfg,
                      TPF_SEED)
    blk = model.blocks[0]
    rep[f"{tag}_widths"] = {
        n: tuple(p.shape) for n, p in blk.named_parameters()
        if n.split(".")[-1] in TPF_WIDTHS}
    with mesh_context(mesh, dist_cfg, batch=TPF_BATCH), \
            torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        with CollectiveTimer() as timer:
            rep[f"{tag}_f32_logits"], rep[f"{tag}_f32_picks"], \
                rep[f"{tag}_f32_walls"] = part(lambda: forced_run(
                    model, cfg32, batch, ref[f"{held_to}_f32_gen"],
                    TPF_NEW))
        rep[f"{tag}_f32_collectives"] = timer.record()
        rep[f"{tag}_f32_peak_gib"] = torch.cuda.max_memory_allocated() \
            / 2 ** 30
        cache = init_cache(cfg32, TPF_BATCH, 8, device=dev)
        rep[f"{tag}_cache"] = {k: list(t.shape) for k, t in cache.items()}
        rep[f"{tag}_cache"]["seq_axes"] = list(cache.seq_axes)
        del cache
    del model
    torch.cuda.empty_cache()
    model = tp_placed(rep, f"{tag}_bf16", cfg, mesh, shape, dev, dist_cfg,
                      TPF_SEED)
    cap = Capture(ops, "flash_attention", TPF_CAPTURE[tag])
    with mesh_context(mesh, dist_cfg, batch=TPF_BATCH), \
            torch.inference_mode():
        engine = Engine(cfg, model, ServeConfig(max_new_tokens=TPF_NEW))
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        with cap, CollectiveTimer() as timer:
            rep[f"{tag}_bf16_gen"] = torch.from_numpy(part(
                lambda: engine.generate(batch)))
        rep[f"{tag}_bf16_wall_s"] = time.perf_counter() - t0
        rep[f"{tag}_bf16_timing"] = dict(engine.timing)
        rep[f"{tag}_bf16_collectives"] = timer.record()
        rep[f"{tag}_bf16_peak_gib"] = torch.cuda.max_memory_allocated() \
            / 2 ** 30
    if cap.args is not None:
        (q, k, v), kw = cap.args
        rep[f"{tag}_call"] = ((q.cpu(), k.cpu(), v.cpu()), kw)
    del model, engine, cap, batch
    torch.cuda.empty_cache()


def tpf_step(rep: dict, ref: dict, dev, part, rank: int, tag: str,
             arch: str, mesh, shape, dist_cfg=None, *,
             decode: bool = False) -> None:
    """A train phase of a rank (``tpf_rank``, ``tpssd_rank``): ``arch``
    at TPF_D_DEPTH layers, f32, placed on ``mesh`` (its ``shape``); with
    ``decode``, a generate of ``ref``'s batch of one first (its cache's
    layout kept); then one AdamW step on ``tp_train_setup``'s batch from
    a barrier under ``CollectiveTimer``, its first attention call with
    gradients kept, its updated parameters gathered whole (rank 0 keeps
    them). Into ``rep`` under ``tag``_``arch``_...; launches through
    ``part``."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_cache
    from repro_torch.models.moe import block_specs
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_step import TrainConfig, make_train_step
    c = tpf_cut(arch, TPF_D_DEPTH, "float32")
    model = tp_placed(rep, f"{tag}_{arch}", c, mesh, shape, dev, dist_cfg,
                      TPF_SEED)
    if decode:
        with mesh_context(mesh, dist_cfg, batch=1), torch.inference_mode():
            cache = init_cache(c, 1, TP_PROMPT + TPF_D_NEW, device=dev)
            rep[f"{tag}_cache"] = {"first_slot": cache.first_slot,
                                   "seq_axes": list(cache.seq_axes),
                                   "k": list(cache["k"].shape)}
            del cache
            engine = Engine(c, model, ServeConfig(max_new_tokens=TPF_D_NEW))
            dist.barrier()
            with CollectiveTimer() as timer:
                rep[f"{tag}_gen"] = torch.from_numpy(part(
                    lambda: engine.generate(
                        {"tokens": ref["D_prompt"].to(dev)})))
            rep[f"{tag}_gen_timing"] = dict(engine.timing)
            rep[f"{tag}_gen_collectives"] = timer.record()
            del engine
    model.requires_grad_()
    specs = block_specs(model)
    ocfg, batch = tp_train_setup(c, dev)
    state = init_state(dict(model.named_parameters()), ocfg, mesh, specs)
    step = make_train_step(c, ocfg, TrainConfig())
    block = {key: shd.local_block(v, shd.batch_spec(
        TP_BATCH, mesh, extra_dims=v.dim() - 1), mesh)
        for key, v in batch.items()}
    cap = Capture(ops, "flash_attention", lambda a, kw: a[0].requires_grad)
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    with cap, CollectiveTimer() as timer, \
            mesh_context(mesh, dist_cfg, batch=TP_BATCH):
        _, state, m = part(lambda: step(model, state, block))
    torch.cuda.synchronize()
    rep[f"{tag}_{arch}_step_s"] = time.perf_counter() - t0
    rep[f"{tag}_{arch}_collectives"] = timer.record()
    rep[f"{tag}_{arch}_peak_gib"] = torch.cuda.max_memory_allocated() \
        / 2 ** 30
    rep[f"{tag}_{arch}_loss"] = float(m["loss"])
    rep[f"{tag}_{arch}_gnorm"] = float(m["grad_norm"])
    if cap.args is not None:
        (q, k, v), kw = cap.args
        rep[f"{tag}_{arch}_step_call"] = ((q.cpu(), k.cpu(), v.cpu()), kw)
    whole = {n: shd.whole_tensor(p.detach(), specs[n], mesh)
             if n in specs else p.detach()
             for n, p in model.named_parameters()}
    if rank == 0:
        rep[f"{tag}_{arch}_params"] = {n: t.cpu() for n, t in whole.items()}
    del model, state, step, batch, block, whole, m, cap
    torch.cuda.empty_cache()


def tp_families(ref: dict, spawned: dict) -> dict:
    """The tp_families path: the ranks ``spawn_ranks(tpf_rank,
    TP_RANKS)`` started, given the unsharded side's prompts and f32 tokens
    (``tpf_reference``) and then the go; joined."""
    torch.save({k: v for k, v in ref.items()
                if k.endswith("_prompt") or k.endswith("_f32_gen")},
               f"{spawned['tmp']}/tpf_in.pt")
    return join_ranks(spawned, "tpf_go", "tpf")


def tpf_launches_want(configs) -> dict:
    """A rank's launches over the path: a phase's prefill launches in each
    of its f32 and bf16 runs (hymba one a layer, whisper its encoder's,
    self- and cross-attention's), phase D's hymba generate's prefill and
    its train step (each layer forward twice, remat, and backward once),
    and phase E's (``tpf_e_launches_want``)."""
    fwd = sum(2 * prefill_launches(cfg) for cfg, _ in configs.values()
              if not cfg.is_attention_free)
    e = tpf_e_launches_want(configs)
    return {"flash_attention": fwd + 3 * TPF_D_DEPTH
            + e["flash_attention"],
            "flash_attention_bwd": TPF_D_DEPTH + e["flash_attention_bwd"]}


def tpf_e_launches_want(configs) -> dict:
    """A rank's launches in phase E: B's prefill in its f32 and bf16 runs,
    the (2, 2) decode's prefill and the train step's, as phase D's."""
    return {"flash_attention": 2 * prefill_launches(configs["B"][0])
            + 3 * TPF_D_DEPTH, "flash_attention_bwd": TPF_D_DEPTH}


def check_tp_families(r: dict, ref: dict) -> dict:
    """The tp_families path's gates. A-C, f32: every rank's logits bit for
    bit the same and, at the prefill's last position and each decode
    step, within TP_LOGITS_RTOL of the row's largest |logit| of the
    unsharded model's; the ranks' greedy choices the unsharded run's
    tokens (both over the real vocabulary, the padded entries left
    out). A-C, bf16: the ranks' tokens the same (their agreement with
    the unsharded bf16 tokens reported). D: hymba's tokens of the batch
    of one the unsharded run's, its cache's slots split over data; each
    train step's loss and grad norm on every rank within TP_LOSS_RTOL and
    TP_GNORM_RTOL of the unsharded step's, its updated parameters
    gathered whole within TP_PARAM_TOL but for TP_PARAM_OUTLIERS of their
    elements, each within 3 lr. E, the head-dim placement: B's gates
    against B's unsharded runs, with every attention weight and the cache
    holding the rank's head-dim block, and D's hymba gates on (2, 2)
    against D's unsharded runs, its cache's slots over data and its head
    dim over model. Launches as ``tpf_launches_want`` on every rank,
    phase E's as ``tpf_e_launches_want``. The parameter bytes were held
    to the census's on the ranks (E's under the flag)."""
    ranks, configs = r["ranks"], tpf_configs()
    out, bad = {}, []
    for tag, held_to in (*((t, t) for t in configs), ("E", "B")):
        out[tag] = tpf_check_serve(tag, held_to, configs[held_to][0], ranks,
                                   ref, bad)
    hd = configs["B"][0].resolved_head_dim
    cache = out["E"]["cache_a_rank"]
    e_hd = {n: w for n, w in out["E"]["widths_a_rank"].items()
            if n.split(".")[-1] in ("wq", "wk", "wo")}
    out["E"]["head_dim_split"] = {
        "weights": e_hd, "cache_k": cache["k"],
        "cache_seq_axes": cache["seq_axes"]}
    if cache["k"][-1] != hd // TPF_E_MESH[0][1] or cache["seq_axes"] \
            or any(hd // TPF_E_MESH[0][1] not in w for w in e_hd.values()):
        bad.append(f"E: not split over the head dim ({out['E']})")
    out["D"] = tpf_check_steps("D", TPF_D_ARCHS, ranks, ref, bad)
    out["E2"] = tpf_check_steps("E2", (TPF_D_DECODE,), ranks, ref, bad)
    if out["E2"]["cache"]["k"][-1] != hd // TPF_D_MESH[0][1]:
        bad.append(f"E2: cache not split over the head dim "
                   f"({out['E2']['cache']})")
    for key, want in (("launches", tpf_launches_want(configs)),
                      ("launches_E", tpf_e_launches_want(configs))):
        check_launches(key, ranks, want, out, bad)
    print(f"tp_families checks: {json.dumps(out)}", flush=True)
    if bad:
        raise AssertionError(f"tp_families: {bad}")
    return out


def tpf_check_serve(tag: str, held_to: str, cfg, ranks, ref,
                    bad: list) -> dict:
    """A serve phase's gates on the ranks' runs under the keys ``tag``_...
    against ``held_to``'s unsharded runs in ``ref`` (``cfg``: its bf16
    config); failures appended to ``bad``."""
    logits = ranks[0][f"{tag}_f32_logits"]
    same = all(torch.equal(x[f"{tag}_f32_logits"], logits) for x in ranks)
    # the real vocabulary: the padded entries are -1e30 on both sides
    want = ref[f"{held_to}_f32_logits"][..., :cfg.vocab_size]
    logits = logits[..., :cfg.vocab_size]
    rel = ((logits - want).abs().amax(-1) / want.abs().amax(-1)).amax(-1)
    picks = all(torch.equal(x[f"{tag}_f32_picks"],
                            ref[f"{held_to}_f32_gen"]) for x in ranks)
    own = bool((want.argmax(-1).T == ref[f"{held_to}_f32_gen"]).all())
    gen = ranks[0][f"{tag}_bf16_gen"]
    out = {
        "arch": cfg.arch_id, "layers": cfg.n_layers,
        "f32_logits_identical_on_ranks": same,
        "f32_logits_rel": [float(x) for x in rel],
        "f32_picks_equal_unsharded": picks,
        "unsharded_f32_forced_reproduces_its_tokens": own,
        "bf16_tokens_identical_on_ranks": all(
            torch.equal(x[f"{tag}_bf16_gen"], gen) for x in ranks),
        "bf16_generated_equal_unsharded": int(
            (gen == ref[f"{held_to}_bf16_gen"]).sum()),
        "bf16_generated_of": int(gen.numel()),
        "widths_a_rank": ranks[0][f"{tag}_widths"],
        "cache_a_rank": ranks[0][f"{tag}_cache"]}
    if not same:
        bad.append(f"{tag}: ranks' f32 logits differ")
    if max(out["f32_logits_rel"]) > TP_LOGITS_RTOL:
        bad.append(f"{tag}: f32 logits off the unsharded model's")
    if not picks or not own:
        bad.append(f"{tag}: f32 greedy tokens differ from the unsharded "
                   f"run's")
    if not out["bf16_tokens_identical_on_ranks"]:
        bad.append(f"{tag}: ranks generated different bf16 tokens")
    return out


def tpf_check_steps(tag: str, archs, ranks, ref, bad: list) -> dict:
    """Phase D's gates on the ranks' runs under the keys ``tag``_...,
    against D's unsharded runs; failures appended to ``bad``."""
    d = {"cache": ranks[0][f"{tag}_cache"], "tokens_equal_unsharded": all(
        torch.equal(x[f"{tag}_gen"], ref["D_gen"]) for x in ranks)}
    if not d["tokens_equal_unsharded"] \
            or "data" not in d["cache"]["seq_axes"]:
        bad.append(f"{tag}: decode of one sequence ({d['cache']})")
    for arch in archs:
        d[arch] = tpf_check_step(tag, arch, ranks, ref, bad)
    return d


def tpf_check_step(tag: str, arch: str, ranks, ref, bad: list,
                   loss_rtol: float = TP_LOSS_RTOL) -> dict:
    """A train step's gates (``tpf_step`` under the keys
    ``tag``_``arch``_...) against D's unsharded step of ``arch``: the
    loss within ``loss_rtol`` and the grad norm within TP_GNORM_RTOL on
    every rank, the updated parameters gathered whole within
    TP_PARAM_TOL but for TP_PARAM_OUTLIERS of their elements, each within
    3 lr; failures appended to ``bad``."""
    loss, gnorm = ref[f"D_{arch}_loss"], ref[f"D_{arch}_gnorm"]
    d = {"loss": [x[f"{tag}_{arch}_loss"] for x in ranks],
         "loss_unsharded": loss,
         "gnorm": [x[f"{tag}_{arch}_gnorm"] for x in ranks],
         "gnorm_unsharded": gnorm}
    d["loss_bit_for_bit"] = all(x == loss for x in d["loss"])
    for x in ranks:
        if abs(x[f"{tag}_{arch}_loss"] - loss) > loss_rtol * abs(loss) \
                or abs(x[f"{tag}_{arch}_gnorm"] - gnorm) \
                > TP_GNORM_RTOL * gnorm:
            bad.append(f"{tag} {arch}: rank {x['rank']} loss or grad norm")
    beyond, elems, worst = 0, 0, 0.0
    for n, w in ref[f"D_{arch}_params"].items():
        g = ranks[0][f"{tag}_{arch}_params"][n]
        err = (g.float() - w.float()).abs()
        tol = TP_PARAM_TOL["atol"] + TP_PARAM_TOL["rtol"] * w.float().abs()
        beyond += int((err > tol).sum())
        elems += err.numel()
        worst = max(worst, float(err.max()))
    d.update(params_beyond_tol=beyond, params_of=elems,
             params_max_abs=worst)
    if beyond > TP_PARAM_OUTLIERS * elems or worst > 3 * TRAIN_LR:
        bad.append(f"{tag} {arch}: updated parameters off the unsharded "
                   f"step's")
    return d


def report_tp_families(r: dict, checks: dict, card: str) -> None:
    """The tp_families path's numbers, each on its own line, then one JSON
    line: per rank and phase the walls, the collectives' seconds and share
    of the wall (timed with the card synchronised around each: the rest
    of the wall is compute and the host's launches), peaks and parameter
    bytes; phase E (the head-dim placement) beside B and D."""
    per_rank = []
    for x in r["ranks"]:
        row = {"rank": x["rank"]}
        line = []
        for tag in (*TPF_PHASES, "E"):
            f32, bf = x[f"{tag}_f32_collectives"], \
                x[f"{tag}_bf16_collectives"]
            f32_wall = sum(x[f"{tag}_f32_walls"].values())
            row[tag] = {
                "f32_walls": x[f"{tag}_f32_walls"], "f32_collectives": f32,
                "f32_collectives_share": f32["total_s"] / f32_wall,
                "bf16_wall_s": x[f"{tag}_bf16_wall_s"],
                "bf16_timing": x[f"{tag}_bf16_timing"],
                "bf16_collectives": bf,
                "bf16_collectives_share": bf["total_s"]
                / x[f"{tag}_bf16_wall_s"],
                "bf16_peak_gib": x[f"{tag}_bf16_peak_gib"],
                "bytes": x[f"{tag}_bf16_bytes"]}
            line.append(
                f"{tag} f32 prefill {x[f'{tag}_f32_walls']['prefill_s']:.3f}"
                f" s + {TPF_NEW - 1} steps "
                f"{x[f'{tag}_f32_walls']['decode_s']:.3f} s (collectives "
                f"{f32['total_s']:.3f} s), bf16 generate "
                f"{x[f'{tag}_bf16_wall_s']:.3f} s (collectives "
                f"{bf['total_s']:.3f} s in {sum(bf['calls'].values())} "
                f"calls)")
        for tag, archs in (("D", TPF_D_ARCHS), ("E2", (TPF_D_DECODE,))):
            row[tag] = {"gen_timing": x[f"{tag}_gen_timing"],
                        "gen_collectives": x[f"{tag}_gen_collectives"],
                        "gen_collectives_share": x[f"{tag}_gen_collectives"][
                            "total_s"] / sum(x[f"{tag}_gen_timing"].values()),
                        **{arch: {"step_s": x[f"{tag}_{arch}_step_s"],
                                  "collectives":
                                      x[f"{tag}_{arch}_collectives"],
                                  "collectives_share":
                                      x[f"{tag}_{arch}_collectives"]["total_s"]
                                      / x[f"{tag}_{arch}_step_s"],
                                  "peak_gib": x[f"{tag}_{arch}_peak_gib"]}
                           for arch in archs}}
            line.append(f"{tag} steps " + ", ".join(
                f"{arch} {x[f'{tag}_{arch}_step_s']:.3f} s (collectives "
                f"{x[f'{tag}_{arch}_collectives']['total_s']:.3f} s)"
                for arch in archs))
        row["E_s"] = x["E_s"]
        line.append(f"phase E in all {x['E_s']:.3f} s")
        per_rank.append(row)
        print(f"tp_families rank {x['rank']}: {'; '.join(line)} ({card})",
              flush=True)
    rep = {"card": card, "backend": "gloo", "ranks_on_one_card": TP_RANKS,
           "phases": TPF_PHASES, "batch": TPF_BATCH, "new": TPF_NEW,
           "D_setup": {"mesh": TPF_D_MESH, "archs": TPF_D_ARCHS,
                 "depth": TPF_D_DEPTH, "new": TPF_D_NEW,
                 "batch": TP_BATCH, "prompt": TP_PROMPT},
           "E_setup": {"dist": "DistConfig(shard_head_dim_fallback=True)",
                       "mesh": TPF_E_MESH, "held_to": "B",
                       "E2": {"mesh": TPF_D_MESH, "arch": TPF_D_DECODE,
                              "held_to": "D"}},
           "per_rank": per_rank, "ranks_s": r["ranks_s"],
           "ranks_started_s_before": r["waited_s"], **checks}
    print(f"tp_families report: {json.dumps(rep, default=str)}", flush=True)


def tpf_kernel_rows(r: dict, dev) -> list:
    """``flash_attention``'s rows at the tp_families path's new shapes on
    a rank: hymba-1.5b's windowed layer (phase B, every head, window
    1024, 128 meta tokens), whisper-small's encoder layer (phase C, 3
    heads a rank) and hymba-1.5b's windowed layer under the head-dim
    placement (phase E: the blocks gathered, every head whole on every
    rank); launches: the path's over its 4 ranks (E's row: phase E's)."""
    rows = []
    for tag, what, key in (
            ("B", "hymba-1.5b windowed layer a rank, 4 x 640", "launches"),
            ("C", "whisper-small encoder layer a rank, 4 x 1500, 3 heads",
             "launches"),
            ("E", "hymba-1.5b windowed layer a rank, head dim split over "
                  "model, the blocks gathered, 4 x 640", "launches_E")):
        launches = sum(x[key].get("flash_attention", 0) for x in r["ranks"])
        (q, k, v), kw = r["ranks"][0][f"{tag}_call"]
        cap = types.SimpleNamespace(
            args=(tuple(t.to(dev) for t in (q, k, v)), kw))
        rows.append(flash_row(cap, launches, f"tp_families {what}"))
        rows[-1]["path"] = "tp_families"
        rows[-1]["note"] = "; ".join(filter(None, [rows[-1].get("note"), (
            "launches: phase E's over the 4 ranks (a rank: the prefills of "
            "its f32 and bf16 runs, its (2, 2) hymba generate and train "
            "step)" if tag == "E" else
            "launches: the tp_families path's over its 4 ranks (a rank: "
            "the prefills of phase B's, C's and E's f32 and bf16 runs, "
            "phase D's and E's hymba generate and train step)")]))
    return rows

def tphd_rank(rank: int, init: str, tmp: str, src: str) -> None:
    """One gloo rank of the tp_hd path (started by ``spawn_ranks``; waits
    for ``tmp/tphd_go``), on (data 1, model 8) under
    ``DistConfig(shard_head_dim_fallback=True)``: M1 as tp's phase A
    (``tp_serve``), then M2 as its phase B (``tp_step``) on the same mesh,
    launches counted from 0 over both. Saves it all to
    ``tmp/tphd<rank>.pt``."""
    sys.path.insert(0, src)
    import datetime

    import torch._dynamo  # noqa: F401  (see DP_WAIT_S)
    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import DistConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm

    deadline = time.monotonic() + DP_WAIT_S
    while not Path(tmp, "tphd_go").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"tp_hd rank {rank}: no go in {DP_WAIT_S} s")
        time.sleep(0.05)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    compat.init_ranks("gloo", init, rank, TP_HD_RANKS,
                      timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
    try:
        ref = torch.load(f"{tmp}/tphd_in.pt")
        rep, launches = {"rank": rank}, {}
        part = counting(ops, launches)
        head_dim = DistConfig(shard_head_dim_fallback=True)
        mesh = pm.make_mesh(*TP_HD_MESH)
        t0 = time.perf_counter()
        tp_serve(rep, "M1", mesh, TP_HD_MESH, ref, dev, part, head_dim)
        t1 = time.perf_counter()
        tp_step(rep, "M2", mesh, TP_HD_MESH, ref, dev, part, rank, head_dim)
        rep["M1_s"], rep["M2_s"] = t1 - t0, time.perf_counter() - t1
        rep["launches"] = launches
        torch.save(rep, f"{tmp}/tphd{rank}.pt")
    finally:
        compat.shutdown()


def tp_hd(ref: dict, spawned: dict) -> dict:
    """The tp_hd path: the ranks ``spawn_ranks(tphd_rank, TP_HD_RANKS)``
    started, given the unsharded side's prompts and f32 tokens
    (``tp_reference``) and then the go; joined."""
    torch.save({"prompt": ref["prompt"], "f32_gen": ref["f32_gen"]},
               f"{spawned['tmp']}/tphd_in.pt")
    return join_ranks(spawned, "tphd_go", "tphd")


def check_tp_hd(r: dict, ref: dict) -> dict:
    """The tp_hd path's gates against ``tp_reference``'s unsharded runs:
    M1's as phase A's (``check_tp_serve``) and M2's as phase B's
    (``check_tp_step``); case M's placement on every rank: 4 query heads
    whole (``wq``, ``wo``) and the head-dim block of every kv head
    (``wk``, ``wv``), the decode caches of M1 and M2 holding that block of
    k (its last dim hd // 8, the slots whole); launches as
    ``tp_launches_want`` on every rank. The parameter bytes were held to
    the census's under the flag on the ranks."""
    ranks = r["ranks"]
    cfg = tp_configs()[0]
    m, hd = TP_HD_MESH[0][1], cfg.resolved_head_dim
    out, bad = {}, []
    check_tp_serve("M1", ranks, ref, out, bad)
    check_tp_step("M2", ranks, ref, out, bad)
    d, h, kvh = cfg.d_model, cfg.n_heads // m, cfg.n_kv_heads
    want = {"wq": [d, h, hd], "wk": [d, kvh, hd // m],
            "wv": [d, kvh, hd // m], "wo": [h, hd, d]}
    out["widths_want"] = want
    if any(x["M1_widths"] != want for x in ranks):
        bad.append(f"M1: not case M's placement "
                   f"({[x['M1_widths'] for x in ranks]})")
    for tag in ("M1", "M2"):
        cache = out[f"{tag}_cache"]
        if cache["k"][-1] != hd // m or cache["seq_axes"]:
            bad.append(f"{tag}: cache not split over the head dim "
                       f"({cache})")
    out["param_bytes_a_rank"] = {t: ranks[0][f"{t}_bytes"]["census_bytes"]
                                 for t in ("M1_f32", "M1_bf16", "M2")}
    check_launches("launches", ranks, tp_launches_want(), out, bad)
    print(f"tp_hd checks: {json.dumps(out)}", flush=True)
    if bad:
        raise AssertionError(f"tp_hd: {bad}")
    return out


def report_tp_hd(r: dict, checks: dict, card: str) -> None:
    """The tp_hd path's numbers: a line a rank (``tp_rank_row``, M1 and
    M2), then one JSON line."""
    per_rank = []
    for x in r["ranks"]:
        per_rank.append({**tp_rank_row(x, "M1", "M2", "tp_hd", card),
                         "M1_s": x["M1_s"], "M2_s": x["M2_s"]})
    rep = {"card": card, "backend": "gloo", "transport": "shared host "
           "segment (distributed/shm.py)", "ranks_on_one_card": TP_HD_RANKS,
           "dist": "DistConfig(shard_head_dim_fallback=True)",
           "mesh": TP_HD_MESH, "batch": TP_BATCH, "prompt": TP_PROMPT,
           "new": TP_NEW, "M2": {"depth": TP_B_DEPTH, "new": TP_B_NEW,
                                 "reduced": {"n_layers": [22, TP_B_DEPTH]}},
           "per_rank": per_rank, "ranks_s": r["ranks_s"],
           "ranks_started_s_before": r["waited_s"],
           "held_before_go": r["held_before_go"], **checks}
    print(f"tp_hd report: {json.dumps(rep, default=str)}", flush=True)


def tphd_kernel_rows(r: dict, dev) -> list:
    """The kernel rows at case M's per-rank shapes (rank 0's calls):
    ``flash_attention`` at M1's bf16 prefill layer (4 x 512, the rank's 4
    query heads over the one kv head they read) and
    ``flash_attention_bwd`` at M2's f32 train layer; launches: the path's
    over its 8 ranks."""
    ranks = r["ranks"]

    def on_card(key):
        (q, k, v), kw = ranks[0][key]
        return tuple(t.to(dev) for t in (q, k, v)), kw

    def launched(name):
        return sum(x["launches"].get(name, 0) for x in ranks)
    rows = [flash_row(types.SimpleNamespace(args=on_card("M1_call")),
                      launched("flash_attention"),
                      "tp_hd M1 bf16 prefill layer a rank, 4 x 512, 4 / 1 "
                      "heads"),
            flash_bwd_row(on_card("M2_step_call"),
                          launched("flash_attention_bwd"),
                          "tp_hd M2 f32 train layer a rank, 4 x 512, 4 / 1 "
                          "heads")]
    for row in rows:
        row["path"] = "tp_hd"
        row["note"] = "; ".join(filter(None, [row.get("note"), (
            "case M of the head-dim placement, TinyLlama-1.1B on (1, 8); "
            "launches: the tp_hd path's over its 8 ranks (a rank: the "
            "prefills of M1's f32 and bf16 runs and of M2's decode, M2's "
            "train step)")]))
    return rows


def tpssd_reference(dev) -> dict:
    """The unsharded side of the tp_ssd path's S1, on the host:
    hymba-1.5b uncut, TPF_PHASES' hymba prompts, its f32 generate's tokens
    and, those fed, its logits, and its bf16 generate's tokens (the
    models freed). S2-S4 are held to tp_families' unsharded runs."""
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, ServeConfig
    arch = TP_SSD_WORLDS[0][2]
    g = torch.Generator(dev).manual_seed(TPF_SEED)
    cfg = tpf_cut(arch, None)
    prompt = torch.randint(0, cfg.vocab_size, (TPF_BATCH, TPF_PHASES["B"][
        "prompt"]), generator=g, device=dev)
    out = {"S1_prompt": prompt.cpu()}
    with torch.inference_mode():
        for kind, c in (("f32", tpf_cut(arch, None, "float32")),
                        ("bf16", cfg)):
            model = init_params(c, TPF_SEED, dev)
            gen = Engine(c, model, ServeConfig(
                max_new_tokens=TPF_NEW)).generate({"tokens": prompt})
            out[f"S1_{kind}_gen"] = torch.from_numpy(gen)
            if kind == "f32":
                out["S1_f32_logits"], _, _ = forced_run(
                    model, c, {"tokens": prompt}, out["S1_f32_gen"],
                    TPF_NEW)
            del model
            torch.cuda.empty_cache()
    return out


def tpssd_rank(rank: int, init: str, tmp: str, src: str) -> None:
    """One gloo rank of the tp_ssd path (started by ``spawn_ranks``; waits
    for ``tmp/tpssd_go``): each world of TP_SSD_WORLDS in turn, the ranks
    of its mesh (the first of them) joining it (``init`` and the world's
    size), its serve phase (``tpf_serve``) and step phase (``tpf_step``),
    launches counted from 0 over all of it. Saves it all to
    ``tmp/tpssd<rank>.pt``."""
    sys.path.insert(0, src)
    import datetime

    import torch._dynamo  # noqa: F401  (see DP_WAIT_S)
    from repro_torch.distributed import compat
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as pm

    deadline = time.monotonic() + DP_WAIT_S
    while not Path(tmp, "tpssd_go").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"tp_ssd rank {rank}: no go in {DP_WAIT_S} s")
        time.sleep(0.05)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ref = torch.load(f"{tmp}/tpssd_in.pt")
    rep, launches = {"rank": rank}, {}
    part = counting(ops, launches)
    for serve, step, arch, shape, held_to in TP_SSD_WORLDS:
        world = math.prod(shape[0])
        if rank >= world:
            break
        compat.init_ranks("gloo", f"{init}{world}", rank, world,
                          timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
        try:
            t0 = time.perf_counter()
            tpf_serve(rep, ref, dev, part, serve, held_to,
                      *(tpf_cut(arch, None, dt)
                        for dt in ("bfloat16", "float32")), shape)
            t1 = time.perf_counter()
            tpf_step(rep, ref, dev, part, rank, step, arch,
                     pm.make_mesh(*shape), shape)
            rep[f"{serve}_s"], rep[f"{step}_s"] = t1 - t0, \
                time.perf_counter() - t1
        finally:
            compat.shutdown()
    rep["launches"] = launches
    torch.save(rep, f"{tmp}/tpssd{rank}.pt")


def tp_ssd(ref: dict, tpf_ref: dict, spawned: dict) -> dict:
    """The tp_ssd path: the ranks ``spawn_ranks(tpssd_rank,
    TP_SSD_RANKS)`` started, given the unsharded sides' prompts and f32
    tokens (S1's ``tpssd_reference``, S3's tp_families' phase A) and then
    the go; joined."""
    torch.save({k: v for k, v in {**tpf_ref, **ref}.items()
                if k.endswith("_prompt") or k.endswith("_f32_gen")},
               f"{spawned['tmp']}/tpssd_in.pt")
    return join_ranks(spawned, "tpssd_go", "tpssd")


def tpssd_launches_want() -> dict:
    """A rank's launches over the tp_ssd path: S1's prefill in its f32 and
    bf16 runs and S2's step (each layer forward twice, remat, and
    backward once) on every rank of world 1; mamba2-370m launches no
    kernel."""
    cfg = tpf_cut(TP_SSD_WORLDS[0][2], None)
    return {"flash_attention": 2 * prefill_launches(cfg) + 2 * TPF_D_DEPTH,
            "flash_attention_bwd": TPF_D_DEPTH}


def check_tp_ssd(r: dict, ref: dict, tpf_ref: dict) -> dict:
    """The tp_ssd path's gates: each world's serve phase under
    tp_families' (``tpf_check_serve``: the ranks' f32 logits bit for bit
    the same and within TP_LOGITS_RTOL of the row's largest of the
    unsharded run's, every greedy choice its token, the ranks' bf16 tokens
    the same), its step under ``tpf_check_step`` with the loss within
    TP_SSD_LOSS_RTOL; the SSD's placement on every rank: S1's ``in_proj``
    and conv whole, its cache's ``h`` the rank's 10 of 50 heads and its
    conv window whole; S3's ``in_proj`` whole, its conv and conv window
    768 of 2304 channels, ``h`` whole; launches as
    ``tpssd_launches_want``. The parameter bytes were held to the
    census's on the ranks."""
    ranks = r["ranks"]
    held = {**tpf_ref, **ref}
    out, bad = {}, []
    for serve, step, arch, shape, held_to in TP_SSD_WORLDS:
        m = shape[0][1]
        on = ranks[:math.prod(shape[0])]
        cfg = tpf_cut(arch, None)
        out[serve] = tpf_check_serve(serve, held_to, cfg, on, held, bad)
        out[step] = tpf_check_step(step, arch, on, tpf_ref, bad,
                                   TP_SSD_LOSS_RTOL)
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv, proj = di + 2 * n, 2 * di + 2 * n + nh
        heads = nh // m if nh % m == 0 else nh
        channels = conv // m if conv % m == 0 else conv
        want = {"in_proj": [cfg.d_model, proj if proj % m else proj // m],
                "conv_w": [cfg.ssm_conv, channels],
                "h": [cfg.n_layers, TPF_BATCH, heads, cfg.ssm_head_dim, n],
                "conv": [cfg.n_layers, TPF_BATCH, cfg.ssm_conv - 1,
                         channels]}
        for x in on:
            got = {k: list(w) for k, w in x[f"{serve}_widths"].items()
                   if k.split(".")[-1] in ("in_proj", "conv_w")}
            got = {k.split(".")[-1]: w for k, w in got.items()}
            got.update({k: x[f"{serve}_cache"][k] for k in ("h", "conv")})
            if got != want:
                bad.append(f"{serve}: rank {x['rank']} holds {got}, want "
                           f"{want}")
        out[serve]["ssd_a_rank_want"] = want
        out[serve]["peak_f32_gib"] = [x[f"{serve}_f32_peak_gib"] for x in on]
    check_launches("launches", ranks, tpssd_launches_want(), out, bad)
    print(f"tp_ssd checks: {json.dumps(out)}", flush=True)
    if bad:
        raise AssertionError(f"tp_ssd: {bad}")
    return out


def report_tp_ssd(r: dict, checks: dict, card: str) -> None:
    """The tp_ssd path's numbers: a line a rank and world (walls, the
    collectives' seconds and calls, peaks, parameter bytes), then one
    JSON line."""
    per_rank = []
    for x in r["ranks"]:
        row = {"rank": x["rank"]}
        for serve, step, arch, shape, _ in TP_SSD_WORLDS:
            if f"{serve}_s" not in x:
                continue
            f32, bf, st = (x[f"{serve}_f32_collectives"],
                           x[f"{serve}_bf16_collectives"],
                           x[f"{step}_{arch}_collectives"])
            row[serve] = {
                "s": x[f"{serve}_s"], "f32_walls": x[f"{serve}_f32_walls"],
                "f32_collectives": f32,
                "f32_peak_gib": x[f"{serve}_f32_peak_gib"],
                "bf16_wall_s": x[f"{serve}_bf16_wall_s"],
                "bf16_timing": x[f"{serve}_bf16_timing"],
                "bf16_collectives": bf,
                "bf16_peak_gib": x[f"{serve}_bf16_peak_gib"],
                "bytes": {k: x[f"{serve}_{k}_bytes"]
                          for k in ("f32", "bf16")}}
            row[step] = {"s": x[f"{step}_s"],
                         "step_s": x[f"{step}_{arch}_step_s"],
                         "collectives": st,
                         "peak_gib": x[f"{step}_{arch}_peak_gib"],
                         "bytes": x[f"{step}_{arch}_bytes"]}
            print(f"tp_ssd rank {x['rank']} {arch} on {shape[0]}: {serve} "
                  f"f32 prefill {x[f'{serve}_f32_walls']['prefill_s']:.3f} s"
                  f" + {TPF_NEW - 1} steps "
                  f"{x[f'{serve}_f32_walls']['decode_s']:.3f} s "
                  f"(collectives {f32['total_s']:.3f} s in "
                  f"{sum(f32['calls'].values())} calls, peak "
                  f"{x[f'{serve}_f32_peak_gib']:.2f} GiB), bf16 generate "
                  f"{x[f'{serve}_bf16_wall_s']:.3f} s (collectives "
                  f"{bf['total_s']:.3f} s in {sum(bf['calls'].values())} "
                  f"calls, peak {x[f'{serve}_bf16_peak_gib']:.2f} GiB); "
                  f"{step} step {x[f'{step}_{arch}_step_s']:.3f} s "
                  f"(collectives {st['total_s']:.3f} s, peak "
                  f"{x[f'{step}_{arch}_peak_gib']:.2f} GiB); parameter bytes "
                  f"{serve} f32 "
                  f"{x[f'{serve}_f32_bytes']['census_bytes']} (census) "
                  f"({card})", flush=True)
        per_rank.append(row)
    rep = {"card": card, "backend": "gloo", "transport": "shared host "
           "segment (distributed/shm.py)", "ranks_on_one_card": TP_SSD_RANKS,
           "worlds": TP_SSD_WORLDS, "batch": TPF_BATCH, "new": TPF_NEW,
           "steps": {"depth": TPF_D_DEPTH, "batch": TP_BATCH,
                     "prompt": TP_PROMPT,
                     "reduced": {"n_layers": TPF_D_DEPTH}},
           "per_rank": per_rank, "ranks_s": r["ranks_s"],
           "ranks_started_s_before": r["waited_s"],
           "held_before_go": r["held_before_go"], **checks}
    print(f"tp_ssd report: {json.dumps(rep, default=str)}", flush=True)


def tpssd_kernel_rows(r: dict, dev) -> list:
    """The kernel rows at S1's and S2's per-rank shapes (rank 0's calls):
    ``flash_attention`` at S1's bf16 windowed prefill layer (4 x 640, the
    rank's 5 query heads over its kv head, window 1024, 128 meta tokens)
    and ``flash_attention_bwd`` at S2's f32 train layer; launches: the
    path's over its 5 ranks."""
    ranks = r["ranks"]
    arch = TP_SSD_WORLDS[0][2]

    def on_card(key):
        (q, k, v), kw = ranks[0][key]
        return tuple(t.to(dev) for t in (q, k, v)), kw

    def launched(name):
        return sum(x["launches"].get(name, 0) for x in ranks)
    rows = [flash_row(types.SimpleNamespace(args=on_card("S1_call")),
                      launched("flash_attention"),
                      "tp_ssd S1 bf16 windowed prefill layer a rank, hymba-"
                      "1.5b on (1, 5), 4 x 640, 5 / 1 heads"),
            flash_bwd_row(on_card(f"S2_{arch}_step_call"),
                          launched("flash_attention_bwd"),
                          "tp_ssd S2 f32 train layer 0 (global) a rank, "
                          "hymba-1.5b on (1, 5), 4 x 640, 5 / 1 heads")]
    for row in rows:
        row["path"] = "tp_ssd"
        row["note"] = "; ".join(filter(None, [row.get("note"), (
            "the SSD heads split over a whole in_proj; launches: the tp_ssd "
            "path's over its 5 ranks (a rank of world 1: the prefills of "
            "S1's f32 and bf16 runs, S2's train step)")]))
    return rows


def placed_bytes_check(what: str, tensors, allocated: int,
                       census: int) -> dict:
    """The placed tensors' bytes equal the census's; the allocator's bytes
    for them exceed those by less than its rounding (ALLOC_SMALL a block
    up to 1 MiB, ALLOC_LARGE above)."""
    exact = sum(t.numel() * t.element_size() for t in tensors)
    slack = sum(ALLOC_SMALL if t.numel() * t.element_size() <= 1 << 20
                else ALLOC_LARGE for t in tensors)
    if exact != census or not 0 <= allocated - exact < slack:
        raise AssertionError(f"census {what}: {exact} bytes in "
                             f"{len(tensors)} tensors ({allocated} "
                             f"allocated), the census says {census}")
    return {"census_bytes": census, "tensor_bytes": exact,
            "allocated_bytes": allocated, "tensors": len(tensors)}


def census_grid() -> dict:
    """launch/dryrun.py's grid in this process: every (arch x shape) cell
    on both production meshes, and the ANNS cells; fails on a FAIL."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    recs = list(dryrun.grid()) + list(dryrun.grid(anns=True))
    secs = time.perf_counter() - t0
    status = [r["status"].split(":")[0].split("(")[0] for r in recs]
    counts = {k: status.count(k) for k in ("OK", "SKIP", "FAIL")}
    if counts["FAIL"] or sum(counts.values()) != len(recs):
        failed = [r["status"] for r in recs if "FAIL" in r["status"]]
        raise AssertionError(f"census grid: {counts}; failed: {failed[:3]}")
    return {**counts, "cells": len(recs), "seconds": secs,
            "records": {(r["mesh"], r["arch"], r["shape"]): r
                        for r in recs}}


def census_anns(dev, name: str, rows_out: list) -> dict:
    """One rank's share of ``name`` at the 16x16 mesh, drawn on the card
    from a seeded generator: the serve scan (``gather_pools`` and
    ``serve_scan``: ``l2_topk_masked``) and the whole assign scan
    (``assign_scan``: ``l2_topk`` a row chunk), launches counted; then
    each held to its plain version (serve on every query, assign on the
    first and the last chunk) and timed as a kernel row (appended to
    ``rows_out``)."""
    from repro_torch.core import distributed as pd
    from repro_torch.kernels import l2_topk, ops
    from repro_torch.launch import dryrun
    spec = dryrun.ANNS_CELLS[name]
    serve = dryrun.census_anns_cell(name, False, "serve")
    assign = dryrun.census_anns_cell(name, False, "assign")
    z, d, nq, k = serve["blocks"], spec["d"], spec["q"], spec["k"]
    g = torch.Generator(device=dev).manual_seed(CENSUS_SEED)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    q = torch.randn((nq, d), generator=g, device=dev)
    db = torch.randn((z["n_local"], d), generator=g, device=dev)
    rows = torch.randint(0, z["n_local"], (nq, z["rows"]), generator=g,
                         device=dev, dtype=torch.int32)
    placed_serve = torch.cuda.memory_allocated() - before
    res = torch.randn((z["res_local"], d), generator=g, device=dev)
    agg = torch.randn((z["agg_local"], d), generator=g, device=dev)
    placed_assign = torch.cuda.memory_allocated() - before - placed_serve
    r = {"name": name, "blocks": z, "d": d, "memory": {
        "serve": placed_bytes_check(
            f"{name} serve", (q, db, rows), placed_serve,
            serve["memory"]["argument_size_in_bytes"]),
        "assign": placed_bytes_check(
            f"{name} assign", (res, agg), placed_assign,
            assign["memory"]["argument_size_in_bytes"])}}

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    start.record()
    pools = pd.gather_pools(db, rows)
    d2, local = pd.serve_scan(q, pools, rows, k)
    end.record()
    torch.cuda.synchronize()
    r["serve_wall_s"], r["serve_ms"] = time.perf_counter() - t0, \
        start.elapsed_time(end)
    t0 = time.perf_counter()
    start.record()
    a_d2, a_local = pd.assign_scan(res, agg, dryrun.ASSIGN_K,
                                   dryrun.ROW_CHUNK)
    end.record()
    torch.cuda.synchronize()
    r["assign_wall_s"], r["assign_ms"] = time.perf_counter() - t0, \
        start.elapsed_time(end)
    r["launches"] = ops.launch_counts()
    chunks = z["res_local"] // dryrun.ROW_CHUNK
    if r["launches"]["l2_topk_masked"] != 1 \
            or r["launches"]["l2_topk"] != chunks:
        raise AssertionError(f"census {name}: launches {r['launches']}, "
                             f"want 1 l2_topk_masked and {chunks} l2_topk")

    w = min(k, z["rows"])
    want = l2_topk.l2_topk_masked_plain(q, pools, rows, k)
    r["serve_max_abs_err"] = compare(
        f"census {name} serve", (d2, local),
        tuple(t[:, :w] for t in want), exact=False,
        atol=norm_atol(q, pools.reshape(-1, d)))

    def plain_blocks(x, y, kk):
        parts = [l2_topk.l2_topk_plain(x[i:i + 512], y, kk)
                 for i in range(0, x.shape[0], 512)]
        return tuple(torch.cat(t) for t in zip(*parts))

    r["assign_max_abs_err"] = 0.0
    for lo in (0, (chunks - 1) * dryrun.ROW_CHUNK):
        hi = lo + dryrun.ROW_CHUNK
        r["assign_max_abs_err"] = max(r["assign_max_abs_err"], compare(
            f"census {name} assign chunk at {lo}",
            (a_d2[lo:hi], a_local[lo:hi]),
            plain_blocks(res[lo:hi], agg, dryrun.ASSIGN_K), exact=False,
            atol=norm_atol(res[lo:hi], agg)))
    # each scan against its bound (l2_masked_row's and l2_row's counts)
    out = nq * k * 8
    r["serve_bound_ms"] = max(
        (nq * d * 4 + pools.numel() * 4 + rows.numel() * 4 + out)
        / HBM_BYTES_PER_S, 4 * nq * z["rows"] * d / FP32_OPS_PER_S) * 1e3
    n, m = z["res_local"], z["agg_local"]
    r["assign_bound_ms"] = max(
        ((n + m) * d * 4 + n * dryrun.ASSIGN_K * 8) / HBM_BYTES_PER_S,
        (2 * n * m * d + 2 * (n + chunks * m) * d + 4 * n * m)
        / FP32_OPS_PER_S) * 1e3

    del d2, local, a_d2, a_local, want
    res0 = res[:dryrun.ROW_CHUNK]

    def assign_library():
        d2 = torch.addmm((agg * agg).sum(-1)[None, :], res0, agg.T,
                         alpha=-2.0)
        d2.add_((res0 * res0).sum(-1)[:, None]).clamp_min_(0.0)
        return torch.topk(d2, dryrun.ASSIGN_K, dim=1, largest=False)

    for row in (l2_masked_row(q, pools, rows, k,
                              2 * r["launches"]["l2_topk_masked"],
                              f"census {name} serve scan"),
                l2_row(res0, agg, dryrun.ASSIGN_K,
                       2 * r["launches"]["l2_topk"],
                       f"census {name} assign chunk", plain=plain_blocks,
                       library=assign_library, plain_reps=1)):
        row["path"] = "census"
        row["note"] = (f"{name}'s rank share at 16x16 (d {d}); launches: "
                       f"the census path's, both 1B shares")
        rows_out.append(row)
    return r


class F32Layers:
    """A cache stack ``[L, ...]`` read one layer at a time in f32: the f32
    decode step beside a bf16 cache holds one layer's f32 copy at once."""

    def __init__(self, t: torch.Tensor):
        self.t, self.shape = t, t.shape

    def __getitem__(self, i):
        return self.t[i].float()


def census_long(dev, arch: str) -> dict:
    """``long_500k`` on one card (census mesh (1, 1)): the uncut model from
    a seed, a seeded cache of 524,288 slots (and the meta tokens') at
    B 1, a warm ``decode_step`` at position 524,287 and
    CENSUS_LONG_STEPS timed ones; the placed bytes against the census's
    ``port_argument_bytes`` and the parameters a decode never reads; the
    warm step's logits against the same step in f32 (the parameters cast,
    the cache cast a layer at a time)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun
    from repro_torch.models import model as lm
    cfg, shape = get_config(arch), SHAPES["long_500k"]
    rec = dryrun.lm_record(cfg, shape, MeshShape(("data", "model"), (1, 1)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = lm.init_params(cfg, CENSUS_SEED, dev)
    g = torch.Generator(device=dev).manual_seed(CENSUS_SEED)
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device=dev)
    for key, c in cache.items():   # keys, values, SSD states and windows
        c.normal_(0.0, 0.1 if key == "h" else 1.0, generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1),
                           generator=g, device=dev, dtype=torch.int32)
    cur_pos = torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=dev)
    # the census counts the parameters a decode reads (hymba's meta
    # tokens are a prefill's); the model holds them all
    unread = sum(p.numel() * p.element_size()
                 for n, p in model.named_parameters()
                 if dryrun.unread_in_decode(n))
    torch.cuda.synchronize()
    r = {"arch": arch, "memory": placed_bytes_check(
        f"{arch} long_500k", [*model.parameters(), *cache.values(), tokens,
                              cur_pos],
        torch.cuda.memory_allocated() - before,
        rec["port_argument_bytes"] + unread),
        "census": {k: rec[k] for k in ("memory", "port_argument_bytes",
                                       "cost")}}
    state = {k: cache[k].clone() for k in ("h", "conv") if k in cache}
    pos = shape.seq_len - 1
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        first = lm.decode_step(model, tokens, cache, pos, cfg)[0]
        torch.cuda.synchronize()
        r["warm_s"] = time.perf_counter() - t0
        walls = []
        for _ in range(CENSUS_LONG_STEPS):
            t0 = time.perf_counter()
            lm.decode_step(model, tokens, cache, pos, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        r["step_walls_s"] = walls
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        for k, v in state.items():   # the warm step's states again
            cache[k].copy_(v)
        del state
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        m32 = lm.LM(cfg32, dev)
        for p32, p in zip(m32.parameters(), model.parameters()):
            p32.copy_(p)
        want = lm.decode_step(m32, tokens,
                              {k: F32Layers(c) for k, c in cache.items()},
                              pos, cfg32)[0]
    v = cfg.vocab_size
    r["logits_max_abs_err_vs_f32"] = float(
        (first[..., :v].float() - want[..., :v]).abs().max())
    if not torch.isfinite(first[..., :v]).all() \
            or r["logits_max_abs_err_vs_f32"] > RAG_LOGITS_ATOL:
        raise AssertionError(f"census {arch} long_500k: bf16 logits off the "
                             f"f32 step by {r['logits_max_abs_err_vs_f32']}")
    cache_bytes = sum(c.numel() * c.element_size() for c in cache.values())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    r.update(cache_gib=cache_bytes / 2 ** 30, param_gib=param_bytes / 2 ** 30,
             bound_ms=(cache_bytes + param_bytes) / HBM_BYTES_PER_S * 1e3,
             slots=cache["k"].shape[2] if "k" in cache else 0)
    del model, m32, cache, first, want, cur_pos
    torch.cuda.empty_cache()
    return r


def census(dev, rows_out: list) -> dict:
    """The census path: the grid, the two 1B rank shares (their kernel
    launches counted from 0 around their scans alone), the long_500k
    decodes."""
    out = {}
    with phase("census: the grid (10 archs x 4 shapes x 2 meshes, ANNS "
               "3 x 2 x 2) in process"):
        out["grid"] = census_grid()
    with phase("census: one rank's share of anns-bigann-1b and "
               "anns-deep-1b at 16x16 (serve and assign scans, checks, "
               "kernel rows)"):
        out["anns"] = [census_anns(dev, name, rows_out)
                       for name in CENSUS_ANNS]
    with phase("census: long_500k decode on one card (mamba2-370m, "
               "hymba-1.5b)"):
        out["long"] = [census_long(dev, arch) for arch in CENSUS_LONG]
    return out


def report_census(r: dict, card: str) -> None:
    """The census path's numbers, each on its own line, then one JSON
    line."""
    grid = r["grid"]
    print(f"census grid: {grid['OK']} OK, {grid['SKIP']} SKIP, "
          f"{grid['FAIL']} FAIL of {grid['cells']} cells in "
          f"{grid['seconds']:.3f} s ({card})")
    for a in r["anns"]:
        print(f"census {a['name']} (d {a['d']}, blocks {a['blocks']}): "
              f"serve scan {a['serve_wall_s'] * 1e3:.3f} ms wall / "
              f"{a['serve_ms']:.4f} ms device (bound "
              f"{a['serve_bound_ms']:.4f}); assign scan "
              f"{a['assign_wall_s']:.3f} s wall / {a['assign_ms']:.2f} ms "
              f"device (bound {a['assign_bound_ms']:.2f}); launches "
              f"{a['launches']}; placed {a['memory']} ({card})")
    for x in r["long"]:
        print(f"census {x['arch']} long_500k: warm step {x['warm_s']:.4f} "
              f"s, steps {[round(w, 5) for w in x['step_walls_s']]} s "
              f"against a byte bound of {x['bound_ms']:.3f} ms (cache "
              f"{x['cache_gib']:.3f} GiB, parameters {x['param_gib']:.3f} "
              f"GiB); peak {x['peak_gib']:.3f} GiB; logits vs f32 "
              f"{x['logits_max_abs_err_vs_f32']:.4g}; placed "
              f"{x['memory']} ({card})")
    rep = {"card": card,
           "grid": {k: v for k, v in grid.items() if k != "records"},
           "anns": r["anns"], "long": r["long"]}
    print(f"census report: {json.dumps(rep)}", flush=True)


def pooled_route_rule(pairs, n_experts: int) -> dict:
    """``route_rule`` over several runs of calls (each a prefill or a
    decode step: (got calls, want calls)), pooled: the share of identical
    routes over all of them, every run's violations, each run's mask of
    the tokens whose routes agree at every layer."""
    reports = [route_rule(got, want, n_experts) for got, want in pairs]
    return {"routes": sum(rp["routes"] for rp, _ in reports),
            "identical": sum(rp["identical"] for rp, _ in reports),
            "agreement": sum(rp["identical"] for rp, _ in reports)
            / sum(rp["routes"] for rp, _ in reports),
            "violations": [v for rp, _ in reports for v in rp["violations"]],
            "runs": len(reports), "agree": [a for _, a in reports]}


def check_ep(r: dict, ref: dict, cfg) -> dict:
    """The ep path's gates. A: the 4 ranks' tokens bit for bit the same,
    and the warm generate's the cold one's; with the unsharded cold run's
    tokens fed (``forced_decode``, which on the unsharded side gives that
    run's own greedy tokens again), every rank's logits bit for bit the
    same, the routes of the prefill and every decode step under the route
    rule (ROUTE_AGREEMENT) against the unsharded cold run's, and the
    last-position logits of the prefill and of every decode step within
    RAG_LOGITS_ATOL of the unsharded model's on the sequences whose routes
    at that position agree at every layer (as the moe path holds them),
    at least one a step; the first MoE layer in f32 within EP_LAYER_RTOL
    of max |out| of the unsharded layer on the same input. Launches:
    exactly one ``flash_attention`` a layer and prefill on every rank."""
    ranks, n_layers = r["ranks"], cfg.n_layers
    out = {}
    gen = ranks[0]["A_gen"].numpy()
    out["A_tokens_identical_on_ranks"] = all(
        torch.equal(x["A_gen"], ranks[0]["A_gen"]) for x in ranks)
    out["A_warm_tokens_equal_cold"] = all(
        torch.equal(x["A_gen_warm"], x["A_gen"]) for x in ranks)
    want_gen = ref["gen"]
    out["A_generated_equal_unsharded"] = int((gen == want_gen).sum())
    out["A_generated_of"] = int(gen.size)
    vocab = cfg.vocab_size
    out["unsharded_forced_reproduces_its_tokens"] = bool(
        (ref["forced"][..., :vocab].argmax(-1).T.numpy()
         == want_gen[:, 1:]).all())
    out["A_forced_identical_on_ranks"] = all(
        torch.equal(x["A_forced"], ranks[0]["A_forced"]) for x in ranks)
    got_calls, want_calls = ranks[0]["A_routes"], ref["routes"]
    pairs = [(got_calls[n_layers * i:n_layers * (i + 1)],
              want_calls[n_layers * i:n_layers * (i + 1)])
             for i in range(MOE_NEW)]
    routes = pooled_route_rule(pairs, cfg.n_experts)
    out["A_routes"] = {k: v for k, v in routes.items() if k != "agree"}
    out["A_decode_steps_compared"] = len(pairs) - 1
    # the prefill's last position, then each decode step's one token
    agree = [routes["agree"][0].view(MOE_BATCH, MOE_PROMPT)[:, -1]] \
        + routes["agree"][1:]
    got = ranks[0]["A_forced"]
    want = torch.cat([ref["logits"][None], ref["forced"]])
    diff = (got[..., :vocab].float() - want[..., :vocab].float()).abs()\
        .amax(-1)                                           # [MOE_NEW, B]
    mask = torch.stack(agree).cpu()
    out["A_logits_max_abs"] = float(diff[mask].max()) if mask.any() else 0.0
    out["A_logits_max_abs_all"] = float(diff.max())
    out["A_logits_prefill_max_abs"] = float(diff[0][mask[0]].max()) \
        if mask[0].any() else 0.0
    out["A_logits_compared"] = [int(m.sum()) for m in mask]
    want = ref["layer_f32"]
    layer_err = [float((x["A_layer_f32"] - want).abs().max()) for x in ranks]
    out["A_layer_f32_max_abs"] = max(layer_err)
    out["A_layer_f32_bound"] = EP_LAYER_RTOL * float(want.abs().max())
    out["A_layer_f32_identical_on_ranks"] = all(
        torch.equal(x["A_layer_f32"], ranks[0]["A_layer_f32"])
        for x in ranks)
    # the cold, warm and fed prefills
    launches = 3 * n_layers
    out["launches_a_rank"] = [x["launches"]["flash_attention"]
                              for x in ranks]
    print(f"ep checks: {json.dumps(out)}", flush=True)
    bad = []
    if not out["A_tokens_identical_on_ranks"]:
        bad.append("A: ranks generated different tokens")
    if not out["A_warm_tokens_equal_cold"]:
        bad.append("A: the warm generate differs from the cold one")
    if not out["unsharded_forced_reproduces_its_tokens"]:
        bad.append("A: the unsharded model fed its tokens gives others")
    if not out["A_forced_identical_on_ranks"]:
        bad.append("A: ranks' logits differ with the tokens fed")
    if routes["agreement"] < ROUTE_AGREEMENT[MOE_ARCHS[0][0]] \
            or routes["violations"]:
        bad.append("A: routes break the route rule")
    if out["A_logits_max_abs"] > RAG_LOGITS_ATOL \
            or min(out["A_logits_compared"]) == 0:
        bad.append("A: prefill or decode logits off the unsharded model's")
    if out["A_layer_f32_max_abs"] > out["A_layer_f32_bound"]:
        bad.append("A: the f32 layer off the unsharded layer")
    for x in ranks:
        if x["launches"]["flash_attention"] != launches \
                or any(c for k, c in x["launches"].items()
                       if k != "flash_attention"):
            bad.append(f"rank {x['rank']} launches {x['launches']}")
    if bad:
        raise AssertionError(f"ep: {bad}")
    return out


def report_ep(r: dict, checks: dict, cfg, published_layers: int,
              card: str) -> None:
    """The ep path's numbers, each on its own line, then one JSON line:
    per rank its times, peak and the bytes moved a layer (a partial sum
    sends the rank's [T, d] and receives the other ranks' of its
    line)."""
    ranks = r["ranks"]
    d, el = cfg.d_model, torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    t_prefill = MOE_BATCH * MOE_PROMPT
    mp_a = EP_MESH[0][1]
    moved = {"A_partial_prefill_sent": t_prefill * d * el,
             "A_partial_prefill_received": (mp_a - 1) * t_prefill * d * el,
             "A_partial_decode_sent": MOE_BATCH * d * el}
    keys = ("A_init_s", "A_dispatch_prefill_ms", "A_products_prefill_ms",
            "A_dispatch_decode_ms", "A_products_decode_ms",
            "A_partial_sum_prefill_ms", "A_partial_sum_decode_ms",
            "A_peak_gib", "A_capacity_prefill", "A_capacity_decode")
    per_rank = []
    for x in ranks:
        row = {k: x[k] for k in keys}
        row.update({"rank": x["rank"], "launches": x["launches"],
                    "A_prefill_s": x["A_warm"]["prefill_s"],
                    "A_decode_step_s": x["A_warm"]["decode_s"]
                    / (MOE_NEW - 1), "A_cold": x["A_cold"]})
        per_rank.append(row)
        print(f"ep rank {x['rank']}: A prefill {row['A_prefill_s']:.4f} s, "
              f"decode step {row['A_decode_step_s'] * 1e3:.3f} ms (warm); "
              f"layer 0 alone: dispatch+products "
              f"{x['A_dispatch_prefill_ms']:.3f} ms (products "
              f"{x['A_products_prefill_ms']:.3f}) prefill, "
              f"{x['A_dispatch_decode_ms']:.3f} ms decode; partial sum "
              f"{x['A_partial_sum_prefill_ms']:.3f} / "
              f"{x['A_partial_sum_decode_ms']:.3f} ms; peak "
              f"{x['A_peak_gib']:.3f} GiB ({card})")
    print(f"ep bytes moved a layer and rank: {json.dumps(moved)}")
    rep = {"card": card, "arch": MOE_ARCHS[0][0],
           "reduced": {"n_layers": [published_layers, cfg.n_layers]},
           "mesh": EP_MESH, "backend": "gloo",
           "ranks_on_one_card": EP_RANKS, "batch": MOE_BATCH,
           "prompt_len": MOE_PROMPT, "new_tokens": MOE_NEW,
           "bytes_moved_a_layer": moved, "per_rank": per_rank,
           "ranks_s": r["ranks_s"], **checks}
    print(f"ep report: {json.dumps(rep)}", flush=True)


def device_split(fn, reps: int, names, tries: int = 4) -> dict | None:
    """The device time of one call of ``fn()`` by kernel, from
    ``torch.profiler`` over ``reps`` calls: for each kernel whose name
    contains one of ``names``, the median duration of its recorded
    launches in ms (each call launches each of them once). Late in a long
    process the profiler can drop a session's kernel records, or keep some
    with wrong durations, so the median is taken over the records kept,
    and a session that kept none is run again, up to ``tries`` sessions;
    None if none kept one."""
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name: dict = {}
        for e in kernels:
            if any(n in e.name for n in names) and e.device_time > 0:
                by_name.setdefault(e.name, []).append(e.device_time)
        if by_name:
            return {n: float(np.median(t)) / 1e3 for n, t in by_name.items()}
        seen = sorted({e.name[:60] for e in kernels})[:4]
    print(f"device_ms: no {names} kernel in {tries} profiler sessions "
          f"(recorded: {seen})", flush=True)
    return None


def device_ms(fn, reps: int, names, tries: int = 4) -> float | None:
    """``device_split``'s times summed: the device time of one call."""
    split = device_split(fn, reps, names, tries)
    return None if split is None else sum(split.values())


def kernel_report(name, fn, plain, library, args, launches, nbytes, n_ops,
                  source, replaces, check, shape, device_names,
                  ops_per_s=FP32_OPS_PER_S, plain_reps: int = 5) -> dict:
    """Times one kernel on captured path inputs beside its plain version,
    a library formulation and its bound (operations at ``ops_per_s``);
    ``check(got, want)`` holds the kernel to the plain version and
    returns the max abs error. ``ms`` is the event time of back-to-back
    wrapper calls (host time included where it is longer), ``device_ms``
    the profiler's time of the kernels named ``device_names`` alone."""
    err = check(fn(*args), plain(*args))
    ms = cuda_time_ms(lambda: fn(*args), reps=20)
    split = device_split(lambda: fn(*args), 20, device_names)
    dev_ms = None if split is None else sum(split.values())
    plain_ms = cuda_time_ms(lambda: plain(*args), reps=plain_reps)
    library_ms = cuda_time_ms(library, reps=10)
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": n_ops / ops_per_s * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms,
            "device_ms_by_kernel": {n[:60]: t for n, t in (split or {}).items()},
            "plain_ms": plain_ms,
            "bound_ms": bound[bound_by], "bound_by": bound_by,
            "library_ms": library_ms, "shape": shape}


def check_flash_bwd_deterministic(*args, **mask) -> None:
    """Two backward calls on the same inputs (and mask: ``causal``,
    ``window``, ``meta_tokens``) give bit-identical dq, dk and dv: the
    kernels sum each element in one order, with no atomics."""
    from repro_torch.kernels import flash_attention as fa
    first = fa.flash_attention_bwd(*args, **mask)
    second = fa.flash_attention_bwd(*args, **mask)
    for part, x, y in zip(("dq", "dk", "dv"), first, second):
        if not torch.equal(x.view(torch.int16), y.view(torch.int16)):
            raise AssertionError(f"flash_attention_bwd: two calls give "
                                 f"different {part} ({mask})")
    print(f"flash_attention_bwd: two calls bit-identical {mask} at "
          f"{list(args[0].shape)} x {list(args[1].shape)}", flush=True)


def flash_bwd_row(call, launches: int, what: str) -> dict:
    """The kernel row of ``flash_attention_bwd`` on a training layer's
    ``flash_attention`` call, ``((q, k, v), kw)`` as a ``Capture`` keeps it
    (a train path's, step 0), under the call's own mask (``kw``'s causal or
    full, window and meta tokens), with the kernel forward's (lse, f32
    output) and a seeded dO; the library time is the backward of
    ``scaled_dot_product_attention`` (GQA; no mask for full attention,
    ``is_causal`` for causal at Sq = Sk, else the boolean mask as
    ``attn_mask``) on the same inputs."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    (q, k, v), kw = call
    mask = attention_mask(kw)
    (b, sq, h, d), (sk, kvh) = q.shape, k.shape[1:3]
    _, lse, out = fa.flash_attention(q, k, v, return_lse=True, **mask)
    gen = torch.Generator(q.device).manual_seed(1)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    check_flash_bwd_deterministic(q, k, v, out, lse, dout, **mask)
    hidden = fa._hidden(sq, sk, q.device, **mask)
    pairs = b * h * (sq * sk if hidden is None else int((~hidden).sum()))
    # S = q.k and dP = dO.v recomputed, then dV, dQ and dK: five products
    # of 2 D FLOPs per unmasked pair
    n_ops = 10 * d * pairs
    # q, dO, dQ and k, v, dK, dV in the inputs' dtype; the f32 O, lse and
    # delta
    nbytes = (3 * b * sq * h + 4 * b * sk * kvh) * d * q.element_size() \
        + b * sq * h * d * 4 + 2 * b * h * sq * 4
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    library = dict(attn_mask=~hidden) if hidden is not None and (
        mask["window"] or sq != sk) else dict(is_causal=mask["causal"])
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **library)
    dout_t = dout.transpose(1, 2)
    row = kernel_report(
        "flash_attention_bwd",
        lambda *a: fa.flash_attention_bwd(*a, **mask),
        lambda *a: fa.flash_attention_bwd_plain(*a, **mask),
        lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dout_t,
                                    retain_graph=True),
        (q, k, v, out, lse, dout), launches,
        nbytes=nbytes, n_ops=n_ops,
        ops_per_s=FP32_OPS_PER_S if q.dtype == torch.float32
        else BF16_OPS_PER_S,
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:136",
        check=lambda got, want: flash_bwd_check(got, want, what),
        shape={"B": b, "Sq": sq, "Sk": sk, "H": h, "KVH": kvh, "D": d,
               **mask, "dtype": str(q.dtype)},
        device_names=("bwd_delta", "bwd_dkdv", "bwd_dq"))
    row["note"] = ("counterpart of the reference's jnp custom_vjp backward, "
                   "not of a pallas_call; library: the backward of "
                   "scaled_dot_product_attention"
                   + (" with the boolean mask" if "attn_mask" in library
                      else ""))
    return row


def flash_row(cap, launches: int, what: str) -> dict:
    """The kernel row of ``flash_attention`` on the inputs ``cap`` kept
    (a path's prefill layer) beside its plain version and
    ``scaled_dot_product_attention`` (GQA; causal, or with a sliding
    window the boolean mask as ``attn_mask``, the one library call
    computing the same function)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    (q, k, v), kw = cap.args
    causal = kw["causal"]
    mask = dict(window=kw.get("window", 0),
                meta_tokens=kw.get("meta_tokens", 0))
    (b, sq, h, d), (sk, kvh) = q.shape, k.shape[1:3]
    # (query, key) pairs the mask lets through, the row at p = r + Sk - Sq
    # seeing keys j <= p, and with a window j > p - window or j < meta
    pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    key = torch.arange(sk, device=q.device)[None, :]
    seen = (key <= pos) if causal else torch.ones_like(key <= pos)
    if mask["window"]:
        seen &= (key > pos - mask["window"]) | (key < mask["meta_tokens"])
    pairs = b * h * int(seen.sum())
    n_ops = 4 * d * pairs   # q.k and p.v, a multiply and an add each
    library = dict(attn_mask=seen) if mask["window"] \
        else dict(is_causal=causal)
    row = kernel_report(
        "flash_attention",
        lambda *a: fa.flash_attention(*a, causal=causal, **mask),
        lambda *a: fa.flash_attention_plain(*a, causal=causal, **mask),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True, **library),
        (q, k, v), launches,
        nbytes=(2 * b * sq * h + 2 * b * sk * kvh) * d
        * q.element_size(),
        n_ops=n_ops, ops_per_s=BF16_OPS_PER_S,
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:68",
        check=lambda got, want: flash_check(got, want, what),
        shape={"B": b, "Sq": sq, "Sk": sk, "H": h, "KVH": kvh, "D": d,
               "causal": causal, **mask, "dtype": str(q.dtype)},
        device_names=("flash_fwd",))
    # the reference fixes f32 scores; on the f32 CUDA cores the same
    # work takes this long at the least
    row["bound_f32_cores_ms"] = n_ops / FP32_OPS_PER_S * 1e3
    return row


def l2_masked_row(q, pools, ids, k, launches, what) -> dict:
    """The l2_topk_masked row on these inputs."""
    from repro_torch.kernels import l2_topk
    real = int((ids >= 0).sum())
    qn, c, d = pools.shape

    def library():
        xn = torch.einsum("qcd,qcd->qc", pools, pools)
        d2 = torch.baddbmm((xn + (q * q).sum(-1)[:, None])[:, :, None],
                           pools, q[:, :, None], alpha=-2.0)[:, :, 0]
        d2 = d2.clamp_min_(0.0).masked_fill_(ids < 0, INF)
        # a pool narrower than k (the pod path's 32) has min(k, C) to give
        return torch.topk(d2, min(k, c), dim=1, largest=False)

    return kernel_report(
        "l2_topk_masked", lambda *a: l2_topk.l2_topk_masked(*a, k=k),
        lambda *a: l2_topk.l2_topk_masked_plain(*a, k=k), library,
        (q, pools, ids), launches,
        nbytes=qn * d * 4 + qn * c * 4 + real * d * 4 + qn * k * 8,
        n_ops=real * d * 4,
        source="src/repro_torch/kernels/csrc/l2_topk_masked.cu",
        replaces="src/repro/kernels/l2_topk.py:138",
        check=lambda got, want: compare(
            what, got, want, exact=False,
            atol=norm_atol(q, pools.reshape(-1, d))),
        shape={"Q": qn, "C": c, "real_rows": real, "d": d, "k": k},
        device_names=("l2_topk_masked_kernel",))


def l2_row(q, x, k, launches, what, plain=None, library=None,
           plain_reps=5) -> dict:
    """The l2_topk row on these inputs (plain: ``l2_topk_plain`` unless
    given; library: cdist2 and topk unless given)."""
    from repro_torch.core.distances import cdist2
    from repro_torch.kernels import l2_topk
    (qn, d), n = q.shape, x.shape[0]
    return kernel_report(
        "l2_topk", l2_topk.l2_topk, plain or l2_topk.l2_topk_plain,
        library or (lambda: torch.topk(cdist2(q, x), k, dim=1,
                                       largest=False)),
        (q, x, k), launches, plain_reps=plain_reps,
        nbytes=(qn + n) * d * 4 + qn * k * 8,
        # q.x for every pair, both norms, the combine and clamp
        n_ops=2 * qn * n * d + 2 * (qn + n) * d + 4 * qn * n,
        source="src/repro_torch/kernels/csrc/l2_topk.cu",
        replaces="src/repro/kernels/l2_topk.py:70",
        check=lambda got, want: compare(what, got, want, exact=False,
                                        atol=norm_atol(q, x)),
        shape={"Q": qn, "N": n, "d": d, "k": k},
        device_names=("l2_topk_scan", "l2_topk_merge"))


def pod_kernel_rows(counts: dict, dev) -> list:
    """The two kernels at the pod path's shapes, on rank 0's inputs drawn
    again from the seed: its serve scan, and its assign step's first row
    chunk against its aggregation block. The plain l2_topk runs in blocks
    of 512 queries (its sort of the whole [4096, 983,040] would take ~64
    GB at once); the library formulation takes one [4096, 983,040]
    buffer. ``counts``: the pod path's launches."""
    from repro_torch.core import distributed as pd
    from repro_torch.kernels import l2_topk
    queries, ids = pod_block("queries", 0, dev), pod_block("rows", 0, dev)
    rows = [l2_masked_row(queries, pd.gather_pools(
        pod_block("db", 0, dev), ids), ids, POD_K, counts["l2_topk_masked"],
        "pod serve scan")]
    res = pod_block("res", 0, dev)[:POD_ROW_CHUNK]
    agg = pod_block("agg", 0, dev)

    def plain_blocks(q, x, k):
        parts = [l2_topk.l2_topk_plain(q[i:i + 512], x, k)
                 for i in range(0, q.shape[0], 512)]
        return tuple(torch.cat(t) for t in zip(*parts))

    def assign_library():
        d2 = torch.addmm((agg * agg).sum(-1)[None, :], res, agg.T,
                         alpha=-2.0)
        d2.add_((res * res).sum(-1)[:, None]).clamp_min_(0.0)
        return torch.topk(d2, POD_ASSIGN_K, dim=1, largest=False)

    rows.append(l2_row(res, agg, POD_ASSIGN_K, counts["l2_topk"],
                       "pod assign chunk", plain=plain_blocks,
                       library=assign_library, plain_reps=1))
    for r in rows:
        r["path"] = "pod"
        r["note"] = ("launches: the pod path's, over its 4 ranks (1 "
                     "l2_topk_masked and 19 l2_topk a rank); timed on rank "
                     "0's inputs with the card to itself")
    return rows


def time_kernels(caps, counts) -> list:
    """One row per kernel at the shapes its path gave it. ``caps`` and
    ``counts`` map each kernel to its captured inputs and to the launch
    counts of the path they came from."""
    from repro_torch.kernels import pq_adc
    rows = []

    (q, pools, ids), kw = caps["l2_topk_masked"].args
    rows.append(l2_masked_row(q, pools, ids, kw["k"],
                              counts["l2_topk_masked"]["l2_topk_masked"],
                              "main path"))

    (luts, codes, pos), kw = caps["pq_adc_masked"].args
    k = kw["k"]
    real = int((pos >= 0).sum())
    qn, c, m = codes.shape

    def adc_masked_library():
        d2 = torch.gather(luts, 2, codes.long().transpose(1, 2)).sum(1)
        return torch.topk(d2.masked_fill_(pos < 0, INF), k, dim=1,
                          largest=False)

    rows.append(kernel_report(
        "pq_adc_masked", lambda *a: pq_adc.pq_adc_masked(*a, k=k),
        lambda *a: pq_adc.pq_adc_masked_plain(*a, k=k), adc_masked_library,
        (luts, codes, pos), counts["pq_adc_masked"]["pq_adc_masked"],
        nbytes=qn * m * 256 * 4 + qn * c * 4 + real * m + qn * k * 8,
        n_ops=real * m,
        source="src/repro_torch/kernels/csrc/pq_adc_masked.cu",
        replaces="src/repro/kernels/pq_adc.py:100",
        check=lambda got, want: compare("main path", got, want,
                                        exact=False, atol=1e-4),
        shape={"Q": qn, "C": c, "real_rows": real, "M": m, "k": k},
        device_names=("pq_adc_masked_kernel",)))

    # SPANN's closure assignment (13 of the compare path's launches), then
    # the main path's ground-truth chunk
    rows.append(l2_row(*caps["l2_topk_closure"].args[0],
                       counts["l2_closure"]["l2_topk"],
                       "SPANN closure chunk"))
    rows.append(l2_row(*caps["l2_topk"].args[0], counts["l2_topk"]["l2_topk"],
                       "ground-truth chunk"))

    (luts, table, node_ids, offsets), _ = caps["pq_adc_rows"].args
    qn, m = luts.shape[:2]
    t_count = node_ids.shape[0]

    def rows_check(got, want):
        if not torch.equal(got, want):   # same summation order
            raise AssertionError("pq_adc_rows: the DiskANN wave disagrees")
        return 0.0

    def rows_library():
        seg = torch.repeat_interleave(
            torch.arange(qn, device=luts.device),
            (offsets[1:] - offsets[:-1]).long(), output_size=t_count)
        flat = (seg[:, None] * m + torch.arange(m, device=luts.device)) \
            * 256 + table[node_ids.long()].long()
        return luts.view(-1)[flat].sum(1)

    # the bytes the wave must move: ids, offsets and outputs, and each
    # table row and LUT entry it touches, once
    lens = np.diff(offsets.cpu().numpy())
    seg = np.repeat(np.arange(qn), lens)
    codes = table[node_ids.long()].long().cpu().numpy()
    lut_entries = np.unique((seg[:, None] * m + np.arange(m)) * 256 + codes)
    nbytes = (2 * t_count + qn + 1) * 4 \
        + len(np.unique(node_ids.cpu().numpy())) * m + len(lut_entries) * 4
    rows.append(kernel_report(
        "pq_adc_rows", pq_adc.pq_adc_rows, pq_adc.pq_adc_rows_plain,
        rows_library, (luts, table, node_ids, offsets),
        counts["pq_adc_rows"]["pq_adc_rows"], nbytes=nbytes,
        n_ops=t_count * m, source="src/repro_torch/kernels/csrc/pq_adc.cu",
        replaces="src/repro/kernels/pq_adc.py:44", check=rows_check,
        shape={"Q": qn, "T": t_count, "M": m, "segments": int((lens > 0)
                                                               .sum()),
               "lut_entries": len(lut_entries),
               "staged": t_count >= pq_adc.STAGE_ROWS * qn},
        device_names=("pq_adc_rows_kernel",)))

    rows.append(flash_row(caps["flash_attention"],
                          counts["flash_attention"]["flash_attention"],
                          "first prefill layer"))
    rows.append(flash_bwd_row(caps["flash_attention_bwd"].args,
                              counts["flash_attention_bwd"]
                              ["flash_attention_bwd"], "train layer 0"))
    for r, path in zip(rows, ("main", "main", "compare", "main", "compare",
                              "rag", "train")):
        r["path"] = path
    # the moe path's first prefill layers: DBRX-132B (D 128, 48 / 8 heads)
    # and Kimi-K2 (D 112, 64 / 8)
    for arch, _ in MOE_ARCHS:
        rows.append(flash_row(caps[f"flash_attention:{arch}"],
                              counts[f"moe:{arch}"]["flash_attention"],
                              f"{arch} first prefill layer"))
        rows[-1]["path"] = "moe"
    rows[-2]["note"] = ("the ep path runs DBRX-132B's prefill layers at this "
                        "shape on each of its 4 ranks: its launches are "
                        "launches_by_path['ep']")
    # the hybrid path's first windowed prefill layer (layer 1) and its
    # first global one (layer 0): hymba-1.5b, 25 / 5 heads, D 64
    for kind in ("windowed", "global"):
        rows.append(flash_row(caps[f"flash_attention:hybrid {kind}"],
                              counts["hybrid"]["flash_attention"],
                              f"hymba-1.5b {kind} prefill layer"))
        rows[-1]["path"] = "hybrid"
        rows[-1]["note"] = ("launches: the hybrid path's, 29 windowed and 3 "
                            "global layers a prefill; the window and meta "
                            "tokens are the mask of the reference's jnp "
                            "attention, src/repro/models/attention.py:50")
    # whisper-small's encoder layer and cross-attention (full attention),
    # internvl2-76b's first prefill layer (causal, D 128, G 8)
    for key, what, path in (
            ("audio encoder", "whisper-small encoder layer", "audio"),
            ("audio cross", "whisper-small cross-attention layer", "audio"),
            ("vlm", "internvl2-76b prefill layer", "vlm")):
        rows.append(flash_row(caps[f"flash_attention:{key}"],
                              counts[path]["flash_attention"], what))
        rows[-1]["path"] = path
    rows[-2]["note"] = rows[-3]["note"] = (
        "launches: the audio path's, 36 a prefill: 12 encoder layers, 12 "
        "decoder self-attention (causal, 64 x 64), 12 cross-attention")
    # the long_train path's first windowed layer (layer 1, step 0):
    # hymba-1.5b's attention backward under the window and meta tokens
    rows.append(flash_bwd_row(
        caps["flash_attention_bwd:hybrid windowed"].args,
        counts["long_train:hymba-1.5b"]["flash_attention_bwd"],
        "hymba-1.5b windowed train layer"))
    rows[-1]["path"] = "long_train"
    rows[-1]["note"] += ("; launches: the long_train path's on hymba-1.5b, "
                         "one a layer and step (29 windowed, 3 global)")
    # the audio_train and vlm_train paths' layers (step 0): the backward
    # at whisper-small's encoder layer (full, 1500 x 1500) and
    # cross-attention (full, 448 x 1500) and at internvl2-76b's layer
    # (causal, D 128, G 8); the forward at the two train shapes the serve
    # rows do not have (whisper's encoder at B 16, internvl2's at B 4 x
    # 1024)
    for tag, what in (("audio_train", "encoder layer 0"),
                      ("audio_train", "decoder layer 0 cross-attention"),
                      ("vlm_train", "layer 0")):
        rows.append(flash_bwd_row(caps[f"{tag}:{what}"].args,
                                  counts[tag]["flash_attention_bwd"],
                                  f"{tag} {what}"))
        rows[-1]["path"] = tag
    for tag, what in (("audio_train", "encoder layer 0"),
                      ("vlm_train", "layer 0")):
        rows.append(flash_row(caps[f"{tag}:{what}"],
                              counts[tag]["flash_attention"],
                              f"{tag} {what}"))
        rows[-1]["path"] = tag
    for r in rows[-5:]:
        r["note"] = "; ".join(filter(None, [r.get("note"), (
            "launches: the path's over its steps, a step 72 forward and "
            "36 backward on whisper-small (12 encoder layers, 12 decoder "
            "self-attention, 12 cross-attention; each forward twice, "
            "remat), 12 and 6 on internvl2-76b (6 layers)")]))

    # the dp_train path's layer 0 on a rank (step 0): TinyLlama-1.1B at 4
    # x 2048 (T1), DBRX-132B at 4 x 512 (T2, D 128, 48 / 8 heads)
    for tag, what in (("T1", "tinyllama-1.1b layer 0, 4 x 2048 a rank"),
                      ("T2", "dbrx-132b layer 0, 4 x 512 a rank")):
        cap = caps[f"dp_train:{tag}"]
        rows.append(flash_row(cap, counts["dp_train"]["flash_attention"],
                              f"dp_train {what}"))
        rows.append(flash_bwd_row(cap.args,
                                  counts["dp_train"]["flash_attention_bwd"],
                                  f"dp_train {what}"))
        for r in rows[-2:]:
            r["path"] = "dp_train"
            r["note"] = "; ".join(filter(None, [r.get("note"), (
                f"{what}; launches: the dp_train path's over both ranks and "
                f"both phases (a rank and step: T1 4 forward and 2 "
                f"backward, 2 layers with remat; T2 2 and 1)")]))

    # the tp path's layer 0 on a rank of phase A (bf16): TinyLlama-1.1B's
    # heads split over 4 ranks, 4 x 512, 8 query heads and 1 kv head
    rows.append(flash_row(caps["tp"], counts["tp"]["flash_attention"],
                          "tp phase A layer 0 a rank, 4 x 512, 8 / 1 heads"))
    rows[-1]["path"] = "tp"
    rows[-1]["note"] = ("launches: the tp path's over its 4 ranks (a rank: "
                        "22 a prefill in A's f32 and bf16 runs, 2 in B's "
                        "decode, 4 in B's train step and 2 in T3's, remat)")
    # the tp path's T3 on a rank, step 0's layer 0: DBRX-132B, a data
    # rank's 2 x 512 rows, 24 of 48 query heads and 4 of 8 kv heads
    what = "tp T3 dbrx-132b layer 0 a rank, 2 x 512, 24 / 4 heads"
    rows.append(flash_row(caps["tp T3"],
                          counts["tp T3"]["flash_attention"], what))
    rows.append(flash_bwd_row(caps["tp T3"].args,
                              counts["tp T3"]["flash_attention_bwd"], what))
    for r in rows[-2:]:
        r["path"] = "tp"
        r["note"] = "; ".join(filter(None, [r.get("note"), (
            f"{what}; launches: T3's over the 4 ranks (a rank: 2 forward, "
            f"the step's and its remat, and 1 backward)")]))
    rows += pod_kernel_rows(counts["pod"], caps["l2_topk"].args[0][0]
                            .device)
    return rows


def report_rag(r: dict, checks: dict) -> None:
    """The rag path's numbers, each on its own line, then one JSON line."""
    cfg, warm = r["cfg"], r["timing"]["warm"]
    n_tok = RAG_BATCH * RAG_NEW
    total = warm["prefill_s"] + warm["decode_s"]
    # the prefill's model FLOPs: every weight but the embedding lookup in
    # one multiply-add per token, and causal attention's q.k and p.v
    matmul_params = cfg.param_count() - (0 if cfg.tie_embeddings
                                         else cfg.vocab_padded * cfg.d_model)
    prefill_flops = (2 * matmul_params * RAG_BATCH * RAG_PROMPT
                     + cfg.n_layers * 4 * cfg.resolved_head_dim * cfg.n_heads
                     * RAG_BATCH * RAG_PROMPT * (RAG_PROMPT + 1) // 2)
    rep = {"arch": RAG_ARCH, "batch": RAG_BATCH, "prompt_len": RAG_PROMPT,
           "new_tokens": RAG_NEW, "timing": r["timing"],
           "tokens_per_s": n_tok / total,
           "decode_tokens_per_s": RAG_BATCH * (RAG_NEW - 1)
           / warm["decode_s"],
           "prefill_tokens_per_s": RAG_BATCH * RAG_PROMPT
           / warm["prefill_s"],
           "prefill_model_tflops_per_s": prefill_flops / warm["prefill_s"]
           / 1e12,
           "retrieved_ids_0": r["retrieved"][0].tolist(),
           "first_generated_ids_0": r["gen"][0, :10].tolist(), **checks}
    print(f"rag prefill seconds (warm, to first tokens on the host): "
          f"{warm['prefill_s']:.4f}")
    print(f"rag decode seconds (warm, {RAG_NEW - 1} steps): "
          f"{warm['decode_s']:.4f}")
    print(f"rag tokens per second (warm, {n_tok} new tokens over prefill "
          f"and decode): {rep['tokens_per_s']:.1f}")
    print(f"rag first generated ids of request 0: "
          f"{rep['first_generated_ids_0']}")
    print(f"rag profile: {json.dumps(r['profile'])}")
    print(f"rag report: {json.dumps(rep)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda", 0)
    with phase("device"):
        card = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
    with phase("build"):
        secs = build.build_all()
        print(f"nvcc build seconds: {json.dumps(secs)}")
    with phase("kernels vs plain (edge cases, exact ties)"):
        check_flash_tensor_cores()
        check_kernel_edges(dev)
    with phase("REDUCED prefills vs plain attention"):
        check_reduced_prefills(dev)

    counts = {}

    @contextlib.contextmanager
    def path(name: str, kernels, part: str = ""):
        """Counts every launch of one path (from 0; a path run in parts,
        one ``part`` at a time, adds them up) and fails if one of its
        kernels was launched no time on it (on this part)."""
        ops.reset_launch_counts()
        yield
        got = ops.launch_counts()
        counts[name] = {k: counts.get(name, {}).get(k, 0) + c
                        for k, c in got.items()}
        print(f"[launches] {name}{part}: {json.dumps(got)}", flush=True)
        missing = [k for k in kernels if got[k] == 0]
        if missing:
            raise AssertionError(f"{name}{part}: not launched: {missing}")

    serve_kernels = ("l2_topk", "l2_topk_masked", "pq_adc_masked")
    # rerank_k=32 (the search default) beside 64: the PQ gap it leaves
    # is why SEARCH_ARGS takes 64
    with path("quality", serve_kernels):
        _, quality_index = index_and_serve(
            "quality", QUALITY_N, QUALITY_QUERIES, QUALITY_FLOOR, dev,
            other_rerank=(32,))

    # the first prefill layer's attention
    caps = {"flash_attention": Capture(ops, "flash_attention",
                                       lambda a, kw: True)}
    with path("rag", ("flash_attention", "l2_topk_masked")), \
            caps["flash_attention"]:
        rag_run = rag(dev, quality_index)
    if counts["rag"]["flash_attention"] < 3 * rag_run["cfg"].n_layers:
        raise AssertionError("rag: fewer flash_attention launches than "
                             "layers in the three prefills")
    with phase("rag: checks (prefill vs plain attention, decode vs "
               "forward)"):
        rag_checks = check_rag(rag_run)
    report_rag(rag_run, rag_checks)
    del rag_run, quality_index
    torch.cuda.empty_cache()

    # one arch at a time, each freed before the next; the first prefill
    # layer's attention of each
    moe_launches = {}
    for arch, depth in MOE_ARCHS:
        cap = caps[f"flash_attention:{arch}"] = Capture(
            ops, "flash_attention", lambda a, kw: True)
        with path("moe", ("flash_attention",), f" ({arch})"), cap:
            moe_run = moe_serve(dev, arch, depth)
        moe_launches[f"moe:{arch}"] = ops.launch_counts()
        launched = moe_launches[f"moe:{arch}"]["flash_attention"]
        if launched < 3 * depth:
            raise AssertionError(f"moe {arch}: fewer flash_attention "
                                 f"launches than layers in the three "
                                 f"prefills")
        with phase(f"moe: {arch} checks (prefill vs plain attention and "
                   f"bit for bit, first decode step vs plain prefill, "
                   f"routes)"):
            moe_checks = check_moe(moe_run)
        report_moe(moe_run, moe_checks, launched)
        if arch == MOE_ARCHS[0][0]:
            with phase(f"moe: {arch} unsharded side of the ep path"):
                ep_ref = ep_reference(moe_run)
                ep_cfg = moe_run["cfg"]
                ep_published = moe_run["published_layers"]
        del moe_run
        torch.cuda.empty_cache()
    with path("moe_train", ("flash_attention", "flash_attention_bwd")), \
            phase("moe: REDUCED train steps"):
        moe_train(dev)

    # mamba2-370m runs no kernel (attention-free); hymba-1.5b's prefill
    # runs flash_attention in each layer, windowed but on its global
    # layers. The first call of each mask is kept for the kernel rows
    for tag, arch in LONG_PATHS:
        kernels = ("flash_attention",) if tag == "hybrid" else ()
        long_caps = [Capture(ops, "flash_attention",
                             lambda a, kw, wide=wide: (kw.get("window", 0)
                                                       > 0) == wide)
                     for wide in (True, False)]
        with path(tag, kernels), long_caps[0], long_caps[1]:
            long_run = long_serve(dev, tag, arch)
        launched = counts[tag]["flash_attention"]
        if tag == "hybrid":
            caps["flash_attention:hybrid windowed"] = long_caps[0]
            caps["flash_attention:hybrid global"] = long_caps[1]
            if launched < 3 * long_run["cfg"].n_layers:
                raise AssertionError("hybrid: fewer flash_attention "
                                     "launches than layers in the three "
                                     "prefills")
        with phase(f"{tag}: checks (prefills bit for bit, first decode step "
                   f"vs forward, plain attention / SSD recurrence)"):
            long_checks = check_long(long_run)
        print(card)
        report_long(long_run, long_checks, counts[tag])
        del long_run
        torch.cuda.empty_cache()

    # whisper-small, uncut, then internvl2-76b cut to VLM_DEPTH layers;
    # the first call of each attention shape is kept for the kernel rows:
    # whisper's encoder layer (full, Sq = Sk), its cross-attention (full,
    # Sq < Sk), internvl2's first prefill layer
    caps["flash_attention:audio encoder"] = Capture(
        ops, "flash_attention",
        lambda a, kw: not kw["causal"] and a[0].shape[1] == a[1].shape[1])
    caps["flash_attention:audio cross"] = Capture(
        ops, "flash_attention",
        lambda a, kw: not kw["causal"] and a[0].shape[1] < a[1].shape[1])
    caps["flash_attention:vlm"] = Capture(ops, "flash_attention",
                                          lambda a, kw: True)
    for tag, shape, tag_caps in (
            ("audio", (AUDIO_ARCH, None, AUDIO_BATCH, AUDIO_PROMPT,
                       AUDIO_NEW),
             ("flash_attention:audio encoder", "flash_attention:audio cross")),
            ("vlm", (VLM_ARCH, VLM_DEPTH, VLM_BATCH, VLM_PROMPT, VLM_NEW),
             ("flash_attention:vlm",))):
        with path(tag, ("flash_attention",)), \
                contextlib.ExitStack() as stack:
            for key in tag_caps:
                stack.enter_context(caps[key])
            run = modal_serve(dev, tag, *shape)
        cfg = run["cfg"]
        if counts[tag]["flash_attention"] != 3 * prefill_launches(cfg):
            raise AssertionError(f"{tag}: {counts[tag]} launches in three "
                                 f"generates, want 3 x "
                                 f"{prefill_launches(cfg)} flash_attention")
        with phase(f"{tag}: checks (prefill launches, prefill vs plain "
                   f"attention, decode vs forward"
                   + (", encoder, padded reference)" if cfg.enc_layers
                      else ", overlay)")):
            checks = check_modal(run)
        print(card)
        report_modal(run, checks, counts[tag])
        del run
        torch.cuda.empty_cache()

    # the first attention call with gradients: layer 0 of step 0
    caps["flash_attention_bwd"] = Capture(ops, "flash_attention",
                                          lambda a, kw: a[0].requires_grad)
    with path("train", ("flash_attention", "flash_attention_bwd")), \
            caps["flash_attention_bwd"]:
        train_run = train(dev)
    n_layers = train_run["cfg"].n_layers
    if counts["train"]["flash_attention_bwd"] != TRAIN_STEPS * n_layers:
        raise AssertionError("train: not one flash_attention_bwd a layer "
                             "and step")
    with phase("train: checks (losses, step 0 vs plain attention, layer 0 "
               "gradients vs plain autograd)"):
        train_checks = check_train(train_run,
                                   {"layer 0": caps["flash_attention_bwd"]})
    print(card)
    report_train(train_run, train_checks, counts["train"])
    del train_run
    torch.cuda.empty_cache()

    # mamba2-370m trains with no attention launch; hymba-1.5b with one
    # flash_attention_bwd a layer and step. The first windowed attention
    # call with gradients (layer 1, step 0) is kept for its checks and row
    for arch in LONG_TRAIN_ARCHS:
        hybrid = arch == "hymba-1.5b"
        cap = Capture(ops, "flash_attention",
                      lambda a, kw: a[0].requires_grad
                      and kw.get("window", 0) > 0)
        with path("long_train", ("flash_attention", "flash_attention_bwd")
                  if hybrid else (), f" ({arch})"), cap:
            long_run = long_train(dev, arch)
        got = ops.launch_counts()
        n_layers = long_run["cfg"].n_layers
        want = TRAIN_STEPS * n_layers if hybrid else 0
        if got["flash_attention_bwd"] != want \
                or (not hybrid and got["flash_attention"] != 0):
            raise AssertionError(f"long_train {arch}: launches {got}, want "
                                 f"{want} flash_attention_bwd")
        with phase(f"long_train: {arch} checks (losses fall at every step, "
                   f"step 0 vs plain attention, layer 1 gradients vs plain "
                   f"autograd)"):
            long_checks = check_train(long_run, {"layer 1": cap},
                                      every_step=True)
        print(card)
        report_train(long_run, long_checks, got)
        if hybrid:
            caps["flash_attention_bwd:hybrid windowed"] = cap
            counts["long_train:hymba-1.5b"] = got
        del long_run
        torch.cuda.empty_cache()

    # whisper-small uncut, then internvl2-76b cut to VLM_TRAIN_DEPTH
    # layers, each freed before the next; the first attention call with
    # gradients of each kind in MODAL_TRAIN_LAYERS is kept for the
    # gradient checks and the kernel rows
    for tag in MODAL_TRAIN_PATHS:
        layer_caps = modal_train_captures(tag)
        with path(tag, ("flash_attention", "flash_attention_bwd")), \
                contextlib.ExitStack() as stack:
            for cap in layer_caps.values():
                stack.enter_context(cap)
            run = modal_train(dev, tag)
        # a step: each prefill launch forward twice (remat recomputes the
        # block in the backward) and backward once
        per_step = prefill_launches(run["cfg"]) * TRAIN_STEPS
        want = {"flash_attention": 2 * per_step,
                "flash_attention_bwd": per_step}
        if any(counts[tag][k] != n for k, n in want.items()):
            raise AssertionError(f"{tag}: launches {counts[tag]}, want "
                                 f"{want} over {TRAIN_STEPS} steps")
        with phase(f"{tag}: checks (losses, step 0 vs plain attention, "
                   f"{', '.join(layer_caps)} gradients vs plain "
                   f"autograd)"):
            checks = check_train(run, layer_caps)
        print(card)
        report_train(run, checks, counts[tag])
        caps.update({f"{tag}:{what}": cap for what, cap in layer_caps.items()})
        del run
        torch.cuda.empty_cache()

    # four gloo ranks share the card; each counts its own launches from 0
    # around its steps, and the path's counts are their sum
    with phase("pod: 4 gloo ranks on one card (serve and assign steps; "
               "no other path's ranks started yet), then 1 nccl rank"):
        pod_run = pod()
    counts["pod"] = {k: sum(x["launches"][k] for x in pod_run["ranks"])
                     for k in pod_run["ranks"][0]["launches"]}
    print(f"[launches] pod: {json.dumps(counts['pod'])}", flush=True)
    with phase("pod: checks (ranks agree, serve vs plain scan, assign vs "
               "unsharded l2_topk, nccl vs direct calls)"):
        pod_checks = check_pod(pod_run, dev)
    print(card)
    report_pod(pod_run, pod_checks, card)
    del pod_run
    torch.cuda.empty_cache()

    # DBRX-132B with expert parallelism: four gloo ranks share the card;
    # each counts its own launches from 0 over its generates and
    # prefills, and the path's counts are their sum. The dp_train path's
    # ranks start now and wait (DP_WAIT_S)
    dp_ranks = spawn_ranks(dp_rank, DP_RANKS)
    with phase("ep: 4 gloo ranks on one card (dp_train's 2 ranks starting "
               "meanwhile), mesh (data 1, model 4) generate"):
        ep_run = ep(ep_ref)
    counts["ep"] = {k: sum(x["launches"].get(k, 0) for x in ep_run["ranks"])
                    for k in counts["pod"]}
    print(f"[launches] ep: {json.dumps(counts['ep'])}", flush=True)
    if counts["ep"]["flash_attention"] == 0:
        raise AssertionError("ep: not launched: ['flash_attention']")
    with phase("ep: checks (ranks agree, routes, logits and the f32 layer "
               "vs the unsharded model)"):
        ep_checks = check_ep(ep_run, ep_ref, ep_cfg)
    print(card)
    report_ep(ep_run, ep_checks, ep_cfg, ep_published, card)
    del ep_run, ep_ref

    # two gloo ranks on the card train through launch/train.py's setup;
    # each counts its own launches from 0 around its steps, and the
    # path's counts are their sum. The tp path's ranks start when they
    # get their go
    with phase("dp_train: one process on the whole batch (TinyLlama-1.1B "
               "2 layers, DBRX-132B 1 layer, the f32 layer on rows 0 and "
               "1)"):
        dp_ref = dp_reference(dev)
    tp_ranks = spawn_ranks(tp_rank, TP_RANKS)
    with phase("dp_train: 2 gloo ranks on one card, T1 (data 2, model 1) "
               "then T2 (data 1, model 2) (tp's 4 ranks starting "
               "meanwhile)"):
        dp_run = dp_train(dp_ref, dp_ranks)
    counts["dp_train"] = {k: sum(x[f"{tag}_launches"].get(k, 0)
                                 for x in dp_run["ranks"]
                                 for tag in DP_RANK_PHASES)
                          for k in counts["pod"]}
    print(f"[launches] dp_train: {json.dumps(counts['dp_train'])}",
          flush=True)
    with phase("dp_train: checks (ranks agree, losses vs one process, "
               "routes, the f32 layer's gradients)"):
        dp_checks = check_dp_train(dp_run, dp_ref)
    print(card)
    report_dp_train(dp_run, dp_checks, card)
    # rank 0's layer-0 call of each phase, for the kernel rows
    for tag in DP_RANK_PHASES:
        (q, k, v), kw = dp_run["ranks"][0][f"{tag}_call"]
        caps[f"dp_train:{tag}"] = types.SimpleNamespace(
            args=(tuple(t.to(dev) for t in (q, k, v)), kw))
    # T3's one-process side (the tp path's DBRX step on (2, 2)) is T2's
    t3_ref, t3_in = t3_side(dp_ref)
    del dp_run, dp_ref
    torch.cuda.empty_cache()

    # TinyLlama-1.1B with every weight and the decode cache placed by the
    # reference's specs, then DBRX-132B's train step on (2, 2) (T3): four
    # gloo ranks on the card (started with dp_train's go); each counts its
    # own launches from 0 over the path (T3's apart), and the path's
    # counts are their sum. The tp_families path's ranks start when they
    # get their go
    with phase("tp: one process unsharded (TinyLlama-1.1B f32 and bf16 "
               "generates, 2 layers f32: a generate and a train step)"):
        tp_ref = tp_reference(dev)
    tpf_ranks = spawn_ranks(tpf_rank, TP_RANKS)
    with phase("tp: 4 gloo ranks on one card, A (data 1, model 4) f32 and "
               "bf16, then B (data 2, model 2) decode and train step, then "
               "T3 (DBRX-132B 1 layer on (2, 2): a train step and its f32 "
               "layer) (tp_families' 4 ranks starting meanwhile)"):
        tp_run = tp(tp_ref, tp_ranks, t3_in)
    del t3_in
    print(f"[phase] tp T3 (DBRX-132B train step on (data 2, model 2); rank "
          f"0, within the ranks' phase above): "
          f"{tp_run['ranks'][0]['T3_s']:.3f} s", flush=True)
    counts["tp T3"] = {k: sum(x["T3"]["launches"].get(k, 0)
                              for x in tp_run["ranks"])
                       for k in counts["pod"]}
    counts["tp"] = {k: sum(x["launches"].get(k, 0) for x in tp_run["ranks"])
                    + counts["tp T3"][k] for k in counts["pod"]}
    print(f"[launches] tp: {json.dumps(counts['tp'])}", flush=True)
    print(f"[launches] tp T3 (DBRX-132B on (2, 2)): "
          f"{json.dumps(counts['tp T3'])}", flush=True)
    missing = [(p, k) for p in ("tp", "tp T3")
               for k in ("flash_attention", "flash_attention_bwd")
               if counts[p][k] == 0]
    if missing:
        raise AssertionError(f"tp: not launched: {missing}")
    with phase("tp: checks (ranks agree, f32 logits and greedy tokens vs "
               "the unsharded model, the decode of one sequence, the train "
               "steps, T3 vs the one-process DBRX step)"):
        tp_checks = check_tp(tp_run, tp_ref, t3_ref)
    print(card)
    report_tp(tp_run, tp_checks, card)
    (q, k, v), kw = tp_run["ranks"][0]["A_call"]
    caps["tp"] = types.SimpleNamespace(
        args=(tuple(t.to(dev) for t in (q, k, v)), kw))
    (q, k, v), kw = tp_run["ranks"][0]["T3"]["call"]
    caps["tp T3"] = types.SimpleNamespace(
        args=(tuple(t.to(dev) for t in (q, k, v)), kw))
    # tp_ref stays for the tp_hd path
    del tp_run, t3_ref
    torch.cuda.empty_cache()

    # the ssm, hybrid and audio families placed by the reference's specs:
    # four gloo ranks on the card (started with tp's go); each counts its
    # own launches from 0 over the path, and the path's counts are their
    # sum
    with phase("tp_families: one process unsharded (mamba2-370m, "
               "hymba-1.5b and whisper-small f32 and bf16 generates; "
               "2-layer train steps and a decode of one)"):
        tpf_ref = tpf_reference(dev)
    with phase("tp_families: 4 gloo ranks on one card, A-C (data 1, model "
               "4) f32 and bf16, then D (data 2, model 2) decode and train "
               "steps, then E (hymba-1.5b, head dim split) on both"):
        tpf_run = tp_families(tpf_ref, tpf_ranks)
    print(f"[phase] tp_families E (head dim split; rank 0, within the ranks' "
          f"phase above): {tpf_run['ranks'][0]['E_s']:.3f} s", flush=True)
    counts["tp_families"] = {
        k: sum(x["launches"].get(k, 0) for x in tpf_run["ranks"])
        for k in counts["pod"]}
    print(f"[launches] tp_families: {json.dumps(counts['tp_families'])}",
          flush=True)
    counts["tp_families E"] = {
        k: sum(x["launches_E"].get(k, 0) for x in tpf_run["ranks"])
        for k in counts["pod"]}
    print(f"[launches] tp_families E (head dim split): "
          f"{json.dumps(counts['tp_families E'])}", flush=True)
    missing = [(path, k) for path in ("tp_families", "tp_families E")
               for k in ("flash_attention", "flash_attention_bwd")
               if counts[path][k] == 0]
    if missing:
        raise AssertionError(f"tp_families: not launched: {missing}")
    with phase("tp_families: checks (ranks agree, f32 logits and greedy "
               "tokens vs the unsharded models, the decode of one sequence, "
               "the train steps)"):
        tpf_checks = check_tp_families(tpf_run, tpf_ref)
    print(card)
    report_tp_families(tpf_run, tpf_checks, card)
    tpf_calls = {"ranks": [{k: x[k] for k in ("B_call", "C_call", "E_call",
                                              "launches", "launches_E")}
                           for x in tpf_run["ranks"]]}
    # tpf_ref stays for the tp_ssd path
    del tpf_run
    torch.cuda.empty_cache()




    # tp_hd's and tp_ssd's ranks start while a one-process path runs (the
    # census, then main), not beside another rank path's ranks: the
    # starting processes' imports take the host's cores from that path's
    # small exchanges
    tphd_ranks = spawn_ranks(tphd_rank, TP_HD_RANKS)
    # the census grid in process, then one rank's share of the two 1B rows
    # (each share's scans counted from 0, their launches gated there) and
    # the long_500k decodes, which launch no kernel
    census_rows = []
    census_run = census(dev, census_rows)
    counts["census"] = {k: sum(a["launches"][k] for a in census_run["anns"])
                        for k in counts["pod"]}
    print(f"[launches] census: {json.dumps(counts['census'])}", flush=True)
    print(card)
    report_census(census_run, card)
    del census_run

    # case M of the head-dim placement: TinyLlama-1.1B on (data 1, model
    # 8), eight gloo ranks on the card (started before the census),
    # held to tp's unsharded side; each counts its own launches from 0
    # over the path, and the path's counts are their sum
    with phase("tp_hd: 8 gloo ranks on one card, M1 (data 1, model 8, "
               "TinyLlama-1.1B's head dim split) f32 and bf16, then M2 "
               "decode and train step"):
        tphd_run = tp_hd(tp_ref, tphd_ranks)
    for tag in ("M1", "M2"):
        print(f"[phase] tp_hd {tag} (rank 0, within the ranks' phase "
              f"above): {tphd_run['ranks'][0][f'{tag}_s']:.3f} s",
              flush=True)
    counts["tp_hd"] = {k: sum(x["launches"].get(k, 0)
                              for x in tphd_run["ranks"])
                       for k in counts["pod"]}
    print(f"[launches] tp_hd: {json.dumps(counts['tp_hd'])}", flush=True)
    missing = [k for k in ("flash_attention", "flash_attention_bwd")
               if counts["tp_hd"][k] == 0]
    if missing:
        raise AssertionError(f"tp_hd: not launched: {missing}")
    with phase("tp_hd: checks (ranks agree, f32 logits and greedy tokens "
               "vs the unsharded model, case M's placement and caches, the "
               "decode of one sequence, the train step)"):
        tphd_checks = check_tp_hd(tphd_run, tp_ref)
    print(card)
    report_tp_hd(tphd_run, tphd_checks, card)
    tphd_calls = {"ranks": [{k: x[k] for k in ("M1_call", "M2_step_call",
                                               "launches")}
                            for x in tphd_run["ranks"]]}
    del tphd_run, tp_ref
    torch.cuda.empty_cache()

    tpssd_ranks = spawn_ranks(tpssd_rank, TP_SSD_RANKS)
    caps.update({
        "l2_topk_masked": Capture(ops, "l2_topk_masked",
                                  lambda a, kw: a[0].shape[0] == MAX_BATCH),
        "pq_adc_masked": Capture(ops, "pq_adc_masked",
                                 lambda a, kw: a[0].shape[0] == MAX_BATCH),
        # the first ground-truth chunk of make_dataset
        "l2_topk": Capture(ops, "l2_topk", lambda a, kw: a[1].shape[0] == N),
        # the compare path's first full DiskANN wave: the second call of
        # the L16 sweep (the first scores the entry points, the next the
        # entry's neighbours), where every query scores the neighbours of
        # a full beam of frontier nodes
        "pq_adc_rows": Capture(ops, "pq_adc_rows", nth_call(2)),
        # the first closure chunk of SPANN's build (k = N_CLOSURE = 8)
        "l2_topk_closure": Capture(ops, "l2_topk", lambda a, kw: a[2] == 8)})
    with path("main", serve_kernels), caps["l2_topk_masked"], \
            caps["pq_adc_masked"], caps["l2_topk"]:
        index_and_serve("main", N, N_QUERIES, SCALE_FLOOR, dev)

    with phase("tp_ssd: one process unsharded (hymba-1.5b uncut, f32 and "
               "bf16 generates)"):
        tpssd_ref = tpssd_reference(dev)

    # the SSD layouts of a leaf split only as a whole: hymba-1.5b's SSD
    # heads split over a whole in_proj on (data 1, model 5), then
    # mamba2-370m's conv cut across its parts on (1, 3); five gloo ranks on
    # the card (started before the main path), the first three re-joined for
    # the second world, held to tp_families' and tpssd_reference's
    # unsharded runs; each counts its own launches from 0 over the path,
    # and the path's counts are their sum
    with phase("tp_ssd: 5 gloo ranks on one card, S1 (hymba-1.5b on (data "
               "1, model 5), SSD heads split over a whole in_proj) f32 and "
               "bf16 and S2 train step, then 3 of them, S3 (mamba2-370m on "
               "(1, 3), conv cut across its parts) and S4"):
        tpssd_run = tp_ssd(tpssd_ref, tpf_ref, tpssd_ranks)
    for tag in ("S1", "S2", "S3", "S4"):
        print(f"[phase] tp_ssd {tag} (rank 0, within the ranks' phase "
              f"above): {tpssd_run['ranks'][0][f'{tag}_s']:.3f} s",
              flush=True)
    counts["tp_ssd"] = {k: sum(x["launches"].get(k, 0)
                               for x in tpssd_run["ranks"])
                        for k in counts["pod"]}
    print(f"[launches] tp_ssd: {json.dumps(counts['tp_ssd'])}", flush=True)
    missing = [k for k in ("flash_attention", "flash_attention_bwd")
               if counts["tp_ssd"][k] == 0]
    if missing:
        raise AssertionError(f"tp_ssd: not launched: {missing}")
    with phase("tp_ssd: checks (ranks agree, f32 logits and greedy tokens "
               "vs the unsharded models, the SSD's placement and caches, "
               "the train steps)"):
        tpssd_checks = check_tp_ssd(tpssd_run, tpssd_ref, tpf_ref)
    print(card)
    report_tp_ssd(tpssd_run, tpssd_checks, card)
    tpssd_calls = {"ranks": [{k: v for k, v in x.items()
                              if k.endswith("call") or k == "launches"}
                             for x in tpssd_run["ranks"]]}
    del tpssd_run, tpssd_ref, tpf_ref
    torch.cuda.empty_cache()

    with path("compare", ("l2_topk", "l2_topk_masked", "pq_adc_rows")), \
            caps["pq_adc_rows"], caps["l2_topk_closure"]:
        comparison(dev)

    with phase("kernel timing at path shapes"):
        by_kernel = {"l2_topk_masked": counts["main"],
                     "pq_adc_masked": counts["main"],
                     "l2_topk": counts["main"],
                     "pq_adc_rows": counts["compare"],
                     "l2_closure": counts["compare"],
                     "flash_attention": counts["rag"],
                     "flash_attention_bwd": counts["train"],
                     "hybrid": counts["hybrid"],
                     "long_train:hymba-1.5b":
                     counts["long_train:hymba-1.5b"],
                     "audio": counts["audio"], "vlm": counts["vlm"],
                     **{tag: counts[tag] for tag in MODAL_TRAIN_PATHS},
                     "pod": counts["pod"], "dp_train": counts["dp_train"],
                     "tp": counts["tp"], "tp T3": counts["tp T3"],
                     **moe_launches}
        rows = time_kernels(caps, by_kernel) \
            + tpf_kernel_rows(tpf_calls, dev) \
            + tphd_kernel_rows(tphd_calls, dev) \
            + tpssd_kernel_rows(tpssd_calls, dev) + census_rows
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in counts.items()}
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
