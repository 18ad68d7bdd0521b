#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, started together);
3. the O-POPE GEMM kernel (K1) against its plain PyTorch version on the
   card, at both models' K1 shapes and chains for M = 4, 64, 256 and 512
   (the sm90 route, and bitwise equal on repeat), timed at chatglm3-6b's
   on the sm90 route, on the tile route and beside ``torch.matmul`` and
   the card's bound, and at small ragged shapes on both routes for every
   epilogue op;
4. full-width chatglm3-6b (28 layers, bf16, random weights from seed 0):
   (a) prefill logits through the kernel against the plain backend,
   (b) the continuous-batching engine on a Poisson trace — the first main
       path, whose kernel launches are counted, every one on K1's sm90
       route — (c) the lockstep engine, (d) a lockstep decode step's
       wall time beside its K1 device time, (e) a 4 x 200-token prefill in
       chunks of 32 (``api.prefill_chunk``) against the bucketed prefill,
       (f) the continuous engine with chunked prefill and the prefix cache
       on a shared-system-prompt trace against the same engine without
       them (12 hits, greedy agreement at least the kernels-vs-plain floor
       of this run less 0.02), and (g) the same with int8 K/V lanes (half
       the bf16 pool's bytes a slot), plus the trie's gather and int8 scale
       adoption checked bitwise on the card — every K1 launch of (b)–(g)
       counted and on its sm90 route — and (h) telemetry (``repro_torch.obs``):
       (i) a 4-row masked decode step and a whole serve of (b)'s trace with
       telemetry on and off — the same device kernels in the same order, the
       same device-to-host copies and host syncs, the same greedy streams —
       with the step's median wall time and the host time of a GEMM call on
       and off; (ii) the prefix-cache trace of (f) with SLOs set: each
       request's queue, prefix-attach and chunk-prefill phases sum to its
       TTFT, the Chrome trace validates, 12 hits and 0 misses, 12 requests
       admitted and retired, goodput 1.0 at SLOs of 1e9 ms and 0.0 at 1e-6
       ms, and every K1 bucket of the decode step with a roofline fraction
       at most 1.0; (iii) the scrape surface (``REPRO_METRICS_PORT``) fetched
       on 127.0.0.1, ``/metrics`` equal to ``prometheus_text()`` after the
       run;
5. the grouped O-POPE GEMM kernel (K4) against its plain version on the
   card, at deepseek-moe-16b's expert shapes and chains for M = 1, 30 and 60
   (required on the sm90 route and checked on the tile route too; timed by
   device time on both routes beside ``torch.bmm`` and the card's bound)
   and at small ragged shapes for every epilogue op and C form (on the tile
   route, and aligned ones on both routes);
6. full-width deepseek-moe-16b (28 layers, bf16, random weights from seed 0),
   after chatglm3-6b's weights are freed:
   (a) routing in a full prefill on the kernels against the plain router on
       the same layer inputs, the drift of two free-running prefills beside
       that of two valid summation orders, and one MoE layer on both
       backends with the same routing,
   (b) the continuous-batching engine on a Poisson trace — the second main
       path, whose K1 and K4 launches are counted, every one on its sm90
       route — and the lockstep engine,
   (c) a lockstep decode step's wall time beside its K1 and K4 device time;
7. the int8 GEMM kernels K2 and K5 against their plain versions on the card,
   bitwise where the chain has no transcendental op, at the shapes of both
   models' quantized GEMMs (every K2 and K5 shape required on its sm90 route
   and checked on the tile route too, a split-K call bitwise on repeat; both
   timed by device time on both routes, K2 at the decode and the prefill M
   beside ``torch._int_mm`` + dequant, K5 at capacities 1, 30 and 60 beside
   K4's sm90 route on the same shapes in bf16 and the card's bound; both beside one per-call weight
   quantization) and at small ragged shapes on the tile route and aligned
   ones on the sm90 route (K5 at G = 3 and 64), each route required to have
   run; ptxas must report no spill for K5's kernels;
8. full-width chatglm3-6b under ``mlp_q8_policy()`` (run after phase 4, on its
   weights) and full-width deepseek-moe-16b under
   ``PrecisionPolicy(rules={"moe": "q8"})`` (after phase 6): (a) one layer on
   the kernels against the plain backends, (b) the all-layer prefill logits
   against a floor this run measures, (c) the q8-vs-bf16 logit difference,
   (d) the quantized main path — a 4 x 64-token prefill and 16 greedy decode
   steps through ``api.prefill``/``api.decode`` with exact launch counts,
   every K1, K2 and K5 launch required on the sm90 route —
   and (e) a decode step's wall and device time and its kernel split, each
   kernel booked by its own name, none that the path launched at zero; and
   for chatglm3-6b (f) the shadow auditor with ``REPRO_AUDIT=1``: one MLP's
   direct K2 calls audited against K1 within 5 % and no drift event, a
   served q8 decode step audited nowhere;
9. after deepseek-moe-16b's weights are freed, the ``kernels`` entry points
   of K3 and K6: (a) ``opope_attention_bhsd`` at chatglm3-6b's attention
   width (32 heads of 128, its 2 KV heads expanded) at a 4 x 2048 causal
   prefill, a 512-row continuation over 2048 keys, a decode row and a
   non-causal call, and ``opope_chunked_scan`` at jamba-v0.1's mamba scan
   width (8192 x 16 columns, 4096 steps) — the slice's main path, its
   launches counted, every K3 launch required on the sm90 route — each
   against its plain version (K6 bitwise); K3 timed by device time (CUDA
   events around calls queued behind a sleeping kernel) on its planned
   route and on the tile route, beside SDPA and the bound, and
   checked on both routes at ragged fp32/bf16 cases and sm90 panel edges,
   plus chatglm3-6b's prefill_32k sequence (both routes and SDPA only);
   (b) the prefill against the model's own ``blockwise_attention``;
10. training on K1 (after phase 9): (a) the vjp of each of one full-width
    chatglm3-6b layer's 7 GEMMs at M = 2048 through ``ops.matmul`` on the
    kernels against the plain backend (every ``dA``, ``dB`` and epilogue
    operand's gradient within TRAIN_GRAD_FLOOR_FACTOR times the RMS gap of
    the plain version's fp32 and fp64 sums, in this run), K1's launches
    counted by role, each backward GEMM timed by device time beside
    ``torch.matmul`` on the same operands and the bound; (b) full-width
    chatglm3-6b cut to 4 layers (bf16, remat "full", random weights from
    seed 0) on the Markov stream at 4 x 512 tokens: the first step's loss
    and every gradient leaf on the kernels against the plain backend under
    the same floor, then 8 steps through ``repro_torch.train.train`` whose
    loss must fall, with step time, tokens/s, peak memory and a profiled
    step; (c) ``python -m repro_torch.launch.train --arch chatglm3-6b
    --reduced --steps 40`` (loss must fall; run as 12(e)'s first run, with
    ``--ckpt-dir``); (d) K1 launched in the backward
    of (a) and (b), and (b)'s launches exactly 25 sm90 and 6 tile (the fp32
    backward GEMMs) a layer and a step;
11. MoE training on K4 and K1 (after phase 10): (a) one full-width
    deepseek-moe-16b layer's 3 expert GEMMs at their training shapes (64
    experts x 240 rows), teacher-forced on fixed routing, their vjp
    through ``ops.grouped_matmul`` on the kernels against the plain
    backend under phase 10's floor gate, K4's backward launches by route,
    each backward GEMM timed by device time beside ``torch.bmm`` on the
    same operands, the operand copies and the bound; (b) full-width
    deepseek-moe-16b cut to 4 layers (bf16, remat "full", onehot dispatch,
    random weights from seed 0) on the Markov stream at 4 x 512 tokens:
    one step with every K1 and K4 launch counted by role (forward, remat
    recompute, backward, fp32 recompute, fp32 backward) and route, and
    each layer's remat recompute routing bitwise equal to its forward's,
    then 8 steps through ``repro_torch.train.train`` with finite losses,
    exact launch counts, step time, tokens/s, peak memory and a profiled
    step; (c) ``python -m repro_torch.launch.train --arch deepseek-moe-16b
    --reduced --steps 40`` (finite losses);
12. q8 training and checkpoints (after phase 11): (a) full-width chatglm3-6b
    cut to 4 layers under ``mlp_q8_policy()``: one step with every K1 and K2
    launch counted by role and route (the MLP's forward and remat recompute
    on K2, every backward GEMM on K1), its loss and every gradient leaf
    against the plain q8 policy under phase 10's floor gate, 8 steps
    through ``train`` with exact launch counts, and K2's 3 MLP GEMMs at
    M = 2048 timed by device time beside ``torch._int_mm`` + dequant and
    the bound; (b) deepseek-moe-16b cut to 2 layers under ``{"moe": "q8"}``:
    the same first step, teacher-forced on the kernels' routing (K5 and K2
    forward, K1 and K4 backward), then 3 steps; (c) chatglm3-6b cut to 2
    layers, bf16: two uninterrupted 6-step runs, and a run that checkpoints
    every 3 steps (9.4 GB each, under ``build/``), fails at step 5 and
    resumes, its final parameters and moments bitwise equal to the
    uninterrupted run's (or within the two uninterrupted runs' gap, where
    they differ), save and restore seconds logged; (d) the final checkpoint
    restored into the continuous engine: 4 greedy requests give the
    in-memory parameters' tokens, every K1 launch on sm90; (e) the train
    CLI at its reduced config with ``--ckpt-dir``, 40 steps, then 60 steps
    resuming from 40.

13. tuning (``repro_torch.tune``; run after phase 4(h), on chatglm3-6b's
    resident weights, so that phases 7-12 run on the heuristic plans): (a)
    the tuner times every legal plan by device time, into a throwaway table
    under ``build/``: K1 at chatglm3-6b's four distinct projection shapes
    and K2 at its two distinct MLP shapes, at M = 4 and 512, K4 and K5 at
    deepseek-moe-16b's two expert shapes (G 64) at M = 1, 30 and 60 — for
    each, the heuristic plan and its time, the winner and its time (never
    above the heuristic's), the candidates timed and the fusion verdict;
    (b) every winner against its plain version, with and without the
    probe's epilogue; (c) the table active: a 4-row decode step whose every
    K1 call resolves ``"tuned"`` (its ``GemmRecord``s and ``gemm.calls``
    labels) and launches on sm90, its teacher-forced logits within
    PROMPT_LOGIT_FLOOR_FACTOR x the plain GEMM's RMS gap of this run, its
    wall and busy time beside the heuristic's (no gain claimed), and the
    host time of a direct K1 call with the plan path against the kernel
    called directly; then the table cleared (``tile="heuristic"`` again);
    (d) ``python -m repro_torch.launch.tune`` on two explicit shapes, its
    table reloaded.
14. the families of ROADMAP A.8 (after phase 12), one at a time at their
    published widths, each freed before the next: stablelm-12b (40 layers,
    the parallel block), gemma2-9b (42 layers, local and global attention,
    soft-capping), qwen2.5-32b (64 layers, QKV bias) and grok-1-314b cut to
    GROK_SERVE_LAYERS of its 64 layers. Each: (i) the all-layer prefill
    logits through the kernels against the plain backend under a same-run
    floor (grok with the kernels' routing replayed, beside 6(a)'s routing
    agreement), (ii) the
    continuous engine on 4(b)'s Poisson trace, every K1 and K4 launch
    counted and on sm90, (iii) a profiled 4-row decode step and the peak
    device memory. Then (a) stablelm-12b: 4(f)'s chunked-prefill and
    prefix-cache gate; (b) gemma2-9b: one prompt longer than its 4096-token
    window, chunked against monolithic prefill and 8 decode steps,
    teacher-forced, at 4(f)'s same-run floor, and the window shown to move
    the logits; (c) qwen2.5-32b under ``mlp_q8_policy()`` (phase 8, K2
    counted); (d) grok-1-314b under ``{"moe": "q8"}`` (phase 8, K5
    counted), and K4 and K5 at its expert GEMMs (G 8) against their plain
    versions, timed beside ``torch.bmm`` and the bound; (e) training
    gemma2-9b at 4 layers and grok-1-314b at 1 layer (``grad_accum=8``,
    bf16 moments), 3 steps each: the first step's gradients under 10(a)'s
    floor gate, launches by role and route, step time, tokens/s and peak
    memory.
15. llava-next-mistral-7b (32 layers, 2880 image rows) and whisper-base
    (6 + 6 layers, 1500 frames) at their published widths, one at a time
    (after phase 14), each freed before the next, on the static engine
    (ROADMAP A.8b), with bf16 inputs drawn from the seed: (i) the prefill
    logits through the kernels against the plain GEMM (llava's image
    projector included) under 14(i)'s same-run floor, (ii) the static
    engine, 4 rows of 32-token prompts, 32 tokens each, every K1 launch
    counted and on sm90, and its decoded logits teacher-forced against one
    full forward over the image rows or frames, the prompt and the tokens
    fed at 4(f)'s same-run floor (llava decoding from its true position,
    2880 + 32), (iii) the 4-row prefill's time, a profiled 4-row decode
    step and the peak device memory; then (c) one ``loss_fn`` value and
    every gradient leaf of each family (llava cut to 2 layers) on the
    kernels against the plain backend under 10(a)'s floor gate.
16. jamba-v0.1-52b cut to JAMBA_SERVE_LAYERS of its 32 layers (two whole
    periods: seven mamba mixers and one attention layer a period, MLP and
    16-expert MoE blocks in turn) and xlstm-125m uncut (sLSTM and mLSTM
    mixers, no FFN) at their published widths, one at a time (after phase
    15), each freed before the next (ROADMAP A.8c): (i) the all-layer
    prefill logits through the kernels against the plain backend under
    14(i)'s same-run floor (jamba's routing replayed and held as 6(a)),
    (ii) the continuous engine on 4(b)'s Poisson trace with exact-length
    buckets, constructed with ``prefill_chunk`` set (the warning and both
    prompt-side features off required), every K1 and K4 launch counted by
    route, (iii) the static engine's prefill-to-decode handoff: 4 rows of
    32-token prompts and 16 decode steps, the decoded logits teacher-forced
    against one full forward at 4(f)'s same-run floor (jamba with
    ``moe.dropless`` here alone, the full forward on the engine's routing),
    (iv) the 4-row prefill's time, a profiled decode step and the peak
    device memory; for jamba, (v) K4 and K5 at its expert GEMMs (G 16)
    timed beside ``torch.bmm`` and the bound, and (vi) phase 8 under
    ``{"moe": "q8", "mixer": "q8"}`` with K2 and K5 counted; then (c) one
    ``loss_fn`` value and every gradient leaf of each family (jamba cut to
    its first 5 layers, the plain runs on the kernels' routing) under
    10(a)'s floor gate.
17. every dtype the reference's kernels take (ROADMAP B.1), after phase
    16: (a) chatglm3-6b in fp16 uncut and (b) deepseek-moe-16b in fp16
    cut to DTYPE_MOE_LAYERS layers through phase 14's ``family_phase``
    ((i) the prefill logits under 14(i)'s floor, deepseek's routing held as
    6(a); (ii) the continuous engine, K/V in bf16; (a) also (iii) a
    profiled decode step), every K1 and K4 launch on the fp16 sm90 route;
    (c) each kernel alone against its plain version at its phase's gate:
    K1 at chatglm3-6b's 7 layer GEMMs in fp16, e4m3, e5m2 and one mixed
    pair of each compute class, K4 at deepseek's expert GEMMs in fp16 and
    e4m3, K3 at head dims 80, 256 and 320 in fp16, bf16, fp32 and e4m3, K6
    in fp16 and e4m3 (bitwise), each timed beside its bound and, where
    one PyTorch call computes the same function, that call; and an e4m3-out
    K1 call whose sums pass 448 held bit for bit, NaNs included.

The last lines are a JSON ``{"kernels": [...]}`` record and then
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
not 0 and no result is printed. Without a CUDA device, or outside a checkout,
it exits with code 2.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores
L2_BYTES = 50 * 2**20
# Free-running full-prefill routing, kernels vs plain: at least the share
# two plain summation orders (fp32, fp64) agree on in the same run, less
# this margin, and never below the absolute floor. The margin is the
# largest mean + 3 SD of that difference, pooled as below, that
# tools/routing_noise_probe.py read on an H100 (48 draws of 2 x 64 tokens):
# jamba-v0.1-52b at 16 layers 0.0102 + 3 x 0.0056, grok-1-314b at 4 layers
# 0.0033 + 3 x 0.0017. Its cause is the tensor cores' accumulation:
# cuBLAS's own bf16 product differs from the plain one by as much (0.0086,
# 0.0032), a second fp32 order by less (0.0029, 0.0000).
FREE_ROUTING_MARGIN = 0.03
FREE_ROUTING_FLOOR = 0.9
# 14(i) and 16(i) pool that share over this many 2 x 64-token prefills: the
# logits gate's tokens and numpy seeds 1, 2, ... A flip early in a sequence
# carries through its later tokens and layers, so one prefill's share moves
# by a few hundredths between token draws (tools/routing_noise_probe.py).
FREE_ROUTING_BATCHES = 16
# All-layer prefill logits under a q8 policy, kernels vs plain: their RMS
# difference at most this many times that of two plain summation orders
# (fp32, fp64) in the same run. An int8 value that rounds the other way
# after a 1-ulp difference upstream moves the logits by one quantization
# step in both comparisons alike.
Q8_LOGIT_FLOOR_FACTOR = 3.0
# Chunked prefill and the prefix cache (phase 4(f)), teacher-forced logits
# of features on against off: their RMS difference at most this many times
# that of the plain GEMM against the kernels on the features-off path, in
# the same run. Both are bf16 rounding of equally valid orders; a wrong
# attach, chunk write or slot moves the logits by their own size.
PROMPT_LOGIT_FLOOR_FACTOR = 3.0
# Training (phase 10): every gradient on the kernels against the plain
# backend, their RMS difference at most this many times that of two plain
# summation orders (fp32 and fp64 sums) in the same run; the loss within
# this relative gap (one number: a ratio of two rounding draws is no gate).
# The plain fp32 sums are sequential FMAs; K1's sm90 route sums bf16
# products on the tensor cores, whose fp32 accumulation aligns and rounds
# otherwise, so a lone GEMM's gradient sits 2.3-3.8x the floor in 10(a) on
# an H100 where two IEEE orders would sit near 1.4x. A wrong rule or a
# rounded cotangent moves a gradient by 30x the floor or more.
TRAIN_GRAD_FLOOR_FACTOR = 8.0
TRAIN_LOSS_RTOL = 1e-3
# The gradient gates' RMS sums take this many elements at a time: 0.5 GB in fp64.
RMS_GAP_SLICE = 1 << 26
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (K1's fp32 tile route)
# Full-width chatglm3-6b cut to 4 layers (1.35 G parameters: 16.2 GB with
# bf16 gradients and fp32 AdamW moments; all 28 layers would need 74.9 GB
# before activations), 4 x 512 tokens a step, 8 steps.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 512
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 8, 2, 1e-3
# K1 launches a layer and a step under remat "full": 7 forward GEMMs twice
# (the first forward and its recompute in the backward), wq/wk/wv/w_up's
# dA and dB (8, bf16), and for wo, w_gate and w_down (epilogue'd) the fp32
# accumulator's recompute and dA, dB on the fp32 cotangent (3 + 6).
K1_TRAIN_SM90_PER_LAYER, K1_TRAIN_TILE_PER_LAYER = 14 + 8 + 3, 6
# MoE training (phase 11): full-width deepseek-moe-16b cut to 4 of its 28
# layers (2.56 B parameters: 30.7 GB with bf16 gradients and fp32 AdamW
# moments; all 28 would need about 200 GB), bf16, remat "full", onehot
# dispatch, the same 4 x 512 tokens and 8 steps: 4 routing groups of 512 at
# capacity 60, so each expert GEMM has M = 240.
MOE_TRAIN_LAYERS = 4
# Launches a layer and a step by role (phase 11(b), all on sm90 but the fp32
# backward on tile). K1: 8 GEMMs (wq, wk, wv, wo, the router, the shared
# MLP's w_up, w_gate, w_down) in the forward and again in the remat
# recompute; dA and dB of wq, wk, wv, the router and the shared w_up; for
# wo and the shared w_gate and w_down (epilogue'd) the fp32 accumulator's
# recompute and dA, dB on its fp32 cotangent. K4: the 3 expert GEMMs twice;
# w_up's dA, dB; w_gate's fp32 recompute and its dA, dB on g_acc; w_down's
# dA, dB on the cotangent of its fp32 output.
K1_MOE_TRAIN = {"forward": 8, "remat recompute": 8, "backward": 10, "fp32 recompute": 3,
                "fp32 backward": 6}
K4_MOE_TRAIN = {"forward": 3, "remat recompute": 3, "backward": 2, "fp32 recompute": 1,
                "fp32 backward": 4}

# q8 training (phase 12(a), (b)): the quantized roles' forward and remat
# recompute on K2 and K5, every backward GEMM on K1 and K4 (their grad
# backend). chatglm3-6b under mlp_q8_policy(), a layer and a step: K2 the 3
# MLP GEMMs twice; K1 wq, wk, wv, wo twice, dA and dB of wq, wk, wv and
# w_up, the fp32 accumulator recompute of wo, w_gate and w_down, and dA, dB
# on their fp32 cotangent (tile).
K1_Q8_TRAIN = {"forward": 4, "remat recompute": 4, "backward": 8, "fp32 recompute": 3,
               "fp32 backward": 6}
K2_Q8_TRAIN = {"forward": 3, "remat recompute": 3}
# deepseek-moe-16b under {"moe": "q8"}, cut to 2 layers: K5 the 3 expert
# GEMMs twice and K2 the shared MLP's 3 twice; K1 the attention and router
# GEMMs twice and the rest of phase 11's K1 table; K4 phase 11's backward.
Q8_MOE_TRAIN_LAYERS, Q8_MOE_TRAIN_STEPS = 2, 3
K1_Q8_MOE_TRAIN = {"forward": 5, "remat recompute": 5, "backward": 10, "fp32 recompute": 3,
                   "fp32 backward": 6}
K2_Q8_MOE_TRAIN = {"forward": 3, "remat recompute": 3}
K5_Q8_MOE_TRAIN = {"forward": 3, "remat recompute": 3}
K4_Q8_MOE_TRAIN = {"backward": 2, "fp32 recompute": 1, "fp32 backward": 4}
# Checkpoints (phase 12(c)-(e)): chatglm3-6b cut to 2 layers (0.94 B
# parameters: 1.9 GB of bf16 weights and 7.5 GB of fp32 moments a
# checkpoint), 6 steps, a checkpoint every 3, a failure at step 5.
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AT = 2, 6, 3, 5

# Phase 14 (ROADMAP A.8): the families served and trained since the
# sixteenth slice, one at a time at their published widths. grok-1-314b is
# cut to 4 of its 64 layers to serve (9.84 GB a layer: 40.97 GB with its
# tied table; all 64 would need 631 GB) and to 1 to train (11.45 GB of
# weights, as much in bf16 gradients, 22.9 GB of fp32 gradient sums for its
# 8 microbatches and 22.9 GB of bf16 moments); gemma2-9b trains at 4 layers
# (2 periods of local and global attention).
FAMILIES = ("stablelm-12b", "gemma2-9b", "qwen2.5-32b", "grok-1-314b")
GROK_SERVE_LAYERS = 4
GROK_EXPERT_MS = (2, 160)  # expert rows at a 4-row decode step and a 512-token group
# 14(i): the all-layer prefill logits, kernels vs plain, their RMS at most
# this many times that of the plain backend's fp32 and fp64 sums in the
# same run. 4(a)'s max gate (2e-2 of max|logits|) measures rounding alone at
# qwen2.5-32b's 64 layers: there two plain orders differ by an RMS of the
# kernels' own size (on an H100: 0.02451 and 0.02466, max 0.1243 of
# max|logits| 5.944). A wrong GEMM moves the logits by their own size.
PREFILL_LOGIT_FLOOR_FACTOR = 3.0
# gemma2-9b's long prompt: past its local layers' 4096-token window.
GEMMA2_LONG_PROMPT, GEMMA2_LONG_CHUNK, GEMMA2_LONG_STEPS = 4608, 512, 8
FAMILY_TRAIN = (("gemma2-9b", 4, 4, 512), ("grok-1-314b", 1, 8, 512))  # layers, batch, seq
FAMILY_TRAIN_STEPS = 3
# Launches a layer and a step by role: a dense layer as phase 10's (7 GEMMs
# twice, 8 bf16 backward, 3 fp32 recomputes, 6 fp32 backward on tile);
# grok's K1 the attention and the router (no shared expert: wo is its only
# epilogue'd K1 GEMM), its K4 phase 11's table.
K1_DENSE_TRAIN = {"forward": 7, "remat recompute": 7, "backward": 8, "fp32 recompute": 3,
                  "fp32 backward": 6}
K1_GROK_TRAIN = {"forward": 5, "remat recompute": 5, "backward": 8, "fp32 recompute": 1,
                 "fp32 backward": 2}

# Phase 15 (ROADMAP A.8b): llava-next-mistral-7b (32 layers, 14.55 GB of
# bf16 weights) and whisper-base (6 + 6 layers) at their published widths
# on the static engine: A8B_ROWS rows of A8B_PROMPT-token prompts (after
# llava's 2880 image rows, or against whisper's 1500 frames), A8B_GEN tokens
# each; the prefill gate at A8B_ROWS_GATE rows; the loss of A8B_LOSS_ROWS
# rows, llava cut to A8B_LOSS_LAYERS layers. A 32-token prompt puts llava's
# prefill at 2912 positions, whose blockwise attention takes blocks of
# 416 x 728 (a 31-token one, 2911 = 41 x 71, would take 71 x 41).
A8B_FAMILIES = ("llava-next-mistral-7b", "whisper-base")
A8B_ROWS, A8B_ROWS_GATE, A8B_PROMPT, A8B_GEN = 4, 2, 32, 32
A8B_LOSS_LAYERS, A8B_LOSS_ROWS = 2, 2

# Phase 16 (ROADMAP A.8c): jamba-v0.1-52b cut to JAMBA_SERVE_LAYERS of its
# 32 layers (two whole periods of 8: 25.79 B parameters, 51.6 GB in bf16;
# all 32 would need 102.6 GB) and xlstm-125m uncut (12 layers, 77.6 M
# parameters), at their published widths. The handoff gate (iii): A8C_ROWS
# rows of A8C_PROMPT-token prompts, A8C_STEPS decode steps. jamba's expert
# GEMMs (G 16) at a 4-row decode step's capacity (1) and a 512-token group's
# (80); its loss cut to its first JAMBA_GRAD_LAYERS layers (mamba + MLP,
# mamba + MoE twice each, attention + MLP: each block kind of the period),
# A8C_LOSS_ROWS rows.
A8C_FAMILIES = ("jamba-v0.1-52b", "xlstm-125m")
JAMBA_SERVE_LAYERS, JAMBA_GRAD_LAYERS = 16, 5
JAMBA_EXPERT_MS = (1, 80)
A8C_ROWS, A8C_PROMPT, A8C_STEPS, A8C_LOSS_ROWS = 4, 32, 16, 2

# Tuning (phase 13): the cells the tuner times, and its samples a plan.
TUNE_DENSE_MS = (4, 512)
TUNE_GROUPED_MS = (1, 30, 60)
TUNE_ITERS = 3


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(torch, fn, n_bufs: int, iters: int = 0, warmup: int = 2) -> float:
    """Mean device time of ``fn(i)`` by CUDA events; ``i`` cycles over
    ``n_bufs`` operand copies so weights come from device memory, not L2."""
    iters = iters or max(10, n_bufs)
    for i in range(warmup):
        fn(i % n_bufs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_bufs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of ``fn(i)`` by CUDA events around ``iters`` calls
    that the host queues behind a sleeping kernel: the device runs them back
    to back once it wakes, so the events time the device's work and not the
    host's issue rate, with no profiler. The start event must still be
    pending when the last call is queued; else the sleep was too short and
    it is taken again, four times longer. Phases 3, 5, 7 and 9 time K1, K4,
    K2 and K3 this way: torch.profiler returned traces missing kernel
    events, late in a run and once in phase 3."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000  # ~25 ms at the H100's clock
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        if not start.query():
            end.synchronize()
            return start.elapsed_time(end) / iters
        torch.cuda.synchronize()
        cycles *= 4
    raise AssertionError("the host did not queue the timed calls within the device's sleep")


def ulp(torch, x, dtype):
    """One unit in the last place of ``dtype`` at the magnitude of ``x``
    (at least its smallest subnormal)."""
    mant, emin = {torch.bfloat16: (8, -126), torch.float16: (11, -14),
                  torch.float32: (24, -126), torch.float8_e4m3fn: (4, -6),
                  torch.float8_e5m2: (3, -14)}[dtype]
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e.clamp(min=emin + 1) - mant)


def check_close(torch, out, plain, out_dtype, what):
    """Kernel output against the plain version on the same inputs
    (``plain(out_dtype)`` computes it): fp32 within rtol 1e-4 / atol 1e-3
    (only the order of sums differs); bf16, fp16, e4m3 and e5m2 within one
    ulp of the plain fp32 result, plus 1e-5 of its largest magnitude for
    sum-order noise where the result nearly cancels; int8 within 1 (a rounding boundary may fall
    between two sum orders). Returns the largest absolute difference."""
    if out_dtype == torch.int8:
        ref = plain(torch.int8)
        err = (out.int() - ref.int()).abs().max().item() if out.numel() else 0
        if err > 1:
            raise AssertionError(f"{what}: int8 off by {err}")
        return float(err)
    ref = plain(torch.float32)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = (out.float() - ref).abs()
    err = diff.max().item() if out.numel() else 0.0
    if out_dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-3, msg=what)
    else:
        tol = ulp(torch, ref, out_dtype) + 1e-5 * ref.abs().max()
        bad = (diff > tol).sum().item()
        if bad:
            raise AssertionError(f"{what}: {bad} elements beyond 1 ulp (max err {err})")
    return err


def check_routes(kern, launches, what, name="K1"):
    """Every launch of ``kern`` (K1, or K2, K4 or K5 with ``name``) counted
    since the reset went through the sm90 route."""
    if kern.launches_by_route != {"sm90": launches, "tile": 0}:
        raise AssertionError(f"{what}: {name} launches by route {kern.launches_by_route}, "
                             f"want all {launches} on sm90")


def k1_plain(a, b, c, steps, ops_):
    """K1's plain version on these inputs, as a function of the out dtype."""
    from repro_torch.kernels.opope_gemm import opope_gemm_plain

    return lambda out_dtype: opope_gemm_plain(
        a, b, c, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_)


def gemm_bound(m, k, n, n_full_operands, elem=2):
    """Least time in ms of one GEMM on the card, and what bounds it: A, B
    and the output moved once each plus the epilogue's full operands, or
    2MNK at the bf16 tensor-core rate."""
    nbytes = elem * (m * k + k * n + m * n * (1 + n_full_operands))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


K1_MS = (4, 64, 256, 512)  # rows of K1's checked and timed calls: decode slots to prefill


def kernel_phase(torch, ep, cfg, mcfg, dev):
    """Phase 3. Returns the layer's GEMMs, the per-shape timing rows and the
    largest error."""
    import importlib

    from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain
    k1mod = importlib.import_module("repro_torch.kernels.opope_gemm")

    gen = torch.Generator(device=dev).manual_seed(0)
    chains = {"none": (), "residual": ("residual",), "silu+mul": ("silu", "mul")}

    def operands(m, n, chain, dtype):
        """The chain's steps and its one full operand (none for "none")."""
        steps = chains[chain]
        if not steps:
            return steps, ()
        return steps, (torch.randn((m, n), generator=gen, device=dev).to(dtype),)

    d, dq, dkv, dff = cfg.d_model, cfg.n_heads * cfg.head_dim_, cfg.n_kv * cfg.head_dim_, cfg.d_ff
    # The 7 GEMMs of one layer: (name, K, N, chain).
    layer = [("wq", d, dq, "none"), ("wk", d, dkv, "none"), ("wv", d, dkv, "none"),
             ("wo", dq, d, "residual"), ("w_up", d, dff, "none"),
             ("w_gate", d, dff, "silu+mul"), ("w_down", dff, d, "residual")]
    # deepseek-moe-16b's K1 GEMMs: attention, router, shared experts.
    md, mdq, msh = mcfg.d_model, mcfg.n_heads * mcfg.head_dim_, mcfg.moe.d_ff_shared
    k1_shapes = {(k, n) for _, k, n, _ in layer} | {
        (md, mdq), (mdq, md), (md, mcfg.moe.n_experts), (md, msh), (msh, md)}
    max_err = 0.0
    # Correctness at both models' K1 shapes, every chain they use, on the
    # route the plan gives them (every one the sm90 route).
    for m in K1_MS:
        for kk, n in sorted(k1_shapes):
            a = torch.randn((m, kk), generator=gen, device=dev).to(torch.bfloat16)
            b = (torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5).to(torch.bfloat16)
            plan = k1mod._plan(m, n, kk, a.dtype, a.data_ptr(), b.data_ptr())
            if plan.route != "sm90":
                raise AssertionError(f"main-path shape M={m} K={kk} N={n} planned {plan}")
            for chain in chains:
                steps, ops_ = operands(m, n, chain, torch.bfloat16)
                out = opope_gemm(a, b, None, epilogue=steps, epilogue_operands=ops_)
                sync(torch, dev)
                err = check_close(torch, out, k1_plain(a, b, None, steps, ops_),
                                  torch.bfloat16, f"main M={m} K={kk} N={n} {chain}")
                max_err = max(max_err, err)
            log(f"check main-path M={m} K={kk} N={n} (config {plan.config}, splits "
                f"{plan.splits}), chains {list(chains)}: max_abs_err={max_err:.3g} ok")
        # Determinism: a split-K call twice, bitwise.
        a = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn((d, d), generator=gen, device=dev).to(torch.bfloat16)
        if not torch.equal(opope_gemm(a, b), opope_gemm(a, b)):
            raise AssertionError(f"M={m} K={d} N={d}: two calls differ")

    # Timing at the main path's (shape, chain) pairs, weights cold in L2:
    # the planned (sm90) route, the tile route on the same call, the plain
    # version and torch.matmul.
    rows = []
    # deepseek-moe-16b's K1 GEMMs of one layer (attention, router, shared
    # experts), at its decode width only.
    ds_layer = {(md, mdq, "none"), (mdq, md, "residual"), (md, mcfg.moe.n_experts, "none"),
                (md, msh, "none"), (md, msh, "silu+mul"), (msh, md, "residual")}
    timed = [(cfg.name, m, k, n, ch) for m in K1_MS
             for k, n, ch in sorted({(k, n, ch) for _, k, n, ch in layer})]
    timed += [(mcfg.name, 4, k, n, ch) for k, n, ch in sorted(ds_layer)]
    for model, m, kk, n, chain in timed:
        steps, ops_ = operands(m, n, chain, torch.bfloat16)
        b_bytes = kk * n * 2
        n_bufs = max(1, min(64, math.ceil(3 * L2_BYTES / b_bytes)))
        a = torch.randn((m, kk), generator=gen, device=dev).to(torch.bfloat16)
        bs = [(torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5).to(torch.bfloat16)
              for _ in range(n_bufs)]
        plan = k1mod._plan(m, n, kk, a.dtype, a.data_ptr(), bs[0].data_ptr())

        def sm90(i):
            return opope_gemm(a, bs[i], None, epilogue=steps, epilogue_operands=ops_)

        iters = max(20, n_bufs)
        ms = queued_ms(torch, lambda i: sm90(i % n_bufs), iters)
        event_ms = time_ms(torch, sm90, n_bufs)
        tile_ms = queued_ms(torch, lambda i: k1mod._run(
            a, bs[i % n_bufs], None, None, steps, ops_, route="tile"), iters)
        plain_ms = time_ms(torch, lambda i: opope_gemm_plain(
            a, bs[i], None, epilogue=steps, epilogue_operands=ops_), n_bufs)
        lib_ms = queued_ms(torch, lambda i: torch.matmul(a, bs[i % n_bufs]), iters)
        bound_ms, bound_by = gemm_bound(m, kk, n, len(ops_))
        out = opope_gemm(a, bs[0], None, epilogue=steps, epilogue_operands=ops_)
        err = check_close(torch, out, k1_plain(a, bs[0], None, steps, ops_),
                          torch.bfloat16, f"timed M={m} K={kk} N={n} {chain}")
        out = k1mod._run(a, bs[0], None, None, steps, ops_, route="tile")
        check_close(torch, out, k1_plain(a, bs[0], None, steps, ops_),
                    torch.bfloat16, f"timed tile route M={m} K={kk} N={n} {chain}")
        max_err = max(max_err, err)
        row = {"model": model, "m": m, "k": kk, "n": n, "epilogue": chain, "route": plan.route,
               "config": plan.config, "splits": plan.splits, "ms": ms,
               "event_ms": event_ms, "tile_ms": tile_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": err}
        rows.append(row)
        log(f"time {model} M={m} K={kk} N={n} chain={chain}: sm90 {ms:.4f} ms device (config "
            f"{plan.config}, splits {plan.splits}; {event_ms:.4f} ms a call by CUDA events, "
            f"host issue included), tile route {tile_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms "
            f"(device), plain {plain_ms:.4f} ms (events), bound {bound_ms:.4f} ms "
            f"({bound_by}), max_abs_err {err:.3g}")
    del bs

    # Coverage: ragged shapes, fp32 and bf16 in, both C forms, every op.
    n_cov = 0
    k1mod.opope_gemm.launches_by_route.update(sm90=0, tile=0)
    for m, kk, n in ((5, 40, 24), (130, 300, 200), (64, 128, 192), (1, 264, 136),
                     (63, 1032, 72), (65, 520, 200), (130, 136, 264)):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn((m, kk), generator=gen, device=dev).to(dt)
            b = torch.randn((kk, n), generator=gen, device=dev).to(dt)
            cs = {"none": None,
                  "row": torch.randn((n,), generator=gen, device=dev).to(dt),
                  "full": torch.randn((m, n), generator=gen, device=dev).to(dt)}
            row_op = torch.randn((1, n), generator=gen, device=dev)
            full_op = torch.randn((m, n), generator=gen, device=dev).to(dt)
            for c_name, c in cs.items():
                acc_max = opope_gemm_plain(a, b, c, out_dtype=torch.float32).abs().max()
                scalar = (acc_max / 100.0).reshape(1, 1)
                for name in ep.epilogue_ops():
                    kind = ep.op_kind(name)
                    ops_ = {"none": (), "row": (row_op,), "full": (full_op,),
                            "scalar": (scalar,)}[kind]
                    out_dtype = torch.int8 if name == "requant_int8" else dt
                    out = opope_gemm(a, b, c, out_dtype=out_dtype, epilogue=(name,),
                                          epilogue_operands=ops_)
                    sync(torch, dev)
                    check_close(torch, out, k1_plain(a, b, c, (name,), ops_), out_dtype,
                                f"coverage {m}x{kk}x{n} {dt} C={c_name} {name}")
                    n_cov += 1
            # One long chain, fp16 out, and the requant chain into int8.
            chain = ("gelu", "scale", "residual", "mul", "relu", "bias")
            ops_ = (row_op, full_op, full_op, row_op)
            for out_dtype in (torch.float16, dt):
                out = opope_gemm(a, b, cs["row"], out_dtype=out_dtype, epilogue=chain,
                                      epilogue_operands=ops_)
                sync(torch, dev)
                check_close(torch, out, k1_plain(a, b, cs["row"], chain, ops_), out_dtype,
                            f"coverage chain {m}x{kk}x{n} {dt} -> {out_dtype}")
                n_cov += 1
            chain = ("silu", "mul", "requant_int8")
            acc_max = opope_gemm_plain(a, b, out_dtype=torch.float32).abs().max()
            ops_ = (full_op, (acc_max / 50.0).reshape(1, 1))
            out = opope_gemm(a, b, out_dtype=torch.int8, epilogue=chain,
                                  epilogue_operands=ops_)
            sync(torch, dev)
            check_close(torch, out, k1_plain(a, b, None, chain, ops_), torch.int8,
                        f"coverage requant chain {m}x{kk}x{n} {dt}")
            n_cov += 1
    log(f"coverage: {n_cov} ragged/dtype/C/epilogue cases within tolerance, launches by "
        f"route {opope_gemm.launches_by_route}")
    return layer, rows, max_err


def model_phase(torch, np, cfg, ops, dev):
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.serve import ContinuousEngine, ServeEngine, poisson_trace

    per_forward = 7 * cfg.n_layers
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync(torch, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"init {cfg.name}: {n_params / 1e9:.3f} B params on {dev} in "
        f"{time.perf_counter() - t0:.1f} s; allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # (a) prefill through the kernel against the plain backend.
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    with torch.inference_mode():
        ref, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend="torch")
        got, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend="cuda")
    if not (torch.isfinite(ref).all() and torch.isfinite(got).all()):
        raise AssertionError("prefill logits not finite")
    if tuple(got.shape) != (2, cfg.vocab):
        raise AssertionError(f"prefill logits shape {tuple(got.shape)}")
    delta, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    if delta > 2e-2 * scale:
        raise AssertionError(f"prefill logits: max|delta| {delta} > 2e-2 * {scale}")
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"(a) prefill 2x64: max|dlogits| {delta:.4g} <= 2e-2 * max|logits| {scale:.4g}; "
        f"argmax agreement {agree:.2f}")

    # (b) the main path: continuous batching over a Poisson trace.
    eng = ContinuousEngine(cfg=cfg, params=params, n_slots=4, max_len=256)
    eng.serve(poisson_trace(2, seed=1, vocab=cfg.vocab, prompt_lens=(32,), gen_lens=(4,)))
    trace = poisson_trace(8, seed=0, vocab=cfg.vocab, prompt_lens=(32, 64, 128),
                          gen_lens=(8, 16, 32))
    ops.reset_counts()
    opope_gemm.launches = 0
    opope_gemm.launches_by_route.update(sm90=0, tile=0)
    report = eng.timed_serve(trace)
    launches = opope_gemm.launches
    want = per_forward * (report.decode_steps + report.prefill_batches)
    if launches != want or ops.backend("torch").calls != 0:
        raise AssertionError(f"kernel launches {launches} != {want} (torch calls "
                             f"{ops.backend('torch').calls})")
    check_routes(opope_gemm, launches, "4(b)")
    for r in trace:
        out = report.outputs[r.rid]
        if len(out) != r.max_new_tokens or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"request {r.rid}: bad output {out}")
    log(f"(b) continuous: {len(trace)} requests, {report.generated_tokens} tokens, "
        f"decode_steps {report.decode_steps}, prefill_batches {report.prefill_batches}, "
        f"mean_occupancy {report.mean_occupancy:.3f}, wall {report.wall_time_s:.3f} s, "
        f"{report.tokens_per_sec:.1f} tokens/s, TTFT p50 {report.ttft_p50 * 1e3:.1f} ms, "
        f"ITL p50 {report.itl_p50 * 1e3:.1f} ms, kernel launches {launches} "
        f"= 7 * {cfg.n_layers} * ({report.decode_steps} + {report.prefill_batches}), "
        f"all on the sm90 route")

    # (c) the lockstep engine.
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(dev)
    opope_gemm.launches = 0
    opope_gemm.launches_by_route.update(sm90=0, tile=0)
    t0 = time.perf_counter()
    toks = ServeEngine(cfg=cfg, params=params, max_len=80).generate({"tokens": prompts}, 16)
    toks_host = toks.cpu()
    dt = time.perf_counter() - t0
    if tuple(toks_host.shape) != (4, 16) or not ((toks_host >= 0) & (toks_host < cfg.vocab)).all():
        raise AssertionError(f"static engine output {tuple(toks_host.shape)}")
    if opope_gemm.launches != per_forward * 16:
        raise AssertionError(f"static launches {opope_gemm.launches} != {per_forward * 16}")
    check_routes(opope_gemm, opope_gemm.launches, "4(c)")
    log(f"(c) static: 4 x 64-token prompts, 16 tokens each in {dt:.3f} s "
        f"({64 / dt:.1f} tokens/s), kernel launches {opope_gemm.launches}")

    # (d) one lockstep decode step at 4 rows: host wall time per step.
    with torch.inference_mode():
        logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 96)
        tok = logits.argmax(-1)[:, None]
        for i in range(3):
            logits, caches = api.decode(cfg, params, tok, caches, 64 + i)
        sync(torch, dev)
        n_steps = 16
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, caches = api.decode(cfg, params, tok, caches, 67 + i)
        sync(torch, dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        prof = None
        if dev.type == "cuda":
            prof = decode_profile(torch, lambda i: api.decode(cfg, params, tok, caches, 83 + i),
                                  step_ms)
    dev_ms = None
    if prof is not None:
        bound = sum(1e3 * t.numel() * t.element_size() / HBM_BYTES_PER_S
                    for t in _leaves(params["blocks"]) if t.ndim >= 2)
        dev_ms = {"k1": sum(ms for key, ms, _ in prof if "opope_gemm_kernel" in key),
                  "busy": sum(ms for _, ms, _ in prof), "k1_byte_bound": bound}
        log(f"(d) decode step, 4 rows: {step_ms:.3f} ms wall; device busy {dev_ms['busy']:.3f} ms, "
            f"K1 {dev_ms['k1']:.3f} ms ({per_forward} launches, byte bound {bound:.3f} ms)")
    return {"continuous": report, "launches": launches, "decode_step_ms": step_ms,
            "device_ms": dev_ms, "params": params}


def _reset_k1(ops, opope_gemm):
    """Every count K1's gates read set to zero."""
    ops.reset_counts()
    opope_gemm.launches = 0
    opope_gemm.launches_by_route.update(sm90=0, tile=0)


def _valid_outputs(report, trace, vocab, what):
    for r in trace:
        out = report.outputs[r.rid]
        if len(out) != r.max_new_tokens or not all(0 <= t < vocab for t in out):
            raise AssertionError(f"{what}: request {r.rid}: bad output {out}")


def _same_streams(a, b):
    """Share of requests whose greedy token streams are identical."""
    return sum(a.outputs[rid] == b.outputs[rid] for rid in a.outputs) / len(a.outputs)


def _prefix_gate(torch, np, cfg, params, ops, dev, tag, *, int8_lane=False):
    """Phase 4(f) on a dense model's resident weights (chatglm3-6b in phase 4,
    stablelm-12b in 14(a)): the continuous engine with and without chunked
    prefill and the prefix cache on the reference's prefix-cache trace, every
    K1 launch counted and on sm90, and the teacher-forced logits of features
    on against off under PROMPT_LOGIT_FLOOR_FACTOR x the plain GEMM's RMS gap
    of this run. With ``int8_lane``, 4(g)'s int8 K/V engine on the same
    trace too. Returns the record and the features-on engine."""
    from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain
    from repro_torch.models import api
    from repro_torch.serve import ContinuousEngine, Scheduler, SlotPool, shared_prefix_trace
    from repro_torch.serve import continuous as cont_mod

    per_forward = 7 * cfg.n_layers
    out = {}
    # The prefix cache on the reference's bench_prefix_cache trace
    # (benchmarks/serving_bench.py): 12 prompts opening with one 192-token
    # system prompt. Each engine serves it once as a warm-up (which fills
    # the trie, as a long-lived server's would be) before the timed serve.
    def trace():
        return shared_prefix_trace(12, seed=0, vocab=cfg.vocab, prefix_len=192,
                                   tail_lens=(8, 12, 16), gen_lens=(8, 16, 24),
                                   mean_interarrival=2.0)

    def timed(eng, what):
        eng.serve(trace())
        stats0 = eng.prefix_cache_stats()
        chunk_steps = []

        def counting(*a, **kw):
            chunk_steps.append(1)
            return orig(*a, **kw)

        _reset_k1(ops, opope_gemm)
        with _patched(cont_mod.model_api, "prefill_chunk", counting) as orig:
            report = eng.timed_serve(trace())
        forwards = report.decode_steps + (len(chunk_steps) if eng.prefill_chunk
                                          else report.prefill_batches)
        if opope_gemm.launches != per_forward * forwards or ops.backend("torch").calls != 0:
            raise AssertionError(f"{what}: K1 launches {opope_gemm.launches} != {per_forward} * "
                                 f"{forwards} forwards")
        check_routes(opope_gemm, opope_gemm.launches, what)
        _valid_outputs(report, trace(), cfg.vocab, what)
        stats = eng.prefix_cache_stats()
        hits = misses = None
        if stats is not None:
            hits, misses = stats["hits"] - stats0["hits"], stats["misses"] - stats0["misses"]
            if (hits, misses) != (12, 0):
                raise AssertionError(f"{what}: {hits} hits, {misses} misses in the timed run, "
                                     f"want 12 and 0")
        log(f"{what}: {report.generated_tokens} tokens, decode_steps {report.decode_steps}, "
            f"chunk steps {len(chunk_steps)}, prefill_batches {report.prefill_batches}, wall "
            f"{report.wall_time_s:.3f} s, {report.tokens_per_sec:.1f} tokens/s, TTFT p50 "
            f"{report.ttft_p50 * 1e3:.1f} ms, ITL p50 {report.itl_p50 * 1e3:.1f} ms, K1 launches "
            f"{opope_gemm.launches} = 7 * {cfg.n_layers} * {forwards}, all on the sm90 route"
            + ("" if stats is None else f"; prefix hits {hits}, misses {misses}, cached_tokens "
               f"{stats['cached_tokens']}") + f"; kv_bytes_per_slot {report.kv_bytes_per_slot:.0f}")
        return report, {"tokens_per_s": report.tokens_per_sec, "ttft_p50_s": report.ttft_p50,
                        "itl_p50_s": report.itl_p50, "decode_steps": report.decode_steps,
                        "chunk_steps": len(chunk_steps), "k1_launches": opope_gemm.launches,
                        "hits": hits, "misses": misses,
                        "kv_bytes_per_slot": report.kv_bytes_per_slot}

    def forced(eng, stream, steps=7):
        """The engine's own join path for the trace's requests, ``n_slots``
        at a time into a fresh pool (prefix attach and suffix chunks, or a
        bucketed prefill), then ``steps`` decode steps fed ``stream``'s
        greedy tokens: logits [requests, 1 + steps, V] in fp32."""
        reqs, outs = trace(), []
        with torch.inference_mode():
            for b0 in range(0, len(reqs), eng.n_slots):
                batch = reqs[b0:b0 + eng.n_slots]
                sched = Scheduler(cfg, max_bucket=eng.max_len)
                pool = SlotPool.create(cfg, eng.n_slots, eng.max_len, eng.cache_dtype, dev,
                                       kv_format=eng.kv_format)
                plens = [len(r.prompt) for r in batch]
                if eng.prefill_chunk:
                    pj = eng._begin_join(sched, pool, batch, 0)
                    while not pj.all_done:
                        eng._advance_chunk(pj)
                    pool.join(pj.caches, pj.slots, pj.floors)
                    for nodes in pj.nodes:
                        if nodes:
                            eng._trie.release(nodes)
                    first, slots = pj.first_logits[: len(batch)], pj.slots
                else:
                    toks = np.zeros((len(batch), sched.bucket(max(plens))), np.int64)
                    for i, r in enumerate(batch):
                        toks[i, : plens[i]] = r.prompt
                    first, caches = api.prefill_bucketed(
                        cfg, params, torch.from_numpy(toks).to(dev),
                        torch.tensor(plens, device=dev), eng.cache_dtype)
                    slots = pool.allocate([r.rid for r in batch])
                    pool.join(caches, slots)
                if slots != list(range(len(batch))):
                    raise AssertionError(f"forced join leased slots {slots}")
                pos = torch.tensor(plens, device=dev)
                rows = [first.float()]
                for j in range(steps):
                    tok = torch.tensor([[stream.outputs[r.rid][j]] for r in batch], device=dev)
                    logits, pool.caches = api.decode_at(cfg, params, tok, pool.caches, pos)
                    rows.append(logits.float())
                    pos = pos + 1
                outs.append(torch.stack(rows, 1))
        return torch.cat(outs)

    common = dict(cfg=cfg, params=params, n_slots=4, max_len=288)
    off_eng = ContinuousEngine(**common, prefill_chunk=None, prefix_cache=False)
    off, out["off"] = timed(off_eng, f"{tag} features off")
    with _patched(ops.backend("cuda"), "fn", opope_gemm_plain):
        plain = ContinuousEngine(**common, prefill_chunk=None, prefix_cache=False).serve(trace())
    on_eng = ContinuousEngine(**common, prefill_chunk=32, prefix_cache=True, prefix_block=32)
    on, out["on"] = timed(on_eng, f"{tag} chunked prefill + prefix cache")
    # Greedy agreement of whole streams is printed, not gated: in bf16 a
    # near-tied greedy choice flips under rounding alone (chunk attention
    # and blockwise attention round differently, and K1 runs at other M,
    # as it does against the plain GEMM), and one flip changes the rest of
    # the stream, so over 12 requests the share moves by 1/12 steps between
    # equally valid variants. The gate below compares logits instead.
    agree, floor = _same_streams(on, off), _same_streams(off, plain)
    log(f"{tag} greedy streams identical, features on vs off: {agree:.4f} of requests; kernels "
        f"vs the plain GEMM, features off: {floor:.4f} (not gated)")
    # The gate: the engine's own join path (prefix attach + suffix chunk,
    # or bucketed prefill), then 7 decode steps over the joined pool fed
    # the features-off run's greedy tokens (teacher forcing), for the 12
    # requests in 3 joins of 4. The logits of features on against off must
    # stay within PROMPT_LOGIT_FLOOR_FACTOR of the RMS difference that the
    # plain GEMM makes on the features-off path in this run. A wrong
    # attach, chunk write, scale or slot moves logits by their own size.
    ref = forced(off_eng, off)
    with _patched(ops.backend("cuda"), "fn", opope_gemm_plain):
        ref_plain = forced(off_eng, off)
    got = forced(on_eng, off)
    d_floor = (ref_plain - ref).pow(2).mean().sqrt().item()
    d_on = (got - ref).pow(2).mean().sqrt().item()
    arg_on = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    arg_floor = (ref_plain.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"{tag} teacher-forced logits, 12 requests x (first token + 7 decode steps): features on "
        f"vs off RMS {d_on:.4g} (gated <= {PROMPT_LOGIT_FLOOR_FACTOR} x {d_floor:.4g}, the plain "
        f"GEMM vs the kernels, features off); argmax agreement {arg_on:.4f} (floor "
        f"{arg_floor:.4f}); max|logits| {ref.abs().max().item():.4g}")
    if not d_on <= PROMPT_LOGIT_FLOOR_FACTOR * d_floor:
        raise AssertionError(f"{tag} features on vs off logits RMS {d_on} > "
                             f"{PROMPT_LOGIT_FLOOR_FACTOR} x {d_floor}")
    out["agreement"] = {"streams_on_vs_off": agree, "streams_kernels_vs_plain": floor,
                        "logit_rms_on_vs_off": d_on, "logit_rms_kernels_vs_plain": d_floor,
                        "argmax_on_vs_off": arg_on, "argmax_kernels_vs_plain": arg_floor}
    if not int8_lane:
        return out, on_eng

    # (g) int8 K/V lanes with the prefix cache, on a fresh engine.
    q8_eng = ContinuousEngine(**common, prefill_chunk=32, prefix_cache=True, prefix_block=32,
                              kv_format="int8")
    q8, out["int8"] = timed(q8_eng, "(g) int8 K/V + chunked prefill + prefix cache")
    ratio = q8.kv_bytes_per_slot / off.kv_bytes_per_slot
    if ratio > 0.51:
        raise AssertionError(f"(g) int8 pool {q8.kv_bytes_per_slot} bytes a slot, "
                             f"{ratio:.4f} of bf16's")
    out["int8"]["agreement_vs_bf16_pool"] = _same_streams(q8, on)
    d_q8 = (forced(q8_eng, off) - got).pow(2).mean().sqrt().item()
    out["int8"]["logit_rms_vs_bf16_pool"] = d_q8
    log(f"(g) kv_bytes_per_slot {q8.kv_bytes_per_slot:.0f} = {ratio:.4f} of the bf16 pool's "
        f"{off.kv_bytes_per_slot:.0f} (gated <= 0.51); against the bf16 pool (both features "
        f"on): greedy streams identical {out['int8']['agreement_vs_bf16_pool']:.4f}, "
        f"teacher-forced logits RMS {d_q8:.4g} (neither gated)")
    return out, on_eng


def prompt_phase(torch, np, cfg, params, ops, dev):
    """Phase 4(e)-(g) on chatglm3-6b's resident weights: chunked prefill
    against bucketed prefill, the prefix cache, and int8 K/V lanes."""
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.quant.kvcache import _dequant, quantize_kv_rows
    from repro_torch.serve import PrefixCache

    per_forward = 7 * cfg.n_layers
    out = {}

    # (e) a 4 x 200-token prefill in chunks of 32 against the bucketed
    # prefill of the same prompts (bucket 256), at 4(a)'s tolerance.
    rows, plen, w, lb = 4, 200, 32, 256
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (rows, plen))
    padded = np.zeros((rows, lb), np.int64)
    padded[:, :plen] = tokens
    n_chunks = -(-plen // w)
    with torch.inference_mode():
        ref, ref_c = api.prefill_bucketed(cfg, params, torch.from_numpy(padded).to(dev),
                                          torch.full((rows,), plen, device=dev))
        caches = api.init_state(cfg, rows, lb, torch.bfloat16, dev)
        _reset_k1(ops, opope_gemm)
        for j in range(n_chunks):
            off, end = j * w, min((j + 1) * w, plen)
            ctoks = np.zeros((rows, w), np.int64)
            ctoks[:, : end - off] = tokens[:, off:end]
            got, caches = api.prefill_chunk(
                cfg, params, torch.from_numpy(ctoks).to(dev), caches,
                torch.full((rows,), off, device=dev),
                torch.full((rows,), end - 1 - off, device=dev))
    if opope_gemm.launches != per_forward * n_chunks or ops.backend("torch").calls != 0:
        raise AssertionError(f"4(e) K1 launches {opope_gemm.launches} != {per_forward} * "
                             f"{n_chunks} chunk steps")
    check_routes(opope_gemm, opope_gemm.launches, "4(e)")
    if not torch.isfinite(got).all() or tuple(got.shape) != (rows, cfg.vocab):
        raise AssertionError(f"4(e) chunked logits {tuple(got.shape)} not finite or misshapen")
    delta, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    if delta > 2e-2 * scale:
        raise AssertionError(f"4(e) chunked logits: max|delta| {delta} > 2e-2 * {scale}")
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    dk = max((c.k[:, :plen].float() - r.k[:, :plen].float()).abs().max().item()
             for c, r in zip(caches, ref_c))
    log(f"(e) chunked prefill 4 x {plen} in {n_chunks} chunks of {w}: max|dlogits| {delta:.4g} "
        f"<= 2e-2 * max|logits| {scale:.4g} against bucketed prefill (bucket {lb}); argmax "
        f"agreement {agree:.2f}; max|dK| over the layers {dk:.4g} (not gated); K1 launches "
        f"{opope_gemm.launches} = 7 * {cfg.n_layers} * {n_chunks}, all on the sm90 route")
    out["chunked"] = {"max_abs_dlogits": delta, "max_abs_logits": scale, "argmax_agreement": agree,
                      "k1_launches": opope_gemm.launches, "chunk_steps": n_chunks}

    prefix_out, on_eng = _prefix_gate(torch, np, cfg, params, ops, dev, "(f)", int8_lane=True)
    out.update(prefix_out)

    # (g) on the card, bitwise: a full-precision trie's gather gives back
    # the K/V its path was inserted from (copies, not views), and int8
    # scale adoption gives back the stored codes.
    trie = PrefixCache(block_size=32)
    trie.insert(tokens[0].tolist(), plen, ref_c, 0)
    path, matched = trie.match(tokens[0].tolist())
    spans, _ = trie.gather(path)
    for c, (k, v) in zip(ref_c, spans):
        if not (torch.equal(k, c.k[0, :matched]) and torch.equal(v, c.v[0, :matched])):
            raise AssertionError("(g) trie gather differs from the inserted K/V")
    if any(x.untyped_storage().data_ptr() in (c.k.untyped_storage().data_ptr(),
                                              c.v.untyped_storage().data_ptr())
           for n in path for c, p in zip(ref_c, n.payload) for x in p):
        raise AssertionError("(g) a trie payload is a view of the prefill's buffer")
    n_kv, k0, v0 = cfg.n_kv, ref_c[0].k[:, :matched].float(), ref_c[0].v[:, :matched].float()
    k_q, v_q, k_s, v_s = quantize_kv_rows(k0, v0, n_kv, fmt="int8")
    small = torch.full((rows, 16, k0.shape[-1]), 1e-4, device=dev)
    k_q2, v_q2, k_s2, v_s2 = quantize_kv_rows(
        torch.cat([_dequant(k_q, k_s, torch.float32), small], 1),
        torch.cat([_dequant(v_q, v_s, torch.float32), small], 1),
        n_kv, fmt="int8", k_scale_floor=k_s, v_scale_floor=v_s)
    if not (torch.equal(k_q2[:, :matched], k_q) and torch.equal(v_q2[:, :matched], v_q)
            and torch.equal(k_s2, k_s) and torch.equal(v_s2, v_s)):
        raise AssertionError("(g) int8 scale adoption changed a code or a scale")
    log(f"(g) bitwise on the card: the trie's gather of a {matched}-token path over "
        f"{cfg.n_layers} layers equals the K/V it was inserted from (payloads are copies); "
        f"int8 scale adoption over {rows} x {matched} x {k0.shape[-1]} K/V gives back every "
        f"code and scale")
    return out, on_eng


# Profiler sessions 4(h) makes at most for one comparison: a session whose
# trace lacks a marker that cuts its runs apart is made again.
TRACE_SESSIONS = 3


def _device_traces(torch, fns, what):
    """Each of ``fns`` in turn inside one torch.profiler session (CUDA
    activity only): for each, (device activity names in launch order,
    device-to-host copies, host synchronizations, its result).

    Everything is ordered by CUPTI correlation id, which counts the host's
    runtime calls (launches, copies, syncs) and tags each device event with
    its launch's: by start time, one fill and one sin kernel of a
    151358-kernel serve traded places between two runs on an H100. The runs
    are compared inside one session, cut apart by marker kernels (a
    complex64 fill: the port launches no complex kernel). The profiler
    drops the first device events of a session, more in each later session
    of a process (on an H100: a serve's first 7 to 29 kernels), so 64 int16
    fills, another kernel than the cuts', pad the session's start. The
    session ends on a synchronize after the last cut. A cut can still be
    missing: on an H100 a session's start has dropped more than the
    padding, and a cut past the start was lost with the synchronize in
    place and without it (cut apart then by the last markers of one kind,
    the runs began at the padding and the first read as empty). So a
    session whose trace lacks a cut is profiled again, TRACE_SESSIONS
    times in all, and says so. Events come from the Kineto results
    directly (``prof.events()`` takes minutes at 10^5 kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad():
        torch.full((1,), 7, dtype=torch.int16, device="cuda")

    def cut():
        torch.full((1,), 7, dtype=torch.complex64, device="cuda")

    for attempt in range(1, TRACE_SESSIONS + 1):
        results = []
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                pad()
            torch.cuda.synchronize()
            for fn in fns:
                cut()
                results.append(fn())
                torch.cuda.synchronize()
            cut()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        raw = prof.profiler.kineto_results.events()
        device = sorted((e.correlation_id(), e.start_ns(), e.name()) for e in raw
                        if e.device_type() == DeviceType.CUDA)
        cuts = [c for c, _, n in device if "FillFunctor<c10::complex" in n]
        if len(cuts) == len(fns) + 1:
            break
        log(f"(h) {what}: the profiler recorded {len(cuts)} of the {len(fns) + 1} markers "
            f"that cut the runs apart (session {attempt} of at most {TRACE_SESSIONS}; "
            f"{len(device)} device events)"
            + ("; profiling again" if attempt < TRACE_SESSIONS else ""))
    else:
        raise AssertionError(f"4(h) {what}: in {TRACE_SESSIONS} sessions the profiler never "
                             f"recorded all {len(fns) + 1} markers that cut the runs apart")
    syncs = [e.correlation_id() for e in raw
             if e.device_type() != DeviceType.CUDA and "Synchronize" in e.name()]
    out = []
    for i, result in enumerate(results):
        dev = [n for c, _, n in device if cuts[i] < c < cuts[i + 1]]
        d2h = sum("DtoH" in x or "Device -> Pageable" in x or "Device -> Pinned" in x
                  for x in dev)
        n_sync = sum(cuts[i] < c < cuts[i + 1] for c in syncs)
        if not n_sync:  # each run ends on a synchronize of its own
            raise AssertionError(f"4(h) {what}: no host sync recorded in run {i}")
        out.append((dev, d2h, n_sync, result))
    log(f"(h) {what}: {len(device)} device events; runs under the profiler {t1 - t0:.1f} s, "
        f"its session's end and the trace read {time.perf_counter() - t1:.1f} s")
    return out


def _first_difference(a, b):
    """Where two name sequences part, and which names one has more of."""
    import collections

    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    ca, cb = collections.Counter(a), collections.Counter(b)
    return (f"first difference at event {i} ({a[i:i + 1]} vs {b[i:i + 1]}); more on the "
            f"left: {dict((ca - cb).most_common(3))}; more on the right: "
            f"{dict((cb - ca).most_common(3))}")


def telemetry_phase(torch, cfg, params, ops, dev, warm_eng):
    """Phase 4(h) on chatglm3-6b's resident weights: telemetry on against
    off (the same device kernels, copies and syncs; host cost a step and a
    GEMM call), the lifecycle trace and SLO goodput on the prefix-cache
    trace, and the scrape surface."""
    import os
    import threading
    import urllib.request

    from repro_torch import obs
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.obs import attr as obs_attr
    from repro_torch.obs import http as obs_http
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import tracing as obs_tracing
    from repro_torch.serve import ContinuousEngine, SlotPool, poisson_trace, shared_prefix_trace

    out = {}
    t_phase = time.perf_counter()
    obs.reset()
    obs_tracing.reset()

    # (i) a 4-row masked decode step as the engine runs it: its step scope,
    # the decode, the per-tick attribution and histogram.
    eng = ContinuousEngine(cfg=cfg, params=params, n_slots=4, max_len=256)
    pool = SlotPool.create(cfg, 4, 256, torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tok0 = torch.randint(0, cfg.vocab, (4, 1), device=dev, generator=gen)
    pos0 = torch.full((4,), 64, dtype=torch.int64, device=dev)
    active = torch.ones(4, dtype=torch.bool, device=dev)

    def tick():
        t0 = time.perf_counter()
        with torch.inference_mode(), eng._steps.dispatch(("decode",), "decode") as st:
            tok, pool.caches, _ = eng._decode(pool.caches, tok0, pos0, active, gen)
        dt = time.perf_counter() - t0
        obs.histogram("serve.step_seconds").observe(dt)
        if st.workload:
            obs_attr.observe_step(st.workload, dt)
        return tok

    def with_telemetry(flag, fn):
        prev = obs_metrics.set_enabled(flag)
        try:
            return fn()
        finally:
            obs_metrics.set_enabled(prev)

    tick()  # the capturing dispatch
    sync(torch, dev)
    step_trace = dict(zip((True, False), _device_traces(
        torch, [functools.partial(with_telemetry, flag, tick) for flag in (True, False)],
        "decode step")))
    if step_trace[True][:3] != step_trace[False][:3]:
        raise AssertionError(f"4(h) decode step: telemetry on and off differ: "
                             f"{len(step_trace[True][0])} vs {len(step_trace[False][0])} device "
                             f"events, D2H {step_trace[True][1]} vs {step_trace[False][1]}, "
                             f"syncs {step_trace[True][2]} vs {step_trace[False][2]}; "
                             + _first_difference(step_trace[True][0], step_trace[False][0]))
    if not torch.equal(step_trace[True][3], step_trace[False][3]):
        raise AssertionError("4(h) decode step: the sampled tokens differ on and off")
    n_k1 = sum("opope_gemm_kernel" in n for n in step_trace[True][0])
    if n_k1 != 7 * cfg.n_layers:
        raise AssertionError(f"4(h) decode step: {n_k1} K1 kernels in the trace, want "
                             f"{7 * cfg.n_layers}")
    # Host wall of single steps, telemetry on and off in turns (the host's
    # own spread is wide: 46-95 ms a step from run to run).
    walls = {True: [], False: []}
    gc.collect()
    for i in range(48):
        flag = (i % 4) in (0, 3)  # on, off, off, on, ...

        def timed_step(flag=flag):
            t0 = time.perf_counter()
            tick()
            walls[flag].append(time.perf_counter() - t0)
        with_telemetry(flag, timed_step)
    sync(torch, dev)
    quart = {flag: [1e3 * sorted(w)[len(w) * q // 4] for q in (1, 2, 3)]
             for flag, w in walls.items()}
    med = {flag: q[1] for flag, q in quart.items()}
    # The host time of one direct K1 call at the decode step's wq shape:
    # telemetry on (every direct call counts), off, and inside a quiet step
    # scope (what a served step's later dispatches pay).
    x = torch.randn(4, cfg.d_model, device=dev, dtype=torch.bfloat16)
    w = params["blocks"][0]["attn"]["wq"]["w"]

    def call_us(n=300):
        ops.matmul(x, w)
        sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(n):
            ops.matmul(x, w)
        host = time.perf_counter() - t0
        sync(torch, dev)
        return 1e6 * host / n

    def quiet_us():
        with obs_attr.step_scope(False):
            return call_us()

    per_call = {"on": with_telemetry(True, call_us), "off": with_telemetry(False, call_us),
                "quiet_scope": with_telemetry(True, quiet_us)}
    log(f"(h)(i) 4-row masked decode step: {len(step_trace[True][0])} device events, "
        f"{n_k1} K1, D2H copies {step_trace[True][1]}, host syncs {step_trace[True][2]}, "
        f"identical with telemetry on and off; wall over {len(walls[True])} steps each, in "
        f"turns (quartiles): on {quart[True][0]:.3f} / {med[True]:.3f} / {quart[True][2]:.3f} "
        f"ms, off {quart[False][0]:.3f} / {med[False]:.3f} / {quart[False][2]:.3f} ms (medians "
        f"{med[True] - med[False]:+.3f} ms); host "
        f"time a direct GEMM call ({x.shape[0]}x{w.shape[0]} @ {w.shape[0]}x{w.shape[1]} on "
        f"K1): on {per_call['on']:.2f} us, off {per_call['off']:.2f} us, in a quiet step "
        f"scope {per_call['quiet_scope']:.2f} us")

    t_step = time.perf_counter()
    # (i) a whole serve of 4(b)'s Poisson trace on fresh engines, on and off.
    def poisson():
        return poisson_trace(8, seed=0, vocab=cfg.vocab, prompt_lens=(32, 64, 128),
                             gen_lens=(8, 16, 32))

    def serve_fresh():
        e = ContinuousEngine(cfg=cfg, params=params, n_slots=4, max_len=256)
        _reset_k1(ops, opope_gemm)
        report = e.serve(poisson())
        check_routes(opope_gemm, opope_gemm.launches, "4(h) serve")
        return report, opope_gemm.launches

    on, off = (trace[:3] + trace[3] for trace in _device_traces(
        torch, [functools.partial(with_telemetry, flag, serve_fresh) for flag in (True, False)],
        "serve"))
    if on[:3] != off[:3] or on[4] != off[4]:
        raise AssertionError(f"4(h) serve: telemetry on and off differ: {len(on[0])} vs "
                             f"{len(off[0])} device events, D2H {on[1]} vs {off[1]}, syncs "
                             f"{on[2]} vs {off[2]}, K1 launches {on[4]} vs {off[4]}; "
                             + _first_difference(on[0], off[0]))
    if on[3].outputs != off[3].outputs:
        raise AssertionError("4(h) serve: greedy streams differ with telemetry on and off")
    n_k1 = sum("opope_gemm_kernel" in n for n in on[0])
    if n_k1 != on[4] or on[1] < 1:
        raise AssertionError(f"4(h) serve: {n_k1} K1 kernels in the trace against {on[4]} "
                             f"launches counted; {on[1]} D2H copies")
    log(f"(h)(i) serve of 4(b)'s trace: {len(on[0])} device events ({n_k1} K1, all sm90), "
        f"D2H copies {on[1]}, host syncs {on[2]}, identical with telemetry on and off; greedy "
        f"streams identical")
    t_serve = time.perf_counter()
    out["on_off"] = {"decode_step_wall_ms_quartiles": quart, "gemm_call_host_us": per_call,
                     "decode_step_device_events": len(step_trace[True][0]),
                     "serve_device_events": len(on[0]), "serve_d2h": on[1],
                     "serve_syncs": on[2]}

    # (ii) the bench_prefix_cache trace on 4(f)'s engine (chunked prefill,
    # the prefix cache; its trie warm) with SLOs set.
    def prefix_trace():
        return shared_prefix_trace(12, seed=0, vocab=cfg.vocab, prefix_len=192,
                                   tail_lens=(8, 12, 16), gen_lens=(8, 16, 24),
                                   mean_interarrival=2.0)

    os.environ["REPRO_METRICS_PORT"] = "0"
    server = obs_http.maybe_serve_from_env()

    def fetch(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}", timeout=10) as r:
            return r.read().decode()

    try:
        obs.reset()
        obs_tracing.reset()
        warm_eng.slo_ttft_ms = warm_eng.slo_itl_ms = 1e9
        report = warm_eng.timed_serve(prefix_trace())
        snap = obs.snapshot()
        c = snap["counters"]
        reqs = obs_tracing.snapshot()["requests"]
        phases = ("queue", "prefix_attach", "chunk_prefill")
        worst = 0.0
        for r in reqs:
            names = [p["name"] for p in r["phases"]]
            if names != list(phases) + ["decode"]:
                raise AssertionError(f"4(h) request {r['rid']}: phases {names}")
            (first,) = [i for i in r["instants"] if i["name"] == "first_token"]
            total = sum(p["t1"] - p["t0"] for p in r["phases"] if p["name"] in phases)
            worst = max(worst, abs(total - first["ttft_s"]))
        if len(reqs) != 12 or worst > 1e-9:
            raise AssertionError(f"4(h) {len(reqs)} requests traced; phases off TTFT by {worst}")
        n_spans = obs_tracing.validate_chrome_trace(obs_tracing.chrome_trace())
        hits = c.get("serve.prefix_cache.hits", {}).get("", 0)
        misses = c.get("serve.prefix_cache.misses", {}).get("", 0)
        served = c["serve.requests"]
        tokens = c["serve.tokens"][""]
        if (n_spans, hits, misses) != (12, 12, 0) or served != {"event=admitted": 12,
                                                               "event=retired": 12}:
            raise AssertionError(f"4(h) spans {n_spans}, hits {hits}, misses {misses}, "
                                 f"requests {served}")
        # serve.tokens counts decode-step tokens; each request's first token
        # comes from its prefill logits at the join.
        if tokens + served["event=admitted"] != report.generated_tokens:
            raise AssertionError(f"4(h) serve.tokens {tokens} + 12 first tokens != "
                                 f"generated {report.generated_tokens}")
        if report.goodput != 1.0:
            raise AssertionError(f"4(h) goodput at SLO 1e9 ms: {report.goodput}")
        fractions = {}
        for label, h in snap["histograms"]["gemm.roofline_fraction"].items():
            d = dict(p.split("=", 1) for p in label.split(","))
            fractions[d["bucket"]] = (h["count"], h["p50"], h["max"])
            if d["backend"] != "cuda" or not 0.0 < h["max"] <= 1.0:
                raise AssertionError(f"4(h) roofline fraction {label}: {h}")
        decode_buckets = {e.bucket for e in warm_eng._steps.workloads[("decode",)].values()}
        chunk_buckets = {e.bucket for k, wl in warm_eng._steps.workloads.items() if len(k) == 4
                         for e in wl.values()}
        if not decode_buckets <= set(fractions) or not chunk_buckets & set(fractions):
            raise AssertionError(f"4(h) K1 buckets without a roofline fraction: decode "
                                 f"{sorted(decode_buckets - set(fractions))}; chunk steps "
                                 f"read {sorted(chunk_buckets & set(fractions))}")
        decode_frac = fractions[sorted(decode_buckets)[0]][1]
        log(f"(h)(ii) prefix-cache trace, chunked prefill + prefix cache, SLOs 1e9 ms: 12 "
            f"requests, phases sum to TTFT (worst {worst:.2g} s), {n_spans} spans validated, "
            f"hits {hits}, misses {misses}, admitted/retired 12/12, serve.tokens {tokens:.0f} + "
            f"12 first tokens = {report.generated_tokens}, goodput {report.goodput}; p50 queue "
            f"{report.queue_p50 * 1e3:.3f} ms, attach {report.attach_p50 * 1e3:.3f} ms, chunk "
            f"prefill {report.chunk_prefill_p50 * 1e3:.3f} ms, TTFT {report.ttft_p50 * 1e3:.3f} "
            f"ms, ITL {report.itl_p50 * 1e3:.3f} ms, {report.tokens_per_sec:.1f} tokens/s")
        for bucket, (n, p50, mx) in sorted(fractions.items()):
            log(f"(h)(ii)   gemm.roofline_fraction {bucket}: {n} steps, p50 {p50:.4g}, max "
                f"{mx:.4g}")
        out["prefix_trace"] = {
            "tokens_per_s": report.tokens_per_sec, "ttft_p50_s": report.ttft_p50,
            "queue_p50_s": report.queue_p50, "attach_p50_s": report.attach_p50,
            "chunk_prefill_p50_s": report.chunk_prefill_p50, "itl_p50_s": report.itl_p50,
            "roofline_fraction": fractions, "decode_roofline_fraction_p50": decode_frac}

        # The same at SLOs of 1e-6 ms, with /requests polled while it runs.
        seen, stop = [], threading.Event()

        def poll():
            while not stop.is_set():
                seen.append(len(json.loads(fetch("/requests"))))
                stop.wait(0.2)

        poller = threading.Thread(target=poll, daemon=True)
        warm_eng.slo_ttft_ms = warm_eng.slo_itl_ms = 1e-6
        poller.start()
        try:
            report = warm_eng.serve(prefix_trace())
        finally:
            stop.set()
            poller.join(timeout=10)
        if report.goodput != 0.0:
            raise AssertionError(f"4(h) goodput at SLO 1e-6 ms: {report.goodput}")
        # (iii) the scrape surface after the run.
        scraped = fetch("/metrics")
        if scraped != obs.prometheus_text():
            raise AssertionError("4(h) /metrics differs from prometheus_text()")
        n_trace = obs_tracing.validate_chrome_trace(json.loads(fetch("/trace")))
        if n_trace != 24 or not seen or max(seen) < 1 or json.loads(fetch("/requests")):
            raise AssertionError(f"4(h) /trace spans {n_trace}, /requests in flight {seen}")
        log(f"(h)(ii) goodput at SLOs 1e-6 ms: {report.goodput}; (iii) scrape on 127.0.0.1:"
            f"{server.port}: /requests polled {len(seen)} times during the run (up to "
            f"{max(seen)} in flight), /trace {n_trace} spans validated, /metrics "
            f"({len(scraped)} bytes) equal to prometheus_text() after the run")
    finally:
        warm_eng.slo_ttft_ms = warm_eng.slo_itl_ms = None
        obs_http.shutdown()
        del os.environ["REPRO_METRICS_PORT"]
    t_end = time.perf_counter()
    log(f"(h) took {t_end - t_phase:.1f} s: (i) decode step {t_step - t_phase:.1f} s, serve "
        f"{t_serve - t_step:.1f} s; (ii)-(iii) {t_end - t_serve:.1f} s")
    return out


def k4_plain(k4, a, b, c, steps, ops_):
    """K4's plain version on these inputs, as a function of the out dtype."""
    return lambda out_dtype: k4.opope_gemm_grouped_plain(
        a, b, c, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_)


def grouped_phase(torch, k4, ops, ep, cfg, dev):
    """Phase 5. Returns the expert FFN's 3 grouped GEMMs, the per-shape
    timing rows, the largest error and the coverage launches by route."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    g, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    tile = functools.partial(k4._run, route="tile")
    # The 3 grouped GEMMs of one MoE layer: (name, K, N, chain, out dtype).
    ffn = [("w_up", d, f, "none", bf16), ("w_gate", d, f, "silu+mul", bf16),
           ("w_down", f, d, "none", f32)]
    rows, max_err = [], 0.0
    # M = the expert capacity: a 4-slot decode step (1), and a prefill of
    # 4 x 64 (30) and 4 x 128 (60) prompt tokens.
    for m in (1, 30, 60):
        for name, kk, n, chain, out_dtype in ffn:
            a = torch.randn((g, m, kk), generator=gen, device=dev).to(bf16)
            b = (torch.randn((g, kk, n), generator=gen, device=dev) * kk ** -0.5).to(bf16)
            steps, ops_ = (), ()
            if chain == "silu+mul":
                steps = ("silu", "mul")
                ops_ = (torch.randn((g, m, n), generator=gen, device=dev).to(bf16),)
            plan = k4._plan(m, n, kk, bf16, a.data_ptr(), b.data_ptr())
            if plan.route != "sm90":
                raise AssertionError(f"grouped {name} M={m}: planned on {plan.route}, want sm90")
            what = f"grouped G={g} M={m} K={kk} N={n} {chain}"
            plain = k4_plain(k4, a, b, None, steps, ops_)
            err = 0.0
            for route, fn in (("sm90", k4.opope_gemm_grouped), ("tile", tile)):
                out = fn(a, b, None, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_)
                sync(torch, dev)
                err = max(err, check_close(torch, out, plain, out_dtype, f"{what} on {route}"))
            max_err = max(max_err, err)
            # One call reads all G experts' weights (>= 184 MB, several
            # times the 50 MB L2), so each call finds them cold. Both
            # routes and torch.bmm by device time: CUDA events around calls
            # queued behind a sleeping kernel (queued_ms); the plain version
            # by CUDA events around a loop.
            ms = queued_ms(torch, lambda i: k4.opope_gemm_grouped(
                a, b, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_))
            tile_ms = queued_ms(torch, lambda i: tile(
                a, b, None, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_))
            plain_ms = time_ms(torch, lambda i: k4.opope_gemm_grouped_plain(
                a, b, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_), 1)
            lib_ms = queued_ms(torch, lambda i: torch.bmm(a, b))
            out_elem = 4 if out_dtype == f32 else 2
            nbytes = 2 * g * (m * kk + kk * n + m * n * len(ops_)) + out_elem * g * m * n
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * g * m * n * kk / BF16_FLOPS
            row = {"g": g, "m": m, "k": kk, "n": n, "name": name, "epilogue": chain,
                   "out_dtype": str(out_dtype).replace("torch.", ""), "route": plan.route,
                   "tile_rows": plan.bm, "ms": ms, "tile_ms": tile_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "max_abs_err": err}
            rows.append(row)
            log(f"grouped G={g} M={m} K={kk} N={n} {name} chain={chain} -> {row['out_dtype']}: "
                f"sm90 {ms:.4f} ms, tile route {tile_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"max_abs_err {err:.3g} (both routes)")
            del a, b, ops_, out

    # Coverage: G = 3, fp32 and bf16 in, every C form and op, through
    # grouped_matmul on the kernel against it on the plain version: ragged
    # shapes TMA cannot describe (tile route), and aligned ragged ones (M 1,
    # 5 and 65, K tails of 200 and 264, N of 24, 136 and 200) on both routes.
    n_cov, gc_ = 0, 3
    cuda_be = ops.backend("cuda")
    cov_routes = {"sm90": 0, "tile": 0}
    for m, kk, n in ((5, 40, 24), (130, 300, 200), (1, 200, 136), (65, 264, 200)):
        for dt in (f32, bf16):
            a = torch.randn((gc_, m, kk), generator=gen, device=dev).to(dt)
            b = torch.randn((gc_, kk, n), generator=gen, device=dev).to(dt)
            route = k4._plan(m, n, kk, dt, a.data_ptr(), b.data_ptr()).route
            routes = ("sm90", "tile") if route == "sm90" else ("tile",)
            cs = {"none": None,
                  "row": torch.randn((gc_, n), generator=gen, device=dev).to(dt),
                  "full": torch.randn((gc_, m, n), generator=gen, device=dev).to(dt)}
            rows_ = {"[N]": torch.randn((n,), generator=gen, device=dev),
                     "[G,N]": torch.randn((gc_, n), generator=gen, device=dev)}
            full_op = torch.randn((gc_, m, n), generator=gen, device=dev).to(dt)
            acc_max = k4.opope_gemm_grouped_plain(a, b, out_dtype=f32).abs().max()
            for c_name, c in cs.items():
                for name in ep.epilogue_ops():
                    kind = ep.op_kind(name)
                    specs = {"none": {"": name},
                             "row": {r: (name, x) for r, x in rows_.items()},
                             "full": {"": (name, full_op)},
                             "scalar": {"": (name, acc_max / 100.0)}}[kind]
                    for form, spec in specs.items():
                        out_dtypes = (torch.int8,) if name == "requant_int8" else (dt, f32)
                        for out_dtype, rt in itertools.product(out_dtypes, routes):
                            def run(be, od, c=c, spec=spec):
                                return ops.grouped_matmul(a, b, c, backend=be, out_dtype=od,
                                                          epilogue=[spec])
                            with _patched(cuda_be, "grouped_fn",
                                          functools.partial(k4._run, route=rt)):
                                out = run("cuda", out_dtype)
                            sync(torch, dev)
                            check_close(torch, out, lambda od: run("torch", od), out_dtype,
                                        f"grouped coverage {gc_}x{m}x{kk}x{n} {dt} C={c_name} "
                                        f"{name}{form} -> {out_dtype} on {rt}")
                            cov_routes[rt] += 1
                            n_cov += 1
            # One long chain into fp16, on the planned route.
            chain = ["gelu", ("scale", rows_["[G,N]"]), ("residual", full_op),
                     ("mul", full_op), "relu", ("bias", rows_["[N]"])]
            out = ops.grouped_matmul(a, b, cs["row"], backend="cuda", out_dtype=torch.float16,
                                     epilogue=chain)
            sync(torch, dev)
            check_close(torch, out, lambda od: ops.grouped_matmul(
                a, b, cs["row"], backend="torch", out_dtype=od, epilogue=chain),
                torch.float16, f"grouped coverage chain {gc_}x{m}x{kk}x{n} {dt}")
            cov_routes[route] += 1
            n_cov += 1
    log(f"grouped coverage: {n_cov} ragged/dtype/C/epilogue cases within tolerance, "
        f"by route {cov_routes}")
    return ffn, rows, max_err, cov_routes


@contextlib.contextmanager
def _patched(obj, name, value):
    """``obj.name = value`` inside the block; yields the original."""
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def _fp64_plain(torch, ep):
    """The plain versions' function with fp64 products and sums, rounded
    once to fp32 before the epilogue: another valid summation order, to
    measure how far routing drifts under rounding alone."""
    def fn(a, b, c=None, *, out_dtype=None, epilogue=(), epilogue_operands=()):
        acc = torch.matmul(a.double(), b.double()).float()
        if c is not None:
            acc = acc + (c.float()[:, None, :] if a.ndim == 3 and c.ndim == 2 else c.float())
        acc = ep.apply_epilogue(acc, tuple(epilogue), tuple(epilogue_operands))
        return ep.cast_out(acc, out_dtype or a.dtype)
    return fn


def _routed_prefill(api, moe_mod, cfg, params, tokens, backend):
    """Prefill logits and every layer's (router params, router input,
    top-k indices)."""
    rec, orig = [], moe_mod._route

    def recording(p, xf, top_k, backend=None):
        out = orig(p, xf, top_k, backend)
        rec.append((p, xf, out[2]))
        return out

    with _patched(moe_mod, "_route", recording):
        logits, _ = api.prefill(cfg, params, {"tokens": tokens}, tokens.shape[1],
                                backend=backend)
    return logits, rec


def _agreement(idx_a, idx_b):
    """Share of top-k assignments of ``idx_a`` that ``idx_b`` also makes
    (per token, in any order), per layer."""
    return (idx_a[..., :, None] == idx_b[..., None, :]).any(-1).float().mean((-1, -2))


def moe_phase(torch, np, cfg, ops, ep, k4, dev):
    """Phase 6: full-width deepseek-moe-16b."""
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import ContinuousEngine, ServeEngine, poisson_trace

    n_k1, n_k4 = 8 * cfg.n_layers, 3 * cfg.n_layers  # launches per forward
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync(torch, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != api.param_count(cfg):
        raise AssertionError(f"{n_params} parameters drawn, {api.param_count(cfg)} counted")
    log(f"init {cfg.name}: {n_params / 1e9:.3f} B params "
        f"({api.active_param_count(cfg) / 1e9:.3f} B active per token) on {dev} in "
        f"{time.perf_counter() - t0:.1f} s; allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # (a) routing in a full prefill on the kernels: the plain router on the
    # same layer inputs, and two free-running prefills. Free-running, a
    # 1-ulp difference upstream flips a near-tied expert choice and the flip
    # grows through the later layers, so the kernels-vs-plain agreement is
    # held to the floor this run measures between two valid summation
    # orders of the plain versions (fp32 and fp64 sums), less a margin.
    m = cfg.moe
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    with torch.inference_mode():
        got, rec_c = _routed_prefill(api, moe_mod, cfg, params, tokens, "cuda")
        ref, rec_t = _routed_prefill(api, moe_mod, cfg, params, tokens, "torch")
        fp64 = _fp64_plain(torch, ep)
        plain = ops.backend("torch")
        with _patched(plain, "fn", fp64), _patched(plain, "grouped_fn", fp64):
            _, rec_64 = _routed_prefill(api, moe_mod, cfg, params, tokens, "torch")
        idx_c, idx_t, idx_64 = (torch.stack([r[2] for r in rec]) for rec in (rec_c, rec_t, rec_64))
        idx_same = torch.stack([moe_mod._route(p, xf, m.top_k, "torch")[2] for p, xf, _ in rec_c])
    if not (torch.isfinite(ref).all() and torch.isfinite(got).all()):
        raise AssertionError("prefill logits not finite")
    if tuple(got.shape) != (2, cfg.vocab) or tuple(idx_c.shape) != (cfg.n_layers, 128, m.top_k):
        raise AssertionError(f"prefill logits {tuple(got.shape)}, routing {tuple(idx_c.shape)}")
    same = _agreement(idx_c, idx_same).mean().item()
    free_l = _agreement(idx_c, idx_t)
    free, free_64 = free_l.mean().item(), _agreement(idx_t, idx_64).mean().item()
    free_min = max(free_64 - FREE_ROUTING_MARGIN, FREE_ROUTING_FLOOR)
    log(f"(a) prefill 2x64, {idx_c.numel()} routing assignments: plain router on the kernel "
        f"run's layer inputs agrees on {same:.5f} (gated >= 0.99)")
    log(f"(a) free-running prefills: kernels vs plain agree on {free:.5f} (gated >= "
        f"{free_min:.5f} = max(fp64 floor - {FREE_ROUTING_MARGIN}, {FREE_ROUTING_FLOOR})), "
        f"plain fp32 sums vs plain fp64 sums (the floor) on {free_64:.5f}; per layer "
        f"(kernels vs plain) " + " ".join(f"{x:.3f}" for x in free_l.tolist()))
    log(f"(a) logits (not gated): max|dlogits| {(got - ref).abs().max().item():.4g}, max|logits| "
        f"{ref.abs().max().item():.4g}, argmax agreement "
        f"{(got.argmax(-1) == ref.argmax(-1)).float().mean().item():.2f}")
    if same < 0.99:
        raise AssertionError(f"routing agreement on the same layer inputs {same} < 0.99")
    if free < free_min:
        raise AssertionError(f"free-running routing agreement {free} < {free_min} "
                             f"(fp64 floor {free_64})")
    agree = {"same_input": same, "free_running": free,
             "free_running_plain_fp32_vs_fp64": free_64}
    del rec_c, rec_t, rec_64

    # (a2) one full-width MoE layer on both backends with the same routing,
    # taken from the kernel run's router: prefill- and decode-shaped inputs.
    p = params["blocks"][0]["moe"]
    kw = dict(n_experts=m.n_experts, top_k=m.top_k, capacity_factor=m.capacity_factor,
              dispatch=m.dispatch, group_size=m.group_size, dropless=m.dropless)
    gen = torch.Generator(device=dev).manual_seed(2)
    layer_err = 0.0
    for shape in ((4, 128), (4, 1)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen, device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            fixed = moe_mod._route(p, x.reshape(-1, cfg.d_model), m.top_k, "cuda")
            with _patched(moe_mod, "_route", lambda *a, **k: fixed):
                y_c, aux_c = moe_mod.moe_apply(p, x, backend="cuda", **kw)
                y_t, aux_t = moe_mod.moe_apply(p, x, backend="torch", **kw)
        delta, scale = (y_c.float() - y_t.float()).abs().max().item(), y_t.float().abs().max().item()
        # Kernel and plain version differ by at most one bf16 ulp in the
        # expert hidden state and the shared MLP's outputs; a few ulps of
        # the largest output bound the layer.
        if not torch.isfinite(y_c.float()).all() or delta > 2e-2 * scale:
            raise AssertionError(f"MoE layer {shape}: max|dy| {delta} > 2e-2 * {scale}")
        if abs(aux_c.item() - aux_t.item()) > 1e-6:
            raise AssertionError(f"MoE layer {shape}: aux {aux_c.item()} != {aux_t.item()}")
        layer_err = max(layer_err, delta)
        log(f"(a) one MoE layer, tokens {shape}, fixed routing: max|dy| {delta:.4g} "
            f"<= 2e-2 * max|y| {scale:.4g}")

    # (b) the second main path: continuous batching over a Poisson trace.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        eng = ContinuousEngine(cfg=cfg, params=params, n_slots=4, max_len=256)
    for w in caught:
        log(f"(b) warning: {w.message}")
    eng.serve(poisson_trace(2, seed=1, vocab=cfg.vocab, prompt_lens=(32,), gen_lens=(4,)))
    trace = poisson_trace(8, seed=0, vocab=cfg.vocab, prompt_lens=(32, 64, 128),
                          gen_lens=(8, 16, 32))
    ops.reset_counts()
    opope_gemm.launches = 0
    opope_gemm.launches_by_route.update(sm90=0, tile=0)
    k4.opope_gemm_grouped.launches = 0
    k4.opope_gemm_grouped.launches_by_route.update(sm90=0, tile=0)
    report = eng.timed_serve(trace)
    launches = {"k1": opope_gemm.launches, "k4": k4.opope_gemm_grouped.launches}
    check_routes(opope_gemm, launches["k1"], "6(b)")
    check_routes(k4.opope_gemm_grouped, launches["k4"], "6(b)", name="K4")
    forwards = report.decode_steps + report.prefill_batches
    plain = ops.backend("torch")
    if (launches["k4"] != n_k4 * forwards or launches["k1"] != n_k1 * forwards
            or plain.calls or plain.grouped_calls
            or ops.backend("cuda").grouped_calls != launches["k4"]):
        raise AssertionError(f"launches {launches} != K1 {n_k1 * forwards}, K4 "
                             f"{n_k4 * forwards} (plain calls {plain.calls}, "
                             f"{plain.grouped_calls} grouped)")
    for r in trace:
        out = report.outputs[r.rid]
        if len(out) != r.max_new_tokens or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"request {r.rid}: bad output {out}")
    log(f"(b) continuous: {len(trace)} requests, {report.generated_tokens} tokens, "
        f"decode_steps {report.decode_steps}, prefill_batches {report.prefill_batches}, "
        f"mean_occupancy {report.mean_occupancy:.3f}, wall {report.wall_time_s:.3f} s, "
        f"{report.tokens_per_sec:.1f} tokens/s, TTFT p50 {report.ttft_p50 * 1e3:.1f} ms, "
        f"ITL p50 {report.itl_p50 * 1e3:.1f} ms (host-issue times); K4 launches "
        f"{launches['k4']} = 3 * {cfg.n_layers} * ({report.decode_steps} + "
        f"{report.prefill_batches}), K1 launches {launches['k1']} = 8 * {cfg.n_layers} * (...), "
        f"every K1 and K4 launch on sm90")
    del eng

    # (b) the lockstep engine.
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(dev)
    opope_gemm.launches = k4.opope_gemm_grouped.launches = 0
    opope_gemm.launches_by_route.update(sm90=0, tile=0)
    k4.opope_gemm_grouped.launches_by_route.update(sm90=0, tile=0)
    t0 = time.perf_counter()
    toks = ServeEngine(cfg=cfg, params=params, max_len=80).generate({"tokens": prompts}, 16)
    toks_host = toks.cpu()
    dt = time.perf_counter() - t0
    if tuple(toks_host.shape) != (4, 16) or not ((toks_host >= 0) & (toks_host < cfg.vocab)).all():
        raise AssertionError(f"static engine output {tuple(toks_host.shape)}")
    if (k4.opope_gemm_grouped.launches, opope_gemm.launches) != (n_k4 * 16, n_k1 * 16):
        raise AssertionError(f"static launches K4 {k4.opope_gemm_grouped.launches}, "
                             f"K1 {opope_gemm.launches}")
    check_routes(opope_gemm, opope_gemm.launches, "6(b) static")
    check_routes(k4.opope_gemm_grouped, k4.opope_gemm_grouped.launches, "6(b) static", name="K4")
    log(f"(b) static: 4 x 64-token prompts, 16 tokens each in {dt:.3f} s "
        f"({64 / dt:.1f} tokens/s), K4 launches {k4.opope_gemm_grouped.launches}, "
        f"K1 launches {opope_gemm.launches}")

    # (c) one lockstep decode step at 4 rows.
    with torch.inference_mode():
        logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 96)
        tok = logits.argmax(-1)[:, None]
        for i in range(3):
            logits, caches = api.decode(cfg, params, tok, caches, 64 + i)
        sync(torch, dev)
        n_steps = 8
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, caches = api.decode(cfg, params, tok, caches, 67 + i)
        sync(torch, dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        prof = None
        if dev.type == "cuda":
            prof = decode_profile(torch, lambda i: api.decode(cfg, params, tok, caches, 75 + i),
                                  step_ms, tag="(c)")
    # Byte bounds of the step's GEMMs: every weight read once (the 4 rows
    # of activations add < 0.1 %); 3-D weights are the experts' (K4).
    bound_ms = {"k1": 0.0, "k4": 0.0}
    for t in _leaves(params["blocks"]):
        if t.ndim >= 2:
            bound_ms["k4" if t.ndim == 3 else "k1"] += (
                1e3 * t.numel() * t.element_size() / HBM_BYTES_PER_S)
    dev_ms = None
    if prof is not None:
        dev_ms = {name: sum(ms for key, ms, _ in prof if kernel in key)
                  for name, kernel in (("k4", "opope_grouped_kernel"),
                                       ("k1", "opope_gemm_kernel"))}
        dev_ms["busy"] = sum(ms for _, ms, _ in prof)
        dev_ms.update({f"{k}_byte_bound": v for k, v in bound_ms.items()})
        log(f"(c) decode step, 4 rows: {step_ms:.3f} ms wall; device busy "
            f"{dev_ms['busy']:.3f} ms, K4 {dev_ms['k4']:.3f} ms ({n_k4} launches, byte bound "
            f"{bound_ms['k4']:.3f} ms), K1 {dev_ms['k1']:.3f} ms ({n_k1} launches, byte bound "
            f"{bound_ms['k1']:.3f} ms)")
    return {"continuous": report, "launches": launches, "decode_step_ms": step_ms,
            "device_ms": dev_ms, "routing_agreement": agree, "layer_err": layer_err,
            "params": params}

def q8_check(torch, out, want, transcendental, what):
    """K2/K5 output against the plain version's on the same int8 inputs:
    bitwise where the chain has no transcendental op (and for int8 out);
    else within one ulp of the output dtype, plus 1e-6 of the largest
    magnitude where gelu cancels. Returns the largest absolute difference."""
    if out.dtype == torch.int8 or not transcendental:
        if not torch.equal(out, want):
            bad = (out != want).sum().item()
            raise AssertionError(f"{what}: {bad} elements differ from the plain version "
                                 "(bitwise gate)")
        return 0.0
    ref = want.float()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = (out.float() - ref).abs()
    tol = ulp(torch, ref, out.dtype) + 1e-6 * ref.abs().max()
    bad = (diff > tol).sum().item()
    if bad:
        raise AssertionError(f"{what}: {bad} elements beyond 1 ulp (max err {diff.max().item()})")
    return diff.max().item() if out.numel() else 0.0


def q8_bound(g, m, k, n, out_elem, n_full_operands):
    """Least time in ms of one int8 GEMM (G = g groups) on the card, and what
    bounds it: int8 A and B, the fp32 scales, the output and the bf16 full
    operands moved once each, or 2MNK at the int8 tensor-core rate."""
    nbytes = g * (m * k + k * n + 4 * (m + n) + out_elem * m * n + 2 * m * n * n_full_operands)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * g * m * n * k / INT8_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


Q8_CHAINS = {"none": (), "silu+mul": ("silu", "mul"), "residual": ("residual",),
             "requant_int8": ("requant_int8",)}


def q8_kernel_phase(torch, q8, qz, qb, k4, ep, cfg, mcfg, dev):
    """Phase 7. Returns the timing rows, the largest error of K2 and K5, and
    K5's coverage launches by route."""
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    d, dff = cfg.d_model, cfg.d_ff
    md, mf, ne = mcfg.d_model, mcfg.moe.d_ff_expert, mcfg.moe.n_experts
    msh = mcfg.moe.d_ff_shared or mcfg.moe.n_shared * mf
    # The quantized GEMMs of one layer: (path, name, G (0: K2), Ms, K, N,
    # chain on the path, out dtype on the path).
    gemms = [
        ("chatglm3-6b mlp", "w_up", 0, (4, 512), d, dff, "none", bf16),
        ("chatglm3-6b mlp", "w_gate", 0, (4, 512), d, dff, "silu+mul", bf16),
        ("chatglm3-6b mlp", "w_down", 0, (4, 512), dff, d, "residual", bf16),
        ("deepseek-moe-16b shared", "w_up", 0, (4, 256), md, msh, "none", bf16),
        ("deepseek-moe-16b shared", "w_gate", 0, (4, 256), md, msh, "silu+mul", bf16),
        ("deepseek-moe-16b shared", "w_down", 0, (4, 256), msh, md, "residual", bf16),
        ("deepseek-moe-16b experts", "w_up", ne, (1, 30, 60), md, mf, "none", bf16),
        ("deepseek-moe-16b experts", "w_gate", ne, (1, 30, 60), md, mf, "silu+mul", bf16),
        ("deepseek-moe-16b experts", "w_down", ne, (1, 30, 60), mf, md, "none", f32),
    ]

    def quantized(g, m, k, n):
        """The path's int8 operands: bf16 activations and weights quantized
        as the q8 backends do (per row / column, per group for K5)."""
        lead = (g,) if g else ()
        a = torch.randn(lead + (m, k), generator=gen, device=dev).to(bf16)
        b = (torch.randn(lead + (k, n), generator=gen, device=dev) * k ** -0.5).to(bf16)
        aq, bq = (qb.quantize_grouped_operands if g else qb.quantize_operands)(a, b)
        return b, aq.q, aq.scale, bq.q, bq.scale

    def chain_operands(chain, g, m, n, out_dtype):
        steps = Q8_CHAINS[chain]
        full = (torch.randn(((g,) if g else ()) + (m, n), generator=gen, device=dev).to(bf16),)
        scalar = (torch.full((1, 1, 1) if g else (1, 1), 0.02, device=dev),)
        ops_ = {"none": (), "silu+mul": full, "residual": full, "requant_int8": scalar}[chain]
        return steps, ops_, (torch.int8 if chain == "requant_int8" else out_dtype)

    errs = {"k2": 0.0, "k5": 0.0}
    n_checks = 0
    # Correctness at every path shape, every chain.
    for g, ms, kk, n, out_dtype in sorted({(g, ms, kk, n, od) for _, _, g, ms, kk, n, _, od in gemms},
                                          key=str):
        kern, plain = ((q8.opope_gemm_q8_grouped, q8.opope_gemm_q8_grouped_plain) if g else
                       (q8.opope_gemm_q8, q8.opope_gemm_q8_plain))
        tile = functools.partial(q8._launch_grouped if g else q8._launch, route="tile")
        for m in ms:
            _, a, sa, b, sb = quantized(g, m, kk, n)
            # Every path shape plans on sm90 (K5 with one split).
            plan = (q8._plan_grouped(g, m, n, kk, a.data_ptr(), b.data_ptr()) if g else
                    q8._plan(m, n, kk, a.data_ptr(), b.data_ptr()))
            if plan.route != "sm90":
                raise AssertionError(f"{'K5' if g else 'K2'} G={g} M={m} K={kk} N={n}: planned "
                                     f"on {plan.route}")
            for chain in Q8_CHAINS:
                steps, ops_, od = chain_operands(chain, g, m, n, out_dtype)
                out = kern(a, sa, b, sb, out_dtype=od, epilogue=steps, epilogue_operands=ops_)
                sync(torch, dev)
                want = plain(a, sa, b, sb, out_dtype=od, epilogue=steps, epilogue_operands=ops_)
                what = f"q8 G={g} M={m} K={kk} N={n} {chain}"
                err = q8_check(torch, out, want, "silu" in steps, what)
                # The same call on the tile route, held the same way.
                q8_check(torch, tile(a, sa, b, sb, out_dtype=od, epilogue=steps,
                                     epilogue_operands=ops_),
                         want, "silu" in steps, what + " (tile route)")
                errs["k5" if g else "k2"] = max(errs["k5" if g else "k2"], err)
                n_checks += 1
                log(f"check {what} -> {str(od).replace('torch.', '')} on sm90 (tile rows "
                    f"{plan.bm}, {plan.splits} splits) and tile: max_abs_err {err:.3g} ok")
            if not g and plan.splits > 1:
                # Split K sums int32 partials: a repeat gives the same bits.
                outs = [kern(a, sa, b, sb, out_dtype=torch.bfloat16) for _ in range(2)]
                if not torch.equal(outs[0], outs[1]):
                    raise AssertionError(f"K2 M={m} K={kk} N={n}: split-K repeat differs")
            del a, b, out, want

    # Timing at the path's (shape, chain) pairs, weights cold in L2, beside
    # the plain version, torch._int_mm (K2 only) and one per-call weight
    # quantization (what the q8 backends run before each kernel). K2 and K5
    # on their planned route and on the tile route, K4's sm90 route on the
    # same shapes in bf16 (K5's yardstick: no single PyTorch call computes a
    # grouped int8 GEMM) and the _int_mm lane by device time (queued_ms: CUDA events around
    # calls queued behind a sleeping kernel; their launches are shorter than
    # the host's issue time), and K2 and K5 also by CUDA events around a loop
    # (event_ms, the host's issue rate included, as they were first timed);
    # the plain versions and the quantization by CUDA events.
    rows = []
    for path, name, g, ms, kk, n, chain, out_dtype in gemms:
        kern, plain = ((q8.opope_gemm_q8_grouped, q8.opope_gemm_q8_grouped_plain) if g else
                       (q8.opope_gemm_q8, q8.opope_gemm_q8_plain))
        launch = q8._launch_grouped if g else q8._launch
        tile = functools.partial(launch, route="tile")
        n_bufs = max(1, min(64, math.ceil(3 * L2_BYTES / (max(g, 1) * kk * n))))
        bufs = [quantized(g, max(ms), kk, n) for _ in range(n_bufs)]
        n_iter = max(20, n_bufs)
        for m in ms:
            a, sa = bufs[0][1][..., :m, :].contiguous(), bufs[0][2][..., :m, :].contiguous()
            steps, ops_, _ = chain_operands(chain, g, m, n, out_dtype)

            def run(fn, i):
                return fn(a, sa, bufs[i][3], bufs[i][4], out_dtype=out_dtype, epilogue=steps,
                          epilogue_operands=ops_)

            plan = (q8._plan_grouped(g, m, n, kk, a.data_ptr(), bufs[0][3].data_ptr()) if g else
                    q8._plan(m, n, kk, a.data_ptr(), bufs[0][3].data_ptr()))
            ms_e = time_ms(torch, lambda i: run(kern, i), n_bufs)
            ms_k = queued_ms(torch, lambda i: run(kern, i % n_bufs), n_iter)
            ms_tile = queued_ms(torch, lambda i: run(tile, i % n_bufs), n_iter)
            ms_p = time_ms(torch, lambda i: run(plain, i), n_bufs)
            ms_q = time_ms(torch, lambda i: qz.quantize(
                bufs[i][0], "int8", axis=(0, 2) if g else 1), n_bufs, warmup=n_bufs)
            lib_ms = lib_e = ms_k4 = None
            if g:
                a_bf = torch.randn((g, m, kk), generator=gen, device=dev).to(bf16)
                ms_k4 = queued_ms(torch, lambda i: k4.opope_gemm_grouped(
                    a_bf, bufs[i % n_bufs][0], out_dtype=out_dtype, epilogue=steps,
                    epilogue_operands=ops_), n_iter)
                k4_route = k4._plan(m, n, kk, bf16, a_bf.data_ptr(),
                                    bufs[0][0].data_ptr()).route
                del a_bf
            else:
                # torch._int_mm needs M > 16: M is padded to 32 with zero rows.
                m_lib = 32 if m <= 16 else m
                a_lib = torch.zeros((m_lib, kk), dtype=torch.int8, device=dev)
                a_lib[:m] = a
                sa_lib = torch.ones((m_lib, 1), device=dev)
                sa_lib[:m] = sa
                b_cm = [x[3].t().contiguous().t() for x in bufs]

                def lib(i):
                    return torch._int_mm(a_lib, b_cm[i]).float() * (sa_lib * bufs[i][4])
                lib_e = time_ms(torch, lib, n_bufs)
                lib_ms = queued_ms(torch, lambda i: lib(i % n_bufs), n_iter)
                del b_cm
            out = run(kern, 0)
            err = q8_check(torch, out, run(plain, 0), "silu" in steps, f"timed {path} {name} M={m}")
            out_elem = out.element_size()
            bound_ms, bound_by = q8_bound(max(g, 1), m, kk, n, out_elem, len(ops_))
            row = {"path": path, "name": name, "g": g, "m": m, "k": kk, "n": n, "epilogue": chain,
                   "out_dtype": str(out_dtype).replace("torch.", ""), "route": plan.route,
                   "config": plan.config, "tile_rows": plan.bm, "splits": plan.splits,
                   "ms": ms_k, "tile_ms": ms_tile, "event_ms": ms_e, "plain_ms": ms_p,
                   "library_ms": lib_ms, "library_event_ms": lib_e, "bound_ms": bound_ms,
                   "bound_by": bound_by, "weight_quant_ms": ms_q, "max_abs_err": err,
                   "tops": 2 * max(g, 1) * m * n * kk / ms_k / 1e9}
            if g:
                row.update(k4_sm90_ms=ms_k4, k4_route=k4_route)
            rows.append(row)
            log(f"time {path} {name} G={g} M={m} K={kk} N={n} chain={chain}: "
                f"sm90 {ms_k:.4f} ms device ({plan.bm} rows, {plan.stages} stages, "
                f"{plan.splits} splits; {row['tops']:.1f} TOP/s; {ms_e:.4f} ms by CUDA events), "
                f"tile route {ms_tile:.4f} ms device, "
                + (f"K4 {k4_route} bf16 {ms_k4:.4f} ms device, " if g else "")
                + f"plain {ms_p:.4f} ms, "
                + (f"torch._int_mm+dequant {lib_ms:.4f} ms device ({lib_e:.4f} by CUDA events; "
                   f"M padded to {m_lib}), " if lib_ms is not None else "")
                + f"bound {bound_ms:.4f} ms ({bound_by}); per-call weight quantization "
                f"{ms_q:.4f} ms")
        del bufs

    # Coverage: ragged shapes, every C form, op and out dtype, on the route
    # each case plans. The tile route: K or N off a multiple of 16 (K2, and
    # K5 at G = 3). The sm90 route: for K2, M of 1, 5, 65 and 130 on the 8-
    # and 128-row tiles, K and N off the 128-byte panel and tile; for K5 at
    # G = 3 and 64, M of 1, 5, 8, 9, 64, 65 and 130 (both tiles, one or two
    # of them), K tails of 144, 272, 400 and 1040, N of 144, 208 and 272.
    tile_cases = ((5, 40, 24), (130, 300, 200), (64, 1000, 192))
    cov_cases = ([(0, c, "tile") for c in tile_cases]
                 + [(0, c, "sm90") for c in ((1, 16, 16), (5, 144, 272), (65, 400, 144),
                                             (130, 1040, 208))]
                 + [(3, c, "tile") for c in tile_cases]
                 + [(3, c, "sm90") for c in ((1, 144, 272), (5, 1040, 208), (8, 400, 144),
                                             (9, 144, 208), (65, 272, 144), (130, 1040, 208))]
                 + [(64, c, "sm90") for c in ((1, 144, 144), (64, 1040, 208))])
    n_cov = 0
    k2_before = dict(q8.opope_gemm_q8.launches_by_route)
    k5_before = dict(q8.opope_gemm_q8_grouped.launches_by_route)
    for g, (m, kk, n), want_route in cov_cases:
        kern, plain = ((q8.opope_gemm_q8_grouped, q8.opope_gemm_q8_grouped_plain) if g else
                       (q8.opope_gemm_q8, q8.opope_gemm_q8_plain))
        lead = (g,) if g else ()
        a = torch.randint(-127, 128, lead + (m, kk), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, lead + (kk, n), generator=gen, device=dev,
                          dtype=torch.int8)
        route = (q8._plan_grouped(g, m, n, kk, a.data_ptr(), b.data_ptr()) if g else
                 q8._plan(m, n, kk, a.data_ptr(), b.data_ptr())).route
        if route != want_route:
            raise AssertionError(f"q8 coverage G={g} {m}x{kk}x{n} planned on {route}, "
                                 f"want {want_route}")
        sa = torch.rand(lead + (m, 1), generator=gen, device=dev) * 1e-3
        sb = torch.rand(lead + (1, n), generator=gen, device=dev) * 1e-2
        row_op = torch.randn(lead + (1, n) if g else (1, n), generator=gen, device=dev)
        full_op = torch.randn(lead + (m, n), generator=gen, device=dev).to(bf16)
        scalar = torch.full((1, 1, 1) if g else (1, 1), 0.05, device=dev)
        cs = {"none": None, "row": torch.randn(lead + (n,), generator=gen, device=dev),
              "full": torch.randn(lead + (m, n), generator=gen, device=dev).to(bf16)}
        for c_name, c in cs.items():
            for name in ep.epilogue_ops():
                ops_ = {"none": (), "row": (row_op,), "full": (full_op,),
                        "scalar": (scalar,)}[ep.op_kind(name)]
                for od in ((torch.int8,) if name == "requant_int8" else (f32, bf16)):
                    out = kern(a, sa, b, sb, c, out_dtype=od, epilogue=(name,),
                               epilogue_operands=ops_)
                    sync(torch, dev)
                    want = plain(a, sa, b, sb, c, out_dtype=od, epilogue=(name,),
                                 epilogue_operands=ops_)
                    q8_check(torch, out, want, name in ("gelu", "silu", "swish"),
                             f"q8 coverage G={g} {m}x{kk}x{n} C={c_name} {name} -> {od} "
                             f"on {route}")
                    n_cov += 1
        chain = ("bias", "scale", "residual", "mul", "relu", "requant_int8")
        ops_ = (cs["row"].reshape(row_op.shape), row_op, full_op, full_op, scalar)
        out = kern(a, sa, b, sb, cs["full"], out_dtype=torch.int8, epilogue=chain,
                   epilogue_operands=ops_)
        q8_check(torch, out, plain(a, sa, b, sb, cs["full"], out_dtype=torch.int8,
                                   epilogue=chain, epilogue_operands=ops_), False,
                 f"q8 coverage chain G={g} {m}x{kk}x{n} on {route}")
        n_cov += 1
        # The int32 accumulator is exact: with unit scales and
        # |acc| < 2^24 the fp32 output is the integer product.
        ones_a, ones_b = torch.ones_like(sa), torch.ones_like(sb)
        out = kern(a, ones_a, b, ones_b)
        exact = torch.matmul(a.double(), b.double())
        if exact.abs().max() >= 2 ** 24 or not torch.equal(out.double(), exact):
            raise AssertionError(f"q8 G={g} {m}x{kk}x{n} on {route}: accumulator not exact")
        n_cov += 1
    k2_cov = {r: q8.opope_gemm_q8.launches_by_route[r] - k2_before[r] for r in k2_before}
    k5_cov = {r: q8.opope_gemm_q8_grouped.launches_by_route[r] - k5_before[r]
              for r in k5_before}
    if not all(k2_cov.values()) or not all(k5_cov.values()):
        raise AssertionError(f"q8 coverage launches by route: K2 {k2_cov}, K5 {k5_cov}: a "
                             "route went unchecked")
    # K5 at decode: experts no token reached hold zero rows (scale 1e-12/127,
    # q = 0) and must give exactly zero outputs.
    x = torch.randn((ne, 1, md), generator=gen, device=dev).to(bf16)
    x[::2] = 0
    w = (torch.randn((ne, md, mf), generator=gen, device=dev) * md ** -0.5).to(bf16)
    xq, wq = qb.quantize_grouped_operands(x, w)
    if q8._plan_grouped(ne, 1, mf, md, xq.q.data_ptr(), wq.q.data_ptr()).route != "sm90":
        raise AssertionError("K5 zero-capacity case: not planned on sm90")
    out = q8.opope_gemm_q8_grouped(xq.q, xq.scale, wq.q, wq.scale)
    if out[::2].any() or not out[1::2].any():
        raise AssertionError("K5: zero capacity rows did not give exactly zero outputs")
    log(f"q8: {n_checks} path-shape checks (K2 and K5 on sm90 and on the tile route), {n_cov} "
        f"ragged/C/epilogue/accumulator cases (launches by route: K2 {k2_cov}, K5 {k5_cov}) "
        f"and the zero-capacity decode case on sm90 bitwise (transcendental chains within "
        f"1 ulp)")
    return rows, errs, k5_cov


def _greedy_decode(torch, api, cfg, params, prompts, gen, policy):
    """``benchmarks/quant_bench.py::greedy_decode``: prefill with fp32
    caches, then ``gen - 1`` greedy decode steps; returns [B, gen] tokens."""
    logits, caches = api.prefill(cfg, params, {"tokens": prompts}, prompts.shape[1] + gen + 1,
                                 torch.float32, backend=policy)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, caches = api.decode(cfg, params, tok, caches, prompts.shape[1] + i,
                                    backend=policy)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"decode step {i}: non-finite logits")
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def every_layer(per_layer, n_layers):
    """:func:`q8_model_phase`'s ``per_forward`` for a model whose layers all
    launch ``per_layer`` (kernel name -> launches) in a prefill and in a
    decode step alike."""
    return lambda kind: {name: n * n_layers for name, n in per_layer.items()}


def q8_model_phase(torch, np, cfg, params, policy, plain_policy, per_forward, ops, ep, kernels,
                   dev, tag, audit=False):
    """Phase 8 for one model on its full-width weights, under ``policy`` on
    the kernels and ``plain_policy`` on the plain versions.
    ``per_forward(kind)`` maps each kernel name of ``kernels`` to its
    launches in one ``"prefill"`` or ``"decode"`` forward on the quantized
    main path (:func:`every_layer` where the layers are alike). ``audit``:
    (f), the shadow auditor on direct K2 calls and on a served q8 step."""
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf_mod

    gen = torch.Generator(device=dev).manual_seed(4)
    # (a) one layer, both backends, the same input (and, for MoE, the
    # kernel run's routing).
    layer_err = 0.0
    for shape in ((4, 64), (4, 1)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.arange(shape[1], device=dev).expand(shape)
        rec, orig = [], moe_mod._route

        def recording(*a, **k):
            rec.append(orig(*a, **k))
            return rec[-1]

        with torch.inference_mode():
            with _patched(moe_mod, "_route", recording):
                y_k = tf_mod._block_apply(cfg, cfg.pattern[0], params["blocks"][0], x,
                                          positions=pos, cache=None, backend=policy)[0]
            with _patched(moe_mod, "_route", lambda *a, **k: rec[0] if rec else orig(*a, **k)):
                y_p = tf_mod._block_apply(cfg, cfg.pattern[0], params["blocks"][0], x,
                                          positions=pos, cache=None, backend=plain_policy)[0]
        delta, scale = (y_k.float() - y_p.float()).abs().max().item(), y_p.float().abs().max().item()
        # K1 and its plain version differ by at most one bf16 ulp; an int8
        # value downstream may round the other way, one quantization step.
        if not torch.isfinite(y_k.float()).all() or delta > 2e-2 * scale:
            raise AssertionError(f"{tag} layer {shape}: max|dy| {delta} > 2e-2 * {scale}")
        layer_err = max(layer_err, delta)
        log(f"{tag} (a) one layer, tokens {shape}: kernels vs plain max|dy| {delta:.4g} "
            f"<= 2e-2 * max|y| {scale:.4g}")

    # (b) all-layer prefill logits: kernels vs plain, against two plain
    # summation orders (fp32 and fp64 sums) of the same run.
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    with torch.inference_mode():
        got, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend=policy)
        ref, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend=plain_policy)
        fp64 = _fp64_plain(torch, ep)
        plain = ops.backend("torch")
        with _patched(plain, "fn", fp64), _patched(plain, "grouped_fn", fp64):
            ref64, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend=plain_policy)
        bf, _ = api.prefill(cfg, params, {"tokens": tokens}, 64)
    for name, t in (("kernels", got), ("plain", ref), ("plain fp64", ref64)):
        if not torch.isfinite(t).all() or tuple(t.shape) != (2, cfg.vocab):
            raise AssertionError(f"{tag} prefill logits ({name}) {tuple(t.shape)} not finite")

    def rms(x):
        return x.double().pow(2).mean().sqrt().item()

    d_k, d_f = rms(got - ref), rms(ref - ref64)
    logit_gate = Q8_LOGIT_FLOOR_FACTOR * d_f
    log(f"{tag} (b) prefill 2x64 logits: kernels vs plain RMS {d_k:.4g} (max {(got - ref).abs().max().item():.4g}); "
        f"plain fp32 vs fp64 sums RMS {d_f:.4g} (the floor; gate {Q8_LOGIT_FLOOR_FACTOR} x = "
        f"{logit_gate:.4g}); max|logits| {ref.abs().max().item():.4g}; argmax agreement "
        f"{(got.argmax(-1) == ref.argmax(-1)).float().mean().item():.2f}")
    if d_k > logit_gate:
        raise AssertionError(f"{tag} prefill logits: kernels vs plain RMS {d_k} > "
                             f"{Q8_LOGIT_FLOOR_FACTOR} x floor {d_f}")
    q8_vs_bf16 = {"rms": rms(got - bf), "max": (got - bf).abs().max().item(),
                  "max_logit": bf.abs().max().item(),
                  "argmax_agreement": (got.argmax(-1) == bf.argmax(-1)).float().mean().item()}
    log(f"{tag} (c) q8 vs bf16 prefill logits (not gated): RMS {q8_vs_bf16['rms']:.4g}, "
        f"max {q8_vs_bf16['max']:.4g} of max|logits| {q8_vs_bf16['max_logit']:.4g}, argmax "
        f"agreement {q8_vs_bf16['argmax_agreement']:.2f}")
    del got, ref, ref64, bf

    # (d) the quantized main path: a 4 x 64-token prefill and 16 greedy
    # decode steps through api.prefill / api.decode, every launch counted.
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(dev)
    n_fwd = 17
    ops.reset_counts()
    for fn in kernels.values():
        fn.launches = 0
    for name in ("K1", "K2", "K5"):
        kernels[name].launches_by_route.update(sm90=0, tile=0)
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks = _greedy_decode(torch, api, cfg, params, prompts, n_fwd, policy)
        toks_host = toks.cpu()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    pf, dc = per_forward("prefill"), per_forward("decode")
    want = {name: pf.get(name, 0) + (n_fwd - 1) * dc.get(name, 0) for name in kernels}
    counted = f"a prefill's {pf} + {n_fwd - 1} x a decode step's {dc}"
    plain_calls = {name: (ops.backend(name).calls, ops.backend(name).grouped_calls)
                   for name in ("torch", "torch_q8")}
    if launches != want or any(sum(c) for c in plain_calls.values()):
        raise AssertionError(f"{tag} launches {launches} != {want} (plain calls {plain_calls})")
    for name in ("K1", "K2", "K5"):
        check_routes(kernels[name], launches[name], f"{tag} (d)", name=name)
    if tuple(toks_host.shape) != (4, n_fwd) or not ((toks_host >= 0) & (toks_host < cfg.vocab)).all():
        raise AssertionError(f"{tag} greedy tokens {tuple(toks_host.shape)}")
    log(f"{tag} (d) greedy 4 x 64 prompt + 16 decode steps in {wall:.3f} s "
        f"({4 * n_fwd / wall:.1f} tokens/s); launches {launches} = {counted}, every K1, K2 "
        f"and K5 launch on sm90; "
        f"plain calls 0")

    # (e) one decode step at 4 rows: wall time and its kernel split.
    with torch.inference_mode():
        logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 96, backend=policy)
        tok = logits.argmax(-1)[:, None]
        for i in range(3):
            logits, caches = api.decode(cfg, params, tok, caches, 64 + i, backend=policy)
        sync(torch, dev)
        n_steps = 8
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, caches = api.decode(cfg, params, tok, caches, 67 + i, backend=policy)
        sync(torch, dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        prof = decode_profile(torch, lambda i: api.decode(cfg, params, tok, caches, 75 + i,
                                                          backend=policy), step_ms, tag=f"{tag} (e)")
    dev_ms = None
    if prof is not None:
        # Each kernel's name holds its own key and no other's (K5's two
        # routes both "opope_q8_grouped_kernel"): a kernel whose name holds
        # two would be booked twice, and fails the run.
        names = {"K1": "opope_gemm_kernel", "K4": "opope_grouped_kernel",
                 "K2": "opope_q8_gemm_kernel", "K5": "opope_q8_grouped_kernel"}
        for key, _, _ in prof:
            if sum(v in key for v in names.values()) > 1:
                raise AssertionError(f"{tag} (e): kernel {key} matches two kernels' names")
        dev_ms = {k: sum(ms for key, ms, _ in prof if v in key) for k, v in names.items()}
        missing = [k for k in names if launches.get(k) and not dev_ms[k]]
        if missing:
            raise AssertionError(f"{tag} (e): the profiled decode step books no device time "
                                 f"to {missing}, which the path launches")
        dev_ms["busy"] = sum(ms for _, ms, _ in prof)
        dev_ms["other"] = dev_ms["busy"] - sum(dev_ms[k] for k in names)
        log(f"{tag} (e) decode step, 4 rows: {step_ms:.3f} ms wall; device busy "
            f"{dev_ms['busy']:.3f} ms: " + ", ".join(f"{k} {dev_ms[k]:.3f} ms" for k in names)
            + f", other kernels (the per-call quantization passes among them) "
            f"{dev_ms['other']:.3f} ms")
    audited = q8_audit(torch, cfg, params, policy, kernels, dev, tag) if audit else None
    return {"launches": launches, "layer_err": layer_err, "logits_rms": d_k,
            "logits_floor_rms": d_f, "q8_vs_bf16": q8_vs_bf16, "greedy_s": wall,
            "decode_step_ms": step_ms, "device_ms": dev_ms, "audit": audited}


def q8_audit(torch, cfg, params, policy, kernels, dev, tag):
    """Phase 8(f) (4(h)(iv)): with ``REPRO_AUDIT=1`` in force, one MLP of
    direct calls (K2 at the model's three MLP shapes, each re-executed on K1
    by the auditor) is audited within the q8 policy's 5 % with no drift
    event; a served q8 decode step (its first, capturing dispatch and a
    later, quiet one) is audited nowhere."""
    from repro_torch import obs
    from repro_torch.models import api
    from repro_torch.models.layers import mlp_apply
    from repro_torch.obs import attr as obs_attr
    from repro_torch.obs import audit as obs_audit

    obs.reset()
    obs.clear_events()
    obs_audit.set_audit_every(1)
    try:
        x = torch.randn(4, cfg.d_model, device=dev, generator=torch.Generator(
            device=dev).manual_seed(5)).to(torch.bfloat16)
        k1_0, k2_0 = kernels["K1"].launches, kernels["K2"].launches
        with torch.inference_mode():
            mlp_apply(params["blocks"][0]["mlp"], x, backend=policy, residual=x)
        sync(torch, dev)
        snap = obs.snapshot()
        audits = snap["counters"].get("numerics.audits", {})
        rel = snap["histograms"].get("numerics.rel_err", {})
        drift = obs.recent_events(kind="numerics_drift")
        k1, k2 = kernels["K1"].launches - k1_0, kernels["K2"].launches - k2_0
        worst = max((h["max"] for h in rel.values()), default=None)
        if (audits != {"backend=cuda_q8,family=q8,shape=dense": 3.0} or (k1, k2) != (3, 3)
                or worst is None or not worst < 0.05 or drift):
            raise AssertionError(f"{tag} (f) audit: {audits}, K1/K2 launches {k1}/{k2}, "
                                 f"max rel_err {worst}, drift events {drift}")
        # A served step: the engines run each dispatch in a step scope.
        prompts = torch.randint(0, cfg.vocab, (4, 16), device=dev)
        obs_audit.set_audit_every(0)
        with torch.inference_mode():
            logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 24, backend=policy)
            tok = logits.argmax(-1)[:, None]
            obs_audit.set_audit_every(1)
            for i, capture in enumerate((True, False)):
                with obs_attr.step_scope(capture):
                    logits, caches = api.decode(cfg, params, tok, caches, 16 + i, backend=policy)
        sync(torch, dev)
        after = obs.snapshot()["counters"].get("numerics.audits", {})
        if after != audits:
            raise AssertionError(f"{tag} (f) a served q8 step was audited: {after}")
        log(f"{tag} (f) REPRO_AUDIT=1: the 3 direct MLP calls audited (K2, re-executed on K1: "
            f"K1 +{k1}, K2 +{k2} launches), max rel_err {worst:.4g} < 0.05, no drift event; "
            f"a served q8 decode step (capturing and quiet dispatch) audited none")
        return {"audits": 3, "max_rel_err": worst}
    finally:
        obs_audit.set_audit_every(None)


# K3 against its plain version: fp32 within rtol = atol = 2e-4 (the
# reference's own tolerance; only the order of sums and the exp
# implementation differ). bf16 (P and the output round to bf16 at places
# that differ by the running max): each element within ATTN_BF16_TOL +
# ATTN_BF16_TOL·|plain| (the H100 measured at most 0.0039 at the prefill
# row, where |out| reaches 1), and the error's RMS within ATTN_BF16_RMS of
# the plain output's RMS. Random attention outputs over 2048 keys are
# about 0.04 in size, so the RMS gate is what catches a dropped or
# misweighted KV panel there (one panel of 32 moves the RMS by ~0.18).
ATTN_F32_TOL = 2e-4
ATTN_BF16_TOL = 1e-2
ATTN_BF16_RMS = 2e-2


def attn_bound(b, h, s, t, d, causal, elem):
    """Least time in ms of one K3 call, and what bounds it: q, k, v and the
    output moved once each, or 4·D flops for each (query, valid key) pair
    (causal: the pairs under the mask aligned to the end of the keys) at
    the bf16 tensor-core rate."""
    t_bytes = elem * b * h * 2 * (s + t) * d / HBM_BYTES_PER_S
    t_ops = attn_flops(b, h, s, t, d, causal) / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_flops(b, h, s, t, d, causal):
    """4·D flops for each (query, valid key) pair (causal: under the mask
    aligned to the end of the keys): Q Kᵀ and P·V."""
    pairs = sum(max(0, min(r + t - s + 1, t)) for r in range(s)) if causal else s * t
    return 4 * b * h * pairs * d


def attn_check(torch, out, want, what):
    """K3's output against its plain version's (or another attention's) on
    the same inputs, at the gates of ``out``'s dtype (fp16 at bf16's; e4m3
    and e5m2 at ATTN_FP8's); returns the largest absolute difference and the
    difference's RMS over the reference's."""
    if out.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return attn_check_fp8(torch, out, want, what)
    bf16 = out.dtype in (torch.bfloat16, torch.float16)
    out, want = out.float(), want.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite output")
    diff = out - want
    err = diff.abs().max().item()
    rel_rms = (diff.square().mean().sqrt() / want.square().mean().sqrt().clamp(min=1e-30)).item()
    tol = ATTN_BF16_TOL if bf16 else ATTN_F32_TOL
    torch.testing.assert_close(out, want, rtol=tol, atol=tol, msg=lambda m: f"{what}: {m}")
    if bf16 and rel_rms > ATTN_BF16_RMS:
        raise AssertionError(f"{what}: error RMS {rel_rms} x the output's > {ATTN_BF16_RMS}")
    return err, rel_rms


# K3 with 8-bit q, k and v: P rounds to v's format (3 or 2 mantissa bits)
# on both sides where the reference rounds it, at the running maximum
# through each of its KV panels, so the same values round up to the last
# fp32 bit of a score. Each element within one ulp of the output format
# plus one at the plain output's largest magnitude (tests/test_torch_dtypes.py's
# gate), and the error's RMS within ATTN_FP8_RMS of the format's relative
# spacing (2**-3 for e4m3, 2**-2 for e5m2) times the plain output's RMS.
# At 17(c)'s shapes on the H100 the kernel reads 0.0004 to 0.0011
# spacings; two broken builds of it, none of whose elements leaves the
# per-element gate, read 0.27 (P left unrounded) and 0.13 (P rounded at the
# kernel's own 64-key panels) (tools/fp8_attention_control_probe.py).
ATTN_FP8_RMS = 1 / 16


def attn_check_fp8(torch, out, want, what):
    """:func:`attn_check` for e4m3 and e5m2 outputs."""
    g, w = out.float(), want.float()
    if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = (g - w).abs()
    tol = ulp(torch, w, out.dtype) + ulp(torch, w.abs().max(), out.dtype)
    spacing = 2.0 ** -3 if out.dtype == torch.float8_e4m3fn else 2.0 ** -2
    rel_rms = (diff.square().mean().sqrt() / w.square().mean().sqrt().clamp(min=1e-30)).item()
    bad = (diff > tol).sum().item()
    if bad or rel_rms > ATTN_FP8_RMS * spacing:
        raise AssertionError(f"{what}: {bad} elements beyond one ulp and the floor, error RMS "
                             f"{rel_rms:.4g} x the output's (limit {ATTN_FP8_RMS * spacing:.4g})")
    return diff.max().item(), rel_rms


def attention_scan_phase(torch, F, kscan, mattn, cfg, jcfg, shape_32k, dev):
    """Phase 9: K3 and K6 through the ``kernels`` entry points, at the width
    of chatglm3-6b's attention and of jamba-v0.1's mamba scan. Returns the
    two kernels' records."""
    import importlib

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.opope_attention import (
        opope_attention, opope_attention_bhsd, opope_attention_plain)

    k3 = importlib.import_module("repro_torch.kernels.opope_attention")

    gen = torch.Generator(device=dev).manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    h, hkv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim_

    def qkv(b, s, t):
        """bf16 q [B, S, H, D] and k, v [B, T, Hkv, D]: the model's layout."""
        return (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf16),
                torch.randn((b, t, hkv, d), generator=gen, device=dev).to(bf16),
                torch.randn((b, t, hkv, d), generator=gen, device=dev).to(bf16))

    def heads(q, k, v):
        """[B, H, S, D] views of q and of k, v with their KV heads expanded."""
        return (q.transpose(1, 2), k.repeat_interleave(h // hkv, dim=2).transpose(1, 2),
                v.repeat_interleave(h // hkv, dim=2).transpose(1, 2))

    # (a) the main path: chatglm3-6b's attention at a prefill, a chunk
    # continuation, a decode row and without a mask, then one scan at
    # jamba's width (d_inner * d_state columns, train_4k's sequence), all
    # through the entry points with every launch counted.
    attn_rows = [("prefill", 4, 2048, 2048, True), ("continuation", 4, 512, 2048, True),
                 ("decode", 4, 1, 2048, True), ("non-causal", 4, 2048, 2048, False)]
    inputs = {name: qkv(b, s, t) for name, b, s, t, _ in attn_rows}
    views = {name: heads(*x) for name, x in inputs.items()}
    s_scan, n_state = 4096, jcfg.mamba.expand * jcfg.d_model * jcfg.mamba.d_state
    decay = 0.2 + 0.79 * torch.rand((s_scan, n_state), generator=gen, device=dev)
    update = torch.randn((s_scan, n_state), generator=gen, device=dev)
    # The route the plan gives each row: every one of them is sm90's (the
    # decode row too: measured beside the tile route, it is faster there).
    routes = {name: k3._plan(views[name][0].shape, t, bf16, causal,
                             [x.stride() for x in views[name]],
                             [x.data_ptr() for x in views[name]]).route
              for name, _, _, t, causal in attn_rows}
    if set(routes.values()) != {"sm90"}:
        raise AssertionError(f"phase 9 K3 rows off the sm90 route: {routes}")
    sync(torch, dev)
    opope_attention.launches = 0
    opope_attention.launches_by_route = {"sm90": 0, "tile": 0}
    kscan.opope_chunked_scan.launches = 0
    outs = {name: opope_attention_bhsd(*views[name], causal=causal)
            for name, _, _, _, causal in attn_rows}
    states = kscan.opope_chunked_scan(decay, update)
    sync(torch, dev)
    launches = {"k3": opope_attention.launches, "k6": kscan.opope_chunked_scan.launches}
    k3_by_route = dict(opope_attention.launches_by_route)
    if launches != {"k3": len(attn_rows), "k6": 1}:
        raise AssertionError(f"phase 9 launches {launches} != K3 {len(attn_rows)}, K6 1")
    if k3_by_route != {"sm90": len(attn_rows), "tile": 0}:
        raise AssertionError(f"phase 9 K3 launches by route {k3_by_route}, want all "
                             f"{len(attn_rows)} on sm90")
    log(f"9 (a) main path: {len(attn_rows)} opope_attention_bhsd calls at {h} heads x head dim "
        f"{d} and one opope_chunked_scan over [{s_scan}, {n_state}]: launches {launches}, K3 "
        f"by route {k3_by_route}")

    # Each output against the plain version, then the same call (the
    # strided [B, H, S, D] views the kernel reads in place) timed by device
    # time (queued_ms) on the planned route and on the tile route, beside
    # SDPA (the library lane: never called by the port), the plain version
    # (CUDA events: its many kernels) and the bound. Launches made for
    # timing and comparison are not the main path's and are not counted in
    # `launches`.
    rows, k3_err = [], 0.0
    for name, b, s, t, causal in attn_rows:
        qh, kh, vh = views.pop(name)
        want = opope_attention_plain(qh, kh, vh, causal=causal)
        err, rel_rms = attn_check(torch, outs[name], want, f"K3 {name} B={b} S={s} T={t}")
        k3_err = max(k3_err, err)
        tile_out = k3._launch(qh, kh, vh, causal, 128, 128, route="tile")
        attn_check(torch, tile_out, want, f"K3 {name} on the tile route")
        del want, tile_out
        ms = queued_ms(torch, lambda i: opope_attention_bhsd(qh, kh, vh, causal=causal))
        ms_tile = queued_ms(torch, lambda i: k3._launch(qh, kh, vh, causal, 128, 128,
                                                        route="tile"))
        plain_ms = time_ms(torch, lambda i: opope_attention_plain(qh, kh, vh, causal=causal),
                           1, iters=3, warmup=1)
        # SDPA's is_causal is aligned to the start of the keys: S != T takes
        # the end-aligned mask explicitly.
        mask = (torch.ones((s, t), dtype=torch.bool, device=dev).tril(t - s)
                if causal and s != t else None)
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                 is_causal=causal and mask is None)
        lib_ms = queued_ms(torch, lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal and mask is None))
        lib_diff = (lib_out.float() - outs[name].float()).abs().max().item()
        bound_ms, bound_by = attn_bound(b, h, s, t, d, causal, 2)
        tflops = attn_flops(b, h, s, t, d, causal) / (ms * 1e-3) / 1e12
        rows.append({"name": name, "b": b, "h": h, "s": s, "t": t, "d": d, "causal": causal,
                     "dtype": "bfloat16", "route": routes[name], "ms": ms,
                     "ms_tile_route": ms_tile, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "tflops": tflops,
                     "max_abs_err": err, "err_rms_over_out_rms": rel_rms,
                     "sdpa_max_abs_diff": lib_diff})
        log(f"9 (a) K3 {name} B={b} H={h} S={s} T={t} D={d} causal={causal}: vs plain max abs "
            f"err {err:.3g} (gate {ATTN_BF16_TOL} + {ATTN_BF16_TOL} |plain|), error RMS / output "
            f"RMS {rel_rms:.3g} (gate {ATTN_BF16_RMS}); device time {routes[name]} route "
            f"{ms:.4f} ms ({tflops:.0f} TFLOP/s), tile route {ms_tile:.4f} ms, SDPA "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); plain {plain_ms:.4f} ms "
            f"(CUDA events); |K3 - SDPA| max {lib_diff:.3g} (not gated)")
        del qh, kh, vh, lib_out

    # (b) the same prefill against the model's own attention, which takes
    # the [B, S, H, D] layout and the 2 unexpanded KV heads.
    q, k, v = inputs["prefill"]
    with torch.inference_mode():
        model_out = mattn.blockwise_attention(q, k, v, causal=True)
    if not torch.isfinite(model_out.float()).all():
        raise AssertionError("blockwise_attention: non-finite output")
    model_err, model_rms = attn_check(torch, outs["prefill"].transpose(1, 2), model_out,
                                      "K3 prefill vs blockwise_attention")
    log(f"9 (b) K3 prefill against models/attention.py::blockwise_attention (GQA, {hkv} KV "
        f"heads): max abs err {model_err:.3g}, error RMS / output RMS {model_rms:.3g} (the "
        "bf16 gates of (a))")
    del inputs, outs, model_out

    # Coverage, on each route that takes the case (tile: all; sm90: bf16 at
    # head dims 64 and 128 but causal S > T) and through both entry points:
    # every test shape of the reference (fp32 and bf16), S > T causal rows
    # without a valid key at two block sizes, head dim 16; and for the sm90
    # route S and T off the 128-row tile, continuations whose diagonal
    # crosses a panel, head dim 64, B·H > 1 on [B, S, H, D] views, and T of
    # one key.
    n_cov, cov_routes = 0, {"sm90": 0, "tile": 0}
    cov = [(1, 1, 128, 128, 64, True, 64, False), (1, 1, 100, 160, 64, True, 64, False),
           (1, 1, 96, 128, 32, False, 64, False), (1, 1, 77, 77, 64, True, 64, False),
           (1, 1, 256, 256, 128, True, 64, False), (2, 3, 64, 64, 32, True, 32, False),
           (1, 1, 96, 64, 64, True, 32, False), (1, 1, 96, 64, 64, True, 64, False),
           (2, 2, 200, 70, 32, True, 64, False), (2, 2, 200, 70, 32, True, 128, False),
           (2, 4, 96, 64, 16, True, 128, False), (1, 4, 1, 300, 128, True, 128, False),
           (1, 1, 129, 300, 128, True, 128, False), (1, 1, 127, 127, 128, False, 128, False),
           (2, 3, 200, 333, 128, True, 128, True), (1, 2, 129, 1000, 64, True, 128, False),
           (3, 5, 257, 700, 64, True, 128, True), (2, 4, 300, 300, 64, False, 128, True),
           (1, 1, 1, 1, 128, True, 128, False), (1, 2, 5, 1, 128, False, 128, False),
           (1, 1, 1, 1, 64, False, 128, False)]
    for dt in (f32, bf16):
        for b, hh, s, t, dd, causal, blk, bshd in cov:
            if bshd:  # [B, H, N, D] views of [B, N, H, D] tensors
                q, k, v = (torch.randn((b, n, hh, dd), generator=gen, device=dev).to(dt)
                           .transpose(1, 2) for n in (s, t, t))
            else:
                q, k, v = (torch.randn((b, hh, n, dd), generator=gen, device=dev).to(dt)
                           for n in (s, t, t))
            what = f"K3 coverage {b}x{hh}x{s}x{t}x{dd} causal={causal} blocks={blk} {dt}"
            want = opope_attention_plain(q, k, v, causal=causal, block_q=blk, block_k=blk)
            plan = k3._plan(q.shape, t, dt, causal, [x.stride() for x in (q, k, v)],
                            [x.data_ptr() for x in (q, k, v)])
            for route in ("tile", "sm90") if plan.route == "sm90" else ("tile",):
                out = k3._launch(q, k, v, causal, blk, blk, route=route)
                sync(torch, dev)
                err, _ = attn_check(torch, out, want, f"{what} on the {route} route")
                k3_err = max(k3_err, err)
                cov_routes[route] += 1
            out = opope_attention_bhsd(q, k, v, causal=causal, block_q=blk, block_k=blk)
            sync(torch, dev)
            attn_check(torch, out, want, what)
            out = opope_attention(q[0, 0], k[0, 0], v[0, 0], causal=causal, block_q=blk,
                                  block_k=blk)
            attn_check(torch, out, want[0, 0], f"K3 single-head coverage {s}x{t}x{dd} {dt}")
            n_cov += 1
    log(f"9 (a) K3 coverage: {n_cov} ragged/dtype/block/head-dim/layout cases within "
        f"tolerance through both entry points, and by route {cov_routes}")

    # chatglm3-6b's prefill_32k sequence: kernel and SDPA only.
    s32 = shape_32k.seq_len
    qh, kh, vh = heads(*qkv(1, s32, s32))
    out = opope_attention_bhsd(qh, kh, vh)
    sync(torch, dev)
    if not torch.isfinite(out.float()).all():
        raise AssertionError("K3 prefill_32k: non-finite output")
    route_32k = k3._plan(qh.shape, s32, bf16, True, [x.stride() for x in (qh, kh, vh)],
                         [x.data_ptr() for x in (qh, kh, vh)]).route
    ms_32k = queued_ms(torch, lambda i: opope_attention_bhsd(qh, kh, vh), iters=3, warmup=1)
    tile_32k = queued_ms(torch, lambda i: k3._launch(qh, kh, vh, True, 128, 128, route="tile"),
                         iters=3, warmup=1)
    lib_32k = queued_ms(torch, lambda i: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), iters=3, warmup=1)
    diff_32k = (F.scaled_dot_product_attention(qh, kh, vh, is_causal=True).float()
                - out.float()).abs().max().item()
    bound_32k, by_32k = attn_bound(1, h, s32, s32, d, True, 2)
    tflops_32k = attn_flops(1, h, s32, s32, d, True) / (ms_32k * 1e-3) / 1e12
    rows.append({"name": shape_32k.name, "b": 1, "h": h, "s": s32, "t": s32, "d": d,
                 "causal": True, "dtype": "bfloat16", "route": route_32k, "ms": ms_32k,
                 "ms_tile_route": tile_32k, "plain_ms": None, "library_ms": lib_32k,
                 "bound_ms": bound_32k, "bound_by": by_32k, "tflops": tflops_32k,
                 "max_abs_err": None, "sdpa_max_abs_diff": diff_32k})
    log(f"9 (a) K3 {shape_32k.name} B=1 H={h} S=T={s32}: device time {route_32k} route "
        f"{ms_32k:.3f} ms ({tflops_32k:.0f} TFLOP/s), tile route {tile_32k:.3f} ms, SDPA "
        f"{lib_32k:.3f} ms, bound {bound_32k:.3f} ms ({by_32k}); |K3 - SDPA| max {diff_32k:.3g} "
        f"(not gated); plain version skipped: its fp32 scores alone would take "
        f"{4 * h * s32 * s32 / 1e9:.0f} GB")
    del qh, kh, vh, out

    # (c) K6 at jamba's width, bitwise against its plain version.
    want = kscan.opope_chunked_scan_plain(decay, update)
    if not torch.equal(states, want):
        bad = (states != want).sum().item()
        raise AssertionError(f"K6 [{s_scan}, {n_state}]: {bad} states differ from the plain "
                             "version (bitwise gate)")
    del want
    ms_scan = time_ms(torch, lambda i: kscan.opope_chunked_scan(decay, update), 1)
    plain_scan = time_ms(torch, lambda i: kscan.opope_chunked_scan_plain(decay, update), 1,
                         iters=1, warmup=0)
    bound_scan = 1e3 * 3 * 4 * s_scan * n_state / HBM_BYTES_PER_S
    log(f"9 (c) K6 [{s_scan}, {n_state}] fp32: bitwise equal to the plain version; kernel "
        f"{ms_scan:.4f} ms, plain {plain_scan:.1f} ms, bound {bound_scan:.4f} ms (bytes)")
    del decay, update, states
    n_scan = 0
    for s, n in ((100, 1), (100, 3), (100, 100), (1, 5), (130, 4096)):
        for dts in ((f32, f32), (bf16, bf16), (f32, bf16), (bf16, f32)):
            a = (0.2 + 0.79 * torch.rand((s, n), generator=gen, device=dev)).to(dts[0])
            u = torch.randn((s, n), generator=gen, device=dev).to(dts[1])
            got = kscan.opope_chunked_scan(a, u, chunk=16)
            sync(torch, dev)
            if not (torch.equal(got, kscan.opope_chunked_scan_plain(a, u))
                    and torch.equal(got, kscan.opope_chunked_scan(a, u, chunk=64))):
                raise AssertionError(f"K6 coverage [{s}, {n}] {dts}: not bitwise")
            n_scan += 1
    log(f"9 (c) K6 coverage: {n_scan} ragged/dtype cases bitwise, chunk 16 = chunk 64")

    k3 = rows[0]
    k3_record = {
        "name": "opope_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/opope_attention.cu",
        "replaces": "src/repro/kernels/opope_attention.py:118",
        "launches": launches["k3"],
        "launches_by_path": {"kernels entry point, chatglm3-6b attention width": launches["k3"]},
        "launches_by_route": k3_by_route,
        "max_abs_err": k3_err,
        "ms": k3["ms"],
        "ms_tile_route": k3["ms_tile_route"],
        "tflops": k3["tflops"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "model_attention_max_abs_err": model_err,
        "work": f"one causal prefill of chatglm3-6b's attention, B=4, H={h}, S=T=2048, D={d}, "
                "bf16, on the sm90 route (per-shape rows under 'shapes')",
        "timing": "ms, ms_tile_route and library_ms: device time by CUDA events around calls "
                  "queued behind a sleeping kernel (queued_ms); plain_ms: CUDA events around "
                  "the loop",
        "coverage_by_route": cov_routes,
        "build_s": kbuild.BUILD_SECONDS.get("opope_attention"),
        "shapes": rows,
    }
    k6_record = {
        "name": "opope_chunked_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/opope_scan.cu",
        "replaces": "src/repro/kernels/opope_scan.py:65",
        "launches": launches["k6"],
        "launches_by_path": {"kernels entry point, jamba-v0.1 mamba scan width": launches["k6"]},
        "max_abs_err": 0.0,
        "ms": ms_scan,
        "plain_ms": plain_scan,
        "bound_ms": bound_scan,
        "bound_by": "bytes",
        "library_ms": None,
        "library": "none: no single PyTorch call returns every state of a linear recurrence",
        "work": f"all {s_scan} states of {n_state} fp32 columns (jamba-v0.1's d_inner x d_state "
                "at train_4k)",
    }
    return k3_record, k6_record


def _leaf_paths(tree, prefix=""):
    """``(path, leaf)`` of a parameter tree, in the order of its leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rms(x):
    return x.double().pow(2).mean().sqrt().item()


def _rms_gap(torch, a, b):
    """RMS of ``a - b`` with fp64 sums, RMS_GAP_SLICE elements at a time
    (one of grok-1-314b's expert gradients in fp64 would take 12.9 GB); NaN
    when ``a`` holds a non-finite value."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    total = 0.0
    for i in range(0, fa.numel(), RMS_GAP_SLICE):
        x = fa[i:i + RMS_GAP_SLICE]
        if not torch.isfinite(x).all():
            return math.nan
        total += (x.double() - fb[i:i + RMS_GAP_SLICE].double()).pow(2).sum().item()
    return math.sqrt(total / max(fa.numel(), 1))


def _floor_gate(torch, got, ref, ref64, what):
    """``got`` (kernels) against ``ref`` (plain) within TRAIN_GRAD_FLOOR_FACTOR
    times the RMS gap of ``ref`` and ``ref64`` (plain, fp64 sums). Returns
    (RMS kernels vs plain, the floor)."""
    d_k = _rms_gap(torch, got, ref) if tuple(got.shape) == tuple(ref.shape) else math.nan
    if math.isnan(d_k):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or "
                             f"not finite")
    d_f = _rms_gap(torch, ref, ref64)
    if not d_k <= TRAIN_GRAD_FLOOR_FACTOR * d_f:
        raise AssertionError(f"{what}: kernels vs plain RMS {d_k:.4g} > "
                             f"{TRAIN_GRAD_FLOOR_FACTOR} x floor {d_f:.4g}")
    return d_k, d_f


def _gate_first_step(torch, params, losses, grads, tag):
    """A first step's loss and every gradient leaf on the kernels against
    the plain backend: ``losses`` and ``grads`` are (kernels, plain, plain
    with fp64 sums). The loss within TRAIN_LOSS_RTOL, each leaf under
    :func:`_floor_gate`. Returns (the gaps by leaf path, the worst leaf)."""
    loss_k, loss_p, loss_64 = losses
    if not all(torch.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} first-step losses {loss_k}, {loss_p}, {loss_64}")
    loss_gap = abs(loss_k.item() - loss_p.item())
    if loss_gap > TRAIN_LOSS_RTOL * abs(loss_p.item()):
        raise AssertionError(f"{tag} first-step loss: kernels {loss_k.item()} vs plain "
                             f"{loss_p.item()}: gap {loss_gap} > {TRAIN_LOSS_RTOL} x loss")
    leaf_gaps = {}
    for (path, _), x, y, z in zip(_leaf_paths(params), *grads):
        leaf_gaps[path] = _floor_gate(torch, x, y, z, f"{tag} first-step d{path}")
    worst = max(leaf_gaps, key=lambda p: leaf_gaps[p][0] / max(leaf_gaps[p][1], 1e-30))
    return leaf_gaps, worst


def train_phase(torch, np, cfg, ops, ep, dev, *, layers=TRAIN_LAYERS, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, steps=TRAIN_STEPS):
    """Phase 10: dense training on K1. (a) the backward GEMMs of one layer
    at M = batch * seq, (b) the model cut to ``layers`` layers through
    ``repro_torch.train.train``, (d) the launch gates ((c), the training
    CLI at its reduced config, runs in 12(e) with ``--ckpt-dir``). Returns
    K1's training record."""
    import dataclasses
    import importlib

    from repro_torch import obs
    from repro_torch.data import MarkovLMDataset, make_batch_fn
    from repro_torch.kernels.opope_gemm import full_fp32, opope_gemm
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainLoopConfig, make_train_step, train
    from repro_torch.tree import leaves, map_leaves
    k1mod = importlib.import_module("repro_torch.kernels.opope_gemm")

    t_phase = time.perf_counter()
    fp64, plain = _fp64_plain(torch, ep), ops.backend("torch")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(10)
    m = batch * seq
    d, dq, dkv, dff = cfg.d_model, cfg.n_heads * cfg.head_dim_, cfg.n_kv * cfg.head_dim_, cfg.d_ff
    layer = [("wq", d, dq, ()), ("wk", d, dkv, ()), ("wv", d, dkv, ()),
             ("wo", dq, d, ("residual",)), ("w_up", d, dff, ()),
             ("w_gate", d, dff, ("silu", "mul")), ("w_down", dff, d, ("residual",))]

    # The recompute's library lane: bf16 in, fp32 out in one call
    # (torch.mm's out_dtype, on builds that have it).
    try:
        torch.mm(torch.ones((8, 8), dtype=bf16, device=dev),
                 torch.ones((8, 8), dtype=bf16, device=dev), out_dtype=f32)
        mm_out_dtype = True
    except (TypeError, RuntimeError, NotImplementedError) as e:
        mm_out_dtype = False
        log(f"10(a) torch.mm(out_dtype=float32) unavailable ({type(e).__name__}): the "
            f"recompute has no library lane")

    # (a) each GEMM's vjp through ops.matmul on the kernels ("cuda") and on
    # the plain backend (fp32 and fp64 sums), the same inputs and cotangent.
    by_role = {"forward": 0, "recompute": 0, "bf16 backward": 0, "fp32 backward": 0}
    rows, worst = [], 0.0
    for name, k, n, steps_ in layer:
        a = torch.randn((m, k), generator=gen, device=dev).to(bf16).requires_grad_()
        b = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(bf16).requires_grad_()
        operands = [torch.randn((m, n), generator=gen, device=dev).to(bf16).requires_grad_()
                    for s_ in steps_ if ep.op_kind(s_) != "none"]
        it = iter(operands)
        spec = [s_ if ep.op_kind(s_) == "none" else (s_, next(it)) for s_ in steps_] or None
        g = torch.randn((m, n), generator=gen, device=dev).to(bf16)
        inputs = [a, b, *operands]

        def vjp(backend):
            out = ops.matmul(a, b, backend=backend, epilogue=spec)
            return torch.autograd.grad(out, inputs, g)

        _reset_k1(ops, opope_gemm)
        out = ops.matmul(a, b, backend="cuda", epilogue=spec)
        sync(torch, dev)
        check_routes(opope_gemm, 1, f"10(a) {name} forward")
        opope_gemm.launches_by_route.update(sm90=0, tile=0)
        got = torch.autograd.grad(out, inputs, g)
        sync(torch, dev)
        want = {"sm90": 1, "tile": 2} if steps_ else {"sm90": 2, "tile": 0}
        if opope_gemm.launches_by_route != want:
            raise AssertionError(f"10(a) {name} backward: K1 launches by route "
                                 f"{opope_gemm.launches_by_route} != {want}")
        by_role["forward"] += 1
        by_role["recompute" if steps_ else "bf16 backward"] += 1 if steps_ else 2
        by_role["fp32 backward"] += 2 if steps_ else 0
        ref = vjp("torch")
        with _patched(plain, "fn", fp64):
            ref64 = vjp("torch")
        gaps = {}
        for what, x, y, z in zip(["dA", "dB"] + [f"d_{s_}" for s_ in steps_
                                                  if ep.op_kind(s_) != "none"], got, ref, ref64):
            gaps[what] = _floor_gate(torch, x, y, z, f"10(a) {name} {what}")
            worst = max(worst, gaps[what][0] / max(gaps[what][1], 1e-30))

        # The backward's GEMMs as it runs them, one by one: the operand
        # copies (transposes; casts to fp32 beside the fp32 cotangent), the
        # kernel on its planned route, torch.matmul on the same operands.
        with torch.no_grad():
            a0, b0 = a.detach(), b.detach()
            g_acc = g
            gemms = []
            if steps_:
                acc = opope_gemm(a0, b0, out_dtype=f32)
                g_acc, _ = ep.epilogue_vjp(steps_, tuple(o.detach() for o in operands), acc, g)
                gemms.append(("recompute", a0, b0, f32))
            gemms += [("dA", g_acc, b0.t(), bf16), ("dB", a0.t(), g_acc, bf16)]
            for role, x, y, out_dtype in gemms:
                dt = torch.promote_types(x.dtype, y.dtype)
                copy_ms = queued_ms(torch, lambda i: (x.to(dt).contiguous(),
                                                      y.to(dt).contiguous()), 5)
                xc, yc = x.to(dt).contiguous(), y.to(dt).contiguous()
                mm, kk, nn = xc.shape[0], xc.shape[1], yc.shape[1]
                plan = k1mod._plan(mm, nn, kk, dt, xc.data_ptr(), yc.data_ptr())
                iters = 5 if dt == f32 else 10
                ms = queued_ms(torch, lambda i: opope_gemm(xc, yc, out_dtype=out_dtype), iters)
                if dt == bf16 and out_dtype == f32:  # bf16 in, fp32 out: the recompute
                    lib = (lambda i: torch.mm(xc, yc, out_dtype=f32)) if mm_out_dtype else None
                else:  # fp32 in writes fp32: no single call casts to bf16
                    lib = lambda i: torch.matmul(xc, yc)  # noqa: E731
                with full_fp32():
                    lib_ms = None if lib is None else queued_ms(torch, lib, iters)
                t_bytes = (mm * kk * x.element_size() + kk * nn * y.element_size()
                           + mm * nn * torch.empty((), dtype=out_dtype).element_size()
                           ) / HBM_BYTES_PER_S
                t_ops = 2 * mm * nn * kk / (FP32_FLOPS if dt == f32 else BF16_FLOPS)
                row = {"gemm": name, "role": role, "m": mm, "k": kk, "n": nn,
                       "in_dtype": str(dt).removeprefix("torch."),
                       "out_dtype": str(out_dtype).removeprefix("torch."), "route": plan.route,
                       "ms": ms, "library_ms": lib_ms, "copy_ms": copy_ms,
                       "bound_ms": 1e3 * max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
                rows.append(row)
                log(f"10(a) {name} {role} [{mm}x{kk}]@[{kk}x{nn}] {row['in_dtype']} -> "
                    f"{row['out_dtype']}: K1 {plan.route} {ms:.4f} ms ({2 * mm * nn * kk / ms / 1e9:.1f} "
                    f"TFLOP/s), library {'n/a' if lib_ms is None else f'{lib_ms:.4f}'} ms, "
                    f"operand copies {copy_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
                    f"({row['bound_by']})")
        log(f"10(a) {name} vjp: " + ", ".join(
            f"{w} RMS {dk:.3g} (floor {df:.3g})" for w, (dk, df) in gaps.items()))
        del a, b, operands, inputs, got, ref, ref64, out
    sums = {key: sum(r[key] or 0.0 for r in rows)
            for key in ("ms", "library_ms", "copy_ms", "bound_ms")}
    fp32_rows = [r for r in rows if r["in_dtype"] == "float32"]
    fp32_sums = {key: sum(r[key] for r in fp32_rows) for key in ("ms", "library_ms", "bound_ms")}
    log(f"10(a) one layer's backward GEMMs at M={m}: K1 {sums['ms']:.3f} ms (fp32 tile route "
        f"{fp32_sums['ms']:.3f} ms of it), library {sums['library_ms']:.3f} ms, operand "
        f"copies {sums['copy_ms']:.3f} ms, bound {sums['bound_ms']:.3f} ms; launches by role "
        f"{by_role}; worst kernels/floor RMS ratio {worst:.3g} (gate {TRAIN_GRAD_FLOOR_FACTOR})")

    # (b) the model at full width, cut to `layers` layers, bf16, remat
    # "full". First step: loss and every gradient leaf on the kernels
    # against the plain backend (fp32 and fp64 sums).
    tcfg = dataclasses.replace(cfg, n_layers=layers)
    if not (tcfg.remat and tcfg.remat_policy == "full"):
        raise AssertionError(f"10(b) wants remat 'full', config has {tcfg.remat_policy}")
    params = api.init_params(tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in leaves(params))
    batch_fn = make_batch_fn(MarkovLMDataset(tcfg.vocab, seq, batch, seed=0), dev)
    first = batch_fn(0)

    def loss_grads(backend):
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        loss = api.loss_fn(tcfg, live, first, backend=backend)
        return loss.detach().float(), torch.autograd.grad(loss, list(leaves(live)))

    _reset_k1(ops, opope_gemm)
    loss_k, g_k = loss_grads("cuda")
    sync(torch, dev)
    first_routes = dict(opope_gemm.launches_by_route)
    loss_p, g_p = loss_grads("torch")
    with _patched(plain, "fn", fp64):
        loss_64, g_64 = loss_grads("torch")
    leaf_gaps, worst_leaf = _gate_first_step(torch, params, (loss_k, loss_p, loss_64),
                                             (g_k, g_p, g_64), "10(b)")
    log(f"10(b) {tcfg.name} at {layers} layers ({n_params / 1e9:.3f} B params), first step "
        f"{batch}x{seq}: loss kernels {loss_k.item():.6f}, plain {loss_p.item():.6f}, plain fp64 "
        f"sums {loss_64.item():.6f}; {len(leaf_gaps)} gradient leaves within "
        f"{TRAIN_GRAD_FLOOR_FACTOR} x floor (worst {worst_leaf}: RMS {leaf_gaps[worst_leaf][0]:.3g}, "
        f"floor {leaf_gaps[worst_leaf][1]:.3g}); K1 launches {first_routes}")
    del g_k, g_p, g_64

    # Then `steps` steps through train(), every K1 launch counted.
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    obs.clear_events()
    _reset_k1(ops, opope_gemm)
    t0 = time.perf_counter()
    res = train(tcfg, opt, TrainLoopConfig(total_steps=steps, log_every=1), batch_fn,
                params=params, log=lambda msg: log(f"10(b) {msg}"))
    sync(torch, dev)
    train_s = time.perf_counter() - t0
    train_routes = dict(opope_gemm.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = obs.recent_events(steps, kind="train_step")
    losses = res.losses
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"10(b) losses {losses}")
    if not sum(losses[-2:]) / 2 < losses[0]:
        raise AssertionError(f"10(b) loss did not fall: {losses}")
    walls = [e["wall_s"] for e in events]
    step_s = sum(walls[1:]) / max(1, len(walls) - 1)
    tokens = batch * seq
    log(f"10(b) {steps} steps in {train_s:.2f} s: losses {[round(x, 4) for x in losses]}; step "
        f"wall {step_s * 1e3:.1f} ms (steps 2..{steps}; the first {walls[0] * 1e3:.1f} ms), "
        f"{tokens / step_s:.1f} tokens/s; peak device memory {peak_gb:.2f} GB; K1 launches "
        f"{train_routes}")

    # One more step under the profiler (fresh moments): device busy share
    # and the top kernels.
    step_fn = make_train_step(tcfg, opt)
    state = init_opt_state(params, opt)
    prof = None
    if dev.type == "cuda":
        prof = decode_profile(torch, lambda i: step_fn(params, state, first), step_s * 1e3,
                              n_steps=1, tag="10(b)", what="train step")
    busy_ms = k1_ms = None
    if prof is not None:
        busy_ms = sum(ms for _, ms, _ in prof)
        k1_ms = sum(ms for key, ms, _ in prof if "opope_gemm" in key)
    del state, step_fn, params

    # (d) K1 ran in the backward of (a) and (b), and every forward and
    # recompute launch of (b) on sm90: the fp32 backward GEMMs are the only
    # tile launches, so the counts are exact.
    want = {"sm90": K1_TRAIN_SM90_PER_LAYER * layers * steps,
            "tile": K1_TRAIN_TILE_PER_LAYER * layers * steps}
    if train_routes != want:
        raise AssertionError(f"10(d) K1 launches by route {train_routes} != {want}")
    if by_role["bf16 backward"] == 0 or by_role["fp32 backward"] == 0:
        raise AssertionError(f"10(d) no K1 backward launch in (a): {by_role}")
    phase_s = time.perf_counter() - t_phase
    log(f"10(d) K1 launches: (a) {by_role}, (b) {train_routes} = {layers} layers x {steps} "
        f"steps x ({K1_TRAIN_SM90_PER_LAYER} sm90 + {K1_TRAIN_TILE_PER_LAYER} tile); phase 10 "
        f"took {phase_s:.1f} s")
    return {
        "launches": sum(train_routes.values()),
        "launches_by_route": train_routes,
        "launches_per_layer_step": {"forward (sm90)": 7, "remat recompute (sm90)": 7,
                                    "bf16 backward (sm90)": 8, "fp32 accumulator recompute (sm90)": 3,
                                    "fp32 backward (tile)": 6},
        "backward_gemms": rows,
        "backward_layer": dict(sums, m=m, fp32_tile=fp32_sums),
        "model": {"name": tcfg.name, "layers": layers, "params": n_params, "batch": batch,
                  "seq": seq, "steps": steps, "peak_lr": TRAIN_LR, "losses": losses,
                  "first_step_loss": {"kernels": loss_k.item(), "plain": loss_p.item(),
                                      "plain_fp64": loss_64.item()},
                  "step_ms": step_s * 1e3, "first_step_ms": walls[0] * 1e3,
                  "tokens_per_sec": tokens / step_s, "device_busy_ms": busy_ms,
                  "k1_device_ms": k1_ms, "peak_memory_gb": peak_gb},
        "seconds": phase_s,
    }


def _role_counter(torch, ops, kernels, members=(("cuda", "fn", "K1"),
                                                ("cuda", "grouped_fn", "K4"))):
    """Count each launch of ``kernels`` (name -> wrapper with
    ``launches_by_route``) made through the backend members ``members``
    ((backend, ``fn`` or ``grouped_fn``, kernel name)) by role and route.
    A product the entry points run (``ops._run``: the forward, and the
    remat recompute, which autograd may start from inside a Function's
    backward when it unpacks the saved inputs) takes the role
    ``state["phase"]`` (``"forward"`` or ``"remat recompute"``); a GEMM of
    the backward rules takes ``"fp32 backward"`` for fp32 operands,
    ``"fp32 recompute"`` for the accumulator (fp32 out) and ``"backward"``
    for the rest. Returns (the Counter of (kernel, role, route), the state,
    a context manager that installs the wrappers)."""
    import collections

    counts = collections.Counter()
    state = {"phase": "forward", "in_run": 0}
    real_run = ops._run

    def entry(*args, **kw):
        state["in_run"] += 1
        try:
            return real_run(*args, **kw)
        finally:
            state["in_run"] -= 1

    def wrap(fn, kname):
        kern = kernels[kname]

        def run(a, b, c=None, **kw):
            before = dict(kern.launches_by_route)
            out = fn(a, b, c, **kw)
            if state["in_run"]:
                role = state["phase"]
            elif a.dtype == torch.float32:
                role = "fp32 backward"
            elif kw.get("out_dtype") == torch.float32:
                role = "fp32 recompute"
            else:
                role = "backward"
            for route, n in kern.launches_by_route.items():
                if n - before[route]:
                    counts[(kname, role, route)] += n - before[route]
            return out
        return run

    @contextlib.contextmanager
    def installed():
        with contextlib.ExitStack() as stack:
            stack.enter_context(_patched(ops, "_run", entry))
            for name, attr, kname in members:
                be = ops.backend(name)
                stack.enter_context(_patched(be, attr, wrap(getattr(be, attr), kname)))
            yield

    return counts, state, installed


def _check_role_counts(counts, tables, layers, tag):
    """``counts`` (from :func:`_role_counter`) equal to ``tables`` (kernel
    -> role -> launches a layer) times ``layers``: the fp32 backward GEMMs
    on the tile route, every other launch on sm90, and none outside the
    tables. Returns the launches by "kernel role (route)"."""
    by_role = {}
    for kname, table in tables.items():
        for role, per_layer in table.items():
            route = "tile" if role == "fp32 backward" else "sm90"
            got_n = {r: counts[(kname, role, r)] for r in ("sm90", "tile")}
            if got_n != {route: per_layer * layers, ("sm90" if route == "tile" else "tile"): 0}:
                raise AssertionError(f"{tag} {kname} {role}: launches by route {got_n}, want "
                                     f"{per_layer * layers} on {route}")
            by_role[f"{kname} {role} ({route})"] = per_layer * layers
    if sum(counts.values()) != sum(by_role.values()):
        raise AssertionError(f"{tag} launches outside the counted roles: {dict(counts)}")
    return by_role


def _want_routes(table, layers, steps):
    """A kernel's launches by route over ``steps`` steps of ``layers``
    layers, from its role table (the fp32 backward on tile)."""
    tile = table.get("fp32 backward", 0)
    return {"sm90": (sum(table.values()) - tile) * layers * steps, "tile": tile * layers * steps}


def _moe_first_step(torch, ops, ep, tcfg, params, first, kernels, members, tables, policy,
                    plain_policy, tag):
    """One MoE train step's loss and gradients under ``policy``, every
    launch of ``kernels`` through ``members`` counted by role and route
    against ``tables`` (:func:`_check_role_counts`), each layer's remat
    recompute routing required equal to its forward's; then the same step
    under ``plain_policy`` (fp32 and fp64 sums) teacher-forced on that
    routing, held under :func:`_gate_first_step`. Returns the losses
    (kernels, plain, fp64), the leaf gaps, the worst leaf and the launches
    by role."""
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.tree import leaves, map_leaves

    dev = first["tokens"].device
    fp64, plain = _fp64_plain(torch, ep), ops.backend("torch")
    layers = tcfg.n_layers
    counts, state, installed = _role_counter(torch, ops, kernels, members)
    routed, real_route = {"forward": [], "remat recompute": []}, moe_mod._route
    forced = {}  # router leaf's storage -> the forward's top_idx

    def recording(p, xf, top_k, backend=None):
        out = real_route(p, xf, top_k, backend)
        routed[state["phase"]].append(out[2].clone())
        if state["phase"] == "forward":
            forced[p["router"].data_ptr()] = out[2].clone()
        return out

    with installed(), _patched(moe_mod, "_route", recording):
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        state["phase"] = "forward"
        loss0 = api.loss_fn(tcfg, live, first, backend=policy)
        sync(torch, dev)
        state["phase"] = "remat recompute"
        g_k = torch.autograd.grad(loss0, list(leaves(live)))
        sync(torch, dev)
    if not torch.isfinite(loss0) or not all(torch.isfinite(x.float()).all() for x in g_k):
        raise AssertionError(f"{tag} first step: loss {loss0.item()} or a gradient not finite")
    del live
    if len(forced) != layers:
        raise AssertionError(f"{tag} routing recorded for {len(forced)} router leaves, want "
                             f"{layers}")

    # The same step on the plain backend (fp32 and fp64 sums), teacher-forced
    # on the kernels' routing: each layer's gates come from its own router
    # GEMM, its top-k indices are the forward's above (in the forward and in
    # the remat recompute). The kernels' gradients above are that same
    # function at their own routing (a gather of the gates at the sorted
    # indices is the sort's values, and their vjp is the same scatter).
    def replay(p, xf, top_k, backend=None):
        gates, _, _ = real_route(p, xf, top_k, backend)
        top_idx = forced[p["router"].data_ptr()]
        top_vals = torch.gather(gates, 1, top_idx)
        return gates, top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9), top_idx

    def loss_grads(backend):
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        loss = api.loss_fn(tcfg, live, first, backend=backend)
        return loss.detach().float(), torch.autograd.grad(loss, list(leaves(live)))

    with _patched(moe_mod, "_route", replay):
        loss_p, g_p = loss_grads(plain_policy)
        with _patched(plain, "fn", fp64), _patched(plain, "grouped_fn", fp64):
            loss_64, g_64 = loss_grads(plain_policy)
    losses = (loss0.detach().float(), loss_p, loss_64)
    leaf_gaps, worst_leaf = _gate_first_step(torch, params, losses, (g_k, g_p, g_64), tag)
    log(f"{tag} first step teacher-forced on the kernels' routing: loss kernels "
        f"{losses[0].item():.6f}, plain {loss_p.item():.6f}, plain fp64 sums "
        f"{loss_64.item():.6f}; {len(leaf_gaps)} gradient leaves within "
        f"{TRAIN_GRAD_FLOOR_FACTOR} x floor (worst {worst_leaf}: RMS "
        f"{leaf_gaps[worst_leaf][0]:.3g}, floor {leaf_gaps[worst_leaf][1]:.3g})")
    del g_k, g_p, g_64
    by_role = _check_role_counts(counts, tables, layers, tag)
    fwd, rec = routed["forward"], routed["remat recompute"]
    if len(fwd) != layers or len(rec) != layers:
        raise AssertionError(f"{tag} routing recorded {len(fwd)} forward, {len(rec)} recompute "
                             f"calls, want {layers} each")
    same = [torch.equal(x, y) for x, y in zip(fwd, reversed(rec))]
    if not all(same):
        raise AssertionError(f"{tag} the remat recompute's top_idx differs from the forward's "
                             f"in layers {[i for i, s_ in enumerate(same) if not s_]}")
    return {"losses": losses, "leaf_gaps": leaf_gaps, "worst_leaf": worst_leaf,
            "by_role": by_role}


def moe_train_phase(torch, np, cfg, ops, ep, k4mod, dev, *, layers=MOE_TRAIN_LAYERS,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS):
    """Phase 11: MoE training, K4 in the backward. (a) one MoE layer's
    expert GEMMs at their training shapes, teacher-forced on fixed routing
    (the dispatched expert inputs drawn directly), vjp on the kernels
    against the plain backend under the same-run floor, each backward GEMM
    timed; (b) the model cut to ``layers`` layers: one step counted by role
    and route with the remat recompute's routing checked against the
    forward's, then ``steps`` steps through ``repro_torch.train.train``;
    (c) the training CLI at its reduced config. Returns K4's training
    record and the K1 launches of (b)."""
    import dataclasses
    import os

    from repro_torch import obs
    from repro_torch.data import MarkovLMDataset, make_batch_fn
    from repro_torch.kernels.opope_gemm import full_fp32, opope_gemm
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainLoopConfig, make_train_step, train
    from repro_torch.tree import leaves
    k4 = k4mod.opope_gemm_grouped

    t_phase = time.perf_counter()
    fp64, plain = _fp64_plain(torch, ep), ops.backend("torch")
    bf16, f32 = torch.bfloat16, torch.float32
    moe = cfg.moe
    if not (moe.dispatch == "onehot" and not moe.dropless and moe.group_size <= seq):
        raise AssertionError(f"11 wants onehot dispatch with capacity, got {moe}")
    group = moe.group_size
    capacity = max(int(math.ceil(moe.capacity_factor * group * moe.top_k / moe.n_experts)), 1)
    m = batch * seq // group * capacity  # rows of each expert GEMM
    e, d, f = moe.n_experts, cfg.d_model, moe.d_ff_expert

    try:  # bf16 in, fp32 out in one library call, on builds that have it
        torch.bmm(torch.ones((1, 8, 8), dtype=bf16, device=dev),
                  torch.ones((1, 8, 8), dtype=bf16, device=dev), out_dtype=f32)
        bmm_out_dtype = True
    except (TypeError, RuntimeError, NotImplementedError) as exc:
        bmm_out_dtype = False
        log(f"11(a) torch.bmm(out_dtype=float32) unavailable ({type(exc).__name__}): the "
            f"recompute has no library lane")

    # (a) the 3 expert GEMMs as the layer runs them: w_up (bf16 out), w_gate
    # (silu, mul(up), bf16 out), w_down (fp32 out for the fp32 combine, so
    # its cotangent is fp32).
    gen = torch.Generator(device=dev).manual_seed(11)
    layer = [("w_up", d, f, (), bf16), ("w_gate", d, f, ("silu", "mul"), bf16),
             ("w_down", f, d, (), f32)]
    want_routes = {"w_up": {"sm90": 2, "tile": 0}, "w_gate": {"sm90": 1, "tile": 2},
                   "w_down": {"sm90": 0, "tile": 2}}
    rows, worst, gaps_all = [], 0.0, {}
    for name, k, n, steps_, out_dtype in layer:
        a = torch.randn((e, m, k), generator=gen, device=dev).to(bf16).requires_grad_()
        b = (torch.randn((e, k, n), generator=gen, device=dev) * k ** -0.5).to(bf16)
        b.requires_grad_()
        operands = [torch.randn((e, m, n), generator=gen, device=dev).to(bf16).requires_grad_()
                    for s_ in steps_ if ep.op_kind(s_) != "none"]
        it = iter(operands)
        spec = [s_ if ep.op_kind(s_) == "none" else (s_, next(it)) for s_ in steps_] or None
        g = torch.randn((e, m, n), generator=gen, device=dev).to(out_dtype)
        inputs = [a, b, *operands]

        def vjp(backend):
            out = ops.grouped_matmul(a, b, backend=backend, epilogue=spec, out_dtype=out_dtype)
            return torch.autograd.grad(out, inputs, g)

        k4.launches_by_route.update(sm90=0, tile=0)
        out = ops.grouped_matmul(a, b, backend="cuda", epilogue=spec, out_dtype=out_dtype)
        sync(torch, dev)
        check_routes(k4, 1, f"11(a) {name} forward", "K4")
        k4.launches_by_route.update(sm90=0, tile=0)
        got = torch.autograd.grad(out, inputs, g)
        sync(torch, dev)
        if k4.launches_by_route != want_routes[name]:
            raise AssertionError(f"11(a) {name} backward: K4 launches by route "
                                 f"{k4.launches_by_route} != {want_routes[name]}")
        ref = vjp("torch")
        with _patched(plain, "grouped_fn", fp64):
            ref64 = vjp("torch")
        gaps = {}
        for what, x, y, z in zip(["dA", "dB"] + [f"d_{s_}" for s_ in steps_
                                                  if ep.op_kind(s_) != "none"], got, ref, ref64):
            gaps[what] = _floor_gate(torch, x, y, z, f"11(a) {name} {what}")
            worst = max(worst, gaps[what][0] / max(gaps[what][1], 1e-30))
        gaps_all[name] = {w: {"rms": dk, "floor": df} for w, (dk, df) in gaps.items()}

        # The backward's grouped GEMMs as it runs them: the operand copies
        # (transposes, and casts to fp32 beside an fp32 cotangent), K4 on
        # its planned route, torch.bmm on the same operands.
        with torch.no_grad():
            a0, b0 = a.detach(), b.detach()
            g_acc = g
            gemms = []
            if steps_:
                acc = k4(a0, b0, out_dtype=f32)
                g_acc, _ = ep.epilogue_vjp(steps_, tuple(o.detach() for o in operands), acc, g)
                gemms.append(("fp32 recompute", a0, b0, f32))
            gemms += [("dA", g_acc, b0.transpose(1, 2), bf16),
                      ("dB", a0.transpose(1, 2), g_acc, bf16)]
            for role, x, y, o_dtype in gemms:
                dt = torch.promote_types(x.dtype, y.dtype)
                copy_ms = queued_ms(torch, lambda i: (x.to(dt).contiguous(),
                                                      y.to(dt).contiguous()), 5)
                xc, yc = x.to(dt).contiguous(), y.to(dt).contiguous()
                mm, kk, nn = xc.shape[1], xc.shape[2], yc.shape[2]
                plan = k4mod._plan(mm, nn, kk, dt, xc.data_ptr(), yc.data_ptr())
                iters = 5 if dt == f32 else 10
                ms = queued_ms(torch, lambda i: k4(xc, yc, out_dtype=o_dtype), iters)
                if dt == bf16 and o_dtype == f32:
                    lib = ((lambda i: torch.bmm(xc, yc, out_dtype=f32)) if bmm_out_dtype
                           else None)
                else:  # bf16 -> bf16, or fp32 in full fp32
                    lib = lambda i: torch.bmm(xc, yc)  # noqa: E731
                with full_fp32():
                    lib_ms = None if lib is None else queued_ms(torch, lib, iters)
                t_bytes = e * (mm * kk * x.element_size() + kk * nn * y.element_size()
                               + mm * nn * torch.empty((), dtype=o_dtype).element_size()
                               ) / HBM_BYTES_PER_S
                t_ops = 2 * e * mm * nn * kk / (FP32_FLOPS if dt == f32 else BF16_FLOPS)
                row = {"gemm": name, "role": role, "g": e, "m": mm, "k": kk, "n": nn,
                       "in_dtype": str(dt).removeprefix("torch."),
                       "out_dtype": str(o_dtype).removeprefix("torch."), "route": plan.route,
                       "ms": ms, "library_ms": lib_ms, "copy_ms": copy_ms,
                       "bound_ms": 1e3 * max(t_bytes, t_ops),
                       "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
                rows.append(row)
                log(f"11(a) {name} {role} {e}x[{mm}x{kk}]@[{kk}x{nn}] {row['in_dtype']} -> "
                    f"{row['out_dtype']}: K4 {plan.route} {ms:.4f} ms "
                    f"({2 * e * mm * nn * kk / ms / 1e9:.1f} TFLOP/s), torch.bmm "
                    f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} ms, operand copies "
                    f"{copy_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        log(f"11(a) {name} vjp: " + ", ".join(
            f"{w} RMS {dk:.3g} (floor {df:.3g})" for w, (dk, df) in gaps.items()))
        del a, b, operands, inputs, got, ref, ref64, out
    sums = {key: sum(r[key] or 0.0 for r in rows)
            for key in ("ms", "library_ms", "copy_ms", "bound_ms")}
    fp32_rows = [r for r in rows if r["in_dtype"] == "float32"]
    fp32_sums = {key: sum(r[key] for r in fp32_rows) for key in ("ms", "library_ms", "bound_ms")}
    log(f"11(a) one MoE layer's expert backward GEMMs at M={m} (G {e}): K4 {sums['ms']:.3f} ms "
        f"(fp32 tile route {fp32_sums['ms']:.3f} ms of it), torch.bmm {sums['library_ms']:.3f} "
        f"ms, operand copies {sums['copy_ms']:.3f} ms, bound {sums['bound_ms']:.3f} ms; worst "
        f"kernels/floor RMS ratio {worst:.3g} (gate {TRAIN_GRAD_FLOOR_FACTOR})")

    # (b) the model at full width, cut to `layers` layers, bf16, remat
    # "full", onehot dispatch.
    tcfg = dataclasses.replace(cfg, n_layers=layers)
    if not (tcfg.remat and tcfg.remat_policy == "full"):
        raise AssertionError(f"11(b) wants remat 'full', config has {tcfg.remat_policy}")
    params = api.init_params(tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in leaves(params))
    n_active = api.active_param_count(tcfg)
    batch_fn = make_batch_fn(MarkovLMDataset(tcfg.vocab, seq, batch, seed=0), dev)
    first = batch_fn(0)

    # One step by hand: every K1 and K4 launch by role and route, each
    # layer's routing in the forward and in its remat recompute, then the
    # loss and gradients against the plain backend on the same routing.
    first_step = _moe_first_step(
        torch, ops, ep, tcfg, params, first, {"K1": opope_gemm, "K4": k4},
        (("cuda", "fn", "K1"), ("cuda", "grouped_fn", "K4")),
        {"K1": K1_MOE_TRAIN, "K4": K4_MOE_TRAIN}, None, "torch", "11(b)")
    loss_k, loss_p, loss_64 = first_step["losses"]
    leaf_gaps, worst_leaf = first_step["leaf_gaps"], first_step["worst_leaf"]
    log(f"11(b) {tcfg.name} at {layers} layers ({n_params / 1e9:.3f} B params, "
        f"{n_active / 1e9:.3f} B active), first step {batch}x{seq}: loss {loss_k.item():.6f}; "
        f"launches by role {first_step['by_role']}; every layer's remat top_idx equal to its "
        f"forward's")

    # Then `steps` steps through train(), every K1 and K4 launch counted.
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    obs.clear_events()
    _reset_k1(ops, opope_gemm)
    k4.launches_by_route.update(sm90=0, tile=0)
    t0 = time.perf_counter()
    res = train(tcfg, opt, TrainLoopConfig(total_steps=steps, log_every=1), batch_fn,
                params=params, log=lambda msg: log(f"11(b) {msg}"))
    sync(torch, dev)
    train_s = time.perf_counter() - t0
    k1_routes, k4_routes = dict(opope_gemm.launches_by_route), dict(k4.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = obs.recent_events(steps, kind="train_step")
    losses = res.losses
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"11(b) losses {losses}")
    for kname, table, routes in (("K1", K1_MOE_TRAIN, k1_routes), ("K4", K4_MOE_TRAIN, k4_routes)):
        want = _want_routes(table, layers, steps)
        if routes != want:
            raise AssertionError(f"11(b) {kname} launches by route {routes} != {want}")
    walls = [ev["wall_s"] for ev in events]
    step_s = sum(walls[1:]) / max(1, len(walls) - 1)
    tokens = batch * seq
    log(f"11(b) {steps} steps in {train_s:.2f} s: losses {[round(x, 4) for x in losses]}; step "
        f"wall {step_s * 1e3:.1f} ms (steps 2..{steps}; the first {walls[0] * 1e3:.1f} ms), "
        f"{tokens / step_s:.1f} tokens/s; peak device memory {peak_gb:.2f} GB; launches K1 "
        f"{k1_routes}, K4 {k4_routes}")

    step_fn = make_train_step(tcfg, opt)
    opt_state = init_opt_state(params, opt)
    prof = None
    if dev.type == "cuda":
        prof = decode_profile(torch, lambda i: step_fn(params, opt_state, first), step_s * 1e3,
                              n_steps=1, tag="11(b)", what="train step")
    busy_ms = k4_ms = k1_ms = None
    if prof is not None:
        busy_ms = sum(ms for _, ms, _ in prof)
        k4_ms = sum(ms for key, ms, _ in prof if "opope_grouped" in key)
        k1_ms = sum(ms for key, ms, _ in prof if "opope_gemm" in key)
    del opt_state, step_fn, params

    # The same `steps` steps on the plain backend from the same initial
    # parameters: the loss curve that the kernels' is read against.
    gc.collect()
    torch.cuda.empty_cache()
    params = api.init_params(tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    obs.clear_events()
    t0 = time.perf_counter()
    res_p = train(tcfg, opt, TrainLoopConfig(total_steps=steps, log_every=steps), batch_fn,
                  params=params, policy="torch", log=lambda msg: None)
    sync(torch, dev)
    walls_p = [ev["wall_s"] for ev in obs.recent_events(steps, kind="train_step")]
    plain_step_ms = 1e3 * sum(walls_p[1:]) / max(1, len(walls_p) - 1)
    losses_p = res_p.losses
    if len(losses_p) != steps or not all(math.isfinite(x) for x in losses_p):
        raise AssertionError(f"11(b) plain-backend losses {losses_p}")
    log(f"11(b) the same {steps} steps on the plain backend in {time.perf_counter() - t0:.2f} s: "
        f"losses {[round(x, 4) for x in losses_p]}; step wall {plain_step_ms:.1f} ms "
        f"(steps 2..{steps})")
    del params, res_p

    # (c) the training CLI at its reduced config.
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_LOG="json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", cfg.name, "--reduced",
         "--steps", "40"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"11(c) train CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    done = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{") and '"event": "done"' in line]
    if len(done) != 1 or not all(math.isfinite(done[0][k_]) for k_ in ("loss_first", "loss_last")):
        raise AssertionError(f"11(c) train CLI: {done or proc.stdout[-2000:]}")
    cli_res = {"loss_first": done[0]["loss_first"], "loss_last": done[0]["loss_last"],
               "seconds": time.perf_counter() - t0}
    phase_s = time.perf_counter() - t_phase
    log(f"11(c) python -m repro_torch.launch.train --arch {cfg.name} --reduced --steps 40: "
        f"loss {cli_res['loss_first']:.4f} -> {cli_res['loss_last']:.4f} in "
        f"{cli_res['seconds']:.1f} s; phase 11 took {phase_s:.1f} s")
    return {
        "launches": sum(k4_routes.values()),
        "launches_by_route": k4_routes,
        "k1_launches_by_route": k1_routes,
        "launches_per_layer_step": {"K4": K4_MOE_TRAIN, "K1": K1_MOE_TRAIN},
        "backward_gemms": rows,
        "backward_layer": dict(sums, m=m, g=e, fp32_tile=fp32_sums),
        "gradient_gaps": gaps_all,
        "model": {"name": tcfg.name, "layers": layers, "params": n_params,
                  "active_params": n_active, "batch": batch, "seq": seq, "steps": steps,
                  "capacity": capacity, "peak_lr": TRAIN_LR, "losses": losses,
                  "plain_losses": losses_p, "plain_step_ms": plain_step_ms,
                  "first_step_loss": {"kernels": loss_k.item(), "plain": loss_p.item(),
                                      "plain_fp64": loss_64.item()},
                  "first_step_leaves": len(leaf_gaps),
                  "first_step_worst_leaf": {"path": worst_leaf, "rms": leaf_gaps[worst_leaf][0],
                                            "floor": leaf_gaps[worst_leaf][1]},
                  "step_ms": step_s * 1e3,
                  "first_step_ms": walls[0] * 1e3, "tokens_per_sec": tokens / step_s,
                  "device_busy_ms": busy_ms, "k4_device_ms": k4_ms, "k1_device_ms": k1_ms,
                  "peak_memory_gb": peak_gb, "remat_top_idx_equal": True},
        "cli": cli_res,
        "seconds": phase_s,
    }


def q8_train_phase(torch, cfg, mcfg, ops, ep, q8mod, k4mod, qz, q8b, dev, *,
                   layers=TRAIN_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                   moe_layers=Q8_MOE_TRAIN_LAYERS, moe_steps=Q8_MOE_TRAIN_STEPS):
    """Phase 12(a), (b): training under a q8 policy, the quantized roles'
    forward and remat recompute on K2 and K5, their backward on K1 and K4.
    (a) chatglm3-6b under ``mlp_q8_policy()``: one step counted by role and
    route, its loss and gradients against the plain q8 policy under phase
    10's floor gate, ``steps`` steps through ``train``, and K2's 3 MLP
    GEMMs at M = batch * seq timed; (b) deepseek-moe-16b under
    ``{"moe": "q8"}``: the same first step teacher-forced on the kernels'
    routing, ``moe_steps`` steps. Returns the record."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.data import MarkovLMDataset, make_batch_fn
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainLoopConfig, train
    from repro_torch.tree import leaves, map_leaves

    t_phase = time.perf_counter()
    fp64, plain = _fp64_plain(torch, ep), ops.backend("torch")
    bf16 = torch.bfloat16
    k2, k5 = q8mod.opope_gemm_q8, q8mod.opope_gemm_q8_grouped
    kernels = {"K1": opope_gemm, "K2": k2, "K4": k4mod.opope_gemm_grouped, "K5": k5}
    members = (("cuda", "fn", "K1"), ("cuda", "grouped_fn", "K4"),
               ("cuda_q8", "fn", "K2"), ("cuda_q8", "grouped_fn", "K5"))
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps)

    def run_steps(tcfg, params, batch_fn, policy, n_steps, tables, tag):
        """``n_steps`` steps through train(), each kernel's launches by
        route equal to its table's; returns the losses, step wall, peak
        memory and launches by route."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        obs.clear_events()
        before = {k: dict(kern.launches_by_route) for k, kern in kernels.items()}
        t0 = time.perf_counter()
        res = train(tcfg, dataclasses.replace(opt, total_steps=n_steps),
                    TrainLoopConfig(total_steps=n_steps, log_every=1), batch_fn, params=params,
                    policy=policy, log=lambda msg: log(f"{tag} {msg}"))
        sync(torch, dev)
        train_s = time.perf_counter() - t0
        routes = {k: {r: n - before[k][r] for r, n in kern.launches_by_route.items()}
                  for k, kern in kernels.items()}
        want = {k: (_want_routes(tables[k], tcfg.n_layers, n_steps) if k in tables
                    else {"sm90": 0, "tile": 0}) for k in kernels}
        if routes != want:
            raise AssertionError(f"{tag} launches by route {routes} != {want}")
        if len(res.losses) != n_steps or not all(math.isfinite(x) for x in res.losses):
            raise AssertionError(f"{tag} losses {res.losses}")
        walls = [e["wall_s"] for e in obs.recent_events(n_steps, kind="train_step")]
        step_s = sum(walls[1:]) / max(1, len(walls) - 1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"{tag} {n_steps} steps in {train_s:.2f} s: losses {[round(x, 4) for x in res.losses]}; "
            f"step wall {step_s * 1e3:.1f} ms (steps 2..{n_steps}; the first "
            f"{walls[0] * 1e3:.1f} ms), {batch * seq / step_s:.1f} tokens/s; peak device memory "
            f"{peak_gb:.2f} GB; launches by route {routes}")
        return {"losses": res.losses, "step_ms": step_s * 1e3, "first_step_ms": walls[0] * 1e3,
                "tokens_per_sec": batch * seq / step_s, "peak_memory_gb": peak_gb,
                "launches_by_route": routes}

    # (a) chatglm3-6b at full width cut to `layers` layers, bf16, remat
    # "full", under mlp_q8_policy(). One step by hand, every launch counted
    # by role and route; its loss and gradients against the plain q8 policy
    # (the MLP on torch_q8, the rest and every backward GEMM on the plain
    # backend, fp32 and fp64 sums).
    tcfg = dataclasses.replace(cfg, n_layers=layers)
    policy = qz.mlp_q8_policy()
    plain_policy = qz.PrecisionPolicy(rules={"mlp": "torch_q8"}, default="torch")
    params = api.init_params(tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in leaves(params))
    batch_fn = make_batch_fn(MarkovLMDataset(tcfg.vocab, seq, batch, seed=0), dev)
    first = batch_fn(0)
    counts, state, installed = _role_counter(torch, ops, kernels, members)

    def loss_grads(backend):
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        state["phase"] = "forward"
        loss = api.loss_fn(tcfg, live, first, backend=backend)
        state["phase"] = "remat recompute"
        grads = torch.autograd.grad(loss, list(leaves(live)))
        return loss.detach().float(), grads

    with installed():
        loss_k, g_k = loss_grads(policy)
        sync(torch, dev)
    loss_p, g_p = loss_grads(plain_policy)
    with _patched(plain, "fn", fp64):
        loss_64, g_64 = loss_grads(plain_policy)
    leaf_gaps, worst = _gate_first_step(torch, params, (loss_k, loss_p, loss_64),
                                        (g_k, g_p, g_64), "12(a)")
    by_role = _check_role_counts(counts, {"K1": K1_Q8_TRAIN, "K2": K2_Q8_TRAIN}, layers, "12(a)")
    del g_k, g_p, g_64
    log(f"12(a) {tcfg.name} at {layers} layers ({n_params / 1e9:.3f} B params) under "
        f"mlp_q8_policy(), first step {batch}x{seq}: loss kernels {loss_k.item():.6f}, plain "
        f"q8 {loss_p.item():.6f}, plain q8 fp64 sums {loss_64.item():.6f}; {len(leaf_gaps)} "
        f"gradient leaves within {TRAIN_GRAD_FLOOR_FACTOR} x floor (worst {worst}: RMS "
        f"{leaf_gaps[worst][0]:.3g}, floor {leaf_gaps[worst][1]:.3g}); launches by role {by_role}")
    dense = run_steps(tcfg, params, batch_fn, policy, steps,
                      {"K1": K1_Q8_TRAIN, "K2": K2_Q8_TRAIN}, "12(a)")
    dense.update(layers=layers, params=n_params, batch=batch, seq=seq, steps=steps,
                 first_step_loss={"kernels": loss_k.item(), "plain": loss_p.item(),
                                  "plain_fp64": loss_64.item()},
                 first_step_leaves=len(leaf_gaps),
                 first_step_worst_leaf={"path": worst, "rms": leaf_gaps[worst][0],
                                        "floor": leaf_gaps[worst][1]},
                 launches_per_layer_step={"K1": K1_Q8_TRAIN, "K2": K2_Q8_TRAIN})
    del params, first

    # K2's 3 MLP GEMMs at the step's M, as the forward runs them (int8
    # operands quantized as the q8 backend does; the gate's silu, mul and
    # the down projection's residual at the writeback): device time beside
    # torch._int_mm + dequant (no epilogue) and the bound; the plain
    # version by CUDA events.
    m, d, dff = batch * seq, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(12)
    k2_rows = []
    for name, kk, n, chain in (("w_up", d, dff, "none"), ("w_gate", d, dff, "silu+mul"),
                               ("w_down", dff, d, "residual")):
        a = torch.randn((m, kk), generator=gen, device=dev).to(bf16)
        w = (torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5).to(bf16)
        aq, bq = q8b.quantize_operands(a, w)
        steps_ = Q8_CHAINS[chain]
        ops_ = ((torch.randn((m, n), generator=gen, device=dev).to(bf16),) if steps_ else ())

        def run(fn, i=0):
            return fn(aq.q, aq.scale, bq.q, bq.scale, out_dtype=bf16, epilogue=steps_,
                      epilogue_operands=ops_)

        plan = q8mod._plan(m, n, kk, aq.q.data_ptr(), bq.q.data_ptr())
        if plan.route != "sm90":
            raise AssertionError(f"12(a) K2 {name} at M={m}: planned on {plan.route}")
        err = q8_check(torch, run(k2), run(q8mod.opope_gemm_q8_plain), "silu" in steps_,
                       f"12(a) K2 {name} M={m}")
        ms = queued_ms(torch, lambda i: run(k2), 10)
        plain_ms = time_ms(torch, lambda i: run(q8mod.opope_gemm_q8_plain), 1, iters=3)
        b_cm = bq.q.t().contiguous().t()
        lib_ms = queued_ms(torch, lambda i: torch._int_mm(aq.q, b_cm).float()
                           * (aq.scale * bq.scale), 10)
        bound_ms, bound_by = q8_bound(1, m, kk, n, 2, len(ops_))
        row = {"gemm": name, "m": m, "k": kk, "n": n, "epilogue": chain, "route": plan.route,
               "tile_rows": plan.bm, "splits": plan.splits, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": err, "tops": 2 * m * n * kk / ms / 1e9}
        k2_rows.append(row)
        log(f"12(a) K2 {name} [{m}x{kk}]@[{kk}x{n}] {chain}: sm90 {ms:.4f} ms device "
            f"({row['tops']:.1f} TOP/s; {plan.bm} rows, {plan.splits} splits), "
            f"torch._int_mm+dequant {lib_ms:.4f} ms device, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        del a, w, aq, bq, b_cm, ops_
    k2_layer = {key: sum(r[key] for r in k2_rows)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"12(a) K2's 3 MLP GEMMs at M={m}: {k2_layer['ms']:.4f} ms device, torch._int_mm+dequant "
        f"{k2_layer['library_ms']:.4f} ms, plain {k2_layer['plain_ms']:.4f} ms, bound "
        f"{k2_layer['bound_ms']:.4f} ms")

    # (b) deepseek-moe-16b at full width cut to `moe_layers` layers under
    # {"moe": "q8"}: the first step by role and route, teacher-forced
    # against the plain q8 policy; then `moe_steps` steps.
    gc.collect()
    torch.cuda.empty_cache()
    mt = dataclasses.replace(mcfg, n_layers=moe_layers)
    params = api.init_params(mt, torch.Generator(device=dev).manual_seed(0), dev)
    n_moe = sum(t.numel() for t in leaves(params))
    batch_fn = make_batch_fn(MarkovLMDataset(mt.vocab, seq, batch, seed=0), dev)
    tables = {"K1": K1_Q8_MOE_TRAIN, "K2": K2_Q8_MOE_TRAIN, "K4": K4_Q8_MOE_TRAIN,
              "K5": K5_Q8_MOE_TRAIN}
    moe_policy = qz.PrecisionPolicy(rules={"moe": "q8"})
    first_step = _moe_first_step(
        torch, ops, ep, mt, params, batch_fn(0), kernels, members, tables, moe_policy,
        qz.PrecisionPolicy(rules={"moe": "torch_q8"}, default="torch"), "12(b)")
    log(f"12(b) {mt.name} at {moe_layers} layers ({n_moe / 1e9:.3f} B params) under "
        f"{{'moe': 'q8'}}: launches by role {first_step['by_role']}; every layer's remat "
        f"top_idx equal to its forward's")
    moe = run_steps(mt, params, batch_fn, moe_policy, moe_steps, tables, "12(b)")
    losses, worst = first_step["losses"], first_step["worst_leaf"]
    moe.update(layers=moe_layers, params=n_moe, batch=batch, seq=seq, steps=moe_steps,
               first_step_loss={"kernels": losses[0].item(), "plain": losses[1].item(),
                                "plain_fp64": losses[2].item()},
               first_step_leaves=len(first_step["leaf_gaps"]),
               first_step_worst_leaf={"path": worst, "rms": first_step["leaf_gaps"][worst][0],
                                      "floor": first_step["leaf_gaps"][worst][1]},
               launches_per_layer_step=tables)
    del params
    phase_s = time.perf_counter() - t_phase
    log(f"12(a), (b) took {phase_s:.1f} s")
    return {"dense": dense, "moe": moe, "k2_mlp_gemms": k2_rows,
            "k2_mlp_layer": dict(k2_layer, m=m), "seconds": phase_s}


def checkpoint_phase(torch, cfg, dev, *, layers=CKPT_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     steps=CKPT_STEPS, every=CKPT_EVERY, fail_at=CKPT_FAIL_AT):
    """Phase 12(c)–(e): checkpoints at full width. (c) chatglm3-6b cut to
    ``layers`` layers, bf16: ``steps`` uninterrupted steps twice (their
    final parameters and moments compared), then a run that checkpoints
    every ``every`` steps and fails at ``fail_at``, resumed to the end: its
    final state against the uninterrupted run's, bitwise where the two
    uninterrupted runs agree bitwise, else within their gap; (d) the final
    checkpoint restored into the continuous engine, 4 greedy requests
    against an engine on the in-memory parameters, every K1 launch on
    sm90; (e) the training CLI at its reduced config, 40 steps then 60 on
    the same ``--ckpt-dir``. The checkpoints live under a temporary
    directory in ``build/``, removed at the end. Returns the record."""
    import dataclasses
    import importlib
    import os
    import shutil
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.data import MarkovLMDataset, make_batch_fn
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve import ContinuousEngine, poisson_trace
    from repro_torch.train import TrainLoopConfig, train
    from repro_torch.tree import leaves
    ckpt_mod = importlib.import_module("repro_torch.checkpoint.checkpoint")

    t_phase = time.perf_counter()
    tcfg = dataclasses.replace(cfg, n_layers=layers)
    n_params = api.param_count(tcfg)
    moment_bytes = {"float32": 4, "bfloat16": 2}[tcfg.moment_dtype]
    ckpt_bytes = n_params * (2 + 2 * moment_bytes) + 4
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ckpt_", dir=build))
    usage = shutil.disk_usage(tmp)
    log(f"12(c) {tcfg.name} at {layers} layers: {n_params / 1e9:.3f} B parameters, a checkpoint "
        f"{n_params * 2 / 1e9:.2f} GB of bf16 weights + {2 * n_params * moment_bytes / 1e9:.2f} GB "
        f"of {tcfg.moment_dtype} moments = {ckpt_bytes / 1e9:.2f} GB; {tmp}: "
        f"{usage.free / 1e9:.1f} GB free of {usage.total / 1e9:.1f} GB")
    if usage.free < 2.2 * ckpt_bytes:
        raise AssertionError(f"12(c) {usage.free / 1e9:.1f} GB free: two checkpoints need "
                             f"{2 * ckpt_bytes / 1e9:.1f} GB")
    io_s = {"host_copy": [], "write": [], "restore": []}

    def timed(key, fn):
        depth = [0]  # _to_host recurses through the module global: time the outer call

        def run(*args, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    io_s[key].append(time.perf_counter() - t0)
        return run

    batch_fn = make_batch_fn(MarkovLMDataset(tcfg.vocab, seq, batch, seed=0), dev)
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps)
    k1_before = dict(opope_gemm.launches_by_route)

    def run(**kw):
        params = api.init_params(tcfg, torch.Generator(device=dev).manual_seed(0), dev)
        return train(tcfg, opt, TrainLoopConfig(total_steps=steps, log_every=0, **kw), batch_fn,
                     params=params, log=lambda msg: log(f"12(c) {msg}"))

    def state(res):
        return list(leaves({"params": res.params, "opt": res.opt_state}))

    def gap(x_res, y_res):
        """RMS over every parameter and moment of two final states."""
        sq = sum((x.double() - y.double()).pow(2).sum().item()
                 for x, y in zip(state(x_res), state(y_res)))
        return math.sqrt(sq / sum(x.numel() for x in state(x_res)))

    try:
        t0 = time.perf_counter()
        whole = run()
        sync(torch, dev)
        whole_s = time.perf_counter() - t0
        again = run()
        repeat_bitwise = all(torch.equal(x, y) for x, y in zip(state(whole), state(again)))
        repeat_gap = 0.0 if repeat_bitwise else gap(whole, again)
        log(f"12(c) two uninterrupted {steps}-step runs ({whole_s:.2f} s each): final parameters "
            f"and moments " + ("bitwise equal" if repeat_bitwise else
                               f"differ: RMS gap {repeat_gap:.4g}"))
        del again
        gc.collect()
        torch.cuda.empty_cache()

        ckpt_dir = str(tmp / "run")
        with _patched(ckpt_mod, "_to_host", timed("host_copy", ckpt_mod._to_host)), \
                _patched(ckpt_mod, "_save_host", timed("write", ckpt_mod._save_host)), \
                _patched(ckpt, "restore", timed("restore", ckpt.restore)):
            try:
                run(ckpt_dir=ckpt_dir, ckpt_every=every, fail_at_step=fail_at)
                raise AssertionError(f"12(c) the run with a failure at step {fail_at} finished")
            except RuntimeError as exc:
                if f"injected failure at step {fail_at}" not in str(exc):
                    raise
            if ckpt.latest_step(ckpt_dir) != every:
                raise AssertionError(f"12(c) newest checkpoint {ckpt.latest_step(ckpt_dir)} "
                                     f"after the failure, want {every}")
            resumed = run(ckpt_dir=ckpt_dir, ckpt_every=every)
        sync(torch, dev)
        if resumed.resumed_from != every or len(resumed.losses) != steps - every:
            raise AssertionError(f"12(c) resumed from {resumed.resumed_from} with "
                                 f"{len(resumed.losses)} steps")
        resume_bitwise = all(torch.equal(x, y) for x, y in zip(state(whole), state(resumed)))
        resume_gap = 0.0 if resume_bitwise else gap(whole, resumed)
        if repeat_bitwise and not resume_bitwise:
            raise AssertionError(f"12(c) resumed final state differs from the uninterrupted "
                                 f"run's (RMS {resume_gap:.4g}) where two uninterrupted runs "
                                 f"agree bitwise")
        if not repeat_bitwise and not resume_gap <= repeat_gap:
            raise AssertionError(f"12(c) resumed vs uninterrupted RMS {resume_gap:.4g} > the "
                                 f"repeat gap {repeat_gap:.4g}")
        if resume_bitwise and resumed.losses != whole.losses[every:]:
            raise AssertionError(f"12(c) losses {resumed.losses} != {whole.losses[every:]}")
        n_saves = len(io_s["write"])
        log(f"12(c) failure at step {fail_at}, resumed from step {resumed.resumed_from}: final "
            f"parameters and moments " + ("bitwise equal to the uninterrupted run's" if
                                          resume_bitwise else
                                          f"within the repeat gap (RMS {resume_gap:.4g})")
            + f"; {n_saves} saves: host copy {[round(x, 3) for x in io_s['host_copy']]} s, "
            f"write {[round(x, 3) for x in io_s['write']]} s; restore "
            f"{[round(x, 3) for x in io_s['restore']]} s")
        del whole
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the final checkpoint into the continuous engine, beside an
        # engine on the in-memory parameters: the same greedy tokens, every
        # K1 launch on sm90.
        t0 = time.perf_counter()
        restored = ckpt.restore(ckpt_dir, steps, {"params": resumed.params}, dev)["params"]
        sync(torch, dev)
        params_restore_s = time.perf_counter() - t0
        trace = poisson_trace(4, seed=12, vocab=tcfg.vocab, prompt_lens=(16, 24, 32),
                              gen_lens=(8, 16), mean_interarrival=1.0)
        outputs, serve_launches = [], 0
        for p in (restored, resumed.params):
            before = dict(opope_gemm.launches_by_route)
            report = ContinuousEngine(cfg=tcfg, params=p, n_slots=4, max_len=64).serve(trace)
            sync(torch, dev)
            got = {r: opope_gemm.launches_by_route[r] - before[r] for r in before}
            want = 7 * layers * (report.decode_steps + report.prefill_batches)
            if got != {"sm90": want, "tile": 0}:
                raise AssertionError(f"12(d) K1 launches by route {got}, want {want} on sm90")
            _valid_outputs(report, trace, tcfg.vocab, "12(d)")
            outputs.append({r.rid: list(report.outputs[r.rid]) for r in trace})
            serve_launches += want
        if outputs[0] != outputs[1]:
            raise AssertionError(f"12(d) restored engine {outputs[0]} != in-memory {outputs[1]}")
        log(f"12(d) the step-{steps} checkpoint's parameters restored in {params_restore_s:.2f} s; "
            f"4 greedy requests on the restored and the in-memory parameters: the same "
            f"{sum(len(v) for v in outputs[0].values())} tokens; K1 {serve_launches} launches, "
            f"all sm90")
        k1_routes = {r: opope_gemm.launches_by_route[r] - k1_before[r] for r in k1_before}
        del restored, resumed

        # (e) the training CLI: 40 steps, then 60 on the same --ckpt-dir.
        cli_dir = str(tmp / "cli")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_LOG="json")
        cli = []
        for n_steps, want_resume in ((40, None), (60, 40)):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch", cfg.name,
                 "--reduced", "--steps", str(n_steps), "--ckpt-dir", cli_dir, "--ckpt-every",
                 "20"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"12(e) train CLI --steps {n_steps} exited "
                                     f"{proc.returncode}: {proc.stderr[-2000:]}")
            done = [json.loads(line) for line in proc.stdout.splitlines()
                    if line.startswith("{") and '"event": "done"' in line]
            # The first run is phase 10(c) as well: its loss must fall.
            if (len(done) != 1 or done[0]["resumed_from"] != want_resume
                    or ckpt.latest_step(cli_dir) != n_steps
                    or not math.isfinite(done[0]["loss_last"])
                    or (want_resume is None
                        and not done[0]["loss_last"] < done[0]["loss_first"])):
                raise AssertionError(f"12(e) train CLI --steps {n_steps}: "
                                     f"{done or proc.stdout[-2000:]}")
            # The walls of the steps the loop logged (every steps // 20): how
            # much of the process's time the steps take, beside its start-up.
            walls = [float(x) for x in re.findall(r"\[train\] step \d+ .*? (\d+)ms",
                                                  proc.stdout)]
            cli.append({"steps": n_steps, "resumed_from": done[0]["resumed_from"],
                        "loss_first": done[0]["loss_first"], "loss_last": done[0]["loss_last"],
                        "seconds": time.perf_counter() - t0,
                        "logged_step_ms_median": statistics.median(walls) if walls else None})
            log(f"12(e) python -m repro_torch.launch.train --arch {cfg.name} --reduced --steps "
                f"{n_steps} --ckpt-dir D --ckpt-every 20: resumed from "
                f"{done[0]['resumed_from']}, loss {done[0]['loss_first']:.4f} -> "
                f"{done[0]['loss_last']:.4f} in {cli[-1]['seconds']:.1f} s (logged steps: "
                f"median {cli[-1]['logged_step_ms_median']} ms)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"12(c)-(e) took {phase_s:.1f} s")
    return {"layers": layers, "params": n_params, "checkpoint_bytes": ckpt_bytes,
            "disk_free_bytes": usage.free, "steps": steps, "ckpt_every": every,
            "fail_at_step": fail_at, "repeat_bitwise": repeat_bitwise, "repeat_gap": repeat_gap,
            "resume_bitwise": resume_bitwise, "resume_gap": resume_gap,
            "save_host_copy_s": io_s["host_copy"], "save_write_s": io_s["write"],
            "restore_s": io_s["restore"], "params_restore_s": params_restore_s,
            "uninterrupted_s": whole_s, "k1_launches_by_route": k1_routes,
            "serve_tokens_equal": True, "cli": cli, "seconds": phase_s}


def _plan_str(p):
    return f"{p.bm}x{p.bn}x{p.bk} x{p.splits}" if p.route == "sm90" else "tile"


def tune_phase(torch, np, cfg, mcfg, params, ops, dev):
    """Phase 13 on chatglm3-6b's resident weights: (a) the tuner over every
    legal plan of K1, K2, K4 and K5 at the path shapes, (b) each winner
    against its plain version, (c) the table served in a decode step, then
    cleared, (d) the tuning CLI. Returns the record."""
    import os

    from repro_torch import obs
    from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain
    from repro_torch.kernels import opope_grouped as k4
    from repro_torch.models import api
    from repro_torch.obs import attr as obs_attr
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.quant import opope_q8 as q8
    from repro_torch.quant.backends import quantize_grouped_operands, quantize_operands
    from repro_torch.tune import GemmShape, TuningTable, search

    t_phase = time.perf_counter()
    out = {"cells": []}
    d, dff = cfg.d_model, cfg.d_ff
    dq, dkv = cfg.n_heads * cfg.head_dim_, cfg.n_kv * cfg.head_dim_
    k1_shapes = sorted({(d, dq), (d, dkv), (dq, d), (d, dff), (dff, d)})
    k2_shapes = sorted({(d, dff), (dff, d)})
    md, mff, g = mcfg.d_model, mcfg.moe.d_ff_expert, mcfg.moe.n_experts
    cells = [("cuda", GemmShape("dense", m, k, n, 0, "bfloat16"))
             for m in TUNE_DENSE_MS for k, n in k1_shapes]
    cells += [("cuda_q8", GemmShape("dense", m, k, n, 0, "bfloat16"))
              for m in TUNE_DENSE_MS for k, n in k2_shapes]
    cells += [(be, GemmShape("grouped", m, k, n, g, "bfloat16")) for be in ("cuda", "cuda_q8")
              for m in TUNE_GROUPED_MS for k, n in ((md, mff), (mff, md))]

    # (a) the search, into a throwaway table.
    table = TuningTable()
    t0 = time.perf_counter()
    for backend, shape in cells:
        entry, results = search.tune_shape(backend, shape, iters=TUNE_ITERS)
        table.put(entry)
        heur = next(r for r in results if r.is_heuristic)
        if entry.us > heur.us:
            raise AssertionError(f"13(a) {backend} {shape}: winner {entry.us} us > heuristic "
                                 f"{heur.us} us")
        kname = {("cuda", "dense"): "K1", ("cuda", "grouped"): "K4",
                 ("cuda_q8", "dense"): "K2", ("cuda_q8", "grouped"): "K5"}[(backend, shape.family)]
        row = {"kernel": kname, "backend": backend, "family": shape.family, "m": shape.m,
               "k": shape.k, "n": shape.n, "g": shape.g,
               "heuristic": {"block": list(heur.block), "splits": heur.splits, "us": heur.us},
               "winner": {"block": list(entry.block), "splits": entry.splits, "us": entry.us},
               "candidates": len(results), "fuse_epilogue": entry.fuse_epilogue,
               "times_us": {f"{r.block[0]}x{r.splits}": r.us for r in results}}
        out["cells"].append(row)
        log(f"13(a) {kname} {shape.family} g={shape.g} M={shape.m} K={shape.k} N={shape.n}: "
            f"heuristic {heur.block[0]} rows x{heur.splits} {heur.us:.2f} us, winner "
            f"{entry.block[0]} rows x{entry.splits} {entry.us:.2f} us "
            f"({heur.us / entry.us:.3f}x), {len(results)} plans timed, fuse_epilogue="
            f"{entry.fuse_epilogue}; " + ", ".join(
                f"{r.block[0]}x{r.splits} {r.us:.2f}" for r in results))
    out["search_s"] = time.perf_counter() - t0
    path = ROOT / "build" / "tune_phase13.json"
    table.save(str(path))
    changed = [r for r in out["cells"] if (r["winner"]["block"], r["winner"]["splits"])
               != (r["heuristic"]["block"], r["heuristic"]["splits"])]
    log(f"13(a) {len(cells)} cells, {sum(r['candidates'] for r in out['cells'])} plans timed in "
        f"{out['search_s']:.1f} s; the winner differs from the heuristic in {len(changed)}; "
        f"table {path}")

    # (b) every winner against its plain version, with and without the
    # probe's chain (bias + silu, fp32 out).
    gen = torch.Generator(device=dev).manual_seed(13)
    max_err = {}
    for backend, shape in cells:
        e = table.lookup_entry(backend=backend, shape_family=shape.family, m=shape.m, k=shape.k,
                               n=shape.n, g=shape.g, itemsize=1 if backend == "cuda_q8" else 2)
        grouped = shape.family == "grouped"
        lead = (shape.g,) if grouped else ()
        a = torch.randn(lead + (shape.m, shape.k), generator=gen, device=dev).to(torch.bfloat16)
        b = (torch.randn(lead + (shape.k, shape.n), generator=gen, device=dev)
             * shape.k ** -0.5).to(torch.bfloat16)
        bias = torch.randn(lead + (1, shape.n), generator=gen, device=dev)
        if backend == "cuda":
            mod = k4 if grouped else importlib_k1()
            plan = mod.validate_plan(shape.m, shape.n, shape.k, e.block, e.splits)
            kern = k4.opope_gemm_grouped if grouped else opope_gemm
            plain = k4.opope_gemm_grouped_plain if grouped else opope_gemm_plain
            args = (a, b)
        else:
            plan = q8.validate_plan(shape.m, shape.n, shape.k, e.block, e.splits,
                                    grouped=grouped)
            aq, bq = (quantize_grouped_operands if grouped else quantize_operands)(a, b)
            args = (aq.q, aq.scale, bq.q, bq.scale)
            kern = q8.opope_gemm_q8_grouped if grouped else q8.opope_gemm_q8
            plain = q8.opope_gemm_q8_grouped_plain if grouped else q8.opope_gemm_q8_plain
        what = f"13(b) {backend} {shape.family} M={shape.m} K={shape.k} N={shape.n} {_plan_str(plan)}"
        for steps, ops_, out_dtype in (((), (), torch.bfloat16),
                                       (search.PROBE_EPILOGUE, (bias,), torch.float32)):
            got = kern(*args, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_,
                       plan=plan)
            sync(torch, dev)
            if backend == "cuda":
                err = check_close(torch, got, lambda dt: plain(
                    *args, out_dtype=dt, epilogue=steps, epilogue_operands=ops_), out_dtype,
                    f"{what} {steps}")
            else:
                err = q8_check(torch, got, plain(*args, out_dtype=out_dtype, epilogue=steps,
                                                 epilogue_operands=ops_),
                               bool(steps), f"{what} {steps}")
            key = {"cuda": "K4" if grouped else "K1",
                   "cuda_q8": "K5" if grouped else "K2"}[backend]
            max_err[key] = max(max_err.get(key, 0.0), err)
    out["winners_max_abs_err"] = max_err
    log(f"13(b) every winner against its plain version, with and without bias+silu: max abs "
        f"err {max_err}")

    # (c) the table served: a 4-row decode step on it, against the heuristic.
    rng = np.random.default_rng(13)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(dev)
    n_forced = 7

    # Positions: 64 prompt tokens, 7 forced steps (64-70), the step timings
    # 72-94, the captured step 95; the caches hold 128.
    def forced(tokens):
        with torch.inference_mode():
            logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 128)
            outs = [logits.float()]
            for i in range(n_forced):
                logits, caches = api.decode(cfg, params, tokens[i], caches, 64 + i)
                outs.append(logits.float())
        return torch.stack(outs), caches

    def greedy():
        with torch.inference_mode():
            logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 128)
            toks = []
            for i in range(n_forced):
                toks.append(logits.argmax(-1)[:, None])
                logits, caches = api.decode(cfg, params, toks[-1], caches, 64 + i)
        return toks

    def step_times(caches, tok):
        with torch.inference_mode():
            for i in range(3):
                api.decode(cfg, params, tok, caches, 72 + i)
            sync(torch, dev)
            t0 = time.perf_counter()
            for i in range(16):
                api.decode(cfg, params, tok, caches, 75 + i)
            sync(torch, dev)
            wall = (time.perf_counter() - t0) * 1e3 / 16
            prof = decode_profile(torch, lambda i: api.decode(cfg, params, tok, caches, 91 + i),
                                  wall, tag="13(c)")
        return {"wall_ms": wall, "busy_ms": None if prof is None else sum(ms for _, ms, _ in prof)}

    def loop_us(fn, n=20000):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t0) / n

    def host_cost(x, w):
        """Host microseconds of ``ops.matmul(x, w)`` on the ``cuda`` member
        ("planned") against the same call with K1 as the member ("direct":
        its own _plan, no resolver), 200 calls a turn, 7 interleaved turns,
        medians (one call's host time spreads by ~10 us here), telemetry off
        and on; and the member's own part alone ("member alone": a tight
        loop over the member wrapping a kernel that returns at once)."""
        def call_us(n=200):
            ops.matmul(x, w)
            sync(torch, dev)
            t0 = time.perf_counter()
            for _ in range(n):
                ops.matmul(x, w)
            host = time.perf_counter() - t0
            sync(torch, dev)
            return 1e6 * host / n

        res = {}
        member = ops._planned("cuda", lambda a, b, c=None, **kw: None, False, False)
        for flag in (False, True):
            tag = "on" if flag else "off"
            prev = obs_metrics.set_enabled(flag)
            try:
                per_call = {f"planned {tag}": [], f"direct {tag}": []}
                for _ in range(7):
                    per_call[f"planned {tag}"].append(call_us())
                    with _patched(ops.backend("cuda"), "fn", opope_gemm):
                        per_call[f"direct {tag}"].append(call_us())
                res.update({k: statistics.median(v) for k, v in per_call.items()})
                res[f"member alone {tag}"] = min(loop_us(lambda: member(x, w)) for _ in range(3))
            finally:
                obs_metrics.set_enabled(prev)
        return {k: res[k] for k in sorted(res)}

    toks = greedy()
    ref, caches = forced(toks)
    out["heuristic_step"] = step_times(caches, toks[0])
    with _patched(ops.backend("cuda"), "fn", opope_gemm_plain):
        ref_plain, _ = forced(toks)
    os.environ["REPRO_TUNE_TABLE"] = str(path)
    ops.clear_tile_cache()
    try:
        prev = obs_metrics.set_enabled(True)
        obs.reset()
        _reset_k1(ops, opope_gemm)
        with torch.inference_mode(), obs_attr.capture_gemms() as recs:
            api.decode(cfg, params, toks[0], caches, 95)
        sync(torch, dev)
        obs_metrics.set_enabled(prev)
        k1_recs = [r for r in recs if r.backend == "cuda"]
        sources = sorted({r.tile_source for r in k1_recs})
        labels = obs.snapshot()["counters"]["gemm.calls"]
        if sources != ["tuned"] or len(k1_recs) != 7 * cfg.n_layers:
            raise AssertionError(f"13(c) decode step K1 tile sources {sources}, "
                                 f"{len(k1_recs)} calls")
        if any("tile=tuned" not in key for key in labels):
            raise AssertionError(f"13(c) gemm.calls labels {labels}")
        check_routes(opope_gemm, 7 * cfg.n_layers, "13(c) tuned decode step")
        _reset_k1(ops, opope_gemm)
        got, caches_t = forced(toks)
        # The 4 x 64-row prefill (M 256, heuristic plans) and the decode steps.
        check_routes(opope_gemm, 7 * cfg.n_layers * (n_forced + 1), "13(c) tuned forced decode")
        out["tuned_launches"] = opope_gemm.launches
        out["tuned_step"] = step_times(caches_t, toks[0])
        # Host time of a direct K1 call at wq's shape, the table active (see
        # host_cost), and the two pieces the table path adds, each alone.
        x = torch.randn(4, d, device=dev, dtype=torch.bfloat16)
        w = params["blocks"][0]["attn"]["wq"]["w"]
        out["host_us"] = {"table": host_cost(x, w)}
        k1 = importlib_k1()
        plan = ops._tile_for(4, d, dq, 2, "dense", 0, "cuda")
        prev = obs_metrics.set_enabled(False)
        pieces = {
            "memo hit (telemetry off)": min(loop_us(lambda: ops._tile_for(
                4, d, dq, 2, "dense", 0, "cuda")) for _ in range(3)),
            "kernel plan check": min(loop_us(lambda: k1._forced(plan, 4, dq, d, x, w))
                                     for _ in range(3)),
            "kernel _plan (no table)": min(loop_us(lambda: k1._plan(
                4, dq, d, x.dtype, x.data_ptr(), w.data_ptr())) for _ in range(3))}
        obs_metrics.set_enabled(True)
        pieces["memo hit (telemetry on)"] = min(loop_us(lambda: ops._tile_for(
            4, d, dq, 2, "dense", 0, "cuda")) for _ in range(3))
        obs_metrics.set_enabled(prev)
        out["host_us"]["pieces"] = pieces
        obs.reset()
    finally:
        del os.environ["REPRO_TUNE_TABLE"]
        ops.clear_tile_cache()
    d_floor = (ref_plain - ref).pow(2).mean().sqrt().item()
    d_tuned = (got - ref).pow(2).mean().sqrt().item()
    arg = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"13(c) table active: the decode step's {len(k1_recs)} K1 calls all 'tuned', "
        f"gemm.calls {labels}, all on sm90; teacher-forced logits (first token + {n_forced} "
        f"decode steps) tuned vs heuristic RMS {d_tuned:.4g} (gated <= "
        f"{PROMPT_LOGIT_FLOOR_FACTOR} x {d_floor:.4g}, the plain GEMM vs the kernels), argmax "
        f"agreement {arg:.4f}")
    if not d_tuned <= PROMPT_LOGIT_FLOOR_FACTOR * d_floor:
        raise AssertionError(f"13(c) tuned vs heuristic logits RMS {d_tuned} > "
                             f"{PROMPT_LOGIT_FLOOR_FACTOR} x {d_floor}")
    out["logits"] = {"rms_tuned_vs_heuristic": d_tuned, "rms_plain_vs_heuristic": d_floor,
                     "argmax_agreement": arg}
    hs, ts = out["heuristic_step"], out["tuned_step"]
    log(f"13(c) 4-row decode step: heuristic {hs['wall_ms']:.3f} ms wall, busy {hs['busy_ms']} ms; "
        f"tuned {ts['wall_ms']:.3f} ms wall, busy {ts['busy_ms']} ms (no gain claimed)")
    # Cleared: the heuristic again, through no resolver at all.
    prev = obs_metrics.set_enabled(True)
    obs.reset()
    ops.matmul(x, w)
    obs_metrics.set_enabled(prev)
    labels = obs.snapshot()["counters"]["gemm.calls"]
    if ops.tile_source("cuda", 4, d, dq) != "heuristic" or \
            list(labels) != ["backend=cuda,family=fp,fusion=default,shape=dense,tile=heuristic"]:
        raise AssertionError(f"13(c) after clearing: {ops.tile_source('cuda', 4, d, dq)}, {labels}")
    obs.reset()
    ops.reset_tile_cache_stats()
    out["host_us"]["no table"] = host_cost(x, w)
    if sum(ops.tile_cache_stats()[k] for k in ("hits", "misses")):
        raise AssertionError(f"13(c) no table: the member resolved plans {ops.tile_cache_stats()}")
    obs.reset()
    for state in ("table", "no table"):
        log(f"13(c) host time a direct K1 call (4x{d} @ {d}x{dq}), {state}: " + ", ".join(
            f"{k} {v:.2f} us" for k, v in out["host_us"][state].items()))
    log("13(c) host time, the table path's pieces alone: " + ", ".join(
        f"{k} {v:.3f} us" for k, v in out["host_us"]["pieces"].items()))

    # (d) the CLI on two explicit shapes, its table reloaded.
    cli_path = ROOT / "build" / "tune_cli.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "--shapes", f"4x{d}x{dq}",
         f"4x{dff}x{d}", "--backends", "cuda", "--table", str(cli_path), "--fresh",
         "--iters", str(TUNE_ITERS)],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"13(d) tune CLI rc {res.returncode}: {res.stderr[-2000:]}")
    cli_table = TuningTable.load(str(cli_path))
    kinds = {e.key.device_kind for e in cli_table.entries}
    if len(cli_table) != 2 or kinds != {torch.cuda.get_device_name(0).strip().lower()
                                        .replace(" ", "-")}:
        raise AssertionError(f"13(d) CLI table: {len(cli_table)} entries, kinds {kinds}")
    for e in cli_table.entries:
        importlib_k1().validate_plan(e.key.m, e.key.n, e.key.k, e.block, e.splits)
    out["cli"] = {"seconds": cli_s, "entries": [e.to_json() for e in cli_table.entries]}
    log(f"13(d) tune CLI on 2 shapes in {cli_s:.1f} s: " + "; ".join(
        line.strip() for line in res.stdout.splitlines() if "best" in line))
    for p_ in (path, cli_path):
        p_.unlink()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 took {out['seconds']:.1f} s")
    return out


def importlib_k1():
    """The K1 module (the package exports the function under its name)."""
    import importlib

    return importlib.import_module("repro_torch.kernels.opope_gemm")


def importlib_k4():
    """The K4 module."""
    import importlib

    return importlib.import_module("repro_torch.kernels.opope_grouped")


def _grouped_bound(g, m, k, n, out_elem, n_full):
    """Least time in ms of one bf16 grouped GEMM: A, B, the output and the
    epilogue's bf16 full operands moved once each, or 2GMNK at the bf16
    tensor-core rate."""
    t_bytes = 2 * g * (m * k + k * n + m * n * n_full) + out_elem * g * m * n
    t_bytes, t_ops = t_bytes / HBM_BYTES_PER_S, 2 * g * m * n * k / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _family_params(torch, api, cfg, dev, tag):
    """A family's weights drawn from seed 0 on the card, after freeing the
    last family's and resetting the peak memory; their count held to
    ``api.param_count``. Returns (params, its record)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sync(torch, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != api.param_count(cfg):
        raise AssertionError(f"{tag}: {n_params} parameters drawn, {api.param_count(cfg)} counted")
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"{tag} init {cfg.name} at {cfg.n_layers} layers: {n_params / 1e9:.4f} B params "
        f"({weights_gb:.3f} GB) in {time.perf_counter() - t0:.1f} s")
    return params, {"name": cfg.name, "layers": cfg.n_layers, "params": n_params,
                    "weights_gb": weights_gb}


# The kernels a decode step's device time is booked to: (a substring of the
# kernel's name, the number of dims of the weights it reads).
STEP_KERNELS = {"k1": ("opope_gemm_kernel", 2), "k4": ("opope_grouped_kernel", 3)}


def _decode_step_times(torch, dev, step, caches, pos, weights, tag, *, kernels=("k1",),
                       required=("k1",)):
    """(iii) of phases 14 and 15: a lockstep decode step, ``step(caches,
    pos) -> caches``, from position ``pos``: 3 warm-up steps, 8 timed, 4
    profiled (each of these writing one position). Each of ``kernels``'
    byte bound is every leaf of ``weights`` of its dims
    (:data:`STEP_KERNELS`) read once. Returns (wall ms a step, device ms
    by kernel with ``busy`` and the ``<kernel>_byte_bound``s, or None where
    the trace holds no device time; the bounds); raises when a kernel of
    ``required`` books no device time."""
    with torch.inference_mode():
        for i in range(3):
            caches = step(caches, pos + i)
        sync(torch, dev)
        n_steps = 8
        t0 = time.perf_counter()
        for i in range(n_steps):
            caches = step(caches, pos + 3 + i)
        sync(torch, dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        prof = None
        if dev.type == "cuda":
            prof = decode_profile(torch, lambda i: step(caches, pos + 11 + i), step_ms,
                                  tag=f"{tag} (iii)")
    del caches
    bound_ms = {name: sum(1e3 * t.numel() * t.element_size() / HBM_BYTES_PER_S
                          for t in _leaves(weights) if t.ndim == STEP_KERNELS[name][1])
                for name in kernels}
    if prof is None:
        return step_ms, None, bound_ms
    dev_ms = {name: sum(ms for key, ms, _ in prof if STEP_KERNELS[name][0] in key)
              for name in kernels}
    dev_ms["busy"] = sum(ms for _, ms, _ in prof)
    dev_ms.update({f"{k}_byte_bound": v for k, v in bound_ms.items()})
    if not all(dev_ms[name] for name in required):
        raise AssertionError(f"{tag} (iii) the profiled step books no device time to a "
                             f"kernel it launches: {dev_ms}")
    return step_ms, dev_ms, bound_ms


def _prefill_floor_gate(torch, rng, cfg, params, ops, ep, dev, tag, rec):
    """(i) of phases 14 and 16: the all-layer prefill logits of 2 x 64
    tokens drawn from ``rng`` through the kernels against the plain backend
    within PREFILL_LOGIT_FLOOR_FACTOR x the RMS gap of the plain backend's
    fp32 and fp64 sums in this run; an MoE model replays the kernels'
    routing on the plain backend, and its routing agreement is held as
    6(a)'s: the plain router on the kernel run's inputs, and the
    free-running share pooled over FREE_ROUTING_BATCHES prefills
    (:func:`free_routing_shares`). Writes ``rec["prefill"]`` (with the
    kernels' K1 and K4 launches by route) and ``rec["routing_agreement"]``."""
    import numpy as np

    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod

    moe, kern4 = cfg.moe, importlib_k4().opope_gemm_grouped
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(dev)
    fp64, plain = _fp64_plain(torch, ep), ops.backend("torch")
    routed, real_route = [], moe_mod._route

    def recording(p, xf, top_k, backend=None):
        out = real_route(p, xf, top_k, backend)
        routed.append((p, xf, out))
        return out

    _reset_k1(ops, opope_gemm)
    kern4.launches_by_route.update(sm90=0, tile=0)
    with torch.inference_mode():
        with _patched(moe_mod, "_route", recording):
            got, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend="cuda")
        sync(torch, dev)
        routes = {"K1": dict(opope_gemm.launches_by_route), "K4": dict(kern4.launches_by_route)}
        replays = [iter([o for _, _, o in routed]) for _ in range(2)]
        with _patched(moe_mod, "_route", lambda *a, **k: next(replays[0])):
            ref, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend="torch")
        with _patched(moe_mod, "_route", lambda *a, **k: next(replays[1])), \
                _patched(plain, "fn", fp64), _patched(plain, "grouped_fn", fp64):
            ref64, _ = api.prefill(cfg, params, {"tokens": tokens}, 64, backend="torch")
    for side, x in (("the plain backend's", ref), ("the plain backend's fp64-sum", ref64),
                    ("the kernels'", got)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{tag} (i) {side} prefill logits not finite "
                                 f"({cfg.param_dtype} parameters)")
    if tuple(got.shape) != (2, cfg.vocab):
        raise AssertionError(f"{tag} (i) prefill logits shape {tuple(got.shape)}")
    delta, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    d_k, d_f = _rms(got - ref), _rms(ref - ref64)
    rec["prefill"] = {"max_abs_dlogits": delta, "max_abs_logits": scale,
                      "rms_kernels_vs_plain": d_k, "rms_plain_fp32_vs_fp64": d_f,
                      "argmax_agreement": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                      "launches_by_route": routes}
    log(f"{tag} (i) prefill 2x64" + (" (the kernels' routing replayed on the plain backend)"
                                     if moe else "")
        + f": RMS kernels vs plain {d_k:.4g} (gated <= {PREFILL_LOGIT_FLOOR_FACTOR} x {d_f:.4g}, "
        f"the plain backend's fp32 vs fp64 sums); max|dlogits| {delta:.4g} of max|logits| "
        f"{scale:.4g}; argmax agreement {rec['prefill']['argmax_agreement']:.2f}")
    if not d_k <= PREFILL_LOGIT_FLOOR_FACTOR * d_f:
        raise AssertionError(f"{tag} (i) prefill logits: kernels vs plain RMS {d_k} > "
                             f"{PREFILL_LOGIT_FLOOR_FACTOR} x floor {d_f}")
    if moe is not None:
        # 6(a): the plain router on the kernel run's layer inputs, and
        # free-running prefills against the floor of two plain sum orders.
        with torch.inference_mode():
            idx_k = torch.stack([o[2] for _, _, o in routed])
            idx_same = torch.stack([real_route(p, xf, moe.top_k, "torch")[2]
                                    for p, xf, _ in routed])
        same = _agreement(idx_k, idx_same).mean().item()
        del routed
        shares = [free_routing_shares(torch, api, moe_mod, ops, cfg, params, tokens,
                                      {"fp64": fp64}, kernels_idx=idx_k)[0]]
        for seed in range(1, FREE_ROUTING_BATCHES):
            more = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 64))
            shares.append(free_routing_shares(torch, api, moe_mod, ops, cfg, params,
                                              torch.from_numpy(more).to(dev), {"fp64": fp64})[0])
        free = sum(x["kernels"] for x in shares) / len(shares)
        free_64 = sum(x["fp64"] for x in shares) / len(shares)
        free_min = max(free_64 - FREE_ROUTING_MARGIN, FREE_ROUTING_FLOOR)
        rec["routing_agreement"] = {"same_input": same, "free_running": free,
                                    "free_running_plain_fp32_vs_fp64": free_64,
                                    "free_running_by_prefill": shares}
        log(f"{tag} (i) routing, {idx_k.numel()} assignments: the plain router on the kernel "
            f"run's inputs agrees on {same:.5f} (gated >= 0.99); free-running over "
            f"{len(shares)} prefills of 2 x 64 ({len(shares) * idx_k.numel()} assignments): "
            f"kernels vs plain {free:.5f} (gated >= {free_min:.5f} = max(fp64 floor - "
            f"{FREE_ROUTING_MARGIN}, {FREE_ROUTING_FLOOR})), plain fp32 vs fp64 sums "
            f"{free_64:.5f}; by prefill "
            + " ".join(f"{x['kernels']:.4f}/{x['fp64']:.4f}" for x in shares))
        if same < 0.99 or free < free_min:
            raise AssertionError(f"{tag} (i) routing agreement {rec['routing_agreement']}")
    else:
        del routed
    del got, ref, ref64


def free_routing_shares(torch, api, moe_mod, ops, cfg, params, tokens, orders,
                        kernels_idx=None):
    """Free-running prefills of ``tokens`` on the kernels, on the plain
    backend, and on the plain backend under each of ``orders`` (name -> a
    function in place of the plain versions', as :func:`_fp64_plain`):
    ``({"kernels" or the order's name: the share of top-k assignments that
    run makes alike with the plain backend's}, assignments)``.
    ``kernels_idx``: the kernels' top-k indices, where a recorded run
    already has them."""
    plain = ops.backend("torch")
    idx = {}
    with torch.inference_mode():
        if kernels_idx is None:
            _, rec = _routed_prefill(api, moe_mod, cfg, params, tokens, "cuda")
            kernels_idx = torch.stack([r[2] for r in rec])
            del rec
        for run, fn in {"plain": None, **orders}.items():
            with _patched(plain, "fn", fn or plain.fn), \
                    _patched(plain, "grouped_fn", fn or plain.grouped_fn):
                _, rec = _routed_prefill(api, moe_mod, cfg, params, tokens, "torch")
            idx[run] = torch.stack([r[2] for r in rec])
            del rec
    idx["kernels"] = kernels_idx
    return ({k: _agreement(idx[k], idx["plain"]).mean().item() for k in ("kernels", *orders)},
            kernels_idx.numel())


def family_phase(torch, np, cfg, ops, ep, k4, dev, tag, decode_step=True):
    """Phase 14, what every family runs, on its full-width weights drawn from
    seed 0: (i) the all-layer prefill logits through the kernels against the
    plain backend within PREFILL_LOGIT_FLOOR_FACTOR x the RMS gap of the
    plain backend's fp32 and fp64 sums in this run (an MoE model with the
    kernels' routing replayed on the plain backend, beside 6(a)'s routing
    agreement), (ii)
    the continuous engine on 4(b)'s Poisson trace, every K1 and K4 launch
    counted and on sm90, (iii) a profiled 4-row decode step (unless
    ``decode_step`` is False), and the peak device memory of (i)-(iii).
    Returns the record and the weights."""
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.serve import ContinuousEngine, poisson_trace

    moe, n_layers = cfg.moe, cfg.n_layers
    n_k1 = (7 if moe is None else 5 + 3 * bool(moe.n_shared)) * n_layers
    n_k4 = 0 if moe is None else 3 * n_layers
    kern4 = k4.opope_gemm_grouped
    params, rec = _family_params(torch, api, cfg, dev, tag)

    # (i) prefill logits, kernels against the plain backend, and the plain
    # backend's fp32 against its fp64 sums: the floor of the gate.
    rng = np.random.default_rng(0)
    plain = ops.backend("torch")
    _prefill_floor_gate(torch, rng, cfg, params, ops, ep, dev, tag, rec)

    # (ii) the continuous engine on 4(b)'s Poisson trace.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        eng = ContinuousEngine(cfg=cfg, params=params, n_slots=4, max_len=256)
    for w in caught:
        log(f"{tag} (ii) warning: {w.message}")
    eng.serve(poisson_trace(2, seed=1, vocab=cfg.vocab, prompt_lens=(32,), gen_lens=(4,)))
    trace = poisson_trace(8, seed=0, vocab=cfg.vocab, prompt_lens=(32, 64, 128),
                          gen_lens=(8, 16, 32))
    _reset_k1(ops, opope_gemm)
    kern4.launches = 0
    kern4.launches_by_route.update(sm90=0, tile=0)
    report = eng.timed_serve(trace)
    launches = {"K1": opope_gemm.launches, "K4": kern4.launches}
    forwards = report.decode_steps + report.prefill_batches
    want = {"K1": n_k1 * forwards, "K4": n_k4 * forwards}
    if launches != want or plain.calls or plain.grouped_calls:
        raise AssertionError(f"{tag} (ii) launches {launches} != {want} (plain calls "
                             f"{plain.calls}, {plain.grouped_calls} grouped)")
    check_routes(opope_gemm, launches["K1"], f"{tag} (ii)")
    check_routes(kern4, launches["K4"], f"{tag} (ii)", name="K4")
    _valid_outputs(report, trace, cfg.vocab, f"{tag} (ii)")
    rec["serve"] = {"requests": len(trace), "generated_tokens": report.generated_tokens,
                    "decode_steps": report.decode_steps,
                    "prefill_batches": report.prefill_batches, "wall_s": report.wall_time_s,
                    "tokens_per_s": report.tokens_per_sec, "ttft_p50_s": report.ttft_p50,
                    "itl_p50_s": report.itl_p50, "launches": launches}
    log(f"{tag} (ii) continuous: {len(trace)} requests, {report.generated_tokens} tokens, "
        f"decode_steps {report.decode_steps}, prefill_batches {report.prefill_batches}, wall "
        f"{report.wall_time_s:.3f} s, {report.tokens_per_sec:.1f} tokens/s, TTFT p50 "
        f"{report.ttft_p50 * 1e3:.1f} ms, ITL p50 {report.itl_p50 * 1e3:.1f} ms (host-issue "
        f"times); launches K1 {launches['K1']} = {n_k1 // n_layers} * {n_layers} * {forwards}"
        + (f", K4 {launches['K4']} = 3 * {n_layers} * {forwards}" if moe else "")
        + ", all on sm90")
    del eng
    if not decode_step:
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return rec, params

    # (iii) one lockstep decode step at 4 rows: wall, device busy, K1 and K4.
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))).to(dev)
    with torch.inference_mode():
        logits, caches = api.prefill(cfg, params, {"tokens": prompts}, 96)
    tok = logits.argmax(-1)[:, None]
    del logits
    # Every block weight read once; the 3-D ones are the experts' (K4).
    step_ms, dev_ms, bound_ms = _decode_step_times(
        torch, dev, lambda c, pos: api.decode(cfg, params, tok, c, pos)[1], caches, 64,
        params["blocks"], tag, kernels=("k1", "k4"),
        required=("k1",) if moe is None else ("k1", "k4"))
    del caches
    rec["decode_step"] = {"wall_ms": step_ms, "device_ms": dev_ms,
                          "launches": {"K1": n_k1, "K4": n_k4}}
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag} (iii) decode step, 4 rows: {step_ms:.3f} ms wall"
        + ("" if dev_ms is None else
           f"; device busy {dev_ms['busy']:.3f} ms ({100 * dev_ms['busy'] / step_ms:.1f}%), K1 "
           f"{dev_ms['k1']:.3f} ms ({n_k1} launches, byte bound {bound_ms['k1']:.3f} ms)"
           + (f", K4 {dev_ms['k4']:.3f} ms ({n_k4} launches, byte bound "
              f"{bound_ms['k4']:.3f} ms)" if moe else ""))
        + f"; peak device memory of (i)-(iii) {rec['peak_memory_gb']:.2f} GB")
    return rec, params


def long_prompt_phase(torch, np, cfg, params, ops, dev, tag):
    """14(b): one prompt of GEMMA2_LONG_PROMPT tokens, past the local layers'
    window, prefilled and decoded GEMMA2_LONG_STEPS steps fed the kernels'
    greedy tokens. The logits of a chunked prefill (chunk_attention's
    window) against the monolithic one (blockwise_attention's) within
    PROMPT_LOGIT_FLOOR_FACTOR x the plain GEMM's RMS gap on the monolithic
    path, as 4(f) gates; the plain GEMM's own gap at 4(a)'s gate; and the
    window must move the logits by more than that gate (every layer global
    instead), so the path past the window is the one checked."""
    import dataclasses

    from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain
    from repro_torch.models import api

    n, w, steps = GEMMA2_LONG_PROMPT, GEMMA2_LONG_CHUNK, GEMMA2_LONG_STEPS
    if not (n > cfg.window and n % w == 0):
        raise AssertionError(f"{tag}: prompt {n} must pass the window {cfg.window} in chunks of {w}")
    max_len = n + steps
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab, (1, n))).to(dev)

    def run(mcfg, chunked, stream=None):
        """fp32 logits [1 + steps, V] and the tokens fed (greedy without
        ``stream``)."""
        at = lambda x: torch.tensor([x], device=dev)  # noqa: E731
        with torch.inference_mode():
            if chunked:
                caches = api.init_state(mcfg, 1, max_len, torch.bfloat16, dev)
                for off in range(0, n, w):
                    logits, caches = api.prefill_chunk(mcfg, params, toks[:, off:off + w], caches,
                                                       at(off), at(w - 1))
            else:
                logits, caches = api.prefill(mcfg, params, {"tokens": toks}, max_len)
            rows, fed = [logits.float()], []
            for j in range(steps):
                tok = logits.argmax(-1)[:, None] if stream is None else stream[j]
                fed.append(tok)
                logits, caches = api.decode_at(mcfg, params, tok, caches, at(n + j))
                rows.append(logits.float())
        return torch.cat(rows), fed

    per_forward = 7 * cfg.n_layers
    _reset_k1(ops, opope_gemm)
    ref, stream = run(cfg, False)
    sync(torch, dev)
    mono_launches = opope_gemm.launches
    check_routes(opope_gemm, mono_launches, f"{tag} monolithic")
    with _patched(ops.backend("cuda"), "fn", opope_gemm_plain):
        ref_plain, _ = run(cfg, False, stream)
    _reset_k1(ops, opope_gemm)
    got, _ = run(cfg, True, stream)
    sync(torch, dev)
    chunk_launches = opope_gemm.launches
    check_routes(opope_gemm, chunk_launches, f"{tag} chunked")
    glob, _ = run(dataclasses.replace(cfg, window=10 ** 9), False, stream)
    want = (per_forward * (1 + steps), per_forward * (n // w + steps))
    if (mono_launches, chunk_launches) != want:
        raise AssertionError(f"{tag} K1 launches {mono_launches}, {chunk_launches} != {want}")
    if not all(torch.isfinite(x).all() for x in (ref, ref_plain, got, glob)):
        raise AssertionError(f"{tag} logits not finite")
    delta, scale = (ref - ref_plain).abs().max().item(), ref_plain.abs().max().item()
    d_floor, d_chunk, d_window = _rms(ref_plain - ref), _rms(got - ref), _rms(glob - ref)
    gate = PROMPT_LOGIT_FLOOR_FACTOR * d_floor
    out = {"prompt": n, "chunk": w, "decode_steps": steps, "window": cfg.window,
           "max_abs_dlogits_plain": delta, "max_abs_logits": scale,
           "rms_kernels_vs_plain": d_floor, "rms_chunked_vs_monolithic": d_chunk,
           "rms_window_vs_global": d_window,
           "argmax_chunked_vs_monolithic": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
           "launches": {"monolithic": mono_launches, "chunked": chunk_launches}}
    log(f"{tag} one {n}-token prompt (window {cfg.window}) + {steps} decode steps, teacher-forced "
        f"logits: chunked ({n // w} chunks of {w}) vs monolithic prefill RMS {d_chunk:.4g} (gated "
        f"<= {PROMPT_LOGIT_FLOOR_FACTOR} x {d_floor:.4g}, the plain GEMM vs the kernels); the "
        f"plain GEMM max|dlogits| {delta:.4g} <= 2e-2 * {scale:.4g}; every layer global instead "
        f"moves them by RMS {d_window:.4g} (gated > {gate:.4g}); K1 launches {mono_launches} "
        f"monolithic, {chunk_launches} chunked, all on sm90")
    if not (d_chunk <= gate and delta <= 2e-2 * scale and d_window > gate):
        raise AssertionError(f"{tag} long prompt gates: {out}")
    return out


def expert_gemm_phase(torch, k4, q8mod, q8b, ep, cfg, params, dev, tag, *,
                      expert_rows=GROK_EXPERT_MS, layer=0):
    """14(d) and 16(a)(v): K4 and K5 at an MoE model's expert GEMMs on
    layer ``layer``'s resident weights, at ``expert_rows`` rows an expert (a
    4-row decode step's capacity and a 512-token group's: grok-1-314b's 2
    and 160 at G 8), with the chains the model runs: each against its plain
    version (K4 within one bf16 ulp, K5 bitwise but silu's one ulp), timed
    by device time (queued_ms) beside torch.bmm (K4) and the bound."""
    from repro_torch.kernels.opope_gemm import full_fp32

    p = params["blocks"][layer]["moe"]
    short = cfg.name.split("-")[0]
    g, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    gen = torch.Generator(device=dev).manual_seed(15)
    bf16, f32 = torch.bfloat16, torch.float32
    rows, err4, err5 = [], 0.0, 0.0
    kern4, kern5 = k4.opope_gemm_grouped, q8mod.opope_gemm_q8_grouped
    for m in expert_rows:
        x = torch.randn((g, m, d), generator=gen, device=dev).to(bf16)
        up = torch.randn((g, m, f), generator=gen, device=dev).to(bf16)
        h = torch.randn((g, m, f), generator=gen, device=dev).to(bf16)
        for name, a, steps, ops_, out_dtype in (("w_up", x, (), (), bf16),
                                                ("w_gate", x, ("silu", "mul"), (up,), bf16),
                                                ("w_down", h, (), (), f32)):
            b = p[name]
            k, n = b.shape[1], b.shape[2]
            out = kern4(a, b, out_dtype=out_dtype, epilogue=steps, epilogue_operands=ops_)
            err4 = max(err4, check_close(torch, out, lambda dt: k4.opope_gemm_grouped_plain(
                a, b, out_dtype=dt, epilogue=steps, epilogue_operands=ops_), out_dtype,
                f"{tag} K4 {name} M={m}"))
            aq, bq = q8b.quantize_grouped_operands(a, b)
            out5 = kern5(aq.q, aq.scale, bq.q, bq.scale, out_dtype=out_dtype, epilogue=steps,
                         epilogue_operands=ops_)
            want5 = q8mod.opope_gemm_q8_grouped_plain(aq.q, aq.scale, bq.q, bq.scale,
                                                      out_dtype=out_dtype, epilogue=steps,
                                                      epilogue_operands=ops_)
            err5 = max(err5, q8_check(torch, out5, want5, bool(steps), f"{tag} K5 {name} M={m}"))
            ms = queued_ms(torch, lambda i: kern4(a, b, out_dtype=out_dtype, epilogue=steps,
                                                  epilogue_operands=ops_), 5)
            with full_fp32():
                lib_ms = queued_ms(torch, lambda i: torch.bmm(a, b), 5)
            ms5 = queued_ms(torch, lambda i: kern5(aq.q, aq.scale, bq.q, bq.scale,
                                                   out_dtype=out_dtype, epilogue=steps,
                                                   epilogue_operands=ops_), 5)
            out_elem = torch.empty((), dtype=out_dtype).element_size()
            bound, by = _grouped_bound(g, m, k, n, out_elem, len(ops_))
            bound5, by5 = q8_bound(g, m, k, n, out_elem, len(ops_))
            rows.append({"gemm": name, "g": g, "m": m, "k": k, "n": n, "chain": "+".join(steps)
                         or "none", "k4_ms": ms, "bmm_ms": lib_ms, "bound_ms": bound,
                         "bound_by": by, "k5_ms": ms5, "k5_bound_ms": bound5, "k5_bound_by": by5})
            log(f"{tag} {short} {name} [{g} x {m} x {k}] @ [{g} x {k} x {n}] ({rows[-1]['chain']}, "
                f"{str(out_dtype).removeprefix('torch.')} out): K4 {ms:.4f} ms, torch.bmm "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); K5 {ms5:.4f} ms, bound "
                f"{bound5:.4f} ms ({by5})")
            del aq, bq, out, out5, want5
    for m in expert_rows:
        sel = [r for r in rows if r["m"] == m]
        log(f"{tag} {short}'s 3 expert GEMMs at M={m}: K4 {sum(r['k4_ms'] for r in sel):.4f} ms, "
            f"torch.bmm {sum(r['bmm_ms'] for r in sel):.4f} ms, bound "
            f"{sum(r['bound_ms'] for r in sel):.4f} ms; K5 {sum(r['k5_ms'] for r in sel):.4f} ms, "
            f"bound {sum(r['k5_bound_ms'] for r in sel):.4f} ms")
    return {"rows": rows, "k4_max_abs_err": err4, "k5_max_abs_err": err5,
            "timing": f"device time (queued_ms), layer {layer}'s resident weights"}


def _dense_first_step(torch, ops, ep, tcfg, params, first, kernels, tables, tag):
    """A dense train step's loss and gradients on the kernels, every K1
    launch counted by role and route against ``tables``
    (:func:`_check_role_counts`), then on the plain backend (fp32 and fp64
    sums), held under :func:`_gate_first_step`."""
    from repro_torch.models import api
    from repro_torch.tree import leaves, map_leaves

    fp64, plain = _fp64_plain(torch, ep), ops.backend("torch")
    counts, state, installed = _role_counter(torch, ops, kernels, (("cuda", "fn", "K1"),))

    def loss_grads(backend):
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        state["phase"] = "forward"
        loss = api.loss_fn(tcfg, live, first, backend=backend)
        state["phase"] = "remat recompute"
        return loss.detach().float(), torch.autograd.grad(loss, list(leaves(live)))

    with installed():
        loss_k, g_k = loss_grads("cuda")
        sync(torch, first["tokens"].device)
    loss_p, g_p = loss_grads("torch")
    with _patched(plain, "fn", fp64):
        loss_64, g_64 = loss_grads("torch")
    losses = (loss_k, loss_p, loss_64)
    leaf_gaps, worst_leaf = _gate_first_step(torch, params, losses, (g_k, g_p, g_64), tag)
    log(f"{tag} first step: loss kernels {loss_k.item():.6f}, plain {loss_p.item():.6f}, plain "
        f"fp64 sums {loss_64.item():.6f}; {len(leaf_gaps)} gradient leaves within "
        f"{TRAIN_GRAD_FLOOR_FACTOR} x floor (worst {worst_leaf}: RMS "
        f"{leaf_gaps[worst_leaf][0]:.3g}, floor {leaf_gaps[worst_leaf][1]:.3g})")
    return {"losses": losses, "leaf_gaps": leaf_gaps, "worst_leaf": worst_leaf,
            "by_role": _check_role_counts(counts, tables, tcfg.n_layers, tag)}


def family_train_phase(torch, np, cfg, ops, ep, k4mod, dev, *, layers, batch, seq, tag,
                       steps=FAMILY_TRAIN_STEPS):
    """14(e) for one family: its full width cut to ``layers`` layers, bf16,
    remat "full", with the config's ``grad_accum`` and moment dtype, on the
    Markov stream at ``batch`` x ``seq`` tokens a step. The first step (its
    first microbatch) on the kernels against the plain backend under
    10(a)'s floor gate, every launch counted by role and route (an MoE
    model teacher-forced on the kernels' routing, as 11(b)); then ``steps``
    steps through ``repro_torch.train.train`` with exact launch counts,
    finite losses, step time, tokens/s and peak memory. The whole phase,
    its first-step gate too, runs under the training loop's own allocator
    setting (``repro_torch.train.expandable_segments``)."""
    from repro_torch.train import expandable_segments

    with expandable_segments(dev):
        return _family_train(torch, np, cfg, ops, ep, k4mod, dev, layers=layers, batch=batch,
                             seq=seq, tag=tag, steps=steps)


def _family_train(torch, np, cfg, ops, ep, k4mod, dev, *, layers, batch, seq, tag, steps):
    import dataclasses

    from repro_torch import obs
    from repro_torch.data import MarkovLMDataset, make_batch_fn
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainLoopConfig, train
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    tcfg = dataclasses.replace(cfg, n_layers=layers)
    moe = tcfg.moe is not None
    if moe and tcfg.moe.n_shared:
        raise AssertionError(f"{tag}: the launch tables here have no shared expert")
    kernels = {"K1": opope_gemm, "K4": k4mod.opope_gemm_grouped}
    tables = ({"K1": K1_GROK_TRAIN, "K4": K4_MOE_TRAIN} if moe else {"K1": K1_DENSE_TRAIN})
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(tcfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in leaves(params))
    batch_fn = make_batch_fn(MarkovLMDataset(tcfg.vocab, seq, batch, seed=0), dev)
    micro = batch // tcfg.grad_accum
    first = {k: v[:micro] for k, v in batch_fn(0).items()}
    if moe:
        fs = _moe_first_step(torch, ops, ep, tcfg, params, first, kernels,
                             (("cuda", "fn", "K1"), ("cuda", "grouped_fn", "K4")), tables,
                             "cuda", "torch", f"{tag} {tcfg.name}")
    else:
        fs = _dense_first_step(torch, ops, ep, tcfg, params, first, kernels, tables,
                               f"{tag} {tcfg.name}")
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    obs.clear_events()
    _reset_k1(ops, opope_gemm)
    kernels["K4"].launches_by_route.update(sm90=0, tile=0)
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=1, total_steps=steps)
    t0 = time.perf_counter()
    res = train(tcfg, opt, TrainLoopConfig(total_steps=steps, log_every=1), batch_fn,
                params=params, log=lambda msg: log(f"{tag} {msg}"))
    sync(torch, dev)
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    routes = {name: dict(kernels[name].launches_by_route) for name in tables}
    want = {name: _want_routes(table, layers, steps * tcfg.grad_accum)
            for name, table in tables.items()}
    if routes != want:
        raise AssertionError(f"{tag} launches by route {routes} != {want}")
    moment_dtypes = {str(x.dtype).removeprefix("torch.") for x in leaves(res.opt_state.mu)}
    if moment_dtypes != {tcfg.moment_dtype}:
        raise AssertionError(f"{tag} moments in {moment_dtypes}, config {tcfg.moment_dtype}")
    if len(res.losses) != steps or not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"{tag} losses {res.losses}")
    walls = [e["wall_s"] for e in obs.recent_events(steps, kind="train_step")]
    step_s = sum(walls[1:]) / max(1, len(walls) - 1)
    phase_s = time.perf_counter() - t_phase
    log(f"{tag} {tcfg.name} at {layers} layers ({n_params / 1e9:.3f} B params), {batch} x {seq} "
        f"tokens a step in {tcfg.grad_accum} microbatches, {tcfg.moment_dtype} moments: {steps} "
        f"steps in {train_s:.2f} s, losses {[round(x, 4) for x in res.losses]}; step wall "
        f"{step_s * 1e3:.1f} ms (steps 2..{steps}; the first {walls[0] * 1e3:.1f} ms), "
        f"{batch * seq / step_s:.1f} tokens/s; peak device memory {peak_gb:.2f} GB (the "
        f"first-step gate's {first_peak:.2f} GB); launches by route {routes}; {phase_s:.1f} s")
    del res, params
    return {"name": tcfg.name, "layers": layers, "params": n_params, "batch": batch, "seq": seq,
            "grad_accum": tcfg.grad_accum, "moment_dtype": tcfg.moment_dtype, "steps": steps,
            "first_step_loss": {k: v.item() for k, v in zip(("kernels", "plain", "plain_fp64"),
                                                             fs["losses"])},
            "worst_leaf": fs["worst_leaf"], "worst_leaf_gap": fs["leaf_gaps"][fs["worst_leaf"]],
            "first_step_by_role": fs["by_role"], "step_ms": step_s * 1e3,
            "first_step_ms": walls[0] * 1e3, "tokens_per_sec": batch * seq / step_s,
            "peak_memory_gb": peak_gb, "first_step_gate_peak_memory_gb": first_peak,
            "launches_by_route": routes, "seconds": phase_s}


def families_phase(torch, np, get_config, ops, ep, k4mod, q8mod, q8b, qz, kernels, dev):
    """Phase 14 (ROADMAP A.8): stablelm-12b, gemma2-9b, qwen2.5-32b and
    grok-1-314b (cut to GROK_SERVE_LAYERS layers) one at a time, each freed
    before the next, through :func:`family_phase` and its own extra: (a)
    4(f)'s prefix-cache gate, (b) :func:`long_prompt_phase`, (c) phase 8
    under ``mlp_q8_policy()``, (d) phase 8 under ``{"moe": "q8"}`` and
    :func:`expert_gemm_phase`; then (e) training gemma2-9b and grok-1-314b
    (:func:`family_train_phase`). Returns the records."""
    import dataclasses

    t_phase = time.perf_counter()
    out = {}
    for letter, name in zip("abcd", FAMILIES):
        tag = f"14({letter}) {name}"
        t0 = time.perf_counter()
        cfg = get_config(name)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, n_layers=GROK_SERVE_LAYERS)
        rec, params = family_phase(torch, np, cfg, ops, ep, k4mod, dev, tag)
        if name == "stablelm-12b":
            rec["prefix_cache"] = _prefix_gate(torch, np, cfg, params, ops, dev, tag)[0]
        elif name == "gemma2-9b":
            rec["long_prompt"] = long_prompt_phase(torch, np, cfg, params, ops, dev, tag)
        elif name == "qwen2.5-32b":
            rec["q8"] = q8_model_phase(
                torch, np, cfg, params, qz.mlp_q8_policy(),
                qz.PrecisionPolicy(rules={"mlp": "torch_q8", "moe": "torch_q8"}, default="torch"),
                every_layer({"K1": 4, "K2": 3}, cfg.n_layers), ops, ep, kernels, dev, f"{tag} q8")
        else:
            rec["q8"] = q8_model_phase(
                torch, np, cfg, params, qz.PrecisionPolicy(rules={"moe": "q8"}),
                qz.PrecisionPolicy(rules={"moe": "torch_q8"}, default="torch"),
                every_layer({"K1": 5, "K5": 3}, cfg.n_layers), ops, ep, kernels, dev, f"{tag} q8")
            rec["experts"] = expert_gemm_phase(torch, k4mod, q8mod, q8b, ep, cfg, params, dev, tag)
        rec["phase_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["seconds"] = time.perf_counter() - t0
        log(f"{tag}: peak device memory {rec['phase_peak_memory_gb']:.2f} GB over the family's "
            f"phase ({rec['peak_memory_gb']:.2f} GB over (i)-(iii)); {rec['seconds']:.1f} s")
        del params
        out[name] = rec
    out["train"] = {name: family_train_phase(torch, np, get_config(name), ops, ep, k4mod, dev,
                                             layers=layers, batch=batch, seq=seq,
                                             tag=f"14(e) {name}")
                    for name, layers, batch, seq in FAMILY_TRAIN}
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 took {out['seconds']:.1f} s")
    return out


def family_launch_paths(fam):
    """Each GEMM kernel's phase-14 launches by path and route (every serving
    path's held to sm90 there, training's to its exact split)."""
    paths = {"K1": {}, "K4": {}, "K2": {}, "K5": {}}
    for name in FAMILIES:
        r = fam[name]
        for kname, n in r["serve"]["launches"].items():
            if n:
                paths[kname][f"{name} (14)"] = {"sm90": n, "tile": 0}
        if "prefix_cache" in r:
            pc = r["prefix_cache"]
            paths["K1"][f"{name} prefix cache (14(a))"] = {
                "sm90": pc["off"]["k1_launches"] + pc["on"]["k1_launches"], "tile": 0}
        if "long_prompt" in r:
            paths["K1"][f"{name} long prompt (14(b))"] = {
                "sm90": sum(r["long_prompt"]["launches"].values()), "tile": 0}
        for kname, n in r.get("q8", {}).get("launches", {}).items():
            if n:
                paths[kname][f"{name} q8 (14)"] = {"sm90": n, "tile": 0}
    for name, t in fam["train"].items():
        for kname, routes in t["launches_by_route"].items():
            paths[kname][f"{name} train ({t['layers']} layers, 14(e))"] = routes
    return paths


def _a8b_k1_per_forward(cfg, kind):
    """K1 launches of one forward: a vlm's prefill adds the projector's 2 to
    the backbone's 7 a layer; whisper's prefill runs the encoder (6 a
    layer), the cross K/V (2 a decoder layer) and the decoder (8 a layer:
    4 self-attention, the cross q and o, 2 MLP), its decode step the
    decoder alone; a loss forward is a prefill's."""
    if cfg.family == "vlm":
        return 7 * cfg.n_layers + (2 if kind != "decode" else 0)
    if kind == "decode":
        return 8 * cfg.n_layers
    return 6 * cfg.n_enc_layers + 2 * cfg.n_layers + 8 * cfg.n_layers


def _a8b_full_logits(torch, cfg, params, batch, tokens, n_last):
    """fp32 logits [B, n_last, V] at the last ``n_last`` positions of one
    full forward (no caches) over ``batch``'s image rows or frames and
    ``tokens``, on the default backend."""
    from repro_torch.models import encdec, transformer, vlm

    with torch.inference_mode():
        if cfg.family == "vlm":
            hidden, _, _ = vlm.vlm_forward(params, tokens, batch["patch_embeds"], cfg,
                                           mode="prefill")
        else:
            enc = encdec.encode(params, batch["frames"], cfg)
            hidden, _ = encdec.decoder_forward(params, tokens, cfg, enc_out=enc, mode="prefill")
        return transformer.lm_logits(params, hidden[:, -n_last:], cfg)


def a8b_family_phase(torch, np, cfg, ops, ep, dev, tag):
    """Phase 15 for one family of ROADMAP A.8b at its published width, on
    weights drawn from seed 0 and bf16 inputs drawn from the seed
    (``launch.serve.static_batch``): (i) the prefill logits of A8B_ROWS_GATE
    rows through the kernels against the plain GEMM (the ``cuda`` backend's
    function swapped for K1's plain version, so a vlm's projector, which
    the prefill runs on the default backend, is held too) within
    PREFILL_LOGIT_FLOOR_FACTOR x the RMS gap of the plain version's fp32
    and fp64 sums in this run; (ii) the static engine, A8B_ROWS rows,
    A8B_GEN tokens, every K1 launch counted and on sm90, and its decoded
    logits teacher-forced against one full forward over the image rows or
    frames, the prompt and the tokens fed, within PROMPT_LOGIT_FLOOR_FACTOR
    x the kernels-vs-plain-GEMM RMS of that forward (4(f)'s floor): a vlm's
    decode runs at the true position; (iii) the prefill time, a profiled
    A8B_ROWS-row decode step and the peak device memory. Returns the
    record and the weights."""
    from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain
    from repro_torch.launch.serve import static_batch
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import engine as engine_mod

    n_img = cfg.n_img_tokens
    per_prefill, per_decode = (_a8b_k1_per_forward(cfg, k) for k in ("prefill", "decode"))
    params, rec = _family_params(torch, api, cfg, dev, tag)
    rec.update(encoder_layers=cfg.n_enc_layers, image_rows=n_img)
    cuda_be, fp64 = ops.backend("cuda"), _fp64_plain(torch, ep)

    # (i) prefill logits: kernels, plain GEMM (fp32 sums), plain GEMM (fp64).
    gate_batch = static_batch(cfg, A8B_ROWS_GATE, A8B_PROMPT, 0, dev)
    max_len = n_img + A8B_PROMPT
    _reset_k1(ops, opope_gemm)
    with torch.inference_mode():
        got, _ = api.prefill(cfg, params, gate_batch, max_len)
        sync(torch, dev)
        gate_launches = opope_gemm.launches
        with _patched(cuda_be, "fn", opope_gemm_plain):
            ref, _ = api.prefill(cfg, params, gate_batch, max_len)
        with _patched(cuda_be, "fn", fp64):
            ref64, _ = api.prefill(cfg, params, gate_batch, max_len)
    if gate_launches != per_prefill:
        raise AssertionError(f"{tag} (i) K1 launches {gate_launches} != {per_prefill}")
    check_routes(opope_gemm, gate_launches, f"{tag} (i)")
    if not all(torch.isfinite(x).all() for x in (got, ref, ref64)):
        raise AssertionError(f"{tag} (i) prefill logits not finite")
    if tuple(got.shape) != (A8B_ROWS_GATE, cfg.vocab):
        raise AssertionError(f"{tag} (i) prefill logits shape {tuple(got.shape)}")
    d_k, d_f = _rms(got - ref), _rms(ref - ref64)
    rec["prefill_gate"] = {
        "rows": A8B_ROWS_GATE, "positions": max_len, "max_abs_dlogits": (got - ref).abs().max().item(),
        "max_abs_logits": ref.abs().max().item(), "rms_kernels_vs_plain": d_k,
        "rms_plain_fp32_vs_fp64": d_f, "launches": gate_launches,
        "argmax_agreement": (got.argmax(-1) == ref.argmax(-1)).float().mean().item()}
    log(f"{tag} (i) prefill {A8B_ROWS_GATE} x ({n_img or cfg.enc_seq} "
        f"{'image rows' if n_img else 'frames'} + {A8B_PROMPT} tokens): RMS kernels vs plain "
        f"{d_k:.4g} (gated <= {PREFILL_LOGIT_FLOOR_FACTOR} x {d_f:.4g}, the plain GEMM's fp32 vs "
        f"fp64 sums); max|dlogits| {rec['prefill_gate']['max_abs_dlogits']:.4g} of max|logits| "
        f"{rec['prefill_gate']['max_abs_logits']:.4g}; {gate_launches} K1 launches, all on sm90")
    if not d_k <= PREFILL_LOGIT_FLOOR_FACTOR * d_f:
        raise AssertionError(f"{tag} (i) prefill logits: kernels vs plain RMS {d_k} > "
                             f"{PREFILL_LOGIT_FLOOR_FACTOR} x floor {d_f}")
    del got, ref, ref64, gate_batch

    # (ii) the static engine, its logits recorded where it samples.
    batch = static_batch(cfg, A8B_ROWS, A8B_PROMPT, 0, dev)
    max_len = n_img + A8B_PROMPT + A8B_GEN
    eng = ServeEngine(cfg=cfg, params=params, max_len=max_len)
    eng.generate(static_batch(cfg, A8B_ROWS, A8B_PROMPT, 1, dev), 2)  # warm-up
    seen, real_sample = [], engine_mod.sample_token

    def recording(logits, generator=None, temperature=0.0):
        seen.append(logits.float())
        return real_sample(logits, generator, temperature)

    _reset_k1(ops, opope_gemm)
    sync(torch, dev)
    t0 = time.perf_counter()
    with _patched(engine_mod, "sample_token", recording):
        toks = eng.generate(batch, A8B_GEN)
    toks_host = toks.cpu()
    serve_s = time.perf_counter() - t0
    serve_launches = opope_gemm.launches
    want = per_prefill + (A8B_GEN - 1) * per_decode
    if serve_launches != want:
        raise AssertionError(f"{tag} (ii) K1 launches {serve_launches} != {want}")
    check_routes(opope_gemm, serve_launches, f"{tag} (ii)")
    if tuple(toks_host.shape) != (A8B_ROWS, A8B_GEN) or not (
            (toks_host >= 0) & (toks_host < cfg.vocab)).all():
        raise AssertionError(f"{tag} (ii) engine output {tuple(toks_host.shape)}")
    engine_logits = torch.stack(seen, dim=1)  # [B, GEN, V]
    fed = torch.cat([batch["tokens"], toks[:, :-1]], dim=1)
    full = _a8b_full_logits(torch, cfg, params, batch, fed, A8B_GEN)
    with _patched(cuda_be, "fn", opope_gemm_plain):
        full_plain = _a8b_full_logits(torch, cfg, params, batch, fed, A8B_GEN)
    d_floor, d_tf = _rms(full_plain - full), _rms(engine_logits - full)
    agree = (engine_logits.argmax(-1) == full.argmax(-1)).float().mean().item()
    rec["serve"] = {"rows": A8B_ROWS, "prompt": A8B_PROMPT, "generated": A8B_GEN,
                    "max_len": max_len, "wall_s": serve_s,
                    "tokens_per_s": A8B_ROWS * A8B_GEN / serve_s, "launches": serve_launches,
                    "teacher_forced": {"rms_engine_vs_full_forward": d_tf,
                                       "rms_kernels_vs_plain_full_forward": d_floor,
                                       "argmax_agreement": agree}}
    log(f"{tag} (ii) static engine, {A8B_ROWS} rows x {A8B_PROMPT}-token prompts"
        + (f" after {n_img} image rows (decoding from position {n_img + A8B_PROMPT})" if n_img
           else f" against {cfg.enc_seq} frames")
        + f", {A8B_GEN} tokens each in {serve_s:.3f} s ({A8B_ROWS * A8B_GEN / serve_s:.1f} tokens/s); "
        f"K1 {serve_launches} = {per_prefill} + {A8B_GEN - 1} x {per_decode} launches, all on sm90; "
        f"teacher-forced logits vs one full forward over the prompt and the {A8B_GEN - 1} tokens "
        f"fed: RMS {d_tf:.4g} (gated <= {PROMPT_LOGIT_FLOOR_FACTOR} x {d_floor:.4g}, the plain "
        f"GEMM vs the kernels on that forward), argmax agreement {agree:.4f}")
    if not d_tf <= PROMPT_LOGIT_FLOOR_FACTOR * d_floor:
        raise AssertionError(f"{tag} (ii) teacher-forced logits RMS {d_tf} > "
                             f"{PROMPT_LOGIT_FLOOR_FACTOR} x {d_floor}")
    del seen, engine_logits, full, full_plain, eng

    # (iii) the prefill's time, then a decode step's wall and device time.
    with torch.inference_mode():
        sync(torch, dev)
        t0 = time.perf_counter()
        logits, caches = api.prefill(cfg, params, batch, n_img + A8B_PROMPT + 12)
        sync(torch, dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits.argmax(-1)[:, None]
    del logits
    # The weights a decode step's K1 GEMMs read: the backbone's, or the
    # decoder's but its cross K and V projections (run once, at prefill).
    blocks = params["blocks"] if cfg.family == "vlm" else [
        {k: v for k, v in b.items() if k != "cross_attn"} | {"cross_attn": {
            k: v for k, v in b["cross_attn"].items() if k in ("wq", "wo")}}
        for b in params["dec_blocks"]]
    step_ms, dev_ms, bound_ms = _decode_step_times(
        torch, dev, lambda c, pos: api.decode(cfg, params, tok, c, pos)[1], caches,
        n_img + A8B_PROMPT, blocks, tag)
    del caches
    bound_ms = bound_ms["k1"]
    rec["prefill_ms"] = prefill_ms
    rec["decode_step"] = {"rows": A8B_ROWS, "wall_ms": step_ms, "device_ms": dev_ms,
                          "launches": per_decode}
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag} (iii) prefill {A8B_ROWS} x {n_img + A8B_PROMPT if n_img else A8B_PROMPT} "
        f"positions{'' if n_img else f' after {cfg.enc_seq} frames'}: {prefill_ms:.2f} ms wall; "
        f"decode step, {A8B_ROWS} rows: {step_ms:.3f} ms wall"
        + ("" if dev_ms is None else
           f"; device busy {dev_ms['busy']:.3f} ms ({100 * dev_ms['busy'] / step_ms:.1f}%), K1 "
           f"{dev_ms['k1']:.3f} ms ({per_decode} launches, byte bound {bound_ms:.3f} ms)")
        + f"; peak device memory of (i)-(iii) {rec['peak_memory_gb']:.2f} GB")
    return rec, params


def a8b_loss_phase(torch, np, cfg, ops, ep, dev, tag, *, batch, prompt):
    """15(c) and 16(c): one ``loss_fn`` value and every gradient leaf on the
    kernels against the plain backend (fp32 and fp64 sums), under 10(a)'s
    floor gate (:func:`_gate_first_step`), on weights drawn from seed 0 and
    a batch drawn from the seed; an MoE model's plain runs teacher-forced on
    the kernels' routing (as 11(b)). K1's and K4's launches counted by
    route: the forward and the bf16 backward on sm90, the fp32 backward of
    an epilogue'd GEMM on tile (a model without one, xlstm, has none)."""
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.launch.serve import static_batch
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.tree import leaves, map_leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kern4 = importlib_k4().opope_gemm_grouped
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in _leaves(params))
    data = static_batch(cfg, batch, prompt + 1, 0, dev)
    tokens = data.pop("tokens")
    data.update(tokens=tokens[:, :-1], labels=tokens[:, 1:])
    fp64, plain = _fp64_plain(torch, ep), ops.backend("torch")
    forced, real_route = {}, moe_mod._route  # router leaf's storage -> the kernels' top_idx

    def recording(p, xf, top_k, backend=None):
        out = real_route(p, xf, top_k, backend)
        forced.setdefault(p["router"].data_ptr(), out[2].clone())
        return out

    def replay(p, xf, top_k, backend=None):
        gates, _, _ = real_route(p, xf, top_k, backend)
        top_vals = torch.gather(gates, 1, forced[p["router"].data_ptr()])
        return (gates, top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9),
                forced[p["router"].data_ptr()])

    def loss_grads(backend):
        live = map_leaves(lambda p: p.detach().requires_grad_(), params)
        loss = api.loss_fn(cfg, live, data, backend=backend)
        return loss.detach().float(), torch.autograd.grad(loss, list(leaves(live)))

    _reset_k1(ops, opope_gemm)
    kern4.launches_by_route.update(sm90=0, tile=0)
    with _patched(moe_mod, "_route", recording):
        loss_k, g_k = loss_grads("cuda")
    sync(torch, dev)
    routes = {"K1": dict(opope_gemm.launches_by_route), "K4": dict(kern4.launches_by_route)}
    with _patched(moe_mod, "_route", replay):
        loss_p, g_p = loss_grads("torch")
        with _patched(plain, "fn", fp64), _patched(plain, "grouped_fn", fp64):
            loss_64, g_64 = loss_grads("torch")
    leaf_gaps, worst = _gate_first_step(torch, params, (loss_k, loss_p, loss_64),
                                        (g_k, g_p, g_64), tag)
    epilogued = any(bd.mixer in ("attn", "attn_local") or bd.ffn != "none"
                    for bd in cfg.pattern)
    if (not routes["K1"]["sm90"] or bool(routes["K1"]["tile"]) != epilogued
            or bool(routes["K4"]["sm90"]) != (cfg.moe is not None)):
        raise AssertionError(f"{tag} launches by route {routes}: the forward and bf16 "
                             f"backward on sm90, the fp32 backward on tile")
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"name": cfg.name, "layers": cfg.n_layers, "params": n_params, "batch": batch,
           "prompt": prompt,
           "loss": {"kernels": loss_k.item(), "plain": loss_p.item(), "plain_fp64": loss_64.item()},
           "worst_leaf": worst, "worst_leaf_gap": leaf_gaps[worst], "leaves": len(leaf_gaps),
           "launches_by_route": routes["K1"], "k4_launches_by_route": routes["K4"],
           "routing_replayed": cfg.moe is not None, "peak_memory_gb": peak,
           "seconds": time.perf_counter() - t0}
    log(f"{tag} at {cfg.n_layers} layers ({n_params / 1e9:.4f} B params), {batch} x {prompt} "
        f"tokens: loss kernels {loss_k.item():.6f}, plain {loss_p.item():.6f}, plain fp64 sums "
        f"{loss_64.item():.6f}" + (" (the plain runs on the kernels' routing)" if cfg.moe else "")
        + f"; {len(leaf_gaps)} gradient leaves within {TRAIN_GRAD_FLOOR_FACTOR} x floor (worst "
        f"{worst}: RMS {leaf_gaps[worst][0]:.3g}, floor {leaf_gaps[worst][1]:.3g}); K1 launches "
        f"by route {routes['K1']}" + (f", K4 {routes['K4']}" if cfg.moe else "")
        + f"; peak device memory {peak:.2f} GB; {out['seconds']:.1f} s")
    del params, g_k, g_p, g_64
    return out


def a8b_phase(torch, np, get_config, ops, ep, dev):
    """Phase 15 (ROADMAP A.8b): (a) llava-next-mistral-7b and (b)
    whisper-base at their published widths through :func:`a8b_family_phase`,
    one at a time, each freed before the next; then (c) each family's loss
    and gradients (:func:`a8b_loss_phase`): llava cut to A8B_LOSS_LAYERS
    layers, whisper uncut. Returns the records."""
    import dataclasses

    t_phase = time.perf_counter()
    out = {}
    for letter, name in zip("ab", A8B_FAMILIES):
        t0 = time.perf_counter()
        rec, params = a8b_family_phase(torch, np, get_config(name), ops, ep, dev,
                                       f"15({letter}) {name}")
        del params
        rec["seconds"] = time.perf_counter() - t0
        log(f"15({letter}) {name}: {rec['seconds']:.1f} s")
        out[name] = rec
    out["loss"] = {}
    for name in A8B_FAMILIES:
        cfg = get_config(name)
        if cfg.family == "vlm":
            cfg = dataclasses.replace(cfg, n_layers=A8B_LOSS_LAYERS)
        out["loss"][name] = a8b_loss_phase(torch, np, cfg, ops, ep, dev, f"15(c) {name}",
                                           batch=A8B_LOSS_ROWS, prompt=A8B_PROMPT)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 took {out['seconds']:.1f} s")
    return out


def a8b_launch_paths(rec):
    """K1's phase-15 launches by path and route."""
    paths = {}
    for name in A8B_FAMILIES:
        r = rec[name]
        paths[f"{name} prefill gate (15(i))"] = {"sm90": r["prefill_gate"]["launches"], "tile": 0}
        paths[f"{name} static engine (15(ii))"] = {"sm90": r["serve"]["launches"], "tile": 0}
        loss = rec["loss"][name]
        paths[f"{name} loss ({loss['layers']} layers, 15(c))"] = loss["launches_by_route"]
    return paths


def a8c_launches(cfg, kind, q8=False):
    """GEMM launches of one ``"prefill"`` or ``"decode"`` forward of a
    phase-16 model, by kernel: a mamba mixer's 4 projections, an mLSTM's 6
    and an sLSTM's 2 on K1 (under the q8 ``mixer`` rule, a mamba's 4 on K2
    at prefill, and at decode its in and out projections on K2 and
    ``x_proj``, ``dt_proj`` on K1: the reference's decode step runs those on
    the default backend), attention's 4 and an MLP's 3 on K1, an MoE
    block's router on K1 and its 3 expert GEMMs on K4 (K5 under q8)."""
    n = {"K1": 0, "K4": 0, "K2": 0, "K5": 0}
    for layer in range(cfg.n_layers):
        bd = cfg.pattern[layer % len(cfg.pattern)]
        if bd.mixer == "mamba":
            on_k2 = (2 if kind == "decode" else 4) if q8 else 0
            n["K2"] += on_k2
            n["K1"] += 4 - on_k2
        else:
            n["K1"] += {"mlstm": 6, "slstm": 2}.get(bd.mixer, 4)
        if bd.ffn == "mlp":
            n["K1"] += 3
        elif bd.ffn == "moe":
            n["K1"] += 1
            n["K5" if q8 else "K4"] += 3
    return n


def _gemm_weights(blocks):
    """The block leaves the GEMMs of a decode step read: every leaf but a
    mamba mixer's ``A_log`` and ``conv_w`` and an sLSTM's recurrent ``r``
    (plain PyTorch, not a GEMM kernel's operand)."""
    skip = {"A_log", "conv_w", "r"}
    return [{k: {n: w for n, w in v.items() if n not in skip} if isinstance(v, dict) else v
             for k, v in b.items()} for b in blocks]


def a8c_k1_shapes(torch, cfg, params, dev, tag):
    """16(0): K1 at each distinct GEMM weight of the family's first period
    (mamba's x_proj N = 288, the mLSTM's w_if N = 8 among them) at a 4-row
    decode step and a 128-row prefill, on the route its plan gives, against
    its plain version (check_close). Returns (max abs err, launches by
    route, the shapes)."""
    from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain

    weights = {}
    for b in _gemm_weights(params["blocks"][:len(cfg.pattern)]):
        for w in _leaves(b):
            if w.ndim == 2:
                weights.setdefault(tuple(w.shape), w)
    gen = torch.Generator(device=dev).manual_seed(16)
    before, err = dict(opope_gemm.launches_by_route), 0.0
    for m in (A8C_ROWS, 128):
        for (k, n), w in sorted(weights.items()):
            a = torch.randn((m, k), generator=gen, device=dev).to(w.dtype)
            out = opope_gemm(a, w)
            err = max(err, check_close(torch, out, lambda dt: opope_gemm_plain(a, w, out_dtype=dt),
                                       w.dtype, f"{tag} (0) K1 [{m} x {k}] @ [{k} x {n}]"))
    routes = {r: opope_gemm.launches_by_route[r] - before[r] for r in before}
    log(f"{tag} (0) K1 at {len(weights)} weight shapes {sorted(weights)} x M = {A8C_ROWS}, 128: "
        f"max|err| {err:.4g} against its plain version (within one bf16 ulp); by route {routes}")
    return err, routes, sorted(weights)


def a8c_family_phase(torch, np, cfg, ops, ep, k4, dev, tag):
    """Phase 16 for one family of ROADMAP A.8c on weights drawn from seed 0:
    (0) K1 at the family's weight shapes against its plain version
    (:func:`a8c_k1_shapes`); (i) the all-layer prefill logits through the
    kernels against the plain backend under 14(i)'s same-run floor
    (:func:`_prefill_floor_gate`: jamba's routing replayed, its routing
    agreement held as 6(a)'s, the free-running share pooled); (ii)
    the continuous engine on 4(b)'s Poisson trace with exact-length buckets,
    constructed with ``prefill_chunk`` set: the warning and both prompt-side
    features off are required, every K1 and K4 launch counted by route;
    (iii) the prefill-to-decode handoff: the static engine, A8C_ROWS rows of
    A8C_PROMPT-token prompts and A8C_STEPS decode steps, its logits
    teacher-forced against one full forward over prompt and tokens fed
    within PROMPT_LOGIT_FLOOR_FACTOR x the kernels-vs-plain-GEMM RMS of that
    forward (4(f)'s floor); jamba with ``moe.dropless`` here alone (capacity
    dropping depends on the batch's token count) and the full forward on
    the engine's routing; (iv) the prefill's time, a profiled decode step
    and the peak device memory. Returns the record and the weights."""
    import dataclasses

    from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.serve import ContinuousEngine, ServeEngine, poisson_trace
    from repro_torch.serve import engine as engine_mod

    moe, kern4, cuda_be = cfg.moe, k4.opope_gemm_grouped, ops.backend("cuda")
    per = a8c_launches(cfg, "decode")  # a prefill's are the same without q8
    params, rec = _family_params(torch, api, cfg, dev, tag)
    err, routes0, shapes0 = a8c_k1_shapes(torch, cfg, params, dev, tag)
    rec["k1_shapes"] = {"max_abs_err": err, "launches_by_route": routes0,
                        "shapes": [list(x) for x in shapes0]}
    rng = np.random.default_rng(0)
    _prefill_floor_gate(torch, rng, cfg, params, ops, ep, dev, tag, rec)

    # (ii) the continuous engine: exact buckets, the prompt-side features off.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        eng = ContinuousEngine(cfg=cfg, params=params, n_slots=4, max_len=256, prefill_chunk=32)
    msgs = [str(w.message) for w in caught]
    for m in msgs:
        log(f"{tag} (ii) warning: {m}")
    if (not any("attention-only" in m for m in msgs) or eng.prefill_chunk is not None
            or eng.prefix_cache):
        raise AssertionError(f"{tag} (ii) chunked prefill and the prefix cache must be turned "
                             f"off with a warning: {msgs}, chunk {eng.prefill_chunk}, prefix "
                             f"cache {eng.prefix_cache}")
    eng.serve(poisson_trace(2, seed=1, vocab=cfg.vocab, prompt_lens=(32,), gen_lens=(4,)))
    trace = poisson_trace(8, seed=0, vocab=cfg.vocab, prompt_lens=(32, 64, 128),
                          gen_lens=(8, 16, 32))
    _reset_k1(ops, opope_gemm)
    kern4.launches = 0
    kern4.launches_by_route.update(sm90=0, tile=0)
    plain = ops.backend("torch")
    report = eng.timed_serve(trace)
    launches = {"K1": opope_gemm.launches, "K4": kern4.launches}
    forwards = report.decode_steps + report.prefill_batches
    want = {"K1": per["K1"] * forwards, "K4": per["K4"] * forwards}
    if launches != want or plain.calls or plain.grouped_calls:
        raise AssertionError(f"{tag} (ii) launches {launches} != {want} (plain calls "
                             f"{plain.calls}, {plain.grouped_calls} grouped)")
    _valid_outputs(report, trace, cfg.vocab, f"{tag} (ii)")
    routes = {"K1": dict(opope_gemm.launches_by_route), "K4": dict(kern4.launches_by_route)}
    rec["serve"] = {"requests": len(trace), "generated_tokens": report.generated_tokens,
                    "decode_steps": report.decode_steps,
                    "prefill_batches": report.prefill_batches, "wall_s": report.wall_time_s,
                    "tokens_per_s": report.tokens_per_sec, "ttft_p50_s": report.ttft_p50,
                    "itl_p50_s": report.itl_p50, "launches": launches,
                    "launches_by_route": routes, "warnings": msgs,
                    "kv_bytes_per_slot": report.kv_bytes_per_slot}
    log(f"{tag} (ii) continuous, exact-length buckets, chunked prefill and prefix cache off: "
        f"{len(trace)} requests, {report.generated_tokens} tokens, decode_steps "
        f"{report.decode_steps}, prefill_batches {report.prefill_batches}, wall "
        f"{report.wall_time_s:.3f} s, {report.tokens_per_sec:.1f} tokens/s, TTFT p50 "
        f"{report.ttft_p50 * 1e3:.1f} ms, ITL p50 {report.itl_p50 * 1e3:.1f} ms (host-issue "
        f"times); launches K1 {launches['K1']} = {per['K1']} x {forwards} forwards"
        + (f", K4 {launches['K4']} = {per['K4']} x {forwards}" if moe else "")
        + f"; by route {routes if moe else routes['K1']}; K/V bytes a slot "
        f"{report.kv_bytes_per_slot:.0f}")
    del eng

    # (iii) the handoff: the static engine's logits against one full forward.
    gcfg = dataclasses.replace(cfg, moe=dataclasses.replace(moe, dropless=True)) if moe else cfg
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (A8C_ROWS, A8C_PROMPT))).to(dev)
    n_tok = A8C_STEPS + 1
    eng = ServeEngine(cfg=gcfg, params=params, max_len=A8C_PROMPT + n_tok)
    eng.generate({"tokens": prompts[:, :8]}, 2)  # warm-up
    seen, engine_routes = [], {}
    real_sample, real_route = engine_mod.sample_token, moe_mod._route

    def sampling(logits, generator=None, temperature=0.0):
        seen.append(logits.float())
        return real_sample(logits, generator, temperature)

    def routing(p, xf, top_k, backend=None):
        out = real_route(p, xf, top_k, backend)
        engine_routes.setdefault(p["router"].data_ptr(), []).append(out[2])
        return out

    _reset_k1(ops, opope_gemm)
    kern4.launches = 0
    kern4.launches_by_route.update(sm90=0, tile=0)
    sync(torch, dev)
    t0 = time.perf_counter()
    with _patched(engine_mod, "sample_token", sampling), _patched(moe_mod, "_route", routing):
        toks = eng.generate({"tokens": prompts}, n_tok)
    toks_host = toks.cpu()
    serve_s = time.perf_counter() - t0
    launches3 = {"K1": opope_gemm.launches, "K4": kern4.launches}
    want3 = {k: per[k] * n_tok for k in ("K1", "K4")}
    if launches3 != want3:
        raise AssertionError(f"{tag} (iii) launches {launches3} != {want3}")
    routes3 = {"K1": dict(opope_gemm.launches_by_route), "K4": dict(kern4.launches_by_route)}
    if tuple(toks_host.shape) != (A8C_ROWS, n_tok) or not (
            (toks_host >= 0) & (toks_host < cfg.vocab)).all():
        raise AssertionError(f"{tag} (iii) engine output {tuple(toks_host.shape)}")
    engine_logits = torch.stack(seen, dim=1)  # [B, n_tok, V]
    fed = torch.cat([prompts, toks[:, :-1]], dim=1)  # [B, prompt + steps]
    # The engine's routing of every position of ``fed``, per MoE layer: the
    # prefill's rows, then one row a decode step.
    forced = {ptr: torch.cat([calls[0].reshape(A8C_ROWS, A8C_PROMPT, -1)]
                             + [c.reshape(A8C_ROWS, 1, -1) for c in calls[1:]], dim=1)
              .reshape(A8C_ROWS * fed.shape[1], -1) for ptr, calls in engine_routes.items()}
    free = []

    def replay(p, xf, top_k, backend=None):
        gates, _, idx = real_route(p, xf, top_k, backend)
        free.append((idx, forced[p["router"].data_ptr()]))
        top_vals = torch.gather(gates, 1, forced[p["router"].data_ptr()])
        return (gates, top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9),
                forced[p["router"].data_ptr()])

    def full_logits():
        with torch.inference_mode(), _patched(moe_mod, "_route", replay):
            hidden, _, _ = transformer.lm_forward(params, fed, gcfg, mode="prefill")
            return transformer.lm_logits(params, hidden[:, -n_tok:], gcfg)

    full = full_logits()
    with _patched(cuda_be, "fn", opope_gemm_plain), \
            _patched(cuda_be, "grouped_fn", k4.opope_gemm_grouped_plain):
        full_plain = full_logits()
    d_floor, d_tf = _rms(full_plain - full), _rms(engine_logits - full)
    agree = (engine_logits.argmax(-1) == full.argmax(-1)).float().mean().item()
    route_agree = (_agreement(torch.stack([a for a, _ in free[:len(forced)]]),
                              torch.stack([b for _, b in free[:len(forced)]])).mean().item()
                   if moe else None)
    rec["handoff"] = {"rows": A8C_ROWS, "prompt": A8C_PROMPT, "decode_steps": A8C_STEPS,
                      "wall_s": serve_s, "launches": launches3, "launches_by_route": routes3,
                      "dropless": bool(moe), "rms_engine_vs_full_forward": d_tf,
                      "rms_kernels_vs_plain_full_forward": d_floor, "argmax_agreement": agree,
                      "full_forward_free_routing_agreement": route_agree}
    log(f"{tag} (iii) handoff: static engine, {A8C_ROWS} rows x {A8C_PROMPT}-token prompts, "
        f"prefill then {A8C_STEPS} decode steps in {serve_s:.3f} s"
        + (" (moe.dropless=True for this gate alone: capacity dropping depends on the "
           "batch's token count; the full forward on the engine's routing, its own router "
           f"agreeing on {route_agree:.5f})" if moe else "")
        + f"; K1 {launches3['K1']} = {per['K1']} x {n_tok}"
        + (f", K4 {launches3['K4']} = {per['K4']} x {n_tok}" if moe else "")
        + f" launches (by route {routes3 if moe else routes3['K1']}); teacher-forced logits vs "
        f"one full forward over the prompt and the {A8C_STEPS} tokens fed: RMS {d_tf:.4g} (gated "
        f"<= {PROMPT_LOGIT_FLOOR_FACTOR} x {d_floor:.4g}, the plain GEMMs vs the kernels on "
        f"that forward), argmax agreement {agree:.4f}")
    if not (torch.isfinite(engine_logits).all() and d_tf <= PROMPT_LOGIT_FLOOR_FACTOR * d_floor):
        raise AssertionError(f"{tag} (iii) teacher-forced logits RMS {d_tf} > "
                             f"{PROMPT_LOGIT_FLOOR_FACTOR} x {d_floor}")
    del seen, engine_logits, full, full_plain, eng, engine_routes, forced, free

    # (iv) the 4-row prefill's time, then a decode step's wall and device time.
    with torch.inference_mode():
        sync(torch, dev)
        t0 = time.perf_counter()
        logits, caches = api.prefill(cfg, params, {"tokens": prompts}, A8C_PROMPT + 16)
        sync(torch, dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits.argmax(-1)[:, None]
    del logits
    kernels = ("k1", "k4") if moe else ("k1",)
    step_ms, dev_ms, bound_ms = _decode_step_times(
        torch, dev, lambda c, pos: api.decode(cfg, params, tok, c, pos)[1], caches, A8C_PROMPT,
        _gemm_weights(params["blocks"]), tag, kernels=kernels, required=kernels)
    del caches
    rec["prefill_ms"] = prefill_ms
    rec["decode_step"] = {"rows": A8C_ROWS, "wall_ms": step_ms, "device_ms": dev_ms,
                          "byte_bound_ms": bound_ms, "launches": {k: per[k] for k in ("K1", "K4")}}
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag} (iv) prefill {A8C_ROWS} x {A8C_PROMPT}: {prefill_ms:.2f} ms wall; decode step, "
        f"{A8C_ROWS} rows: {step_ms:.3f} ms wall"
        + ("" if dev_ms is None else
           f"; device busy {dev_ms['busy']:.3f} ms ({100 * dev_ms['busy'] / step_ms:.1f}%), K1 "
           f"{dev_ms['k1']:.3f} ms ({per['K1']} launches, byte bound {bound_ms['k1']:.3f} ms)"
           + (f", K4 {dev_ms['k4']:.3f} ms ({per['K4']} launches, byte bound "
              f"{bound_ms['k4']:.3f} ms)" if moe else ""))
        + f"; peak device memory of (i)-(iv) {rec['peak_memory_gb']:.2f} GB")
    return rec, params


def a8c_phase(torch, np, get_config, ops, ep, k4mod, q8mod, q8b, qz, kernels, dev):
    """Phase 16 (ROADMAP A.8c): (a) jamba-v0.1-52b cut to
    JAMBA_SERVE_LAYERS layers and (b) xlstm-125m uncut, one at a time, each
    freed before the next, through :func:`a8c_family_phase`; jamba also
    (a)(v) K4 and K5 at its expert GEMMs (:func:`expert_gemm_phase`, G 16,
    at JAMBA_EXPERT_MS rows) and (a)(vi) phase 8 under ``{"moe": "q8",
    "mixer": "q8"}`` (:func:`q8_model_phase`, launches by
    :func:`a8c_launches`); then (c) each family's loss and gradients
    (:func:`a8b_loss_phase`): jamba cut to its first JAMBA_GRAD_LAYERS
    layers (one of each block kind of its period), xlstm uncut. Returns
    the records."""
    import dataclasses

    t_phase = time.perf_counter()
    out = {}
    for letter, name in zip("ab", A8C_FAMILIES):
        tag = f"16({letter}) {name}"
        t0 = time.perf_counter()
        cfg = get_config(name)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, n_layers=JAMBA_SERVE_LAYERS)
        rec, params = a8c_family_phase(torch, np, cfg, ops, ep, k4mod, dev, tag)
        if cfg.moe is not None:
            rec["experts"] = expert_gemm_phase(torch, k4mod, q8mod, q8b, ep, cfg, params, dev,
                                               f"{tag} (v)", expert_rows=JAMBA_EXPERT_MS, layer=1)
            rec["q8"] = q8_model_phase(
                torch, np, cfg, params, qz.PrecisionPolicy(rules={"moe": "q8", "mixer": "q8"}),
                qz.PrecisionPolicy(rules={"moe": "torch_q8", "mixer": "torch_q8"},
                                   default="torch"),
                lambda kind, c=cfg: a8c_launches(c, kind, q8=True), ops, ep, kernels, dev,
                f"{tag} (vi) q8")
        rec["phase_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["seconds"] = time.perf_counter() - t0
        log(f"{tag}: peak device memory {rec['phase_peak_memory_gb']:.2f} GB over the family's "
            f"phase; {rec['seconds']:.1f} s")
        del params
        out[name] = rec
    out["loss"] = {}
    for name in A8C_FAMILIES:
        cfg = get_config(name)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, pattern=cfg.pattern[:JAMBA_GRAD_LAYERS],
                                      n_layers=JAMBA_GRAD_LAYERS)
        out["loss"][name] = a8b_loss_phase(torch, np, cfg, ops, ep, dev, f"16(c) {name}",
                                           batch=A8C_LOSS_ROWS, prompt=A8C_PROMPT)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16 took {out['seconds']:.1f} s")
    return out


def a8c_launch_paths(rec):
    """Each GEMM kernel's phase-16 launches by path and route."""
    paths = {"K1": {}, "K4": {}, "K2": {}, "K5": {}}
    for name in A8C_FAMILIES:
        r = rec[name]
        for what, routes in (("prefill gate (16(i))", r["prefill"]["launches_by_route"]),
                             ("continuous engine (16(ii))", r["serve"]["launches_by_route"]),
                             ("static engine (16(iii))", r["handoff"]["launches_by_route"])):
            for kname, by_route in routes.items():
                if sum(by_route.values()):
                    paths[kname][f"{name} {what}"] = by_route
        for kname, n in r.get("q8", {}).get("launches", {}).items():
            if n:  # phase 8 held each to the sm90 route
                paths[kname][f"{name} q8 (16(vi))"] = {"sm90": n, "tile": 0}
        loss = rec["loss"][name]
        for kname, key in (("K1", "launches_by_route"), ("K4", "k4_launches_by_route")):
            if sum(loss[key].values()):
                paths[kname][f"{name} loss ({loss['layers']} layers, 16(c))"] = loss[key]
    return paths


# Phase 17 (ROADMAP B.1): every input dtype the reference's kernels take.
# (a) chatglm3-6b in fp16 at its published width and depth (28 layers,
# 6.24 B parameters, 12.49 GB); (b) deepseek-moe-16b in fp16 cut to
# DTYPE_MOE_LAYERS of its 28 layers (every layer is MoE, so the expert GEMMs
# keep their widths at any depth); both through family_phase, K/V in bf16
# (the reference launcher's rule). (c) each kernel alone on each dtype
# class at the models' shapes, against its plain version, beside its bound
# and, where one PyTorch call computes the same function, that call.
DTYPE_MOE_LAYERS = 4
FP8_FLOPS = 1979e12  # H100 SXM dense fp8 tensor cores
# K1's (A, B) cases: fp16 (the sm90 route), the two 8-bit floats, and one
# mixed pair of each compute class (bf16, fp16 with bf16 in fp32, fp32).
K1_DTYPE_CASES = (("float16", "float16"), ("float8_e4m3fn", "float8_e4m3fn"),
                  ("float8_e5m2", "float8_e5m2"), ("float8_e4m3fn", "bfloat16"),
                  ("float16", "bfloat16"), ("float32", "bfloat16"))
K1_DTYPE_MS = (4, 512)
K4_DTYPE_CASES = ("float16", "float8_e4m3fn")
K4_DTYPE_MS = (1, 60)
K3_DTYPE_CASES = ("float16", "bfloat16", "float32", "float8_e4m3fn")
K3_DTYPE_DIMS = (80, 256, 320)
K3_DTYPE_SHAPE = (4, 16, 2048)  # B, H, S = T, causal: gemma2-9b's attention at D 256
K6_DTYPE_CASES = ("float16", "float8_e4m3fn")
DTYPE_ITERS = 10


def dtype_peak(torch, *dtypes):
    """The card's dense rate for products of these operands: two 8-bit
    floats at the fp8 tensor-core rate, any fp32 operand at the fp32 rate
    outside the tensor cores, the rest (bf16, fp16, mixed) at bf16's."""
    fp8 = (torch.float8_e4m3fn, torch.float8_e5m2)
    if all(d in fp8 for d in dtypes):
        return FP8_FLOPS
    return FP32_FLOPS if torch.float32 in dtypes else BF16_FLOPS


def _bound(t_bytes, ops, peak):
    t_bytes, t_ops = t_bytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _counted(torch, kern, fn):
    """``fn()`` and the launches of ``kern`` it made, by route."""
    before = dict(kern.launches_by_route)
    out = fn()
    torch.cuda.synchronize()
    return out, {r: kern.launches_by_route[r] - before[r] for r in before}


def _add_routes(total, routes):
    for r, n in routes.items():
        total[r] = total.get(r, 0) + n


def _library(torch, fn, what):
    """Device ms of one PyTorch call computing the same function, or None
    with the reason where it does not take the call."""
    try:
        fn(0)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, ValueError) as e:
        return None, f"{what}: does not take the call ({str(e).splitlines()[0][:120]})"
    return queued_ms(torch, fn, DTYPE_ITERS), what


def dtype_kernel_phase(torch, F, k4mod, kscan, cfg, mcfg, jcfg, dev):
    """17(c): K1, K4, K3 and K6 on the card on each new dtype class, at the
    models' shapes, each call held to its plain version at its phase's gate
    (K1, K4: check_close; K3: attn_check; K6 bitwise), an e4m3-out K1 call
    whose sums overflow held bit for bit, NaNs included. Returns the rows
    and each kernel's entry-point launches by route."""
    import importlib

    from repro_torch.kernels.opope_attention import opope_attention_bhsd, opope_attention_plain
    from repro_torch.kernels.opope_gemm import opope_gemm, opope_gemm_plain

    k1mod = importlib.import_module("repro_torch.kernels.opope_gemm")
    k3mod = importlib.import_module("repro_torch.kernels.opope_attention")
    k4 = k4mod.opope_gemm_grouped
    gen = torch.Generator(device=dev).manual_seed(17)
    dt = lambda name: getattr(torch, name)  # noqa: E731
    out = {"k1": [], "k1_layers": [], "k4": [], "k3": [], "k6": []}
    entry = {"K1": {}, "K4": {}, "K3": {}, "K6": 0}
    max_err = {"K1": 0.0, "K4": 0.0, "K3": 0.0}
    t0 = time.perf_counter()

    d, dq, dkv, dff = cfg.d_model, cfg.n_heads * cfg.head_dim_, cfg.n_kv * cfg.head_dim_, cfg.d_ff
    layer = [("wq", d, dq, ()), ("wk", d, dkv, ()), ("wv", d, dkv, ()),
             ("wo", dq, d, ("residual",)), ("w_up", d, dff, ()),
             ("w_gate", d, dff, ("silu", "mul")), ("w_down", dff, d, ("residual",))]
    for a_name, b_name in K1_DTYPE_CASES:
        adt, bdt = dt(a_name), dt(b_name)
        for m in K1_DTYPE_MS:
            sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
            lib_what, routes = None, {}
            for gname, kk, n, steps in layer:
                n_bufs = max(1, min(64, math.ceil(3 * L2_BYTES / (kk * n * bdt.itemsize))))
                a = torch.randn((m, kk), generator=gen, device=dev).to(adt)
                bs = [(torch.randn((kk, n), generator=gen, device=dev) * kk ** -0.5).to(bdt)
                      for _ in range(n_bufs)]
                ops_ = tuple(torch.randn((m, n), generator=gen, device=dev).to(adt)
                             for _ in steps if _ != "silu")
                got, r = _counted(torch, opope_gemm, lambda: opope_gemm(
                    a, bs[0], None, epilogue=steps, epilogue_operands=ops_))
                _add_routes(routes, r)
                what = f"17(c) K1 {a_name}@{b_name} {gname} M={m} K={kk} N={n}"
                err = check_close(torch, got, k1_plain(a, bs[0], None, steps, ops_), adt, what)
                max_err["K1"] = max(max_err["K1"], err)
                ms = queued_ms(torch, lambda i: opope_gemm(
                    a, bs[i % n_bufs], None, epilogue=steps, epilogue_operands=ops_),
                    max(DTYPE_ITERS, n_bufs))
                plain_ms = time_ms(torch, lambda i: opope_gemm_plain(
                    a, bs[i], None, epilogue=steps, epilogue_operands=ops_), n_bufs)
                lib_ms = None
                if a_name == b_name == "float16":
                    lib_ms, lib_what = _library(
                        torch, lambda i: torch.matmul(a, bs[i % n_bufs]), "torch.matmul")
                elif a_name == b_name == "float8_e4m3fn" or a_name == b_name == "float8_e5m2":
                    one = torch.ones((), device=dev)
                    cms = [b.t().contiguous().t() for b in bs]  # the column-major B it needs
                    lib_ms, lib_what = _library(torch, lambda i: torch._scaled_mm(
                        a, cms[i % n_bufs], scale_a=one, scale_b=one, out_dtype=torch.bfloat16),
                        "torch._scaled_mm, unit scales, bf16 out")
                    del cms
                nbytes = (adt.itemsize * m * kk + bdt.itemsize * kk * n
                          + adt.itemsize * m * n * (1 + len(ops_)))
                bound_ms, bound_by = _bound(nbytes, 2 * m * n * kk, dtype_peak(torch, adt, bdt))
                route = k1mod._plan(m, n, kk, k1mod.plan_dtype(adt, bdt), a.data_ptr(),
                                    bs[0].data_ptr()).route
                out["k1"].append({"a": a_name, "b": b_name, "gemm": gname, "m": m, "k": kk,
                                  "n": n, "epilogue": "+".join(steps) or "none", "route": route,
                                  "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by,
                                  "max_abs_err": err})
                for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                    sums[key] += v
                if sums["library_ms"] is not None:
                    sums["library_ms"] = None if lib_ms is None else sums["library_ms"] + lib_ms
                del a, bs, ops_, got
            _add_routes(entry["K1"].setdefault(f"{a_name}@{b_name}", {}), routes)
            out["k1_layers"].append(dict(sums, a=a_name, b=b_name, m=m, routes=routes,
                                         library=lib_what or "none"))
            log(f"17(c) K1 {a_name}@{b_name}, chatglm3-6b's 7 layer GEMMs at M={m} "
                f"(routes {routes}): kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} "
                f"ms, library {sums['library_ms']} ms ({lib_what or 'none'}), bound "
                f"{sums['bound_ms']:.4f} ms")

    # The e4m3 cast past 448: sums of 448, 464, 468 and 512 on both K1
    # routes' dtype classes, bit for bit against the plain version.
    x = torch.zeros((4, 128), device=dev)
    for i, count in enumerate((112, 116, 117, 128)):
        x[i, :count] = 4.0
    x = x.to(torch.float8_e4m3fn)
    for b_name in ("float8_e4m3fn", "bfloat16"):
        y = torch.ones((128, 64), device=dev).to(dt(b_name))
        got, r = _counted(torch, opope_gemm, lambda: opope_gemm(x, y))
        _add_routes(entry["K1"].setdefault("e4m3 overflow", {}), r)
        want = opope_gemm_plain(x, y)
        vals = got.float()[:, 0].tolist()
        if not (torch.equal(got.view(torch.uint8), want.view(torch.uint8))
                and vals[:2] == [448.0, 448.0] and all(v != v for v in vals[2:])):
            raise AssertionError(f"17(c) K1 e4m3 out past 448 (B {b_name}): {vals} against "
                                 f"the plain version's {want.float()[:, 0].tolist()}")
    log("17(c) K1 e4m3 out of sums 448, 464, 468, 512: 448, 448, NaN, NaN, bit for bit with "
        "the plain version (B e4m3 and bf16)")

    g, md, f = mcfg.moe.n_experts, mcfg.d_model, mcfg.moe.d_ff_expert
    ffn = [("w_up", md, f, (), None), ("w_gate", md, f, ("silu", "mul"), None),
           ("w_down", f, md, (), torch.float32)]
    for a_name in K4_DTYPE_CASES:
        adt = dt(a_name)
        for m in K4_DTYPE_MS:
            routes = {}
            for gname, kk, n, steps, out_dtype in ffn:
                a = torch.randn((g, m, kk), generator=gen, device=dev).to(adt)
                b = (torch.randn((g, kk, n), generator=gen, device=dev) * kk ** -0.5).to(adt)
                ops_ = tuple(torch.randn((g, m, n), generator=gen, device=dev).to(adt)
                             for _ in steps if _ != "silu")
                odt = out_dtype or adt
                got, r = _counted(torch, k4, lambda: k4(a, b, out_dtype=odt, epilogue=steps,
                                                 epilogue_operands=ops_))
                _add_routes(routes, r)
                what = f"17(c) K4 {a_name} {gname} G={g} M={m} K={kk} N={n}"
                err = check_close(torch, got, k4_plain(k4mod, a, b, None, steps, ops_), odt, what)
                max_err["K4"] = max(max_err["K4"], err)
                ms = queued_ms(torch, lambda i: k4(a, b, out_dtype=odt, epilogue=steps,
                                                   epilogue_operands=ops_), DTYPE_ITERS)
                plain_ms = time_ms(torch, lambda i: k4mod.opope_gemm_grouped_plain(
                    a, b, out_dtype=odt, epilogue=steps, epilogue_operands=ops_), 1)
                lib_ms, lib_what = (None, "none: no PyTorch call takes grouped e4m3 operands")
                if a_name == "float16":
                    lib_ms, lib_what = _library(torch, lambda i: torch.bmm(a, b), "torch.bmm")
                nbytes = (adt.itemsize * g * (m * kk + kk * n + m * n * len(ops_))
                          + odt.itemsize * g * m * n)
                bound_ms, bound_by = _bound(nbytes, 2 * g * m * n * kk, dtype_peak(torch, adt))
                out["k4"].append({"a": a_name, "gemm": gname, "g": g, "m": m, "k": kk, "n": n,
                                  "out_dtype": str(odt).removeprefix("torch."),
                                  "routes": r, "ms": ms, "plain_ms": plain_ms,
                                  "library_ms": lib_ms, "library": lib_what,
                                  "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err})
                log(f"{what}: routes {r}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"library {lib_ms} ms ({lib_what}), bound {bound_ms:.4f} ms ({bound_by}), "
                    f"max_abs_err {err:.3g}")
                del a, b, ops_, got
            _add_routes(entry["K4"].setdefault(a_name, {}), routes)

    b_, h_, s_ = K3_DTYPE_SHAPE
    for name in K3_DTYPE_CASES:
        qdt = dt(name)
        for dd in K3_DTYPE_DIMS:
            q, k, v = (torch.randn((b_, h_, s_, dd), generator=gen, device=dev).to(qdt)
                       for _ in range(3))
            got, r = _counted(torch, k3mod.opope_attention, lambda: opope_attention_bhsd(q, k, v))
            _add_routes(entry["K3"].setdefault(name, {}), r)
            what = f"17(c) K3 {name} B={b_} H={h_} S=T={s_} D={dd} causal"
            want = opope_attention_plain(q, k, v)
            err, rel_rms = attn_check(torch, got, want, what)
            max_err["K3"] = max(max_err["K3"], err)
            del want
            ms = queued_ms(torch, lambda i: opope_attention_bhsd(q, k, v), 3, warmup=1)
            plain_ms = time_ms(torch, lambda i: opope_attention_plain(q, k, v), 1, iters=2,
                               warmup=1)
            lib_ms, lib_what = None, "none: SDPA takes no 8-bit float"
            if qdt != torch.float8_e4m3fn:
                lib_ms, lib_what = _library(torch, lambda i: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), "torch.nn.functional.scaled_dot_product_attention")
            nbytes = qdt.itemsize * b_ * h_ * 4 * s_ * dd
            bound_ms, bound_by = _bound(nbytes, attn_flops(b_, h_, s_, s_, dd, True),
                                        dtype_peak(torch, qdt))
            out["k3"].append({"dtype": name, "b": b_, "h": h_, "s": s_, "t": s_, "d": dd,
                              "causal": True, "routes": r, "ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "library": lib_what, "bound_ms": bound_ms,
                              "bound_by": bound_by, "max_abs_err": err,
                              "err_rms_over_out_rms": rel_rms})
            log(f"{what}: routes {r}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{lib_ms} ms ({lib_what}), bound {bound_ms:.4f} ms ({bound_by}), max_abs_err "
                f"{err:.3g}, error RMS {rel_rms:.3g} of the output's")
            del q, k, v, got

    s_scan, n_state = 4096, jcfg.mamba.expand * jcfg.d_model * jcfg.mamba.d_state
    for name in K6_DTYPE_CASES:
        sdt = dt(name)
        decay = (0.2 + 0.79 * torch.rand((s_scan, n_state), generator=gen, device=dev)).to(sdt)
        update = torch.randn((s_scan, n_state), generator=gen, device=dev).to(sdt)
        before = kscan.opope_chunked_scan.launches
        states = kscan.opope_chunked_scan(decay, update)
        sync(torch, dev)
        entry["K6"] += kscan.opope_chunked_scan.launches - before
        t_plain = time.perf_counter()
        want = kscan.opope_chunked_scan_plain(decay, update)
        sync(torch, dev)
        plain_ms = 1e3 * (time.perf_counter() - t_plain)
        if not torch.equal(states, want):
            raise AssertionError(f"17(c) K6 {name} [{s_scan}, {n_state}]: "
                                 f"{(states != want).sum().item()} states differ (bitwise gate)")
        del want
        ms = time_ms(torch, lambda i: kscan.opope_chunked_scan(decay, update), 1)
        bound_ms = 1e3 * (2 * sdt.itemsize + 4) * s_scan * n_state / HBM_BYTES_PER_S
        out["k6"].append({"dtype": name, "s": s_scan, "d": n_state, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                          "library_ms": None, "max_abs_err": 0.0})
        log(f"17(c) K6 {name} decay and update [{s_scan}, {n_state}]: bitwise equal to the "
            f"plain version; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms (one call, host "
            f"clock), bound {bound_ms:.4f} ms (bytes)")
        del decay, update, states
    out["entry_launches"] = entry
    out["max_abs_err"] = max_err
    out["seconds"] = time.perf_counter() - t0
    log(f"17(c) took {out['seconds']:.1f} s; entry-point launches by route {entry}")
    return out


def dtype_phase(torch, np, get_config, ops, ep, k4mod, kscan, F, dev):
    """Phase 17 (ROADMAP B.1): (a) chatglm3-6b in fp16 uncut and (b)
    deepseek-moe-16b in fp16 at DTYPE_MOE_LAYERS layers through
    :func:`family_phase` ((b) without the profiled step), every K1 and K4
    launch of their prefill gates and engines on the sm90 route; then (c)
    :func:`dtype_kernel_phase`. Returns the records."""
    import dataclasses

    t_phase = time.perf_counter()
    out = {}
    for letter, name in zip("ab", ("chatglm3-6b", "deepseek-moe-16b")):
        tag = f"17({letter}) {name} fp16"
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), param_dtype="float16")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, n_layers=DTYPE_MOE_LAYERS)
        rec, params = family_phase(torch, np, cfg, ops, ep, k4mod, dev, tag,
                                   decode_step=cfg.moe is None)
        for kname, routes in rec["prefill"]["launches_by_route"].items():
            if routes["tile"]:
                raise AssertionError(f"{tag} (i) {kname} launches by route {routes}: want all "
                                     "on sm90")
        rec["seconds"] = time.perf_counter() - t0
        log(f"{tag}: {rec['seconds']:.1f} s, peak device memory {rec['peak_memory_gb']:.2f} GB")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = rec
    out["kernels"] = dtype_kernel_phase(torch, F, k4mod, kscan, get_config("chatglm3-6b"),
                                        get_config("deepseek-moe-16b"),
                                        get_config("jamba-v0.1-52b"), dev)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 17 took {out['seconds']:.1f} s")
    return out


def dtype_launch_paths(rec):
    """Each kernel's phase-17 launches by path and route."""
    paths = {"K1": {}, "K4": {}, "K3": {}, "K6": {}}
    for name in ("chatglm3-6b", "deepseek-moe-16b"):
        r = rec[name]
        for kname, routes in r["prefill"]["launches_by_route"].items():
            if sum(routes.values()):
                paths[kname][f"{name} fp16 prefill gate (17(i))"] = routes
        for kname, n in r["serve"]["launches"].items():
            if n:  # family_phase held each to the sm90 route
                paths[kname][f"{name} fp16 continuous engine (17(ii))"] = {"sm90": n, "tile": 0}
    entry = rec["kernels"]["entry_launches"]
    for kname in ("K1", "K4", "K3"):
        for case, routes in entry[kname].items():
            paths[kname][f"kernels entry point, {case} (17(c))"] = routes
    paths["K6"]["kernels entry point, fp16 and e4m3 (17(c))"] = entry["K6"]
    return paths


def decode_profile(torch, step, step_ms, n_steps: int = 4, tag: str = "(d)",
                   what: str = "decode step"):
    """Device time by kernel over ``n_steps`` decode steps (torch.profiler),
    beside the steps' host wall time: the device's busy share (kernels run
    one at a time on the one stream) and the top kernels. Prints "not
    measured" and returns None when the trace holds no device time; else
    returns ``(key, ms per step, launches per step)`` rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    # Device-side events only: a CPU op's row repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total / 1e3 / n_steps, e.count // n_steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    if not rows:
        log(f"{tag} profiler: device time not measured (no device events in the trace)")
        return None
    log(f"{tag} profiled {what}: {wall_ms:.3f} ms host wall (unprofiled {step_ms:.3f} ms), "
        f"{busy_ms:.3f} ms device busy ({100 * busy_ms / wall_ms:.1f}%)")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"{tag}   {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config, shape_by_name
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import epilogue as ep
    from repro_torch.kernels import ops
    from repro_torch.kernels.opope_gemm import opope_gemm
    from repro_torch.kernels import opope_grouped as k4mod
    from repro_torch.kernels import opope_scan as kscan
    from repro_torch.models import attention as mattn
    import torch.nn.functional as F
    from repro_torch import quant as qz
    from repro_torch.quant import backends as q8b
    from repro_torch.quant import opope_q8 as q8mod

    smi = nvidia_smi()
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s together; per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(kbuild.BUILD_SECONDS.items())))
    for name, path in libs.items():
        entry = ""
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "registers" in line or "spill" in line:
                kernel = "sm90 " if "sm90" in entry else ""
                log(f"ptxas {name} {kernel}{entry[-60:]}: {line.strip()}")
                # K5's kernels are held to no spill.
                spilled = re.findall(r"(\d+) bytes spill", line)
                if name == "opope_q8_grouped" and any(int(x) for x in spilled):
                    raise AssertionError(f"ptxas: {entry} spills: {line.strip()}")

    cfg = get_config("chatglm3-6b")
    mcfg = get_config("deepseek-moe-16b")
    dev = torch.device("cuda")
    layer, rows, max_err = kernel_phase(torch, ep, cfg, mcfg, dev)
    res = model_phase(torch, np, cfg, ops, dev)
    _, prefix_eng = prompt_phase(torch, np, cfg, res["params"], ops, dev)
    telemetry_phase(torch, cfg, res["params"], ops, dev, prefix_eng)
    del prefix_eng
    # Phase 13 on the resident weights; it clears its table, so phases
    # 7-12 run on the heuristic plans.
    gc.collect()
    tune_record = tune_phase(torch, np, cfg, mcfg, res["params"], ops, dev)

    # One layer's 7 GEMMs of a 4-slot decode step (and of a 512-row
    # prefill), from the timed rows.
    by_key = {(r["m"], r["k"], r["n"], r["epilogue"]): r for r in rows if r["model"] == cfg.name}
    layer_sums = {}
    for m in K1_MS:
        m_rows = [by_key[(m, k, n, ch)] for _, k, n, ch in layer]
        layer_sums[m] = {key: sum(r[key] for r in m_rows) for key in (
            "ms", "event_ms", "tile_ms", "plain_ms", "library_ms", "bound_ms")}
        flops = sum(2 * m * n * k for _, k, n, _ in layer)
        log(f"K1 one chatglm3-6b layer at M={m}: sm90 {layer_sums[m]['ms']:.4f} ms device "
            f"({flops / layer_sums[m]['ms'] / 1e9:.1f} TFLOP/s; {layer_sums[m]['event_ms']:.4f} "
            f"ms by CUDA events, host issue included), tile route "
            f"{layer_sums[m]['tile_ms']:.4f} ms, torch.matmul {layer_sums[m]['library_ms']:.4f} ms, "
            f"bound {layer_sums[m]['bound_ms']:.4f} ms")
    sums = layer_sums[4]

    def layer_bound_by(m):
        t_bytes = sum(2 * (m * k + k * n + m * n * (1 + (ch != "none"))) for _, k, n, ch in layer)
        t_ops = sum(2 * m * n * k for _, k, n, _ in layer)
        return "bytes" if t_bytes / HBM_BYTES_PER_S >= t_ops / BF16_FLOPS else "operations"
    gemm_ms_step = cfg.n_layers * sums["ms"]
    log(f"(d) lockstep decode step, 4 rows: {res['decode_step_ms']:.3f} ms wall; its "
        f"{7 * cfg.n_layers} GEMMs take {gemm_ms_step:.3f} ms on the kernel "
        f"(cold-L2 timings above; bound {cfg.n_layers * sums['bound_ms']:.3f} ms)")
    # Phases 7 and 8 on chatglm3-6b's weights: the int8 kernels at both
    # models' shapes, then chatglm3-6b under mlp_q8_policy().
    q8_rows, q8_errs, k5_cov = q8_kernel_phase(torch, q8mod, qz, q8b, k4mod, ep, cfg, mcfg, dev)
    kernels = {"K1": opope_gemm, "K4": k4mod.opope_gemm_grouped,
               "K2": q8mod.opope_gemm_q8, "K5": q8mod.opope_gemm_q8_grouped}
    glm_q8 = q8_model_phase(
        torch, np, cfg, res.pop("params"), qz.mlp_q8_policy(),
        qz.PrecisionPolicy(rules={"mlp": "torch_q8", "moe": "torch_q8"}, default="torch"),
        every_layer({"K1": 4, "K2": 3}, cfg.n_layers), ops, ep, kernels, dev,
        "8 chatglm3-6b q8", audit=True)
    # Free chatglm3-6b before deepseek-moe-16b's 33 GB are drawn.
    gc.collect()
    torch.cuda.empty_cache()
    log(f"allocated after chatglm3-6b: {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    ffn, g_rows, g_err, g_cov = grouped_phase(torch, k4mod, ops, ep, mcfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    mres = moe_phase(torch, np, mcfg, ops, ep, k4mod, dev)
    ds_q8 = q8_model_phase(
        torch, np, mcfg, mres.pop("params"), qz.PrecisionPolicy(rules={"moe": "q8"}),
        qz.PrecisionPolicy(rules={"moe": "torch_q8"}, default="torch"),
        every_layer({"K1": 5, "K2": 3, "K5": 3}, mcfg.n_layers), ops, ep, kernels, dev,
        "8 deepseek-moe-16b q8")
    # Phase 9 after deepseek-moe-16b's weights are freed: K3 and K6.
    gc.collect()
    torch.cuda.empty_cache()
    log(f"allocated after deepseek-moe-16b: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    k3_record, k6_record = attention_scan_phase(
        torch, F, kscan, mattn, cfg, get_config("jamba-v0.1-52b"),
        shape_by_name("prefill_32k"), dev)
    # Phase 10: training chatglm3-6b on K1, cut to TRAIN_LAYERS layers.
    gc.collect()
    torch.cuda.empty_cache()
    train_record = train_phase(torch, np, cfg, ops, ep, dev)
    # Phase 11: MoE training, deepseek-moe-16b cut to MOE_TRAIN_LAYERS layers.
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = moe_train_phase(torch, np, mcfg, ops, ep, k4mod, dev)
    # Phase 12: q8 training (K2, K5 forward; K1, K4 backward), then
    # checkpoints, resume and serving from a checkpoint.
    gc.collect()
    torch.cuda.empty_cache()
    q8_train = q8_train_phase(torch, cfg, mcfg, ops, ep, q8mod, k4mod, qz, q8b, dev)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_record = checkpoint_phase(torch, cfg, dev)
    train_record["cli"] = ckpt_record["cli"][0]  # 10(c): 12(e)'s first run
    # Phase 14: the families of ROADMAP A.8, one at a time.
    gc.collect()
    torch.cuda.empty_cache()
    fam = families_phase(torch, np, get_config, ops, ep, k4mod, q8mod, q8b, qz, kernels, dev)
    # Phase 15: llava-next-mistral-7b and whisper-base on the static engine.
    gc.collect()
    torch.cuda.empty_cache()
    a8b = a8b_phase(torch, np, get_config, ops, ep, dev)
    # Phase 16: jamba-v0.1-52b and xlstm-125m, served and their gradients.
    gc.collect()
    torch.cuda.empty_cache()
    a8c = a8c_phase(torch, np, get_config, ops, ep, k4mod, q8mod, q8b, qz, kernels, dev)
    # Phase 17: fp16 models, and every input dtype of K1, K4, K3 and K6.
    gc.collect()
    torch.cuda.empty_cache()
    p17 = dtype_phase(torch, np, get_config, ops, ep, k4mod, kscan, F, dev)
    # One MoE layer's 3 grouped GEMMs of a 4-slot decode step (capacity 1).
    g_decode = [r for r in g_rows if r["m"] == 1]
    g_sums = {key: sum(r[key] for r in g_decode)
              for key in ("ms", "tile_ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"(c) deepseek decode step: its {3 * mcfg.n_layers} grouped GEMMs take "
        f"{mcfg.n_layers * g_sums['ms']:.3f} ms on K4 (cold-L2 timings above; byte bound "
        f"{mcfg.n_layers * g_sums['bound_ms']:.3f} ms)")
    g_layers = {}
    for m in (1, 30, 60):
        m_rows = [r for r in g_rows if r["m"] == m]
        g_layers[m] = {key: sum(r[key] for r in m_rows)
                       for key in ("ms", "tile_ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"K4 deepseek's 3 expert GEMMs (G {mcfg.moe.n_experts}) at M={m}: sm90 "
            f"{g_layers[m]['ms']:.4f} ms, tile route {g_layers[m]['tile_ms']:.4f} ms, torch.bmm "
            f"{g_layers[m]['library_ms']:.4f} ms, bound {g_layers[m]['bound_ms']:.4f} ms (bytes "
            f"{g_layers[m]['bound_ms'] / g_layers[m]['ms']:.1%} of the kernel's time)")

    k1_paths = {cfg.name: res["launches"], mcfg.name: mres["launches"]["k1"],
                f"{cfg.name} q8": glm_q8["launches"]["K1"],
                f"{mcfg.name} q8": ds_q8["launches"]["K1"]}
    serve_launches = sum(k1_paths.values())
    k1_paths[f"{cfg.name} train ({TRAIN_LAYERS} layers)"] = train_record["launches"]
    k1_moe_train = moe_train["k1_launches_by_route"]
    k1_paths[f"{mcfg.name} train ({MOE_TRAIN_LAYERS} layers)"] = sum(k1_moe_train.values())
    # Phase 12's paths: each kernel's launches by route, held exact there.
    q8_paths = {f"{cfg.name} q8 train ({TRAIN_LAYERS} layers)": q8_train["dense"],
                f"{mcfg.name} q8 train ({Q8_MOE_TRAIN_LAYERS} layers)": q8_train["moe"]}
    p12_k1 = {path: r["launches_by_route"]["K1"] for path, r in q8_paths.items()}
    p12_k1[f"{cfg.name} checkpoint, resume and serve ({CKPT_LAYERS} layers)"] = \
        ckpt_record["k1_launches_by_route"]
    for path, routes in p12_k1.items():
        k1_paths[path] = sum(routes.values())
    record = {
        "name": "opope_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/opope_gemm.cu",
        "replaces": "src/repro/kernels/opope_gemm.py:293",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        # check_routes held every serving path's launches to the sm90 route;
        # phases 10(d) and 11(b) held training's to their exact split (the
        # fp32 backward GEMMs on the tile route).
        "launches_by_route": {r: (serve_launches if r == "sm90" else 0)
                              + train_record["launches_by_route"][r] + k1_moe_train[r]
                              + sum(x[r] for x in p12_k1.values()) for r in ("sm90", "tile")},
        "training": train_record,
        "q8_training_backward": {path: r["launches_by_route"]["K1"]
                                 for path, r in q8_paths.items()},
        "checkpoint": ckpt_record,
        "max_abs_err": max_err,
        "ms": sums["ms"],
        "tile_ms": sums["tile_ms"],
        "plain_ms": sums["plain_ms"],
        "bound_ms": sums["bound_ms"],
        "bound_by": layer_bound_by(4),
        "library_ms": sums["library_ms"],
        "work": "the 7 GEMMs of one chatglm3-6b layer in a 4-slot decode step on the sm90 "
                "route ('tile_ms': the same calls on the tile route; per-shape rows under "
                "'shapes'; the same layer at 64, 256 and 512 rows under 'layers')",
        "timing": "ms, tile_ms and library_ms: device time (CUDA events around calls queued "
                  "behind a sleeping kernel); event_ms and "
                  "plain_ms: CUDA events around the loop, the host's issue rate included",
        "layers": {str(m): v for m, v in layer_sums.items()},
        "prefill_layer": dict(layer_sums[512], m=512, bound_by=layer_bound_by(512)),
        "build_s": kbuild.BUILD_SECONDS.get("opope_gemm"),
        "decode_step_device_ms": {cfg.name: res["device_ms"],
                                  mcfg.name: mres["device_ms"]},
        "shapes": rows,
    }
    g_record = {
        "name": "opope_gemm_grouped",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/opope_grouped.cu",
        "replaces": "src/repro/kernels/opope_grouped.py:228",
        "launches": mres["launches"]["k4"] + moe_train["launches"]
                    + sum(q8_train["moe"]["launches_by_route"]["K4"].values()),
        "launches_by_path": {mcfg.name: mres["launches"]["k4"],
                             f"{mcfg.name} q8": ds_q8["launches"]["K4"],
                             f"{mcfg.name} train ({MOE_TRAIN_LAYERS} layers)":
                                 moe_train["launches"],
                             f"{mcfg.name} q8 train ({Q8_MOE_TRAIN_LAYERS} layers)":
                                 sum(q8_train["moe"]["launches_by_route"]["K4"].values())},
        # check_routes held both bf16 serving paths' launches to the sm90
        # route; phases 11(b) and 12(b) held training's to their exact split
        # (the fp32 backward GEMMs on the tile route).
        "launches_by_route": {r: (mres["launches"]["k4"] if r == "sm90" else 0)
                              + moe_train["launches_by_route"][r]
                              + q8_train["moe"]["launches_by_route"]["K4"][r]
                              for r in ("sm90", "tile")},
        "training": moe_train,
        "q8_training_backward": q8_train["moe"]["launches_by_route"]["K4"],
        "coverage_launches_by_route": g_cov,
        "max_abs_err": g_err,
        "ms": g_sums["ms"],
        "tile_ms": g_sums["tile_ms"],
        "plain_ms": g_sums["plain_ms"],
        "bound_ms": g_sums["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in g_decode) else "operations",
        "library_ms": g_sums["library_ms"],
        "work": "the 3 grouped GEMMs (64 experts) of one deepseek-moe-16b layer in a 4-slot "
                "decode step on the sm90 route ('tile_ms': the same calls on the tile route; "
                "the same GEMMs at prefill capacities 30 and 60 under 'layers'; per-shape rows "
                "under 'shapes')",
        "timing": "ms, tile_ms and library_ms: device time (CUDA events around calls queued "
                  "behind a sleeping kernel); plain_ms: CUDA events around the loop, the "
                  "host's issue rate included",
        "layers": {str(m): v for m, v in g_layers.items()},
        "build_s": kbuild.BUILD_SECONDS.get("opope_grouped"),
        "decode_step_device_ms": mres["device_ms"],
        "routing_agreement": mres["routing_agreement"],
        "shapes": g_rows,
    }
    # K2: the 3 MLP GEMMs of one chatglm3-6b layer in a 4-slot decode step;
    # K5: the 3 expert GEMMs of one deepseek-moe-16b layer (capacity 1).
    q8_records = []
    for name, src_line, sel, paths, work, lib in (
            ("opope_gemm_q8", 243, lambda r: r["path"] == "chatglm3-6b mlp" and r["m"] == 4,
             {f"{cfg.name} q8": glm_q8["launches"]["K2"],
              f"{mcfg.name} q8": ds_q8["launches"]["K2"],
              **{path: sum(r["launches_by_route"]["K2"].values())
                 for path, r in q8_paths.items()}},
             "the 3 MLP GEMMs of one chatglm3-6b layer in a 4-slot decode step",
             "torch._int_mm (M padded to 32 where M <= 16) plus the dequant multiply"),
            ("opope_gemm_q8_grouped", 451,
             lambda r: r["path"] == "deepseek-moe-16b experts" and r["m"] == 1,
             {f"{mcfg.name} q8": ds_q8["launches"]["K5"],
              f"{mcfg.name} q8 train ({Q8_MOE_TRAIN_LAYERS} layers)":
                  sum(q8_train["moe"]["launches_by_route"]["K5"].values())},
             "the 3 grouped expert GEMMs (64 experts) of one deepseek-moe-16b layer in a "
             "4-slot decode step",
             "none: no single PyTorch call computes a grouped int8 GEMM")):
        sel_rows = [r for r in q8_rows if sel(r)]
        sums = {key: sum(r[key] for r in sel_rows)
                for key in ("ms", "plain_ms", "bound_ms", "weight_quant_ms")}
        q8_records.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "opope_q8_grouped.cu" if "grouped" in name else "opope_q8.cu"),
            "replaces": f"src/repro/quant/pallas_q8.py:{src_line}",
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": q8_errs["k5" if "grouped" in name else "k2"],
            "ms": sums["ms"],
            "plain_ms": sums["plain_ms"],
            "bound_ms": sums["bound_ms"],
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in sel_rows) else "operations",
            "library_ms": (sum(r["library_ms"] for r in sel_rows) if "grouped" not in name
                           else None),
            "library": lib,
            "weight_quant_ms": sums["weight_quant_ms"],
            "work": work + " (per-shape rows of both models under 'shapes')",
            "decode_step_device_ms": (glm_q8 if "grouped" not in name else ds_q8)["device_ms"],
            "shapes": [r for r in q8_rows if (r["g"] > 0) == ("grouped" in name)],
        })
        log(f"{name}: {work}: kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, "
            f"bound {sums['bound_ms']:.4f} ms; per-call weight quantization of the same "
            f"weights {sums['weight_quant_ms']:.4f} ms")
    # K2's routes and its 512-row prefill layer, from the same timed rows.
    k2_paths = q8_records[0]["launches_by_path"]
    layers = {}
    for m in (4, 512):
        m_rows = [r for r in q8_rows if r["path"] == "chatglm3-6b mlp" and r["m"] == m]
        layers[m] = {key: sum(r[key] for r in m_rows) for key in (
            "ms", "tile_ms", "event_ms", "plain_ms", "library_ms", "library_event_ms",
            "bound_ms")}
        layers[m]["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in m_rows)
                                 else "operations")
        ops_m = sum(2 * r["m"] * r["n"] * r["k"] for r in m_rows)
        layers[m]["tops"] = ops_m / layers[m]["ms"] / 1e9
        log(f"K2 chatglm3-6b's 3 MLP GEMMs at M={m}: sm90 {layers[m]['ms']:.4f} ms device "
            f"({layers[m]['tops']:.1f} TOP/s), tile route {layers[m]['tile_ms']:.4f} ms, "
            f"torch._int_mm+dequant {layers[m]['library_ms']:.4f} ms device "
            f"({layers[m]['library_event_ms']:.4f} by CUDA events), bound "
            f"{layers[m]['bound_ms']:.4f} ms ({layers[m]['bound_by']})")
    q8_records[0].update(
        # check_routes held every serving path's launches to the sm90
        # route, phase 12 every training path's.
        launches_by_route={"sm90": sum(k2_paths.values()), "tile": 0},
        training={"dense": q8_train["dense"], "moe": q8_train["moe"],
                  "mlp_gemms": q8_train["k2_mlp_gemms"], "mlp_layer": q8_train["k2_mlp_layer"],
                  "timing": "ms and library_ms: device time (queued_ms); plain_ms: CUDA "
                            "events around the loop"},
        tile_ms=layers[4]["tile_ms"], event_ms=layers[4]["event_ms"],
        library_event_ms=layers[4]["library_event_ms"],
        prefill_layer=dict(layers[512], m=512),
        timing="ms, tile_ms and library_ms: device time (CUDA events around calls queued "
               "behind a sleeping kernel); event_ms, library_event_ms and plain_ms: CUDA "
               "events around the loop, the host's issue rate included",
        build_s=kbuild.BUILD_SECONDS.get("opope_q8"))
    # K5's routes at the decode capacity and at prefill capacities 30 and 60,
    # beside K4's sm90 route on the same shapes in bf16, from the same rows.
    k5_layers = {}
    for m in (1, 30, 60):
        m_rows = [r for r in q8_rows if r["path"] == "deepseek-moe-16b experts" and r["m"] == m]
        k5_layers[m] = {key: sum(r[key] for r in m_rows) for key in (
            "ms", "tile_ms", "event_ms", "k4_sm90_ms", "plain_ms", "bound_ms")}
        k5_layers[m]["tile_rows"] = m_rows[0]["tile_rows"]
        log(f"K5 deepseek's 3 expert GEMMs (G {mcfg.moe.n_experts}) at M={m}: sm90 "
            f"{k5_layers[m]['ms']:.4f} ms device ({k5_layers[m]['tile_rows']} rows; "
            f"{k5_layers[m]['event_ms']:.4f} ms by CUDA events), tile route "
            f"{k5_layers[m]['tile_ms']:.4f} ms, K4 sm90 (bf16) {k5_layers[m]['k4_sm90_ms']:.4f} "
            f"ms, bound {k5_layers[m]['bound_ms']:.4f} ms (bytes "
            f"{k5_layers[m]['bound_ms'] / k5_layers[m]['ms']:.1%} of the kernel's time)")
    k5_paths = q8_records[1]["launches_by_path"]
    q8_records[1].update(
        # check_routes held the serving path's launches to the sm90 route,
        # phase 12(b) the training path's.
        launches_by_route={"sm90": sum(k5_paths.values()), "tile": 0},
        training=q8_train["moe"],
        coverage_launches_by_route=k5_cov,
        tile_ms=k5_layers[1]["tile_ms"], event_ms=k5_layers[1]["event_ms"],
        k4_sm90_ms=k5_layers[1]["k4_sm90_ms"],
        layers={str(m): v for m, v in k5_layers.items()},
        timing="ms, tile_ms and k4_sm90_ms (K4's sm90 route on the same shapes in bf16): "
               "device time (CUDA events around calls queued behind a sleeping kernel); "
               "event_ms and plain_ms: CUDA events around the loop, the host's issue "
               "rate included",
        build_s=kbuild.BUILD_SECONDS.get("opope_q8_grouped"))
    for tag, r in (("chatglm3-6b q8", glm_q8), ("deepseek-moe-16b q8", ds_q8)):
        log(f"{tag}: prefill logits kernels vs plain RMS {r['logits_rms']:.4g} (floor "
            f"{r['logits_floor_rms']:.4g}); q8 vs bf16 RMS {r['q8_vs_bf16']['rms']:.4g}; "
            f"decode step {r['decode_step_ms']:.3f} ms wall")
    # Phase 13: each GEMM kernel's tuned cells; K1's tuned decode path.
    for rec, kname in ((record, "K1"), (g_record, "K4"), (q8_records[0], "K2"),
                       (q8_records[1], "K5")):
        rec["tuning"] = {"cells": [r for r in tune_record["cells"] if r["kernel"] == kname],
                         "winners_max_abs_err": tune_record["winners_max_abs_err"].get(kname),
                         "timing": "device time (search.median_time_us: the median of "
                                   f"{TUNE_ITERS} means over calls queued behind a sleeping "
                                   "kernel), weights cold in L2"}
    record["tuning"].update({k: tune_record[k] for k in (
        "heuristic_step", "tuned_step", "logits", "host_us", "cli",
        "seconds")})
    record["launches_by_path"][f"{cfg.name} tuned decode (13(c))"] = tune_record["tuned_launches"]
    record["launches"] += tune_record["tuned_launches"]
    record["launches_by_route"]["sm90"] += tune_record["tuned_launches"]
    # Phase 14's paths beside the earlier ones, for each GEMM kernel.
    for rec, kname in ((record, "K1"), (g_record, "K4"), (q8_records[0], "K2"),
                       (q8_records[1], "K5")):
        for path, routes in family_launch_paths(fam)[kname].items():
            rec["launches_by_path"][path] = sum(routes.values())
            rec["launches"] += sum(routes.values())
            for route, n in routes.items():
                rec["launches_by_route"][route] += n
    record["families"] = fam
    for path, routes in a8b_launch_paths(a8b).items():
        record["launches_by_path"][path] = sum(routes.values())
        record["launches"] += sum(routes.values())
        for route, n in routes.items():
            record["launches_by_route"][route] += n
    record["a8b"] = a8b
    # Phase 16's paths, for each GEMM kernel, by route as counted there.
    a8c_paths = a8c_launch_paths(a8c)
    for rec, kname in ((record, "K1"), (g_record, "K4"), (q8_records[0], "K2"),
                       (q8_records[1], "K5")):
        for path, routes in a8c_paths[kname].items():
            rec["launches_by_path"][path] = sum(routes.values())
            rec["launches"] += sum(routes.values())
            for route, n in routes.items():
                rec["launches_by_route"][route] += n
    record["a8c"] = a8c
    # Phase 17's paths, for each kernel, by route as counted there.
    p17_paths = dtype_launch_paths(p17)
    for rec, kname in ((record, "K1"), (g_record, "K4"), (k3_record, "K3")):
        for path, routes in p17_paths[kname].items():
            rec["launches_by_path"][path] = sum(routes.values())
            rec["launches"] += sum(routes.values())
            for route, n in routes.items():
                rec["launches_by_route"][route] += n
    for path, n in p17_paths["K6"].items():
        k6_record["launches_by_path"][path] = n
        k6_record["launches"] += n
    p17k = p17["kernels"]
    record["dtypes"] = {"models": {name: p17[name] for name in ("chatglm3-6b",
                                                                "deepseek-moe-16b")},
                        "layers": p17k["k1_layers"], "shapes": p17k["k1"],
                        "max_abs_err": p17k["max_abs_err"]["K1"], "seconds": p17["seconds"]}
    g_record["dtypes"] = {"shapes": p17k["k4"], "max_abs_err": p17k["max_abs_err"]["K4"]}
    k3_record["dtypes"] = {"shapes": p17k["k3"], "max_abs_err": p17k["max_abs_err"]["K3"]}
    k6_record["dtypes"] = {"shapes": p17k["k6"]}
    log(f"the whole script took {time.perf_counter() - t_script:.1f} s (builds "
        f"{sum(kbuild.BUILD_SECONDS.values()):.1f} s summed over sources, run together)")
    print(smi, flush=True)
    print(json.dumps({"kernels": [record, g_record] + q8_records + [k3_record, k6_record]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
