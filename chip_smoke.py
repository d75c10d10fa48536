#!/usr/bin/env python3
"""Smoke run of curl_tpu_torch on one CUDA card: kernels; the function
library; the private 2-party GPT-2 forward under the shipped configuration
(and under each protocol layout: replicated sharing at 3 parties, the TTP
dealer, Beaver at 3 parties, active security),
under bench.py's kernel configuration, at batch 8 with Beaver-masked weight
reuse, and with seed-compressed weights as bench.py builds them; then
GPT-Neo 1.3B's and 2.7B's geometries, seed-compressed; private greedy
generation with a causal GPT-2, eagerly and captured whole as one CUDA
graph; BertLarge at full width; the repo's bert-tiny-qnli checkpoint
classifying 8 rows privately; bench.py's offline/online split
(``compile_parties_cached``) over the compressed GPT-2 and the standalone
dealer; private ResNet-18 (eager and captured) and ResNet-50 inference at
224 x 224; private training of examples/mpc_cifar.py's LeNet (autograd,
CrossEntropyLoss, SGD), eagerly and as a training step captured by
``compile_parties``; a torchvision-layout ResNet-18 brought as a plain torch
model and converted by ``from_pytorch`` (eager and captured) and by
``from_onnx`` of its ONNX export, and DPSplitModel's split training over
LeNet; the compressed GPT-2 through the eager API in lazy scopes, each
replayed as one captured CUDA graph, and the materialized GPT-2 under the
llm_config profile; then the three compressed forwards captured as CUDA
graphs by ``compile_parties``.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the run exits non-zero
without the final line):

  1. device   the card's name and power limit (nvidia-smi); raises without CUDA
  2. build    every kernel from curl_tpu_torch/csrc with nvcc for sm_90a,
              one nvcc per source, all started together; the SASS
              instructions of one Philox call (cuobjdump -sass of
              philox_rate_kernel), the count behind every bound by operations
  3. kernels  ring_mm and philox against their plain torch versions at the
              main path's shapes and layouts, bit for bit; ring_mm also at
              extreme operands (one whole FLUSH_K chunk a block), K around
              FLUSH_K and past 2^17, 2 and 4 pairs of odd K, and GPT-Neo's
              block products, each with its split-K chunks; philox's time
              and bound, 2-D and 1-D, and grouped launches: each TFP
              provider call's segments at the path's sizes and 3 x 16
              mixed segments against plain_philox_group; the Philox-only
              kernel at the path's largest launch against its bound by
              operations; what a launch costs whatever it carries (a
              one-element torch op, a tiny group, torch's fill_ of 25 MiB)
  3b. fused   fused_mul (each op and truncation the path uses), ltz and
              max_step against their plain versions, bit for bit, at the
              path's sizes and an odd one; time, plain time and bound
  3c. seed    seed_expand's compress and expand (both parties, one party)
              against their plain versions, bit for bit, at the compressed
              paths' tensor sizes and an odd one; expand(compress(e))
              reconstructs e exactly; the open of a compressed Beaver operand
              against plain_open at the paths' weight shapes, transposed and
              not, and odd ones; time, plain time and bound
  3d. functions  every (function, method) of curl_tpu's function library
              (FUNCTION_CASES: exp, log, reciprocal, inv_sqrt, sqrt, cos/sin,
              sigmoid, tanh, erf, gelu, silu, relu, log_softmax, softmax of
              one element, the crypten LUT truncation) on a (64, 3072) grid
              over its domain, by the fused route (bench.py's kernel
              configuration) and the composable route: max and mean |error|
              against float64 within the limits taken from curl_tpu's own
              readings on the same input (or the reference's fault
              reproduced), rounds equal on both routes and to the CPU count,
              bytes equal on both routes, launches by kernel. It runs first
              of run_paths, and phase 5 holds its launch signatures
  4. forward  GPT-2 (768 wide, 12 heads, 12 blocks, vocab 50257) under
              configs/default.yaml, random weights from a numpy seed,
              encrypted by party 0; a private forward on 64 token ids
              (batch 1): latency, rounds and bytes, kernel launches of one
              forward, peak memory, and the final-LayerNorm hidden state
              against a float64 plaintext forward of the same weights,
              beside a planted fault (one block left out) that must fail
              the same bound
  4b. bench   the same model and tokens under bench.py's kernel
              configuration (the scan_reduction max, and mpc.fused_mul,
              fused_trunc, fused_compare, fused_max_step = "cuda"): the
              same readings and checks, launches of every kernel and op,
              the device busy share; then the same forward with the fused
              knobs off, whose rounds and bytes must be equal
  4e. batch8  the same model under bench.py's kernel configuration with
              models.head_chunk_positions 64, on 8 x 64 token ids: the
              embedding table and the LM head Beaver-masked once a forward
              (one mask draw and one delta reveal each) and reused by each
              chunk of 64 positions (one 3-pair ring_mm_acc launch a
              chunk); latency, rounds and bytes, launches (the 3-pair ones
              apart), peak memory, each row's final-LayerNorm hidden state
              against float64 under the bound and the planted fault
  4c. compressed  bench.py's default run: the same weights and tokens
              through GPT.build_compressed (8 vocab chunks) under bench.py's
              kernel configuration: build time, resident share bytes (at
              most 0.6 of the materialized model's), latency, rounds and
              bytes (phase 4b's plus what the vocab chunks add, exactly),
              launches of every kernel, seed_expand's included, peak memory,
              the device busy share, the hidden state and the planted fault;
              one open per compressed weight and one expand per other
              compressed tensor a forward (no weight expanded); one Beaver
              matmul of each compressed weight shape by the open route and
              by the composable route (the same tensor's expansion) at the
              same draw counters: delta and the output shares bit-identical;
              the same forward by the composable route, profiled beside it
  4d. neo     GPT-Neo 1.3B's geometry (2048 wide, 16 heads, vocab 50257;
              12 of its 24 blocks since phase 14) through
              GPT.build_compressed, chunked block
              linears, weights made block by block from a numpy seed: the
              same readings and open checks, against its own pre-declared
              bound
  4f. neo_large  GPT-Neo 2.7B's geometry (2560 wide, 20 heads, vocab
              50257; 16 of its 32 blocks since phase 14), as 4d: the same
              readings and checks against its
              own pre-declared bound, resident shares at most 0.6 of the
              materialized model's, rounds equal to the CPU count
  7. generate private greedy generation with a causal GPT-2 (phase 4's
              weights, materialized), a 60-token prompt as an encrypted
              one-hot buffer (1, 64, 50257), 4 tokens: every weight
              Beaver-masked once a call, then 4 decode steps (the buffer
              times the masked table, 12 causal blocks, the LM head, the
              private argmax of the last position's logits by
              scan_reduction and eq, written into the buffer); run eagerly
              step by step (each step's logits revealed), then captured as
              one CUDA graph by compile_parties and replayed: every written
              row a one-hot, each choice the argmax of its step's logits,
              the replay bit-identical to the eager loop under the same
              keys and counter, the same seed twice identical, two seeds
              different deltas, the capture's CommStats and launches equal
              to the eager loop's, each step's logits against float64
              under a bound fixed from CPU runs and a planted fault (one
              block left out) that fails it; rounds, bytes and latency a
              token, capture time and graph memory. It runs after phase
              4d, so that phase 5 holds its launch signatures
  8. bert     BertLarge (1024 wide, 16 heads, 24 post-LN blocks, vocab
              30522) as bench.py builds it for BENCH_MODEL=BertLarge:
              materialized, under its kernel configuration; latency,
              rounds (the CPU count), bytes, launches, peak memory; the last
              block's output against float64 under its pre-declared bound,
              one block left out above it
  9. qnli     benchmarks/checkpoints/bert-tiny-qnli read by the port's own
              safetensors reader, 8 rows of [CLS] a [SEP] b [SEP] [PAD]...
              classified privately under bench.py's kernel configuration:
              the logits' relative L2 error against the float64 classifier
              under its pre-declared bound, the argmax agreement, block 1
              left out above the bound; latency, rounds, bytes
  10. cached  bench.py's BENCH_CACHE=1 run on phase 4c's model and tokens:
              compile_parties_cached(forward, 2, 99, params, x) records the
              tuple requests in one eager forward; the fill is captured at
              seed 97 and replayed, then run eagerly at its keys and
              counter (bit-identical tuples; its launch signatures recorded
              for phase 5); the online is captured with that cache at seed
              101 and replayed at 101-106, then run eagerly, served from
              the same cache at its keys and counter (bit-identical shares;
              its signatures recorded); a timed fill at seed 98 into the
              same buffers (offline_fill_sec) and the online with it (the
              old cache refused, no capture anew, different shares). Holds:
              the online's rounds and bytes equal phase 4c's; the fill's
              launches are its provider calls' (philox, and ring_mm's dealer
              products), the online makes neither and launches the rest as
              phase 4c; the hidden state with either cache within phase
              4c's bound. Logs the cache's bytes, the fill's time eager and
              captured, the online replay beside phase 6's compile_parties
              replay (after phase 6), the device busy share of one online
              replay, and the graphs' memory
  10b. dealer the standalone dealer: a mul and a gelu at (4,) recorded, the
              dealer's command line (python -m
              curl_tpu_torch.mpc.provider.dealer) run on the card in a
              process of its own, each party's file loaded, the same ops
              served within 0.02 and 0.05, the cursor at the cache's end
  11. resnet  ResNet-18 and ResNet-50 (examples/mpc_imagenet.py's models)
              at 3 x 224 x 224, batch 1, 1000 classes, under bench.py's
              kernel configuration: He-normal weights from a numpy seed,
              each BatchNorm's running statistics from a float64 forward
              over the input, encrypted by party 0; every convolution an
              im2col product through ring_mm (the dealer's) and ring_mm_acc
              (the Beaver reconstruction), BatchNorm's private gain and the
              truncations through fused_mul, each ReLU through ltz, the
              3 x 3 max pool's windows through max_step's butterfly:
              latency, rounds against the CPU count, bytes, resident
              shares, peak memory, launches by kernel, the device busy
              share; the logits against float64 under a bound fixed from
              CPU runs, top-1 agreement, the least-felt residual block left
              out above it. ResNet-18 also through compile_parties:
              capture, replays at fresh seeds, the replay bit-identical to
              the eager forward at its keys and counter, equal CommStats and
              launches, the logits of two seeds within the bound. It runs
              after phase 10, so that phase 5 holds its launch signatures
  12. train   examples/mpc_cifar.py's training path at full width: LeNet
              (conv 3->6 5x5, ReLU, 2x2 max pool, conv 6->16 5x5, ReLU, 2x2
              max pool, fc 400->120->84->10) on 64 x 3 x 32 x 32 inputs
              ~ N(0, 1) with one-hot labels from numpy seeds, torch's
              default init from a numpy seed, encrypted by party 0,
              CrossEntropyLoss, SGD at lr 0.01, under bench.py's kernel
              configuration. The planted fault first (conv2's input
              detached: conv1 gets no gradient), then 3 eager steps
              (zero_grad, forward, loss, backward, step), the first
              recording its launch signatures (for phase 5) and counted;
              the step through compile_parties at CAPTURE_SEED, its
              parameters fed back at 3 fresh seeds, then more replays timed;
              the step eagerly at the capture's keys and counter. Holds:
              rounds the CPU count; step 1's gradient of every parameter,
              each step's loss, and the parameters after the eager and the
              captured steps against the float64 SGD trajectory under
              bounds fixed from CPU runs; the planted fault above them; the
              capture bit-identical to the eager step, with its CommStats
              and launches. Logs latency eager and replayed, images/s,
              bytes, launches, device busy share, peak and graph memory.
              It runs after phase 11, so that phase 5 holds the backward's
              launch signatures
  13. convert  bring your own model: TorchResNet, torchvision's ResNet-18
              written in plain torch (BasicBlock with an in-place ReLU and
              out += identity, torch.flatten), holding phase 11's state dict
              in float64 on the card, phase 11's input. from_pytorch (a
              torch.fx trace into a GraphModule): its DOT (one node a
              module), the graph in the clear through PlainTensor within
              1e-9 of torch's float64 logits, then encrypted by party 0
              under bench.py's kernel configuration: latency, rounds (the
              CPU count, beside phase 11's native 285), bytes, launches,
              peak memory, busy share, the logits within phase 11's bound,
              top-1 kept; the GraphModule through compile_parties as phase
              11 captures its model. export_onnx_bytes on the card with
              torch's constant folding (each BatchNorm folded into its
              convolution), from_onnx: the op types and the same readings
              and checks at its own round count; the export without
              folding logged beside it (its BatchNorms' encrypted
              variances through the private inv_sqrt). Then DPSplitModel
              over LeNet as a float32 torch model, batch 64, 10 sigmoid
              outputs, multi-label targets: one step of each protocol
              (layer_estimation, full_jacobian: the 640 x 62,006 Jacobian
              encrypted, one private product), recorded and counted
              together, each gradient against torch's float64
              BCEWithLogits gradient and against the float64
              backpropagation of its own dL/dZ under bounds fixed from CPU
              runs, rounds the CPU count, latency, busy share; a step with
              noise_magnitude against the noiseless one: the noise's
              scale. It runs after phase 12, so that phase 5 holds its
              launch signatures
  14. protocols  the protocol matrix: phase 4's GPT-2 (weights, tokens,
              configs/default.yaml, materialized) under rss3 (replicated
              sharing, 3 parties), ttp2 (the TTP dealer), tfp3 (Beaver, 3
              parties: the tuple one-hot embedding, the wrap-corrected
              truncation) and active2 (the sacrifice check), each a path of
              its own: the final-LayerNorm hidden state against float64
              under the layout's bound, rounds and bytes the CPU counts,
              ring_mm_acc and philox launched in every layout, ring_mm in
              every one but rss3 (whose products are 3-pair ring_mm_acc
              launches, checked), K5-K8 not launched; eager latency (best
              of 3), the device busy share, peak memory. rss3 is also
              captured by compile_parties at 3 parties and replayed at
              fresh seeds, bit-identical to the eager forward at the
              capture's keys and counter; active2 is also run with every
              triple's c off by one in one element, which must poison it.
              It runs after phase 13, so that phase 5 holds its launch
              signatures
  15. lazy    phase 4c's model and tokens through the eager API in lazy
              scopes (``with ct.lazy(): h = model(xe)``) under bench.py's
              kernel configuration: scope 1 records (each op evaluated on
              the meta device), warms up and captures one CUDA graph;
              scopes 2-7 record from the evaluations kept and replay it at
              fresh flush seeds; each timed from entering the scope until
              its output's shares are on the device, beside two plain eager
              forwards and (after phase 6) phase 6's compile_parties replay.
              Holds: one flush and no fallback a scope, no capture after
              scope 1, phase 4c's rounds and bytes a scope, the capture's
              launches by kernel phase 4c's, each scope's hidden state
              within phase 4c's bound, different shares in scopes 2 and 3.
              Logs the recording time of a repeated scope, the device busy
              share of one, the graph's memory
  15b. llm_config  phase 4's GPT-2 (weights and tokens, materialized) under
              ``init(config_file=<the port's configs/llm_config.yaml>)``,
              as examples/llms.py --no_cmp runs it: one eager forward (its
              launch signatures recorded for phase 5), two lazy scopes
              (capture, replay), the planted fault (one block left out).
              Holds: rounds and bytes the CPU count eagerly and in each
              scope, the hidden state within the bound fixed from CPU
              readings and the fault above it, the capture's launches the
              eager forward's, the default profile restored after it
  5. path     every launch signature (shapes, strides, op) that any of the
              runs of phases 3d, 4, 4b, 4e, 4c, 4d, 4f, 7, 8, 9, 10, 11, 12,
              13, 14, 15 and 15b
              passed to ring_mm, philox, fused_mul, ltz, max_step and
              seed_expand (expand and open), on
              fresh operands of the same layout: bit for bit against plain,
              timed with the L2 cache flushed before each call, and summed
              over each path's launches into each kernel's milliseconds a
              forward of that path, against the sum of each signature's
              bound (the larger of bytes and operations); philox's
              launches, ms and bound by size class; ring_mm's split-K
              chunks of its largest signatures, each path's ring_mm and
              ring_mm_acc as multiples of their bounds, and any ring_mm
              signature above 10x its bound; each open signature's
              multiple of its bound
  6. captured phase 4c's, 4d's and 4f's models and tokens through
              ``compile_parties(model.functional())``: the forward
              captured once as a CUDA graph (launch counts and CommStats
              reset just before the capture and read just after), replayed
              at fresh seeds: capture time, the capture's launches by
              kernel, replay latency (best of 6, host clock between
              synchronizations) beside the same run's eager forward,
              tokens/s, device busy of one replay, device memory of the
              graph; a replay bit-identical to the eager forward under the
              same keys from the same draw counter, the same seed twice
              identical, two seeds different, the hidden state of each
              within its bound, the capture's rounds, bytes and launches
              by kernel equal to the eager forward's

It prints one JSON line with every kernel's numbers (launches, time,
plain time and bound of one phase 4c forward, the main path of the slices
that ported the kernels, or for the 3-pair ring_mm_acc entry of phase 7's
generation; under ``paths`` the same for each phase's run, phase 10's fill
and online as "cached fill" and "cached online", phase 11's as "resnet18"
and "resnet50", phase 12's as "train", phase 13's as "convert", "convert
onnx" and "dp split", phase 14's as "protocols <layout>", phase 15's as
"lazy" and 15b's as "llm_config", and under ``captured`` the launches of
each phase 6, 7, 10, 11, 12, 13, 14, 15 and 15b capture) and, under
``protocols``, phase 14's readings by layout; then the
card's name and power limit, then ``{"ok": true, "device": {...}}`` as the
last line.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections.abc import Mapping

import numpy as np
import torch

SEQ = 64
SEED = 11
# Bounds on the decoded final-LayerNorm hidden state against the float64
# plaintext forward (PERF.md, "Hidden-state error bound"; the readings come
# from `python tests/test_torch_gpt.py --bound --blocks 12` on the CPU and
# from this script's own lines). The max |error| is set by single elements
# in the private inv_sqrt's widest table cells, which err by one factor per
# row: twice the largest error curl_tpu shows at GPT-2 width. It catches
# gross faults only. The relative L2 error left after one scale per row
# (hidden_stats' ``scale_free_l2``) separates a sound forward from a wrong
# one: curl_tpu reads 0.124 at 12 blocks, the plaintext forward without
# one block lies 0.18 or more from the full one, and the script also runs a
# private forward with one block left out (the block whose absence the
# plaintext forward feels least) and requires its error to exceed the bound.
HIDDEN_STATE_ATOL = 2.3
HIDDEN_STATE_SCALE_FREE_L2 = 0.15

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# The Philox and fused protocol kernels' integer work, counted in 32-bit
# instructions at the CUDA cores' 32-bit integer rate: the CUDA C++
# Programming Guide's table of arithmetic instruction throughput gives, at
# compute capability 9.0, 64 results a clock per SM for 32-bit integer add,
# multiply-add, shift and bitwise logical operations. ``set_int32_rate``
# sets it to 64 x the SM count x the SM clock nvidia-smi reads
# (clocks.max.sm); the default is an H100 SXM's 132 SMs at 1,980 MHz. Only
# the Philox rounds and the 64-bit products are counted, so the bound by
# operations is a lower one.
INT32_PER_CLOCK_PER_SM = 64
INT32_OPS_PER_S = INT32_PER_CLOCK_PER_SM * 132 * 1.98e9
# SASS instructions of one Philox4x32-10 call with its output's XOR fold, as
# ``philox_sass_ops`` counts them in the built philox_rate_kernel (it sets
# this from the card's build; the default is that count on an H100 with
# CUDA 12.8)
PHILOX_OPS = 40.5
MUL64_OPS = 3    # a 64-bit product mod 2^64: one widening 32-bit multiply, two cross products

# bench.py's kernel configuration (bench.py:136-174): the scan_reduction max
# and the four fused protocol knobs, which take "cuda" in the port where the
# JAX package takes "pallas_tpu"
FUSED_KNOBS = ("fused_mul", "fused_trunc", "fused_compare", "fused_max_step")
BENCH_CONFIG = {"functions.max_method": "scan_reduction",
                **{f"mpc.{knob}": "cuda" for knob in FUSED_KNOBS}}
FUSED_OFF = {"functions.max_method": "scan_reduction"}
FUSED_KEY = 0x5EED_F00D_0BAD_CAFE  # the fused checks' session key (check_keys)
# phase 3b: the path's element counts, and an odd one
FUSED_SIZES = ((196_608, "GELU, 64 x 3072"), (3_216_448, "vocab softmax, 64 x 50257"),
               (49_152, "LayerNorm 64 x 768, attention 12 x 64 x 64"),
               (131_072, "vocab fold step, 64 x 2048"), (100_003, "odd"))
FUSED_VARIANTS = (("mul", "egk", 16), ("square", "crypten", 16), ("trunc", "egk", 12),
                  ("mul", "none", 0))
# phase 3c: the seed expansion at the compressed paths' tensor sizes, and an odd one
SEED_SIZES = ((3072 * 768, "GPT-2 FFN weight, 3072 x 768"),
              (6283 * 768, "GPT-2 vocab chunk, 6283 x 768"),
              (6283 * 2048, "GPT-Neo vocab chunk, 6283 x 2048"),
              (2048 * 2048, "GPT-Neo ChunkedLinear chunk, 2048 x 2048"), (1_000_003, "odd"))
SEED_KEY = 0x0DDB_A11C_0FFE_E5ED
# phase 3c: the open of a compressed Beaver operand at the paths' weight
# shapes (share0's stored shape, whether the product takes its transpose)
# and odd ones
OPEN_SHAPES = (((2304, 768), True, "GPT-2 QKV weight"), ((768, 768), True, "GPT-2 projection"),
               ((3072, 768), True, "GPT-2 FFN up"), ((768, 3072), True, "GPT-2 FFN down"),
               ((6283, 768), True, "GPT-2 LM head chunk"),
               ((6283, 768), False, "GPT-2 embedding chunk"),
               ((2048, 2048), True, "GPT-Neo block linear chunk"),
               ((6283, 2048), True, "GPT-Neo LM head chunk"),
               ((6283, 2048), False, "GPT-Neo embedding chunk"),
               ((1001, 999), True, "odd, transposed"), ((999, 1001), False, "odd"))
# bench.py's compressed construction (bench.py:218-223): 8 vocab chunks
HEAD_CHUNKS = 8
# Phase 4d's bound on the final-LayerNorm hidden state's scale-free relative
# L2 error of GPT-Neo's geometry (2048 wide, 24 blocks), fixed before the
# first run of the phase (PERF.md, "The GPT-Neo bound"). The sound
# error grows with depth, and the plaintext error of the least-felt block
# left out shrinks: on the CPU at 24 blocks, widths 64 and 256, the sound
# private forward reads 0.141 and 0.159 and the plaintext without its
# least-felt block 0.161 and 0.174, and the private forward without that
# block reads about sqrt(sound^2 + plaintext^2) (0.203 at width 64); at
# GPT-2's width and 12 blocks the card read 0.124 and 0.221. At 2048 wide
# the sound reading is expected near 0.16-0.17 and the planted fault near
# 0.23-0.25; the bound sits between them.
NEO_SCALE_FREE_L2 = 0.20
# Phase 4f's bound on GPT-Neo 2.7B's geometry (2560 wide, 20 heads, 32
# blocks), fixed the same way before the first run of the phase (PERF.md
# §6; scripts/torch_neo_large_bound.py): on the CPU at widths 80 and 240
# the sound private forward reads 0.148 and 0.178, the private forward
# without the least-felt block 0.215 and 0.236 (the plaintext without it
# 0.152 and 0.155); the sound reading grows with width. Read later: width
# 480, 0.180 and 0.242; width 240 at two other session seeds, 0.180 and
# 0.178, their faults 0.232 and 0.237. The bound splits every width but
# 80, with margins ten times the seeds' spread. And its rounds:
# the CPU count at width 240, whose head dimension (12) scales the scores
# by a truncated product as 2560's (128) does; width 80's (4) divides
# locally and counts one round a block fewer.
NEO_LARGE_SCALE_FREE_L2 = 0.22
# Since phase 14 the two GPT-Neo geometries run at half their depth (full
# width, vocabulary and chunking), so that the whole script stays inside
# its time limit: GPT-Neo 1.3B's at 12 of 24 blocks, 2.7B's at 16 of 32.
# The bounds hold there: `python3 scripts/torch_neo_large_bound.py --width
# 240 --blocks 16` reads 0.14579 sound and 0.24203 with the least-felt
# block left out, `... --model GPTNeo --width 240 --blocks 12` 0.12845 and
# 0.23658 (PERF.md §6); and 2.7B's rounds at 16 blocks, that run's count
# (5517 at 32).
NEO_BLOCKS = 12
NEO_LARGE_BLOCKS = 16
NEO_LARGE_ROUNDS = 2973
# Phase 4e: batch 8 with the embedding and the head over chunks of 64
# positions (the Beaver-masked reuse), bench.py's batch
BATCH8 = 8
# Phase 7: the generation's prompt length and generated tokens, and its
# bound on the scale-free relative L2 error of each step's last-position
# logits (1 x 50257) against the float64 forward of the same buffer, fixed
# from CPU runs before the first run of the phase (PERF.md, "PR 9"). The
# same generation on the CPU (12 blocks, vocab 1000, the same seeds and
# prompt; widths 64, 128 and 256; scripts/torch_generate_bound.py) read at
# most 0.146, 0.149 and 0.147 over its 4 steps, and one private step
# without the least-felt block 0.223, 0.233 and 0.235 (the plaintext
# without it 0.193-0.196); the bound sits between them.
PROMPT_LEN = 60
GEN_TOKENS = 4
GENERATE_LOGITS_SCALE_FREE_L2 = 0.19

# Phase 3d: every function and method of the library (tests/test_torch_functions.py
# holds each against curl_tpu on the CPU) at the GELU's size in GPT-2, on a
# grid over the function's domain repeated to fill the shape. Each case:
# (function, config override, domain): (lo, hi), "signed" (+-[2, 32],
# alternating) or "normal" (a standard normal times 2, numpy seed 0); a
# case whose id ends in "-one" takes a trailing axis of one element.
FUNCTION_SHAPE = (64, 3072)
_DOMAINS = {"sigmoid": (-6, 6), "tanh": (-3, 3), "erf": (-2, 2), "silu": (-6, 6),
            "gelu": (-3, 3), "log": (2, 60), "reciprocal": (2, 32), "inv_sqrt": (2, 200),
            "sqrt": (4, 200), "cossin": (-6, 6), "relu": (-3, 3), "log_softmax": "normal"}
_CRYPTEN = {"encoder.trunc_method.lut": "crypten"}
# tests/test_reference_parity.py's TOLS for the default-config functions
FUNCTION_TOLS = {"sigmoid": 0.08, "tanh": 0.15, "erf": 0.02, "silu": 0.04, "relu": 0.01,
                 "sqrt": 0.3, "log": 0.05}


def _function_cases():
    cases = {name: (name, {}, _DOMAINS[name]) for name in FUNCTION_TOLS}

    def add(key, fn, over, dom=None):
        cases[key] = (fn, over, _DOMAINS[fn] if dom is None else dom)

    for m in ("bior", "haar-lut-only", "bior-lut-only", "reciprocal", "chebyshev"):
        for f in ("sigmoid", "tanh"):
            add(f"{f}-{m}", f, {"functions.sigmoid_tanh_method": m})
    for f, key in (("erf", "erf_method"), ("silu", "silu_method"), ("gelu", "gelu_method")):
        for m in ("haar", "haar-lut-only", "bior-lut-only", {"erf": "Taylor", "silu": "sigmoid",
                                                             "gelu": "erf"}[f]):
            add(f"{f}-{m}", f, {f"functions.{key}": m})
    for m in ("split", "haar", "bior"):
        add(f"exp-{m}", "exp", {"functions.exp_method": m}, (-12, 0))
        if m != "split":
            add(f"exp-{m}-signed", "exp", {"functions.exp_method": m,
                                           "functions.exp_all_neg": False}, (-4, 3))
    for m in ("haar", "iter"):
        add(f"log-{m}", "log", {"functions.log_method": m})
    add("log-input_in_01", "log", {}, (0.05, 0.95))
    for m in ("bior", "NR", "log"):
        add(f"reciprocal-{m}", "reciprocal", {"functions.reciprocal_method": m})
    add("reciprocal-signed", "reciprocal", {"functions.reciprocal_all_pos": False}, "signed")
    add("reciprocal-input_in_01", "reciprocal", {}, (0.05, 0.95))
    for m in ("haar", "bior", "NR"):
        add(f"inv_sqrt-{m}", "inv_sqrt", {"functions.inv_sqrt_method": m})
    for m in ("haar", "NR"):
        add(f"sqrt-{m}", "sqrt", {"functions.sqrt_method": m})
    for m in ("haar", "bior", "NR", "haar-lut-only", "bior-lut-only"):
        add(f"cossin-{m}", "cossin", {"functions.trigonometry_method": m})
    add("log_softmax", "log_softmax", {})
    add("softmax-one", "softmax", {}, (-6, 6))
    add("log_softmax-one", "log_softmax", {}, (-6, 6))
    # the crypten LUT truncation (local div, public remainder)
    add("log-bior-crypten", "log", _CRYPTEN)
    add("reciprocal-haar-crypten", "reciprocal", _CRYPTEN)
    add("gelu-bior-crypten", "gelu", _CRYPTEN)
    return cases


FUNCTION_CASES = _function_cases()
# Phase 8's bound on BertLarge's last block's output (hidden_stats'
# scale-free relative L2) and its rounds, fixed from CPU runs before the
# first run of the phase (PERF.md §6; scripts/torch_bert_bound.py, 24
# blocks, vocab 30522, widths 64 and 256): the sound private forward reads
# 0.104 and 0.100, the private forward without the least-felt block 0.200
# and 0.269 (the plaintext without it 0.171 and 0.244); 3688 rounds at both
# widths (every head dimension there, as BertLarge's 64, has an integer
# square root).
BERT_SCALE_FREE_L2 = 0.15
BERT_ROUNDS = 3688
# Phase 9: the bert-tiny-qnli checkpoint's 8 rows, its bound on the logits'
# relative L2 error against the float64 classifier, the argmax agreement
# and the rounds, from the same forward on the CPU before the first run of
# the phase (scripts/torch_qnli_bound.py): 0.107 and 8 of 8 rows, 329
# rounds; without block 1 the private logits read 0.591 (the plaintext's
# 0.644), though every row keeps its argmax.
QNLI_ROWS = 8
QNLI_LOGITS_REL_L2 = 0.30
QNLI_AGREE = 8
QNLI_ROUNDS = 329
# curl_tpu's (max, mean) |error| against float64 on each case's phase 3d
# input (function_input at FUNCTION_SHAPE), the case's override on the
# default configuration, read once on a CPU by
# ``python3 tests/torch_function_reference.py dense``: the limits of phase 3d
# and of the CPU test (function_tolerance) are taken from these
CURL_TPU_DENSE_ERR = {
    "sigmoid": (0.0910792, 0.0105943), "tanh": (0.182174, 0.0211966),
    "erf": (0.0010181, 0.000112262), "silu": (0.031929, 0.00120784),
    "relu": (1.52538e-05, 3.88923e-06), "sqrt": (0.0747446, 0.000712967),
    "log": (0.0427695, 0.00034303), "sigmoid-bior": (0.02536, 0.00186956),
    "tanh-bior": (0.0507352, 0.00374157), "sigmoid-haar-lut-only": (0.0910792, 0.0112059),
    "sigmoid-bior-lut-only": (0.0250815, 0.00187089),
    "sigmoid-reciprocal": (0.268249, 0.0865349), "tanh-reciprocal": (0.536498, 0.173042),
    "sigmoid-chebyshev": (0.0383553, 0.00748378), "tanh-chebyshev": (0.0767106, 0.0149672),
    "erf-haar": (0.206642, 0.0315093), "erf-haar-lut-only": (0.208534, 0.0336514),
    "erf-bior-lut-only": (0.0010181, 0.000103717), "silu-haar": (0.264109, 0.0336425),
    "silu-haar-lut-only": (1.61866, 0.314086),
    "silu-bior-lut-only": (0.0333851, 0.00131364), "silu-sigmoid": (0.073418, 0.0141435),
    "gelu-haar": (0.129414, 0.0128707), "gelu-haar-lut-only": (0.416312, 0.0777831),
    "gelu-bior-lut-only": (0.0522714, 0.0028499), "gelu-erf": (0.000606689, 5.95138e-05),
    "exp-haar": (0.929844, 0.0445112), "exp-bior": (0.861334, 0.0302432),
    "log-haar": (0.161986, 0.00781385), "log-iter": (0.0383419, 0.0212396),
    "log-input_in_01": (0.0162009, 0.000223458),
    "reciprocal-bior": (0.0361897, 0.000308754),
    "reciprocal-NR": (0.000475601, 8.68858e-05), "reciprocal-log": (0.0217396, 0.00105),
    "reciprocal-signed": (0.0761372, 0.00200645),
    "reciprocal-input_in_01": (1.99229, 0.0432653),
    "inv_sqrt-haar": (0.0277041, 0.000219652), "inv_sqrt-bior": (0.0016116, 7.30204e-06),
    "inv_sqrt-NR": (0.0374923, 0.000936852), "sqrt-haar": (0.627601, 0.0659967),
    "sqrt-NR": (0.281319, 0.0334368), "cossin-haar": (0.290092, 0.0679749),
    "cossin-bior": (0.0413594, 0.00452482), "cossin-NR": (0.0325278, 0.00604874),
    "log_softmax": (0.0413109, 0.0271894), "softmax-one": (0, 0), "log_softmax-one": (0, 0),
    "log-bior-crypten": (0.0427695, 0.000341539),
    "reciprocal-haar-crypten": (0.0761372, 0.00200193),
    "gelu-bior-crypten": (0.0502358, 0.00252282),
}
_erf_np = np.vectorize(math.erf)
# The faults of the reference the port reproduces (ROADMAP Queue C), each
# (tolerance against curl_tpu's eager output in the CPU test or None, the
# pin that holds on the decoded output x -> got).
FUNCTION_FAULTS = {
    # the lut-only tanh reads tables over the sigmoid's domain at tanh's
    # offset: haar's then reads tanh(2x), bior's about tanh(2x - 12) - 1;
    # curl_tpu reads 0.420 and 1.211 from tanh(x) (tolerance: one bior cell)
    "tanh-haar-lut-only": (0.3, lambda x, got: np.abs(got - np.tanh(x)).max() > 0.25
                           and np.abs(got - np.tanh(2 * x)).max() < np.abs(got - np.tanh(x)).max()),
    "tanh-bior-lut-only": (0.3, lambda x, got: np.abs(got - np.tanh(x)).max() > 1.0),
    # the lut-only trig tables take cell means over whole periods: 0 everywhere
    "cossin-haar-lut-only": (0.01, lambda x, got: np.abs(got).max() < 0.01),
    "cossin-bior-lut-only": (0.01, lambda x, got: np.abs(got).max() < 0.01),
    # split: garbage up to 4.0e9 in curl_tpu where exp(x) is at most 1
    "exp-split": (None, lambda x, got: np.abs(got - np.exp(x)).max() > 1e6),
    # e^64 * 2^16 overflows int64 in the signed tables: curl_tpu decodes
    # haar's cells as -2^47 (INT64_MIN) or 0, bior's as 0
    "exp-haar-signed": (None, lambda x, got: np.isin(got, (-2.0 ** 47, 0.0)).all()
                        and (got == -2.0 ** 47).any()),
    "exp-bior-signed": (None, lambda x, got: np.abs(got).max() < 1e-3),
    # Taylor: pow(p) of an odd p >= 5 computes (x^3)^((p - 1) / 2); curl_tpu
    # reads 176.48 from erf on [-2, 2]
    "erf-Taylor": (None, lambda x, got: abs(np.abs(got - _erf_np(x)).max() - 176.48) < 2),
}


# Each case's (rounds, max and mean |error| against float64) at
# FUNCTION_SHAPE on the CPU (``python3 scripts/torch_functions_bound.py``,
# the composable route under bench.py's kernel configuration, phase 3d's
# seed and inputs): the rounds phase 3d must count, and the port's errors
# beside curl_tpu's (CURL_TPU_DENSE_ERR); the max is the worst of the 64
# draws each of the 3072 grid points gets
FUNCTION_CPU = {
    "sigmoid": (19, 0.0920561, 0.0105836), "tanh": (19, 0.184127, 0.0211651),
    "erf": (21, 0.0010181, 0.000111771), "silu": (28, 0.0319309, 0.00119819),
    "relu": (8, 1.52538e-05, 3.88923e-06), "sqrt": (4, 0.0710003, 0.000712281),
    "log": (4, 0.0427695, 0.000337705), "sigmoid-bior": (21, 0.0250815, 0.00186424),
    "tanh-bior": (21, 0.050163, 0.00372204),
    "sigmoid-haar-lut-only": (2, 0.0920561, 0.0112253),
    "tanh-haar-lut-only": (2, 0.454309, 0.116337),
    "sigmoid-bior-lut-only": (4, 0.0249787, 0.00185543),
    "tanh-bior-lut-only": (4, 1.50762, 1.01173),
    "sigmoid-reciprocal": (20, 0.268249, 0.0863735),
    "tanh-reciprocal": (20, 0.536498, 0.172536),
    "sigmoid-chebyshev": (40, 0.0383553, 0.00748377),
    "tanh-chebyshev": (40, 0.0767106, 0.0149673), "erf-haar": (19, 0.208112, 0.0315451),
    "erf-haar-lut-only": (2, 0.207086, 0.0337116),
    "erf-bior-lut-only": (4, 0.0010181, 0.000103888),
    "erf-Taylor": (56, 3.62334e+06, 26.2744), "silu-haar": (26, 0.262168, 0.0336581),
    "silu-haar-lut-only": (2, 1.61866, 0.314551),
    "silu-bior-lut-only": (4, 0.0333851, 0.00131279),
    "silu-sigmoid": (21, 0.0727351, 0.0141007), "gelu-haar": (26, 0.129414, 0.0128687),
    "gelu-haar-lut-only": (2, 0.416312, 0.077646),
    "gelu-bior-lut-only": (4, 0.0534226, 0.00285253),
    "gelu-erf": (24, 0.000606689, 5.93927e-05), "exp-split": (11, 4.01896e+09, 3.2651e+08),
    "exp-haar": (10, 0.903176, 0.0443208), "exp-haar-signed": (2, 1.40737e+14, 6.04832e+13),
    "exp-bior": (12, 0.872532, 0.0305271), "exp-bior-signed": (4, 20.0855, 2.86909),
    "log-haar": (2, 0.161986, 0.00785994), "log-iter": (40, 0.0380909, 0.0212461),
    "log-input_in_01": (5, 0.0154697, 0.0002255),
    "reciprocal-bior": (4, 0.0361897, 0.000311187),
    "reciprocal-NR": (38, 0.000482172, 8.684e-05),
    "reciprocal-log": (12, 0.0220641, 0.00105072),
    "reciprocal-signed": (11, 0.0761372, 0.00201212),
    "reciprocal-input_in_01": (2, 1.99229, 0.0432619),
    "inv_sqrt-haar": (2, 0.0277041, 0.000221578),
    "inv_sqrt-bior": (4, 0.00162686, 7.32882e-06),
    "inv_sqrt-NR": (34, 0.037477, 0.000936897), "sqrt-haar": (2, 0.627601, 0.0662513),
    "sqrt-NR": (15, 0.281319, 0.0333915), "cossin-haar": (13, 0.290092, 0.067914),
    "cossin-bior": (17, 0.0413747, 0.00455208), "cossin-NR": (37, 0.0308942, 0.006052),
    "cossin-haar-lut-only": (3, 0.999998, 0.640057),
    "cossin-bior-lut-only": (7, 0.999998, 0.640057),
    "log_softmax": (140, 0.0414482, 0.0270666), "softmax-one": (0, 0, 0),
    "log_softmax-one": (0, 0, 0), "log-bior-crypten": (3, 0.0427695, 0.00034271),
    "reciprocal-haar-crypten": (1, 0.0761372, 0.00201143),
    "gelu-bior-crypten": (27, 0.0502501, 0.0025308),
}


def function_tolerance(key):
    """A case's limits on max and mean |error| against float64, for phase 3d
    and the CPU test: twice curl_tpu's max on phase 3d's input (at least
    the default functions' TOLS, and 0.01), but below the midpoint between
    curl_tpu's max and the range of the function's values there, so that
    no constant passes; and 1.25 times curl_tpu's mean there."""
    top, mean = CURL_TPU_DENSE_ERR[key]
    span = _function_range(key)
    return min(max(2 * top, FUNCTION_TOLS.get(key, 0.01)), (top + span) / 2), 1.25 * mean + 1e-6


@functools.lru_cache(maxsize=None)
def _function_range(key):
    """The range of a case's float64 values on phase 3d's input."""
    return float(np.ptp(function_plain(key, function_input(key, FUNCTION_SHAPE))))


def function_input(key, shape):
    """A case's input: its domain's grid over the last axis, repeated over
    the others (a "-one" case: one element on a trailing axis)."""
    dom = FUNCTION_CASES[key][2]
    if key.endswith("-one"):
        shape = tuple(shape) + (1,)
    if dom == "normal":
        return np.random.default_rng(0).normal(size=shape) * 2
    n = shape[-1] if not key.endswith("-one") else shape[-2]
    if dom == "signed":
        row = np.linspace(2, 32, n) * np.where(np.arange(n) % 2, -1.0, 1.0)
    else:
        row = np.linspace(dom[0], dom[1], n)
    if key.endswith("-one"):
        row = row[:, None]
    return np.broadcast_to(row, shape).copy()


def function_call(x, key):
    fn = FUNCTION_CASES[key][0]
    if key.endswith("input_in_01"):
        return getattr(x, fn)(input_in_01=True)
    return getattr(x, fn)()


def function_plain(key, x):
    """float64 values of a case's function on x."""
    fn = FUNCTION_CASES[key][0]
    if fn == "cossin":
        return np.stack([np.cos(x), np.sin(x)])
    if fn in ("log_softmax", "softmax"):
        z = x - x.max(-1, keepdims=True)
        lsm = z - np.log(np.exp(z).sum(-1, keepdims=True))
        return lsm if fn == "log_softmax" else np.exp(lsm)
    if fn in ("sigmoid", "silu"):
        return (1 if fn == "sigmoid" else x) / (1 + np.exp(-x))
    if fn == "gelu":
        return x * (1 + _erf_np(x / math.sqrt(2))) / 2
    if fn == "relu":
        return np.maximum(x, 0)
    if fn == "erf":
        return _erf_np(x)
    return {"tanh": np.tanh, "exp": np.exp, "log": np.log, "reciprocal": np.reciprocal,
            "sqrt": np.sqrt, "inv_sqrt": lambda v: 1 / np.sqrt(v)}[fn](x)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line(query="name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def set_int32_rate(dev):
    """INT32_OPS_PER_S from the card: 64 a clock per SM x SMs x the maximum
    SM clock (nvidia-smi clocks.max.sm, in MHz)."""
    global INT32_OPS_PER_S
    mhz = float(nvidia_smi_line("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    INT32_OPS_PER_S = INT32_PER_CLOCK_PER_SM * sms * mhz * 1e6
    log(f"[device] 32-bit integer rate {INT32_OPS_PER_S / 1e12:.3f} T/s: "
        f"{INT32_PER_CLOCK_PER_SM} a clock x {sms} SMs x {mhz:.0f} MHz (clocks.max.sm)")


_spin_cycles_per_ms = []


def _spin(ms):
    """Hold the stream for about ``ms`` milliseconds with a spin kernel."""
    if not _spin_cycles_per_ms:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        stop.record()
        torch.cuda.synchronize()
        _spin_cycles_per_ms.append(10 ** 7 / start.elapsed_time(stop))
    torch.cuda._sleep(int(ms * _spin_cycles_per_ms[0]))


# H100 SXM's L2 cache is 50 MB; a read of four times that evicts what a
# timed call would otherwise find there (a read leaves clean lines, which
# the timed call then evicts for free)
L2_FLUSH_BYTES = 4 * 50 * 2 ** 20


def cuda_ms(fn, reps, cold=False):
    """Device milliseconds of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run, with Python's garbage collector held off. The runs are
    queued behind a spin kernel that lasts longer than the host takes to
    queue them, so the events time the device's work, not the gaps of the
    host's launch overhead: the mean of the runs. ``cold``: each run is
    timed alone after an L2 flush (not timed), so that it reads its inputs
    from HBM, as a kernel of the forward does, not from the L2 cache the
    previous run left warm: the median of the runs, so that a host stall
    past the spin's end in one run does not count."""
    flush = torch.ones(L2_FLUSH_BYTES // 8, dtype=torch.int64, device="cuda") if cold else None
    collecting = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cold:
            flush.sum()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * reps if cold else 2)]
        _spin(1.5 * reps * host_ms + 1.0)
        if not cold:
            marks[0].record()
            for _ in range(reps):
                fn()
            marks[1].record()
            torch.cuda.synchronize()
            return marks[0].elapsed_time(marks[1]) / reps
        for i in range(reps):
            flush.sum()
            marks[2 * i].record()
            fn()
            marks[2 * i + 1].record()
        torch.cuda.synchronize()
        return statistics.median(marks[2 * i].elapsed_time(marks[2 * i + 1]) for i in range(reps))
    finally:
        if collecting:
            gc.enable()


def rand_i64(gen, shape, dev):
    return torch.randint(-(2 ** 63), 2 ** 63 - 1, shape, generator=gen, dtype=torch.int64,
                         device="cpu").to(dev)


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for ``nbytes`` moved
    once and ``ops`` 32-bit integer operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _operand(gen, spec, dev):
    """A random int64 operand: a plain shape, ("t", n, k) for the (k, n)
    transpose of a contiguous (n, k) tensor, or ("kperm", *shape) for
    attention's key layout, a (b, t, h, d) tensor permuted to (b, h, d, t)
    (with the party axis in front)."""
    if spec[0] == "t":
        return rand_i64(gen, spec[1:], dev).t()
    if spec[0] == "kperm":
        return rand_i64(gen, spec[1:], dev).permute(0, 1, 3, 4, 2)
    return rand_i64(gen, spec, dev)


def _strided_i64(gen, shape, stride, dev):
    """A random int64 tensor with the given shape and strides (broadcast
    dims keep stride 0), over a buffer just large enough for them."""
    span = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    return rand_i64(gen, (span,), dev).as_strided(shape, stride)


# operands whose balanced digits are extreme: 0x80..80 makes the largest
# (-128 in limb 0, -127 in the others), so a diagonal's int32 sum comes
# nearest its bound; INT64_MIN and -1 test the sign of the top and bottom
# limbs
RING_EXTREMES = (("INT64_MIN", -(2 ** 63)), ("-1", -1), ("0x7f..7f", 0x7F7F7F7F7F7F7F7F),
                 ("0x80..80", 0x8080808080808080 - 2 ** 64))
# GPT-Neo's block products as phase 4d passes them (shapes, strides): the
# dealer's a @ b, the Beaver eps @ b + x @ delta (delta of Linear's
# compressed weight.t(), row-major as the open writes it), and the FFN down
# projection's, whose x is a 2048-wide slice of the (64, 8192) activation
NEO_X = ((1, 64, 2048), (131072, 2048, 1))
NEO_W = ((2048, 2048), (2048, 1))
NEO_B = ((2, 1, 2048, 2048), (4194304, 4194304, 2048, 1))
NEO_DELTA = ((2048, 2048), (2048, 1))
NEO_RING_MM = {
    "neo dealer (1,64,2048)@(2048,2048)": [NEO_X + NEO_W],
    "neo beaver eps@b + x@delta.t() at 2048": [
        NEO_X + NEO_B, ((2, 1, 64, 2048), (131072, 131072, 2048, 1)) + NEO_DELTA],
    "neo ffn down eps@b + x[..., chunk]@delta.t()": [
        NEO_X + NEO_B, ((2, 1, 64, 2048), (524288, 524288, 8192, 1)) + NEO_DELTA],
}


def _full_i64(shape, value, dev):
    return torch.full(shape, value, dtype=torch.int64, device=dev)


def check_ring_mm(dev, gen):
    from curl_tpu_torch.kernels import ring_mm

    cases = {
        "qkv (2,64,768)@(768,2304) shared B": [((2, 64, 768), (768, 2304))],
        "scores (2,12,64,64)@(2,12,64,64)": [((2, 12, 64, 64), (2, 12, 64, 64))],
        "lm_head (64,768)@(768,50257)": [((64, 768), (768, 50257))],
        "acc2 qkv eps@b + x@delta": [((1, 64, 768), (2, 1, 768, 2304)),
                                     ((2, 1, 64, 768), (768, 2304))],
        "ragged (3,5,37,129)@(129,65)": [((3, 5, 37, 129), (129, 65))],
        # the layouts the path passes: Linear's weight.t(), attention's
        # key.permute(0, 2, 3, 1), the embedding's K = 50257 one-hot product
        "acc2 x@weight.t() (B column-major)": [((1, 64, 768), (2, 1, 768, 2304)),
                                               ((2, 1, 64, 768), ("t", 2304, 768))],
        "scores q@key.permute(0,2,3,1)": [((2, 1, 12, 64, 64), ("kperm", 2, 1, 64, 12, 64))],
        "embedding (2,64,50257)@(50257,768)": [((2, 64, 50257), (50257, 768))],
        # long and odd k: around one chunk's FLUSH_K, past 2^17, four pairs,
        # and pairs whose K is no multiple of the 32-k tile
        "K 8191 (5,8191)@(8191,7)": [((5, 8191), (8191, 7))],
        "K 8192 (5,8192)@(8192,7)": [((5, 8192), (8192, 7))],
        "K 8193 (5,8193)@(8193,7)": [((5, 8193), (8193, 7))],
        "K 2^17+37 (3,131109)@(131109,5)": [((3, 2 ** 17 + 37), (2 ** 17 + 37, 5))],
        "acc4 4 x (64,3072)@(3072,768)": [((64, 3072), (3072, 768))] * 4,
        "acc2 K 1000 + K 77 (64,K)@(K,200)": [((64, 1000), (1000, 200)), ((64, 77), (77, 200))],
    }
    named = {name: [(_operand(gen, sa, dev), _operand(gen, sb, dev)) for sa, sb in shapes]
             for name, shapes in cases.items()}
    for name, sig in NEO_RING_MM.items():
        named[name] = [(_strided_i64(gen, sa, st_a, dev), _strided_i64(gen, sb, st_b, dev))
                       for sa, st_a, sb, st_b in sig]
    # extreme operands: at (64, 8192) @ (8192, 8448) each of the 132 blocks
    # contracts one whole FLUSH_K chunk; at small M and N around it
    wide = ((64, 8192), (8192, 132 * 64))
    for label, v in RING_EXTREMES:
        named[f"extreme {label} (64,8192)@(8192,8448)"] = [
            (_full_i64(wide[0], v, dev), _full_i64(wide[1], v, dev))]
        for k in (8191, 8193):
            named[f"extreme {label} (5,{k})@({k},7)"] = [
                (_full_i64((5, k), v, dev), _full_i64((k, 7), v, dev))]
    named["extreme 0x7f..7f @ 0x80..80 (64,8192)@(8192,8448)"] = [
        (_full_i64(wide[0], RING_EXTREMES[2][1], dev),
         _full_i64(wide[1], RING_EXTREMES[3][1], dev))]
    named["extreme acc4 0x80..80, 4 x (5,2048)@(2048,7)"] = [
        (_full_i64((5, 2048), RING_EXTREMES[3][1], dev),
         _full_i64((2048, 7), RING_EXTREMES[3][1], dev))] * 4

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, pairs in named.items():
        got = ring_mm.ring_mm(pairs)
        want = ring_mm.plain(pairs)
        if not torch.equal(got, want):
            bad = (got != want).nonzero()
            raise AssertionError(f"ring_mm {name}: kernel != plain at {bad.shape[0]} of "
                                 f"{got.numel()} elements, first {bad[:4].tolist()}")
        if name.startswith("qkv"):
            a, b = pairs[0]
            if not torch.equal(got.cpu(), torch.matmul(a.cpu(), b.cpu())):
                raise AssertionError("ring_mm qkv: kernel != CPU int64 matmul")
        g = ring_mm.plan(pairs, sms)
        log(f"[kernels] ring_mm {name}: bit-exact vs plain ({g['out_tiles']} output tiles x "
            f"{g['splits']} chunks of {g['chunk']} 32-k tiles)")
        del pairs, got, want
    del named
    torch.cuda.empty_cache()


def _sass_functions(lib_path):
    """{function name: [SASS opcodes]} of a built library (cuobjdump -sass),
    padding NOPs left out."""
    from curl_tpu_torch.kernels import build

    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(build._nvcc())), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m and not m.group(1).startswith("NOP"):
                funcs[name].append(m.group(1))
    return funcs


def philox_sass_ops():
    """SASS instructions of one Philox call: philox_rate_kernel's
    instructions at 2 x and 1 x rate_calls() calls a thread, their
    difference over rate_calls(); by opcode, for the log."""
    from curl_tpu_torch.kernels import build, philox

    funcs = _sass_functions(build._target("philox"))
    calls = philox.rate_calls()
    one = next(v for k, v in funcs.items() if f"philox_rate_kernelILi{calls}E" in k)
    two = next(v for k, v in funcs.items() if f"philox_rate_kernelILi{2 * calls}E" in k)
    per_call = (len(two) - len(one)) / calls
    mix = {}
    for op in two:
        key = op.split(".")[0]
        mix[key] = mix.get(key, 0) + 1
    for op in one:
        key = op.split(".")[0]
        mix[key] = mix.get(key, 0) - 1
    mix = {k: v / calls for k, v in sorted(mix.items(), key=lambda kv: -kv[1]) if v}
    return per_call, mix


def check_launch_floor(dev):
    """What a launch costs whatever it carries, in the timing phase 5 uses:
    a one-element torch op and a two-segment philox group of 64 elements,
    L2-cold and warm; and torch's own fill_ of 25 MiB (the bytes of GPT-Neo's
    largest-but-one philox groups) against its bound by bytes, the yardstick
    of a launch that only writes."""
    from curl_tpu_torch.kernels import philox
    from curl_tpu_torch.kernels.philox import Segment

    one = torch.zeros(1, dtype=torch.int64, device=dev)
    dealer = check_keys()["dealer"]
    tiny = [Segment("draw", dealer, c, 64) for c in (1, 2)]
    for name, fn in (("a one-element torch add_", lambda: one.add_(1)),
                     ("a philox group of 2 x 64 elements",
                      lambda: philox.philox_group(tiny, dev))):
        log(f"[kernels] launch floor: {name}: {cuda_ms(fn, 20, cold=True):.4f} ms L2-cold, "
            f"{cuda_ms(fn, 50):.4f} ms warm")
    big = torch.empty(25 * 2 ** 20 // 8, dtype=torch.int64, device=dev)
    ms = cuda_ms(lambda: big.fill_(3), 10, cold=True)
    b = big.numel() * 8 / HBM_BYTES_PER_S * 1e3
    log(f"[kernels] launch floor: torch fill_ of 25 MiB: {ms:.4f} ms L2-cold, {ms / b:.2f}x its "
        f"bound {b:.4f} ms by bytes")
    del big


def check_philox_rate(dev, largest_calls):
    """The Philox-only kernel at ``largest_calls`` calls, against the bound
    by operations those calls make at PHILOX_OPS each."""
    from curl_tpu_torch.kernels import philox

    per_thread = philox.rate_calls()
    threads = max(256, -(-largest_calls // per_thread // 256) * 256)
    calls = threads * per_thread
    ms = cuda_ms(lambda: philox.launch_rate(threads, dev), 10, cold=True)
    t_ops = calls * PHILOX_OPS / INT32_OPS_PER_S * 1e3
    verdict = ("below the bound by operations: the count or the rate is wrong" if ms < t_ops
               else "above the bound by operations")
    log(f"[kernels] philox_rate: {calls} Philox calls ({threads} threads x {per_thread}, one "
        f"XOR-folded store a thread) in {ms:.4f} ms L2-cold, {verdict} {t_ops:.4f} ms "
        f"({PHILOX_OPS} instructions a call at {INT32_OPS_PER_S / 1e12:.3f} T/s; "
        f"{calls * PHILOX_OPS / (ms * 1e-3) / 1e12:.3f} T instructions/s achieved)")
    return ms, t_ops


RING_KEYS = (0x0123456789ABCDEF, 0x0FEDCBA987654321)
DEALER_KEY = 0x00C0FFEE0DDBA11
TTP_KEYS = (0x7A7A_0001_0203_0405, 0x7A7A_0607_0809_0A0B, 0x7A7A_0C0D_0E0F_1011)


def check_keys() -> dict:
    """Make the checks' keys the session's streams (``random.set_keys``):
    RING_KEYS the two parties' ring seeds, DEALER_KEY the dealer's and
    FUSED_KEY the fused kernels'. The checks name them by the session key
    table's slots, as the path's launches do (``random.stream_ref``,
    ``random.fused_key``): {"ring", "ring0", "ring1", "dealer", "fused"}."""
    from curl_tpu_torch import random as crandom

    keys = crandom.make_party_keys(SEED, len(RING_KEYS))
    keys.update(next=list(RING_KEYS), prev=[RING_KEYS[-1], RING_KEYS[0]], dealer=[DEALER_KEY],
                fused=[FUSED_KEY], ttp=list(TTP_KEYS))
    crandom.set_keys(keys)
    ring = crandom.stream_ref("next")
    ttp = crandom.SLOTS["ttp"]
    return dict(ring=ring, ring0=crandom.TABLE.ref(ring.slot), ring1=crandom.TABLE.ref(ring.slot + 1),
                dealer=crandom.stream_ref("dealer"), fused=crandom.fused_key(),
                ttp2=crandom.TABLE.ref(ttp, 2), ttp3=crandom.TABLE.ref(ttp, 3))


def provider_groups(dev, gen):
    """Each TFP provider call's grouped launches at the path's sizes, on
    the checks' keys and fresh plaintexts: {name: [segments]}."""
    from curl_tpu_torch.kernels.philox import Segment

    keys = check_keys()
    ring, dealer = keys["ring"], keys["dealer"]

    def fresh(n, bits, c, how="add", emit=False):
        return Segment("fresh", ring, 100 + c, n, how=how, dealer=dealer, draw_counter=c,
                       draw_kbits=bits, emit=emit)

    def share(n, c, how="add"):
        return Segment("plain", ring, 100 + c, n, how=how, plain=rand_i64(gen, (n,), dev))

    def draw(n, c):
        return Segment("draw", dealer, c, n)

    return {
        # a Linear's triple, (64, 768) @ (768, 3072): a and b, then c
        "triple (64,768)@(768,3072) a, b": [fresh(64 * 768, 64, 0, emit=True),
                                            fresh(768 * 3072, 64, 1, emit=True)],
        "triple c (64,3072)": [share(64 * 3072, 2)],
        # the LM head chunk's triple: b at (768, 6283), the path's largest
        "triple (64,768)@(768,6283) a, b": [fresh(64 * 768, 64, 3, emit=True),
                                            fresh(768 * 6283, 64, 4, emit=True)],
        "square r (64,3072), r^2": [fresh(64 * 3072, 64, 5, emit=True)],
        "EGK l-m, m, 1 at 196608": [fresh(196608, 48, 6), fresh(196608, 16, 7),
                                    fresh(196608, 1, 8)],
        "binary triple draws at 64": [draw(64, 9), draw(64, 10)],
        "binary triple shares at 64": [share(64, 11, "xor"), share(64, 12, "xor"),
                                       share(64, 13, "xor")],
        "B2A at 196608": [fresh(196608, 1, 14), fresh(196608, 1, 14, how="xor")],
        "LUT r, then r mod L and 2 masks at 49152": [draw(49152, 15)],
        "LUT shares at 49152": [share(49152, 16)] + [
            Segment("zero", ring, 117 + i, 49152) for i in range(2)],
        **ttp_groups(dev, gen, keys),
    }


def ttp_groups(dev, gen, keys):
    """The TTP dealer's grouped launches (ttp_fresh, ttp_plain) at the
    path's sizes, 2 and 3 parties, additive and XOR, fresh and given
    plaintexts, and an odd length."""
    from curl_tpu_torch.kernels.philox import Segment

    dealer = keys["dealer"]
    out = {}
    for parties in (2, 3):
        ttp = keys[f"ttp{parties}"]

        def fresh(n, bits, c, how="add", emit=False):
            return Segment("ttp_fresh", ttp, 200 + c, n, how=how, dealer=dealer, draw_counter=c,
                           draw_kbits=bits, emit=emit)

        def share(n, c, how="add"):
            return Segment("ttp_plain", ttp, 200 + c, n, how=how, plain=rand_i64(gen, (n,), dev))

        out.update({
            f"TTP triple (64,768)@(768,3072) a, b, {parties} parties": [
                fresh(64 * 768, 64, 20, emit=True), fresh(768 * 3072, 64, 21, emit=True)],
            f"TTP triple c (64,3072), {parties} parties": [share(64 * 3072, 22)],
            f"TTP EGK l-m, m, 1 at 196608, {parties} parties": [
                fresh(196608, 48, 23), fresh(196608, 16, 24), fresh(196608, 1, 25)],
            f"TTP B2A at an odd 196607, {parties} parties": [
                fresh(196607, 1, 26), fresh(196607, 1, 26, how="xor")],
            f"TTP binary triple shares at an odd 4097, {parties} parties": [
                share(4097, 27, "xor"), share(4097, 28, "xor"), share(4097, 29, "xor")],
            f"TTP one-hot r, (64, 50257), {parties} parties": [
                share(64, 30), share(64 * 50257, 31)],
        })
    return out


def random_segments(g, count, dev):
    """``count`` mixed segments from numpy generator ``g``: every kind,
    additive and XOR, odd n and n = 1, rows 1-8, kbits 1, 20 and 64; their
    random keys in slots of one key table of their own."""
    from curl_tpu_torch.kernels.keys import KeyTable
    from curl_tpu_torch.kernels.philox import FRESH, HOWS, MAX_ROWS, TTP, WHATS, Segment

    kinds = list(WHATS) + list(TTP)

    table = KeyTable(count * (MAX_ROWS + 1))
    out = []
    for i in range(count):
        what = kinds[i % len(kinds)]
        how = "add" if what == "draw" else HOWS[(i // len(kinds)) % 2]
        n = int(g.choice([1, 3, 257, 1001, 65_537, 1_000_003]))
        rows = 1 if i == 0 else 2 if what != "draw" and i % 3 else int(g.integers(1, MAX_ROWS + 1))
        keys = tuple(int(k) * 2 + 1 for k in g.integers(0, 2 ** 63, size=rows))
        kbits = int(g.choice([1, 20, 64])) if what == "draw" or (
            how == "xor" and what not in TTP) else 64
        plain = None
        if what in ("plain", "ttp_plain"):
            plain = torch.from_numpy(g.integers(-2 ** 63, 2 ** 63 - 1, size=n)).to(dev)
        elif what == "plain_lane":
            plain = torch.from_numpy(g.integers(-2 ** 63, 2 ** 63 - 1, size=(rows, n))).to(dev)
        base = i * (MAX_ROWS + 1)
        table.write(keys, base + 1)
        counter, src = int(g.integers(0, 2 ** 62)), int(g.integers(0, min(rows, 2)))
        src = 0 if what in TTP else src
        table.write([int(g.integers(0, 2 ** 63))], base)
        out.append(Segment(what, table.ref(base + 1, rows), counter, n, how=how, kbits=kbits,
                           src=src, plain=plain,
                           dealer=table.ref(base) if what in FRESH else None, draw_counter=i,
                           draw_kbits=int(g.choice([1, 20, 64])),
                           emit=what in FRESH and i % 2 == 1))
    return out


def _check_group(name, segments, dev, want=None):
    """The grouped launch against ``want`` (plain_philox_group's outputs,
    computed here where None), output by output."""
    from curl_tpu_torch.kernels import philox

    got = philox.philox_group(segments, dev)
    if want is None:
        want = philox.plain_philox_group(segments, dev)
    for i, (a, b) in enumerate(zip(got, want)):
        # an emitted fresh draw's output is the pair (shares, value)
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"philox group {name}, segment {i} "
                                 f"{segments[i].signature()}: kernel != plain")
    return got


def _plain_keys(kw):
    """``kw`` for plain_philox: the keys that the slots of kw["keys"] hold."""
    return dict(kw, keys=list(kw["keys"].values()))


def check_philox(dev, gen):
    from curl_tpu_torch.kernels import philox

    keys = check_keys()
    ring = keys["ring"]
    for n in (768 * 50257, 1_000_003):
        plain_n = rand_i64(gen, (n,), dev)
        plain_lane = rand_i64(gen, (2, n), dev)
        args = {
            "draw": dict(keys=keys["ring0"], kbits=64),
            "draw_k20": dict(keys=keys["ring1"], kbits=20),
            "przs": dict(keys=ring),
            "share": dict(keys=ring, plain=plain_n, src=0),
            "share_lane": dict(keys=ring, plain=plain_lane, src=1),
        }
        for label, kw in args.items():
            mode = label.split("_k")[0]
            got = philox.philox(mode, counter=77, n=n, device=dev, **kw)
            want = philox.plain_philox(mode, counter=77, n=n, device=dev, **_plain_keys(kw))
            if not torch.equal(got, want):
                raise AssertionError(f"philox {label} n={n}: kernel != plain")
            if mode == "przs" and torch.count_nonzero(got.sum(0)) != 0:
                raise AssertionError("philox przs rows do not sum to zero")
        log(f"[kernels] philox draw/przs/share/share_lane n={n}: bit-exact vs plain, "
            "PRZS sums to zero")
        if n == 768 * 50257:  # the weight sharing of the LM head, 2-D on the TPU
            kw = dict(keys=ring, plain=plain_n, src=0)
            ms = cuda_ms(lambda: philox.philox("share", counter=5, n=n, **kw), 10)
            plain_ms = cuda_ms(lambda: philox.plain_philox("share", counter=5, n=n,
                                                           **_plain_keys(kw)), 2)
            b, by = bound((2 * n + n) * 8, 2 * (n + 1) // 2 * PHILOX_OPS)
            log(f"[kernels] philox share (2, {n}): {ms:.3f} ms (plain {plain_ms:.3f} ms, "
                f"bound {b:.4f} ms by {by})")
        del plain_n, plain_lane
    # the 1-D form (pallas_przs.py:60 on the TPU) at the GELU's element count
    n = 64 * 3072
    plain_n = rand_i64(gen, (n,), dev)
    for mode, kw in (("draw", dict(keys=keys["ring0"])),
                     ("share", dict(keys=ring, plain=plain_n, src=0))):
        kw = dict(kw, counter=6, n=n, device=dev)
        got = philox.philox(mode, **kw)
        if not torch.equal(got, philox.plain_philox(mode, **_plain_keys(kw))):
            raise AssertionError(f"philox 1-D {mode} n={n}: kernel != plain")
        ms = cuda_ms(lambda: philox.philox(mode, **kw), 20)
        plain_ms = cuda_ms(lambda: philox.plain_philox(mode, **_plain_keys(kw)), 3)
        b, by = bound(got.numel() * 8 + (n * 8 if mode == "share" else 0),
                      kw["keys"].rows * (n + 1) // 2 * PHILOX_OPS)
        log(f"[kernels] philox 1-D {mode} ({got.shape[0]}, {n}): bit-exact vs plain; {ms:.4f} ms "
            f"(plain {plain_ms:.3f} ms, bound {b:.5f} ms by {by})")

    # grouped launches: each provider call's segments at the path's sizes,
    # then 16 mixed segments, additive and XOR, with odd n and n = 1
    for name, segments in provider_groups(dev, gen).items():
        _check_group(name, segments, dev)
        nbytes, ops = philox_work([s.signature() for s in segments])
        b, by = bound(nbytes, ops)
        ms = cuda_ms(lambda: philox.philox_group(segments, dev), 10, cold=True)
        log(f"[kernels] philox group {name}: bit-exact vs plain; {ms:.4f} ms L2-cold "
            f"(bound {b:.5f} ms by {by})")
    g = np.random.default_rng(5)
    for rep in range(3):
        segments = random_segments(g, philox.MAX_SEGMENTS, dev)
        _check_group(f"mixed {rep}", segments, dev)
    log(f"[kernels] philox group: 3 x {philox.MAX_SEGMENTS} mixed segments (every kind, the TTP "
        "ones too, additive and XOR, n from 1 to 1000003, rows 1-8, kbits 1/20/64): bit-exact "
        "vs plain")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3b: the fused protocol kernels against their plain versions
# ---------------------------------------------------------------------------

# the kinds of launch of the fused protocol kernels, as recording_launches
# names them: fused_mul's per-op launch and its chain of squarings; ltz;
# max_step's single step and its two scan_reduction chains
FUSED_KINDS = ("fused_mul", "square_chain", "ltz", "max_step", "fold", "butterfly")


def fused_name(spec):
    kind = spec["kind"]
    if kind == "fused_mul":
        return f"fused_mul {spec['op']}+{spec['trunc']} m={spec['m']}"
    if kind == "square_chain":
        return f"fused_mul square+{spec['trunc']} m={spec['m']} chain of {spec['steps']}"
    if kind == "butterfly":
        return f"max_step butterfly chain of {spec['steps']}"
    return "max_step fold chain" if kind == "fold" else kind


def fused_spec(kind, sig):
    """A launch of a fused protocol kernel as a spec: its op, truncation
    and bits (fused_mul), steps (the chains), and its operands' (shape,
    strides)."""
    if kind == "fused_mul":
        return dict(kind=kind, op=sig[0], trunc=sig[1], m=sig[2], operands=list(sig[3:]))
    if kind == "square_chain":
        return dict(kind=kind, op="square", trunc=sig[0], m=sig[1], steps=sig[2],
                    operands=list(sig[3:]))
    if kind == "butterfly":
        return dict(kind=kind, steps=sig[0], operands=list(sig[1:]))
    return dict(kind=kind, operands=list(sig))


def fused_run(spec, ops, count, plain=False):
    """One launch of the spec's kernel (or its plain version) on ``ops``,
    keyed by the session's fused slot, as the path's launches are (it holds
    FUSED_KEY once check_keys has run)."""
    from curl_tpu_torch import random as crandom
    from curl_tpu_torch.kernels import fused_mul, max_step

    key = crandom.fused_key()
    kind = spec["kind"]
    if kind == "fused_mul":
        fn = fused_mul.plain if plain else fused_mul.launch
        y = ops[1] if len(ops) > 1 else None
        return fn(spec["op"], spec["trunc"], spec["m"], ops[0], y, key, count)
    if kind == "square_chain":
        fn = fused_mul.plain_square_chain if plain else fused_mul.launch_square_chain
        return fn(spec["trunc"], spec["m"], ops[0], spec["steps"], key, count)
    name = {"fold": "fold_chain", "butterfly": "butterfly_chain"}.get(kind, kind)
    fn = getattr(max_step, ("plain_" if plain else "launch_") + name)
    if kind == "butterfly":
        return fn(ops[0], spec["steps"], key, count)
    return fn(*ops, key, count)


def fused_work(spec):
    """(bytes, 32-bit operations) one launch's function needs: each input
    element read once (a broadcast operand at its own size) and both result
    shares written once; ceil(k/2) Philox calls for each draw slot over k
    elements or words (one call gives two 64-bit draws) and the protocol's
    64-bit products, for each step of a chain. A chain's intermediate
    shares are not bytes: they never need to leave the chip."""
    from curl_tpu_torch.kernels import fused_mul, max_step

    kind = spec["kind"]
    shapes = [shape for shape, _ in spec["operands"]]
    if kind == "fold":  # the (2, ..., G, W) chunks -> a (2, ..., W) carry
        n, steps = math.prod(shapes[0][1:]) // shapes[0][-2], shapes[0][-2] - 1
    else:
        n = math.prod(torch.broadcast_shapes(*[tuple(s[1:]) for s in shapes]))
        steps = spec.get("steps", 1)
    nbytes = (sum(_distinct_numel(shape, st) for shape, st in spec["operands"]) + 2 * n) * 8
    if kind in ("fused_mul", "square_chain"):
        size = {"x": math.prod(shapes[0][1:]), "y": math.prod(shapes[-1][1:]), "out": n}
        calls = sum((size[s] + 1) // 2 for s in fused_mul.slot_spaces(spec["op"], spec["trunc"]))
        mul64 = {"mul": 5, "square": 4, "trunc": 0}[spec["op"]] * n
    else:
        draws = max_step.DRAWS["ltz" if kind == "ltz" else "max_step"]
        calls = draws * (((n + 1) // 2 + 1) // 2)
        mul64 = 0 if kind == "ltz" else 5 * n
    return nbytes, steps * (calls * PHILOX_OPS + mul64 * MUL64_OPS)


# phase 3b's launches beyond the flat (2, n) variants: element-pair
# fused_mul on broadcast, strided and odd layouts, and the chains at the
# paths' sizes, (kind, signature, label); a broadcast dim has stride 0
FUSED_LAYOUTS = (
    ("fused_mul", ("mul", "egk", 16, ((2, 1, 64, 768), (49152, 49152, 768, 1)),
                   ((2, 1, 64, 1), (64, 64, 1, 1))), "LayerNorm's rescale, a broadcast column"),
    ("fused_mul", ("mul", "egk", 16, ((2, 1, 64, 768), (49152, 49152, 768, 1)),
                   ((2, 768), (768, 1))), "a broadcast row"),
    ("fused_mul", ("mul", "egk", 16, ((2, 333, 301), (100233, 1, 333)),
                   ((2, 333, 1), (333, 1, 1))), "odd n, x transposed, y a broadcast column"),
    ("fused_mul", ("square", "crypten", 16, ((2, 1, 12, 64, 64), (49152, 49152, 64, 768, 1))),
     "attention scores, strided"),
    ("square_chain", ("crypten", 16, 8, ((2, 1, 12, 64, 64), (49152, 49152, 4096, 64, 1))),
     "exp, attention 12 x 64 x 64"),
    ("square_chain", ("crypten", 16, 8, ((2, 1, 16, 64, 64), (65536, 65536, 4096, 64, 1))),
     "exp, GPT-Neo attention 16 x 64 x 64"),
    ("square_chain", ("crypten", 16, 8, ((2, 1, 64, 50257), (3216448, 3216448, 50257, 1))),
     "exp, vocab softmax 64 x 50257"),
    ("square_chain", ("crypten", 16, 8, ((2, 100003), (100003, 1))), "exp, odd n"),
    ("fold", (((2, 1, 64, 32, 2048), (4194304, 4194304, 65536, 2048, 1)),),
     "vocab fold, 64 x 32 x 2048, 31 steps"),
    ("fold", (((2, 1, 64, 8, 256), (131072, 131072, 2048, 256, 1)),),
     "vocab cascade, 64 x 8 x 256, 7 steps"),
    ("fold", (((2, 1, 64, 2, 128), (16384, 16384, 256, 128, 1)),),
     "vocab cascade, 64 x 2 x 128, 1 step"),
    ("fold", (((2, 3, 7, 333), (6993, 2331, 333, 1)),), "odd carry, 3 x 7 x 333"),
    ("butterfly", (6, ((2, 1, 12, 64, 64), (49152, 49152, 4096, 64, 1))),
     "attention tail, 12 x 64 x 64"),
    ("butterfly", (6, ((2, 1, 16, 64, 64), (65536, 65536, 4096, 64, 1))),
     "GPT-Neo attention tail, 16 x 64 x 64"),
    ("butterfly", (7, ((2, 1, 64, 128), (8192, 8192, 128, 1))), "vocab tail, 64 x 128"),
    ("butterfly", (6, ((2, 1, 5, 64), (320, 320, 64, 1))),
     "rows that do not pair (5): the step kernel once a step"),
)


def check_fused(dev, gen):
    """Each fused kernel, at each variant the path uses, bit for bit against
    its plain version on fresh contiguous (2, n) operands; then element-pair
    fused_mul on other layouts and the chains at the paths' sizes; timed
    (warm)."""
    check_keys()
    count = 0
    cases = []
    for n, label in FUSED_SIZES:
        flat = ((2, n), (n, 1))
        specs = [dict(kind="fused_mul", op=op, trunc=tr, m=m, operands=[flat] * (1 + (op == "mul")))
                 for op, tr, m in FUSED_VARIANTS]
        specs += [dict(kind="ltz", operands=[flat]), dict(kind="max_step", operands=[flat] * 2)]
        cases += [(spec, f"n={n} ({label})") for spec in specs]
    cases += [(fused_spec(kind, sig), label) for kind, sig, label in FUSED_LAYOUTS]
    for spec, label in cases:
        count += 1
        ops = [_strided_i64(gen, shape, st, dev) for shape, st in spec["operands"]]
        got = fused_run(spec, ops, count)
        if not torch.equal(got, fused_run(spec, ops, count, plain=True)):
            raise AssertionError(f"{fused_name(spec)} {label}: kernel != plain")
        ms = cuda_ms(lambda: fused_run(spec, ops, count), 10)
        plain_ms = cuda_ms(lambda: fused_run(spec, ops, count, plain=True),
                           1 if spec.get("steps", 1) > 1 or spec["kind"] == "fold" else 2)
        b, by = bound(*fused_work(spec))
        log(f"[fused] {fused_name(spec)} {label}: bit-exact vs plain; {ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, bound {b:.5f} ms by {by}, {ms / b:.2f}x)")
        del ops, got
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3c: the seed expansion against its plain version
# ---------------------------------------------------------------------------

def seed_work(mode, n, b=None):
    """(bytes, 32-bit operations) of one seed_expand call over n elements:
    the input read once, the output written once (two rows for expand), one
    Philox call per element pair; the open reads share0 and both of b's
    shares (``b``: their (shape, strides); a broadcast b at its own size)
    and writes delta, 32 bytes an element."""
    if mode == "open":
        return (2 * n + _distinct_numel(*b)) * 8, (n + 1) // 2 * PHILOX_OPS
    return (3 if mode == "expand" else 2) * n * 8, (n + 1) // 2 * PHILOX_OPS


def seed_run(mode, x, plain=False, b=None, transposed=False):
    from curl_tpu_torch.kernels import seed_expand as se

    if mode == "compress":
        return (se.plain_compress if plain else se.launch_compress)(x, SEED_KEY)
    if mode == "open":
        return (se.plain_open if plain else se.launch_open)(x, SEED_KEY, transposed, b)
    parties = 2 if mode == "expand" else 1
    return (se.plain_expand if plain else se.launch_expand)(x, SEED_KEY, parties)


def check_seed(dev, gen):
    """compress and expand (both parties, and one party) bit for bit against
    their plain versions at the compressed paths' sizes; expand(compress(e))
    reconstructs e exactly; timed, each call L2-cold."""
    for n, label in SEED_SIZES:
        e = rand_i64(gen, (n,), dev)
        share0 = seed_run("compress", e)
        for mode, x in (("compress", e), ("expand", share0), ("expand1", share0)):
            got = seed_run(mode, x)
            if not torch.equal(got, seed_run(mode, x, plain=True)):
                raise AssertionError(f"seed_expand {mode} n={n}: kernel != plain")
            if mode != "compress" and not torch.equal(got.sum(0), e):
                raise AssertionError(f"seed_expand {mode} n={n}: the shares do not sum to e")
            ms = cuda_ms(lambda: seed_run(mode, x), 10, cold=True)
            plain_ms = cuda_ms(lambda: seed_run(mode, x, plain=True), 2, cold=True)
            b, by = bound(*seed_work(mode, n))
            log(f"[seed] {mode} n={n} ({label}): bit-exact vs plain"
                f"{'' if mode == 'compress' else ', reconstructs e exactly'}; {ms:.4f} ms L2-cold "
                f"(plain {plain_ms:.3f} ms, bound {b:.5f} ms by {by})")
            del got
        del e, share0
    torch.cuda.empty_cache()


def check_open(dev, gen):
    """The open of a compressed Beaver operand bit for bit against
    plain_open at the paths' weight shapes and odd ones (b contiguous, as
    the dealer makes it); timed, each call L2-cold."""
    from curl_tpu_torch.kernels import seed_expand as se

    for shape, transposed, label in OPEN_SHAPES:
        share0 = rand_i64(gen, shape, dev)
        b = rand_i64(gen, (2,) + se.view_shape(share0, transposed), dev)
        got = seed_run("open", share0, b=b, transposed=transposed)
        if not torch.equal(got, seed_run("open", share0, True, b, transposed)):
            raise AssertionError(f"seed_expand open {shape} transposed={transposed}: kernel != plain")
        ms = cuda_ms(lambda: seed_run("open", share0, b=b, transposed=transposed), 10, cold=True)
        plain_ms = cuda_ms(lambda: seed_run("open", share0, True, b, transposed), 2, cold=True)
        b_ms, by = bound(*seed_work("open", share0.numel(), (tuple(b.shape), b.stride())))
        log(f"[seed] open {shape}{'.t()' if transposed else ''} ({label}): bit-exact vs plain; "
            f"{ms:.4f} ms L2-cold (plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms by {by}, "
            f"{ms / b_ms:.2f}x)")
        del share0, b, got
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4: the private GPT-2 forward
# ---------------------------------------------------------------------------

def _lin(sd, rng, prefix, fan_in, fan_out):
    b = 1.0 / math.sqrt(fan_in)
    sd[f"{prefix}.weight"] = rng.uniform(-b, b, size=(fan_out, fan_in))
    sd[f"{prefix}.bias"] = rng.uniform(-b, b, size=(fan_out,))


def _ln(sd, prefix, d):
    sd[f"{prefix}.weight"] = np.ones(d)
    sd[f"{prefix}.bias"] = np.zeros(d)


def _block_state(sd, rng, prefix, d):
    _ln(sd, f"{prefix}.ln1", d)
    _ln(sd, f"{prefix}.ln2", d)
    _lin(sd, rng, f"{prefix}.attn.search", d, 3 * d)
    _lin(sd, rng, f"{prefix}.attn.proj", d, d)
    _lin(sd, rng, f"{prefix}.ff.0", d, 4 * d)
    _lin(sd, rng, f"{prefix}.ff.2", 4 * d, d)


def random_gpt2_state(rng, seq, blocks, d=768, vocab=50257):
    """Weights in the JAX package's init distributions (nn/module.py:571-598):
    Embedding normal, Linear weight and bias uniform in +-1/sqrt(fan_in),
    LayerNorm 1 and 0, pos_embed 0."""
    sd = {"pos_embed": np.zeros((1, seq, d)), "tok_embed.weight": rng.standard_normal((vocab, d))}
    for i in range(blocks):
        _block_state(sd, rng, f"blocks.{i}", d)
    _ln(sd, "ln", d)
    _lin(sd, rng, "fc", d, vocab)
    return sd


def gpt_param_count(d, blocks, vocab, seq=SEQ):
    """Parameters of a full GPT (random_gpt2_state's keys)."""
    block = 4 * d + (3 * d * d + 3 * d) + (d * d + d) + (4 * d * d + 4 * d) + (4 * d * d + d)
    return vocab * d + seq * d + blocks * block + 2 * d + vocab * d + vocab


class SeededGPTState(Mapping):
    """A GPT state dict in random_gpt2_state's distributions, made part by
    part (the embedding, each block, the final LayerNorm and head) from a
    numpy generator seeded (seed, part), keeping only the part last read:
    no more than one part's plaintext lives on the host (GPT-Neo's whole
    float64 state is 10.5 GB). Read the keys in order to make each part once."""

    BLOCK_KEYS = [f"{m}.{p}" for m in ("ln1", "ln2", "attn.search", "attn.proj", "ff.0", "ff.2")
                  for p in ("weight", "bias")]

    def __init__(self, seed, seq, blocks, d, vocab):
        self.seed, self.seq, self.blocks, self.d, self.vocab = seed, seq, blocks, d, vocab
        self._part, self._arrays = None, {}

    def _make(self, part):
        if part == "embed":
            rng = np.random.default_rng([self.seed, 0])
            return {"tok_embed.weight": rng.standard_normal((self.vocab, self.d)),
                    "pos_embed": np.zeros((1, self.seq, self.d))}
        sd = {}
        if part == "head":
            _ln(sd, "ln", self.d)
            _lin(sd, np.random.default_rng([self.seed, 1]), "fc", self.d, self.vocab)
        else:
            i = int(part.split(".")[1])
            _block_state(sd, np.random.default_rng([self.seed, 2, i]), part, self.d)
        return sd

    def __iter__(self):
        yield from ("tok_embed.weight", "pos_embed")
        for i in range(self.blocks):
            yield from (f"blocks.{i}.{key}" for key in self.BLOCK_KEYS)
        yield from ("ln.weight", "ln.bias", "fc.weight", "fc.bias")

    def __len__(self):
        return 6 + 12 * self.blocks

    def __getitem__(self, key):
        if key.startswith("blocks."):
            part = ".".join(key.split(".")[:2])
        else:
            part = "embed" if key in ("tok_embed.weight", "pos_embed") else "head"
        if part != self._part:
            self._part, self._arrays = None, {}  # the last part goes before the next is made
            self._arrays = self._make(part)
            self._part = part
        return self._arrays[key]


def plain_gpt_forward(sd, tokens, heads, blocks, dev, skip=None, head=True):
    """float64 plaintext forward: (final-LayerNorm hidden state, probs),
    probs None without ``head``; block ``skip`` is left out."""
    W = {k: torch.as_tensor(v, dtype=torch.float64, device=dev) for k, v in sd.items()}
    ids = torch.as_tensor(tokens, dtype=torch.int64, device=dev)

    def ln(x, p):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * W[f"{p}.weight"] + W[f"{p}.bias"]

    def lin(x, p):
        return x @ W[f"{p}.weight"].T + W[f"{p}.bias"]

    x = W["tok_embed.weight"][ids] + W["pos_embed"][:, : ids.shape[1]]
    b, t, d = x.shape
    hd = d // heads
    for i in range(blocks):
        if i == skip:
            continue
        p = f"blocks.{i}"
        q, k, v = lin(ln(x, f"{p}.ln1"), f"{p}.attn.search").split(d, dim=-1)
        q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in (q, k, v))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        y = (att @ v).transpose(1, 2).reshape(b, t, d)
        x = x + lin(y, f"{p}.attn.proj")
        h = lin(ln(x, f"{p}.ln2"), f"{p}.ff.0")
        h = 0.5 * h * (1 + torch.erf(h / math.sqrt(2)))
        x = x + lin(h, f"{p}.ff.2")
    hidden = ln(x, "ln")
    return hidden, torch.softmax(lin(hidden, "fc"), dim=-1) if head else None


def hidden_stats(got, ref):
    """Errors of a decoded hidden state against the plaintext: max |error|,
    mean |error|, the relative L2 error ||got - ref|| / ||ref||, and the
    relative L2 error left after fitting one scale per row
    (``scale_free_l2``). A LayerNorm's private inv_sqrt errs by one factor
    per row (the table's cells are 1.0 wide), which the last statistic
    does not count; a wrong forward changes the rows' directions."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    err = got - ref
    g = got.reshape(-1, got.shape[-1])
    r = ref.reshape(-1, ref.shape[-1])
    scale = (g * r).sum(-1, keepdims=True) / (r * r).sum(-1, keepdims=True)
    return {"max_abs": float(np.abs(err).max()), "mean_abs": float(np.abs(err).mean()),
            "rel_l2": float(np.linalg.norm(err) / np.linalg.norm(ref)),
            "scale_free_l2": float(np.linalg.norm(g - scale * r) / np.linalg.norm(scale * r))}


def fmt_stats(st):
    return (f"max |err| {st['max_abs']:.5f}, mean |err| {st['mean_abs']:.5f}, "
            f"rel L2 {st['rel_l2']:.5f}, scale-free rel L2 {st['scale_free_l2']:.5f}")


@contextlib.contextmanager
def recording_launches():
    """Count, by launch signature, every kernel launch made while the
    context is open (the wrappers' own launch counts are kept): ring_mm by
    its pairs' shapes and strides; philox by its segments' signatures;
    fused_mul by op, truncation, bits and its operands' shapes and strides,
    its chain of squarings ("square_chain") by truncation, bits and steps
    too; ltz and max_step by their operands' shapes and strides, max_step's
    chains ("fold", "butterfly") as their own signatures, the butterfly's
    with its steps; seed_expand by mode, elements and parties, and its open
    ("open") by transposition, share0's shape and b's shape and strides."""
    import curl_tpu_torch.random as crandom
    from curl_tpu_torch.kernels import fused_mul, max_step, ring_mm, seed_expand

    calls = {kind: {} for kind in KINDS}

    def note(kind, sig):
        calls[kind][sig] = calls[kind].get(sig, 0) + 1

    def layout(*ts):
        return tuple((tuple(t.shape), t.stride()) for t in ts)

    def rec_ring_mm(pairs):
        pairs = list(pairs)
        note("ring_mm", tuple((tuple(a.shape), a.stride(), tuple(b.shape), b.stride())
                              for a, b in pairs))
        return orig["ring_mm"](pairs)

    def rec_philox_group(segments, device=None):
        segments = list(segments)
        note("philox", tuple(seg.signature() for seg in segments))
        return orig["philox_group"](segments, device)

    def rec_fused_mul(op, trunc, m, x, y, key, count):
        note("fused_mul", (op, trunc, m) + layout(*([x] if y is None else [x, y])))
        return orig["fused_mul"](op, trunc, m, x, y, key, count)

    def rec_square_chain(trunc, m, x, steps, key, count):
        note("square_chain", (trunc, m, steps) + layout(x))
        return orig["square_chain"](trunc, m, x, steps, key, count)

    def rec_ltz(d, key, count):
        note("ltz", layout(d))
        return orig["ltz"](d, key, count)

    def rec_max_step(carry, rolled, key, count):
        note("max_step", layout(carry, rolled))
        return orig["max_step"](carry, rolled, key, count)

    def rec_fold_chain(chunked, key, count):
        note("fold", layout(chunked))
        return orig["fold_chain"](chunked, key, count)

    def rec_butterfly_chain(x, steps, key, count):
        note("butterfly", (steps,) + layout(x))
        return orig["butterfly_chain"](x, steps, key, count)

    def rec_expand(share0, key, parties=2):
        note("seed_expand", ("expand" if parties == 2 else "expand1", share0.numel(), parties))
        return orig["expand"](share0, key, parties)

    def rec_open(share0, key, transposed, b_share):
        note("open", ("open", transposed, tuple(share0.shape)) + layout(b_share)[0])
        return orig["open"](share0, key, transposed, b_share)

    targets = [(ring_mm, "ring_mm", rec_ring_mm), (crandom, "philox_group", rec_philox_group),
               (fused_mul, "fused_mul", rec_fused_mul),
               (fused_mul, "square_chain", rec_square_chain), (max_step, "ltz", rec_ltz),
               (max_step, "max_step", rec_max_step), (max_step, "fold_chain", rec_fold_chain),
               (max_step, "butterfly_chain", rec_butterfly_chain),
               (seed_expand, "expand", rec_expand), (seed_expand, "open", rec_open)]
    orig = {name: getattr(mod, name) for mod, name, _ in targets}
    for mod, name, fn in targets:
        setattr(mod, name, fn)
    try:
        yield calls
    finally:
        for mod, name, _ in targets:
            setattr(mod, name, orig[name])


def reset_launches():
    from curl_tpu_torch.kernels import fused_mul, max_step, philox, ring_mm, seed_expand

    for mod in (ring_mm, philox, fused_mul, max_step, seed_expand):
        mod.reset_launches()


# max_step's launch-count tags: its single step, its chains, and the step
# launches of a butterfly whose rows do not pair
MAX_STEP_TAGS = ("max_step", "fold", "butterfly", "butterfly_unpaired")


def read_launches():
    """Launches since the last reset: by kernel (the JSON line's names;
    ring_mm_acc's 3-pair launches also under MASKED), fused_mul by
    op+truncation (a chain with "+chain") and max_step by tag, and philox
    by mode."""
    from curl_tpu_torch.kernels import fused_mul, max_step, philox, ring_mm, seed_expand

    steps = {k: n for k, n in max_step.launches.items() if k != "ltz"}
    by_kernel = {"ring_mm": ring_mm.launches.get(1, 0),
                 "ring_mm_acc": sum(n for k, n in ring_mm.launches.items() if k >= 2),
                 MASKED: ring_mm.launches.get(3, 0),
                 "philox": sum(philox.launches.values()),
                 "fused_mul": sum(fused_mul.launches.values()),
                 "ltz": max_step.launches.get("ltz", 0),
                 "max_step": sum(steps.values()),
                 "seed_expand": sum(n for k, n in seed_expand.launches.items() if k != "open"),
                 "open": seed_expand.launches.get("open", 0)}
    return by_kernel, dict(fused_mul.launches, **steps), dict(philox.launches)


def unlaunched_chains(by_op):
    """The chain entries a forward under bench.py's kernel configuration
    launched no time."""
    return [name for name, is_tag in CHAIN_TAGS.items() if not any(map(is_tag, by_op))]


def recorded_launches(calls):
    """The recorded signatures' launches in read_launches' form."""
    from curl_tpu_torch.kernels import max_step

    by_kernel = {"ring_mm": 0, "ring_mm_acc": 0, MASKED: 0}
    for sig, n in calls["ring_mm"].items():
        by_kernel["ring_mm" if len(sig) == 1 else "ring_mm_acc"] += n
        by_kernel[MASKED] += n if len(sig) == 3 else 0
    for kind in ("philox", "ltz", "seed_expand", "open"):
        by_kernel[kind] = sum(calls[kind].values())
    by_op = {}

    def add(tag, n):
        by_op[tag] = by_op.get(tag, 0) + n

    for sig, n in calls["fused_mul"].items():
        add(f"{sig[0]}+{sig[1]}", n)
    for sig, n in calls["square_chain"].items():
        add(f"square+{sig[0]}+chain", n)
    for sig, n in calls["max_step"].items():
        add("max_step", n)
    for sig, n in calls["fold"].items():
        add("fold", n)
    for sig, n in calls["butterfly"].items():
        if max_step.butterfly_pairs(sig[1][0][1:]):
            add("butterfly", n)
        else:
            add("butterfly_unpaired", n * sig[0])
    by_kernel["fused_mul"] = sum(n for tag, n in by_op.items() if "+" in tag)
    by_kernel["max_step"] = sum(n for tag, n in by_op.items() if "+" not in tag)
    return {k: by_kernel[k] for k in PATH_FAMILIES + (MASKED,)}, by_op


def private_hidden(model, xe, skip=None):
    """The final-LayerNorm hidden state of a private forward through the
    model's own modules in forward order, block ``skip`` left out."""
    h = model.embed(xe)
    for i, block in enumerate(model.blocks):
        if i != skip:
            h = block(h)
    return model.ln(h)


# the port's kernels as the profiler names them
PORT_KERNEL_NAMES = ("ring_mm_kernel", "philox_group_kernel", "fused_mul_kernel",
                     "ltz_pair_kernel", "step_kernel<1>", "step_kernel<2>",
                     "seed_expand_kernel", "open_flat_kernel", "open_tile_kernel")


def profile_forward(model, xe, best_s, tag="profile", top=10, call=None, shapes=True):
    """One more forward under torch.profiler (``call()`` in place of
    ``model(xe)`` where given): the device's busy time (sum of kernel self
    time) against the best unprofiled latency, the kernels that take the
    most of it and, for each of those that is not the port's (with
    ``shapes``: the host's ops recorded too), the PyTorch ops (with their
    input shapes) that launched it. Returns the busy ms (None where the
    profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # without shapes only the device's kernels are recorded (a forward of
    # 40k-90k launches records several host ops for each)
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if shapes else [])
    with profile(activities=activities, record_shapes=shapes) as prof:
        model(xe) if call is None else call()
        torch.cuda.synchronize()
    # device-side events only: a host op's device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        log(f"[{tag}] the profiler recorded no device time: device busy share not measured")
        return None
    log(f"[{tag}] device busy {busy_ms:.1f} ms per forward, "
        f"{busy_ms / (best_s * 1e3):.1%} of the best unprofiled latency {best_s * 1e3:.1f} ms; "
        f"{sum(e.count for e in events)} kernel launches")
    # each kernel's launching op (the innermost) and its input shapes
    launched_by = {}
    for e in prof.events() if shapes else ():
        for k in e.kernels:
            key = (k.name, e.name, str(e.input_shapes))
            us, n = launched_by.get(key, (0.0, 0))
            launched_by[key] = (us + k.duration, n + 1)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")
        if not shapes or any(name in e.key for name in PORT_KERNEL_NAMES):
            continue
        ops = sorted(((us, n, op, shapes) for (name, op, shapes), (us, n) in launched_by.items()
                      if name == e.key), reverse=True)
        log(f"[{tag}]       {e.key[90:260]}; launched by " + "; ".join(
            f"{op} {shapes[:110]} {n}x {us / 1e3:.2f} ms" for us, n, op, shapes in ops[:3]))
    port = {}
    for e in events:
        for name in PORT_KERNEL_NAMES:
            if name in e.key:
                ms, n = port.get(name, (0.0, 0))
                port[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    log(f"[{tag}] the port's kernels in the forward: " + ", ".join(
        f"{name} {ms:.2f} ms / {n}" for name, (ms, n) in port.items()))
    return busy_ms


@contextlib.contextmanager
def composable_route():
    """Beaver matmuls with a compressed y take the composable route while
    the context is open: y expanded at full size, then y - b revealed."""
    from curl_tpu_torch.mpc.primitives import beaver

    opens = beaver._opens_compressed
    beaver._opens_compressed = lambda op, y: False
    try:
        yield
    finally:
        beaver._opens_compressed = opens


def run_forward(dev):
    import curl_tpu_torch as ct
    from curl_tpu_torch.kernels import philox, ring_mm
    from curl_tpu_torch.models import GPT2, load_numpy_state_dict

    blocks, heads, d, vocab = (GPT2.GEOM[k] for k in ("num_blocks", "num_heads", "embed_dim",
                                                      "vocab_size"))
    ct.init(world_size=2, seed=SEED)
    t0 = time.perf_counter()
    sd = random_gpt2_state(np.random.default_rng(1234), SEQ, blocks, d=d, vocab=vocab)
    model = load_numpy_state_dict(GPT2(seq_len=SEQ), sd)
    torch.cuda.reset_peak_memory_stats()
    model.encrypt(src=0)
    torch.cuda.synchronize()
    log(f"[forward] GPT-2 built and encrypted in {time.perf_counter() - t0:.1f} s")

    # token ids drawn as bench.py draws them
    tokens = np.random.default_rng(0).integers(0, 1000, size=(1, SEQ)).astype(np.float64)
    xe = ct.cryptensor(tokens, precision=0)

    # warm-up forward through the model's own modules in forward order,
    # keeping the final-LayerNorm hidden state and recording the operand
    # layouts of every ring_mm launch
    t0 = time.perf_counter()
    with recording_launches() as calls:
        h = private_hidden(model, xe)
        probs = model.softmax(model.fc(h))
    hidden = h.get_plain_text()
    probs = probs.get_plain_text()
    log(f"[forward] warm-up forward {time.perf_counter() - t0:.2f} s")

    ids = tokens.astype(np.int64)
    ref_hidden, ref_probs = plain_gpt_forward(sd, ids, heads, blocks, dev)
    ref_hidden = ref_hidden.cpu().numpy()
    sound = hidden_stats(hidden, ref_hidden)
    probs_err = float(np.abs(probs - ref_probs.cpu().numpy()).max())

    lat = []
    for i in range(3):
        if i == 2:
            reset_launches()
            ct.reset_communication_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(xe)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if i == 2:
            rm_launches = dict(ring_mm.launches)
            ph_launches = dict(philox.launches)
            launches, by_op, _ = read_launches()
            stats = ct.get_communication_stats()
    out = out.get_plain_text()

    log(f"[forward] latencies {', '.join(f'{x:.4f}' for x in lat)} s; "
        f"{SEQ / min(lat):.1f} tokens/s (best)")
    log(f"[forward] one forward: {stats['rounds']} rounds, {stats['bytes']} bytes per party")
    log(f"[forward] one forward: ring_mm launches {rm_launches}, philox launches {ph_launches}")
    log(f"[forward] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[forward] final-LN hidden: {fmt_stats(sound)} (bounds: max {HIDDEN_STATE_ATOL}, "
        f"scale-free rel L2 {HIDDEN_STATE_SCALE_FREE_L2}); probabilities max |err| "
        f"{probs_err:.5f} (reported, not asserted)")
    profile_forward(model, xe, min(lat))

    # a planted fault: the private forward without the block whose absence
    # the plaintext forward feels least must fail the scale-free bound
    skip_err = [hidden_stats(plain_gpt_forward(sd, ids, heads, blocks, dev, skip=j,
                                               head=False)[0].cpu().numpy(),
                             ref_hidden)["scale_free_l2"] for j in range(blocks)]
    j = int(np.argmin(skip_err))
    fault = hidden_stats(private_hidden(model, xe, skip=j).get_plain_text(), ref_hidden)
    log(f"[forward] plaintext with one block left out, scale-free rel L2: min "
        f"{skip_err[j]:.5f} (block {j}), max {max(skip_err):.5f}")
    log(f"[forward] planted fault, private forward without block {j}: {fmt_stats(fault)}")

    # the forward's checks; main() raises on any of them once phase 5 has
    # reported too
    failures = []
    if out.shape != (1, SEQ, vocab) or not np.isfinite(out).all():
        failures.append(f"forward output {out.shape} is not finite (1, {SEQ}, {vocab})")
    if not np.isfinite(hidden).all():
        failures.append("final-LN hidden state is not finite")
    bound = HIDDEN_STATE_SCALE_FREE_L2
    if sound["max_abs"] > HIDDEN_STATE_ATOL or sound["scale_free_l2"] > bound:
        failures.append(f"final-LN hidden error ({fmt_stats(sound)}) exceeds its bounds")
    if fault["scale_free_l2"] <= bound:
        failures.append(f"the planted fault ({fmt_stats(fault)}) passes the bound {bound}: "
                        "the check cannot tell it from a sound run")
    if rm_launches.get(1, 0) < 74 or rm_launches.get(2, 0) < 74:
        failures.append(f"ring_mm launched fewer than 74 times per form: {rm_launches}")
    if sum(ph_launches.values()) == 0:
        failures.append("philox was not launched on the main path")
    if recorded_launches(calls) != (launches, by_op):
        failures.append(f"forward recorded launches {recorded_launches(calls)} != counted "
                        f"{(launches, by_op)}")
    forward = dict(model=model, xe=xe, ref_hidden=ref_hidden, fault_block=j, sd=sd, tokens=tokens,
                   calls=calls, launches=launches, by_op=by_op)
    return forward, failures


def run_bench_forward(fw):
    """Phase 4b: phase 4's model and tokens under bench.py's kernel
    configuration, then once with the fused knobs off."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg

    model, xe, ref_hidden = fw["model"], fw["xe"], fw["ref_hidden"]
    with cfg.temp_override(BENCH_CONFIG):
        # warm-up forward, recording the signature of every kernel launch
        t0 = time.perf_counter()
        with recording_launches() as calls:
            h = private_hidden(model, xe)
            model.softmax(model.fc(h))
        hidden = h.get_plain_text()
        log(f"[bench] warm-up forward {time.perf_counter() - t0:.2f} s")
        lat = []
        for i in range(3):
            if i == 2:
                reset_launches()
                ct.reset_communication_stats()
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(xe)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if i == 2:
                launches, by_op, ph_modes = read_launches()
                stats = ct.get_communication_stats()
                peak = torch.cuda.max_memory_allocated()
        out = out.get_plain_text()
        log(f"[bench] latencies {', '.join(f'{x:.4f}' for x in lat)} s; "
            f"{SEQ / min(lat):.1f} tokens/s (best)")
        log(f"[bench] one forward: {stats['rounds']} rounds, {stats['bytes']} bytes per party")
        log(f"[bench] one forward: launches {launches}; fused_mul by op {by_op}; "
            f"philox by mode {ph_modes}")
        log(f"[bench] peak device memory {peak / 2**30:.2f} GiB")
        profile_forward(model, xe, min(lat))
        fault = hidden_stats(private_hidden(model, xe, skip=fw["fault_block"]).get_plain_text(),
                             ref_hidden)
    sound = hidden_stats(hidden, ref_hidden)
    log(f"[bench] final-LN hidden: {fmt_stats(sound)} (bounds: max {HIDDEN_STATE_ATOL}, "
        f"scale-free rel L2 {HIDDEN_STATE_SCALE_FREE_L2})")
    log(f"[bench] planted fault, private forward without block {fw['fault_block']}: "
        f"{fmt_stats(fault)}")

    # the same forward with the fused knobs off (the composable scan_reduction)
    with cfg.temp_override(FUSED_OFF):
        ct.reset_communication_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(xe)
        torch.cuda.synchronize()
        lat_off = time.perf_counter() - t0
        stats_off = ct.get_communication_stats()
    log(f"[bench] fused knobs off: {lat_off:.4f} s (one forward after the fused runs); "
        f"{stats_off['rounds']} rounds, {stats_off['bytes']} bytes per party")

    failures = []
    if out.shape != (1, SEQ, model.vocab_size) or not np.isfinite(out).all():
        failures.append(f"bench forward output {out.shape} is not finite (1, {SEQ}, "
                        f"{model.vocab_size})")
    if not np.isfinite(hidden).all():
        failures.append("bench final-LN hidden state is not finite")
    limit = HIDDEN_STATE_SCALE_FREE_L2
    if sound["max_abs"] > HIDDEN_STATE_ATOL or sound["scale_free_l2"] > limit:
        failures.append(f"bench final-LN hidden error ({fmt_stats(sound)}) exceeds its bounds")
    if fault["scale_free_l2"] <= limit:
        failures.append(f"bench planted fault ({fmt_stats(fault)}) passes the bound {limit}")
    # the materialized model expands and opens no compressed share
    missing = [k for k, n in launches.items()
               if n == 0 and k not in ("seed_expand", "open", MASKED)]
    missing += [op for op in ("mul", "square", "trunc")
                if not any(tag.startswith(op + "+") for tag in by_op)]
    missing += unlaunched_chains(by_op)
    if missing:
        failures.append(f"bench forward launched no {missing}: {launches}, {by_op}")
    if recorded_launches(calls) != (launches, by_op):
        failures.append(f"bench recorded launches {recorded_launches(calls)} != counted "
                        f"{(launches, by_op)}")
    for key in ("rounds", "bytes"):
        if stats[key] != stats_off[key]:
            failures.append(f"bench {key} {stats[key]} != {stats_off[key]} with the knobs off")
    return launches, by_op, calls, failures, stats


@contextlib.contextmanager
def counting_masks():
    """Record the shape of every operand ``beaver.mask_operand`` masks while
    the context is open."""
    from curl_tpu_torch.mpc.primitives import beaver

    masked, mask_operand = [], beaver.mask_operand

    def counted(y):
        out = mask_operand(y)
        if out is not y:
            masked.append(tuple(y.shape))
        return out

    beaver.mask_operand = counted
    try:
        yield masked
    finally:
        beaver.mask_operand = mask_operand


def run_batch8(fw):
    """Phase 4e: phase 4's model at batch 8 under bench.py's kernel
    configuration with the embedding and the LM head over chunks of 64
    positions, through ``model.functional()`` (each call binds the plain
    shares, so each forward masks the table and the head's weight anew)."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.models import GPT2

    model, sd = fw["model"], fw["sd"]
    blocks, heads, vocab = (GPT2.GEOM[k] for k in ("num_blocks", "num_heads", "vocab_size"))
    tokens = np.random.default_rng(0).integers(0, 1000, size=(BATCH8, SEQ)).astype(np.float64)
    ids = tokens.astype(np.int64)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ref = plain_gpt_forward(sd, ids, heads, blocks, dev, head=False)[0].cpu().numpy()
    # the planted fault: the block whose absence the plaintext batch feels least
    skip_err = [hidden_stats(plain_gpt_forward(sd, ids, heads, blocks, dev, skip=j,
                                               head=False)[0].cpu().numpy(),
                             ref)["scale_free_l2"] for j in range(blocks)]
    j = int(np.argmin(skip_err))
    log(f"[batch8] float64 reference and {blocks} forwards with one block left out in "
        f"{time.perf_counter() - t0:.1f} s; scale-free rel L2 without one block: min "
        f"{skip_err[j]:.5f} (block {j}), max {max(skip_err):.5f}")
    apply_fn, params = model.functional()
    xe = ct.cryptensor(tokens, precision=0)
    config = dict(BENCH_CONFIG, **{"models.head_chunk_positions": SEQ})
    with cfg.temp_override(config):
        with counting_masks() as masked:
            res, failures = drive("batch8", model, xe, reps=2, call=lambda: apply_fn(params, xe),
                                  unlaunched=("seed_expand", "open"))
        model.bind_params(params)
        fault = hidden_stats(private_hidden(model, xe, skip=j).get_plain_text(), ref)
    model.bind_params(params)
    rows = [hidden_stats(res["hidden"][i], ref[i]) for i in range(BATCH8)]
    launches = res["launches"]
    log(f"[batch8] masked in each forward: {masked[:2]} ({len(masked)} in all forwards); "
        f"ring_mm_acc 3-pair launches {launches[MASKED]} of {launches['ring_mm_acc']}")
    for i, st in enumerate(rows):
        log(f"[batch8] row {i} final-LN hidden: {fmt_stats(st)}")
    log(f"[batch8] planted fault, private forward without block {j}: {fmt_stats(fault)}")
    limit = HIDDEN_STATE_SCALE_FREE_L2
    want_masked = [(vocab, GPT2.GEOM["embed_dim"])] * 2
    if res["out"].shape != (BATCH8, SEQ, vocab):
        failures.append(f"batch8 output {res['out'].shape} != ({BATCH8}, {SEQ}, {vocab})")
    bad = [i for i, st in enumerate(rows)
           if st["max_abs"] > HIDDEN_STATE_ATOL or st["scale_free_l2"] > limit]
    if bad:
        failures.append(f"batch8 rows {bad} exceed the hidden-state bounds (max "
                        f"{HIDDEN_STATE_ATOL}, scale-free rel L2 {limit})")
    if fault["scale_free_l2"] <= limit:
        failures.append(f"batch8 planted fault ({fmt_stats(fault)}) passes the bound {limit}")
    if not masked or masked != want_masked * (len(masked) // 2):
        failures.append(f"batch8 masked {masked}, not the table and the head's weight once "
                        "a forward")
    if launches[MASKED] != 2 * BATCH8:
        failures.append(f"batch8 made {launches[MASKED]} 3-pair ring_mm_acc launches, not one "
                        f"a chunk of {SEQ} positions for the table and the head ({2 * BATCH8})")
    return res, failures


# ---------------------------------------------------------------------------
# Phases 4c and 4d: seed-compressed models (GPT.build_compressed)
# ---------------------------------------------------------------------------

def drive(tag, model, xe, reps, call=None, unlaunched=None):
    """A warm-up forward (``call()`` in place of ``model(xe)`` where given),
    recording the signature of every kernel launch and keeping the
    final-LayerNorm hidden state (a hook on ``model.ln``, its chunks of
    positions joined), then ``reps`` forwards; the last one runs with the
    launch counts, CommStats and peak memory reset just before it and read
    just after. Then one profiled forward. Every kernel but those in
    ``unlaunched`` (by default the 3-pair ring_mm_acc) must have launched."""
    import curl_tpu_torch as ct

    unlaunched = (MASKED,) if unlaunched is None else unlaunched
    if call is None:
        def call():
            return model(xe)

    seen = []
    hook = model.ln.register_forward_hook(lambda mod, inp, out: seen.append(out))
    t0 = time.perf_counter()
    try:
        with recording_launches() as calls:
            out = call()
    finally:
        hook.remove()
    hidden = np.concatenate([h.get_plain_text().reshape(-1, h.shape[-1]) for h in seen])
    hidden = hidden.reshape(out.shape[:-1] + (-1,))
    log(f"[{tag}] warm-up forward {time.perf_counter() - t0:.2f} s")
    lat = []
    for i in range(reps):
        last = i == reps - 1
        if last:
            reset_launches()
            ct.reset_communication_stats()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if last:
            launches, by_op, _ = read_launches()
            stats = ct.get_communication_stats()
            peak = torch.cuda.max_memory_allocated()
    out = out.get_plain_text()
    log(f"[{tag}] latencies {', '.join(f'{x:.4f}' for x in lat)} s; "
        f"{xe.nelement() / min(lat):.1f} tokens/s (best)")
    log(f"[{tag}] one forward: {stats['rounds']} rounds, {stats['bytes']} bytes per party")
    log(f"[{tag}] one forward: launches {launches}; fused_mul by op {by_op}")
    log(f"[{tag}] peak device memory {peak / 2**30:.2f} GiB in the forward, "
        f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before it")
    profile_forward(model, xe, min(lat), call=call)
    failures = []
    if not np.isfinite(out).all() or not np.isfinite(hidden).all():
        failures.append(f"{tag} output or final-LN hidden state is not finite")
    missing = [k for k, n in launches.items() if n == 0 and k not in unlaunched]
    missing += unlaunched_chains(by_op)
    if missing:
        failures.append(f"{tag} forward launched no {missing}: {launches}, {by_op}")
    if recorded_launches(calls) != (launches, by_op):
        failures.append(f"{tag} recorded launches {recorded_launches(calls)} != counted "
                        f"{(launches, by_op)}")
    return dict(out=out, hidden=hidden, stats=stats, launches=launches, by_op=by_op, calls=calls,
                peak=peak, best_s=min(lat)), failures


def profile_composable(tag, model, xe, best_s):
    """The same forward as before the open (each compressed weight
    expanded, then y - b revealed): its peak memory and its profile, to set
    beside drive's. Run after the forward's other checks, whose draws it
    would otherwise move."""
    held = torch.cuda.memory_allocated()
    with composable_route():
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(xe)
        torch.cuda.synchronize()
        lat = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        log(f"[{tag}] by the composable route: {lat:.4f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB in the forward, {(peak - held) / 2**30:.2f} GiB above the "
            f"{held / 2**30:.2f} GiB held before it")
        profile_forward(model, xe, best_s, tag="profile, composable route")


def compressed_tensors(model):
    """The model's compressed parameters: (the 2-D ones, the y operands of
    its Beaver matmuls: linear weights and their chunks, the embedding's
    chunks; the others: LayerNorm gains, biases, pos_embed)."""
    from curl_tpu_torch.mpc.primitives.compressed import SeedCompressedArithmetic

    weights, others = [], []
    for _, p in model.named_params():
        for t in p if isinstance(p, list) else [p]:
            inner = getattr(t, "_tensor", None)
            if isinstance(inner, SeedCompressedArithmetic):
                (weights if inner.ndim == 2 else others).append(inner)
    return weights, others


def open_checks(tag, model, res):
    """One forward (no position chunks on these paths) opened each
    compressed weight once and expanded each other compressed tensor once:
    no weight was expanded. Returns the failures."""
    calls, launches = res["calls"], res["launches"]
    weights, others = compressed_tensors(model)
    opened = sorted(math.prod(sig[2]) for sig in calls["open"])
    expanded = sorted(sig[1] for sig in calls["seed_expand"])
    log(f"[{tag}] seed_expand in one forward: open {launches['open']} launches for "
        f"{len(weights)} compressed weights ({len(opened)} signatures, {opened[:1]} to "
        f"{opened[-1:]} elements); expand {launches['seed_expand']} launches for {len(others)} "
        f"other compressed tensors, the LayerNorm gains, biases and pos_embed ({len(expanded)} "
        f"signatures, {expanded[:1]} to {expanded[-1:]} elements)")
    if (launches["open"], launches["seed_expand"]) != (len(weights), len(others)):
        return [f"{tag}: open and expand launches {launches['open']}, {launches['seed_expand']} != "
                f"the {len(weights)} compressed weights and {len(others)} other compressed tensors"]
    return []


def check_open_routes(tag, model, gen):
    """One Beaver matmul of each compressed weight shape the model's
    products open, by the open route and by the composable route (the same
    tensor's expansion as a plain ArithmeticSharedTensor) from the same
    draw counter: delta, the output shares and the CommStats must be equal.
    Returns the failures."""
    import curl_tpu_torch as ct
    from curl_tpu_torch import comm
    from curl_tpu_torch import random as crandom
    from curl_tpu_torch.kernels import seed_expand
    from curl_tpu_torch.models.gpt import ChunkedEmbedding
    from curl_tpu_torch.mpc.primitives import beaver
    from curl_tpu_torch.mpc.primitives.arithmetic import ArithmeticSharedTensor
    from curl_tpu_torch.mpc.primitives.compressed import SeedCompressedArithmetic

    cases = {}  # (transposed, shape): one compressed weight of that use
    for m in model.modules():
        for p in getattr(m, "_params", {}).values():
            for t in p if isinstance(p, list) else [p]:
                w = getattr(t, "_tensor", None)
                if isinstance(w, SeedCompressedArithmetic) and w.ndim == 2:
                    cases.setdefault((not isinstance(m, ChunkedEmbedding), tuple(w.shape)), w)
    orig_open, orig_sum = seed_expand.open, comm.all_sum
    deltas = []

    def open_(*args):
        deltas.append(("open", orig_open(*args)))
        return deltas[-1][1]

    def all_sum(x):
        out = orig_sum(x)
        if isinstance(x, list):  # the composable route's batched reveal: (eps, delta)
            deltas.append(("all_sum", out[1]))
        return out

    failures = []
    for (transposed, shape), w in sorted(cases.items()):
        if transposed:  # a linear's x @ W.t()
            x = ct.cryptensor(torch.randn((1, SEQ, shape[1]), generator=gen,
                                          dtype=torch.float64))._tensor
            y = w.t()
        else:  # an embedding chunk: a one-hot @ the chunk at scale 1
            rows = torch.randint(0, shape[0], (SEQ,), generator=gen)
            x = ct.cryptensor(torch.nn.functional.one_hot(rows, shape[0]).to(torch.float64),
                              precision=0)._tensor
            y = beaver._raw(w)
        plain_y = ArithmeticSharedTensor(y.share, y.encoder)
        c0, out = crandom._counter, []
        del deltas[:]
        for operand in (y, plain_y):
            crandom._counter = c0
            ct.reset_communication_stats()
            seed_expand.open, comm.all_sum = open_, all_sum
            try:
                z = beaver.matmul(x, operand)
            finally:
                seed_expand.open, comm.all_sum = orig_open, orig_sum
            out.append((z.share, ct.get_communication_stats()))
        what = f"{shape}{'.t()' if transposed else ' at scale 1'}"
        routes = [r for r, _ in deltas]
        same = (routes == ["open", "all_sum"] and torch.equal(deltas[0][1], deltas[1][1])
                and torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1])
        log(f"[{tag}] one Beaver matmul of {what}, open route against composable route at the "
            f"same counters: {'delta, output shares and CommStats equal' if same else 'DIFFER'} "
            f"(routes {routes}; {out[0][1]['rounds']} round, {out[0][1]['bytes']} bytes)")
        if not same:
            failures.append(f"{tag}: the open and composable routes differ at {what}")
        del x, y, plain_y, z, out
        del deltas[:]
    torch.cuda.empty_cache()
    return failures


def chunked_extra_bytes(rows, d, vocab, n):
    """Bytes per party a vocab-chunked embedding and LM head open beyond the
    unchunked ones, at ``rows`` positions: the embedding's one-hot and
    table deltas over the padded vocabulary; the head's input delta once
    per chunk, its weight delta and the rescale of its logits over the
    padded vocabulary."""
    pad = -(-vocab // n) * n - vocab
    embedding = (pad * rows + pad * d) * 8
    head = ((n - 1) * rows * d + pad * d + pad * rows) * 8
    return embedding + head


def build_timed(tag, **kw):
    """GPT.build_compressed(**kw) on the card: build seconds, peak memory of
    the build and resident share bytes."""
    from curl_tpu_torch.models import GPT

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPT.build_compressed(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    resident = model.resident_share_bytes()
    log(f"[{tag}] built compressed in {secs:.1f} s: resident shares {resident / 2**30:.3f} GiB "
        f"({resident} bytes), device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
        f"peak in the build {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, resident


def run_compressed(fw, bench_stats, gen):
    """Phase 4c: bench.py's default GPT-2 run: phase 4's weights and tokens
    through GPT.build_compressed(head_vocab_chunks=8) under bench.py's
    kernel configuration."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.models import GPT2

    # the materialized model is freed first, so that the peaks below are
    # this model's own
    materialized = fw.pop("model").resident_share_bytes()
    ct.init(world_size=2, seed=SEED)
    with cfg.temp_override(BENCH_CONFIG):
        model, resident = build_timed("compressed", **GPT2.GEOM, seq_len=SEQ,
                                      head_vocab_chunks=HEAD_CHUNKS, state_dict=fw["sd"])
        xe = ct.cryptensor(fw["tokens"], precision=0)
        res, failures = drive("compressed", model, xe, reps=3)
        fault = hidden_stats(private_hidden(model, xe, skip=fw["fault_block"]).get_plain_text(),
                             fw["ref_hidden"])
        failures += open_checks("compressed", model, res)
        failures += check_open_routes("compressed", model, gen)
        profile_composable("compressed", model, xe, res["best_s"])
    res.update(model=model, xe=xe, ref=fw["ref_hidden"], config=BENCH_CONFIG,
               bound=HIDDEN_STATE_SCALE_FREE_L2)
    sound = hidden_stats(res["hidden"], fw["ref_hidden"])
    ratio = resident / materialized
    want_rounds = bench_stats["rounds"] + 3 * (HEAD_CHUNKS - 1)
    d, vocab = GPT2.GEOM["embed_dim"], GPT2.GEOM["vocab_size"]
    want_bytes = bench_stats["bytes"] + chunked_extra_bytes(SEQ, d, vocab, HEAD_CHUNKS)
    log(f"[compressed] resident share bytes {resident} against the materialized model's "
        f"{materialized} (phase 4b): {ratio:.4f}")
    log(f"[compressed] rounds {res['stats']['rounds']} (phase 4b {bench_stats['rounds']} + "
        f"{3 * (HEAD_CHUNKS - 1)}: {want_rounds}); bytes {res['stats']['bytes']} (phase 4b "
        f"{bench_stats['bytes']} + chunk padding and per-chunk deltas: {want_bytes})")
    log(f"[compressed] final-LN hidden: {fmt_stats(sound)} (bounds: max {HIDDEN_STATE_ATOL}, "
        f"scale-free rel L2 {HIDDEN_STATE_SCALE_FREE_L2})")
    log(f"[compressed] planted fault, private forward without block {fw['fault_block']}: "
        f"{fmt_stats(fault)}")
    limit = HIDDEN_STATE_SCALE_FREE_L2
    if res["out"].shape != (1, SEQ, vocab):
        failures.append(f"compressed forward output {res['out'].shape} != (1, {SEQ}, {vocab})")
    if sound["max_abs"] > HIDDEN_STATE_ATOL or sound["scale_free_l2"] > limit:
        failures.append(f"compressed final-LN hidden error ({fmt_stats(sound)}) exceeds its bounds")
    if fault["scale_free_l2"] <= limit:
        failures.append(f"compressed planted fault ({fmt_stats(fault)}) passes the bound {limit}")
    if ratio > 0.6:
        failures.append(f"compressed resident share bytes {ratio:.3f} of the materialized > 0.6")
    if (res["stats"]["rounds"], res["stats"]["bytes"]) != (want_rounds, want_bytes):
        failures.append(f"compressed rounds/bytes {res['stats']['rounds']}/{res['stats']['bytes']} "
                        f"!= {want_rounds}/{want_bytes}")
    return res, failures


def run_neo(dev, gen, tag="neo", model="GPTNeo", bound=NEO_SCALE_FREE_L2, rounds=None,
            blocks=None):
    """Phase 4d (4f): GPT-Neo 1.3B's (2.7B's) geometry at full width
    through GPT.build_compressed (chunked block linears at their default),
    under bench.py's settings for the model, at ``blocks`` blocks (the
    model's depth where None); ``rounds``, where given, the count the
    forward must equal."""
    import curl_tpu_torch as ct
    from curl_tpu_torch import models
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.nn.module import ChunkedLinear

    geom = dict(getattr(models, model).GEOM)
    geom["num_blocks"] = blocks or geom["num_blocks"]
    d, heads, blocks, vocab = (geom[k] for k in ("embed_dim", "num_heads", "num_blocks",
                                                 "vocab_size"))
    sd = SeededGPTState(1234, SEQ, blocks, d, vocab)
    tokens = np.random.default_rng(0).integers(0, 1000, size=(1, SEQ)).astype(np.float64)
    ids = tokens.astype(np.int64)

    # float64 reference on the card, the weights made once; the plaintext
    # forward without each block picks the planted fault
    t0 = time.perf_counter()
    W = {k: torch.as_tensor(v, dtype=torch.float64, device=dev) for k, v in sd.items()}
    ref = plain_gpt_forward(W, ids, heads, blocks, dev, head=False)[0].cpu().numpy()
    skip_err = [hidden_stats(plain_gpt_forward(W, ids, heads, blocks, dev, skip=j,
                                               head=False)[0].cpu().numpy(),
                             ref)["scale_free_l2"] for j in range(blocks)]
    del W
    torch.cuda.empty_cache()
    j = int(np.argmin(skip_err))
    log(f"[{tag}] float64 reference and {blocks} plaintext forwards with one block left out in "
        f"{time.perf_counter() - t0:.1f} s; scale-free rel L2 without one block: min "
        f"{skip_err[j]:.5f} (block {j}), max {max(skip_err):.5f}")

    ct.init(world_size=2, seed=SEED)
    config = dict(BENCH_CONFIG, **{"models.head_chunk_positions": SEQ})
    with cfg.temp_override(config):
        model, resident = build_timed(tag, **geom, seq_len=SEQ, head_vocab_chunks=HEAD_CHUNKS,
                                      state_dict=sd)
        chunked = sum(isinstance(m, ChunkedLinear) for m in model.blocks.modules())
        xe = ct.cryptensor(tokens, precision=0)
        res, failures = drive(tag, model, xe, reps=2)
        fault = hidden_stats(private_hidden(model, xe, skip=j).get_plain_text(), ref)
        failures += open_checks(tag, model, res)
        failures += check_open_routes(tag, model, gen)
        profile_composable(tag, model, xe, res["best_s"])
    sound = hidden_stats(res["hidden"], ref)
    # the materialized model's share bytes: every party's share of every
    # parameter, 8 bytes an element
    materialized = 2 * 8 * gpt_param_count(d, blocks, vocab)
    log(f"[{tag}] {chunked} ChunkedLinear modules in the blocks; resident share bytes {resident} "
        f"({resident / 2**30:.3f} GiB), {resident / materialized:.4f} of the materialized "
        f"model's {materialized}")
    log(f"[{tag}] rounds {res['stats']['rounds']}" + ("" if rounds is None else
        f" (the CPU count at this geometry: {rounds})"))
    log(f"[{tag}] final-LN hidden: {fmt_stats(sound)} (bounds: max {HIDDEN_STATE_ATOL}, "
        f"scale-free rel L2 {bound})")
    log(f"[{tag}] planted fault, private forward without block {j}: {fmt_stats(fault)}")
    if res["out"].shape != (1, SEQ, vocab):
        failures.append(f"{tag} forward output {res['out'].shape} != (1, {SEQ}, {vocab})")
    if chunked != 3 * blocks:
        failures.append(f"{tag} has {chunked} ChunkedLinear modules, not {3 * blocks}")
    if resident > 0.6 * materialized:
        failures.append(f"{tag} resident share bytes {resident} > 0.6 of {materialized}")
    if rounds is not None and res["stats"]["rounds"] != rounds:
        failures.append(f"{tag} rounds {res['stats']['rounds']} != the CPU count {rounds}")
    if sound["max_abs"] > HIDDEN_STATE_ATOL or sound["scale_free_l2"] > bound:
        failures.append(f"{tag} final-LN hidden error ({fmt_stats(sound)}) exceeds its bounds")
    if fault["scale_free_l2"] <= bound:
        failures.append(f"{tag} planted fault ({fmt_stats(fault)}) passes the bound {bound}")
    # phase 6 captures this model's forward
    res.update(model=model, xe=xe, ref=ref, config=config, bound=bound)
    return res, failures


# ---------------------------------------------------------------------------
# Phase 3d: the function library at the GELU's size
# ---------------------------------------------------------------------------

def add_launches(total, launches, by_op):
    """Accumulate one run's read_launches() into ``total``."""
    for name, counts in (("launches", launches), ("by_op", by_op)):
        for k, n in counts.items():
            total[name][k] = total[name].get(k, 0) + n


def run_functions():
    """Phase 3d: each (function, method) of FUNCTION_CASES on its grid at
    FUNCTION_SHAPE, by the fused route (bench.py's kernel configuration)
    and the composable route (the fused knobs off): max |error| against
    float64, rounds and bytes (equal on both routes, the rounds the CPU
    count), launches by kernel. Every launch of the phase (the inputs'
    sharing and both routes) is counted and recorded for phase 5."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg

    ct.init(world_size=2, seed=SEED)
    total = {"launches": {}, "by_op": {}}
    failures, rows = [], {}
    t_phase = time.perf_counter()
    with recording_launches() as calls:
        for key, (_, over, _) in FUNCTION_CASES.items():
            x = function_input(key, FUNCTION_SHAPE)
            reset_launches()
            xe = ct.cryptensor(x)
            add_launches(total, *read_launches()[:2])  # the input's sharing
            got = {}
            for route, config in (("fused", BENCH_CONFIG), ("composable", FUSED_OFF)):
                with cfg.temp_override(dict(config, **over)):
                    reset_launches()
                    ct.reset_communication_stats()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = function_call(xe, key)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    launches, by_op, _ = read_launches()
                    stats = ct.get_communication_stats()
                add_launches(total, launches, by_op)
                got[route] = (out, stats, launches, secs)
            out, stats, launches, secs = got["fused"]
            dec = (np.stack([o.get_plain_text() for o in out]) if isinstance(out, tuple)
                   else out.get_plain_text())
            diff = np.abs(dec - function_plain(key, x))
            err, mean = float(diff.max()), float(diff.mean())
            off = got["composable"][1]
            fault = key in FUNCTION_FAULTS
            if fault:
                ok = bool(FUNCTION_FAULTS[key][1](x, dec))
                limit = "the reference's fault reproduced" if ok else "FAULT NOT REPRODUCED"
            else:
                tol, mean_tol = function_tolerance(key)
                ok = bool(np.isfinite(dec).all()) and err <= tol and mean <= mean_tol
                limit = f"limits {tol:g}, mean {mean_tol:g}"
            want_rounds = FUNCTION_CPU[key][0]
            same = (stats["rounds"], stats["bytes"]) == (off["rounds"], off["bytes"])
            ran = {k: n for k, n in launches.items() if n}
            log(f"[functions] {key} {over or 'default'}: max |err| {err:.6g}, mean {mean:.6g} "
                f"({limit}); "
                f"{stats['rounds']} rounds (CPU {want_rounds}), {stats['bytes']} bytes; "
                f"composable route {off['rounds']} rounds, {off['bytes']} bytes"
                f"{'' if same else ' DIFFER'}; fused {secs * 1e3:.2f} ms, composable "
                f"{got['composable'][3] * 1e3:.2f} ms; launches {ran}")
            rows[key] = dict(err=err, mean_err=mean, rounds=stats["rounds"], bytes=stats["bytes"])
            if not ok:
                failures.append(f"functions {key}: max |err| {err}, mean {mean} ({limit})")
            if not same:
                failures.append(f"functions {key}: fused {stats} != composable {off}")
            if stats["rounds"] != want_rounds:
                failures.append(f"functions {key}: {stats['rounds']} rounds != CPU {want_rounds}")
            del got, out, xe
    log(f"[functions] {len(FUNCTION_CASES)} (function, method) cases on {FUNCTION_SHAPE}, both "
        f"routes, in {time.perf_counter() - t_phase:.1f} s; launches {total['launches']}")
    by_kernel = {k: total["launches"].get(k, 0) for k in PATH_FAMILIES + (MASKED,)}
    if recorded_launches(calls) != (by_kernel, total["by_op"]):
        failures.append(f"functions recorded launches {recorded_launches(calls)} != counted "
                        f"{(by_kernel, total['by_op'])}")
    missing = [k for k in ("ring_mm", "philox", "fused_mul", "ltz", "max_step")
               if not by_kernel.get(k)]
    if missing:
        failures.append(f"functions launched no {missing}")
    torch.cuda.empty_cache()
    return dict(calls=calls, launches=by_kernel, by_op=total["by_op"], rows=rows), failures


# ---------------------------------------------------------------------------
# Phases 8 and 9: BERT
# ---------------------------------------------------------------------------

def bert_hidden(model, xe, skip=None):
    """The last block's output of a private Bert forward, block ``skip``
    left out."""
    h = model.ln(model.embed(xe))
    for i, block in enumerate(model.blocks):
        if i != skip:
            h = block(h)
    return h


def run_bert(dev):
    """Phase 8: BertLarge as bench.py builds it for BENCH_MODEL=BertLarge
    (bench.py:201-226): ``BertLarge(seq_len=64, full=True)`` encrypted by
    party 0, materialized (no GEOM), under bench.py's kernel configuration
    with head_chunk_positions 64, weights from a numpy seed, bench.py's
    tokens: latency, rounds, bytes, launches, peak memory; the last block's
    output against float64 under BERT_SCALE_FREE_L2, and one block left out
    above it."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.models import BertLarge, load_numpy_state_dict, plain_bert_forward

    ct.init(world_size=2, seed=SEED)
    t0 = time.perf_counter()
    model = BertLarge(seq_len=SEQ, full=True)
    d, heads, blocks, vocab = (model.embed_dim, model.blocks._modules["0"].attn.num_heads,
                               model.num_blocks, model.vocab_size)
    sd = random_gpt2_state(np.random.default_rng(4321), SEQ, blocks, d=d, vocab=vocab)
    load_numpy_state_dict(model, sd)
    torch.cuda.reset_peak_memory_stats()
    model.encrypt(src=0)
    torch.cuda.synchronize()
    resident = model.resident_share_bytes()
    log(f"[bert] BertLarge ({d} wide, {heads} heads, {blocks} blocks, vocab {vocab}) built and "
        f"encrypted in {time.perf_counter() - t0:.1f} s; resident shares {resident / 2**30:.3f} GiB")
    tokens = np.random.default_rng(0).integers(0, 1000, size=(1, SEQ)).astype(np.float64)
    ids = tokens.astype(np.int64)
    t0 = time.perf_counter()
    W = {k: torch.as_tensor(v, dtype=torch.float64, device=dev) for k, v in sd.items()}
    ref = plain_bert_forward(W, ids, heads, blocks, dev, head=False)[0].cpu().numpy()
    skip_err = [hidden_stats(plain_bert_forward(W, ids, heads, blocks, dev, skip=j,
                                                head=False)[0].cpu().numpy(),
                             ref)["scale_free_l2"] for j in range(blocks)]
    del W, sd
    j = int(np.argmin(skip_err))
    log(f"[bert] float64 reference and {blocks} plaintext forwards with one block left out in "
        f"{time.perf_counter() - t0:.1f} s; scale-free rel L2 without one block: min "
        f"{skip_err[j]:.5f} (block {j}), max {max(skip_err):.5f}")
    xe = ct.cryptensor(tokens, precision=0)
    config = dict(BENCH_CONFIG, **{"models.head_chunk_positions": SEQ})
    failures = []
    with cfg.temp_override(config):
        t0 = time.perf_counter()
        with recording_launches() as calls:
            h = bert_hidden(model, xe)
            probs = model.softmax(model.fc(h))
        hidden = h.get_plain_text()
        log(f"[bert] warm-up forward {time.perf_counter() - t0:.2f} s")
        lat = []
        for i in range(3):
            if i == 2:
                reset_launches()
                ct.reset_communication_stats()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(xe)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if i == 2:
                launches, by_op, _ = read_launches()
                stats = ct.get_communication_stats()
                peak = torch.cuda.max_memory_allocated()
        out = out.get_plain_text()
        busy = profile_forward(model, xe, min(lat), tag="profile bert")
        fault = hidden_stats(bert_hidden(model, xe, skip=j).get_plain_text(), ref)
    sound = hidden_stats(hidden, ref)
    log(f"[bert] latencies {', '.join(f'{x:.4f}' for x in lat)} s; "
        f"{SEQ / min(lat):.1f} tokens/s (best)")
    log(f"[bert] one forward: {stats['rounds']} rounds (the CPU count {BERT_ROUNDS}), "
        f"{stats['bytes']} bytes per party; launches {launches}; fused_mul by op {by_op}")
    log(f"[bert] peak device memory {peak / 2**30:.2f} GiB in the forward, "
        f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before it")
    log(f"[bert] last block's output: {fmt_stats(sound)} (bound: scale-free rel L2 "
        f"{BERT_SCALE_FREE_L2})")
    log(f"[bert] planted fault, private forward without block {j}: {fmt_stats(fault)}")
    if out.shape != (1, SEQ, vocab) or not np.isfinite(out).all() or not np.isfinite(hidden).all():
        failures.append(f"bert output {out.shape} or its hidden state is not finite")
    if stats["rounds"] != BERT_ROUNDS:
        failures.append(f"bert rounds {stats['rounds']} != the CPU count {BERT_ROUNDS}")
    if sound["scale_free_l2"] > BERT_SCALE_FREE_L2:
        failures.append(f"bert last block's output ({fmt_stats(sound)}) exceeds its bound")
    if fault["scale_free_l2"] <= BERT_SCALE_FREE_L2:
        failures.append(f"bert planted fault ({fmt_stats(fault)}) passes the bound "
                        f"{BERT_SCALE_FREE_L2}")
    missing = [k for k, n in launches.items()
               if n == 0 and k not in ("seed_expand", "open", MASKED)]
    missing += unlaunched_chains(by_op)
    if missing:
        failures.append(f"bert forward launched no {missing}: {launches}, {by_op}")
    if recorded_launches(calls) != (launches, by_op):
        failures.append(f"bert recorded launches {recorded_launches(calls)} != counted "
                        f"{(launches, by_op)}")
    res = dict(calls=calls, launches=launches, by_op=by_op, stats=stats, best_s=min(lat),
               busy_ms=busy, peak=peak)
    del model, probs, h, xe
    gc.collect()
    torch.cuda.empty_cache()
    return res, failures


QNLI_DIR = os.path.join("benchmarks", "checkpoints", "bert-tiny-qnli")


def qnli_rows(rng, rows, seq):
    """[CLS] a [SEP] b [SEP] then [PAD] to seq: word ids in [5, 9322) (the
    words of vocab.txt below its first [unused] entry), segments of 3 to
    20 words, type ids 0 for the first segment, 1 for the second."""
    ids = np.zeros((rows, seq), dtype=np.int64)
    types = np.zeros((rows, seq), dtype=np.int64)
    for r in range(rows):
        a, b = rng.integers(3, 21, size=2)
        ids[r, 0] = 2
        ids[r, 1:1 + a] = rng.integers(5, 9322, size=a)
        ids[r, 1 + a] = 3
        ids[r, 2 + a:2 + a + b] = rng.integers(5, 9322, size=b)
        ids[r, 2 + a + b] = 3
        types[r, 2 + a:3 + a + b] = 1
    return ids, types


def qnli_model(root):
    """The bert-tiny-qnli checkpoint through the port's reader as
    BertTinyForSequenceClassification(seq_len=64): (plaintext model, its
    float64 state dict, 8 rows of ids and type ids from numpy seed 0)."""
    from curl_tpu_torch.models import BertTinyForSequenceClassification, load_safetensors

    model = BertTinyForSequenceClassification(seq_len=SEQ)
    model.load_hf_state_dict(load_safetensors(os.path.join(root, QNLI_DIR, "model.safetensors")))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ids, types = qnli_rows(np.random.default_rng(0), QNLI_ROWS, SEQ)
    return model, sd, ids, types


def qnli_private(model, ids_e, types_e, skip=None):
    """Private logits, block ``skip`` left out."""
    h = model.embed(ids_e, types_e)
    for i, block in enumerate(model.blocks):
        if i != skip:
            h = block(h)
    return model.head(h)


def rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def run_qnli(dev, root):
    """Phase 9: the repo's trained bert-tiny-qnli checkpoint, read by the
    port's own reader, classifies 8 rows privately under bench.py's kernel
    configuration: the logits' relative L2 error against the float64
    classifier under QNLI_LOGITS_REL_L2, the argmax agreement, block 1 left
    out above the bound; latency, rounds, bytes."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.models import plain_classifier_forward

    ct.init(world_size=2, seed=SEED)
    model, sd, ids, types = qnli_model(root)
    model.encrypt(src=0)
    ref = plain_classifier_forward(sd, ids, types, model.cfg, device=dev).cpu().numpy()
    plain_fault = plain_classifier_forward(sd, ids, types, model.cfg, device=dev,
                                           skip=1).cpu().numpy()
    ids_e = ct.cryptensor(ids.astype(np.float64), precision=0)
    types_e = ct.cryptensor(types.astype(np.float64), precision=0)
    failures = []
    with cfg.temp_override(BENCH_CONFIG):
        with recording_launches() as calls:
            logits = model(ids_e, types_e).get_plain_text()
        lat = []
        for i in range(3):
            if i == 2:
                reset_launches()
                ct.reset_communication_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(ids_e, types_e)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if i == 2:
                launches, by_op, _ = read_launches()
                stats = ct.get_communication_stats()
        fault = qnli_private(model, ids_e, types_e, skip=1).get_plain_text()
    err, fault_err = rel_l2(logits, ref), rel_l2(fault, ref)
    agree = int((logits.argmax(-1) == ref.argmax(-1)).sum())
    log(f"[qnli] {QNLI_DIR} through load_safetensors: {len(sd)} parameters; {QNLI_ROWS} rows, "
        f"{int((ids > 0).sum())} of {ids.size} positions words or markers")
    log(f"[qnli] latencies {', '.join(f'{x:.4f}' for x in lat)} s "
        f"({QNLI_ROWS * SEQ / min(lat):.1f} tokens/s best); {stats['rounds']} rounds (the CPU "
        f"count {QNLI_ROUNDS}), {stats['bytes']} bytes per party; launches {launches}")
    log(f"[qnli] logits against float64: relative L2 {err:.5f} (bound {QNLI_LOGITS_REL_L2}); "
        f"argmax agrees on {agree} of {QNLI_ROWS} rows (the CPU run: {QNLI_AGREE}); the "
        f"plaintext without block 1: {rel_l2(plain_fault, ref):.5f}")
    log(f"[qnli] planted fault, private forward without block 1: relative L2 {fault_err:.5f}")
    log(f"[qnli] private logits {np.round(logits, 4).tolist()}; float64 {np.round(ref, 4).tolist()}")
    if not np.isfinite(logits).all() or logits.shape != (QNLI_ROWS, 2):
        failures.append(f"qnli logits {logits.shape} not finite ({QNLI_ROWS}, 2)")
    if err > QNLI_LOGITS_REL_L2:
        failures.append(f"qnli logits relative L2 {err} > {QNLI_LOGITS_REL_L2}")
    if fault_err <= QNLI_LOGITS_REL_L2:
        failures.append(f"qnli planted fault {fault_err} passes the bound {QNLI_LOGITS_REL_L2}")
    if agree < QNLI_AGREE:
        failures.append(f"qnli argmax agrees on {agree} rows, the CPU run on {QNLI_AGREE}")
    if stats["rounds"] != QNLI_ROUNDS:
        failures.append(f"qnli rounds {stats['rounds']} != the CPU count {QNLI_ROUNDS}")
    if recorded_launches(calls) != (launches, by_op):
        failures.append(f"qnli recorded launches {recorded_launches(calls)} != counted "
                        f"{(launches, by_op)}")
    res = dict(calls=calls, launches=launches, by_op=by_op, stats=stats, best_s=min(lat))
    del model
    torch.cuda.empty_cache()
    return res, failures


# ---------------------------------------------------------------------------
# Phase 11: private ResNet inference at 224 x 224 (ResNet-18 and ResNet-50)
# ---------------------------------------------------------------------------

# examples/mpc_imagenet.py's models at their true ImageNet size: batch 1,
# 3 x 224 x 224, numpy seed 0 normal x 0.5, 1000 classes; He-normal weights
# from numpy seed 1234, each BatchNorm's running statistics from a float64
# forward over that input
RESNET_SIZE = 224
RESNET_CLASSES = 1000
RESNET_WEIGHT_SEED = 1234
# (model, captured by compile_parties)
RESNETS = (("resnet18", True), ("resnet50", False))
# The bound on the logits' relative L2 error against float64, and each
# model's rounds, fixed before the first run of the phase from CPU runs of
# the port at full width and depth on reduced inputs
# (scripts/torch_resnet_bound.py, PERF.md §6): at 192 x 192 ResNet-18 read
# 0.0026 and ResNet-50 0.0184, at 128 x 128 0.0031 (session seeds 11, 1 and
# 2 alike) and 0.0364; the least-felt block left out read 0.30 and 0.20 at
# 192. Smaller inputs read worse: a BatchNorm whose statistics come from a
# few positions (2 x 2 in layer4 at 64 x 64) scales the protocol's noise up
# by 1 / sqrt(var). The rounds do not depend on the input size.
RESNET_LOGITS_REL_L2 = 0.06
RESNET_ROUNDS = {"resnet18": 285, "resnet50": 706}
# kernels a ResNet forward does not launch: no compressed weight, no masked
# operand (ring_mm_acc's 3 pairs), no exp (the square chain) and windows of
# 16 lanes (no fold)
RESNET_UNLAUNCHED = ("seed_expand", "open", "ring_mm_acc 3 pairs", "fused_mul square chain",
                     "max_step fold")


def resnet_input(size=RESNET_SIZE):
    """examples/mpc_imagenet.py's input (its line 29): (1, 3, size, size)."""
    return np.random.default_rng(0).normal(size=(1, 3, size, size)) * 0.5


def resnet_state(model, x, dev, seed=RESNET_WEIGHT_SEED):
    """A numpy state dict for ``model`` (the port's or curl_tpu's ResNet,
    torchvision's keys): conv and fc weights He-normal (std sqrt(2 /
    fan_in)), BatchNorm weights 1 + 0.1 N(0, 1), biases 0.1 N(0, 1), drawn
    in the port's key order from numpy ``seed``; then each BatchNorm's
    running mean and (biased) variance from a float64 forward over ``x``
    that normalizes by its batch statistics."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, v in model.state_dict().items():
        shape = tuple(v.shape)
        if key.endswith(("running_mean", "running_var")):
            continue
        if len(shape) > 1:
            sd[key] = rng.standard_normal(shape) * math.sqrt(2.0 / math.prod(shape[1:]))
        elif key.endswith("weight"):
            sd[key] = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            sd[key] = 0.1 * rng.standard_normal(shape)
    plain_resnet_forward(sd, x, dev, calibrate=True)
    return sd


def _resnet_blocks(sd):
    """(layer, block) of every residual block in forward order."""
    return sorted({(int(k.split(".")[0][5:]), int(k.split(".")[1])) for k in sd
                   if k.startswith("layer")})


def skippable_blocks(sd):
    """The blocks whose input and output shapes agree (no downsample): the
    ones a planted fault can leave out."""
    return [(li, bi) for li, bi in _resnet_blocks(sd)
            if f"layer{li}.{bi}.downsample.0.weight" not in sd]


def plain_resnet_forward(sd, x, dev, skip=None, calibrate=False):
    """The float64 forward of a ResNet state dict on ``dev`` (logits as a
    numpy array), block ``skip`` left out; BatchNorm at eval by the running
    statistics, as the private forward computes it ((x - mean) * (1 /
    sqrt(var + eps)) * weight + bias), or with ``calibrate`` by the batch's
    statistics, which it writes into ``sd``."""
    F = torch.nn.functional

    def t(key):
        return torch.as_tensor(np.asarray(sd[key]), dtype=torch.float64, device=dev)

    def bn(p, h):
        if calibrate:
            sd[p + "running_mean"] = h.mean((0, 2, 3)).cpu().numpy()
            sd[p + "running_var"] = h.var((0, 2, 3), unbiased=False).cpu().numpy()
        view = (1, -1, 1, 1)
        inv = 1.0 / torch.sqrt(t(p + "running_var") + 1e-5)
        return ((h - t(p + "running_mean").view(view)) * inv.view(view) * t(p + "weight").view(view)
                + t(p + "bias").view(view))

    h = torch.as_tensor(x, dtype=torch.float64, device=dev)
    h = F.relu(bn("bn1.", F.conv2d(h, t("conv1.weight"), stride=2, padding=3)))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    for li, bi in _resnet_blocks(sd):
        if (li, bi) == skip:
            continue
        p = f"layer{li}.{bi}."
        stride = 2 if li > 1 and bi == 0 else 1
        identity = h
        if p + "downsample.0.weight" in sd:
            identity = bn(p + "downsample.1.", F.conv2d(h, t(p + "downsample.0.weight"),
                                                       stride=stride))
        if p + "conv3.weight" in sd:  # Bottleneck
            out = F.relu(bn(p + "bn1.", F.conv2d(h, t(p + "conv1.weight"))))
            out = F.relu(bn(p + "bn2.", F.conv2d(out, t(p + "conv2.weight"), stride=stride,
                                                 padding=1)))
            out = bn(p + "bn3.", F.conv2d(out, t(p + "conv3.weight")))
        else:
            out = F.relu(bn(p + "bn1.", F.conv2d(h, t(p + "conv1.weight"), stride=stride,
                                                 padding=1)))
            out = bn(p + "bn2.", F.conv2d(out, t(p + "conv2.weight"), padding=1))
        h = F.relu(out + identity)
    h = h.mean((2, 3))
    return (h @ t("fc.weight").T + t("fc.bias")).cpu().numpy()


def resnet_private(model, xe, skip=None):
    """The private logits through the model's own modules in forward
    order, block ``skip`` (layer, block) left out."""
    out = model.maxpool(model.bn1(model.conv1(xe)).relu())
    for li in range(1, 5):
        for bi, block in enumerate(getattr(model, f"layer{li}")):
            if (li, bi) != skip:
                out = block(out)
    return model.fc(out.adaptive_avg_pool2d((1, 1)).flatten(1))


def build_resnet(name, dev, size=RESNET_SIZE):
    """(model encrypted by party 0, its state dict, the input, the float64
    logits, the planted fault's block and the plaintext's relative L2
    without it): the fault is the block whose absence the float64 logits
    feel least."""
    from curl_tpu_torch import models
    from curl_tpu_torch.models import load_numpy_state_dict
    from curl_tpu_torch.nn.module import skip_init

    x = resnet_input(size)
    with skip_init():
        model = getattr(models, name)(num_classes=RESNET_CLASSES)
    sd = resnet_state(model, x, dev)
    load_numpy_state_dict(model, sd)
    model.encrypt(src=0)
    ref = plain_resnet_forward(sd, x, dev)
    felt = {b: rel_l2(plain_resnet_forward(sd, x, dev, skip=b), ref) for b in skippable_blocks(sd)}
    fault = min(felt, key=felt.get)
    return model, sd, x, ref, fault, felt[fault]


@contextlib.contextmanager
def counting_columns():
    """The im2col column matrices the ring convolutions copy while the
    context is open: {"matrices": n, "bytes": b} (a 1 x 1 convolution at
    stride 1 reads its input in place and copies none)."""
    from curl_tpu_torch import ring

    made = {"matrices": 0, "bytes": 0}
    orig = ring._columns

    def columns(x, *args):
        cols, out = orig(x, *args)
        if cols.untyped_storage().data_ptr() != x.untyped_storage().data_ptr():
            made["matrices"] += 1
            made["bytes"] += cols.numel() * cols.element_size()
        return cols, out

    ring._columns = columns
    try:
        yield made
    finally:
        ring._columns = orig


def resnet_readings(logits, ref):
    """(relative L2 against float64, top-1 agreement of every row)."""
    return rel_l2(logits, ref), int((logits.argmax(-1) == ref.argmax(-1)).sum())


def run_resnet(dev, name, capture):
    """Phase 11: ``name`` (resnet18 or resnet50) at 3 x 224 x 224, batch 1,
    1000 classes, under bench.py's kernel configuration, 2 parties, session
    seed 11: build and encrypt, a warm-up forward recording every launch
    signature (for phase 5), 3 forwards (the last counted: launches,
    CommStats, peak memory), one profiled; the logits against float64 under
    RESNET_LOGITS_REL_L2 and top-1 agreement, the rounds against the CPU
    count, the least-felt block left out above the bound; with ``capture``
    the forward through compile_parties(model.functional()) too."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg

    ct.init(world_size=2, seed=SEED)
    t0 = time.perf_counter()
    model, sd, x, ref, fault_block, plain_fault = build_resnet(name, dev)
    n_params = sum(np.asarray(v).size for k, v in sd.items() if "running" not in k)
    resident = model.resident_share_bytes()
    log(f"[{name}] {n_params} parameters, He-normal from numpy seed {RESNET_WEIGHT_SEED}, "
        f"BatchNorm statistics from the float64 forward; built, calibrated and encrypted in "
        f"{time.perf_counter() - t0:.1f} s; resident shares {resident / 2**30:.3f} GiB; the "
        f"plaintext without block {fault_block} (the least felt): relative L2 {plain_fault:.5f}")
    xe = ct.cryptensor(x)
    failures = []
    with cfg.temp_override(BENCH_CONFIG):
        t0 = time.perf_counter()
        with recording_launches() as calls:
            logits = model(xe).get_plain_text()
        log(f"[{name}] warm-up forward {time.perf_counter() - t0:.2f} s")
        lat = []
        for i in range(3):
            if i == 2:
                reset_launches()
                ct.reset_communication_stats()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(xe)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if i == 2:
                launches, by_op, _ = read_launches()
                stats = ct.get_communication_stats()
                peak = torch.cuda.max_memory_allocated()
        del out
        with counting_columns() as columns:
            model(xe)
        busy = profile_forward(model, xe, min(lat), tag=f"profile {name}")
        fault = resnet_private(model, xe, skip=fault_block).get_plain_text()
    err, agree = resnet_readings(logits, ref)
    fault_err, _ = resnet_readings(fault, ref)
    log(f"[{name}] latencies {', '.join(f'{v:.4f}' for v in lat)} s (best {min(lat):.4f} s, "
        f"{1 / min(lat):.2f} images/s; {nvidia_smi_line()})")
    log(f"[{name}] one forward: {stats['rounds']} rounds (the CPU count {RESNET_ROUNDS[name]}), "
        f"{stats['bytes']} bytes per party; launches {launches}; fused_mul and max_step by op "
        f"{by_op}")
    log(f"[{name}] peak device memory {peak / 2**30:.2f} GiB in the forward, "
        f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before it")
    log(f"[{name}] im2col: {columns['matrices']} column matrices copied in one forward, "
        f"{columns['bytes']} bytes ({columns['bytes'] / 2**20:.1f} MiB), the dealer's and both "
        f"parties' Beaver operands")
    log(f"[{name}] logits against float64: relative L2 {err:.5f} (bound {RESNET_LOGITS_REL_L2}), "
        f"top-1 {'agrees' if agree else 'differs'} (private {int(logits.argmax())}, float64 "
        f"{int(ref.argmax())})")
    log(f"[{name}] planted fault, private forward without block {fault_block}: relative L2 "
        f"{fault_err:.5f}")
    if logits.shape != (1, RESNET_CLASSES) or not np.isfinite(logits).all():
        failures.append(f"{name} logits {logits.shape} not finite (1, {RESNET_CLASSES})")
    if err > RESNET_LOGITS_REL_L2:
        failures.append(f"{name} logits relative L2 {err} > {RESNET_LOGITS_REL_L2}")
    if fault_err <= RESNET_LOGITS_REL_L2:
        failures.append(f"{name} planted fault {fault_err} passes the bound {RESNET_LOGITS_REL_L2}")
    if stats["rounds"] != RESNET_ROUNDS[name]:
        failures.append(f"{name} rounds {stats['rounds']} != the CPU count {RESNET_ROUNDS[name]}")
    missing = [k for k, n in launches.items() if n == 0 and k not in RESNET_UNLAUNCHED]
    missing += [c for c in unlaunched_chains(by_op) if c not in RESNET_UNLAUNCHED]
    if missing:
        failures.append(f"{name} forward launched no {missing}: {launches}, {by_op}")
    if recorded_launches(calls) != (launches, by_op):
        failures.append(f"{name} recorded launches {recorded_launches(calls)} != counted "
                        f"{(launches, by_op)}")
    res = dict(calls=calls, launches=launches, by_op=by_op, stats=stats, best_s=min(lat),
               busy_ms=busy, peak=peak)
    if capture:
        res["captured"], more = run_captured_resnet(name, model, xe, ref, res)
        failures += more
    del model, xe
    gc.collect()
    torch.cuda.empty_cache()
    return res, failures


def run_captured_resnet(name, model, xe, ref, res):
    """Phase 11's capture: ``compile_parties(model.functional())`` at
    CAPTURE_SEED (launch counts and CommStats reset just before and read
    just after), replays at REPLAYS fresh seeds, the capture seed again,
    and the forward eagerly under the capture seed's keys from the
    capture's draw counter: bit-identical to the replay, equal CommStats
    and launches, the logits of two seeds within the bound."""
    import curl_tpu_torch as ct
    from curl_tpu_torch import random as crandom
    from curl_tpu_torch.config import cfg

    tag = f"captured {name}"
    apply_fn, params = model.functional()
    step = ct.compile_parties(apply_fn, 2)
    with cfg.temp_override(BENCH_CONFIG):
        reset_launches()
        ct.reset_communication_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        first = step(CAPTURE_SEED, params, xe)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches, by_op, _ = read_launches()
        stats = ct.get_communication_stats()
        graph = torch.cuda.memory_allocated() - held
        first_logits = first.get_plain_text()
        lat, other = [], None
        for i in range(REPLAYS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(CAPTURE_SEED + 1 + i, params, xe)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if other is None:
                other = out.get_plain_text()
        again = step(CAPTURE_SEED, params, xe)
        after = ct.get_communication_stats()
        peak = torch.cuda.max_memory_allocated() - held
        reset_launches()
        ct.reset_communication_stats()
        resume = crandom.counter()
        crandom.set_counter(step.counter)
        with ct.parallel.mpc_context(crandom.make_party_keys(CAPTURE_SEED, 2), 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager = apply_fn(params, xe)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
        crandom.set_counter(resume)
        eager_launches, eager_by_op, _ = read_launches()
        eager_stats = ct.get_communication_stats()
        best = min(lat)
        busy = profile_forward(None, None, best, tag=f"profile, {tag}", top=6,
                               call=lambda: step(CAPTURE_SEED + REPLAYS + 1, params, xe))
    log(f"[{tag}] first call {first_s:.2f} s: warm-up forward {step.warmup_s:.2f} s, capture "
        f"and instantiation {step.capture_s:.2f} s, one replay; the graph keeps "
        f"{step.constants} public constants")
    log(f"[{tag}] the capture's launches {launches}; fused_mul and max_step by op {by_op}")
    log(f"[{tag}] replay latencies {', '.join(f'{v:.4f}' for v in lat)} s: best {best:.4f} s, "
        f"{1 / best:.2f} images/s; the eager forward beside it {eager_s:.4f} s (the eager "
        f"best {res['best_s']:.4f} s; {nvidia_smi_line()})")
    log(f"[{tag}] device memory: the graph's pool and buffers hold {graph / 2**30:.3f} GiB "
        f"after the capture; peak {peak / 2**30:.3f} GiB above the {held / 2**30:.2f} GiB "
        f"held before it")
    checks = {
        "replay at the capture seed bit-identical to the eager forward at its keys and counter":
            torch.equal(first.share, eager.share),
        "the same seed twice bit-identical": torch.equal(first.share, again.share),
        "two seeds different logits": not np.array_equal(first_logits, other),
        "rounds and bytes of the capture equal the eager forward's":
            (stats["rounds"], stats["bytes"]) == (eager_stats["rounds"], eager_stats["bytes"])
            == (res["stats"]["rounds"], res["stats"]["bytes"]) and after == stats,
        "the capture launched every kernel the eager forward launched, as often":
            (launches, by_op) == (eager_launches, eager_by_op) == (res["launches"], res["by_op"]),
    }
    for seed, logits in ((CAPTURE_SEED, first_logits), (CAPTURE_SEED + 1, other)):
        err, agree = resnet_readings(logits, ref)
        log(f"[{tag}] logits at seed {seed}: relative L2 {err:.5f}, top-1 "
            f"{'agrees' if agree else 'differs'}")
        checks[f"logits at seed {seed} within relative L2 {RESNET_LOGITS_REL_L2}"] = (
            np.isfinite(logits).all() and err <= RESNET_LOGITS_REL_L2)
    for check, ok in checks.items():
        log(f"[{tag}] {check}: {'held' if ok else 'FAILED'}")
    failures = [f"{tag}: {check}" for check, ok in checks.items() if not ok]
    chains = {c: sum(n for t, n in by_op.items() if is_tag(t)) for c, is_tag in CHAIN_TAGS.items()}
    return dict(launches=launches, chains=chains, best_s=best, eager_s=eager_s, busy_ms=busy,
                capture_s=step.capture_s, peak=peak), failures


# ---------------------------------------------------------------------------
# Phase 12: private training (autograd, the loss, SGD, a captured step)
# ---------------------------------------------------------------------------

# examples/mpc_cifar.py's training path at full width: LeNet on 3 x 32 x 32,
# 10 classes, batch 64, CrossEntropyLoss on public one-hot labels, SGD at
# lr 0.01 (its line 70)
LENET_BATCH = 64
LENET_CLASSES = 10
LENET_LR = 0.01
LENET_WEIGHT_SEED = 1213
LENET_DATA_SEED = 1214
LENET_STEPS = 3
# the captured step's fed-back replays, each at a fresh seed after
# CAPTURE_SEED's
TRAIN_REPLAYS = 3
TRAIN_PATH = "train"
# The bounds, fixed from CPU runs of the port at full width before the
# phase's first card run (scripts/torch_train_bound.py at session seeds 11,
# 1 and 2, PERF.md §6), each 1.5 times the worst of the three readings: the
# relative L2 error against float64 of step 1's gradient of each parameter
# (conv1's read 0.35-0.36 for the weight and 0.39-0.63 for the bias, conv2's
# 0.12-0.20, the linears' 0.03-0.05: gradients a batch of 64 divides down
# to a few units of the 16-bit fixed point), of the parameters after the
# eager steps and after the captured ones (at most 0.00106), and the
# absolute error of each step's loss (at most 0.00064). The planted fault
# reads 1.0 for conv1's weight and bias. The rounds of one step (forward,
# backward and SGD) are the CPU count.
LENET_GRAD_REL_L2 = {"0.weight": 0.55, "0.bias": 0.95, "3.weight": 0.22, "3.bias": 0.31,
                     "7.weight": 0.08, "7.bias": 0.08, "9.weight": 0.05, "9.bias": 0.06,
                     "11.weight": 0.06, "11.bias": 0.06}
LENET_PARAM_REL_L2 = 0.0016
LENET_LOSS_ATOL = 0.001
LENET_ROUNDS = 197
# kernels a LeNet step does not launch: no compressed weight, no masked
# operand, log_softmax's exp over 64 x 10 below the squaring chain's least
# size, and windows of 4 and 16 lanes (no fold)
LENET_UNLAUNCHED = ("seed_expand", "open", "ring_mm_acc 3 pairs", "fused_mul square chain",
                    "max_step fold")


def build_lenet(nn):
    """examples/mpc_cifar.py's ``build_lenet`` (its lines 22-39), in either
    package's ``nn``: conv 3->6 5x5, ReLU, 2x2 max pool, conv 6->16 5x5,
    ReLU, 2x2 max pool, fc 400->120->84->10 with ReLUs between."""
    return nn.Sequential(
        nn.Conv2d(3, 6, 5), nn.ReLU(), nn.MaxPool2d(2),
        nn.Conv2d(6, 16, 5), nn.ReLU(), nn.MaxPool2d(2),
        nn.Flatten(),
        nn.Linear(16 * 5 * 5, 120), nn.ReLU(),
        nn.Linear(120, 84), nn.ReLU(),
        nn.Linear(84, LENET_CLASSES),
    )


# (state dict key, shape, fan_in) in build_lenet's order
LENET_PARAMS = tuple(
    (f"{i}.{kind}", shape if kind == "weight" else shape[:1], math.prod(shape[1:]))
    for i, shape in ((0, (6, 3, 5, 5)), (3, (16, 6, 5, 5)), (7, (120, 400)), (9, (84, 120)),
                     (11, (10, 84)))
    for kind in ("weight", "bias"))


def lenet_state(seed=LENET_WEIGHT_SEED):
    """A numpy state dict of LeNet: every weight and bias uniform in
    +-1/sqrt(fan_in), torch's default init (kaiming-uniform at a = sqrt(5)),
    drawn in key order from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    return {key: rng.uniform(-1, 1, shape) / math.sqrt(fan_in)
            for key, shape, fan_in in LENET_PARAMS}


def lenet_batch(batch=LENET_BATCH, seed=LENET_DATA_SEED):
    """(input (batch, 3, 32, 32) ~ N(0, 1), one-hot labels (batch, 10)) from
    numpy ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 3, 32, 32))
    return x, np.eye(LENET_CLASSES)[rng.integers(0, LENET_CLASSES, batch)]


def plain_lenet_trajectory(sd, x, labels, dev, steps, lr=LENET_LR):
    """The float64 SGD trajectory of LeNet on ``dev`` from state dict
    ``sd``, the same batch each step: (each step's loss, step 1's gradient
    of each parameter, the parameters after each step), numpy."""
    F = torch.nn.functional
    p = {k: torch.tensor(np.asarray(v), dtype=torch.float64, device=dev, requires_grad=True)
         for k, v in sd.items()}
    xt = torch.as_tensor(x, dtype=torch.float64, device=dev)
    yt = torch.as_tensor(labels, dtype=torch.float64, device=dev)
    losses, grads, params = [], None, []
    for _ in range(steps):
        h = F.max_pool2d(F.relu(F.conv2d(xt, p["0.weight"], p["0.bias"])), 2)
        h = F.max_pool2d(F.relu(F.conv2d(h, p["3.weight"], p["3.bias"])), 2).flatten(1)
        h = F.relu(F.linear(h, p["7.weight"], p["7.bias"]))
        h = F.relu(F.linear(h, p["9.weight"], p["9.bias"]))
        logits = F.linear(h, p["11.weight"], p["11.bias"])
        loss = -(yt * F.log_softmax(logits, -1)).sum() / xt.shape[0]
        g = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if grads is None:
            grads = {k: gi.cpu().numpy() for k, gi in zip(p, g)}
        with torch.no_grad():
            p = {k: (v - lr * gi).requires_grad_() for (k, v), gi in zip(p.items(), g)}
        params.append({k: v.detach().cpu().numpy() for k, v in p.items()})
    return losses, grads, params


def lenet_model(ct, sd):
    """The port's LeNet with state dict ``sd``, encrypted by party 0, its
    parameters autograd leaves."""
    from curl_tpu_torch.nn.module import skip_init

    with skip_init():
        model = build_lenet(ct.nn)
    model.load_state_dict(sd)
    return model.encrypt(src=0, requires_grad=True)


def lenet_forward(model, xe, detach_before=None):
    """The private logits through the model's modules in order; the input
    of module ``detach_before`` detached (the planted fault: no gradient
    flows back through it)."""
    out = xe
    for i, m in enumerate(model):
        if i == detach_before:
            out = out.detach()
        out = m(out)
    return out


def lenet_step(ct, model, opt, xe, labels, detach_before=None):
    """One eager SGD step, examples/mpc_cifar.py:73-79: zero_grad, the
    forward, the loss, backward, step. Returns the loss (encrypted)."""
    opt.zero_grad()
    loss = ct.nn.CrossEntropyLoss()(lenet_forward(model, xe, detach_before), labels)
    loss.backward()
    opt.step()
    return loss


def lenet_train_fn(ct, model, lr=LENET_LR):
    """The training step as compile_parties captures it (the shape of
    tests/test_compiled.py:30-63): ``(params, x, labels) -> (the new
    params, the loss)``, the parameters bound to the model and made
    autograd leaves, SGD's in-place swap on them, the model's
    ``params_pytree`` returned."""

    def step(p, xe, labels):
        model.bind_params(p)
        params = list(model.parameters())
        for t in params:
            t.requires_grad = True
        opt = ct.optim.SGD(params, lr=lr)
        loss = lenet_step(ct, model, opt, xe, labels)
        return model.params_pytree(), loss

    return step


def lenet_grads(model):
    """Each parameter's decoded gradient (zeros where it has none)."""
    return {k: (p.grad.get_plain_text() if p.grad is not None else np.zeros(p.shape))
            for k, p in model.named_parameters()}


def lenet_params(tree):
    """A LeNet params pytree's parameters, decoded, by state dict key."""
    return {f"{i}.{k}": t.get_plain_text() for i, sub in tree.items() if i != "__params__"
            for k, t in sub["__params__"].items()}


def rel_l2_by_key(got, ref):
    """Each parameter's relative L2 error, by state dict key."""
    return {k: rel_l2(np.asarray(got[k]), ref[k]) for k in ref}


def train_readings(ct, dev, batch=LENET_BATCH, steps=LENET_STEPS, replays=TRAIN_REPLAYS,
                   config=None):
    """Phase 12's numbers on any device (``scripts/torch_train_bound.py``
    runs it on the CPU): the planted fault, ``steps`` eager steps from
    lenet_state at ``batch``, then the step through compile_parties at
    CAPTURE_SEED and ``replays`` replays fed back, each against the float64
    trajectory."""
    x, labels = lenet_batch(batch)
    sd = lenet_state()
    total = steps + 1 + replays
    losses64, grads64, params64 = plain_lenet_trajectory(sd, x, labels, dev, total)
    model = lenet_model(ct, sd)
    opt = ct.optim.SGD(list(model.parameters()), lr=LENET_LR)
    xe = ct.cryptensor(x)
    yt = torch.as_tensor(labels, dtype=torch.float64, device=dev)
    res = {"losses64": losses64}
    with ct.cfg.temp_override(config or {}):
        opt.zero_grad()
        loss = ct.nn.CrossEntropyLoss()(lenet_forward(model, xe, detach_before=3), yt)
        loss.backward()
        res["fault"] = rel_l2_by_key(lenet_grads(model), grads64)
        losses = []
        for i in range(steps):
            ct.reset_communication_stats()
            losses.append(float(lenet_step(ct, model, opt, xe, yt).get_plain_text()))
            if i == 0:
                res["stats"] = ct.get_communication_stats()
                res["grads"] = rel_l2_by_key(lenet_grads(model), grads64)
        res["losses"] = losses
        res["params"] = rel_l2_by_key(
            {k: p.get_plain_text() for k, p in model.named_parameters()}, params64[steps - 1])
        step = ct.compile_parties(lenet_train_fn(ct, model), 2)
        p, loss = step(CAPTURE_SEED, model.params_pytree(), xe, yt)
        captured = [float(loss.get_plain_text())]
        for i in range(replays):
            p, loss = step(CAPTURE_SEED + 1 + i, p, xe, yt)
            captured.append(float(loss.get_plain_text()))
        res["captured_losses"] = captured
        res["captured_params"] = rel_l2_by_key(lenet_params(p), params64[-1])
        res["capture_stats"] = step.stats
    res["loss_err"] = max(abs(a - b) for a, b in zip(losses + captured, losses64))
    return res


def run_train(dev):
    """Phase 12: examples/mpc_cifar.py's training path at full width under
    bench.py's kernel configuration, 2 parties, session seed 11. The planted
    fault first (conv2's input detached: conv1 gets no gradient), then
    LENET_STEPS eager SGD steps, the first recording every launch signature
    (for phase 5) and counted (launches, CommStats), two more timed steps
    and one profiled (their updates undone); then the step through
    compile_parties at CAPTURE_SEED, fed back TRAIN_REPLAYS times at fresh
    seeds, more replays timed and one profiled, and the step run eagerly at
    the capture's keys and counter. Every gradient, loss and the parameters
    against the float64 trajectory under the bounds fixed from CPU runs."""
    import curl_tpu_torch as ct
    from curl_tpu_torch import random as crandom
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.parallel import runner

    ct.init(world_size=2, seed=SEED)
    t0 = time.perf_counter()
    x, labels = lenet_batch()
    sd = lenet_state()
    losses64, grads64, params64 = plain_lenet_trajectory(
        sd, x, labels, dev, LENET_STEPS + 1 + TRAIN_REPLAYS)
    model = lenet_model(ct, sd)
    params = list(model.parameters())
    opt = ct.optim.SGD(params, lr=LENET_LR)
    xe = ct.cryptensor(x)
    yt = torch.as_tensor(labels, dtype=torch.float64, device=dev)
    n_params = sum(v.size for v in sd.values())
    log(f"[train] LeNet, {n_params} parameters from numpy seed {LENET_WEIGHT_SEED}, batch "
        f"{LENET_BATCH} x 3 x 32 x 32, {LENET_CLASSES} classes, SGD lr {LENET_LR}; built, "
        f"encrypted and the float64 trajectory in {time.perf_counter() - t0:.1f} s")

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = lenet_step(ct, model, opt, xe, yt)
        torch.cuda.synchronize()
        return loss, time.perf_counter() - t

    with cfg.temp_override(BENCH_CONFIG):
        opt.zero_grad()
        ct.nn.CrossEntropyLoss()(lenet_forward(model, xe, detach_before=3), yt).backward()
        fault = rel_l2_by_key(lenet_grads(model), grads64)
        reset_launches()
        ct.reset_communication_stats()
        with recording_launches() as calls:
            loss, first_s = timed_step()
        launches, by_op, _ = read_launches()
        stats = ct.get_communication_stats()
        grads = rel_l2_by_key(lenet_grads(model), grads64)
        losses, lat = [float(loss.get_plain_text())], []
        for i in range(1, LENET_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            loss, secs = timed_step()
            if i == 1:
                peak = torch.cuda.max_memory_allocated()
            lat.append(secs)
            losses.append(float(loss.get_plain_text()))
        eager_params = rel_l2_by_key({k: p.get_plain_text() for k, p in model.named_parameters()},
                                     params64[LENET_STEPS - 1])
        # more steps, timed and profiled; their updates undone
        saved = [p._tensor for p in params]
        lat += [timed_step()[1] for _ in range(2)]
        best = min(lat)
        busy = profile_forward(None, None, best, tag="profile train", top=8,
                               call=lambda: lenet_step(ct, model, opt, xe, yt))
        for p, t in zip(params, saved):
            p._tensor, p.grad = t, None

        # the step captured by compile_parties and fed back
        train_fn = lenet_train_fn(ct, model)
        p0 = model.params_pytree()
        step = ct.compile_parties(train_fn, 2)
        reset_launches()
        ct.reset_communication_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cap_held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        first = step(CAPTURE_SEED, p0, xe, yt)
        torch.cuda.synchronize()
        cap_first_s = time.perf_counter() - t0
        cap_launches, cap_by_op, _ = read_launches()
        cap_stats = ct.get_communication_stats()
        graph = torch.cuda.memory_allocated() - cap_held
        p, loss = first
        cap_losses = [float(loss.get_plain_text())]
        for i in range(TRAIN_REPLAYS):
            p, loss = step(CAPTURE_SEED + 1 + i, p, xe, yt)
            cap_losses.append(float(loss.get_plain_text()))
        cap_params = rel_l2_by_key(lenet_params(p), params64[-1])
        fed = ct.get_communication_stats()  # the capture anew counted once more
        replay_lat = []
        for i in range(REPLAYS):  # timed: each from the same parameters
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(CAPTURE_SEED + 1 + TRAIN_REPLAYS + i, p, xe, yt)
            torch.cuda.synchronize()
            replay_lat.append(time.perf_counter() - t0)
        after = ct.get_communication_stats()
        cap_peak = torch.cuda.max_memory_allocated() - cap_held
        replay_best = min(replay_lat)
        replay_busy = profile_forward(
            None, None, replay_best, tag="profile, captured train", top=6,
            call=lambda: step(CAPTURE_SEED + 1 + TRAIN_REPLAYS + REPLAYS, p, xe, yt))

        # the step eagerly at the capture's keys and draw counter
        leaves = []
        fresh = runner._build(runner._flatten((p0, xe, yt), leaves), leaves, public=True)
        reset_launches()
        ct.reset_communication_stats()
        resume = crandom.counter()
        crandom.set_counter(step.counter)
        with ct.parallel.mpc_context(crandom.make_party_keys(CAPTURE_SEED, 2), 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager = train_fn(*fresh)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
        crandom.set_counter(resume)
        eager_launches, eager_by_op, _ = read_launches()
        eager_stats = ct.get_communication_stats()

    smi = nvidia_smi_line()
    loss_err = max(abs(a - b) for a, b in zip(losses + cap_losses, losses64))
    log(f"[train] one step (zero_grad, forward, loss, backward, SGD): {stats['rounds']} rounds "
        f"(the CPU count {LENET_ROUNDS}), {stats['bytes']} bytes per party; launches {launches}; "
        f"fused_mul and max_step by op {by_op}")
    log(f"[train] eager step latencies {', '.join(f'{v:.4f}' for v in lat)} s (the first, "
        f"recorded, {first_s:.4f} s): best {best:.4f} s, {LENET_BATCH / best:.1f} images/s; "
        f"peak device memory {(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB "
        f"held ({smi})")
    log(f"[train] captured: first call {cap_first_s:.2f} s (warm-up {step.warmup_s:.2f} s, "
        f"capture {step.capture_s:.2f} s), {step.captures} captures (the fed-back parameters "
        f"at new addresses once); replay latencies {', '.join(f'{v:.4f}' for v in replay_lat)} "
        f"s: best {replay_best:.4f} s, {LENET_BATCH / replay_best:.1f} images/s; the eager step "
        f"beside it {eager_s:.4f} s; the graph holds {graph / 2**30:.3f} GiB, peak "
        f"{cap_peak / 2**30:.3f} GiB above the {cap_held / 2**30:.3f} GiB held ({smi})")
    log(f"[train] the capture's launches {cap_launches}; by op {cap_by_op}")
    log("[train] step 1's gradients against float64, relative L2 (bound): " + ", ".join(
        f"{k} {v:.4f} ({LENET_GRAD_REL_L2[k]})" for k, v in grads.items()))
    log("[train] planted fault (conv2's input detached): " + ", ".join(
        f"{k} {v:.4f}" for k, v in fault.items()))
    log(f"[train] losses {', '.join(f'{v:.5f}' for v in losses)} eager, "
        f"{', '.join(f'{v:.5f}' for v in cap_losses)} captured and fed back; float64 "
        f"{', '.join(f'{v:.5f}' for v in losses64)}: worst error {loss_err:.6f} (bound "
        f"{LENET_LOSS_ATOL})")
    log(f"[train] parameters after {LENET_STEPS} eager steps, worst relative L2 "
        f"{max(eager_params.values()):.6f}; after {len(losses64)} steps (the captured fed back) "
        f"{max(cap_params.values()):.6f} (bound {LENET_PARAM_REL_L2})")
    same_out = torch.equal(first[1].share, eager[1].share) and all(
        torch.equal(a, b) for a, b in zip(runner_shares(first[0]), runner_shares(eager[0])))
    checks = {
        f"rounds of a step equal the CPU count {LENET_ROUNDS}": stats["rounds"] == LENET_ROUNDS,
        "every gradient of step 1 within its bound": all(
            v <= LENET_GRAD_REL_L2[k] for k, v in grads.items()),
        "the planted fault reads above the bound": any(
            v > LENET_GRAD_REL_L2[k] for k, v in fault.items()),
        f"every loss within {LENET_LOSS_ATOL} of float64's": loss_err <= LENET_LOSS_ATOL
            and all(np.isfinite(losses + cap_losses)),
        f"the parameters within relative L2 {LENET_PARAM_REL_L2} after the eager steps and "
        "after the captured ones": max(list(eager_params.values()) + list(cap_params.values()))
            <= LENET_PARAM_REL_L2,
        "the captured step bit-identical to the eager step at its keys and counter": same_out,
        "the capture's CommStats equal the eager step's and step 1's, the capture anew's "
        "the same again; replays count none":
            (cap_stats["rounds"], cap_stats["bytes"]) == (eager_stats["rounds"],
                                                          eager_stats["bytes"])
            == (stats["rounds"], stats["bytes"])
            and (fed["rounds"], fed["bytes"]) == (2 * stats["rounds"], 2 * stats["bytes"])
            and after == fed,
        "the capture launched every kernel the eager step launched, as often":
            (cap_launches, cap_by_op) == (eager_launches, eager_by_op) == (launches, by_op),
        "the fed-back parameters captured anew once": step.captures == 2,
    }
    missing = [k for k, n in launches.items() if n == 0 and k not in LENET_UNLAUNCHED]
    missing += [c for c in unlaunched_chains(by_op) if c not in LENET_UNLAUNCHED]
    checks["the step launched every kernel of the path"] = not missing
    checks["recorded launches equal the counted ones"] = recorded_launches(calls) == (launches,
                                                                                      by_op)
    for name, ok in checks.items():
        log(f"[train] {name}: {'held' if ok else 'FAILED'}")
    failures = [f"train: {name}" for name, ok in checks.items() if not ok]
    if missing:
        failures.append(f"train launched no {missing}")
    chains = {c: sum(n for t, n in cap_by_op.items() if is_tag(t))
              for c, is_tag in CHAIN_TAGS.items()}
    res = dict(calls=calls, launches=launches, by_op=by_op, stats=stats, best_s=best,
               busy_ms=busy, peak=peak)
    captured = dict(launches=cap_launches, chains=chains, best_s=replay_best, eager_s=eager_s,
                    busy_ms=replay_busy, capture_s=step.capture_s, peak=cap_peak)
    del model, opt, step, first, eager, p
    gc.collect()
    torch.cuda.empty_cache()
    return res, captured, failures


# ---------------------------------------------------------------------------
# Phase 13: bring your own model (from_pytorch, from_onnx, DPSplitModel)
# ---------------------------------------------------------------------------

CONVERT_PATH = "convert"
CONVERT_ONNX_PATH = "convert onnx"
DP_SPLIT_PATH = "dp split"


class TorchBasicBlock(torch.nn.Module):
    """torchvision's ``BasicBlock`` (torchvision/models/resnet.py), written
    as torchvision writes it: an in-place ReLU and ``out += identity``."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.conv1(x)
        out = self.bn1(out)
        out = self.relu(out)
        out = self.conv2(out)
        out = self.bn2(out)
        if self.downsample is not None:
            identity = self.downsample(x)
        out += identity
        out = self.relu(out)
        return out


class TorchResNet(torch.nn.Module):
    """torchvision's ``ResNet`` of BasicBlocks, its layout and keys: the
    7 x 7 stem at stride 2, BatchNorm, ReLU, the 3 x 3 max pool, four
    layers, ``AdaptiveAvgPool2d((1, 1))``, ``torch.flatten(x, 1)`` and the
    fc layer."""

    def __init__(self, layers=(2, 2, 2, 2), num_classes=RESNET_CLASSES):
        super().__init__()
        nn = torch.nn
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(64, layers[0])
        self.layer2 = self._make_layer(128, layers[1], stride=2)
        self.layer3 = self._make_layer(256, layers[2], stride=2)
        self.layer4 = self._make_layer(512, layers[3], stride=2)
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(512 * TorchBasicBlock.expansion, num_classes)

    def _make_layer(self, planes, blocks, stride=1):
        nn = torch.nn
        downsample = None
        if stride != 1 or self.inplanes != planes * TorchBasicBlock.expansion:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * TorchBasicBlock.expansion, 1, stride=stride,
                          bias=False),
                nn.BatchNorm2d(planes * TorchBasicBlock.expansion))
        layers = [TorchBasicBlock(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * TorchBasicBlock.expansion
        layers += [TorchBasicBlock(self.inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.conv1(x)
        x = self.bn1(x)
        x = self.relu(x)
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        x = self.avgpool(x)
        x = torch.flatten(x, 1)
        x = self.fc(x)
        return x


def torch_resnet18(dev, size=RESNET_SIZE):
    """(the torchvision-layout ResNet-18 in float64 on ``dev``, eval mode,
    holding phase 11's state dict, the input): the weights ``resnet_state``
    draws for the port's native resnet18 (numpy seed 1234, BatchNorm
    statistics from the float64 forward over the input)."""
    from curl_tpu_torch import models
    from curl_tpu_torch.nn.module import skip_init

    x = resnet_input(size)
    with skip_init():
        native = models.resnet18(num_classes=RESNET_CLASSES)
    sd = resnet_state(native, x, dev)
    model = TorchResNet().double()
    missing, unexpected = model.load_state_dict(
        {k: torch.as_tensor(np.asarray(v), dtype=torch.float64) for k, v in sd.items()},
        strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return model.to(dev).eval(), x


def torch_logits(model, x, dev):
    """The torch model's float64 logits on ``dev``, numpy."""
    with torch.no_grad():
        return model(torch.as_tensor(x, dtype=torch.float64, device=dev)).cpu().numpy()


def onnx_op_types(data):
    """{op_type: count} of the nodes of serialized ONNX bytes."""
    from curl_tpu_torch.utils import onnx_lite

    types = {}
    for node in onnx_lite.load_model(data).graph.nodes:
        types[node.op_type] = types.get(node.op_type, 0) + 1
    return types


# DPSplitModel over examples/mpc_cifar.py's LeNet (phase 12's architecture
# and weights, numpy seed 1213), a plain float32 torch model on the card, on
# phase 12's batch (numpy seed 1214) with 10 sigmoid outputs and multi-label
# 0/1 targets from numpy seed 1216; one step of each protocol
DP_TARGET_SEED = 1216
DP_PROTOCOLS = ("layer_estimation", "full_jacobian")
# the noise_magnitude of the noisy steps: the gradients are 1e-4 to 1e-2
DP_NOISE = 0.01


# The bounds and round counts, fixed before the phase's first card run from
# CPU runs of the port (scripts/torch_convert_bound.py, PERF.md §6). The
# converted ResNet-18 at 192 x 192 read 0.0026 through from_pytorch and
# 0.0023 through from_onnx of torch's export with constant folding (each
# BatchNorm folded into its convolution), session seeds 11, 1 and 2: phase
# 11's bound holds both. Its rounds do not depend on the input size:
# from_pytorch's are the native model's 285; the folded graph drops
# BatchNorm's private gain, 227. The export without folding keeps
# BatchNormalization nodes whose running statistics are encrypted
# initializers (curl_tpu's from_onnx does so): 567 rounds, and 0.38 from
# float64 at 192 through the private inv_sqrt, logged, not bounded. Each
# converted graph run in the clear: within 1e-9 of torch's float64 logits.
CONVERT_ROUNDS = {CONVERT_PATH: 285, CONVERT_ONNX_PATH: 227, "unfolded": 567}
CONVERT_PLAIN_REL_L2 = 1e-9
# DPSplitModel at batch 64: each protocol's step 21 rounds. Each gradient's
# relative L2 against torch's float64 BCEWithLogits gradient
# (DP_GRAD_REL_L2) and against the float64 backpropagation of what the
# protocol computes from the step's own decrypted dL/dZ (DP_OWN_REL_L2),
# each bound 1.5 times the worst of session seeds 11, 1 and 2 (at least
# 0.01). The default haar sigmoid errs up to 0.09 at logits near 0, a bias
# in dL/dZ that the batch does not average out: full_jacobian read
# 0.10-0.68 from BCEWithLogits, 0.00-0.05 from its own dL/dZ.
# layer_estimation solves dL/dZ through pinv(X) of the last Linear's
# 64 x 84 input, rank 59 (25 ReLUs dead on the whole batch): its error
# beyond the projection onto X's columns is the fixed point's, amplified by
# X's small singular values: 0.55-2.21 and 0.16-1.81, but 0.014 for the
# last Linear's weight. With noise, the deviation's standard deviation read
# -4% to +6% of the expected; DP_NOISE_TOL holds it.
DP_ROUNDS = {"layer_estimation": 21, "full_jacobian": 21}
DP_GRAD_REL_L2 = {
    "layer_estimation": {"0.weight": 2.6, "0.bias": 3.4, "3.weight": 1.9, "3.bias": 1.6,
                         "7.weight": 1.8, "7.bias": 1.7, "9.weight": 1.3, "9.bias": 1.3,
                         "11.weight": 0.83, "11.bias": 1.0},
    "full_jacobian": {"0.weight": 0.16, "0.bias": 1.1, "3.weight": 0.46, "3.bias": 0.53,
                      "7.weight": 0.8, "7.bias": 0.87, "9.weight": 0.78, "9.bias": 0.88,
                      "11.weight": 0.8, "11.bias": 0.87}}
DP_OWN_REL_L2 = {
    "layer_estimation": {"0.weight": 2.8, "0.bias": 1.7, "3.weight": 1.7, "3.bias": 1.2,
                         "7.weight": 1.4, "7.bias": 1.2, "9.weight": 0.88, "9.bias": 0.77,
                         "11.weight": 0.022, "11.bias": 0.25},
    "full_jacobian": {"0.weight": 0.027, "0.bias": 0.047, "3.weight": 0.034, "3.bias": 0.027,
                      "7.weight": 0.075, "7.bias": 0.031, "9.weight": 0.064, "9.bias": 0.011,
                      "11.weight": 0.023, "11.bias": 0.01}}
DP_NOISE_TOL = 0.15
# kernels a DP step must launch (its model runs in plain torch: no private
# pool and no ReLU)
DP_LAUNCHED = ("ring_mm", "ring_mm_acc", "philox", "fused_mul")


def dp_targets(batch=LENET_BATCH, seed=DP_TARGET_SEED):
    """Multi-label 0/1 targets (batch, 10) from numpy ``seed``."""
    return np.random.default_rng(seed).integers(0, 2, (batch, LENET_CLASSES)).astype(np.float64)


def torch_lenet(dev, dtype=torch.float32):
    """examples/mpc_cifar.py's LeNet as a plain torch model on ``dev``
    holding ``lenet_state()``."""
    model = build_lenet(torch.nn).to(dtype)
    model.load_state_dict({k: torch.as_tensor(v, dtype=dtype) for k, v in lenet_state().items()})
    return model.to(dev)


def dp_reference_grads(x, y, dev):
    """Each LeNet parameter's gradient of torch's float64 BCEWithLogits
    (the mean over every output), by state dict key, numpy."""
    model = torch_lenet(dev, torch.float64)
    logits = model(torch.as_tensor(x, dtype=torch.float64, device=dev))
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, torch.as_tensor(y, dtype=torch.float64, device=dev))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return {k: g.cpu().numpy() for (k, _), g in zip(model.named_parameters(), grads)}


def dp_protocol_reference(dp, x, dev):
    """Each LeNet parameter's float64 gradient backpropagated from what the
    step's protocol computes exactly from its own decrypted dL/dZ, so that
    the error left is the protocol's fixed point alone (the sigmoid's LUT
    error in dL/dZ cancels): full_jacobian backpropagates dL/dZ itself;
    layer_estimation its projection X pinv(X) dL/dZ onto the columns of the
    last Linear's input X, which is dL/dZ only where X has full row rank."""
    model = torch_lenet(dev, torch.float64)
    logits = model(torch.as_tensor(x, dtype=torch.float64, device=dev))
    dldz = torch.as_tensor(dp.dLdZ.get_plain_text(), dtype=torch.float64, device=dev)
    if hasattr(dp, "_last_input"):
        h = dp._last_input.detach().to(torch.float64)
        dldz = h @ (torch.linalg.pinv(h) @ dldz)
    grads = torch.autograd.grad(logits, list(model.parameters()), grad_outputs=dldz)
    return {k: g.cpu().numpy() for (k, _), g in zip(model.named_parameters(), grads)}


def dp_step(ct, model, x, y, protocol, noise=None, **kw):
    """One DPSplitModel step of ``protocol`` on the torch ``model``:
    zero_grad, the forward, the loss, backward. Returns (each parameter's
    gradient by state dict key, numpy float64; the DPSplitModel)."""
    with ct.cfg.temp_override({"nn.dpsmpc.protocol": protocol}):
        dp = ct.nn.DPSplitModel(model, noise_magnitude=noise, **kw)
        if protocol == "layer_estimation":
            dp.attach_hooks()
        dp.zero_grad()
        dp(x)
        dp.compute_loss(y)
        dp.backward()
    return {k: p.grad.detach().cpu().numpy().astype(np.float64)
            for k, p in model.named_parameters()}, dp


def dp_noise_scale(dp, protocol, noisy, clean, noise=DP_NOISE):
    """(the noisy step's deviation from the noiseless one, its expected
    standard deviation): every gradient where the noise is added to them
    (full_jacobian); the last Linear's weight gradient under
    layer_estimation, where the noise on dL/dW reaches it through the
    projection onto the row space of that layer's input X, rank r of I
    columns: sigma sqrt(r / I)."""
    if protocol == "full_jacobian":
        dev = np.concatenate([(noisy[k] - clean[k]).ravel() for k in clean])
        return float(dev.std()), noise
    key = list(clean)[-2]  # the last Linear's weight
    x = dp._last_input.detach().to(torch.float64)
    rank = int(torch.linalg.matrix_rank(x))
    return float((noisy[key] - clean[key]).std()), noise * math.sqrt(rank / x.shape[1])


def convert_forward(tag, graph, x, ref, rounds):
    """A converted graph encrypted by party 0, under bench.py's kernel
    configuration: a warm-up forward recording every launch signature (for
    phase 5), 3 forwards (the last counted: launches, CommStats, peak
    memory), one profiled; the logits against float64 under
    RESNET_LOGITS_REL_L2, top-1 kept, the rounds the CPU count, every
    kernel of the path launched. Returns (res, failures)."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg

    graph.encrypt(src=0)
    xe = ct.cryptensor(x)
    with cfg.temp_override(BENCH_CONFIG):
        t0 = time.perf_counter()
        with recording_launches() as calls:
            logits = graph(xe).get_plain_text()
        warm_s = time.perf_counter() - t0
        lat = []
        for i in range(3):
            if i == 2:
                reset_launches()
                ct.reset_communication_stats()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = graph(xe)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if i == 2:
                launches, by_op, _ = read_launches()
                stats = ct.get_communication_stats()
                peak = torch.cuda.max_memory_allocated()
        del out
        busy = profile_forward(graph, xe, min(lat), tag=f"profile {tag}")
    err, agree = resnet_readings(logits, ref)
    log(f"[{tag}] warm-up forward {warm_s:.2f} s; latencies {', '.join(f'{v:.4f}' for v in lat)} "
        f"s (best {min(lat):.4f} s, {1 / min(lat):.2f} images/s; {nvidia_smi_line()})")
    log(f"[{tag}] one forward: {stats['rounds']} rounds (the CPU count {rounds}; phase 11's "
        f"native ResNet-18 {RESNET_ROUNDS['resnet18']}), {stats['bytes']} bytes per party; "
        f"launches {launches}; fused_mul and max_step by op {by_op}")
    log(f"[{tag}] peak device memory {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held")
    log(f"[{tag}] logits against the torch model in float64: relative L2 {err:.5f} (bound "
        f"{RESNET_LOGITS_REL_L2}), top-1 {'agrees' if agree else 'differs'} (private "
        f"{int(logits.argmax())}, float64 {int(ref.argmax())})")
    missing = [k for k, n in launches.items() if n == 0 and k not in RESNET_UNLAUNCHED]
    missing += [c for c in unlaunched_chains(by_op) if c not in RESNET_UNLAUNCHED]
    checks = {
        f"logits finite, (1, {RESNET_CLASSES})":
            logits.shape == (1, RESNET_CLASSES) and bool(np.isfinite(logits).all()),
        f"logits within relative L2 {RESNET_LOGITS_REL_L2}": err <= RESNET_LOGITS_REL_L2,
        "top-1 kept": bool(agree),
        f"rounds the CPU count {rounds}": stats["rounds"] == rounds,
        "every kernel of the path launched": not missing,
        "recorded launches equal the counted ones": recorded_launches(calls) == (launches, by_op),
    }
    failures = report_checks(tag, checks)
    res = dict(calls=calls, launches=launches, by_op=by_op, stats=stats, best_s=min(lat),
               busy_ms=busy, peak=peak - held, xe=xe, err=err)
    return res, failures


def report_checks(tag, checks):
    """Log each check "held" or "FAILED"; the failed ones."""
    for name, ok in checks.items():
        log(f"[{tag}] {name}: {'held' if ok else 'FAILED'}")
    return [f"{tag}: {name}" for name, ok in checks.items() if not ok]


def plain_check(tag, graph, x, ref, dev):
    """The converted graph run in the clear (PlainTensor, float64 on the
    card) against the torch model's float64 logits."""
    t0 = time.perf_counter()
    out = graph(torch.as_tensor(x, dtype=torch.float64, device=dev))
    err = rel_l2(np.asarray(out.get_plain_text()), ref)
    log(f"[{tag}] unencrypted through PlainTensor: relative L2 {err:.3e} from the torch model's "
        f"float64 logits ({time.perf_counter() - t0:.3f} s)")
    return report_checks(tag, {f"the graph in the clear within relative L2 "
                               f"{CONVERT_PLAIN_REL_L2}": err <= CONVERT_PLAIN_REL_L2})


def run_convert(dev):
    """Phase 13: bring your own model, 2 parties, session seed 11, under
    bench.py's kernel configuration. A torchvision-layout ResNet-18
    (TorchResNet: phase 11's weights and input, float64 on the card)
    converted by from_pytorch (a private forward, the graph in the clear,
    its DOT, then the GraphModule through compile_parties as phase 11
    captures its model) and by from_onnx of export_onnx_bytes on the card
    (torch's constant folding on, each BatchNorm folded into its
    convolution; the export without folding logged beside it); then one
    DPSplitModel step of each protocol over LeNet, noiseless and with
    DP_NOISE. Returns ({path: (calls, launches, by_op)}, {path: the
    capture's readings}, failures)."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.nn.tensorboard import graph_to_dot
    from curl_tpu_torch.utils.torch_onnx_export import export_onnx_bytes

    ct.init(world_size=2, seed=SEED)
    t0 = time.perf_counter()
    model, x = torch_resnet18(dev)
    ref = torch_logits(model, x, dev)
    xt = torch.as_tensor(x, dtype=torch.float64, device=dev)
    log(f"[{CONVERT_PATH}] TorchResNet (torchvision's BasicBlock layout, in-place ReLU, out += "
        f"identity, torch.flatten) with phase 11's state dict, float64 on the card, in "
        f"{time.perf_counter() - t0:.1f} s; float64 top-1 {int(ref.argmax())}")
    paths, captured, failures = {}, {}, []

    # item 1: from_pytorch, private, in the clear, its DOT, captured
    t0 = time.perf_counter()
    graph = ct.nn.from_pytorch(model)
    n_modules = len(list(graph.named_modules()))
    dot = graph_to_dot(graph, "resnet18")
    log(f"[{CONVERT_PATH}] from_pytorch: a GraphModule of {len(graph.graph.nodes)} fx nodes and "
        f"{n_modules} modules in {time.perf_counter() - t0:.2f} s; graph_to_dot: "
        f"{dot.count(' [label=')} nodes, {dot.count(' -> ')} edges, {len(dot)} characters")
    failures += report_checks(CONVERT_PATH, {
        "graph_to_dot has one node a module": dot.count(" [label=") == n_modules})
    failures += plain_check(CONVERT_PATH, graph, x, ref, dev)
    res, more = convert_forward(CONVERT_PATH, graph, x, ref, CONVERT_ROUNDS[CONVERT_PATH])
    failures += more
    paths[CONVERT_PATH] = (res["calls"], res["launches"], res["by_op"])
    captured[CONVERT_PATH], more = run_captured_resnet(CONVERT_PATH, graph, res["xe"], ref, res)
    failures += more
    del graph, res
    gc.collect()
    torch.cuda.empty_cache()

    # item 2: export_onnx_bytes on the card, from_onnx
    t0 = time.perf_counter()
    data = export_onnx_bytes(model, xt, do_constant_folding=True)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = ct.nn.from_onnx(data)
    log(f"[{CONVERT_ONNX_PATH}] export_onnx_bytes on the card (torch {torch.__version__}, opset "
        f"11, constant folding) in {export_s:.2f} s: {len(data)} bytes, ops "
        f"{onnx_op_types(data)}; from_onnx in {time.perf_counter() - t0:.2f} s, "
        f"{len(list(graph.named_modules()))} modules")
    del data
    failures += plain_check(CONVERT_ONNX_PATH, graph, x, ref, dev)
    res, more = convert_forward(CONVERT_ONNX_PATH, graph, x, ref,
                                CONVERT_ROUNDS[CONVERT_ONNX_PATH])
    failures += more
    paths[CONVERT_ONNX_PATH] = (res["calls"], res["launches"], res["by_op"])
    del graph, res
    # the export without folding: BatchNormalization nodes with encrypted
    # running statistics, logged beside it
    data = export_onnx_bytes(model, xt)
    graph = ct.nn.from_onnx(data)
    graph.encrypt(src=0)
    with cfg.temp_override(BENCH_CONFIG):
        ct.reset_communication_stats()
        logits = graph(ct.cryptensor(x)).get_plain_text()
        stats = ct.get_communication_stats()
    err, agree = resnet_readings(logits, ref)
    log(f"[{CONVERT_ONNX_PATH}] the export without constant folding ({onnx_op_types(data)}): "
        f"{stats['rounds']} rounds (the CPU count {CONVERT_ROUNDS['unfolded']}), {stats['bytes']} "
        f"bytes; logits relative L2 {err:.5f}, top-1 {'agrees' if agree else 'differs'}: its "
        "BatchNorms divide by the private inv_sqrt of their encrypted variances, not bounded")
    failures += report_checks(CONVERT_ONNX_PATH, {
        "the unfolded export's rounds the CPU count": stats["rounds"] == CONVERT_ROUNDS["unfolded"]})
    del data, graph, model, xt
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("phase 13 convert")

    dp_res, more = run_dp_split(dev)
    failures += more
    paths[DP_SPLIT_PATH] = (dp_res["calls"], dp_res["launches"], dp_res["by_op"])
    return paths, captured, failures


def run_dp_split(dev):
    """Phase 13's DPSplitModel: LeNet as a float32 torch model on the card,
    batch 64, multi-label targets; one step of each protocol recorded and
    counted together (the path "dp split"), each protocol's gradients
    against float64, two more steps timed, one profiled, then a step with
    DP_NOISE against the noiseless one."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg

    ct.init(world_size=2, seed=SEED)
    x, _ = lenet_batch()
    y = dp_targets()
    ref = dp_reference_grads(x, y, dev)
    model = torch_lenet(dev)
    steps = {}
    failures = []
    with cfg.temp_override(BENCH_CONFIG):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with recording_launches() as calls:
            for protocol in DP_PROTOCOLS:
                ct.reset_communication_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grads, dp = dp_step(ct, model, x, y, protocol)
                torch.cuda.synchronize()
                steps[protocol] = dict(grads=grads, first_s=time.perf_counter() - t0,
                                       stats=ct.get_communication_stats(), dp=dp)
        launches, by_op, _ = read_launches()
        peak = torch.cuda.max_memory_allocated() - held
        for protocol, st in steps.items():
            st["own"] = dp_protocol_reference(st.pop("dp"), x, dev)
            lat = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dp_step(ct, model, x, y, protocol)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
            st["lat"] = lat
            st["busy"] = profile_forward(None, None, min(lat), tag=f"profile dp {protocol}",
                                         top=6, call=lambda p=protocol: dp_step(ct, model, x, y, p))
            noisy, dp = dp_step(ct, model, x, y, protocol, noise=DP_NOISE)
            st["noise"] = dp_noise_scale(dp, protocol, noisy, st["grads"])
            del dp
    smi = nvidia_smi_line()
    for protocol, st in steps.items():
        tag = f"dp {protocol}"
        grad = rel_l2_by_key(st["grads"], ref)
        own = rel_l2_by_key(st["grads"], st["own"])
        got, want = st["noise"]
        log(f"[{tag}] a step (forward, loss, backward) {st['first_s']:.4f} s recorded, then "
            f"{', '.join(f'{v:.4f}' for v in st['lat'])} s ({LENET_BATCH / min(st['lat']):.1f} "
            f"images/s; {smi}); {st['stats']['rounds']} rounds (the CPU count "
            f"{DP_ROUNDS[protocol]}), {st['stats']['bytes']} bytes per party")
        log(f"[{tag}] gradients against float64 BCEWithLogits, relative L2 (bound): " + ", ".join(
            f"{k} {v:.4f} ({DP_GRAD_REL_L2[protocol][k]})" for k, v in grad.items()))
        log(f"[{tag}] against the float64 backpropagation of the step's own dL/dZ (bound): "
            + ", ".join(f"{k} {v:.4f} ({DP_OWN_REL_L2[protocol][k]})" for k, v in own.items()))
        log(f"[{tag}] noise_magnitude {DP_NOISE}: the deviation's standard deviation {got:.6f}, "
            f"expected {want:.6f} ({got / want - 1:+.1%})")
        failures += report_checks(tag, {
            "every gradient finite and within its bound against float64": all(
                np.isfinite(st["grads"][k]).all() and v <= DP_GRAD_REL_L2[protocol][k]
                for k, v in grad.items()),
            "every gradient within its bound against its own dL/dZ's backpropagation": all(
                v <= DP_OWN_REL_L2[protocol][k] for k, v in own.items()),
            f"rounds the CPU count {DP_ROUNDS[protocol]}":
                st["stats"]["rounds"] == DP_ROUNDS[protocol],
            f"the noise's scale within {DP_NOISE_TOL:.0%}": abs(got / want - 1) <= DP_NOISE_TOL,
        })
    log(f"[{DP_SPLIT_PATH}] one step of each protocol: launches {launches}; fused_mul and "
        f"max_step by op {by_op}; peak device memory {peak / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held")
    failures += report_checks(DP_SPLIT_PATH, {
        f"the steps launched {', '.join(DP_LAUNCHED)}": all(launches[k] for k in DP_LAUNCHED),
        "recorded launches equal the counted ones": recorded_launches(calls) == (launches, by_op),
    })
    best = min(min(st["lat"]) for st in steps.values())
    res = dict(calls=calls, launches=launches, by_op=by_op, best_s=best, peak=peak)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res, failures


def runner_shares(tree):
    """The share tensors of an output pytree, in order."""
    from curl_tpu_torch.parallel import runner

    leaves = []
    runner._flatten(tree, leaves)
    return leaves


# ---------------------------------------------------------------------------
# Phase 6: the forward captured as a CUDA graph (compile_parties)
# ---------------------------------------------------------------------------

def hidden_forward(model):
    """``(forward, params)``: ``model.functional()``'s forward returning
    the output and the final-LayerNorm hidden state (the output of the last
    call of ``model.ln``)."""
    apply_fn, params = model.functional()

    def forward(p, x):
        seen = []
        hook = model.ln.register_forward_hook(lambda mod, inp, out: seen.append(out))
        try:
            probs = apply_fn(p, x)
        finally:
            hook.remove()
        return probs, seen[-1]

    return forward, params


def hidden_of(out):
    """The final-LayerNorm hidden state of ``hidden_forward``'s output, revealed."""
    probs, hidden = out
    return hidden.get_plain_text().reshape(tuple(probs.shape[:-1]) + (-1,))


def same(a, b):
    """Whether two outputs' shares are bit-identical, item by item."""
    return all(torch.equal(u.share, v.share) for u, v in zip(a, b))


# what phase 6 keeps of a phase 4c, 4d or 4f run, and each path's phase
PHASE_OF = {"compressed": "4c", "neo": "4d", "neo_large": "4f"}
CAPTURE_KEYS = ("model", "xe", "ref", "config", "bound", "stats", "best_s", "launches", "by_op")
# the capture's seed, then the replays' (each a fresh seed)
CAPTURE_SEED = 101
REPLAYS = 6


def run_captured(path, res):
    """Phase 6: the model's forward through ``compile_parties(
    model.functional())``, with its final-LayerNorm hidden state as a
    second output: the capture (counts reset just before it and read just
    after), replays at fresh seeds, the same forward eagerly under the
    capture seed's keys and under the first replay seed's, each from the
    capture's draw counter, and the tokens at another address (read
    through a static buffer after one capture anew)."""
    import curl_tpu_torch as ct
    from curl_tpu_torch import random as crandom
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.mpc.mpc import MPCTensor
    from curl_tpu_torch.mpc.primitives.arithmetic import ArithmeticSharedTensor

    tag = f"captured {path}"
    model, xe = res["model"], res["xe"]
    forward, params = hidden_forward(model)

    def eager_at(seed):
        """The forward eagerly under ``seed``'s keys from the capture's
        draw counter: (outputs, host seconds)."""
        resume = crandom.counter()
        crandom.set_counter(step.counter)
        with ct.parallel.mpc_context(crandom.make_party_keys(seed, 2), 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = forward(params, xe)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        crandom.set_counter(resume)
        return out, secs

    def elsewhere(x):
        """The same tokens at another address."""
        return MPCTensor(ArithmeticSharedTensor(x._tensor.share.clone(), x._tensor.encoder),
                         x.ptype)

    step = ct.compile_parties(forward, 2)
    with cfg.temp_override(res["config"]):
        reset_launches()
        ct.reset_communication_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        first = step(CAPTURE_SEED, params, xe)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches, by_op, _ = read_launches()
        stats = ct.get_communication_stats()
        resident = torch.cuda.memory_allocated() - held
        lat, other = [], None
        for i in range(REPLAYS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(CAPTURE_SEED + 1 + i, params, xe)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            other = out if other is None else other
        again = step(CAPTURE_SEED, params, xe)
        after = ct.get_communication_stats()
        peak = torch.cuda.max_memory_allocated() - held

        # the same forward eagerly, under the capture seed's keys from the
        # capture's draw counter, counted alone; then uncounted under the
        # first replay seed's
        reset_launches()
        ct.reset_communication_stats()
        eager, eager_s = eager_at(CAPTURE_SEED)
        eager_launches, eager_by_op, _ = read_launches()
        eager_stats = ct.get_communication_stats()
        eager_other, _ = eager_at(CAPTURE_SEED + 1)
        best = min(lat)
        busy = profile_forward(None, None, best, tag=f"profile, {tag}", top=6,
                               call=lambda: step(CAPTURE_SEED + REPLAYS + 1, params, xe))
        # the tokens at another address: one capture anew, then a copy a call
        captures = step.captures
        moved = [step(CAPTURE_SEED + 1, params, elsewhere(xe)) for _ in range(2)]
        moved_captures = step.captures - captures

    log(f"[{tag}] first call {first_s:.2f} s: warm-up forward {step.warmup_s:.2f} s, capture "
        f"and instantiation {step.capture_s:.2f} s, one replay; {captures} capture; the graph "
        f"keeps {step.constants} public constants")
    log(f"[{tag}] the capture's launches {launches}; fused_mul and max_step by op {by_op}")
    log(f"[{tag}] replay latencies {', '.join(f'{x:.4f}' for x in lat)} s: best {best:.4f} s, "
        f"{SEQ / best:.1f} tokens/s; the eager forward beside it {eager_s:.4f} s (phase "
        f"{PHASE_OF[path]}'s best {res['best_s']:.4f} s)")
    log(f"[{tag}] device memory: the graph's pool and buffers hold {resident / 2**30:.3f} GiB "
        f"after the capture; peak {peak / 2**30:.3f} GiB above the {held / 2**30:.2f} GiB "
        f"held before it")
    log(f"[{tag}] the capture: {stats['rounds']} rounds, {stats['bytes']} bytes; the eager "
        f"forward: {eager_stats['rounds']}, {eager_stats['bytes']}; replays counted "
        f"{after['rounds'] - stats['rounds']} more rounds")
    checks = {
        "replay at the capture seed bit-identical to the eager forward at its keys and counter":
            same(first, eager),
        "replay at another seed bit-identical to the eager forward at that seed's keys":
            same(other, eager_other),
        "the same seed twice bit-identical": same(first, again),
        "two seeds different shares": not torch.equal(first[0].share, other[0].share),
        "tokens at another address: one capture anew, then the same shares each call":
            moved_captures == 1 and all(same(m, other) for m in moved),
        f"rounds and bytes of the capture equal the eager forward's and phase {PHASE_OF[path]}'s":
            (stats["rounds"], stats["bytes"]) == (eager_stats["rounds"], eager_stats["bytes"])
            == (res["stats"]["rounds"], res["stats"]["bytes"]) and after == stats,
        "the capture launched every kernel the eager forward launched, as often":
            (launches, by_op) == (eager_launches, eager_by_op)
            and all(n > 0 for k, n in launches.items() if k != MASKED)
            and not unlaunched_chains(by_op),
    }
    for seed, out in ((CAPTURE_SEED, first), (CAPTURE_SEED + 1, other)):
        st = hidden_stats(hidden_of(out), res["ref"])
        log(f"[{tag}] final-LN hidden at seed {seed}: {fmt_stats(st)}")
        checks[f"hidden state at seed {seed} within max {HIDDEN_STATE_ATOL}, scale-free rel L2 "
               f"{res['bound']}"] = (np.isfinite(hidden_of(out)).all()
                                     and st["max_abs"] <= HIDDEN_STATE_ATOL
                                     and st["scale_free_l2"] <= res["bound"])
    for name, ok in checks.items():
        log(f"[{tag}] {name}: {'held' if ok else 'FAILED'}")
    failures = [f"{tag}: {name}" for name, ok in checks.items() if not ok]
    if failures:
        log(f"[{tag}] eager launches {eager_launches}, by op {eager_by_op}")
    chains = {name: sum(n for t, n in by_op.items() if is_tag(t))
              for name, is_tag in CHAIN_TAGS.items()}
    return dict(launches=launches, chains=chains, best_s=best, eager_s=eager_s, busy_ms=busy,
                capture_s=step.capture_s, peak=peak), failures


# ---------------------------------------------------------------------------
# Phase 10: the offline/online split (compile_parties_cached) and the dealer
# ---------------------------------------------------------------------------

# bench.py's BENCH_CACHE=1 seeds (bench.py:236-275): the recording, the
# warm-up fill and the timed fill; the online replays take CAPTURE_SEED on
CACHE_RECORD_SEED = 99
FILL_SEEDS = (97, 98)
FILL_REPLAYS = 3
# philox launches of one call of each TFP provider method (tfp_provider.py:
# each method's docstring), and the one ring_mm launch of a matmul triple's
# dealer product
PROVIDER_LAUNCHES = {"generate_additive_triple": 2, "square": 2, "generate_binary_triple": 2,
                     "wrap_rng": 1, "B2A_rng": 1, "generate_lut_masks": 2,
                     "egk_trunc_pr_rng": 1}
CACHED_PATHS = ("cached fill", "cached online")


def _leaves(entries):
    from curl_tpu_torch.mpc.provider.provider import describe

    return describe(entries)[1]


def run_cached(res):
    """Phase 10: bench.py's BENCH_CACHE=1 run (bench.py:236-275) on phase
    4c's model and tokens: ``compile_parties_cached(forward, 2, 99, params,
    x)``; the fill captured at seed 97 (counts reset just before and read
    just after), replayed, then run eagerly at its keys and counter,
    recording its launch signatures for phase 5; the online captured with
    that cache at seed 101 (counts reset just before and read just after)
    and replayed at seeds 101-106, then run eagerly, served from the same
    cache at its keys and counter, recording its signatures; a timed fill
    at seed 98 into the same buffers and the online once more with it.
    Returns (the fill's and the online's paths and captures, best times),
    failures."""
    import curl_tpu_torch as ct
    from curl_tpu_torch import random as crandom
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.mpc import get_default_provider
    from curl_tpu_torch.mpc.provider.provider import TupleCache

    tag = "cached"
    model, xe = res["model"], res["xe"]
    forward, params = hidden_forward(model)
    provider = get_default_provider()

    def at_counter(seed, counter, fn):
        """``fn()`` eagerly under ``seed``'s keys from draw counter
        ``counter``, recording its launches: (output, calls, host s)."""
        resume = crandom.counter()
        crandom.set_counter(counter)
        try:
            with ct.parallel.mpc_context(crandom.make_party_keys(seed, 2), 2), \
                    recording_launches() as calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
        finally:
            crandom.set_counter(resume)
        return out, calls, secs

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with cfg.temp_override(res["config"]):
        (online, fill), record_s = timed(lambda: ct.compile_parties_cached(
            forward, 2, CACHE_RECORD_SEED, params, xe))
        funcs = {f: fill.funcs.count(f) for f in sorted(set(fill.funcs))}
        want_fill = {"philox": sum(PROVIDER_LAUNCHES[f] for f in fill.funcs),
                     "ring_mm": sum(1 for r in fill.requests
                                    if r.func == "generate_additive_triple" and r.args[2] == "matmul")}

        # the fill: its capture, counted alone, then replays
        reset_launches()
        ct.reset_communication_stats()
        torch.cuda.synchronize()
        held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        cache, fill_first_s = timed(lambda: fill(FILL_SEEDS[0]))
        fill_launches, fill_by_op, _ = read_launches()
        fill_stats = ct.get_communication_stats()
        fill_bytes = torch.cuda.memory_allocated() - held
        fill_pool = torch.cuda.memory_reserved() - reserved
        cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache.entries))
        bytes_by = {f: sum(t.numel() * t.element_size() for e, g in zip(cache.entries, fill.funcs)
                           if g == f for t in _leaves([e])) for f in funcs}
        fill_lat = []
        for _ in range(FILL_REPLAYS):
            cache, secs = timed(lambda: fill(FILL_SEEDS[0]))
            fill_lat.append(secs)
        # the same fill eagerly at its keys and counter: its signatures
        reset_launches()
        with provider.serving(None):
            eager_entries, fill_calls, fill_eager_s = at_counter(
                FILL_SEEDS[0], fill.program.counter,
                lambda: provider.fill_cache_entries(fill.requests))
        eager_fill_launches, eager_fill_by_op, _ = read_launches()
        fill_same = all(torch.equal(a, b) for a, b in zip(_leaves(cache.entries),
                                                          _leaves(eager_entries)))
        del eager_entries
        gc.collect()

        # the online: its capture with the cache of seed 97, counted alone
        reset_launches()
        ct.reset_communication_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        first, online_first_s = timed(lambda: online(CAPTURE_SEED, cache, params, xe))
        launches, by_op, _ = read_launches()
        stats = ct.get_communication_stats()
        online_bytes = torch.cuda.memory_allocated() - held
        online_pool = torch.cuda.memory_reserved() - reserved
        lat = []
        for i in range(REPLAYS):
            _, secs = timed(lambda: online(CAPTURE_SEED + i, cache, params, xe))
            lat.append(secs)
        again = online(CAPTURE_SEED, cache, params, xe)
        after = ct.get_communication_stats()
        peak = torch.cuda.max_memory_allocated() - held
        best = min(lat)
        busy = profile_forward(None, None, best, tag=f"profile, {tag} online", top=6,
                               call=lambda: online(CAPTURE_SEED + REPLAYS, cache, params, xe))
        # the same forward eagerly, served from the same cache at the
        # online's keys and counter, counted alone
        reset_launches()
        ct.reset_communication_stats()
        view = TupleCache(cache.entries)
        with provider.serving(view):
            eager, online_calls, online_eager_s = at_counter(
                CAPTURE_SEED, online.counter, lambda: forward(params, xe))
        eager_launches, eager_by_op, _ = read_launches()
        eager_stats = ct.get_communication_stats()

        # a timed fill at seed 98 into the same buffers (bench.py's
        # offline_fill_sec), and the online with it
        captures = online.captures
        cache98, offline_fill_s = timed(lambda: fill(FILL_SEEDS[1]))
        try:
            online(CAPTURE_SEED, cache, params, xe)
            stale_refused = False
        except RuntimeError:
            stale_refused = True
        second = online(CAPTURE_SEED, cache98, params, xe)

    want_online = dict(res["launches"], ring_mm=0,
                       philox=res["launches"]["philox"] - want_fill["philox"])
    log(f"[{tag}] recorded {len(fill.requests)} tuple requests in {record_s:.2f} s (one eager "
        f"forward at seed {CACHE_RECORD_SEED}): {funcs}")
    log(f"[{tag}] the cache: {len(cache.entries)} entries, {len(_leaves(cache.entries))} tensors, "
        f"{cache_bytes} bytes ({cache_bytes / 2**30:.3f} GiB), by method {bytes_by}; the fill "
        f"graph allocates {fill_bytes / 2**30:.3f} GiB, reserves {fill_pool / 2**30:.3f} GiB more")
    log(f"[{tag}] fill: first call {fill_first_s:.3f} s (warm-up fill {fill.program.warmup_s:.3f} "
        f"s, capture and instantiation {fill.program.capture_s:.3f} s, one replay); eager fill "
        f"{fill_eager_s:.4f} s; captured fill replays {', '.join(f'{x:.4f}' for x in fill_lat)} s; "
        f"the timed fill at seed {FILL_SEEDS[1]} (offline_fill_sec) {offline_fill_s:.4f} s")
    log(f"[{tag}] fill launches {fill_launches} (the provider calls': philox {want_fill['philox']}, "
        f"ring_mm {want_fill['ring_mm']}); {fill_stats['rounds']} rounds")
    log(f"[{tag}] online: first call {online_first_s:.2f} s (warm-up {online.warmup_s:.2f} s, "
        f"capture and instantiation {online.capture_s:.2f} s, one replay); replay latencies "
        f"{', '.join(f'{x:.4f}' for x in lat)} s: best {best:.4f} s, {SEQ / best:.1f} tokens/s; "
        f"the eager served forward {online_eager_s:.4f} s; phase 4c's eager best "
        f"{res['best_s']:.4f} s")
    log(f"[{tag}] online: {stats['rounds']} rounds, {stats['bytes']} bytes (phase 4c "
        f"{res['stats']['rounds']}, {res['stats']['bytes']}); launches {launches}; by op {by_op}")
    log(f"[{tag}] online device memory: the graph allocates {online_bytes / 2**30:.3f} GiB, "
        f"reserves {online_pool / 2**30:.3f} GiB more; peak {peak / 2**30:.3f} GiB above the "
        f"{held / 2**30:.2f} GiB held before it; captures: online {online.captures}, fill "
        f"{fill.program.captures}")
    checks = {
        f"the online's rounds and bytes equal phase 4c's uncached forward's "
        f"({res['stats']['rounds']}, {res['stats']['bytes']}), replays count none":
            (stats["rounds"], stats["bytes"]) == (res["stats"]["rounds"], res["stats"]["bytes"])
            == (eager_stats["rounds"], eager_stats["bytes"]) and after == stats,
        "the fill communicates nothing at 2 parties": fill_stats["rounds"] == 0,
        "the fill's launches equal its provider calls' (philox, ring_mm) and the eager fill's":
            {k: fill_launches[k] for k in want_fill} == want_fill
            and fill_launches == eager_fill_launches and fill_by_op == eager_fill_by_op == {}
            and want_fill["ring_mm"] == res["launches"]["ring_mm"],
        "the online makes no dealer product and no provider philox launch; its other launches "
        "equal phase 4c's": (launches, by_op) == (want_online, res["by_op"]),
        "the online capture's launches equal the eager served forward's, as recorded":
            (launches, by_op) == (eager_launches, eager_by_op)
            == recorded_launches(online_calls),
        "the fill's recorded launches equal its counted ones":
            recorded_launches(fill_calls) == (eager_fill_launches, eager_fill_by_op),
        "the fill graph's tuples bit-identical to the eager fill's at its keys and counter":
            fill_same,
        "the online replay bit-identical to the eager served forward at its keys and counter":
            same(first, eager) and view.cursor == len(cache.entries),
        "the same seed and cache twice bit-identical": same(first, again),
        "the caches of seeds 97 and 98 different shares": not torch.equal(first[0].share,
                                                                          second[0].share),
        "a cache that a later fill overwrote is refused": stale_refused and cache.overwritten,
        "one capture each: a new fill into the same buffers captures nothing anew":
            online.captures == captures == 1 and fill.program.captures == 1,
    }
    for seed, out in ((FILL_SEEDS[0], first), (FILL_SEEDS[1], second)):
        st = hidden_stats(hidden_of(out), res["ref"])
        log(f"[{tag}] final-LN hidden with the cache of seed {seed}: {fmt_stats(st)}")
        checks[f"hidden state with the cache of seed {seed} within max {HIDDEN_STATE_ATOL}, "
               f"scale-free rel L2 {res['bound']}"] = (np.isfinite(hidden_of(out)).all()
                                                       and st["max_abs"] <= HIDDEN_STATE_ATOL
                                                       and st["scale_free_l2"] <= res["bound"])
    for name, ok in checks.items():
        log(f"[{tag}] {name}: {'held' if ok else 'FAILED'}")
    failures = [f"{tag}: {name}" for name, ok in checks.items() if not ok]
    out = dict(paths={"cached fill": (fill_calls, eager_fill_launches, eager_fill_by_op),
                      "cached online": (online_calls, eager_launches, eager_by_op)},
               captured={"cached fill": dict(launches=fill_launches, chains={}),
                         "cached online": dict(launches=launches, chains={
                             name: sum(n for t, n in by_op.items() if is_tag(t))
                             for name, is_tag in CHAIN_TAGS.items()})},
               best_s=best, fill_best_s=min(fill_lat), offline_fill_s=offline_fill_s,
               busy_ms=busy)
    del online, fill, cache, cache98, first, again, second, eager, view
    gc.collect()
    torch.cuda.empty_cache()
    return out, failures


def run_dealer():
    """Phase 10b: the standalone dealer on the card, with the case of
    tests/test_providers.py:178-240: a mul and a gelu at (4,) recorded, the
    dealer's command line run in a process of its own, each party's file
    loaded, the same ops served from them."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.mpc import get_default_provider
    from curl_tpu_torch.mpc.provider import dealer

    tag = "dealer"
    ct.init(world_size=2, seed=SEED)
    provider = get_default_provider()
    g = np.random.default_rng(2024)
    x, y = g.normal(size=(4,)), g.normal(size=(4,))
    provider.requests = []
    ct.trace(True)
    (ct.cryptensor(x) * ct.cryptensor(y)).get_plain_text()
    ct.cryptensor(x).gelu().get_plain_text()
    ct.trace(False)
    out_dir = os.path.join(ROOT, "build", "dealer")
    os.makedirs(out_dir, exist_ok=True)
    requests, prefix = os.path.join(out_dir, "requests.json"), os.path.join(out_dir, "tuples")
    provider.save_requests(requests)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "curl_tpu_torch.mpc.provider.dealer",
                           "--requests", requests, "--world-size", "2", "--seed", "1234",
                           "--out", prefix], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        log(f"[{tag}] the dealer's command line failed: {proc.stderr[-2000:]}")
        return [f"{tag}: the dealer's command line exited {proc.returncode}"]
    try:
        cache = dealer.attach_party_caches([f"{prefix}.party{r}.npz" for r in (1, 0)])
        got_mul = (ct.cryptensor(x) * ct.cryptensor(y)).get_plain_text()
        got_gelu = ct.cryptensor(x).gelu().get_plain_text()
        served = (cache.cursor, len(cache.entries))
    finally:
        provider.attach_cache(None)
        provider.requests = []
    ref_gelu = x * (1 + np.vectorize(math.erf)(x / math.sqrt(2))) / 2
    err_mul, err_gelu = np.abs(got_mul - x * y).max(), np.abs(got_gelu - ref_gelu).max()
    log(f"[{tag}] {served[1]} requests filled by the dealer's command "
        f"line on the card in a process of its own in {secs:.1f} s; served {served[0]} of "
        f"{served[1]} entries; mul max |err| {err_mul:.5f} (0.02), gelu {err_gelu:.5f} (0.05)")
    checks = {"mul within 0.02 and gelu within 0.05 of float64": err_mul <= 0.02
              and err_gelu <= 0.05,
              "the cursor ends at the cache's length": served[0] == served[1]}
    for name, ok in checks.items():
        log(f"[{tag}] {name}: {'held' if ok else 'FAILED'}")
    return [f"{tag}: {name}" for name, ok in checks.items() if not ok]


# ---------------------------------------------------------------------------
# Phase 7: private greedy generation, eagerly and captured (compile_parties)
# ---------------------------------------------------------------------------

GENERATE_SEED = 201  # the capture's seed; the replays take the next ones
GENERATE_REPLAYS = 3


def one_hot_rows(rows, tol=2.0 ** -12):
    """Whether every row has one lane within ``tol`` of 1 and every other
    lane within ``tol`` of 0."""
    rows = np.sort(np.asarray(rows).reshape(-1, rows.shape[-1]), axis=-1)
    return bool(np.all(np.abs(rows[:, -1] - 1) <= tol) and np.all(np.abs(rows[:, :-1]) <= tol))


def run_generate(sd):
    """Phase 7: the slice's path. Phase 4's weights in a causal GPT-2,
    materialized, a 60-token prompt, 4 tokens, under bench.py's kernel
    configuration: the generator captured by compile_parties (counts reset
    just before the capture and read just after) and replayed at fresh
    seeds; then the same loop eagerly, step by step, under the capture
    seed's keys from the capture's draw counter (counts reset just before it
    and read just after), each step's last-position logits revealed and held
    to float64; then one step without a block, the planted fault."""
    import curl_tpu_torch as ct
    from curl_tpu_torch import random as crandom
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.models import GPT2, load_numpy_state_dict
    from curl_tpu_torch.models import generate as gen

    heads, blocks, vocab = (GPT2.GEOM[k] for k in ("num_heads", "num_blocks", "vocab_size"))
    ct.init(world_size=2, seed=SEED)
    t0 = time.perf_counter()
    model = load_numpy_state_dict(GPT2(seq_len=SEQ, causal=True), sd).encrypt(src=0)
    params = model.params_pytree()
    prompt = np.random.default_rng(0).integers(0, 1000, size=(PROMPT_LEN,))
    buf0 = np.zeros((1, SEQ, vocab))
    buf0[0, np.arange(PROMPT_LEN), prompt] = 1.0
    be = ct.cryptensor(buf0)
    forward = gen.build_generator(model, PROMPT_LEN, GEN_TOKENS)
    sel, wr = forward.masks
    torch.cuda.synchronize()
    log(f"[generate] causal GPT-2 built and encrypted, prompt of {PROMPT_LEN} tokens shared as a "
        f"(1, {SEQ}, {vocab}) one-hot in {time.perf_counter() - t0:.1f} s")

    def run(p, buf):
        # the plain shares bound on every call, so that every call (the
        # runner's warm-up and capture included) masks the weights anew
        model.bind_params(p)
        out = forward(buf)
        return out, model.tok_embed.weight._tensor.delta[:4], model.fc.weight._tensor.delta[:4]

    def eager_loop(seed, counter, record=False):
        """The generator step by step under ``seed``'s keys from draw
        counter ``counter``: (buffer, each step's last logits, host s)."""
        resume = crandom.counter()
        crandom.set_counter(counter)
        lasts = []
        with ct.parallel.mpc_context(crandom.make_party_keys(seed, 2), 2), \
                (recording_launches() if record else contextlib.nullcontext()) as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.bind_params(params)
            model.premask_for_reuse()
            buf = be
            for g in range(GEN_TOKENS):
                buf, last = gen.decode_step(model, buf, sel[g], wr[g])
                lasts.append(last)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        crandom.set_counter(resume)
        return buf, lasts, secs, calls

    with cfg.temp_override(BENCH_CONFIG):
        # a warm-up of the loop: builds the constants, records every launch
        # signature for phase 5
        _, _, warm_s, calls = eager_loop(GENERATE_SEED, crandom.counter(), record=True)
        log(f"[generate] warm-up eager loop {warm_s:.2f} s")
        # the capture
        step = ct.compile_parties(run, 2)
        model.bind_params(params)  # the warm-up's masks go before the capture
        gc.collect()
        reset_launches()
        ct.reset_communication_stats()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = step(GENERATE_SEED, params, be)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches, by_op, _ = read_launches()
        stats = ct.get_communication_stats()
        graph_bytes = torch.cuda.memory_allocated() - held
        pool_bytes = torch.cuda.memory_reserved() - reserved
        lat, other = [], None
        for i in range(GENERATE_REPLAYS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(GENERATE_SEED + 1 + i, params, be)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            other = out if other is None else other
        again = step(GENERATE_SEED, params, be)
        after = ct.get_communication_stats()
        peak = torch.cuda.max_memory_allocated() - held
        busy = profile_forward(None, None, min(lat), tag="profile, captured generate", top=6,
                               call=lambda: step(GENERATE_SEED + 9, params, be))
        # the eager loop at the capture's keys and counter, counted alone
        reset_launches()
        ct.reset_communication_stats()
        torch.cuda.reset_peak_memory_stats()
        buf, lasts, eager_s, _ = eager_loop(GENERATE_SEED, step.counter)
        eager_launches, eager_by_op, _ = read_launches()
        eager_stats = ct.get_communication_stats()
        eager_peak = torch.cuda.max_memory_allocated()
        # the mask draws and reveals alone
        ct.reset_communication_stats()
        model.bind_params(params)
        model.premask_for_reuse()
        premask = ct.get_communication_stats()
        model.bind_params(params)
        final = buf.get_plain_text()
        lasts = [last.get_plain_text()[0] for last in lasts]
        # the planted fault: one step on the prompt without the block whose
        # absence the plaintext logits feel least
        ref0 = gen.plaintext_logits(sd, buf0, heads)[0, PROMPT_LEN - 1]
        skip_err = [hidden_stats(gen.plaintext_logits(sd, buf0, heads, skip=j)[0, PROMPT_LEN - 1],
                                 ref0)["scale_free_l2"] for j in range(blocks)]
        j = int(np.argmin(skip_err))
        kept = list(model.blocks._modules.items())
        model.blocks._modules.pop(str(j))
        try:
            model.premask_for_reuse()
            _, fault_last = gen.decode_step(model, be, sel[0], wr[0])
        finally:
            model.blocks._modules.clear()
            model.blocks._modules.update(kept)
            model.bind_params(params)
        fault = hidden_stats(fault_last.get_plain_text()[0], ref0)

    # each step against float64 on the same buffer, and its choice
    bound = GENERATE_LOGITS_SCALE_FREE_L2
    steps, choice_ok = [], True
    for g in range(GEN_TOKENS):
        b_now = final.copy()
        b_now[:, PROMPT_LEN + g:] = 0.0
        ref = gen.plaintext_logits(sd, np.round(b_now), heads)[0, PROMPT_LEN + g - 1]
        st = hidden_stats(lasts[g], ref)
        tok = int(final[0, PROMPT_LEN + g].argmax())
        choice_ok &= bool(lasts[g][tok] >= lasts[g].max() - 2.0 ** -12)
        steps.append(st)
        log(f"[generate] step {g}: token {tok} (private logit {lasts[g][tok]:.5f}, max "
            f"{lasts[g].max():.5f}; plaintext argmax {int(ref.argmax())}, plaintext margin of the "
            f"choice {ref.max() - ref[tok]:.5f}); last logits against float64: {fmt_stats(st)}")
    log(f"[generate] float64 logits without one block, scale-free rel L2: min {skip_err[j]:.5f} "
        f"(block {j}), max {max(skip_err):.5f}; planted fault, a private step without block "
        f"{j}: {fmt_stats(fault)}")
    best = min(lat)
    per = GEN_TOKENS
    log(f"[generate] capture: first call {first_s:.2f} s: warm-up {step.warmup_s:.2f} s, capture "
        f"and instantiation {step.capture_s:.2f} s, one replay; the graph keeps "
        f"{step.constants} public constants; device memory allocated after it "
        f"{graph_bytes / 2**30:.3f} GiB, reserved {pool_bytes / 2**30:.3f} GiB more (the "
        f"graph's pool), peak {peak / 2**30:.3f} GiB above the {held / 2**30:.2f} GiB held "
        "before")
    log(f"[generate] replay latencies {', '.join(f'{x:.4f}' for x in lat)} s: best {best:.4f} s, "
        f"{best / per:.4f} s a token; the eager loop {eager_s:.4f} s, {eager_s / per:.4f} s a "
        f"token (peak {eager_peak / 2**30:.2f} GiB)")
    log(f"[generate] one call: {stats['rounds']} rounds, {stats['bytes']} bytes per party "
        f"({stats['rounds'] / per:.2f} rounds and {stats['bytes'] / per:.0f} bytes a token); the "
        f"masks alone {premask['rounds']} rounds, {premask['bytes']} bytes; a decode step "
        f"{(stats['rounds'] - premask['rounds']) / per:.2f} rounds, "
        f"{(stats['bytes'] - premask['bytes']) / per:.0f} bytes")
    log(f"[generate] the capture's launches {launches}; fused_mul and max_step by op {by_op}")
    want_masked = 2 + 4 * blocks
    checks = {
        "every written row of the buffer a one-hot within 2^-12 (and the prompt's)":
            one_hot_rows(final[0, :PROMPT_LEN + GEN_TOKENS]) and not final[0, PROMPT_LEN + GEN_TOKENS:].any(),
        "each step's choice the argmax of its revealed logits, or tied within 2^-12": choice_ok,
        "the replay bit-identical to the eager loop at the capture's keys and counter":
            torch.equal(first[0].share, buf.share),
        "the same seed twice bit-identical": all(torch.equal(u.share if hasattr(u, "share") else u,
                                                             v.share if hasattr(v, "share") else v)
                                                 for u, v in zip(first, again)),
        "two seeds different deltas": not torch.equal(first[1], other[1])
            and not torch.equal(first[2], other[2]),
        "the capture's rounds and bytes equal the eager loop's, replays count none":
            (stats["rounds"], stats["bytes"]) == (eager_stats["rounds"], eager_stats["bytes"])
            and after == stats,
        "the capture's launches by kernel equal the eager loop's":
            (launches, by_op) == (eager_launches, eager_by_op),
        "the loop launched every kernel but seed_expand, the 3-pair form included":
            all(n > 0 for k, n in launches.items() if k not in ("seed_expand", "open"))
            and not unlaunched_chains(by_op),
        f"the masks: one delta reveal for each of the {want_masked} weights":
            premask["rounds"] == want_masked,
        "the recorded launches equal the counted ones": recorded_launches(calls) == (launches, by_op),
        f"each step's logits within scale-free rel L2 {bound}":
            all(np.isfinite(st["scale_free_l2"]) and st["scale_free_l2"] <= bound for st in steps),
        f"the planted fault fails the bound {bound}": fault["scale_free_l2"] > bound,
    }
    for name, ok in checks.items():
        log(f"[generate] {name}: {'held' if ok else 'FAILED'}")
    failures = [f"generate: {name}" for name, ok in checks.items() if not ok]
    if failures:
        log(f"[generate] eager launches {eager_launches}, by op {eager_by_op}")
    chains = {name: sum(n for t, n in by_op.items() if is_tag(t))
              for name, is_tag in CHAIN_TAGS.items()}
    res = dict(calls=calls, launches=eager_launches, by_op=eager_by_op,
               captured=dict(launches=launches, chains=chains, best_s=best, eager_s=eager_s,
                             busy_ms=busy, capture_s=step.capture_s, peak=peak,
                             pool=pool_bytes))
    del step, first, again, other, model, params, be
    gc.collect()
    torch.cuda.empty_cache()
    return res, failures


# ---------------------------------------------------------------------------
# Phase 14: the protocol matrix, GPT-2 under each layout
# ---------------------------------------------------------------------------

# the layouts: the config keys that select each (over configs/default.yaml)
# and its parties
PROTOCOL_LAYOUTS = {
    "rss3": ({"mpc.protocol": "replicated"}, 3),
    "tfp3": ({}, 3),
    "ttp2": ({"mpc.provider": "TTP"}, 2),
    "active2": ({"mpc.active_security": True}, 2),
}
# The final-LayerNorm hidden state's scale-free relative L2 bound of each
# layout, and the rounds and bytes of one forward: fixed before the card
# ran them, from `python3 scripts/torch_protocols_bound.py readings` (12
# blocks, session seeds 11, 1 and 2: 1.5 times the worst reading, at most
# phase 4's 0.15; PERF.md §6) and `... count`
PROTOCOL_BOUNDS = {"rss3": 0.15, "ttp2": 0.15, "tfp3": 0.15, "active2": 0.15}
PROTOCOL_COUNTS = {"rss3": (3487, 4482159104), "ttp2": (7375, 8258725888),
                   "tfp3": (3321, 5348521472), "active2": (3673, 5368139344)}
PROTOCOL_REPS = 3
# the kernels the shipped configuration leaves idle in every layout (K5-K8):
# the fused knobs are null, and the compressed weights' open is 2PC
PROTOCOL_IDLE = ("fused_mul", "ltz", "max_step", "seed_expand", "open")


def gpt2_tokens():
    """Phase 4's token ids, drawn as bench.py draws them: (1, SEQ), below 1000."""
    return np.random.default_rng(0).integers(0, 1000, size=(1, SEQ)).astype(np.float64)


def run_protocols(dev):
    """Phase 14: GPT-2 at full width (phase 4's weights and tokens,
    materialized, configs/default.yaml) under rss3, ttp2, tfp3 and active2,
    each a path of its own ("protocols <layout>"); rss3 also captured by
    compile_parties, active2 also run with a tampered triple. The model is
    encrypted once for each number of parties (a sharing does not depend
    on the dealer, the protocol or the security mode). Returns ({path:
    (calls, launches, by_op)}, {layout: readings}, {path: the capture's
    readings}, failures)."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.models import GPT2, load_numpy_state_dict

    blocks, heads, d, vocab = (GPT2.GEOM[k] for k in ("num_blocks", "num_heads", "embed_dim",
                                                      "vocab_size"))
    sd = random_gpt2_state(np.random.default_rng(1234), SEQ, blocks, d=d, vocab=vocab)
    tokens = gpt2_tokens()
    ref = plain_gpt_forward(sd, tokens.astype(np.int64), heads, blocks, dev,
                            head=False)[0].cpu().numpy()
    paths, readings, captured, failures = {}, {}, {}, []
    model, encrypted_for = None, None
    for layout, (config, parties) in PROTOCOL_LAYOUTS.items():
        tag = f"protocols {layout}"
        with cfg.temp_override(config):
            ct.init(world_size=parties, seed=SEED)
            if encrypted_for != parties:
                del model
                gc.collect()
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                model = load_numpy_state_dict(GPT2(seq_len=SEQ), sd)
                model.encrypt(src=0)
                torch.cuda.synchronize()
                encrypted_for = parties
                log(f"[{tag}] GPT-2 encrypted for {parties} parties in "
                    f"{time.perf_counter() - t0:.1f} s")
            xe = ct.cryptensor(tokens, precision=0)
            log(f"[{tag}] {parties} parties, config {config or 'the shipped one'}")
            res, more = layout_forward(tag, layout, model, xe, ref)
            failures += more
            if layout == "rss3":
                captured[tag], more = capture_layout(tag, parties, model, xe, ref, res)
                failures += more
            if layout == "active2":
                failures += tampered_forward(tag, model, xe, ref)
        paths[tag] = (res.pop("calls"), res["launches"], res["by_op"])
        readings[layout] = {k: v for k, v in res.items() if k != "by_op"}
        del xe, res
        phase_done(f"phase 14 {layout}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ct.init(world_size=2, seed=SEED)
    return paths, readings, captured, failures


def layout_forward(tag, layout, model, xe, ref):
    """One layout's forward: a warm-up recording every launch signature and
    keeping the final-LayerNorm hidden state, PROTOCOL_REPS timed forwards
    (the last with the launch counts, CommStats and peak memory reset just
    before it and read just after), one profiled; its checks."""
    import curl_tpu_torch as ct

    seen = []
    hook = model.ln.register_forward_hook(lambda mod, inp, out: seen.append(out))
    t0 = time.perf_counter()
    try:
        with recording_launches() as calls:
            out = model(xe)
    finally:
        hook.remove()
    hidden = seen[-1].get_plain_text()
    log(f"[{tag}] warm-up forward {time.perf_counter() - t0:.2f} s")
    lat = []
    for i in range(PROTOCOL_REPS):
        last = i == PROTOCOL_REPS - 1
        if last:
            reset_launches()
            ct.reset_communication_stats()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(xe)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if last:
            launches, by_op, by_mode = read_launches()
            stats = ct.get_communication_stats()
            peak = torch.cuda.max_memory_allocated()
    out = out.get_plain_text()
    best = min(lat)
    st = hidden_stats(hidden, ref)
    bound = PROTOCOL_BOUNDS[layout]
    rounds, nbytes = PROTOCOL_COUNTS[layout]
    log(f"[{tag}] latencies {', '.join(f'{x:.4f}' for x in lat)} s; {SEQ / best:.1f} tokens/s "
        f"(best)")
    log(f"[{tag}] one forward: {stats['rounds']} rounds, {stats['bytes']} bytes per party; "
        f"calls {stats['calls']}")
    log(f"[{tag}] one forward: launches {launches}; philox by mode {by_mode}")
    log(f"[{tag}] peak device memory {peak / 2**30:.2f} GiB in the forward, "
        f"{(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before it")
    log(f"[{tag}] final-LN hidden: {fmt_stats(st)} (bounds: max {HIDDEN_STATE_ATOL}, scale-free "
        f"rel L2 {bound})")
    busy = profile_forward(model, xe, best, tag=f"profile {tag}", top=6, shapes=False)
    checks = {
        f"output finite, (1, {SEQ}, vocab)": out.shape == (1, SEQ, model.fc.out_features)
        and np.isfinite(out).all(),
        f"final-LN hidden within max |err| {HIDDEN_STATE_ATOL} and scale-free rel L2 {bound}":
            np.isfinite(hidden).all() and st["max_abs"] <= HIDDEN_STATE_ATOL
            and st["scale_free_l2"] <= bound,
        f"rounds and bytes the CPU count {rounds}, {nbytes}":
            (stats["rounds"], stats["bytes"]) == (rounds, nbytes),
        "ring_mm_acc and philox launched": launches["ring_mm_acc"] > 0 and launches["philox"] > 0,
        f"{', '.join(PROTOCOL_IDLE)} (K5-K8) not launched":
            all(launches[k] == 0 for k in PROTOCOL_IDLE),
        "recorded launches equal counted": recorded_launches(calls) == (launches, by_op),
    }
    if layout == "rss3":
        checks["every ring_mm_acc launch one replicated product of 3 pairs"] = (
            launches[MASKED] == launches["ring_mm_acc"])
    else:
        checks["ring_mm (the dealer's products) launched"] = launches["ring_mm"] > 0
    if layout == "ttp2":
        checks["the TTP segments launched"] = any("ttp" in mode for mode in by_mode)
    failures = report_checks(tag, checks)
    return dict(calls=calls, launches=launches, by_op=by_op, stats=stats, best_s=best,
                latencies=lat, busy_ms=busy, peak=peak, held=held, hidden=st), failures


def capture_layout(tag, parties, model, xe, ref, res):
    """rss3 through compile_parties at its parties: the capture (counts
    reset just before it and read just after), replays at fresh seeds, and
    the forward eagerly under the capture seed's keys from the capture's
    draw counter: bit-identical shares, equal CommStats and launches."""
    import curl_tpu_torch as ct
    from curl_tpu_torch import random as crandom

    ctag = f"captured {tag}"
    forward, params = hidden_forward(model)
    step = ct.compile_parties(forward, parties)
    reset_launches()
    ct.reset_communication_stats()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    first = step(CAPTURE_SEED, params, xe)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, by_op, _ = read_launches()
    stats = ct.get_communication_stats()
    resident = torch.cuda.memory_allocated() - held
    lat = []
    for i in range(REPLAYS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(CAPTURE_SEED + 1 + i, params, xe)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    best = min(lat)
    resume = crandom.counter()
    crandom.set_counter(step.counter)
    reset_launches()
    ct.reset_communication_stats()
    with ct.parallel.mpc_context(crandom.make_party_keys(CAPTURE_SEED, parties), parties):
        eager = forward(params, xe)
    eager_launches, eager_by_op, _ = read_launches()
    eager_stats = ct.get_communication_stats()
    crandom.set_counter(resume)
    busy = profile_forward(None, None, best, tag=f"profile, {ctag}", top=6, shapes=False,
                           call=lambda: step(CAPTURE_SEED + REPLAYS + 1, params, xe))
    st = hidden_stats(hidden_of(first), ref)
    log(f"[{ctag}] first call {first_s:.2f} s: warm-up {step.warmup_s:.2f} s, capture "
        f"{step.capture_s:.2f} s; the graph holds {resident / 2**30:.3f} GiB")
    log(f"[{ctag}] replay latencies {', '.join(f'{x:.4f}' for x in lat)} s: best {best:.4f} s, "
        f"{SEQ / best:.1f} tokens/s; eager best {res['best_s']:.4f} s")
    log(f"[{ctag}] the capture: {stats['rounds']} rounds, {stats['bytes']} bytes, launches "
        f"{launches}; final-LN hidden {fmt_stats(st)}")
    checks = {
        "replay at the capture seed bit-identical to the eager forward at its keys and counter":
            same(first, eager),
        "the capture's rounds and bytes equal the eager forward's and the timed one's":
            (stats["rounds"], stats["bytes"]) == (eager_stats["rounds"], eager_stats["bytes"])
            == (res["stats"]["rounds"], res["stats"]["bytes"]),
        "the capture's launches equal the eager forward's and the timed one's":
            (launches, by_op) == (eager_launches, eager_by_op) == (res["launches"], res["by_op"]),
        f"hidden state within the bound {PROTOCOL_BOUNDS['rss3']}":
            st["scale_free_l2"] <= PROTOCOL_BOUNDS["rss3"] and st["max_abs"] <= HIDDEN_STATE_ATOL,
    }
    failures = report_checks(ctag, checks)
    chains = {name: sum(n for t, n in by_op.items() if is_tag(t))
              for name, is_tag in CHAIN_TAGS.items()}
    out = dict(launches=launches, chains=chains, best_s=best, eager_s=res["best_s"],
               busy_ms=busy, capture_s=step.capture_s, peak=resident)
    del step, first, eager
    return out, failures


def tampered_forward(tag, model, xe, ref):
    """active2 with a tampered triple: each c off by one in party 0's first
    element. The sacrifice check must poison the forward."""
    from curl_tpu_torch.mpc import get_default_provider

    provider = get_default_provider()
    honest = provider.generate_additive_triple

    def tampered(*args, **kwargs):
        a, b, c = honest(*args, **kwargs)
        share = c.share.clone()
        share.view(share.shape[0], -1)[0, 0] += 1
        return a, b, c.with_share(share)

    provider.generate_additive_triple = tampered
    try:
        hidden = private_hidden(model, xe).get_plain_text()
    finally:
        del provider.generate_additive_triple
    st = hidden_stats(hidden, ref)
    bound = PROTOCOL_BOUNDS["active2"]
    log(f"[{tag}] a tampered triple: final-LN hidden {fmt_stats(st)}")
    return report_checks(tag, {
        f"a tampered triple poisons the forward (scale-free rel L2 above 3 x {bound})":
            not st["scale_free_l2"] <= 3 * bound})


# ---------------------------------------------------------------------------
# Phase 15: the lazy scope; phase 15b: the llm_config profile
# ---------------------------------------------------------------------------

LAZY_PATH = "lazy"
LLM_PATH = "llm_config"
# scope 1 records, warms up and captures; the others replay
LAZY_SCOPES = 7
LLM_SCOPES = 2
# Phase 15b's rounds and bytes of one forward, and its bound on the
# final-LayerNorm hidden state's scale-free relative L2 error: fixed before
# the phase's first card run from `python3 scripts/torch_llm_config_bound.py
# count` and `... readings --seed S --fault` (12 blocks, session seeds 11, 1
# and 2 read 0.02136, 0.02170 and 0.02148, every LayerNorm row inside the
# profile's inv_sqrt domain; the bound is 1.5 times the worst, far below the
# private forward without block 11, 0.18431; PERF.md §6)
LLM_CONFIG_COUNTS = (1625, 2773625344)
LLM_CONFIG_SCALE_FREE_L2 = 0.0326


def lazy_scope(model, xe):
    """``model(xe)`` in one lazy scope: (probabilities, the final-LayerNorm
    hidden state, the scope's tape, the seconds its recording took)."""
    import curl_tpu_torch as ct

    seen = []
    hook = model.ln.register_forward_hook(lambda mod, inp, out: seen.append(out))
    try:
        with ct.lazy() as tape:
            t0 = time.perf_counter()
            probs = model(xe)
            record_s = time.perf_counter() - t0
    finally:
        hook.remove()
    return probs, seen[-1], tape, record_s


def timed_scopes(tag, model, xe, n):
    """``n`` scopes over ``model(xe)``, each timed from entering it until its
    output's shares are on the device; scope 1's launches (its capture's),
    reset just before it and read just after, and the graph's memory.
    Returns a dict of the readings, each scope's tape and outputs."""
    import curl_tpu_torch as ct

    out = dict(lat=[], record_s=[], stats=[], tapes=[], hidden=[], shares=[])
    reset_launches()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    for i in range(n):
        before = ct.get_communication_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, hidden, tape, record_s = lazy_scope(model, xe)
        torch.cuda.synchronize()
        out["lat"].append(time.perf_counter() - t0)
        after = ct.get_communication_stats()
        out["stats"].append((after["rounds"] - before["rounds"], after["bytes"] - before["bytes"]))
        out["record_s"].append(record_s)
        out["tapes"].append(tape)
        out["shares"].append(hidden.share)
        out["hidden"].append(hidden.get_plain_text())
        if i == 0:
            out["launches"], out["by_op"], _ = read_launches()
            out["program"] = tape.program
            out["shape"] = tuple(probs.shape)
            del probs, hidden
            torch.cuda.synchronize()
            out["graph_gib"] = (torch.cuda.memory_allocated() - held
                                - sum(s.numel() * 8 for s in out["shares"])) / 2**30
    program = out["program"]
    log(f"[{tag}] scope 1: {out['lat'][0]:.2f} s (recording {out['record_s'][0]:.2f} s, the "
        f"program's warm-up {program.warmup_s:.2f} s, capture and instantiation "
        f"{program.capture_s:.2f} s, a replay); {program.captures} capture in "
        f"{n} scopes; the graph holds {out['graph_gib']:.3f} GiB")
    log(f"[{tag}] scope latencies {', '.join(f'{x:.4f}' for x in out['lat'])} s: best of "
        f"scopes 2-{n} {min(out['lat'][1:]):.4f} s; recording a repeated scope "
        f"{', '.join(f'{x:.4f}' for x in out['record_s'][1:])} s")
    log(f"[{tag}] flushes a scope {[t.flushes for t in out['tapes']]}, fallbacks "
        f"{[t.fallbacks for t in out['tapes']]}; {len(out['tapes'][-1].nodes)} nodes left "
        f"unflushed; rounds and bytes a scope {sorted(set(out['stats']))}")
    log(f"[{tag}] the capture's launches {out['launches']}; fused_mul and max_step by op "
        f"{out['by_op']}")
    return out


def scope_checks(tag, scopes, stats, bound, ref):
    """The checks every phase's scopes hold: one flush and no fallback a
    scope, one capture, the eager forward's rounds and bytes a scope, each
    scope's hidden state within ``bound``, different shares in scopes 2
    and 3 (in scopes 1 and 2 where there are two)."""
    tapes = scopes["tapes"]
    a, b = (1, 2) if len(tapes) > 2 else (0, 1)
    checks = {
        "each scope one flush and no fallback":
            all(t.flushes == 1 and t.fallbacks == 0 for t in tapes),
        f"no capture after scope 1 ({len(tapes)} scopes, one program)":
            scopes["program"].captures == 1 and all(t.program is scopes["program"] for t in tapes),
        f"each scope counts {stats[0]} rounds and {stats[1]} bytes":
            all(s == tuple(stats) for s in scopes["stats"]),
        f"scopes {a + 1} and {b + 1} different shares":
            not torch.equal(scopes["shares"][a], scopes["shares"][b]),
    }
    for i, hidden in enumerate(scopes["hidden"]):
        st = hidden_stats(hidden, ref)
        log(f"[{tag}] scope {i + 1} final-LN hidden: {fmt_stats(st)}")
        checks[f"scope {i + 1} hidden within scale-free rel L2 {bound}"] = (
            np.isfinite(hidden).all() and st["scale_free_l2"] <= bound
            and st["max_abs"] <= HIDDEN_STATE_ATOL)
    return checks


def timed_eager(model, xe, n):
    lat = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(xe)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return lat


def run_lazy(res):
    """Phase 15: phase 4c's compressed GPT-2 and tokens through the eager API
    in lazy scopes (``with ct.lazy(): h = model(xe)``), under bench.py's
    kernel configuration: scope 1 records, warms up and captures, scopes
    2-7 replay; two plain eager forwards beside them. Returns (the path's
    (calls, launches, by_op), its captured entry, failures)."""
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg

    tag = "lazy"
    model, xe = res["model"], res["xe"]
    want = (res["stats"]["rounds"], res["stats"]["bytes"])
    with cfg.temp_override(res["config"]):
        with recording_launches() as calls:
            eager = timed_eager(model, xe, 1)
        eager += timed_eager(model, xe, 1)
        ct.reset_communication_stats()
        scopes = timed_scopes(tag, model, xe, LAZY_SCOPES)
        best = min(scopes["lat"][1:])
        busy = profile_forward(None, None, best, tag=f"profile, {tag}", top=6, shapes=False,
                               call=lambda: lazy_scope(model, xe))
    smi = nvidia_smi_line()
    log(f"[{tag}] best scope {best:.4f} s against two eager forwards "
        f"{', '.join(f'{x:.4f}' for x in eager)} s (phase 4c's best {res['best_s']:.4f} s); "
        "device busy in one repeated scope "
        + (f"{busy:.1f} ms, {busy / (best * 1e3):.1%}" if busy is not None else "not measured")
        + f" ({smi})")
    checks = scope_checks(tag, scopes, want, res["bound"], res["ref"])
    checks["the capture's launches by kernel equal phase 4c's counted forward"] = (
        (scopes["launches"], scopes["by_op"]) == (res["launches"], res["by_op"]))
    checks[f"the output's shape (1, {SEQ}, vocab)"] = scopes["shape"][:2] == (1, SEQ)
    failures = report_checks(tag, checks)
    chains = {name: sum(n for t, n in scopes["by_op"].items() if is_tag(t))
              for name, is_tag in CHAIN_TAGS.items()}
    captured = dict(launches=scopes["launches"], chains=chains, best_s=best, busy_ms=busy,
                    eager_s=eager, record_s=min(scopes["record_s"][1:]),
                    capture_s=scopes["program"].capture_s, graph_gib=scopes["graph_gib"])
    del scopes
    return (calls, res["launches"], res["by_op"]), captured, failures


def run_llm_config(dev):
    """Phase 15b: phase 4's materialized GPT-2 (weights and tokens) under
    ``init(config_file=<the port's llm_config.yaml>)``, as examples/llms.py
    --no_cmp runs it: one eager forward (counted, its launch signatures
    recorded), two lazy scopes (capture, replay), the planted fault; then
    the default profile restored. Returns (the path's (calls, launches,
    by_op), its captured entry, failures)."""
    import yaml

    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg, profile
    from curl_tpu_torch.models import GPT2, load_numpy_state_dict

    tag = "llm_config"
    blocks, heads, d, vocab = (GPT2.GEOM[k] for k in ("num_blocks", "num_heads", "embed_dim",
                                                      "vocab_size"))
    sd = random_gpt2_state(np.random.default_rng(1234), SEQ, blocks, d=d, vocab=vocab)
    tokens = gpt2_tokens()
    ids = tokens.astype(np.int64)
    ref = plain_gpt_forward(sd, ids, heads, blocks, dev, head=False)[0].cpu().numpy()
    skip_err = [hidden_stats(plain_gpt_forward(sd, ids, heads, blocks, dev, skip=j,
                                               head=False)[0].cpu().numpy(), ref)["scale_free_l2"]
                for j in range(blocks)]
    fault_block = int(np.argmin(skip_err))
    try:
        t0 = time.perf_counter()
        ct.init(config_file=profile("llm_config"), world_size=2, seed=SEED)
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = load_numpy_state_dict(GPT2(seq_len=SEQ), sd)
        model.encrypt(src=0)
        torch.cuda.synchronize()
        log(f"[{tag}] init with the profile (its tables built) {init_s:.1f} s; GPT-2 "
            f"encrypted in {time.perf_counter() - t0:.1f} s")
        xe = ct.cryptensor(tokens, precision=0)
        seen = []
        hook = model.ln.register_forward_hook(lambda mod, inp, out: seen.append(out))
        reset_launches()
        ct.reset_communication_stats()
        try:
            with recording_launches() as calls:
                eager = timed_eager(model, xe, 1)
        finally:
            hook.remove()
        launches, by_op, _ = read_launches()
        stats = ct.get_communication_stats()
        eager_hidden = hidden_stats(seen[-1].get_plain_text(), ref)
        del seen
        ct.reset_communication_stats()
        scopes = timed_scopes(tag, model, xe, LLM_SCOPES)
        fault = hidden_stats(private_hidden(model, xe, skip=fault_block).get_plain_text(), ref)
    finally:
        cfg.load_config(None)
        ct.init(world_size=2, seed=SEED)
    with open(profile("default")) as f:
        restored = cfg.to_dict() == yaml.safe_load(f)
    bound = LLM_CONFIG_SCALE_FREE_L2
    log(f"[{tag}] eager forward {eager[0]:.4f} s; {stats['rounds']} rounds, {stats['bytes']} "
        f"bytes (the CPU count {LLM_CONFIG_COUNTS[0]}, {LLM_CONFIG_COUNTS[1]}); launches "
        f"{launches}")
    log(f"[{tag}] eager final-LN hidden: {fmt_stats(eager_hidden)}; planted fault, the "
        f"private forward without block {fault_block}: {fmt_stats(fault)} (plaintext "
        f"{skip_err[fault_block]:.5f}; bound {bound})")
    checks = scope_checks(tag, scopes, LLM_CONFIG_COUNTS, bound, ref)
    checks.update({
        "the eager forward's rounds and bytes the CPU count":
            (stats["rounds"], stats["bytes"]) == tuple(LLM_CONFIG_COUNTS),
        f"the eager forward's hidden within scale-free rel L2 {bound}":
            eager_hidden["scale_free_l2"] <= bound,
        "the planted fault above the bound": fault["scale_free_l2"] > bound,
        "the capture launched every kernel the eager forward launched, as often":
            (scopes["launches"], scopes["by_op"]) == (launches, by_op),
        "ring_mm, ring_mm_acc and philox launched":
            all(launches[k] > 0 for k in ("ring_mm", "ring_mm_acc", "philox")),
        "the default profile restored after it (cfg.to_dict() is configs/default.yaml's)":
            restored,
    })
    failures = report_checks(tag, checks)
    chains = {name: sum(n for t, n in scopes["by_op"].items() if is_tag(t))
              for name, is_tag in CHAIN_TAGS.items()}
    captured = dict(launches=scopes["launches"], chains=chains, best_s=min(scopes["lat"][1:]),
                    eager_s=eager, capture_s=scopes["program"].capture_s)
    del scopes, model, xe
    gc.collect()
    torch.cuda.empty_cache()
    return (calls, launches, by_op), captured, failures


# ---------------------------------------------------------------------------
# Phase 5: every kernel in the launch signatures the forward passed
# ---------------------------------------------------------------------------

def timed_plain(plain):
    """(plain()'s output, its device ms as ``cuda_ms(plain, 1, cold=True)``
    gives them): the timed run's output serves the bit-exact check, so that
    a signature's plain version runs twice, not three times."""
    out = []

    def run():
        out[:] = [plain()]

    ms = cuda_ms(run, 1, cold=True)
    return out[0], ms


def _distinct_numel(shape, stride):
    """Elements a tensor view reads once: broadcast (stride-0) dims count once."""
    return math.prod(n for n, st in zip(shape, stride) if st != 0)


# The kernels of the JSON line: (name, the recorded kinds, which of their
# signatures, the TPU kernel it replaces, its source, the kernel it is a
# part of). fused_mul and max_step count every launch of their kernels; the
# chains are also entries of their own, parts of those.
PATH_KERNELS = (
    ("ring_mm", ("ring_mm",), lambda sig: len(sig) == 1, "curl_tpu/ops/pallas_ring_mm.py:149",
     "curl_tpu_torch/csrc/ring_mm.cu", None),
    ("ring_mm_acc", ("ring_mm",), lambda sig: len(sig) >= 2,
     "curl_tpu/ops/pallas_ring_mm.py:324", "curl_tpu_torch/csrc/ring_mm.cu", None),
    ("philox", ("philox",), None, "curl_tpu/ops/pallas_przs.py:218 (_build2d; 1-D: :60 _build)",
     "curl_tpu_torch/csrc/philox.cu", None),
    ("fused_mul", ("fused_mul", "square_chain"), None, "curl_tpu/ops/pallas_mul.py:177",
     "curl_tpu_torch/csrc/fused_mul.cu", None),
    ("ltz", ("ltz",), None, "curl_tpu/ops/pallas_max_step.py:346",
     "curl_tpu_torch/csrc/max_step.cu", None),
    ("max_step", ("max_step", "fold", "butterfly"), None, "curl_tpu/ops/pallas_max_step.py:223",
     "curl_tpu_torch/csrc/max_step.cu", None),
    ("seed_expand", ("seed_expand",), None, "curl_tpu/ops/pallas_rng.py:43",
     "curl_tpu_torch/csrc/seed_expand.cu", None),
    ("open", ("open",), None,
     "curl_tpu/ops/pallas_rng.py:43 (its draws as the Beaver open reads them, "
     "curl_tpu/mpc/primitives/beaver.py:56)", "curl_tpu_torch/csrc/seed_expand.cu", None),
    ("fused_mul square chain", ("square_chain",), None,
     "curl_tpu/ops/pallas_mul.py:177 (exp's squarings, curl_tpu/functions/approximations.py:96)",
     "curl_tpu_torch/csrc/fused_mul.cu", "fused_mul"),
    ("max_step fold", ("fold",), None,
     "curl_tpu/ops/pallas_max_step.py:223 (scan_reduction's fold, curl_tpu/functions/maximum.py:324)",
     "curl_tpu_torch/csrc/max_step.cu", "max_step"),
    ("max_step butterfly", ("butterfly",), None,
     "curl_tpu/ops/pallas_max_step.py:223 (scan_reduction's butterfly, "
     "curl_tpu/functions/maximum.py:373)", "curl_tpu_torch/csrc/max_step.cu", "max_step"),
    ("ring_mm_acc 3 pairs", ("ring_mm",), lambda sig: len(sig) == 3,
     "curl_tpu/ops/pallas_ring_mm.py:324 (the product against a Beaver-masked operand, "
     "curl_tpu/mpc/primitives/beaver.py:196)", "curl_tpu_torch/csrc/ring_mm.cu", "ring_mm_acc"),
)
# ring_mm_acc's 3-pair launches (a product against a Beaver-masked operand),
# counted apart
MASKED = "ring_mm_acc 3 pairs"
# the kernels read_launches counts, and the kinds recording_launches records
PATH_FAMILIES = tuple(name for name, *_, part_of in PATH_KERNELS if part_of is None)
KINDS = ("ring_mm", "philox") + FUSED_KINDS + ("seed_expand", "open")
# the launch-count tags of the chain entries (read_launches' by_op)
CHAIN_TAGS = {"fused_mul square chain": lambda tag: tag.endswith("+chain"),
              "max_step fold": lambda tag: tag == "fold",
              "max_step butterfly": lambda tag: tag in ("butterfly", "butterfly_unpaired")}
# the main path of the slices that ported the kernels, whose launches and
# milliseconds the JSON line's top-level numbers are; an entry that path
# does not launch (the 3-pair ring_mm_acc) takes GENERATE_PATH's, this
# slice's main path
MAIN_PATH = "compressed"
GENERATE_PATH = "generate"


def _other_layout(t):
    """A 2-D operand's copy in the other of row- and column-major."""
    return t.t().contiguous().t() if t.stride(-1) == 1 else t.contiguous()


def time_ring_mm(sig, dev, gen):
    """One (shapes, strides) signature of ring_mm on fresh random operands
    of the same layout: bit-exact against plain; its time (L2-cold), on
    contiguous copies (what the layout costs), plain, and bounds. A Beaver
    reconstruction whose delta (the second pair's B) is 2-D is also timed
    with delta in the other of row- and column-major (the open route writes
    it row-major, the composable route's is column-major for weight.t())."""
    from curl_tpu_torch.kernels import ring_mm

    pairs = [(_strided_i64(gen, sa, st_a, dev), _strided_i64(gen, sb, st_b, dev))
             for sa, st_a, sb, st_b in sig]
    got = ring_mm.ring_mm(pairs)
    want, plain_ms = timed_plain(lambda: ring_mm.plain(pairs))
    if not torch.equal(got, want):
        raise AssertionError(f"ring_mm at the path layout {sig}: kernel != plain")
    del want
    dense = [(a.contiguous(), b.contiguous()) for a, b in pairs]
    nbytes = sum(_distinct_numel(sa, st_a) + _distinct_numel(sb, st_b)
                 for sa, st_a, sb, st_b in sig) * 8 + got.numel() * 8
    macs = sum(got.numel() * sa[-1] for sa, _, _, _ in sig)
    g = ring_mm.plan(pairs, torch.cuda.get_device_properties(dev).multi_processor_count)
    other = {}
    if len(pairs) == 2 and pairs[1][1].dim() == 2:
        flipped = [pairs[0], (pairs[1][0], _other_layout(pairs[1][1]))]
        other["other_ms"] = cuda_ms(lambda: ring_mm.ring_mm(flipped), 5, cold=True)
    return dict(split=f"{g['splits']} chunks of {g['chunk']} 32-k tiles, "
                      f"{g['out_tiles'] * g['splits']} blocks", **other,
                ms=cuda_ms(lambda: ring_mm.ring_mm(pairs), 5, cold=True),
                dense_ms=cuda_ms(lambda: ring_mm.ring_mm(dense), 5, cold=True),
                plain_ms=plain_ms,
                t_bytes=nbytes / HBM_BYTES_PER_S * 1e3,
                t_ops=36 * 2 * macs / INT8_OPS_PER_S * 1e3)


def philox_work(sig):
    """(bytes, 32-bit operations) of one grouped philox launch: every output
    row written once, a given plaintext's row read once; one Philox call
    per pair and per stream (a fresh draw's own stream included)."""
    nbytes = sum(((keys + emit) * n + (n if what in ("plain", "plain_lane", "ttp_plain") else 0))
                 * 8 for what, _, keys, n, _, _, _, emit in sig)
    return nbytes, philox_calls(sig) * PHILOX_OPS


def philox_calls(sig):
    """Philox calls of one grouped launch: one per pair and per stream
    (a fresh draw's own stream included; a TTP sharing draws no stream for
    party 0)."""
    return sum((keys + what.endswith("fresh") - what.startswith("ttp")) * ((n + 1) // 2)
               for what, _, keys, n, *_ in sig)


def philox_segments(sig, dev, gen):
    """Segments of a recorded signature on the checks' keys, named by the
    session key table's slots as the path names them (the ring seeds, or
    one slot a row from the first), and fresh plaintexts."""
    from curl_tpu_torch import random as crandom
    from curl_tpu_torch.kernels.philox import Segment

    keys = check_keys()
    segments = []
    for i, (what, how, rows, n, kbits, src, draw_kbits, emit) in enumerate(sig):
        plain = None
        if what in ("plain", "ttp_plain"):
            plain = rand_i64(gen, (n,), dev)
        elif what == "plain_lane":
            plain = rand_i64(gen, (rows, n), dev)
        segments.append(Segment(
            what, crandom.TABLE.ref(keys["ring"].slot, rows), 3 + i, n, how=how, kbits=kbits,
            src=src, plain=plain, dealer=keys["dealer"] if what.endswith("fresh") else None,
            draw_counter=50 + i, draw_kbits=draw_kbits, emit=emit))
    return segments


def time_philox(sig, dev, gen):
    """One grouped launch's signature (its segments') on fresh keys and
    plaintexts: bit-exact against plain_philox_group, timed (L2-cold)."""
    from curl_tpu_torch.kernels import philox

    segments = philox_segments(sig, dev, gen)
    want, plain_ms = timed_plain(lambda: philox.plain_philox_group(segments, dev))
    _check_group(_describe("philox", sig), segments, dev, want)
    del want
    nbytes, ops = philox_work(sig)
    return dict(ms=cuda_ms(lambda: philox.philox_group(segments, dev), 5, cold=True),
                plain_ms=plain_ms,
                t_bytes=nbytes / HBM_BYTES_PER_S * 1e3, t_ops=ops / INT32_OPS_PER_S * 1e3)


def time_fused(kind, sig, count, dev, gen):
    """One launch signature of fused_mul, ltz or max_step on fresh operands
    of the same shapes and strides: bit-exact against plain, timed
    (L2-cold)."""
    spec = fused_spec(kind, sig)
    ops = [_strided_i64(gen, shape, st, dev) for shape, st in spec["operands"]]
    got = fused_run(spec, ops, count)
    want, plain_ms = timed_plain(lambda: fused_run(spec, ops, count, plain=True))
    if not torch.equal(got, want):
        raise AssertionError(f"{fused_name(spec)} at the path signature {sig}: kernel != plain")
    del want
    nbytes, nops = fused_work(spec)
    return dict(ms=cuda_ms(lambda: fused_run(spec, ops, count), 5, cold=True),
                plain_ms=plain_ms,
                t_bytes=nbytes / HBM_BYTES_PER_S * 1e3, t_ops=nops / INT32_OPS_PER_S * 1e3)


def time_seed(sig, dev, gen):
    """One (mode, elements, parties) of seed_expand, or one ("open",
    transposed, share0's shape, b's shape, b's strides) of its open, on
    fresh shares: bit-exact against plain, timed (L2-cold)."""
    mode, b, transposed = sig[0], None, False
    if mode == "open":
        _, transposed, shape, b_shape, b_stride = sig
        x = rand_i64(gen, shape, dev)
        b = _strided_i64(gen, b_shape, b_stride, dev)
        work = seed_work(mode, x.numel(), (b_shape, b_stride))
    else:
        x = rand_i64(gen, (sig[1],), dev)
        work = seed_work(mode, sig[1])

    def run(plain=False):
        return seed_run(mode, x, plain, b, transposed)

    want, plain_ms = timed_plain(lambda: run(True))
    if not torch.equal(run(), want):
        raise AssertionError(f"seed_expand at the path signature {sig}: kernel != plain")
    del want
    return dict(ms=cuda_ms(run, 5, cold=True), plain_ms=plain_ms,
                t_bytes=work[0] / HBM_BYTES_PER_S * 1e3, t_ops=work[1] / INT32_OPS_PER_S * 1e3)


def time_signatures(paths, dev, gen):
    """Every launch signature any path recorded, once: {kind: {sig: row}}."""
    check_keys()  # the phases' sessions have written the table since phase 3
    union = {kind: {} for kind in KINDS}
    for calls in paths.values():
        for kind, sigs in calls.items():
            for sig in sigs:
                union[kind].setdefault(sig, None)
    rows = {}
    for kind, sigs in union.items():
        rows[kind] = {}
        for i, sig in enumerate(sigs):
            if kind == "ring_mm":
                rows[kind][sig] = time_ring_mm(sig, dev, gen)
            elif kind == "philox":
                rows[kind][sig] = time_philox(sig, dev, gen)
            elif kind in ("seed_expand", "open"):
                rows[kind][sig] = time_seed(sig, dev, gen)
            else:
                rows[kind][sig] = time_fused(kind, sig, i, dev, gen)
            torch.cuda.empty_cache()
        log(f"[path] {kind}: {len(sigs)} launch signatures over the paths "
            f"{', '.join(paths)}, each bit-exact vs plain")
    for sig, r in rows["ring_mm"].items():
        x = r["ms"] / max(r["t_bytes"], r["t_ops"])
        if x > 10:
            log(f"[path] ring_mm above 10x its bound: {x:.1f}x, {r['ms']:.4f} ms, {r['split']}; "
                f"{_describe('ring_mm', sig)}")
    return rows


def _describe(kind, sig):
    if kind == "ring_mm":
        return "shapes(strides) " + " + ".join(f"{sa}{st_a}@{sb}{st_b}" for sa, st_a, sb, st_b in sig)
    if kind == "philox":
        return " + ".join(
            f"{what}{'' if what == 'draw' else '/' + how} rows {keys}{'+1' if emit else ''} n {n}"
            f"{'' if kbits == 64 else f' kbits {kbits}'}"
            f"{f' draw_kbits {dk}' if what.endswith('fresh') and dk != 64 else ''}"
            for what, how, keys, n, kbits, _, dk, emit in sig)
    if kind == "seed_expand":
        return f"{sig[0]} n {sig[1]} parties {sig[2]}"
    if kind == "open":
        return f"share0 {sig[2]}{'.t()' if sig[1] else ''}, b {sig[3]}{sig[4]}"
    return " ".join(str(x) for x in sig)


def path_totals(path, calls, rows, top=8):
    """Each kernel's launches, time, plain time and bound summed over one
    path's recorded launches; its largest signatures logged."""
    out = {}
    for name, kinds, keep, _, _, part_of in PATH_KERNELS:
        mine = [(sig, n, rows[kind][sig], kind) for kind in kinds
                for sig, n in calls[kind].items() if keep is None or keep(sig)]
        if not mine:
            continue
        tot = {k: sum(r[k] * n for _, n, r, _ in mine)
               for k in ("ms", "plain_ms", "t_bytes", "t_ops")}
        for sig, n, r, kind in sorted(mine, key=lambda m: -m[2]["ms"] * m[1])[:top]:
            if part_of is not None:  # logged with the kernel it is a part of
                break
            dense = f"; contiguous {r['dense_ms']:.4f} ms" if "dense_ms" in r else ""
            dense += f"; delta in the other layout {r['other_ms']:.4f} ms" if "other_ms" in r else ""
            dense += f"; {r['split']}" if "split" in r else ""
            log(f"[path] {path} {name} x{n}: {r['ms']:.4f} ms each, {r['ms'] * n:.3f} ms a forward "
                f"({r['ms'] * n / (tot['ms'] or 1.0):.1%}){dense}; bound "
                f"{max(r['t_bytes'], r['t_ops']):.5f} ms; plain {r['plain_ms']:.3f} ms; "
                f"{_describe(kind, sig)}")
        # the bound is each signature's max(bytes, operations), summed;
        # "bound_by" names the side that bounds the larger part of it
        by_side = {"bytes": 0.0, "operations": 0.0}
        for _, n, r, _ in mine:
            side = "bytes" if r["t_bytes"] >= r["t_ops"] else "operations"
            by_side[side] += n * max(r["t_bytes"], r["t_ops"])
        b = sum(by_side.values())
        by = max(by_side, key=by_side.get)
        launches = sum(n for _, n, _, _ in mine)
        dense = ""
        if any("other_ms" in r for _, _, r, _ in mine):
            dense = (f"; with each 2-D delta in the other layout "
                     f"{sum(r.get('other_ms', r['ms']) * n for _, n, r, _ in mine):.3f} ms")
        log(f"[path] {path} {name}: one forward's {launches} launches over {len(mine)} "
            f"signatures: {tot['ms']:.3f} ms (bound {b:.4f} ms, {by_side['bytes']:.4f} by bytes + "
            f"{by_side['operations']:.4f} by operations, {tot['ms'] / b:.2f}x; plain "
            f"{tot['plain_ms']:.1f} ms{dense})")
        if name == "philox":
            philox_size_classes(path, [m[:3] for m in mine])
        if name in ("fused_mul", "ltz", "max_step", "open"):
            for sig, n, r, kind in sorted(mine, key=lambda m: -m[2]["ms"] / max(m[2]["t_bytes"],
                                                                                m[2]["t_ops"])):
                if fused_elements(kind, sig) > FUSED_LARGE:
                    log(f"[path] {path} {name} above {FUSED_LARGE} elements x{n}: "
                        f"{r['ms'] / max(r['t_bytes'], r['t_ops']):.2f}x its bound, "
                        f"{r['ms']:.4f} ms against {max(r['t_bytes'], r['t_ops']):.5f}; "
                        f"{_describe(kind, sig)}")
        out[name] = dict(launches=launches, signatures=len(mine), ms=tot["ms"],
                         plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by)
    return out


# fused protocol launches whose multiple of the bound is logged one by one
FUSED_LARGE = 1_000_000


def fused_elements(kind, sig):
    """Output elements of one fused protocol launch (of an open: of y)."""
    if kind == "open":
        return math.prod(sig[2])
    spec = fused_spec(kind, sig)
    shape = spec["operands"][0][0]
    n = math.prod(shape[1:])
    return n // shape[-2] if kind == "fold" else n


# philox launches by the elements of the launch: at most 1k, at most 256k,
# above
PHILOX_SIZE_CLASSES = ((1024, "<= 1k"), (256 * 1024, "<= 256k"), (None, "> 256k"))
# philox launches whose multiple of the bound is logged one by one
PHILOX_LARGE = 1_000_000


def philox_elements(sig):
    """Elements of one philox launch: n summed over its segments."""
    return sum(seg[3] for seg in sig)


def philox_size_classes(path, mine):
    """One path's philox launches, ms and bound by size class."""
    parts, lo = [], 0
    for limit, label in PHILOX_SIZE_CLASSES:
        rows = [(n, r) for sig, n, r in mine
                if lo < philox_elements(sig) and (limit is None or philox_elements(sig) <= limit)]
        parts.append(f"{label}: {sum(n for n, _ in rows)} launches, "
                     f"{sum(n * r['ms'] for n, r in rows):.3f} ms, bound "
                     f"{sum(n * max(r['t_bytes'], r['t_ops']) for n, r in rows):.4f} ms")
        lo = limit
    log(f"[path] {path} philox by size class: " + "; ".join(parts))
    large = sorted(((r["ms"] / max(r["t_bytes"], r["t_ops"]), n, sig, r) for sig, n, r in mine
                    if philox_elements(sig) > PHILOX_LARGE), key=lambda x: -x[0])
    for x, n, sig, r in large:
        log(f"[path] {path} philox above {PHILOX_LARGE} elements x{n}: {x:.2f}x its bound, "
            f"{r['ms']:.4f} ms against {max(r['t_bytes'], r['t_ops']):.5f}; "
            f"{_describe('philox', sig)}")


ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()


def phase_done(name):
    """A ``[time]`` line: the host seconds since the run started."""
    log(f"[time] {name} done at {time.perf_counter() - START:.1f} s")


def main():
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this runs on a CUDA card")
    import curl_tpu_torch  # noqa: F401  (fails where the package is missing)
    from curl_tpu_torch.kernels import build

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    set_int32_rate(dev)

    secs = build.build_all()
    log(f"[build] {', '.join(build.KERNELS)} built for sm_90a in {secs:.1f} s")
    for name, text in sorted(build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    for name in ("philox", "fused_mul", "max_step", "seed_expand"):
        spills = [line for line in build.build_logs.get(name, "").splitlines()
                  if re.search(r"[1-9]\d* bytes spill", line)]
        if spills:
            raise AssertionError(f"ptxas spills in csrc/{name}.cu: {spills}")
    global PHILOX_OPS
    PHILOX_OPS, mix = philox_sass_ops()
    log(f"[build] philox: one Philox4x32-10 call is {PHILOX_OPS:g} SASS instructions with its "
        "XOR fold (philox_rate_kernel, cuobjdump -sass): " + ", ".join(
            f"{op} {k:g}" for op, k in mix.items()))

    gen = torch.Generator().manual_seed(5)
    check_ring_mm(dev, gen)
    largest = provider_groups(dev, gen)["triple (64,768)@(768,6283) a, b"]
    check_philox_rate(dev, philox_calls([seg.signature() for seg in largest]))
    del largest
    check_launch_floor(dev)
    check_philox(dev, gen)
    torch.cuda.empty_cache()
    check_fused(dev, gen)
    check_seed(dev, gen)
    check_open(dev, gen)
    phase_done("phases 1-3c")

    kernels, protocols, failures = run_paths(dev, gen)
    if failures:
        raise AssertionError("; ".join(failures))
    print(json.dumps({"kernels": kernels, "protocols": protocols}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def run_paths(dev, gen):
    """Phases 3d-5: the function library, each path's forward, then every
    launch signature any of them recorded, held bit-exact and timed; (the
    kernels' JSON entries, phase 14's entries by layout, the failed
    checks)."""
    # each path: the signatures its warm-up forward recorded, and the launch
    # counts of one forward, reset just before it and read just after
    functions, failures = run_functions()
    paths = {"functions": (functions["calls"], functions["launches"], functions["by_op"])}
    del functions
    phase_done("phase 3d")
    forward, fw_failures = run_forward(dev)
    failures += fw_failures
    paths["forward"] = (forward.pop("calls"), forward.pop("launches"), forward.pop("by_op"))
    launches, by_op, calls, bench_failures, bench_stats = run_bench_forward(forward)
    failures += bench_failures
    paths["bench"] = (calls, launches, by_op)
    batch8, batch8_failures = run_batch8(forward)
    failures += batch8_failures
    paths["batch8"] = (batch8["calls"], batch8["launches"], batch8["by_op"])
    del batch8
    sd = forward["sd"]  # phase 7's weights
    compressed, comp_failures = run_compressed(forward, bench_stats, gen)
    failures += comp_failures
    paths["compressed"] = (compressed["calls"], compressed["launches"], compressed["by_op"])
    compressed = {k: compressed[k] for k in CAPTURE_KEYS}  # phase 6's
    del forward
    torch.cuda.empty_cache()
    phase_done("phases 4, 4b, 4e, 4c")
    neo, neo_failures = run_neo(dev, gen, blocks=NEO_BLOCKS)
    failures += neo_failures
    paths["neo"] = (neo["calls"], neo["launches"], neo["by_op"])
    neo_large, nl_failures = run_neo(dev, gen, tag="neo_large", model="GPTNeoLarge",
                                     bound=NEO_LARGE_SCALE_FREE_L2, rounds=NEO_LARGE_ROUNDS,
                                     blocks=NEO_LARGE_BLOCKS)
    failures += nl_failures
    paths["neo_large"] = (neo_large["calls"], neo_large["launches"], neo_large["by_op"])
    phase_done("phases 4d, 4f")
    # phases 7, 8 and 9 before phase 5, which holds their launch signatures too
    generated, gen_failures = run_generate(sd)
    failures += gen_failures
    paths[GENERATE_PATH] = (generated["calls"], generated["launches"], generated["by_op"])
    del sd
    phase_done("phase 7")
    for name, run in (("bert", lambda: run_bert(dev)), ("qnli", lambda: run_qnli(dev, ROOT))):
        res, more = run()
        failures += more
        paths[name] = (res["calls"], res["launches"], res["by_op"])
        del res
    phase_done("phases 8, 9")
    # phase 10: the offline/online split on phase 4c's model and tokens, and
    # the dealer; before phase 5, which holds their launch signatures too
    cached, cached_failures = run_cached(compressed)
    failures += cached_failures + run_dealer()
    paths.update(cached.pop("paths"))
    phase_done("phase 10")
    # phase 11: ResNet-18 (eager and captured) and ResNet-50 at 224 x 224;
    # before phase 5, which holds their launch signatures too
    resnet_captured = {}
    for name, capture in RESNETS:
        res, more = run_resnet(dev, name, capture)
        failures += more
        paths[name] = (res["calls"], res["launches"], res["by_op"])
        if capture:
            resnet_captured[name] = res["captured"]
        del res
    phase_done("phase 11")
    # phase 12: LeNet training, eager and captured; before phase 5, which
    # holds its launch signatures too
    train, train_captured, train_failures = run_train(dev)
    failures += train_failures
    paths[TRAIN_PATH] = (train["calls"], train["launches"], train["by_op"])
    del train
    phase_done("phase 12")
    # phase 13: bring your own model (from_pytorch, from_onnx, DPSplitModel);
    # before phase 5, which holds its launch signatures too
    convert_paths, convert_captured, convert_failures = run_convert(dev)
    failures += convert_failures
    paths.update(convert_paths)
    phase_done("phase 13")
    # phase 14: GPT-2 under rss3, ttp2, tfp3 and active2; before phase 5,
    # which holds its launch signatures too
    protocol_paths, protocols, protocol_captured, protocol_failures = run_protocols(dev)
    failures += protocol_failures
    paths.update(protocol_paths)
    phase_done("phase 14")
    # phases 15 and 15b: the lazy scope over phase 4c's model, and phase 4's
    # GPT-2 under llm_config; before phase 5, which holds their launch
    # signatures too
    paths[LAZY_PATH], lazy_captured, lazy_failures = run_lazy(compressed)
    failures += lazy_failures
    phase_done("phase 15")
    paths[LLM_PATH], llm_captured, llm_failures = run_llm_config(dev)
    failures += llm_failures
    phase_done("phase 15b")

    # phase 5: every signature of every path held bit-exact and timed once,
    # then summed over each path's launches
    rows = time_signatures({p: c for p, (c, _, _) in paths.items()}, dev, gen)
    totals = {p: path_totals(p, c, rows) for p, (c, _, _) in paths.items()}
    phase_done("phase 5")
    for layout in PROTOCOL_LAYOUTS:
        t = ttp_segment_totals(paths[f"protocols {layout}"][0], rows)
        if t["launches"]:
            protocols[layout]["ttp_segments"] = t
            log(f"[path] protocols {layout} philox launches with a TTP segment: {t['launches']}, "
                f"{t['ms']:.3f} ms (bound {t['bound_ms']:.4f} ms, {t['ms'] / t['bound_ms']:.2f}x; "
                f"plain {t['plain_ms']:.1f} ms)")
    for p, t in totals.items():
        log(f"[path] {p} ring_mm and ring_mm_acc against their bounds: " + ", ".join(
            f"{name} {t[name]['ms']:.3f} ms = {t[name]['ms'] / t[name]['bound_ms']:.2f}x "
            f"{t[name]['bound_ms']:.4f} ms" for name in ("ring_mm", "ring_mm_acc") if name in t))
        _, launches, by_op = paths[p]
        log(f"[path] {p} fused_mul launches {launches['fused_mul']}: " + ", ".join(
            f"{tag} {n}" for tag, n in sorted(by_op.items()) if "+" in tag)
            + f"; max_step launches {launches['max_step']}: " + ", ".join(
            f"{tag} {by_op.get(tag, 0)}" for tag in MAX_STEP_TAGS))

    # phase 6: the compressed GPT-2, GPT-Neo and GPT-Neo 2.7B forwards
    # through compile_parties, captured once and replayed; each model freed
    # after
    captured = {GENERATE_PATH: generated["captured"], **cached.pop("captured"), **resnet_captured,
                TRAIN_PATH: train_captured, **convert_captured, **protocol_captured,
                LAZY_PATH: lazy_captured, LLM_PATH: llm_captured}
    del generated
    for p, res in (("compressed", compressed), ("neo", neo), ("neo_large", neo_large)):
        captured[p], cap_failures = run_captured(p, res)
        failures += cap_failures
        res.clear()
        torch.cuda.empty_cache()
    del compressed, neo, neo_large
    phase_done("phase 6")
    smi = nvidia_smi_line()
    log(f"[cached] the online replay {cached['best_s']:.4f} s (best of {REPLAYS}) beside phase "
        f"6's compile_parties replay of the same model and tokens {captured['compressed']['best_s']:.4f} "
        f"s; the captured fill {cached['fill_best_s']:.4f} s (best of {FILL_REPLAYS}), "
        f"offline_fill_sec {cached['offline_fill_s']:.4f} s; device busy in one online replay "
        + (f"{cached['busy_ms']:.1f} ms, {cached['busy_ms'] / (cached['best_s'] * 1e3):.1%}"
           if cached["busy_ms"] is not None else "not measured") + f" ({smi})")
    log(f"[lazy] the best repeated scope {lazy_captured['best_s']:.4f} s (recording "
        f"{lazy_captured['record_s']:.4f} s of it) beside phase 6's compile_parties replay of the "
        f"same model and tokens {captured['compressed']['best_s']:.4f} s and the eager forwards "
        f"{', '.join(f'{x:.4f}' for x in lazy_captured['eager_s'])} s ({smi})")

    def counted(p, name):
        """The launches one forward of path p counted for a JSON entry."""
        _, launches, by_op = paths[p]
        if name in CHAIN_TAGS:
            return sum(n for tag, n in by_op.items() if CHAIN_TAGS[name](tag))
        return launches[name]

    kernels = []
    for name, _, _, replaces, source, part_of in PATH_KERNELS:
        path = MAIN_PATH if name in totals[MAIN_PATH] else GENERATE_PATH
        main = totals[path].get(name)
        if main is None:  # the main path's check has failed already
            continue
        run = "one phase 4c forward" if path == MAIN_PATH else "one phase 7 generation"
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counted(path, name), max_abs_err=0, ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None, part_of=part_of,
            shape=f"{run}: every launch, {main['signatures']} signatures",
            paths={p: dict(t[name], launches=counted(p, name))
                   for p, t in totals.items() if name in t},
            captured={p: c["launches"].get(name, c["chains"].get(name))
                      for p, c in captured.items()}))
    return kernels, protocol_entries(protocols, protocol_captured), failures


def ttp_segment_totals(calls, rows):
    """Over one path's philox launches that carry a TTP segment: launches,
    card ms, bound ms and plain ms (phase 5's rows)."""
    mine = [(n, rows["philox"][sig]) for sig, n in calls["philox"].items()
            if any(seg[0].startswith("ttp") for seg in sig)]
    return dict(launches=sum(n for n, _ in mine), ms=sum(n * r["ms"] for n, r in mine),
                bound_ms=sum(n * max(r["t_bytes"], r["t_ops"]) for n, r in mine),
                plain_ms=sum(n * r["plain_ms"] for n, r in mine))


def protocol_entries(protocols, captured):
    """Phase 14's readings for the JSON line, one entry a layout."""
    out = {}
    for layout, r in protocols.items():
        config, parties = PROTOCOL_LAYOUTS[layout]
        cap = captured.get(f"protocols {layout}")
        out[layout] = dict(
            parties=parties, config=config, rounds=r["stats"]["rounds"], bytes=r["stats"]["bytes"],
            best_s=r["best_s"], latencies_s=r["latencies"], busy_ms=r["busy_ms"],
            peak_gib=r["peak"] / 2**30, above_held_gib=(r["peak"] - r["held"]) / 2**30,
            scale_free_l2=r["hidden"]["scale_free_l2"], max_abs_err=r["hidden"]["max_abs"],
            bound=PROTOCOL_BOUNDS[layout], launches=r["launches"],
            ttp_segments=r.get("ttp_segments"),
            captured=None if cap is None else dict(best_s=cap["best_s"], busy_ms=cap["busy_ms"],
                                                   capture_s=cap["capture_s"]))
    return out

if __name__ == "__main__":
    main()
