#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, is right and starts.

    python3 chip_smoke.py

Phases, each on its own printed lines (any failure exits non-zero):

  1. the card: name and power limit; TF32 off for matmuls and cuDNN;
  2. the build of the CUDA kernels from ``src/repro_torch/csrc``, with
     each kernel's registers and spills (``-Xptxas -v``): the
     tensor-core attention kernels (K9's bf16 and fp32, K10's bf16 and
     fp32) may not spill;
  3. each kernel against its plain PyTorch version on the card (K1 full
     and weights-only, K2a, K2b; K3 at int8 and int4 levels; K4 and K5
     full and weights-only) at the main path's shapes, at an odd batch
     and narrow (and odd) rows, and at a wide F (the split-row path);
     K7 and K8 bitwise at WDL-Criteo's leaf shapes, and their table
     kernels (one launch over a party's tensors: the in-place step,
     with and without the mask, and the updates) bitwise over
     WDL-Criteo's and smollm-360m's party lists and a 100-leaf ragged
     list (three launches; 1-element and unaligned leaves), bf16
     params, gradients and state included; a step captured in a CUDA
     graph and replayed against eager steps; no allocation in an eager
     step; times from CUDA events beside the least time the card could
     take (the steps warm and cold, beside ``torch._fused_adagrad_``);
  4. the golden traces (``tests/golden``) replayed on the card from the
     reference's initial parameters, held to the tests' tolerance, with
     plain AdaGrad and once more through K7;
  5. the main paths: ``repro_torch.launch.train`` at WDL-Criteo's full
     width (B = 256, R = W = 5, celu) with the kernels' launch counts:
     the fp32 cache (K1) with fused AdaGrad (K7 once on every update of
     every party, in every run below unless named), DSSM-Avazu,
     ``--no-cache-fusion`` (K2), the int8 / int4 / bf16 caches (K3 + K4,
     K3 + K5, K1), the int8 wire and the int8 cache under the int4x2 wire
     (K3), the int8 / bf16 optimizer states (K8, K7) and SM3 (neither);
     five full-width rounds on the card against the CPU (fp32; int8
     cache + int8 wire and int8 optimizer state on the same uniforms,
     the latter beside a mutation run with zeroed updates); ms per round
     and per local step, and for the four AdaGrad routes in turns, each
     route's kernels and busy ms per round from the profiler;
  6. the pipelined scheduler (``engine.make_pipeline``): the goldens at
     depth 0 on the card, within the tests' tolerance and bitwise the
     port's ``make_round``; WDL-Criteo at full width through
     ``train_dlrm`` at ``--pipeline-depth`` 1, 2 and 4 (50 rounds; K1 and
     K7 launches against the counts derived from the schedule,
     ``_pipeline_schedule``), uniform sampling at depth 2 and DP
     (sigma 0.5) over the int8 wire (K3), each also five rounds on the
     card against the CPU; ms per round on the host clock (depths 0, 1,
     2 in turns), device busy ms per round (profiler), the simulated WAN
     seconds against the sequential charge and the AUC; smollm-360m at
     full width through ``train_llm`` at depth 1 (3 rounds; K9-LSE, K10,
     K9, K1 and K7 launches derived by ``_llm_launches``), its losses,
     ms per round, busy ms per round and peak memory;
  7. the serving kernels against their plain versions: K6 and K11
     bitwise at the serving shape (W = 4 ring slots, C = 8 lanes,
     F = 960) and at a wide ring, K9 at the long-prompt shape
     (1, 4096, 15, 64) bf16, causal, with a window of 1,024, at head
     dim 128 and at the reduced model's (2, 3072, 4, 32), and K9 and
     K9-LSE at S = 320 (an odd number of 64-row tiles) at each head
     dim, each element within a bf16 ulp of its own magnitude, timed beside
     ``F.scaled_dot_product_attention``, with the rate of the two
     products of its work and of the three it issues, and the
     tensor-core instructions in the SASS of its bf16 kernel (none
     fails);
  8. the serving path: ``repro_torch.launch.serve`` at smollm-360m's
     full width (32 requests, 8 lanes, prompt 16, gen 16, closed burst)
     with the int8 ring and wire (K6 on every ring read; two runs, equal
     tokens and bitwise equal logits), the int4 ring (K11), the fp32
     ring and wire against the sequential loop (each lane's logits at
     every token against the loop's for its request, fed the same
     tokens, and ``naive_generate``), and a 4,096-token prompt (K9 in
     every attention layer of each prefill, the prefill's logits held
     against the same prefill through the plain attention); launches
     and ms per decode step;
  9. the training kernels against their plain versions: K9-LSE (the
     forward with the row log-sum-exp) and K10's dkv and dq kernels at
     (1, 4096, 15, 64) bf16, causal, with a window of 1,024, at head dim
     128 and in fp32, at the training phase's (2, 4096, 15, 64) in bf16
     and fp32, at (1, 4096, 15, 128) fp32 and at the reduced model's
     (2, 3072, 4, 32) in bf16 and fp32, K9-LSE in fp32 at S = 320 at
     each head dim (causal, windowed, non-causal) and K10 at S = 320 (an
     odd number of 64-row tiles) in both dtypes at each head dim, each
     element within a limit of its own magnitude (K10's fp32 cases at
     S = 320 against the fp64 plain version); every fp32 case of K9-LSE
     and K10 on four more draws, and on all five against the fp64 plain
     version too; K9's output with the LSE pointer set bitwise its
     output without it, K10's outputs bitwise the same on a second run;
     timed beside the least time and SDPA's forward and backward (bf16,
     and fp32 with TF32 off, naming the kernels SDPA ran); the
     tensor-core instructions in the SASS of K9-LSE's fp32 kernel and of
     K10's bf16 and fp32 kernels (none fails) and their TFLOP/s, K9-LSE's
     fp32 beside SDPA's fp32 forward; K1 on its split-row path at the
     LLM cut tensor (2, 2, 3,932,160) and a wide ragged row (2, 3,
     1,000,003), full and weights-only, against its plain version,
     bitwise the same on a second run, timed beside its bound;
 10. the LLM training path: ``repro_torch.launch.train`` at smollm-360m's
     full width (B = 2, S = 4,096, R = W = 2, 3 celu rounds, fp32 cache,
     AdaGrad through K7, remat on) with the exact launch counts of
     K9-LSE, K10, K9, K1 and K7 derived from the code, each round's loss,
     ms per round, the card's busy time per round (profiler, rounds 2-3
     of a second run) and the peak memory beside ``launch/budget.py``'s
     budget; then one
     ``launch/steps.py`` train step at B = 1, S = 4,096 through
     K9-LSE / K10 against the same step through the plain attention,
     loss and every gradient leaf held to a limit;
 11. the reduced smollm-360m (head dim 32) past 2,048 tokens: two celu
     rounds of ``train_llm`` at B = 2, S = 3,072 and a train step, each
     against the same run through the plain attention, and the serving
     engine on 3,072-token prompts, the prefill's logits against the
     plain attention's;
 12. a JSON line of per-kernel results, then the last line
     ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is present or
when it is not run from a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12           # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12          # H100 SXM bf16 tensor cores, dense
# fp32-accurate products on the tensor cores: six bf16 products each
PEAK_SPLIT_FLOPS = PEAK_BF16_FLOPS / 6
KERNEL_TOL = 3e-5                 # fp32 sums of up to 61,440 terms reordered
NEAR = 1e-6                       # rows this close to cos ξ may flip
# Loss over 5 full-width rounds, card against CPU: this comparison reads
# 3.1e-4 at round 5 on an H100 (PERF.md), so the limit is about 3x that.
# (AdaGrad's first steps move every coordinate by ±lr whatever its
# gradient's size, so rounding in near-zero gradients flips whole steps
# and the two part after round 5.)  A gate that zeroed every weight moves
# the loss by 3.3e-2 by round 3.
CPU_CUDA_RTOL = 1e-3
# The same over the int8 cache + int8 wire, both sides on the same
# uniforms: stochastic rounding turns an ulp of difference in Z into a
# whole code step now and then, so the runs part sooner.  This comparison
# read 7.8e-4 at round 4 on an H100 (PERF.md), so the limit is about 4x
# that; zeroing K4's weights moves the loss by 3.2e-2 at round 3 (CPU).
QUANT_CPU_CUDA_RTOL = 3e-3
# The same over the int8 AdaGrad state (K8 on the card, its plain version
# on the CPU), both sides on the same uniforms: a code flips where
# r'/s' + u sits at an integer.  This comparison read 1.7e-4 at round 5
# on an H100 (PERF.md), so the limit is about 6x that; a mutation run with
# zeroed updates, made in every run, reads 1.3e-2 (round 4).
OPT_CPU_CUDA_RTOL = 1e-3
SHAPES = [(5, 256, 256), (2, 37, 8), (2, 37, 13), (2, 64, 64 * 960)]
MAIN_SHAPE = (5, 256, 256)
WIRE_SHAPE = (512, 128)           # B · z_dim = 65,536 values in 128-tiles
R = 5
GATE = "src/repro_torch/csrc/cosine_gate.cu"
ADAGRAD = "src/repro_torch/csrc/fused_adagrad.cu"
# K7 at WDL-Criteo's largest leaf (26 fields x 1024 x 16, the main shape),
# one element, a ragged tail and one past a whole (8, 1024) tile; K8 at
# the tilings of that leaf (main), the scalar bias, a bias and a
# mid-sized weight
K7_SIZES = [26 * 1024 * 16, 1, 1025, 8 * 1024 + 3]
K8_CASES = [((416, 1024), (26 * 1024, 16)), ((8, 1), ()), ((8, 64), (512,)),
            ((104, 1024), (104, 1024))]
# the table kernels' ragged list: more leaves than two tables hold, with
# 1-element leaves, sizes about a chunk, and every third leaf's operands
# views one element into their storage (not 16-byte aligned)
RAGGED_LEAVES = 100
RAGGED_SIZES = [1, 2, 3, 5, 1023, 1024, 1025, 4097, 65_537]
ADAGRAD_LR, ADAGRAD_EPS = 0.01, 1e-10
# a timed step also runs cold: over enough copies of its operands, in
# turn, that each launch finds its operands out of the 50 MB L2 cache
L2_BYTES = 50 * 2 ** 20
KERNELS = {   # name -> (the TPU kernel it replaces, its source)
    "fused_sample_2d": ("src/repro/kernels/fused_sample.py:125", GATE),
    "cosine_weight_2d": ("src/repro/kernels/cosine_weight.py:80", GATE),
    "cosine_weights_2d": ("src/repro/kernels/cosine_weight.py:56", GATE),
    "quantize_sr_2d": ("src/repro/kernels/quantize.py:51",
                       "src/repro_torch/csrc/quantize.cu"),
    "fused_sample_q8_2d": ("src/repro/kernels/fused_sample.py:143", GATE),
    "fused_sample_q4_2d": ("src/repro/kernels/fused_sample.py:232", GATE),
    "fused_adagrad": ("src/repro/kernels/fused_adagrad.py:54", ADAGRAD),
    "fused_adagrad_q8": ("src/repro/kernels/fused_adagrad.py:110", ADAGRAD),
    "fused_dequant_q8_2d": ("src/repro/kernels/fused_sample.py:197", GATE),
    "fused_dequant_q4_2d": ("src/repro/kernels/fused_sample.py:214", GATE),
    "flash_attention": ("src/repro/kernels/flash_attention.py:87",
                        "src/repro_torch/csrc/flash_attention.cu"),
    "flash_attention_fwd_lse": ("src/repro/kernels/flash_attention_bwd.py:195",
                                "src/repro_torch/csrc/flash_attention.cu"),
    "flash_attention_bwd_dkv": ("src/repro/kernels/flash_attention_bwd.py:226",
                                "src/repro_torch/csrc/flash_attention_bwd.cu"),
    "flash_attention_bwd_dq": ("src/repro/kernels/flash_attention_bwd.py:244",
                               "src/repro_torch/csrc/flash_attention_bwd.cu"),
}
# the serving path: smollm-360m at full width; the decode activation ring
# is (ring slots W, lanes C, d)
SERVE_ARGS = {"--requests": 32, "--capacity": 8, "--prompt-len": 16,
              "--gen": 16, "--rate": 0}
SERVE_RING = (4, 8, 960)
WIDE_RING = (4, 64, 64 * 960)
# K9: the long-prompt shape (B, S, H, hd) of smollm-360m, with a window,
# at head dim 128 and at the reduced model's shape.  The plain version
# takes both products in fp32; the bf16 kernel takes q kᵀ exactly and p
# into p v as bf16 hi + lo (about 16 bits of p), and both round the
# output to bf16 once, so an element may land one bf16 ulp apart, and one
# ulp is at most 2^-7 of the element.  (p rounded once to bf16 would put
# elements 34-70 times past this limit: tests/test_torch_kernels.py::
# test_k9_rounding_design.)  Each element is held to its own magnitude:
# |out - ref| <= 2^-7 |ref| + K9_ATOL, where K9_ATOL covers the fp32
# difference between the online and the dense sums at outputs near zero
# (some twenty fp32 ulps of the largest input, about 5).  The bulk of a
# 4,096-key row's outputs are about 0.03, so a key tile dropped from late
# rows (an error of about 1e-3) cannot pass; ``chip_mutants.py`` builds
# such faults, and p rounded once on late rows, and checks that this
# phase fails on each.  On an H100 80GB HBM3 the worst err / limit of the
# tensor-core kernel reads 0.967-0.982: one-ulp differences at the bottom
# of a binade, where an ulp is 2^-7 of the value.
K9_CASES = [((1, 4096, 15, 64), True, 0), ((1, 4096, 15, 64), True, 1024),
            ((1, 4096, 15, 128), True, 0), ((2, 3072, 4, 32), True, 0)]
# K9 and K9-LSE at S = 320, five 64-row tiles (S % 64 == 0 is all the
# kernels ask), causal, with a window of 100, and without the causal mask,
# at each head dim: out and lse held to the same limits
K9_ODD_TILES = [((1, 320, 2, hd), causal, window) for hd in (32, 64, 128)
                for causal, window in ((True, 0), (True, 100), (False, 100))]
K9_REL_TOL = 2.0 ** -7
K9_ATOL = 1e-5
LONG_ARGS = {"--requests": 4, "--capacity": 2, "--prompt-len": 4096,
             "--gen": 8, "--rate": 0}
# The long prompt's prefill logits through K9 against the same prefill
# through the plain attention on the card: both round each layer's
# attention output to bf16, so a one-ulp difference in an element can
# carry through the 32 layers.  On an H100 80GB HBM3 this reads 0.0234
# with logits up to 2.6, so the limit is about 4x that.
LONG_LOGIT_ATOL = 0.1
# The fp32 engine against the sequential loop on the card: the lanes'
# batched bf16 products may round differently from the loop's one-row
# products, which moves an activation by a bf16 ulp now and then and can
# carry through the 32 layers, as in the long prefill above; each lane's
# logits are held to LANE_LOGIT_ATOL of the loop's, and a token may flip
# where the loop's top-1 margin is below BATCH_MARGIN.
LANE_LOGIT_ATOL = 0.1
BATCH_MARGIN = 0.1
# K9-LSE and K10 at smollm-360m's attention shape (B, S, H, hd) with
# B = 1 (the timed row), with a window, at head dim 128, and at the
# training phase's own B = 2 in bf16 and in fp32 (the label party's ad-hoc
# ∇Z pass), so that batch rows past the first are held too.  Kernel and
# plain version take the same inputs (the plain forward's o and lse for
# K10), sum in fp32 in other orders and round once to the output dtype.
# Each element is held to its own magnitude: |out - ref| <= REL |ref| +
# ATOL, with REL one bf16 ulp (2^-7) for bf16 outputs, and for fp32
# outputs and the fp32 lse a few fp32 ulps of summation-order difference
# (2^-17); ATOL covers the fp32 differences at outputs near zero.
K10_CASES = [((1, 4096, 15, 64), "bfloat16", 0),
             ((1, 4096, 15, 64), "bfloat16", 1024),
             ((1, 4096, 15, 128), "bfloat16", 0),
             ((1, 4096, 15, 64), "float32", 0),
             ((2, 4096, 15, 64), "bfloat16", 0),
             ((2, 4096, 15, 64), "float32", 0),
             ((2, 3072, 4, 32), "bfloat16", 0),
             ((1, 4096, 15, 128), "float32", 0),
             ((2, 3072, 4, 32), "float32", 0)]
# The (2, 3072, 4, 32) cases are the reduced model's attention (head dim
# 32) past 2,048 tokens, whose ad-hoc ∇Z pass takes fp32.  K10's bf16
# kernels take p and ds into their tensor-core products as bf16 hi + lo,
# its fp32 kernels take every operand of every product as three bf16
# parts, six products for each (csrc/flash_attention_bwd.cu); either keeps
# every element within these limits (tests/test_torch_kernels.py::
# test_k10_rounding_design and test_k10_f32_split_design model them on
# the CPU).
K10_REL = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -17}
K10_ATOL = {"bfloat16": 1e-5, "float32": 2e-6}
# K10 at S = 320, five 64-row tiles (S % 64 == 0 is all the kernels ask,
# and the fp32 kernels walk 32- or 16-row tiles), in both dtypes at each
# head dim, causal, with a window of 100, and without the causal mask.
# The fp32 cases are held against the fp64 plain version only (on five
# draws, the fp32 plain version's distance printed beside): on the
# smoke's draw at hd 128 with the window the fp32 plain version is itself
# past the limit against fp64 (PERF.md §7 q6).
K10_ODD_TILES = [((1, 320, 2, hd), dt, causal, window)
                 for dt in ("float32", "bfloat16") for hd in (32, 64, 128)
                 for causal, window in ((True, 0), (True, 100),
                                        (False, 100))]
# Every fp32 case is also run on four more draws, and on each of the five
# (the smoke's own draw first) K10 is held to the same limits against the
# fp64 plain version on the same inputs (the fp32 plain version's own
# distance from it is printed beside)
K10_F32_SEEDS = (11, 12, 13, 14)
LSE_REL, LSE_ATOL = 2.0 ** -17, 1e-5
# K9-LSE's fp32 outputs and their limits (rel, atol): out as K10's fp32
# outputs, lse as every lse
K9_F32_LIMITS = (("out", K10_REL["float32"], K10_ATOL["float32"]),
                 ("lse", LSE_REL, LSE_ATOL))
# K1 at the training path's cut tensor (W, B, S·d): the fp32 sums of
# 3,932,160 products a row in other orders; the weights are cosines in
# [-1, 1] and the cotangent is |dz| <= ~5 times a weight.  Also at a wide
# ragged row (F odd: one element a lane), both on the split-row path.
LLM_GATE_SHAPE = (2, 2, 4096 * 960)
RAGGED_GATE_SHAPE = (2, 3, 1_000_003)
GATE_SINK = 960                   # the first token's d values of a row
LLM_GATE_TOL = 1e-4
# the training phase: smollm-360m at full width
TRAIN_ARGS = {"batch_size": 2, "seq_len": 4096, "R": 2, "W": 2}
TRAIN_ROUNDS = 3
# the pipeline phase's DP run: noise at sigma · clip on clipped rows
DP_SIGMA = 0.5
DP_CLIP = 1.0
# The full-width train step through K9-LSE / K10 against the same step
# through the plain attention on the card (B = 1, S = 4,096): both round
# each layer's attention output and its gradients to bf16, so one-ulp
# differences carry through the 32 layers.  The loss and each gradient
# leaf's relative L2 error are held to these limits.
GRAD_LOSS_ATOL = 1e-2
GRAD_REL_L2 = 5e-2
# The reduced model (head dim 32; ``--reduced`` in training, the serving
# CLI's default) past the 2,048-token threshold, so through K9, K9-LSE and
# K10 at hd 32: two celu rounds of ``train_llm`` and a train step, each
# held to the same run through the plain attention (losses to
# GRAD_LOSS_ATOL, the step's gradient leaves to GRAD_REL_L2), and
# 3,072-token prompts served, the prefill's logits held to
# LONG_LOGIT_ATOL of the plain attention's.
REDUCED_SEQ = 3072
REDUCED_TRAIN_ARGS = {"batch_size": 2, "seq_len": REDUCED_SEQ, "R": 2,
                      "W": 2, "reduced": True}
REDUCED_ROUNDS = 2
REDUCED_SERVE_ARGS = {"--requests": 4, "--capacity": 2,
                      "--prompt-len": REDUCED_SEQ, "--gen": 8, "--rate": 0}
# K10's bf16 kernels (csrc/flash_attention_bwd.cu): name of the wrapper ->
# (the kernel's name in the library, the products it issues)
K10_MMA = {"flash_attention_bwd_dkv": ("flash_bwd_dkv_mma", 6),
           "flash_attention_bwd_dq": ("flash_bwd_dq_mma", 4)}
# K10's fp32 kernels: the same, in bf16 products (six per fp32 product)
K10_F32_MMA = {"flash_attention_bwd_dkv": ("flash_bwd_dkv_f32mma", 24),
               "flash_attention_bwd_dq": ("flash_bwd_dq_f32mma", 18)}
# K9's (and K9-LSE's) bf16 kernel (csrc/flash_attention.cu): its name in
# the library and the products it issues (s = q kᵀ, p_hi v, p_lo v),
# against the two (s, p v) of its work
K9_MMA = ("flash_fwd_mma", 3)
# its fp32 kernel: the same, in bf16 products (six per fp32 product)
K9_F32_MMA = ("flash_fwd_f32mma", 12)
DENSE_GATES = ("fused_sample_2d", "cosine_weight_2d", "cosine_weights_2d")
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _events_ms(torch, run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(torch, fn, iters: int = 200) -> float:
    """ms per call issued from Python back to back (CUDA events): what the
    round pays, host launch cost included."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    return _events_ms(torch, fn, iters)


def device_ms(torch, fn, iters: int = 50) -> float:
    """ms per call on the card alone: ``iters`` calls captured in a CUDA
    graph and replayed (CUDA events), so no host launch cost is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(torch, graph.replay, 5) / iters


def kernel_label(mangled: str) -> str:
    """A kernel's mangled name -> its name and integer template
    arguments, e.g. ``flash_bwd_dkv_mma<64>`` or ``flash_fwd_kernel<bf16,64>``
    (the mangled name when it is not a name in a namespace)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    i = m.end() + int(m.group(1))
    m = re.match(r"(\d+)", mangled[i:])
    if not m:
        return mangled
    j = i + m.end()
    name, rest = mangled[j:j + int(m.group(1))], mangled[j + int(m.group(1)):]
    if not rest.startswith("I"):
        return name
    head = rest[:rest.find("EE") + 2]
    args = re.findall(r"Li(\d+)E", head)
    kind = head.split("Li")[0]
    if kind.startswith("If"):
        args.insert(0, "float")
    elif "bfloat16" in kind:
        args.insert(0, "bf16")
    return f"{name}<{','.join(args)}>"


def ptxas_usage(log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel label: (registers, spill
    store bytes, spill load bytes)}."""
    usage, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur, spill = kernel_label(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            usage[cur] = (int(m.group(1)),) + spill
            cur = None
    return usage


def sass_mma_counts(path: str) -> dict:
    """{kernel label: tensor-core instructions (HMMA, HGMMA)} in the
    SASS of the library at ``path`` (``cuobjdump -sass``)."""
    from repro_torch.kernels import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        counts[kernel_label(name.strip())] = len(
            re.findall(r"\bH(?:G)?MMA\b", body))
    return counts


def bound(nbytes: float, flops: float, peak: float = PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------
def phase_kernels(torch):
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.kernels import cosine_weight as cw
    from repro_torch.kernels import fused_sample as fs

    cos_xi = xi_to_cos(60.0)
    thresh = cw.f32_threshold(cos_xi)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {k: {"max_abs_err": 0.0} for k in DENSE_GATES}
    for (W, B, F) in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            a = randn(B, F)
            z = randn(W, B, F)
            z[1] = a * (torch.rand((B, 1), generator=gen, device="cuda")
                        * 4 - 1) + z[1]
            z = z.to(dtype)
            dz = randn(W, B, F).to(dtype)
            slot = torch.tensor([1], dtype=torch.int32, device="cuda")
            z1, dz1 = z[1].contiguous(), dz[1].contiguous()
            cos = cw.gate_weights_plain(a, z1, -2.0)
            cos_dz = cw.gate_weights_plain(a, dz1, -2.0)
            keep = (cos - thresh).abs() > NEAR
            keep_dz = (cos_dz - thresh).abs() > NEAR
            s = F * z.element_size()
            base = 4 * B * F + 4 * B             # ad_hoc read, w written
            cases = {
                "fused_sample_2d": (
                    lambda: fs.fused_sample_2d(slot, a, z, dz, cos_xi),
                    lambda: fs.fused_sample_plain(slot, a, z, dz, cos_xi),
                    keep, base + 2 * B * s + 4 * B * F + 4, 7 * B * F),
                "fused_sample_2d weights-only": (
                    lambda: fs.fused_sample_2d(slot, a, dz, None, cos_xi),
                    lambda: fs.fused_sample_plain(slot, a, dz, None, cos_xi),
                    keep_dz, base + B * s + 4, 6 * B * F),
                "cosine_weight_2d": (
                    lambda: cw.cosine_weight_2d(a, z1, dz1, cos_xi),
                    lambda: cw.cosine_weight_plain(a, z1, dz1, cos_xi),
                    keep, base + 2 * B * s + 4 * B * F, 7 * B * F),
                "cosine_weights_2d": (
                    lambda: (cw.cosine_weights_2d(a, z1, cos_xi), None),
                    lambda: (cw.cosine_weights_plain(a, z1, cos_xi), None),
                    keep, base + B * s, 6 * B * F),
            }
            for name, (kern, plain, rows, nbytes, flops) in cases.items():
                (w, cot), (w0, cot0) = kern(), plain()
                torch.cuda.synchronize()
                err = (w - w0).abs()[rows].max().item()
                if cot is not None:
                    err = max(err, (cot - cot0).abs()[rows].max().item())
                check(math.isfinite(err) and err <= KERNEL_TOL,
                      f"{name} at {(W, B, F)} {dtype}: max |err| {err}")
                key = name.split()[0]
                results[key]["max_abs_err"] = max(
                    results[key]["max_abs_err"], err)
                ms = device_ms(torch, kern)
                plain_ms = device_ms(torch, plain)
                call = call_ms(torch, kern)
                bound_ms, bound_by = bound(nbytes, flops)
                print(f"[kernel] {name:30s} W,B,F={W},{B},{F} "
                      f"{str(dtype)[6:]:8s} max|err| {err:.3g}  device: "
                      f"kernel {ms * 1e3:.2f} us  plain {plain_ms * 1e3:.2f}"
                      f" us  bound {bound_ms * 1e3:.3f} us ({bound_by}); "
                      f"per call from Python {call * 1e3:.2f} us",
                      flush=True)
                if (W, B, F) == MAIN_SHAPE and dtype == torch.float32 \
                        and name in DENSE_GATES:
                    results[name].update(ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms,
                                         bound_by=bound_by)
    return results


def _timed(torch, label, kern, plain, err, nbytes, flops, library="none",
           peak=PEAK_FP32_FLOPS, iters=50):
    """Time ``kern`` and ``plain`` on the card at this shape; print one
    line (``library`` names the PyTorch call timed beside it); -> the
    numbers of the kernels' JSON line."""
    ms = device_ms(torch, kern, iters)
    plain_ms = device_ms(torch, plain, iters)
    call = call_ms(torch, kern, 4 * iters)
    bound_ms, bound_by = bound(nbytes, flops, peak)
    print(f"[kernel] {label} max|err| {err:.3g}  device: kernel "
          f"{ms * 1e3:.2f} us  plain {plain_ms * 1e3:.2f} us  bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}, {nbytes} B); per call "
          f"from Python {call * 1e3:.2f} us; library: {library}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_quant_kernels(torch):
    """K3 against its plain version (codes equal, scales bitwise, on the
    card and against the CPU) and K4 / K5 against theirs (within
    KERNEL_TOL, rows near cos ξ excluded)."""
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.core.workset import pack_nibbles, sample_hbm_bytes
    from repro_torch.kernels import cosine_weight as cw
    from repro_torch.kernels import fused_sample as fs
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {k: {"max_abs_err": 0.0} for k in
               ("quantize_sr_2d", "fused_sample_q8_2d", "fused_sample_q4_2d")}

    # K3 at the insert shape (B, F), the wire shape, ragged and wide rows
    for (T, L) in [MAIN_SHAPE[1:], WIRE_SHAPE, (37, 13), (37, 8),
                   SHAPES[-1][1:]]:
        x = torch.randn((T, L), generator=gen, device="cuda") \
            * torch.rand((T, 1), generator=gen, device="cuda") * 10
        x[0] = 0.0                      # an all-zero tile: the scale floor
        u = torch.rand((T, L), generator=gen, device="cuda")
        for levels in (127, 7):
            q, sc = qz.quantize_sr_2d(x, u, levels)
            q0, sc0 = qz.quantize_sr_plain(x, u, levels)
            qc, scc = qz.quantize_sr_plain(x.cpu(), u.cpu(), levels)
            torch.cuda.synchronize()
            bad = int((q != q0).sum()) + int((q.cpu() != qc).sum())
            check(bad == 0 and torch.equal(sc, sc0)
                  and torch.equal(sc.cpu(), scc),
                  f"quantize_sr_2d at {(T, L)} levels {levels}: {bad} codes "
                  f"differ, scales bitwise {torch.equal(sc, sc0)} "
                  f"{torch.equal(sc.cpu(), scc)}")
            label = f"{'quantize_sr_2d':30s} T,L={T},{L} levels {levels:3d}"
            if (T, L) in (MAIN_SHAPE[1:], WIRE_SHAPE) and levels == 127:
                t = _timed(torch, label,
                           lambda: qz.quantize_sr_2d(x, u, levels),
                           lambda: qz.quantize_sr_plain(x, u, levels), 0.0,
                           9 * T * L + 4 * T, 5 * T * L)
                if (T, L) == MAIN_SHAPE[1:]:
                    results["quantize_sr_2d"].update(t)
            else:
                print(f"[kernel] {label} codes equal, scales bitwise equal "
                      f"(card and CPU)", flush=True)

    # K4 / K5 over rings quantised as an insert quantises them
    cos_xi = xi_to_cos(60.0)
    thresh = cw.f32_threshold(cos_xi)
    slot = torch.tensor([1], dtype=torch.int32, device="cuda")
    for bits, name in ((8, "fused_sample_q8_2d"), (4, "fused_sample_q4_2d")):
        full = ops.fused_gather_weight_q8 if bits == 8 \
            else ops.fused_gather_weight_q4
        w_only = ops.fused_gather_weights_q8 if bits == 8 \
            else ops.fused_gather_weights_q4
        for (W, B, F) in SHAPES:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            a = randn(B, F)
            z = randn(W, B, F)
            z[1] = a * (torch.rand((B, 1), generator=gen, device="cuda")
                        * 4 - 1) + z[1]
            dz = randn(W, B, F)

            def enc(r):
                x = r.reshape(W * B, F)
                q, sc = qz.quantize_sr_plain(
                    x, torch.rand(x.shape, generator=gen, device="cuda"),
                    127 if bits == 8 else 7)
                if bits == 4:
                    if F & 1:
                        q = torch.cat([q, q.new_zeros((W * B, 1))], dim=1)
                    q = pack_nibbles(q)
                return (q.reshape(W, B, -1).contiguous(),
                        sc.reshape(W, B).contiguous())
            zq, zs = enc(z)
            dzq, dzs = enc(dz)
            a_pad = torch.nn.functional.pad(
                a, (0, (2 * zq.shape[2] - F) if bits == 4 else 0))

            def plain(q, sc, dq, ds):
                w, cot = fs.fused_sample_quant_plain(
                    bits, slot, a_pad, q, sc, dq, ds, cos_xi)
                return w, None if cot is None else cot[:, :F]

            def keep(q, sc):
                deq = fs.dequant_rows(q[1], sc[1], bits)
                return (cw.gate_weights_plain(a_pad, deq, -2.0)
                        - thresh).abs() > NEAR
            cases = [
                ("", lambda: full(slot, a, zq, zs, dzq, dzs, cos_xi),
                 lambda: plain(zq, zs, dzq, dzs), keep(zq, zs), "a"),
                (" weights-only",      # Party B's: the ∇Z ring alone
                 lambda: (w_only(slot, a, dzq, dzs, cos_xi), None),
                 lambda: plain(dzq, dzs, None, None), keep(dzq, dzs), "b"),
            ]
            for tag, kern, plain_fn, rows, party in cases:
                (w, cot), (w0, cot0) = kern(), plain_fn()
                torch.cuda.synchronize()
                err = (w - w0).abs()[rows].max().item()
                if cot is not None:
                    err = max(err, (cot - cot0).abs()[rows].max().item())
                check(math.isfinite(err) and err <= KERNEL_TOL,
                      f"{name}{tag} at {(W, B, F)}: max |err| {err}")
                results[name]["max_abs_err"] = max(
                    results[name]["max_abs_err"], err)
                label = f"{name + tag:30s} W,B,F={W},{B},{F}"
                if (W, B, F) != MAIN_SHAPE:
                    print(f"[kernel] {label} max|err| {err:.3g}", flush=True)
                    continue
                dtype = "int8" if bits == 8 else "int4"
                ex = {"z": a, "dz": a}
                if party == "a":
                    nbytes = sample_hbm_bytes(ex, dtype, True, "a") + 4
                else:      # the stored dz, the ad-hoc rows, w, the slot
                    nbytes = sample_hbm_bytes({"dz": a}, dtype) \
                        + 4 * B * F + 4 * B + 4
                t = _timed(torch, label, kern, plain_fn, err, nbytes,
                           (8 if party == "a" else 7) * B * F)
                if party == "a":
                    results[name].update(t)
    return results


def library_adagrad_ms(torch, sets, lr, eps):
    """ms of ``torch._fused_adagrad_`` (one fused PyTorch AdaGrad call over
    a list; it applies the step to the parameters) on the card, over each
    (grads, accumulators, params) of ``sets`` in turn, or (None, why)
    where this PyTorch has none for CUDA."""
    fn = getattr(torch, "_fused_adagrad_", None)
    if fn is None:
        return None, "torch._fused_adagrad_ does not exist"
    lists = [([p.float() for p in ps], [g.float() for g in gs],
              [a.float().clone() for a in accs],
              [torch.zeros((), device=g.device) for g in gs])
             for gs, accs, ps in sets]
    turn = [0]

    def run():
        params, grads, acc, steps = lists[turn[0] % len(lists)]
        turn[0] += 1
        fn(params, grads, acc, steps, lr=lr, lr_decay=0.0, weight_decay=0.0,
           eps=eps, maximize=False)
    try:
        run()
        torch.cuda.synchronize()
    except RuntimeError as e:       # no CUDA kernel registered for it
        return None, f"torch._fused_adagrad_ on CUDA: {str(e)[:120]}"
    return device_ms(torch, run), "torch._fused_adagrad_"


def _same(name: str, label: str, got, want) -> None:
    """Every tensor of ``got`` bitwise its counterpart in ``want`` (the
    failure names the elements that differ and the largest difference)."""
    import torch
    for x, y in zip(got, want, strict=True):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"{name} at {label}: {tuple(x.shape)} {x.dtype} against the "
              f"plain version's {tuple(y.shape)} {y.dtype}")
        if not torch.equal(x, y):
            d = (x.float() - y.float()).abs().nan_to_num(float("inf"))
            fail(f"{name} at {label}: not bitwise equal to its plain version "
                 f"({int((x != y).sum())} elements differ, max |diff| "
                 f"{d.max().item():.4g})")


def _view(x, off: int):
    """A copy of ``x`` that starts ``off`` elements into its storage (so
    not 16-byte aligned when ``off`` is 1)."""
    import torch
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    out = buf[off:].view(x.shape)
    out.copy_(x)
    return out


def _copy(x):
    """A copy of ``x`` as aligned as ``x`` (the kernel's operand)."""
    return _view(x, 0 if x.data_ptr() % 16 == 0 else 1)


def _adagrad_lists(torch) -> dict:
    """{name: parameter shapes}: WDL-Criteo's Party A and B and
    smollm-360m's, each in the reference's leaf order, and the ragged
    list."""
    import numpy as np

    from repro_torch.bridge import reference_parameters
    from repro_torch.configs import get_config
    from repro_torch.launch.train import llm_params
    from repro_torch.models.tabular import make_dlrm

    cfg = get_config("wdl-criteo")
    wdl = make_dlrm(cfg)[0](0, cfg, "cuda")
    llm = llm_params(get_config("smollm-360m"), 0, "cuda")
    lists = {f"{name} {p}": [tuple(t.shape) for t in reference_parameters(
        m[p])] for name, m in (("wdl-criteo", wdl), ("smollm-360m", llm))
        for p in ("a", "b")}
    del wdl, llm
    rng = np.random.default_rng(20)
    sizes = RAGGED_SIZES + [int(x) for x in rng.integers(
        1, 70_000, RAGGED_LEAVES - len(RAGGED_SIZES))]
    lists["ragged"] = [(n,) for n in sizes]
    torch.cuda.empty_cache()
    return lists


def _k7_operands(torch, gen, shapes, grad_dtype, state_dtype, param_dtype,
                 ragged=False):
    """Random (grads, accumulators, params) on the card; with ``ragged``
    every third leaf's operands are views one element in."""
    def make(shape, dtype, i, fill):
        x = torch.empty(shape, device="cuda")
        fill(x)
        return _view(x.to(dtype), int(ragged and i % 3 == 1))
    grads = [make(s, grad_dtype, i, lambda x: x.normal_(
        generator=gen).mul_(0.1)) for i, s in enumerate(shapes)]
    accums = [make(s, state_dtype, i, lambda x: x.uniform_(
        generator=gen)) for i, s in enumerate(shapes)]
    params = [make(s, param_dtype, i, lambda x: x.normal_(
        generator=gen)) for i, s in enumerate(shapes)]
    return grads, accums, params


def _k8_operands(torch, gen, shapes, grad_dtype, param_dtype):
    """Random (grads, codes, scales, noises, params) on the card, in each
    leaf's int8 tiling."""
    from repro_torch.optim.quantized import _tiling
    grads, qs, ss, us, ps = [], [], [], [], []
    for shape in shapes:
        R, C = _tiling(math.prod(shape))
        grads.append((torch.randn(shape, generator=gen, device="cuda")
                      * 0.1).to(grad_dtype))
        qs.append(torch.randint(0, 128, (R, C), generator=gen,
                                device="cuda", dtype=torch.int8))
        ss.append(torch.rand((R, 1), generator=gen, device="cuda") * 1e-2)
        us.append(torch.rand((R, C), generator=gen, device="cuda"))
        ps.append(torch.randn(shape, generator=gen, device="cuda")
                  .to(param_dtype))
    return grads, qs, ss, us, ps


def _k7_check(torch, label, ops, scale) -> None:
    """The K7 step and the K7 updates over a list, each bitwise its plain
    version; one launch per table of leaves."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import fused_adagrad as fag
    g, a, p = ops
    lr, eps = ADAGRAD_LR, ADAGRAD_EPS
    ak, pk = [_copy(x) for x in a], [_copy(x) for x in p]
    ap, pp = [x.clone() for x in a], [x.clone() for x in p]
    n0 = _cuda.LAUNCHES["fused_adagrad"]
    fag.fused_adagrad_step_(g, ak, pk, lr, eps, scale)
    launches = _cuda.LAUNCHES["fused_adagrad"] - n0
    fag.fused_adagrad_step_plain(g, ap, pp, lr, eps, scale)
    torch.cuda.synchronize()
    _same("fused_adagrad", f"{label} step", ak + pk, ap + pp)
    uk, ank = fag.fused_adagrad_list(g, a, lr, eps)
    up, anp = fag.fused_adagrad_list_plain(g, a, lr, eps)
    torch.cuda.synchronize()
    _same("fused_adagrad", f"{label} updates", uk + ank, up + anp)
    want = _adagrad_launches([len(g)])
    check(launches == want, f"fused_adagrad at {label}: {launches} "
          f"launches for {len(g)} leaves, want {want}")
    print(f"[adagrad] {'fused_adagrad':17s} {label}: step and updates "
          f"bitwise equal to the plain version ({len(g)} leaves, "
          f"{sum(x.numel() for x in g):,} elements, {launches} launch(es))",
          flush=True)


def _k8_check(torch, label, ops, scale) -> None:
    """The K8 step and the K8 updates over a list, each bitwise its plain
    version."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import fused_adagrad as fag
    g, q, s, u, p = ops
    lr, eps = ADAGRAD_LR, ADAGRAD_EPS
    qk, sk, pk = ([x.clone() for x in xs] for xs in (q, s, p))
    qp, sp, pp = ([x.clone() for x in xs] for xs in (q, s, p))
    n0 = _cuda.LAUNCHES["fused_adagrad_q8"]
    fag.fused_adagrad_q8_step_(g, qk, sk, u, pk, lr, eps, scale)
    launches = _cuda.LAUNCHES["fused_adagrad_q8"] - n0
    fag.fused_adagrad_q8_step_plain(g, qp, sp, u, pp, lr, eps, scale)
    torch.cuda.synchronize()
    _same("fused_adagrad_q8", f"{label} step", qk + sk + pk, qp + sp + pp)
    outs = fag.fused_adagrad_q8_list(g, q, s, u, lr, eps)
    refs = fag.fused_adagrad_q8_list_plain(g, q, s, u, lr, eps)
    torch.cuda.synchronize()
    _same("fused_adagrad_q8", f"{label} updates", sum(outs, []),
          sum(refs, []))
    want = _adagrad_launches([len(g)])
    check(launches == want, f"fused_adagrad_q8 at {label}: {launches} "
          f"launches for {len(g)} leaves, want {want}")
    print(f"[adagrad] {'fused_adagrad_q8':17s} {label}: step and updates "
          f"bitwise equal to the plain version ({len(g)} leaves, "
          f"{sum(x.numel() for x in q):,} codes, {launches} launch(es))",
          flush=True)


def _step_bytes(g, a, p) -> int:
    """Bytes the K7 step must move: g and a read, a' written, p read and
    written, and the 4-byte scale."""
    return 4 + sum(x.numel() * (x.element_size() + 2 * y.element_size()
                                + 2 * z.element_size())
                   for x, y, z in zip(g, a, p))


def _q8_step_bytes(g, q, p) -> int:
    """The K8 step: g, q, the noise and p read, q' and p' written, a
    scale read and written a row, and the 4-byte mask."""
    return 4 + sum(x.numel() * (x.element_size() + 2 * z.element_size())
                   + 6 * c.numel() + 8 * c.shape[0]
                   for x, c, z in zip(g, q, p))


def _step_kernel(state) -> str:
    import torch
    return "fused_adagrad_q8" if state == torch.int8 else "fused_adagrad"


def _step_timings(torch, gen, shapes, name, state, mask) -> dict:
    """The in-place step over one party's list, fp32 params and grads,
    ``state`` fp32 / bf16 (K7) or int8 (K8), timed warm (the same
    operands each launch, so from the L2 cache, as in the WDL round,
    whose whole state fits there) and cold (copies of the operands in
    turn, twice the 50 MB L2); fp32 K7 beside ``torch._fused_adagrad_``
    over the same lists.  -> {"warm" | "cold": the JSON numbers}."""
    from repro_torch.kernels import fused_adagrad as fag
    lr, eps = ADAGRAD_LR, ADAGRAD_EPS
    kernel = _step_kernel(state)
    if kernel == "fused_adagrad":
        def make():
            return _k7_operands(torch, gen, shapes, torch.float32, state,
                                torch.float32)
        step, plain = fag.fused_adagrad_step_, fag.fused_adagrad_step_plain
        nbytes = _step_bytes(*make())
        flops = 8 * sum(math.prod(x) for x in shapes)
    else:
        def make():
            return _k8_operands(torch, gen, shapes, torch.float32,
                                torch.float32)
        step, plain = fag.fused_adagrad_q8_step_, \
            fag.fused_adagrad_q8_step_plain
        g, q, _, _, p = make()
        nbytes = _q8_step_bytes(g, q, p)
        flops = 12 * sum(x.numel() for x in q)
    sets = [make() for _ in range(1 + 2 * L2_BYTES // nbytes)]
    out = {}
    for temp, use in (("warm", sets[:1]), ("cold", sets)):
        turn = [0]

        def operands(use=use, turn=turn):
            turn[0] += 1
            return use[turn[0] % len(use)]
        lib_ms, lib_what = None, "none"
        if state == torch.float32:
            lib_ms, lib_what = library_adagrad_ms(torch, use, lr, eps)
        out[temp] = _timed(
            torch, f"{kernel:30s} {name} step, {str(state)[6:]} state "
            f"{temp} ({len(use)} operand set(s))",
            lambda: step(*operands(), lr, eps, mask),
            lambda: plain(*operands(), lr, eps, mask), 0.0, nbytes, flops,
            library=lib_what + ("" if lib_ms is None
                                else f" {lib_ms * 1e3:.3f} us"))
        out[temp]["library_ms"] = lib_ms
    return out


def _adagrad_graph_and_allocations(torch, lists, gen) -> None:
    """One party's in-place step captured in a CUDA graph and replayed
    three times (the mask 1, 0, 0.7, written before each replay) equals
    three eager steps bitwise; an eager step (AdaGrad's ``step`` as the
    engine calls it, and the K8 step) allocates nothing."""
    from repro_torch.kernels import fused_adagrad as fag
    from repro_torch.optim import adagrad
    lr, eps = ADAGRAD_LR, ADAGRAD_EPS
    shapes = lists["wdl-criteo a"]
    g, a, p = _k7_operands(torch, gen, shapes, torch.float32, torch.float32,
                           torch.float32)
    ag, pg = [x.clone() for x in a], [x.clone() for x in p]
    scale = torch.ones((), device="cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fag.fused_adagrad_step_(g, ag, pg, lr, eps, scale)
    for v in (1.0, 0.0, 0.7):
        scale.fill_(v)
        graph.replay()
        fag.fused_adagrad_step_(g, a, p, lr, eps, scale)
    torch.cuda.synchronize()
    _same("fused_adagrad", "wdl-criteo a, 3 replays of a captured step "
          "against 3 eager steps", ag + pg, a + p)
    print("[adagrad] fused_adagrad     wdl-criteo a: the step captured in a "
          "CUDA graph, replayed 3 times (mask 1, 0, 0.7), bitwise equal to "
          "3 eager steps", flush=True)

    opt = adagrad(lr, eps, use_pallas=True)
    state = opt.init(p)
    q8 = _k8_operands(torch, gen, shapes, torch.float32, torch.float32)
    for what, step in (
            ("AdaGrad's step (K7, fp32 state)",
             lambda: opt.step(g, state, p, scale)),
            ("the K8 step", lambda: fag.fused_adagrad_q8_step_(
                *q8, lr, eps, scale))):
        step()
        torch.cuda.synchronize()
        n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        step()
        torch.cuda.synchronize()
        n1 = torch.cuda.memory_stats()["allocation.all.allocated"]
        print(f"[adagrad] {what} over wdl-criteo a: {n1 - n0} device "
              f"allocations in an eager step", flush=True)
        check(n1 == n0, f"{what}: an eager step made {n1 - n0} device "
              f"allocations, want 0")


def phase_adagrad_kernels(torch):
    """K7 and K8 against their plain versions on the card, bitwise: one
    leaf at the main path's leaf shapes (the updates), and the table
    kernels over WDL-Criteo's and smollm-360m's party lists and a ragged
    list of more than two tables (the in-place step with and without the
    mask, and the updates), bf16 params, gradients and state included;
    a captured step; no allocation in a step; µs per party update beside
    the bound and one fused PyTorch AdaGrad call over the same list."""
    from repro_torch.kernels import fused_adagrad as fag
    from repro_torch.optim.quantized import _tiling

    gen = torch.Generator(device="cuda").manual_seed(2)
    lr, eps = ADAGRAD_LR, ADAGRAD_EPS
    results = {"fused_adagrad": {"max_abs_err": 0.0},
               "fused_adagrad_q8": {"max_abs_err": 0.0}}
    # one leaf, as the kernels' one-leaf case (the updates written)
    for n in K7_SIZES:
        g = torch.randn(n, generator=gen, device="cuda") * 0.1
        a = torch.rand(n, generator=gen, device="cuda")
        (u, a2), (u0, a20) = (fag.fused_adagrad(g, a, lr, eps),
                              fag.fused_adagrad_plain(g, a, lr, eps))
        uc, a2c = fag.fused_adagrad_plain(g.cpu(), a.cpu(), lr, eps)
        torch.cuda.synchronize()
        _same("fused_adagrad", f"n={n}", [u, a2], [u0, a20])
        cpu_same = torch.equal(u.cpu(), uc) and torch.equal(a2.cpu(), a2c)
        label = f"{'fused_adagrad':30s} n={n}"
        if n == K7_SIZES[0]:     # the one-leaf time, beside earlier PRs'
            _timed(torch, label + " one leaf",
                   lambda: fag.fused_adagrad(g, a, lr, eps),
                   lambda: fag.fused_adagrad_plain(g, a, lr, eps), 0.0,
                   16 * n, 6 * n)
        print(f"[kernel] {label} bitwise equal to its plain version (CPU "
              f"plain version bitwise equal: {cpu_same})", flush=True)

    for (R, C), shape in K8_CASES:
        check(_tiling(math.prod(shape)) == (R, C), f"K8 tiling of {shape}")
        g = torch.randn(shape, generator=gen, device="cuda") * 0.1
        q = torch.randint(0, 128, (R, C), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((R, 1), generator=gen, device="cuda") * 1e-2
        u = torch.rand((R, C), generator=gen, device="cuda")
        out = fag.fused_adagrad_q8(g, q, s, u, lr, eps)
        ref = fag.fused_adagrad_q8_plain(g, q, s, u, lr, eps)
        torch.cuda.synchronize()
        _same("fused_adagrad_q8", f"{(R, C)}", out, ref)
        print(f"[kernel] {'fused_adagrad_q8':30s} R,C={R},{C} update, codes "
              f"and scales bitwise equal to its plain version", flush=True)

    # the table kernels over the party lists
    lists = _adagrad_lists(torch)
    f32, bf16 = torch.float32, torch.bfloat16
    mask0 = torch.zeros((), device="cuda")
    mask = torch.full((), 0.7, device="cuda")
    for name in ("wdl-criteo a", "wdl-criteo b", "ragged"):
        shapes, ragged = lists[name], name == "ragged"
        ops = _k7_operands(torch, gen, shapes, f32, f32, f32, ragged)
        if ragged:
            from repro_torch.kernels import _cuda
            tables = fag.k7_tables(ops[0], ops[1], ops[1], ops[2])
            flags = [t.leaf[k].flags for t in tables
                     for k in range(t.n_leaves)]
            check(len(tables) == 3 and any(f & fag.ALIGNED for f in flags)
                  and not all(f & fag.ALIGNED for f in flags),
                  f"the ragged list: {len(tables)} tables of "
                  f"{_cuda.ADAGRAD_LEAVES}, aligned flags {flags}")
        for scale, what in ((None, "no mask"), (mask, "mask 0.7"),
                            (mask0, "mask 0")):
            _k7_check(torch, f"{name}, fp32, {what}", ops, scale)
        _k7_check(torch, f"{name}, bf16 grads, params and state, mask 0.7",
                  _k7_operands(torch, gen, shapes, bf16, bf16, bf16, ragged),
                  mask)
        q8 = _k8_operands(torch, gen, shapes, f32, f32)
        for scale, what in ((None, "no mask"), (mask, "mask 0.7"),
                            (mask0, "mask 0")):
            _k8_check(torch, f"{name}, fp32, {what}", q8, scale)
        _k8_check(torch, f"{name}, bf16 grads and params, mask 0.7",
                  _k8_operands(torch, gen, shapes, bf16, bf16), mask)
        del ops, q8
    for name in ("smollm-360m a", "smollm-360m b"):
        shapes = lists[name]
        ops = _k7_operands(torch, gen, shapes, bf16, f32, bf16)
        _k7_check(torch, f"{name}, bf16 grads and params, fp32 state",
                  ops, None)
        del ops
        ops = _k7_operands(torch, gen, shapes, bf16, bf16, bf16)
        _k7_check(torch, f"{name}, bf16 grads, params and state, mask 0.7",
                  ops, mask)
        del ops
        q8 = _k8_operands(torch, gen, shapes, bf16, bf16)
        _k8_check(torch, f"{name}, bf16 grads and params, mask 0.7", q8,
                  mask)
        del q8
        torch.cuda.empty_cache()
    _adagrad_graph_and_allocations(torch, lists, gen)

    # µs per party update: the in-place step of the engine's local update
    # (fp32 params, the mask given); K7 beside one torch._fused_adagrad_
    # call over the same list
    for name in ("wdl-criteo a", "wdl-criteo b"):
        for state in (f32, bf16, torch.int8):
            for temp, t in _step_timings(torch, gen, lists[name], name,
                                         state, mask).items():
                if name == "wdl-criteo a" and temp == "cold" \
                        and state != bf16:
                    results[_step_kernel(state)].update(t)
    return results


def phase_goldens(torch):
    from repro_torch import golden
    from repro_torch.kernels import _cuda
    params = golden.load_params(GOLDEN_DIR)
    two = golden.load_golden(GOLDEN_DIR, "two_party_trace.json")
    three = golden.load_golden(GOLDEN_DIR, "three_party_trace.json")["celu"]
    runs = [(p, True, None) for p in ("vanilla", "fedbcd", "celu")]
    runs.append(("celu", False, None))
    # once more through the fused AdaGrad kernel (K7): one launch a party
    # update, (1 + R) x 2 a round of 20 (R = 3); the three-party golden
    # (1 + R) x 3 (R = 2)
    runs.append(("celu", True, {"use_pallas": True}))
    for protocol, fused, opt_kw in runs:
        _cuda.reset_launches()
        got = golden.two_party_trace(protocol, params, device="cuda",
                                     cache_fused=fused, opt_kw=opt_kw)
        dev = golden.compare(got, two[protocol])
        print(f"[golden] two-party {protocol:7s} cache_fused={fused} "
              f"adagrad {'K7' if opt_kw else 'plain'}: {dev}; K7 launches "
              f"{_cuda.LAUNCHES['fused_adagrad']}", flush=True)
        check(golden.within_tolerance(dev), f"golden {protocol} {dev}")
        check(_cuda.LAUNCHES["fused_adagrad"] == (160 if opt_kw else 0),
              f"golden {protocol}: K7 launches {_cuda.LAUNCHES}")
    for opt_kw in (None, {"use_pallas": True}):
        _cuda.reset_launches()
        got = golden.three_party_trace(params, device="cuda", opt_kw=opt_kw)
        dev = golden.compare(got, three)
        print(f"[golden] three-party celu cache_fused=True adagrad "
              f"{'K7' if opt_kw else 'plain'}: {dev}; K7 launches "
              f"{_cuda.LAUNCHES['fused_adagrad']}", flush=True)
        check(golden.within_tolerance(dev), f"golden three-party {dev}")
        check(_cuda.LAUNCHES["fused_adagrad"] == (180 if opt_kw else 0),
              f"golden three-party: K7 launches {_cuda.LAUNCHES}")


def train_args(arch, protocol="celu", rounds=50, device=None, **kw):
    from repro_torch.launch.train import build_parser
    argv = ["--arch", arch, "--protocol", protocol, "--rounds", str(rounds)]
    if device:
        argv += ["--device", device]
    args = build_parser().parse_args(argv)
    return SimpleNamespace(**{**vars(args), **kw})


def _party_tensors(out) -> list:
    """Parameter tensors of each party of a trained state."""
    params = out["state"]["params"]
    return [len(list(m.parameters())) for m in params["a"] + [params["b"]]]


def _adagrad_launches(party_tensors) -> int:
    """K7 / K8 launches of one optimizer update of every party: one a
    table of at most ``_cuda.ADAGRAD_LEAVES`` of a party's tensors."""
    from repro_torch.kernels import _cuda
    return sum(-(-n // _cuda.ADAGRAD_LEAVES) for n in party_tensors)


def _run(label, args, **kw):
    """Train with the launch counts set to 0 just before; -> (result,
    the counts of this run)."""
    from repro_torch.kernels import _cuda
    from repro_torch.launch.train import train_dlrm
    _cuda.reset_launches()
    out = train_dlrm(args, **kw)
    counts = dict(_cuda.LAUNCHES)
    print(f"[main] {label}: launches {counts}", flush=True)
    check(math.isfinite(out["final_loss"]), f"{label}: loss not finite")
    return out, counts


def _want(label, counts, **want):
    """Every kernel's count is the wanted one (0 where none is given)."""
    full = {k: want.get(k, 0) for k in counts}
    check(counts == full, f"{label}: launches {counts}, want {full}")


def _cpu_vs_cuda(label, gpu, cpu, rtol):
    """-> the largest relative loss deviation over rounds 2-5, checked
    against ``rtol`` unless ``rtol`` is None (a mutation run, which the
    caller holds to the other side of the limit).  A deep pipeline's
    warm-up rounds report a NaN loss: they must do so on both devices,
    and are not compared."""
    check([g[0] for g in gpu["history"]] == [2, 3, 4, 5]
          and [c[0] for c in cpu["history"]] == [2, 3, 4, 5],
          f"{label} cuda vs cpu: rounds 2-5 not all recorded")
    warm = [math.isnan(c[1]) for c in cpu["history"]]
    check([math.isnan(g[1]) for g in gpu["history"]] == warm
          and not all(warm), f"{label} cuda vs cpu: NaN losses on rounds "
          f"{gpu['history']} against {cpu['history']}")
    devs = [abs(g[1] - c[1]) / abs(c[1])
            for g, c in zip(gpu["history"], cpu["history"])
            if not math.isnan(c[1])]
    print(f"[main] {label}, 5 full-width rounds cuda vs cpu: loss rel dev "
          f"per round 2-5 {[float(f'{d:.3g}') for d in devs]} (tolerance "
          f"{rtol})", flush=True)
    if rtol is not None:
        check(max(devs) <= rtol, f"{label} cuda vs cpu loss deviation {devs}")
    return max(devs)


def _zero_updates(opt):
    """``opt`` with every update zeroed (the mutation run's optimizer)."""
    from repro_torch.optim import Optimizer

    def update(grads, state, params=None):
        upd, state = opt.update(grads, state, params)
        return [u * 0.0 for u in upd], state
    return Optimizer(opt.init, update)


def phase_main_path(torch, card):
    from repro_torch.core.uniforms import GeneratorUniforms
    from repro_torch.launch.train import make_opt, train_dlrm
    from repro_torch.optim import make_optimizer

    counts = {}
    upd = 1 + R              # optimizer updates per party a round
    # WDL-Criteo at full width, the default fused ring sample (K1) and
    # fused AdaGrad (K7: one launch per party update)
    rounds = 50
    wdl, c = _run(f"wdl-criteo celu {rounds} rounds",
                  train_args("wdl-criteo", rounds=rounds))
    check(_party_tensors(wdl) == [7, 13], f"wdl-criteo has "
          f"{_party_tensors(wdl)} parameter tensors a party, want [7, 13]")
    n_wdl = _adagrad_launches(_party_tensors(wdl))
    check(upd * n_wdl == 12, f"{upd * n_wdl} AdaGrad launches per wdl-criteo "
          f"celu round, want 12")
    _want("fp32 cache", c, fused_sample_2d=2 * R * rounds,
          fused_adagrad=upd * n_wdl * rounds)
    counts["fused_sample_2d"] = c["fused_sample_2d"]
    counts["fused_adagrad"] = c["fused_adagrad"]

    dssm, c = _run("dssm-avazu celu 5 rounds", train_args("dssm-avazu",
                                                          rounds=5))
    check(sum(_party_tensors(dssm)) == 16, f"dssm-avazu has "
          f"{_party_tensors(dssm)} parameter tensors, want 16")
    _want("dssm", c, fused_sample_2d=2 * R * 5,
          fused_adagrad=upd * _adagrad_launches(_party_tensors(dssm)) * 5)

    # the materialising path: K2a for Party A, K2b for Party B
    _, c = _run("wdl-criteo celu --no-cache-fusion 5 rounds",
                train_args("wdl-criteo", rounds=5, no_cache_fusion=True))
    _want("--no-cache-fusion", c, cosine_weight_2d=R * 5,
          cosine_weights_2d=R * 5, fused_adagrad=upd * n_wdl * 5)
    counts["cosine_weight_2d"] = c["cosine_weight_2d"]
    counts["cosine_weights_2d"] = c["cosine_weights_2d"]

    # the quantised caches: K3 on each of the 4 inserts of a round (z and
    # dz of both parties), K4 / K5 on each of the 2·R samples; bf16 is K1's
    quant = {}
    for dtype, kernel in (("int8", "fused_sample_q8_2d"),
                          ("int4", "fused_sample_q4_2d")):
        quant[dtype], c = _run(
            f"wdl-criteo celu --cache-dtype {dtype} {rounds} rounds",
            train_args("wdl-criteo", rounds=rounds, cache_dtype=dtype))
        _want(f"--cache-dtype {dtype}", c, quantize_sr_2d=4 * rounds,
              fused_adagrad=upd * n_wdl * rounds,
              **{kernel: 2 * R * rounds})
        counts[kernel] = c[kernel]
        if dtype == "int8":
            counts["quantize_sr_2d"] = c["quantize_sr_2d"]
    _, c = _run("wdl-criteo celu --cache-dtype bfloat16 5 rounds",
                train_args("wdl-criteo", rounds=5, cache_dtype="bfloat16"))
    _want("--cache-dtype bfloat16", c, fused_sample_2d=2 * R * 5,
          fused_adagrad=upd * n_wdl * 5)

    # the compressed wire: K3 on the uplink Z and the downlink ∇Z
    _, c = _run("wdl-criteo celu --compression int8 5 rounds",
                train_args("wdl-criteo", rounds=5, compression="int8"))
    _want("--compression int8", c, quantize_sr_2d=2 * 5,
          fused_sample_2d=2 * R * 5, fused_adagrad=upd * n_wdl * 5)
    _, c = _run("wdl-criteo celu --cache-dtype int8 --compression int4x2 "
                "5 rounds", train_args("wdl-criteo", rounds=5,
                                       cache_dtype="int8",
                                       compression="int4x2"))
    _want("--cache-dtype int8 --compression int4x2", c,
          quantize_sr_2d=(4 + 4) * 5, fused_sample_q8_2d=2 * R * 5,
          fused_adagrad=upd * n_wdl * 5)

    # the optimizer states: K8 on every int8-state update, K7 on every
    # bf16-state update (it reads and stores the bf16 state), neither for
    # SM3
    opt_int8, c = _run(f"wdl-criteo celu --opt-state-dtype int8 {rounds} "
                       f"rounds", train_args("wdl-criteo", rounds=rounds,
                                             opt_state_dtype="int8"))
    _want("--opt-state-dtype int8", c, fused_sample_2d=2 * R * rounds,
          fused_adagrad_q8=upd * n_wdl * rounds)
    counts["fused_adagrad_q8"] = c["fused_adagrad_q8"]
    _, c = _run("wdl-criteo celu --opt-state-dtype bfloat16 5 rounds",
                train_args("wdl-criteo", rounds=5,
                           opt_state_dtype="bfloat16"))
    _want("--opt-state-dtype bfloat16", c, fused_sample_2d=2 * R * 5,
          fused_adagrad=upd * n_wdl * 5)
    _, c = _run("wdl-criteo celu --optimizer sm3 5 rounds",
                train_args("wdl-criteo", rounds=5, optimizer="sm3"))
    _want("--optimizer sm3", c, fused_sample_2d=2 * R * 5)

    # five full-width rounds on the card against the CPU
    gpu5 = train_dlrm(train_args("wdl-criteo", rounds=5))
    cpu5 = train_dlrm(train_args("wdl-criteo", rounds=5, device="cpu"))
    _cpu_vs_cuda("fp32", gpu5, cpu5, CPU_CUDA_RTOL)
    # ... and on the quantised cache and wire, both drawing the same
    # uniforms on the CPU; two card runs, since the card's embedding
    # gradients sum with atomics in no fixed order
    kw = dict(rounds=5, cache_dtype="int8", compression="int8")
    cpu5 = train_dlrm(train_args("wdl-criteo", device="cpu", **kw),
                      uniforms=GeneratorUniforms(0, "cpu"))
    for run in (1, 2):
        gpu5 = train_dlrm(train_args("wdl-criteo", **kw),
                          uniforms=GeneratorUniforms(0, "cuda", "cpu"))
        _cpu_vs_cuda(f"int8 cache + int8 wire (card run {run})", gpu5, cpu5,
                     QUANT_CPU_CUDA_RTOL)
    # ... and on the int8 optimizer state (K8), the same way; then a
    # mutation run whose updates are zeroed must fall outside the limit
    kw = dict(rounds=5, opt_state_dtype="int8")
    cpu5 = train_dlrm(train_args("wdl-criteo", device="cpu", **kw),
                      uniforms=GeneratorUniforms(0, "cpu"))
    for run in (1, 2):
        gpu5 = train_dlrm(train_args("wdl-criteo", **kw),
                          uniforms=GeneratorUniforms(0, "cuda", "cpu"))
        _cpu_vs_cuda(f"int8 optimizer state (card run {run})", gpu5, cpu5,
                     OPT_CPU_CUDA_RTOL)
    args = train_args("wdl-criteo", **kw)
    src = GeneratorUniforms(0, "cuda", "cpu")
    mutant = train_dlrm(args, uniforms=src,
                        opt=_zero_updates(make_opt(args, src)))
    dev = _cpu_vs_cuda("int8 optimizer state, updates zeroed (mutation)",
                       mutant, cpu5, None)
    check(dev > OPT_CPU_CUDA_RTOL, f"the zero-update mutation reads {dev}, "
          f"inside the limit {OPT_CPU_CUDA_RTOL}")

    # time: the celu round against the vanilla round (no local updates)
    vanilla, c = _run("wdl-criteo vanilla 20 rounds",
                      train_args("wdl-criteo", protocol="vanilla",
                                 rounds=20))
    _want("vanilla", c, fused_adagrad=n_wdl * 20)     # 2 a round
    round_ms = wdl["steady_round_ms"]
    local_ms = (round_ms - vanilla["steady_round_ms"]) / R
    print(f"[time] wdl-criteo full width B=256 R=W=5 celu: "
          f"{round_ms:.3f} ms per round, vanilla "
          f"{vanilla['steady_round_ms']:.3f} ms per round, so "
          f"{local_ms:.3f} ms per local step (both parties); card {card}",
          flush=True)
    for dtype, out in quant.items():
        print(f"[time] wdl-criteo full width celu --cache-dtype {dtype}: "
              f"{out['steady_round_ms']:.3f} ms per round (fp32 cache "
              f"{round_ms:.3f}); card {card}", flush=True)
    # the four AdaGrad routes in turns (plain, K7, int8 / K8, bf16 / K7,
    # then back), 20 rounds each
    routes = {"plain AdaGrad (6 launches a tensor)": {},
              "K7 (--opt-state-dtype float32)": {},
              "int8 state, K8": {"opt_state_dtype": "int8"},
              "bf16 state, K7": {"opt_state_dtype": "bfloat16"}}
    times = {k: [] for k in routes}
    for name in list(routes) + list(routes)[::-1]:
        args = train_args("wdl-criteo", rounds=20, **routes[name])
        opt = make_optimizer("adagrad", args.lr) if name.startswith("plain") \
            else None
        times[name].append(train_dlrm(args, opt=opt)["steady_round_ms"])
    for name, ms in times.items():
        print(f"[time] wdl-criteo full width celu, AdaGrad route {name}: "
              f"{ms[0]:.3f} and {ms[1]:.3f} ms per round; card {card}",
              flush=True)

    # the card's busy time per round, from a profiled run of each route
    # (the profiler slows the host, not the kernels)
    from torch.profiler import ProfilerActivity, profile
    rounds = 20
    for name, kw in routes.items():
        args = train_args("wdl-criteo", rounds=rounds, **kw)
        opt = make_optimizer("adagrad", args.lr) if name.startswith("plain") \
            else None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train_dlrm(args, opt=opt)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / rounds
        ag = [e for e in kernels if "adagrad" in e.name]
        print(f"[time] AdaGrad {name}: device busy {busy_ms:.3f} ms per "
              f"round ({len(kernels) / rounds:.0f} kernels per round, "
              f"evaluation included; K7 / K8 {len(ag) / rounds:.0f} of them, "
              f"{sum(e.device_time_total for e in ag) / 1e3 / rounds:.3f} "
              f"ms) = {100 * busy_ms / round_ms:.1f}% of the "
              f"{round_ms:.3f} ms K7 round; card {card}", flush=True)
        top = sorted(prof.key_averages(),
                     key=lambda e: -e.self_device_time_total)
        for e in top[:8]:
            print(f"[time]   {e.self_device_time_total / 1e3 / rounds:8.3f} "
                  f"ms per round  {e.count / rounds:6.1f} calls  "
                  f"{e.key[:70]}")
    return counts


def _depth0_goldens(torch):
    """The goldens at depth 0 through ``engine.make_pipeline``: within the
    tests' tolerance, and bitwise the port's ``make_round`` on the card."""
    from repro_torch import golden
    params = golden.load_params(GOLDEN_DIR)
    two = golden.load_golden(GOLDEN_DIR, "two_party_trace.json")
    three = golden.load_golden(GOLDEN_DIR, "three_party_trace.json")["celu"]
    runs = [(f"two-party {p}", two[p],
             lambda depth, p=p: golden.two_party_trace(
                 p, params, device="cuda", depth=depth))
            for p in ("vanilla", "fedbcd", "celu")]
    runs.append(("three-party celu", three,
                 lambda depth: golden.three_party_trace(
                     params, device="cuda", depth=depth)))
    for label, want, trace in runs:
        got = trace(0)
        dev = golden.compare(got, want)
        same = got == trace(None)
        print(f"[pipeline] golden {label} through make_pipeline at depth 0 "
              f"on the card: {dev}; bitwise make_round: {same}", flush=True)
        check(golden.within_tolerance(dev), f"depth-0 golden {label} {dev}")
        check(same, f"depth-0 golden {label}: the pipeline's rows differ "
              f"from make_round's")


def _pipeline_run(label, args, depth, n_adagrad, want=None, **kw):
    """``train_dlrm(args, **kw)`` at ``depth`` with the counts set to 0
    just before: the derived K1 / K7 counts, and no other kernel unless
    ``want`` names it.  -> (result, counts)."""
    from repro_torch.kernels import _cuda
    from repro_torch.launch.train import train_dlrm
    want = dict(_wdl_launches(depth, args.rounds, n_adagrad), **(want or {}))
    _cuda.reset_launches()
    out = train_dlrm(args, **kw)
    counts = dict(_cuda.LAUNCHES)
    print(f"[pipeline] {label}: launches {counts}", flush=True)
    check(out["pipeline_depth"] == depth, f"{label}: ran at depth "
          f"{out['pipeline_depth']}")
    check(math.isfinite(out["final_loss"]), f"{label}: loss not finite")
    _want(label, counts, **want)
    return out, counts


@contextlib.contextmanager
def _profiled_steps(torch, start: int = 2):
    """Profile the training CLI's rounds from step ``start`` to its last
    (evaluation included; set-up, the earlier rounds and the pipeline's
    drain left out): ``launch.train.make_schedule`` is wrapped so that the
    profiler starts before step ``start`` and stops before the finish.
    Yields the profiler."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as T
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    make = T.make_schedule

    def profiled(*a, **kw):
        sched, calls = make(*a, **kw), [0]

        def step(*sa, **skw):
            calls[0] += 1
            if calls[0] == start:
                torch.cuda.synchronize()
                prof.start()
            return sched.step(*sa, **skw)

        def finish(state):
            torch.cuda.synchronize()
            prof.stop()
            return sched.finish(state)
        return sched._replace(step=step, finish=finish)
    with mock.patch.object(T, "make_schedule", profiled):
        yield prof


def _kernels(torch, prof) -> list:
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _busy_ms_per_round(torch, args):
    """-> (device busy ms per round, kernels per round) of ``train_dlrm``'s
    rounds 2 on (evaluation included) under the profiler."""
    from repro_torch.launch.train import train_dlrm
    with _profiled_steps(torch) as prof:
        train_dlrm(args)
    kernels = _kernels(torch, prof)
    rounds = args.rounds - 1
    return (sum(e.device_time_total for e in kernels) / 1e3 / rounds,
            len(kernels) / rounds)


def phase_pipeline(torch, card):
    """The pipelined scheduler (``engine.PipelinedEngine``): the goldens at
    depth 0; WDL-Criteo at full width through ``train_dlrm`` at depths 1,
    2 and 4, uniform sampling at depth 2 and DP over the int8 wire (K3),
    each run's launches against the counts derived from the schedule and
    its first rounds against the CPU; ms per round (host clock and busy)
    at depths 0, 1 and 2; smollm-360m at full width through ``train_llm``
    at depth 1.  -> the kernels' launches over the phase's runs."""
    from repro_torch.core.uniforms import GeneratorUniforms
    from repro_torch.launch.train import celu_config, train_dlrm

    _depth0_goldens(torch)
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    n_wdl = 2            # one K7 launch a party update (7 and 13 tensors)
    rounds = 50
    runs = {}
    for depth in (1, 2, 4):
        args = train_args("wdl-criteo", rounds=rounds, pipeline_depth=depth)
        runs[depth], c = _pipeline_run(
            f"wdl-criteo celu --pipeline-depth {depth}, {rounds} rounds",
            args, depth, n_wdl)
        check(_adagrad_launches(_party_tensors(runs[depth])) == n_wdl,
              "wdl-criteo: one K7 launch a party update")
        add(c)
        # the first rounds on the card against the CPU
        gpu5 = train_dlrm(train_args("wdl-criteo", rounds=5,
                                     pipeline_depth=depth))
        cpu5 = train_dlrm(train_args("wdl-criteo", rounds=5, device="cpu",
                                     pipeline_depth=depth))
        _cpu_vs_cuda(f"--pipeline-depth {depth}", gpu5, cpu5, CPU_CUDA_RTOL)

    # uniform sampling at depth 2: no CLI flag (nor the reference's), so
    # the CELUConfig goes to train_dlrm; the draws' uniforms come from the
    # CPU on both devices
    def uniform(device, rounds):
        args = train_args("wdl-criteo", rounds=rounds, device=device,
                          pipeline_depth=2)
        celu = dataclasses.replace(celu_config(args), sampling="uniform")
        return args, dict(celu=celu, uniforms=GeneratorUniforms(
            0, device or "cuda", "cpu"))
    args, kw = uniform(None, rounds)
    out, c = _pipeline_run(f"wdl-criteo celu uniform sampling "
                           f"--pipeline-depth 2, {rounds} rounds", args, 2,
                           n_wdl, **kw)
    add(c)
    print(f"[pipeline] uniform sampling at depth 2: AUC "
          f"{out['final_auc']:.4f} (round-robin {runs[2]['final_auc']:.4f})",
          flush=True)
    gpu5, cpu5 = (train_dlrm(a, **k) for a, k in (uniform(None, 5),
                                                  uniform("cpu", 5)))
    _cpu_vs_cuda("uniform sampling, --pipeline-depth 2", gpu5, cpu5,
                 CPU_CUDA_RTOL)

    # DP over the int8 wire (K3 on the uplink Z and the downlink ∇Z), the
    # noise drawn on the CPU on both devices
    def dp(device, rounds):
        args = train_args("wdl-criteo", rounds=rounds, device=device,
                          compression="int8")
        celu = dataclasses.replace(celu_config(args), dp_sigma=DP_SIGMA,
                                   dp_clip=DP_CLIP)
        return args, dict(celu=celu, uniforms=GeneratorUniforms(
            0, device or "cuda", "cpu"))
    args, kw = dp(None, rounds)
    out, c = _pipeline_run(f"wdl-criteo celu --compression int8, DP sigma "
                           f"{DP_SIGMA} clip {DP_CLIP}, {rounds} rounds",
                           args, 0, n_wdl,
                           want={"quantize_sr_2d": 2 * rounds}, **kw)
    add(c)
    print(f"[pipeline] DP sigma {DP_SIGMA} over the int8 wire: AUC "
          f"{out['final_auc']:.4f}", flush=True)
    gpu5, cpu5 = (train_dlrm(a, **k) for a, k in (dp(None, 5),
                                                  dp("cpu", 5)))
    _cpu_vs_cuda(f"DP sigma {DP_SIGMA} over the int8 wire", gpu5, cpu5,
                 QUANT_CPU_CUDA_RTOL)

    # time: depths 0, 1, 2 in turns (host clock), then the card's busy
    # time per round from a profiled run of each
    times = {d: [] for d in (0, 1, 2)}
    for depth in (0, 1, 2, 2, 1, 0):
        out = train_dlrm(train_args("wdl-criteo", rounds=20,
                                    pipeline_depth=depth))
        times[depth].append(out)
    for depth, outs in times.items():
        busy, n = _busy_ms_per_round(torch, train_args(
            "wdl-criteo", rounds=20, pipeline_depth=depth))
        o = outs[0]
        host = " and ".join(f"{x['steady_round_ms']:.3f}" for x in outs)
        flush = " and ".join(f"{x['flush_ms']:.3f}" for x in outs)
        print(f"[time] wdl-criteo full width B=256 R=W=5 celu "
              f"--pipeline-depth {depth}: {host} ms per round (host clock, "
              f"rounds 2-20 of two runs in turns; the drain {flush} ms); "
              f"device busy {busy:.3f} ms per round over rounds 2-20 "
              f"({n:.0f} kernels per round, evaluation included); "
              f"simulated WAN {o['sim_wan_s']:.3f} s "
              f"against {o['sim_wan_sequential_s']:.3f} s sequential "
              f"({o['sim_wan_sequential_s'] / o['sim_wan_s']:.3f}x); AUC "
              f"{o['final_auc']:.4f} after 20 rounds; card {card}",
              flush=True)
    for depth in (1, 2, 4):
        o = runs[depth]
        print(f"[time] wdl-criteo --pipeline-depth {depth}, {rounds} rounds: "
              f"{o['steady_round_ms']:.3f} ms per round (host clock), "
              f"simulated WAN {o['sim_wan_s']:.3f} s against "
              f"{o['sim_wan_sequential_s']:.3f} s sequential, AUC "
              f"{o['final_auc']:.4f}; card {card}", flush=True)
    add(_llm_at_depth1(torch, card))
    return counts


def _llm_at_depth1(torch, card):
    """smollm-360m at full width through ``train_llm`` at depth 1: the
    derived launches, finite losses, ms per round, busy ms per round
    (rounds 2-3, profiled) and the peak memory.  -> the launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch import train as T

    cfg = get_config("smollm-360m")
    args = train_args("smollm-360m", rounds=TRAIN_ROUNDS, pipeline_depth=1,
                      **TRAIN_ARGS)
    params = T.llm_params(cfg, args.seed, "cuda")
    n_tensors = [len(list(p.parameters())) for p in params.values()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    out = T.train_llm(args, params=params)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = _llm_launches(cfg, args.R, TRAIN_ROUNDS, args.remat, n_tensors,
                         depth=1)
    print(f"[pipeline] {cfg.name} full width, B={args.batch_size} "
          f"S={args.seq_len} R={args.R} W={args.W} celu "
          f"--pipeline-depth 1, {TRAIN_ROUNDS} rounds, remat on: launches "
          f"{counts} (derived {want})", flush=True)
    _want("smollm-360m at depth 1", counts, **want)
    losses = out["losses"]
    check(out["pipeline_depth"] == 1
          and all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"depth-1 training losses {losses}")
    ms = [1e3 * t for t in out["round_s"]]
    print(f"[pipeline] losses per round {losses}; ms per round "
          f"{[round(x, 3) for x in ms]} (rounds 2-{TRAIN_ROUNDS}: "
          f"{sum(ms[1:]) / len(ms[1:]):.3f} ms), the flush "
          f"{1e3 * out['flush_s']:.3f} ms; peak device memory {peak:,} B "
          f"(torch.cuda.max_memory_allocated); card {card}", flush=True)
    del out

    # busy time of rounds 2-3 (the drain left out)
    with _profiled_steps(torch) as prof:
        prof_out = T.train_llm(train_args(
            "smollm-360m", rounds=TRAIN_ROUNDS, pipeline_depth=1,
            **TRAIN_ARGS), params=params)
    rounds = TRAIN_ROUNDS - 1
    wall = sum(prof_out["round_s"][1:])
    kernels = _kernels(torch, prof)
    busy = sum(e.device_time_total for e in kernels) / 1e3 / rounds
    print(f"[pipeline] {cfg.name} depth 1, rounds 2-{TRAIN_ROUNDS} of a "
          f"second run profiled: device busy {busy:.3f} ms per round in "
          f"{len(kernels) / rounds:.0f} kernels, ms per round on the host "
          f"clock under the profiler "
          f"{[round(1e3 * t, 3) for t in prof_out['round_s']]} "
          f"({100 * busy * rounds / (1e3 * wall):.1f} % busy over rounds "
          f"2-{TRAIN_ROUNDS}); card {card}", flush=True)
    del prof, prof_out, params
    return counts


def phase_serve_kernels(torch):
    """K6 and K11 against their plain versions, bitwise, at the serving
    ring and a wide one; K9 against its plain version at the long-prompt
    shapes, beside one ``F.scaled_dot_product_attention`` call."""
    import torch.nn.functional as F
    from repro_torch.core.workset import pack_nibbles
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_sample as fs
    from repro_torch.kernels import quantize as qz

    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    slot = torch.tensor([2], dtype=torch.int32, device="cuda")
    for bits, name, kernel in ((8, "fused_dequant_q8_2d",
                                fs.fused_dequant_q8_2d),
                               (4, "fused_dequant_q4_2d",
                                fs.fused_dequant_q4_2d)):
        results[name] = {"max_abs_err": 0.0, "library_ms": None}
        for (W, C, F_) in (SERVE_RING, WIDE_RING):
            x = torch.randn((W * C, F_), generator=gen, device="cuda")
            q, sc = qz.quantize_sr_plain(
                x, torch.rand(x.shape, generator=gen, device="cuda"),
                127 if bits == 8 else 7)
            if bits == 4:
                q = pack_nibbles(q)
            q = q.reshape(W, C, -1).contiguous()
            sc = sc.reshape(W, C).contiguous()

            def kern():
                return kernel(slot, q, sc)

            def plain():
                return fs.fused_dequant_plain(bits, slot, q, sc)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            check(torch.equal(out, ref), f"{name} at {(W, C, F_)}: not "
                  f"bitwise equal to its plain version (max |err| "
                  f"{(out - ref).abs().max().item()})")
            label = f"{name:30s} W,C,F={W},{C},{F_}"
            if (W, C, F_) != SERVE_RING:
                print(f"[kernel] {label} bitwise equal to its plain "
                      f"version", flush=True)
                continue
            # the slot's codes and scales read, the rows written, the slot
            nbytes = q[0].numel() + 4 * C + 4 * C * F_ + 4
            results[name].update(_timed(torch, label, kern, plain, 0.0,
                                        nbytes, C * F_))
            print(f"[kernel] {label} bitwise equal to its plain version",
                  flush=True)

    results["flash_attention"] = {"max_abs_err": 0.0}
    for shape, causal, window in K9_CASES:
        B, S, H, hd = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))

        def kern():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            return fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        limit = K9_REL_TOL * ref.float().abs() + K9_ATOL
        err = diff.max().item()
        worst = (diff / limit).max().item()      # <= 1 everywhere to pass
        over = int((diff > limit).sum())
        check(math.isfinite(err) and over == 0,
              f"flash_attention at {shape} causal={causal} window={window}: "
              f"{over} elements beyond 2^-7 |ref| + {K9_ATOL} (max |err| "
              f"{err}, largest |ref| {ref.float().abs().max().item()}, "
              f"worst err / limit {worst:.3g})")
        results["flash_attention"]["max_abs_err"] = max(
            results["flash_attention"]["max_abs_err"], err)
        label = (f"{'flash_attention':30s} B,S,H,hd={B},{S},{H},{hd} bf16 "
                 f"causal={causal} window={window}")
        nbytes = fa.nbytes(q)
        flops = fa.flops(B, S, H, hd, causal, window)
        lib_ms, lib = None, "none"
        if window == 0:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            lib_ms = device_ms(torch, library, 10)
            lib = f"F.scaled_dot_product_attention {lib_ms * 1e3:.2f} us"
        t = _timed(torch, label, kern, plain, err, nbytes, flops,
                   library=lib, peak=PEAK_BF16_FLOPS, iters=10)
        print(f"[kernel] {label} max |err| {err:.3g}; every element "
              f"within 2^-7 |ref| + {K9_ATOL:g} (worst err / limit "
              f"{worst:.3g}, median |ref| "
              f"{ref.float().abs().median().item():.3g}); "
              f"{t['ms'] * 1e3:.2f} us: the two products of its work at "
              f"{flops / t['ms'] / 1e9:.1f} TFLOP/s, the {K9_MMA[1]} it "
              f"issues at {K9_MMA[1] / 2 * flops / t['ms'] / 1e9:.1f} "
              f"TFLOP/s (peak {PEAK_BF16_FLOPS / 1e12:.0f})", flush=True)
        if (shape, causal, window) == K9_CASES[0]:
            results["flash_attention"].update(t, library_ms=lib_ms)
    for shape, causal, window in K9_ODD_TILES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        kw = dict(causal=causal, window=window)
        tag = (f"B,S,H,hd={','.join(map(str, shape))} causal={causal} "
               f"window={window}")
        o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
        o_k9 = fa.flash_attention(q, k, v, **kw)
        o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
        check(torch.equal(o, o_k9), f"flash_attention_fwd_lse {tag}: the "
              f"output differs from K9's without the LSE pointer")
        _, w_o = _per_element("flash_attention", f"{tag} out", o_k9, o_ref,
                              K9_REL_TOL, K9_ATOL)
        _, w_l = _per_element("flash_attention_fwd_lse", f"{tag} lse", lse,
                              lse_ref, LSE_REL, LSE_ATOL)
        print(f"[kernel] {'flash_attention':30s} {tag}: worst err / limit "
              f"out {w_o:.3g}, lse {w_l:.3g}; K9-LSE's out bitwise K9's",
              flush=True)
    _k9_tensor_cores()
    return results


def _mma_per_hd(name: str, kernel: str) -> dict:
    """{hd: HMMA / HGMMA instructions in the SASS of ``kernel<hd>``} at hd
    32, 64 and 128; fails if one has none (``name`` the wrapper)."""
    from repro_torch.kernels import _cuda

    counts = sass_mma_counts(_cuda.build()["path"])
    per_hd = {d: counts.get(f"{kernel}<{d}>", 0) for d in (32, 64, 128)}
    check(all(per_hd.values()), f"{name}: {kernel} has no tensor-core "
          f"instruction in its SASS at some head dim: {per_hd}")
    return per_hd


def _k9_tensor_cores():
    """K9's bf16 kernel runs on the tensor cores at hd 32, 64 and 128."""
    per_hd = _mma_per_hd("flash_attention", K9_MMA[0])
    print(f"[kernel] {'flash_attention':30s} bf16: tensor-core instructions "
          f"in the SASS of {K9_MMA[0]} (cuobjdump -sass) at hd 32 / 64 / "
          f"128: {per_hd[32]} / {per_hd[64]} / {per_hd[128]}", flush=True)


def _loop_logits(torch, params, cfg, batch, total_len, tokens):
    """The sequential loop's (``naive_generate``'s functions, one row)
    logits for each of a request's tokens, fed the engine's tokens
    (teacher forcing) -> (n, V) fp32."""
    from repro_torch.serve.engine import make_naive_fns
    prefill, decode = make_naive_fns(cfg, total_len)
    logits, caches = prefill(params, batch)
    S = batch["tokens"].shape[1]
    out = [logits[0, -1]]
    for i in range(1, len(tokens)):
        tok = torch.tensor([[int(tokens[i - 1])]], dtype=torch.int32,
                           device=logits.device)
        sb = {"token": tok,
              "token_a": torch.remainder(tok, cfg.aux_vocab_size)}
        logits, caches = decode(params, caches, sb, S + i - 1)
        out.append(logits[0, -1])
    return torch.stack(out)


class _Recorder:
    """Records, in call order and without a host sync, what the serving
    engine computes: each admit's prompt and Party B prefill logits and
    the lane it fills, and each decode step's lane positions and
    logits."""

    def __init__(self):
        self.events = []

    def patches(self):
        from unittest import mock

        from repro_torch.models import vfl
        from repro_torch.serve import engine as E
        prefill_b, decode_b = vfl.prefill_b, vfl.decode_step_b
        clear = E._ring_clear_lane

        def rec_prefill_b(params_b, cfg, z_a, batch, total_len=0):
            logits, caches = prefill_b(params_b, cfg, z_a, batch, total_len)
            self.events.append(["admit", batch["tokens"][0].clone(),
                                logits[0, -1].clone(), None])
            return logits, caches

        def rec_clear(ws, lane):
            self.events[-1][3] = lane
            return clear(ws, lane)

        def rec_decode_b(params_b, cfg, caches, token, z_a_t, pos):
            logits, caches = decode_b(params_b, cfg, caches, token, z_a_t,
                                      pos)
            self.events.append(["step", pos.clone(), logits[:, 0].clone()])
            return logits, caches
        return [mock.patch.object(vfl, "prefill_b", rec_prefill_b),
                mock.patch.object(vfl, "decode_step_b", rec_decode_b),
                mock.patch.object(E, "_ring_clear_lane", rec_clear)]

    def logits(self, torch, requests, prompt_len):
        """-> {req_id: (n, V) the engine's logits for the request's
        tokens}, each step's row taken from the lane the request held
        (warm()'s scratch admits match no request)."""
        by_prompt = {tuple(r.prompt.tolist()): r.req_id for r in requests}
        owner, rows = {}, {}
        for ev in self.events:
            if ev[0] == "admit":
                rid = by_prompt.get(tuple(ev[1].tolist()))
                owner[ev[3]] = rid
                if rid is not None:
                    rows[rid] = [ev[2]]
                continue
            pos = ev[1].tolist()
            for lane, rid in owner.items():
                if rid is not None and \
                        pos[lane] - prompt_len + 1 == len(rows[rid]):
                    rows[rid].append(ev[2][lane])
        return {rid: torch.stack(r) for rid, r in rows.items()}


def phase_serving(torch, card):
    """The serving CLI's path at smollm-360m's full width; -> the kernels'
    launch counts on it."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as cli
    from repro_torch.models import layers as L
    from repro_torch.models import vfl
    from repro_torch.models.initializers import param_bytes, param_count
    from repro_torch.serve import LoadSpec, naive_generate, synth_requests

    cfg = get_config("smollm-360m")
    params = vfl.init_all(0, cfg, "cuda")
    print(f"[serve] {cfg.name} full width: {param_count(params):,} "
          f"parameters, {param_bytes(params):,} B (bf16), split "
          f"{cfg.vfl_split.layers_a}/{cfg.vfl_split.layers_b}/"
          f"{cfg.vfl_split.layers_top} layers", flush=True)
    counts = {}

    def serve(label, base, **flags):
        argv = ["--full"]
        for k, v in base.items():
            argv += [k, str(v)]
        for k, v in flags.items():
            argv += [f"--{k.replace('_', '-')}"] + ([] if v is True
                                                     else [str(v)])
        args = cli.build_parser().parse_args(argv)
        _cuda.reset_launches()
        comps, stats, eng = cli.serve_engine(args, cfg, params)
        c = dict(_cuda.LAUNCHES)
        steps = stats["decode_steps"]
        walls = sorted(stats["step_walls"])
        print(f"[serve] {label}: launches {c}; {steps} decode steps, "
              f"{1e3 * walls[len(walls) // 2]:.3f} ms per step (median), "
              f"{stats['req_per_s']:.2f} req/s, {stats['tok_per_s']:.1f} "
              f"tok/s, p50 {stats['p50_ms']:.3f} / p99 "
              f"{stats['p99_ms']:.3f} ms per token, wire "
              f"{(stats['wire_up_bytes'] + stats['wire_down_bytes']) / stats['total_tokens']:.1f}"
              f" B per token, ring {eng.ring_bytes} B; card {card}",
              flush=True)
        check(stats["n_requests"] == args.requests,
              f"{label}: {stats['n_requests']} of {args.requests} served")
        for comp in comps:
            check(comp.tokens.dtype.kind == "i"
                  and ((comp.tokens >= 0)
                       & (comp.tokens < cfg.vocab_size)).all(),
                  f"{label}: request {comp.req_id} tokens {comp.tokens}")
        return comps, stats, eng, c

    def want(label, c, **w):
        full = {k: w.get(k, 0) for k in c}
        check(c == full, f"{label}: launches {c}, want {full}")

    # warm() runs one admit and one step of each kind (one exchange) on
    # scratch state, the run R = 1 exchanges on every step; each admit
    # sends its (S, d) prefill up through K3, each exchange step its lane
    # rows (K3) and inserts them into the ring (K3)
    def k3(admits, steps):
        return admits + 1 + 2 * (steps + 1)

    int8_runs = []
    for run in (1, 2):
        rec = _Recorder()
        with contextlib.ExitStack() as stack:
            for p in rec.patches():
                stack.enter_context(p)
            comps, stats, eng, c = serve(
                f"int8 ring + int8 wire (run {run})", SERVE_ARGS)
        steps = stats["decode_steps"]
        want(f"int8 run {run}", c, fused_dequant_q8_2d=steps + 2,
             quantize_sr_2d=k3(32, steps))
        int8_runs.append((comps, rec.events))
    counts["fused_dequant_q8_2d"] = c["fused_dequant_q8_2d"]
    (comps1, ev1), (comps2, ev2) = int8_runs
    for a, b in zip(comps1, comps2):
        check(a.req_id == b.req_id and (a.tokens == b.tokens).all(),
              f"int8 runs 1 and 2 differ at request {a.req_id}")
    check(len(ev1) == len(ev2) and all(
        torch.equal(x, y) for e1, e2 in zip(ev1, ev2)
        for x, y in zip(e1[1:3], e2[1:3])),
        "int8 runs 1 and 2: the engine's logits differ")
    print(f"[serve] int8: two runs give identical tokens for all 32 "
          f"requests and bitwise equal logits at all {len(ev1)} admits "
          f"and decode steps", flush=True)

    # launches and device work of one decode step (all 8 lanes)
    from torch.profiler import ProfilerActivity, profile
    step = eng._step[True]
    for _ in range(2):
        step(eng.params, eng.state, 0, 0, eng.uniforms)
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(eng.params, eng.state, 0, 0, eng.uniforms)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        step(eng.params, eng.state, 0, 0, eng.uniforms)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"[serve] one int8 decode step, 8 lanes: {len(kernels) / n:.0f} "
          f"kernel launches, {step_ms:.3f} ms on the host clock "
          f"({prof_ms:.3f} profiled), device busy {busy:.3f} ms "
          f"({100 * busy / step_ms:.1f}%); card {card}", flush=True)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    for e in top[:6]:
        print(f"[serve]   {e.self_device_time_total / 1e3 / n:8.3f} ms per "
              f"step  {e.count / n:6.1f} calls  {e.key[:70]}")

    _, stats, _, c = serve("int4 ring + int8 wire", SERVE_ARGS,
                           cache_dtype="int4")
    steps = stats["decode_steps"]
    want("int4 ring", c, fused_dequant_q4_2d=steps + 2,
         quantize_sr_2d=k3(32, steps))
    counts["fused_dequant_q4_2d"] = c["fused_dequant_q4_2d"]

    # fp32 ring and wire: no kernel of this PR on the path; each lane's
    # logits at every step against the sequential loop's for the same
    # request, fed the same tokens
    rec = _Recorder()
    with contextlib.ExitStack() as stack:
        for p in rec.patches():
            stack.enter_context(p)
        comps, stats, _, c = serve("fp32 ring + fp32 wire", SERVE_ARGS,
                                   cache_dtype="float32", fp32_wire=True)
    want("fp32 ring + fp32 wire", c)
    spec = LoadSpec(n_requests=32, rate=0.0, prompt_len=16,
                    max_new_tokens=16, min_new_tokens=4, seed=0)
    reqs = {r.req_id: r for r in synth_requests(spec, cfg)}
    eng_logits = rec.logits(torch, reqs.values(), spec.prompt_len)
    loop = {}
    for comp in comps:
        r = reqs[comp.req_id]
        batch = {"tokens": torch.as_tensor(r.prompt[None]).cuda(),
                 "tokens_a": torch.as_tensor(r.prompt_a[None]).cuda()}
        n = len(comp.tokens)
        check(comp.req_id in eng_logits
              and eng_logits[comp.req_id].shape[0] >= n,
              f"fp32 request {comp.req_id}: the engine's logits were not "
              f"recorded for its {n} tokens")
        eng_logits[comp.req_id] = eng_logits[comp.req_id][:n]
        loop[comp.req_id] = _loop_logits(torch, params, cfg, batch, 32,
                                         comp.tokens)
        if comp.req_id == 0:
            naive = naive_generate(params, cfg, batch, n,
                                   total_len=32)[0].tolist()
    dev = max((eng_logits[i] - loop[i]).abs().max().item() for i in loop)
    # a lane's logits lie nearer its own request's loop than any other
    # request's at the same token: a lane mix-up, a wrong KV slot or a
    # stale ring row would not
    nearest_other = math.inf
    for i in loop:
        for j in loop:
            m = min(len(loop[i]), len(loop[j]))
            if i != j:
                nearest_other = min(nearest_other, (
                    eng_logits[i][:m] - loop[j][:m]).abs().amax(-1).min()
                    .item())
    flips = 0
    for comp in comps:
        top = torch.topk(loop[comp.req_id], 2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]).tolist()
        want_tok = loop[comp.req_id].argmax(-1).tolist()
        for t, (a, b) in enumerate(zip(comp.tokens.tolist(), want_tok)):
            if a != b:
                flips += 1
                check(margin[t] < BATCH_MARGIN,
                      f"fp32 engine request {comp.req_id} token {t}: "
                      f"{a} where the loop's argmax is {b} by a margin "
                      f"of {margin[t]}")
    # naive_generate itself: greedy on its own tokens, it may part from
    # the engine only where the loop's margin allows a flip
    first = comps[0].tokens.tolist()
    upto = next((t for t, (a, b) in enumerate(zip(first, naive)) if a != b),
                len(first))
    if upto < len(first):
        top = torch.topk(loop[0][upto], 2).values
        check(float(top[0] - top[1]) < BATCH_MARGIN,
              f"naive_generate differs from the engine at request 0 "
              f"token {upto}")
    toks = [t for cp in comps for t in cp.tokens.tolist()]
    total = len(toks)
    print(f"[serve] fp32 engine against the sequential loop: each lane's "
          f"logits at all {total} tokens within {dev:.4g} of its own "
          f"request's (limit {LANE_LOGIT_ATOL}); the nearest other "
          f"request's logits at least {nearest_other:.4g} away; {flips} "
          f"tokens differ from the loop's argmax (each at a margin below "
          f"{BATCH_MARGIN}); {len(set(toks))} distinct tokens; "
          f"naive_generate equal to the engine on request 0 for {upto} "
          f"of {len(first)} tokens", flush=True)
    check(math.isfinite(dev) and dev <= LANE_LOGIT_ATOL,
          f"fp32 engine logits deviate from the loop's by {dev}")
    check(dev < nearest_other, f"fp32 engine: a lane's logits lie "
          f"{nearest_other} from another request's, nearer than the "
          f"{dev} from its own")

    # a prompt past the blockwise threshold: K9 in every attention layer
    # of every prefill (32 layers; warm() adds one admit)
    comps, stats, _, c = serve("4,096-token prompts", LONG_ARGS)
    steps = stats["decode_steps"]
    n_layers = cfg.n_layers
    want("long prompt", c, flash_attention=n_layers * (4 + 1),
         fused_dequant_q8_2d=steps + 2, quantize_sr_2d=k3(4, steps))
    counts["flash_attention"] = c["flash_attention"]
    spec = LoadSpec(n_requests=4, rate=0.0, prompt_len=4096,
                    max_new_tokens=8, min_new_tokens=2, seed=0)
    r = synth_requests(spec, cfg)[0]
    batch = {"tokens": torch.as_tensor(r.prompt[None]).cuda(),
             "tokens_a": torch.as_tensor(r.prompt_a[None]).cuda()}
    logits_k, _ = vfl.prefill(params, cfg, batch, 4096 + 8)
    with mock.patch.object(L, "flash_attention", fa.flash_attention_plain):
        logits_p, _ = vfl.prefill(params, cfg, batch, 4096 + 8)
    torch.cuda.synchronize()
    dev = (logits_k - logits_p).abs().max().item()
    print(f"[serve] 4,096-token prefill logits, K9 against the plain "
          f"attention on the card: max |dev| {dev:.4g} (limit "
          f"{LONG_LOGIT_ATOL}; |logits| up to "
          f"{logits_p.abs().max().item():.3g}), argmax equal "
          f"{int(logits_k.argmax()) == int(logits_p.argmax())}", flush=True)
    check(math.isfinite(dev) and dev <= LONG_LOGIT_ATOL,
          f"long prefill logits deviate by {dev}")
    return counts


def _err_limit(out, ref, rel, atol):
    """-> (|out - ref|, rel |ref| + atol) per element, in fp64 when either
    is fp64, else in fp32."""
    wide = 8 in (out.element_size(), ref.element_size())
    out, ref = (x.double() if wide else x.float() for x in (out, ref))
    return (out - ref).abs(), rel * ref.abs() + atol


def _per_element(name, label, out, ref, rel, atol):
    """Hold every element of ``out`` to |out - ref| <= rel |ref| + atol;
    -> (max |err|, worst err / limit)."""
    diff, limit = _err_limit(out, ref, rel, atol)
    err = diff.max().item()
    worst = (diff / limit).max().item()
    over = int((diff > limit).sum())
    check(math.isfinite(err) and over == 0,
          f"{name} {label}: {over} elements beyond {rel:.3g} |ref| + "
          f"{atol:g} (max |err| {err}, largest |ref| "
          f"{ref.float().abs().max().item()}, worst err / limit "
          f"{worst:.3g})")
    return err, worst


def _profiled(torch, fn, reps: int = 10):
    """-> (ms on the card per call of ``fn``: its kernels' device time,
    summed by the profiler over ``reps`` calls after two more, so that the
    host's calls, which can outlast the kernels, are not timed; the names
    of the CUDA kernels it ran)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.device_time_total for e in kernels) / 1e3 / reps,
            ", ".join(sorted({e.name[:90] for e in kernels})))


def _sdpa_backend(torch, q, k, v) -> str:
    """The backend PyTorch's dispatcher picks for causal SDPA on these
    operands (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend
    choice = int(torch._fused_sdp_choice(q, k, v, is_causal=True))
    return next((name for name, b in SDPBackend.__members__.items()
                 if int(b) == choice), str(choice))


K10_OUTS = ("dk", "dv", "dq")


def _k10_name(label: str) -> str:
    """The wrapper that computes K10's output ``label``."""
    return "flash_attention_bwd_dq" if label == "dq" \
        else "flash_attention_bwd_dkv"


def _k10_operands(torch, gen, shape, dtype, kw):
    """q, k, v, do drawn from ``gen`` in ``dtype``, with the plain
    forward's lse and D = rowsum(do ∘ o): K10's operands."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
    return q, k, v, do, lse, fab.row_delta(o, do)


def _k10(args, kw, plain=False):
    """K10's kernels (or their plain versions) on ``args`` -> (dk, dv,
    dq)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    if plain:
        dk, dv = fab.flash_attention_bwd_dkv_plain(*args, **kw)
        return dk, dv, fab.flash_attention_bwd_dq_plain(*args, **kw)
    dk, dv = fab.flash_attention_bwd_dkv(*args, **kw)
    return dk, dv, fab.flash_attention_bwd_dq(*args, **kw)


def _k10_against_fp64(tag, args, kw, outs, refs) -> None:
    """Print, for K10's fp32 outputs ``outs`` on ``args``, the worst err /
    limit against the fp32 plain version (``refs``) and against the fp64
    plain version on the same inputs, and the fp32 plain version's own
    against fp64; then hold ``outs`` to the fp32 limit against fp64."""
    rel, atol = K10_REL["float32"], K10_ATOL["float32"]
    exact = _k10(tuple(t.double() for t in args), kw, plain=True)
    parts = []
    for label, got, ref, ex in zip(K10_OUTS, outs, refs, exact):
        worst = [(d / lim).max().item() for d, lim in
                 (_err_limit(got, ref, rel, atol),
                  _err_limit(got, ex, rel, atol),
                  _err_limit(ref, ex, rel, atol))]
        parts.append(f"{label} " + " / ".join(f"{w:.3g}" for w in worst))
    print(f"[kernel] K10 fp32 {tag}: worst err / limit, the kernel against "
          f"the fp32 plain version / the kernel against fp64 / the fp32 "
          f"plain version against fp64: {'; '.join(parts)}", flush=True)
    for label, got, ex in zip(K10_OUTS, outs, exact):
        _per_element(_k10_name(label), f"{tag} {label} against the fp64 "
                     f"plain version", got, ex, rel, atol)


def _k10_f32_draws(torch, shape, kw, tag) -> None:
    """K10's fp32 kernels on the draws of K10_F32_SEEDS at ``shape``,
    each held against the fp64 plain version."""
    for seed in K10_F32_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        args = _k10_operands(torch, gen, shape, torch.float32, kw)
        _k10_against_fp64(f"{tag} seed {seed}", args, kw, _k10(args, kw),
                          _k10(args, kw, plain=True))


def _k10_odd_tiles(torch, gen) -> None:
    """K10 at K10_ODD_TILES, each element within its dtype's limit: bf16
    against the plain version, fp32 against the fp64 plain version on
    five draws (see K10_ODD_TILES)."""
    for shape, dt, causal, window in K10_ODD_TILES:
        kw = dict(causal=causal, window=window)
        tag = (f"B,S,H,hd={','.join(map(str, shape))} {dt} "
               f"causal={causal} window={window}")
        args = _k10_operands(torch, gen, shape, getattr(torch, dt), kw)
        outs, refs = _k10(args, kw), _k10(args, kw, plain=True)
        if dt == "float32":
            _k10_against_fp64(tag, args, kw, outs, refs)
            _k10_f32_draws(torch, shape, kw, tag)
            continue
        worst = [_per_element(_k10_name(label), f"{tag} {label}", got, ref,
                              K10_REL[dt], K10_ATOL[dt])[1]
                 for label, got, ref in zip(K10_OUTS, outs, refs)]
        print(f"[kernel] K10 {tag}: worst err / limit dk {worst[0]:.3g}, "
              f"dv {worst[1]:.3g}, dq {worst[2]:.3g}", flush=True)


def _k9_f32_against_fp64(tag, qkv, kw, outs, refs) -> None:
    """Print, for K9-LSE's fp32 (out, lse) ``outs`` on ``qkv``, the worst
    err / limit against the fp32 plain version (``refs``) and against the
    fp64 plain version on the same inputs, and the fp32 plain version's
    own against fp64; then hold ``outs`` to their limits against fp64."""
    from repro_torch.kernels import flash_attention as fa
    exact = fa.flash_attention_fwd_lse_plain(*(t.double() for t in qkv),
                                             **kw)
    parts = []
    for (label, rel, atol), got, ref, ex in zip(K9_F32_LIMITS, outs, refs,
                                                exact):
        worst = [(d / lim).max().item() for d, lim in
                 (_err_limit(got, ref, rel, atol),
                  _err_limit(got, ex, rel, atol),
                  _err_limit(ref, ex, rel, atol))]
        parts.append(f"{label} " + " / ".join(f"{w:.3g}" for w in worst))
    print(f"[kernel] K9-LSE fp32 {tag}: worst err / limit, the kernel "
          f"against the fp32 plain version / the kernel against fp64 / the "
          f"fp32 plain version against fp64: {'; '.join(parts)}",
          flush=True)
    for (label, rel, atol), got, ex in zip(K9_F32_LIMITS, outs, exact):
        _per_element("flash_attention_fwd_lse", f"{tag} {label} against "
                     f"the fp64 plain version", got, ex, rel, atol)


def _k9_f32_draws(torch, shape, kw, tag) -> None:
    """K9-LSE's fp32 kernel on the draws of K10_F32_SEEDS at ``shape``,
    each held against the fp64 plain version."""
    from repro_torch.kernels import flash_attention as fa
    for seed in K10_F32_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        qkv = tuple(torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(3))
        _k9_f32_against_fp64(f"{tag} seed {seed}", qkv, kw,
                             fa.flash_attention_fwd_lse(*qkv, **kw),
                             fa.flash_attention_fwd_lse_plain(*qkv, **kw))


def _k9_f32_odd_tiles(torch, gen) -> None:
    """K9-LSE's fp32 kernel at the shapes of K9_ODD_TILES (S = 320):
    out and lse per element against the fp32 plain version, and on five
    draws against the fp64 plain version; out bitwise K9's."""
    from repro_torch.kernels import flash_attention as fa
    for shape, causal, window in K9_ODD_TILES:
        kw = dict(causal=causal, window=window)
        tag = (f"B,S,H,hd={','.join(map(str, shape))} float32 "
               f"causal={causal} window={window}")
        qkv = tuple(torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(3))
        outs = fa.flash_attention_fwd_lse(*qkv, **kw)
        refs = fa.flash_attention_fwd_lse_plain(*qkv, **kw)
        check(torch.equal(outs[0], fa.flash_attention(*qkv, **kw)),
              f"flash_attention_fwd_lse {tag}: the output differs from "
              f"K9's without the LSE pointer")
        worst = [_per_element("flash_attention_fwd_lse", f"{tag} {label}",
                              got, ref, rel, atol)[1]
                 for (label, rel, atol), got, ref in
                 zip(K9_F32_LIMITS, outs, refs)]
        print(f"[kernel] K9-LSE {tag}: worst err / limit out "
              f"{worst[0]:.3g}, lse {worst[1]:.3g}; out bitwise K9's",
              flush=True)
        _k9_f32_against_fp64(tag, qkv, kw, outs, refs)
        _k9_f32_draws(torch, shape, kw, tag)


def _k9_f32_tensor_cores(times) -> None:
    """K9-LSE's fp32 kernel runs on the tensor cores: the HMMA / HGMMA
    instructions in its SASS at hd 32, 64 and 128 (none fails), and at
    each fp32 case of K10_CASES its rate over the two products of its
    work and over the 12 bf16 products it issues, beside SDPA's fp32
    forward."""
    from repro_torch.kernels import flash_attention as fa
    name, (kernel, issued) = "flash_attention_fwd_lse", K9_F32_MMA
    per_hd = _mma_per_hd(name, kernel)
    print(f"[kernel] {name:30s} float32: tensor-core instructions in the "
          f"SASS of {kernel} (cuobjdump -sass) at hd 32 / 64 / 128: "
          f"{per_hd[32]} / {per_hd[64]} / {per_hd[128]}", flush=True)
    for (shape, dt, window), t in times.items():
        if dt != "float32":
            continue
        B, S, H, hd = shape
        flops = fa.flops(B, S, H, hd, True, window)
        ms, lib = t[name], t["sdpa"]
        sdpa = "none" if lib is None else (
            f"{lib * 1e3:.2f} us ({flops / lib / 1e9:.1f} TFLOP/s of the "
            f"work; kernel / SDPA {ms / lib:.3f})")
        print(f"[kernel] {name:30s} B,S,H,hd={B},{S},{H},{hd} float32 "
              f"causal window={window}: {ms * 1e3:.2f} us, the two products "
              f"of its work at {flops / ms / 1e9:.1f} TFLOP/s, the "
              f"{issued} bf16 products it issues at "
              f"{issued / 2 * flops / ms / 1e9:.1f} TFLOP/s (peak "
              f"{PEAK_BF16_FLOPS / 1e12:.0f}); SDPA's fp32 forward {sdpa}",
              flush=True)


def phase_train_kernels(torch):
    """K9-LSE and K10 (dkv, dq) against their plain versions on the card,
    each element within its own limit, and K10's fp32 kernels against the
    fp64 plain version on five draws; K9's output bitwise the same with
    and without the LSE pointer; times beside the least time, the plain
    version and SDPA (forward; backward alone)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    gen = torch.Generator(device="cuda").manual_seed(5)
    names = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
    results = {k: {"max_abs_err": 0.0, "library_ms": None} for k in names}
    times = {}
    for shape, dt, window in K10_CASES:
        B, S, H, hd = shape
        dtype = getattr(torch, dt)
        # the least time at the bf16 tensor-core peak, or for fp32 at the
        # tensor cores' fp32-accurate rate (six bf16 products each)
        peak = PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_SPLIT_FLOPS
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        kw = dict(causal=True, window=window)
        rel, atol = K10_REL[dt], K10_ATOL[dt]
        tag = f"B,S,H,hd={B},{S},{H},{hd} {dt} causal window={window}"

        # K9-LSE
        def fwd():
            return fa.flash_attention_fwd_lse(q, k, v, **kw)

        def fwd_plain():
            return fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
        (o, lse), (o_ref, lse_ref) = fwd(), fwd_plain()
        o_k9 = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(torch.equal(o, o_k9), f"flash_attention_fwd_lse {tag}: the "
              f"output differs from K9's without the LSE pointer")
        err_o, w_o = _per_element("flash_attention_fwd_lse", f"{tag} out",
                                  o, o_ref, rel, atol)
        err_l, w_l = _per_element("flash_attention_fwd_lse", f"{tag} lse",
                                  lse, lse_ref, LSE_REL, LSE_ATOL)
        err = max(err_o, err_l)
        if dt == "float32":
            _k9_f32_against_fp64(tag, (q, k, v), kw, (o, lse),
                                 (o_ref, lse_ref))
            _k9_f32_draws(torch, shape, kw, tag)

        # K10 on the plain forward's o and lse (the same inputs both ways)
        args = (q, k, v, do, lse_ref, fab.row_delta(o_ref, do))

        def dkv():
            return fab.flash_attention_bwd_dkv(*args, **kw)

        def dkv_plain():
            return fab.flash_attention_bwd_dkv_plain(*args, **kw)

        def dq():
            return fab.flash_attention_bwd_dq(*args, **kw)

        def dq_plain():
            return fab.flash_attention_bwd_dq_plain(*args, **kw)
        outs, refs = _k10(args, kw), _k10(args, kw, plain=True)
        torch.cuda.synchronize()
        # no atomics: a second run repeats every output bit for bit
        check(all(torch.equal(a, b) for a, b in zip(outs, _k10(args, kw))),
              f"K10 {tag}: a second run of the dkv and dq kernels differs "
              f"from the first")
        if dt == "float32":
            _k10_against_fp64(tag, args, kw, outs, refs)
        errs = {}
        for label, got, ref in zip(K10_OUTS, outs, refs):
            e, w = _per_element(_k10_name(label), f"{tag} {label}", got,
                                ref, rel, atol)
            errs[label] = (e, w)
            print(f"[kernel] {_k10_name(label):30s} {tag} {label}: max "
                  f"|err| {e:.3g}, worst err / limit {w:.3g} (limit "
                  f"{rel:.3g} |ref| + {atol:g}; median |ref| "
                  f"{ref.float().abs().median().item():.3g}, largest "
                  f"{ref.float().abs().max().item():.3g})", flush=True)
        if dt == "float32":
            _k10_f32_draws(torch, shape, kw, tag)
        del outs, refs
        results[names[0]]["max_abs_err"] = max(
            results[names[0]]["max_abs_err"], err)
        results[names[1]]["max_abs_err"] = max(
            results[names[1]]["max_abs_err"], errs["dk"][0], errs["dv"][0])
        results[names[2]]["max_abs_err"] = max(
            results[names[2]]["max_abs_err"], errs["dq"][0])
        print(f"[kernel] {names[0]:30s} {tag}: out max |err| {err_o:.3g} "
              f"(worst err / limit {w_o:.3g}), lse max |err| {err_l:.3g} "
              f"(worst {w_l:.3g}, limit {LSE_REL:.3g} |lse| + "
              f"{LSE_ATOL:g}); out bitwise K9's; K10 bitwise the same on a "
              f"second run", flush=True)

        # times; SDPA at the causal, unwindowed shapes (fp32 with TF32 off)
        pairs = fa.visible_pairs(S, True, window)
        esize = q.element_size()
        lse_b = 4 * B * H * S
        lib_f = lib_b = None
        if window == 0:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            do_t = do.transpose(1, 2)

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            with torch.no_grad():
                lib_f = device_ms(torch, library, 10)
                fwd_names = _profiled(torch, library)[1]
            out = library()
            # the backward alone, of a graph kept from one forward
            lib_b, bwd_names = _profiled(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), do_t, retain_graph=True))
            del out
            print(f"[kernel] F.scaled_dot_product_attention {tag}: backend "
                  f"{_sdpa_backend(torch, qt, kt, vt)}; forward "
                  f"{lib_f * 1e3:.2f} us (kernels: "
                  f"{fwd_names or 'not captured by the profiler'}); "
                  f"backward alone {lib_b * 1e3:.2f} us (kernels: "
                  f"{bwd_names or 'not captured by the profiler'})",
                  flush=True)
        t_f = _timed(torch, f"{names[0]:30s} {tag}", fwd, fwd_plain, err,
                     fa.nbytes(q, with_lse=True),
                     fa.flops(B, S, H, hd, True, window),
                     library="none" if lib_f is None else
                     f"F.scaled_dot_product_attention forward "
                     f"{lib_f * 1e3:.2f} us", peak=peak, iters=10)
        n = q.numel() * esize
        t_kv = _timed(torch, f"{names[1]:30s} {tag}", dkv, dkv_plain,
                      max(errs["dk"][0], errs["dv"][0]),
                      6 * n + 2 * lse_b, 8 * hd * H * B * pairs,
                      library="none", peak=peak, iters=10)
        t_q = _timed(torch, f"{names[2]:30s} {tag}", dq, dq_plain,
                     errs["dq"][0], 5 * n + 2 * lse_b,
                     6 * hd * H * B * pairs, library="none", peak=peak,
                     iters=10)
        times[(shape, dt, window)] = {names[0]: t_f["ms"],
                                      names[1]: t_kv["ms"],
                                      names[2]: t_q["ms"], "sdpa": lib_f}
        bwd_flops = fab.flops(B, S, H, hd, True, window)
        bwd_bound, by = bound(fab.nbytes(q), bwd_flops, peak)
        fp32_cores = "" if dt == "bfloat16" else (
            f", {bound(fab.nbytes(q), bwd_flops)[0] * 1e3:.2f} us at the "
            f"fp32 cores' {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s")
        both = t_kv["ms"] + t_q["ms"]
        print(f"[kernel] K10 (dkv + dq) {tag}: {both * 1e3:.2f} us against "
              f"the backward's bound {bwd_bound * 1e3:.2f} us ({by} at "
              f"{peak / 1e12:.1f} TFLOP/s{fp32_cores}; five products over "
              f"{pairs * B * H} visible pairs); plain "
              f"{(t_kv['plain_ms'] + t_q['plain_ms']) * 1e3:.2f} us; "
              f"SDPA backward alone: "
              f"{'none' if lib_b is None else f'{lib_b * 1e3:.2f} us'}",
              flush=True)
        if (shape, dt, window) == K10_CASES[0]:
            results[names[0]].update(t_f, library_ms=lib_f)
            # one SDPA backward computes dk, dv and dq: its time stands on
            # the dkv row only, and the dq row has no library call of its own
            results[names[1]].update(t_kv, library_ms=lib_b)
            results[names[2]].update(t_q, library_ms=None)
    _k9_f32_odd_tiles(torch, gen)
    _k10_odd_tiles(torch, gen)
    _k9_f32_tensor_cores(times)
    _k10_tensor_cores(times)
    _gate_at_llm_width(torch)
    return results


def _k10_tensor_cores(times):
    """K10's bf16 and fp32 kernels run on the tensor cores: the HMMA /
    HGMMA instructions in each one's SASS at hd 32, 64 and 128 (none
    fails), and the rates at each dtype's first shape of K10_CASES over
    the products each issues and over the backward's five-product work."""
    from repro_torch.kernels import flash_attention_bwd as fab

    for dt, kernels in (("bfloat16", K10_MMA), ("float32", K10_F32_MMA)):
        case = next(c for c in K10_CASES if c[1] == dt)
        (B, S, H, hd), _, window = case
        tag = f"B,S,H,hd={B},{S},{H},{hd} {dt} causal window={window}"

        def rate(products, ms):
            return fab.flops(B, S, H, hd, True, window, products) / ms / 1e9
        for name, (kernel, issued) in kernels.items():
            per_hd = _mma_per_hd(name, kernel)
            ms = times[case][name]
            print(f"[kernel] {name:30s} {dt}: tensor-core instructions in "
                  f"the SASS of {kernel} (cuobjdump -sass) at hd 32 / 64 / "
                  f"128: {per_hd[32]} / {per_hd[64]} / {per_hd[128]}; "
                  f"{tag}: {ms * 1e3:.2f} us, the {issued} bf16 products it "
                  f"issues at {rate(issued, ms):.1f} TFLOP/s", flush=True)
        ms = sum(times[case][name] for name in kernels)
        issued = sum(n for _, n in kernels.values())
        print(f"[kernel] K10 (dkv + dq) {dt} {tag}: {ms * 1e3:.2f} us; the "
              f"backward's five-product work at {rate(5, ms):.1f} TFLOP/s, "
              f"the {issued} bf16 products issued at "
              f"{rate(issued, ms):.1f} TFLOP/s (peak "
              f"{PEAK_BF16_FLOPS / 1e12:.0f})", flush=True)


def _gate_at_llm_width(torch):
    """K1 on its split-row path: at the training path's cut tensor (ring
    rows of S·d = 3,932,160 bf16 values, B = 2 rows, the fp32 ad-hoc row)
    and at a wide ragged row (RAGGED_GATE_SHAPE), full and weights-only,
    against its plain version (weights and cotangent within LLM_GATE_TOL),
    bitwise the same on a second run and the weights-only call's weights
    bitwise the full call's; timed beside its bound and plain version."""
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.kernels import cosine_weight as cw
    from repro_torch.kernels import fused_sample as fs

    gen = torch.Generator(device="cuda").manual_seed(7)
    cos_xi = xi_to_cos(60.0)
    for W, B, F in (LLM_GATE_SHAPE, RAGGED_GATE_SHAPE):
        a = torch.randn((B, F), generator=gen, device="cuda")
        z = torch.randn((W, B, F), generator=gen, device="cuda")
        mix = torch.tensor([0.9, -0.5, 1.5][:B], device="cuda")[:, None]
        z[1] = a * mix + 0.5 * z[1]
        # the first token's d values carry a transformer's massive
        # activations and change little between rounds: 30 times the
        # rest, and the stale z close to the ad-hoc a there, so that the
        # first chunk of a row moves its cosine by about 0.02
        a[:, :GATE_SINK] *= 30.0
        z[1, :, :GATE_SINK] = a[:, :GATE_SINK] + 0.05 * z[1, :, :GATE_SINK]
        z = z.to(torch.bfloat16)
        dz = torch.randn((W, B, F), generator=gen, device="cuda").to(
            torch.bfloat16)
        slot = torch.tensor([1], dtype=torch.int32, device="cuda")

        def kern(d=dz):
            return fs.fused_sample_2d(slot, a, z, d, cos_xi)

        def plain(d=dz):
            return fs.fused_sample_plain(slot, a, z, d, cos_xi)
        (w, cot), (w0, cot0) = kern(), plain()
        (w2, cot2), (wo, _) = kern(), kern(None)
        torch.cuda.synchronize()
        err = max((w - w0).abs().max().item(),
                  (cot - cot0).abs().max().item())
        label = f"fused_sample_2d at {(W, B, F)} bf16 ring"
        check(math.isfinite(err) and err <= LLM_GATE_TOL
              and w[1].item() == 0.0 and w[0].item() > 0.5,
              f"{label}: weights {w.tolist()} against {w0.tolist()}, max "
              f"|err| {err}")
        check(torch.equal(w, w2) and torch.equal(cot, cot2),
              f"{label}: a second run differs from the first")
        check(torch.equal(wo, w), f"{label}: the weights-only call's "
              f"weights {wo.tolist()} differ from the full call's "
              f"{w.tolist()}")
        chunks = cw.gate_chunks(B, F)
        print(f"[kernel] {label}: split-row path, {chunks} chunks a row; "
              f"max |err| {err:.3g} (limit {LLM_GATE_TOL}); bitwise the "
              f"same on a second run; weights-only weights bitwise the "
              f"full call's", flush=True)
        # ad-hoc read, the slot's z (and dz) read, w (and the cotangent)
        # written, the slot
        _timed(torch, f"{'fused_sample_2d':30s} W,B,F={W},{B},{F} bf16 ring "
               f"({chunks} chunks a row)", kern, plain, err,
               4 * B * F + 2 * 2 * B * F + 4 * B * F + 4 * B + 4, 7 * B * F,
               iters=10)
        _timed(torch, f"{'fused_sample_2d weights-only':30s} W,B,F={W},{B},"
               f"{F} bf16 ring ({chunks} chunks a row)", lambda: kern(None),
               lambda: plain(None), (wo - w0).abs().max().item(),
               4 * B * F + 2 * B * F + 4 * B + 4, 6 * B * F, iters=10)


def _pipeline_schedule(depth: int, rounds: int):
    """-> (local scans, merges) of ``rounds`` steps of
    ``engine.PipelinedEngine`` at ``depth`` and its flush, following its
    ``step`` and ``flush``: depth 0 merges, then scans; depth 1 scans,
    then merges, and the flush scans once more; depth D >= 2 scans and
    merges the oldest exchange once D are in flight, and the flush scans
    and merges until none is, then scans once more.  Every step
    dispatches one exchange; depth 0 (and ``make_round``) is ``rounds``
    of each."""
    scans = merges = pending = 0
    for _ in range(rounds):
        pending += 1
        scans += 1
        if depth <= 1 or pending == depth:
            merges += 1
            pending -= 1
    if depth == 1:
        scans += 1
    elif depth >= 2:
        scans += pending + 1
        merges += pending
    return scans, merges


def _wdl_launches(depth: int, rounds: int, n_adagrad: int) -> dict:
    """K1 and K7 launches of ``rounds`` WDL celu rounds (one feature
    party, R local updates a scan) at ``depth``: K1 once per local update
    of each party (Party B's weights-only), K7 ``n_adagrad`` launches for
    each update of both parties (``_adagrad_launches``), R a scan and one
    a merge."""
    scans, merges = _pipeline_schedule(depth, rounds)
    return {"fused_sample_2d": 2 * R * scans,
            "fused_adagrad": (R * scans + merges) * n_adagrad}


def _llm_launches(cfg, R: int, rounds: int, remat: bool, party_tensors,
                  depth: int = 0):
    """The kernels' launches over ``rounds`` celu rounds of the LLM
    split at pipeline depth ``depth``, derived from the engine's code:
    ``rounds`` exchanges, and the local scans and merges of
    :func:`_pipeline_schedule`.  Layers: Party A's La, Party B's Lb
    (bottom) and Lt (top).  Each forward through a layer runs K9-LSE
    once, each backward K10 (dkv and dq) once, and with remat each
    backward first recomputes the layer's forward (K9-LSE again):

      * exchange: A's and B's forwards; B's backward through all its
        layers (its parameters and Z); A's backward;
      * local update of A: forward, K1, backward;
      * local update of B: the ad-hoc ∇Z pass, whose backward reaches the
        top tower only (the gradient is taken with respect to Z), K1
        (weights only), then the weighted pass, whose backward reaches
        all of B's layers;
      * ``init_state`` runs A's forward once without a gradient (K9);
      * each update of a party (R a scan, one a merge) is one K7 launch
        per table of its ``party_tensors``.
    """
    La = cfg.vfl_split.layers_a
    Lb, Lt = cfg.vfl_split.layers_b, cfg.vfl_split.layers_top
    rec = int(remat)
    ex_fwd = La + (Lb + Lt) + rec * ((Lb + Lt) + La)
    ex_bwd = (Lb + Lt) + La
    loc_fwd = (La * (1 + rec) + (Lb + Lt) + rec * Lt
               + (Lb + Lt) * (1 + rec))
    loc_bwd = La + Lt + (Lb + Lt)
    scans, merges = _pipeline_schedule(depth, rounds)
    k10 = rounds * ex_bwd + scans * R * loc_bwd
    return {"flash_attention_fwd_lse": rounds * ex_fwd + scans * R * loc_fwd,
            "flash_attention_bwd_dkv": k10, "flash_attention_bwd_dq": k10,
            "flash_attention": La, "fused_sample_2d": scans * R * 2,
            "fused_adagrad": (scans * R + merges)
            * _adagrad_launches(party_tensors)}


def _capture_grads():
    """An optimizer that records the gradients it is given and applies
    zero updates."""
    from repro_torch.optim import Optimizer
    seen = []

    def update(grads, state, params=None):
        seen.append([g.detach().float() for g in grads])
        return [0.0 * g.float() for g in grads], state
    return Optimizer(lambda p: {}, update), seen


def phase_training(torch, card):
    """The LLM training path at smollm-360m's full width; -> the kernels'
    launch counts on it."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch.budget import format_budget, party_hbm_budget
    from repro_torch.launch.train import llm_params, train_llm

    cfg = get_config("smollm-360m")
    args = train_args("smollm-360m", rounds=TRAIN_ROUNDS, **TRAIN_ARGS)
    params = llm_params(cfg, args.seed, "cuda")
    n_tensors = [len(list(p.parameters())) for p in params.values()]
    check(sum(n_tensors) == 32, f"smollm-360m has {n_tensors} parameter "
          f"tensors a party, want 32 over both")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    out = train_llm(args, params=params)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {cfg.name} full width, B={args.batch_size} "
          f"S={args.seq_len} R={args.R} W={args.W} celu, {TRAIN_ROUNDS} "
          f"rounds, remat on: launches {counts}", flush=True)
    want = _llm_launches(cfg, args.R, TRAIN_ROUNDS, args.remat, n_tensors)
    _want("smollm-360m training", counts, **want)
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"training losses {losses} (a random model starts near "
          f"ln V = {math.log(cfg.vocab_size):.3f})")
    ms = [1e3 * t for t in out["round_s"]]
    budget = party_hbm_budget(cfg, batch_size=args.batch_size,
                              seq_len=args.seq_len, W=args.W)
    total = budget["hbm_total_bytes_a"] + budget["hbm_total_bytes_b"]
    print(f"[train] losses per round {losses}; ms per round "
          f"{[round(x, 3) for x in ms]} (rounds 2-{TRAIN_ROUNDS}: "
          f"{sum(ms[1:]) / len(ms[1:]):.3f} ms); card {card}", flush=True)
    print(f"[train] peak device memory {peak:,} B "
          f"(torch.cuda.max_memory_allocated) against the budget's "
          f"parameters + optimizer state + rings {total:,} B of both "
          f"parties:\n{format_budget(cfg.name, budget)}", flush=True)
    del out

    # the card's busy time per round: one more run, with the profiler on
    # for rounds 2-3 only (set-up and round 1 run before it starts)
    from repro_torch.core import engine
    rounds = 2
    prof_args = train_args("smollm-360m", rounds=1 + rounds, **TRAIN_ARGS)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    make_round = engine.make_round

    def profiled_round(*a, **kw):
        rnd, calls = make_round(*a, **kw), [0]

        def run(*ra, **rkw):
            calls[0] += 1
            if calls[0] == 2:
                torch.cuda.synchronize()
                prof.start()
            return rnd(*ra, **rkw)
        return run
    with mock.patch.object(engine, "make_round", profiled_round):
        prof_out = train_llm(prof_args, params=params)
    torch.cuda.synchronize()
    prof.stop()
    wall = sum(prof_out["round_s"][1:])
    del prof_out
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / rounds
    print(f"[train] rounds 2-{1 + rounds} of a run profiled from round 2 on "
          f"(set-up and round 1 not profiled): device busy {busy:.3f} ms per "
          f"round in {len(kernels) / rounds:.0f} kernels, "
          f"{1e3 * wall / rounds:.3f} ms per round on the host clock of the "
          f"same rounds under the profiler "
          f"({100 * busy * rounds / (1e3 * wall):.1f} % busy); card {card}",
          flush=True)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    for e in top[:10]:
        print(f"[train]   {e.self_device_time_total / 1e3 / rounds:9.3f} ms "
              f"per round  {e.count / rounds:7.1f} calls  {e.key[:70]}")
    ours = {}
    for e in top:
        m = re.search(r"(flash_\w+|cosine_gate_kernel|gate_\w+_kernel"
                      r"|fused_adagrad\w*_kernel)[<(]", e.key)
        if m and e.self_device_time_total:
            row = ours.setdefault(m.group(1), [0.0, 0.0])
            row[0] += e.self_device_time_total / 1e3 / rounds
            row[1] += e.count / rounds
    print("[train] the attention, gate and AdaGrad kernels per round: "
          + "; ".join(
        f"{k} {ms:.3f} ms in {n:.0f} launches"
        for k, (ms, n) in sorted(ours.items())), flush=True)
    del prof, params

    # one full-width train step (B = 1, S = 4,096) through K9-LSE / K10
    # against the same step through the plain attention, on the card
    _step_vs_plain(torch, cfg, 4096, "full-width")
    return {k: counts[k] for k in want}


def _plain_attention(route: str) -> list:
    """Patches that route the attention past 2,048 tokens (K9, K9-LSE,
    K10) through the plain versions; none for ``route`` "kernels"."""
    from unittest import mock

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.models import layers as L
    if route == "kernels":
        return []
    return [mock.patch.object(fab, "flash_attention_fwd_lse",
                              fa.flash_attention_fwd_lse_plain),
            mock.patch.object(fab, "flash_attention_bwd_dkv",
                              fab.flash_attention_bwd_dkv_plain),
            mock.patch.object(fab, "flash_attention_bwd_dq",
                              fab.flash_attention_bwd_dq_plain),
            mock.patch.object(L, "flash_attention", fa.flash_attention_plain)]


def _layers(cfg) -> int:
    """Attention layers of the split model (both parties)."""
    s = cfg.vfl_split
    return s.layers_a + s.layers_b + s.layers_top


def _step_vs_plain(torch, cfg, seq_len: int, label: str) -> None:
    """One ``launch/steps.py`` train step (B = 1) through K9-LSE / K10
    against the same step through the plain attention on the card: the
    loss to GRAD_LOSS_ATOL, each gradient leaf to GRAD_REL_L2 relative
    L2."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _cuda
    from repro_torch.launch import steps
    from repro_torch.models.vfl import PartyParams, init_all

    shape = ShapeConfig(f"train_{seq_len}", seq_len=seq_len, global_batch=1,
                        kind="train")
    batch = steps.concrete_batch(cfg, shape, seed=0, device="cuda")
    layers = _layers(cfg)
    grads = {}
    for route in ("kernels", "plain"):
        joint = PartyParams(init_all(1, cfg, "cuda"))
        opt, seen = _capture_grads()
        with contextlib.ExitStack() as stack:
            for patch in _plain_attention(route):
                stack.enter_context(patch)
            _cuda.reset_launches()
            _, _, loss = steps.make_train_step(cfg, opt)(joint, {}, batch)
            torch.cuda.synchronize()
        c = dict(_cuda.LAUNCHES)
        _want(f"{label} train step ({route})", c, **(
            {"flash_attention_fwd_lse": 2 * layers,
             "flash_attention_bwd_dkv": layers,
             "flash_attention_bwd_dq": layers} if route == "kernels"
            else {}))
        grads[route] = (float(loss), seen[0])
        del joint
    (lk, gk), (lp, gp) = grads["kernels"], grads["plain"]
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(gk, gp)]
    worst = max(rel)
    print(f"[train] {label} train step (B=1, S={seq_len}, hd "
          f"{cfg.head_dim}), K9-LSE / K10 against the plain attention on "
          f"the card: loss {lk:.6f} / {lp:.6f} (|dev| {abs(lk - lp):.3g}, "
          f"limit {GRAD_LOSS_ATOL}); {len(rel)} gradient leaves, relative "
          f"L2 error worst {worst:.3g} (limit {GRAD_REL_L2}), median "
          f"{sorted(rel)[len(rel) // 2]:.3g}", flush=True)
    check(math.isfinite(lk) and abs(lk - lp) <= GRAD_LOSS_ATOL,
          f"{label} train step loss {lk} against {lp}")
    check(worst <= GRAD_REL_L2, f"{label} train step gradients: relative "
          f"L2 errors {rel}")


def phase_reduced(torch, card):
    """The reduced smollm-360m (head dim 32) past 2,048 tokens: two celu
    rounds of ``train_llm`` and a train step, and the serving engine on
    3,072-token prompts, each held to the plain attention; -> the
    kernels' launch counts of the training run."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as cli
    from repro_torch.launch.train import llm_params, train_llm
    from repro_torch.models import layers as L
    from repro_torch.models import vfl
    from repro_torch.serve import LoadSpec, synth_requests

    cfg = get_config("smollm-360m").reduced()
    check(cfg.head_dim == 32, f"reduced head dim {cfg.head_dim}, want 32")
    args = train_args("smollm-360m", rounds=REDUCED_ROUNDS,
                      **REDUCED_TRAIN_ARGS)
    runs = {}
    for route in ("kernels", "plain"):
        params = llm_params(cfg, args.seed, "cuda")
        n_tensors = [len(list(p.parameters())) for p in params.values()]
        with contextlib.ExitStack() as stack:
            for patch in _plain_attention(route):
                stack.enter_context(patch)
            _cuda.reset_launches()
            out = train_llm(args, params=params)
            torch.cuda.synchronize()
        runs[route] = (out["losses"], dict(_cuda.LAUNCHES))
        del out, params
    (lk, counts), (lp, c_plain) = runs["kernels"], runs["plain"]
    want = _llm_launches(cfg, args.R, REDUCED_ROUNDS, args.remat, n_tensors)
    _want("reduced training", counts, **want)
    _want("reduced training (plain attention)", c_plain,
          **{k: v for k, v in want.items() if not k.startswith("flash")})
    dev = max(abs(a - b) for a, b in zip(lk, lp))
    print(f"[reduced] {cfg.name} (hd {cfg.head_dim}), B={args.batch_size} "
          f"S={args.seq_len} R={args.R} W={args.W} celu, {REDUCED_ROUNDS} "
          f"rounds: launches {counts}; losses {lk} against {lp} through "
          f"the plain attention (max |dev| {dev:.3g}, limit "
          f"{GRAD_LOSS_ATOL})", flush=True)
    check(all(math.isfinite(x) for x in lk) and dev <= GRAD_LOSS_ATOL,
          f"reduced training losses {lk} against {lp}")
    _step_vs_plain(torch, cfg, REDUCED_SEQ, "reduced")

    # serving: K9 in every attention layer of each prefill (warm() adds
    # one admit), the prefill's logits against the plain attention's
    params = vfl.init_all(0, cfg, "cuda")
    argv = [a for kv in REDUCED_SERVE_ARGS.items() for a in map(str, kv)]
    _cuda.reset_launches()
    comps, stats, _ = cli.serve_engine(cli.build_parser().parse_args(argv),
                                       cfg, params)
    c = dict(_cuda.LAUNCHES)
    n_req = REDUCED_SERVE_ARGS["--requests"]
    print(f"[reduced] serving {n_req} requests of {REDUCED_SEQ}-token "
          f"prompts: {stats['decode_steps']} decode steps, launches {c}",
          flush=True)
    check(len(comps) == n_req and c["flash_attention"] == _layers(cfg)
          * (n_req + 1), f"reduced serving: {len(comps)} requests done, "
          f"K9 launches {c['flash_attention']}, want "
          f"{_layers(cfg) * (n_req + 1)}")
    spec = LoadSpec(n_requests=n_req, rate=0.0, prompt_len=REDUCED_SEQ,
                    max_new_tokens=8, min_new_tokens=2, seed=0)
    r = synth_requests(spec, cfg)[0]
    batch = {"tokens": torch.as_tensor(r.prompt[None]).cuda(),
             "tokens_a": torch.as_tensor(r.prompt_a[None]).cuda()}
    logits_k, _ = vfl.prefill(params, cfg, batch, REDUCED_SEQ + 8)
    with mock.patch.object(L, "flash_attention", fa.flash_attention_plain):
        logits_p, _ = vfl.prefill(params, cfg, batch, REDUCED_SEQ + 8)
    torch.cuda.synchronize()
    dev = (logits_k - logits_p).abs().max().item()
    print(f"[reduced] {REDUCED_SEQ}-token prefill logits, K9 against the "
          f"plain attention on the card: max |dev| {dev:.4g} (limit "
          f"{LONG_LOGIT_ATOL}; |logits| up to "
          f"{logits_p.abs().max().item():.3g}); card {card}", flush=True)
    check(math.isfinite(dev) and dev <= LONG_LOGIT_ATOL,
          f"reduced prefill logits deviate by {dev}")
    return counts


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"run from a checkout of the repository: {SRC}/repro_torch "
             f"is missing")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, SRC)

    # 1. the card
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. the build
    from repro_torch.kernels import _cuda
    info = _cuda.build()
    _cuda.lib()
    print(f"[build] {info['path']} in {info['seconds']:.2f} s", flush=True)
    usage = ptxas_usage(info["log"])
    for label, (regs, st, ld) in sorted(usage.items()):
        print(f"[build] {label}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B")
    if info["log"]:
        names = [K9_MMA[0], K9_F32_MMA[0]] + [
            n for n, _ in K10_MMA.values()] + [
            n for n, _ in K10_F32_MMA.values()]
        mma = {k: u for k, u in usage.items() if k.split("<")[0] in names}
        check(len(mma) == 3 * len(names)
              and all(u[1:] == (0, 0) for u in mma.values()),
              f"the tensor-core attention kernels of K9 and K10 at hd 32 / "
              f"64 / 128: ptxas reports {mma} (registers, spill bytes), "
              f"want {3 * len(names)} and no spills")
    else:
        print("[build] the library was already built: no ptxas report")

    # 3.-5.
    t0 = time.perf_counter()
    kernels = phase_kernels(torch)
    kernels.update(phase_quant_kernels(torch))
    kernels.update(phase_adagrad_kernels(torch))
    print(f"[phase] kernels {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_goldens(torch)
    print(f"[phase] goldens {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    counts = phase_main_path(torch, card)
    print(f"[phase] main path {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pipeline_counts = phase_pipeline(torch, card)
    print(f"[phase] pipeline {time.perf_counter() - t0:.1f} s", flush=True)

    # 7.-8. serving
    t0 = time.perf_counter()
    kernels.update(phase_serve_kernels(torch))
    print(f"[phase] serving kernels {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    counts.update(phase_serving(torch, card))
    print(f"[phase] serving {time.perf_counter() - t0:.1f} s", flush=True)

    # 9.-10. training
    t0 = time.perf_counter()
    kernels.update(phase_train_kernels(torch))
    print(f"[phase] training kernels {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    counts.update(phase_training(torch, card))
    print(f"[phase] training {time.perf_counter() - t0:.1f} s", flush=True)

    # 11. the reduced model
    t0 = time.perf_counter()
    phase_reduced(torch, card)
    print(f"[phase] reduced model {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 12. results: each kernel's launches over every path that ran it
    for k, v in pipeline_counts.items():
        counts[k] = counts.get(k, 0) + v
    rows = []
    for name, (replaces, source) in KERNELS.items():
        r = kernels[name]
        check(counts.get(name, 0) > 0, f"{name} never launched on its path")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms")})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
