#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, is right and starts.

    python3 chip_smoke.py

Phases, each on its own printed lines (any failure exits non-zero):

  1. the card: name and power limit; TF32 off for matmuls and cuDNN;
  2. the build of the CUDA kernels from ``src/repro_torch/csrc`` (each
     kernel's registers, shared and local memory are phase 17's lint);
  3. each kernel against its plain PyTorch version on the card (K1 full
     and weights-only, K2a, K2b; K3 at int8 and int4 levels on fp32 and
     bf16 rows, bitwise, a second run too; K4 and K5 full and
     weights-only) at the main path's shapes, at an odd batch and narrow
     (and odd) rows, and at a wide F (the split-row path; K3 also at the
     LLM ring's (2, 61,440) and (2, 3,932,160), timed beside its bound);
     K7 and K8 bitwise at WDL-Criteo's leaf shapes, and their table
     kernels (one launch over a party's tensors: the in-place step,
     with and without the mask, and the updates) bitwise over
     WDL-Criteo's and smollm-360m's party lists and a 100-leaf ragged
     list (three launches; 1-element and unaligned leaves), bf16
     params, gradients and state included, and over granite-moe-3b-
     a800m's two party lists and xlstm-125m's Party B (55 leaves: two
     launches) at full width, each leaf in its training dtype (bf16 or
     fp32) with fp32 state; a step captured in a CUDA
     graph and replayed against eager steps; no allocation in an eager
     step; times from CUDA events beside the least time the card could
     take (the steps warm and cold, beside ``torch._fused_adagrad_``);
     the launch floor: the gate's smallest launch (K2b at one row of 8
     values) timed as the kernels are;
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
     ``train_dlrm`` at ``--pipeline-depth`` 1, 2 and 4 (20 rounds each; K1 and K7 launches against the counts derived from the schedule,
     ``_pipeline_schedule``), uniform sampling at depth 2 and DP
     (sigma 0.5) over the int8 wire (K3), each also five rounds on the
     card against the CPU; ms per round on the host clock (depths 0, 1,
     2 in turns), device busy ms per round (profiler, 8-round runs),
     the simulated WAN
     seconds against the sequential charge and the AUC; smollm-360m at
     full width through ``train_llm`` at depth 1 (3 rounds; K9-LSE, K10,
     K9, K1 and K7 launches derived by ``_llm_launches``), its losses,
     ms per round, busy ms per round and peak memory;
  7. the chaos engine (``core/faults.py``) and the round-state
     checkpoints (``checkpoint/``) at WDL-Criteo's full width: (1)
     ``ChaosEngine(plan=None)`` bitwise ``PipelinedEngine`` at depths 0,
     1 and 2 over 20 rounds; (2) the reference benchmark's fault matrix
     (``benchmarks/chaos.py``) at depth 1 over 50 rounds, its counters
     and events equal to the CPU run's, a0's parameters, K7 accumulators
     and step counter bitwise unchanged over its dropout span while Party
     B's move (K1 and K7 still launch for it, at mask and scale 0), the
     first 5 rounds card against CPU, the wire priced on a0's slow link;
     (3) a plan that drops (int8 wire, K3) at depth 2: comm_rounds ==
     merges == dispatches - drops, and a dropped exchange's recovered
     residual bitwise r' + y; (4) a checkpoint after round 7 of 12 at
     depth 2 restored into a fresh engine, the resumed run bitwise the
     uninterrupted one with every AdaGrad state tensor in its storage,
     with the fp32 ring and state, then the int4 ring (K5) and the int8
     state (K8); (5) the training CLI run whole, to a checkpoint and
     resumed, the resumed history bitwise the whole run's; every run's
     launches derived from its telemetry (``_chaos_launches``); host and
     busy ms per round of the fault matrix against plan=None, in turns;
  8. the fleet (``fleet.run_fleet``): the job-batched gate (one launch
     for N jobs, each with its own slot, rings and threshold) in every
     layout (narrow and split-row; fp32, bf16, int8 and int4 rings; full,
     weights-only, a ring shared by every job; K2a, K2b), each job bitwise
     its one-job launch and within the kernels' limit of the plain
     version, timed at N = 16 and 128 beside its bound and N one-job
     launches; a one-job vmap fleet on both goldens; map lanes bitwise
     the scalar ``PipelinedEngine``; 16 lanes of one spec bitwise each
     other; WDL-Criteo at full width over the reference benchmark's job
     grid (lr cycling, seed j, ξ 60° / 45°), 8 rounds and the drain, at
     N = 1 (bitwise the scalar run), 16 and 128 (2 rounds; depth 0) and
     16 (depth 2), lanes against their scalar runs, K1 launches derived
     from the schedule (the same at every N of a round count); a
     ``--no-cache-fusion`` and an int8-cache cohort (K2a / K2b, K3 +
     K4); job-rounds per second, busy (profiled 2-round runs at N = 1
     and 16) and host ms per fleet round against the sequential loop of
     scalar runs, in turns;
  9. the serving kernels against their plain versions: K6 and K11
     bitwise at the serving shape (W = 4 ring slots, C = 8 lanes,
     F = 960; timed beside the launch floor) and at a wide ring, K9 at
     the long-prompt shape
     (1, 4096, 15, 64) bf16, causal, with a window of 1,024, at head
     dim 128 and at the reduced model's (2, 3072, 4, 32), and K9 and
     K9-LSE at S = 320 (an odd number of 64-row tiles) at each head
     dim (causal, windowed, non-causal windowed and with no mask at
     all), each element within a bf16 ulp of its own magnitude, timed beside
     ``F.scaled_dot_product_attention``, with the rate of the two
     products of its work and of the three it issues, and the
     tensor-core instructions in the SASS of its bf16 kernel (none
     fails);
 10. the serving path: ``repro_torch.launch.serve`` at smollm-360m's
     full width (32 requests, 8 lanes, prompt 16, gen 16, closed burst)
     with the int8 ring and wire (K6 on every ring read; two runs, equal
     tokens and bitwise equal logits), the int4 ring (K11), the fp32
     ring and wire against the sequential loop (each lane's logits at
     every token against the loop's for its request, fed the same
     tokens, and ``naive_generate``), and a 4,096-token prompt (K9 in
     every attention layer of each prefill, the prefill's logits held
     against the same prefill through the plain attention); launches
     and ms per decode step;
 11. the training kernels against their plain versions: K9-LSE (the
     forward with the row log-sum-exp) and K10's dkv and dq kernels at
     (1, 4096, 15, 64) bf16, causal, with a window of 1,024, at head dim
     128 and in fp32, at the training phase's (2, 4096, 15, 64) in bf16
     and fp32, at (1, 4096, 15, 128) fp32, at the reduced model's
     (2, 3072, 4, 32) in bf16 and fp32 and at seamless-m4t-large-v2's
     decoder (2, 4096, 16, 64) bf16, K9-LSE in fp32 at S = 320 at each
     head dim (causal, windowed, non-causal windowed and with no mask)
     and K10 at S = 320 (an
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
     LLM cut tensors, smollm-360m's (2, 2, 3,932,160) on a bf16 ring and
     granite-moe-3b-a800m's (2, 2, 6,291,456) on an fp32 ring, and a
     wide ragged row (2, 3, 1,000,003), full and weights-only, against
     its plain version, bitwise the same on a second run, timed beside
     its bound;
 12. the LLM training path: ``repro_torch.launch.train`` at smollm-360m's
     full width (B = 2, S = 4,096, R = W = 2, 3 celu rounds, fp32 cache,
     AdaGrad through K7, remat on) with the exact launch counts of
     K9-LSE, K10, K9, K1 and K7 derived from the code, each round's loss,
     ms per round, the card's busy time per round (profiler, rounds 2-3
     of a second run) and the peak memory beside ``launch/budget.py``'s
     budget; then one
     ``launch/steps.py`` train step at B = 1, S = 4,096 through
     K9-LSE / K10 against the same step through the plain attention,
     loss and every gradient leaf held to a limit;
 13. the reduced smollm-360m (head dim 32) past 2,048 tokens: two celu
     rounds of ``train_llm`` at B = 2, S = 3,072 and a train step, each
     against the same run through the plain attention, and the serving
     engine on 3,072-token prompts, the prefill's logits against the
     plain attention's;
 14. the moe, hybrid and ssm / xlstm text families: granite-moe-3b-a800m
     at full width and depth trained as phase 12 trains smollm-360m
     (K9-LSE, K10, K9, K1 and K7 launches derived by ``_llm_launches``
     from each tower's attention-bearing layers and K7's 48-tensor
     tables; losses; host ms per round, busy ms and the top device ops
     of the last round; peak memory beside the budget), its B = 1 train
     step against the plain attention with each MoE layer's routing
     recorded on both routes, K9 and K9-LSE at its prefill's (1, 4096,
     24, 64) with its 8 KV heads repeated against the plain attention,
     and served (8 requests, 4 lanes,
     4,096-token prompts: K9 in all 32 layers, K3, K6; the fp32 engine's
     lanes against the sequential loop); hymba-1.5b at full widths cut
     to 8 layers (B = 1, S = 4,096) and xlstm-125m at full width and
     depth (B = 2, S = 1,024; Party B's 55 tensors take two K7 launches
     an update) trained one round each and served briefly; each
     text family's reduced config two celu rounds on the card against
     the CPU, counters exact, losses within 4e-3;
 15. the cross-attention families (vlm, audio): K9 and K9-LSE at
     seamless-m4t-large-v2's encoder prefill (1, 4096, 16, 64) with no
     mask and llama-3.2-vision-90b's decoder prefill (1, 4096, 64, 128,
     8 KV heads repeated) against the plain attention, timed beside
     SDPA; seamless-m4t-large-v2 at its published widths and depth
     trained three ``launch/steps.py`` train steps (B = 2, S = 4,096,
     AdaGrad through K7; K9-LSE, K10 and K7 launches derived by
     ``_cross_step_launches``; losses, ms a step, busy ms, peak
     memory), one B = 1 step through K9-LSE / K10 against the plain
     attention, and served through the CLI's ``serve_naive`` (4
     requests, 4,096-token prompts and frames: K9 in the encoder's 24
     layers, with no mask, and the decoder's 24); the vision config at
     full widths cut to 10 layers served (2 requests); each family's
     reduced config (and the vlm one with a cross layer a tower) one
     train step and one served request on the card against the CPU;
 16. the dry-run (``launch/dryrun.py``): (a) its CLI in subprocesses,
     on the CPU, on the reference's two integration-test triples
     (smollm-360m train_4k on the 2 x 16 x 16 mesh, xlstm-125m
     long_500k on 16 x 16), one ok line each with finite roofline
     terms; (b) its trace of the unsharded ``launch/steps.py`` train
     step (B = 2, S = 4,096, AdaGrad through K7) on fake CUDA tensors
     for smollm-360m and seamless-m4t-large-v2, the predicted peak
     device memory held to ``torch.cuda.max_memory_allocated`` of the
     same step within DRYRUN_PEAK_RTOL, the predicted compute and memory
     terms printed beside the step's measured busy ms; (c) the sharded
     train step over a one-rank NCCL mesh at smollm-360m's full width
     (B = 2, S = 4,096), its attention on the shards (K9-LSE, K10, K7
     launches derived by ``_cross_step_launches``), against the
     unsharded step (the loss to GRAD_LOSS_ATOL, each leaf's gradient
     magnitude to GRAD_REL_L2, each leaf's update (updated less
     initial) to DRYRUN_UPDATE_RTOL by relative L2);
 17. the boundary auditor (``repro_torch.analysis``) on the card: the
     library's kernels linted from ``cuobjdump -res-usage`` (one line a
     kernel: REG, SHARED, LOCAL, threads; REG <= 255 and REG x threads
     <= 65,536, the tensor-core attention kernels (K9's bf16 and fp32,
     K10's bf16 and fp32) present at hd 32, 64 and 128 with no local
     memory, so no spills; shared memory within the H100's 232,448 B a
     block), the nine
     kernel contracts (K2b, K2a, K1, K4, K5, K3, K9, K7, K8) launched at
     their audited geometries (round-default, round-wide, flash-long:
     K9 fp32 at (2, 2048, 4, 128) causal) against their plain versions,
     ``audit.route_check`` over the quick matrix (one real round of each
     case on the card: the gate of its ring, K3 where it quantises, K7),
     and the seeded-mutation self-test with the gate bypass caught on
     the card too;
 18. the examples (``examples/torch``, the twins of the reference's
     scripts): the LLM twin at its defaults (smollm-360m at full width,
     B = 2, S = 64, R = W = 3, 3 rounds, int4 ring, int8 AdaGrad state:
     K5, K3 and K8 launches derived by ``_llm_example_launches``, its
     losses, ms per round and peak memory beside its own budget line),
     the quickstart twin's seven presets cut to QUICKSTART_ROUNDS rounds
     (each preset's K1 / K4 / K3 / K7 launches by
     ``_quickstart_launches``, its AUC curve), the multiparty twin whole
     (120 rounds, K1 and K7) and the serving twin whole (K6 and K3); K5
     and K4 at the LLM twin's ring (3, 2, 61,440), full and weights-only,
     against their plain versions, timed beside the bound, and K8's step
     over smollm-360m's two party tables (cold) beside the bound;
 19. the launch-bound kernels' times beside the launch floor, a JSON line
     of per-kernel results, then the last line
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
POD_GATE_SHAPE = (5, 4096, 256)   # K2a / K2b in the pod phase's timed rounds
WIRE_SHAPE = (512, 128)           # B · z_dim = 65,536 values in 128-tiles
# K3 at the LLM ring's few wide rows (its split-row path): the LLM twin's
# cut tensor and a 4,096-token sequence's, one value a row K3_SPIKE times
# the rest (row 0's first element, the last row's last: in the first and
# the last chunk whatever the chunking), so a chunk left out moves a scale
K3_WIDE = ((2, 61_440), (2, 3_932_160))
K3_SPIKE = 30.0
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
# K3 at the serving inserts' rows, one (C, d) row a lane into the quantised
# ring (smollm-360m's d = 960, granite-moe-3b-a800m's 1,536): the narrow
# path's two sweeps, past the 512 a row it holds in registers.  A ragged
# narrow row and a ragged wide one take each path's one-element variant.
K3_SERVE = ((SERVE_RING[1], SERVE_RING[2]), (4, 1_536))
K3_RAGGED = (5, 1_001)
K3_RAGGED_WIDE = (2, 100_003)
# every (T, L) at which phase_quant_kernels holds K3 bitwise: the insert
# shape (B, F), the wire's, ragged narrow rows, the 64 rows of the LLM
# ring's check, and the rows above
K3_CHECKED = (MAIN_SHAPE[1:], WIRE_SHAPE, (37, 13), (37, 8),
              SHAPES[-1][1:], *K3_WIDE, *K3_SERVE, K3_RAGGED,
              K3_RAGGED_WIDE)
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
# kernels ask), causal, with a window of 100, and without the causal mask
# (with that window, and with no mask at all: the audio encoder's
# bidirectional attention), at each head dim: out and lse held to the
# same limits
ODD_MASKS = ((True, 0), (True, 100), (False, 100), (False, 0))
K9_ODD_TILES = [((1, 320, 2, hd), causal, window) for hd in (32, 64, 128)
                for causal, window in ODD_MASKS]
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
             ((2, 3072, 4, 32), "float32", 0),
             ((2, 4096, 16, 64), "bfloat16", 0)]
# The (2, 3072, 4, 32) cases are the reduced model's attention (head dim
# 32) past 2,048 tokens, whose ad-hoc ∇Z pass takes fp32; the
# (2, 4096, 16, 64) case is seamless-m4t-large-v2's decoder in its train
# step.  K10's bf16
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
# head dim, causal, with a window of 100, and without the causal mask
# (with that window, and with no mask at all).
# The fp32 cases are held against the fp64 plain version only (on five
# draws, the fp32 plain version's distance printed beside): on the
# smoke's draw at hd 128 with the window the fp32 plain version is itself
# past the limit against fp64 (PERF.md §7 q6).
K10_ODD_TILES = [((1, 320, 2, hd), dt, causal, window)
                 for dt in ("float32", "bfloat16") for hd in (32, 64, 128)
                 for causal, window in ODD_MASKS]
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
# K1 at the training paths' cut tensors (W, B, S·d): smollm-360m's on a
# bf16 ring and granite-moe-3b-a800m's on the fp32 ring its training
# runs, the fp32 sums of 3,932,160 and 6,291,456 products a row in other
# orders; the weights are cosines in [-1, 1] and the cotangent is |dz| <=
# ~5 times a weight.  Also at a wide ragged row (F odd: one element a
# lane), all on the split-row path.  Each with its ring's dtype and the
# model width d (the first token's d values of a row).
LLM_GATE_SHAPE = (2, 2, 4096 * 960)
GRANITE_GATE_SHAPE = (2, 2, 4096 * 1536)
RAGGED_GATE_SHAPE = (2, 3, 1_000_003)
GATE_CASES = ((LLM_GATE_SHAPE, "bf16", 960), (RAGGED_GATE_SHAPE, "bf16", 960),
              (GRANITE_GATE_SHAPE, "fp32", 1536))
LLM_GATE_TOL = 1e-4
# the training phase: smollm-360m at full width
TRAIN_ARGS = {"batch_size": 2, "seq_len": 4096, "R": 2, "W": 2}
TRAIN_ROUNDS = 3
# the pipeline phase's DP run: noise at sigma · clip on clipped rows
DP_SIGMA = 0.5
DP_CLIP = 1.0
# The pipeline phase's profiled runs (busy ms per round at depths 0-2)
# and its depth-4 run are cut short for the smoke's time limit: the
# profiler's collection is the cost of a profiled run
PIPELINE_BUSY_ROUNDS = 4
DEPTH4_ROUNDS = 20
# For the time limit (with the dry-run phase the smoke took 1,336 s on a
# slow host, PERF.md) the long WDL-Criteo runs of the main path and the
# pipeline phase take WDL_ROUNDS (50 before), their timing-only runs in
# turns TIMED_ROUNDS (20, then 6 before the audit phase came) and their
# profiled runs PROFILED_ROUNDS (20 before); every check and its derived
# count is unchanged
WDL_ROUNDS = 20
TIMED_ROUNDS = 4
PROFILED_ROUNDS = 4
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
# The families phase (the moe, hybrid and ssm / xlstm text families):
# granite-moe-3b-a800m at full width and depth trained (as the smollm-360m
# training phase: B = 2, S = 4,096, R = W = 2, 3 celu rounds, fp32 cache
# and wire, AdaGrad through K7, remat on) and served (8 requests, 4 lanes,
# 4,096-token prompts, 16 new tokens); hymba-1.5b at full widths cut to 8
# layers (2 / 4 / 2) and xlstm-125m at full width and depth, each trained
# one round and served briefly; each text family's reduced() config two
# celu rounds on the card against the same rounds on the CPU, the losses
# held to FAMILY_CPU_RTOL (the CPU tests hold the port's rounds to the
# reference's at 4e-3: tests/test_torch_families.py).
GRANITE = "granite-moe-3b-a800m"
FAMILY_ROUNDS = 3
GRANITE_SERVE_ARGS = {"--requests": 8, "--capacity": 4, "--prompt-len": 4096,
                      "--gen": 16, "--rate": 0}
HYMBA_LAYERS = 8
HYMBA_TRAIN_ARGS = {"batch_size": 1, "seq_len": 4096, "R": 2, "W": 2}
XLSTM_TRAIN_ARGS = {"batch_size": 2, "seq_len": 1024, "R": 2, "W": 2}
SHORT_ROUNDS = 2
# hymba's and xlstm's full-width rounds are host-bound (8-13 and 26-30 s
# a round): one round each, for the smoke's time limit
HOST_BOUND_ROUNDS = 1
HYMBA_SERVE_ARGS = {"--requests": 2, "--capacity": 2, "--prompt-len": 4096,
                    "--gen": 8, "--rate": 0}
XLSTM_SERVE_ARGS = {"--requests": 4, "--capacity": 2, "--prompt-len": 256,
                    "--gen": 8, "--rate": 0}
FAMILY_ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e",
                "hymba-1.5b", "xlstm-125m")
FAMILY_REDUCED_ARGS = {"batch_size": 2, "seq_len": 32, "R": 2, "W": 2,
                       "reduced": True}
FAMILY_CPU_RTOL = 4e-3
# The cross-attention phase (the vlm and audio families, slice 7d):
# seamless-m4t-large-v2 at its published widths and depth (24 encoder and
# 24 decoder layers, split 24 / 18 / 6) trained CROSS_STEPS
# ``launch/steps.py`` train steps (AdaGrad lr 0.01 through K7, fp32
# state; B = 2, S = 4,096, so 1,024 audio frames; remat on) and served
# through the CLI's ``serve_naive`` (B = 1, 4,096-token prompts and as
# many frames, so the encoder's bidirectional attention takes K9 too);
# llama-3.2-vision-90b at its full widths cut to 10 layers (one super-
# block of 4 dense + 1 cross layers a tower: ``VISION_SPLIT``) served
# only (AdaGrad would need some 88 GB); each family's reduced config, and
# the vlm one at ``VISION_X_SPLIT`` (a cross layer a tower: the reduced
# split has none), one train step and one served request on the card
# against the CPU: the step's loss and the request's loss (the mean
# negative log-probability of its greedy tokens, both sides fed the CPU's)
# held to FAMILY_CPU_RTOL relative, its greedy tokens equal wherever the
# CPU's top-1 margin passes BATCH_MARGIN.
AUDIO = "seamless-m4t-large-v2"
VISION = "llama-3.2-vision-90b"
CROSS_STEPS = 3
CROSS_TRAIN = {"batch": 2, "seq_len": 4096}
CROSS_LR = 0.01
CROSS_PEAK = 75e9                 # past it: train at B = 1 (not reached)
AUDIO_SERVE_ARGS = {"--requests": 4, "--prompt-len": 4096, "--gen": 16}
VISION_SPLIT = (0, 5, 5, "cross_attn")
VISION_SERVE_ARGS = {"--requests": 2, "--prompt-len": 4096, "--gen": 8}
VISION_X_SPLIT = (0, 2, 2, "cross_attn")
CROSS_REDUCED = ((VISION, None), (VISION, VISION_X_SPLIT), (AUDIO, None))
CROSS_REDUCED_TRAIN = {"batch": 2, "seq_len": 32}
CROSS_REDUCED_SERVE = {"prompt": 16, "gen": 6}
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
# the launch floor: K2b at one row of 8 values, and the kernels that sit
# near it at their main paths' shapes (PERF.md §6)
FLOOR_SHAPE = (1, 8)
FLOOR_KERNELS = ("cosine_weight_2d", "cosine_weights_2d", "quantize_sr_2d",
                 "fused_sample_q8_2d", "fused_sample_q4_2d",
                 "fused_dequant_q8_2d", "fused_dequant_q4_2d")
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


def sass_mma_counts(path: str) -> dict:
    """{kernel label: tensor-core instructions (HMMA, HGMMA)} in the
    SASS of the library at ``path`` (``cuobjdump -sass``)."""
    from repro_torch.analysis.kernel_lint import demangle
    from repro_torch.kernels import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        counts[demangle(name.strip())] = len(
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
    for (W, B, F) in SHAPES + [POD_GATE_SHAPE]:
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


def launch_floor(torch) -> float:
    """ms of the gate's smallest launch on the card (K2b at
    ``FLOOR_SHAPE``: one row of a few values), timed as every kernel is
    (a CUDA graph of launches, CUDA events): the floor that a kernel
    doing almost no work sits at."""
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.kernels import cosine_weight as cw
    gen = torch.Generator(device="cuda").manual_seed(9)
    a, z = (torch.randn(FLOOR_SHAPE, generator=gen, device="cuda")
            for _ in range(2))
    cos_xi = xi_to_cos(60.0)
    ms = device_ms(torch, lambda: cw.cosine_weights_2d(a, z, cos_xi))
    B, F = FLOOR_SHAPE
    bound_ms, bound_by = bound(8 * B * F + 4 * B, 6 * B * F)
    print(f"[floor] {'cosine_weights_2d':30s} B,F={B},{F}: {ms * 1e3:.2f} us "
          f"a launch on the card (bound {bound_ms * 1e3:.4f} us, "
          f"{bound_by}): the launch floor", flush=True)
    return ms


def floor_lines(kernels, floor_ms) -> None:
    """Print each launch-bound kernel's time at its main path's shape
    beside the launch floor."""
    for name in FLOOR_KERNELS:
        r = kernels[name]
        print(f"[floor] {name:22s} {r['ms'] * 1e3:7.2f} us (bound "
              f"{r['bound_ms'] * 1e3:.3f} us) = the floor "
              f"{floor_ms * 1e3:.2f} us + {(r['ms'] - floor_ms) * 1e3:.2f} "
              f"us", flush=True)


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
    card and against the CPU, and bitwise again on a second run) on fp32
    and bf16 rows, and K4 / K5 against theirs (within KERNEL_TOL, rows
    near cos ξ excluded)."""
    from repro_torch.kernels import quantize as qz

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {k: {"max_abs_err": 0.0} for k in
               ("quantize_sr_2d", "fused_sample_q8_2d", "fused_sample_q4_2d")}

    timed = (MAIN_SHAPE[1:], WIRE_SHAPE, K3_SERVE[0]) + K3_WIDE
    for (T, L) in K3_CHECKED:
        x32 = torch.randn((T, L), generator=gen, device="cuda") \
            * torch.rand((T, 1), generator=gen, device="cuda") * 10
        if (T, L) in K3_WIDE + (K3_RAGGED_WIDE,):
            spike = K3_SPIKE * x32.abs().max()
            x32[0, 0], x32[-1, -1] = spike, -spike
        else:
            x32[0] = 0.0                # an all-zero tile: the scale floor
        u = torch.rand((T, L), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for levels in (127, 7):
                q, sc = qz.quantize_sr_2d(x, u, levels)
                q2, sc2 = qz.quantize_sr_2d(x, u, levels)
                q0, sc0 = qz.quantize_sr_plain(x, u, levels)
                qc, scc = qz.quantize_sr_plain(x.cpu(), u.cpu(), levels)
                torch.cuda.synchronize()
                bad = int((q != q0).sum()) + int((q.cpu() != qc).sum())
                again = torch.equal(q, q2) and torch.equal(sc, sc2)
                check(bad == 0 and torch.equal(sc, sc0)
                      and torch.equal(sc.cpu(), scc) and again,
                      f"quantize_sr_2d at {(T, L)} {dtype} levels {levels}: "
                      f"{bad} codes differ, scales bitwise "
                      f"{torch.equal(sc, sc0)} {torch.equal(sc.cpu(), scc)},"
                      f" a second run bitwise {again}")
                label = (f"{'quantize_sr_2d':30s} T,L={T},{L} "
                         f"{str(dtype)[6:]:8s} levels {levels:3d}")
                if (T, L) in timed and levels == 127:
                    t = _timed(torch, label,
                               lambda: qz.quantize_sr_2d(x, u, levels),
                               lambda: qz.quantize_sr_plain(x, u, levels),
                               0.0, T * L * (x.element_size() + 5) + 4 * T,
                               5 * T * L)
                    if (T, L) == MAIN_SHAPE[1:] and dtype == torch.float32:
                        results["quantize_sr_2d"].update(t)
                print(f"[kernel] {label} codes equal, scales bitwise equal "
                      f"(card and CPU, and on a second run)", flush=True)

    # K4 / K5 over rings quantised as an insert quantises them
    for bits, name in ((8, "fused_sample_q8_2d"), (4, "fused_sample_q4_2d")):
        for shape in SHAPES:
            err, times = _quant_gate(torch, gen, bits, shape,
                                     ("a", "b") if shape == MAIN_SHAPE
                                     else ())
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err)
            if shape == MAIN_SHAPE:
                results[name].update(times["a"])
    return results


def _quant_gate(torch, gen, bits, shape, timed=()):
    """K4 (``bits`` 8) / K5 (4) at ``shape`` (W, B, F) over rings
    quantised as an insert quantises them, full (Party A's) and
    weights-only (Party B's: the ∇Z ring alone), each within KERNEL_TOL of
    its plain version (rows near cos ξ excluded); the cases ``timed``
    names ("a", "b") timed beside their bound.  -> (the largest error,
    {case: the timing's JSON numbers})."""
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.core.workset import pack_nibbles, sample_hbm_bytes
    from repro_torch.kernels import cosine_weight as cw
    from repro_torch.kernels import fused_sample as fs
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as qz

    name = "fused_sample_q8_2d" if bits == 8 else "fused_sample_q4_2d"
    cos_xi = xi_to_cos(60.0)
    thresh = cw.f32_threshold(cos_xi)
    slot = torch.tensor([1], dtype=torch.int32, device="cuda")
    full = ops.fused_gather_weight_q8 if bits == 8 \
        else ops.fused_gather_weight_q4
    w_only = ops.fused_gather_weights_q8 if bits == 8 \
        else ops.fused_gather_weights_q4
    W, B, F = shape

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
    worst, times = 0.0, {}
    for tag, kern, plain_fn, rows, party in cases:
        (w, cot), (w0, cot0) = kern(), plain_fn()
        torch.cuda.synchronize()
        err = (w - w0).abs()[rows].max().item()
        if cot is not None:
            err = max(err, (cot - cot0).abs()[rows].max().item())
        check(math.isfinite(err) and err <= KERNEL_TOL,
              f"{name}{tag} at {shape}: max |err| {err}")
        worst = max(worst, err)
        label = f"{name + tag:30s} W,B,F={W},{B},{F}"
        if party not in timed:
            print(f"[kernel] {label} max|err| {err:.3g}", flush=True)
            continue
        dtype = "int8" if bits == 8 else "int4"
        ex = {"z": a, "dz": a}
        if party == "a":
            nbytes = sample_hbm_bytes(ex, dtype, True, "a") + 4
        else:      # the stored dz, the ad-hoc rows, w, the slot
            nbytes = sample_hbm_bytes({"dz": a}, dtype) \
                + 4 * B * F + 4 * B + 4
        times[party] = _timed(torch, label, kern, plain_fn, err, nbytes,
                              (8 if party == "a" else 7) * B * F)
    return worst, times


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
    """{name: parameter shapes}: WDL-Criteo's Party A and B,
    smollm-360m's and the pod phase's Party B (``POD_RUN``), each in the
    reference's leaf order, and the ragged list."""
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
    from repro_torch.core import engine
    from repro_torch.core import pod_protocol as pp
    stacked = pp.stacked_wdl_init(
        torch.Generator().manual_seed(0), POD_RUN["n_fields"],
        POD_RUN["vocab"], POD_RUN["embed_dim"], POD_RUN["z_dim"],
        POD_RUN["hidden"])
    lists["pod b"] = [tuple(t.shape) for t in
                      engine._params(pp.pod_party(stacked, 1))]
    rng = np.random.default_rng(20)
    sizes = RAGGED_SIZES + [int(x) for x in rng.integers(
        1, 70_000, RAGGED_LEAVES - len(RAGGED_SIZES))]
    lists["ragged"] = [(n,) for n in sizes]
    torch.cuda.empty_cache()
    return lists


def _llm_party_leaves(arch: str) -> dict:
    """{party: [(shape, dtype)]} of ``arch``'s two parties in the
    reference's leaf order, built on the meta device."""
    from repro_torch.bridge import reference_parameters
    from repro_torch.configs import get_config
    from repro_torch.launch.budget import _param_shapes
    from repro_torch.models import vfl
    tree = _param_shapes(get_config(arch))
    return {p: [(tuple(t.shape), t.dtype) for t in reference_parameters(
        vfl.PartyParams(tree[p]))] for p in ("a", "b")}


def _family_adagrad_lists(torch) -> dict:
    """{name: [(shape, dtype)]}: granite-moe-3b-a800m's Party A and B and
    xlstm-125m's Party B (55 leaves: two K7 tables) at full width, each
    leaf with the dtype its training gives it (bf16, the router's and
    the recurrent cells' fp32 leaves fp32), in the reference's leaf
    order; built on the meta device."""
    lists = {}
    for arch, parties in ((GRANITE, "ab"), ("xlstm-125m", "b")):
        leaves = _llm_party_leaves(arch)
        for p in parties:
            lists[f"{arch} {p}"] = leaves[p]
    return lists


def _k7_operands(torch, gen, shapes, grad_dtype, state_dtype, param_dtype,
                 ragged=False):
    """Random (grads, accumulators, params) on the card; with ``ragged``
    every third leaf's operands are views one element in.  A dtype is
    one for every leaf or a list of one a leaf."""
    def make(shape, dtype, i, fill):
        x = torch.empty(shape, device="cuda")
        fill(x)
        dt = dtype[i] if isinstance(dtype, list) else dtype
        return _view(x.to(dt), int(ragged and i % 3 == 1))
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
    del ak, pk, ap, pp     # a party of granite's fills half the card
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
    kernels over WDL-Criteo's, the pod phase's Party B's and smollm-360m's
    party lists and a ragged
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
    for name in ("wdl-criteo a", "wdl-criteo b", "pod b", "ragged"):
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
    # the text families' party lists as their training runs them: each
    # grad and parameter in its leaf's dtype, fp32 state
    for name, leaves in _family_adagrad_lists(torch).items():
        shapes, dts = [s for s, _ in leaves], [d for _, d in leaves]
        ops = _k7_operands(torch, gen, shapes, dts, f32, dts)
        kinds = sorted({str(d).split(".")[-1] for d in dts})
        for scale, what in ((None, "no mask"), (mask, "mask 0.7")):
            _k7_check(torch, f"{name}, grads and params in the leaves' "
                      f"dtypes ({'/'.join(kinds)}), fp32 state, {what}",
                      ops, scale)
        del ops
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
    rounds = WDL_ROUNDS
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
    vanilla, c = _run(f"wdl-criteo vanilla {TIMED_ROUNDS} rounds",
                      train_args("wdl-criteo", protocol="vanilla",
                                 rounds=TIMED_ROUNDS))
    _want("vanilla", c, fused_adagrad=n_wdl * TIMED_ROUNDS)   # 2 a round
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
    # then back), TIMED_ROUNDS each
    routes = {"plain AdaGrad (6 launches a tensor)": {},
              "K7 (--opt-state-dtype float32)": {},
              "int8 state, K8": {"opt_state_dtype": "int8"},
              "bf16 state, K7": {"opt_state_dtype": "bfloat16"}}
    times = {k: [] for k in routes}
    for name in list(routes) + list(routes)[::-1]:
        args = train_args("wdl-criteo", rounds=TIMED_ROUNDS,
                          **routes[name])
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
    rounds = PROFILED_ROUNDS
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
    rounds = WDL_ROUNDS
    runs = {}
    for depth in (1, 2, 4):
        n = DEPTH4_ROUNDS if depth == 4 else rounds
        args = train_args("wdl-criteo", rounds=n, pipeline_depth=depth)
        runs[depth], c = _pipeline_run(
            f"wdl-criteo celu --pipeline-depth {depth}, {n} rounds",
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
        out = train_dlrm(train_args("wdl-criteo", rounds=TIMED_ROUNDS,
                                    pipeline_depth=depth))
        times[depth].append(out)
    for depth, outs in times.items():
        busy, n = _busy_ms_per_round(torch, train_args(
            "wdl-criteo", rounds=PIPELINE_BUSY_ROUNDS, pipeline_depth=depth))
        o = outs[0]
        host = " and ".join(f"{x['steady_round_ms']:.3f}" for x in outs)
        flush = " and ".join(f"{x['flush_ms']:.3f}" for x in outs)
        print(f"[time] wdl-criteo full width B=256 R=W=5 celu "
              f"--pipeline-depth {depth}: {host} ms per round (host clock, "
              f"rounds 2-{TIMED_ROUNDS} of two runs in turns; the drain "
              f"{flush} ms); "
              f"device busy {busy:.3f} ms per round over rounds "
              f"2-{PIPELINE_BUSY_ROUNDS} "
              f"({n:.0f} kernels per round, evaluation included); "
              f"simulated WAN {o['sim_wan_s']:.3f} s "
              f"against {o['sim_wan_sequential_s']:.3f} s sequential "
              f"({o['sim_wan_sequential_s'] / o['sim_wan_s']:.3f}x); AUC "
              f"{o['final_auc']:.4f} after {TIMED_ROUNDS} rounds; card "
              f"{card}",
              flush=True)
    for depth in (1, 2, 4):
        o = runs[depth]
        n = DEPTH4_ROUNDS if depth == 4 else rounds
        print(f"[time] wdl-criteo --pipeline-depth {depth}, {n} rounds: "
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


# --------------------------------------------------------------------------
# The chaos engine and the checkpoints (core/faults.py, checkpoint/)
# --------------------------------------------------------------------------
# the reference benchmark's fault matrix (benchmarks/chaos.py:44-50) over
# 50 rounds: 5% per-attempt loss with two retries, a light straggler
# tail, a0 down for 5 rounds from the middle, a0 on a 100 Mbps link with
# 20 ms legs (the link only prices the wire)
CHAOS_ROUNDS = 50
CHAOS_SPAN = (25, 5)
# the fault matrix's timing-only runs (``_chaos_times``) stop a few rounds
# after the dropout span, for the smoke's time limit
CHAOS_TIMED_ROUNDS = CHAOS_SPAN[0] + CHAOS_SPAN[1] + 2
CHAOS_MATRIX = {"fault_seed": 7, "fault_drop_prob": 0.05,
                "fault_max_retries": 2, "fault_straggler_prob": 0.1,
                "fault_straggler_rounds": 2,
                "fault_dropout": [f"a0:{CHAOS_SPAN[0]}:{CHAOS_SPAN[1]}"]}
CHAOS_LINKS = ((12.5e6, 12.5e6, 0.02),)
CHAOS_BACKOFF_S = 0.5
# a plan that really drops: no retry, depth 2, the int8 wire (K3)
DROP_FLAGS = {"fault_seed": 2, "fault_drop_prob": 0.35,
              "fault_max_retries": 0}
DROP_ROUNDS = 30
# tests/test_faults.py::test_chaos_checkpoint_resume_bit_exact's plan:
# depth 2, 12 rounds, interrupted after round 7
CKPT_FLAGS = {"fault_seed": 9, "fault_drop_prob": 0.25,
              "fault_max_retries": 1, "fault_straggler_prob": 0.3,
              "fault_straggler_rounds": 2, "fault_dropout": ["a0:5:2"]}
CKPT_ROUNDS, CKPT_CUT = 12, 7
# the CLI's three runs: one whole, one to the checkpoint, one resumed
CLI_FLAGS = ["--fault-seed", "3", "--fault-drop-prob", "0.3",
             "--fault-straggler-prob", "0.2", "--fault-dropout", "a0:10:5",
             "--pipeline-depth", "2", "--compression", "int8"]
CLI_ROUNDS, CLI_CUT = 50, 25


def _chaos_schedule(tel, rounds: int, depth: int):
    """-> (local scans, merges) of a chaos run from its telemetry
    (``ChaosEngine.telemetry()`` after the flush), following
    ``ChaosEngine.step`` and ``flush``: every round scans once; the flush
    scans and merges each exchange still in flight (one scheduler round
    each, so ``rounds`` grows by them) and then scans once more, except
    at depth 0 with nothing in flight."""
    drained = tel["rounds"] - rounds
    scans = rounds + drained + (0 if depth == 0 and not drained else 1)
    return scans, tel["merges"]


def _chaos_launches(tel, rounds: int, depth: int, n_adagrad: int, *,
                    wire_k3: int = 0, cache: str = "float32",
                    state: str = "float32") -> dict:
    """The kernels' launches of a WDL chaos run (one feature party, R
    local updates a scan), derived from its telemetry: the gate (K1 for
    fp32 / bf16 rings, K4 / K5 for int8 / int4) on each local update of
    both parties, down parties included (a zero mask); AdaGrad (K7, or K8
    for the int8 state) ``n_adagrad`` launches for each update of both
    parties, R a scan, the down party's at scale 0, and one a merge; K3
    ``wire_k3`` times a dispatch (dropped ones included: the drop comes
    after the sends) and, for a quantised ring, once for each of the four
    inserts of a merge."""
    scans, merges = _chaos_schedule(tel, rounds, depth)
    gate = {"float32": "fused_sample_2d", "bfloat16": "fused_sample_2d",
            "int8": "fused_sample_q8_2d", "int4": "fused_sample_q4_2d"}
    opt = "fused_adagrad_q8" if state == "int8" else "fused_adagrad"
    k3 = wire_k3 * tel["dispatches"] + (
        4 * merges if cache in ("int8", "int4") else 0)
    return {gate[cache]: 2 * R * scans, opt: (R * scans + merges) * n_adagrad,
            "quantize_sr_2d": k3}


def _chaos_args(device=None, rounds=CHAOS_ROUNDS, **kw):
    return train_args("wdl-criteo", rounds=rounds, device=device, **kw)


def _chaos_engine(args, *, chaos=True, uniforms=None):
    """WDL-Criteo at full width as ``train_dlrm`` sets it up, under the
    ChaosEngine of the flags' plan (``chaos``) or the plain
    ``PipelinedEngine`` -> (set-up, engine, round state, batches on the
    device)."""
    from repro_torch.core import engine
    from repro_torch.core.faults import ChaosEngine
    from repro_torch.data import synthetic as synth
    from repro_torch.data import to_device
    from repro_torch.launch.train import fault_plan, setup_dlrm
    su = setup_dlrm(args, uniforms=uniforms)
    if chaos:
        pe = ChaosEngine(su.etask, su.opt, su.celu, plan=fault_plan(args),
                         local_steps=su.n_local, transport=su.transport)
    else:
        pe = engine.make_pipeline(su.etask, su.opt, su.celu,
                                  local_steps=su.n_local,
                                  transport=su.transport)
    batches = (([to_device(ba, su.dev)], to_device(bb, su.dev), bi)
               for bi, ba, bb in synth.aligned_batches(
                   su.data["train"], args.batch_size, seed=args.seed))
    return su, pe, pe.init(su.state), batches


def _drive(pe, rs, batches, rounds, at=None):
    """``rounds`` steps -> (round state, losses as device tensors);
    ``at`` (step index -> fn(rs)) runs a hook after that step."""
    losses = []
    for i in range(rounds):
        bas, b, bi = next(batches)
        rs, m = pe.step(rs, bas, b, bi)
        losses.append(m["loss"])
        if at and i in at:
            at[i](rs)
    return rs, losses


def _floats(losses) -> list:
    return [float(x) for x in losses]


def _same_losses(a, b) -> bool:
    return len(a) == len(b) and all(
        (math.isnan(x) and math.isnan(y)) or x == y for x, y in zip(a, b))


def _state_tensors(state) -> list:
    """Every tensor of an engine state dict (parameters, optimizer
    state, rings, counters, residuals) in a fixed order."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "named_parameters"):
            out.extend(p.detach() for _, p in sorted(x.named_parameters()))
        elif hasattr(x, "tensors"):
            out.extend(x.tensors())
        elif hasattr(x, "q") and hasattr(x, "scale"):
            out.extend([x.q, x.scale])
        elif hasattr(x, "data_ptr"):
            out.append(x)
    walk({k: v for k, v in state.items() if k != "uniforms"})
    return out


def _states_equal(torch, a, b) -> bool:
    ta, tb = _state_tensors(a), _state_tensors(b)
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))


def _chaos_plan_none(torch):
    """Check 1: ``ChaosEngine(plan=None)`` is bitwise ``PipelinedEngine``
    at depths 0, 1 and 2 over 20 full-width rounds on the card: every
    loss and every state tensor."""
    for depth in (0, 1, 2):
        outs = []
        for chaos in (False, True):
            args = _chaos_args(rounds=20, pipeline_depth=depth)
            _, pe, rs, it = _chaos_engine(args, chaos=chaos)
            rs, losses = _drive(pe, rs, it, 20)
            rs, _ = pe.flush(rs)
            outs.append((_floats(losses), pe.finalize(rs)))
        same = _same_losses(outs[0][0], outs[1][0])
        state = _states_equal(torch, outs[0][1], outs[1][1])
        print(f"[chaos] plan=None at depth {depth}, 20 rounds on the card: "
              f"losses bitwise {same}, state bitwise {state}", flush=True)
        check(same and state, f"chaos plan=None at depth {depth}: not "
              f"bitwise the pipeline (losses {same}, state {state})")


def _party_snapshot(rs, i):
    """Party i's parameters, AdaGrad accumulators and step counter
    (i = -1: Party B), cloned."""
    m = rs.params["b"] if i < 0 else rs.params["a"][i]
    o = rs.opt["b"] if i < 0 else rs.opt["a"][i]
    s = rs.steps["b"] if i < 0 else rs.steps["a"][i]
    return ([p.detach().clone() for p in m.parameters()]
            + [a.clone() for a in o["accum"]] + [s.clone()])


def _chaos_wire_seconds(plan, tel, transport, z_shapes) -> float:
    """The run's wire seconds on the plan's links, as the reference's
    benchmark prices them (``benchmarks/chaos.py::_wire_seconds``):
    every attempt of every round with nobody down, with its backoff."""
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.launch.wan import (clocks_from_plan,
                                        retry_exchange_seconds,
                                        transport_party_updown)
    clocks = clocks_from_plan(plan, len(z_shapes))
    updown = transport_party_updown(transport, z_shapes)
    sched = FaultSchedule(plan)
    return sum(retry_exchange_seconds(
        clocks, updown, attempts=sched.exchange_fate(t).attempts,
        backoff_s=plan.retry_backoff_s)
        for t in range(tel["rounds"]) if not plan.down_parties(t))


def _chaos_fault_matrix(torch, card=None):
    """Check 2: the reference benchmark's fault matrix at depth 1 over 50
    rounds on the card: counters and events equal the CPU run's; a0's
    parameters, K7 accumulators and step counter unchanged over its
    dropout span while Party B's advance; the first 5 rounds' losses
    within CPU_CUDA_RTOL of the CPU's (the uniforms drawn on the CPU on
    both devices); the launches derived from the telemetry.  -> the
    launches."""
    import dataclasses as dc

    from repro_torch.core.uniforms import GeneratorUniforms
    from repro_torch.kernels import _cuda
    from repro_torch.launch.train import fault_plan
    start, span = CHAOS_SPAN
    runs = {}
    for device in ("cuda", "cpu"):
        args = _chaos_args(device, pipeline_depth=1, **CHAOS_MATRIX)
        su, pe, rs, it = _chaos_engine(
            args, uniforms=GeneratorUniforms(0, device, "cpu"))
        snaps = {}

        def snap(rs, key):
            snaps[key] = (_party_snapshot(rs, 0), _party_snapshot(rs, -1))
        _cuda.reset_launches()
        rs, losses = _drive(pe, rs, it, CHAOS_ROUNDS, at={
            start - 1: lambda rs: snap(rs, "before"),
            start + span - 1: lambda rs: snap(rs, "after")})
        rs, _ = pe.flush(rs)
        counts = dict(_cuda.LAUNCHES)
        runs[device] = (pe, _floats(losses), snaps, counts, su)
    pe, losses, snaps, counts, su = runs["cuda"]
    cpe, closses = runs["cpu"][0], runs["cpu"][1]
    tel = pe.telemetry()
    print(f"[chaos] fault matrix (benchmarks/chaos.py) at depth 1, "
          f"{CHAOS_ROUNDS} rounds: {pe.counters}; events {tel['events']}",
          flush=True)
    check(pe.counters == cpe.counters
          and tel["events"] == cpe.telemetry()["events"],
          f"chaos fault matrix: card counters {pe.counters} against the "
          f"CPU's {cpe.counters}")
    check(tel["dropout_rounds"] == span, f"chaos fault matrix: "
          f"{tel['dropout_rounds']} dropout rounds, want {span}")
    a_before, b_before = snaps["before"]
    a_after, b_after = snaps["after"]
    frozen = all(torch.equal(x, y) for x, y in zip(a_before, a_after))
    moved = not all(torch.equal(x, y) for x, y in zip(b_before, b_after))
    print(f"[chaos] a0 over its dropout span (rounds {start}-"
          f"{start + span - 1}): parameters, accumulators and step "
          f"counter bitwise unchanged {frozen}; Party B's moved {moved}",
          flush=True)
    check(frozen, "chaos fault matrix: a0's parameters, accumulators or "
          "step counter moved over its dropout span")
    check(moved, "chaos fault matrix: Party B did not step over a0's "
          "dropout span")
    devs = [abs(g - c) / abs(c) for g, c in zip(losses[:5], closses[:5])
            if not math.isnan(c)]
    nan_same = [math.isnan(x) for x in losses[:5]] == \
        [math.isnan(x) for x in closses[:5]]
    print(f"[chaos] fault matrix, first 5 rounds card against CPU: loss "
          f"rel dev {[float(f'{d:.3g}') for d in devs]} (tolerance "
          f"{CPU_CUDA_RTOL})", flush=True)
    check(nan_same and devs and max(devs) <= CPU_CUDA_RTOL,
          f"chaos fault matrix: card losses {losses[:5]} against the "
          f"CPU's {closses[:5]}")
    n = _adagrad_launches([len(list(m.parameters())) for m in
                           (su.params["a"], su.params["b"])])
    want = _chaos_launches(tel, CHAOS_ROUNDS, 1, n)
    _want("chaos fault matrix", counts, **want)
    plan = dc.replace(fault_plan(_chaos_args(**CHAOS_MATRIX)),
                      party_clocks=CHAOS_LINKS,
                      retry_backoff_s=CHAOS_BACKOFF_S)
    wire = _chaos_wire_seconds(plan, tel, su.transport,
                               [(256, su.cfg.z_dim)])
    print(f"[chaos] fault matrix sim_wan_s {wire} (every attempt on a0's "
          f"100 Mbps / 20 ms link with backoff {CHAOS_BACKOFF_S} s, "
          f"launch.wan.retry_exchange_seconds over clocks_from_plan)",
          flush=True)
    return counts


def _chaos_times(torch, card):
    """Host ms and busy ms per scheduler round of the fault matrix
    against ``plan=None`` at depth 1: each profiled once over rounds
    2-PROFILED_ROUNDS (busy; before the dropout span), then timed over
    rounds 2-CHAOS_TIMED_ROUNDS in turns (host clock; the dropout span
    included)."""
    from torch.profiler import ProfilerActivity, profile
    host = {True: [], False: []}
    busy = {}
    for chaos in (True, False, False, True, True, False):
        flags = CHAOS_MATRIX if chaos else {}
        _, pe, rs, it = _chaos_engine(_chaos_args(pipeline_depth=1,
                                                  **flags))
        rs, _ = _drive(pe, rs, it, 1)
        torch.cuda.synchronize()
        if chaos not in busy:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            with prof:
                rs, _ = _drive(pe, rs, it, PROFILED_ROUNDS - 1)
                torch.cuda.synchronize()
            kern = _kernels(torch, prof)
            busy[chaos] = (sum(e.device_time_total for e in kern) / 1e3
                           / (PROFILED_ROUNDS - 1),
                           len(kern) / (PROFILED_ROUNDS - 1))
        else:
            t0 = time.perf_counter()
            rs, _ = _drive(pe, rs, it, CHAOS_TIMED_ROUNDS - 1)
            torch.cuda.synchronize()
            host[chaos].append(1e3 * (time.perf_counter() - t0)
                               / (CHAOS_TIMED_ROUNDS - 1))
        pe.flush(rs)
    for chaos in (True, False):
        label = "fault matrix" if chaos else "plan=None"
        print(f"[time] chaos {label} at depth 1: "
              f"{' and '.join(f'{x:.3f}' for x in host[chaos])} ms per "
              f"scheduler round (host clock, rounds "
              f"2-{CHAOS_TIMED_ROUNDS} of two runs in turns); device busy "
              f"{busy[chaos][0]:.3f} ms per "
              f"round over rounds 2-{PROFILED_ROUNDS}, before the dropout "
              f"span at {CHAOS_SPAN[0]} ({busy[chaos][1]:.0f} "
              f"kernels per "
              f"round); card {card}", flush=True)


def _chaos_drop_plan(torch):
    """Check 3: a plan that drops (seed 2, p 0.35, no retry) at depth 2
    over the int8 wire (K3), 30 rounds: at least one drop, known from the
    host-side schedule before the run; after the flush comm_rounds ==
    merges == dispatches - drops; finite state; the first drop's
    recovered residual bitwise r' + y, the same add made on the CPU.
    -> the launches."""
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.kernels import _cuda
    from repro_torch.launch.train import fault_plan
    args = _chaos_args(rounds=DROP_ROUNDS, pipeline_depth=2,
                       compression="int8", **DROP_FLAGS)
    plan = fault_plan(args)
    sched = FaultSchedule(plan)
    planned = [t for t in range(DROP_ROUNDS)
               if not sched.exchange_fate(t).delivered]
    check(planned, "chaos drop plan: the schedule drops nothing")
    su, pe, rs, it = _chaos_engine(args)
    recovered = []
    recover = pe.transport.recover_dropped

    def recording(fresh):
        out = recover(fresh)
        if not recovered:
            recovered.append(({d: [r.cpu() for r in fresh["tstate"][d]]
                               for d in out}, [y.cpu() for y in fresh["zs"]],
                              [y.cpu() for y in fresh["dzs"]],
                              {d: [r.cpu() for r in out[d]] for d in out}))
        return out
    pe.transport.recover_dropped = recording
    _cuda.reset_launches()
    rs, _ = _drive(pe, rs, it, DROP_ROUNDS)
    rs, _ = pe.flush(rs)
    counts = dict(_cuda.LAUNCHES)
    state = pe.finalize(rs)
    c = pe.counters
    comm = int(state["comm_rounds"])
    print(f"[chaos] drop plan at depth 2 over the int8 wire, {DROP_ROUNDS} "
          f"rounds: drops planned at {planned}; {c}; comm_rounds {comm}",
          flush=True)
    check(c["drops"] == len(planned) and comm == c["merges"]
          == c["dispatches"] - c["drops"], f"chaos drop plan: comm_rounds "
          f"{comm}, counters {c}")
    check(all(bool(torch.isfinite(t.float()).all())
              for t in _state_tensors(state)), "chaos drop plan: a state "
          "tensor is not finite")
    check(recovered, "chaos drop plan: recover_dropped never ran")
    res, zs, dzs, out = recovered[0]
    same = all(torch.equal(out[d][i], res[d][i] + (zs if d == "up"
                                                   else dzs)[i].float())
               for d in out for i in range(len(out[d])))
    moved = any(not torch.equal(out[d][i], res[d][i])
                for d in out for i in range(len(out[d])))
    print(f"[chaos] the first drop's recovered residuals bitwise r' + y "
          f"(the add on the CPU): {same}; they differ from r': {moved}",
          flush=True)
    check(same and moved, "chaos drop plan: the recovered residual is not "
          "r' + y")
    n = _adagrad_launches([len(list(m.parameters())) for m in
                           (su.params["a"], su.params["b"])])
    _want("chaos drop plan", counts,
          **_chaos_launches(pe.telemetry(), DROP_ROUNDS, 2, n, wire_k3=2))
    return counts


def _opt_tensors(rs) -> list:
    out = []
    for o in rs.opt["a"] + [rs.opt["b"]]:
        for a in o["accum"]:
            out.extend([a.q, a.scale] if hasattr(a, "q") else [a])
    return out


def _chaos_checkpoint(torch, card=None):
    """Check 4: the plan of test_chaos_checkpoint_resume_bit_exact at
    depth 2 over the int8 wire, 12 rounds, saved after round 7 and
    restored into a fresh engine: the losses and the final state bitwise
    the uninterrupted run's, and every AdaGrad state tensor keeps its
    storage; with the fp32 ring and state, then the int4 ring (K5) and
    the int8 state (K8).  -> the uninterrupted runs' launches."""
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.kernels import _cuda
    counts = {}
    for cache, state in (("float32", "float32"), ("int4", "int8")):
        label = f"chaos checkpoint ({cache} ring, {state} AdaGrad state)"
        args = _chaos_args(rounds=CKPT_ROUNDS, pipeline_depth=2,
                           compression="int8", cache_dtype=cache,
                           opt_state_dtype=state, **CKPT_FLAGS)
        su, pe0, rs0, it0 = _chaos_engine(args)
        _cuda.reset_launches()
        rs0, l0 = _drive(pe0, rs0, it0, CKPT_ROUNDS)
        rs0, _ = pe0.flush(rs0)
        c = dict(_cuda.LAUNCHES)
        st0 = pe0.finalize(rs0)
        n = _adagrad_launches([len(list(m.parameters())) for m in
                               (su.params["a"], su.params["b"])])
        _want(label, c, **_chaos_launches(
            pe0.telemetry(), CKPT_ROUNDS, 2, n, wire_k3=2, cache=cache,
            state=state))
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

        _, pe1, rs1, it1 = _chaos_engine(args)
        rs1, l1a = _drive(pe1, rs1, it1, CKPT_CUT)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "round.npz")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save_round_state(path, rs1, extra=pe1.host_state())
            save_ms = 1e3 * (time.perf_counter() - t0)
            nbytes = os.path.getsize(path)
            n_pend = len(rs1.pending)
            del pe1, rs1
            _, pe2, rs_ref, it2 = _chaos_engine(args)
            for _ in range(n_pend):
                bas, b, bi = next(it2)
                rs_ref = pe2.dispatch(rs_ref, bas, b, bi)
            ptrs = [t.data_ptr() for t in _opt_tensors(rs_ref)]
            host = {"now": 0, "dispatch_seq": 0, "arrival": [0] * n_pend,
                    "dispatch_round": [0] * n_pend,
                    "last_merged_dispatch": 0}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                rs2, host = ckpt.restore_round_state(path, rs_ref,
                                                     extra_reference=host)
            except (KeyError, ValueError) as e:
                fail(f"chaos checkpoint: the restore failed: {e}")
            torch.cuda.synchronize()
            restore_ms = 1e3 * (time.perf_counter() - t0)
        pe2.load_host_state(host)
        kept = [t.data_ptr() for t in _opt_tensors(rs2)] == ptrs
        for _ in range(CKPT_CUT - n_pend):
            next(it2)
        rs2, l1b = _drive(pe2, rs2, it2, CKPT_ROUNDS - CKPT_CUT)
        rs2, _ = pe2.flush(rs2)
        st2 = pe2.finalize(rs2)
        same = _same_losses(_floats(l0), _floats(l1a + l1b))
        state_same = _states_equal(torch, st0, st2)
        print(f"[chaos] {label}: {n_pend} in flight at round {CKPT_CUT}; "
              f"file {nbytes} B, save {save_ms:.3f} ms, restore "
              f"{restore_ms:.3f} ms; {len(ptrs)} AdaGrad state tensors "
              f"keep their storage {kept}; resumed losses bitwise {same}, "
              f"final state bitwise {state_same}", flush=True)
        check(kept, f"chaos checkpoint: the restore moved the AdaGrad "
              f"state ({label})")
        check(same and state_same, f"chaos checkpoint: the resumed run is "
              f"not bitwise the uninterrupted one ({label}: losses {same}, "
              f"state {state_same})")
    return counts


def _chaos_cli(torch):
    """Check 5: ``python -m repro_torch.launch.train`` (its ``main``) with
    the same fault flags three times: 50 rounds; 25 rounds with a
    checkpoint at 25; 50 rounds resumed from it.  The resumed run's
    history from round 25 on and its final AUC equal the whole run's,
    bitwise; its counters cover only the rounds after the resume.  ->
    the whole run's launches, checked against the derivation."""
    import tempfile

    from repro_torch.kernels import _cuda
    from repro_torch.launch.train import main
    base = ["--arch", "wdl-criteo"] + CLI_FLAGS
    _cuda.reset_launches()
    whole = main(base + ["--rounds", str(CLI_ROUNDS)])
    counts = dict(_cuda.LAUNCHES)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cli.npz")
        first = main(base + ["--rounds", str(CLI_CUT), "--checkpoint", path,
                             "--checkpoint-every", str(CLI_CUT)])
        resumed = main(base + ["--rounds", str(CLI_ROUNDS), "--resume",
                               path])
    def rows(h):        # NaN (a starved round's loss) equal to NaN
        return [tuple("nan" if isinstance(x, float) and math.isnan(x)
                      else x for x in row) for row in h]
    tail = [h for h in whole["history"] if h[0] > CLI_CUT]
    at_cut = [h for h in whole["history"] if h[0] == CLI_CUT]
    same = (rows(resumed["history"]) == rows(tail)
            and rows(first["history"][-1:]) == rows(at_cut)
            and resumed["final_auc"] == whole["final_auc"])
    tw, tf, tr = (o["fault_telemetry"] for o in (whole, first, resumed))
    split = all(tf[k] + tr[k] == tw[k]
                for k in ("dispatches", "drops", "wire_attempts",
                          "dropout_rounds"))
    print(f"[chaos] the CLI, {' '.join(CLI_FLAGS)}: whole run AUC "
          f"{whole['final_auc']!r}, resumed at round "
          f"{resumed['start_round']} AUC {resumed['final_auc']!r}; history "
          f"from round {CLI_CUT} on bitwise {same}; counters split at the "
          f"resume {split} (whole {tw['dispatches']} dispatches, "
          f"{tw['drops']} drops; resumed {tr['dispatches']}, "
          f"{tr['drops']})", flush=True)
    check(resumed["start_round"] == CLI_CUT and same, "chaos CLI: the "
          "resumed run's history is not bitwise the whole run's")
    check(split, f"chaos CLI: counters whole {tw}, first {tf}, resumed "
          f"{tr}")
    # main() drops the state: WDL-Criteo's parties hold 7 and 13 tensors
    # (phase_main_path checks it)
    n = _adagrad_launches([7, 13])
    _want("chaos CLI", counts, **_chaos_launches(tw, CLI_ROUNDS, 2, n,
                                                 wire_k3=2))
    return counts


def phase_chaos(torch, card):
    """The chaos engine over the pipelined scheduler and the round-state
    checkpoints at WDL-Criteo's full width (B = 256, R = W = 5, ξ = 60°,
    AdaGrad lr 0.01) on the card: checks 1-5 above, each run's K1 / K7 /
    K3 / K5 / K8 launches derived from its telemetry; host and busy ms
    per round of the fault matrix against plan=None.  -> the launches."""
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    _chaos_plan_none(torch)
    add(_chaos_fault_matrix(torch, card))
    add(_chaos_drop_plan(torch))
    add(_chaos_checkpoint(torch))
    add(_chaos_cli(torch))
    _chaos_times(torch, card)
    return counts


# --------------------------------------------------------------------------
# The fleet (repro_torch.fleet)
# --------------------------------------------------------------------------
FLEET_ROUNDS = 8                  # benchmarks/fleet.py: ROUNDS
# N = 128 runs FLEET_BIG_ROUNDS, and every profiled run as many (the
# smoke's time limit: the profiler's collection is its cost; 3 before the
# audit phase came)
FLEET_BIG_ROUNDS = 2
FLEET_SIZES = (1, 16, 128)        # the reference's, less 512 (time)
FLEET_LRS = (0.05, 0.03, 0.08, 0.02)   # benchmarks/fleet.py: job_specs
FLEET_XI = (60.0, 45.0)           # two thresholds: each job its own
FLEET_GATE_JOBS = (16, 128)
# lanes of N > 1 against their scalar runs: the batched GEMMs and the
# embedding's batched scatter-add sum in another order than the scalar
# run's, and at the grid's lr (0.02-0.08) the first AdaGrad steps (±lr
# wherever a gradient is nonzero) amplify that from round 3 on (measured
# at N = 16: at most 1.4e-5 relative over rounds 1-2, 1.2e-3 at round 3,
# 5e-3 at round 4, whole percents later; one-job fleets are bitwise)
FLEET_PARITY_ROUNDS = 2
FLEET_RTOL = 1e-3
FLEET_SIDE_ROUNDS = 4             # the K2 and int8-cache cohorts
FLEET_SIDE_JOBS = 16


def _jobs_operands(torch, gen, n, shape, dtype, bits=None):
    """``n`` jobs' gate operands at (W, B, F): ad hoc (n, B, F), rings
    (n, W, B, F) whose slots lie near the ad-hoc rows at every angle (the
    jobs' cosines straddle both thresholds), slots (n, 1) and thresholds
    (n,) alternating cos 60° and cos 45°.  ``bits`` quantises the rings
    (K3's plain version): -> (q, row scales) pairs."""
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.kernels import fused_sample as fs
    from repro_torch.kernels import quantize as qz
    W, B, F = shape

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")
    a = randn(n, B, F)
    mix = torch.rand((n, W, B, 1), generator=gen, device="cuda") * 4 - 1
    z = a[:, None] * mix + randn(n, W, B, F)
    dz = randn(n, W, B, F)
    slot = torch.randint(0, W, (n, 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    thr = torch.tensor([xi_to_cos(FLEET_XI[j % 2]) for j in range(n)],
                       dtype=torch.float32, device="cuda")
    if bits is None:
        return a, z.to(dtype), dz.to(dtype), slot, thr

    def quant(x):
        rows = x.reshape(-1, F)
        q, s = qz.quantize_sr_plain(rows, torch.rand(
            rows.shape, generator=gen, device="cuda"),
            127 if bits == 8 else 7)
        q = q.reshape(x.shape)
        return (fs.pack_nibbles(q) if bits == 4 else q), s.reshape(
            x.shape[:-1])
    return a, quant(z), quant(dz), slot, thr


def _gate_cases(torch, fs, cw, n, ops, bits):
    """name -> (the op over one job's operands and threshold, the
    (args, in_dims) of its vmapped call over ``ops``, the plain version of
    one job): the layouts of the job-batched gate."""
    a, z, dz, slot, thr = ops
    if bits:
        (zq, zs), (dzq, dzs) = z, dz
        fn = fs.fused_sample_q8_2d if bits == 8 else fs.fused_sample_q4_2d
        name = fs.QUANT_NAMES[bits]
        return {
            name: (lambda s, x, q, sc, dq, dsc, t: fn(s, x, q, sc, dq, dsc,
                                                      t),
                   (slot, a, zq, zs, dzq, dzs, thr), (0,) * 7,
                   lambda j, t: fs.fused_sample_quant_plain(
                       bits, slot[j], a[j], zq[j], zs[j], dzq[j], dzs[j],
                       t)),
            f"{name} weights-only": (
                lambda s, x, q, sc, t: (fn(s, x, q, sc, None, None, t)[0],),
                (slot, a, zq, zs, thr), (0,) * 5,
                lambda j, t: fs.fused_sample_quant_plain(
                    bits, slot[j], a[j], zq[j], zs[j], None, None, t)),
        }
    z1 = z[torch.arange(n, device=z.device), slot[:, 0].long()]
    dz1 = dz[torch.arange(n, device=dz.device), slot[:, 0].long()]
    return {
        "fused_sample_2d": (
            lambda s, x, zr, dzr, t: fs.fused_sample_2d(s, x, zr, dzr, t),
            (slot, a, z, dz, thr), (0,) * 5,
            lambda j, t: fs.fused_sample_plain(slot[j], a[j], z[j], dz[j],
                                               t)),
        "fused_sample_2d weights-only": (
            lambda s, x, zr, t: (fs.fused_sample_2d(s, x, zr, None, t)[0],),
            (slot, a, z, thr), (0,) * 4,
            lambda j, t: fs.fused_sample_plain(slot[j], a[j], z[j], None,
                                               t)),
        "fused_sample_2d shared ring": (
            lambda s, x, zr, dzr, t: fs.fused_sample_2d(s, x, zr, dzr, t),
            (slot, a, z[0], dz[0], thr), (0, 0, None, None, 0),
            lambda j, t: fs.fused_sample_plain(slot[j], a[j], z[0], dz[0],
                                               t)),
        "cosine_weight_2d": (
            lambda x, s, d, t: cw.cosine_weight_2d(x, s, d, t),
            (a, z1.contiguous(), dz1.contiguous(), thr), (0,) * 4,
            lambda j, t: cw.cosine_weight_plain(a[j], z1[j], dz1[j], t)),
        "cosine_weights_2d": (
            lambda x, s, t: (cw.cosine_weights_2d(x, s, t),),
            (a, z1.contiguous(), thr), (0,) * 3,
            lambda j, t: (cw.cosine_weights_plain(a[j], z1[j], t), None)),
    }


def _fleet_gate_kernels(torch):
    """The job-batched gate (one launch for n jobs, each with its own
    slot, threshold and rings) in every layout: the narrow and the
    split-row paths, fp32 / bf16 / int8 / int4 rings, K1 full,
    weights-only and over a ring vmap left unbatched (job stride 0), K2a
    and K2b.  Each is bitwise n one-job launches of the same kernel and
    within K1's limit of its plain version; each kernel's full gate is
    timed at (n, W, B, F) = (16 | 128, 5, 256, 256) beside its bytes
    bound and n one-job launches.  -> the timings."""
    from torch.func import vmap

    from repro_torch.kernels import _cuda
    from repro_torch.kernels import cosine_weight as cw
    from repro_torch.kernels import fused_sample as fs
    gen = torch.Generator(device="cuda").manual_seed(23)
    layouts = [(4, MAIN_SHAPE, torch.float32, None),
               (3, (2, 37, 13), torch.float32, None),
               (4, MAIN_SHAPE, torch.bfloat16, None),
               (3, (2, 2, 64 * 960), torch.float32, None),    # split rows
               (4, MAIN_SHAPE, None, 8), (4, MAIN_SHAPE, None, 4),
               (3, (2, 2, 64 * 960), None, 8)]
    for n, shape, dtype, bits in layouts:
        W, B, F = shape
        path = "split-row" if cw.gate_chunks(B, F) > 1 else "narrow"
        ops = _jobs_operands(torch, gen, n, shape, dtype, bits)
        thr = ops[-1]
        for name, (one, args, dims, plain) in _gate_cases(
                torch, fs, cw, n, ops, bits).items():
            key = name.split()[0]
            before = _cuda.LAUNCHES[key]
            got = vmap(one, in_dims=dims)(*args)
            check(_cuda.LAUNCHES[key] == before + 1,
                  f"fleet gate {name}: {_cuda.LAUNCHES[key] - before} "
                  f"launches for {n} jobs, want 1")
            err = 0.0
            for j in range(n):
                sub = [x[j] if d == 0 else x for x, d in zip(args, dims)]
                t = float(thr[j])
                want = one(*sub[:-1], t)
                want = want if isinstance(want, tuple) else (want,)
                for g, w in zip(got, want):
                    check(torch.equal(g[j], w), f"fleet gate {name} "
                          f"{path} {shape} {dtype or bits}: job {j} of the "
                          f"batched launch is not bitwise its one-job launch")
                w0, c0 = plain(j, t)
                # rows this close to the job's threshold may flip
                keep = (plain(j, -2.0)[0] - t).abs() > NEAR
                err = max(err, (got[0][j] - w0).abs()[keep].max().item())
                if c0 is not None and len(got) > 1:
                    err = max(err, (got[1][j] - c0).abs()[keep].max().item())
            check(math.isfinite(err) and err <= KERNEL_TOL,
                  f"fleet gate {name} {shape}: max |err| {err} against the "
                  f"plain version")
            print(f"[fleet] gate {name:30s} n={n} W,B,F={W},{B},{F} "
                  f"{'int%d' % bits if bits else str(dtype)[6:]:8s} "
                  f"({path}): one launch, bitwise {n} one-job launches, "
                  f"max|err| {err:.3g} against the plain version",
                  flush=True)
    # times at the main path's shape: the full gate of each kernel (K1,
    # K2a, K2b, K4, K5), one batched launch against n one-job launches
    W, B, F = MAIN_SHAPE
    per_job = {      # bytes a job: ad hoc read, w written, stale rows read,
        # cot written, the slot and the threshold
        "fused_sample_2d": 4 * B * F + 4 * B + 2 * 4 * B * F + 4 * B * F + 8,
        "cosine_weight_2d": 4 * B * F + 4 * B + 2 * 4 * B * F + 4 * B * F + 4,
        "cosine_weights_2d": 4 * B * F + 4 * B + 4 * B * F + 4,
        "fused_sample_q8_2d": 4 * B * F + 4 * B + 2 * (B * F + 4 * B)
        + 4 * B * F + 8,
        "fused_sample_q4_2d": 4 * B * F + 4 * B + 2 * (B * F // 2 + 4 * B)
        + 4 * B * F + 8,
    }
    times = {}
    for n in FLEET_GATE_JOBS:
        cases = {}
        for bits in (None, 8, 4):
            ops = _jobs_operands(torch, gen, n, MAIN_SHAPE, torch.float32,
                                 bits)
            cases.update({k: (v, ops[-1]) for k, v in _gate_cases(
                torch, fs, cw, n, ops, bits).items() if k in per_job})
        for name, ((one, args, dims, _), thr) in cases.items():
            ts = [float(x) for x in thr]
            subs = [[x[j] if d == 0 else x for x, d in zip(args, dims)][:-1]
                    for j in range(n)]
            ms = device_ms(torch, lambda: vmap(one, in_dims=dims)(*args), 20)
            loop_ms = device_ms(torch, lambda: [one(*s, t) for s, t in
                                                zip(subs, ts)], 2)
            call = call_ms(torch, lambda: vmap(one, in_dims=dims)(*args), 50)
            nbytes = n * per_job[name]
            flops = n * (6 if name == "cosine_weights_2d" else 7) * B * F
            bound_ms, bound_by = bound(nbytes, flops)
            times[(name, n)] = {"ms": ms, "loop_ms": loop_ms,
                                "bound_ms": bound_ms}
            print(f"[fleet] gate {name:18s} n={n} W,B,F={W},{B},{F}: "
                  f"device: one launch {ms * 1e3:.2f} us, {n} one-job "
                  f"launches {loop_ms * 1e3:.2f} us, bound "
                  f"{bound_ms * 1e3:.3f} us ({bound_by}, {nbytes} B; "
                  f"{bound_ms / ms:.0%} of the bound rate); per call from "
                  f"Python {call * 1e3:.2f} us", flush=True)
    return times


def _fleet_workload(torch, device="cuda"):
    """WDL-Criteo at full width (B = 256) as ``train_dlrm`` sets it up, as
    a fleet workload: job ``seed``'s parameters from the port's own
    initialisers (``wdl_init(seed)``) -> (workload, celu config, R)."""
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.data import synthetic as synth
    from repro_torch.fleet import FleetWorkload
    from repro_torch.launch.train import celu_config
    from repro_torch.models.tabular import make_dlrm
    args = train_args("wdl-criteo", device=device)
    cfg = get_config("wdl-criteo")
    spec = dataclasses.replace(synth.TABULAR_SPECS["criteo"],
                               vocab=cfg.vocab, n_train=args.n_train,
                               n_test=args.n_test)
    data = synth.make_tabular(spec, seed=0)
    init_fn, task, _ = make_dlrm(cfg)

    def params_for(seed):
        return engine.lift_two_party_params(init_fn(seed, cfg, device))

    def batch_stream():
        for bi, ba, bb in synth.aligned_batches(data["train"],
                                                args.batch_size, seed=0):
            yield bi, [ba], bb
    ccfg, nloc = engine.preset_config("celu", celu_config(args))
    return FleetWorkload(engine.lift_two_party(task), params_for,
                         batch_stream), ccfg, nloc


def _fleet_specs(celu, nloc, n, depth=0):
    """The reference benchmark's job grid (lr cycling, seed j) with ξ
    alternating 60° and 45°."""
    from repro_torch.fleet import JobSpec
    return [JobSpec(celu=celu, local_steps=nloc, lr=FLEET_LRS[j % 4],
                    seed=j, xi_degrees=FLEET_XI[j % 2], depth=depth)
            for j in range(n)]


def _fleet_scalar(torch, wl, spec, rounds):
    """Job ``spec`` through the scalar ``PipelinedEngine`` (the plain
    AdaGrad route, the job's uniform source as the fleet makes it) ->
    (its rows' metrics (device tensors), flush metrics, final state,
    seconds of its rounds and flush on the host clock, set-up left
    out)."""
    from repro_torch.core import engine
    from repro_torch.core.uniforms import GeneratorUniforms
    from repro_torch.data import to_device
    from repro_torch.fleet import JobUniforms
    from repro_torch.optim import make_optimizer
    celu = dataclasses.replace(spec.celu, xi_degrees=spec.resolved_xi())
    opt = make_optimizer(spec.optimizer, spec.lr)
    it = wl.batch_stream()
    _, ba, bb = next(it)
    state = engine.init_state(
        wl.task, wl.params_for(spec.seed), opt, celu,
        [to_device(b, "cuda") for b in ba], to_device(bb, "cuda"),
        uniforms=JobUniforms(GeneratorUniforms(spec.seed, "cuda"),
                             spec.seed))
    pe = engine.make_pipeline(wl.task, opt, celu,
                              depth=spec.resolved_depth(),
                              local_steps=spec.local_steps)
    rs = pe.init(state)
    rows = []
    it = wl.batch_stream()
    batches = [next(it) for _ in range(rounds)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bi, ba, bb in batches:
        rs, m = pe.step(rs, [to_device(b, "cuda") for b in ba],
                        to_device(bb, "cuda"), bi)
        rows.append(m)
    rs, fm = pe.flush(rs)
    torch.cuda.synchronize()
    return rows, fm, pe.finalize(rs), time.perf_counter() - t0


def _fleet_goldens(torch):
    """A one-job vmap fleet replays the two-party (celu) and the
    three-party goldens on the card within the tests' tolerance."""
    from repro_torch import golden
    from repro_torch.bridge import load_flat, subtree
    from repro_torch.configs.base import CELUConfig
    from repro_torch.core import engine
    from repro_torch.data.synthetic import (TabularSpec, aligned_batches,
                                            make_tabular)
    from repro_torch.fleet import FleetWorkload, JobSpec, run_fleet
    from repro_torch.models.tabular import (MLP, PartyA, WDLPartyB,
                                            make_dlrm)
    flat = golden.load_params(GOLDEN_DIR)
    cfg = golden.TWO_PARTY_CFG
    data = make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=2048, n_test=512), 0)
    init_fn, task, _ = make_dlrm(cfg)

    def two(seed):
        p = init_fn(0, cfg, "cuda")
        load_flat(p["a"], subtree(flat, "two_party.a"))
        load_flat(p["b"], subtree(flat, "two_party.b"))
        return engine.lift_two_party_params(p)

    def two_stream():
        for bi, ba, bb in aligned_batches(data["train"], 64, seed=0):
            yield bi, [ba], bb
    data3 = make_tabular(TabularSpec("t", fields_a=8, fields_b=4, vocab=64,
                                     n_train=4096, n_test=512), seed=0)

    def three(seed):
        gen = torch.Generator().manual_seed(0)
        pas = [PartyA(golden.THREE_PARTY_CFG, gen) for _ in range(2)]
        pb = WDLPartyB(golden.THREE_PARTY_CFG, gen)
        pb.top = MLP(golden.THREE_PARTY_TOP, gen)
        for i, pa in enumerate(pas):
            load_flat(pa, subtree(flat, f"three_party.a{i}"))
        load_flat(pb, subtree(flat, "three_party.b"))
        return {"a": pas, "b": pb}

    def three_stream():
        for bi, ba, bb in aligned_batches(data3["train"], 64, seed=0):
            yield bi, [{"x_a": ba["x_a"][:, :4]},
                       {"x_a": ba["x_a"][:, 4:]}], bb
    runs = [("two-party celu", FleetWorkload(engine.lift_two_party(task),
                                             two, two_stream),
             JobSpec(celu=CELUConfig(R=3, W=3, xi_degrees=60.0)),
             "two_party_trace.json", False),
            ("three-party celu", FleetWorkload(golden.three_party_task(),
                                               three, three_stream),
             JobSpec(celu=CELUConfig(R=2, W=2, xi_degrees=60.0), lr=0.02),
             "three_party_trace.json", True)]
    for label, wl, spec, name, k3 in runs:
        res = run_fleet([spec], 20, workload=wl, mode="vmap")
        rows = [{"loss": float(res.losses[0, t]),
                 "w_mean": float(res.w_mean[0, t]),
                 "w_zero_frac": float(res.w_zero_frac[0, t]),
                 "local_steps": int(res.local_steps[0, t])}
                for t in range(20)]
        rows.append({"steps_a": res.steps_a[0] if k3 else res.steps_a[0][0],
                     "steps_b": int(res.steps_b[0]),
                     "comm_rounds": int(res.comm_rounds[0])})
        dev = golden.compare(rows, golden.load_golden(GOLDEN_DIR,
                                                      name)["celu"])
        print(f"[fleet] one-job vmap fleet, {label} golden on the card: "
              f"{dev}", flush=True)
        check(golden.within_tolerance(dev), f"fleet {label} golden {dev}")


def _fleet_bitwise(res, j, scalar, label) -> None:
    """Job ``j`` of a fleet is bitwise the scalar run of its job: every
    row, the flush's w_mean, the counters and the final parameters."""
    import numpy as np

    from repro_torch.core import engine
    rows, fm, fin, _ = scalar
    got = np.stack([res.losses[j], res.w_mean[j], res.w_zero_frac[j]])
    want = np.stack([[float(m[k]) for m in rows]
                     for k in ("loss", "w_mean", "w_zero_frac")])
    want_p = [p.detach().cpu().numpy() for m in fin["params"]["a"]
              + [fin["params"]["b"]] for p in engine._params(m)]
    got_p = [p for ps in res.final_state(j)["params"]["a"] for p in ps] \
        + res.final_state(j)["params"]["b"]
    check(np.array_equal(got, want, equal_nan=True)
          and [int(m["local_steps"]) for m in rows]
          == res.local_steps[j].tolist()
          and np.float32(res.flush_metrics["w_mean"][j])
          == np.float32(float(fm["w_mean"]))
          and int(res.comm_rounds[j]) == int(fin["comm_rounds"])
          and int(res.steps_b[j]) == int(fin["steps"]["b"])
          and all(np.array_equal(a, b) for a, b in zip(got_p, want_p,
                                                       strict=True)),
          f"{label}: job {j} is not bitwise the scalar run of its job")


def _fleet_map_bitwise(torch, wl, celu, nloc):
    """``mode="map"`` lanes (two jobs, depth 2) bitwise the scalar
    ``PipelinedEngine`` runs of their jobs.  -> the launches of the map
    run."""
    from repro_torch.fleet import run_fleet
    from repro_torch.kernels import _cuda
    specs = _fleet_specs(celu, nloc, 2, depth=2)
    _cuda.reset_launches()
    res = run_fleet(specs, FLEET_SIDE_ROUNDS, workload=wl, mode="map")
    counts = dict(_cuda.LAUNCHES)
    scans, _ = _pipeline_schedule(2, FLEET_SIDE_ROUNDS)
    _want("fleet map, 2 jobs at depth 2", counts,
          fused_sample_2d=2 * 2 * R * scans)
    for j, spec in enumerate(specs):
        _fleet_bitwise(res, j, _fleet_scalar(torch, wl, spec,
                                             FLEET_SIDE_ROUNDS),
                       "fleet map")
    print(f"[fleet] map mode, 2 jobs at depth 2, {FLEET_SIDE_ROUNDS} "
          f"rounds: each lane bitwise its scalar PipelinedEngine run "
          f"(rows, flush metrics, counters, parameters); K1 launches "
          f"{counts['fused_sample_2d']} (twice one job's)", flush=True)
    return counts


def _fleet_vmap_run(torch, wl, specs, rounds, label, profile_it=False):
    """One vmap fleet run with the launch counts set to 0 just before,
    the K1 count checked against the schedule (independent of the fleet
    size).  -> (result, counts, busy ms and kernels per fleet round or
    None)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fleet import run_fleet
    from repro_torch.kernels import _cuda
    depth = specs[0].resolved_depth()
    _cuda.reset_launches()
    if profile_it:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = run_fleet(specs, rounds, workload=wl, mode="vmap")
            torch.cuda.synchronize()
        kern = _kernels(torch, prof)
        busy = (sum(e.device_time_total for e in kern) / 1e3 / rounds,
                len(kern) / rounds)
    else:
        res = run_fleet(specs, rounds, workload=wl, mode="vmap")
        busy = None
    counts = dict(_cuda.LAUNCHES)
    check(np.isfinite(res.losses[:, depth and depth - 1:]).all(),
          f"{label}: losses not finite")
    return res, counts, busy


def _fleet_lanes_alike(torch, wl, celu, nloc):
    """Sixteen lanes of one spec under vmap are bitwise each other (rows
    and final parameters).  -> the run's launches."""
    import numpy as np

    from repro_torch.fleet import JobSpec
    specs = [JobSpec(celu=celu, local_steps=nloc, lr=FLEET_LRS[0],
                     seed=3)] * 16
    res, c, _ = _fleet_vmap_run(torch, wl, specs, FLEET_SIDE_ROUNDS,
                                "fleet vmap, 16 lanes of one spec")
    p0 = res.final_state(0)["params"]
    alike = all(
        np.array_equal(res.losses[j], res.losses[0])
        and np.array_equal(res.w_mean[j], res.w_mean[0])
        and all(np.array_equal(a, b) for a, b in zip(
            p0["a"][0] + p0["b"], res.final_state(j)["params"]["a"][0]
            + res.final_state(j)["params"]["b"]))
        for j in range(16))
    check(alike, "fleet vmap: lanes of one spec differ")
    print(f"[fleet] vmap, 16 lanes of one spec, {FLEET_SIDE_ROUNDS} rounds: "
          f"bitwise each other (rows and final parameters)", flush=True)
    return c


def _fleet_parity(torch, res, scalar, label):
    """Lane j of a vmap fleet against the scalar run of job j: counters
    exact over all rounds, loss (relative) and w_mean (absolute) within
    FLEET_RTOL over the first FLEET_PARITY_ROUNDS rounds (every round's
    largest deviations printed).  -> the largest held deviation."""
    per_round = [(0.0, 0.0)] * FLEET_ROUNDS
    for j, (rows, fm, fin, _) in enumerate(scalar):
        check([int(m["local_steps"]) for m in rows]
              == res.local_steps[j].tolist()
              and int(res.comm_rounds[j]) == int(fin["comm_rounds"])
              and int(res.steps_b[j]) == int(fin["steps"]["b"])
              and res.steps_a[j] == [int(s) for s in fin["steps"]["a"]],
              f"{label} lane {j}: counters differ from the scalar run")
        for t, m in enumerate(rows):
            want, got = float(m["loss"]), float(res.losses[j, t])
            if math.isnan(want):
                check(math.isnan(got), f"{label} lane {j}: warm-up row")
                continue
            dl = abs(got - want) / abs(want)
            dw = abs(float(res.w_mean[j, t]) - float(m["w_mean"]))
            per_round[t] = (max(per_round[t][0], dl),
                            max(per_round[t][1], dw))
    per_round = per_round[:len(scalar[0][0])]
    shown = [(float(f"{a:.3g}"), float(f"{b:.3g}")) for a, b in per_round]
    print(f"[fleet] {label}: lanes against their scalar runs, largest "
          f"(loss rel, w_mean abs) per round: {shown} (held to "
          f"{FLEET_RTOL} over rounds 1-{FLEET_PARITY_ROUNDS}); counters "
          f"exact", flush=True)
    worst = max(max(r) for r in per_round[:FLEET_PARITY_ROUNDS])
    check(worst <= FLEET_RTOL,
          f"{label}: lanes {shown} from their scalar runs")
    return worst


def phase_fleet(torch, card):
    """The fleet (``repro_torch.fleet.run_fleet``) on the card: the
    job-batched gate in every layout; the goldens through a one-job vmap
    fleet; map lanes bitwise the scalar engine; WDL-Criteo at full width
    (B = 256, R = W = 5, fp32 cache and wire) over the reference
    benchmark's job grid, 8 rounds and the drain, at N = 1, 16 and 128
    (FLEET_BIG_ROUNDS rounds; depth 0) and N = 16 at depth 2, each lane
    of N = 16 against its scalar run, K1 launches per fleet round derived
    from the schedule (the same at every N); a ``--no-cache-fusion``
    cohort (K2a / K2b) and an int8-cache cohort (K3 + K4); job-rounds per
    second, busy (a profiled FLEET_BIG_ROUNDS-round run at N = 1 and 16)
    and host ms per fleet round against the sequential loop of scalar
    runs, in turns.  -> the launches of the phase's runs."""
    counts = {}
    t0 = time.perf_counter()

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    def lap(label):
        print(f"[fleet] {label}: done at {time.perf_counter() - t0:.1f} s "
              f"into the phase", flush=True)
    _fleet_gate_kernels(torch)
    lap("the job-batched gate")
    _fleet_goldens(torch)
    wl, celu, nloc = _fleet_workload(torch)
    add(_fleet_map_bitwise(torch, wl, celu, nloc))
    add(_fleet_lanes_alike(torch, wl, celu, nloc))
    lap("goldens, map lanes, lanes of one spec")

    # the sequential loop over the first 16 jobs: the lanes' reference
    # and the baseline's time (its first round untimed: the warm-up)
    specs16 = _fleet_specs(celu, nloc, 16)
    _fleet_scalar(torch, wl, specs16[0], 1)
    scalar16 = [_fleet_scalar(torch, wl, s, FLEET_ROUNDS) for s in specs16]
    seq_s = [sum(r[3] for r in scalar16)]
    lap("the sequential loop")

    results = {}
    for n, depth in [(1, 0), (16, 0), (128, 0), (16, 2)]:
        specs = _fleet_specs(celu, nloc, n, depth)
        label = f"fleet vmap N={n} depth {depth}"
        rounds = FLEET_BIG_ROUNDS if n == 128 else FLEET_ROUNDS
        res, c, _ = _fleet_vmap_run(torch, wl, specs, rounds, label)
        scans, _ = _pipeline_schedule(depth, rounds)
        _want(label, c, fused_sample_2d=2 * R * scans)
        add(c)
        k1 = c["fused_sample_2d"]
        if n == 1:
            _fleet_bitwise(res, 0, scalar16[0], label)
            print(f"[fleet] {label}: bitwise the scalar PipelinedEngine "
                  f"run of its job (rows, counters, parameters)",
                  flush=True)
        if n == 16 and depth == 0:
            _fleet_parity(torch, res, scalar16, label)
        if n == 16 and depth == 2:
            _fleet_parity(torch, res, [_fleet_scalar(
                torch, wl, s, FLEET_ROUNDS) for s in specs[:2]], label)
        busy = None
        # the profiled run: busy ms, kernels a round (timing only, so not
        # at N = 128, for the time limit: PERF.md keeps its earlier figure)
        if depth == 0 and n < 128:
            _, c, busy = _fleet_vmap_run(torch, wl, specs,
                                         FLEET_BIG_ROUNDS, label,
                                         profile_it=True)
            add(c)
        results[(n, depth)] = {"host": [res.wall_s], "busy": busy,
                               "compile_s": res.compile_s,
                               "rounds": rounds}
        print(f"[fleet] {label}: K1 launches {k1} "
              f"(schedule: {2 * R * scans}, at every N); compile "
              f"{res.compile_s:.2f} s", flush=True)
        lap(label)

    # times in turns: the sequential loop, the fleets above, then the
    # sequential loop and N = 16 once more
    seq_s.append(sum(_fleet_scalar(torch, wl, s, FLEET_ROUNDS)[3]
                     for s in specs16))
    res, c, _ = _fleet_vmap_run(torch, wl, _fleet_specs(celu, nloc, 16),
                                FLEET_ROUNDS, "fleet vmap N=16 (time)")
    add(c)
    results[(16, 0)]["host"].append(res.wall_s)
    seq_rate = [16 * FLEET_ROUNDS / s for s in seq_s]
    print(f"[fleet] sequential loop of scalar PipelinedEngine runs (16 jobs "
          f"x {FLEET_ROUNDS} rounds, plain AdaGrad, warm-up untimed): "
          f"{' / '.join(f'{r:.2f}' for r in seq_rate)} job-rounds per s "
          f"({' / '.join(f'{1e3 / r:.3f}' for r in seq_rate)} ms per "
          f"job-round, host clock, set-up left out); card {card}",
          flush=True)
    for (n, depth), r in results.items():
        timed = r["rounds"] - 1           # round 1 is the warm-up
        rates = [n * timed / w for w in r["host"]]
        host_ms = [1e3 * w / timed for w in r["host"]]
        busy = "not profiled" if r["busy"] is None else (
            f"device busy {r['busy'][0]:.3f} ms per fleet round "
            f"({r['busy'][1]:.0f} kernels per round, warm-up included; a "
            f"profiled {FLEET_BIG_ROUNDS}-round run)")
        print(f"[time] fleet N={n} depth {depth}: "
              f"{' / '.join(f'{x:.2f}' for x in rates)} job-rounds per s "
              f"({max(rates) / max(seq_rate):.2f}x the sequential loop's "
              f"best); host {' / '.join(f'{x:.3f}' for x in host_ms)} ms "
              f"per fleet round (rounds 2-{r['rounds']} and the drain); "
              f"{busy}; card {card}", flush=True)

    # the other gate kernels in a cohort: K2a / K2b and K3 + K4
    for label, kw, want in [
            ("--no-cache-fusion", {"cache_fused": False},
             lambda s: {"cosine_weight_2d": R * s,
                        "cosine_weights_2d": R * s}),
            ("int8 cache", {"cache_dtype": "int8"},
             lambda s: {"fused_sample_q8_2d": 2 * R * s,
                        "quantize_sr_2d": 4 * FLEET_SIDE_ROUNDS})]:
        specs = _fleet_specs(dataclasses.replace(celu, **kw), nloc,
                             FLEET_SIDE_JOBS)
        res, c, _ = _fleet_vmap_run(torch, wl, specs, FLEET_SIDE_ROUNDS,
                                    f"fleet {label}")
        scans, _ = _pipeline_schedule(0, FLEET_SIDE_ROUNDS)
        _want(f"fleet {label} N={FLEET_SIDE_JOBS}", c, **want(scans))
        add(c)
        scalar = [_fleet_scalar(torch, wl, s, FLEET_SIDE_ROUNDS)
                  for s in specs[:2]]
        _fleet_parity(torch, res, scalar, f"fleet {label} N="
                      f"{FLEET_SIDE_JOBS}")
        print(f"[fleet] {label} cohort N={FLEET_SIDE_JOBS}, "
              f"{FLEET_SIDE_ROUNDS} rounds: launches "
              f"{ {k: v for k, v in c.items() if v} }", flush=True)
    return counts


# the party-to-pod round (phase_pods): the WDL-Criteo widths in the
# party-stacked demo model (Party B's 13 fields padded to 26 with dead
# fields), R = W = 5, xi 60 degrees, AdaGrad lr 0.01, labels from a
# teacher over the live fields
POD_RUN = dict(n_fields=26, fields_b=13, vocab=1024, embed_dim=16,
               hidden=512, z_dim=256, R=5, W=5, xi_degrees=60.0, lr=0.01,
               teacher=True)
POD_PARITY_B, POD_PARITY_ROUNDS = 256, 10
POD_TIMED_B, POD_WARM, POD_TIMED = 4096, 2, 6
# each shadowed round (card against CPU from the same state): both pods'
# losses within POD_LOSS_ATOL; each leaf's update, each leaf's
# accumulator increment and each ring within POD_*_RTOL of its own norm
# (what the round's K2a / K2b / K7 launches computed, against the plain
# versions on the CPU).  Read on an H100 (PERF.md): losses within
# 4.77e-7; updates within 5.2e-4 at B = 256 and 1.09e-2 at B = 4,096
# (the first round from the initial state: AdaGrad's first step moves a
# coordinate by ±lr whatever its gradient's size, and the next step
# divides by that gradient), accumulators within 6.4e-4, rings within
# 7.7e-4; so each limit is 4.5-8x its reading.  K2a's cotangent left
# unweighted reads 0.594 in an update, K7's last chunk dropped 3.67
# (``chip_mutants.py``).
POD_LOSS_ATOL = 1e-3
POD_UPDATE_RTOL, POD_ACCUM_RTOL, POD_RING_RTOL = 5e-2, 5e-3, 5e-3


def _pod_checks(label, res, run, staged) -> None:
    """A pod world's invariants: the link's and the staging's bytes
    exact, the rings on both ends of the link bitwise equal (what pod 0
    sent up is pod 1's z, what pod 1 sent down is pod 0's dz), pod 0's
    dead top unchanged, finite losses."""
    n = run["rounds"] + run.get("timed", 0)
    msg = run["batch"] * run["z_dim"] * 4
    for pod, r in enumerate(res):
        c = r["counters"]
        check(c["sent_bytes"] == c["recv_bytes"] == 2 * n * msg,
              f"pods {label}: pod {pod} moved {c} over {n} rounds, want "
              f"{2 * n * msg} B each way")
        want = 4 * n * msg if staged else 0
        check(c["staged_bytes"] == want,
              f"pods {label}: pod {pod} staged {c['staged_bytes']} B, want "
              f"{want}")
        check(all(math.isfinite(v) for v in r["losses"]),
              f"pods {label}: pod {pod} losses {r['losses']}")
    for k in ("z", "dz"):
        a, b = res[0]["ws"][k], res[1]["ws"][k]
        check((a == b).all(), f"pods {label}: the {k} rings differ across "
              f"the link in {(a != b).sum()} elements")
    check(res[0]["dead_top_kept"],
          f"pods {label}: pod 0's dead top copy moved")


def phase_pods(torch, card=None):
    """The party-to-pod round (``core/pod_protocol.py``) on the card: two
    ranks (one a pod, ``launch.dist.run_ranks``) share the H100 over gloo,
    the transport staging each cut tensor through pinned host memory
    (``PodTransport(staged=True)``).  10 rounds at B = 256 at depths 0 and
    1, each round also run on the CPU from the card's state at its start
    (``pod_worker``'s ``shadow``: the two ranks' CPU round over a CPU
    transport), both pods' losses within POD_LOSS_ATOL and each leaf's
    update and accumulator increment and each ring within POD_*_RTOL of
    its norm; 2 + POD_TIMED rounds at B = 4,096 at each depth, the 2
    shadowed likewise, the POD_TIMED timed in ms a round on the host clock
    (ending in
    ``torch.cuda.synchronize()``); every run's link and staging bytes
    exact, its rings equal across the link, pod 0's dead top unchanged,
    its K2a / K2b / K7 launches those of ``pod_protocol.pod_launches``.
    -> the launches of the card's runs."""
    from repro_torch.core import pod_protocol as pp
    from repro_torch.kernels import _cuda
    from repro_torch.launch.dist import run_ranks
    _cuda.build()             # the ranks load the library, never build it
    counts = {}
    t0 = time.perf_counter()
    runs = [{**pp.POD_DEFAULTS, **POD_RUN, "batch": POD_PARITY_B,
             "rounds": POD_PARITY_ROUNDS, "depth": d, "shadow": True}
            for d in (0, 1)]
    runs += [{**pp.POD_DEFAULTS, **POD_RUN, "batch": POD_TIMED_B,
              "rounds": POD_WARM, "timed": POD_TIMED, "depth": d,
              "shadow": True} for d in (0, 1)]
    runs = [{**r, "device": "cuda", "staged": True} for r in runs]
    try:
        res = run_ranks(pp.pod_worker, 2, backend="gloo", args=(runs,))
    except Exception as e:        # a rank raised or died
        fail(f"pods world: the ranks failed: "
             f"{str(e).strip().splitlines()[-1][-500:]}")
    print(f"[pods] two ranks on the card, gloo, staged: done at "
          f"{time.perf_counter() - t0:.1f} s into the phase", flush=True)
    for i, run in enumerate(runs):
        pair = [res[0][i], res[1][i]]
        label = f"B {run['batch']} depth {run['depth']}"
        _pod_checks(label, pair, run, staged=True)
        n = run["rounds"] + run["timed"]
        want = pp.pod_launches(run["R"], n)
        got = {k: pair[0]["launches"][k] + pair[1]["launches"][k]
               for k in want}
        check(got == want, f"pods {label}: launches {got}, want {want} "
              f"(pod_launches)")
        check(pair[0]["launches"]["cosine_weights_2d"] == 0
              and pair[1]["launches"]["cosine_weight_2d"] == 0,
              f"pods {label}: K2a runs on pod 0 only, K2b on pod 1 only: "
              f"{pair[0]['launches']} / {pair[1]['launches']}")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        if run["shadow"]:
            devs = {"loss": max(abs(a - b) for r in pair for a, b in
                                zip(r["losses"], r["cpu_losses"]))}
            for k in ("update", "accum", "ring"):
                devs[k] = max(max(r[f"{k}_dev"]) for r in pair)
            limits = {"loss": POD_LOSS_ATOL, "update": POD_UPDATE_RTOL,
                      "accum": POD_ACCUM_RTOL, "ring": POD_RING_RTOL}
            print(f"[pods] {label}: {run['rounds']} rounds, each against "
                  f"the CPU from the same state: losses within "
                  f"{devs['loss']:.3g} (limit {POD_LOSS_ATOL}); largest "
                  f"relative deviation of a leaf's update "
                  f"{devs['update']:.3g} (limit {POD_UPDATE_RTOL}), of a "
                  f"leaf's accumulator increment {devs['accum']:.3g} (limit "
                  f"{POD_ACCUM_RTOL}), of a ring {devs['ring']:.3g} (limit "
                  f"{POD_RING_RTOL}); largest parameter deviation "
                  f"{max(max(r['param_dev']) for r in pair):.3g}; losses "
                  f"pod 1 {[round(v, 6) for v in pair[1]['losses']]}",
                  flush=True)
            for k, v in devs.items():
                check(v <= limits[k], f"pods {label}: card against CPU, "
                      f"the {k} deviation {v:.3g} is past {limits[k]}")
        if run["timed"]:
            msg = run["batch"] * run["z_dim"] * 4
            print(f"[pods] staged=True gloo, B {run['batch']}, depth "
                  f"{run['depth']}: {pair[0]['ms_per_round']:.3f} / "
                  f"{pair[1]['ms_per_round']:.3f} ms a round (pod 0 / pod "
                  f"1, host clock, {run['timed']} rounds), staging "
                  f"{pair[0]['stage_ms_per_round']:.3f} / "
                  f"{pair[1]['stage_ms_per_round']:.3f} ms a round; link "
                  f"{4 * msg} B a round between the pods, staged "
                  f"{8 * msg} B a round (both pods); K2a {run['R']}, K2b "
                  f"{run['R']}, K7 {2 * (run['R'] + 1)} launches a round; "
                  f"{card}", flush=True)
    return counts


def phase_serve_kernels(torch, floor_ms=None):
    """K6 and K11 against their plain versions, bitwise, at the serving
    ring and a wide one, timed at the serving ring beside the launch floor
    (``floor_ms``, when given); K9 against its plain version at the
    long-prompt shapes, beside one ``F.scaled_dot_product_attention``
    call."""
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
            over = "" if floor_ms is None else (
                f"; the launch floor {floor_ms * 1e3:.2f} us + "
                f"{(results[name]['ms'] - floor_ms) * 1e3:.2f} us")
            print(f"[kernel] {label} bitwise equal to its plain version"
                  f"{over}", flush=True)

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
            # the backward alone: the forward and the backward captured
            # in a CUDA graph, less the forward (the profiler can miss
            # cuDNN's kernels once an earlier profiler ran in the process;
            # it names the kernels only)
            def both():
                return torch.autograd.grad(library(), (qt, kt, vt), do_t)
            lib_b = device_ms(torch, both, 10) - lib_f
            out = library()
            bwd_names = _profiled(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), do_t, retain_graph=True))[1]
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
        # each kernel's products and bytes, as the dry-run costs it
        kv_flops, kv_bytes = fab.bwd_costs(names[1], q, True, window)
        q_flops, q_bytes = fab.bwd_costs(names[2], q, True, window)
        t_kv = _timed(torch, f"{names[1]:30s} {tag}", dkv, dkv_plain,
                      max(errs["dk"][0], errs["dv"][0]), kv_bytes, kv_flops,
                      library="none", peak=peak, iters=10)
        t_q = _timed(torch, f"{names[2]:30s} {tag}", dq, dq_plain,
                     errs["dq"][0], q_bytes, q_flops, library="none",
                     peak=peak, iters=10)
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
    """K1 on its split-row path: at the training paths' cut tensors (ring
    rows of S·d = 3,932,160 bf16 and 6,291,456 fp32 values, B = 2 rows,
    the fp32 ad-hoc row) and at a wide ragged row (GATE_CASES), full and
    weights-only,
    against its plain version (weights and cotangent within LLM_GATE_TOL),
    bitwise the same on a second run and the weights-only call's weights
    bitwise the full call's; timed beside its bound and plain version."""
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.kernels import cosine_weight as cw
    from repro_torch.kernels import fused_sample as fs

    gen = torch.Generator(device="cuda").manual_seed(7)
    cos_xi = xi_to_cos(60.0)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for (W, B, F), ring, sink in GATE_CASES:
        a = torch.randn((B, F), generator=gen, device="cuda")
        z = torch.randn((W, B, F), generator=gen, device="cuda")
        mix = torch.tensor([0.9, -0.5, 1.5][:B], device="cuda")[:, None]
        z[1] = a * mix + 0.5 * z[1]
        # the first token's d values carry a transformer's massive
        # activations and change little between rounds: 30 times the
        # rest, and the stale z close to the ad-hoc a there, so that the
        # first chunk of a row moves its cosine by about 0.02
        a[:, :sink] *= 30.0
        z[1, :, :sink] = a[:, :sink] + 0.05 * z[1, :, :sink]
        z = z.to(dtypes[ring])
        dz = torch.randn((W, B, F), generator=gen, device="cuda").to(
            dtypes[ring])
        zb = z.element_size()
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
        label = f"fused_sample_2d at {(W, B, F)} {ring} ring"
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
        _timed(torch, f"{'fused_sample_2d':30s} W,B,F={W},{B},{F} {ring} "
               f"ring ({chunks} chunks a row)", kern, plain, err,
               4 * B * F + 2 * zb * B * F + 4 * B * F + 4 * B + 4, 7 * B * F,
               iters=10)
        _timed(torch, f"{'fused_sample_2d weights-only':30s} W,B,F={W},{B},"
               f"{F} {ring} ring ({chunks} chunks a row)",
               lambda: kern(None), lambda: plain(None),
               (wo - w0).abs().max().item(),
               4 * B * F + zb * B * F + 4 * B + 4, 6 * B * F, iters=10)


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
    :func:`_pipeline_schedule`.  Layers: the attention-bearing layers
    (:func:`_attention_layers`; an xLSTM cell has no attention) of Party
    A's tower, La, and of Party B's bottom and top towers, Lb and Lt.
    Each forward through such a layer runs K9-LSE once, each backward K10
    (dkv and dq) once, and with remat each backward first recomputes the
    layer's forward (K9-LSE again):

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
    La, Lb, Lt = _attention_layers(cfg)
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


def _attention_layers(cfg, frames: int = 0):
    """-> the layers whose self-attention runs past 2,048 tokens on the
    long path (dense, moe, hybrid and cross blocks; an audio encoder's
    ``enc`` blocks when its ``frames`` pass the threshold too) of the
    split model's towers: (Party A's, Party B's bottom, its top)."""
    from repro_torch.models import vfl
    from repro_torch.models.layers import BLOCKWISE_THRESHOLD
    kinds = ("dense", "moe", "hybrid", "cross") + (
        ("enc",) if frames > BLOCKWISE_THRESHOLD else ())
    return tuple(sum(rep * sum(bt in kinds for bt in pattern)
                     for pattern, rep in stages(cfg))
                 for stages in (vfl.stages_a, vfl.stages_b, vfl.stages_top))


def _layers(cfg, frames: int = 0) -> int:
    """Long-path attention layers of the split model (both parties)."""
    return sum(_attention_layers(cfg, frames))


def _train_frames(cfg, seq_len: int) -> int:
    """Audio frames of a training batch of ``seq_len`` tokens (0 for the
    other families): ``launch/steps.py`` draws S // audio_downsample."""
    return seq_len // cfg.audio_downsample if cfg.family == "audio" else 0


def _step_vs_plain(torch, cfg, seq_len: int, label: str,
                   on_route=None) -> None:
    """One ``launch/steps.py`` train step (B = 1) through K9-LSE / K10
    against the same step through the plain attention on the card: the
    loss to GRAD_LOSS_ATOL, each gradient leaf to GRAD_REL_L2 relative
    L2.  ``on_route(route)`` is called before each route's step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _cuda
    from repro_torch.launch import steps
    from repro_torch.models.vfl import PartyParams, init_all

    shape = ShapeConfig(f"train_{seq_len}", seq_len=seq_len, global_batch=1,
                        kind="train")
    batch = steps.concrete_batch(cfg, shape, seed=0, device="cuda")
    layers = _layers(cfg, _train_frames(cfg, seq_len))
    grads = {}
    for route in ("kernels", "plain"):
        joint = PartyParams(init_all(1, cfg, "cuda"))
        opt, seen = _capture_grads()
        with contextlib.ExitStack() as stack:
            for patch in _plain_attention(route):
                stack.enter_context(patch)
            if on_route is not None:
                on_route(route)
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
          f"{cfg.resolved_head_dim}), K9-LSE / K10 against the plain "
          f"attention on the card: loss {lk:.6f} / {lp:.6f} (|dev| "
          f"{abs(lk - lp):.3g}, limit {GRAD_LOSS_ATOL}); {len(rel)} "
          f"gradient leaves, relative L2 error worst {worst:.3g} (limit "
          f"{GRAD_REL_L2}), median {sorted(rel)[len(rel) // 2]:.3g}",
          flush=True)
    check(math.isfinite(lk) and abs(lk - lp) <= GRAD_LOSS_ATOL,
          f"{label} train step loss {lk} against {lp}")
    check(worst <= GRAD_REL_L2, f"{label} train step gradients: relative "
          f"L2 errors {rel}")


# --------------------------------------------------------------------------
# the families phase
# --------------------------------------------------------------------------
def _serve_launches(n_req: int, steps: int) -> dict:
    """K6 and K3 launches of a ``serve_engine`` run of ``n_req`` requests
    over ``steps`` decode steps, int8 ring and wire, R = 1: warm() runs
    one admit and one step of each kind (one exchange); each admit sends
    its (S, d) prefill up (K3), each exchange step sends its lane rows
    (K3) and inserts them into the ring (K3), and every step reads the
    ring (K6)."""
    return {"fused_dequant_q8_2d": steps + 2,
            "quantize_sr_2d": n_req + 1 + 2 * (steps + 1)}


def _serve_family(torch, card, label, cfg, params, argv_map, want_k9):
    """One int8 ``serve_engine`` run; -> (completions, stats, launches)."""
    from repro_torch.kernels import _cuda
    from repro_torch.launch import serve as cli
    argv = [a for kv in argv_map.items() for a in map(str, kv)]
    args = cli.build_parser().parse_args(argv)
    _cuda.reset_launches()
    comps, stats, eng = cli.serve_engine(args, cfg, params)
    c = dict(_cuda.LAUNCHES)
    steps = stats["decode_steps"]
    walls = sorted(stats["step_walls"])
    print(f"[families] {label} serving: launches {c}; {steps} decode "
          f"steps, {1e3 * walls[len(walls) // 2]:.3f} ms per step "
          f"(median), {stats['req_per_s']:.3f} req/s, "
          f"{stats['tok_per_s']:.1f} tok/s, p50 {stats['p50_ms']:.3f} / "
          f"p99 {stats['p99_ms']:.3f} ms per token; card {card}",
          flush=True)
    n_req = args.requests
    want = _serve_launches(n_req, steps)
    if want_k9:     # K9 in every attention layer of each prefill
        want["flash_attention"] = _layers(cfg) * (n_req + 1)
    _want(f"{label} serving", c, **want)
    check(stats["n_requests"] == n_req and all(
        ((cp.tokens >= 0) & (cp.tokens < cfg.vocab_size)).all()
        for cp in comps), f"{label} serving: {stats['n_requests']} of "
          f"{n_req} served, or a token out of the vocabulary")
    return comps, stats, c


def _family_train(torch, card, label, cfg, args, profile_last=True):
    """``train_llm`` over ``cfg`` with the launch counts, losses, host
    ms per round, peak memory against ``party_hbm_budget`` and, with
    ``profile_last``, the busy ms and top device ops of the last round
    (the profiler on for it alone); -> the launch counts."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.kernels import _cuda
    from repro_torch.launch.budget import party_hbm_budget
    from repro_torch.launch import train as T

    params = T.llm_params(cfg, args.seed, "cuda")
    n_tensors = [len(list(p.parameters())) for p in params.values()]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    make_round = engine.make_round

    def profiled_round(*a, **kw):
        rnd, calls = make_round(*a, **kw), [0]

        def run(*ra, **rkw):
            calls[0] += 1
            if calls[0] == args.rounds and profile_last:
                torch.cuda.synchronize()
                prof.start()
            return rnd(*ra, **rkw)
        return run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    # ``cfg`` in place of ``--arch``'s config (hymba's is cut in depth)
    with mock.patch.object(engine, "make_round", profiled_round), \
            mock.patch.object(T, "get_config", lambda arch: cfg):
        out = T.train_llm(args, params=params)
    torch.cuda.synchronize()
    if profile_last:
        prof.stop()
    counts = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = _llm_launches(cfg, args.R, args.rounds, args.remat, n_tensors)
    print(f"[families] {label}: {cfg.n_layers} layers, B={args.batch_size} "
          f"S={args.seq_len} R={args.R} W={args.W} celu, {args.rounds} "
          f"rounds, remat on; parameter tensors a party {n_tensors}; "
          f"launches {counts}", flush=True)
    _want(f"{label} training", counts, **want)
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"{label} training losses {losses} (a random model starts near "
          f"ln V = {math.log(cfg.vocab_size):.3f})")
    ms = [1e3 * t for t in out["round_s"]]
    budget = party_hbm_budget(cfg, batch_size=args.batch_size,
                              seq_len=args.seq_len, W=args.W)
    total = budget["hbm_total_bytes_a"] + budget["hbm_total_bytes_b"]
    print(f"[families] {label}: losses per round {losses}; ms per round on "
          f"the host clock {[round(x, 3) for x in ms]}"
          f"{' (the last under the profiler)' if profile_last else ''}; "
          f"peak device memory {peak:,} B against the budget's "
          f"parameters + optimizer state + rings {total:,} B of both "
          f"parties; card {card}", flush=True)
    if profile_last:
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in kernels) / 1e3
        print(f"[families] {label}: round {args.rounds} profiled: device "
              f"busy {busy:.3f} ms in {len(kernels)} kernels, "
              f"{ms[-1]:.3f} ms on the host clock "
              f"({100 * busy / ms[-1]:.1f} % busy); card {card}",
              flush=True)
        top = sorted(prof.key_averages(),
                     key=lambda e: -e.self_device_time_total)
        for e in top[:10]:
            print(f"[families]   {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"{e.count:7d} calls  {e.key[:70]}")
    del out, params, prof
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}


def _granite_step_routing(torch, cfg):
    """The B = 1 train step through K9-LSE / K10 against the plain
    attention (``_step_vs_plain``) with the MoE routing pinned: the
    kernels' step records each MoE layer pass's top-k experts, the plain
    step routes every pass as the kernels' did, so the gradients differ
    by the attention's arithmetic alone (an ulp in a router's input
    moves a near-tie token to another expert, which moves the expert
    weights' gradients by far more).  Prints how many tokens the plain
    step would have routed to other experts."""
    from unittest import mock

    from repro_torch.models import moe as M
    orig = M.top_k
    state = {"route": None, "seen": [], "at": 0, "moved": 0, "tokens": 0}

    def pinned(logits, k):
        vals, idx = orig(logits, k)
        if state["route"] == "kernels":
            state["seen"].append(idx)
            return vals, idx
        want = state["seen"][state["at"]]
        state["at"] += 1
        same = torch.sort(idx, dim=-1)[0] == torch.sort(want, dim=-1)[0]
        state["moved"] += int((~same.all(-1)).sum())
        state["tokens"] += idx[..., 0].numel()
        return torch.gather(logits, -1, want), want

    def on_route(route):
        state["route"] = route
    try:
        with mock.patch.object(M, "top_k", pinned):
            _step_vs_plain(torch, cfg, 4096, f"{cfg.name} full-width, "
                           f"routing pinned", on_route=on_route)
    finally:
        print(f"[families] {cfg.name} train step: {state['at']} of "
              f"{len(state['seen'])} MoE layer passes replayed (the remat "
              f"recomputes among them); through the plain attention "
              f"{state['moved']} of {state['tokens']} token routings "
              f"(top-{cfg.moe.top_k} of {cfg.moe.n_experts}) would go to "
              f"other experts than through K9-LSE / K10", flush=True)
    check(state["at"] == len(state["seen"]) > 0,
          f"granite train step: {state['at']} of {len(state['seen'])} "
          f"routings replayed")


def _granite_k9(torch, cfg):
    """K9 and K9-LSE at granite's serving prefill (B = 1, S = 4,096, its
    query heads, its KV heads repeated to them as the attention layer
    does) against the plain attention: every element of out (and lse)
    within the K9 limits, K9-LSE's out bitwise K9's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(24)
    S, H, Kv, hd = (GRANITE_SERVE_ARGS["--prompt-len"], cfg.n_heads,
                    cfg.n_kv_heads, cfg.resolved_head_dim)

    def draw(heads):
        return torch.randn((1, S, heads, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)
    q = draw(H)
    k, v = (L._repeat_kv(draw(Kv), H).contiguous() for _ in range(2))
    o = fa.flash_attention(q, k, v)
    o_lse, lse = fa.flash_attention_fwd_lse(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v)
    torch.cuda.synchronize()
    tag = f"B,S,H,hd=1,{S},{H},{hd} ({Kv} KV heads) causal"
    check(torch.equal(o, o_lse), f"flash_attention_fwd_lse {tag}: the "
          f"output differs from K9's without the LSE pointer")
    err, w_o = _per_element("flash_attention", f"{tag} out", o, o_ref,
                            K9_REL_TOL, K9_ATOL)
    _, w_l = _per_element("flash_attention_fwd_lse", f"{tag} lse", lse,
                          lse_ref, LSE_REL, LSE_ATOL)
    print(f"[families] {cfg.name} {'flash_attention':17s} {tag}: max "
          f"|err| {err:.3g}, worst err / limit out {w_o:.3g} (limit "
          f"2^-7 |ref| + {K9_ATOL:g}), lse {w_l:.3g}; K9-LSE's out "
          f"bitwise K9's", flush=True)


def _granite_lanes_vs_loop(torch, card, cfg, params):
    """The fp32 ring and wire engine against the sequential loop at
    granite's full width: each lane's logits at every token against its
    own request's loop (fed the same tokens), as the serving phase holds
    smollm-360m's."""
    from repro_torch.launch import serve as cli
    from repro_torch.serve import LoadSpec, synth_requests
    rec = _Recorder()
    argv = [a for kv in GRANITE_SERVE_ARGS.items() for a in map(str, kv)]
    args = cli.build_parser().parse_args(
        argv + ["--cache-dtype", "float32", "--fp32-wire"])
    with contextlib.ExitStack() as stack:
        for p in rec.patches():
            stack.enter_context(p)
        comps, stats, _ = cli.serve_engine(args, cfg, params)
    S, gen = args.prompt_len, args.gen
    spec = LoadSpec(n_requests=args.requests, rate=0.0, prompt_len=S,
                    max_new_tokens=gen, min_new_tokens=max(1, gen // 4),
                    seed=0)
    reqs = {r.req_id: r for r in synth_requests(spec, cfg)}
    eng_logits = rec.logits(torch, reqs.values(), S)
    devs, far, total = [], 0, 0
    for comp in comps:
        r = reqs[comp.req_id]
        batch = {"tokens": torch.as_tensor(r.prompt[None]).cuda(),
                 "tokens_a": torch.as_tensor(r.prompt_a[None]).cuda()}
        n = len(comp.tokens)
        loop = _loop_logits(torch, params, cfg, batch, S + gen, comp.tokens)
        d = (eng_logits[comp.req_id][:n] - loop).abs().amax(-1)
        devs.append(d.max().item())
        far += int((d > LANE_LOGIT_ATOL).sum())
        total += n
    dev = max(devs)
    print(f"[families] {cfg.name} fp32 engine against the sequential loop: "
          f"each lane's logits at all {total} tokens within {dev:.4g} of "
          f"its own request's (limit {LANE_LOGIT_ATOL}; {far} tokens past "
          f"it); card {card}", flush=True)
    check(math.isfinite(dev) and dev <= LANE_LOGIT_ATOL,
          f"{cfg.name} fp32 engine logits deviate from the loop's by "
          f"{devs}")


def _reduced_card_vs_cpu(torch, arch):
    """Two celu rounds of ``arch``'s reduced config on the card against
    the same rounds on the CPU from the same parameters: counters exact,
    losses within FAMILY_CPU_RTOL; -> the card run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.launch.train import train_llm
    from repro_torch.models import vfl
    from repro_torch.models.backbone import tree_map

    cfg = get_config(arch).reduced()
    runs = {}
    for dev in ("cuda", "cpu"):
        args = train_args(arch, rounds=SHORT_ROUNDS, device=dev,
                          **FAMILY_REDUCED_ARGS)
        tree = tree_map(lambda t: t.to(dev), vfl.init_all(0, cfg, "cpu"))
        params = {p: vfl.PartyParams(tree[p]) for p in ("a", "b")}
        _cuda.reset_launches()
        out = train_llm(args, params=params)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = dict(_cuda.LAUNCHES)
        st = out["state"]
        runs[dev] = (out["losses"], int(st["comm_rounds"]),
                     int(st["steps"]["b"]), int(st["steps"]["a"][0]))
    (lg, *cg), (lc, *cc) = runs["cuda"], runs["cpu"]
    devs = [abs(a - b) / abs(b) for a, b in zip(lg, lc)]
    print(f"[families] {cfg.name}: {SHORT_ROUNDS} celu rounds card / CPU: "
          f"losses {lg} / {lc} (rel dev {[float(f'{d:.3g}') for d in devs]},"
          f" limit {FAMILY_CPU_RTOL}); comm rounds, B's and A's steps "
          f"{cg} / {cc}; launches {counts}", flush=True)
    check(cg == cc and all(math.isfinite(x) for x in lg)
          and max(devs) <= FAMILY_CPU_RTOL,
          f"{cfg.name} reduced rounds card vs CPU: {runs}")
    return counts


def phase_families(torch, card):
    """The moe, hybrid and ssm / xlstm text families; -> the kernels'
    launch counts over the phase's runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.models import vfl

    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # (a) granite-moe-3b-a800m training at full width
    cfg = get_config(GRANITE)
    add(_family_train(torch, card, cfg.name, cfg,
                      train_args(GRANITE, rounds=FAMILY_ROUNDS,
                                 **TRAIN_ARGS)))
    _granite_step_routing(torch, cfg)

    # (b) granite serving at full width: K9 at its prefill's shape against
    # the plain attention; int8 ring and wire (K9 in all 32 layers of
    # every prefill, K3, K6), then the fp32 engine against the sequential
    # loop
    _granite_k9(torch, cfg)
    params = vfl.init_all(0, cfg, "cuda")
    _, _, c = _serve_family(torch, card, cfg.name, cfg, params,
                            GRANITE_SERVE_ARGS, want_k9=True)
    add(c)
    _granite_lanes_vs_loop(torch, card, cfg, params)
    del params
    torch.cuda.empty_cache()

    # (c) hymba-1.5b (8 layers) and xlstm-125m at full widths
    hymba = dataclasses.replace(get_config("hymba-1.5b"),
                                n_layers=HYMBA_LAYERS)
    xlstm = get_config("xlstm-125m")
    for cfg, targs, rounds, sargs, k9 in (
            (hymba, HYMBA_TRAIN_ARGS, HOST_BOUND_ROUNDS, HYMBA_SERVE_ARGS,
             True),
            (xlstm, XLSTM_TRAIN_ARGS, HOST_BOUND_ROUNDS, XLSTM_SERVE_ARGS,
             False)):
        # not profiled: hymba's 176 thousand and xlstm's 678 thousand
        # kernels a round take the profiler minutes to collect
        add(_family_train(torch, card, cfg.name, cfg,
                          train_args(cfg.name, rounds=rounds, **targs),
                          profile_last=False))
        params = vfl.init_all(0, cfg, "cuda")
        if cfg is xlstm:
            n_b = len(list(vfl.PartyParams(params["b"]).parameters()))
            check(n_b > _cuda.ADAGRAD_LEAVES,
                  f"xlstm-125m's Party B has {n_b} tensors: its update "
                  f"should take more than one K7 table")
        _, _, c = _serve_family(torch, card, cfg.name, cfg, params, sargs,
                                want_k9=k9)
        add(c)
        del params
        torch.cuda.empty_cache()

    # (d) each family's reduced config, card against CPU
    for arch in FAMILY_ARCHS:
        add(_reduced_card_vs_cpu(torch, arch))
    return counts


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


# --------------------------------------------------------------------------
# the cross-attention phase (vlm, audio)
# --------------------------------------------------------------------------
def _cross_cfg(arch, split=None, reduced=False):
    """``arch``'s config (reduced), its split replaced by ``split``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import VFLConfig
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    return cfg if split is None else dataclasses.replace(
        cfg, vfl=VFLConfig(*split))


def _cross_step_launches(cfg, seq_len: int, steps: int, n_tensors: int):
    """The kernels' launches of ``steps`` ``launch/steps.py`` train steps
    (the joint loss with remat, one AdaGrad update): each long-path
    attention layer runs K9-LSE in the forward and again in the
    backward's recompute, and K10 (dkv, dq) once; each update is one K7
    launch a table of at most 48 of the model's ``n_tensors``."""
    layers = _layers(cfg, _train_frames(cfg, seq_len))
    return {"flash_attention_fwd_lse": 2 * layers * steps,
            "flash_attention_bwd_dkv": layers * steps,
            "flash_attention_bwd_dq": layers * steps,
            "fused_adagrad": _adagrad_launches([n_tensors]) * steps}


def _cross_k9(torch, card):
    """K9 and K9-LSE at the cross families' prefill shapes against the
    plain attention, every element within the K9 / LSE limits, K9-LSE's
    out bitwise K9's: seamless' encoder (1, 4096, 16, 64) with no mask
    and the vision decoder's (1, 4096, 64, 128), causal, its 8 KV heads
    repeated; each timed beside its bound, the plain version and SDPA
    with the same ``is_causal``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(25)
    for label, cfg, causal in (("seamless encoder", _cross_cfg(AUDIO),
                                False),
                               ("vision prefill", _cross_cfg(VISION), True)):
        S, H, Kv, hd = (4096, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim)

        def draw(heads):
            return torch.randn((1, S, heads, hd), generator=gen,
                               device="cuda").to(torch.bfloat16)
        q = draw(H)
        k, v = (L._repeat_kv(draw(Kv), H).contiguous() for _ in range(2))
        kw = dict(causal=causal, window=0)
        o = fa.flash_attention(q, k, v, **kw)
        o_lse, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
        o_ref, lse_ref = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = f"B,S,H,hd=1,{S},{H},{hd} ({Kv} KV heads) causal={causal}"
        check(torch.equal(o, o_lse), f"flash_attention_fwd_lse {tag}: the "
              f"output differs from K9's without the LSE pointer")
        err, w_o = _per_element("flash_attention", f"{tag} out", o, o_ref,
                                K9_REL_TOL, K9_ATOL)
        _, w_l = _per_element("flash_attention_fwd_lse", f"{tag} lse", lse,
                              lse_ref, LSE_REL, LSE_ATOL)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 10)
        flops = fa.flops(1, S, H, hd, causal, 0)
        t = _timed(torch, f"{'flash_attention':30s} {label} {tag}",
                   lambda: fa.flash_attention(q, k, v, **kw),
                   lambda: fa.flash_attention_plain(q, k, v, **kw), err,
                   fa.nbytes(q), flops,
                   library=f"F.scaled_dot_product_attention(is_causal="
                   f"{causal}) {lib_ms * 1e3:.2f} us",
                   peak=PEAK_BF16_FLOPS, iters=10)
        print(f"[cross] {label} {'flash_attention':17s} {tag}: max |err| "
              f"{err:.3g}, worst err / limit out {w_o:.3g} (limit 2^-7 "
              f"|ref| + {K9_ATOL:g}), lse {w_l:.3g}; K9-LSE's out bitwise "
              f"K9's; {t['ms'] * 1e3:.2f} us ({flops / t['ms'] / 1e9:.1f} "
              f"TFLOP/s of its work), bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_by']}), plain {t['plain_ms'] * 1e3:.2f} us, SDPA "
              f"{lib_ms * 1e3:.2f} us; card {card}", flush=True)
        del q, k, v, o, o_lse, o_ref, lse, lse_ref, qt, kt, vt
    torch.cuda.empty_cache()


def _cross_train(torch, card):
    """seamless-m4t-large-v2 at full width: CROSS_STEPS train steps with
    AdaGrad through K7 (fp32 state), the launches derived by
    ``_cross_step_launches``, each step's loss and host ms, the last step
    under the profiler (busy ms, kernels); the peak memory.  -> the
    launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bridge import reference_parameters
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _cuda
    from repro_torch.launch import steps
    from repro_torch.models.initializers import _leaves
    from repro_torch.models.vfl import PartyParams, init_all
    from repro_torch.optim import make_optimizer

    cfg = _cross_cfg(AUDIO)
    B, S = CROSS_TRAIN["batch"], CROSS_TRAIN["seq_len"]
    shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tree = init_all(0, cfg, "cuda")
    n_party = [sum(t.numel() for t in _leaves(tree[p])) for p in "ab"]
    params = PartyParams(tree)
    leaves = reference_parameters(params)
    opt = make_optimizer("adagrad", CROSS_LR, use_pallas=True)
    state = opt.init(leaves)
    step = steps.make_train_step(cfg, opt)
    batch = steps.concrete_batch(cfg, shape, seed=0, device="cuda")
    print(f"[cross] {cfg.name}: {cfg.enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers (split {cfg.vfl_split.layers_a} / "
          f"{cfg.vfl_split.layers_b} / {cfg.vfl_split.layers_top}), d "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, "
          f"vocabulary {cfg.vocab_size} ({cfg.padded_vocab} padded); "
          f"parameters a party {n_party} ({len(leaves)} tensors); batch "
          f"{ {k: tuple(v.shape) for k, v in batch.items()} }", flush=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _cuda.reset_launches()
    losses, ms = [], []
    for i in range(CROSS_STEPS):
        if i == CROSS_STEPS - 1:
            prof.start()
        t0 = time.perf_counter()
        _, state, loss = step(params, state, batch)
        losses.append(float(loss))          # syncs
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    prof.stop()
    counts = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = _cross_step_launches(cfg, S, CROSS_STEPS, len(leaves))
    print(f"[cross] {cfg.name} train steps (B={B}, S={S}, "
          f"{_train_frames(cfg, S)} frames, AdaGrad lr {CROSS_LR} through "
          f"K7, remat on): launches {counts}", flush=True)
    _want(f"{cfg.name} train steps", counts, **want)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    print(f"[cross] {cfg.name}: losses per step {losses}; ms per step on "
          f"the host clock {[round(x, 3) for x in ms]} (the last under the "
          f"profiler: device busy {busy:.3f} ms in {len(kernels)} kernels, "
          f"{100 * busy / ms[-1]:.1f} % busy); peak device memory "
          f"{peak:,} B (limit {CROSS_PEAK:,.0f}); card {card}", flush=True)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    for e in top[:8]:
        print(f"[cross]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:7d} calls  {e.key[:70]}")
    check(all(math.isfinite(x) for x in losses)
          and abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"{cfg.name} train losses {losses} (a random model starts near "
          f"ln V = {math.log(cfg.vocab_size):.3f})")
    check(peak <= CROSS_PEAK, f"{cfg.name} train step peak memory {peak:,} "
          f"B past {CROSS_PEAK:,.0f}")
    del params, leaves, state, tree, batch, prof, kernels, top
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}


def _cross_serve(torch, card, arch, cfg, argv_map, frames):
    """``python -m repro_torch.launch.serve --arch arch --full`` over
    ``cfg`` (its ``get_config`` patched in this scope to give ``cfg``, so
    a config cut in depth serves too), which serves a cross-attention
    family through ``serve_naive``: K9 in every long-path attention
    layer of each prefill (``frames`` the encoder's), warm call
    included; then one more request under the profiler.  -> (launches,
    stats)."""
    from unittest import mock

    from repro_torch.kernels import _cuda
    from repro_torch.launch import serve as cli
    from repro_torch.models import vfl
    from repro_torch.models.initializers import _leaves
    argv = ["--arch", arch, "--full"] + [
        a for kv in argv_map.items() for a in map(str, kv)]
    args = cli.build_parser().parse_args(argv)
    _cuda.reset_launches()
    with mock.patch.object(cli, "get_config", lambda arch: cfg):
        toks, stats = cli.main(argv)
    c = dict(_cuda.LAUNCHES)
    params = vfl.init_all(args.seed, cfg, "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    want = {"flash_attention": _layers(cfg, frames) * (args.requests + 1)}
    walls = [round(1e3 * w, 3) for w in stats["walls"]]
    split = cfg.vfl_split
    print(f"[cross] {cfg.name} served (split {split.layers_a} / "
          f"{split.layers_b} / {split.layers_top}, {n_params:,} "
          f"parameters): {args.requests} requests of a "
          f"{args.prompt_len}-token prompt and {args.gen} new tokens "
          f"through serve_naive: {stats['tok_per_s']:.2f} tok/s, "
          f"{stats['ms_per_token']:.3f} ms per token, ms per request "
          f"{walls}; launches {c}; tokens {toks.tolist()}; card {card}",
          flush=True)
    _want(f"{cfg.name} serving", c, **want)
    check(((toks >= 0) & (toks < cfg.vocab_size)).all().item(),
          f"{cfg.name} serving: a token out of the vocabulary")
    # one more request, outside the counted run, under the profiler: the
    # card's busy time and its top ops
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import make_naive_fns, naive_generate
    batch = cli.naive_batch(cfg, args.prompt_len, args.seed, "cuda")
    fns = make_naive_fns(cfg, args.prompt_len + args.gen)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        naive_generate(params, cfg, batch, args.gen, fns=fns).cpu()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    print(f"[cross] {cfg.name} one request under the profiler: {wall:.3f} "
          f"ms on the host clock, device busy {busy:.3f} ms in "
          f"{len(kernels)} kernels ({100 * busy / wall:.1f} % busy)",
          flush=True)
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[cross]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:7d} calls  {e.key[:70]}")
    del params, prof, kernels, batch
    torch.cuda.empty_cache()
    return c, stats


def _cross_reduced_card_vs_cpu(torch, arch, split):
    """One train step and one served request of ``arch``'s reduced config
    (its split replaced by ``split``) on the card against the same on
    the CPU from the same parameters: the step's loss and the request's
    (the mean negative log-probability of the CPU's greedy tokens at the
    prefill and each decode step, both sides fed those tokens) within
    FAMILY_CPU_RTOL relative; the card's greedy tokens the CPU's wherever
    the CPU's top-1 margin passes BATCH_MARGIN.  -> the card's
    launches."""
    from repro_torch.bridge import reference_parameters
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _cuda
    from repro_torch.launch import steps
    from repro_torch.models import vfl
    from repro_torch.models.backbone import tree_map
    from repro_torch.optim import make_optimizer

    cfg = _cross_cfg(arch, split, reduced=True)
    tree0 = vfl.init_all(0, cfg, "cpu")
    B, S = CROSS_REDUCED_TRAIN["batch"], CROSS_REDUCED_TRAIN["seq_len"]
    P, G = CROSS_REDUCED_SERVE["prompt"], CROSS_REDUCED_SERVE["gen"]
    train = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
    pre = ShapeConfig("prefill", seq_len=P, global_batch=1, kind="prefill")
    runs, tokens = {}, None
    counts = {}
    for dev in ("cpu", "cuda"):
        tree = tree_map(lambda t: t.to(dev), tree0)
        params = vfl.PartyParams(tree_map(torch.clone, tree))
        opt = make_optimizer("adagrad", CROSS_LR, use_pallas=True)
        state = opt.init(reference_parameters(params))
        _cuda.reset_launches()
        _, _, loss = steps.make_train_step(cfg, opt)(
            params, state, steps.concrete_batch(cfg, train, 0, dev))
        batch = steps.concrete_batch(cfg, pre, 1, dev)
        with torch.no_grad():
            logits, caches = vfl.prefill(tree, cfg, batch, P + G)
            rows = [logits[0, -1]]
            if tokens is None:              # the CPU's greedy tokens
                tokens = [int(rows[0].argmax())]
            for i in range(G - 1):
                sb = {"token": torch.tensor([[tokens[i]]], device=dev)}
                logits, caches = vfl.decode_step(tree, cfg, caches, sb,
                                                 P + i)
                rows.append(logits[0, -1])
                if len(tokens) < G:
                    tokens.append(int(rows[-1].argmax()))
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = dict(_cuda.LAUNCHES)
        own = [int(r.argmax()) for r in rows]
        runs[dev] = (float(loss), torch.stack(rows).float().cpu(), own)
    (lc, rc, tc), (lg, rg, tg) = runs["cpu"], runs["cuda"]
    loss_dev = abs(lg - lc) / abs(lc)
    idx = torch.tensor(tc)[:, None]
    nll = [-torch.log_softmax(r, -1).gather(1, idx).mean().item()
           for r in (rg, rc)]
    nll_dev = abs(nll[0] - nll[1]) / abs(nll[1])
    top2 = rc.topk(2, -1).values
    wide = ((top2[:, 0] - top2[:, 1]) > BATCH_MARGIN).tolist()
    same = [a == b for a, b in zip(tg, tc)]
    name = cfg.name + ("" if split is None else f" split {split[:3]}")
    print(f"[cross] {name}: train step card / CPU loss {lg:.6f} / {lc:.6f} "
          f"(rel dev {loss_dev:.3g}); served request ({P}-token prompt, "
          f"{G} tokens): loss {nll[0]:.6f} / {nll[1]:.6f} (rel dev "
          f"{nll_dev:.3g}; limit {FAMILY_CPU_RTOL} for both), logits max "
          f"|dev| {(rg - rc).abs().max().item():.3g}; greedy tokens {tg} / "
          f"{tc} ({sum(wide)} of {G} past the margin {BATCH_MARGIN}); "
          f"launches { {k: v for k, v in counts.items() if v} }",
          flush=True)
    check(math.isfinite(lg) and loss_dev <= FAMILY_CPU_RTOL
          and nll_dev <= FAMILY_CPU_RTOL
          and all(s for s, w in zip(same, wide) if w),
          f"{name} reduced card vs CPU: loss {lg} / {lc}, request loss "
          f"{nll}, tokens {tg} / {tc}, margins past {BATCH_MARGIN} {wide}")
    _want(f"{name} reduced train step", counts,
          fused_adagrad=_adagrad_launches(
              [len(reference_parameters(vfl.PartyParams(tree0)))]))
    return counts


def phase_cross(torch, card):
    """The cross-attention families (vlm, audio; see CROSS_STEPS); ->
    the kernels' launch counts over the phase's runs."""
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # (a) seamless-m4t-large-v2 at full width: the train steps, one B = 1
    # step through the kernels against the plain attention, K9 at the
    # encoder's prefill shape, the served requests (the encoder over
    # 4,096 frames: K9 with no mask in its 24 layers)
    _cross_k9(torch, card)
    add(_cross_train(torch, card))
    cfg = _cross_cfg(AUDIO)
    _step_vs_plain(torch, cfg, CROSS_TRAIN["seq_len"],
                   f"{cfg.name} full-width")
    torch.cuda.empty_cache()
    add(_cross_serve(torch, card, AUDIO, cfg, AUDIO_SERVE_ARGS,
                     AUDIO_SERVE_ARGS["--prompt-len"])[0])

    # (b) llama-3.2-vision-90b at full widths, 10 layers: served
    add(_cross_serve(torch, card, VISION, _cross_cfg(VISION, VISION_SPLIT),
                     VISION_SERVE_ARGS, 0)[0])

    # (c) the reduced configs, card against CPU
    for arch, split in CROSS_REDUCED:
        add(_cross_reduced_card_vs_cpu(torch, arch, split))
    return counts


# --------------------------------------------------------------------------
# the dry-run phase
# --------------------------------------------------------------------------
# (a) the reference's integration-test triples: (arch, shape, multi-pod)
DRYRUN_TRIPLES = (("smollm-360m", "train_4k", True),
                  ("xlstm-125m", "long_500k", False))
DRYRUN_CLI_TIMEOUT = 400
# (b) the predicted peak of a train step (params, AdaGrad state, batch
# and the step's own allocations, as the caching allocator counts them)
# against the measured one: the trace sees every tensor the step makes,
# but not the scratch that a library call takes from the allocator for
# itself (cuBLAS, reductions), so the limit is stated in PERF.md before
# the first run
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_STEP = {"batch": 2, "seq_len": 4096}
# (c) each leaf's update (updated less initial) against the unsharded
# step's by relative L2, as ``tests/test_torch_sharded_long.py`` holds
# it: AdaGrad's first step moves a coordinate by about ±lr whatever its
# gradient's size, so a few coordinates whose gradient rounds to the
# other sign read small, and a leaf the step never wrote back reads 1
DRYRUN_UPDATE_RTOL = 1e-2


def _dryrun_cli_start():
    """Start ``python -m repro_torch.launch.dryrun`` on each triple, on
    the CPU (no card: ``CUDA_VISIBLE_DEVICES`` empty) -> the processes."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="2")
    procs = []
    for arch, shape, multi_pod in DRYRUN_TRIPLES:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape] + (["--multi-pod"] if multi_pod
                                           else [])
        procs.append(((arch, shape), subprocess.Popen(
            argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def _dryrun_cli_check(procs, card) -> None:
    """Each triple printed one ok line with finite, positive roofline
    terms."""
    for (arch, shape), proc in procs:
        try:
            out, err = proc.communicate(timeout=DRYRUN_CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"dry-run {arch} {shape}: past {DRYRUN_CLI_TIMEOUT} s")
        lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
        check(proc.returncode == 0 and len(lines) == 1 and lines[0]["ok"],
              f"dry-run {arch} {shape}: rc {proc.returncode}, lines "
              f"{lines}, stderr {err[-2000:]}")
        r = lines[0]
        terms = r["roofline"]
        check(all(math.isfinite(v) and v > 0 for v in terms.values()),
              f"dry-run {arch} {shape}: roofline terms {terms}")
        print(f"[dryrun] CLI {arch} {shape} on {r['mesh']} ({r['chips']} "
              f"GPUs, traced on the CPU in {r['compile_s']} s): per device "
              f"{r['hlo_flops_per_dev']:.4g} FLOP, {r['hlo_bytes_per_dev']:.4g} "
              f"B accessed, collectives {r['collectives']}, peak "
              f"{r['memory']['peak_bytes']:,} B; terms (a model from the "
              f"H100 data sheet) {terms}, {r['dominant']}; kernels "
              f"{r['kernels']}", flush=True)


def _dryrun_peak(torch, card, arch):
    """(b) for one arch: the dry-run's trace of the train step on fake
    CUDA tensors against the same step run on the card.  -> the
    deviation of the predicted peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bridge import reference_parameters
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.models.vfl import PartyParams, init_all
    from repro_torch.optim import make_optimizer

    cfg = get_config(arch)
    B, S = DRYRUN_STEP["batch"], DRYRUN_STEP["seq_len"]
    shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
    opt = make_optimizer("adagrad", CROSS_LR, use_pallas=True)
    t0 = time.perf_counter()
    with FakeTensorMode():
        fparams = PartyParams(init_all(0, cfg, "cuda"))
        fstate = opt.init(reference_parameters(fparams))
        fbatch = steps.input_specs(cfg, shape, device="cuda")["batch"]
        t = trace_step(steps.make_train_step(cfg, opt), fparams, fstate,
                       fbatch)
    trace_s = time.perf_counter() - t0
    del fparams, fstate, fbatch
    predicted = t["peak_bytes"]

    # what the process holds before the step's arguments are made: the
    # measured side owes nothing to the trace's argument bytes
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated()
    params = PartyParams(init_all(0, cfg, "cuda"))
    state = opt.init(reference_parameters(params))
    batch = steps.concrete_batch(cfg, shape, seed=0, device="cuda")
    step = steps.make_train_step(cfg, opt)
    step(params, state, batch)          # warm: the libraries' handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, loss = step(params, state, batch)
        torch.cuda.synchronize()
    raw = torch.cuda.max_memory_allocated()
    measured = raw - other
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    dev = abs(predicted - measured) / measured
    print(f"[dryrun] {arch} train step (B={B}, S={S}, unsharded, AdaGrad "
          f"through K7): peak predicted by the dry-run's trace {predicted:,} "
          f"B (arguments {t['argument_bytes']:,} B; traced in "
          f"{trace_s:.1f} s), measured {measured:,} B "
          f"(torch.cuda.max_memory_allocated {raw:,} B less {other:,} B "
          f"held before the step's arguments were made): deviation {dev:.2%} (limit "
          f"{DRYRUN_PEAK_RTOL:.0%}); predicted compute term "
          f"{1e3 * t['flops'] / PEAK_FLOPS_BF16:.3f} ms ({t['flops']:.4g} "
          f"FLOP) and memory term {1e3 * t['bytes'] / HBM_BW:.3f} ms "
          f"({t['bytes']:.4g} B, un-fused) beside the measured busy "
          f"{busy:.3f} ms; loss {float(loss):.4f}; kernels {t['kernels']}; "
          f"card {card}", flush=True)
    check(math.isfinite(float(loss)), f"{arch} dry-run step loss {loss}")
    check(dev <= DRYRUN_PEAK_RTOL, f"{arch}: the dry-run's peak {predicted:,}"
          f" B against the measured {measured:,} B")
    del params, state, batch, prof, t
    torch.cuda.empty_cache()
    return dev


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want||; 0 where both are zero (a leaf the loss
    does not reach), infinite where only ``want`` is."""
    num, den = float((got - want).norm()), float(want.norm())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _dryrun_sharded(torch, card):
    """(c) the sharded train step on a one-rank mesh against the unsharded
    step.  -> its launch counts."""
    import torch.distributed as dist

    from repro_torch.bridge import reference_parameters
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import _cuda
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.vfl import PartyParams, init_all
    from repro_torch.optim import make_optimizer

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_config("smollm-360m")
        B, S = DRYRUN_STEP["batch"], DRYRUN_STEP["seq_len"]
        shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
        batch = steps.concrete_batch(cfg, shape, seed=0, device="cuda")
        opt = make_optimizer("adagrad", CROSS_LR, use_pallas=True)

        ref = PartyParams(init_all(0, cfg, "cuda"))
        init = [p.detach().clone() for p in reference_parameters(ref)]
        rstate = opt.init(reference_parameters(ref))
        _, rstate, rloss = steps.make_train_step(cfg, opt)(ref, rstate,
                                                           batch)
        params = steps.shard_params(PartyParams(init_all(0, cfg, "cuda")),
                                    mesh)
        state = opt.init(reference_parameters(params))
        step = steps.make_sharded_train_step(cfg, opt, mesh)
        sbatch = steps.shard_batch(batch, mesh)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        _, state, loss = step(params, state, sbatch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(_cuda.LAUNCHES)
        want = _cross_step_launches(cfg, S, 1, len(init))
        print(f"[dryrun] smollm-360m sharded train step over a one-rank "
              f"(data, model) mesh (B={B}, S={S}, attention on the shards "
              f"through local_map): launches {counts}; {ms:.1f} ms on the "
              f"host clock; card {card}", flush=True)
        _want("the sharded train step", counts, **want)
        loss, rloss = float(loss.full_tensor()), float(rloss)
        leaves = [p.full_tensor().detach()
                  for p in reference_parameters(params)]
        rleaves = [p.detach() for p in reference_parameters(ref)]
        grad_rel = [float((a.full_tensor().sqrt() - b.sqrt()).norm()
                          / b.sqrt().norm().clamp_min(1e-30))
                    for a, b in zip(state["accum"], rstate["accum"])]
        update_rel = [_rel_l2(a.float() - p0.float(), b.float() - p0.float())
                      for a, b, p0 in zip(leaves, rleaves, init)]
        worst = max(range(len(update_rel)), key=update_rel.__getitem__)
        moved = max(float((b.float() - p0.float()).abs().max())
                    for b, p0 in zip(rleaves, init))
        print(f"[dryrun] sharded against unsharded: loss {loss:.6f} / "
              f"{rloss:.6f} (|dev| {abs(loss - rloss):.3g}, limit "
              f"{GRAD_LOSS_ATOL}); gradient magnitudes (the AdaGrad "
              f"accumulators' roots) relative L2 worst {max(grad_rel):.3g} "
              f"(limit {GRAD_REL_L2}); each leaf's update relative L2 "
              f"worst {update_rel[worst]:.3g} (leaf {worst} of "
              f"{len(update_rel)}, {leaves[worst].numel():,} elements; "
              f"limit {DRYRUN_UPDATE_RTOL}; the unsharded step moved a "
              f"coordinate by up to {moved:.3g})", flush=True)
        check(math.isfinite(loss) and abs(loss - rloss) <= GRAD_LOSS_ATOL,
              f"sharded step loss {loss} against {rloss}")
        check(max(grad_rel) <= GRAD_REL_L2, f"sharded step gradient "
              f"magnitudes: relative L2 errors {grad_rel}")
        check(max(update_rel) <= DRYRUN_UPDATE_RTOL,
              f"sharded step leaves: updates' relative L2 errors "
              f"{update_rel}")
        del params, state, ref, rstate, leaves, rleaves, init, batch, sbatch
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}


def phase_dryrun(torch, card):
    """The dry-run's three checks (the module's note, item 16); (a) runs
    in subprocesses on the CPU while (b) and (c) run.  -> the launch
    counts of (c)."""
    procs = _dryrun_cli_start()
    try:
        for arch in ("smollm-360m", AUDIO):
            _dryrun_peak(torch, card, arch)
        counts = _dryrun_sharded(torch, card)
        _dryrun_cli_check(procs, card)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return counts


def phase_audit(torch):
    """The boundary auditor's card checks (phase 17): the resource lint
    and the contracts' launches, the quick matrix's route checks and the
    self-test.  Any error fails the run."""
    from repro_torch.analysis import audit
    from repro_torch.analysis.kernel_lint import (CONTRACTS,
                                                  DEFAULT_GEOMETRIES,
                                                  K3_KERNELS, SPILL_FREE,
                                                  lint_card)
    from repro_torch.analysis.selftest import render, run_selftest

    findings, stats = lint_card(DEFAULT_GEOMETRIES)
    for label, u in sorted(stats["res_usage"].items()):
        print(f"[audit] {label}: REG {u['REG']}, SHARED {u['SHARED']} B, "
              f"LOCAL {u['LOCAL']} B, threads {u['threads']}", flush=True)
    for r in stats["launched"]:
        print(f"[audit] contract {r['kernel']} @ {r['geometry']}: "
              f"{r['launches']} launch(es), max|err| {r['max_abs_err']:.3g} "
              f"against its plain version, ok {r['ok']}", flush=True)
    missing = [f"{k}<{hd}>" for k in SPILL_FREE for hd in (32, 64, 128)
               if f"{k}<{hd}>" not in stats["res_usage"]]
    bases = {k.split("<")[0] for k in stats["res_usage"]}
    missing += [k for k in K3_KERNELS if k not in bases]
    check(not missing, f"audit kernel lint: the kernels {missing} (the "
          f"tensor-core attention kernels', K3's) are not in the library, "
          f"so their local memory went unchecked")
    errors = [f for f in findings if f.severity == "error"]
    check(not errors, "audit kernel lint: " + "; ".join(
        f"{f.code} @ {f.where}: {f.detail}" for f in errors))
    want = sum(1 for c in CONTRACTS for g in DEFAULT_GEOMETRIES
               if c.flash == g.name.startswith("flash"))
    check(len(stats["launched"]) == want == 17,
          f"audit: {len(stats['launched'])} contract launches, want {want}")
    for case in audit.default_cases(quick=True):
        r = audit.route_check(case)
        print(f"[audit] route {case.name}: launches {r.stats['launches']}",
              flush=True)
        check(not r.errors, f"audit route {case.name}: " + "; ".join(
            f"{f.code} @ {f.where}: {f.detail}" for f in r.errors))
    ok, results = run_selftest("cuda")
    print("\n".join("[audit] " + line
                    for line in render(results).splitlines()), flush=True)
    check(ok and len(results) == 7
          and results[-1].name == "gate-bypass (card)",
          f"audit self-test: {[(m.name, m.caught) for m in results]}")


# --------------------------------------------------------------------------
# The examples (examples/torch): the twins of the reference's scripts
# --------------------------------------------------------------------------
EXAMPLES = os.path.join(ROOT, "examples", "torch")
# the quickstart twin's presets, cut from 400 rounds a preset for the time
# limit; its multiparty and serving twins run whole
QUICKSTART_ROUNDS = 30
# the LLM twin's cut tensor on its ring: (W, B, S · d) at smollm-360m's
# width, B = 2, S = 64, W = 3 (the split-row path: 15 chunks a row)
EXAMPLE_RING = (3, 2, 64 * 960)


def load_example(name: str):
    """The twin ``examples/torch/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quickstart_launches(protocol: str, kw: dict, rounds: int,
                         n_adagrad: int) -> dict:
    """The kernels' launches of ``rounds`` rounds of one quickstart preset
    (the twin's ``run_protocol``), from the engine's code: vanilla has no
    local updates, fedbcd no gate (its weighting is off); celu gates each
    local update of both parties (K1, or K4 over the int8 cache), the
    local scans and merges following :func:`_pipeline_schedule`; each
    update of a party is ``n_adagrad`` K7 launches over both parties
    (:func:`_adagrad_launches`); an int8 cache quantises the 4 inserts of
    each merge (K3), the int8_topk wire the up and down message of each
    exchange (K3)."""
    R = kw.get("R", 5)
    n_local = 0 if protocol == "vanilla" else R
    scans, merges = _pipeline_schedule(kw.get("pipeline_depth", 0), rounds)
    gate = ("fused_sample_q8_2d" if kw.get("cache_dtype") == "int8"
            else "fused_sample_2d")
    want = {"fused_adagrad": (n_local * scans + merges) * n_adagrad}
    if protocol == "celu":
        want[gate] = 2 * n_local * scans
    k3 = (4 * merges if kw.get("cache_dtype") == "int8" else 0) \
        + (2 * rounds if kw.get("compression") else 0)
    if k3:
        want["quantize_sr_2d"] = k3
    return want


def _multiparty_launches(rounds: int, R: int, K: int, n_adagrad: int):
    """The multiparty twin's launches: each local update gates each
    feature party's ring (K1) and Party B's ∇Z ring once per feature party
    (K1 weights-only, the minimum cosine), and every party takes 1 + R
    updates a round, ``n_adagrad`` K7 launches over all parties."""
    return {"fused_sample_2d": 2 * K * R * rounds,
            "fused_adagrad": (1 + R) * rounds * n_adagrad}


def _llm_example_launches(R: int, rounds: int, n_adagrad: int) -> dict:
    """The LLM twin's launches (int4 ring, int8 AdaGrad state, S = 64, so
    the attention takes its plain path and no K9 / K9-LSE / K10
    launches): each local update gates once a party on the int4 ring (K5,
    Party B's weights-only), each round's inserts quantise z and ∇Z of
    both parties (K3), and every update of a party is K8 over its tables
    (``n_adagrad`` over both parties)."""
    return {"fused_sample_q4_2d": 2 * R * rounds,
            "quantize_sr_2d": 4 * rounds,
            "fused_adagrad_q8": (1 + R) * rounds * n_adagrad}


def _example_kernels(torch):
    """K5 and K4 at the LLM twin's ring (``EXAMPLE_RING``: full and
    weights-only, against their plain versions, timed beside the bound);
    K8's step over smollm-360m's two party tables as its training runs
    them (bf16 gradients and parameters), operands far past the L2 cache
    (cold), beside the bound, and the per-leaf uniforms the int8 state
    draws a step."""
    from repro_torch.kernels import fused_adagrad as fag
    gen = torch.Generator(device="cuda").manual_seed(29)
    for bits in (4, 8):
        _quant_gate(torch, gen, bits, EXAMPLE_RING, ("a", "b"))
    mask = torch.full((), 0.7, device="cuda")
    lr, eps = ADAGRAD_LR, ADAGRAD_EPS
    for p, leaves in _llm_party_leaves("smollm-360m").items():
        shapes = [s for s, _ in leaves]
        g, q, sc, u, prm = _k8_operands(torch, gen, shapes, torch.bfloat16,
                                        torch.bfloat16)
        n = sum(x.numel() for x in q)
        _timed(torch, f"{'fused_adagrad_q8':30s} smollm-360m {p} step, "
               f"{len(q)} leaves, {n:,} codes (cold)",
               lambda: fag.fused_adagrad_q8_step_(g, q, sc, u, prm, lr, eps,
                                                  mask),
               lambda: fag.fused_adagrad_q8_step_plain(g, q, sc, u, prm, lr,
                                                       eps, mask),
               0.0, _q8_step_bytes(g, q, prm), 12 * n, iters=3)
        draw_ms = call_ms(torch, lambda: [
            torch.rand(x.shape, generator=gen, device="cuda") for x in u],
            iters=10)
        print(f"[examples] the int8 state's uniforms of smollm-360m {p}'s "
              f"step: {n * 4 / 1e9:.3f} GB of fp32 in {len(u)} draws, "
              f"{draw_ms * 1e3:.2f} us a step (CUDA events)", flush=True)
        del g, q, sc, u, prm
        torch.cuda.empty_cache()


def _llm_example(torch, card) -> dict:
    """The LLM twin at its defaults: smollm-360m at full width, int4 ring,
    int8 AdaGrad state, 3 rounds; -> its launches."""
    from repro_torch.kernels import _cuda
    llm = load_example("llm_vfl_training")
    n_adagrad = _adagrad_launches(
        [len(v) for v in _llm_party_leaves("smollm-360m").values()])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # held by earlier phases
    _cuda.reset_launches()
    out = llm.main([])
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    args = llm.build_parser().parse_args([])
    _, _, rounds = llm.shape(args)
    tr = out["train"]
    want = _llm_example_launches(3, rounds, n_adagrad)
    print(f"[examples] llm_vfl_training (defaults: {' '.join(out['argv'])})"
          f": launches {counts} (derived {want})", flush=True)
    _want("the LLM example", counts, **want)
    losses = tr["losses"]
    check(len(losses) == rounds and all(math.isfinite(x) for x in losses),
          f"the LLM example's losses {losses}")
    ms = [1e3 * t for t in tr["round_s"]]
    budget = out["budget"]
    total = budget["hbm_total_bytes_a"] + budget["hbm_total_bytes_b"]
    print(f"[examples] llm_vfl_training losses {losses}; ms per round "
          f"{[round(x, 3) for x in ms]} (rounds 2-{rounds}: "
          f"{sum(ms[1:]) / len(ms[1:]):.3f} ms); peak device memory "
          f"{peak - base:,} B over the {base:,} B held before the run "
          f"(torch.cuda.max_memory_allocated) against the twin's budget "
          f"line for the demo shape, {total:,} B of parameters + "
          f"optimizer state + rings over both parties "
          f"({(peak - base) / total:.2f}x); card {card}", flush=True)
    return counts


def _quickstart_example(torch, card) -> dict:
    """The quickstart twin cut to QUICKSTART_ROUNDS rounds a preset; each
    preset's launches against the derived counts.  -> the launches."""
    from unittest import mock

    from repro_torch.kernels import _cuda
    qs = load_example("quickstart")
    run_protocol, per_preset = qs.run_protocol, []

    def counted(*a, **kw):
        _cuda.reset_launches()
        r = run_protocol(*a, **kw)
        per_preset.append(dict(_cuda.LAUNCHES))
        return r
    with mock.patch.object(qs, "run_protocol", counted):
        out = qs.main(["--rounds", str(QUICKSTART_ROUNDS)])
    total = {}
    for (name, proto, kw), c in zip(qs.PRESETS, per_preset, strict=True):
        r = out["results"][name]
        want = _quickstart_launches(proto, kw, QUICKSTART_ROUNDS, 2)
        print(f"[examples] quickstart {name}: AUC {r['curve']}, "
              f"{1e3 * r['wall_s'] / QUICKSTART_ROUNDS:.3f} ms a round "
              f"(host clock, evaluation included); launches {c}",
              flush=True)
        _want(f"quickstart {name}", c, **want)
        check(all(math.isfinite(a) for _, a in r["curve"]),
              f"quickstart {name}: AUC {r['curve']}")
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    print(f"[examples] quickstart: card {card}", flush=True)
    return total


def _multiparty_example(torch, card) -> dict:
    """The multiparty twin whole (120 rounds); -> its launches."""
    from repro_torch.kernels import _cuda
    mp = load_example("multiparty_vfl")
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = mp.main([])
    wall = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    want = _multiparty_launches(mp.ROUNDS, 3, mp.K, 1 + mp.K)
    print(f"[examples] multiparty_vfl: {out['comm_rounds']} rounds in "
          f"{wall:.2f} s (host clock, evaluation included); launches "
          f"{counts}; card {card}", flush=True)
    _want("the multiparty example", counts, **want)
    check(out["comm_rounds"] == mp.ROUNDS and all(
        math.isfinite(x) for _, loss, a in out["history"] for x in (loss, a)),
        f"the multiparty example: {out['history']}")
    return counts


def _serve_example(torch, card) -> dict:
    """The serving twin whole: the engine run (int8 wire and ring) and
    the vision config's ``serve_naive`` run; -> the launches."""
    from repro_torch.kernels import _cuda
    sv = load_example("serve_split_model")
    _cuda.reset_launches()
    out = sv.main([])
    counts = dict(_cuda.LAUNCHES)
    comps, stats = out["engine"]
    toks, nstats = out["naive"]
    # prompts of 16 tokens: the attention's plain path, no K9
    want = _serve_launches(len(comps), stats["decode_steps"])
    print(f"[examples] serve_split_model: engine {stats['n_requests']} "
          f"requests over {stats['decode_steps']} decode steps, "
          f"{stats['tok_per_s']:.1f} tok/s; vision {nstats['ms_per_token']:.3f} "
          f"ms a token; launches {counts}; card {card}", flush=True)
    _want("the serving example", counts, **want)
    check(stats["n_requests"] == 12 and tuple(toks.shape) == (1, 8),
          f"the serving example: {stats['n_requests']} requests, tokens "
          f"{tuple(toks.shape)}")
    return counts


def phase_examples(torch, card) -> dict:
    """The twins of the reference's example scripts (``examples/torch``):
    the LLM twin at its defaults, the quickstart twin cut, the
    multiparty and serving twins whole, each with its launches against
    the derived counts (the counts set to 0 before each run); K5 / K4 /
    K8 at the LLM twin's shapes.  -> the runs' launches."""
    counts = {}
    for run in (_llm_example, _quickstart_example, _multiparty_example,
                _serve_example):
        for k, v in run(torch, card).items():
            counts[k] = counts.get(k, 0) + v
    _example_kernels(torch)
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

    # 3.-5.
    t0 = time.perf_counter()
    kernels = phase_kernels(torch)
    floor_ms = launch_floor(torch)
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
    t0 = time.perf_counter()
    for k, v in phase_chaos(torch, card).items():
        pipeline_counts[k] = pipeline_counts.get(k, 0) + v
    print(f"[phase] chaos {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for k, v in phase_fleet(torch, card).items():
        pipeline_counts[k] = pipeline_counts.get(k, 0) + v
    print(f"[phase] fleet {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for k, v in phase_pods(torch, card).items():
        pipeline_counts[k] = pipeline_counts.get(k, 0) + v
    print(f"[phase] pods {time.perf_counter() - t0:.1f} s", flush=True)

    # 9.-10. serving
    t0 = time.perf_counter()
    kernels.update(phase_serve_kernels(torch, floor_ms))
    print(f"[phase] serving kernels {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    counts.update(phase_serving(torch, card))
    print(f"[phase] serving {time.perf_counter() - t0:.1f} s", flush=True)

    # 11.-12. training
    t0 = time.perf_counter()
    kernels.update(phase_train_kernels(torch))
    print(f"[phase] training kernels {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    counts.update(phase_training(torch, card))
    print(f"[phase] training {time.perf_counter() - t0:.1f} s", flush=True)

    # 13. the reduced model
    t0 = time.perf_counter()
    phase_reduced(torch, card)
    print(f"[phase] reduced model {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 14. the moe, hybrid and ssm / xlstm text families
    t0 = time.perf_counter()
    for k, v in phase_families(torch, card).items():
        pipeline_counts[k] = pipeline_counts.get(k, 0) + v
    print(f"[phase] families {time.perf_counter() - t0:.1f} s", flush=True)

    # 15. the vlm and audio families (cross-attention)
    t0 = time.perf_counter()
    for k, v in phase_cross(torch, card).items():
        pipeline_counts[k] = pipeline_counts.get(k, 0) + v
    print(f"[phase] cross {time.perf_counter() - t0:.1f} s", flush=True)

    # 16. the dry-run
    t0 = time.perf_counter()
    for k, v in phase_dryrun(torch, card).items():
        pipeline_counts[k] = pipeline_counts.get(k, 0) + v
    print(f"[phase] dryrun {time.perf_counter() - t0:.1f} s", flush=True)

    # 17. the boundary auditor
    t0 = time.perf_counter()
    phase_audit(torch)
    print(f"[phase] audit {time.perf_counter() - t0:.1f} s", flush=True)

    # 18. the examples
    t0 = time.perf_counter()
    for k, v in phase_examples(torch, card).items():
        pipeline_counts[k] = pipeline_counts.get(k, 0) + v
    print(f"[phase] examples {time.perf_counter() - t0:.1f} s", flush=True)

    # 19. results: each kernel's launches over every path that ran it, and
    # the launch-bound kernels beside the launch floor
    floor_lines(kernels, floor_ms)
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
