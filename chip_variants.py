#!/usr/bin/env python3
"""Times source variants of kernels on one NVIDIA GPU: K9's bf16 and fp32
kernels (``flash_fwd_mma``, ``flash_fwd_f32mma`` in ``src/repro_torch/
csrc/flash_attention.cu``), K10's fp32 kernels (``flash_bwd_dkv_f32mma``,
``flash_bwd_dq_f32mma`` in ``flash_attention_bwd.cu``) and K1's
split-row path (``csrc/cosine_gate.cu`` and its rule in
``kernels/cosine_weight.py``).

Each variant is a copy of ``src/`` and ``chip_smoke.py`` with some lines
of a kernel's source replaced (``chip_mutants.mutated_copy``), built in
a process of its own.  That process times the kernel (device µs per
call, CUDA graph and events, as ``chip_smoke.py`` times it) and prints
one line a shape with ptxas's registers and spills of the kernel:

  * K9 at the shapes of ``chip_smoke.K9_CASES``, every element of each
    output held to the smoke's limit (a variant past it fails);
  * K10's fp32 kernels at the fp32 shapes of ``chip_smoke.K10_CASES``,
    with the worst err / limit of dk, dv and dq against the fp64 plain
    version on the same inputs (printed, not held: some variants exist
    to show what a design choice does to the numbers);
  * K9-LSE's fp32 kernel at the same shapes, with the worst err / limit
    of out and lse against the fp64 plain version (printed, not held);
  * K1 at the LLM cut tensor, at (2, 64, 61,440) in fp32 and bf16 and at
    the paper's (5, 256, 256), full and weights-only, with its max |err|
    against the plain version.

The tree as it stands runs first and last in each group, so that the
spread between two runs of the same code shows beside the variants.

    python3 chip_variants.py               # every variant
    python3 chip_variants.py NAME [NAME]   # the tree and the named ones

Exits non-zero if a variant does not build or fails a check.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import chip_mutants

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("src", "repro_torch", "csrc")
MMA_HEADER = os.path.join(CSRC, "attention_mma.cuh")
# the big part of s (and dp) summed over the k-steps in the tensor cores'
# accumulator (the kernels: each k-step's from zero, added in fp32)
BIG_CHAINED = ("  float t[4] = {0.f, 0.f, 0.f, 0.f};\n"
               "  mma(t, a[0], b[0][2 * half], b[0][2 * half + 1]);\n"
               "#pragma unroll\n"
               "  for (int e = 0; e < 4; ++e) big[e] += t[e];",
               "  mma(big, a[0], b[0][2 * half], b[0][2 * half + 1]);",
               MMA_HEADER)
# name -> [(line, new line)] in flash_attention.cu: each undoes one choice
# of K9's design
K9_VARIANTS = {
    # key tiles of 64 rows at hd 128 too (the kernel: 32 there)
    "key_tile_64_at_hd128": [
        ("constexpr int fwd_tile() { return HD == 128 ? 32 : 64; }",
         "constexpr int fwd_tile() { return 64; }")],
    # exp2 with denormal results kept
    "exp2_not_ftz": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : '
                      '"f"(x));', "y = exp2f(x);")],
    # the mask only on the tiles that cross an edge, at every head dim
    "mask_edge_tiles_only": [("const bool masked = HD < 128 || (causal",
                              "const bool masked = (causal")],
    # the blocks of one (b, h) after another, heaviest first within each
    "heads_in_turn": [
        ("const int bh = blockIdx.x;\n"
         "  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;",
         "const int bh = blockIdx.y;\n"
         "  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;"),
        ("const dim3 grid(B * H, S / kM);\n  flash_fwd_mma<HD><<<",
         "const dim3 grid(S / kM, B * H);\n  flash_fwd_mma<HD><<<")],
}
# the dq kernel's s and dp, one after the other and together
DQ_S_THEN_DP = """\
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t aq[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        ldsm_x4(aq[i], qw + i * kHeld + a_off + 16 * ks);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(bk[i], Kp + i * kWalk + 16 * np * kStr + b_off + 16 * ks);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mma6(sc[2 * np + half], sc2[2 * np + half], aq, bk, half);
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t ao[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        ldsm_x4(ao[i], ow + i * kHeld + a_off + 16 * ks);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bv[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(bv[i], Vp + i * kWalk + 16 * np * kStr + b_off + 16 * ks);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mma6(dc[2 * np + half], dc2[2 * np + half], ao, bv, half);
      }
    }
"""
DQ_S_AND_DP = """\
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t aq[3][4], ao[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ldsm_x4(aq[i], qw + i * kHeld + a_off + 16 * ks);
        ldsm_x4(ao[i], ow + i * kHeld + a_off + 16 * ks);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk[3][4], bv[3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          ldsm_x4(bk[i], Kp + i * kWalk + 16 * np * kStr + b_off + 16 * ks);
          ldsm_x4(bv[i], Vp + i * kWalk + 16 * np * kStr + b_off + 16 * ks);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mma6(sc[2 * np + half], sc2[2 * np + half], aq, bk, half);
          mma6(dc[2 * np + half], dc2[2 * np + half], ao, bv, half);
        }
      }
    }
"""
# name -> [(line, new line)] in flash_attention_bwd.cu: each undoes one
# choice of the design of K10's fp32 kernels
K10_F32_VARIANTS = {
    # tiles of 16 rows in both kernels at every head dim (the kernels: 32,
    # and 16 at hd 128)
    "f32_tile_16": [
        ("constexpr int f32_tile() { return HD == 128 ? 16 : 32; }",
         "constexpr int f32_tile() { return 16; }", MMA_HEADER)],
    # tiles of 32 rows at every head dim
    "f32_tile_32": [
        ("constexpr int f32_tile() { return HD == 128 ? 16 : 32; }",
         "constexpr int f32_tile() { return 32; }", MMA_HEADER)],
    # the dkv kernel declared with no minimum of blocks an SM (the kernel:
    # two, which lets ptxas take up to 255 registers a thread)
    "dkv_f32_one_block": [
        ("__global__ void __launch_bounds__(kThreads, 2)\n"
         "flash_bwd_dkv_f32mma(",
         "__global__ void __launch_bounds__(kThreads)\n"
         "flash_bwd_dkv_f32mma(")],
    # s and dp of the dq kernel in one loop over the k-steps (the kernel:
    # s, then dp)
    "dq_f32_s_dp_together": [
        (DQ_S_THEN_DP, DQ_S_AND_DP)],
    # s and dp of the dkv kernel summed in one accumulator, the small
    # products first in each k-step (the kernel: a big and a small sum)
    "dkv_f32_one_sum": [
        ("mma6(sb[2 * np + half], ss[2 * np + half], ak, bq, half);",
         "mma6_sum(sb[2 * np + half], ak, bq, half);"),
        ("mma6(pb[2 * np + half], ps[2 * np + half], av, bo, half);",
         "mma6_sum(pb[2 * np + half], av, bo, half);")],
    # the big part of s and dp (both kernels) summed over the k-steps in
    # the tensor cores' accumulator (the kernel: each k-step's from zero,
    # added in fp32)
    "f32_big_chained": [BIG_CHAINED],
    # dv and dk of the dkv kernel summed in the tensor cores' accumulators
    # over the whole walk (the kernel: each tile's share summed on its
    # own, then added in fp32)
    "dkv_f32_no_tile_sums": [
        ("mma6_sum(lv[half], pf[kk], bo, half);",
         "mma6_sum(dva[2 * j + half], pf[kk], bo, half);"),
        ("mma6_sum(lk[half], df[kk], bq, half);",
         "mma6_sum(dka[2 * j + half], df[kk], bq, half);"),
        ("dva[2 * j + half][e] += lv[half][e];", ""),
        ("dka[2 * j + half][e] += lk[half][e];", "")],
}
# name -> [(line, new line)] in flash_attention.cu: each undoes one choice
# of the design of K9 / K9-LSE's fp32 kernel (flash_fwd_f32mma)
K9_F32_VARIANTS = {
    # key tiles of 16 rows at every head dim (the kernel: 32, and 16 at
    # hd 128; f32_tile is shared with K10's fp32 kernels, which this group
    # does not time)
    "fwd_f32_tile_16": [
        ("constexpr int f32_tile() { return HD == 128 ? 16 : 32; }",
         "constexpr int f32_tile() { return 16; }", MMA_HEADER)],
    # key tiles of 32 rows at every head dim
    "fwd_f32_tile_32": [
        ("constexpr int f32_tile() { return HD == 128 ? 16 : 32; }",
         "constexpr int f32_tile() { return 32; }", MMA_HEADER)],
    # the big part of s chained over the k-steps
    "fwd_f32_big_chained": [BIG_CHAINED],
    # o summed in the tensor cores' accumulators over the whole walk (the
    # kernel: each key tile's share summed on its own, then added in fp32)
    "fwd_f32_no_tile_sums": [
        ("mma6_sum(lo[half], pf[kk], bv, half);",
         "mma6_sum(acc[2 * j + half], pf[kk], bv, half);"),
        ("for (int e = 0; e < 4; ++e) acc[2 * j + half][e] += lo[half][e];",
         "for (int e = 0; e < 4; ++e) {}")],
    # declared with no minimum of blocks an SM at every head dim, and for
    # two at every head dim (the kernel: two at hd 32, none at 64 and 128)
    "fwd_f32_no_min_blocks": [
        ("__launch_bounds__(kThreads, 2)\nflash_fwd_f32mma<32>(",
         "__launch_bounds__(kThreads)\nflash_fwd_f32mma<32>(")],
    "fwd_f32_min_blocks_2": [
        ("__launch_bounds__(kThreads)\nflash_fwd_f32mma(",
         "__launch_bounds__(kThreads, 2)\nflash_fwd_f32mma(")],
}
# name -> [(line, new line, file)]: each undoes one choice of K1's
# split-row path (csrc/cosine_gate.cu) or of its rule
# (kernels/cosine_weight.py::gate_chunks)
GATE_PY = os.path.join("src", "repro_torch", "kernels", "cosine_weight.py")
GATE_VARIANTS = {
    # the narrow path (one warp a row) at every shape, as before the split
    "gate_narrow": [("    if -(-B // 4) >= GATE_SMS or F < 2 * GATE_CHUNK:",
                     "    if True:", GATE_PY)],
    # other chunk sizes (the rule: 4,096 elements)
    **{f"gate_chunk_{n}": [("GATE_CHUNK = 4096", f"GATE_CHUNK = {n}",
                            GATE_PY)] for n in (2048, 8192, 16384)},
    # blocks of 128 and of 512 threads on the split path (the kernels: 256)
    **{f"gate_threads_{n}": [("constexpr int kSplitThreads = 256;",
                              f"constexpr int kSplitThreads = {n};")]
       for n in (128, 512)},
}
K9_F32_RUN = """
import sys, torch
sys.path.insert(0, 'src')
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as fa
usage = chip_smoke.ptxas_usage(_cuda.build()['log'])
gen = torch.Generator(device='cuda').manual_seed(5)
limits = ((chip_smoke.K10_REL['float32'], chip_smoke.K10_ATOL['float32']),
          (chip_smoke.LSE_REL, chip_smoke.LSE_ATOL))
for shape, dt, window in chip_smoke.K10_CASES:
    if dt != 'float32':
        continue
    q, k, v = (torch.randn(shape, generator=gen, device='cuda')
               for _ in range(3))
    kw = dict(causal=True, window=window)
    outs = fa.flash_attention_fwd_lse(q, k, v, **kw)
    exact = fa.flash_attention_fwd_lse_plain(q.double(), k.double(),
                                             v.double(), **kw)
    worst = [(d / lim).max().item() for d, lim in
             (chip_smoke._err_limit(o, e, rel, atol)
              for o, e, (rel, atol) in zip(outs, exact, limits))]
    ms = chip_smoke.device_ms(
        torch, lambda: fa.flash_attention_fwd_lse(q, k, v, **kw), 10)
    hd = shape[3]
    print(f'{shape}: {ms * 1e3:.2f} us; worst err / limit against fp64 '
          f'(out, lse) {worst[0]:.3g}, {worst[1]:.3g}; (registers, spill '
          f'bytes) {usage.get(f"flash_fwd_f32mma<{hd}>")}', flush=True)
"""
GATE_RUN = """
import sys, torch
sys.path.insert(0, 'src')
import chip_smoke
from repro_torch.core.weighting import xi_to_cos
from repro_torch.kernels import fused_sample as fs
gen = torch.Generator(device='cuda').manual_seed(7)
cos_xi = xi_to_cos(60.0)
for (W, B, F), dt in ((chip_smoke.LLM_GATE_SHAPE, torch.bfloat16),
                      ((2, 64, 64 * 960), torch.float32),
                      ((2, 64, 64 * 960), torch.bfloat16),
                      (chip_smoke.MAIN_SHAPE, torch.float32)):
    a = torch.randn((B, F), generator=gen, device='cuda')
    z = torch.randn((W, B, F), generator=gen, device='cuda')
    z[1] = a * 0.7 + 0.5 * z[1]
    z = z.to(dt)
    dz = torch.randn((W, B, F), generator=gen, device='cuda').to(dt)
    slot = torch.tensor([1], dtype=torch.int32, device='cuda')
    w, cot = fs.fused_sample_2d(slot, a, z, dz, cos_xi)
    w0, cot0 = fs.fused_sample_plain(slot, a, z, dz, cos_xi)
    err = max((w - w0).abs().max().item(), (cot - cot0).abs().max().item())
    ms = [chip_smoke.device_ms(torch, lambda: fs.fused_sample_2d(
        slot, a, z, d, cos_xi)) for d in (dz, None)]
    print(f'{(W, B, F)} {str(dt)[6:]}: {ms[0] * 1e3:.2f} us, weights-only '
          f'{ms[1] * 1e3:.2f} us; max |err| {err:.3g}', flush=True)
"""
K9_RUN = """
import sys, torch
sys.path.insert(0, 'src')
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as fa
usage = chip_smoke.ptxas_usage(_cuda.build()['log'])
gen = torch.Generator(device='cuda').manual_seed(3)
for shape, causal, window in chip_smoke.K9_CASES:
    q, k, v = (torch.randn(shape, generator=gen, device='cuda')
               .to(torch.bfloat16) for _ in range(3))
    kw = dict(causal=causal, window=window)
    out = fa.flash_attention(q, k, v, **kw)
    ref = fa.flash_attention_plain(q, k, v, **kw)
    err, worst = chip_smoke._per_element('flash_attention', str(shape),
                                         out, ref, chip_smoke.K9_REL_TOL,
                                         chip_smoke.K9_ATOL)
    ms = chip_smoke.device_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                                **kw), 10)
    print(f'{shape} window={window}: {ms * 1e3:.2f} us, worst err / '
          f'limit {worst:.3g}; flash_fwd_mma<{shape[3]}> (registers, '
          f'spill bytes) {usage.get(f"flash_fwd_mma<{shape[3]}>")}',
          flush=True)
"""
K10_F32_RUN = """
import sys, torch
sys.path.insert(0, 'src')
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention_bwd as fab
usage = chip_smoke.ptxas_usage(_cuda.build()['log'])
gen = torch.Generator(device='cuda').manual_seed(5)
rel, atol = chip_smoke.K10_REL['float32'], chip_smoke.K10_ATOL['float32']
for shape, dt, window in chip_smoke.K10_CASES:
    if dt != 'float32':
        continue
    kw = dict(causal=True, window=window)
    args = chip_smoke._k10_operands(torch, gen, shape, torch.float32, kw)
    outs = chip_smoke._k10(args, kw)
    exact = chip_smoke._k10(tuple(t.double() for t in args), kw, plain=True)
    worst = [(d / lim).max().item() for d, lim in
             (chip_smoke._err_limit(o, e, rel, atol)
              for o, e in zip(outs, exact))]
    ms = [chip_smoke.device_ms(torch, lambda: f(*args, **kw), 10)
          for f in (fab.flash_attention_bwd_dkv, fab.flash_attention_bwd_dq)]
    hd = shape[3]
    print(f'{shape}: dkv {ms[0] * 1e3:.2f} us, dq {ms[1] * 1e3:.2f} us; '
          f'worst err / limit against fp64 (dk, dv, dq) '
          f'{", ".join(f"{w:.3g}" for w in worst)}; (registers, spill '
          f'bytes) dkv {usage.get(f"flash_bwd_dkv_f32mma<{hd}>")}, dq '
          f'{usage.get(f"flash_bwd_dq_f32mma<{hd}>")}', flush=True)
"""
# group -> (source under CSRC, variants, the run of each)
GROUPS = {"k9": ("flash_attention.cu", K9_VARIANTS, K9_RUN),
          "k10_f32": ("flash_attention_bwd.cu", K10_F32_VARIANTS,
                      K10_F32_RUN),
          "k9_f32": ("flash_attention.cu", K9_F32_VARIANTS, K9_F32_RUN),
          "gate": ("cosine_gate.cu", GATE_VARIANTS, GATE_RUN)}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_variants: no CUDA device is available")
    known = {n: g for g, (_, vs, _) in GROUPS.items() for n in vs}
    names = sys.argv[1:] or list(known)
    unknown = [n for n in names if n not in known]
    if unknown:
        sys.exit(f"chip_variants: no variant {unknown}; "
                 f"known: {list(known)}")
    top = os.path.join(ROOT, "src", "repro_torch", "_build", "variants")
    failed = []
    for group, (source, variants, run) in GROUPS.items():
        chosen = [n for n in names if known[n] == group]
        if not chosen:
            continue
        for name in ["tree"] + chosen + ["tree"]:
            d = os.path.join(top, name)
            chip_mutants.mutated_copy(d, os.path.join(CSRC, source),
                                      variants.get(name, []), name)
            r = subprocess.run([sys.executable, "-c", run], cwd=d,
                               capture_output=True, text=True, timeout=600)
            for line in r.stdout.splitlines():
                print(f"[variant] {group} {name}: {line}", flush=True)
            if r.returncode != 0:
                print(f"[variant] {group} {name}: FAILED (rc "
                      f"{r.returncode}): {r.stderr[-2000:]}", flush=True)
                failed.append(name)
            shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(top, ignore_errors=True)
    if failed:
        sys.exit(f"chip_variants: FAILED: {failed}")
    print("chip_variants: done")


if __name__ == "__main__":
    main()
