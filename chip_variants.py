#!/usr/bin/env python3
"""Times source variants of K9's bf16 kernel (``flash_fwd_mma`` in
``src/repro_torch/csrc/flash_attention.cu``) on one NVIDIA GPU.

Each variant is a copy of ``src/`` and ``chip_smoke.py`` with some lines
of the kernel's source replaced (``chip_mutants.mutated_copy``), built in
a process of its own.  That process times K9 (device µs per call, CUDA
graph and events, as ``chip_smoke.py`` times it) at the shapes of
``chip_smoke.K9_CASES``, holds every element of each output to the
smoke's limit, and prints one line a shape with ptxas's registers and
spills of the kernel.  The tree as it
stands runs first and last, so that the spread between two runs of the
same code shows beside the variants.

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
SOURCE = os.path.join("src", "repro_torch", "csrc", "flash_attention.cu")
# name -> [(line, new line)] in SOURCE: each undoes one choice of the
# kernel's design
VARIANTS = {
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
        ("const dim3 grid(B * H, S / kM);", "const dim3 grid(S / kM, B * H);")],
}
RUN = """
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_variants: no CUDA device is available")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        sys.exit(f"chip_variants: no variant {unknown}; "
                 f"known: {list(VARIANTS)}")
    top = os.path.join(ROOT, "src", "repro_torch", "_build", "variants")
    failed = []
    for name in ["tree"] + names + ["tree"]:
        d = os.path.join(top, name)
        chip_mutants.mutated_copy(d, SOURCE, VARIANTS.get(name, []), name)
        r = subprocess.run([sys.executable, "-c", RUN], cwd=d,
                           capture_output=True, text=True, timeout=600)
        for line in r.stdout.splitlines():
            print(f"[variant] {name}: {line}", flush=True)
        if r.returncode != 0:
            print(f"[variant] {name}: FAILED (rc {r.returncode}): "
                  f"{r.stderr[-2000:]}", flush=True)
            failed.append(name)
        shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(top, ignore_errors=True)
    if failed:
        sys.exit(f"chip_variants: FAILED: {failed}")
    print("chip_variants: done")


if __name__ == "__main__":
    main()
