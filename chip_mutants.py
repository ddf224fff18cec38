#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s per-element limits for K9 and
K10, of its check of K1 at the LLM width, and of its bitwise checks of
the AdaGrad table kernels (K7), on one NVIDIA GPU.

Builds the flash-attention forward (``src/repro_torch/csrc/
flash_attention.cu``) or backward (``flash_attention_bwd.cu``), or the
gate (``cosine_gate.cu``), with one small fault at a time (a key tile, or
a single key, too few or too many for some rows of a 4,096-token
sequence; an operand rounded once; a chunk of a row left out), runs the
smoke's check of that kernel on it and requires it to fail on the
kernel.
K9's bf16 kernel (``flash_fwd_mma``), in the serving kernel phase:

  * ``window_tile_late``: the window's first key tile is skipped for the
    query tiles from row 3,584 on;
  * ``diagonal_tile_late``: the diagonal key tile is skipped for the
    query tiles from row 3,584 on;
  * ``diagonal_key_late``: an off-by-one in the causal mask hides each
    row's own key, for the query tiles from row 3,584 on;
  * ``window_edge``: an off-by-one in the window keeps one key too many,
    ``window`` positions behind each row;
  * ``k9_p_lo_dropped``: for the query tiles from row 3,584 on, o takes
    p's bf16 high half alone (p rounded once to bf16, its low half
    dropped), so the per-element limit must catch single rounding.

K10's bf16 kernels, in the training kernel phase:

  * ``dkv_diagonal_key_late``: the mask of the dkv kernel is shifted by
    one for the key tiles from row 3,584 on, hiding each of those keys'
    own query (the pair on the diagonal) from dk and dv;
  * ``dkv_diagonal_tile_late``: the dkv kernel skips the diagonal query
    tile of the key tiles from row 3,584 on;
  * ``dkv_dv_diagonal_late``: for the key tiles from row 3,584 on, dv
    alone misses each key's own query (dk keeps it);
  * ``dkv_lse_batch_row0``: the dkv kernel reads the lse and D rows of
    batch row 0 for every batch row, which only the B = 2 cases show;
  * ``dkv_p_lo_dropped``: for the key tiles from row 3,584 on, dv takes
    p's bf16 high half alone (p rounded once to bf16, its low half
    dropped), so the per-element limit must catch single rounding;
  * ``dq_diagonal_key_late``: the mask of the dq kernel is shifted by one
    for the query tiles from row 3,584 on, hiding each of those queries'
    own key from dq.

K10's fp32 kernels (``flash_bwd_dkv_f32mma``, ``flash_bwd_dq_f32mma``),
which take every operand as three bf16 parts, in the same phase:

  * ``dkv_f32_split_dropped``: for the key tiles from row 3,584 on, dv
    takes p's first bf16 part alone (p rounded once to bf16);
  * ``dq_f32_split_dropped``: for the query tiles from row 3,584 on, dq
    takes ds's first bf16 part alone.

K9-LSE's fp32 kernel (``flash_fwd_f32mma``), in the same phase:

  * ``k9_f32_split_dropped``: for the query tiles from row 3,584 on, o
    takes p's first bf16 part alone (its second and third zeroed).

K1's split-row path (``csrc/cosine_gate.cu``), in the smoke's check at
the LLM cut tensor (``_gate_at_llm_width``):

  * ``gate_chunk_dropped``: pass 1 skips the first chunk of each row.

K7's table kernel (``csrc/fused_adagrad.cu``), in the smoke's AdaGrad
kernel phase (``phase_adagrad_kernels``), whose checks are bitwise:

  * ``adagrad_last_chunk_dropped``: the launch's last block (the last
    chunk of the table's last leaf) processes nothing;
  * ``adagrad_scale_ignored``: the mask is never applied.

    python3 chip_mutants.py               # every mutant
    python3 chip_mutants.py NAME [NAME]   # the named ones

Each mutant is a copy of ``src/`` and ``chip_smoke.py`` under
``src/repro_torch/_build/mutants/`` (removed afterwards).  Prints each
mutant's failure line beside the limit of the whole-tensor check it
replaced (2^-7 of the largest output), or for a bitwise check the
elements that differ and the largest difference (the limit is 0); exits
non-zero if a mutant passes.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("src", "repro_torch", "csrc")
LATE = 3584
# name -> (line, mutated line); K9's are checked by the serving
# kernel phase, K10's by the training kernel phase
MUTANTS = {
    "window_tile_late": (
        "const int lo = window ? max(q0 - window, 0) / kN : 0;",
        f"const int lo = window ? max(q0 - window, 0) / kN"
        f" + (q0 >= {LATE}) : 0;"),
    "diagonal_tile_late": (
        "const int hi = causal ? min((q0 + kM + kN - 1) / kN, n_kb) : n_kb;",
        f"const int hi = causal ? min((q0 + kM + kN - 1) / kN, n_kb)"
        f" - (q0 >= {LATE}) : n_kb;"),
    "diagonal_key_late": (
        "bool vis = !causal || dist >= 0;",
        f"bool vis = !causal || (q0 >= {LATE} ? dist > 0 : dist >= 0);"),
    "window_edge": (
        "vis = vis && (!window || dist < window);",
        "vis = vis && (!window || dist <= window);"),
    "k9_p_lo_dropped": (
        "split_frag(s[2 * kk], s[2 * kk + 1], ph, pl);",
        f"split_frag(s[2 * kk], s[2 * kk + 1], ph, pl);"
        f" if (q0 >= {LATE}) pl[0] = pl[1] = pl[2] = pl[3] = 0u;"),
    "dkv_diagonal_key_late": (
        "const int dist = qt * kN + qi - (key + 8 * (e >> 1));",
        f"const int dist = qt * kN + qi - (key + 8 * (e >> 1))"
        f" - (k0 >= {LATE});"),
    "dkv_diagonal_tile_late": (
        "const int lo = causal ? k0 / kN : 0;",
        f"const int lo = causal ? k0 / kN + (k0 >= {LATE}) : 0;"),
    "dkv_dv_diagonal_late": (
        "s[n][e] = p;",
        f"s[n][e] = k0 >= {LATE} && dist == 0 ? 0.f : p;"),
    "dkv_lse_batch_row0": (
        "const long long lrow = static_cast<long long>(bh) * S;",
        "const long long lrow = static_cast<long long>(h) * S;"),
    "dkv_p_lo_dropped": (
        "split_frag(s[2 * kk], s[2 * kk + 1], ph, pl);",
        f"split_frag(s[2 * kk], s[2 * kk + 1], ph, pl);"
        f" if (k0 >= {LATE}) pl[0] = pl[1] = pl[2] = pl[3] = 0u;"),
    "dq_diagonal_key_late": (
        "const int dist = row + 8 * r - (kt * kN + 8 * n + 2 * t + (e & 1));",
        f"const int dist = row + 8 * r - (kt * kN + 8 * n + 2 * t + (e & 1))"
        f" - (q0 >= {LATE});"),
    "dkv_f32_split_dropped": (
        "split3_frag(sb[2 * kk], sb[2 * kk + 1], pf[kk]);",
        f"split3_frag(sb[2 * kk], sb[2 * kk + 1], pf[kk]); if (k0 >= {LATE})"
        f" for (int i = 0; i < 4; ++i) pf[kk][1][i] = pf[kk][2][i] = 0u;"),
    "dq_f32_split_dropped": (
        "split3_frag(sc[2 * kk], sc[2 * kk + 1], dsf[kk]);",
        f"split3_frag(sc[2 * kk], sc[2 * kk + 1], dsf[kk]); if (q0 >= {LATE})"
        f" for (int i = 0; i < 4; ++i) dsf[kk][1][i] = dsf[kk][2][i] = 0u;"),
    "k9_f32_split_dropped": (
        "split3_frag(sb[2 * kk], sb[2 * kk + 1], pf[kk]);",
        f"split3_frag(sb[2 * kk], sb[2 * kk + 1], pf[kk]); if (q0 >= {LATE})"
        f" for (int i = 0; i < 4; ++i) pf[kk][1][i] = pf[kk][2][i] = 0u;"),
    "gate_chunk_dropped": (
        "    gate_sums<C, kVec>(ar, zr, zscale, j, num, aa, zz);\n"
        "  block_sums(num, aa, zz);",
        "    if (c != 0) gate_sums<C, kVec>(ar, zr, zscale, j, num, aa, zz);\n"
        "  block_sums(num, aa, zz);"),
    "adagrad_last_chunk_dropped": (
        "const long long end = min(begin + kChunk, L.n);",
        "const long long end = blockIdx.x + 1 == gridDim.x"
        " ? begin : min(begin + kChunk, L.n);"),
    "adagrad_scale_ignored": (
        "const Step st{neg_lr, eps, scale ? *scale : 1.f, scale != nullptr};",
        "const Step st{neg_lr, eps, scale ? *scale : 1.f, false};"),
}
# K10's mutants: name -> the wrapper whose check must fail
K10_MUTANTS = {name: "flash_attention_bwd_dq" if name.startswith("dq_")
               else "flash_attention_bwd_dkv"
               for name in MUTANTS if name.startswith(("dkv_", "dq_"))}
# every mutant: name -> (its source under CSRC, the smoke's function that
# must fail on it, the wrapper its failure names); K9's bf16 mutants are
# checked by the serving kernel phase
TARGETS = {
    "k9_f32_split_dropped": ("flash_attention.cu", "phase_train_kernels",
                             "flash_attention_fwd_lse"),
    "gate_chunk_dropped": ("cosine_gate.cu", "_gate_at_llm_width",
                           "fused_sample_2d"),
    "adagrad_last_chunk_dropped": ("fused_adagrad.cu",
                                   "phase_adagrad_kernels", "fused_adagrad"),
    "adagrad_scale_ignored": ("fused_adagrad.cu", "phase_adagrad_kernels",
                              "fused_adagrad"),
    **{name: ("flash_attention_bwd.cu", "phase_train_kernels", kernel)
       for name, kernel in K10_MUTANTS.items()},
}
for _name in MUTANTS:
    TARGETS.setdefault(_name, ("flash_attention.cu", "phase_serve_kernels",
                               "flash_attention"))
RUN = ("import sys, torch; sys.path.insert(0, 'src'); "
       "torch.backends.cuda.matmul.allow_tf32 = False; "
       "import chip_smoke; chip_smoke.{}(torch)")


def mutated_copy(d: str, source: str, lines: list, name: str) -> None:
    """A copy of ``src/`` and ``chip_smoke.py`` under ``d`` with each
    (line, new line) of ``lines`` replaced in ``source`` (a path under
    the root), or in the path a third element names; exits if a line is
    not in its file exactly once."""
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(d, "src"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
    for good, bad, *where in lines:
        path = os.path.join(d, where[0] if where else source)
        with open(path) as f:
            text = f.read()
        if text.count(good) != 1:
            sys.exit(f"{name}: the line to replace is not in "
                     f"{os.path.relpath(path, d)} once but "
                     f"{text.count(good)} times: {good!r}")
        with open(path, "w") as f:
            f.write(text.replace(good, bad))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_mutants: no CUDA device is available")
    names = sys.argv[1:] or list(MUTANTS)
    unknown = [n for n in names if n not in MUTANTS]
    if unknown:
        sys.exit(f"chip_mutants: no mutant {unknown}; known: "
                 f"{list(MUTANTS)}")
    top = os.path.join(ROOT, "src", "repro_torch", "_build", "mutants")
    survived = []
    for name in names:
        good, bad = MUTANTS[name]
        source, phase, kernel = TARGETS[name]
        d = os.path.join(top, name)
        mutated_copy(d, os.path.join(CSRC, source), [(good, bad)], name)
        r = subprocess.run([sys.executable, "-c", RUN.format(phase)], cwd=d,
                           capture_output=True, text=True, timeout=600)
        line = next((ln for ln in (r.stdout + r.stderr).splitlines()
                     if "FAILED" in ln), "")
        caught = r.returncode != 0 and f"FAILED: {kernel} " in line
        print(f"[mutant] {name}: {'caught' if caught else 'PASSED'} "
              f"(rc {r.returncode}) {line}", flush=True)
        m = re.search(r"max \|err\| ([0-9.e+-]+), largest \|ref\| "
                      r"([0-9.e+-]+)", line)
        if m:
            err, ref = float(m.group(1)), float(m.group(2))
            print(f"[mutant] {name}: max |err| {err:.4g} against the "
                  f"whole-tensor limit 2^-7 x {ref:.4g} = "
                  f"{ref / 128:.4g}: "
                  f"{'caught' if err > ref / 128 else 'missed'} by it",
                  flush=True)
        m = re.search(r"\((\d+) elements differ, max \|diff\| (\S+)\)",
                      line)
        if m:
            print(f"[mutant] {name}: {m.group(1)} elements differ from the "
                  f"plain version (max |diff| {m.group(2)}) where the check "
                  f"allows none", flush=True)
        if not caught:
            survived.append(name)
        shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(top, ignore_errors=True)
    if survived:
        sys.exit(f"chip_mutants: FAILED: {survived} passed the smoke's "
                 f"K9 / K10 / K1 / K7 checks")
    print("chip_mutants: every mutant caught")


if __name__ == "__main__":
    main()
