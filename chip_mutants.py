#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s limit for K9 on one NVIDIA GPU.

Builds the flash-attention forward (``src/repro_torch/csrc/
flash_attention.cu``) with one small fault at a time (a key tile, or a
single key, too few or too many for some rows of a 4,096-token prompt),
runs the smoke's serving kernel phase on it and requires that phase to
fail on K9:

  * ``window_tile_late``: the window's first key tile is skipped for the
    query tiles from row 3,584 on;
  * ``diagonal_tile_late``: the diagonal key tile is skipped for the
    query tiles from row 3,584 on;
  * ``diagonal_key_late``: an off-by-one in the causal mask hides each
    row's own key, for the query tiles from row 3,584 on;
  * ``window_edge``: an off-by-one in the window keeps one key too many,
    ``window`` positions behind each row.

    python3 chip_mutants.py

Each mutant is a copy of ``src/`` and ``chip_smoke.py`` under
``src/repro_torch/_build/mutants/`` (removed afterwards).  Prints each
mutant's failure line beside the limit of the whole-tensor check it
replaced (2^-7 of the largest output); exits non-zero if a mutant
passes.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join("src", "repro_torch", "csrc", "flash_attention.cu")
LATE = 3584
MUTANTS = {
    "window_tile_late": (
        "const int lo = window ? max(q0 - window, 0) / kBK : 0;",
        f"const int lo = window ? max(q0 - window, 0) / kBK"
        f" + (q0 >= {LATE}) : 0;"),
    "diagonal_tile_late": (
        "const int hi = causal ? min((q0 + kBQ + kBK - 1) / kBK, n_kb) : n_kb;",
        f"const int hi = causal ? min((q0 + kBQ + kBK - 1) / kBK, n_kb)"
        f" - (q0 >= {LATE}) : n_kb;"),
    "diagonal_key_late": (
        "if (causal) vis = dist >= 0;",
        f"if (causal) vis = q0 >= {LATE} ? dist > 0 : dist >= 0;"),
    "window_edge": (
        "if (window) vis = vis && dist < window;",
        "if (window) vis = vis && dist <= window;"),
}
RUN = ("import sys, torch; sys.path.insert(0, 'src'); "
       "torch.backends.cuda.matmul.allow_tf32 = False; "
       "import chip_smoke; chip_smoke.phase_serve_kernels(torch)")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_mutants: no CUDA device is available")
    top = os.path.join(ROOT, "src", "repro_torch", "_build", "mutants")
    survived = []
    for name, (good, bad) in MUTANTS.items():
        d = os.path.join(top, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "src"), os.path.join(d, "src"),
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
        path = os.path.join(d, SOURCE)
        with open(path) as f:
            text = f.read()
        if good not in text:
            sys.exit(f"chip_mutants: {name}: the line to mutate is gone "
                     f"from {SOURCE}")
        with open(path, "w") as f:
            f.write(text.replace(good, bad))
        r = subprocess.run([sys.executable, "-c", RUN], cwd=d,
                           capture_output=True, text=True, timeout=600)
        line = next((ln for ln in (r.stdout + r.stderr).splitlines()
                     if "FAILED" in ln), "")
        caught = r.returncode != 0 and "flash_attention" in line
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
        if not caught:
            survived.append(name)
        shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(top, ignore_errors=True)
    if survived:
        sys.exit(f"chip_mutants: FAILED: {survived} passed the smoke's "
                 f"K9 check")
    print("chip_mutants: every mutant caught")


if __name__ == "__main__":
    main()
