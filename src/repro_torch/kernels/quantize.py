"""Stochastic-rounding quantiser with one absmax scale per tile: K3.

Replaces ``repro/kernels/quantize.py``: ``quantize_sr_2d`` (``_kernel``),
the encode hot path of the compressed wire and of the int8 / int4 workset
inserts.  For (T, L) values ``x`` and uniforms ``u`` in [0, 1):

    scale = max(absmax(x_t), 1e-12) / levels
    codes = int8(clip(floor(x / scale + u), -levels, levels))

with ``levels`` 127 (int8) or 7 (int4).  x is fp32 or bf16 (a bf16 row
is read as it is and widened in the kernel, as the TPU kernel widens its
block); u is fp32.  The uniforms are an operand, so the function is
deterministic in (x, u): on a CUDA tensor the wrapper launches
``csrc/quantize.cu``, whose codes and scales equal the plain version's
bit for bit; on a CPU tensor it runs the plain version, the counterpart
of ``repro/kernels/ref.py::quantize_sr_ref``.

Bandwidth-bound: x and u are read and the codes written (9 bytes an
element, 7 for bf16 x) plus one fp32 scale a tile.  At the workset
insert's (256, 256) that is 590,848 B, 0.176 us at 3.35 TB/s; at the LLM
cut tensor of a 4,096-token sequence a row, (2, 3,932,160), 21.1 us
(fp32) or 16.4 us (bf16).  Few wide rows take the kernel's split-row
path (:func:`quant_chunks`), with a (T, chunks) workspace allocated
here: two launches, one count.

``quantize_sr_2d`` is a ``torch.library`` op (``kernels/jobs.py``): under
the fleet's ``vmap`` its rule folds the jobs into the rows (the scales
are per row) and makes one call, one launch on the card.
"""
from __future__ import annotations

import torch

from . import _cuda
from .jobs import register_quantize

EPS = 1e-12
_X_DTYPES = tuple(_cuda.DTYPE_CODES)
# The split-row path of ``csrc/quantize.cu``: rows are cut into chunks of
# about QUANT_CHUNK elements, one block a (chunk, row), when the narrow
# path's ceil(T / 4) blocks (one warp a row) cannot fill the card's
# QUANT_SMS SMs and a row holds two chunks or more.  chip_variants.py
# times other chunk sizes and thresholds.
QUANT_CHUNK = 4096
QUANT_SMS = 132


def quantize_sr_plain(x, u, levels):
    """-> (codes int8 (T, L), scales fp32 (T,)): the CPU path and the
    kernel's oracle."""
    x = x.float()
    u = u.float()
    lv = float(levels)
    amax = x.abs().amax(dim=1)
    # divide by a tensor on x's device: on the card PyTorch turns division
    # by a Python scalar into multiplication by its reciprocal, which can
    # miss the IEEE quotient by an ulp
    scale = torch.clamp(amax, min=EPS) / torch.full_like(amax, lv)
    q = torch.clamp(torch.floor(x / scale[:, None] + u), -lv, lv)
    return q.to(torch.int8), scale


def quant_chunks(T: int, L: int) -> int:
    """Chunks a row of the (T, L) quantiser is cut into on the split-row
    path; 1 selects the narrow path (one warp a row)."""
    if -(-T // 4) >= QUANT_SMS or L < 2 * QUANT_CHUNK:
        return 1
    return -(-L // QUANT_CHUNK)


def check_operands(x, u) -> None:
    """K3's operand checks: contiguous (T, L) x (fp32 or bf16) and fp32 u
    on one CUDA device."""
    if x.dim() != 2 or x.dtype not in _X_DTYPES or 0 in x.shape:
        raise ValueError(f"quantize_sr_2d: x must be non-empty (T, L) "
                         f"float32 or bfloat16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if u.shape != x.shape or u.dtype != torch.float32 \
            or u.device != x.device:
        raise ValueError(f"quantize_sr_2d: u must be float32 "
                         f"{tuple(x.shape)} on {x.device}, got "
                         f"{tuple(u.shape)} {u.dtype} on {u.device}")
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("quantize_sr_2d: operands must be contiguous")


def _quantize_rows(x, u, levels):
    """K3 on (T, L) rows: one launch (the plain version on the CPU)."""
    if x.device.type == "cpu":
        return quantize_sr_plain(x, u, levels)
    check_operands(x, u)
    T, L = x.shape
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(T, dtype=torch.float32, device=x.device)
    chunks = quant_chunks(T, L)
    part = None if chunks == 1 else torch.empty(
        (T, chunks), dtype=torch.float32, device=x.device)
    _cuda.launch_quantize_sr("quantize_sr_2d", x=x, u=u, q=q, scale=scale,
                             part=part, levels=float(levels))
    return q, scale


K3_OP = register_quantize(_quantize_rows)


def quantize_sr_2d(x, u, levels):
    """K3.  x: (T, L) float32 or bfloat16, u: (T, L) float32; levels: max
    code magnitude.  -> (codes int8 (T, L), scales float32 (T,))."""
    return K3_OP(x, u, float(levels))
