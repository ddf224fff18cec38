"""Stochastic-rounding quantiser with one absmax scale per tile: K3.

Replaces ``repro/kernels/quantize.py``: ``quantize_sr_2d`` (``_kernel``),
the encode hot path of the compressed wire and of the int8 / int4 workset
inserts.  For (T, L) values ``x`` and uniforms ``u`` in [0, 1):

    scale = max(absmax(x_t), 1e-12) / levels
    codes = int8(clip(floor(x / scale + u), -levels, levels))

with ``levels`` 127 (int8) or 7 (int4).  The uniforms are an operand, so
the function is deterministic in (x, u): on a CUDA tensor the wrapper
launches ``csrc/quantize.cu``, whose codes and scales equal the plain
version's bit for bit; on a CPU tensor it runs the plain version, the
counterpart of ``repro/kernels/ref.py::quantize_sr_ref``.

Bandwidth-bound: x and u are read and the codes written (9 bytes an
element) plus one fp32 scale a tile.  At the workset insert's (256, 256)
that is 590,848 B, 0.176 us at 3.35 TB/s.

``quantize_sr_2d`` is a ``torch.library`` op (``kernels/jobs.py``): under
the fleet's ``vmap`` its rule folds the jobs into the rows (the scales
are per row) and makes one call, one launch on the card.
"""
from __future__ import annotations

import torch

from . import _cuda
from .jobs import register_quantize

EPS = 1e-12


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


def check_operands(x, u) -> None:
    """K3's operand checks: contiguous fp32 (T, L) x and u on one CUDA
    device."""
    if x.dim() != 2 or x.dtype != torch.float32 or 0 in x.shape:
        raise ValueError(f"quantize_sr_2d: x must be non-empty (T, L) "
                         f"float32, got {tuple(x.shape)} {x.dtype}")
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
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    _cuda.launch_quantize_sr("quantize_sr_2d", x=x, u=u, q=q, scale=scale,
                             levels=float(levels))
    return q, scale


K3_OP = register_quantize(_quantize_rows)


def quantize_sr_2d(x, u, levels):
    """K3.  x, u: (T, L) float32; levels: max code magnitude.  -> (codes
    int8 (T, L), scales float32 (T,))."""
    return K3_OP(x, u, float(levels))
