"""Algorithm-2 cosine gate over materialised rows: K2a and K2b.

Replaces ``repro/kernels/cosine_weight.py``: ``cosine_weight_2d``
(``_kernel``, K2a: weights and the weighted cotangent) and
``cosine_weights_2d`` (``_kernel_weights_only``, K2b: weights only).  On a
CUDA tensor the wrapper launches ``csrc/cosine_gate.cu`` with no ring slot;
on a CPU tensor it runs the plain PyTorch version beside it, which is also
the kernel's oracle on the card.

The gate is bandwidth-bound: K2a reads three (B, F) operands and writes
one plus the (B,) weights, K2b reads two and writes the weights, at about
7 flops per element.  Its least time on an H100 is those bytes over
3.35 TB/s; at the paper's B = F = 256 in fp32 that is 0.31 us for K2a and
0.16 us for K2b, so at that size a launch costs more than the data.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cuda

EPS = 1e-12
_RING_DTYPES = tuple(_cuda.DTYPE_CODES)
# The split-row path of ``csrc/cosine_gate.cu`` (K1, K2a, K2b, K4, K5):
# rows are cut into chunks of about GATE_CHUNK elements, one block a
# (chunk, row), when the narrow path's ceil(B / 4) blocks (one warp a row)
# cannot fill the card's GATE_SMS SMs and a row holds two chunks or more.
# chip_variants.py times other chunk sizes.
GATE_CHUNK = 4096
GATE_SMS = 132


def f32_threshold(cos_xi) -> float:
    """cos ξ as the float32 value every version compares against."""
    return float(np.float32(cos_xi))


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernel's oracle)
# --------------------------------------------------------------------------
def gate_weights_plain(a, s, thresh: float):
    """(B, F) x2 -> (B,) fp32 row cosines, zero below ``thresh``."""
    a = a.float()
    s = s.float()
    num = (a * s).sum(dim=1)
    den = torch.sqrt((a * a).sum(dim=1) * (s * s).sum(dim=1))
    w = num / torch.clamp(den, min=EPS)
    return torch.where(w < thresh, 0.0, w)


def cosine_weights_plain(ad_hoc, stale, cos_xi):
    return gate_weights_plain(ad_hoc, stale, f32_threshold(cos_xi))


def cosine_weight_plain(ad_hoc, stale, dz, cos_xi):
    w = gate_weights_plain(ad_hoc, stale, f32_threshold(cos_xi))
    return w, dz.float() * w[:, None]


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------
def gate_chunks(B: int, F: int) -> int:
    """Chunks a row of the (B, F) gate is cut into on the split-row path;
    1 selects the narrow path (one warp a row)."""
    if -(-B // 4) >= GATE_SMS or F < 2 * GATE_CHUNK:
        return 1
    return -(-F // GATE_CHUNK)


def gate_workspace(B: int, F: int, device):
    """The split-row path's (B, chunks, 3) fp32 partial sums, or None on
    the narrow path."""
    chunks = gate_chunks(B, F)
    if chunks == 1:
        return None
    return torch.empty((B, chunks, 3), dtype=torch.float32, device=device)


def check_operands(name: str, ad_hoc, rows) -> None:
    """Raise unless the operands are what ``cosine_gate.cu`` takes:
    contiguous CUDA tensors on one device, fp32 ``ad_hoc`` of shape
    (B, F), and ``rows`` (each (..., B, F)) of one dtype in fp32/bf16."""
    dev = ad_hoc.device
    if ad_hoc.dim() != 2 or ad_hoc.dtype != torch.float32:
        raise ValueError(f"{name}: ad_hoc must be (B, F) float32, got "
                         f"{tuple(ad_hoc.shape)} {ad_hoc.dtype}")
    B, F = ad_hoc.shape
    if B == 0 or F == 0:
        raise ValueError(f"{name}: empty operand {tuple(ad_hoc.shape)}")
    dtype = rows[0].dtype
    if dtype not in _RING_DTYPES:
        raise ValueError(f"{name}: stale operands must be float32 or "
                         f"bfloat16, got {dtype}")
    for t in (ad_hoc, *rows):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in rows:
        if t.dtype != dtype or tuple(t.shape[-2:]) != (B, F):
            raise ValueError(f"{name}: operand {tuple(t.shape)} {t.dtype} "
                             f"does not match ({B}, {F}) {dtype}")


def check_rows(name: str, ad_hoc, stale, dz=None) -> None:
    """K2's operand checks: materialised (B, F) rows."""
    rows = (stale,) if dz is None else (stale, dz)
    check_operands(name, ad_hoc, rows)
    if any(r.dim() != 2 for r in rows):
        raise ValueError(f"{name}: stale and dz must be (B, F)")


def cosine_weights_2d(ad_hoc, stale, cos_xi):
    """K2b.  ad_hoc, stale: (B, F).  -> (B,) fp32 weights."""
    if ad_hoc.device.type == "cpu":
        return cosine_weights_plain(ad_hoc, stale, cos_xi)
    check_rows("cosine_weights_2d", ad_hoc, stale)
    w = torch.empty(ad_hoc.shape[0], dtype=torch.float32,
                    device=ad_hoc.device)
    _cuda.launch_cosine_gate("cosine_weights_2d", slot=None, n_slots=1,
                             slot_stride=0, a=ad_hoc, z=stale, dz=None, w=w,
                             cot=None, part=gate_workspace(*ad_hoc.shape,
                                                           ad_hoc.device),
                             thresh=f32_threshold(cos_xi))
    return w


def cosine_weight_2d(ad_hoc, stale, dz, cos_xi):
    """K2a.  ad_hoc, stale, dz: (B, F).  -> (weights (B,) fp32, weighted
    cotangent (B, F) fp32).  The reference returns the cotangent in dz's
    dtype; the engine always passes fp32 dz, where the two agree."""
    if ad_hoc.device.type == "cpu":
        return cosine_weight_plain(ad_hoc, stale, dz, cos_xi)
    check_rows("cosine_weight_2d", ad_hoc, stale, dz)
    w = torch.empty(ad_hoc.shape[0], dtype=torch.float32,
                    device=ad_hoc.device)
    cot = torch.empty(ad_hoc.shape, dtype=torch.float32, device=ad_hoc.device)
    _cuda.launch_cosine_gate("cosine_weight_2d", slot=None, n_slots=1,
                             slot_stride=0, a=ad_hoc, z=stale, dz=dz, w=w,
                             cot=cot, part=gate_workspace(*ad_hoc.shape,
                                                          ad_hoc.device),
                             thresh=f32_threshold(cos_xi))
    return w, cot
