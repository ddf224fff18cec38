"""Fused workset sample: the Algorithm-2 gate read straight off the ring.

K1 replaces ``repro/kernels/fused_sample.py``: ``fused_sample_2d``
(``_kernel_f32``), over an fp32 or bf16 ring.  It gathers ring slot
``slot``, takes each row's cosine of the ad-hoc statistic against the
stale Z, zeroes it below cos ξ and scales the stale ∇Z by it, so no copy
of the sampled entry is ever written to device memory.  K4
(``fused_sample_q8_2d``, ``_kernel_q8``) and K5 (``fused_sample_q4_2d``,
``_kernel_q4``) do the same over the quantised rings: int8 codes, or two
int4 codes a byte (element 2j in the low nibble, each stored as code + 8),
with one fp32 scale per row, dequantised in registers.

The TPU kernels took the slot as a scalar-prefetch operand; here ``slot``
is a one-element int32 tensor on the card that ``csrc/cosine_gate.cu``
reads itself, so a local update never waits for the host to learn which
slot it drew.  ``dz_ring=None`` gives weights only (Party B's use: the
reference passes the ∇Z ring twice and drops the cotangent).

Bandwidth-bound: one slot of z (and dz) plus the ad-hoc rows are read and
the weights (and cotangent) written, at about 7 flops per element.  At the
paper's W = 5, B = F = 256 that is 1.05 MB over an fp32 ring (0.31 us at
3.35 TB/s), 658,432 B over the int8 ring (0.197 us) and 592,896 B over
the int4 ring (0.177 us).  At the LLM cut tensor (W, B, F) = (2, 2,
3,932,160) over a bf16 ring it is 94.4 MB (28.2 us): there the kernel
takes its split-row path (``cosine_weight.gate_chunks``), two launches
over a (B, chunks, 3) workspace of partial sums that the wrapper
allocates, still one launch of K1 in :data:`_cuda.LAUNCHES`.

K6 (``fused_dequant_q8_2d``, ``_kernel_dq8``) and K11
(``fused_dequant_q4_2d``, ``_kernel_dq4``) gather one slot of an int8 or
packed int4 ring and return it dequantised, (B, F) fp32, without the
gate: the serving engine's read of its decode activation ring, once per
decode step.  They share the ring codecs of ``csrc/cosine_gate.cu`` with
K4 / K5 and are bitwise their plain versions (one multiply an element).
Bytes bound them, and at the serving shape (W = 4, C = 8, F = 960) the
launch is the cost.
"""
from __future__ import annotations

import torch

from . import _cuda
from .cosine_weight import (check_operands, f32_threshold,
                            gate_weights_plain, gate_workspace)

QUANT_NAMES = {8: "fused_sample_q8_2d", 4: "fused_sample_q4_2d"}
DEQUANT_NAMES = {8: "fused_dequant_q8_2d", 4: "fused_dequant_q4_2d"}


def fused_sample_plain(slot, ad_hoc, z_ring, dz_ring, cos_xi):
    """Gather slot, gate, scale: the CPU path and the kernel's oracle."""
    idx = slot.reshape(1).long()
    w = gate_weights_plain(ad_hoc, z_ring.index_select(0, idx)[0],
                           f32_threshold(cos_xi))
    if dz_ring is None:
        return w, None
    return w, dz_ring.index_select(0, idx)[0].float() * w[:, None]


def check_ring(slot, ad_hoc, z_ring, dz_ring) -> None:
    """K1's operand checks: (W, B, F) rings and a one-element int32 slot
    on the operands' device."""
    rings = (z_ring,) if dz_ring is None else (z_ring, dz_ring)
    check_operands("fused_sample_2d", ad_hoc, rings)
    if any(r.dim() != 3 or r.shape != z_ring.shape for r in rings):
        raise ValueError("fused_sample_2d: rings must be (W, B, F) alike")
    if (slot.dtype != torch.int32 or slot.numel() != 1
            or slot.device != ad_hoc.device):
        raise ValueError("fused_sample_2d: slot must be one int32 on "
                         f"{ad_hoc.device}, got {slot.dtype} "
                         f"{tuple(slot.shape)} on {slot.device}")


def fused_sample_2d(slot, ad_hoc, z_ring, dz_ring, cos_xi):
    """K1.  slot: (1,) int32 on the ring's device; ad_hoc: (B, F);
    z_ring / dz_ring: (W, B, F) fp32 or bf16 (``dz_ring=None``: weights
    only).  -> (weights (B,) fp32, weighted cotangent (B, F) fp32 or
    None)."""
    if ad_hoc.device.type == "cpu":
        return fused_sample_plain(slot, ad_hoc, z_ring, dz_ring, cos_xi)
    check_ring(slot, ad_hoc, z_ring, dz_ring)
    B, F = ad_hoc.shape
    w = torch.empty(B, dtype=torch.float32, device=ad_hoc.device)
    cot = None if dz_ring is None else torch.empty(
        (B, F), dtype=torch.float32, device=ad_hoc.device)
    _cuda.launch_cosine_gate("fused_sample_2d", slot=slot,
                             n_slots=z_ring.shape[0], slot_stride=B * F,
                             a=ad_hoc, z=z_ring, dz=dz_ring, w=w, cot=cot,
                             part=gate_workspace(B, F, ad_hoc.device),
                             thresh=f32_threshold(cos_xi))
    return w, cot


# --------------------------------------------------------------------------
# K4 / K5: the int8 and packed int4 rings
# --------------------------------------------------------------------------
def pack_nibbles(q):
    """Signed int4 codes (..., Fp) in [-7, 7] (Fp even) -> packed uint8
    (..., Fp // 2): byte j holds element 2j in the low nibble and 2j + 1
    in the high, each biased by +8 (the layout K5 reads, and the wire
    codec's)."""
    b = (q + 8).to(torch.uint8)
    return b[..., 0::2] | (b[..., 1::2] << 4)


def unpack_nibbles(packed):
    """Packed uint8 (..., P) -> signed int4 codes (..., 2P) as int8 (the
    inverse of :func:`pack_nibbles`)."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[:-1] + (-1,))


def dequant_rows(codes, scale, bits: int):
    """(B, F) int8 or (B, F / 2) packed codes and (B,) row scales ->
    (B, F) fp32, in the reference's order: code to float, times the row
    scale."""
    if bits == 4:
        codes = unpack_nibbles(codes)
    return codes.float() * scale[:, None]


def fused_sample_quant_plain(bits: int, slot, ad_hoc, zq, zscale, dzq,
                             dzscale, cos_xi):
    """Gather slot, dequantise, gate, scale: the CPU path and the
    oracle of K4 (``bits=8``) and K5 (``bits=4``)."""
    idx = slot.reshape(1).long()

    def take(q, s):
        return dequant_rows(q.index_select(0, idx)[0],
                            s.index_select(0, idx)[0], bits)
    w = gate_weights_plain(ad_hoc, take(zq, zscale), f32_threshold(cos_xi))
    if dzq is None:
        return w, None
    return w, take(dzq, dzscale) * w[:, None]


def check_quant_ring(bits: int, slot, ad_hoc, zq, zscale, dzq,
                     dzscale) -> None:
    """K4 / K5's operand checks: contiguous (W, B, F) int8 or
    (W, B, F / 2) uint8 codes with (W, B) fp32 row scales, a (B, F) fp32
    ad_hoc and a one-element int32 slot, all on one device."""
    name = QUANT_NAMES[bits]
    dev = ad_hoc.device
    if ad_hoc.dim() != 2 or ad_hoc.dtype != torch.float32 \
            or 0 in ad_hoc.shape:
        raise ValueError(f"{name}: ad_hoc must be non-empty (B, F) float32, "
                         f"got {tuple(ad_hoc.shape)} {ad_hoc.dtype}")
    B, F = ad_hoc.shape
    if bits == 4 and F % 2:
        raise ValueError(f"{name}: ad_hoc's F must be even (pad it to the "
                         f"packed width), got {F}")
    code_dtype = torch.int8 if bits == 8 else torch.uint8
    width = F if bits == 8 else F // 2
    pairs = [(zq, zscale)] + ([] if dzq is None else [(dzq, dzscale)])
    for q, s in pairs:
        if q.dtype != code_dtype or q.dim() != 3 \
                or tuple(q.shape[1:]) != (B, width):
            raise ValueError(f"{name}: codes must be (W, {B}, {width}) "
                             f"{code_dtype}, got {tuple(q.shape)} {q.dtype}")
        if q.shape != zq.shape or s.dtype != torch.float32 \
                or tuple(s.shape) != tuple(zq.shape[:2]):
            raise ValueError(f"{name}: scales must be float32 "
                             f"{tuple(zq.shape[:2])} beside codes "
                             f"{tuple(zq.shape)}")
    for t in [ad_hoc, slot] + [x for p in pairs for x in p]:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if slot.dtype != torch.int32 or slot.numel() != 1:
        raise ValueError(f"{name}: slot must be one int32, got "
                         f"{slot.dtype} {tuple(slot.shape)}")


def _fused_sample_quant(bits, slot, ad_hoc, zq, zscale, dzq, dzscale,
                        cos_xi):
    if ad_hoc.device.type == "cpu":
        return fused_sample_quant_plain(bits, slot, ad_hoc, zq, zscale, dzq,
                                        dzscale, cos_xi)
    check_quant_ring(bits, slot, ad_hoc, zq, zscale, dzq, dzscale)
    B, F = ad_hoc.shape
    w = torch.empty(B, dtype=torch.float32, device=ad_hoc.device)
    cot = None if dzq is None else torch.empty(
        (B, F), dtype=torch.float32, device=ad_hoc.device)
    _cuda.launch_cosine_gate_quant(
        QUANT_NAMES[bits], bits=bits, slot=slot, n_slots=zq.shape[0],
        a=ad_hoc, zq=zq, zs=zscale, dzq=dzq, dzs=dzscale, w=w, cot=cot,
        part=gate_workspace(B, F, ad_hoc.device),
        thresh=f32_threshold(cos_xi))
    return w, cot


def fused_sample_q8_2d(slot, ad_hoc, zq, zscale, dzq, dzscale, cos_xi):
    """K4.  slot: (1,) int32; ad_hoc: (B, F) fp32; zq / dzq: (W, B, F)
    int8 codes; zscale / dzscale: (W, B) fp32 row scales (``dzq=None``:
    weights only).  -> (weights (B,) fp32, weighted cotangent (B, F) fp32
    or None)."""
    return _fused_sample_quant(8, slot, ad_hoc, zq, zscale, dzq, dzscale,
                               cos_xi)


def fused_sample_q4_2d(slot, ad_hoc, zq, zscale, dzq, dzscale, cos_xi):
    """K5.  As :func:`fused_sample_q8_2d` over packed int4 codes
    (W, B, F / 2) uint8; F is even (the caller pads an odd row)."""
    return _fused_sample_quant(4, slot, ad_hoc, zq, zscale, dzq, dzscale,
                               cos_xi)


# --------------------------------------------------------------------------
# K6 / K11: one ring slot, dequantised
# --------------------------------------------------------------------------
def fused_dequant_plain(bits: int, slot, zq, zscale):
    """Gather slot, dequantise: the CPU path and the oracle of K6
    (``bits=8``) and K11 (``bits=4``).  -> (B, F) fp32, F = 2 P for a
    packed (W, B, P) ring."""
    idx = slot.reshape(1).long()
    return dequant_rows(zq.index_select(0, idx)[0],
                        zscale.index_select(0, idx)[0], bits)


def check_dequant_ring(bits: int, slot, zq, zscale) -> None:
    """K6 / K11's operand checks: contiguous (W, B, F) int8 or
    (W, B, F / 2) uint8 codes with (W, B) fp32 row scales and a
    one-element int32 slot, all on one device."""
    name = DEQUANT_NAMES[bits]
    code_dtype = torch.int8 if bits == 8 else torch.uint8
    if zq.dtype != code_dtype or zq.dim() != 3 or 0 in zq.shape:
        raise ValueError(f"{name}: codes must be non-empty (W, B, P) "
                         f"{code_dtype}, got {tuple(zq.shape)} {zq.dtype}")
    if zscale.dtype != torch.float32 \
            or tuple(zscale.shape) != tuple(zq.shape[:2]):
        raise ValueError(f"{name}: scales must be float32 "
                         f"{tuple(zq.shape[:2])}, got "
                         f"{tuple(zscale.shape)} {zscale.dtype}")
    for t in (zq, zscale, slot):
        if t.device != zq.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{zq.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if slot.dtype != torch.int32 or slot.numel() != 1:
        raise ValueError(f"{name}: slot must be one int32, got "
                         f"{slot.dtype} {tuple(slot.shape)}")


def _fused_dequant(bits: int, slot, zq, zscale):
    if zq.device.type == "cpu":
        return fused_dequant_plain(bits, slot, zq, zscale)
    check_dequant_ring(bits, slot, zq, zscale)
    W, B, P = zq.shape
    out = torch.empty((B, P if bits == 8 else 2 * P), dtype=torch.float32,
                      device=zq.device)
    _cuda.launch_ring_dequant(DEQUANT_NAMES[bits], bits=bits, slot=slot,
                              zq=zq, zs=zscale, out=out)
    return out


def fused_dequant_q8_2d(slot, zq, zscale):
    """K6.  slot: (1,) int32 on the ring's device; zq: (W, B, F) int8
    codes; zscale: (W, B) fp32 row scales.  -> (B, F) fp32, the entry at
    ``slot``."""
    return _fused_dequant(8, slot, zq, zscale)


def fused_dequant_q4_2d(slot, zq, zscale):
    """K11.  As :func:`fused_dequant_q8_2d` over packed int4 codes
    (W, B, P) uint8.  -> (B, 2 P) fp32 (the caller slices a pad
    column)."""
    return _fused_dequant(4, slot, zq, zscale)
