"""Fused workset sample: K1, the Algorithm-2 gate read straight off the ring.

Replaces ``repro/kernels/fused_sample.py``: ``fused_sample_2d``
(``_kernel_f32``), over an fp32 or bf16 ring.  It gathers ring slot
``slot``, takes each row's cosine of the ad-hoc statistic against the
stale Z, zeroes it below cos ξ and scales the stale ∇Z by it, so no copy
of the sampled entry is ever written to device memory.

The TPU kernel took the slot as a scalar-prefetch operand; here ``slot``
is a one-element int32 tensor on the card that ``csrc/cosine_gate.cu``
reads itself, so a local update never waits for the host to learn which
slot it drew.  ``dz_ring=None`` gives weights only (Party B's use: the
reference passes the ∇Z ring twice and drops the cotangent).

Bandwidth-bound: one slot of z (and dz) plus the ad-hoc rows are read and
the weights (and cotangent) written, at about 7 flops per element.  At the
paper's W = 5, B = F = 256 fp32 ring that is 1.05 MB, 0.31 us at 3.35 TB/s.
"""
from __future__ import annotations

import torch

from . import _cuda
from .cosine_weight import check_operands, f32_threshold, gate_weights_plain


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
                             thresh=f32_threshold(cos_xi))
    return w, cot
