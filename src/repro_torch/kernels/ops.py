"""Public wrappers for the port's kernels (the counterpart of
``repro/kernels/ops.py``).

Each takes the engine's shapes, flattens them to the (B, F) rows the
kernel works on, and calls the kernel module's wrapper: on a CUDA tensor
that launches ``csrc/cosine_gate.cu``; on a CPU tensor it runs the plain
PyTorch version.
"""
from __future__ import annotations

from . import cosine_weight as _cw
from . import fused_sample as _fs


def _rows(x):
    """(B, ...) -> contiguous (B, F); autograd may hand back a strided
    gradient (e.g. a slice of a concatenation's), which the kernel does
    not take."""
    return x.reshape(x.shape[0], -1).contiguous()


def cosine_weight(ad_hoc, stale, cos_xi):
    """Algorithm-2 InsWeight: -> (B,) float32 weights (K2b)."""
    return _cw.cosine_weights_2d(_rows(ad_hoc), _rows(stale), cos_xi)


def weighted_cotangent(ad_hoc, stale, dz, cos_xi):
    """Fused InsWeight + weights ⊙ ∇Z (K2a).  -> (weights (B,), weighted
    dz in dz's shape, fp32)."""
    w, out = _cw.cosine_weight_2d(_rows(ad_hoc), _rows(stale), _rows(dz),
                                  cos_xi)
    return w, out.reshape(dz.shape)


def _ring_rows(ring, B):
    return ring.reshape(ring.shape[0], B, -1)


def fused_gather_weight(slot, ad_hoc, z_ring, dz_ring, cos_xi):
    """Fused workset sample over a full-precision (fp32/bf16) ring (K1):
    gather slot → row-cosine vs ad_hoc → threshold → cotangent scale.
    slot: (1,) int32 device tensor; ad_hoc: (B, ...); z_ring/dz_ring:
    (W,) + ad_hoc.shape.  -> (weights (B,) f32, weighted cotangent f32 in
    ad_hoc's shape)."""
    B = ad_hoc.shape[0]
    w, cot = _fs.fused_sample_2d(slot, _rows(ad_hoc), _ring_rows(z_ring, B),
                                 _ring_rows(dz_ring, B), cos_xi)
    return w, cot.reshape(ad_hoc.shape)


def fused_gather_weights(slot, ad_hoc, ring, cos_xi):
    """Weights-only K1 (Party B): the row cosine of ``ad_hoc`` against
    ring slot ``slot``, floored at cos ξ.  -> (B,) f32."""
    B = ad_hoc.shape[0]
    w, _ = _fs.fused_sample_2d(slot, _rows(ad_hoc), _ring_rows(ring, B),
                               None, cos_xi)
    return w
