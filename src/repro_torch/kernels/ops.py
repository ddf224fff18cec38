"""Public wrappers for the port's kernels (the counterpart of
``repro/kernels/ops.py``).

Each takes the engine's shapes, flattens them to the (B, F) rows the
kernel works on, and calls the kernel module's wrapper: on a CUDA tensor
that launches the kernel (``csrc/cosine_gate.cu``, ``csrc/quantize.cu``,
``csrc/fused_adagrad.cu``); on a CPU tensor it runs the plain PyTorch
version.  The gates read the ad-hoc statistic in fp32: the LLM's cut
tensor is bf16, and the reference casts it inside K1 / K2
(``a_ref[...].astype(f32)``) and before K4 / K5, so the wrappers cast
it here (exactly: bf16 is a subset of fp32).  The model calls K9
(``kernels/flash_attention.py``) directly, and K9-LSE / K10 through
:func:`flash_attention_trainable`.
"""
from __future__ import annotations

import torch.nn.functional as F

from . import cosine_weight as _cw
from . import flash_attention_bwd as _fab
from . import fused_adagrad as _ag
from . import fused_sample as _fs
from . import quantize as _qz


def _rows(x):
    """(B, ...) -> contiguous (B, F); autograd may hand back a strided
    gradient (e.g. a slice of a concatenation's), which the kernel does
    not take."""
    return x.reshape(x.shape[0], -1).contiguous()


def _rows32(x):
    """(B, ...) -> contiguous fp32 (B, F): the gates' ad-hoc operand."""
    return _rows(x.float())


def cosine_weight(ad_hoc, stale, cos_xi):
    """Algorithm-2 InsWeight: -> (B,) float32 weights (K2b)."""
    return _cw.cosine_weights_2d(_rows32(ad_hoc), _rows(stale), cos_xi)


def weighted_cotangent(ad_hoc, stale, dz, cos_xi):
    """Fused InsWeight + weights ⊙ ∇Z (K2a).  -> (weights (B,), weighted
    dz in dz's shape, fp32)."""
    w, out = _cw.cosine_weight_2d(_rows32(ad_hoc), _rows(stale), _rows(dz),
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
    w, cot = _fs.fused_sample_2d(slot, _rows32(ad_hoc),
                                 _ring_rows(z_ring, B),
                                 _ring_rows(dz_ring, B), cos_xi)
    return w, cot.reshape(ad_hoc.shape)


def fused_gather_weights(slot, ad_hoc, ring, cos_xi):
    """Weights-only K1 (Party B): the row cosine of ``ad_hoc`` against
    ring slot ``slot``, floored at cos ξ.  -> (B,) f32."""
    B = ad_hoc.shape[0]
    w, _ = _fs.fused_sample_2d(slot, _rows32(ad_hoc), _ring_rows(ring, B),
                               None, cos_xi)
    return w


def fused_gather_weight_q8(slot, ad_hoc, zq, zscale, dzq, dzscale, cos_xi):
    """Fused workset sample over the int8 ring (K4): gather → dequant →
    cosine → threshold → cotangent scale.  zq/dzq: (W, B, F) int8,
    zscale/dzscale: (W, B) fp32 row scales.  -> (weights (B,) f32,
    weighted cotangent f32 in ad_hoc's shape)."""
    w, cot = _fs.fused_sample_q8_2d(slot, _rows32(ad_hoc), zq, zscale,
                                    dzq, dzscale, cos_xi)
    return w, cot.reshape(ad_hoc.shape)


def fused_gather_weights_q8(slot, ad_hoc, zq, zscale, cos_xi):
    """Weights-only K4 (Party B): -> (B,) f32."""
    w, _ = _fs.fused_sample_q8_2d(slot, _rows32(ad_hoc), zq, zscale,
                                  None, None, cos_xi)
    return w


def _pad_to_packed(ad_hoc, zq):
    """(B, ...) -> (B, 2P) fp32 rows, zero-padded to the packed width of
    ``zq`` (W, B, P): the pad nibble of an odd row decodes to zero, so the
    zero column adds nothing to the reductions."""
    a2d = _rows32(ad_hoc)
    pad = 2 * zq.shape[2] - a2d.shape[1]
    return F.pad(a2d, (0, pad)) if pad else a2d


def fused_gather_weight_q4(slot, ad_hoc, zq, zscale, dzq, dzscale, cos_xi):
    """Fused workset sample over the packed int4 ring (K5).  zq/dzq:
    (W, B, ceil(F/2)) uint8, zscale/dzscale: (W, B) fp32 row scales.  For
    odd F the wrapper pads ``ad_hoc`` with a zero column and slices the
    pad column off the cotangent."""
    w, cot = _fs.fused_sample_q4_2d(slot, _pad_to_packed(ad_hoc, zq), zq,
                                    zscale, dzq, dzscale, cos_xi)
    width = ad_hoc.numel() // ad_hoc.shape[0]
    return w, cot[:, :width].reshape(ad_hoc.shape)


def fused_gather_weights_q4(slot, ad_hoc, zq, zscale, cos_xi):
    """Weights-only K5 (Party B): -> (B,) f32."""
    w, _ = _fs.fused_sample_q4_2d(slot, _pad_to_packed(ad_hoc, zq), zq,
                                  zscale, None, None, cos_xi)
    return w


def fused_gather_dequant_q8(slot, zq, zscale):
    """Gather + dequantise one int8 ring entry (K6; the serving
    decode-cache read).  zq: (W, B, F) int8, zscale: (W, B) fp32 row
    scales.  -> (B, F) fp32."""
    return _fs.fused_dequant_q8_2d(slot.reshape(1), zq, zscale)


def fused_gather_dequant_q4(slot, zq, zscale, width: int):
    """Gather + unpack + dequantise one int4 nibble-packed ring entry
    (K11).  zq: (W, B, ceil(F/2)) packed uint8, zscale: (W, B) fp32 row
    scales, width: the true row width F (the pad nibble of an odd row is
    sliced off).  -> (B, F) fp32."""
    return _fs.fused_dequant_q4_2d(slot.reshape(1), zq, zscale)[:, :width]


def quantize_stochastic(x, u, levels):
    """Per-tile absmax-scale stochastic-rounding quantiser (K3).
    x, u: (T, L); levels: max code magnitude (127 = int8, 7 = int4).
    -> (codes int8 (T, L), fp32 scales (T,))."""
    return _qz.quantize_sr_2d(x.float().contiguous(), u.float().contiguous(),
                              levels)


def fused_adagrad(grad, accum, lr, eps):
    """Fused AdaGrad step on one leaf (K7): a' = a + g², u = -lr·g /
    (√a' + eps).  grad: any shape, fp32 or bf16; accum: fp32 of grad's
    shape.  -> (update fp32, new accumulator fp32)."""
    return _ag.fused_adagrad(grad.contiguous(), accum.contiguous(), lr, eps)


def fused_adagrad_list(grads, accums, lr, eps):
    """K7 over a list of leaves, one launch (per table of leaves): ->
    (updates fp32, new accumulators in the accumulators' dtype, fp32 or
    bf16); the inputs are untouched."""
    return _ag.fused_adagrad_list([g.contiguous() for g in grads], accums,
                                  lr, eps)


def fused_adagrad_step_(grads, accums, params, lr, eps, scale=None):
    """The in-place K7 step over one party's leaves: accumulators <- a',
    params <- p + u·scale (``scale`` a 0-d fp32 tensor, or None for 1)."""
    _ag.fused_adagrad_step_([g.contiguous() for g in grads], accums, params,
                            lr, eps, scale)


def fused_adagrad_q8(grad, accum_q, accum_scale, u, lr, eps):
    """int8-at-rest AdaGrad step on one leaf (K8): dequantise → accumulate
    → scale → requantise in one pass.  grad: fp32 or bf16 of at most R·C
    elements (the rest of the (R, C) tiling is the zero pad: no padded
    copy is made); accum_q: (R, C) int8 sqrt-space codes; accum_scale:
    (R, 1) fp32; u: (R, C) uniforms.  -> (update fp32 in grad's shape,
    new codes, new scales)."""
    return _ag.fused_adagrad_q8(grad.contiguous(), accum_q, accum_scale,
                                u.float().contiguous(), lr, eps)


def fused_adagrad_q8_list(grads, qs, scales, noises, lr, eps):
    """K8 over a list of leaves, one launch (per table of leaves): ->
    (updates fp32, new codes, new scales); the inputs are untouched."""
    return _ag.fused_adagrad_q8_list([g.contiguous() for g in grads], qs,
                                     scales, noises, lr, eps)


def fused_adagrad_q8_step_(grads, qs, scales, noises, params, lr, eps,
                           scale=None):
    """The in-place K8 step over one party's leaves: codes and scales
    <- q', s', params <- p + u·scale."""
    _ag.fused_adagrad_q8_step_([g.contiguous() for g in grads], qs, scales,
                               noises, params, lr, eps, scale)


def flash_attention_trainable(q, k, v, *, causal: bool = True,
                              window: int = 0):
    """Differentiable flash attention: K9-LSE forward, K10 backward
    (``kernels/flash_attention_bwd.py``).  q, k, v: (B, S, H, hd), KV
    heads repeated to H."""
    return _fab.FlashAttentionFn.apply(q, k, v, causal, window)
