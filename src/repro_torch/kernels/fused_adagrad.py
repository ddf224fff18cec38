"""Fused AdaGrad steps: K7 (fp32 accumulator) and K8 (int8 sqrt-space
accumulator).

Replaces ``repro/kernels/fused_adagrad.py``:

  * K7 ``fused_adagrad`` (``_kernel``): for a gradient ``g`` of any shape
    and its fp32 accumulator ``a``

        a' = a + g·g;   u = -lr·g / (√a' + eps)

    The TPU kernel pads to a (rows, 1024) tiling; on the card the kernel
    is one flat elementwise pass and takes any element count.
  * K8 ``fused_adagrad_q8`` (``_kernel_q8``): the int8-at-rest step over
    the optimizer's padded (R, C) tiling.  Codes ``q`` live in sqrt-space
    (accumulator value = (q·s)²) with one fp32 scale ``s`` a row:

        r  = q·s;   r' = √(r·r + g·g);   u = -lr·g / (r' + eps)
        s' = max(max_j r'_j, 1e-12) / 127
        q' = int8(clip(floor(r'/s' + noise), 0, 127))

    ``noise`` is an (R, C) operand of uniforms in [0, 1), as on the TPU.
    The gradient may hold fewer than R·C elements: the rest count as the
    reference's zero pad (``repro/optim/quantized.py::_to2d``), and the
    update comes back in the gradient's own shape.

On a CUDA tensor the wrappers launch ``csrc/fused_adagrad.cu``, whose
outputs equal the plain versions' bit for bit; on a CPU tensor they run
the plain versions, the counterparts of ``repro/kernels/ref.py::
fused_adagrad_ref`` and ``fused_adagrad_q8_ref``.

Both are bandwidth-bound.  K7 reads g and a and writes u and a' (16 B an
element): at WDL-Criteo's largest leaf (425,984 elements) 6,815,744 B,
2.03 us at 3.35 TB/s.  K8 reads g, q and the noise and writes u and q'
(14 B an element) plus 8 B of scales a row: at (416, 1024) 5,967,104 B,
1.78 us.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda

# the reference's tiling and requantisation constants
# (``repro/kernels/fused_adagrad.py``)
BLOCK = 1024
ROWS = 8
Q8_LEVELS = 127.0
EPS_SCALE = 1e-12


def to2d(x, R: int, C: int):
    """x (any shape, at most R·C elements) -> its float32 (R, C) tiling,
    zero-padded after the last element."""
    g = x.reshape(-1).float()
    if g.numel() != R * C:
        g = F.pad(g, (0, R * C - g.numel()))
    return g.reshape(R, C)


def fused_adagrad_plain(grad, accum, lr, eps):
    """-> (update fp32, new accumulator fp32), in grad's shape: the CPU
    path and K7's oracle."""
    g = grad.float()
    a_new = accum + g * g
    return -lr * g / (torch.sqrt(a_new) + eps), a_new


def check_operands(grad, accum) -> None:
    """K7's operand checks: contiguous, non-empty fp32 grad and accumulator
    of one shape on one device."""
    if grad.dtype != torch.float32 or grad.numel() == 0:
        raise ValueError(f"fused_adagrad: grad must be non-empty float32, "
                         f"got {tuple(grad.shape)} {grad.dtype}")
    if accum.shape != grad.shape or accum.dtype != torch.float32 \
            or accum.device != grad.device:
        raise ValueError(f"fused_adagrad: accum must be float32 "
                         f"{tuple(grad.shape)} on {grad.device}, got "
                         f"{tuple(accum.shape)} {accum.dtype} on "
                         f"{accum.device}")
    if not (grad.is_contiguous() and accum.is_contiguous()):
        raise ValueError("fused_adagrad: operands must be contiguous")


def fused_adagrad(grad, accum, lr, eps):
    """K7.  grad, accum: float32 of one shape.  -> (update, accum')."""
    if grad.device.type == "cpu":
        return fused_adagrad_plain(grad, accum, lr, eps)
    check_operands(grad, accum)
    upd = torch.empty_like(grad)
    a_new = torch.empty_like(accum)
    _cuda.launch_fused_adagrad("fused_adagrad", grad=grad, accum=accum,
                               upd=upd, accum_out=a_new, lr=float(lr),
                               eps=float(eps))
    return upd, a_new


def fused_adagrad_q8_plain(grad, q, scale, u, lr, eps):
    """-> (update fp32 in grad's shape, codes int8 (R, C), scales fp32
    (R, 1)): the CPU path and K8's oracle."""
    R, C = q.shape
    g = to2d(grad, R, C)
    r = q.float() * scale
    r_new = torch.sqrt(r * r + g * g)
    upd = -lr * g / (r_new + eps)
    amax = r_new.amax(dim=1, keepdim=True)
    # divide by a tensor: on the card PyTorch turns division by a Python
    # scalar into multiplication by its reciprocal (see kernels/quantize.py)
    s_new = torch.clamp(amax, min=EPS_SCALE) \
        / torch.full_like(amax, Q8_LEVELS)
    codes = torch.clamp(torch.floor(r_new / s_new + u.float()), 0.0,
                        Q8_LEVELS).to(torch.int8)
    return upd.reshape(-1)[:grad.numel()].reshape(grad.shape), codes, s_new


def check_q8_operands(grad, q, scale, u) -> None:
    """K8's operand checks: int8 (R, C) codes with C <= BLOCK, float32
    (R, 1) scales and (R, C) uniforms, a float32 gradient of at most R·C
    elements, all contiguous on one device."""
    if q.dim() != 2 or q.dtype != torch.int8 or 0 in q.shape \
            or q.shape[1] > BLOCK:
        raise ValueError(f"fused_adagrad_q8: q must be non-empty (R, C) "
                         f"int8 with C <= {BLOCK}, got {tuple(q.shape)} "
                         f"{q.dtype}")
    R, C = q.shape
    if grad.dtype != torch.float32 or not 0 < grad.numel() <= R * C:
        raise ValueError(f"fused_adagrad_q8: grad must be float32 with 1 to "
                         f"{R * C} elements, got {tuple(grad.shape)} "
                         f"{grad.dtype}")
    for name, t, shape in (("scale", scale, (R, 1)), ("u", u, (R, C))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"fused_adagrad_q8: {name} must be float32 "
                             f"{shape}, got {tuple(t.shape)} {t.dtype}")
    if any(t.device != q.device for t in (grad, scale, u)):
        raise ValueError("fused_adagrad_q8: operands on different devices")
    if not all(t.is_contiguous() for t in (grad, q, scale, u)):
        raise ValueError("fused_adagrad_q8: operands must be contiguous")


def fused_adagrad_q8(grad, q, scale, u, lr, eps):
    """K8.  grad: float32, at most R·C elements (the rest are the zero
    pad); q: (R, C) int8 codes; scale: (R, 1) float32; u: (R, C) float32
    uniforms.  -> (update in grad's shape, codes (R, C), scales (R, 1))."""
    if grad.device.type == "cpu":
        return fused_adagrad_q8_plain(grad, q, scale, u, lr, eps)
    check_q8_operands(grad, q, scale, u)
    upd = torch.empty_like(grad)
    q_new = torch.empty_like(q)
    s_new = torch.empty_like(scale)
    _cuda.launch_fused_adagrad_q8("fused_adagrad_q8", grad=grad, q=q,
                                  scale=scale, u=u, upd=upd, q_out=q_new,
                                  scale_out=s_new, lr=float(lr),
                                  eps=float(eps))
    return upd, q_new, s_new
