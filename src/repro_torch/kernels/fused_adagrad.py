"""Fused AdaGrad steps: K7 (fp32 or bf16 accumulator) and K8 (int8
sqrt-space accumulator), each one launch over a list of parameter tensors
(leaves).

Replaces ``repro/kernels/fused_adagrad.py``:

  * K7 ``fused_adagrad`` (``_kernel``): for a gradient ``g`` of any shape
    and its accumulator ``a``

        a' = a + g·g;   u = -lr·g / (√a' + eps)

    The TPU kernel pads to a (rows, 1024) tiling; on the card every leaf
    is cut into 1,024-element chunks, one block a chunk.
  * K8 ``fused_adagrad_q8`` (``_kernel_q8``): the int8-at-rest step over
    each leaf's padded (R, C) tiling.  Codes ``q`` live in sqrt-space
    (accumulator value = (q·s)²) with one fp32 scale ``s`` a row:

        r  = q·s;   r' = √(r·r + g·g);   u = -lr·g / (r' + eps)
        s' = max(max_j r'_j, 1e-12) / 127
        q' = int8(clip(floor(r'/s' + noise), 0, 127))

    ``noise`` is an (R, C) operand of uniforms in [0, 1), as on the TPU.
    The gradient may hold fewer than R·C elements: the rest count as the
    reference's zero pad (``repro/optim/quantized.py::_to2d``).

Each comes in two modes over one kernel:

  * the step (``fused_adagrad_step_``, ``fused_adagrad_q8_step_``): the
    accumulators (codes and scales) are updated in place, and the update,
    multiplied by ``scale`` (the draw's 0-d valid mask) when one is
    given, is added to each parameter in place: p' = p + u·scale, in
    fp32, rounded to p's type.  No update tensor is written and nothing
    is allocated, so the step can be captured in a CUDA graph;
  * the updates (``fused_adagrad_list``, ``fused_adagrad_q8_list``, and
    their one-leaf cases ``fused_adagrad`` / ``fused_adagrad_q8``): fresh
    accumulators and the updates are written out and returned.

The gradient and the parameter may be fp32 or bf16, and so may K7's
accumulator (the bf16 state: a' rounded to bf16 when stored).

On a CUDA tensor the wrappers launch ``csrc/fused_adagrad.cu`` once for
every :data:`_cuda.ADAGRAD_LEAVES` leaves (the capacity of the table the
launch takes by value; :func:`k7_tables`, :func:`k8_tables`), and its
results equal the plain versions' bit for bit; on a CPU tensor they run
the plain versions: each leaf's arithmetic in the order of the engine's
per-leaf route (update, ``u * scale``, ``p.add_(u)``), the counterparts
of ``repro/kernels/ref.py::fused_adagrad_ref`` and
``fused_adagrad_q8_ref``.

Both are bandwidth-bound.  The K7 step reads g, a and p and writes a'
and p' (20 B an fp32 element): over WDL-Criteo's Party A (836,608
elements) 16,732,160 B, 4.99 us at 3.35 TB/s.  The K8 step reads g, q,
the noise and p and writes q' and p' (18 B an element) plus 8 B of
scales a row.
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

# a leaf's flags in the kernels' tables (``csrc/fused_adagrad.cu``)
GRAD_BF16, ACCUM_BF16, DST_BF16, ALIGNED = 1, 2, 4, 8
_FLOATS = (torch.float32, torch.bfloat16)


def to2d(x, R: int, C: int):
    """x (any shape, at most R·C elements) -> its float32 (R, C) tiling,
    zero-padded after the last element."""
    g = x.reshape(-1).float()
    if g.numel() != R * C:
        g = F.pad(g, (0, R * C - g.numel()))
    return g.reshape(R, C)


# --------------------------------------------------------------------------
# The plain versions: the CPU path and the kernels' oracles
# --------------------------------------------------------------------------
def fused_adagrad_plain(grad, accum, lr, eps):
    """One leaf -> (update fp32, new accumulator fp32), in grad's shape."""
    g = grad.float()
    a_new = accum + g * g
    return -lr * g / (torch.sqrt(a_new) + eps), a_new


def fused_adagrad_list_plain(grads, accums, lr, eps):
    """-> (updates fp32, new accumulators in the accumulators' dtype)."""
    upd, acc = [], []
    for g, a in zip(grads, accums):
        u, a_new = fused_adagrad_plain(g, a.float(), lr, eps)
        upd.append(u)
        acc.append(a_new.to(a.dtype))
    return upd, acc


@torch.no_grad()
def fused_adagrad_step_plain(grads, accums, params, lr, eps, scale=None):
    """The K7 step in place: each accumulator <- a', each parameter
    <- p + u (· scale)."""
    for g, a, p in zip(grads, accums, params):
        u, a_new = fused_adagrad_plain(g, a.float(), lr, eps)
        if scale is not None:
            u = u * scale
        a.copy_(a_new)
        p.add_(u)


def fused_adagrad_q8_plain(grad, q, scale, u, lr, eps):
    """One leaf -> (update fp32 in grad's shape, codes int8 (R, C), scales
    fp32 (R, 1))."""
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


def fused_adagrad_q8_list_plain(grads, qs, scales, noises, lr, eps):
    """-> (updates fp32, new codes, new scales)."""
    out = [fused_adagrad_q8_plain(g, q, s, u, lr, eps)
           for g, q, s, u in zip(grads, qs, scales, noises)]
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


@torch.no_grad()
def fused_adagrad_q8_step_plain(grads, qs, scales, noises, params, lr, eps,
                                scale=None):
    """The K8 step in place: codes and scales <- q', s', each parameter
    <- p + u (· scale)."""
    for g, q, s, noise, p in zip(grads, qs, scales, noises, params):
        u, q_new, s_new = fused_adagrad_q8_plain(g, q, s, noise, lr, eps)
        if scale is not None:
            u = u * scale
        q.copy_(q_new)
        s.copy_(s_new)
        p.add_(u)


# --------------------------------------------------------------------------
# Operand checks
# --------------------------------------------------------------------------
def check_operands(grad, accum) -> None:
    """K7's operand checks for one leaf: contiguous, non-empty fp32 or
    bf16 grad and accumulator of one shape on one device."""
    if grad.dtype not in _FLOATS or grad.numel() == 0:
        raise ValueError(f"fused_adagrad: grad must be non-empty float32 "
                         f"or bfloat16, got {tuple(grad.shape)} "
                         f"{grad.dtype}")
    if accum.shape != grad.shape or accum.dtype not in _FLOATS \
            or accum.device != grad.device:
        raise ValueError(f"fused_adagrad: accum must be float32 or bfloat16 "
                         f"{tuple(grad.shape)} on {grad.device}, got "
                         f"{tuple(accum.shape)} {accum.dtype} on "
                         f"{accum.device}")
    if not (grad.is_contiguous() and accum.is_contiguous()):
        raise ValueError("fused_adagrad: operands must be contiguous")


def check_q8_operands(grad, q, scale, u) -> None:
    """K8's operand checks for one leaf: int8 (R, C) codes with C <=
    BLOCK, float32 (R, 1) scales and (R, C) uniforms, a float32 or
    bfloat16 gradient of at most R·C elements, all contiguous on one
    device."""
    if q.dim() != 2 or q.dtype != torch.int8 or 0 in q.shape \
            or q.shape[1] > BLOCK:
        raise ValueError(f"fused_adagrad_q8: q must be non-empty (R, C) "
                         f"int8 with C <= {BLOCK}, got {tuple(q.shape)} "
                         f"{q.dtype}")
    R, C = q.shape
    if grad.dtype not in _FLOATS or not 0 < grad.numel() <= R * C:
        raise ValueError(f"fused_adagrad_q8: grad must be float32 or "
                         f"bfloat16 with 1 to {R * C} elements, got "
                         f"{tuple(grad.shape)} {grad.dtype}")
    for name, t, shape in (("scale", scale, (R, 1)), ("u", u, (R, C))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"fused_adagrad_q8: {name} must be float32 "
                             f"{shape}, got {tuple(t.shape)} {t.dtype}")
    if any(t.device != q.device for t in (grad, scale, u)):
        raise ValueError("fused_adagrad_q8: operands on different devices")
    if not all(t.is_contiguous() for t in (grad, q, scale, u)):
        raise ValueError("fused_adagrad_q8: operands must be contiguous")


def check_params(name: str, grads, params, scale) -> None:
    """A step's parameters: contiguous fp32 or bf16 of each gradient's
    shape on its device; ``scale`` None or a 0-d float32 on that device;
    the lists of equal length."""
    if len(params) != len(grads):
        raise ValueError(f"{name}: {len(grads)} gradients but "
                         f"{len(params)} parameters")
    for g, p in zip(grads, params):
        if p.shape != g.shape or p.dtype not in _FLOATS \
                or p.device != g.device or not p.is_contiguous():
            raise ValueError(f"{name}: a parameter must be contiguous "
                             f"float32 or bfloat16 {tuple(g.shape)} on "
                             f"{g.device}, got {tuple(p.shape)} {p.dtype} "
                             f"on {p.device}")
    if scale is not None and (scale.dim() != 0
                              or scale.dtype != torch.float32
                              or scale.device != grads[0].device):
        raise ValueError(f"{name}: scale must be a 0-d float32 tensor on "
                         f"{grads[0].device}, got {tuple(scale.shape)} "
                         f"{scale.dtype} on {scale.device}")


def check_step_operands(grads, accums, params=None, scale=None) -> None:
    """The K7 list's operand checks, leaf by leaf (the step's parameters
    and mask too, when given)."""
    if len(accums) != len(grads):
        raise ValueError(f"fused_adagrad: {len(grads)} gradients but "
                         f"{len(accums)} accumulators")
    for g, a in zip(grads, accums):
        check_operands(g, a)
    if params is not None:
        check_params("fused_adagrad", grads, params, scale)


def check_q8_step_operands(grads, qs, scales, noises, params=None,
                           scale=None) -> None:
    """The K8 list's operand checks, leaf by leaf (the step's parameters
    and mask too, when given)."""
    if not len(grads) == len(qs) == len(scales) == len(noises):
        raise ValueError("fused_adagrad_q8: lists of unequal length")
    for g, q, s, u in zip(grads, qs, scales, noises):
        check_q8_operands(g, q, s, u)
    if params is not None:
        check_params("fused_adagrad_q8", grads, params, scale)


# --------------------------------------------------------------------------
# The leaf tables (the launches' by-value kernel parameter)
# --------------------------------------------------------------------------
def _ceil(n: int, d: int) -> int:
    return -(-n // d)


def _flag(t, flag: int) -> int:
    return flag if t.dtype == torch.bfloat16 else 0


def k7_tables(grads, accums, accum_outs, dsts) -> list:
    """The K7 launches over checked leaves: one :class:`_cuda.K7Table` a
    launch, :data:`_cuda.ADAGRAD_LEAVES` leaves at most, in list order.
    ``dsts``: the parameters (applied) or the fp32 updates (written).
    A leaf takes ``ceil(n / ADAGRAD_CHUNK)`` blocks from ``start[i]`` on;
    it takes 16-byte loads when all four of its pointers are 16-byte
    aligned."""
    cap, chunk = _cuda.ADAGRAD_LEAVES, _cuda.ADAGRAD_CHUNK
    leaves = list(zip(grads, accums, accum_outs, dsts))
    tables = []
    for lo in range(0, len(leaves), cap):
        t, blocks = _cuda.K7Table(), 0
        ops = leaves[lo:lo + cap]
        for k, (g, a, ao, d) in enumerate(ops):
            e = t.leaf[k]
            ptrs = (g.data_ptr(), a.data_ptr(), ao.data_ptr(), d.data_ptr())
            e.g, e.a, e.a_out, e.dst = ptrs
            e.n = g.numel()
            e.flags = (_flag(g, GRAD_BF16) | _flag(a, ACCUM_BF16)
                       | _flag(d, DST_BF16)
                       | (ALIGNED if all(x % 16 == 0 for x in ptrs) else 0))
            t.start[k] = blocks
            blocks += _ceil(e.n, chunk)
        t.start[len(ops)] = blocks
        t.n_leaves = len(ops)
        tables.append(t)
    return tables


def k8_tables(grads, qs, scales, q_outs, s_outs, noises, dsts) -> list:
    """The K8 launches over checked leaves: one :class:`_cuda.K8Table` a
    launch, :data:`_cuda.ADAGRAD_LEAVES` leaves at most, in list order; a
    leaf takes one block a row of its (R, C) tiling."""
    cap = _cuda.ADAGRAD_LEAVES
    leaves = list(zip(grads, qs, scales, q_outs, s_outs, noises, dsts))
    tables = []
    for lo in range(0, len(leaves), cap):
        t, rows = _cuda.K8Table(), 0
        ops = leaves[lo:lo + cap]
        for k, (g, q, s, qo, so, u, d) in enumerate(ops):
            e = t.leaf[k]
            e.g, e.q, e.s, e.q_out, e.s_out, e.noise, e.dst = (
                g.data_ptr(), q.data_ptr(), s.data_ptr(), qo.data_ptr(),
                so.data_ptr(), u.data_ptr(), d.data_ptr())
            e.n = g.numel()
            e.C = q.shape[1]
            e.flags = _flag(g, GRAD_BF16) | _flag(d, DST_BF16)
            t.start[k] = rows
            rows += q.shape[0]
        t.start[len(ops)] = rows
        t.n_leaves = len(ops)
        tables.append(t)
    return tables


def _launch(entry: str, tables, device, scale, lr, eps, apply) -> None:
    for t in tables:
        _cuda.launch_fused_adagrad(entry, t, device=device, scale=scale,
                                   lr=float(lr), eps=float(eps), apply=apply)


# --------------------------------------------------------------------------
# K7
# --------------------------------------------------------------------------
def fused_adagrad_step_(grads, accums, params, lr, eps, scale=None) -> None:
    """The K7 step over one party's leaves, in place: accumulators
    (fp32 or bf16) <- a', parameters <- p + u (· ``scale``, a 0-d fp32
    tensor).  One launch per :data:`_cuda.ADAGRAD_LEAVES` leaves."""
    if not grads:
        return
    if grads[0].device.type == "cpu":
        return fused_adagrad_step_plain(grads, accums, params, lr, eps,
                                        scale)
    check_step_operands(grads, accums, params, scale)
    _launch("fused_adagrad", k7_tables(grads, accums, accums, params),
            grads[0].device, scale, lr, eps, True)


def fused_adagrad_list(grads, accums, lr, eps):
    """K7 writing the updates: -> (updates fp32 in each grad's shape, new
    accumulators in the accumulators' dtype); the inputs are untouched."""
    if not grads:
        return [], []
    if grads[0].device.type == "cpu":
        return fused_adagrad_list_plain(grads, accums, lr, eps)
    check_step_operands(grads, accums)
    upd = [torch.empty(g.shape, dtype=torch.float32, device=g.device)
           for g in grads]
    acc = [torch.empty_like(a) for a in accums]
    _launch("fused_adagrad", k7_tables(grads, accums, acc, upd),
            grads[0].device, None, lr, eps, False)
    return upd, acc


def fused_adagrad(grad, accum, lr, eps):
    """K7 on one leaf.  grad: float32 or bfloat16; accum: float32 of
    grad's shape.  -> (update, accum')."""
    (u,), (a,) = fused_adagrad_list([grad], [accum], lr, eps)
    return u, a


# --------------------------------------------------------------------------
# K8
# --------------------------------------------------------------------------
def fused_adagrad_q8_step_(grads, qs, scales, noises, params, lr, eps,
                           scale=None) -> None:
    """The K8 step over one party's leaves, in place: codes and scales
    <- q', s', parameters <- p + u (· ``scale``).  ``noises``: one (R, C)
    fp32 tensor of uniforms a leaf.  One launch per
    :data:`_cuda.ADAGRAD_LEAVES` leaves."""
    if not grads:
        return
    if grads[0].device.type == "cpu":
        return fused_adagrad_q8_step_plain(grads, qs, scales, noises,
                                           params, lr, eps, scale)
    check_q8_step_operands(grads, qs, scales, noises, params, scale)
    _launch("fused_adagrad_q8",
            k8_tables(grads, qs, scales, qs, scales, noises, params),
            grads[0].device, scale, lr, eps, True)


def fused_adagrad_q8_list(grads, qs, scales, noises, lr, eps):
    """K8 writing the updates: -> (updates fp32 in each grad's shape, new
    codes, new scales); the inputs are untouched."""
    if not grads:
        return [], [], []
    if grads[0].device.type == "cpu":
        return fused_adagrad_q8_list_plain(grads, qs, scales, noises, lr,
                                           eps)
    check_q8_step_operands(grads, qs, scales, noises)
    upd = [torch.empty(g.shape, dtype=torch.float32, device=g.device)
           for g in grads]
    q_new = [torch.empty_like(q) for q in qs]
    s_new = [torch.empty_like(s) for s in scales]
    _launch("fused_adagrad_q8",
            k8_tables(grads, qs, scales, q_new, s_new, noises, upd),
            grads[0].device, None, lr, eps, False)
    return upd, q_new, s_new


def fused_adagrad_q8(grad, q, scale, u, lr, eps):
    """K8 on one leaf.  grad: float32 or bfloat16, at most R·C elements
    (the rest are the zero pad); q: (R, C) int8 codes; scale: (R, 1)
    float32; u: (R, C) float32 uniforms.  -> (update in grad's shape,
    codes (R, C), scales (R, 1))."""
    (upd,), (q_new,), (s_new,) = fused_adagrad_q8_list([grad], [q], [scale],
                                                       [u], lr, eps)
    return upd, q_new, s_new
