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

Both entry points are ``torch.library`` ops (``kernels/jobs.py``) whose
``vmap`` rule runs a fleet's jobs in one job-batched launch; the
threshold may then be each job's own (``cos_xi`` a tensor).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .jobs import register_gate

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


def threshold_operands(cos_xi):
    """cos ξ -> the gate ops' ``(thr, thresh)``: a number goes by value
    as its float32 (``thr`` None: the scalar path copies nothing to the
    card); a tensor (a fleet job's own threshold, batched under ``vmap``)
    goes as the fp32 tensor ``thr``."""
    if torch.is_tensor(cos_xi):
        return cos_xi.to(torch.float32), 0.0
    return None, f32_threshold(cos_xi)


def plain_threshold(thr, thresh, w_dim: int):
    """The threshold the plain version compares ``w_dim``-d (..., B)
    weights against: ``thresh``, or ``thr`` (one value a job) shaped to
    broadcast against them."""
    if thr is None:
        return thresh
    return thr.reshape(tuple(thr.shape) + (1,) * (w_dim - thr.dim()))


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernel's oracle)
# --------------------------------------------------------------------------
def gate_weights_plain(a, s, thresh):
    """(..., B, F) x2 -> (..., B) fp32 row cosines, zero below ``thresh``
    (a float, or a tensor that broadcasts against the weights)."""
    a = a.float()
    s = s.float()
    num = (a * s).sum(dim=-1)
    den = torch.sqrt((a * a).sum(dim=-1) * (s * s).sum(dim=-1))
    w = num / torch.clamp(den, min=EPS)
    return torch.where(w < thresh, 0.0, w)


def gate_plain(a, z, dz, thr, thresh):
    """The gate over materialised rows with any leading (job) axes:
    -> (weights, ``dz`` scaled by them in fp32, or None without ``dz``)."""
    w = gate_weights_plain(a, z, plain_threshold(thr, thresh, a.dim() - 1))
    return w, (None if dz is None else dz.float() * w[..., None])


def cosine_weights_plain(ad_hoc, stale, cos_xi):
    return gate_plain(ad_hoc, stale, None, *threshold_operands(cos_xi))[0]


def cosine_weight_plain(ad_hoc, stale, dz, cos_xi):
    return gate_plain(ad_hoc, stale, dz, *threshold_operands(cos_xi))


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


def _k2_single(slot, a, z, zs, dz, dzs, thr, thresh):
    """One K2 call (``dz`` None: K2b) -> (w, cot or None)."""
    name = "cosine_weights_2d" if dz is None else "cosine_weight_2d"
    if a.device.type == "cpu":
        return gate_plain(a, z, dz, thr, thresh)
    check_rows(name, a, z, dz)
    w = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    cot = None if dz is None else torch.empty(
        a.shape, dtype=torch.float32, device=a.device)
    _cuda.launch_cosine_gate(name, slot=None, n_slots=1, slot_stride=0, a=a,
                             z=z, dz=dz, w=w, cot=cot,
                             part=gate_workspace(*a.shape, a.device),
                             thresh=thresh, thr=thr)
    return w, cot


def check_jobs(name: str, n: int, ops) -> None:
    """A job-batched gate's operand check beyond each job's: a tensor
    threshold is one fp32 a job on the operands' device."""
    thr, dev = ops["thr"], ops["a"].t.device
    if thr.t is not None and (
            thr.t.dtype != torch.float32 or thr.t.device != dev
            or thr.t.numel() != (n if thr.batched else 1)):
        raise ValueError(f"{name}: thr must be one float32 a job on {dev}")


def gate_job_outputs(n: int, a_job, with_cot: bool):
    """A job-batched gate's outputs and workspace, every job's: w (n, B),
    cot (n, B, F) or None, the split-row path's (n, B, chunks, 3) or
    None (the chunk rule is the one-job call's, so each job's sums run in
    the order of its one-job launch)."""
    B, F = a_job.shape
    dev = a_job.device
    w = torch.empty((n, B), dtype=torch.float32, device=dev)
    cot = torch.empty((n, B, F), dtype=torch.float32, device=dev) \
        if with_cot else None
    chunks = gate_chunks(B, F)
    part = None if chunks == 1 else torch.empty(
        (n, B, chunks, 3), dtype=torch.float32, device=dev)
    return w, cot, part


def _k2_jobs(n, ops, thresh):
    """K2 over ``n`` jobs on the card: one launch."""
    dz = ops["dz"]
    name = "cosine_weights_2d" if dz.t is None else "cosine_weight_2d"
    a, z, thr = ops["a"], ops["z"], ops["thr"]
    check_jobs(name, n, ops)
    check_rows(name, a.job(0), z.job(0), dz.job(0))
    w, cot, part = gate_job_outputs(n, a.job(0), dz.t is not None)
    _cuda.launch_cosine_gate(
        name, slot=None, n_slots=1, slot_stride=0, a=a.t, z=z.t, dz=dz.t,
        w=w, cot=cot, part=part, thresh=thresh, n_jobs=n, thr=thr.t,
        strides={"a": a.stride, "z": z.stride, "dz": dz.stride,
                 "thr": thr.stride})
    return w, cot


K2A_OP = register_gate("cosine_weight_2d", _k2_single, _k2_jobs)
K2B_OP = register_gate("cosine_weights_2d", _k2_single, _k2_jobs)


def cosine_weights_2d(ad_hoc, stale, cos_xi):
    """K2b.  ad_hoc, stale: (B, F); ``cos_xi`` a number or an fp32
    tensor.  -> (B,) fp32 weights."""
    thr, thresh = threshold_operands(cos_xi)
    return K2B_OP(None, ad_hoc, stale, None, None, None, thr, thresh)[0]


def cosine_weight_2d(ad_hoc, stale, dz, cos_xi):
    """K2a.  ad_hoc, stale, dz: (B, F).  -> (weights (B,) fp32, weighted
    cotangent (B, F) fp32).  The reference returns the cotangent in dz's
    dtype; the engine always passes fp32 dz, where the two agree."""
    thr, thresh = threshold_operands(cos_xi)
    return K2A_OP(None, ad_hoc, stale, None, dz, None, thr, thresh)
