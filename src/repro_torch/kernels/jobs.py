"""The job axis of the gate and quantiser kernels: ``torch.library`` ops.

The fleet (``repro_torch/fleet``) runs a cohort of CELU-VFL jobs as one
batched program under ``torch.func.vmap``, so each launch serves every
job.  For that, the Algorithm-2 gate entry points (K1
``fused_sample_2d``, K2a ``cosine_weight_2d``, K2b ``cosine_weights_2d``,
K4 ``fused_sample_q8_2d``, K5 ``fused_sample_q4_2d``) and the quantiser
(K3 ``quantize_sr_2d``) are custom ops, ``torch.ops.repro_torch.<name>``,
each with

  * its one-job implementation (the kernel module's wrapper: the kernel on
    a CUDA tensor, its plain version on a CPU tensor);
  * a fake rule, for abstract (meta and fake) tensors: the launch's
    outputs and its split-row workspace, empty, with the kernel's
    operations and bytes added to the installed accountant
    (``_cuda.account``);
  * a ``vmap`` rule: ONE job-batched call for the N jobs.  On a CUDA
    tensor that is one launch of the job-batched kernel
    (``csrc/cosine_gate.cu``'s grid takes the jobs on its last axis; K3
    folds the jobs into its rows, since its scales are per row), counted
    once in ``_cuda.LAUNCHES``.  It never loops scalar launches.  On a CPU
    tensor each job's operands go through the op itself, one call a job
    (its plain version; K3's folded rows in one call), so a traced
    ``vmap`` shows the op as a node.

Every gate op takes ``(slot, a, z, zs, dz, dzs, thr, thresh)``: the ring
slot (None for K2's materialised rows), the ad-hoc rows, the stale z and
its row scales (K4 / K5), the stale ∇Z and its scales (None: weights
only, returned as an empty cotangent), and the threshold, either
``thresh`` by value (``thr`` None) or the fp32 tensor ``thr`` (a job's own
cos ξ under ``vmap``).  An operand that ``vmap`` leaves unbatched is
shared by every job: the kernel reads it with a job stride of 0, and
nothing is expanded or copied.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import _cuda

GATE_OPERANDS = ("slot", "a", "z", "zs", "dz", "dzs", "thr")


class JobOperand(NamedTuple):
    """An operand of a job-batched call: ``t`` with its jobs on dim 0
    (``batched``) or one operand that every job shares; ``stride`` is
    the job stride in elements (0 when shared)."""
    t: Optional[torch.Tensor]
    stride: int
    batched: bool

    def per_job(self, n: int):
        """(n, ...) for the plain version: a shared operand expanded (a
        view)."""
        if self.t is None or self.batched:
            return self.t
        return self.t.expand((n,) + tuple(self.t.shape))

    def job(self, i: int):
        """Job ``i``'s operand (the shared one for every job)."""
        if self.t is None or not self.batched:
            return self.t
        return self.t[i]


def job_operand(x, bdim) -> JobOperand:
    """An operand as ``vmap`` hands it to a rule -> :class:`JobOperand`.
    A batched one gets its jobs on dim 0 (a view) and is made contiguous
    per job only where it is not; a shared one (``bdim`` None) keeps its
    shape and a stride of 0."""
    if x is None or bdim is None:
        return JobOperand(x, 0, False)
    x = x.movedim(bdim, 0)
    if not x[0].is_contiguous():
        x = x.contiguous()
    return JobOperand(x, x.stride(0), True)


def gate_costs(slot, a, z, zs, dz, dzs):
    """(operations, bytes) of one gate launch: about 7 operations an
    element of the (B, F) rows; the ad-hoc rows read, one slot of each
    ring (every ring when ``slot`` is None: K2's materialised rows) and
    its scales read, the weights (and the fp32 cotangent) written."""
    B, F = a.shape
    slots = 1 if slot is None else z.shape[0]

    def row(t):
        return 0 if t is None else t.numel() * t.element_size() // slots
    nbytes = (a.numel() * a.element_size() + row(z) + row(zs) + row(dz)
              + row(dzs) + 4 * B + (4 * B * F if dz is not None else 0))
    return 7 * B * F, nbytes


def register_gate(name: str, single: Callable, jobs: Callable):
    """Register ``torch.ops.repro_torch.<name>``.  ``single(slot, a, z,
    zs, dz, dzs, thr, thresh)`` is the one-job wrapper, -> (w, cot or
    None); ``jobs(n, ops, thresh)`` the job-batched launch on the card,
    ``ops`` mapping :data:`GATE_OPERANDS` to :class:`JobOperand` s, ->
    (w (n, B), cot (n, B, F) or None)."""
    def op(slot: Optional[torch.Tensor], a: torch.Tensor, z: torch.Tensor,
           zs: Optional[torch.Tensor], dz: Optional[torch.Tensor],
           dzs: Optional[torch.Tensor], thr: Optional[torch.Tensor],
           thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
        w, cot = single(slot, a, z, zs, dz, dzs, thr, thresh)
        return w, (a.new_empty(0) if cot is None else cot)

    op.__name__ = name
    cop = torch.library.custom_op(f"repro_torch::{name}", op,
                                  mutates_args=())

    def fake(slot, a, z, zs, dz, dzs, thr, thresh):
        from .cosine_weight import gate_workspace
        B, F = a.shape
        gate_workspace(B, F, a.device)    # the launch's own, freed after it
        _cuda.account(name, *gate_costs(slot, a, z, zs, dz, dzs))
        return (a.new_empty((B,), dtype=torch.float32),
                a.new_empty((B, F) if dz is not None else (0,),
                            dtype=torch.float32))
    cop.register_fake(fake)

    def rule(info, in_dims, slot, a, z, zs, dz, dzs, thr, thresh):
        ops = {k: job_operand(x, d) for k, x, d in zip(
            GATE_OPERANDS, (slot, a, z, zs, dz, dzs, thr), in_dims)}
        n = info.batch_size
        if a.device.type == "cpu":
            # the plain version, one call of the op a job (so a traced
            # fleet step shows the op as a node for each job)
            outs = [cop(*(ops[k].job(j) for k in GATE_OPERANDS), thresh)
                    for j in range(n)]
            w = torch.stack([o[0] for o in outs])
            cot = None if dz is None else torch.stack([o[1] for o in outs])
        else:
            w, cot = jobs(n, ops, thresh)
        if cot is None:
            return (w, a.new_empty(0)), (0, None)
        return (w, cot), (0, 0)
    cop.register_vmap(rule)
    return cop


def register_quantize(rows: Callable):
    """Register ``torch.ops.repro_torch.quantize_sr_2d(x, u, levels)``.
    ``rows(x, u, levels)`` is K3 on (T, L) rows; the vmap rule folds the
    jobs into the rows (one scale a row, so the jobs' rows are K3's rows)
    and calls the op once on them."""
    def quantize_sr_2d(x: torch.Tensor, u: torch.Tensor,
                       levels: float) -> Tuple[torch.Tensor, torch.Tensor]:
        return rows(x, u, levels)

    cop = torch.library.custom_op("repro_torch::quantize_sr_2d",
                                  quantize_sr_2d, mutates_args=())

    def fake(x, u, levels):
        # x (fp32 or bf16) and u read, the codes and a scale a row
        # written; about four operations an element
        _cuda.account("quantize_sr_2d", 4 * x.numel(),
                      (x.element_size() + 5) * x.numel() + 4 * x.shape[0])
        return (x.new_empty(x.shape, dtype=torch.int8),
                x.new_empty(x.shape[:1], dtype=torch.float32))
    cop.register_fake(fake)

    def rule(info, in_dims, x, u, levels):
        n = info.batch_size
        x, u = (job_operand(t, d).per_job(n)
                for t, d in ((x, in_dims[0]), (u, in_dims[1])))
        T, L = x.shape[1:]
        q, scale = cop(x.reshape(n * T, L).contiguous(),
                       u.reshape(n * T, L).contiguous(), levels)
        return (q.reshape(n, T, L), scale.reshape(n, T)), (0, 0)
    cop.register_vmap(rule)
    return cop


def register_dequant(name: str, single: Callable, width: Callable):
    """Register ``torch.ops.repro_torch.<name>(slot, zq, zscale)``, the
    ring dequantiser K6 / K11: ``single(slot, zq, zscale)`` is the wrapper
    (the kernel on a CUDA tensor, the plain version on a CPU tensor), ->
    (B, F) fp32; ``width(P)`` is F for codes (W, B, P).  The fake rule
    allocates the output and adds the launch's costs to the installed
    accountant: one slot's codes and scales read, the fp32 rows written,
    one multiply an element.  The ``vmap`` rule calls the op once a job
    (there is no job-batched ring-dequant kernel: the serving engine
    reads one ring)."""
    def op(slot: torch.Tensor, zq: torch.Tensor,
           zscale: torch.Tensor) -> torch.Tensor:
        return single(slot, zq, zscale)

    op.__name__ = name
    cop = torch.library.custom_op(f"repro_torch::{name}", op,
                                  mutates_args=())

    def fake(slot, zq, zscale):
        _, B, P = zq.shape
        out = zq.new_empty((B, width(P)), dtype=torch.float32)
        _cuda.account(name, out.numel(), B * P + 4 * B + 4 * out.numel())
        return out
    cop.register_fake(fake)

    def rule(info, in_dims, slot, zq, zscale):
        ops = [job_operand(x, d) for x, d in zip((slot, zq, zscale),
                                                   in_dims)]
        return torch.stack([cop(*(o.job(j) for o in ops))
                            for j in range(info.batch_size)]), 0
    cop.register_vmap(rule)
    return cop
