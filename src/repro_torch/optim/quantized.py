"""Quantised optimizer state: bf16 / int8 AdaGrad accumulators and an
SM3-style factored accumulator.

Port of ``repro/optim/quantized.py``.  Three at-rest options, all keeping
the fp32 update arithmetic:

  * ``bfloat16`` — the accumulator is stored bf16 and widened around the
    fused fp32 step (K7, ``kernels/fused_adagrad.py``, which reads and
    stores the bf16 accumulator itself);
  * ``int8`` — int8 sqrt-space codes in [0, 127] plus one fp32 scale a
    row (accumulator value = (code·scale)²), stored in the reference
    kernel's padded (R, C) tiling (:func:`_tiling`).  The step is K8:
    dequantise, accumulate g², emit the update, re-derive the row scale
    and requantise with stochastic rounding in one pass (one launch for
    all of a party's leaves), so the fp32 accumulator never exists in
    device memory.  The rounding uniforms come
    from a uniform source (``core/uniforms.py``) under the tag
    ``("optim", t, i)``: ``t`` is the state's update counter, kept as a
    host int so a tag costs no sync, and ``i`` the leaf's index in the
    parameter list, which the engine hands over in the reference's leaf
    order (``bridge.reference_parameters``);
  * ``sm3`` — the factored accumulator (Anil et al.): an (r, c) leaf keeps
    a row vector (r,) and a column vector (c,) of running maxima, and the
    cover ``min(row_i, col_j)`` upper-bounds the AdaGrad sum.  Leaves of
    fewer than two dimensions keep the exact accumulator.  Plain PyTorch,
    as in the reference.

State layout: ``{"accum": [one entry per parameter], "t": int}`` (``t``
for int8 only); an entry is a tensor (bf16), a :class:`QuantAccum` (int8)
or SM3's ``{"row", "col"}`` / ``{"full"}`` dict.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.uniforms import GeneratorUniforms, optim_key
from ..kernels import ops as kops
from ..kernels.fused_adagrad import (BLOCK, ROWS, fused_adagrad_list_plain,
                                     fused_adagrad_plain,
                                     fused_adagrad_q8_list_plain)
from . import Optimizer


class QuantAccum:
    """int8-at-rest AdaGrad accumulator of ONE parameter.

    ``q``: (R, C) int8 sqrt-space codes in [0, 127]; ``scale``: (R, 1)
    fp32 row scales; ``shape``: the parameter's shape, which
    :meth:`dequant` (inspection only: the step never calls it) restores."""

    __slots__ = ("q", "scale", "shape")

    def __init__(self, q, scale, shape):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() \
            + self.scale.numel() * self.scale.element_size()

    def dequant(self):
        n = math.prod(self.shape)
        r = self.q.float() * self.scale
        return (r * r).reshape(-1)[:n].reshape(self.shape)


def _tiling(n: int) -> Tuple[int, int]:
    """Element count -> the padded (R, C) tiling, R a multiple of ROWS.

    Small leaves take C ≈ n / ROWS, so a bias costs no more quantised
    than in fp32; leaves of at least ROWS·BLOCK elements take C = BLOCK."""
    cols = max(min(BLOCK, -(-max(n, 1) // ROWS)), 1)
    n_rows = -(-max(n, 1) // cols)
    return -(-n_rows // ROWS) * ROWS, cols


def quant_accum_init(p) -> QuantAccum:
    """The all-zero int8 state of parameter ``p``, on p's device."""
    R, C = _tiling(p.numel())
    return QuantAccum(torch.zeros((R, C), dtype=torch.int8, device=p.device),
                      torch.zeros((R, 1), dtype=torch.float32,
                                  device=p.device), p.shape)


def adagrad_quantized(lr: float, eps: float = 1e-10, *,
                      state_dtype: str = "int8", use_pallas: bool = True,
                      uniforms=None) -> Optimizer:
    """AdaGrad with a quantised at-rest accumulator (see the module
    docstring).  ``state_dtype``: "int8" | "bfloat16".  ``use_pallas``
    takes the hand-written kernel route (K7 / K8; on the CPU their plain
    versions), else the plain PyTorch arithmetic.  ``uniforms`` is the
    source of the int8 requantisation uniforms; the default draws from a
    ``torch.Generator`` seeded with 0 on the gradients' device."""
    if state_dtype not in ("int8", "bfloat16"):
        raise ValueError(f"state_dtype must be int8|bfloat16, "
                         f"got {state_dtype!r}")

    if state_dtype == "bfloat16":
        def init(params):
            return {"accum": [torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=p.device) for p in params]}

        updates = kops.fused_adagrad_list if use_pallas \
            else fused_adagrad_list_plain

        def update(grads, state, params=None):
            upd, acc = updates(grads, state["accum"], lr, eps)
            return upd, {"accum": acc}

        if not use_pallas:
            return Optimizer(init, update)

        def step(grads, state, params, scale=None):
            kops.fused_adagrad_step_(grads, state["accum"], params, lr, eps,
                                     scale)
            return state

        return Optimizer(init, update, step)

    defaults = {}

    def source(device):
        if uniforms is not None:
            return uniforms
        if device not in defaults:
            defaults[device] = GeneratorUniforms(0, device)
        return defaults[device]

    def init(params):
        return {"accum": [quant_accum_init(p) for p in params], "t": 0}

    def noises(grads, state):
        """One (R, C) tensor of uniforms a leaf, under ``("optim", t,
        i)``."""
        key = optim_key(source(grads[0].device), state["t"])
        return [key.fold(i).uniform(a.q.shape)
                for i, a in enumerate(state["accum"])]

    def qs(state):
        return ([a.q for a in state["accum"]],
                [a.scale for a in state["accum"]])

    updates = kops.fused_adagrad_q8_list if use_pallas \
        else fused_adagrad_q8_list_plain

    def update(grads, state, params=None):
        upd, q_new, s_new = updates(grads, *qs(state), noises(grads, state),
                                    lr, eps)
        acc = [QuantAccum(q, s, a.shape)
               for q, s, a in zip(q_new, s_new, state["accum"])]
        return upd, {"accum": acc, "t": state["t"] + 1}

    if not use_pallas:
        return Optimizer(init, update)

    def step(grads, state, params, scale=None):
        kops.fused_adagrad_q8_step_(grads, *qs(state), noises(grads, state),
                                    params, lr, eps, scale)
        state["t"] += 1
        return state

    return Optimizer(init, update, step)


def sm3(lr: float, eps: float = 1e-10) -> Optimizer:
    """SM3-style factored AdaGrad: O(r + c) state for an (r, c...) leaf
    through running row / column maxima; exact AdaGrad for leaves of fewer
    than two dimensions.  Every step is at most AdaGrad's."""

    def _rc(p) -> Tuple[int, int]:
        return int(p.shape[0]), math.prod(p.shape[1:])

    def init(params):
        acc = []
        for p in params:
            if p.dim() >= 2:
                r, c = _rc(p)
                acc.append({"row": torch.zeros(r, device=p.device),
                            "col": torch.zeros(c, device=p.device)})
            else:
                acc.append({"full": torch.zeros(p.shape, device=p.device)})
        return {"accum": acc}

    def update(grads, state, params=None):
        upd, new_acc = [], []
        for g, acc in zip(grads, state["accum"]):
            if "full" in acc:
                u, a_new = fused_adagrad_plain(g, acc["full"], lr, eps)
                upd.append(u)
                new_acc.append({"full": a_new})
                continue
            gf = g.float()
            r, c = _rc(g)
            v = torch.minimum(acc["row"][:, None], acc["col"][None, :]) \
                + (gf * gf).reshape(r, c)
            upd.append((-lr * gf.reshape(r, c)
                        / (torch.sqrt(v) + eps)).reshape(g.shape))
            new_acc.append({"row": v.amax(dim=1), "col": v.amax(dim=0)})
        return upd, {"accum": new_acc}

    return Optimizer(init, update)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, QuantAccum):
        return x.nbytes
    if isinstance(x, int):
        return 4            # the reference's int32 step counter
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return sum(_nbytes(v) for v in x)


def opt_state_nbytes(opt: Optimizer, params) -> int:
    """Exact device bytes of ``opt.init(params)``, counted on the meta
    device without allocating the state."""
    meta = [torch.empty(p.shape, dtype=p.dtype, device="meta")
            for p in params]
    return _nbytes(opt.init(meta))
