"""Optimizers as explicit transforms over lists of tensors.

Port of ``repro/optim/__init__.py``.  ``Optimizer(init, update, step)``:

  * ``init(params) -> opt_state``
  * ``update(grads, opt_state, params) -> (updates, opt_state)``; updates
    are ADDED to params by ``apply_updates``;
  * ``step(grads, opt_state, params, scale) -> opt_state``, or None: the
    same update applied in place, multiplied by ``scale`` (a 0-d tensor,
    or None for 1) first, with the state updated in place (its tensors
    keep their storage).  The engine and ``launch/steps.py`` take it
    where an optimizer has one, else ``update`` + ``apply_updates``.

``params`` and ``grads`` are matching lists of tensors (a module's
parameters, which the engine lists in the reference's leaf order).
``torch.optim`` is not used: the engine scales each update by the draw's
valid mask before applying it, and the arithmetic follows the reference
op for op.  Accumulators are fp32 unless ``adagrad(state_dtype=...)``
picks the bf16 or int8 state of :mod:`.quantized`;
``make_optimizer("sm3", ...)`` is the factored accumulator.

``adagrad(..., use_pallas=True)`` takes the hand-written kernel route:
on the card each ``update`` or ``step`` of a list of tensors is one
launch of the fused AdaGrad kernel (K7, ``kernels/fused_adagrad.py``;
one per 48 tensors), where the plain arithmetic takes six elementwise
launches a tensor and ``apply_updates`` two more; ``step`` is AdaGrad's
in-place step.  On the CPU the kernel's plain version runs, the same
arithmetic.  (The keyword is the reference's, whose kernel route was the
Pallas kernel.)
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from ..kernels import ops as kops
from ..kernels.fused_adagrad import fused_adagrad_list_plain


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    step: Optional[Callable] = None


def _zeros_like_f32(params):
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


OPT_STATE_DTYPES = ("float32", "bfloat16", "int8")


def adagrad(lr: float, eps: float = 1e-10, *, use_pallas: bool = False,
            state_dtype: str = "float32", uniforms=None) -> Optimizer:
    """a' = a + g², u = -lr·g / (√a' + eps).  ``uniforms``: the source of
    the int8 state's rounding uniforms (``optim.quantized``)."""
    if state_dtype not in OPT_STATE_DTYPES:
        raise ValueError(f"state_dtype must be one of {OPT_STATE_DTYPES}, "
                         f"got {state_dtype!r}")
    if state_dtype != "float32":
        from .quantized import adagrad_quantized
        return adagrad_quantized(lr, eps, state_dtype=state_dtype,
                                 use_pallas=use_pallas, uniforms=uniforms)
    def init(params):
        return {"accum": _zeros_like_f32(params)}

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


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mom": _zeros_like_f32(params)}
        return {}

    def update(grads, state, params=None):
        if momentum:
            mom = [momentum * m + g.float()
                   for m, g in zip(state["mom"], grads)]
            return [-lr * m for m in mom], {"mom": mom}
        return [-lr * g.float() for g in grads], state

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        p0 = params[0]
        return {"m": _zeros_like_f32(params), "v": _zeros_like_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=p0.device)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = [b1 * m_ + (1 - b1) * g.float()
             for m_, g in zip(state["m"], grads)]
        v = [b2 * v_ + (1 - b2) * torch.square(g.float())
             for v_, g in zip(state["v"], grads)]
        tf = t.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=tf.device), tf)
        upd = [-lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
               for m_, v_ in zip(m, v)]
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: List[torch.Tensor], updates) -> None:
    """p <- p + u, in place (the reference returns new arrays; the port
    updates the module's parameters where they are)."""
    for p, u in zip(params, updates):
        p.add_(u)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    from .quantized import sm3
    return {"adagrad": adagrad, "sgd": sgd, "adam": adam,
            "sm3": sm3}[name](lr, **kw)
