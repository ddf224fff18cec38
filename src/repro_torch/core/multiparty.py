"""Multi-party CELU-VFL: two or more feature parties (the paper's
footnote 1 and §6 leave the extension to future work).

Port of ``repro/core/multiparty.py``: a thin K-party preset over
:mod:`repro_torch.core.engine`, whose task and state layout are the
engine's own, so the functions delegate.  In a round every A_i sends Z_i
and receives ∇Z_i (K uplinks and K downlinks), all parties take the fresh
step, each A_i runs R local updates off its own ring weighted by
cos(Z_i^(j), Z_i), and B runs R off its ring, weighting each instance by
the minimum per-party derivative cosine.

    forward_a(params_a_i, batch_a_i) -> Z_i           (per party)
    loss_b(params_b, [Z_1..Z_K], batch_b) -> (per-instance loss, aux)
"""
from __future__ import annotations

from typing import Any, Dict, List

from ..configs.base import CELUConfig
from ..optim import Optimizer
from . import engine

# The K-party task tuple is the engine's native interface.
MultiVFLTask = engine.KPartyTask


def init_state(task: MultiVFLTask, params: Dict[str, Any], opt: Optimizer,
               celu: CELUConfig, batches_a: List[Dict[str, Any]],
               batch_b: Dict[str, Any], transport=None, compression=None,
               uniforms=None):
    """params = {"a": [pa_1..pa_K], "b": pb} (modules)."""
    return engine.init_state(task, params, opt, celu, batches_a, batch_b,
                             transport=transport, compression=compression,
                             uniforms=uniforms)


def make_round(task: MultiVFLTask, opt: Optimizer, celu: CELUConfig,
               *, local_steps: int = -1, transport=None, compression=None):
    """fn(state, batches_a: list, batch_b, batch_idx) -> (state, metrics).

    ``compression`` names a wire codec (``core.compression.CODEC_SPECS``)
    when no explicit ``transport`` is given."""
    return engine.make_round(task, opt, celu, local_steps=local_steps,
                             transport=transport, compression=compression)
