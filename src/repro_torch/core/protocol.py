"""Two-party VFL protocols: Vanilla, FedBCD, CELU-VFL (paper Section 3).

Port of ``repro/core/protocol.py``: a thin two-party preset over
:mod:`repro_torch.core.engine`, with the two-party state layout
(``params/opt/ws/steps`` keyed ``"a"``/``"b"`` with scalar step counters).

A *task* is the minimal two-party interface:

    forward_a(params_a, batch_a) -> Z_A
    loss_b(params_b, z_a, batch_b) -> (per_instance_loss (B,), aux_scalar)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..configs.base import CELUConfig
from ..optim import Optimizer
from . import engine


class VFLTask(NamedTuple):
    """Two-party split model interface (see module docstring)."""
    forward_a: Callable[[Any, Dict[str, Any]], torch.Tensor]
    loss_b: Callable[[Any, torch.Tensor, Dict[str, Any]],
                     Tuple[torch.Tensor, torch.Tensor]]


def _to_engine(state):
    return {
        "params": {"a": [state["params"]["a"]], "b": state["params"]["b"]},
        "opt": {"a": [state["opt"]["a"]], "b": state["opt"]["b"]},
        "ws": {"a": [state["ws"]["a"]], "b": state["ws"]["b"]},
        "steps": {"a": [state["steps"]["a"]], "b": state["steps"]["b"]},
        "comm_rounds": state["comm_rounds"],
        "round": state["round"],
        "uniforms": state["uniforms"],
        "transport": state.get("transport", {}),
    }


def _from_engine(st):
    return {
        "params": {"a": st["params"]["a"][0], "b": st["params"]["b"]},
        "opt": {"a": st["opt"]["a"][0], "b": st["opt"]["b"]},
        "ws": {"a": st["ws"]["a"][0], "b": st["ws"]["b"]},
        "steps": {"a": st["steps"]["a"][0], "b": st["steps"]["b"]},
        "comm_rounds": st["comm_rounds"],
        "round": st["round"],
        "uniforms": st["uniforms"],
        "transport": st.get("transport", {}),
    }


def init_state(task: VFLTask, params: Dict[str, Any], opt: Optimizer,
               celu: CELUConfig, batch_a: Dict[str, Any],
               batch_b: Dict[str, Any], transport=None, compression=None):
    """Build the full training state; ``batch_a/b`` are example batches
    that size the workset rings."""
    st = engine.init_state(engine.lift_two_party(task),
                           engine.lift_two_party_params(params),
                           opt, celu, [batch_a], batch_b,
                           transport=transport, compression=compression)
    return _from_engine(st)


def exchange_bytes(z_shape, dtype_bytes: int = 4,
                   wire_dtype: str = "float32") -> int:
    """Bytes moved per communication round (Z_A + ∇Z_A)."""
    import numpy as np
    if not wire_dtype:
        return 2 * int(np.prod(z_shape)) * dtype_bytes
    tp = engine.SimWANTransport(CELUConfig(wire_dtype=wire_dtype))
    return tp.round_bytes([z_shape])


def make_round(task: VFLTask, opt: Optimizer, celu: CELUConfig,
               *, local_steps: int = -1, transport=None, compression=None):
    """fn(state, batch_a, batch_b, batch_idx) -> (state, metrics)."""
    eng = engine.make_round(engine.lift_two_party(task), opt, celu,
                            local_steps=local_steps, transport=transport,
                            compression=compression)

    def round_fn(state, batch_a, batch_b, batch_idx):
        st, m = eng(_to_engine(state), [batch_a], batch_b, batch_idx)
        return _from_engine(st), m

    return round_fn
