"""Exact per-party device-memory budgets at full LLM geometry, without
allocating a weight (the port of ``repro/launch/budget.py``).

The reference traces under ``jax.eval_shape``; here the parameters are
drawn under ``FakeTensorMode`` (no storage) and held as tensors on the
meta device, and the same model, workset and optimizer code the training
run executes then runs on them, so the accounting is exact and costs no
memory.  On the meta device the kernel wrappers (K9, K9-LSE, K10) return
results of the right shape without computing anything.  Three parts per
party:

  * **params**: the party's tower slice (``models.vfl.init_all``);
  * **optimizer state**: the AdaGrad accumulator
    (``optim.quantized.opt_state_nbytes``): fp32 mirrors the params,
    bf16 halves it, int8 stores sqrt-space codes and per-row scales;
  * **workset cache**: the W-deep ring of cut statistics ⟨z, dz⟩ that the
    local updates replay (``core.workset``), whose cut tensor comes from
    the real Party A forward.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.base import ArchConfig
from ..core.workset import QUANT_KEYS, workset_init, workset_nbytes
from ..models import vfl
from ..models.backbone import tree_map
from ..models.initializers import _leaves
from ..optim import make_optimizer
from ..optim.quantized import opt_state_nbytes


def tree_nbytes(tree) -> int:
    """Total bytes of a tree (nested dicts / lists) of tensors."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _param_shapes(cfg: ArchConfig):
    """Both parties' parameter trees on the meta device."""
    with FakeTensorMode():
        fake = vfl.init_all(0, cfg)
    return tree_map(_meta, fake)


@torch.no_grad()
def _z_struct(cfg: ArchConfig, params_a, batch_size: int, seq_len: int):
    """The cut tensor Z_A on the meta device, from the real Party A
    forward (so the budget follows the model code)."""
    batch_a = {"tokens_a": torch.empty((batch_size, seq_len),
                                       dtype=torch.int64, device="meta")}
    return vfl.forward_a(params_a, cfg, batch_a, train=True)


def _cache_nbytes(z, W: int, cache_dtype: str) -> int:
    """Cut-statistics bytes of ONE W-deep ring holding ⟨z, dz⟩ at
    ``cache_dtype``: the exact ``workset_init`` layout."""
    table = workset_init(W, {"z": z, "dz": z}, cache_dtype=cache_dtype)
    return workset_nbytes(table, QUANT_KEYS)


def party_hbm_budget(cfg: ArchConfig, *, batch_size: int, seq_len: int,
                     W: int = 5, cache_dtype: str = "float32",
                     opt_state_dtype: str = "float32",
                     lr: float = 0.01) -> Dict[str, Any]:
    """-> exact per-party device bytes at full geometry (a flat dict of
    int counters, every key ending in ``_bytes``)."""
    params = _param_shapes(cfg)
    opt = make_optimizer("adagrad", lr, state_dtype=opt_state_dtype)
    z = _z_struct(cfg, params["a"], batch_size, seq_len)
    cache_b = _cache_nbytes(z, W, cache_dtype)
    row = {
        "params_bytes_a": tree_nbytes(params["a"]),
        "params_bytes_b": tree_nbytes(params["b"]),
        "opt_state_bytes_a": opt_state_nbytes(opt, _leaves(params["a"])),
        "opt_state_bytes_b": opt_state_nbytes(opt, _leaves(params["b"])),
        # both parties keep one W-deep ring over the same cut tensor
        # (Party B's table holds the K=1 z / dz lists: the same bytes)
        "cache_bytes_a": cache_b,
        "cache_bytes_b": cache_b,
    }
    for p in ("a", "b"):
        row[f"hbm_total_bytes_{p}"] = (row[f"params_bytes_{p}"]
                                       + row[f"opt_state_bytes_{p}"]
                                       + row[f"cache_bytes_{p}"])
    return row


def format_budget(name: str, row: Dict[str, Any]) -> str:
    """A readable per-party budget block."""
    gb = 1024 ** 3
    lines = [f"[hbm] {name}: per-party device-memory budget"]
    for p in ("a", "b"):
        lines.append(
            f"[hbm]   party {p}: params "
            f"{row[f'params_bytes_{p}'] / gb:8.3f} GiB + opt state "
            f"{row[f'opt_state_bytes_{p}'] / gb:8.3f} GiB + workset cache "
            f"{row[f'cache_bytes_{p}'] / gb:8.3f} GiB = "
            f"{row[f'hbm_total_bytes_{p}'] / gb:8.3f} GiB")
    return "\n".join(lines)
