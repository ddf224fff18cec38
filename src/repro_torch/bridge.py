"""Parameter bridge between the reference's pytrees and the port's modules.

A reference parameter pytree (nested dicts and lists of arrays, passed in
as numpy) flattens to dotted paths — ``{"tower": {"mlp": [{"w": ...}]}}``
to ``tower.mlp.0.w`` — which are exactly the ``state_dict`` keys of the
port's modules.  Tests start both frameworks from the same weights with
:func:`load_tree`; :func:`to_tree` goes back.

JAX flattens a pytree with dict keys sorted and list entries by index,
which is not the order in which a module registers its parameters (a
``Dense`` registers ``w`` before ``b``; JAX flattens ``b`` first).  The
engine lists a party's parameters in JAX's order
(:func:`reference_parameters`), so per-leaf optimizer state and the int8
state's per-leaf rounding uniforms line up with the reference's leaf
indices; :func:`load_opt_state` brings a reference optimizer state across.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from .optim.quantized import QuantAccum


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts / lists of arrays -> {dotted path: numpy array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@functools.lru_cache(maxsize=4096)       # the engine sorts on every step
def path_key(path: str) -> tuple:
    """Sort key of a dotted path in JAX's flattening order: dict keys as
    strings, list entries (all-digit components) by index."""
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in path.split("."))


def reference_parameters(module: torch.nn.Module) -> list:
    """``module``'s parameters in the reference pytree's leaf order."""
    return [p for _, p in sorted(module.named_parameters(),
                                 key=lambda kv: path_key(kv[0]))]


def load_tree(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a reference pytree into ``module``'s parameters in place.
    The paths and shapes must match exactly."""
    return load_flat(module, flatten_tree(tree))


def subtree(flat: Dict[str, np.ndarray], prefix: str
            ) -> Dict[str, np.ndarray]:
    """The entries of ``flat`` under dotted ``prefix``, prefix removed."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}


def load_flat(module: torch.nn.Module, flat: Dict[str, np.ndarray]
              ) -> torch.nn.Module:
    """Copy {dotted path: array} into ``module``'s parameters in place."""
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"pytree paths {sorted(set(flat) - set(params))} "
                       f"have no parameter; parameters "
                       f"{sorted(set(params) - set(flat))} have no path")
    with torch.no_grad():
        for k, p in params.items():
            v = _tensor(flat[k], "cpu")
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{k}: pytree shape {tuple(v.shape)} != "
                                 f"parameter shape {tuple(p.shape)}")
            p.copy_(v.to(p.dtype))
    return module


def to_tree(module: torch.nn.Module) -> Any:
    """``module``'s parameters as a nested dict / list pytree of numpy."""
    root: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        node = root
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}
    return listify(root)


def _tensor(x, device) -> torch.Tensor:
    """An array (numpy, or the reference's, whose bf16 comes out as
    ``ml_dtypes.bfloat16``) -> a tensor on ``device``, bitwise.  PyTorch
    takes no numpy bf16, so its bits travel as int16."""
    a = np.array(np.asarray(x), order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_to_torch(tree, device="cpu"):
    """A reference pytree of arrays (nested dicts / lists, e.g. the LLM
    parameters of ``repro.models.vfl.init_all``) -> the same tree of
    tensors on ``device``, leaf for leaf and bitwise: the port's LLM
    functions take such trees."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    return _tensor(tree, device)


def load_opt_state(state, device="cpu") -> dict:
    """A reference AdaGrad / SM3 optimizer state, its arrays as numpy
    (``jax.tree_util.tree_map(np.asarray, state)``), -> the port's state
    on ``device``: a mirrored accumulator tree (fp32 / bf16 AdaGrad)
    becomes a list in the reference's leaf order, a tuple of per-leaf
    entries (int8 ``QuantAccum``, SM3's row / col dicts) a list of the
    port's entries, and the int32 step ``t`` a host int."""
    def entry(x):
        if hasattr(x, "q") and hasattr(x, "scale"):
            return QuantAccum(_tensor(x.q, device), _tensor(x.scale, device),
                              x.shape)
        if isinstance(x, dict):
            return {k: _tensor(v, device) for k, v in x.items()}
        return _tensor(x, device)

    acc = state["accum"]
    if isinstance(acc, tuple):
        out = {"accum": [entry(x) for x in acc]}
    else:
        flat = flatten_tree(acc)
        out = {"accum": [_tensor(flat[k], device)
                         for k in sorted(flat, key=path_key)]}
    if "t" in state:
        out["t"] = int(np.asarray(state["t"]))
    return out
