"""Parameter bridge between the reference's pytrees and the port's modules.

A reference parameter pytree (nested dicts and lists of arrays, passed in
as numpy) flattens to dotted paths — ``{"tower": {"mlp": [{"w": ...}]}}``
to ``tower.mlp.0.w`` — which are exactly the ``state_dict`` keys of the
port's modules.  Tests start both frameworks from the same weights with
:func:`load_tree`; :func:`to_tree` goes back.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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
            v = torch.from_numpy(np.array(flat[k], order="C"))
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
