"""Checkpoints of trees and of the scheduler's round state, as ``.npz``
files with flat ``/``-joined key paths.

Port of ``repro/checkpoint/checkpoint.py``, with the same keys and storage
rules, so that the two packages read each other's files:

  * a key is the reference pytree's path: dict keys, list indices, a
    named tuple's field names; a party's parameters are keyed by their
    pytree paths (``tower/mlp/0/w``), and so are the per-parameter lists
    that mirror them (the fresh gradients, an fp32 / bf16 optimizer
    accumulator), which the port keeps in the reference's leaf order
    (``bridge.reference_parameters``);
  * bf16 is stored as its ``uint16`` bits; a file holding fp32 under a
    bf16 reference restores by a value cast;
  * ``QuantLeaf`` / ``Quant4Leaf`` / ``CastLeaf`` and ``QuantAccum`` are
    stored natively: int8 codes or packed uint8 nibbles under ``.../0``,
    fp32 scales under ``.../1`` (a ``CastLeaf``'s bf16 under ``.../0``);
  * host ints (the step counter ``t`` of the int8 optimizer state, a
    pending exchange's ``dispatched_at`` and ``batch_idx``, the chaos
    engine's bookkeeping) are 0-d arrays, int32 where the reference's
    value is an int32 array;
  * ``__round_state__/pending_len`` records the in-flight queue's depth.

Leaves are stored in the port's dtypes (the batches' integer ids are
int64 where the reference's are int32); a restore casts each value to its
reference's dtype, as the reference's does.

A restore writes into the reference's tensors with ``copy_``, on their
device: the in-place optimizer step (K7 / K8) and a captured CUDA graph
depend on fixed addresses, so no tensor of the reference is replaced.

The port's default uniform source (``core/uniforms.GeneratorUniforms``)
is a ``torch.Generator`` whose position moves with every draw (the wire,
the quantised inserts, uniform sampling, the int8 optimizer state, DP).
``save_round_state`` stores it under ``__repro_torch__/uniforms``, a key
the reference's restore ignores.  A file without it (one the reference
wrote) restores only into a round state whose source is a function of
the tag alone (the tests' ``jax_uniforms``); restoring it into a
generator source raises rather than resuming on other uniforms.  An int8
AdaGrad state draws from the source it was built with: give it the round
state's (as ``launch.train.make_opt`` does) for a bitwise resume.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..bridge import path_key
from ..core.workset import CastLeaf, QuantLeaf
from ..optim.quantized import QuantAccum

_SEP = "/"
_PENDING_META = "__round_state__" + _SEP + "pending_len"
_UNIFORMS = "__repro_torch__" + _SEP + "uniforms"


# --------------------------------------------------------------------------
# Leaves
# --------------------------------------------------------------------------
def _to_numpy(leaf) -> np.ndarray:
    """Host array of one leaf; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _restore_tensor(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """Copy ``arr`` into ``ref`` in place (shape checked; bf16 from its
    uint16 bits, any other dtype by a value cast)."""
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"shape {arr.shape} != {tuple(ref.shape)}")
    arr = np.array(arr, order="C")          # keeps a 0-d array 0-d
    if ref.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        src = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        src = torch.from_numpy(arr)
    with torch.no_grad():
        ref.copy_(src)
    return ref


def _host_value(arr: np.ndarray, ref):
    """A host scalar of the reference's type (int for numpy ints)."""
    if arr.shape != ():
        raise ValueError(f"shape {arr.shape} != ()")
    if isinstance(ref, (bool, np.bool_)):
        return bool(arr.item())
    if isinstance(ref, (int, np.integer)):
        return int(arr.item())
    return float(arr.item())


def _storage_children(x):
    """The tensors a storage leaf keeps, in the reference's flattening
    order (its ``FlattenedIndexKey`` children), or None."""
    if isinstance(x, QuantLeaf):            # and Quant4Leaf
        return [x.q, x.scale]
    if isinstance(x, CastLeaf):
        return [x.v]
    if isinstance(x, QuantAccum):
        return [x.q, x.scale]
    return None


def _is_host(x) -> bool:
    return isinstance(x, (bool, int, float, np.generic))


# --------------------------------------------------------------------------
# Trees
# --------------------------------------------------------------------------
def _items(tree):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, torch.nn.Module):
        return [(n.replace(".", _SEP), p) for n, p in sorted(
            tree.named_parameters(), key=lambda kv: path_key(kv[0]))]
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    kids = _storage_children(tree)
    if kids is not None:
        return [(str(i), v) for i, v in enumerate(kids)]
    return None


def _join(prefix: str, key: str) -> str:
    return f"{prefix}{_SEP}{key}" if prefix else key


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    items = _items(tree)
    if items is None:
        return {prefix: _to_numpy(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(_flatten(v, _join(prefix, k)))
    return flat


def _unflatten(flat: Dict[str, np.ndarray], ref, prefix: str = ""):
    """``ref``'s structure with every leaf restored from ``flat``: its
    tensors written in place, host scalars and numpy arrays rebuilt."""
    items = _items(ref)
    if items is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing {prefix}")
        try:
            if isinstance(ref, torch.Tensor):
                return _restore_tensor(flat[prefix], ref)
            if _is_host(ref):
                return _host_value(flat[prefix], ref)
            arr = flat[prefix]
            if tuple(arr.shape) != tuple(np.shape(ref)):
                raise ValueError(f"shape {arr.shape} != {np.shape(ref)}")
            return np.asarray(arr, dtype=np.asarray(ref).dtype)
        except ValueError as e:
            raise ValueError(f"{prefix}: {e}") from None
    out = [(k, _unflatten(flat, v, _join(prefix, k))) for k, v in items]
    if isinstance(ref, dict):
        return dict(out)
    if isinstance(ref, tuple) and hasattr(ref, "_fields"):
        return type(ref)(*[v for _, v in out])
    if isinstance(ref, (list, tuple)):
        return type(ref)(v for _, v in out)
    return ref      # a module or a storage leaf: written in place


def save(path: str, tree: Any, party: Optional[str] = None) -> None:
    """``tree`` (nested dicts / lists / tuples of tensors, storage leaves,
    modules and host scalars) to ``path``; ``party`` keeps that subtree
    only (a party persists its own tower)."""
    if party is not None:
        tree = {party: tree[party]} if isinstance(tree, dict) else tree
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def _load(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def restore(path: str, reference: Any) -> Any:
    """Load into the structure of ``reference``: its tensors are written
    in place (shape checked), its host scalars rebuilt."""
    return _unflatten(_load(path), reference)


# --------------------------------------------------------------------------
# The scheduler's round state
# --------------------------------------------------------------------------
def _param_paths(module) -> list:
    """A party's parameter paths in the reference's leaf order."""
    return [n.replace(".", _SEP) for n, _ in sorted(
        module.named_parameters(), key=lambda kv: path_key(kv[0]))]


def _mirror(paths, leaves) -> Dict[str, Any]:
    """A leaf-order list as the reference's tree that mirrors the
    parameters (keys are the parameter paths)."""
    leaves = list(leaves)
    if len(leaves) != len(paths):
        raise ValueError(f"{len(leaves)} leaves for {len(paths)} "
                         f"parameters")
    return dict(zip(paths, leaves))


def _opt_view(opt_state: Dict[str, Any], paths) -> Dict[str, Any]:
    """An optimizer state in the reference's layout: a list of plain
    tensors (fp32 / bf16 AdaGrad, SGD's momentum, Adam's moments)
    mirrors the parameters, a list of per-leaf entries (``QuantAccum``,
    SM3's dicts) is the reference's tuple, and the int8 state's host
    step counter is the reference's int32."""
    out = {}
    for k, v in opt_state.items():
        if isinstance(v, list) and all(isinstance(x, torch.Tensor)
                                       for x in v):
            out[k] = _mirror(paths, v)
        elif isinstance(v, list):
            out[k] = tuple(v)
        elif isinstance(v, int):
            out[k] = np.int32(v)
        else:
            out[k] = v
    return out


def _state_view(rs) -> Dict[str, Any]:
    """The round state's tree in the reference's layout (its
    ``RoundState.as_state()``); the host round and the uniform source
    are not in it."""
    pa = [_param_paths(m) for m in rs.params["a"]]
    pb = _param_paths(rs.params["b"])
    return {"params": rs.params,
            "opt": {"a": [_opt_view(o, p) for o, p in
                          zip(rs.opt["a"], pa)],
                    "b": _opt_view(rs.opt["b"], pb)},
            "ws": rs.ws, "steps": rs.steps, "comm_rounds": rs.comm_rounds,
            "transport": rs.transport}


def _pending_view(rs) -> tuple:
    pa = [_param_paths(m) for m in rs.params["a"]]
    pb = _param_paths(rs.params["b"])
    out = []
    for p in rs.pending:
        fresh = dict(p.fresh)
        fresh["g_as"] = [_mirror(paths, g)
                         for paths, g in zip(pa, fresh["g_as"])]
        fresh["g_b"] = _mirror(pb, fresh["g_b"])
        out.append({"fresh": fresh, "batches_a": list(p.batches_a),
                    "batch_b": p.batch_b, "batch_idx": np.int64(p.batch_idx),
                    "dispatched_at": np.int32(p.dispatched_at)})
    return tuple(out)


def save_round_state(path: str, rs, extra: Any = None) -> None:
    """Persist a whole ``engine.RoundState``: parameters, optimizer,
    workset rings, transport residuals and the in-flight queue (each
    ``PendingExchange`` with its batches and ``dispatched_at``), the
    uniform generator's position when the source has one, and an optional
    ``extra`` tree (``ChaosEngine.host_state()``)."""
    tree = {"state": _state_view(rs), "pending": _pending_view(rs)}
    if extra is not None:
        tree["extra"] = extra
    flat = _flatten(tree)
    flat[_PENDING_META] = np.asarray(len(rs.pending))
    if hasattr(rs.uniforms, "get_state"):
        flat[_UNIFORMS] = rs.uniforms.get_state().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def peek_pending_len(path: str) -> int:
    """The in-flight queue depth a ``save_round_state`` file records:
    read it first, fabricate a reference with that many dispatches, then
    :func:`restore_round_state`."""
    with np.load(path) as data:
        if _PENDING_META not in data.files:
            raise KeyError(
                f"{path} is not a round-state checkpoint (missing "
                f"{_PENDING_META!r})")
        return int(data[_PENDING_META])


def restore_round_state(path: str, reference,
                        extra_reference: Any = None) -> Tuple[Any, Any]:
    """Restore a ``save_round_state`` file (the port's or the
    reference's) into ``reference``, a ``RoundState`` with the same
    in-flight queue depth and slot structure: after a restart, drive a
    fresh engine that many dispatches (any batches: every value is
    overwritten).  The reference's tensors are written in place; its
    opt states' host counters are set; the uniform source's position is
    restored (see the module docstring).  -> ``(round_state, extra)``,
    ``extra`` None without ``extra_reference``."""
    flat = _load(path)
    if _PENDING_META not in flat:
        raise KeyError(
            f"{path} is not a round-state checkpoint (missing "
            f"{_PENDING_META!r}): use restore() for plain trees")
    n = int(flat.pop(_PENDING_META))
    if n != len(reference.pending):
        raise ValueError(
            f"checkpoint holds {n} in-flight exchange(s) but the "
            f"reference RoundState holds {len(reference.pending)}: "
            f"rebuild the reference with {n} dispatch(es) before "
            f"restoring")
    gen = flat.pop(_UNIFORMS, None)
    if hasattr(reference.uniforms, "set_state") and gen is None:
        raise ValueError(
            f"{path} holds no uniform generator state (a file of the "
            f"reference package, or one saved without it), and the "
            f"reference round state draws from a generator: a resume "
            f"would draw other uniforms.  Restore into a round state whose "
            f"uniform source is a function of the tag alone")
    tree = {"state": _state_view(reference),
            "pending": _pending_view(reference)}
    if extra_reference is not None:
        tree["extra"] = extra_reference
    restored = _unflatten(flat, tree)
    for o, ro in zip(reference.opt["a"] + [reference.opt["b"]],
                     restored["state"]["opt"]["a"]
                     + [restored["state"]["opt"]["b"]]):
        for k, v in o.items():
            if isinstance(v, int):
                o[k] = ro[k]
    if gen is not None and hasattr(reference.uniforms, "set_state"):
        reference.uniforms.set_state(torch.from_numpy(gen))
    pending = tuple(
        p._replace(batch_idx=rp["batch_idx"],
                   dispatched_at=rp["dispatched_at"])
        for p, rp in zip(reference.pending, restored["pending"]))
    rs = reference._replace(round=int(flat["state/comm_rounds"]),
                            pending=pending)
    return rs, restored.get("extra")
