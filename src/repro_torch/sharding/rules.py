"""Sharding rules: parameter-name-driven specs with divisibility guards.

Port of ``repro/sharding/rules.py``.  Tensor-parallel (Megatron-style)
layout over the ``model`` mesh axis, data-parallel batches over ``data``
(and ``pod`` when the multi-pod mesh is active, except in the
party-to-pod CELU protocol, where ``pod`` carries the two parties; see
``core/pod_protocol.py``).

Every rule checks divisibility against the mesh axis size and replicates
otherwise, so every (arch × mesh) pair has a layout without per-arch
cases.  The name-based rules (leaf name -> the dim that shards over
``model``):

  embed        (V, d)        -> V          head       (d, V)   -> V
  wq           (d, H, hd)    -> H          wo   (H, hd, d)     -> H
  wk/wv        (d, Kv, hd)   -> Kv         mlp wg/wu  (d, f)   -> f
  mlp wd       (f, d)        -> f          moe  (E, d, f)      -> f ("tp") or E ("ep")
  mamba in_proj(d, 2di)      -> 2di        mamba out_proj (di, d) -> di
  xlstm w_x    (d, 4d)       -> 4d         norms/bias/scalars  -> replicate

A spec is plain data: a tuple with one entry a dim, each an axis name, a
tuple of axis names or None; ``()`` replicates.  The rules take trees of
nested dicts and lists of tensors (the port's parameter trees, as the
reference's pytrees) or flat dicts of dotted names (``named_parameters``);
a leaf's name is its last key that is not all digits, and a list index
anywhere in its path (an all-digit component, as ``bridge.path_key``
reads it) marks a scanned stage stack whose leading layer axis shifts
every dim by one.  Store objects (the workset's ``CastLeaf`` /
``QuantLeaf`` / ``Quant4Leaf``, the optimizer's ``QuantAccum``) are walked
through their tensor slots; leaves that are not tensors (host ints) get
no spec.  The mesh is given as its axis sizes (a dict) or as a
``DeviceMesh``; :func:`make_sharding` turns specs into DTensor
placements.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

Spec = Tuple[Any, ...]


# --------------------------------------------------------------------------
# Mesh sizes and tree walking
# --------------------------------------------------------------------------
def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a dict, a ``DeviceMesh`` or an object with a
    ``shape`` mapping (the reference's meshes)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(sizes: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(math.prod(sizes.get(a, 1) for a in axis))
    return int(sizes.get(axis, 1))


def _slots(obj) -> Tuple[str, ...]:
    out = []
    for cls in reversed(type(obj).__mro__):
        out.extend(getattr(cls, "__slots__", ()))
    return tuple(out)


def _is_store(obj) -> bool:
    return bool(_slots(obj)) and not isinstance(obj, torch.Tensor)


def _components(key) -> Tuple[str, ...]:
    return tuple(str(key).split("."))


def _key_order(key):
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in _components(key))


def walk(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                          torch.Tensor]]:
    """(path components, tensor) over ``tree``'s tensor leaves, in the
    reference's flattening order (dict keys sorted, list entries by
    index, store slots in order)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=_key_order):
            yield from walk(tree[k], path + _components(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (str(i),))
    elif _is_store(tree):
        for name in _slots(tree):
            v = getattr(tree, name)
            if isinstance(v, torch.Tensor):
                yield path, v


def map_leaves(fn, tree, path: Tuple[str, ...] = ()):
    """``tree`` with each tensor leaf replaced by ``fn(path, leaf)``; a
    store becomes a dict of its tensor slots, a non-tensor leaf None."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + _components(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    if _is_store(tree):
        return {n: fn(path, getattr(tree, n)) for n in _slots(tree)
                if isinstance(getattr(tree, n), torch.Tensor)}
    return None


def flat_specs(spec_tree):
    """The specs of a spec tree in :func:`walk`'s order."""
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree, key=_key_order)
                for s in flat_specs(spec_tree[k])]
    if isinstance(spec_tree, list):
        return [s for v in spec_tree for s in flat_specs(v)]
    return [] if spec_tree is None else [spec_tree]


def _leaf_name(path) -> str:
    for p in reversed(path):
        if not p.isdigit():
            return p
    return ""


def _is_scanned(path) -> bool:
    return any(p.isdigit() for p in path)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
def _param_spec(path, leaf, sizes, model_axis: str, moe_sharding: str,
                fsdp_axis: Optional[str]) -> Spec:
    name = _leaf_name(path)
    msize = _axis_size(sizes, model_axis)
    fsize = _axis_size(sizes, fsdp_axis) if fsdp_axis else 1
    shape = tuple(leaf.shape)
    nd = len(shape)
    off = 1 if _is_scanned(path) else 0

    def _add_fsdp(parts: list) -> list:
        """ZeRO-3-style second axis: shard the largest remaining divisible
        dim over the data axis (ties to the first dim)."""
        if not fsdp_axis or fsize == 1 or leaf.numel() < 1 << 20:
            return parts
        cands = sorted(
            (i for i in range(off, nd)
             if parts[i] is None and shape[i] % fsize == 0
             and shape[i] >= fsize),
            key=lambda i: -shape[i])
        if cands:
            parts[cands[0]] = fsdp_axis
        return parts

    def _model_dim(*dims: int) -> Optional[int]:
        """First candidate dim divisible by the model-axis size."""
        for dim in dims:
            if dim < nd and msize > 1 and shape[dim] % msize == 0 \
                    and shape[dim] >= msize:
                return dim
        return None

    if name == "embed":
        cand = (off + 0,)
    elif name == "head":
        cand = (off + 1,)
    elif name == "wq":
        # heads only: sharding head_dim would make every score a partial
        # sum reduced over `model`; a head count that does not divide
        # replicates, as Megatron does
        cand = (off + 1,)
    elif name in ("wk", "wv"):
        cand = (off + 1,)
    elif name == "wo":
        cand = (off + 0,)
    elif name in ("wg", "wu"):
        if nd - off == 3:                 # MoE (E, d, f)
            cand = (off + 0,) if moe_sharding == "ep" else (off + 2,)
        else:
            cand = (off + 1,)
    elif name == "wd":
        if nd - off == 3:                 # MoE (E, f, d)
            cand = (off + 0,) if moe_sharding == "ep" else (off + 1,)
        else:
            cand = (off + 0,)
    elif name in ("in_proj", "w_x"):
        cand = (off + 1,)
    elif name == "out_proj":
        cand = (off + 0,)
    elif name in ("proj", "proj1", "proj2", "fuse_proj"):
        cand = (off + 1,)
    else:
        # norms, biases, routers, conv, ssm / xlstm small tensors, scalars
        return ()

    parts: list = [None] * nd
    dim = _model_dim(*cand)
    if dim is not None:
        parts[dim] = model_axis
    return tuple(_add_fsdp(parts))


def params_pspecs(params, mesh, *, model_axis: str = "model",
                  moe_sharding: str = "tp", fsdp_axis: Optional[str] = None):
    """Spec tree matching ``params``.  ``fsdp_axis``: also shard the big
    parameters over the data axis (ZeRO-3-style), which the >= 30B archs
    need to fit a device's memory."""
    sizes = mesh_sizes(mesh)
    return map_leaves(lambda p, leaf: _param_spec(
        p, leaf, sizes, model_axis, moe_sharding, fsdp_axis), params)


# --------------------------------------------------------------------------
# Batches, worksets, optimizer state, caches
# --------------------------------------------------------------------------
def _data_axis(data_axes):
    return tuple(data_axes) if len(data_axes) > 1 else data_axes[0]


def batch_pspec(shape, mesh, *, data_axes=("data",),
                model_axis: str = "model") -> Spec:
    """A batch leaf: the batch dim over the data axes if divisible, else
    (decode with a tiny batch) the next dim, the sequence / capacity dim,
    else replicate."""
    dsize = _axis_size(mesh_sizes(mesh), tuple(data_axes))
    ax = _data_axis(data_axes)
    shape = tuple(shape)
    nd = len(shape)
    if nd >= 1 and shape[0] % dsize == 0 and shape[0] >= dsize:
        return (ax,) + (None,) * (nd - 1)
    if nd >= 2 and shape[1] % dsize == 0 and shape[1] >= dsize:
        return (None, ax) + (None,) * (nd - 2)
    return ()


def tree_pspecs(tree, mesh, *, data_axes=("data",)):
    """Batch-like trees (batches, caches, workset buffers)."""
    return map_leaves(lambda p, leaf: batch_pspec(
        leaf.shape, mesh, data_axes=data_axes), tree)


def workset_pspecs(table, mesh, *, data_axes=("data",)):
    """Ring tables (``core.workset``): every buffer leaf leads with the W
    slot axis; shard the per-instance batch dim (dim 1) over data, never
    the ring axis (a draw reads ONE slot).  ``QuantLeaf`` /
    ``Quant4Leaf`` codes (W, B, F or packed nibbles) and their (W, B)
    scales shard B the same way; clock vectors and scalars replicate."""
    dsize = _axis_size(mesh_sizes(mesh), tuple(data_axes))
    ax = _data_axis(data_axes)

    def spec(path, leaf) -> Spec:
        s = tuple(leaf.shape)
        if len(s) >= 2 and s[1] % dsize == 0 and s[1] >= dsize:
            return (None, ax) + (None,) * (len(s) - 2)
        return ()
    return map_leaves(spec, table)


def opt_state_pspecs(opt_state, mesh, *, data_axes=("data",)):
    """ZeRO-1-style optimizer state: a ``QuantAccum``'s int8 codes (R, C)
    and (R, 1) scales shard the padded row dim over data (R is a multiple
    of the fused kernel's ROWS tiling, so every shard keeps whole requant
    rows); fp32 / bf16 accumulators shard their leading dim when
    divisible; SM3's factored vectors, counters and other 1-D or scalar
    state replicate."""
    dsize = _axis_size(mesh_sizes(mesh), tuple(data_axes))
    ax = _data_axis(data_axes)

    def spec(path, leaf) -> Spec:
        s = tuple(leaf.shape)
        if len(s) >= 2 and s[0] % dsize == 0 and s[0] >= dsize:
            return (ax,) + (None,) * (len(s) - 1)
        return ()
    return map_leaves(spec, opt_state)


def _cache_spec(path, leaf, sizes, data_axes, model_axis: str) -> Spec:
    """KV / state cache leaves: stacked (L, B, cap, Kv, hd) etc.  Batch
    over data if divisible; Kv heads over model if divisible; for B = 1
    long-context decode, the capacity dim over data instead."""
    name = _leaf_name(path)
    dsize = _axis_size(sizes, tuple(data_axes))
    msize = _axis_size(sizes, model_axis)
    ax = _data_axis(data_axes)
    s = tuple(leaf.shape)
    nd = len(s)
    parts: list = [None] * nd
    if name in ("k", "v"):          # (L, B, cap, Kv, hd)
        if nd >= 5:
            if s[1] % dsize == 0:
                parts[1] = ax
            elif s[2] % dsize == 0:
                parts[2] = ax
            if s[3] % msize == 0:
                parts[3] = model_axis
            elif parts[2] is None and s[2] % msize == 0:
                # GQA kv heads that do not divide: shard the cache's
                # sequence dim over `model` (flash-decoding style)
                parts[2] = model_axis
    elif name in ("h", "C", "n", "c", "m", "conv"):   # ssm / xlstm states
        if nd >= 2 and s[1] % dsize == 0:
            parts[1] = ax
    return tuple(parts)


def cache_pspecs(cache, mesh, *, data_axes=("data",),
                 model_axis: str = "model"):
    sizes = mesh_sizes(mesh)
    return map_leaves(lambda p, leaf: _cache_spec(
        p, leaf, sizes, data_axes, model_axis), cache)


# --------------------------------------------------------------------------
# DTensor placements
# --------------------------------------------------------------------------
def placements(mesh, spec: Spec):
    """One spec -> DTensor placements over ``mesh`` (a ``DeviceMesh``): a
    mesh dim that shards tensor dim d is ``Shard(d)``, every other mesh
    dim ``Replicate()``.  A tuple of axes on one tensor dim shards that
    dim over each of those mesh dims, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def make_sharding(mesh, spec_tree):
    """A spec tree -> the same tree of DTensor placements over ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: make_sharding(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [make_sharding(mesh, v) for v in spec_tree]
    return None if spec_tree is None else placements(mesh, spec_tree)
