"""The workset table: a device-resident ring buffer of cached statistics.

Port of ``repro/core/workset.py`` (paper §3.1).  The table caches
``⟨i, Z^(i), ∇Z^(i), j⟩`` entries with two clocks per entry — the
insertion timestamp ``i`` (the communication round that produced it) and
the use count ``j``.  Eviction rules:

  * capacity: the ring overwrites slot ``i mod W`` and the validity
    predicate ``insert_time > time - W`` retires the rest;
  * exhaustion: entries that reach ``R`` uses are dead.

Every clock (``insert_time``, ``use_count``, ``batch_idx``, ``cursor``,
``time``) is an int32 tensor on the table's device, and a draw returns the
slot and its valid flag as device tensors too: a local update never waits
for the host.  Unlike the reference, whose arrays are immutable, the port
updates the table IN PLACE (``index_copy_`` / ``index_add_`` at a device
index) and returns the same dict.

Round-robin sampling (paper §3.2): a cursor walks slots in insertion
order, one slot per draw, bubbles included.  Consecutive sampling (FedBCD)
always returns the most recently inserted slot.  Uniform sampling draws
each slot independently over the alive ones (a Gumbel-max draw from a
uniform source, as ``jax.random.categorical`` draws it).

At-rest precision (``workset_init(..., cache_dtype=...)``) of the cut
statistics (the ``z`` / ``dz`` entry keys, ``QUANT_KEYS``):

  * ``"float32"`` — leaves stored as they are (the goldens pin this);
  * ``"bfloat16"`` — :class:`CastLeaf`, decoded back to the leaf's dtype;
  * ``"int8"`` — :class:`QuantLeaf`: int8 codes of the leaf flattened to
    (B, F) rows and one fp32 absmax scale per row, quantised on insert
    with stochastic rounding through K3 (levels 127);
  * ``"int4"`` — :class:`Quant4Leaf`: the same at levels 7, two codes a
    byte (element 2j in the low nibble, each stored as code + 8); an odd
    F pads one zero code before packing.

The row is the scale's tile because Algorithm 2's cosine is a row
reduction: the fused sample kernels (K4, K5) dequantise a row in
registers.  Cache bytes per party (z + dz, scales included):
``2·W·B·F·4`` (fp32), ``2·W·B·(F + 4)`` (int8),
``2·W·B·(ceil(F/2) + 4)`` (int4).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..kernels import ops as kops
# pack_nibbles / unpack_nibbles: the int4 layout, named here as in the
# reference's workset module
from ..kernels.fused_sample import dequant_rows, pack_nibbles, unpack_nibbles

INT_MIN = -(2 ** 30)

# Entry keys holding the exchanged cut statistics — the subtrees a storage
# codec would quantize.  Everything else (own features, labels) is cached
# verbatim.
QUANT_KEYS = ("z", "dz")

CACHE_DTYPES = ("float32", "bfloat16", "int8", "int4")


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts / lists; ``rest``
    are trees of the same structure (indexed by ``tree``'s keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts / lists in the reference's flattening
    order (dict keys sorted): the reference numbers an entry's leaves this
    way when it folds the insert key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# Storage leaves (table level: a leading W axis; entry level: one slot)
# --------------------------------------------------------------------------
def _row_shape(shape) -> Tuple[int, int]:
    """Leaf shape (B, ...) -> (rows B, flattened row length F)."""
    B = int(shape[0])
    F = 1
    for s in shape[1:]:
        F *= int(s)
    return B, max(F, 1)


def _pad_even(F: int) -> int:
    return F + (F & 1)


class CastLeaf:
    """bf16 at rest: ``v`` holds the leaf cast to bf16; ``dtype`` is the
    original dtype that decode restores."""

    __slots__ = ("v", "dtype")

    def __init__(self, v, dtype):
        self.v = v
        self.dtype = dtype

    def tensors(self):
        return [self.v]

    def take(self, idx):
        return CastLeaf(self.v.index_select(0, idx)[0], self.dtype)

    def decode(self):
        return self.v.to(self.dtype)


class QuantLeaf:
    """int8 at rest: ``q`` holds int8 codes of the leaf flattened to (B, F)
    rows (table level (W, B, F)), ``scale`` one fp32 absmax scale per row
    ((B,) / (W, B)); ``shape`` / ``dtype`` are the entry leaf's."""

    __slots__ = ("q", "scale", "shape", "dtype")
    bits = 8

    def __init__(self, q, scale, shape, dtype):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)
        self.dtype = dtype

    def tensors(self):
        return [self.q, self.scale]

    def take(self, idx):
        return type(self)(self.q.index_select(0, idx)[0],
                          self.scale.index_select(0, idx)[0], self.shape,
                          self.dtype)

    def decode(self):
        """Entry level (q, scale (B,)) -> the original leaf (the pad
        column of an odd int4 row sliced off)."""
        _, F = _row_shape(self.shape)
        x = dequant_rows(self.q, self.scale, self.bits)[:, :F]
        return x.reshape(self.shape).to(self.dtype)


class Quant4Leaf(QuantLeaf):
    """int4 at rest: ``q`` holds packed uint8, two codes (levels ±7) a
    byte, of the rows padded to even F (entry level (B, ceil(F/2)), table
    level (W, B, ceil(F/2))); ``scale`` as :class:`QuantLeaf`.  The pad
    nibble stores code 0, so it decodes to an exact zero."""

    __slots__ = ()
    bits = 4


STORES = (CastLeaf, QuantLeaf)


def is_store(x) -> bool:
    return isinstance(x, STORES)


def _quantize_rows(key, x2d, levels: int = 127):
    """(B, F) fp32 -> (codes int8 (B, F), fp32 row scales (B,)) through K3,
    with uniforms drawn from ``key``."""
    u = key.uniform(x2d.shape).to(x2d.device)
    return kops.quantize_stochastic(x2d, u, levels)


def _empty_store(W: int, a, cache_dtype: str):
    """Table-level storage for one quantisable leaf shaped like ``a``."""
    if cache_dtype == "float32":
        return torch.zeros((W,) + tuple(a.shape), dtype=a.dtype,
                           device=a.device)
    if cache_dtype == "bfloat16":
        return CastLeaf(torch.zeros((W,) + tuple(a.shape),
                                    dtype=torch.bfloat16, device=a.device),
                        a.dtype)
    B, F = _row_shape(a.shape)
    scale = torch.zeros((W, B), dtype=torch.float32, device=a.device)
    if cache_dtype == "int4":
        # 0x88 is code 0 in both nibbles: the empty table unpacks to zeros
        return Quant4Leaf(torch.full((W, B, _pad_even(F) // 2), 0x88,
                                     dtype=torch.uint8, device=a.device),
                          scale, a.shape, a.dtype)
    return QuantLeaf(torch.zeros((W, B, F), dtype=torch.int8,
                                 device=a.device), scale, a.shape, a.dtype)


def _encode_leaf(store, x, key):
    """One entry leaf -> the storage form of the table's leaf (entry
    level).  ``key`` draws the rounding uniforms of a quantised store."""
    if isinstance(store, QuantLeaf):
        B, F = _row_shape(x.shape)
        q, scale = _quantize_rows(key, x.reshape(B, F).float().contiguous(),
                                  127 if store.bits == 8 else 7)
        if store.bits == 4:
            if F & 1:                   # pad one zero code before packing
                q = torch.cat([q, q.new_zeros((B, 1))], dim=1)
            q = pack_nibbles(q)
        return type(store)(q, scale, store.shape, store.dtype)
    if isinstance(store, CastLeaf):
        return CastLeaf(x.to(torch.bfloat16), store.dtype)
    return x.to(store.dtype)


def _decode_leaf(leaf):
    return leaf.decode() if is_store(leaf) else leaf


def decode_entry(entry):
    """Storage-form entry -> full-precision entry (identity for fp32)."""
    return tree_map(_decode_leaf, entry)


def _leaf_tensors(x):
    return x.tensors() if is_store(x) else [x]


def workset_nbytes(ws: Dict[str, Any], keys=None) -> int:
    """Device bytes held by the table's ring buffer: codes, scales and
    raw leaves (excludes the O(W) clock vectors).  ``keys`` restricts the
    count to those entry keys, e.g. ``QUANT_KEYS``."""
    buf = ws["buf"] if keys is None else \
        {k: v for k, v in ws["buf"].items() if k in keys}
    return sum(t.numel() * t.element_size()
               for leaf in tree_leaves(buf) for t in _leaf_tensors(leaf))


def sample_hbm_bytes(entry_example: Dict[str, Any],
                     cache_dtype: str = "float32",
                     fused: bool = True, party: str = "a") -> int:
    """Roofline counter: device-memory bytes moved by ONE local-update
    sample over the cut statistics (gather from the ring, dequantise,
    row cosine against the ad-hoc statistics, cotangent scale), each
    operand read once and each result written once.  Excludes the
    party model's forward and backward.

    ``party="a"``: fused, one pass reads the stored z / dz and the ad-hoc
    rows and writes w + cot; unfused, the gather writes an fp32 copy of
    z and dz that the gate re-reads with the ad-hoc rows.  ``party="b"``:
    the loss consumes the decoded Z list, so its fp32 copy is always
    written; the fused path weighs the stored dz ring against the ad-hoc
    dz (the reference counts a ride-along cotangent as well)."""
    if cache_dtype not in CACHE_DTYPES:
        raise ValueError(f"cache_dtype must be one of {CACHE_DTYPES}, "
                         f"got {cache_dtype!r}")
    if party not in ("a", "b"):
        raise ValueError(f"party must be 'a' or 'b', got {party!r}")
    z_leaves = tree_leaves(entry_example.get("z", {}))
    dz_leaves = tree_leaves(entry_example.get("dz", {}))

    def at_rest(B: int, F: int) -> int:
        if cache_dtype == "int4":            # packed nibbles + row scale
            return B * (_pad_even(F) // 2) + B * 4
        itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[cache_dtype]
        return B * F * itemsize + (B * 4 if cache_dtype == "int8" else 0)

    total = 0
    for a in z_leaves + dz_leaves:           # the ring reads, at rest
        total += at_rest(*_row_shape(a.shape))
    if party == "a":
        for a in z_leaves:
            B, F = _row_shape(a.shape)
            f32 = B * F * 4
            total += (f32 + f32 + B * 4 if fused
                      else 2 * f32 + 3 * f32 + f32 + B * 4)
        return total
    for a in z_leaves:                       # decoded Z the loss consumes
        B, F = _row_shape(a.shape)
        total += B * F * 4
    for a in dz_leaves:
        B, F = _row_shape(a.shape)
        f32 = B * F * 4
        total += f32 + f32 + B * 4 if fused else f32 + 2 * f32 + B * 4
    return total


# --------------------------------------------------------------------------
# Table ops
# --------------------------------------------------------------------------
def workset_init(W: int, entry_example: Dict[str, Any], *,
                 cache_dtype: str = "float32") -> Dict[str, Any]:
    """Create an empty table on the device of ``entry_example``'s leaves
    (a pytree with the per-batch shapes); the table stacks a leading W
    axis.  ``cache_dtype`` selects the at-rest storage of the ``z`` /
    ``dz`` subtrees; everything else is cached as it is."""
    if cache_dtype not in CACHE_DTYPES:
        raise ValueError(f"cache_dtype must be one of {CACHE_DTYPES}, "
                         f"got {cache_dtype!r}")
    buf = {}
    for k, sub in entry_example.items():
        dt = cache_dtype if k in QUANT_KEYS else "float32"
        buf[k] = tree_map(lambda a: _empty_store(W, a, dt), sub)
    dev = tree_leaves(entry_example)[0].device

    def i32(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=dev)
    return {
        "buf": buf,
        "insert_time": i32((W,), INT_MIN),
        "use_count": i32((W,), 0),
        "batch_idx": i32((W,), -1),
        "cursor": i32((), 0),
        "time": i32((), 0),      # communication rounds so far
    }


def _index(slot):
    return slot.reshape(1).long()


def _store_(store, idx, value) -> None:
    """Write the entry-level ``value`` into ``store`` at ring slot
    ``idx`` (a (1,) long device tensor), in place."""
    for t, v in zip(_leaf_tensors(store), _leaf_tensors(value)):
        t.index_copy_(0, idx, v.detach().unsqueeze(0).to(t.dtype))


def workset_insert(ws: Dict[str, Any], entry: Dict[str, Any],
                   batch_idx: int, *, key=None) -> Dict[str, Any]:
    """Insert a fresh entry at ring slot ``time mod W`` and bump the clock,
    in place.  The entry is encoded into the table's storage form first
    (stochastic rounding through K3, a bf16 cast, or as it is).  ``key``
    (a :class:`~repro_torch.core.uniforms.UniformKey`) gives the rounding
    uniforms of a quantised table, folded by each leaf's index in
    :func:`tree_leaves` order; an fp32 or bf16 table needs none.  Where
    the reference derives the key from the table clock (an insert given
    none), the caller passes ``uniforms.clock_key(source, time)`` with its
    host copy of ``ws["time"]``, so no insert reads the clock back from
    the device."""
    W = ws["insert_time"].shape[0]
    t = ws["time"]
    idx = _index(torch.remainder(t, W))
    stores = tree_leaves(ws["buf"])
    values = tree_leaves(entry)
    for i, (store, value) in enumerate(zip(stores, values)):
        if isinstance(store, QuantLeaf) and key is None:
            raise ValueError("a quantised workset table needs a key for "
                             "its rounding uniforms")
        _store_(store, idx, _encode_leaf(
            store, value, None if key is None else key.fold(i)))
    ws["insert_time"].index_copy_(0, idx, t.reshape(1))
    ws["use_count"].index_fill_(0, idx, 0)
    ws["batch_idx"].index_fill_(0, idx, int(batch_idx))
    ws["time"].add_(1)
    return ws


def _valid_mask(ws: Dict[str, Any], R: int,
                pipeline_staleness=0) -> torch.Tensor:
    """(W,) bool — alive entries: inserted, not expired, not exhausted.
    ``pipeline_staleness`` retires the oldest ring slots early."""
    t = ws["time"]
    W = ws["insert_time"].shape[0]
    alive = ws["insert_time"] >= t - W + pipeline_staleness
    alive &= ws["insert_time"] > INT_MIN    # ever inserted
    alive &= ws["use_count"] < R            # not exhausted
    return alive


def _categorical(f, alive) -> torch.Tensor:
    """``jax.random.categorical(key, where(alive, 0, -inf))`` from the
    key's [0, 1) uniforms ``f`` (W,): the Gumbel-max draw of JAX's "low"
    mode, ``argmax(-log(-log(u)) + logits)`` with ``u = max(tiny, f · (1 -
    tiny) + tiny)`` (``1 - tiny`` rounds to 1 in float32).  With no slot
    alive the logits are zeros, as in the reference (the draw is then a
    bubble).  -> 0-d int32 on the device, no host sync."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp_min(f.to(alive.device) + tiny, tiny)
    logits = torch.where(alive, 0.0, float("-inf"))
    logits = torch.where(alive.any(), logits, 0.0)
    return torch.argmax(-torch.log(-torch.log(u)) + logits).to(torch.int32)


def workset_draw(ws: Dict[str, Any], R: int, strategy: str, *,
                 rng=None, pipeline_staleness=0
                 ) -> Tuple[Dict[str, Any], torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Pick one slot for a local update without materialising the entry.

    strategy: "round_robin" — the cursor's slot, then the cursor advances
    by one even on a bubble; "consecutive" — always the freshest slot;
    "uniform" — an independent draw over the alive slots, from ``rng`` (a
    :class:`~repro_torch.core.uniforms.UniformKey`).  Returns (ws, slot,
    batch_idx, valid), all device tensors: ``slot`` and ``batch_idx`` 0-d
    int32, ``valid`` 0-d bool (False -> the caller masks the update into a
    no-op).  The table's use count (and the round-robin cursor) are
    updated in place; the other strategies leave the cursor where it is.
    ``pipeline_staleness`` is a host int."""
    W = ws["insert_time"].shape[0]
    alive = _valid_mask(ws, R, pipeline_staleness)
    if strategy == "consecutive":
        slot = torch.remainder(ws["time"] - 1, W)
    elif strategy == "round_robin":
        slot = torch.remainder(ws["cursor"], W)
    elif strategy == "uniform":
        if rng is None:
            raise ValueError("uniform sampling needs an rng key")
        slot = _categorical(rng.uniform((W,)), alive)
    else:
        raise ValueError(strategy)
    idx = _index(slot)
    valid = alive.index_select(0, idx).reshape(())
    batch_idx = ws["batch_idx"].index_select(0, idx).reshape(())
    ws["use_count"].index_add_(0, idx, valid.to(torch.int32).reshape(1))
    if strategy == "round_robin":
        ws["cursor"].copy_(torch.remainder(slot + 1, W))
    return ws, slot, batch_idx, valid


def take_slot(buf, slot):
    """The storage-form entry at ``slot`` (gathered, not decoded)."""
    idx = _index(slot)
    return tree_map(lambda b: b.take(idx) if is_store(b)
                    else b.index_select(0, idx)[0], buf)


def workset_entry(ws: Dict[str, Any], slot) -> Dict[str, Any]:
    """Materialise (gather + decode) the entry at ``slot``."""
    return decode_entry(take_slot(ws["buf"], slot))


def workset_sample(ws: Dict[str, Any], R: int, strategy: str, *,
                   rng=None, pipeline_staleness=0):
    """:func:`workset_draw` plus the materialised entry.  Returns (ws,
    entry, batch_idx, valid)."""
    ws, slot, batch_idx, valid = workset_draw(
        ws, R, strategy, rng=rng, pipeline_staleness=pipeline_staleness)
    return ws, workset_entry(ws, slot), batch_idx, valid


def workset_stats(ws: Dict[str, Any], R: int,
                  pipeline_staleness=0) -> Dict[str, torch.Tensor]:
    """Table health counters (device tensors)."""
    alive = _valid_mask(ws, R, pipeline_staleness)
    return {
        "n_alive": alive.sum(),
        "total_uses": torch.where(alive, ws["use_count"], 0).sum(),
        "time": ws["time"],
    }
