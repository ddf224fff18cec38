"""The workset table: a device-resident ring buffer of cached statistics.

Port of the fp32 part of ``repro/core/workset.py`` (paper §3.1).  The
table caches ``⟨i, Z^(i), ∇Z^(i), j⟩`` entries with two clocks per entry —
the insertion timestamp ``i`` (the communication round that produced it)
and the use count ``j``.  Eviction rules:

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
always returns the most recently inserted slot.  ``uniform`` sampling and
the quantised at-rest caches (bf16, int8, int4) come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

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


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def workset_nbytes(ws: Dict[str, Any], keys=None) -> int:
    """Device bytes held by the table's ring buffer (excludes the O(W)
    clock vectors).  ``keys`` restricts the count to those entry keys."""
    buf = ws["buf"] if keys is None else \
        {k: v for k, v in ws["buf"].items() if k in keys}
    return sum(t.numel() * t.element_size() for t in tree_leaves(buf))


# --------------------------------------------------------------------------
# Table ops
# --------------------------------------------------------------------------
def workset_init(W: int, entry_example: Dict[str, Any], *,
                 cache_dtype: str = "float32") -> Dict[str, Any]:
    """Create an empty table on the device of ``entry_example``'s leaves
    (a pytree with the per-batch shapes); the table stacks a leading W
    axis."""
    if cache_dtype not in CACHE_DTYPES:
        raise ValueError(f"cache_dtype must be one of {CACHE_DTYPES}, "
                         f"got {cache_dtype!r}")
    if cache_dtype != "float32":
        raise NotImplementedError(
            f"cache_dtype={cache_dtype!r}: the quantised at-rest caches "
            f"come with slice 4 of the port (ROADMAP.md)")
    buf = tree_map(lambda a: torch.zeros((W,) + tuple(a.shape),
                                         dtype=a.dtype, device=a.device),
                   entry_example)
    dev = tree_leaves(buf)[0].device

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


def workset_insert(ws: Dict[str, Any], entry: Dict[str, Any],
                   batch_idx: int, *, rng=None) -> Dict[str, Any]:
    """Insert a fresh entry at ring slot ``time mod W`` and bump the clock,
    in place.  ``rng`` (the reference's rounding-noise key for quantised
    tables) is unused by the fp32 table."""
    W = ws["insert_time"].shape[0]
    t = ws["time"]
    idx = _index(torch.remainder(t, W))
    tree_map(lambda b, e: b.index_copy_(0, idx, e.detach().unsqueeze(0)
                                        .to(b.dtype)),
             ws["buf"], entry)
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


def workset_draw(ws: Dict[str, Any], R: int, strategy: str, *,
                 rng=None, pipeline_staleness=0
                 ) -> Tuple[Dict[str, Any], torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Pick one slot for a local update without materialising the entry.

    strategy: "round_robin" — the cursor's slot, then the cursor advances
    by one even on a bubble; "consecutive" — always the freshest slot.
    Returns (ws, slot, batch_idx, valid), all device tensors: ``slot`` and
    ``batch_idx`` 0-d int32, ``valid`` 0-d bool (False -> the caller
    masks the update into a no-op).  The table's use count (and cursor)
    are updated in place."""
    W = ws["insert_time"].shape[0]
    alive = _valid_mask(ws, R, pipeline_staleness)
    if strategy == "consecutive":
        slot = torch.remainder(ws["time"] - 1, W)
    elif strategy == "round_robin":
        slot = torch.remainder(ws["cursor"], W)
    elif strategy == "uniform":
        raise NotImplementedError(
            "uniform workset sampling comes with slice 2 of the port "
            "(ROADMAP.md)")
    else:
        raise ValueError(strategy)
    idx = _index(slot)
    valid = alive.index_select(0, idx).reshape(())
    batch_idx = ws["batch_idx"].index_select(0, idx).reshape(())
    ws["use_count"].index_add_(0, idx, valid.to(torch.int32).reshape(1))
    if strategy == "round_robin":
        ws["cursor"].copy_(torch.remainder(slot + 1, W))
    return ws, slot, batch_idx, valid


def workset_entry(ws: Dict[str, Any], slot) -> Dict[str, Any]:
    """Materialise (gather) the entry at ``slot``."""
    idx = _index(slot)
    return tree_map(lambda b: b.index_select(0, idx)[0], ws["buf"])


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
