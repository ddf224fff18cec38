"""Byte accounting for the transport boundary.

Port of ``repro/analysis/wire_audit.py``.  Three ledgers must agree, per
direction and per feature party:

  * **measured** — the bytes the wire PHYSICALLY carries: the payload
    tensors ``codec.encode`` produces for a CPU tensor of the message's
    shape (codes, scales, top-k indices, chained-stage payloads...),
    summed as ``numel * element_size``.  For exact codecs (and the plain
    SimWAN transport) the wire carries the value itself at the wire
    dtype.
  * **claimed** — what the codec's ``wire_bytes()`` promises.
  * **reported** — what the transport's ``uplink_bytes`` /
    ``downlink_bytes`` / ``round_bytes`` counters feed the WAN clock, the
    pipeline scheduler's occupancy model, and every results table.

A codec that under-counts (compresses less than it reports) silently
inflates every communication-efficiency claim downstream: the audit
turns that into a named failure.  The trace cross-check closes the other
hole: every boundary mark the graph contains must be one of the accounted
``K`` up + ``K`` down crossings per exchange dispatch, so a code path that
sends MORE than the ledger (an extra sync, a debug send) is also caught.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

from .report import Finding
from .taint import TraceAudit


class _ZeroKey:
    """A uniform key that draws zeros: the payload's SHAPE does not depend
    on the rounding uniforms."""

    def fold(self, i: int) -> "_ZeroKey":
        return self

    def uniform(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(int(s) for s in shape))


def payload_nbytes(codec, shape) -> int:
    """Wire bytes of one encoded message: ``codec.encode`` run on a CPU
    tensor of ``shape``, its payload's tensors summed."""
    from ..core.workset import tree_leaves
    x = torch.zeros(tuple(int(s) for s in shape), dtype=torch.float32)
    payload = codec.encode(_ZeroKey(), x)
    return sum(t.numel() * t.element_size() for t in tree_leaves(payload))


def _measured_bytes(tp, direction: str, shape) -> Tuple[int, str]:
    """(true wire bytes, codec label) for one message on this transport."""
    from ..core.engine import CompressedWANTransport

    n = int(math.prod(int(s) for s in shape))
    if isinstance(tp, CompressedWANTransport):
        codec = tp.codecs[direction]
        if not getattr(codec, "exact", False):
            return payload_nbytes(codec, shape), type(codec).__name__
        return n * tp.wire.itemsize, type(codec).__name__
    return n * tp.wire.itemsize, type(tp).__name__


def audit_wire(tp, celu, z_shapes: Sequence[Tuple[int, ...]],
               trace: TraceAudit, n_computes: int, case: str,
               jobs: int = 0) -> Tuple[List[Finding], Dict[str, Any]]:
    """Cross-check measured vs claimed vs reported bytes, and reconcile
    the ledger against the boundary crossings the trace actually has.

    ``jobs > 0`` audits a BATCHED (vmapped fleet) trace: the byte ledger
    is still per job (``z_shapes`` unbatched), but each boundary crossing
    in the graph must carry the leading ``(jobs,)`` axis (one mark moves
    the whole fleet's messages; a per-job mark count would mean the job
    axis was unrolled).

    ``stats["ledger"]`` lists every (direction, party) row with its three
    byte counts."""
    from ..core.engine import CompressedWANTransport

    findings: List[Finding] = []
    stats: Dict[str, Any] = {}
    ledger: List[Dict[str, Any]] = []

    def add(code, where, detail):
        findings.append(Finding(code=code, severity="error", where=where,
                                detail=detail, case=case))

    up_total = down_total = 0
    for i, shape in enumerate(z_shapes):
        for direction in ("up", "down"):
            reported = (tp.uplink_bytes(shape) if direction == "up"
                        else tp.downlink_bytes(shape))
            measured, codec_name = _measured_bytes(tp, direction, shape)
            claimed = measured
            where = f"{codec_name}[{direction}] party {i} z{tuple(shape)}"
            if measured != reported:
                add("wire.bytes-mismatch", where,
                    f"transport reports {reported} B/message but the "
                    f"encoded payload measures {measured} B — the WAN "
                    f"clock and every efficiency table are "
                    f"{'under' if reported < measured else 'over'}-counting "
                    f"by {abs(measured - reported)} B")
            if isinstance(tp, CompressedWANTransport):
                claimed = tp.codecs[direction].wire_bytes(shape, tp.wire)
                if claimed != measured and \
                        not getattr(tp.codecs[direction], "exact", False):
                    add("wire.bytes-mismatch", where,
                        f"codec.wire_bytes claims {claimed} B but encode "
                        f"emits {measured} B of payload")
            ledger.append({"direction": direction, "party": i,
                           "measured": int(measured),
                           "claimed": int(claimed),
                           "reported": int(reported)})
            if direction == "up":
                up_total += measured
            else:
                down_total += measured

    round_reported = tp.round_bytes(z_shapes)
    if round_reported != up_total + down_total:
        add("wire.round-bytes", f"{type(tp).__name__}.round_bytes",
            f"round_bytes reports {round_reported} B but per-message "
            f"payloads sum to {up_total + down_total} B")

    # ledger vs trace: every boundary crossing in the graph is accounted
    K = len(z_shapes)
    by_dir: Dict[str, list] = {"up": [], "down": []}
    for rec in trace.boundaries.values():
        by_dir.setdefault(rec.direction, []).append(rec)
    for direction in ("up", "down"):
        recs = by_dir[direction]
        expect = K * n_computes
        if len(recs) != expect:
            add("wire.unaccounted-boundary",
                f"{direction} boundary",
                f"trace contains {len(recs)} {direction} boundary "
                f"crossings but the byte ledger accounts "
                f"{expect} ({K} parties x {n_computes} exchange "
                f"dispatch(es)) — an unaccounted send would move bytes "
                f"the WAN clock never sees")
        for rec in recs:
            want = ((jobs,) if jobs else ()) \
                + tuple(z_shapes[rec.party % K])
            if rec.shape != want:
                add("wire.boundary-shape",
                    f"{direction}:{rec.party}",
                    f"boundary crossing has shape {rec.shape} but the "
                    f"accounted message for party {rec.party % K} is "
                    f"{want}")

    stats["uplink_bytes"] = up_total
    stats["downlink_bytes"] = down_total
    stats["round_bytes"] = round_reported
    stats["boundaries"] = len(trace.boundaries)
    stats["boundaries_up"] = len(by_dir["up"])
    stats["boundaries_down"] = len(by_dir["down"])
    stats["ledger"] = ledger
    if jobs:
        stats["jobs"] = jobs
    return findings, stats
