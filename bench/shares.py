"""Roofline shares: the least time the card could take for the work of
some launches, over the device time they took."""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from . import peaks


def least_s(flops: float, nbytes: float, flop_peak: float) -> float:
    """The larger of operations over the FLOP peak and bytes over the
    memory bandwidth."""
    return max(flops / flop_peak, nbytes / peaks.HBM_BYTES_PER_S)


def visible_pairs(S: int, causal: bool) -> int:
    """(query, key) pairs one attention head's mask keeps."""
    return S * (S + 1) // 2 if causal else S * S


def device_s(events: Iterable[Tuple[str, float, float]]) -> float:
    return sum(b - a for _, a, b in events) / 1e6


def share_pct(least: float, events) -> Optional[float]:
    """100 × least / the events' device time; None with no events."""
    t = device_s(events)
    return 100.0 * least / t if t > 0 else None
