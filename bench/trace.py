"""The traced rounds: ``torch.profiler`` over a few whole rounds after the
window, reduced to what the per-layer readers and the result's breakdown
read.

Device time is the union of the device activities' intervals (kernels,
copies, sets), as ``chip_smoke.py`` sums ``device_time_total`` over the
profiler's CUDA events; an idle gap is the time between two of them, and
what the host was doing in it is the innermost host operation open at the
gap's middle.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import torch

NON_KERNEL = ("Memcpy", "Memset")


@dataclass
class Profile:
    """The device and host events of ``rounds`` profiled rounds.
    ``device``: (name, start µs, end µs) of every device activity;
    ``host``: (name, start µs, end µs) of every host operation;
    ``wall_s``: the host clock over the profiled rounds, ending in a
    synchronize."""
    rounds: int
    wall_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if not e[0].startswith(NON_KERNEL)]

    def matching(self, patterns) -> List[Tuple[str, float, float]]:
        """The kernels whose name holds one of ``patterns``."""
        return [e for e in self.kernels()
                if any(p in e[0] for p in patterns)]

    def busy_s(self) -> float:
        """Seconds in which some device activity ran."""
        return sum(b - a for a, b in _merged(self.device)) / 1e6


def _merged(events) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def profile_rounds(step: Callable[[int], None], rounds: int,
                   sync: Callable[[], None]) -> Profile:
    """Run ``step(i)`` for ``rounds`` rounds under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(rounds):
            step(i)
        sync()
        wall = time.perf_counter() - t0
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    # the profiler's raw records: building ``prof.events()``'s tree of a
    # round's ~10^6 records would take minutes
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        row = (e.name(), start, start + e.duration_ns() / 1e3)
        (dev if e.device_type() == cuda else host).append(row)
    return Profile(rounds=rounds, wall_s=wall, device=dev, host=host)


def top_device_ops(p: Profile, n: int = 10) -> List[list]:
    """[[name, device seconds a round]] of the ``n`` costliest names."""
    tot: dict = defaultdict(float)
    for name, a, b in p.device:
        tot[name] += (b - a) / 1e6
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], s / p.rounds] for name, s in top]


def idle_gaps(p: Profile, n: int = 10, scan: int = 4000) -> List[list]:
    """[[what the host was doing, idle device seconds a round]]: the
    gaps between device activities, summed by the innermost host
    operation open at each gap's middle, the ``n`` largest sums."""
    spans = _merged(p.device)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:])
            if a1 > b0]
    host = sorted(p.host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    tot: dict = defaultdict(float)
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = (g0 + g1) / 2
        name = "(no host operation)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - scan), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        tot[name] += (g1 - g0) / 1e6
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:200], s / p.rounds] for name, s in top]
