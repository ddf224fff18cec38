"""Fault injection over the pipelined scheduler: the chaos layer.

Port of ``repro/core/faults.py``.  CELU-VFL hides a slow, unreliable WAN
behind cached local updates; this module makes the unreliable part real.
A seeded :class:`~repro_torch.configs.base.FaultPlan` drives a
deterministic :class:`FaultSchedule` (every fate is a function of
``(seed, round_idx)`` through ``np.random.default_rng``, so the fates are
the reference's, bit for bit), and :class:`ChaosEngine`, a
:class:`~repro_torch.core.engine.PipelinedEngine`, replays it over the
exchange queue:

  * **Exchange drop with bounded retry.**  Each round's exchange is tried
    up to ``max_retries + 1`` times (priced by
    ``launch.wan.retry_exchange_seconds``); when every attempt drops, the
    exchange is abandoned and the transport's ``recover_dropped`` folds
    the lost decoded messages back into the error-feedback residuals.
  * **Stragglers.**  A delivered exchange may arrive ``d`` rounds late;
    its merge waits for the arrival, and while the queue is full with an
    unarrived head, dispatches stall (the round's batch is skipped).
  * **Party dropout and rejoin.**  While a party is down no exchange is
    dispatched or merged, and the scans' ``party_mask`` freezes the down
    party; the others keep updating from their caches.
  * **Staleness.**  A scan is charged ``t - dispatch round of the newest
    merged exchange`` (the in-flight count on the fault-free schedule),
    and a merge its true age in scheduler rounds.

``plan=None`` defers every decision to :class:`PipelinedEngine`, bitwise.

Every fate is a host decision: the engine reads nothing back from the
card (a starved round's NaN ``loss`` is a device tensor).  A run resumes
from ``checkpoint.save_round_state`` of its round state with
:meth:`ChaosEngine.host_state` beside it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import CELUConfig, FaultPlan
from ..optim import Optimizer
from .engine import (KPartyTask, PipelinedEngine, RoundState,
                     _zero_local_metrics)


@dataclasses.dataclass(frozen=True)
class ExchangeFate:
    """The fate of one round's exchange attempt(s)."""
    delivered: bool
    attempts: int       # wire attempts made (1..max_retries + 1)
    delay_rounds: int   # straggler delay in rounds (0: on time)


class FaultSchedule:
    """Deterministic fate oracle over a :class:`FaultPlan`.  Every
    decision comes from a fresh ``np.random.default_rng((seed,
    round_idx))`` stream, independent of call history, so a resumed run
    sees the same faults without replaying the earlier rounds."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def down(self, round_idx: int) -> Tuple[str, ...]:
        return self.plan.down_parties(round_idx)

    def party_mask(self, round_idx: int, K: int, device="cpu"
                   ) -> Optional[torch.Tensor]:
        """(K+1,) float32 mask (a_0..a_{K-1}, b) on ``device``, or None
        when every party is up.  A plan naming a feature party the engine
        does not have is an error."""
        down = self.down(round_idx)
        if not down:
            return None
        # filled on the device: no host-to-device copy, so no wait for
        # the kernels queued before it
        mask = torch.ones(K + 1, dtype=torch.float32, device=device)
        for p in down:
            idx = K if p == "b" else int(p[1:])
            # slot K is party b's: an out-of-range "a{K}" must not mask it
            if p != "b" and idx >= K:
                raise ValueError(
                    f"FaultPlan drops party {p!r} but the engine has "
                    f"only K={K} feature parties (a0..a{K - 1}) plus b")
            mask[idx] = 0.0
        return mask

    def exchange_fate(self, round_idx: int) -> ExchangeFate:
        plan = self.plan
        if plan.drop_prob <= 0.0 and plan.straggler_prob <= 0.0:
            return ExchangeFate(True, 1, 0)
        rng = np.random.default_rng((plan.seed, round_idx))
        attempts, delivered = 0, False
        for _ in range(plan.max_retries + 1):
            attempts += 1
            if rng.random() >= plan.drop_prob:
                delivered = True
                break
        delay = 0
        if delivered and plan.straggler_prob > 0.0 \
                and rng.random() < plan.straggler_prob:
            delay = int(rng.integers(1, plan.straggler_rounds + 1))
        return ExchangeFate(delivered, attempts, delay)


class ChaosEngine(PipelinedEngine):
    """The pipelined scheduler under a seeded fault plan.

    The same ``step`` / ``flush`` / ``finalize`` contract as
    :class:`PipelinedEngine`; a round whose merge a fault starved reports
    a NaN ``loss``.  The host-side bookkeeping (the scheduler clock, the
    slots' arrival and dispatch rounds, the event log) lives on the
    engine: checkpoint :meth:`host_state` beside the round state."""

    def __init__(self, task: KPartyTask, opt: Optimizer, celu: CELUConfig,
                 *, plan: Optional[FaultPlan] = None,
                 depth: Optional[int] = None, local_steps: int = -1,
                 transport=None, compression: Optional[str] = None):
        super().__init__(
            task, opt, celu, depth=depth, local_steps=local_steps,
            transport=transport, compression=compression,
            # no plan: the base scheduler's path, bit for bit
            dynamic_staleness=True if plan is not None else None)
        self.plan = plan
        self.schedule = None if plan is None else FaultSchedule(plan)
        self.now = 0                    # scheduler rounds elapsed
        self.events: List[Dict[str, Any]] = []
        self._dispatch_seq = 0          # the wire's round (see dispatch)
        self._arrival: List[int] = []   # per pending slot, oldest first
        self._dispatch_round: List[int] = []
        self._last_merged_dispatch = -1
        self.counters = {"dispatches": 0, "drops": 0, "stalls": 0,
                         "stalled_dispatches": 0, "dropout_rounds": 0,
                         "merges": 0, "wire_attempts": 0,
                         "straggler_delay_rounds": 0}

    # ---- host bookkeeping ------------------------------------------------
    def _event(self, t: int, kind: str, **detail):
        self.events.append({"round": t, "kind": kind, **detail})

    def host_state(self) -> Dict[str, Any]:
        """The scheduler's fault bookkeeping as a tree of host ints, to
        checkpoint beside the round state (``checkpoint.save_round_state``
        ``extra``)."""
        return {"now": self.now, "dispatch_seq": self._dispatch_seq,
                "arrival": list(self._arrival),
                "dispatch_round": list(self._dispatch_round),
                "last_merged_dispatch": self._last_merged_dispatch}

    def load_host_state(self, hs: Dict[str, Any]) -> None:
        """Restore the clock and the queue's bookkeeping; the counters and
        the event log are not part of it (a resumed run counts only its
        own rounds, as in the reference)."""
        self.now = int(hs["now"])
        self._dispatch_seq = int(hs["dispatch_seq"])
        self._arrival = [int(x) for x in hs["arrival"]]
        self._dispatch_round = [int(x) for x in hs["dispatch_round"]]
        self._last_merged_dispatch = int(hs["last_merged_dispatch"])

    def telemetry(self) -> Dict[str, Any]:
        return {"rounds": self.now, **self.counters,
                "events": list(self.events)}

    def _mask(self, rs: RoundState, t: int):
        return self.schedule.party_mask(t, len(rs.params["a"]),
                                        rs.comm_rounds.device)

    # ---- faulty stages ---------------------------------------------------
    def dispatch(self, rs: RoundState, batches_a, batch_b, batch_idx, *,
                 wire_round: Optional[int] = None) -> RoundState:
        """Under a plan the wire is keyed by the host dispatch count, not
        merges + in flight: the two agree on the fault-free schedule, but
        after a drop the latter would repeat, and a resend must not reuse
        the dropped release's uniforms or DP noise."""
        if self.plan is None:
            return super().dispatch(rs, batches_a, batch_b, batch_idx,
                                    wire_round=wire_round)
        rs = super().dispatch(rs, batches_a, batch_b, batch_idx,
                              wire_round=self._dispatch_seq)
        self._dispatch_seq += 1
        return rs

    def _absorb_drop(self, rs: RoundState) -> RoundState:
        """Pop the newest exchange, whose transfer was lost, and park the
        transport's recovered residuals where the next dispatch (and the
        next merge) reads them: on the newest surviving slot, or on
        ``rs.transport`` when the queue is empty.  The slot's payload is
        replaced, not written."""
        pe = rs.pending[-1]
        recovered = self.transport.recover_dropped(pe.fresh)
        pending = rs.pending[:-1]
        if pending:
            prev = pending[-1]
            fresh = dict(prev.fresh)
            fresh["tstate"] = recovered
            return rs._replace(
                pending=pending[:-1] + (prev._replace(fresh=fresh),))
        return rs._replace(pending=(), transport=recovered)

    def _scan_staleness(self, t: int) -> int:
        """Rounds since the newest merged exchange was dispatched."""
        return t - self._last_merged_dispatch

    def _chaos_local(self, rs: RoundState, t: int, mask):
        return self.local(rs, staleness=self._scan_staleness(t),
                          party_mask=mask)

    def _try_merge(self, rs: RoundState, t: int, down: Tuple[str, ...]):
        """Merge the oldest exchange if the schedule allows it: the queue
        at capacity, its head arrived, nobody down."""
        if down or len(rs.pending) < self.queue_capacity:
            return rs, None
        if self._arrival and self._arrival[0] > t:
            self.counters["stalls"] += 1
            self._event(t, "stall", arrives=self._arrival[0])
            return rs, None
        dr = self._dispatch_round.pop(0)
        self._arrival.pop(0)
        rs, m = self.merge(rs, staleness=t - dr)
        self._last_merged_dispatch = max(self._last_merged_dispatch, dr)
        self.counters["merges"] += 1
        return rs, m

    # ---- schedules -------------------------------------------------------
    def step(self, rs: RoundState, batches_a, batch_b, batch_idx
             ) -> Tuple[RoundState, Dict[str, Any]]:
        if self.plan is None:
            return super().step(rs, batches_a, batch_b, batch_idx)
        t = self.now
        down = self.schedule.down(t)
        mask = self._mask(rs, t)
        if down:
            self.counters["dropout_rounds"] += 1
            if any(d.start == t for d in self.plan.dropouts
                   if d.covers(t)):
                self._event(t, "dropout", parties=list(down))
        elif len(rs.pending) < self.queue_capacity:
            fate = self.schedule.exchange_fate(t)
            self.counters["wire_attempts"] += fate.attempts
            rs = self.dispatch(rs, batches_a, batch_b, batch_idx)
            self.counters["dispatches"] += 1
            if fate.delivered:
                self._arrival.append(t + fate.delay_rounds)
                self._dispatch_round.append(t)
                if fate.delay_rounds:
                    self.counters["straggler_delay_rounds"] += \
                        fate.delay_rounds
                    self._event(t, "straggler", delay=fate.delay_rounds,
                                attempts=fate.attempts)
            else:
                rs = self._absorb_drop(rs)
                self.counters["drops"] += 1
                self._event(t, "drop", attempts=fate.attempts)
        else:
            # the queue is full behind an unarrived head: the round's
            # batch is skipped (a straggler's real cost)
            self.counters["stalled_dispatches"] += 1
            self._event(t, "stall-dispatch")
        if self.depth == 0:
            rs, m = self._try_merge(rs, t, down)
            rs, lm = self._chaos_local(rs, t, mask)
        else:
            rs, lm = self._chaos_local(rs, t, mask)
            rs, m = self._try_merge(rs, t, down)
        self.now = t + 1
        if m is None:
            m = {"loss": torch.full((), float("nan"),
                                    device=rs.comm_rounds.device)}
        m.update(lm)
        return rs, m

    def flush(self, rs: RoundState) -> Tuple[RoundState, Dict[str, Any]]:
        """Drain the queue.  The outstanding merges complete whatever the
        rest of the schedule says (their transfers succeeded; only their
        arrival was simulated, and shutdown waits for it).  Down parties
        stay masked in the drain's scans."""
        if self.plan is None:
            return super().flush(rs)
        dev = rs.comm_rounds.device
        if self.depth == 0 and not rs.pending:
            # depth 0 merges, then scans: every merge had its scan
            return rs, _zero_local_metrics(dev)
        scans = []
        while rs.pending:
            t = self.now
            rs, lm = self._chaos_local(rs, t, self._mask(rs, t))
            scans.append(lm)
            dr = self._dispatch_round.pop(0) if self._dispatch_round \
                else t
            if self._arrival:
                self._arrival.pop(0)
            rs, _ = self.merge(rs, staleness=t - dr)
            self._last_merged_dispatch = max(
                self._last_merged_dispatch, dr)
            self.counters["merges"] += 1
            self.now = t + 1
        t = self.now
        rs, lm = self._chaos_local(rs, t, self._mask(rs, t))
        scans.append(lm)
        n = len(scans)
        return rs, {
            "local_steps": sum(s["local_steps"] for s in scans),
            "w_mean": sum(s["w_mean"] for s in scans) / n,
            "w_zero_frac": sum(s["w_zero_frac"] for s in scans) / n,
        }


def make_chaos_engine(task: KPartyTask, opt: Optimizer, celu: CELUConfig,
                      *, plan: Optional[FaultPlan] = None,
                      **kw) -> ChaosEngine:
    """:func:`~repro_torch.core.engine.make_pipeline` with a fault plan;
    ``plan=None`` is bitwise the fault-free pipeline."""
    return ChaosEngine(task, opt, celu, plan=plan, **kw)
