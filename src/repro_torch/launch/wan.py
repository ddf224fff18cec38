"""The simulated WAN clock: per-direction bandwidth + RTT, and the
overlap-aware round latency model.

Copy of ``repro/launch/wan.py``'s ``WANClock``, ``transport_round_updown``
and ``wan_seconds`` (the port imports nothing of the JAX package).  The
simulation has no real WAN, so the training loop models wall-clock from
byte counts (paper §2.1: a 300 Mbps gateway-proxied link).  Within a round
the two legs serialize, so wire time is ``up/bw_up + down/bw_down +
2·latency``; the sequential schedule pays ``exchange_compute + wire +
local`` per round, a depth-D pipelined one the slowest of the local
worker, the serial wire occupancy and ``(exchange_compute + wire) / D``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class WANClock:
    """Simulated cross-silo WAN link (paper §2.1 defaults: 300 Mbps each
    direction, 10 ms one-way gateway latency)."""
    up_bandwidth: float = 300e6 / 8      # bytes/s, feature party -> label
    down_bandwidth: float = 300e6 / 8    # bytes/s, label party -> feature
    latency: float = 0.01                # s, one way

    @property
    def rtt(self) -> float:
        return 2.0 * self.latency

    def up_seconds(self, nbytes: float) -> float:
        """One uplink leg (Z_i), excluding latency."""
        return nbytes / self.up_bandwidth

    def down_seconds(self, nbytes: float) -> float:
        """One downlink leg (∇Z_i), excluding latency."""
        return nbytes / self.down_bandwidth

    def wire_seconds(self, up_bytes: float, down_bytes: float) -> float:
        """One full exchange: the legs serialize (the downlink cotangent
        depends on the uplinked Z), plus one RTT of gateway latency."""
        return self.up_seconds(up_bytes) + self.down_seconds(down_bytes) \
            + self.rtt

    def round_seconds(self, up_bytes: float, down_bytes: float, *,
                      exchange_compute_s: float = 0.0,
                      local_compute_s: float = 0.0,
                      pipeline_depth: int = 0) -> float:
        """Latency of ONE communication round under the given schedule.

        Sequential (depth 0): the WAN stall serializes with both compute
        phases.  Pipelined (depth D >= 1): up to D exchanges (compute +
        wire) are in flight concurrently with the local updates, so the
        steady-state round period is the slowest of three bounds —

          * the local worker: ``local_compute_s`` per round;
          * the serial wire occupancy: each round must still push one
            exchange's bytes through the link (transfers pipeline, so the
            RTT amortizes across the D in-flight exchanges but bandwidth
            does not multiply);
          * the exchange latency amortized over its D-round window:
            ``(exchange_compute_s + wire) / D`` — an exchange has D rounds
            to complete before its merge is due.

        Depth 1 reduces to the historical ``max(exchange + wire, local)``
        (the single-exchange window dominates its occupancy bound)."""
        wire = self.wire_seconds(up_bytes, down_bytes)
        if pipeline_depth <= 0:
            return exchange_compute_s + wire + local_compute_s
        occupancy = self.up_seconds(up_bytes) + self.down_seconds(down_bytes)
        return max(local_compute_s, occupancy,
                   (exchange_compute_s + wire) / pipeline_depth)

    def time_to_target(self, rounds: int, up_bytes: float,
                       down_bytes: float, **kw) -> float:
        """Overlap-aware simulated wall-clock for ``rounds`` rounds."""
        return rounds * self.round_seconds(up_bytes, down_bytes, **kw)

    def with_bandwidth(self, up: float, down: float = None) -> "WANClock":
        return dataclasses.replace(self, up_bandwidth=up,
                                   down_bandwidth=up if down is None
                                   else down)


DEFAULT_CLOCK = WANClock()


def transport_round_updown(transport, z_shapes):
    """Per-round (uplink, downlink) byte totals for a transport over the K
    cut-tensor shapes — the per-direction split ``round_bytes`` sums."""
    up = sum(transport.uplink_bytes(s) for s in z_shapes)
    down = sum(transport.downlink_bytes(s) for s in z_shapes)
    return up, down


def wan_seconds(up_bytes: float, down_bytes: float, *,
                clock: WANClock = DEFAULT_CLOCK) -> float:
    """Seconds one exchange spends on the wire.  Both directions are
    required — the historical one-argument form took the ROUND TOTAL and
    would silently double-count if it defaulted here."""
    return clock.wire_seconds(up_bytes, down_bytes)
