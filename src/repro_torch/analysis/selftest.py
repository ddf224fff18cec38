"""Seeded-mutation self-tests: the auditor must CATCH each planted bug,
naming the offender — an analyzer that cannot fail is not a gate.

Port of ``repro/analysis/selftest.py``.  Six mutations, one per
invariant family plus the DP-ordering rule, the batched fleet path and
the pod round:

  * **raw-send** — a transport whose ``send`` returns the raw tensor
    unencoded: the taint pass must flag the boundary crossing.
  * **under-count** — a codec whose ``wire_bytes`` reports half the
    payload its ``encode`` emits: the byte reconciliation must flag the
    codec and direction.
  * **gate-bypass** — the gate's entry points in ``kernels/ops.py``
    patched to call the plain version straight, around the gate's op: the
    kernel-route lint must flag the disabled fused path, naming the op
    (the reference's ``bad-blockspec``: the port's gate has no tiling to
    break, so the promise it can break is the op itself).  On the card
    :func:`audit.route_check` must flag it too, from the launch counts.
  * **noise-before-encode** — the pre-fix ``CompressedWANTransport``
    behavior (DP noise applied BEFORE the lossy encode, so error feedback
    re-transmits and cancels the mechanism): the sanitizer ordering check
    must flag it.
  * **fleet-raw-send** — the raw-send transport driven through the
    VMAPPED fleet step (``trace_fleet_case``): the taint pass must flag
    the same crossing with the leading job axis on the boundary — a
    batched trace that hides planted bugs would make the fleet audit case
    vacuous.
  * **pod-raw-isend** — each pod of the two-rank pod round also sends its
    raw features to the other with ``dist.isend``, around the transport:
    the record of ``torch.distributed`` calls (``trace_pod_case``) must
    flag the unmarked call.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List

from .audit import AuditCase, make_celu, route_check, trace_case, \
    trace_fleet_case, trace_pod_case


@dataclass
class MutationResult:
    name: str
    expected_code: str
    caught: bool
    errors: List[str] = field(default_factory=list)


def _raw_leak_transport():
    from ..core import engine as E

    class RawLeakTransport(E.CompressedWANTransport):
        """Planted bug: releases the raw cut tensor, codec ignored."""

        def send(self, key, x, res=None, direction: str = "up"):
            return x, res
    return RawLeakTransport


def _mut_raw_send() -> MutationResult:
    from ..core import compression as C

    case = AuditCase(name="mut-raw-send", compression="int8")
    up, down = C.make_codec_pair("int8")
    r = trace_case(case, transport=_raw_leak_transport()(make_celu(case),
                                                         up, down))
    return _grade("raw-send", "taint.raw-boundary", "RawLeakTransport", r)


def _mut_under_count() -> MutationResult:
    from ..core import compression as C
    from ..core import engine as E

    class UnderCountCodec:
        """Planted bug: reports half the bytes its payload occupies."""

        lossless = False
        exact = False

        def __init__(self, inner):
            self._inner = inner

        def encode(self, key, x):
            return self._inner.encode(key, x)

        def decode(self, payload, like):
            return self._inner.decode(payload, like)

        def wire_bytes(self, shape, dtype) -> int:
            return self._inner.wire_bytes(shape, dtype) // 2

    case = AuditCase(name="mut-under-count", compression="int8")
    tp = E.CompressedWANTransport(make_celu(case),
                                  UnderCountCodec(C.make_codec("int8")),
                                  UnderCountCodec(C.make_codec("int8")))
    r = trace_case(case, transport=tp)
    return _grade("under-count", "wire.bytes-mismatch", "UnderCountCodec",
                  r)


@contextlib.contextmanager
def gate_bypassed():
    """The fp32 / bf16 ring gate's entry points (``kernels/ops.py``)
    routed to the plain version, around ``repro_torch::fused_sample_2d``."""
    from ..kernels import fused_sample as fs
    from ..kernels import ops

    def full(slot, ad_hoc, z_ring, dz_ring, cos_xi):
        B = ad_hoc.shape[0]
        w, cot = fs.fused_sample_plain(slot, ops._rows32(ad_hoc),
                                       ops._ring_rows(z_ring, B),
                                       ops._ring_rows(dz_ring, B), cos_xi)
        return w, cot.reshape(ad_hoc.shape)

    def weights(slot, ad_hoc, ring, cos_xi):
        B = ad_hoc.shape[0]
        return fs.fused_sample_plain(slot, ops._rows32(ad_hoc),
                                     ops._ring_rows(ring, B), None,
                                     cos_xi)[0]

    saved = ops.fused_gather_weight, ops.fused_gather_weights
    ops.fused_gather_weight, ops.fused_gather_weights = full, weights
    try:
        yield
    finally:
        ops.fused_gather_weight, ops.fused_gather_weights = saved


GATE_OP = "repro_torch::fused_sample_2d"


def _mut_gate_bypass() -> MutationResult:
    with gate_bypassed():
        r = trace_case(AuditCase(name="mut-gate-bypass"))
    return _grade("gate-bypass", "kernel.fused-path-disabled", GATE_OP, r)


def _mut_gate_bypass_card() -> MutationResult:
    with gate_bypassed():
        r = route_check(AuditCase(name="mut-gate-bypass"))
    return _grade("gate-bypass (card)", "kernel.fused-path-disabled",
                  GATE_OP, r)


def _mut_noise_before_encode() -> MutationResult:
    from ..core import compression as C
    from ..core import engine as E

    class StatelessClaim:
        """Lossy codec that opts out of error feedback (no residual
        state) — isolates the ORDERING violation below.  With residuals
        the same bug surfaces as ``taint.raw-boundary`` instead: the
        un-noised residual joins the release and dilutes the DP stage
        out of the taint's sanitizer set."""

        lossless = True      # -> no residual slots in the round state
        exact = False

        def __init__(self, inner):
            self._inner = inner

        def encode(self, key, x):
            return self._inner.encode(key, x)

        def decode(self, payload, like):
            return self._inner.decode(payload, like)

        def wire_bytes(self, shape, dtype) -> int:
            return self._inner.wire_bytes(shape, dtype)

    class NoiseFirstTransport(E.CompressedWANTransport):
        """Planted bug: the pre-fix DP path — noise rides the value INTO
        the lossy encode instead of the decoded wire value."""

        def send(self, key, x, res=None, direction: str = "up"):
            codec = self.codecs[direction]
            x, _ = E.SimWANTransport.send(self, key, x, None, direction)
            e = x.float()
            if res is not None:
                e = e + res
            y = codec.decode(codec.encode(key.fold(1), e), e)
            return y.to(x.dtype), None if res is None else e - y

    case = AuditCase(name="mut-noise-before-encode", compression="int8",
                     dp_sigma=0.3)
    tp = NoiseFirstTransport(make_celu(case),
                             StatelessClaim(C.make_codec("int8")),
                             StatelessClaim(C.make_codec("int8")))
    r = trace_case(case, transport=tp)
    return _grade("noise-before-encode", "taint.sanitizer-order",
                  "NoiseFirstTransport", r)


def _mut_fleet_raw_send() -> MutationResult:
    from ..core import compression as C

    case = AuditCase(name="mut-fleet-raw-send", depth=2,
                     compression="int8")
    up, down = C.make_codec_pair("int8")
    r = trace_fleet_case(case, transport=_raw_leak_transport()(
        make_celu(case), up, down))
    return _grade("fleet-raw-send", "taint.raw-boundary",
                  "RawLeakTransport", r)


def _mut_pod_raw_isend() -> MutationResult:
    return _grade("pod-raw-isend", "taint.unmarked-collective", "isend",
                  trace_pod_case(leak=True))


def _grade(name: str, expected_code: str, offender: str,
           result) -> MutationResult:
    hits = [f for f in result.findings
            if f.code == expected_code and offender in f.where]
    return MutationResult(
        name=name, expected_code=expected_code, caught=bool(hits),
        errors=[f"{f.code} @ {f.where}" for f in result.errors])


def run_selftest(device: str = "cpu"):
    """-> (all caught?, per-mutation results).  ``device="cuda"`` adds the
    gate bypass caught by :func:`audit.route_check` on the card."""
    results = [_mut_raw_send(), _mut_under_count(), _mut_gate_bypass(),
               _mut_noise_before_encode(), _mut_fleet_raw_send(),
               _mut_pod_raw_isend()]
    if device == "cuda":
        results.append(_mut_gate_bypass_card())
    return all(m.caught for m in results), results


def render(results: List[MutationResult]) -> str:
    lines = ["seeded-mutation self-test:"]
    for m in results:
        status = "caught" if m.caught else "MISSED"
        lines.append(f"  [{status:6s}] {m.name} -> {m.expected_code}")
        if not m.caught:
            lines.append(f"           analyzer errors were: "
                         f"{m.errors or ['<none>']}")
    ok = all(m.caught for m in results)
    lines.append("SELFTEST PASSED" if ok else
                 "SELFTEST FAILED: the analyzer missed a planted bug")
    return "\n".join(lines)
