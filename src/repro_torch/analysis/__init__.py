"""Boundary auditor for the port's CELU round engine.

Port of ``repro/analysis``.  Traces the round, the fleet step and the
serving step to ``make_fx`` graphs (through functionalization, on CPU
tensors), records the pod round's ``torch.distributed`` calls, and proves
three invariant families:

  * **taint** — cross-party information flow: every value reaching a
    transport send passes the registered wire / codec-encode / DP-noise
    stages, and no state hosted at one party carries another party's raw
    taint (raw features, labels, pre-release cut tensors, optimizer
    state), error-feedback residuals and the fleet's in-flight queue
    slots included;
  * **wire** — byte accounting: the payload a codec's ``encode`` emits
    must equal the codec's ``wire_bytes()`` and the transport's
    ``uplink_bytes`` / ``downlink_bytes`` counters, and every boundary
    crossing the graph contains must be accounted;
  * **kernel** — the Hopper kernels' contracts: a plain version beside
    each, the wrapper's operand checks and shared memory at the audited
    geometries, the gate op each config promises in its graph, no
    narrowing precision cast outside a declared wire / codec / cache
    stage; on the card, the kernels' registers, shared and local memory
    (``cuobjdump -res-usage``), each contract against its plain version,
    and each audited round's launches (``audit.route_check``).

Run ``python -m repro_torch.analysis`` for the CLI (writes
``results/AUDIT_torch.json``).  This ``__init__`` stays import-light: the
modules load on first use.
"""

__all__ = ["run_audit", "default_cases", "Finding", "AuditReport"]


def __getattr__(name):
    if name in ("run_audit", "default_cases"):
        from . import audit
        return getattr(audit, name)
    if name in ("Finding", "AuditReport"):
        from . import report
        return getattr(report, name)
    raise AttributeError(name)
