"""Findings, per-case results, and the AUDIT_torch.json / human renderers.

Port of ``repro/analysis/report.py`` (pure Python, the same layout).
Finding codes are dotted ``family.rule`` slugs — the family prefix is the
invariant that failed (``taint`` / ``wire`` / ``kernel`` / ``audit``), the
rule names the specific check.  ``where`` names the offending graph node,
codec, transport direction, or kernel so a CI failure reads as a pointer,
not a riddle.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List

SEVERITIES = ("error", "warning", "info")


@dataclass
class Finding:
    code: str                 # "taint.raw-boundary", "wire.bytes-mismatch", ...
    severity: str             # error | warning | info
    where: str                # offending value / kernel / codec / direction
    detail: str               # human sentence, with numbers
    case: str = ""            # audit case id ("" for case-independent lint)

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class CaseResult:
    """One audited configuration: its findings plus the audit's evidence
    (what was traced, what crossed the boundary, what bytes we proved)."""
    name: str
    config: Dict[str, Any] = field(default_factory=dict)
    findings: List[Finding] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "config": self.config,
                "findings": [f.to_dict() for f in self.findings],
                "stats": self.stats}


@dataclass
class AuditReport:
    cases: List[CaseResult] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def findings(self) -> List[Finding]:
        return [f for c in self.cases for f in c.findings]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def passed(self) -> bool:
        return not self.errors

    def to_dict(self) -> Dict[str, Any]:
        sev = {s: sum(1 for f in self.findings if f.severity == s)
               for s in SEVERITIES}
        return {
            "version": 1,
            "passed": self.passed,
            "summary": {"cases": len(self.cases), **sev},
            "meta": self.meta,
            "cases": [c.to_dict() for c in self.cases],
        }

    def write_json(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=False)
            fh.write("\n")

    def render(self, verbose: bool = False) -> str:
        """Human report: one line per case, findings grouped under it."""
        lines = []
        n_err = len(self.errors)
        for c in self.cases:
            errs = c.errors
            status = "FAIL" if errs else "ok"
            stat_bits = []
            if "boundaries" in c.stats:
                stat_bits.append(f"{c.stats['boundaries']} boundary "
                                 f"crossings")
            if "round_bytes" in c.stats:
                stat_bits.append(f"{c.stats['round_bytes']} B/round")
            if "kernel_ops" in c.stats:
                stat_bits.append(f"{c.stats['kernel_ops']} kernel ops")
            suffix = f"  [{', '.join(stat_bits)}]" if stat_bits else ""
            lines.append(f"[{status:4s}] {c.name}{suffix}")
            shown = c.findings if verbose else errs
            for f in shown:
                lines.append(f"    {f.severity.upper():7s} {f.code} "
                             f"@ {f.where}")
                lines.append(f"            {f.detail}")
        lines.append("")
        if n_err:
            lines.append(f"AUDIT FAILED: {n_err} error(s) across "
                         f"{len(self.cases)} case(s)")
        else:
            lines.append(f"AUDIT PASSED: {len(self.cases)} case(s), "
                         f"{len(self.findings)} non-error finding(s)")
        return "\n".join(lines)
