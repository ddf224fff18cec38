"""CLI: ``python -m repro_torch.analysis`` — run the boundary audit, write
``results/AUDIT_torch.json``, print the human report, exit nonzero on
errors (1: the audit found errors; 2: ``--selftest`` missed a planted
bug).

``--device cuda`` (the default) adds the card-only checks: the kernels'
resource lint and their launches against their plain versions at the
contracts' geometries, and one real round of each case on CUDA tensors
with its launch counts read (``audit.route_check``).  Without a card it
raises.  ``--device cpu`` runs everything else and reports those two as
``info`` findings.  The graphs are traced on CPU tensors either way.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Boundary audit: information flow, wire bytes, kernel "
                    "contracts.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default) adds the card-only kernel lint and "
                         "route checks; cpu reports them as needing the "
                         "card")
    ap.add_argument("--out", default="results/AUDIT_torch.json",
                    help="JSON report path (default: "
                         "results/AUDIT_torch.json)")
    ap.add_argument("--quick", action="store_true",
                    help="5-case smoke matrix instead of full coverage")
    ap.add_argument("--no-pod", action="store_true",
                    help="skip the two-rank pod audit")
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded-mutation self-tests instead of the "
                         "audit (exit 2 if any mutation is missed)")
    ap.add_argument("--verbose", action="store_true",
                    help="print non-error findings too")
    args = ap.parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("python -m repro_torch.analysis: --device cuda "
                           "but no CUDA device is available (use --device "
                           "cpu)")

    if args.selftest:
        from .selftest import render, run_selftest
        ok, results = run_selftest(args.device)
        print(render(results))
        return 0 if ok else 2

    from .audit import default_cases, run_audit
    report = run_audit(default_cases(quick=args.quick),
                       include_pod=not args.no_pod, device=args.device)
    report.write_json(args.out)
    print(report.render(verbose=args.verbose))
    print(f"\nwrote {args.out}")
    return 0 if report.passed else 1


if __name__ == "__main__":
    sys.exit(main())
