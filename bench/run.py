"""The benchmark of ``repro_torch``: one run of one cell on this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It reads the cell from ``BENCHMARK.json`` and its files under ``bench/``,
refuses to run without as many CUDA devices as the cell asks for, runs
the cell (``bench/harness.py``), prints each number it compared with its
limit as the last lines of standard error, and the result as the last
line of standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics.  It exits with 3 and
prints no result if the JAX package or JAX itself was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench import specs
    cell = specs.load_cell(args.workload)

    import torch
    need = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench/run.py: {args.workload} needs {need} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from bench import harness
    print(f"[card] {harness.card_line()}; shares are of the H100 SXM's "
          f"published peaks", file=sys.stderr, flush=True)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)

    bad = loaded_forbidden()
    if bad:
        print(f"bench/run.py: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"[check] correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
