"""The readings that the limits of ``correct`` are set from, for one cell
at its own size (the benchmark's runs do not run it).

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 [--sides control,unweighted] \\
        [--tiny] [--device cpu]

For each seed it drives the program's checked rounds as a run does and
compares them with the reference (``program``).  For each control seed it
also puts the reference in the program's place and compares it with the
fp32 reference, once for each of ``--sides``: computed in bf16
throughout (``control``), with float8 products (``control_fp8``), with
Party B's loss over half of each batch's tokens (``half_batch``), and
with Party A's local cotangent not scaled by its gate weight
(``unweighted``).  A state left unchanged reads 1 on both norm gaps by
construction and is not run.  Each reading is one JSON line on standard
output.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--sides", default="control,control_fp8,half_batch,"
                    "unweighted")
    ap.add_argument("--tiny", action="store_true",
                    help="the cell shrunk to a CPU test's size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    SIDES = {"control": {"dtype": torch.bfloat16},
             "control_fp8": {"products": "fp8"},
             "half_batch": {"keep": 0.5},
             "unweighted": {"unweighted": True}}
    from bench import check, harness, specs, tiny
    from bench import traffic as Tr
    from bench.reference import reading

    cell = tiny.tiny_cell(args.workload) if args.tiny \
        else specs.load_cell(args.workload)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    n = cell["traffic"]["checked_rounds"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def emit(row):
        print(json.dumps(row), flush=True)

    if on_card:
        emit({"card": harness.card_line()})
    for seed in sorted(set(seeds) | set(controls)):
        t0 = time.perf_counter()
        batches, prog = harness.build(cell, seed, dev)
        got = harness.checked_rounds(
            prog, lambda i: prog.step(Tr.batch(batches, i), i), n,
            cell["config"], seed, sync)
        del prog
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        want = reading(cell["config"], cell["traffic"], seed, batches[:n],
                       dev)
        t2 = time.perf_counter()
        emit({"seed": seed, "side": "program", "lr": cell["traffic"]["lr"],
              "program_s": t1 - t0,
              "reference_s": t2 - t1, "loss": got["loss"],
              "loss_ref": want["loss"], "w_zero": got["w_zero"],
              "w_zero_ref": want["w_zero"], "updates": got["updates"],
              "updates_ref": want["updates"], **check.gaps(got, want)})
        if seed in controls:
            for side, kw in SIDES.items():
                if side not in args.sides.split(","):
                    continue
                t3 = time.perf_counter()
                alt = reading(cell["config"], cell["traffic"], seed,
                              batches[:n], dev, **kw)
                emit({"seed": seed, "side": side,
                      "reference_s": time.perf_counter() - t3,
                      "w_zero": alt["w_zero"], "updates": alt["updates"],
                      **check.gaps(alt, want)})
        del batches, want
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
