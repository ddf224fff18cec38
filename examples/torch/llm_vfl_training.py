"""CELU-VFL on an LLM backbone at FULL model geometry, on the PyTorch port
(the twin of ``examples/llm_vfl_training.py``): Party A holds an auxiliary
token stream, Party B the main tokens + labels, and the full protocol
stack (workset ring, round-robin sampling, instance weighting,
int4-at-rest cache, int8 optimizer state) runs over the real 32-layer
smollm-360m config.  The script prints the exact per-party device-memory
math (``repro_torch.launch.budget``) before training, then hands the run
to the port's training CLI (``repro_torch.launch.train``): on the card
the int4 ring's local updates go through K5, its inserts through K3, and
each party update through K8.

Defaults are full geometry with a small demo batch; pass ``--reduced``
for the 2-layer CPU smoke variant.  It runs on the card unless
``--device cpu`` is given.

    python examples/torch/llm_vfl_training.py
    python examples/torch/llm_vfl_training.py --reduced --device cpu \\
        --cache-dtype float32 --opt-state-dtype float32
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.budget import format_budget, party_hbm_budget  # noqa: E402,E501

W = 3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke variant instead of full geometry")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: 3 full-geometry rounds, 12 reduced")
    ap.add_argument("--cache-dtype", default="int4",
                    choices=("float32", "bfloat16", "int8", "int4"))
    ap.add_argument("--opt-state-dtype", default="int8",
                    choices=("float32", "bfloat16", "int8"))
    return ap


def shape(args):
    """-> (batch, seq_len, rounds) of the run."""
    if args.reduced:
        return 4, 32, args.rounds or 12
    return 2, 64, args.rounds or 3


def budget_lines(args) -> list:
    """The per-party device-memory math, before any weight exists: the
    demo shape trained below, then (at full geometry) the paper-shape
    train_4k batch, fp32 and at this run's at-rest dtypes."""
    cfg = get_config(args.arch)
    batch, seq, _ = shape(args)
    shape_cfg = cfg.reduced() if args.reduced else cfg
    demo = party_hbm_budget(shape_cfg, batch_size=batch, seq_len=seq, W=W,
                            cache_dtype=args.cache_dtype,
                            opt_state_dtype=args.opt_state_dtype)
    lines = [format_budget(f"{shape_cfg.name} (this run: B={batch} S={seq} "
                           f"W={W}, cache {args.cache_dtype}, opt state "
                           f"{args.opt_state_dtype})", demo)]
    if not args.reduced:
        for cd, od in (("float32", "float32"),
                       (args.cache_dtype, args.opt_state_dtype)):
            full = party_hbm_budget(cfg, batch_size=256, seq_len=4096, W=5,
                                    cache_dtype=cd, opt_state_dtype=od)
            lines.append(format_budget(
                f"{cfg.name} (paper-shape train_4k: B=256 S=4096 W=5, "
                f"cache {cd}, opt state {od})", full))
    return lines, demo


def train_argv(args) -> list:
    """The training CLI's argv: the reference script's, plus the
    device."""
    batch, seq, rounds = shape(args)
    argv = ["--arch", args.arch, "--protocol", "celu",
            "--rounds", str(rounds), "--batch-size", str(batch),
            "--seq-len", str(seq), "--R", "3", "--W", str(W),
            "--cache-dtype", args.cache_dtype,
            "--opt-state-dtype", args.opt_state_dtype, "--lr", "0.02"]
    if args.reduced:
        argv.append("--reduced")
    if args.device is not None:
        argv += ["--device", args.device]
    return argv


def main(argv=None) -> dict:
    """-> {"budget": the demo shape's budget row, "budget_lines": the
    printed blocks, "argv": the training CLI's argv, "train": what the
    CLI returned (losses, ms per round, wire bytes)}."""
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    lines, demo = budget_lines(args)
    for block in lines:
        print(block)
    targv = train_argv(args)
    return {"budget": demo, "budget_lines": lines, "argv": targv,
            "train": T.main(targv)}


if __name__ == "__main__":
    main()
