"""Serve a split VFL model on the PyTorch port (the twin of
``examples/serve_split_model.py``): continuous batching over the party
boundary.

Two runs of the port's serving CLI (``repro_torch.launch.serve``), both
at reduced geometry:

  * smollm-360m (fusion="add"): the ServeEngine path — requests admit
    into a fixed-capacity lane array and evict mid-flight, every decode
    step runs over all lanes at once, the cut activation crosses the int8
    uplink (K3) and Party B fuses it from the quantized activation ring
    (K3 on insert, K6 on read).  Prints requests/sec, p50/p99 token
    latency, and exact wire bytes per token.
  * llama-3.2-vision-90b (cross-attn): the sequential fallback — the
    vision memory crosses once at prefill, decode is Party-B-local, so
    there is no per-token activation to batch over the wire.

It runs on the card unless ``--device cpu`` is given.

    python examples/torch/serve_split_model.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402

ENGINE_ARGV = ["--arch", "smollm-360m", "--requests", "12", "--capacity",
               "4", "--prompt-len", "16", "--gen", "8"]
NAIVE_ARGV = ["--arch", "llama-3.2-vision-90b", "--requests", "2",
              "--prompt-len", "16", "--gen", "8"]


def main(argv=None) -> dict:
    """-> {"engine": (completions, stats) of the continuous-batching run,
    "naive": (tokens, stats) of the cross-attention run}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    dev = [] if args.device is None else ["--device", args.device]
    # continuous-batching engine: 12 requests through 4 lanes
    engine = S.main(ENGINE_ARGV + dev)
    print()
    # cross-attn family: sequential naive_generate fallback
    naive = S.main(NAIVE_ARGV + dev)
    return {"engine": engine, "naive": naive}


if __name__ == "__main__":
    main()
