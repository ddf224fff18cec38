"""Serving CLI: continuous-batching split-model serving on synthetic
open-loop traffic (port of ``repro/launch/serve.py``).

A thin CLI over :class:`repro_torch.serve.ServeEngine`: it builds the
seeded load (``serve/loadgen.py``, the reference's traffic for one
seed), draws the model's weights from ``--seed``, serves the load through
the fixed-capacity lane array with the compressed uplink and the
quantised decode activation ring, and prints requests/s, tokens/s,
p50/p99 token latency and the exact wire and ring bytes.  It runs on the
card unless ``--device cpu`` is given.  The text-family archs (dense,
moe, hybrid, ssm / xlstm); the cross-attention families (vlm / audio)
come with slice 7d of the port.  llama4-scout-17b-a16e's full widths
(216 GB of bf16 parameters) do not fit one card: serve it reduced.

  python -m repro_torch.launch.serve --arch smollm-360m --full \\
      --requests 32 --capacity 8 --prompt-len 16 --gen 16
  python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --full \\
      --requests 8 --capacity 4 --prompt-len 4096 --gen 16
  python -m repro_torch.launch.serve --device cpu \\
      --requests 8 --capacity 4 --prompt-len 8 --gen 6
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import resolve_device
from ..configs import ARCH_IDS, LATER_ARCH_IDS, get_config
from ..models import layers as L
from ..models import vfl
from ..serve import LoadSpec, ServeConfig, ServeEngine, synth_requests


def percentiles(comps):
    """(p50, p99) of the ms between a request's consecutive tokens (the
    first from its arrival)."""
    lats = []
    for c in comps:
        prev = c.arrival
        for t in c.token_times:
            lats.append(t - prev)
            prev = t
    ms = 1e3 * np.asarray(lats)
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def serve_engine(args, cfg, params, uniforms=None):
    """Serve the seeded load; print the CLI's lines.  -> (completions,
    stats, engine); ``stats`` gains ``warm_s``, ``req_per_s``,
    ``tok_per_s``, ``p50_ms`` and ``p99_ms``."""
    scfg = ServeConfig(capacity=args.capacity, prompt_len=args.prompt_len,
                       max_new_tokens=args.gen,
                       compression="" if args.fp32_wire else "int8",
                       cache_dtype=args.cache_dtype,
                       refresh_every=args.refresh_every, seed=args.seed)
    spec = LoadSpec(n_requests=args.requests, rate=args.rate,
                    prompt_len=args.prompt_len, max_new_tokens=args.gen,
                    min_new_tokens=max(1, args.gen // 4), seed=args.seed)
    eng = ServeEngine(params, cfg, scfg, uniforms=uniforms)
    t0 = time.perf_counter()
    eng.warm()
    warm_s = time.perf_counter() - t0
    print(f"warm (kernel build, first launches) {warm_s:.1f} s")
    comps, stats = eng.run(synth_requests(spec, cfg))

    n_tok = stats["total_tokens"]
    dur = stats["virtual_duration_s"]
    p50, p99 = percentiles(comps)
    up, down = stats["wire_up_bytes"], stats["wire_down_bytes"]
    stats.update(warm_s=warm_s, req_per_s=stats["n_requests"] / dur,
                 tok_per_s=n_tok / dur, p50_ms=p50, p99_ms=p99)
    print(f"arch={cfg.name} capacity={scfg.capacity} "
          f"wire={scfg.compression or 'fp32'} ring={scfg.cache_dtype} "
          f"R={scfg.refresh_every} device={eng.device}")
    print(f"{stats['n_requests']} requests, {n_tok} tokens in {dur:.2f} s "
          f"(virtual) -> {stats['req_per_s']:.1f} req/s, "
          f"{stats['tok_per_s']:.0f} tok/s")
    print(f"p50 {p50:.2f} ms/token | p99 {p99:.2f} ms/token")
    print(f"wire: {up} B up + {down} B down = {(up + down) / n_tok:.1f} "
          f"B/token ({eng.step_up_bytes} B per decode uplink row)")
    print(f"ring: {eng.ring_bytes} B ({scfg.ring_slots} slots x "
          f"{scfg.capacity} lanes x d={cfg.d_model}, {scfg.cache_dtype})")
    print("first request's token ids:", comps[0].tokens[:16])
    return comps, stats, eng


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m",
                    choices=ARCH_IDS + tuple(LATER_ARCH_IDS))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate in req/s (0 = closed "
                         "burst)")
    ap.add_argument("--capacity", type=int, default=8,
                    help="concurrent decode lanes")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-dtype", default="int8",
                    choices=("float32", "bfloat16", "int8", "int4"),
                    help="decode activation ring at-rest storage")
    ap.add_argument("--refresh-every", type=int, default=1,
                    help="uplink cadence R: exchange every R-th decode "
                         "step, serve Party B from the stale ring row in "
                         "between")
    ap.add_argument("--fp32-wire", action="store_true",
                    help="identity uplink codec instead of int8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the arch's full widths (default: reduced)")
    return ap


def check_args(args) -> None:
    """Exit with a message on what the port does not serve."""
    S = args.prompt_len
    if S > L.BLOCKWISE_THRESHOLD and S % L.KV_BLOCK:
        raise SystemExit(
            f"repro_torch.launch.serve: a prompt longer than "
            f"{L.BLOCKWISE_THRESHOLD} tokens takes the blockwise attention "
            f"path and must be a multiple of {L.KV_BLOCK}, got {S}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_args(args)
    try:
        cfg = get_config(args.arch)
    except NotImplementedError as e:      # vlm / audio: slice 7d
        raise SystemExit(f"repro_torch.launch.serve: {e}") from None
    if not args.full:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = vfl.init_all(args.seed, cfg, dev)
    comps, stats, _ = serve_engine(args, cfg, params)
    return comps, stats


if __name__ == "__main__":
    main()
