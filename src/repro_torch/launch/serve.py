"""Serving CLI: continuous-batching split-model serving on synthetic
open-loop traffic (port of ``repro/launch/serve.py``).

A thin CLI over :class:`repro_torch.serve.ServeEngine`: it builds the
seeded load (``serve/loadgen.py``, the reference's traffic for one
seed), draws the model's weights from ``--seed``, serves the load through
the fixed-capacity lane array with the compressed uplink and the
quantised decode activation ring, and prints requests/s, tokens/s,
p50/p99 token latency and the exact wire and ring bytes.  The
token-aligned (``fusion="add"``) archs run the engine; the
cross-attention families (vlm / audio) exchange their memory once at
prefill and decode on Party B alone, so they take the sequential
:func:`repro_torch.serve.naive_generate` loop (:func:`serve_naive`), as
in the reference.  It runs on the card unless ``--device cpu`` is given.
llama4-scout-17b-a16e's full widths (216 GB of bf16 parameters) and
llama-3.2-vision-90b's (181.5 GB) do not fit one card: serve them reduced.

  python -m repro_torch.launch.serve --arch smollm-360m --full \\
      --requests 32 --capacity 8 --prompt-len 16 --gen 16
  python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --full \\
      --requests 8 --capacity 4 --prompt-len 4096 --gen 16
  python -m repro_torch.launch.serve --device cpu \\
      --requests 8 --capacity 4 --prompt-len 8 --gen 6
  python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --full \\
      --requests 4 --prompt-len 4096 --gen 16
  python -m repro_torch.launch.serve --arch llama-3.2-vision-90b \\
      --device cpu --requests 2 --prompt-len 8 --gen 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCH_IDS, get_config
from ..models import layers as L
from ..models import vfl
from ..serve import (LoadSpec, ServeConfig, ServeEngine, make_naive_fns,
                     naive_generate, synth_requests)


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


def naive_batch(cfg, prompt_len: int, seed: int, device):
    """The one request :func:`serve_naive` serves, drawn as the reference
    draws it (B = 1): prompt tokens, then the patch embeddings (vlm) or
    ``prompt_len`` frame embeddings (audio), from
    ``np.random.default_rng(seed)``."""
    B, S = 1, prompt_len
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32).astype(np.int64)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_frontend)).astype(np.float32)
    else:
        batch["frames"] = rng.normal(
            size=(B, S, cfg.d_frontend)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def serve_naive(args, cfg, params):
    """The sequential loop for the cross-attention families: the memory
    crosses once at prefill, decode is Party B's alone.  One warm call,
    then ``--requests`` timed generations of one request (B = 1).  ->
    (the last generation's tokens (1, gen), stats: ``walls`` (s a
    request), ``tok_per_s``, ``ms_per_token``)."""
    dev = params["b"]["embed"].device
    S = args.prompt_len
    fns = make_naive_fns(cfg, S + args.gen)
    batch = naive_batch(cfg, S, args.seed, dev)
    naive_generate(params, cfg, batch, args.gen, fns=fns).cpu()   # warm
    walls = []
    toks = None
    for _ in range(args.requests):
        t0 = time.perf_counter()
        toks = naive_generate(params, cfg, batch, args.gen, fns=fns).cpu()
        walls.append(time.perf_counter() - t0)
    total = sum(walls)
    stats = {"walls": walls,
             "tok_per_s": args.requests * args.gen / total,
             "ms_per_token": total / args.requests / args.gen * 1e3}
    print(f"arch={cfg.name} ({cfg.family}): cross-attn family — memory "
          f"crosses once at prefill; sequential naive_generate loop; "
          f"device={dev}")
    print(f"{args.requests} requests x {args.gen} tokens in {total:.2f} s "
          f"-> {stats['tok_per_s']:.0f} tok/s, "
          f"{stats['ms_per_token']:.1f} ms/token")
    print("generated token ids (first request):", toks.numpy()[0][:16])
    return toks, stats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m",
                    choices=ARCH_IDS)
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
    """-> (completions, stats) of the engine, or (tokens, stats) of
    :func:`serve_naive` for a cross-attention family."""
    args = build_parser().parse_args(argv)
    check_args(args)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = vfl.init_all(args.seed, cfg, dev)
    if cfg.vfl_split.fusion != "add":
        return serve_naive(args, cfg, params)
    comps, stats, _ = serve_engine(args, cfg, params)
    return comps, stats


if __name__ == "__main__":
    main()
