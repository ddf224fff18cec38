#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, is right and starts.

    python3 chip_smoke.py

Phases, each on its own printed lines (any failure exits non-zero):

  1. the card: name and power limit; TF32 off for matmuls and cuDNN;
  2. the build of the CUDA kernels from ``src/repro_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card (K1 full
     and weights-only, K2a, K2b) at the main path's shape, at an odd batch
     and narrow rows, and at a wide F that runs the chunk loop; times
     from CUDA events beside the least time the card could take;
  4. the golden traces (``tests/golden``) replayed on the card from the
     reference's initial parameters, held to the tests' tolerance;
  5. the main path: ``repro_torch.launch.train`` at WDL-Criteo's full
     width (B = 256, R = W = 5, celu) with the kernels' launch counts,
     DSSM-Avazu, the ``--no-cache-fusion`` path (K2), five full-width
     rounds on the card against the CPU, and ms per round and per local
     step;
  6. a JSON line of per-kernel results, then the last line
     ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when no CUDA device is present or
when it is not run from a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12           # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = 3e-5                 # fp32 sums of up to 61,440 terms reordered
NEAR = 1e-6                       # rows this close to cos ξ may flip
# Loss over 5 full-width rounds, card against CPU: this comparison reads
# 3.1e-4 at round 5 on an H100 (PERF.md), so the limit is about 3x that.
# (AdaGrad's first steps move every coordinate by ±lr whatever its
# gradient's size, so rounding in near-zero gradients flips whole steps
# and the two part after round 5.)  A gate that zeroed every weight moves
# the loss by 3.3e-2 by round 3.
CPU_CUDA_RTOL = 1e-3
SHAPES = [(5, 256, 256), (2, 37, 8), (2, 37, 13), (2, 64, 64 * 960)]
MAIN_SHAPE = (5, 256, 256)
REPLACES = {
    "fused_sample_2d": "src/repro/kernels/fused_sample.py:125",
    "cosine_weight_2d": "src/repro/kernels/cosine_weight.py:80",
    "cosine_weights_2d": "src/repro/kernels/cosine_weight.py:56",
}
SOURCE = "src/repro_torch/csrc/cosine_gate.cu"
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _events_ms(torch, run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(torch, fn, iters: int = 200) -> float:
    """ms per call issued from Python back to back (CUDA events): what the
    round pays, host launch cost included."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    return _events_ms(torch, fn, iters)


def device_ms(torch, fn, iters: int = 50) -> float:
    """ms per call on the card alone: ``iters`` calls captured in a CUDA
    graph and replayed (CUDA events), so no host launch cost is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(torch, graph.replay, 5) / iters


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------
def phase_kernels(torch):
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.kernels import cosine_weight as cw
    from repro_torch.kernels import fused_sample as fs

    cos_xi = xi_to_cos(60.0)
    thresh = cw.f32_threshold(cos_xi)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {k: {"max_abs_err": 0.0} for k in REPLACES}
    for (W, B, F) in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            a = randn(B, F)
            z = randn(W, B, F)
            z[1] = a * (torch.rand((B, 1), generator=gen, device="cuda")
                        * 4 - 1) + z[1]
            z = z.to(dtype)
            dz = randn(W, B, F).to(dtype)
            slot = torch.tensor([1], dtype=torch.int32, device="cuda")
            z1, dz1 = z[1].contiguous(), dz[1].contiguous()
            cos = cw.gate_weights_plain(a, z1, -2.0)
            cos_dz = cw.gate_weights_plain(a, dz1, -2.0)
            keep = (cos - thresh).abs() > NEAR
            keep_dz = (cos_dz - thresh).abs() > NEAR
            s = F * z.element_size()
            base = 4 * B * F + 4 * B             # ad_hoc read, w written
            cases = {
                "fused_sample_2d": (
                    lambda: fs.fused_sample_2d(slot, a, z, dz, cos_xi),
                    lambda: fs.fused_sample_plain(slot, a, z, dz, cos_xi),
                    keep, base + 2 * B * s + 4 * B * F + 4, 7 * B * F),
                "fused_sample_2d weights-only": (
                    lambda: fs.fused_sample_2d(slot, a, dz, None, cos_xi),
                    lambda: fs.fused_sample_plain(slot, a, dz, None, cos_xi),
                    keep_dz, base + B * s + 4, 6 * B * F),
                "cosine_weight_2d": (
                    lambda: cw.cosine_weight_2d(a, z1, dz1, cos_xi),
                    lambda: cw.cosine_weight_plain(a, z1, dz1, cos_xi),
                    keep, base + 2 * B * s + 4 * B * F, 7 * B * F),
                "cosine_weights_2d": (
                    lambda: (cw.cosine_weights_2d(a, z1, cos_xi), None),
                    lambda: (cw.cosine_weights_plain(a, z1, cos_xi), None),
                    keep, base + B * s, 6 * B * F),
            }
            for name, (kern, plain, rows, nbytes, flops) in cases.items():
                (w, cot), (w0, cot0) = kern(), plain()
                torch.cuda.synchronize()
                err = (w - w0).abs()[rows].max().item()
                if cot is not None:
                    err = max(err, (cot - cot0).abs()[rows].max().item())
                check(math.isfinite(err) and err <= KERNEL_TOL,
                      f"{name} at {(W, B, F)} {dtype}: max |err| {err}")
                key = name.split()[0]
                results[key]["max_abs_err"] = max(
                    results[key]["max_abs_err"], err)
                ms = device_ms(torch, kern)
                plain_ms = device_ms(torch, plain)
                call = call_ms(torch, kern)
                bound_ms, bound_by = bound(nbytes, flops)
                print(f"[kernel] {name:30s} W,B,F={W},{B},{F} "
                      f"{str(dtype)[6:]:8s} max|err| {err:.3g}  device: "
                      f"kernel {ms * 1e3:.2f} us  plain {plain_ms * 1e3:.2f}"
                      f" us  bound {bound_ms * 1e3:.3f} us ({bound_by}); "
                      f"per call from Python {call * 1e3:.2f} us",
                      flush=True)
                if (W, B, F) == MAIN_SHAPE and dtype == torch.float32 \
                        and name in REPLACES:
                    results[name].update(ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms,
                                         bound_by=bound_by)
    return results


def phase_goldens(torch):
    from repro_torch import golden
    params = golden.load_params(GOLDEN_DIR)
    two = golden.load_golden(GOLDEN_DIR, "two_party_trace.json")
    runs = [(p, True) for p in ("vanilla", "fedbcd", "celu")]
    runs.append(("celu", False))
    for protocol, fused in runs:
        got = golden.two_party_trace(protocol, params, device="cuda",
                                     cache_fused=fused)
        dev = golden.compare(got, two[protocol])
        print(f"[golden] two-party {protocol:7s} cache_fused={fused}: "
              f"{dev}", flush=True)
        check(golden.within_tolerance(dev), f"golden {protocol} {dev}")
    got = golden.three_party_trace(params, device="cuda")
    dev = golden.compare(got, golden.load_golden(
        GOLDEN_DIR, "three_party_trace.json")["celu"])
    print(f"[golden] three-party celu cache_fused=True: {dev}", flush=True)
    check(golden.within_tolerance(dev), f"golden three-party {dev}")


def train_args(arch, protocol="celu", rounds=50, device=None, **kw):
    from repro_torch.launch.train import build_parser
    argv = ["--arch", arch, "--protocol", protocol, "--rounds", str(rounds)]
    if device:
        argv += ["--device", device]
    args = build_parser().parse_args(argv)
    return SimpleNamespace(**{**vars(args), **kw})


def phase_main_path(torch, card):
    from repro_torch.kernels import _cuda
    from repro_torch.launch.train import train_dlrm

    R = 5
    counts = {}
    # WDL-Criteo at full width, the default fused ring sample (K1)
    rounds = 50
    _cuda.reset_launches()
    wdl = train_dlrm(train_args("wdl-criteo", rounds=rounds))
    counts["fused_sample_2d"] = _cuda.LAUNCHES["fused_sample_2d"]
    print(f"[main] wdl-criteo celu {rounds} rounds: launches "
          f"{dict(_cuda.LAUNCHES)}", flush=True)
    check(math.isfinite(wdl["final_loss"]), "wdl loss not finite")
    check(_cuda.LAUNCHES["fused_sample_2d"] == 2 * R * rounds,
          f"K1 launched {_cuda.LAUNCHES['fused_sample_2d']} times, "
          f"want 2·R per round = {2 * R * rounds}")
    check(_cuda.LAUNCHES["cosine_weight_2d"] == 0
          and _cuda.LAUNCHES["cosine_weights_2d"] == 0,
          "K2 launched on the fused path")

    _cuda.reset_launches()
    dssm = train_dlrm(train_args("dssm-avazu", rounds=5))
    print(f"[main] dssm-avazu celu 5 rounds: launches "
          f"{dict(_cuda.LAUNCHES)}", flush=True)
    check(math.isfinite(dssm["final_loss"]), "dssm loss not finite")
    check(_cuda.LAUNCHES["fused_sample_2d"] == 2 * R * 5, "dssm K1 count")

    # the materialising path: K2a for Party A, K2b for Party B
    _cuda.reset_launches()
    unfused = train_dlrm(train_args("wdl-criteo", rounds=5,
                                    no_cache_fusion=True))
    counts["cosine_weight_2d"] = _cuda.LAUNCHES["cosine_weight_2d"]
    counts["cosine_weights_2d"] = _cuda.LAUNCHES["cosine_weights_2d"]
    print(f"[main] wdl-criteo celu --no-cache-fusion 5 rounds: launches "
          f"{dict(_cuda.LAUNCHES)}", flush=True)
    check(math.isfinite(unfused["final_loss"]), "unfused loss not finite")
    check(_cuda.LAUNCHES["cosine_weight_2d"] == R * 5
          and _cuda.LAUNCHES["cosine_weights_2d"] == R * 5
          and _cuda.LAUNCHES["fused_sample_2d"] == 0,
          f"K2a/K2b counts {dict(_cuda.LAUNCHES)}, want R per round each")

    # five full-width rounds on the card against the CPU
    gpu5 = train_dlrm(train_args("wdl-criteo", rounds=5))
    cpu5 = train_dlrm(train_args("wdl-criteo", rounds=5, device="cpu"))
    check([g[0] for g in gpu5["history"]] == [2, 3, 4, 5]
          and [c[0] for c in cpu5["history"]] == [2, 3, 4, 5],
          "cuda vs cpu: rounds 2-5 not all recorded")
    devs = [abs(g[1] - c[1]) / abs(c[1])
            for g, c in zip(gpu5["history"], cpu5["history"])]
    print(f"[main] 5 full-width rounds cuda vs cpu: loss rel dev per round "
          f"2-5 {[float(f'{d:.3g}') for d in devs]} (tolerance "
          f"{CPU_CUDA_RTOL})", flush=True)
    check(max(devs) <= CPU_CUDA_RTOL, f"cuda vs cpu loss deviation {devs}")

    # time: the celu round against the vanilla round (no local updates)
    vanilla = train_dlrm(train_args("wdl-criteo", protocol="vanilla",
                                    rounds=20))
    round_ms = wdl["steady_round_ms"]
    local_ms = (round_ms - vanilla["steady_round_ms"]) / R
    print(f"[time] wdl-criteo full width B=256 R=W=5 celu: "
          f"{round_ms:.3f} ms per round, vanilla "
          f"{vanilla['steady_round_ms']:.3f} ms per round, so "
          f"{local_ms:.3f} ms per local step (both parties); card {card}",
          flush=True)

    # the card's busy time per round, from a profiled run (the profiler
    # slows the host, not the kernels)
    from torch.profiler import ProfilerActivity, profile
    rounds = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_dlrm(train_args("wdl-criteo", rounds=rounds))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / rounds
    print(f"[time] device busy {busy_ms:.3f} ms per round "
          f"({len(kernels) / rounds:.0f} kernels per round, evaluation "
          f"included) = {100 * busy_ms / round_ms:.1f}% of the "
          f"{round_ms:.3f} ms round; card {card}", flush=True)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    for e in top[:8]:
        print(f"[time]   {e.self_device_time_total / 1e3 / rounds:8.3f} ms "
              f"per round  {e.count / rounds:6.1f} calls  {e.key[:70]}")
    return counts


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"run from a checkout of the repository: {SRC}/repro_torch "
             f"is missing")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, SRC)

    # 1. the card
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. the build
    from repro_torch.kernels import _cuda
    info = _cuda.build()
    _cuda.lib()
    print(f"[build] {info['path']} in {info['seconds']:.2f} s", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # 3.-5.
    t0 = time.perf_counter()
    kernels = phase_kernels(torch)
    print(f"[phase] kernels {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_goldens(torch)
    print(f"[phase] goldens {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    counts = phase_main_path(torch, card)
    print(f"[phase] main path {time.perf_counter() - t0:.1f} s", flush=True)

    # 6. results
    rows = []
    for name, r in kernels.items():
        check(counts.get(name, 0) > 0, f"{name} never launched on its path")
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name], "launches": counts[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
