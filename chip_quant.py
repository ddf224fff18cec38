#!/usr/bin/env python3
"""K3 (the stochastic-rounding quantiser) and K6 / K11 (the ring
dequantiser) timed for one or more checkouts of the repository in turns,
on one NVIDIA GPU.

    python3 chip_quant.py [TREE ...]     # default: this checkout

Each TREE (a directory holding ``src/repro_torch`` and ``chip_smoke.py``,
e.g. a commit unpacked with ``git archive``) runs in a process of its
own, in the order given: to compare two commits give them as parent,
change, change, parent.  A run times, at levels 127 and with the same
seeded inputs in every tree:

  * K3 at the WDL insert's (256, 256), the wire's (512, 128), the
    serving insert's (8, 960), the LLM twin's cut tensor (2, 61,440) and
    the 4,096-token one (2, 3,932,160): on fp32 rows ("fp32"); on bf16
    rows as the quantised workset's insert hands them over
    (``kernels/ops.quantize_stochastic``: a checkout whose K3 takes fp32
    rows only widens them there first, and that cast is timed with it;
    "bf16"); and on the bf16 rows' fp32 copy made beforehand ("bf16,
    cast excluded");
  * K6 and K11 at the serving ring (W, C, F) = (4, 8, 960);
  * the launch floor, K2b at one row of 8 values.

Each time is device µs a call (a CUDA graph of calls, CUDA events:
``chip_smoke.device_ms``) beside the host µs a call from Python
(``chip_smoke.call_ms``) and the bound (bytes read once and written once
over 3.35 TB/s).  Prints the card's name and power limit, one JSON line
per tree and case, then a table (``chip_rounds.in_turns``).
"""
from __future__ import annotations

from chip_rounds import in_turns

K3_SHAPES = ((256, 256), (512, 128), (8, 960), (2, 61_440),
             (2, 3_932_160))
RING = (4, 8, 960)
RUN = r"""
import json, sys, torch
sys.path.insert(0, "src")
import chip_smoke as cs
from repro_torch.kernels import cosine_weight as cw
from repro_torch.kernels import fused_sample as fs
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz
from repro_torch.core.workset import pack_nibbles


def row(case, shape, fn, nbytes):
    print("ROW " + json.dumps({
        "case": case, "shape": list(shape), "us": cs.device_ms(torch, fn)
        * 1e3, "host_us": cs.call_ms(torch, fn) * 1e3,
        "bound_us": nbytes / cs.PEAK_BYTES_PER_S * 1e6,
        "device": torch.cuda.get_device_name(0)}), flush=True)


gen = torch.Generator(device="cuda").manual_seed(11)
a, z = (torch.randn((1, 8), generator=gen, device="cuda") for _ in range(2))
row("floor", (1, 8), lambda: cw.cosine_weights_2d(a, z, 0.5), 8 * 8 + 4)
for T, L in @SHAPES@:
    x = torch.randn((T, L), generator=gen, device="cuda") \
        * torch.rand((T, 1), generator=gen, device="cuda") * 10
    u = torch.rand((T, L), generator=gen, device="cuda")
    xb = x.to(torch.bfloat16)
    xw = xb.float()
    for case, xs, fn in (
            ("K3 fp32", x, lambda: qz.quantize_sr_2d(x, u, 127)),
            ("K3 bf16", xb, lambda: ops.quantize_stochastic(xb, u, 127)),
            ("K3 bf16, cast excluded", xb,
             lambda: qz.quantize_sr_2d(xw, u, 127))):
        row(case, (T, L), fn, T * L * (xs.element_size() + 5) + 4 * T)
W, C, F = @RING@
slot = torch.tensor([2], dtype=torch.int32, device="cuda")
for bits, name, kern in ((8, "K6", fs.fused_dequant_q8_2d),
                         (4, "K11", fs.fused_dequant_q4_2d)):
    x = torch.randn((W * C, F), generator=gen, device="cuda")
    q, sc = qz.quantize_sr_plain(
        x, torch.rand(x.shape, generator=gen, device="cuda"),
        127 if bits == 8 else 7)
    q = (pack_nibbles(q) if bits == 4 else q).reshape(W, C, -1).contiguous()
    sc = sc.reshape(W, C).contiguous()
    row(name, (W, C, F), lambda: kern(slot, q, sc),
        q[0].numel() + 4 * C + 4 * C * F + 4)
"""


def main() -> None:
    in_turns("chip_quant", RUN.replace("@SHAPES@", repr(K3_SHAPES))
             .replace("@RING@", repr(RING)), "chip_smoke.py",
             lambda row, card: (
                 f"[quant] {row['tree']:>16s} {row['case']:24s} "
                 f"{str(tuple(row['shape'])):18s} {row['us']:9.2f} us "
                 f"(bound {row['bound_us']:.3f} us); host "
                 f"{row['host_us']:.2f} us a call; {card}"), 600)


if __name__ == "__main__":
    main()
