"""Kernel-contract lint for the hand-written Hopper kernels.

Port of ``repro/analysis/kernel_lint.py``.  Each kernel of
:mod:`repro_torch.kernels` carries a contract the engine relies on:

  * a **plain version** (its oracle) must exist in the wrapper's own
    module, callable: the CPU path and what the card is held to;
  * the wrapper's **operand checks** must accept the call-site geometries
    the engine audits (probed on meta tensors: a refusal is a finding, not
    an engine-time crash) — the counterpart of the reference's grid /
    BlockSpec divisibility;
  * the kernel's **shared memory a block** (the counterpart of the TPU's
    VMEM budget), by the formula its launcher in ``csrc/`` uses, must fit
    the H100's 232,448 B a block, and anything above the default 48 KB
    must be dynamic and opted into by the launcher's
    ``cudaFuncSetAttribute`` (``allow_smem``);
  * the wrapper must take its **abstract branch** at the audited geometry
    (a probe on meta tensors: the reference's ``eval_shape``).

On the card (:func:`lint_card`) the built library's resources are read
with ``cuobjdump -res-usage`` (REG, SHARED, LOCAL of every
``__global__``): REG <= 255, REG x the launch's threads <= 65,536, and
no local memory in the tensor-core attention kernels and K3's; and each
contract's kernel is launched at each geometry against its plain
version.

:func:`lint_kernel_route` restates the reference's
``lint_engine_fusability``: the port's gate has no tiling fallback, so the
promise to check is that the config's gate op is a node of the round's
graph.  The companion check — no narrowing precision cast outside a
declared wire / encode / cache stage — runs in the taint walk
(``taint.py``); its findings share the ``kernel.`` family.
"""
from __future__ import annotations

import importlib
import math
import os
import re
import subprocess
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .report import Finding

# H100 (sm_90): shared memory a block with the opt-in, the default
# static limit, registers a thread and a block
SMEM_BLOCK_MAX = 232448
SMEM_DEFAULT_MAX = 48 * 1024
REG_MAX = 255
REGS_PER_BLOCK = 65536

# the launchers' block sizes (csrc/): threads of one block of each kernel
KERNEL_THREADS = {
    "cosine_gate_kernel": 128, "gate_partials_kernel": 256,
    "gate_apply_kernel": 256, "ring_dequant_kernel": 256,
    "quantize_sr_kernel": 128, "quantize_partials_kernel": 256,
    "quantize_apply_kernel": 256, "fused_adagrad_kernel": 256,
    "fused_adagrad_q8_kernel": 256, "flash_fwd_mma": 128,
    "flash_fwd_f32mma": 128, "flash_bwd_dkv_mma": 128,
    "flash_bwd_dq_mma": 128, "flash_bwd_dkv_f32mma": 128,
    "flash_bwd_dq_f32mma": 128,
}
# the tensor-core attention kernels: no local memory (so no spills)
SPILL_FREE = ("flash_fwd_mma", "flash_fwd_f32mma", "flash_bwd_dkv_mma",
              "flash_bwd_dq_mma", "flash_bwd_dkv_f32mma",
              "flash_bwd_dq_f32mma")
# K3's kernels (csrc/quantize.cu): the narrow path's row held in
# registers, the split-row passes' loads in flight; no local memory either
K3_KERNELS = ("quantize_sr_kernel", "quantize_partials_kernel",
              "quantize_apply_kernel")

# the card's tolerances (``chip_smoke.py``'s): the gates' fp32 sums
# reordered, rows within NEAR of cos ξ excluded; K9's fp32 kernel per
# element against the fp64 plain version
GATE_TOL = 3e-5
NEAR = 1e-6
FLASH_F32_REL, FLASH_F32_ATOL = 2.0 ** -17, 2e-6
COS_XI = 0.5


@dataclass
class Geometry:
    """One audited call-site shape set (engine defaults + stress point)."""
    name: str
    B: int = 64          # batch rows per workset draw
    F: int = 8           # cut-layer width (z_dim)
    W: int = 5           # workset ring depth
    P: int = 4096        # largest flat param block fed to fused_adagrad
    S: int = 2048        # flash-attention sequence length
    H: int = 4           # flash heads
    hd: int = 128        # flash head dim
    T: int = 0           # quantizer tiles; derived from B*F when 0

    def tiles(self, tile: int = 128) -> int:
        n = self.B * self.F
        return self.T or -(-n // tile)


DEFAULT_GEOMETRIES = (
    Geometry("round-default", B=64, F=8),
    Geometry("round-wide", B=4096, F=128),
    Geometry("flash-long", B=2, F=8, S=2048, hd=128),
)


@dataclass
class KernelContract:
    name: str                # the kernel's name (``_cuda.LAUNCHES``)
    module: str              # kernels/<module>.py
    oracle: str              # its plain version, in that module
    # (geometry, device) -> dict of operands
    operands: Callable[[Geometry, str], Dict[str, Any]]
    # (operands) -> None, raising where the wrapper refuses them
    check: Callable[[Dict[str, Any]], None]
    # (operands) -> the wrapper's outputs (the launch on the card)
    kernel: Callable[[Dict[str, Any]], Any]
    # (operands) -> the plain version's outputs
    plain: Callable[[Dict[str, Any]], Any]
    # (geometry) -> {kernel name: (static, dynamic) shared bytes a block}
    smem: Callable[[Geometry], Dict[str, Tuple[int, int]]]
    # (kernel out, plain out, operands) -> (max |err|, ok)
    compare: Callable[[Any, Any, Dict[str, Any]], Tuple[float, bool]]
    source: str = ""         # csrc/<file> of the launcher
    flash: bool = False      # the flash geometry axis


# --------------------------------------------------------------------------
# Operands of each contract at a geometry
# --------------------------------------------------------------------------
def _gen(device):
    import torch
    return torch.Generator(device=device).manual_seed(0)


def _randn(gen, shape, device):
    import torch
    return torch.randn(shape, generator=gen, device=device) \
        if device != "meta" else torch.empty(shape, device="meta")


def _slot(device):
    import torch
    return torch.ones(1, dtype=torch.int32, device=device)


def _gate_ops(g: Geometry, device: str, ring: bool, quant: int = 0):
    import torch
    gen = None if device == "meta" else _gen(device)
    a = _randn(gen, (g.B, g.F), device)
    ops = {"a": a, "slot": _slot(device)}
    shape = (g.W, g.B, g.F) if ring else (g.B, g.F)
    z, dz = _randn(gen, shape, device), _randn(gen, shape, device)
    if ring and device != "meta":
        z[1] = a * (torch.rand((g.B, 1), generator=gen, device=device) * 4
                    - 1) + z[1]
    elif device != "meta":
        z = a * (torch.rand((g.B, 1), generator=gen, device=device) * 4
                 - 1) + z
    if quant:
        from ..kernels import fused_sample as fs
        from ..kernels import quantize as qz

        def enc(r):
            x = r.reshape(g.W * g.B, g.F)
            if device == "meta":
                P = g.F if quant == 8 else g.F // 2
                code = torch.int8 if quant == 8 else torch.uint8
                return (torch.empty((g.W, g.B, P), dtype=code,
                                    device="meta"),
                        torch.empty((g.W, g.B), device="meta"))
            q, sc = qz.quantize_sr_plain(
                x, torch.rand(x.shape, generator=gen, device=device),
                127 if quant == 8 else 7)
            if quant == 4:
                q = fs.pack_nibbles(q)
            return (q.reshape(g.W, g.B, -1).contiguous(),
                    sc.reshape(g.W, g.B).contiguous())
        ops["zq"], ops["zs"] = enc(z)
        ops["dzq"], ops["dzs"] = enc(dz)
    else:
        ops["z"], ops["dz"] = z, dz
    return ops


def _gate_compare(bits: int = 0, ring: bool = True):
    """Weights and cotangent within GATE_TOL of the plain version's, rows
    whose cosine lies within NEAR of cos ξ excluded."""
    def compare(got, want, ops):
        from ..kernels import cosine_weight as cw
        from ..kernels import fused_sample as fs
        thresh = cw.f32_threshold(COS_XI)
        if bits:
            stale = fs.dequant_rows(ops["zq"][1], ops["zs"][1], bits)
        else:
            stale = ops["z"][1] if ring else ops["z"]
        keep = (cw.gate_weights_plain(ops["a"], stale, -2.0)
                - thresh).abs() > NEAR
        (w, cot), (w0, cot0) = got, want
        err = (w - w0).abs()[keep].max().item()
        if cot is not None:
            err = max(err, (cot - cot0).abs()[keep].max().item())
        return err, math.isfinite(err) and err <= GATE_TOL
    return compare


def _gate_smem(g: Geometry):
    """Narrow path: one warp a row, no shared memory; split-row path: the
    block sums' static ``red[3][kSplitThreads / 32]`` floats
    (``csrc/cosine_gate.cu``)."""
    from ..kernels.cosine_weight import gate_chunks
    if gate_chunks(g.B, g.F) == 1:
        return {"cosine_gate_kernel": (0, 0)}
    red = 3 * (256 // 32) * 4
    return {"gate_partials_kernel": (red, 0), "gate_apply_kernel": (0, 0)}


def _bitwise(got, want, ops):
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(((a.float() - b.float()).abs().max().item()
               if a.numel() else 0.0) for a, b in zip(got, want))
    return err, same


def _contracts() -> Tuple[KernelContract, ...]:
    from ..kernels import cosine_weight as cw
    from ..kernels import fused_adagrad as ag
    from ..kernels import fused_sample as fs
    from ..kernels import flash_attention as fa
    from ..kernels import quantize as qz

    def k3_ops(g, device):
        import torch
        T = g.tiles()
        if device == "meta":
            return {"x": torch.empty((T, 128), device="meta"),
                    "u": torch.empty((T, 128), device="meta")}
        gen = _gen(device)
        x = torch.randn((T, 128), generator=gen, device=device) \
            * torch.rand((T, 1), generator=gen, device=device) * 10
        return {"x": x, "u": torch.rand((T, 128), generator=gen,
                                        device=device)}

    def k7_ops(g, device):
        import torch
        gen = None if device == "meta" else _gen(device)
        grad = _randn(gen, (g.P,), device)
        acc = torch.rand((g.P,), generator=gen, device=device) \
            if device != "meta" else torch.empty((g.P,), device="meta")
        return {"grad": grad, "accum": acc}

    def k8_ops(g, device):
        import torch
        R, C = ag.ROWS, ag.BLOCK
        gen = None if device == "meta" else _gen(device)
        if device == "meta":
            q = torch.empty((R, C), dtype=torch.int8, device="meta")
            return {"grad": torch.empty((R * C,), device="meta"), "q": q,
                    "scale": torch.empty((R, 1), device="meta"),
                    "u": torch.empty((R, C), device="meta")}
        q = torch.randint(0, 128, (R, C), generator=gen, device=device,
                          dtype=torch.int8)
        return {"grad": torch.randn((R * C,), generator=gen, device=device),
                "q": q, "scale": torch.rand((R, 1), generator=gen,
                                            device=device) * 1e-2,
                "u": torch.rand((R, C), generator=gen, device=device)}

    def flash_ops(g, device):
        shape = (2, g.S, g.H, g.hd)
        gen = None if device == "meta" else _gen(device)
        return {k: _randn(gen, shape, device) for k in ("q", "k", "v")}

    def flash_compare(got, want, ops):
        exact = fa.flash_attention_plain(
            *(ops[k].double() for k in ("q", "k", "v")), causal=True)
        diff = (got.double() - exact).abs()
        limit = FLASH_F32_REL * exact.abs() + FLASH_F32_ATOL
        err = diff.max().item()
        return err, math.isfinite(err) and bool((diff <= limit).all())

    def flash_smem(g):
        # csrc/flash_attention.cu fwd_f32_smem<HD>: q's three bf16 parts
        # (3 x kM rows), the tile's k and v parts (2 x 3 x f32_tile rows),
        # the next k and v tile in fp32 (2 x f32_tile rows); rows of
        # row_stride = hd + 8 bf16 values, kM = 64
        n = 16 if g.hd == 128 else 32
        stride = g.hd + 8
        return {f"flash_fwd_f32mma<{g.hd}>": (
            0, 3 * (64 + 2 * n) * stride * 2 + 2 * n * g.hd * 4)}

    def k2_cot(ops):
        return cw.cosine_weight_2d(ops["a"], ops["z"], ops["dz"], COS_XI)

    thr = COS_XI
    return (
        KernelContract(
            "cosine_weights_2d", "cosine_weight", "cosine_weights_plain",
            lambda g, d: _gate_ops(g, d, ring=False),
            lambda o: cw.check_rows("cosine_weights_2d", o["a"], o["z"]),
            lambda o: (cw.cosine_weights_2d(o["a"], o["z"], thr), None),
            lambda o: (cw.cosine_weights_plain(o["a"], o["z"], thr), None),
            _gate_smem, _gate_compare(ring=False), "cosine_gate.cu"),
        KernelContract(
            "cosine_weight_2d", "cosine_weight", "cosine_weight_plain",
            lambda g, d: _gate_ops(g, d, ring=False),
            lambda o: cw.check_rows("cosine_weight_2d", o["a"], o["z"],
                                    o["dz"]),
            k2_cot,
            lambda o: cw.cosine_weight_plain(o["a"], o["z"], o["dz"], thr),
            _gate_smem, _gate_compare(ring=False), "cosine_gate.cu"),
        KernelContract(
            "fused_sample_2d", "fused_sample", "fused_sample_plain",
            lambda g, d: _gate_ops(g, d, ring=True),
            lambda o: fs.check_ring(o["slot"], o["a"], o["z"], o["dz"]),
            lambda o: fs.fused_sample_2d(o["slot"], o["a"], o["z"], o["dz"],
                                         thr),
            lambda o: fs.fused_sample_plain(o["slot"], o["a"], o["z"],
                                            o["dz"], thr),
            _gate_smem, _gate_compare(), "cosine_gate.cu"),
        KernelContract(
            "fused_sample_q8_2d", "fused_sample", "fused_sample_quant_plain",
            lambda g, d: _gate_ops(g, d, ring=True, quant=8),
            lambda o: fs.check_quant_ring(8, o["slot"], o["a"], o["zq"],
                                          o["zs"], o["dzq"], o["dzs"]),
            lambda o: fs.fused_sample_q8_2d(o["slot"], o["a"], o["zq"],
                                            o["zs"], o["dzq"], o["dzs"],
                                            thr),
            lambda o: fs.fused_sample_quant_plain(
                8, o["slot"], o["a"], o["zq"], o["zs"], o["dzq"], o["dzs"],
                thr),
            _gate_smem, _gate_compare(bits=8), "cosine_gate.cu"),
        KernelContract(
            "fused_sample_q4_2d", "fused_sample", "fused_sample_quant_plain",
            lambda g, d: _gate_ops(g, d, ring=True, quant=4),
            lambda o: fs.check_quant_ring(4, o["slot"], o["a"], o["zq"],
                                          o["zs"], o["dzq"], o["dzs"]),
            lambda o: fs.fused_sample_q4_2d(o["slot"], o["a"], o["zq"],
                                            o["zs"], o["dzq"], o["dzs"],
                                            thr),
            lambda o: fs.fused_sample_quant_plain(
                4, o["slot"], o["a"], o["zq"], o["zs"], o["dzq"], o["dzs"],
                thr),
            _gate_smem, _gate_compare(bits=4), "cosine_gate.cu"),
        KernelContract(
            "quantize_sr_2d", "quantize", "quantize_sr_plain", k3_ops,
            lambda o: qz.check_operands(o["x"], o["u"]),
            lambda o: qz.quantize_sr_2d(o["x"], o["u"], 127),
            lambda o: qz.quantize_sr_plain(o["x"], o["u"], 127),
            # (T, 128) tiles always take the narrow path: one warp a row,
            # no shared memory
            lambda g: {"quantize_sr_kernel": (0, 0)}, _bitwise,
            "quantize.cu"),
        KernelContract(
            "flash_attention", "flash_attention", "flash_attention_plain",
            flash_ops,
            lambda o: fa.check_operands(o["q"], o["k"], o["v"], 0),
            lambda o: fa.flash_attention(o["q"], o["k"], o["v"],
                                         causal=True),
            lambda o: fa.flash_attention_plain(o["q"], o["k"], o["v"],
                                               causal=True),
            flash_smem, flash_compare, "flash_attention.cu", flash=True),
        KernelContract(
            "fused_adagrad", "fused_adagrad", "fused_adagrad_plain", k7_ops,
            lambda o: ag.check_step_operands([o["grad"]], [o["accum"]]),
            lambda o: ag.fused_adagrad(o["grad"], o["accum"], 0.1, 1e-10),
            lambda o: ag.fused_adagrad_plain(o["grad"], o["accum"], 0.1,
                                             1e-10),
            lambda g: {"fused_adagrad_kernel": (0, 0)}, _bitwise,
            "fused_adagrad.cu"),
        KernelContract(
            "fused_adagrad_q8", "fused_adagrad", "fused_adagrad_q8_plain",
            k8_ops,
            lambda o: ag.check_q8_operands(o["grad"], o["q"], o["scale"],
                                           o["u"]),
            lambda o: ag.fused_adagrad_q8(o["grad"], o["q"], o["scale"],
                                          o["u"], 0.1, 1e-10),
            lambda o: ag.fused_adagrad_q8_plain(o["grad"], o["q"],
                                                o["scale"], o["u"], 0.1,
                                                1e-10),
            # the row maximum's static ``warp_maxes[kThreads / 32]``
            lambda g: {"fused_adagrad_q8_kernel": (4 * 256 // 32, 0)},
            _bitwise, "fused_adagrad.cu"),
    )


# the reference's nine contracts: K2b, K2a, K1, K4, K5, K3, K9, K7, K8
CONTRACTS: Tuple[KernelContract, ...] = _contracts()


def _applies(c: KernelContract, g: Geometry) -> bool:
    # flash has its own geometry axis; round kernels skip it
    return c.flash == g.name.startswith("flash")


def _csrc(name: str) -> str:
    from ..kernels import _cuda
    return (_cuda.CSRC / name).read_text()


def _opts_in(source: str, kernel: str) -> bool:
    """The launcher in ``source`` opts ``kernel`` (a label such as
    ``flash_fwd_f32mma<128>``) into dynamic shared memory above 48 KB."""
    base = kernel.split("<")[0]
    return re.search(rf"allow_smem\(\s*{re.escape(base)}<HD>", source) \
        is not None or re.search(
            rf"cudaFuncSetAttribute\(\s*{re.escape(base)}", source) \
        is not None


def smem_findings(c: KernelContract, g: Geometry, static_of=None
                  ) -> List[Finding]:
    """The shared memory a block of ``c``'s kernels at ``g`` against the
    H100's limits; ``static_of(kernel)`` (the card's SHARED) replaces the
    formula's static part where given."""
    out = []
    src = _csrc(c.source)
    for kernel, (static, dynamic) in c.smem(g).items():
        if static_of is not None:
            got = static_of(kernel)
            static = static if got is None else got
        where = f"kernels/{c.module} {kernel} @ {g.name}"
        if static + dynamic > SMEM_BLOCK_MAX:
            out.append(Finding(
                code="kernel.vmem-budget", severity="error", where=where,
                detail=f"{static} B static + {dynamic} B dynamic shared "
                       f"memory a block exceeds the H100's "
                       f"{SMEM_BLOCK_MAX} B — shrink the tile"))
        if static > SMEM_DEFAULT_MAX:
            out.append(Finding(
                code="kernel.vmem-budget", severity="error", where=where,
                detail=f"{static} B of static shared memory exceeds the "
                       f"{SMEM_DEFAULT_MAX} B a static allocation may "
                       f"take: make it dynamic"))
        if dynamic > SMEM_DEFAULT_MAX and not _opts_in(src, kernel):
            out.append(Finding(
                code="kernel.vmem-budget", severity="error", where=where,
                detail=f"{dynamic} B of dynamic shared memory needs the "
                       f"launcher's cudaFuncSetAttribute(MaxDynamic"
                       f"SharedMemorySize) opt-in, which csrc/{c.source} "
                       f"does not make for this kernel"))
    return out


def lint_kernels(geometries: Sequence[Geometry] = DEFAULT_GEOMETRIES
                 ) -> List[Finding]:
    """The contracts' CPU-side checks: oracle, operand checks, shared
    memory, abstract probe (on meta tensors, nothing launched)."""
    findings: List[Finding] = []
    for c in CONTRACTS:
        # 1. the plain version: the oracle
        mod = importlib.import_module(f"repro_torch.kernels.{c.module}")
        if not callable(getattr(mod, c.oracle, None)):
            findings.append(Finding(
                code="kernel.missing-oracle", severity="error",
                where=f"kernels/{c.module}.py::{c.oracle}",
                detail=f"kernel '{c.name}' has no plain version — the CPU "
                       f"path and the card's comparison both need it"))
            continue
        for g in geometries:
            if not _applies(c, g):
                continue
            where = f"kernels/{c.module} {c.name} @ {g.name}"
            ops = c.operands(g, "meta")
            # 2. the wrapper's operand checks accept the geometry
            try:
                c.check(ops)
            except Exception as e:  # noqa: BLE001 - report, not crash
                findings.append(Finding(
                    code="kernel.grid-divisibility", severity="error",
                    where=where,
                    detail=f"the wrapper's operand checks refuse the "
                           f"audited geometry: {type(e).__name__}: {e}"))
            # 3. shared memory a block
            findings += smem_findings(c, g)
            # 4. the wrapper's abstract branch at the geometry
            try:
                c.kernel(ops)
            except Exception as e:  # noqa: BLE001 - report, not crash
                findings.append(Finding(
                    code="kernel.probe-failed", severity="error",
                    where=where,
                    detail=f"meta-tensor probe raised "
                           f"{type(e).__name__}: {e}"))
    return findings


def lint_kernel_route(trace, celu, case: str) -> List[Finding]:
    """The engine promises its gate kernel (K1 / K4 / K5 by the ring's
    storage form, K2a / K2b unfused): the promise is live iff the gate's
    op is a node of the audited round's graph."""
    if not celu.weighting:
        return []
    if celu.cache_fused:
        want = {"int8": "fused_sample_q8_2d",
                "int4": "fused_sample_q4_2d"}.get(celu.cache_dtype,
                                                  "fused_sample_2d")
        ops = (want,)
    else:
        ops = ("cosine_weight_2d", "cosine_weights_2d")
    have = trace.kernel_names()
    findings = []
    for op in ops:
        name = f"repro_torch::{op}"
        if name not in have:
            findings.append(Finding(
                code="kernel.fused-path-disabled", severity="error",
                where=name,
                detail=f"the {celu.cache_dtype} ring's gate op {name} is not "
                       f"a node of the round's graph: the local updates "
                       f"bypass the kernel the config promises (ops seen: "
                       f"{sorted(have)})", case=case))
    return findings


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
_BUILTINS = {"f": "float", "d": "double", "i": "int", "j": "unsigned",
             "b": "bool", "c": "char", "a": "signed char",
             "h": "unsigned char", "l": "long", "x": "long long",
             "v": "void"}


def _source_name(m: str, i: int) -> Tuple[str, int]:
    n = re.match(r"\d+", m[i:])
    j = i + n.end()
    return m[j:j + int(n.group())], j + int(n.group())


def _substitution(m: str, i: int) -> int:
    """Skip an ``S_`` / ``S<seq>_`` / ``St``-style substitution."""
    if m[i + 1] in "tabsio":
        return i + 2
    return m.index("_", i) + 1


def _nested(m: str, i: int) -> Tuple[str, List[str], int]:
    """``N ... E`` (``i`` past the N) -> (last name, its template
    arguments, index past the E)."""
    name, args = "?", []
    while m[i] != "E":
        if m[i].isdigit():
            name, i = _source_name(m, i)
            args = []
        elif m[i] == "S":
            i = _substitution(m, i)
        elif m[i] == "I":
            args, i = _template_args(m, i + 1)
        else:
            raise ValueError(m[i:])
    return name, args, i + 1


def _template_args(m: str, i: int) -> Tuple[List[str], int]:
    """``I ... E`` (``i`` past the I) -> (arguments, index past the E)."""
    args = []
    while m[i] != "E":
        if m[i] == "L":                       # a literal: L<type><value>E
            end = m.index("E", i)
            args.append(re.sub(r"^L[a-z]", "", m[i:end]).replace("n", "-"))
            i = end + 1
        elif m[i] == "N":
            name, inner, i = _nested(m, i + 1)
            args.append(f"{name}<{','.join(inner)}>" if inner else name)
        elif m[i].isdigit():
            name, i = _source_name(m, i)
            inner = []
            if m[i] == "I":
                inner, i = _template_args(m, i + 1)
            args.append(f"{name}<{','.join(inner)}>" if inner else name)
        elif m[i] == "S":
            i = _substitution(m, i)
            args.append("?")
        elif m[i] in _BUILTINS:
            args.append(_BUILTINS[m[i]])
            i += 1
        else:
            raise ValueError(m[i:])
    return args, i + 1


def demangle(mangled: str) -> str:
    """A kernel's mangled name -> its name and template arguments, e.g.
    ``flash_fwd_f32mma<128>`` or ``cosine_gate_kernel<F32,4>`` (the
    mangled name where it is not a plain or nested function name)."""
    try:
        if mangled.startswith("_ZN"):
            name, args, _ = _nested(mangled, 3)
        elif mangled.startswith("_Z"):
            name, i = _source_name(mangled, 2)
            args = _template_args(mangled, i + 1)[0] \
                if mangled[i:i + 1] == "I" else []
        else:
            return mangled
    except (ValueError, IndexError, AttributeError):
        return mangled
    return f"{name}<{','.join(args)}>" if args else name


def parse_res_usage(text: str) -> Dict[str, Dict[str, int]]:
    """``cuobjdump -res-usage`` output -> {kernel label: {"REG", "STACK",
    "SHARED", "LOCAL"}}.  SHARED is the static shared memory a block plus,
    where there is any, the 1 KB the H100 reserves a block."""
    usage: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s+([^\s:]+)\s*:", line)
        if m:
            cur = label = demangle(m.group(1))
            n = 1
            while cur in usage:        # two kernels demangled alike
                n += 1
                cur = f"{label}#{n}"
            continue
        if cur and "REG:" in line:
            vals = dict((k, int(v)) for k, v in
                        re.findall(r"\b(REG|STACK|SHARED|LOCAL):(\d+)", line))
            usage[cur] = vals
            cur = None
    return usage


def res_usage() -> Dict[str, Dict[str, int]]:
    """The built library's resources (``cuobjdump`` beside ``nvcc``)."""
    from ..kernels import _cuda
    _cuda.build()
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", str(_cuda.library_path())],
                          capture_output=True, text=True, check=True).stdout
    return parse_res_usage(text)


def lint_usage(usage: Dict[str, Dict[str, int]]) -> List[Finding]:
    """REG <= 255 and REG x threads <= 65,536 for every kernel; no local
    memory in :data:`SPILL_FREE` and :data:`K3_KERNELS`; static shared
    memory <= 48 KB."""
    findings = []
    for label, u in sorted(usage.items()):
        base = label.split("<")[0].split("#")[0]
        threads = KERNEL_THREADS.get(base)
        where = f"csrc kernel {label}"
        if threads is None:
            findings.append(Finding(
                code="kernel.unknown-launch", severity="error", where=where,
                detail="a kernel of the library with no block size in "
                       "KERNEL_THREADS: its register budget cannot be "
                       "checked"))
            continue
        reg = u.get("REG", 0)
        if reg > REG_MAX or reg * threads > REGS_PER_BLOCK:
            findings.append(Finding(
                code="kernel.register-budget", severity="error",
                where=where,
                detail=f"{reg} registers a thread x {threads} threads = "
                       f"{reg * threads} (limits {REG_MAX} a thread, "
                       f"{REGS_PER_BLOCK} a block)"))
        if base in SPILL_FREE + K3_KERNELS and u.get("LOCAL", 0):
            findings.append(Finding(
                code="kernel.local-memory", severity="error", where=where,
                detail=f"{u['LOCAL']} B of local memory a thread in a "
                       f"kernel that keeps its values in registers "
                       f"(spills)"))
        if u.get("SHARED", 0) > SMEM_DEFAULT_MAX:
            findings.append(Finding(
                code="kernel.vmem-budget", severity="error", where=where,
                detail=f"{u['SHARED']} B of static shared memory"))
    return findings


def _card_static(usage: Dict[str, Dict[str, int]], kernel: str
                 ) -> Optional[int]:
    """The card's SHARED for ``kernel`` (a label, or a name whose every
    instantiation counts: the largest)."""
    if kernel in usage:
        return usage[kernel].get("SHARED")
    vals = [u.get("SHARED", 0) for k, u in usage.items()
            if k.split("<")[0].split("#")[0] == kernel]
    return max(vals) if vals else None


def lint_card(geometries: Sequence[Geometry] = DEFAULT_GEOMETRIES
              ) -> Tuple[List[Finding], Dict[str, Any]]:
    """The card's half: the library's resources (:func:`lint_usage`, and
    each contract's shared memory with the card's static figure), then
    each contract's kernel launched at each geometry against its plain
    version.  -> (findings, stats)."""
    import torch

    from ..kernels import _cuda
    if not torch.cuda.is_available():
        raise RuntimeError("lint_card needs a CUDA device")
    usage = res_usage()
    findings = lint_usage(usage)
    launched = []
    for c in CONTRACTS:
        for g in geometries:
            if not _applies(c, g):
                continue
            findings += smem_findings(c, g,
                                      lambda k: _card_static(usage, k))
            ops = c.operands(g, "cuda")
            before = _cuda.LAUNCHES[c.name]
            got = c.kernel(ops)
            want = c.plain(ops)
            torch.cuda.synchronize()
            n = _cuda.LAUNCHES[c.name] - before
            err, ok = c.compare(got, want, ops)
            where = f"kernels/{c.module} {c.name} @ {g.name}"
            if n < 1:
                findings.append(Finding(
                    code="kernel.route-not-taken", severity="error",
                    where=where, detail="the wrapper launched no kernel on "
                                        "CUDA tensors"))
            if not ok:
                findings.append(Finding(
                    code="kernel.oracle-mismatch", severity="error",
                    where=where,
                    detail=f"the kernel disagrees with its plain version: "
                           f"max |err| {err}"))
            launched.append({"kernel": c.name, "geometry": g.name,
                             "launches": n, "max_abs_err": err, "ok": ok})
    stats = {"res_usage": {k: dict(v, threads=KERNEL_THREADS.get(
        k.split("<")[0].split("#")[0])) for k, v in usage.items()},
        "launched": launched}
    return findings, stats
