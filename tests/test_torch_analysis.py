"""The port's boundary auditor (``src/repro_torch/analysis``) on the CPU.

Mirrors ``tests/test_analysis.py`` (marker transparency, the taint
lattice, a clean audit over the quick matrix, the fleet, serve and pod
cases, report serialization and every seeded mutation caught, naming the
offender), and adds: a marked round is bitwise the unmarked one; the
serving step's graph holds the K3 and K6 nodes; the pod round over two
gloo ranks makes no data call but its two marked permutes; the
``cuobjdump -res-usage`` parser; and parity with the reference auditor —
for each quick case and for the fleet and serve cases, the port's
boundary count per direction and its measured / claimed / reported bytes
per direction and party equal the reference's, with no error finding on
either side.
"""
import ast
import contextlib
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import audit as A
from repro_torch.analysis.kernel_lint import (demangle, lint_kernels,
                                              lint_usage, parse_res_usage)
from repro_torch.analysis.markers import (boundary_order,
                                          boundary_requirements,
                                          instrumented, mark)
from repro_torch.analysis.report import AuditReport, CaseResult, Finding
from repro_torch.analysis.taint import (EMPTY, BoundaryRecord, TraceAudit,
                                        join, raw_of, sanitize)
from repro_torch.configs.base import CELUConfig
from repro_torch.core.engine import (CompressedWANTransport,
                                     SimWANTransport, make_transport)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def quick_report():
    return A.run_audit(A.default_cases(quick=True), include_pod=False)


@pytest.fixture(scope="module")
def selftest_results():
    from repro_torch.analysis.selftest import run_selftest
    return run_selftest()


# --------------------------------------------------------------------------
# markers
# --------------------------------------------------------------------------
def test_mark_is_identity():
    x = torch.arange(12.0).reshape(3, 4)
    y = mark({"a": x, "b": [x + 1]}, role="sanitizer", name="wire")
    assert torch.equal(y["a"], x)
    assert torch.equal(y["b"][0], x + 1)


def test_mark_is_identity_under_trace_and_vmap():
    from torch.fx.experimental.proxy_tensor import make_fx

    def f(x):
        return mark(x, role="sanitizer", name="wire") * 2.0

    gm = make_fx(f)(torch.ones(4))
    assert torch.equal(gm(torch.ones(4)), 2.0 * torch.ones(4))
    marks = [n for n in gm.graph.nodes
             if n.target is torch.ops.repro_torch_audit.mark.default]
    assert len(marks) == 1
    xs = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(torch.func.vmap(f)(xs), 2.0 * xs)
    x = torch.ones(4, requires_grad=True)
    f(x).sum().backward()
    assert torch.equal(x.grad, 2.0 * torch.ones(4))


def test_boundary_requirements_per_transport():
    celu = CELUConfig()
    assert boundary_requirements(SimWANTransport(celu), celu, "up") == \
        ("wire",)
    dp = CELUConfig(dp_sigma=0.3)
    assert boundary_requirements(SimWANTransport(dp), dp, "up") == \
        ("wire", "dp")
    tp = make_transport(CELUConfig(compression="int8"))
    assert boundary_requirements(tp, CELUConfig(compression="int8"),
                                 "up") == ("wire", "encode")
    dp_tp = make_transport(CELUConfig(compression="int8", dp_sigma=0.3))
    cfg = CELUConfig(compression="int8", dp_sigma=0.3)
    assert boundary_requirements(dp_tp, cfg, "up") == \
        ("wire", "encode", "dp")
    # ordering constraint only exists for DP over a LOSSY codec
    assert boundary_order(dp_tp, cfg, "up") == (("encode", "dp"),)
    assert boundary_order(tp, CELUConfig(compression="int8"), "up") == ()
    ident = make_transport(CELUConfig(compression="identity",
                                      dp_sigma=0.3))
    assert isinstance(ident, CompressedWANTransport)
    assert boundary_order(ident, CELUConfig(compression="identity",
                                            dp_sigma=0.3), "up") == ()


def test_marked_round_is_bitwise_the_unmarked_one():
    """One real round (the production route) with every mark in place —
    the boundary proxy and the instrumented sanitizers — against the same
    round without them, from the same seed: every state tensor and
    metric bitwise equal."""
    from repro_torch.core.uniforms import GeneratorUniforms
    from repro_torch.fleet.runner import flatten
    case = A.AuditCase(name="bitwise", depth=2, compression="topk_int8",
                       cache_dtype="int8", dp_sigma=0.3)
    runs = []
    for audited in (True, False):
        b = A.build_case(case, functional=False, audited=audited,
                         uniforms=GeneratorUniforms(0, "cpu"))
        with instrumented() if audited else contextlib.nullcontext():
            state, m = b["fn"](b["state"], b["batches_a"], b["batch_b"], 3)
        runs.append((flatten(state)[0], m))
    (sa, ma), (sb, mb) = runs
    assert len(sa) == len(sb) > 10
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert np.isfinite(float(ma["loss"]))


# --------------------------------------------------------------------------
# taint lattice
# --------------------------------------------------------------------------
def test_taint_join_unions_raw_and_intersects_san():
    a = sanitize(raw_of("a0"), "wire", 3)
    b = sanitize(sanitize(raw_of("b"), "wire", 5), "encode", 7)
    j = join([a, b])
    assert j.raw == frozenset({"a0", "b"})
    assert j.san_names == frozenset({"wire"})       # encode not shared
    assert j.san_idx("wire") == 3                   # earliest application


def test_taint_join_untainted_inputs_do_not_constrain():
    t = sanitize(raw_of("a0"), "dp", 2)
    j = join([t, EMPTY])
    assert j.san_names == frozenset({"dp"})
    assert join([EMPTY, EMPTY]) == EMPTY


def test_taint_is_hashable_and_frozen():
    t = sanitize(raw_of("a0"), "wire", 1)
    assert isinstance(hash(t), int)
    with pytest.raises(Exception):
        t.raw = frozenset()


def test_host_rule_reads_the_write_backs_and_casts():
    """A state hosted at B written in place from A's raw value, and a
    narrowing cast outside any declared stage, are both caught: the
    write-back comes out of functionalization as ``copy_`` into B's
    input, whose host tag the walker applies."""
    from repro_torch.analysis.taint import OutTag, audit_trace

    def f(x_a, w_b, y_b):
        w_b.add_(x_a.sum())
        return [y_b.to(torch.bfloat16).float() * 2.0]

    gm = A.trace_graph(f, [torch.ones(3), torch.zeros(2), torch.ones(2)])
    hosts = [OutTag(frozenset({"a0"}), "x_a"),
             OutTag(frozenset({"b"}), "w_b"),
             OutTag(frozenset({"b"}), "y_b")]
    trace = audit_trace(gm.graph, [raw_of("a0"), raw_of("b"), raw_of("b")],
                        [OutTag(frozenset({"b"}), "out")], hosts)
    got = sorted((f.code, f.where) for f in trace.findings)
    assert got == [("kernel.unmediated-cast", "out"),
                   ("taint.foreign-raw-output", "w_b")]


# --------------------------------------------------------------------------
# clean audits
# --------------------------------------------------------------------------
def test_quick_matrix_is_clean(quick_report):
    rep = quick_report
    assert rep.passed, rep.render(verbose=True)
    names = [c.name for c in rep.cases]
    assert names[0] == "kernel-contracts"
    assert [c.name for c in A.default_cases(quick=True)] == names[1:6]
    # positive assurance: every engine case's graph held boundary marks
    # and its promised gate op, or the audit proved nothing
    for c in rep.cases[1:6]:
        cfg = A.make_celu(A.AuditCase(**c.config))
        assert c.stats["boundaries"] >= 2, c.name
        assert f"repro_torch::{A.promised_gate(cfg)}" in \
            c.stats["kernel_op_names"], c.name
    # the card-only checks are reported, not skipped in silence
    infos = [f.code for f in rep.findings if f.severity == "info"]
    assert infos.count("kernel.card-only") == 2


def test_full_matrix_has_the_reference_cases():
    from repro.analysis.audit import default_cases as ref_cases
    assert [c.name for c in A.default_cases()] == \
        [c.name for c in ref_cases()]
    assert len(A.default_cases()) == 39


def test_depth_queue_case_audits_two_chained_dispatches():
    r = A.trace_case(A.AuditCase(name="d4", K=2, depth=4,
                                 compression="topk_int8",
                                 cache_dtype="int8", dp_sigma=0.3))
    assert not r.errors, [f.detail for f in r.errors]
    # 2 parties x (up + down) x 2 chained exchange dispatches
    assert r.stats["boundaries"] == 8


def test_fleet_case_audits_batched_state_clean():
    """The vmapped fleet step (jobs stacked on a leading axis) passes the
    same taint / ordering / byte-ledger analyses, with ONE boundary mark
    per direction whose value carries the job axis."""
    r = A.trace_fleet_case(jobs=3)
    assert not r.errors, [f.detail for f in r.errors]
    assert r.config["jobs"] == 3
    assert r.stats["boundaries"] == 2
    assert r.stats["jobs"] == 3
    # the gate op ran once a job (its CPU rule), K3 once for the jobs
    assert "repro_torch::fused_sample_q8_2d" in r.stats["kernel_op_names"]
    assert r.stats["kernel_ops"] > 0


def test_vmapped_fleet_takes_a_topk_wire():
    """The fleet case found that the vmapped step refused every top-k
    codec (an in-place index write of batched values into unbatched
    zeros in ``TopKCodec.decode``).  Two jobs of one spec over a top-k +
    int8 wire at depth 2, three steps: each lane bitwise the other, and
    each within float32 reduction order of its job's scalar step."""
    from repro_torch.core import engine as E
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.fleet.runner import _stack_states, _vmapped, unflatten
    from repro_torch.fleet.scheduler import JobHyper, make_fleet_step
    from repro_torch.optim import make_optimizer
    case = A.AuditCase(name="topk-fleet", depth=2, compression="topk_int8",
                       cache_dtype="int8")
    celu = A.make_celu(case)
    tp = make_transport(celu)
    cos = float(xi_to_cos(celu.xi_degrees))

    def fresh():
        task, params, ba, bb = A.toy_task(1)
        st = E.init_state(task, params, make_optimizer("adagrad", 0.1),
                          celu, ba, bb, transport=tp,
                          uniforms=A.ConstUniforms())
        init, step, _ = make_fleet_step(task, celu, depth=2, transport=tp)
        return init(st), step, ba, bb
    fs, step, ba, bb = fresh()
    leaves, spec = _stack_states([fs, fs])
    run = _vmapped(step, 2)
    scalar, _, _, _ = fresh()
    for t in range(3):
        leaves, spec, m = run(leaves, spec, torch.full((2,), 0.1),
                              torch.full((2,), cos),
                              [A.ConstUniforms()] * 2, ba, bb, t)
        with torch.no_grad():
            scalar, ms = step(scalar, JobHyper(0.1, cos), ba, bb, t)
    assert torch.equal(m["loss"][0], m["loss"][1])
    got = unflatten(spec, leaves).state["params"]["a"][0].tensors
    want = E._params(scalar.state["params"]["a"][0])
    for g, w in zip(got, want):
        assert torch.equal(g[0], g[1])
        torch.testing.assert_close(g[0], w, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(m["loss"][0], ms["loss"], rtol=1e-4,
                               atol=1e-6)


def test_fleet_case_boundary_shapes_carry_job_axis():
    """audit_wire(jobs=N) must reject a boundary whose value LOST the job
    axis."""
    from repro_torch.analysis.wire_audit import audit_wire
    celu = CELUConfig()
    tp = make_transport(celu)
    trace = TraceAudit(case="shape-probe")
    for i, d in enumerate(("up", "down")):
        trace.boundaries[i] = BoundaryRecord(
            direction=d, party=0, transport="SimWANTransport",
            shape=(A.AUDIT_B, A.AUDIT_Z), dtype="float32", satisfied=True)
    findings, _ = audit_wire(tp, celu, [(A.AUDIT_B, A.AUDIT_Z)], trace,
                             n_computes=1, case="shape-probe", jobs=3)
    shape_errs = [f for f in findings if f.code == "wire.boundary-shape"]
    assert len(shape_errs) == 2, [f.detail for f in findings]


def test_pod_case_two_ranks_only_marked_permutes():
    r = A.trace_pod_case()
    assert not r.errors, [f.detail for f in r.errors]
    assert r.stats["boundaries"] == 2
    # one batch_isend_irecv a boundary, no other torch.distributed call
    assert r.stats["data_calls"] == [2, 2]


def test_pod_recorder_covers_p2p_and_object_calls():
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    for name in ("isend", "irecv", "send_object_list", "recv_object_list",
                 "broadcast_object_list", "all_gather_object",
                 "gather_object", "scatter_object_list"):
        assert name in A._DATA_CALLS, name
    calls = []
    with A.recording_data_calls(calls):
        # P2POp takes only c10d's own isend / irecv: both names are the
        # recorder's, so a transport's P2POp still builds
        assert dist.isend is c10d.isend and dist.irecv is c10d.irecv
        with pytest.raises((RuntimeError, ValueError)):
            dist.isend(torch.zeros(2), 1)       # no process group here
        with pytest.raises((RuntimeError, ValueError)):
            dist.send_object_list([torch.zeros(2)], dst=1)
    assert [c["call"] for c in calls] == ["isend", "send_object_list"]
    assert dist.isend is not c10d.send and dist.isend.__name__ == "isend"


def test_serve_case_holds_k3_and_k6_nodes(quick_report):
    (r,) = [c for c in quick_report.cases if c.name == A.SERVE_NAME]
    assert not r.errors
    assert r.stats["uplink_marks"] == 1 and r.stats["downlink_marks"] == 1
    assert {"repro_torch::quantize_sr_2d",
            "repro_torch::fused_dequant_q8_2d"} <= \
        set(r.stats["kernel_op_names"])


def test_serve_case_flags_a_bf16_cast_on_the_ring(monkeypatch):
    # the towers' fp32 -> bf16 casts are declared on what the towers
    # write; a bf16 narrowing of the ring's stored scales is not
    from repro_torch.core import workset as WS
    real = WS.workset_insert

    def planted(ws, entry, batch_idx, *, key=None):
        real(ws, entry, batch_idx, key=key)
        scale = ws["buf"]["z"].scale
        scale.copy_(scale.to(torch.bfloat16).float())
        return ws
    monkeypatch.setattr(WS, "workset_insert", planted)
    r = A.trace_serve_case()
    casts = [f for f in r.errors if f.code == "kernel.unmediated-cast"]
    assert casts and all(f.where.startswith("state.ws") for f in casts), \
        [(f.code, f.where) for f in r.errors]


def test_kernel_contracts_clean_at_default_geometries():
    assert lint_kernels() == []


def test_kernel_route_lint_names_the_missing_gate():
    from repro_torch.analysis.kernel_lint import lint_kernel_route
    trace = TraceAudit(case="route")
    trace.kernel_ops[1] = "repro_torch::fused_sample_2d"
    assert lint_kernel_route(trace, CELUConfig(), "route") == []
    f = lint_kernel_route(trace, CELUConfig(cache_dtype="int4"), "route")
    assert [x.where for x in f] == ["repro_torch::fused_sample_q4_2d"]
    assert f[0].code == "kernel.fused-path-disabled"


def test_cli_refuses_cuda_without_a_card():
    from repro_torch.analysis.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--device", "cuda", "--quick"])
    with pytest.raises(RuntimeError, match="CUDA"):
        A.run_audit([], include_pod=False, device="cuda")


def test_cli_writes_the_report(tmp_path, monkeypatch):
    from repro_torch.analysis import __main__ as cli
    monkeypatch.setattr(A, "default_cases",
                        lambda quick=False: [A.AuditCase(name="K1-d0")])
    # the fleet and serve cases have tests of their own: stand-ins here
    for fn, name in (("trace_fleet_case", "fleet"),
                     ("trace_serve_case", A.SERVE_NAME)):
        monkeypatch.setattr(A, fn, lambda name=name: CaseResult(
            name=name, config={}, findings=[]))
    out = tmp_path / "AUDIT_torch.json"
    assert cli.main(["--device", "cpu", "--no-pod", "--out",
                     str(out)]) == 0
    d = json.loads(out.read_text())
    assert d["passed"] is True
    assert [c["name"] for c in d["cases"]] == [
        "kernel-contracts", "K1-d0", "fleet", A.SERVE_NAME, "route-check"]


# --------------------------------------------------------------------------
# seeded mutations: each planted bug must be caught, naming the offender
# --------------------------------------------------------------------------
def test_seeded_mutations_all_caught(selftest_results):
    ok, results = selftest_results
    missed = [m.name for m in results if not m.caught]
    assert ok, f"analyzer missed planted bug(s): {missed}"
    assert [(m.name, m.expected_code) for m in results] == [
        ("raw-send", "taint.raw-boundary"),
        ("under-count", "wire.bytes-mismatch"),
        ("gate-bypass", "kernel.fused-path-disabled"),
        ("noise-before-encode", "taint.sanitizer-order"),
        ("fleet-raw-send", "taint.raw-boundary"),
        ("pod-raw-isend", "taint.unmarked-collective")]


def test_raw_send_mutation_names_party_and_direction(selftest_results):
    m = selftest_results[1][0]
    assert m.name == "raw-send" and m.caught
    assert any("up:0" in e for e in m.errors)
    assert any("down:0" in e for e in m.errors)


def test_gate_bypass_names_the_op(selftest_results):
    m = selftest_results[1][2]
    assert m.caught
    assert "kernel.fused-path-disabled @ repro_torch::fused_sample_2d" in \
        m.errors


# --------------------------------------------------------------------------
# the card's resource lint, on a sample of ``cuobjdump -res-usage``
# --------------------------------------------------------------------------
RES_USAGE_SAMPLE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN4attn12_GLOBAL__N_116flash_fwd_f32mmaILi128EEEvPKfS3_S3_Pfs4_iiiif:
  REG:236 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:940 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z18quantize_sr_kernelILi4EEvPKfS1_PaPfiif:
  REG:40 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:400 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_118cosine_gate_kernelINS_5DenseIfEELi4EEEvNS_8GateArgsIT_EE:
  REG:47 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_118cosine_gate_kernelINS_5DenseI13__nv_bfloat16EELi4EEEvNS_8GateArgsIT_EE:
  REG:46 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_118cosine_gate_kernelINS_2Q8ELi4EEEvNS_8GateArgsIT_EE:
  REG:40 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN12_GLOBAL__N_123fused_adagrad_q8_kernelE7K8TablePKfffi:
  REG:38 STACK:0 SHARED:32 LOCAL:0 CONSTANT[0]:3604 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN4attn12_GLOBAL__N_113flash_fwd_mmaILi64EEEvPK13__nv_bfloat16S4_S4_PS2_Pfiiiif:
  REG:255 STACK:8 SHARED:0 LOCAL:16 CONSTANT[0]:940 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_res_usage_parser_and_lint():
    u = parse_res_usage(RES_USAGE_SAMPLE)
    assert u["flash_fwd_f32mma<128>"] == {"REG": 236, "STACK": 0,
                                          "SHARED": 0, "LOCAL": 0}
    assert u["quantize_sr_kernel<4>"]["REG"] == 40
    assert (u["cosine_gate_kernel<Dense<float>,4>"]["REG"],
            u["cosine_gate_kernel<Dense<__nv_bfloat16>,4>"]["REG"],
            u["cosine_gate_kernel<Q8,4>"]["REG"]) == (47, 46, 40)
    assert u["fused_adagrad_q8_kernel"]["SHARED"] == 32
    assert demangle("_Z18quantize_sr_kernelILi1EEvPKf") == \
        "quantize_sr_kernel<1>"
    findings = lint_usage(u)
    # the spilling bf16 attention kernel is the one finding
    assert [(f.code, f.where) for f in findings] == [
        ("kernel.local-memory", "csrc kernel flash_fwd_mma<64>")]
    u["quantize_sr_kernel<4>"]["REG"] = 600
    assert {f.code for f in lint_usage(u)} == {"kernel.local-memory",
                                               "kernel.register-budget"}


K3_RES_USAGE = """
 Function _ZN44_GLOBAL__N__eac064ef_11_quantize_cu_9f8d533018quantize_sr_kernelI13__nv_bfloat16Li4ELb1EEEvPKT_PKfPaPfiif:
  REG:50 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:400 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN44_GLOBAL__N__eac064ef_11_quantize_cu_9f8d533024quantize_partials_kernelI13__nv_bfloat16Li1EEEvPKT_Pfii:
  REG:23 STACK:0 SHARED:1056 LOCAL:0 CONSTANT[0]:400 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN44_GLOBAL__N__eac064ef_11_quantize_cu_9f8d533021quantize_apply_kernelIfLi4EEEvPKT_PKfPaPfS5_iif:
  REG:58 STACK:0 SHARED:1056 LOCAL:0 CONSTANT[0]:400 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_k3_kernels_are_linted_with_no_local_memory():
    """K3's narrow, pass-1 and pass-2 kernels (``csrc/quantize.cu``) have
    block sizes in the lint and must keep their values in registers."""
    u = parse_res_usage(K3_RES_USAGE)
    assert sorted(u) == ["quantize_apply_kernel<float,4>",
                         "quantize_partials_kernel<__nv_bfloat16,1>",
                         "quantize_sr_kernel<__nv_bfloat16,4,1>"]
    assert lint_usage(u) == []
    u["quantize_apply_kernel<float,4>"]["LOCAL"] = 16
    u["quantize_sr_kernel<__nv_bfloat16,4,1>"]["REG"] = 256
    assert sorted((f.code, f.where) for f in lint_usage(u)) == [
        ("kernel.local-memory", "csrc kernel quantize_apply_kernel<float,4>"),
        ("kernel.register-budget",
         "csrc kernel quantize_sr_kernel<__nv_bfloat16,4,1>")]


# --------------------------------------------------------------------------
# parity with the reference auditor
# --------------------------------------------------------------------------
def _ref_traces(monkeypatch):
    """Capture the reference's TraceAudit of each traced case."""
    import repro.analysis.audit as RA
    seen = []
    real = RA.audit_trace

    def capture(*args, **kw):
        t = real(*args, **kw)
        seen.append(t)
        return t
    monkeypatch.setattr(RA, "audit_trace", capture)
    return RA, seen


def _by_dir(records):
    out = {"up": 0, "down": 0}
    for r in records:
        out[r.direction] += 1
    return out


def _ref_ledger(celu, K, shape=(A.AUDIT_B, A.AUDIT_Z)):
    from repro.analysis.wire_audit import _measured_bytes
    from repro.core.engine import CompressedWANTransport as RComp
    from repro.core.engine import make_transport as rmake
    tp = rmake(celu)
    rows = []
    for i in range(K):
        for d in ("up", "down"):
            measured = _measured_bytes(tp, d, shape)[0]
            claimed = tp.codecs[d].wire_bytes(shape, tp.wire) \
                if isinstance(tp, RComp) else measured
            reported = tp.uplink_bytes(shape) if d == "up" \
                else tp.downlink_bytes(shape)
            rows.append({"direction": d, "party": i,
                         "measured": int(measured), "claimed": int(claimed),
                         "reported": int(reported)})
    return rows


def test_parity_with_the_reference_engine_cases(quick_report, monkeypatch):
    RA, seen = _ref_traces(monkeypatch)
    port = {c.name: c for c in quick_report.cases}
    for case in RA.default_cases(quick=True):
        seen.clear()
        ref = RA.trace_case(case)
        assert not ref.errors, (case.name, [f.detail for f in ref.errors])
        got = port[case.name]
        assert not got.errors
        (trace,) = seen
        want = _by_dir(trace.boundaries.values())
        assert (got.stats["boundaries_up"], got.stats["boundaries_down"]) \
            == (want["up"], want["down"]), case.name
        assert got.stats["ledger"] == _ref_ledger(RA._make_celu(case),
                                                  case.K), case.name
        assert got.stats["round_bytes"] == ref.stats["round_bytes"]


def test_parity_with_the_reference_fleet_and_serve(quick_report,
                                                   monkeypatch):
    RA, seen = _ref_traces(monkeypatch)
    port = {c.name: c for c in quick_report.cases}

    ref = RA.trace_fleet_case()
    assert not ref.errors, [f.detail for f in ref.errors]
    got = port[ref.name]
    assert not got.errors
    want = _by_dir(seen[-1].boundaries.values())
    assert (got.stats["boundaries_up"], got.stats["boundaries_down"]) == \
        (want["up"], want["down"]) == (1, 1)
    case = A.AuditCase(**{k: v for k, v in got.config.items()
                          if k != "jobs"})
    assert got.stats["ledger"] == _ref_ledger(RA._make_celu(case), case.K)

    ref = RA.trace_serve_case()
    assert not ref.errors, [f.detail for f in ref.errors]
    got = port[A.SERVE_NAME]
    assert (got.stats["uplink_marks"], got.stats["downlink_marks"]) == \
        (ref.stats["uplink_marks"], ref.stats["downlink_marks"])
    from repro.analysis.wire_audit import _measured_bytes
    from repro.configs import get_config
    from repro.configs.base import CELUConfig as RCELU
    from repro.core.engine import make_transport as rmake
    tp = rmake(RCELU(compression="int8/identity"))
    C = got.config["capacity"]
    d = get_config("smollm-360m").reduced().d_model
    want = []
    for direction, shape in (("up", (d,)), ("down", (1,))):
        measured = _measured_bytes(tp, direction, shape)[0]
        claimed = tp.codecs[direction].wire_bytes(shape, tp.wire)
        reported = tp.uplink_bytes(shape) if direction == "up" \
            else tp.downlink_bytes(shape)
        want.append({"direction": direction, "party": 0,
                     "measured": C * int(measured),
                     "claimed": C * int(claimed),
                     "reported": C * int(reported)})
    assert got.stats["ledger"] == want


# --------------------------------------------------------------------------
# report plumbing
# --------------------------------------------------------------------------
def test_report_json_roundtrip(tmp_path):
    rep = AuditReport(cases=[CaseResult(
        name="c", config={"K": 1},
        findings=[Finding(code="taint.raw-boundary", severity="error",
                          where="x", detail="d", case="c")],
        stats={"boundaries": 2})], meta={"torch": torch.__version__})
    path = tmp_path / "AUDIT_torch.json"
    rep.write_json(str(path))
    d = json.loads(path.read_text())
    assert d["version"] == 1
    assert d["passed"] is False
    assert d["summary"]["error"] == 1
    assert d["cases"][0]["findings"][0]["code"] == "taint.raw-boundary"
    assert not rep.passed
    assert "AUDIT FAILED" in rep.render()


def test_finding_rejects_unknown_severity():
    with pytest.raises(AssertionError):
        Finding(code="x", severity="catastrophic", where="w", detail="d")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_analysis_imports_neither_jax_nor_the_reference():
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / \
        "repro_torch" / "analysis"
    files = sorted(root.glob("*.py"))
    assert len(files) == 9
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                (f, mod)
