"""The audit orchestrator: build round graphs for every supported config
and run the three invariant families over each.

Port of ``repro/analysis/audit.py``.  Per audited case this module:

  1. builds a small but structurally faithful K-party task (the real
     ``KPartyTask``, ``init_state`` and ``_make_stages`` with the
     production transport / codec / cache path — only the model is tiny);
  2. composes the stages in the ORDER the schedule under audit runs them
     — depth 0 sequential, depth 1 static-staleness overlap, depth D >= 2
     as two CHAINED exchange dispatches (the in-flight queue's residual
     chain) plus the dynamic-staleness scan and merges — and traces the
     composition to one graph under :func:`markers.instrumented`;
  3. walks the graph with the taint engine (``taint.py``), reconciles the
     byte ledger (``wire_audit.py``), and checks that the gate op the
     config promises is a node of the graph (``kernel_lint.py``).

How a round becomes a graph.  The engine updates its state in place
(parameters, optimizer state, rings, counters), so the composition is
traced with ``make_fx`` through ``torch.func.functionalize(remove=
"mutations_and_views")``, in real mode on CPU tensors: every tensor the
round writes comes back as an ``aten.copy_`` into its input, which the
host rule reads.  Every tensor of the state (a party's parameters
included, bound into its module as the fleet binds them) is one graph
input, named by its path.  ``torch.func.functionalize`` refuses the
production route's ``requires_grad_`` / ``torch.autograd.grad``, so the
stages are built with ``functional=True`` (gradients through
``torch.func.vjp``): the fleet's route, whose one-job rounds are bitwise
the scalar ones.  Each case's stats say so (``route``).  On the CPU the
kernels' wrappers run their plain versions op by op, so the traced
dataflow is the program's; the gate, quantiser and ring-dequant kernels
are ``torch.library`` ops and show as one node each.  That the audited
path launches the promised kernels on the card is :func:`route_check`'s
part: one real round of each quick case on CUDA tensors, read through
``kernels._cuda.LAUNCHES``.

Input taints: each party's params / optimizer state / raw batch / cached
features are that party's raw sources; workset ``z``/``dz`` rings hold
already-released messages (untainted); error-feedback residuals are raw
to their owner and enter pre-seeded with the ``wire`` stage — they are
differences of wire-cast values by construction (every registered send
path maintains that invariant), and without the seed every stateful
codec path would false-positive on its first re-encode.
"""
from __future__ import annotations

import contextlib
import re
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .report import AuditReport, CaseResult, Finding
from .taint import EMPTY, OutTag, Taint, TraceAudit, audit_trace, raw_of
from .wire_audit import _measured_bytes, audit_wire

AUDIT_B = 64        # audited batch geometry
AUDIT_Z = 8         # cut-layer width
AUDIT_FA = 6        # feature-party input width
AUDIT_FB = 5        # label-party own-feature width
AUDIT_LR = 0.1


@dataclass(frozen=True)
class AuditCase:
    name: str
    K: int = 1
    depth: int = 0
    compression: str = ""
    cache_dtype: str = "float32"
    dp_sigma: float = 0.0
    wire_dtype: str = "float32"
    # chaos-layer schedule: the first dispatch's wire transfer is LOST
    # and the transport's recover_dropped folds its decoded messages back
    # into the error-feedback residuals before the next dispatch
    # (core/faults.py) — the audit proves the absorbed residuals still
    # clear the boundary theorem on the retransmission
    dropped: bool = False


def default_cases(quick: bool = False) -> List[AuditCase]:
    """The supported-config matrix, factorized so every axis value is
    covered without the full cross product: codec x DP at depth 0, depth
    x K at the heaviest codec, cache dtypes at depth 2, wire dtype.  The
    reference's 39 names (5 with ``quick``)."""
    from ..core.compression import CODEC_SPECS

    def mk(**kw):
        kw.setdefault("name", "-".join(
            [f"K{kw.get('K', 1)}", f"d{kw.get('depth', 0)}",
             kw.get("compression") or "wire",
             kw.get("cache_dtype", "float32"),
             f"dp{kw.get('dp_sigma', 0.0):g}",
             ] + ([kw["wire_dtype"]] if kw.get("wire_dtype",
                                               "float32") != "float32"
                  else [])
               + (["drop"] if kw.get("dropped") else [])))
        return AuditCase(**kw)

    if quick:
        return [mk(), mk(compression="topk_int8", dp_sigma=0.3, depth=2,
                         cache_dtype="int8"),
                mk(compression="topk_int8", dp_sigma=0.3, depth=2,
                   cache_dtype="int8", dropped=True),
                mk(depth=2, compression="int8", cache_dtype="int4"),
                mk(compression="int8", wire_dtype="bfloat16")]

    cases = []
    for spec in ("",) + tuple(CODEC_SPECS):
        for dp in (0.0, 0.3):
            cases.append(mk(compression=spec, dp_sigma=dp))
    for K in (1, 3):
        for depth in (0, 1, 2, 4):
            cases.append(mk(K=K, depth=depth, compression="topk_int8",
                            cache_dtype="int8", dp_sigma=0.3))
    for cd in ("float32", "bfloat16", "int8", "int4"):
        cases.append(mk(depth=2, compression="int8", cache_dtype=cd))
    # int4 at-rest rides the packed-nibble fused sample path; cover it at
    # K > 1 and under the chaos drop-absorb schedule too
    cases.append(mk(K=3, depth=2, compression="topk_int8",
                    cache_dtype="int4", dp_sigma=0.3))
    cases.append(mk(depth=2, compression="topk_int8", cache_dtype="int4",
                    dropped=True))
    for spec in ("", "int8"):
        cases.append(mk(compression=spec, wire_dtype="bfloat16"))
    # chaos layer: lost exchange absorbed into the residuals, with and
    # without DP noise riding the dropped messages, at both K widths
    for K in (1, 3):
        cases.append(mk(K=K, depth=2, compression="topk_int8",
                        cache_dtype="int8", dp_sigma=0.3, dropped=True))
    cases.append(mk(depth=2, compression="topk_int8", dropped=True))
    # dedupe (the sweeps overlap at the origin), keep first occurrence
    seen, out = set(), []
    for c in cases:
        if c.name not in seen:
            seen.add(c.name)
            out.append(c)
    return out


# --------------------------------------------------------------------------
# Toy-but-faithful K-party task
# --------------------------------------------------------------------------
class _Leaves(torch.nn.Module):
    """A party's parameters as named leaves (the reference's dict)."""

    def __init__(self, leaves: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in leaves.items():
            setattr(self, k, torch.nn.Parameter(v))


def _forward_a(p, batch):
    return torch.tanh(batch["x"] @ p.w + p.b)


def _loss_b(p, z_list, batch):
    own = torch.tanh(batch["x"] @ p.w_own)
    h = torch.cat(list(z_list) + [own], dim=1)
    logits = (h @ p.w_top)[:, 0]
    y = batch["y"]
    li = torch.clamp_min(logits, 0.0) - logits * y \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    return li, 0.0


def toy_task(K: int, device="cpu"):
    """-> (task, params, batches_a, batch_b) at the audited geometry,
    drawn from one generator seeded with 0."""
    from ..core import engine as E

    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return (0.3 * torch.randn(shape, generator=gen)).to(device)
    params = {
        "a": [_Leaves({"w": rnd(AUDIT_FA, AUDIT_Z), "b": rnd(AUDIT_Z)})
              for _ in range(K)],
        "b": _Leaves({"w_own": rnd(AUDIT_FB, AUDIT_Z),
                      "w_top": rnd((K + 1) * AUDIT_Z, 1)}),
    }
    batches_a = [{"x": rnd(AUDIT_B, AUDIT_FA)} for _ in range(K)]
    batch_b = {"x": rnd(AUDIT_B, AUDIT_FB),
               "y": (torch.rand(AUDIT_B, generator=gen) < 0.5).float().to(
                   device)}
    return E.KPartyTask(_forward_a, _loss_b), params, batches_a, batch_b


class ConstUniforms:
    """The traces' uniform source: every draw is 0.5 on the CPU (a
    constant of the graph, untainted; the uniforms' values do not change
    the dataflow)."""

    def __call__(self, tag, shape) -> torch.Tensor:
        return torch.full(tuple(shape), 0.5, dtype=torch.float32)


# --------------------------------------------------------------------------
# Flat graph inputs and outputs, named by path
# --------------------------------------------------------------------------
def _party_names(module) -> List[str]:
    from ..bridge import path_key
    return [n for n, _ in sorted(module.named_parameters(),
                                 key=lambda kv: path_key(kv[0]))]


def spec_paths(spec, prefix: str) -> List[str]:
    """The path of every tensor leaf of a ``fleet.runner.flatten`` spec,
    in its leaves' order."""
    out: List[str] = []

    def go(s, p):
        kind = s[0]
        if kind == "t":
            out.append(p)
        elif kind == "party":
            out.extend(f"{p}.{n}" for n in _party_names(s[1]))
        elif kind == "store":
            names = ("q", "scale") if s[2] == 2 else ("v",)
            out.extend(f"{p}.{n}" for n in names)
        elif kind == "dict":
            for k, v in s[1].items():
                go(v, f"{p}.{k}")
        elif kind == "named":
            for f, v in zip(s[1]._fields, s[2]):
                go(v, f"{p}.{f}")
        elif kind == "seq":
            for i, v in enumerate(s[2]):
                go(v, f"{p}[{i}]")
    go(spec, prefix)
    return out


def flat_inputs(tree, prefix: str):
    """-> (paths, leaves, spec) of a tree of modules, stores, dicts,
    lists and tensors (``fleet.runner.flatten``'s layout)."""
    from ..fleet.runner import flatten
    leaves, spec = flatten(tree)
    return spec_paths(spec, prefix), leaves, spec


@contextlib.contextmanager
def bound(spec, leaves):
    """The tree of ``spec`` over ``leaves``, each module with its leaves
    bound as its parameters (for the life of the context)."""
    from ..fleet.runner import _bind, unflatten
    with contextlib.ExitStack() as stack:
        yield _bind(unflatten(spec, list(leaves)), stack)


class _InplaceBitwise(torch.overrides.TorchFunctionMode):
    """``a &= b`` (``Tensor.__iand__``, which functionalization does not
    take) as the same in-place op under its aten name,
    ``a.bitwise_and_(b)``; likewise ``|=`` and ``^=``."""

    _SAME = {torch.Tensor.__iand__: torch.Tensor.bitwise_and_,
             torch.Tensor.__ior__: torch.Tensor.bitwise_or_,
             torch.Tensor.__ixor__: torch.Tensor.bitwise_xor_}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return self._SAME.get(func, func)(*args, **(kwargs or {}))


def trace_graph(fn: Callable, leaves: Sequence[torch.Tensor]
                ) -> torch.fx.GraphModule:
    """``fn(*leaves) -> list of tensors`` traced through functionalization
    (real mode, on copies of ``leaves``: the trace runs the round and
    writes its inputs back)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    args = [x.detach().clone() for x in leaves]

    def body(*xs):
        with _InplaceBitwise():
            return fn(*xs)
    return make_fx(torch.func.functionalize(
        body, remove="mutations_and_views"))(*args)


# --------------------------------------------------------------------------
# Input / output tags from paths
# --------------------------------------------------------------------------
_PUBLIC = frozenset()


def _residual_seed(party: str) -> Taint:
    # raw to the owner, pre-seeded with the wire stage (see module doc)
    return Taint(raw=frozenset({party}), san=(("wire", 0),))


# (pattern, input taint maker, host) in order; ``i`` is the pattern's
# party index, None where the pattern names Party B or public state
_ROUND_RULES: Tuple[Tuple[str, Callable, Callable], ...] = (
    (r"(transport|tstate)\.up\[(\d+)\]",
     lambda m: _residual_seed(f"a{m.group(2)}"),
     lambda m: frozenset({f"a{m.group(2)}"})),
    (r"(transport|tstate)\.down\[(\d+)\]",
     lambda m: _residual_seed("b"), lambda m: frozenset({"b"})),
    (r"(params|opt)\.a\[(\d+)\]", lambda m: raw_of(f"a{m.group(2)}"),
     lambda m: frozenset({f"a{m.group(2)}"})),
    (r"(params|opt)\.b\b", lambda m: raw_of("b"),
     lambda m: frozenset({"b"})),
    (r"ws\.a\[(\d+)\]\.buf\.batch", lambda m: raw_of(f"a{m.group(1)}"),
     lambda m: frozenset({f"a{m.group(1)}"})),
    (r"ws\.a\[(\d+)\]", lambda m: EMPTY,
     lambda m: frozenset({f"a{m.group(1)}"})),
    (r"ws\.b\.buf\.batch", lambda m: raw_of("b"),
     lambda m: frozenset({"b"})),
    (r"ws\.b\b", lambda m: EMPTY, lambda m: frozenset({"b"})),
    (r"(fresh\.(zs|dzs))", lambda m: EMPTY, lambda m: _PUBLIC),
    (r"fresh\.g_as\[(\d+)\]", lambda m: raw_of(f"a{m.group(1)}"),
     lambda m: frozenset({f"a{m.group(1)}"})),
    (r"fresh\.(g_b|loss)", lambda m: raw_of("b"),
     lambda m: frozenset({"b"})),
    (r"batches_a\[(\d+)\]\.", lambda m: raw_of(f"a{m.group(1)}"),
     lambda m: frozenset({f"a{m.group(1)}"})),
    (r"batches_a\[\d+\]\[(\d+)\]", lambda m: raw_of(f"a{m.group(1)}"),
     lambda m: frozenset({f"a{m.group(1)}"})),
    (r"batch_b\b", lambda m: raw_of("b"), lambda m: frozenset({"b"})),
    (r"metrics\.loss", lambda m: raw_of("b"), lambda m: frozenset({"b"})),
    # w_mean / w_zero_frac aggregate per-party weight statistics across
    # ALL parties by design (sim-level diagnostics): host rule skipped
    (r"metrics\.(w_mean|w_zero_frac)", lambda m: EMPTY, lambda m: None),
    (r"(steps|comm_rounds|metrics\.|hyper\.)", lambda m: EMPTY,
     lambda m: _PUBLIC),
)


def tag_of(path: str, rules=_ROUND_RULES) -> Tuple[Taint, OutTag]:
    """(input taint, host tag) of the leaf at ``path``."""
    for pattern, taint, host in rules:
        m = re.search(pattern, path)
        if m:
            return taint(m), OutTag(host(m), path)
    raise KeyError(f"no audit rule hosts {path!r}")


# --------------------------------------------------------------------------
# One case
# --------------------------------------------------------------------------
def make_celu(case: AuditCase):
    from ..configs.base import CELUConfig
    return CELUConfig(R=2, W=5, compression=case.compression,
                      cache_dtype=case.cache_dtype,
                      dp_sigma=case.dp_sigma,
                      wire_dtype=case.wire_dtype,
                      pipeline_depth=case.depth)


def _optimizer():
    from ..optim import make_optimizer
    # the kernel route: K7's in-place step on the card, its plain version
    # (the same arithmetic, op by op) on the CPU
    return make_optimizer("adagrad", AUDIT_LR, use_pallas=True)


def compose(case: AuditCase, stages, tp=None):
    """Wire the three stages in the order the schedule under audit runs
    them (``PipelinedEngine``'s).  Depth >= 2 chains TWO exchange
    dispatches through the transport-residual state — the in-flight
    queue — and charges the scan and the merges their staleness (a host
    int) on the dynamic path, exactly like ``PipelinedEngine`` at steady
    state.  ``case.dropped`` (needs ``tp`` and depth >= 2) audits the
    chaos layer's drop-absorb path instead: the first dispatch's wire
    transfer is lost, ``tp.recover_dropped`` folds its decoded messages
    back into the residuals, and only the SECOND dispatch is merged.
    Both dispatches still count as wire sends.  -> (fn(state, batches_a,
    batch_b, batch_idx) -> (state, metrics), dispatches)."""
    compute, apply_, scan = stages
    depth = case.depth

    def run(fn):
        def wrapped(state, batches_a, batch_b, batch_idx):
            with torch.enable_grad():
                return fn(state, batches_a, batch_b, batch_idx,
                          state["uniforms"])
        return wrapped

    if case.dropped:
        if depth < 2 or tp is None:
            raise ValueError("dropped cases need depth >= 2 and the "
                             "audited transport")

        def fn(state, batches_a, batch_b, batch_idx, src):
            r = state["round"]
            f1 = compute(state["params"], state["transport"], batches_a,
                         batch_b, r, src)
            ts = tp.recover_dropped(f1)          # f1's wire is LOST
            f2 = compute(state["params"], ts, batches_a, batch_b, r + 1,
                         src)
            state, lm = scan(state, depth)
            state, m = apply_(state, f2, batches_a, batch_b,
                              batch_idx + 1, src, depth - 1)
            return state, {**m, **lm}
        return run(fn), 2

    if depth == 0:
        def fn(state, batches_a, batch_b, batch_idx, src):
            fresh = compute(state["params"], state["transport"], batches_a,
                            batch_b, state["round"], src)
            state, m = apply_(state, fresh, batches_a, batch_b, batch_idx,
                              src)
            state, lm = scan(state)
            return state, {**m, **lm}
        return run(fn), 1

    if depth == 1:
        def fn(state, batches_a, batch_b, batch_idx, src):
            fresh = compute(state["params"], state["transport"], batches_a,
                            batch_b, state["round"], src)
            state, lm = scan(state)
            state, m = apply_(state, fresh, batches_a, batch_b, batch_idx,
                              src)
            return state, {**m, **lm}
        return run(fn), 1

    def fn(state, batches_a, batch_b, batch_idx, src):
        r = state["round"]
        f1 = compute(state["params"], state["transport"], batches_a,
                     batch_b, r, src)
        f2 = compute(state["params"], f1["tstate"], batches_a, batch_b,
                     r + 1, src)
        state, lm = scan(state, depth)
        state, _ = apply_(state, f1, batches_a, batch_b, batch_idx, src,
                          depth - 1)
        state, m = apply_(state, f2, batches_a, batch_b, batch_idx + 1, src,
                          depth - 1)
        return state, {**m, **lm}
    return run(fn), 2


def _check_collectives(trace: TraceAudit, case: str) -> List[Finding]:
    """Simulated-WAN graphs must contain NO collectives (the pod round's
    point-to-point record is :func:`trace_pod_case`'s)."""
    colls = list(trace.collectives.values())
    if not colls:
        return []
    return [Finding(
        code="taint.unmarked-collective", severity="error",
        where=f"{colls[0][0]}",
        detail=f"simulated-WAN trace contains collective(s) "
               f"{sorted({c[0] for c in colls})} — cross-device data "
               f"movement outside the audited transport", case=case)]


def build_case(case: AuditCase, transport=None, *, device="cpu",
               functional: bool = True, uniforms=None,
               audited: bool = True):
    """The case's round: -> dict(fn, dispatches, state, batches_a,
    batch_b, celu, tp (the inner transport), audited (the transport the
    stages send through: its boundary-marking proxy, or with
    ``audited=False`` the inner transport itself))."""
    from ..core import engine as E
    from .markers import AuditedTransport

    celu = make_celu(case)
    task, params, batches_a, batch_b = toy_task(case.K, device)
    opt = _optimizer()
    tp_inner = transport if transport is not None \
        else E.make_transport(celu)
    tp = AuditedTransport(tp_inner, celu) if audited else tp_inner
    state = E.init_state(task, params, opt, celu, batches_a, batch_b,
                         transport=tp_inner,
                         uniforms=uniforms if uniforms is not None
                         else ConstUniforms())
    stages = E._make_stages(
        task, opt, celu, n_local=celu.R, tp=tp,
        pipeline_staleness=case.depth,
        lr_damping=celu.pipeline_lr_damping if case.depth >= 2 else 0.0,
        functional=functional)
    fn, n_computes = compose(case, stages, tp)
    return dict(fn=fn, dispatches=n_computes, state=state,
                batches_a=batches_a, batch_b=batch_b, celu=celu,
                tp=tp_inner, audited=tp)


def _trace_tree(run: Callable, tree, prefix: str, case: str):
    """Trace ``run(tree) -> out tree`` (both of modules / stores / dicts /
    tensors) instrumented -> (graph, input paths, output paths)."""
    from .markers import instrumented
    paths, leaves, spec = flat_inputs(tree, prefix)
    out_paths: List[str] = []

    def fn(*xs):
        from ..fleet.runner import flatten
        with bound(spec, xs) as t:
            out = run(t)
            outs, ospec = flatten(out)
        out_paths[:] = spec_paths(ospec, "")
        return outs

    with instrumented():
        gm = trace_graph(fn, leaves)
    n_out = len(out_paths)
    out_vals = [n for n in gm.graph.nodes if n.op == "output"][0].args[0]
    assert len(out_vals) == n_out, (case, len(out_vals), n_out)
    return gm, paths, out_paths


def _tags(paths: Sequence[str], rules=_ROUND_RULES):
    tags = [tag_of(p, rules) for p in paths]
    return [t for t, _ in tags], [h for _, h in tags]


def _finish(case_name: str, gm, in_paths, out_paths, rules=_ROUND_RULES):
    in_taints, in_hosts = _tags(in_paths, rules)
    out_hosts = [tag_of(p, rules)[1] for p in out_paths]
    trace = audit_trace(gm.graph, in_taints, out_hosts, in_hosts,
                        case=case_name)
    return trace


def _engine_checks(trace: TraceAudit, celu, case: str, where: str
                   ) -> List[Finding]:
    from .kernel_lint import lint_kernel_route
    findings = lint_kernel_route(trace, celu, case)
    if not trace.boundaries:
        findings.append(Finding(
            code="audit.no-boundaries", severity="error", where=where,
            detail="the trace contains no boundary marks at all — the "
                   "analyzer instrumentation is broken, the audit proves "
                   "nothing", case=case))
    return findings


def trace_case(case: AuditCase, transport=None) -> CaseResult:
    """Trace + audit one configuration.  ``transport`` overrides the
    config-derived inner transport (used by the mutation self-tests)."""
    b = build_case(case, transport)
    fn = b["fn"]
    b["audited"]._counts.clear()          # fresh party indices per trace

    def run(tree):
        state, m = fn(tree["state"], tree["batches_a"], tree["batch_b"], 3)
        return {"state": state, "metrics": m}

    tree = {"state": b["state"], "batches_a": b["batches_a"],
            "batch_b": b["batch_b"]}
    gm, in_paths, out_paths = _trace_tree(run, tree, "", case.name)
    trace = _finish(case.name, gm, in_paths, out_paths)
    findings = list(trace.findings)
    findings += _check_collectives(trace, case.name)

    z_shapes = [(AUDIT_B, AUDIT_Z)] * case.K
    wire_findings, stats = audit_wire(b["tp"], b["celu"], z_shapes, trace,
                                      b["dispatches"], case.name)
    findings += wire_findings
    findings += _engine_checks(trace, b["celu"], case.name,
                               "instrumented trace")
    stats["nodes"] = trace.nodes
    stats["kernel_ops"] = len(trace.kernel_ops)
    stats["kernel_op_names"] = sorted(trace.kernel_names())
    stats["route"] = "functional (torch.func.vjp)"
    stats["branches"] = (f"R={b['celu'].R} local updates unrolled; "
                         f"{b['dispatches']} dispatch(es) traced")
    return CaseResult(name=case.name, config=asdict(case),
                      findings=findings, stats=stats)


# --------------------------------------------------------------------------
# Fleet (vmapped batched-state) case
# --------------------------------------------------------------------------
AUDIT_JOBS = 2      # fleet width of the batched-state audit trace


def trace_fleet_case(case: Optional[AuditCase] = None,
                     jobs: int = AUDIT_JOBS, transport=None) -> CaseResult:
    """Audit the vmapped fleet step: ``jobs`` stacked scheduler states
    (engine state + stacked in-flight queue) driven through ONE batched
    graph (``fleet.runner``'s ``vmap`` of ``make_fleet_step``'s step), at
    the heaviest supported config by default (depth 2, top-k + int8
    codec, DP noise, int8 cache).

    The port's queue phase is a host int, so the traced step is the one
    at the queue's steady state: each job's state first runs one warm-up
    step (its queue then holds ``depth - 1`` exchanges), and the traced
    step dispatches, scans with the queue full and merges the oldest.

    The batched-state theorem this proves: the taint, sanitizer-ordering
    and byte-ledger analyses are invariant under the leading job axis —
    every boundary crossing carries ``(jobs,) + z_shape`` (ONE mark moves
    the fleet's messages), the queue's host rule still separates parties
    per slot, and the per-job wire ledger reconciles unchanged."""
    from ..core import engine as E
    from ..core.weighting import xi_to_cos
    from ..fleet.runner import _stack_states, _vmapped, flatten
    from ..fleet.scheduler import JobHyper, make_fleet_step
    from ..optim import make_optimizer
    from .markers import AuditedTransport, instrumented

    if case is None:
        case = AuditCase(name=f"fleet-N{jobs}-K1-d2-topk_int8-int8-dp0.3",
                         K=1, depth=2, compression="topk_int8",
                         cache_dtype="int8", dp_sigma=0.3)
    celu = make_celu(case)
    K = case.K
    task, params, batches_a, batch_b = toy_task(K)
    tp_inner = transport if transport is not None \
        else E.make_transport(celu)
    tp = AuditedTransport(tp_inner, celu)
    state = E.init_state(task, params, make_optimizer("adagrad", AUDIT_LR),
                         celu, batches_a, batch_b, transport=tp_inner,
                         uniforms=ConstUniforms())
    init, step, _ = make_fleet_step(task, celu, depth=case.depth,
                                    transport=tp)
    fs = init(state)
    cos = float(xi_to_cos(celu.xi_degrees))
    warm = max(case.depth - 1, 0)
    with torch.no_grad():
        for t in range(warm):          # fill the queue to steady state
            fs, _ = step(fs, JobHyper(AUDIT_LR, cos), batches_a, batch_b, t)
    leaves, spec = _stack_states([fs] * jobs)
    paths = spec_paths(spec, "fs")
    lr = torch.full((jobs,), AUDIT_LR)
    cos_xi = torch.full((jobs,), cos)
    b_leaves, b_spec = flatten({"batches_a": batches_a,
                                "batch_b": batch_b})
    b_paths = spec_paths(b_spec, "")
    run = _vmapped(step, jobs)
    sources = [ConstUniforms()] * jobs
    n_state = len(leaves)
    out_paths: List[str] = []

    def fn(*xs):
        from ..fleet.runner import unflatten
        bt = unflatten(b_spec, xs[n_state + 2:])
        new, ospec, m = run(list(xs[:n_state]), spec, xs[n_state],
                            xs[n_state + 1], sources, bt["batches_a"],
                            bt["batch_b"], warm)
        m_leaves, m_spec = flatten(m)
        out_paths[:] = spec_paths(ospec, "fs") \
            + spec_paths(m_spec, "metrics")
        return list(new) + list(m_leaves)

    tp._counts.clear()
    with instrumented():
        gm = trace_graph(fn, list(leaves) + [lr, cos_xi] + list(b_leaves))
    in_paths = paths + ["hyper.lr", "hyper.cos_xi"] + b_paths
    trace = _finish(case.name, gm, in_paths, out_paths)
    findings = list(trace.findings)
    findings += _check_collectives(trace, case.name)

    z_shapes = [(AUDIT_B, AUDIT_Z)] * K
    wire_findings, stats = audit_wire(tp_inner, celu, z_shapes, trace, 1,
                                      case.name, jobs=jobs)
    findings += wire_findings
    findings += _engine_checks(trace, celu, case.name,
                               "instrumented fleet trace")
    stats["nodes"] = trace.nodes
    stats["kernel_ops"] = len(trace.kernel_ops)
    stats["kernel_op_names"] = sorted(trace.kernel_names())
    stats["route"] = "functional (the fleet's own)"
    stats["branches"] = (f"steady state: {warm} warm-up step(s) run, then "
                         f"one step traced (dispatch, scan, merge)")
    cfg = asdict(case)
    cfg["jobs"] = jobs
    return CaseResult(name=case.name, config=cfg, findings=findings,
                      stats=stats)


# --------------------------------------------------------------------------
# Pod (party-to-pod, two ranks) case
# --------------------------------------------------------------------------
POD_NAME = "pod-p2p-d1"
# every torch.distributed call that moves tensors or objects between ranks
_DATA_CALLS = ("batch_isend_irecv", "isend", "irecv", "send", "recv",
               "all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
               "gather", "scatter", "reduce", "send_object_list",
               "recv_object_list", "broadcast_object_list",
               "all_gather_object", "gather_object", "scatter_object_list")
# ``P2POp`` admits only ``distributed_c10d``'s own ``isend`` / ``irecv``
# and ``batch_isend_irecv`` calls them back: these two are recorded in
# both modules, and not where ``batch_isend_irecv`` makes them
_P2P_CALLS = ("isend", "irecv")


@contextlib.contextmanager
def recording_data_calls(calls: List[Dict[str, Any]]):
    """Record every :data:`_DATA_CALLS` call made through
    ``torch.distributed`` into ``calls`` (a ``batch_isend_irecv`` with
    its ops: kind, peer, bytes)."""
    import functools

    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d

    inside = [0]

    def recorder(name, orig):
        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            if name in _P2P_CALLS and inside[0]:
                return orig(*args, **kwargs)
            rec = {"call": name, "ops": []}
            if name == "batch_isend_irecv":
                for op in args[0]:
                    rec["ops"].append((op.op.__name__, int(op.peer),
                                       op.tensor.numel()
                                       * op.tensor.element_size()))
            calls.append(rec)
            inside[0] += name == "batch_isend_irecv"
            try:
                return orig(*args, **kwargs)
            finally:
                inside[0] -= name == "batch_isend_irecv"
        return wrapped

    saved = [(mod, n, getattr(mod, n)) for n in _DATA_CALLS
             for mod in ((dist, c10d) if n in _P2P_CALLS else (dist,))
             if hasattr(mod, n)]
    wrapped = {n: recorder(n, f) for mod, n, f in saved if mod is dist}
    for mod, n, _ in saved:
        setattr(mod, n, wrapped[n])
    try:
        yield calls
    finally:
        for mod, n, f in saved:
            setattr(mod, n, f)


def pod_rank(rank: int, world_size: int, leak: bool = False
             ) -> Dict[str, Any]:
    """One pod's part of :func:`trace_pod_case` (a ``run_ranks`` entry):
    one depth-1 pod round over the WDL demo model through an
    :class:`AuditedPodTransport`, with every ``torch.distributed`` data
    call of the round recorded.  ``leak`` plants the self-test's bug: each
    pod also sends its raw features to the other with ``dist.isend``,
    around the transport.  -> {"calls", "boundaries"}."""
    import torch.distributed as dist

    from ..core import pod_protocol as pp
    from ..core.engine import PodTransport
    from ..optim import make_optimizer
    from .markers import AuditedPodTransport, instrumented

    run = dict(pp.POD_DEFAULTS, rounds=1)
    opt = make_optimizer("adagrad", run["lr"])
    gen = torch.Generator().manual_seed(run["init_seed"])
    party, opt_state, ws = pp.init_pod_state(
        gen, None, opt, n_fields=run["n_fields"], vocab=run["vocab"],
        batch=run["batch"], W=run["W"], embed_dim=run["embed_dim"],
        z_dim=run["z_dim"], hidden=run["hidden"], device="cpu")
    tp = AuditedPodTransport(PodTransport())
    rnd = pp.make_pod_round(None, opt, R=run["R"], cos_xi=0.5,
                            transport=tp, pipeline_depth=1)
    (x, y), = pp.pod_batches(run)
    x, y = torch.as_tensor(x[rank]), torch.as_tensor(y[rank])
    calls: List[Dict[str, Any]] = []
    with recording_data_calls(calls), instrumented():
        if leak:
            got = torch.empty_like(x)
            for work in (dist.isend(x.contiguous(), 1 - rank),
                         dist.irecv(got, 1 - rank)):
                work.wait()
        rnd(party, opt_state, ws, x, y)
    return {"calls": calls, "boundaries": list(tp.records)}


def trace_pod_case(leak: bool = False) -> CaseResult:
    """Audit the party-to-pod round (``engine.make_pod_round`` at depth
    1, two gloo ranks on the CPU): every ``torch.distributed`` data call
    a rank makes in one round must be one of the transport's marked
    permutes (one ``batch_isend_irecv`` per boundary mark, carrying that
    crossing's bytes each way), and nothing else may cross.  Each pod
    holds one party's state whole, so the per-party host rule does not
    apply here: the record of calls is the boundary theorem on this
    path.  ``leak`` plants the self-test's raw ``dist.isend``
    (:func:`pod_rank`)."""
    from ..launch.dist import run_ranks

    name = POD_NAME
    results = run_ranks(pod_rank, 2, backend="gloo", args=(leak,),
                        timeout_s=120.0)
    findings: List[Finding] = []
    for rank, r in enumerate(results):
        p2p = [c for c in r["calls"] if c["call"] == "batch_isend_irecv"]
        other = [c["call"] for c in r["calls"]
                 if c["call"] != "batch_isend_irecv"]
        if other:
            findings.append(Finding(
                code="taint.unmarked-collective", severity="error",
                where=f"rank {rank}: {sorted(set(other))}",
                detail=f"the pod round calls torch.distributed "
                       f"{sorted(set(other))}: only the transport's marked "
                       f"permutes may move data between pods", case=name))
        bnd = r["boundaries"]
        if len(p2p) != len(bnd):
            findings.append(Finding(
                code="taint.unmarked-collective", severity="error",
                where=f"rank {rank}: batch_isend_irecv",
                detail=f"{len(p2p)} point-to-point exchange(s) but "
                       f"{len(bnd)} transport boundary mark(s) — a raw "
                       f"permute bypasses the transport", case=name))
            continue
        for call, (direction, party, shape, dtype) in zip(p2p, bnd):
            nbytes = int(torch.empty(shape, dtype=getattr(
                torch, dtype.replace("torch.", ""))).nbytes)
            moved = [b for _, _, b in call["ops"]]
            if any(b != nbytes for b in moved):
                findings.append(Finding(
                    code="wire.bytes-mismatch", severity="error",
                    where=f"rank {rank}: {direction}:{party}",
                    detail=f"the permute moves {moved} B but the marked "
                           f"crossing holds {nbytes} B", case=name))
    n_bnd = [len(r["boundaries"]) for r in results]
    if any(n != 2 for n in n_bnd):
        findings.append(Finding(
            code="audit.no-boundaries", severity="error", where="pod round",
            detail=f"expected the up/down permute boundary pair on each "
                   f"rank, found {n_bnd} boundary mark(s)", case=name))
    return CaseResult(
        name=name, config={"K": 1, "depth": 1, "transport": "PodTransport",
                           "ranks": 2, "backend": "gloo"},
        findings=findings,
        stats={"boundaries": n_bnd[0],
               "data_calls": [len(r["calls"]) for r in results],
               "route": "executed (two gloo ranks), calls recorded"})


# --------------------------------------------------------------------------
# Serving (continuous-batching decode) case
# --------------------------------------------------------------------------
SERVE_NAME = "serve-cb2-int8-int8"

_SERVE_RULES: Tuple[Tuple[str, Callable, Callable], ...] = (
    (r"^params\.a\.", lambda m: raw_of("a0"), lambda m: frozenset({"a0"})),
    (r"^params\.b\.", lambda m: raw_of("b"), lambda m: frozenset({"b"})),
    (r"\.cache_a\b", lambda m: raw_of("a0"), lambda m: frozenset({"a0"})),
    (r"\.cache_b\b", lambda m: raw_of("b"), lambda m: frozenset({"b"})),
    # ring rows are RELEASED messages; tokens already crossed the
    # downlink; the schedule vectors are public
    (r"\.ws\b", lambda m: EMPTY, lambda m: _PUBLIC),
    # B's own last emission feeds only B
    (r"(\.token$|^tokens$)", lambda m: raw_of("b"),
     lambda m: frozenset({"b"})),
    (r"\.(token_a|active|pos|remaining)$|^produced$", lambda m: EMPTY,
     lambda m: _PUBLIC),
)


# Declared exceptions of the serving step's cast lint, each on the outputs
# it reaches, each exact or by design:
#  * the towers compute in their parameter dtype (bf16, PARAM_DTYPE):
#    their float32 -> bfloat16 conversions (norms and softmax in fp32, the
#    rest in bf16) are the model's declared precision on what the towers
#    write, the KV caches and Party B's token;
#  * the downlink carries a token ID as float32 (the wire dtype) and
#    Party A converts it back with float32 -> int32: token ids < 2^24 are
#    exactly representable in float32, and the cast sits AFTER the wire
#    mark, so no declared stage can clear it.
# Any other cast on any output, the ring and the uplink's products
# included, still fails the case.
_SERVE_DECLARED_CASTS = (
    (r"^state\.cache_[ab]\b|^state\.token$|^tokens$",
     ("float32", "bfloat16")),
    (r"^state\.token_a$", ("float32", "int32")),
)


def trace_serve_case(transport=None) -> CaseResult:
    """Audit ONE exchange decode step of the serving engine
    (``serve.engine.make_step_fn`` with ``exchange=True``) at reduced
    smollm-360m geometry, with the int8 uplink, the identity downlink and
    the int8 activation ring.

    The serving boundary theorem: Party A's raw material (embedding
    params, tower KV cache, aux token) may reach Party B's logits — and
    hence the emitted token — ONLY through the uplink boundary (wire +
    codec encode), and the activation ring Party B fuses against may hold
    ONLY released (post-wire) rows.  The output tags require: new
    ``cache_a`` stays with A, new ``cache_b`` / the token stay with B,
    the ring contents and A's next aux token (downlink product) are
    released.  The crossing is marked on ``_send_rows`` (the int8
    uplink's quantiser rows never pass ``send``), so the transport is
    left unwrapped and each crossing is marked once."""
    from ..configs import get_config
    from ..models import vfl
    from ..serve.engine import ServeConfig, ServeEngine, make_step_fn

    name = SERVE_NAME
    cfg = get_config("smollm-360m").reduced()
    scfg = ServeConfig(capacity=2, prompt_len=4, max_new_tokens=2,
                       compression="int8", cache_dtype="int8",
                       ring_slots=2)
    params = vfl.init_all(0, cfg, device="cpu")
    engine = ServeEngine(params, cfg, scfg, transport=transport,
                         uniforms=ConstUniforms())
    step = make_step_fn(cfg, scfg, engine.tp, exchange=True)
    source = ConstUniforms()

    def run(tree):
        state, tok, produced = step(tree["params"], tree["state"], 1, 0,
                                    source)
        return {"state": state, "tokens": tok, "produced": produced}

    gm, in_paths, out_paths = _trace_tree(
        run, {"params": params, "state": engine.state}, "", name)
    out_paths = [p.lstrip(".") for p in out_paths]
    in_paths = [p.lstrip(".") for p in in_paths]
    trace = _finish(name, gm, in_paths, out_paths, _SERVE_RULES)

    def _declared(f):
        if f.code != "kernel.unmediated-cast":
            return False
        sites = set(re.findall(r"convert (\S+)->(\S+) ", f.detail))
        allowed = {cast for pattern, cast in _SERVE_DECLARED_CASTS
                   if re.search(pattern, f.where)}
        return bool(sites) and sites <= allowed
    declared = [f for f in trace.findings if _declared(f)]
    findings = [f for f in trace.findings if not _declared(f)]
    findings += _check_collectives(trace, name)

    # one uplink mark (the C lanes' rows) + one downlink mark (the C
    # token ids) per exchange step
    ups = [r for r in trace.boundaries.values() if r.direction == "up"]
    downs = [r for r in trace.boundaries.values() if r.direction == "down"]
    if len(ups) != 1 or len(downs) != 1:
        findings.append(Finding(
            code="audit.no-boundaries", severity="error",
            where="serve exchange step",
            detail=f"expected exactly 1 uplink + 1 downlink boundary mark "
                   f"(the lanes' rows), found {len(ups)} up / "
                   f"{len(downs)} down — a decode release is bypassing the "
                   f"serving wire", case=name))
    ops = trace.kernel_names()
    for op, what in (("repro_torch::quantize_sr_2d",
                      "the int8 uplink's quantiser (K3)"),
                     ("repro_torch::fused_dequant_q8_2d",
                      "the int8 ring read (K6)")):
        if op not in ops:
            findings.append(Finding(
                code="kernel.fused-path-disabled", severity="error",
                where=op,
                detail=f"{what} is not a node of the serving step's graph: "
                       f"the step does not go through the kernel's op",
                case=name))

    # the byte ledger of one step's crossings: C rows up, C token ids down
    tp, C, d = engine.tp, scfg.capacity, cfg.d_model
    ledger = []
    for direction, shape, reported in (("up", (d,), engine.step_up_bytes),
                                       ("down", (1,),
                                        engine.token_down_bytes)):
        measured, codec_name = _measured_bytes(tp, direction, shape)
        codecs = getattr(tp, "codecs", None)
        claimed = codecs[direction].wire_bytes(shape, tp.wire) \
            if codecs is not None else measured
        ledger.append({"direction": direction, "party": 0,
                       "measured": C * measured, "claimed": C * claimed,
                       "reported": C * int(reported)})
        if not measured == claimed == reported:
            findings.append(Finding(
                code="wire.bytes-mismatch", severity="error",
                where=f"{codec_name}[{direction}] lane row {shape}",
                detail=f"a lane's {direction} message measures {measured} "
                       f"B, its codec claims {claimed} B and the engine "
                       f"reports {reported} B", case=name))
    stats = {"nodes": trace.nodes,
             "boundaries": len(trace.boundaries),
             "uplink_marks": len(ups), "downlink_marks": len(downs),
             "ledger": ledger,
             "kernel_ops": len(trace.kernel_ops),
             "kernel_op_names": sorted(ops),
             "declared_casts": len(declared),
             "uplink_bytes": ledger[0]["measured"],
             "downlink_bytes": ledger[1]["measured"],
             "route": "traced (the serving step has no gradients)"}
    return CaseResult(
        name=name,
        config={"capacity": scfg.capacity, "compression": "int8/identity",
                "cache_dtype": scfg.cache_dtype, "arch": "smollm-360m",
                "reduced": True},
        findings=findings, stats=stats)


# --------------------------------------------------------------------------
# On the card: the audited path reaches its kernels
# --------------------------------------------------------------------------
def promised_gate(celu) -> str:
    """The gate kernel a config's local updates launch (its op name)."""
    return {"int8": "fused_sample_q8_2d",
            "int4": "fused_sample_q4_2d"}.get(celu.cache_dtype,
                                              "fused_sample_2d")


def promised_kernels(case: AuditCase) -> Dict[str, str]:
    """{kernel: why} the case's round must launch on the card."""
    from ..core.compression import make_codec_pair
    celu = make_celu(case)
    want = {promised_gate(celu): f"the {celu.cache_dtype} ring's gate",
            "fused_adagrad": "AdaGrad's kernel route (K7)"}

    def quantises(codec) -> bool:
        from ..core.compression import (ChainCodec, StochasticQuantCodec,
                                        TopKCodec)
        if isinstance(codec, StochasticQuantCodec):
            return True
        if isinstance(codec, TopKCodec):
            return quantises(codec.value_codec)
        if isinstance(codec, ChainCodec):
            return any(quantises(c) for c in codec.stages)
        return False
    wire_q = bool(case.compression) and any(
        quantises(c) for c in make_codec_pair(case.compression))
    if wire_q or case.cache_dtype in ("int8", "int4"):
        want["quantize_sr_2d"] = ("the wire's quantiser" if wire_q else
                                  f"the {case.cache_dtype} ring's inserts")
    return want


def route_check(case: AuditCase) -> CaseResult:
    """One real round of ``case`` on CUDA tensors (the production route:
    ``torch.autograd.grad``, K7's in-place step), with the delta of
    ``kernels._cuda.LAUNCHES`` read around it: every kernel the config
    promises (:func:`promised_kernels`) must have launched.  A gate that
    did not is ``kernel.fused-path-disabled``, any other kernel
    ``kernel.route-not-taken``."""
    from ..core.uniforms import GeneratorUniforms
    from ..kernels import _cuda

    if not torch.cuda.is_available():
        raise RuntimeError("route_check needs a CUDA device")
    b = build_case(case, device="cuda", functional=False, audited=False,
                   uniforms=GeneratorUniforms(0, "cuda"))
    before = dict(_cuda.LAUNCHES)
    state, m = b["fn"](b["state"], b["batches_a"], b["batch_b"], 3)
    torch.cuda.synchronize()
    delta = {k: _cuda.LAUNCHES[k] - before.get(k, 0)
             for k in _cuda.LAUNCHES if _cuda.LAUNCHES[k] != before.get(k)}
    findings: List[Finding] = []
    gate = promised_gate(b["celu"])
    for k, why in promised_kernels(case).items():
        if delta.get(k, 0) > 0:
            continue
        code = "kernel.fused-path-disabled" if k == gate \
            else "kernel.route-not-taken"
        findings.append(Finding(
            code=code, severity="error", where=f"repro_torch::{k}",
            detail=f"{why} launched no kernel in one round on the card "
                   f"(launches {delta})", case=case.name))
    if not torch.isfinite(m["loss"]).all():
        findings.append(Finding(
            code="audit.route-nonfinite", severity="error", where="loss",
            detail=f"the round's loss is {m['loss'].item()}", case=case.name))
    return CaseResult(name=f"route-{case.name}", config=asdict(case),
                      findings=findings, stats={"launches": delta})


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------
def run_audit(cases: Sequence[AuditCase], *, include_pod: bool = True,
              device: str = "cpu") -> AuditReport:
    """The audit over ``cases`` (:func:`default_cases`), the kernel
    contracts, the fleet and serving cases and (``include_pod``) the pod
    case.  The traces run on CPU tensors whatever ``device``;
    ``device="cuda"`` adds the card-only checks: the kernels' resource
    lint and launches at the contracts' geometries, and
    :func:`route_check` over ``cases``.  On ``"cpu"`` those two are
    ``info`` findings saying they need the card."""
    from .kernel_lint import CONTRACTS, DEFAULT_GEOMETRIES, lint_card, \
        lint_kernels

    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    kf = lint_kernels(DEFAULT_GEOMETRIES)
    stats = {"contracts": len(CONTRACTS),
             "geometries": len(DEFAULT_GEOMETRIES)}
    if device == "cuda":
        card_findings, card_stats = lint_card(DEFAULT_GEOMETRIES)
        kf += card_findings
        stats.update(card_stats)
    else:
        kf.append(Finding(
            code="kernel.card-only", severity="info",
            where="kernel_lint.lint_card",
            detail="the resource lint (cuobjdump -res-usage) and the "
                   "contracts' launches against their plain versions "
                   "need the card: run with --device cuda",
            case="kernel-contracts"))
    results: List[CaseResult] = [CaseResult(
        name="kernel-contracts",
        config={"geometries": [g.name for g in DEFAULT_GEOMETRIES]},
        findings=kf, stats=stats)]
    for case in cases:
        results.append(trace_case(case))
    results.append(trace_fleet_case())
    results.append(trace_serve_case())
    if include_pod:
        results.append(trace_pod_case())
    if device == "cuda":
        for case in cases:
            results.append(route_check(case))
    else:
        results.append(CaseResult(
            name="route-check", config={"device": device},
            findings=[Finding(
                code="kernel.card-only", severity="info",
                where="audit.route_check",
                detail="that each audited round launches its promised "
                       "kernels is read from kernels._cuda.LAUNCHES on "
                       "the card: run with --device cuda",
                case="route-check")]))
    return AuditReport(
        cases=results,
        meta={"torch": torch.__version__, "device": device,
              "card": torch.cuda.get_device_name(0) if device == "cuda"
              else None, "audited_cases": len(results)})
