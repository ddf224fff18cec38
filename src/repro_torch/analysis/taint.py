"""Cross-party information-flow analysis over traced round graphs.

Port of ``repro/analysis/taint.py``.  The lattice: every traced value
carries

  * ``raw``  — the set of parties whose UNRELEASED private data (features,
    labels, pre-release cut tensors, optimizer state, error-feedback
    residuals) flowed into it;
  * ``san``  — the sanitizer stages the value passed while tainted
    (``wire`` / ``encode`` / ``dp`` / ``cache``, as marked by
    :mod:`repro_torch.analysis.markers`), with the node index of the
    latest application (for ordering checks);
  * ``casts`` — narrowing precision-cast sites (fp32 -> bf16 / int8, or
    float -> int) the value passed that no declared wire / encode / cache
    stage has vouched for yet.

The graph is the round traced with ``make_fx`` through
``torch.func.functionalize(remove="mutations_and_views")`` in real mode on
CPU tensors: every node is a pure aten (or custom) op, and every tensor an
input the round wrote in place comes back as an ``aten.copy_(input,
value)`` node at the end.  Propagation is a forward walk of the nodes:
outputs union the ``raw`` and ``casts`` of their inputs and intersect the
``san`` of their *tainted* inputs (a value mixed from a sanitized and an
unsanitized raw source is not sanitized).  ``repro_torch_audit.mark``
nodes apply the semantics:

  * sanitizer marks add their stage (and clear pending casts for the
    declared stages);
  * boundary marks CHECK — raw taint present means the required stages
    must all be in ``san`` and the ordering constraints must hold — then
    release: raw taint converts to nothing (the value is now a released
    message both parties may hold).

Every ``repro_torch::*`` node (a hand-written kernel's op: the gate, the
quantiser, the ring dequantiser) is treated as an opaque (conservative)
op and recorded for the kernel-usage stats: the counterpart of the
reference's opaque ``pallas_call``.  ``_c10d_functional`` collectives are
recorded with their group.  The graph has no ``scan`` or ``cond``: the
port's local updates are a Python loop, unrolled in the trace, and each
branch the host took is the one traced (the cases say which).

The host rule closes the theorem: every stage OUTPUT is declared hosted
at a party, and must carry no OTHER party's raw taint — the graph's
outputs and, through the ``copy_`` write-backs, every input the round
mutated in place (a party's parameters, its ring, its residuals).
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch

from .markers import MARK_TARGET, decode_meta
from .report import Finding

KERNEL_NAMESPACE = "repro_torch"
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                         "_dtensor")


# --------------------------------------------------------------------------
# The taint lattice
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Taint:
    raw: FrozenSet[str] = frozenset()
    san: Tuple[Tuple[str, int], ...] = ()       # (stage, latest node idx)
    casts: FrozenSet[str] = frozenset()         # unmediated narrowing casts

    @property
    def san_names(self) -> FrozenSet[str]:
        return frozenset(n for n, _ in self.san)

    def san_idx(self, name: str) -> Optional[int]:
        for n, i in self.san:
            if n == name:
                return i
        return None


EMPTY = Taint()


def raw_of(party: str) -> Taint:
    return Taint(raw=frozenset({party}))


def _san_dict(t: Taint) -> Dict[str, int]:
    return dict(t.san)


def join(taints: Sequence[Taint]) -> Taint:
    """Output taint of a generic node over these input taints."""
    raw: FrozenSet[str] = frozenset()
    casts: FrozenSet[str] = frozenset()
    for t in taints:
        raw = raw | t.raw
        casts = casts | t.casts
    tainted = [t for t in taints if t.raw]
    if not tainted:
        return Taint(raw=raw, casts=casts)
    names = frozenset.intersection(*[t.san_names for t in tainted])
    san = tuple(sorted(
        (n, min(_san_dict(t)[n] for t in tainted)) for n in names))
    return Taint(raw=raw, san=san, casts=casts)


def sanitize(t: Taint, name: str, idx: int) -> Taint:
    san = dict(t.san)
    san[name] = idx
    casts = t.casts
    from .markers import DECLARED_CAST_STAGES
    if name in DECLARED_CAST_STAGES:
        casts = frozenset()
    return Taint(raw=t.raw, san=tuple(sorted(san.items())), casts=casts)


# --------------------------------------------------------------------------
# Trace-level evidence collected during the walk
# --------------------------------------------------------------------------
@dataclass
class BoundaryRecord:
    direction: str
    party: int
    transport: str
    shape: Tuple[int, ...]
    dtype: str
    satisfied: bool


@dataclass
class TraceAudit:
    """Everything one walk learns about one traced function."""
    case: str = ""
    findings: List[Finding] = field(default_factory=list)
    boundaries: Dict[int, BoundaryRecord] = field(default_factory=dict)
    kernel_ops: Dict[int, str] = field(default_factory=dict)
    collectives: Dict[int, Tuple[str, Tuple[str, ...]]] = \
        field(default_factory=dict)
    nodes: int = 0
    _seen: set = field(default_factory=set)

    def add_finding(self, code: str, severity: str, where: str,
                    detail: str) -> None:
        key = (code, where, detail)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(code=code, severity=severity,
                                     where=where, detail=detail,
                                     case=self.case))

    def kernel_names(self) -> FrozenSet[str]:
        return frozenset(self.kernel_ops.values())


# --------------------------------------------------------------------------
# The walker
# --------------------------------------------------------------------------
def is_narrowing(src: torch.dtype, dst: torch.dtype) -> bool:
    """A float -> narrower float, or float -> integer, conversion."""
    if not src.is_floating_point:
        return False
    if dst.is_floating_point:
        return dst.itemsize < src.itemsize
    return dst not in (torch.bool,) and not dst.is_complex


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _cast_dtypes(node) -> Optional[Tuple[torch.dtype, torch.dtype]]:
    """(source, destination) dtype of a conversion node, else None."""
    t = node.target
    if t is torch.ops.aten._to_copy.default:
        dst = node.kwargs.get("dtype")
    elif t is torch.ops.prims.convert_element_type.default:
        dst = node.args[1]
    else:
        return None
    src = _val(node.args[0])
    if dst is None or not torch.is_tensor(src):
        return None
    return src.dtype, dst


def _namespace(target) -> str:
    return getattr(target, "namespace", "") or ""


def op_name(target) -> str:
    """``torch.ops.repro_torch.fused_sample_2d.default`` ->
    ``repro_torch::fused_sample_2d``."""
    name = getattr(target, "name", None)
    if callable(name):
        name = name()
    return str(name).split(".")[0] if name else str(target)


class TaintWalker:
    def __init__(self, audit: TraceAudit):
        self.audit = audit

    def walk(self, graph: torch.fx.Graph, in_taints: Sequence[Taint]
             ) -> Tuple[List[Taint], List[Tuple[int, Taint]]]:
        """-> (the taints of the graph's outputs, the write-backs as
        (mutated input's index, taint of the value written))."""
        env: Dict[torch.fx.Node, Taint] = {}
        placeholders = {}
        it = iter(in_taints)
        outs: List[Taint] = []
        writes: List[Tuple[int, Taint]] = []
        for idx, node in enumerate(graph.nodes):
            self.audit.nodes += 1
            if node.op == "placeholder":
                placeholders[node] = len(placeholders)
                env[node] = next(it)
            elif node.op == "get_attr":
                env[node] = EMPTY          # a constant of the trace
            elif node.op == "output":
                for a in _flat(node.args[0]):
                    outs.append(env.get(a, EMPTY)
                                if isinstance(a, torch.fx.Node) else EMPTY)
            elif node.op == "call_function":
                if node.target is torch.ops.aten.copy_.default \
                        and node.args[0] in placeholders:
                    t = env.get(node.args[1], EMPTY) \
                        if isinstance(node.args[1], torch.fx.Node) else EMPTY
                    writes.append((placeholders[node.args[0]], t))
                    env[node] = t
                    continue
                env[node] = self._node(env, node, idx)
            else:
                raise ValueError(f"unexpected graph node {node.op}")
        left = next(it, None)
        assert left is None, "more input taints than graph inputs"
        return outs, writes

    def _node(self, env, node, idx: int) -> Taint:
        ts = [env.get(a, EMPTY) for a in _flat((node.args, node.kwargs))
              if isinstance(a, torch.fx.Node)]
        target = node.target
        if target is MARK_TARGET:
            return self._mark(node, ts[0], idx)
        if target is operator.getitem:
            return ts[0] if ts else EMPTY
        ns = _namespace(target)
        if ns == KERNEL_NAMESPACE:
            self.audit.kernel_ops[idx] = op_name(target)
            return join(ts)
        if ns in COLLECTIVE_NAMESPACES:
            group = [str(a) for a in node.args[1:]
                     if isinstance(a, (str, int, list, tuple))]
            self.audit.collectives[idx] = (op_name(target), tuple(group))
            return join(ts)
        out = join(ts)
        casts = _cast_dtypes(node)
        if casts is not None and is_narrowing(*casts):
            src, dst = (str(d).replace("torch.", "") for d in casts)
            site = f"convert {src}->{dst} (node #{idx} {node.name})"
            out = Taint(raw=out.raw, san=out.san, casts=out.casts | {site})
        return out

    # -- marks -------------------------------------------------------------
    def _mark(self, node, t: Taint, idx: int) -> Taint:
        _, role, name, meta_s = node.args
        if role == "sanitizer":
            return sanitize(t, name, idx)
        assert role == "boundary", role
        meta = decode_meta(meta_s)
        require = tuple(meta.get("require", ()))
        order = tuple(meta.get("order", ()))
        val = _val(node)
        shape = tuple(val.shape) if torch.is_tensor(val) else ()
        dtype = str(val.dtype).replace("torch.", "") \
            if torch.is_tensor(val) else "?"
        satisfied = True
        if t.raw:
            missing = [r for r in require if r not in t.san_names]
            if missing:
                satisfied = False
                self.audit.add_finding(
                    "taint.raw-boundary", "error",
                    f"{meta.get('transport', '?')}.send "
                    f"{name} {shape}:{dtype}",
                    f"raw value tainted by part"
                    f"{'ies' if len(t.raw) > 1 else 'y'} "
                    f"{sorted(t.raw)} reaches the {meta.get('direction')} "
                    f"boundary without the registered "
                    f"{'/'.join(missing)} stage(s) "
                    f"(required: {list(require)}, seen: "
                    f"{sorted(t.san_names)})")
            for before, after in order:
                bi, ai = t.san_idx(before), t.san_idx(after)
                if bi is not None and ai is not None and ai <= bi:
                    satisfied = False
                    self.audit.add_finding(
                        "taint.sanitizer-order", "error",
                        f"{meta.get('transport', '?')}.send {name}",
                        f"'{after}' stage applied BEFORE '{before}' on the "
                        f"{meta.get('direction')} boundary value — with a "
                        f"lossy codec the DP noise must ride the decoded "
                        f"wire value (after encode), or error feedback "
                        f"re-transmits and cancels it")
        self.audit.boundaries[idx] = BoundaryRecord(
            direction=str(meta.get("direction", "?")),
            party=int(meta.get("party", -1)),
            transport=str(meta.get("transport", "?")),
            shape=shape, dtype=dtype, satisfied=satisfied)
        # release: the value is now a sanitized public message
        return Taint(casts=t.casts)


def _flat(x) -> list:
    out = []
    torch.fx.node.map_aggregate(x, lambda a: out.append(a))
    return out


# --------------------------------------------------------------------------
# Output host rule
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class OutTag:
    """Host declaration for one stage-output region.  ``allowed`` is the
    set of parties whose RAW taint the output may carry (None = skip the
    check: sim-level metrics that legitimately mix parties)."""
    allowed: Optional[FrozenSet[str]]
    label: str


def check_outputs(out_taints: Sequence[Taint], out_tags: Sequence[OutTag],
                  audit: TraceAudit) -> None:
    assert len(out_taints) == len(out_tags), \
        (len(out_taints), len(out_tags))
    for t, tag in zip(out_taints, out_tags):
        if t.casts:
            audit.add_finding(
                "kernel.unmediated-cast", "error", tag.label,
                f"narrowing precision cast(s) {sorted(t.casts)} reach this "
                f"output without passing a declared wire/encode/cache "
                f"stage — precision loss outside the registered codecs")
        if tag.allowed is None:
            continue
        extra = t.raw - tag.allowed
        if extra:
            audit.add_finding(
                "taint.foreign-raw-output", "error", tag.label,
                f"output hosted at {sorted(tag.allowed) or ['<public>']} "
                f"carries raw taint of part"
                f"{'ies' if len(extra) > 1 else 'y'} {sorted(extra)} — a "
                f"pre-release private value escaped into another party's "
                f"state")


def audit_trace(graph: torch.fx.Graph, in_taints: Sequence[Taint],
                out_tags: Sequence[OutTag], in_tags: Sequence[OutTag],
                case: str = "") -> TraceAudit:
    """Walk one traced round graph end to end: propagate taint, check
    every boundary mark, then apply the host rule to the outputs and to
    every in-place write-back (``in_tags[i]`` hosts input ``i``)."""
    audit = TraceAudit(case=case)
    outs, writes = TaintWalker(audit).walk(graph, in_taints)
    check_outputs(outs, out_tags, audit)
    check_outputs([t for _, t in writes], [in_tags[i] for i, _ in writes],
                  audit)
    return audit
