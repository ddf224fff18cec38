"""Graph markers: how the auditor sees sanitizer stages and boundary
crossings inside a traced round WITHOUT touching production numerics.

Port of ``repro/analysis/markers.py``.  The engine's transports and codecs
are ordinary Python objects whose ops disappear into a soup of ``mul`` /
``_to_copy`` nodes once traced.  To audit them the analyzer calls an
identity op, ``torch.ops.repro_torch_audit.mark``, on the values of
interest, but ONLY inside :func:`instrumented`, an analyzer-scoped context
manager that patches the registered implementations:

  * ``privacy.wire_noise``           -> sanitizer mark ``dp``
  * ``SimWANTransport._wire_cast``   -> sanitizer mark ``wire``
  * every codec class's ``encode``   -> sanitizer mark ``encode`` on the
    and ``StochasticQuantCodec.         payload leaves (the serving
    roundtrip_rows``                    uplink's one-launch quantiser too)
  * ``workset._encode_leaf``         -> sanitizer mark ``cache`` (declares
                                        the at-rest storage casts)
  * ``serve.engine._send_rows``      -> boundary mark on the serving
                                        crossing (the int8 uplink does not
                                        go through ``send``)

and by wrapping the engine-side transport object in
:class:`AuditedTransport`, which marks every ``send`` result as a
``boundary`` crossing carrying the sanitizer requirements the config
implies (:class:`AuditedPodTransport` marks the pod round's permutes).
Production code never imports this module.

The split matters for mutation coverage: sanitizer marks live INSIDE the
registered implementations, the boundary mark lives in the engine-side
proxy, so a mutated transport that skips the registered pipeline still
gets its output marked as a boundary, now carrying unsanitized raw taint.

The mark returns a copy of its operand (a custom op may not alias its
input), so a marked round computes bit for bit what the unmarked one does.
It has a fake rule (abstract tensors), a ``vmap`` rule (the mark rides the
fleet's job axis: ONE mark over the batched value) and an identity
gradient under autograd.  Every value it marks in a round is detached
already (a released message, a payload, a stored row), so no
``torch.func`` gradient transform has to see through it.
"""
from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, Tuple

import torch

OP_NAME = "repro_torch_audit::mark"


def _mark_impl(x: torch.Tensor, role: str, name: str,
               meta: str) -> torch.Tensor:
    return x.clone()


mark_op = torch.library.custom_op(OP_NAME, _mark_impl, mutates_args=())


@mark_op.register_fake
def _mark_fake(x, role, name, meta):
    return torch.empty_like(x)


def _mark_vmap(info, in_dims, x, role, name, meta):
    return mark_op(x, role, name, meta), in_dims[0]


mark_op.register_vmap(_mark_vmap)


def _mark_backward(ctx, grad):
    return grad, None, None, None


mark_op.register_autograd(_mark_backward,
                          setup_context=lambda ctx, inputs, output: None)

# the op as the traced graph names it (``node.target``)
MARK_TARGET = torch.ops.repro_torch_audit.mark.default

# Sanitizer names whose marks "declare" a narrowing precision cast (the
# kernel-contract cast lint whitelists casts flowing into these).
DECLARED_CAST_STAGES = ("wire", "encode", "cache")


def encode_meta(meta: Tuple) -> str:
    """A boundary's ``(key, value)`` pairs -> the op's string argument."""
    return json.dumps([[k, v] for k, v in meta])


def decode_meta(meta: str) -> Dict[str, Any]:
    """Inverse of :func:`encode_meta` (lists back to tuples)."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    return {k: tup(v) for k, v in json.loads(meta)} if meta else {}


def mark(x, *, role: str, name: str, meta: Tuple = ()):
    """Mark every tensor of ``x`` (identity): dicts, lists, tuples and the
    workset's storage leaves are walked."""
    from ..core.workset import CastLeaf, QuantLeaf
    m = encode_meta(meta)

    def go(v):
        if torch.is_tensor(v):
            return mark_op(v, role, name, m)
        if isinstance(v, QuantLeaf):
            return type(v)(go(v.q), go(v.scale), v.shape, v.dtype)
        if isinstance(v, CastLeaf):
            return CastLeaf(go(v.v), v.dtype)
        if isinstance(v, dict):
            return {k: go(u) for k, u in v.items()}
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*[go(u) for u in v])
        if isinstance(v, (list, tuple)):
            return type(v)(go(u) for u in v)
        return v
    return go(x)


def boundary_requirements(tp, celu, direction: str) -> Tuple[str, ...]:
    """The sanitizer stages a raw value must pass before THIS transport
    may release it in ``direction``: the taint pass's required pattern.

    Registering a new transport = teaching this function (and
    :func:`instrumented` below, if it adds new sanitizer stages) what its
    sends promise."""
    from ..core.engine import CompressedWANTransport
    req = ["wire"]
    if isinstance(tp, CompressedWANTransport) and \
            not getattr(tp.codecs[direction], "exact", False):
        req.append("encode")
    if celu.dp_sigma > 0.0:
        req.append("dp")
    return tuple(req)


def boundary_order(tp, celu, direction: str) -> Tuple[Tuple[str, str], ...]:
    """(before, after) sanitizer-ordering constraints at this boundary.

    With a lossy codec under DP the noise must be applied AFTER the
    encode/decode round-trip (on the decoded wire value, residual already
    taken): noising first both wastes wire bits on noise and lets error
    feedback cancel the mechanism across rounds."""
    from ..core.engine import CompressedWANTransport
    if (isinstance(tp, CompressedWANTransport) and celu.dp_sigma > 0.0
            and not getattr(tp.codecs[direction], "exact", False)):
        return (("encode", "dp"),)
    return ()


def boundary_meta(tp, celu, direction: str, party: int) -> Tuple:
    return (("direction", direction), ("party", party),
            ("require", boundary_requirements(tp, celu, direction)),
            ("order", boundary_order(tp, celu, direction)),
            ("transport", type(tp).__name__))


class AuditedTransport:
    """Transparent engine-side proxy: forwards everything to the wrapped
    transport and boundary-marks each send's released value with the
    party index, direction and requirements.  The port's ``send`` is
    ``send(key, x, res, direction)``."""

    def __init__(self, tp, celu):
        self._tp = tp
        self._celu = celu
        self._counts: Dict[str, int] = {}

    def __getattr__(self, name):
        return getattr(self._tp, name)

    def send(self, key, x, res=None, direction: str = "up"):
        y, new_res = self._tp.send(key, x, res, direction)
        party = self._counts.get(direction, 0)
        self._counts[direction] = party + 1
        y = mark(y, role="boundary", name=f"{direction}:{party}",
                 meta=boundary_meta(self._tp, self._celu, direction, party))
        return y, new_res


class AuditedPodTransport:
    """The same for the party-to-pod round: the boundary is the received
    tensor of each permute (``send_up`` / ``send_down``, and the pipelined
    ``start_up`` whose ``wait()`` returns the crossing).  The pod link has
    no codec or DP stage registered, so the requirement set is empty: the
    audit's value here is the record of ``torch.distributed`` data calls
    (every one must be one of these marked permutes)."""

    def __init__(self, tp):
        self._tp = tp
        self._n = 0
        self.records = []

    def __getattr__(self, name):
        return getattr(self._tp, name)

    def _mark(self, y, direction: str):
        party = self._n
        self._n += 1
        self.records.append((direction, party, tuple(y.shape),
                             str(y.dtype)))
        return mark(y, role="boundary", name=f"{direction}:{party}",
                    meta=(("direction", direction), ("party", party),
                          ("require", ()), ("order", ()),
                          ("transport", type(self._tp).__name__)))

    def start_up(self, z):
        pending = self._tp.start_up(z)
        audited = self

        class _Marked:
            def wait(self):
                return audited._mark(pending.wait(), "up")
        return _Marked()

    def send_up(self, z):
        return self.start_up(z).wait()

    def send_down(self, dz):
        return self._mark(self._tp.send_down(dz), "down")


@contextlib.contextmanager
def instrumented():
    """Patch the registered sanitizer implementations to mark their
    outputs, for the duration of an analyzer trace.  Always restores on
    exit."""
    from ..core import compression as C
    from ..core import engine as E
    from ..core import privacy as P
    from ..core import workset as W
    from ..serve import engine as S

    patched: list = []

    def patch(owner, attr, wrapper):
        orig = getattr(owner, attr)
        patched.append((owner, attr, orig))
        setattr(owner, attr, wrapper(orig))
        return orig

    # privacy: the DP-noise stage.  privatize routes through the module
    # global wire_noise; the compressed transport imported the name, so
    # its module global is patched as well
    def noise(orig):
        return lambda key, y, cfg: mark(orig(key, y, cfg), role="sanitizer",
                                        name="dp")
    patch(P, "wire_noise", noise)
    patch(E, "wire_noise", noise)

    # wire stage: the dtype round-trip every send path shares
    patch(E.SimWANTransport, "_wire_cast",
          lambda orig: lambda self, x: mark(
              orig(self, x), role="sanitizer", name="wire"))

    # codec encodes: the payload leaves are what the wire carries; the
    # serving uplink's one-launch quantiser encodes (and decodes) rows
    for cls in (C.IdentityCodec, C.StochasticQuantCodec, C.TopKCodec,
                C.ChainCodec):
        patch(cls, "encode",
              lambda orig: lambda self, key, x: mark(
                  orig(self, key, x), role="sanitizer", name="encode"))
    patch(C.StochasticQuantCodec, "roundtrip_rows",
          lambda orig: lambda self, key, x: mark(
              orig(self, key, x), role="sanitizer", name="encode"))

    # workset storage codec: at-rest narrowing casts are declared here
    patch(W, "_encode_leaf",
          lambda orig: lambda store, x, key: mark(
              orig(store, x, key), role="sanitizer", name="cache"))

    # the serving crossing: one mark per direction and step, over the
    # lanes' rows (the uplink's quantiser rows never pass ``send``)
    counts: Dict[str, int] = {}

    def send_rows(orig):
        def wrapped(tp, key, rows, direction):
            y = orig(tp, key, rows, direction)
            party = counts.get(direction, 0)
            counts[direction] = party + 1
            return mark(y, role="boundary", name=f"{direction}:{party}",
                        meta=boundary_meta(tp, tp.celu, direction, party))
        return wrapped
    patch(S, "_send_rows", send_rows)

    try:
        yield
    finally:
        for owner, attr, orig in reversed(patched):
            setattr(owner, attr, orig)
