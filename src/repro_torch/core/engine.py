"""The K-party CELU-VFL round engine (paper Algorithms 1-2): the
sequential round and the pipelined scheduler.

Port of ``repro/core/engine.py``.  A *round*
exchanges ⟨Z_i, ∇Z_i⟩ once for every feature party A_i, applies the fresh
update to all parties, inserts the released statistics into each party's
workset ring, then runs ``R`` staleness-weighted local updates per party
from that ring.  The named protocols are presets of this one structure:

  * Vanilla  = ``local_steps=0``;
  * FedBCD   = ``W=1`` consecutive sampling, no weighting;
  * CELU-VFL = round-robin sampling over W slots + Algorithm-2 weighting.

``K`` is the length of ``state["params"]["a"]``; ``K=1`` is the paper's
two-party setting.  For ``K>=2`` Party B weights each cached instance by
the MINIMUM per-party cosine.

How the JAX engine maps onto PyTorch:

  * The party boundary is a detach.  Z crosses the wire and becomes a
    fresh leaf; Party B takes one ``torch.autograd.grad`` over its
    parameters and the Z leaves, and each Party A one
    ``torch.autograd.grad(z, params_a, grad_outputs=∇Z)``.  No autograd
    graph spans two parties.
  * ``lax.scan`` over the local updates is a Python loop.  Every counter,
    slot and valid flag stays a device tensor and draws are masked by the
    valid factor, never branched on, so a local update never waits for the
    host.
  * State is updated IN PLACE: parameters, optimizer state, rings and
    counters are mutated where they are, and ``round_fn`` returns the same
    state dict.
  * The Algorithm-2 gate always goes through the kernel wrappers
    (``kernels/ops.py``): on the card the CUDA kernel for every batch size
    (the TPU kernel's ``_fusable`` tiling gate has no counterpart), on the
    CPU their plain versions.  The ring's storage form picks the kernel:
    K1 for fp32 and bf16, K4 for int8, K5 for int4.
  * Randomness is injected: the stochastic-rounding uniforms of the
    compressed wire and of the quantised inserts come from a uniform
    source (``core/uniforms.py``) under tags that name the reference's
    key chain.  The state keeps the round number as a host int
    (``state["round"]``) for the tags, so drawing costs no host sync.
  * The pipelined scheduler (:class:`PipelinedEngine`) runs the same
    stages eagerly on one stream: a per-slot staleness is a host int
    (the queue's length, an exchange's age), so the schedule never reads
    the card.
  * DP on the wire (``celu.dp_sigma > 0``) draws its Gaussian noise from
    the send's key through the uniform source (``core/privacy.py``).
  * The chaos engine (``core/faults.py``) drives the same scheduler
    through its hooks: ``local(staleness=, party_mask=)``,
    ``merge(staleness=)``, ``dispatch(wire_round=)`` and the transports'
    ``recover_dropped``.
  * The fleet (``fleet/``) runs the same stages under
    ``torch.func.vmap`` over a job axis.  Stages built with
    ``functional=True`` take every gradient with ``torch.func.vjp`` over
    the party's parameters bound into its module (:func:`bind_parameters`),
    never create a leaf with ``requires_grad_`` and never add a batched
    value into a tensor they made; ``cos_xi=`` may then be a (batched)
    tensor and ``uniforms=`` a per-job source.  The default route keeps
    ``torch.autograd.grad``: ``torch.func`` refuses the saved-tensor
    hooks of the LLM towers' activation checkpointing and the old-style
    ``autograd.Function`` of K9-LSE / K10.  Both routes give the same
    numbers (``tests/test_torch_fleet.py`` holds map lanes bitwise to the
    scalar engine).
  * The party-to-pod round (:func:`make_pod_round`) runs one process a
    pod: rank p of the pod group holds party p, and the cut tensors cross
    between ranks by point-to-point ``torch.distributed`` sends
    (:class:`PodTransport`, the reference's ``lax.ppermute`` pair).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from ..bridge import path_key, reference_parameters
from ..configs.base import CELUConfig, validate_pipeline_depth
from ..kernels import ops as kops
from ..optim import Optimizer, apply_updates
from .compression import IdentityCodec, make_codec_pair
from .privacy import DPConfig, clip_rows, privatize, wire_noise
from .uniforms import GeneratorUniforms, draw_key, insert_key, wire_key
from .weighting import pipeline_attenuation, xi_to_cos
from .workset import (CastLeaf, Quant4Leaf, QuantLeaf, decode_entry,
                      take_slot, tree_map, workset_draw, workset_entry,
                      workset_init, workset_insert)


class KPartyTask(NamedTuple):
    """K-party split-model interface (no function sees two parties' raw
    features):

        forward_a(params_a_i, batch_a_i) -> Z_i
        loss_b(params_b, [Z_1..Z_K], batch_b) -> (per-instance loss, aux)

    ``params_*`` are the parties' ``nn.Module``s (the LLM split's are
    ``models.vfl.PartyParams``)."""
    forward_a: Callable[[Any, Any], torch.Tensor]
    loss_b: Callable[[Any, Sequence[torch.Tensor], Any],
                     Tuple[torch.Tensor, torch.Tensor]]


def lift_two_party(task) -> KPartyTask:
    """Adapt a two-party task (``loss_b`` over one Z_A) to the K-party
    interface (``loss_b`` over ``[Z_1..Z_K]``, K=1)."""
    return KPartyTask(
        task.forward_a,
        lambda pb, z_list, batch_b: task.loss_b(pb, z_list[0], batch_b))


def lift_two_party_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """{"a": pa, "b": pb} -> the engine's {"a": [pa], "b": pb}."""
    return {"a": [params["a"]], "b": params["b"]}


def unlift_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Engine {"a": [pa], "b": pb} -> the two-party {"a": pa, "b": pb}."""
    (pa,) = params["a"]
    return {"a": pa, "b": params["b"]}


# --------------------------------------------------------------------------
# Transport
# --------------------------------------------------------------------------
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SimWANTransport:
    """In-process slow link: each released message is round-tripped
    through the wire dtype (simulating quantised transmission) after
    optional DP noising (``celu.dp_sigma > 0``: per-row L2 clip at
    ``celu.dp_clip``, then Gaussian noise, ``core/privacy.py``); byte
    accounting follows the wire precision.  The noised wire value is what
    both sides see and what gets cached."""

    def __init__(self, celu: CELUConfig):
        if celu.wire_dtype not in _WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be one of "
                             f"{tuple(_WIRE_DTYPES)}, got "
                             f"{celu.wire_dtype!r}")
        self.celu = celu
        self.wire = _WIRE_DTYPES[celu.wire_dtype]

    @property
    def stateful_directions(self):
        """Directions ("up"/"down") whose error-feedback residuals live in
        ``state["transport"]`` (none: this transport is stateless)."""
        return ()

    def init_state(self, z_examples: Sequence) -> Dict[str, Any]:
        return {}

    def _wire_cast(self, x):
        if x.dtype != self.wire:
            x = x.to(self.wire).to(x.dtype)
        return x

    @property
    def dp(self) -> DPConfig:
        return DPConfig(clip=self.celu.dp_clip, sigma=self.celu.dp_sigma)

    def send(self, key, x, res=None, direction: str = "up"):
        """The message released across the link -> (wire value, residual).
        ``key`` (a ``UniformKey``) draws the DP noise; the plain wire uses
        it for nothing else."""
        if self.celu.dp_sigma > 0.0:
            x = privatize(key, x, self.dp)
        return self._wire_cast(x), res

    def message_bytes(self, z_shape) -> int:
        return int(np.prod(z_shape)) * self.wire.itemsize

    def uplink_bytes(self, z_shape) -> int:
        """Bytes of one released Z_i (feature party -> label party)."""
        return self.message_bytes(z_shape)

    def downlink_bytes(self, z_shape) -> int:
        """Bytes of one released ∇Z_i (label party -> feature party)."""
        return self.message_bytes(z_shape)

    def round_bytes(self, z_shapes: Sequence) -> int:
        """One uplink plus one downlink per feature party."""
        return sum(self.uplink_bytes(s) + self.downlink_bytes(s)
                   for s in z_shapes)

    def recover_dropped(self, fresh: Dict[str, Any]) -> Dict[str, Any]:
        """Transport state to resume from when ``fresh``'s wire transfer
        is lost (the chaos engine abandons an exchange after its
        retries).  A stateless transport has nothing to recover: the
        update is gone and the local scans go on from cached
        statistics."""
        return fresh["tstate"]


class CompressedWANTransport(SimWANTransport):
    """Compressed wire (Compressed-VFL): every released message passes the
    plain wire cast and then a per-direction codec of
    :mod:`repro_torch.core.compression` under error feedback.

    Lossy directions carry one fp32 residual per feature party in
    ``state["transport"]`` (``{"up": [r_1..r_K], "down": [...]}``, built
    by :meth:`init_state`); each send compresses ``x + r`` and keeps the
    compression error as the next round's residual, so the decoded
    messages telescope to the uncompressed sum.  The identity codec is
    ``exact``: its send skips encode, so that wire is bitwise the plain
    one and keeps no residual."""

    def __init__(self, celu: CELUConfig, up_codec=None, down_codec=None):
        super().__init__(celu)
        up = up_codec if up_codec is not None else IdentityCodec()
        self.codecs = {"up": up,
                       "down": down_codec if down_codec is not None else up}

    @property
    def stateful_directions(self):
        return tuple(d for d, c in self.codecs.items() if not c.lossless)

    def init_state(self, z_examples: Sequence) -> Dict[str, Any]:
        """Zero residuals, one per party per lossy direction, on the
        device of the K cut-tensor examples."""
        return {d: [torch.zeros(z.shape, dtype=torch.float32,
                                device=z.device) for z in z_examples]
                for d in self.stateful_directions}

    def send(self, key, x, res=None, direction: str = "up"):
        codec = self.codecs[direction]
        if getattr(codec, "exact", False):
            return super().send(key, x, None, direction)[0], res
        # under DP: clip before the wire cast and noise the decoded value,
        # so the residual stays noise-free (noise in it would be re-sent,
        # and so cancelled, by the next rounds)
        dp = self.celu.dp_sigma > 0.0
        e = self._wire_cast(clip_rows(x, self.dp.clip) if dp else x).float()
        if res is not None:
            e = e + res
        y = codec.decode(codec.encode(key.fold(1), e), e)
        new_res = None if res is None else e - y
        if dp:
            y = wire_noise(key.fold(2), y, self.dp)
        return y.to(x.dtype), new_res

    def uplink_bytes(self, z_shape) -> int:
        return self.codecs["up"].wire_bytes(z_shape, self.wire)

    def downlink_bytes(self, z_shape) -> int:
        return self.codecs["down"].wire_bytes(z_shape, self.wire)

    def recover_dropped(self, fresh: Dict[str, Any]) -> Dict[str, Any]:
        """Error-feedback recovery of a lost exchange: each dropped
        decoded message ``y`` goes back into its direction's residual.
        The send kept ``r' = (x + r) - y``, so ``r'' = r' + y = x + r``
        and the next delivered send carries the whole signal: the drop
        becomes a delay, not a loss.  Under DP the dropped ``y`` carries
        its noise into the residual, as in the reference (the released
        value is then noisier than needed, never less noisy).  Lossless
        directions keep no residual.  The residuals are new tensors: the
        dropped payload is not written."""
        ts = dict(fresh["tstate"])
        for d in self.stateful_directions:
            vals = fresh["zs"] if d == "up" else fresh["dzs"]
            ts[d] = [r + v.float() for r, v in zip(ts[d], vals)]
        return ts

    def scheduled(self, loss) -> "CompressedWANTransport":
        """Offer one (smoothed) loss observation to each distinct codec's
        adaptive hook (the top-k ``ratio_schedule``).  -> ``self`` when
        nothing fired, else a new transport around the re-ratioed codecs;
        the residuals in the round state are dense and carry over."""
        # consult each DISTINCT codec once: a symmetric wire may alias one
        # codec object in both directions
        seen: Dict[int, Any] = {}
        for c in self.codecs.values():
            if id(c) not in seen:
                seen[id(c)] = c.scheduled(loss) if hasattr(c, "scheduled") \
                    else c
        new = {d: seen[id(c)] for d, c in self.codecs.items()}
        if all(new[d] is self.codecs[d] for d in self.codecs):
            return self
        return CompressedWANTransport(self.celu, new["up"], new["down"])


def make_transport(celu: CELUConfig, compression: Optional[str] = None):
    """Transport for the simulated WAN.  ``compression`` (falling back to
    ``celu.compression``) is a codec spec of
    ``core.compression.CODEC_SPECS`` or ``"up/down"``; empty -> the plain
    :class:`SimWANTransport`."""
    name = celu.compression if compression is None else compression
    if not name:
        return SimWANTransport(celu)
    up, down = make_codec_pair(name)
    return CompressedWANTransport(celu, up, down)


class _PendingPermute(NamedTuple):
    """A started permute: ``wait()`` gives the received tensor."""
    tp: "PodTransport"
    works: list
    recv: Optional[torch.Tensor]
    like: torch.Tensor

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        if self.recv is None:          # no pair sends to this pod
            return torch.zeros_like(self.like)
        return self.tp._stage_in(self.recv, self.like)


class PodTransport:
    """Cut-tensor exchange between pods: the reference's ``lax.ppermute``
    pair over the ``pod`` axis, as point-to-point ``torch.distributed``
    sends.  Party A lives on pod 0, Party B on pod 1 by default.

    ``up`` / ``down`` are (source pod, destination pod) pairs; a send is
    one ``batch_isend_irecv`` over them, which computes what ``ppermute``
    does (a pod no pair sends to receives zeros).  ``group`` is the pod
    process group (default: the world); a pod is its rank there.

    ``staged=True`` carries each CUDA tensor through a pinned host buffer
    (one copy out before the send, one copy in after the receive), for a
    backend that moves host memory (gloo): the transport mode of two pods
    that share one card, and of a link that leaves the card through the
    host.  ``staged=False`` hands the tensors to the backend as they are.

    Counters (this pod's): ``sent_bytes`` / ``recv_bytes`` over the link,
    ``staged_bytes`` copied between card and host, ``stage_s`` the
    seconds those copies took."""

    def __init__(self, up: Sequence[Tuple[int, int]] = ((0, 1), (1, 0)),
                 down: Sequence[Tuple[int, int]] = ((1, 0), (0, 1)), *,
                 group=None, staged: bool = False):
        self.up = [tuple(p) for p in up]
        self.down = [tuple(p) for p in down]
        self.group = group
        self.staged = staged
        self.sent_bytes = 0
        self.recv_bytes = 0
        self.staged_bytes = 0
        self.stage_s = 0.0
        self._host = {}

    def pod(self) -> int:
        import torch.distributed as dist
        return dist.get_rank(self.group)

    def _peer(self, pod: int) -> int:
        import torch.distributed as dist
        return pod if self.group is None \
            else dist.get_global_rank(self.group, pod)

    def _host_buffer(self, role: str, like: torch.Tensor) -> torch.Tensor:
        key = (role, tuple(like.shape), like.dtype)
        buf = self._host.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def _stage_out(self, x: torch.Tensor, role: str) -> torch.Tensor:
        if not self.staged:
            return x.contiguous()
        if x.device.type != "cuda":
            raise ValueError("staged=True carries CUDA tensors through the "
                             "host; this one is on " + str(x.device))
        t0 = time.perf_counter()
        buf = self._host_buffer(role, x)
        buf.copy_(x)                   # synchronous: ready for the send
        self.stage_s += time.perf_counter() - t0
        self.staged_bytes += x.numel() * x.element_size()
        return buf

    def _stage_in(self, recv: torch.Tensor, like: torch.Tensor):
        if not self.staged:
            return recv
        t0 = time.perf_counter()
        out = recv.to(like.device)
        self.stage_s += time.perf_counter() - t0
        self.staged_bytes += out.numel() * out.element_size()
        return out

    def start(self, x: torch.Tensor, pairs, role: str) -> _PendingPermute:
        """Start the permute of ``x`` over ``pairs`` (``role`` names the
        direction's host buffers) and return at once."""
        import torch.distributed as dist
        me = self.pod()
        wire = self._stage_out(x.detach(), role + "_out")
        ops, recv = [], None
        nbytes = x.numel() * x.element_size()
        for src, dst in pairs:
            if src == me:
                ops.append(dist.P2POp(dist.isend, wire, self._peer(dst),
                                      group=self.group))
                self.sent_bytes += nbytes
            if dst == me:
                recv = self._host_buffer(role + "_in", x) if self.staged \
                    else torch.empty_like(wire)
                ops.append(dist.P2POp(dist.irecv, recv, self._peer(src),
                                      group=self.group))
                self.recv_bytes += nbytes
        works = dist.batch_isend_irecv(ops) if ops else []
        return _PendingPermute(self, works, recv, x)

    def start_up(self, z) -> _PendingPermute:
        return self.start(z, self.up, "up")

    def send_up(self, z) -> torch.Tensor:
        """Z_A: feature pod -> label pod."""
        return self.start_up(z).wait()

    def send_down(self, dz) -> torch.Tensor:
        """∇Z_A: label pod -> feature pod."""
        return self.start(dz, self.down, "down").wait()


# --------------------------------------------------------------------------
# Algorithm-2 weighting
# --------------------------------------------------------------------------
def _bcast(w, like):
    """(B,) weights -> broadcastable to ``like``'s shape."""
    return w.reshape(w.shape + (1,) * (like.dim() - 1)).float()


def staleness_weights(ad_hoc, stale, cos_xi: float) -> torch.Tensor:
    """Algorithm-2 ``InsWeight``: per-instance cosine floored at cos ξ
    (K2b)."""
    return kops.cosine_weight(ad_hoc, stale, cos_xi)


def _attenuate_post_scale(w, cot, staleness: int, dynamic: bool = False):
    """Compose the depth-s pipeline discount onto a gate kernel's
    (w, w ⊙ ∇Z): -> (w^(1+s), w^s ⊙ (w ⊙ ∇Z)), the law of
    :func:`~repro_torch.core.weighting.pipeline_attenuation`, so the
    discounted weight multiplies the cotangent once.  The static path
    (depths 0 / 1) skips ``s = 0`` and takes ``w ** s`` as products; the
    dynamic path (``dynamic``: the depth-D queue's per-slot staleness, a
    host int) always applies the float power, the identity at s = 0."""
    if not dynamic and not staleness:
        return w, cot
    extra = torch.pow(w, float(staleness)) if dynamic else w ** int(staleness)
    return w * extra, cot * _bcast(extra, cot)


def weighted_cotangent(ad_hoc, stale, dz, cos_xi: float, *,
                       pipeline_staleness: int = 0, dynamic: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InsWeight + weights ⊙ ∇Z -> (weights (B,), fp32 weighted
    cotangent) (K2a), discounted for ``pipeline_staleness``
    (:func:`_attenuate_post_scale`)."""
    w, cot = kops.weighted_cotangent(ad_hoc, stale, dz.float(), cos_xi)
    return _attenuate_post_scale(w, cot, pipeline_staleness, dynamic)


# --------------------------------------------------------------------------
# Local-update gradients (Algorithm 2)
# --------------------------------------------------------------------------
def _params(module) -> list:
    """The module's parameters in the reference's leaf order: gradients,
    per-leaf optimizer state and the int8 state's rounding uniforms (leaf
    index ``i``) follow it."""
    return reference_parameters(module)


def _take(ws_leaf, idx):
    return ws_leaf.index_select(0, idx)[0]


@contextlib.contextmanager
def bind_parameters(module, tensors):
    """Run ``module`` with ``tensors`` (in :func:`_params`'s order) in
    place of its parameters, restored on exit: the party's parameters
    as a stacked fleet's batched slices, or as ``torch.func.vjp``'s
    primals.  In-place updates of the bound tensors land in them."""
    names = [n for n, _ in sorted(module.named_parameters(),
                                  key=lambda kv: path_key(kv[0]))]
    slots = []
    for name in names:
        *path, leaf = name.split(".")
        sub = module
        for part in path:
            sub = getattr(sub, part)
        slots.append((sub, leaf, sub._parameters[leaf]))
    for (sub, leaf, _), t in zip(slots, tensors, strict=True):
        sub._parameters[leaf] = t
    try:
        yield module
    finally:
        for sub, leaf, old in slots:
            sub._parameters[leaf] = old


def _vjp(fn, module, extra=(), *, functional: bool = False):
    """``fn(*extra)``'s value and its pullback: ``pull(cot)`` -> the
    gradients of <fn, cot> with respect to ``module``'s parameters
    (:func:`_params`'s order; none when ``module`` is None), then
    ``extra``.  ``fn`` reaches the parameters through ``module``.

    ``functional``: ``torch.func.vjp`` with the parameters bound into the
    module as primals, which ``torch.func.vmap`` can carry (the fleet).
    Otherwise ``torch.autograd.grad`` over the module's own parameters and
    fresh leaves for ``extra``: the same numbers, and the only route for
    the LLM towers (see the module docstring)."""
    params = [] if module is None else _params(module)
    if not functional:
        leaves = [x.detach().requires_grad_(True) for x in extra]
        out = fn(*leaves)
        return out, lambda cot: torch.autograd.grad(
            out, params + leaves, grad_outputs=cot)
    n = len(params)

    def f(*xs):
        ctx = contextlib.nullcontext() if module is None \
            else bind_parameters(module, xs[:n])
        with ctx:
            return fn(*xs[n:])
    out, pull = torch.func.vjp(f, *[p.detach() for p in params],
                               *[x.detach() for x in extra])
    return out, pull


def _backward_a(z_new, pull, w, cot, mask):
    if mask is not None:
        w = w * mask
        cot = cot * mask
    g = pull(cot.to(z_new.dtype))
    return g, w


def _grad_a_tail(z_new, pull, stale_z, stale_dz, cos_xi, *,
                 weighting: bool, mask, pipeline_staleness: int,
                 dynamic: bool):
    """Feature-party update once the stale statistics are materialised:
    InsWeight + cotangent scale + backward (``pull``, the forward's
    pullback)."""
    if weighting:
        w, cot = weighted_cotangent(z_new.detach(), stale_z, stale_dz,
                                    cos_xi,
                                    pipeline_staleness=pipeline_staleness,
                                    dynamic=dynamic)
    else:
        w = torch.ones(z_new.shape[0], device=z_new.device)
        cot = _bcast(w, z_new) * stale_dz.float()
    return _backward_a(z_new, pull, w, cot, mask)


def local_grad_a(forward_a, params_a, entry, cos_xi, *,
                 weighting: bool = True, mask=None,
                 pipeline_staleness: int = 0, dynamic: bool = False,
                 functional: bool = False):
    """Feature-party local update on a materialised workset entry
    {"z", "dz", "batch"}.  ``mask`` (0-d 0/1 tensor) zeroes a bubble
    draw; ``pipeline_staleness`` / ``dynamic`` discount the weights
    (:func:`_attenuate_post_scale`); ``functional`` picks :func:`_vjp`'s
    route.  Returns (grads, weights)."""
    z_new, pull = _vjp(lambda: forward_a(params_a, entry["batch"]),
                       params_a, functional=functional)
    return _grad_a_tail(z_new, pull, entry["z"], entry["dz"], cos_xi,
                        weighting=weighting, mask=mask,
                        pipeline_staleness=pipeline_staleness,
                        dynamic=dynamic)


def _ring_view(store):
    """fp32 / bf16 storage leaf -> the ring tensor K1 reads."""
    return store.v if isinstance(store, CastLeaf) else store


def _fused_ring_sample(slot, z_new, z_store, dz_store, cos_xi):
    """One-pass sample off the ring in its storage form: gather the slot,
    dequantise, row cosine against the ad-hoc z, threshold, scale the
    stale cotangent (K1 for fp32 / bf16, K4 for int8, K5 for int4).
    -> (weights (B,), fp32 weighted cotangent in z_new's shape)."""
    if isinstance(z_store, Quant4Leaf):
        return kops.fused_gather_weight_q4(slot, z_new, z_store.q,
                                           z_store.scale, dz_store.q,
                                           dz_store.scale, cos_xi)
    if isinstance(z_store, QuantLeaf):
        return kops.fused_gather_weight_q8(slot, z_new, z_store.q,
                                           z_store.scale, dz_store.q,
                                           dz_store.scale, cos_xi)
    return kops.fused_gather_weight(slot, z_new, _ring_view(z_store),
                                    _ring_view(dz_store), cos_xi)


def local_grad_a_cached(forward_a, params_a, ws, slot, cos_xi, *,
                        weighting: bool = True, cache_fused: bool = True,
                        mask=None, pipeline_staleness: int = 0,
                        dynamic: bool = False, functional: bool = False):
    """Feature-party local update straight off the workset ring.  Only the
    party's own cached features are gathered; with ``cache_fused`` the cut
    statistics ⟨Z, ∇Z⟩ go through the fused ring-sample kernel of the
    ring's storage form (K1, K4 or K5) and no copy of the entry is made.
    Otherwise the entry is gathered, decoded and weighted by K2a.  The
    pipeline discount is a post-scale of the kernel's output.  Returns
    (grads, weights)."""
    buf = ws["buf"]
    idx = slot.reshape(1).long()
    batch = tree_map(lambda b: _take(b, idx), buf["batch"])
    z_new, pull = _vjp(lambda: forward_a(params_a, batch), params_a,
                       functional=functional)
    if weighting and cache_fused:
        w, cot = _fused_ring_sample(slot, z_new.detach(), buf["z"],
                                    buf["dz"], cos_xi)
        w, cot = _attenuate_post_scale(w, cot, pipeline_staleness, dynamic)
        return _backward_a(z_new, pull, w, cot, mask)
    entry = workset_entry(ws, slot)
    return _grad_a_tail(z_new, pull, entry["z"], entry["dz"], cos_xi,
                        weighting=weighting, mask=mask,
                        pipeline_staleness=pipeline_staleness,
                        dynamic=dynamic)


def _weighted_grad_b(loss_b, params_b, zs, batch_b, w, functional=False):
    def loss():
        li, aux = loss_b(params_b, zs, batch_b)
        return (w * li).mean() + aux
    out, pull = _vjp(loss, params_b, functional=functional)
    return pull(torch.ones_like(out))


def _ad_hoc_dz(loss_b, params_b, zs, batch_b, functional=False):
    """∇Z_i of the mean loss at the cached Z_i (paper footnote 2): the
    first of Party B's two autograd passes, used only for the weights.
    As in the reference, the cached Z_i enter in fp32, so a bf16 cut
    tensor (the LLM's) runs the layers after the fusion in fp32, and the
    gradient is taken with respect to Z alone: the backward reaches only
    those layers."""
    def loss(*zl):
        li, _ = loss_b(params_b, list(zl), batch_b)
        return li.mean()
    out, pull = _vjp(loss, None, [z.float() for z in zs],
                     functional=functional)
    return pull(torch.ones_like(out))


def local_grad_b(loss_b, params_b, entry, cos_xi, *,
                 weighting: bool = True, mask=None,
                 pipeline_staleness: int = 0, dynamic: bool = False,
                 functional: bool = False):
    """Label-party local update on a materialised entry: stale Z_i's +
    own features; the ad-hoc ∇Z_i only measure staleness, then the
    weighted per-instance losses drive the backward pass.  K>1: the
    weight is the minimum cosine over parties, then discounted once for
    the pipeline staleness.  Returns (grads, weights)."""
    zs, dzs, batch_b = entry["z"], entry["dz"], entry["batch"]
    if weighting:
        dz_new = _ad_hoc_dz(loss_b, params_b, zs, batch_b, functional)
        w = staleness_weights(dz_new[0], dzs[0], cos_xi)
        for i in range(1, len(zs)):
            w = torch.minimum(w, staleness_weights(dz_new[i], dzs[i], cos_xi))
        w = pipeline_attenuation(w, pipeline_staleness, dynamic)
    else:
        w = torch.ones(zs[0].shape[0], device=zs[0].device)
    if mask is not None:
        w = w * mask
    return _weighted_grad_b(loss_b, params_b, zs, batch_b, w,
                            functional), w


def _fused_ring_weights(slot, dz_new, dz_store, cos_xi):
    """Weights-only fused sample for Party B: the slot's stale ∇Z_i read
    straight off the ring in its storage form and row-cosined against the
    ad-hoc derivative (K1, K4 or K5 with no cotangent)."""
    if isinstance(dz_store, Quant4Leaf):
        return kops.fused_gather_weights_q4(slot, dz_new, dz_store.q,
                                            dz_store.scale, cos_xi)
    if isinstance(dz_store, QuantLeaf):
        return kops.fused_gather_weights_q8(slot, dz_new, dz_store.q,
                                            dz_store.scale, cos_xi)
    return kops.fused_gather_weights(slot, dz_new, _ring_view(dz_store),
                                     cos_xi)


def local_grad_b_cached(loss_b, params_b, ws, slot, cos_xi, *,
                        weighting: bool = True, cache_fused: bool = True,
                        mask=None, pipeline_staleness: int = 0,
                        dynamic: bool = False, functional: bool = False):
    """Label-party local update straight off the workset ring.  The loss
    consumes the cached Z list, so it is gathered and decoded with plain
    ops; with ``cache_fused`` the ∇Z side is read by the weights-only ring
    kernel of the ring's storage form (K1, K4 or K5) and never gathered,
    otherwise it is gathered, decoded and weighted by K2b.  Returns
    (grads, weights)."""
    buf = ws["buf"]
    idx = slot.reshape(1).long()
    batch_b = tree_map(lambda b: _take(b, idx), buf["batch"])
    zs = decode_entry(take_slot(buf["z"], slot))
    if weighting:
        dz_new = _ad_hoc_dz(loss_b, params_b, zs, batch_b, functional)
        if cache_fused:
            stale = buf["dz"]
            weigh = lambda i: _fused_ring_weights(  # noqa: E731
                slot, dz_new[i], stale[i], cos_xi)
        else:
            stale = decode_entry(take_slot(buf["dz"], slot))
            weigh = lambda i: staleness_weights(  # noqa: E731
                dz_new[i], stale[i], cos_xi)
        w = weigh(0)
        for i in range(1, len(zs)):
            w = torch.minimum(w, weigh(i))
        w = pipeline_attenuation(w, pipeline_staleness, dynamic)
    else:
        w = torch.ones(zs[0].shape[0], device=zs[0].device)
    if mask is not None:
        w = w * mask
    return _weighted_grad_b(loss_b, params_b, zs, batch_b, w,
                            functional), w


# --------------------------------------------------------------------------
# State
# --------------------------------------------------------------------------
def _i32(device):
    return torch.zeros((), dtype=torch.int32, device=device)


@torch.no_grad()
def init_state(task: KPartyTask, params: Dict[str, Any], opt: Optimizer,
               celu: CELUConfig, batches_a: Sequence[Any], batch_b,
               transport=None, compression: Optional[str] = None,
               uniforms=None):
    """Build the K-party training state on the device of ``params`` and
    the example batches, which size the workset rings.
    ``params = {"a": [pa_1..pa_K], "b": pb}`` (modules).  ``transport`` /
    ``compression`` must mirror what :func:`make_round` gets: the
    transport sizes the error-feedback residuals of
    ``state["transport"]``.  ``uniforms`` is the round's uniform source
    (``core/uniforms.py``); the default draws from a ``torch.Generator``
    on the state's device seeded with 0."""
    K = len(params["a"])
    z_like = [torch.zeros_like(task.forward_a(params["a"][i], batches_a[i]))
              for i in range(K)]
    dev = z_like[0].device
    ws_a = [workset_init(celu.W, {"z": z_like[i], "dz": z_like[i],
                                  "batch": batches_a[i]},
                         cache_dtype=celu.cache_dtype)
            for i in range(K)]
    ws_b = workset_init(celu.W, {"z": list(z_like), "dz": list(z_like),
                                 "batch": batch_b},
                        cache_dtype=celu.cache_dtype)
    return {
        "params": {"a": list(params["a"]), "b": params["b"]},
        "opt": {"a": [opt.init(_params(p)) for p in params["a"]],
                "b": opt.init(_params(params["b"]))},
        "ws": {"a": ws_a, "b": ws_b},
        "steps": {"a": [_i32(dev) for _ in range(K)], "b": _i32(dev)},
        "comm_rounds": _i32(dev),
        "round": 0,              # comm_rounds as a host int, for the tags
        "uniforms": (uniforms if uniforms is not None
                     else GeneratorUniforms(0, dev)),
        "transport": (transport if transport is not None
                      else make_transport(celu, compression)
                      ).init_state(z_like),
    }


# --------------------------------------------------------------------------
# The round stages
# --------------------------------------------------------------------------
def _zero_local_metrics(dev):
    zero = torch.zeros((), device=dev)
    return {"local_steps": _i32(dev), "w_mean": zero, "w_zero_frac": zero}


def _opt_step(opt, module, grads, opt_state, scale=None):
    """One optimizer update of ``module`` in place -> new opt state.
    ``scale`` (0-d tensor) multiplies the update before it is applied.
    An optimizer with an in-place ``step`` (AdaGrad's kernel route: one
    K7 / K8 launch for the party's tensors) takes it."""
    params = _params(module)
    if opt.step is not None:
        return opt.step(list(grads), opt_state, params, scale)
    upd, opt_state = opt.update(grads, opt_state, params)
    if scale is not None:
        upd = [u * scale for u in upd]
    apply_updates(params, upd)
    return opt_state


def _make_stages(task: KPartyTask, opt: Optimizer, celu: CELUConfig, *,
                 n_local: int, tp, pipeline_staleness: int = 0,
                 lr_damping: float = 0.0, cos_xi=None, uniforms=None,
                 functional: bool = False):
    """The round's stages over the shared state layout:

      * ``exchange_compute(params, tstate, batches_a, batch_b, round_,
        uniforms)`` — party forwards, the wire up (Z_i) and down (∇Z_i),
        Party B's loss and every fresh gradient, without touching the
        state; -> the fresh values and the updated residuals (the
        payload an in-flight exchange carries);
      * ``exchange_apply(state, fresh, batches_a, batch_b, batch_idx,
        uniforms, staleness=None)`` — fresh optimizer steps, workset
        inserts, counters, the residuals adopted;
      * ``local_scan(state, staleness=None, party_mask=None)`` — the R
        staleness-weighted local updates per party (Algorithm 2);
        ``party_mask`` ((K+1,) float32 on the round's device, a_0..a_{K-1}
        then b) freezes a party that is down.

    ``pipeline_staleness`` (the scheduler's depth) tightens the workset
    validity window and discounts the Algorithm-2 weights on the static
    path.  A ``staleness`` given to a stage (a host int: the depth-D
    queue's in-flight count at a scan, the merged exchange's age at a
    merge) takes the dynamic path instead: it replaces the depth, the
    discount is always applied, the uniform draws fold it in, and with
    ``lr_damping`` (the ``c`` of ``1 / (1 + c·s)``) positive the stage's
    optimizer updates are damped.

    The fleet's overrides (the reference's ``cos_xi=`` / ``rng_keys=``):
    ``cos_xi`` replaces ``celu.xi_degrees``'s threshold (a float, or a
    0-d fp32 tensor: under ``vmap`` each job's own); ``uniforms`` (a
    uniform source) replaces the one the stages are handed and the
    state's; ``functional`` takes every gradient through
    ``torch.func.vjp`` (:func:`_vjp`), so ``torch.func.vmap`` can carry
    the stages."""
    if celu.sampling not in ("round_robin", "consecutive", "uniform"):
        raise ValueError(f"sampling={celu.sampling!r}")
    if cos_xi is None:
        cos_xi = xi_to_cos(celu.xi_degrees)
    fn = functional
    s_pipe = int(pipeline_staleness)
    uniform = celu.sampling == "uniform"

    def _damp(staleness) -> Optional[float]:
        """1 / (1 + c·s) in float32, as the reference computes it; None
        on the static path or at c = 0."""
        if staleness is None or lr_damping <= 0.0:
            return None
        one = np.float32(1.0)
        return float(one / (one + np.float32(lr_damping)
                            * np.float32(staleness)))

    def exchange_compute(params, tstate, batches_a, batch_b, round_,
                         src):
        if uniforms is not None:
            src = uniforms
        pas, pb = params["a"], params["b"]
        K = len(pas)
        missing = [d for d in tp.stateful_directions if d not in tstate]
        if missing:
            raise ValueError(
                f"transport keeps error-feedback residuals for {missing} "
                f"but the round state has none: pass the same transport "
                f"(or compression spec) to init_state")
        up_res = list(tstate["up"]) if "up" in tstate else [None] * K
        down_res = list(tstate["down"]) if "down" in tstate else [None] * K

        def key(j):     # wire send j of 2K: 2i up, 2i + 1 down
            return wire_key(src, round_, 2 * K, j)

        # uplinks: every A_i's forward -> Z_i, released in wire precision;
        # the wire value becomes a fresh leaf on Party B's side
        z_out, pulls, zs = [], [], []
        for i in range(K):
            z, pull = _vjp(lambda i=i: task.forward_a(pas[i], batches_a[i]),
                           pas[i], functional=fn)
            z_out.append(z)
            pulls.append(pull)
            zi, up_res[i] = tp.send(key(2 * i), z.detach(), up_res[i], "up")
            zs.append(zi)

        # Party B: loss + grads wrt (params_b, all Z_i) in one pass
        def loss_fn(*z_leaves):
            li, aux = task.loss_b(pb, list(z_leaves), batch_b)
            return li.mean() + aux
        loss, pull_b = _vjp(loss_fn, pb, zs, functional=fn)
        n_b = len(_params(pb))
        grads = pull_b(torch.ones_like(loss))
        g_b = grads[:n_b]
        dzs = list(grads[n_b:])
        for i in range(K):
            dzs[i], down_res[i] = tp.send(key(2 * i + 1), dzs[i],
                                          down_res[i], "down")
        new_tstate = dict(tstate)
        if "up" in tstate:
            new_tstate["up"] = up_res
        if "down" in tstate:
            new_tstate["down"] = down_res

        # every A_i's backward with its (wire-precision) cotangent
        g_as = [pulls[i](dzs[i].to(z_out[i].dtype)) for i in range(K)]
        return {"zs": zs, "dzs": dzs, "g_as": g_as, "g_b": g_b,
                "loss": loss.detach(), "tstate": new_tstate}

    def exchange_apply(state, fresh, batches_a, batch_b, batch_idx,
                       src, staleness=None):
        if uniforms is not None:
            src = uniforms
        pas, pb = state["params"]["a"], state["params"]["b"]
        K = len(pas)
        zs, dzs = fresh["zs"], fresh["dzs"]
        damp = _damp(staleness)
        # the damping alone scales the fresh steps (a fill, no host copy)
        scale = None if damp is None else torch.full(
            (), damp, dtype=torch.float32, device=state["comm_rounds"].device)
        for i in range(K):
            state["opt"]["a"][i] = _opt_step(opt, pas[i], fresh["g_as"][i],
                                             state["opt"]["a"][i], scale)
        state["opt"]["b"] = _opt_step(opt, pb, fresh["g_b"],
                                      state["opt"]["b"], scale)
        # rounding uniforms of quantised tables: one key per party
        round_ = state["round"]
        for i in range(K):
            workset_insert(state["ws"]["a"][i],
                           {"z": zs[i], "dz": dzs[i], "batch": batches_a[i]},
                           batch_idx, key=insert_key(src, round_, i))
        workset_insert(state["ws"]["b"],
                       {"z": zs, "dz": dzs, "batch": batch_b}, batch_idx,
                       key=insert_key(src, round_, K))
        for s in state["steps"]["a"]:
            s.add_(1)
        state["steps"]["b"].add_(1)
        state["comm_rounds"].add_(1)
        state["round"] = round_ + 1
        state["transport"] = fresh["tstate"]
        return state, {"loss": fresh["loss"]}

    def local_scan(state, staleness=None, party_mask=None):
        # a masked party's draw factor is 0: its gate (K1) and its update
        # (K7 at scale 0) still launch, and its ring clocks (use_count,
        # cursor) still tick, as in the reference, so the draws of every
        # later step stay those of the unmasked schedule
        pas, pb = state["params"]["a"], state["params"]["b"]
        K = len(pas)
        dev = state["comm_rounds"].device
        if n_local == 0:
            return state, _zero_local_metrics(dev)
        dynamic = staleness is not None
        s_loc = s_pipe if staleness is None else int(staleness)
        damp = _damp(staleness)
        scale = float(np.float32(1.0 / (K + 1)))
        oas, wsas, wsb = state["opt"]["a"], state["ws"]["a"], state["ws"]["b"]
        nas = [_i32(dev) for _ in range(K)]
        nb = _i32(dev)
        w_mean_steps, w_zero_steps = [], []
        # the uniform draws' keys: the scan's round and local step, then
        # the party; the dynamic path folds the staleness in first, since
        # the depth-D queue can run several scans at one round
        round_ = state["round"]
        src = state["uniforms"] if uniforms is None else uniforms
        s_key = s_loc if dynamic else None

        def draw(ws, j, party):
            key = draw_key(src, round_, j, party, s_key) if uniform else None
            _, slot, _, valid = workset_draw(ws, celu.R, celu.sampling,
                                             rng=key,
                                             pipeline_staleness=s_loc)
            vf = valid.float()
            if party_mask is not None:
                vf = vf * party_mask[party]
            # the update's scale: the draw's mask, damped (exact: 0 or 1
            # times a float32)
            return slot, valid, vf, (vf if damp is None else vf * damp)

        def account(n, valid, vf, w, w_means, w_zeros):
            # out of place: under the fleet's vmap the count is batched
            w_means.append(w.mean())
            w_zeros.append((w == 0.0).float().mean())
            return n + (valid if party_mask is None
                        else vf > 0).to(torch.int32)

        for j in range(n_local):
            w_means, w_zeros = [], []
            for i in range(K):
                slot, valid, vf, uf = draw(wsas[i], j, i)
                g, w = local_grad_a_cached(
                    task.forward_a, pas[i], wsas[i], slot, cos_xi,
                    weighting=celu.weighting, cache_fused=celu.cache_fused,
                    mask=vf, pipeline_staleness=s_loc, dynamic=dynamic,
                    functional=fn)
                oas[i] = _opt_step(opt, pas[i], g, oas[i], uf)
                nas[i] = account(nas[i], valid, vf, w, w_means, w_zeros)

            slot_b, valid, vf, uf = draw(wsb, j, K)
            g, w = local_grad_b_cached(
                task.loss_b, pb, wsb, slot_b, cos_xi,
                weighting=celu.weighting, cache_fused=celu.cache_fused,
                mask=vf, pipeline_staleness=s_loc, dynamic=dynamic,
                functional=fn)
            state["opt"]["b"] = _opt_step(opt, pb, g, state["opt"]["b"], uf)
            nb = account(nb, valid, vf, w, w_means, w_zeros)
            w_mean_steps.append(sum(w_means) * scale)
            w_zero_steps.append(sum(w_zeros) * scale)

        for s, n in zip(state["steps"]["a"], nas):
            s.add_(n)
        state["steps"]["b"].add_(nb)
        return state, {"local_steps": sum(nas) + nb,
                       "w_mean": torch.stack(w_mean_steps).mean(),
                       "w_zero_frac": torch.stack(w_zero_steps).mean()}

    return exchange_compute, exchange_apply, local_scan


# --------------------------------------------------------------------------
# One full communication round (exchange + R local updates per party)
# --------------------------------------------------------------------------
def make_round(task: KPartyTask, opt: Optimizer, celu: CELUConfig, *,
               local_steps: int = -1, transport=None,
               compression: Optional[str] = None):
    """fn(state, batches_a: list, batch_b, batch_idx) -> (state, metrics).

    ``local_steps`` defaults to R; Vanilla training = ``local_steps=0``.
    ``transport`` defaults to :func:`make_transport` over ``celu`` (the
    compressed wire when ``compression`` or ``celu.compression`` names a
    codec).  The rounding uniforms come from the state's source
    (``init_state(uniforms=...)``).  The state is updated in place.
    Metrics are device tensors: reading one (``float(m["loss"])``) is the
    round's only host sync.

    This is the sequential schedule; a ``celu.pipeline_depth`` > 0 is
    refused here.  For the paper's two-worker overlap (and the depth-D
    queue) build the same stages through :func:`make_pipeline`."""
    if celu.pipeline_depth:
        raise ValueError(
            f"pipeline_depth={celu.pipeline_depth}: make_round is the "
            f"sequential schedule; build the pipelined scheduler with "
            f"make_pipeline")
    n_local = celu.R if local_steps < 0 else local_steps
    tp = transport if transport is not None \
        else make_transport(celu, compression)
    exchange_compute, exchange_apply, local_scan = _make_stages(
        task, opt, celu, n_local=n_local, tp=tp)

    def round_fn(state, batches_a, batch_b, batch_idx):
        src = state["uniforms"]
        with torch.enable_grad():
            fresh = exchange_compute(state["params"],
                                     state.get("transport", {}), batches_a,
                                     batch_b, state["round"], src)
            state, m = exchange_apply(state, fresh, batches_a, batch_b,
                                      batch_idx, src)
            state, lm = local_scan(state)
        m.update(lm)
        return state, m

    return round_fn


# --------------------------------------------------------------------------
# The pipelined scheduler (paper §4.1 Fig. 4, generalised to a D-deep
# exchange queue)
# --------------------------------------------------------------------------
class PendingExchange(NamedTuple):
    """An in-flight exchange: one slot of the scheduler's queue.

    ``fresh`` is ``exchange_compute``'s payload: the wire values
    ⟨Z_i, ∇Z_i⟩ that the merge inserts, the fresh gradients, Party B's
    loss and the transport's updated residuals (adopted at the merge).
    Every tensor in it was made by the dispatch, so no later local scan,
    insert or merge writes it.  The batches ride along for the deferred
    insert.  ``dispatched_at`` is the number of merges done at dispatch (a
    host int): the merge charges the fresh gradients
    ``round - dispatched_at`` exchanges of staleness (D - 1 at steady
    state)."""
    fresh: Dict[str, Any]
    batches_a: Sequence[Any]
    batch_b: Any
    batch_idx: Any
    dispatched_at: int = 0


class RoundState(NamedTuple):
    """The scheduler's round state: the fields of :func:`init_state`'s
    dict (convert with :meth:`from_state` / :meth:`as_state`) and
    ``pending``, the in-flight exchanges, oldest first (at most
    ``max(depth, 1)``; ``()`` when none is in flight).

    The stages update the tensors in place, so a ``RoundState`` that a
    stage returns supersedes the one it was given: the old one shares
    the mutated parameters, optimizer state and rings."""
    params: Dict[str, Any]
    opt: Dict[str, Any]
    ws: Dict[str, Any]
    steps: Dict[str, Any]
    comm_rounds: torch.Tensor
    round: int
    uniforms: Any
    transport: Dict[str, Any]
    pending: Tuple[PendingExchange, ...] = ()

    @classmethod
    def from_state(cls, state: Dict[str, Any],
                   pending: Tuple[PendingExchange, ...] = ()
                   ) -> "RoundState":
        return cls(params=state["params"], opt=state["opt"], ws=state["ws"],
                   steps=state["steps"], comm_rounds=state["comm_rounds"],
                   round=state["round"], uniforms=state["uniforms"],
                   transport=state.get("transport", {}), pending=pending)

    def as_state(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.opt, "ws": self.ws,
                "steps": self.steps, "comm_rounds": self.comm_rounds,
                "round": self.round, "uniforms": self.uniforms,
                "transport": self.transport}


class PipelinedEngine:
    """The round as explicit stages: the paper's two-worker pipeline,
    generalised to a depth-D exchange queue.

    Depth 0 runs dispatch, merge and the local scan in turn and is
    bitwise :func:`make_round`.  Depth 1 dispatches round t+1's exchange
    and runs round t's local scan while it is in flight::

        dispatch(batch t+1)   # exchange_compute: the wire and fresh grads
        local()               # round t's R local updates (the overlap)
        merge()               # adopt the exchange: fresh step + insert

    Depth D >= 2 keeps up to D exchanges in flight (``rs.pending``, oldest
    first): each step dispatches, scans with the whole queue in flight,
    and merges the oldest once the queue holds D, so an exchange rides
    the wire for D local scans.  The first D - 1 steps only fill the
    queue (their ``loss`` is NaN); :meth:`flush` drains it, scan and merge
    in turn, so every inserted batch still gets its scan.

    The overlap is at dispatch: the stages are eager launches on one
    stream and nothing waits for the card between them, so the local
    scan's kernels queue behind the exchange's with no host barrier; the
    simulated WAN clock (``launch/wan.py``) charges the D-deep schedule.
    The cost is staleness, charged per slot at depth >= 2 (the
    ``dynamic`` path; ``dynamic_staleness=True`` forces it at any
    depth): a scan is charged the in-flight count (a host int), which
    tightens the workset's validity window, discounts the weights
    ``w -> w^(1+s)`` and damps the local steps by ``1 / (1 + c·s)``
    (``CELUConfig.pipeline_lr_damping``); a merge is charged its
    exchange's age.  Depths 0 / 1 keep the static path.

    Drive it as::

        pe = make_pipeline(task, opt, celu, depth=2)
        rs = pe.init(engine.init_state(...))
        for bi, ba, bb in batches:
            rs, m = pe.step(rs, ba, bb, bi)
        rs, m = pe.flush(rs)          # drain the in-flight queue
        state = pe.finalize(rs)
    """

    def __init__(self, task: KPartyTask, opt: Optimizer, celu: CELUConfig,
                 *, depth: Optional[int] = None, local_steps: int = -1,
                 transport=None, compression: Optional[str] = None,
                 dynamic_staleness: Optional[bool] = None):
        if depth is None:
            depth = celu.pipeline_depth
        validate_pipeline_depth(depth, celu.W)
        self.depth = depth
        self.celu = celu
        self.dynamic = (depth >= 2) if dynamic_staleness is None \
            else bool(dynamic_staleness)
        self.n_local = celu.R if local_steps < 0 else local_steps
        self.transport = transport if transport is not None \
            else make_transport(celu, compression)
        self._compute, self._apply, self._scan = _make_stages(
            task, opt, celu, n_local=self.n_local, tp=self.transport,
            pipeline_staleness=depth,
            lr_damping=celu.pipeline_lr_damping if self.dynamic else 0.0)

    @property
    def queue_capacity(self) -> int:
        """Most exchanges in flight (depth 0 still holds the one exchange
        between its dispatch and its merge)."""
        return max(self.depth, 1)

    # ---- stages ----------------------------------------------------------
    def init(self, state: Dict[str, Any]) -> RoundState:
        """Adopt an :func:`init_state` dict."""
        return RoundState.from_state(state)

    def dispatch(self, rs: RoundState, batches_a, batch_b, batch_idx, *,
                 wire_round: Optional[int] = None) -> RoundState:
        """Start an exchange from the current parameters and append it to
        the queue.  Its wire sends are keyed by the dispatch's sequence
        number (merges done + in flight, or ``wire_round``, a host int:
        the chaos engine's own count, so that a resend after a drop never
        reuses the dropped release's uniforms), and it encodes against
        the newest in-flight exchange's residuals: the error-feedback
        chain follows dispatch order."""
        if len(rs.pending) >= self.queue_capacity:
            raise RuntimeError(
                f"{len(rs.pending)} exchange(s) already in flight: the "
                f"depth-{self.depth} queue holds at most "
                f"{self.queue_capacity}; merge() the oldest before "
                f"dispatching another")
        tstate = rs.pending[-1].fresh["tstate"] if rs.pending \
            else rs.transport
        with torch.enable_grad():
            fresh = self._compute(rs.params, tstate, batches_a, batch_b,
                                  rs.round + len(rs.pending)
                                  if wire_round is None else wire_round,
                                  rs.uniforms)
        pe = PendingExchange(fresh, batches_a, batch_b, batch_idx,
                             dispatched_at=rs.round)
        return rs._replace(pending=rs.pending + (pe,))

    def local(self, rs: RoundState, *, staleness: Optional[int] = None,
              party_mask=None) -> Tuple[RoundState, Dict[str, Any]]:
        """The R local updates per party against the rings as of the last
        merge.  On the dynamic path the scan is charged the in-flight
        count; ``staleness`` (a host int) replaces that charge and
        ``party_mask`` ((K+1,) float32 on the round's device) freezes
        parties that are down.  Both are the chaos engine's hooks and
        need the dynamic path."""
        if (staleness is not None or party_mask is not None) \
                and not self.dynamic:
            raise RuntimeError(
                "staleness/party_mask overrides need the dynamic stage "
                "plumbing: build the engine with dynamic_staleness=True")
        s = None
        if self.dynamic:
            s = len(rs.pending) if staleness is None else int(staleness)
        with torch.enable_grad():
            state, lm = self._scan(rs.as_state(), s, party_mask)
        return RoundState.from_state(state, rs.pending), lm

    def merge(self, rs: RoundState, *, staleness: Optional[int] = None
              ) -> Tuple[RoundState, Dict[str, Any]]:
        """Adopt the oldest in-flight exchange: the fresh optimizer steps,
        applied to the parameters as they are now (damped by the
        exchange's age on the dynamic path), the inserts, the residuals
        and the counters.  ``staleness`` (a host int, dynamic path only)
        replaces the age: the chaos engine charges the true age in
        scheduler rounds."""
        if not rs.pending:
            raise RuntimeError("no exchange in flight: dispatch() first")
        p, rest = rs.pending[0], rs.pending[1:]
        if staleness is not None and not self.dynamic:
            raise RuntimeError(
                "staleness override needs the dynamic stage plumbing: "
                "build the engine with dynamic_staleness=True")
        s = None
        if self.dynamic:
            s = rs.round - p.dispatched_at if staleness is None \
                else int(staleness)
        with torch.enable_grad():
            state, m = self._apply(rs.as_state(), p.fresh, p.batches_a,
                                   p.batch_b, p.batch_idx, rs.uniforms, s)
        return RoundState.from_state(state, rest), m

    # ---- schedules -------------------------------------------------------
    def step(self, rs: RoundState, batches_a, batch_b, batch_idx
             ) -> Tuple[RoundState, Dict[str, Any]]:
        """One communication round.  Depth 0: exchange, then the local
        scan.  Depth 1: the previous round's scan runs between this
        round's dispatch and merge.  Depth D >= 2: dispatch, scan with the
        queue in flight, merge the oldest once the queue holds D (the
        first D - 1 steps report a NaN ``loss``)."""
        rs = self.dispatch(rs, batches_a, batch_b, batch_idx)
        if self.depth == 0:
            rs, m = self.merge(rs)
            rs, lm = self.local(rs)
        elif self.depth == 1:
            rs, lm = self.local(rs)
            rs, m = self.merge(rs)
        else:
            rs, lm = self.local(rs)
            if len(rs.pending) == self.depth:
                rs, m = self.merge(rs)
            else:       # warm-up: the queue is filling
                m = {"loss": torch.full((), float("nan"),
                                        device=rs.comm_rounds.device)}
        m.update(lm)
        return rs, m

    def flush(self, rs: RoundState) -> Tuple[RoundState, Dict[str, Any]]:
        """Drain the pipeline.  Depth 0: nothing to do; depth 1: the one
        scan the last merge still owes; depth >= 2: scan and merge in
        turn until the queue is empty, then one more scan."""
        if self.depth == 0:
            return rs, _zero_local_metrics(rs.comm_rounds.device)
        if self.depth == 1:
            return self.local(rs)
        scans = []
        while rs.pending:
            rs, lm = self.local(rs)
            scans.append(lm)
            rs, _ = self.merge(rs)
        rs, lm = self.local(rs)
        scans.append(lm)
        n = len(scans)
        return rs, {
            "local_steps": sum(m["local_steps"] for m in scans),
            "w_mean": sum(m["w_mean"] for m in scans) / n,
            "w_zero_frac": sum(m["w_zero_frac"] for m in scans) / n,
        }

    def finalize(self, rs: RoundState) -> Dict[str, Any]:
        """Back to :func:`init_state`'s dict."""
        if rs.pending:
            raise RuntimeError(
                f"{len(rs.pending)} exchange(s) still in flight: merge() "
                f"(or flush()) before finalizing")
        return rs.as_state()


def make_pipeline(task: KPartyTask, opt: Optimizer, celu: CELUConfig, *,
                  depth: Optional[int] = None, local_steps: int = -1,
                  transport=None, compression: Optional[str] = None
                  ) -> PipelinedEngine:
    """The staged round scheduler.  ``depth`` defaults to
    ``celu.pipeline_depth``: 0 is :func:`make_round`'s sequential round,
    1 overlaps round t+1's exchange with round t's local updates (paper
    §4.1), D >= 2 keeps a D-deep queue with per-slot staleness and
    damping (:class:`PipelinedEngine`).  ``depth`` must stay < ``celu.W``.
    """
    return PipelinedEngine(task, opt, celu, depth=depth,
                           local_steps=local_steps, transport=transport,
                           compression=compression)


def preset_config(name: str, base: CELUConfig) -> Tuple[CELUConfig, int]:
    """-> (celu_cfg, local_steps) for name in {vanilla, fedbcd, celu}."""
    if name == "vanilla":
        return dataclasses.replace(base, weighting=False), 0
    if name == "fedbcd":
        return dataclasses.replace(base, W=1, weighting=False,
                                   sampling="consecutive"), base.R
    if name == "celu":
        return base, base.R
    raise ValueError(name)


# --------------------------------------------------------------------------
# Party-to-pod round (PodTransport between the pod ranks)
# --------------------------------------------------------------------------
def make_pod_round(mesh, opt: Optimizer, *, R: int, cos_xi: float,
                   weighting: bool = True, tower_fwd=None, top_loss=None,
                   transport: Optional[PodTransport] = None,
                   pipeline_depth: int = 0):
    """Build the party-to-pod CELU round; it runs in every pod's process.

    Rank p of the pod group (``mesh``'s ``"pod"`` dimension, or the world
    when ``mesh`` is None) holds party p: its slice of the reference's
    party-stacked state.  ``tower_fwd(tower, x) -> Z`` and
    ``top_loss(top, z_a, z_b, y) -> per-instance loss`` define the model
    (``core.pod_protocol`` has the WDL demo); a pod's parameters are one
    module with ``tower`` and ``top`` children, and pod 0's ``top`` is a
    dead copy that gets zero gradients.

    The round, ``round_fn(party, opt_state, ws, x, y) -> (party,
    opt_state, ws, loss)``, takes this pod's features ``x`` (B, F) and
    label slot ``y`` (B,) and updates the state in place.  Each pod
    computes only its own branch of the reference's ``jnp.where(pod ==
    0, ...)``: the selected values are the same.  The exchange is the
    transport's up and down permutes, the only traffic between pods.

    ``pipeline_depth=1`` starts the up permute, runs the R local updates
    against the previous rounds' workset and the dispatch-time parameters,
    then waits for the permute; the fresh gradients are taken at the
    dispatch-time parameters (a copy) and applied to the post-scan ones.
    Depth 0 is the sequential schedule: exchange, update, insert, then the
    local updates over the refreshed workset.

    The gate runs through :func:`weighted_cotangent` (Party A, K2a) and
    :func:`staleness_weights` (Party B, K2b); every update is one
    :func:`_opt_step` over the pod's tensors (AdaGrad's kernel route: one
    K7 launch)."""
    if pipeline_depth not in (0, 1):
        raise ValueError(
            f"make_pod_round supports pipeline_depth 0 or 1 (got "
            f"{pipeline_depth}): the D-deep exchange queue is scheduled on "
            f"the host by PipelinedEngine, which keeps the in-flight "
            f"exchanges between its stage calls; the pod round runs one "
            f"exchange a round.  Use make_pipeline / PipelinedEngine for "
            f"D >= 2, or depth 1 here (the overlapped two-worker "
            f"schedule).")
    assert tower_fwd is not None and top_loss is not None
    tp = transport if transport is not None else PodTransport(
        group=None if mesh is None else mesh.get_group("pod"))
    depth = pipeline_depth

    def b_loss(party, z_list, batch):
        """Party B's towers as a K-party ``loss_b`` over its module."""
        z_b = tower_fwd(party.tower, batch["x"])
        return top_loss(party.top, z_list[0], z_b, batch["y"]), 0.0

    def zeros_top(party):
        return [torch.zeros_like(p) for p in _params(party.top)]

    def local_scan(party, opt_state, ws, is_a):
        W = ws["z"].shape[0]
        n_alive = max(min(ws["time"], W), 1)
        for j in range(R):
            slot = j % n_alive
            zs, dzs = ws["z"][slot].float(), ws["dz"][slot].float()
            xs, ys = ws["x"][slot], ws["y"][slot]
            if is_a:
                g_tower, _ = local_grad_a(
                    tower_fwd, party.tower, {"z": zs, "dz": dzs,
                                             "batch": xs},
                    cos_xi, weighting=weighting, pipeline_staleness=depth)
                grads = zeros_top(party) + list(g_tower)
            else:
                grads, _ = local_grad_b(
                    b_loss, party, {"z": [zs], "dz": [dzs],
                                    "batch": {"x": xs, "y": ys}},
                    cos_xi, weighting=weighting, pipeline_staleness=depth)
            opt_state = _opt_step(opt, party, grads, opt_state)
        return opt_state

    def round_fn(party, opt_state, ws, x, y):
        is_a = tp.pod() == 0
        # the fresh exchange reads the dispatch-time parameters; at depth 1
        # the scan updates the pod's own in place meanwhile
        fresh = copy.deepcopy(party) if depth else party
        tower_p = _params(fresh.tower)
        z_mine = tower_fwd(fresh.tower, x)
        pending = tp.start_up(z_mine)        # pod 1 receives Z_A
        if depth:
            opt_state = local_scan(party, opt_state, ws, is_a)
        z_other = pending.wait().detach().requires_grad_(True)
        loss = top_loss(fresh.top, z_other, z_mine, y).mean()
        if is_a:
            # pod 0's top is dead: only its ∇ of the received Z goes down
            (dz_sent,) = torch.autograd.grad(loss, [z_other],
                                             retain_graph=True)
            dz_back = tp.send_down(dz_sent)  # ∇Z_A from pod 1
            g_tower = torch.autograd.grad(z_mine, tower_p,
                                          grad_outputs=dz_back)
            grads = zeros_top(fresh) + list(g_tower)
            z_cache, dz_cache = z_mine.detach(), dz_back
        else:
            g = torch.autograd.grad(loss, _params(fresh) + [z_other])
            grads, dz_sent = list(g[:-1]), g[-1]
            tp.send_down(dz_sent)
            z_cache, dz_cache = z_other.detach(), dz_sent
        opt_state = _opt_step(opt, party, grads, opt_state)

        with torch.no_grad():
            W = ws["z"].shape[0]
            slot = ws["time"] % W
            ws["z"][slot] = z_cache.to(ws["z"].dtype)
            ws["dz"][slot] = dz_cache.to(ws["dz"].dtype)
            ws["x"][slot] = x
            ws["y"][slot] = y
            ws["time"] += 1
        if not depth:
            opt_state = local_scan(party, opt_state, ws, is_a)
        return party, opt_state, ws, loss.detach()

    return round_fn
