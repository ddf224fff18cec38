"""The K-party CELU-VFL round engine (paper Algorithms 1-2), sequential
schedule.

Port of the sequential half of ``repro/core/engine.py``.  A *round*
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
    CPU their plain versions.

The pipelined scheduler, the compressed wire, DP and the quantised caches
are later slices of the port (ROADMAP.md) and raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from ..configs.base import CELUConfig
from ..kernels import ops as kops
from ..optim import Optimizer, apply_updates
from .weighting import xi_to_cos
from .workset import (tree_map, workset_draw, workset_entry, workset_init,
                      workset_insert)


class KPartyTask(NamedTuple):
    """K-party split-model interface (no function sees two parties' raw
    features):

        forward_a(params_a_i, batch_a_i) -> Z_i
        loss_b(params_b, [Z_1..Z_K], batch_b) -> (per-instance loss, aux)

    ``params_*`` are the parties' ``nn.Module``s."""
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
    through the wire dtype (simulating quantised transmission); byte
    accounting follows the wire precision.  The wire value is what both
    sides see and what gets cached."""

    def __init__(self, celu: CELUConfig):
        if celu.dp_sigma > 0.0:
            raise NotImplementedError(
                "DP on the wire (dp_sigma > 0) comes with slice 3 of the "
                "port (ROADMAP.md)")
        if celu.wire_dtype not in _WIRE_DTYPES:
            raise ValueError(f"wire_dtype must be one of "
                             f"{tuple(_WIRE_DTYPES)}, got "
                             f"{celu.wire_dtype!r}")
        self.celu = celu
        self.wire = _WIRE_DTYPES[celu.wire_dtype]

    def init_state(self, z_examples: Sequence) -> Dict[str, Any]:
        return {}

    def _wire_cast(self, x):
        if x.dtype != self.wire:
            x = x.to(self.wire).to(x.dtype)
        return x

    def send(self, rng, x, res=None, direction: str = "up"):
        """The message released across the link -> (wire value, residual).
        ``rng`` is the reference's DP key, unused without DP."""
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


def make_transport(celu: CELUConfig, compression: Optional[str] = None):
    """Transport for the simulated WAN.  Only the plain wire (``""``) and
    the identity codec, which is the same wire, exist in this slice."""
    name = celu.compression if compression is None else compression
    if name in ("", "identity"):
        return SimWANTransport(celu)
    raise NotImplementedError(
        f"compression={name!r}: the compressed wire comes with slice 3 of "
        f"the port (ROADMAP.md)")


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


def weighted_cotangent(ad_hoc, stale, dz, cos_xi: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InsWeight + weights ⊙ ∇Z -> (weights (B,), fp32 weighted
    cotangent) (K2a)."""
    return kops.weighted_cotangent(ad_hoc, stale, dz.float(), cos_xi)


# --------------------------------------------------------------------------
# Local-update gradients (Algorithm 2)
# --------------------------------------------------------------------------
def _params(module) -> list:
    return list(module.parameters())


def _take(ws_leaf, idx):
    return ws_leaf.index_select(0, idx)[0]


def _backward_a(z_new, params_a, w, cot, mask):
    if mask is not None:
        w = w * mask
        cot = cot * mask
    g = torch.autograd.grad(z_new, _params(params_a),
                            grad_outputs=cot.to(z_new.dtype))
    return g, w


def _grad_a_tail(z_new, params_a, stale_z, stale_dz, cos_xi: float, *,
                 weighting: bool, mask):
    """Feature-party update once the stale statistics are materialised:
    InsWeight + cotangent scale + backward."""
    if weighting:
        w, cot = weighted_cotangent(z_new.detach(), stale_z, stale_dz,
                                    cos_xi)
    else:
        w = torch.ones(z_new.shape[0], device=z_new.device)
        cot = _bcast(w, z_new) * stale_dz.float()
    return _backward_a(z_new, params_a, w, cot, mask)


def local_grad_a(forward_a, params_a, entry, cos_xi: float, *,
                 weighting: bool = True, mask=None):
    """Feature-party local update on a materialised workset entry
    {"z", "dz", "batch"}.  ``mask`` (0-d 0/1 tensor) zeroes a bubble
    draw.  Returns (grads, weights)."""
    z_new = forward_a(params_a, entry["batch"])
    return _grad_a_tail(z_new, params_a, entry["z"], entry["dz"], cos_xi,
                        weighting=weighting, mask=mask)


def local_grad_a_cached(forward_a, params_a, ws, slot, cos_xi: float, *,
                        weighting: bool = True, cache_fused: bool = True,
                        mask=None):
    """Feature-party local update straight off the workset ring.  Only the
    party's own cached features are gathered; with ``cache_fused`` the cut
    statistics ⟨Z, ∇Z⟩ go through the fused ring-sample kernel (K1) and
    no copy of the entry is made.  Otherwise the entry is materialised and
    weighted by K2a.  Returns (grads, weights)."""
    buf = ws["buf"]
    idx = slot.reshape(1).long()
    batch = tree_map(lambda b: _take(b, idx), buf["batch"])
    z_new = forward_a(params_a, batch)
    if weighting and cache_fused:
        w, cot = kops.fused_gather_weight(slot, z_new.detach(), buf["z"],
                                          buf["dz"], cos_xi)
        return _backward_a(z_new, params_a, w, cot, mask)
    entry = workset_entry(ws, slot)
    return _grad_a_tail(z_new, params_a, entry["z"], entry["dz"], cos_xi,
                        weighting=weighting, mask=mask)


def _weighted_grad_b(loss_b, params_b, zs, batch_b, w):
    li, aux = loss_b(params_b, zs, batch_b)
    return torch.autograd.grad((w * li).mean() + aux, _params(params_b))


def _ad_hoc_dz(loss_b, params_b, zs, batch_b):
    """∇Z_i of the mean loss at the cached Z_i (paper footnote 2): the
    first of Party B's two autograd passes, used only for the weights."""
    zl = [z.float().detach().requires_grad_(True) for z in zs]
    li, _ = loss_b(params_b, zl, batch_b)
    return torch.autograd.grad(li.mean(), zl)


def local_grad_b(loss_b, params_b, entry, cos_xi: float, *,
                 weighting: bool = True, mask=None):
    """Label-party local update on a materialised entry: stale Z_i's +
    own features; the ad-hoc ∇Z_i only measure staleness, then the
    weighted per-instance losses drive the backward pass.  K>1: the
    weight is the minimum cosine over parties.  Returns (grads, weights)."""
    zs, dzs, batch_b = entry["z"], entry["dz"], entry["batch"]
    if weighting:
        dz_new = _ad_hoc_dz(loss_b, params_b, zs, batch_b)
        w = staleness_weights(dz_new[0], dzs[0], cos_xi)
        for i in range(1, len(zs)):
            w = torch.minimum(w, staleness_weights(dz_new[i], dzs[i], cos_xi))
    else:
        w = torch.ones(zs[0].shape[0], device=zs[0].device)
    if mask is not None:
        w = w * mask
    return _weighted_grad_b(loss_b, params_b, zs, batch_b, w), w


def local_grad_b_cached(loss_b, params_b, ws, slot, cos_xi: float, *,
                        weighting: bool = True, cache_fused: bool = True,
                        mask=None):
    """Label-party local update straight off the workset ring.  The loss
    consumes the cached Z list, so it is gathered; with ``cache_fused``
    the ∇Z side is read by the weights-only ring kernel (K1) and never
    gathered, otherwise it is materialised and weighted by K2b.  Returns
    (grads, weights)."""
    buf = ws["buf"]
    idx = slot.reshape(1).long()
    batch_b = tree_map(lambda b: _take(b, idx), buf["batch"])
    zs = [_take(z, idx) for z in buf["z"]]
    if weighting:
        dz_new = _ad_hoc_dz(loss_b, params_b, zs, batch_b)
        if cache_fused:
            stale = buf["dz"]
            weigh = lambda i: kops.fused_gather_weights(  # noqa: E731
                slot, dz_new[i], stale[i], cos_xi)
        else:
            stale = [_take(d, idx) for d in buf["dz"]]
            weigh = lambda i: staleness_weights(  # noqa: E731
                dz_new[i], stale[i], cos_xi)
        w = weigh(0)
        for i in range(1, len(zs)):
            w = torch.minimum(w, weigh(i))
    else:
        w = torch.ones(zs[0].shape[0], device=zs[0].device)
    if mask is not None:
        w = w * mask
    return _weighted_grad_b(loss_b, params_b, zs, batch_b, w), w


# --------------------------------------------------------------------------
# State
# --------------------------------------------------------------------------
def _i32(device):
    return torch.zeros((), dtype=torch.int32, device=device)


@torch.no_grad()
def init_state(task: KPartyTask, params: Dict[str, Any], opt: Optimizer,
               celu: CELUConfig, batches_a: Sequence[Any], batch_b,
               transport=None, compression: Optional[str] = None):
    """Build the K-party training state on the device of ``params`` and
    the example batches, which size the workset rings.
    ``params = {"a": [pa_1..pa_K], "b": pb}`` (modules)."""
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
        "transport": (transport if transport is not None
                      else make_transport(celu, compression)
                      ).init_state(z_like),
    }


# --------------------------------------------------------------------------
# The round stages
# --------------------------------------------------------------------------
def _opt_step(opt, module, grads, opt_state, scale=None):
    """One optimizer update of ``module`` in place -> new opt state.
    ``scale`` (0-d tensor) multiplies the update before it is applied."""
    params = _params(module)
    upd, opt_state = opt.update(grads, opt_state, params)
    if scale is not None:
        upd = [u * scale for u in upd]
    apply_updates(params, upd)
    return opt_state


def _make_stages(task: KPartyTask, opt: Optimizer, celu: CELUConfig, *,
                 n_local: int, tp):
    """The round's stages over the shared state layout:

      * ``exchange_compute(params, tstate, batches_a, batch_b,
        comm_rounds)`` — party forwards, the wire up (Z_i) and down
        (∇Z_i), Party B's loss and every fresh gradient, without touching
        the state;
      * ``exchange_apply(state, fresh, batches_a, batch_b, batch_idx)`` —
        fresh optimizer steps, workset inserts, counters;
      * ``local_scan(state)`` — the R staleness-weighted local updates
        per party (Algorithm 2)."""
    if celu.sampling not in ("round_robin", "consecutive"):
        raise NotImplementedError(
            f"sampling={celu.sampling!r}: uniform sampling comes with "
            f"slice 2 of the port (ROADMAP.md)")
    cos_xi = xi_to_cos(celu.xi_degrees)

    def exchange_compute(params, tstate, batches_a, batch_b, comm_rounds):
        pas, pb = params["a"], params["b"]
        K = len(pas)
        # uplinks: every A_i's forward -> Z_i, released in wire precision;
        # the wire value becomes a fresh leaf on Party B's side
        z_out, zs = [], []
        for i in range(K):
            z = task.forward_a(pas[i], batches_a[i])
            z_out.append(z)
            zs.append(tp.send(None, z.detach(), None, "up")[0])
        z_leaves = [z.detach().requires_grad_(True) for z in zs]

        # Party B: loss + grads wrt (params_b, all Z_i) in one pass
        li, aux = task.loss_b(pb, z_leaves, batch_b)
        loss = li.mean() + aux
        pb_params = _params(pb)
        grads = torch.autograd.grad(loss, pb_params + z_leaves)
        g_b = grads[:len(pb_params)]
        dzs = [tp.send(None, dz, None, "down")[0]
               for dz in grads[len(pb_params):]]

        # every A_i's backward with its (wire-precision) cotangent
        g_as = [torch.autograd.grad(z_out[i], _params(pas[i]),
                                    grad_outputs=dzs[i].to(z_out[i].dtype))
                for i in range(K)]
        return {"zs": zs, "dzs": dzs, "g_as": g_as, "g_b": g_b,
                "loss": loss.detach(), "tstate": tstate}

    def exchange_apply(state, fresh, batches_a, batch_b, batch_idx):
        pas, pb = state["params"]["a"], state["params"]["b"]
        K = len(pas)
        zs, dzs = fresh["zs"], fresh["dzs"]
        for i in range(K):
            state["opt"]["a"][i] = _opt_step(opt, pas[i], fresh["g_as"][i],
                                             state["opt"]["a"][i])
        state["opt"]["b"] = _opt_step(opt, pb, fresh["g_b"],
                                      state["opt"]["b"])
        for i in range(K):
            workset_insert(state["ws"]["a"][i],
                           {"z": zs[i], "dz": dzs[i], "batch": batches_a[i]},
                           batch_idx)
        workset_insert(state["ws"]["b"],
                       {"z": zs, "dz": dzs, "batch": batch_b}, batch_idx)
        for s in state["steps"]["a"]:
            s.add_(1)
        state["steps"]["b"].add_(1)
        state["comm_rounds"].add_(1)
        state["transport"] = fresh["tstate"]
        return state, {"loss": fresh["loss"]}

    def local_scan(state):
        pas, pb = state["params"]["a"], state["params"]["b"]
        K = len(pas)
        dev = state["comm_rounds"].device
        if n_local == 0:
            zero = torch.zeros((), device=dev)
            return state, {"local_steps": _i32(dev), "w_mean": zero,
                           "w_zero_frac": zero}
        scale = float(np.float32(1.0 / (K + 1)))
        oas, wsas, wsb = state["opt"]["a"], state["ws"]["a"], state["ws"]["b"]
        nas = [_i32(dev) for _ in range(K)]
        nb = _i32(dev)
        w_mean_steps, w_zero_steps = [], []

        def account(n, valid, w, w_means, w_zeros):
            n.add_(valid.to(torch.int32))
            w_means.append(w.mean())
            w_zeros.append((w == 0.0).float().mean())

        for _ in range(n_local):
            w_means, w_zeros = [], []
            for i in range(K):
                _, slot, _, valid = workset_draw(wsas[i], celu.R,
                                                 celu.sampling)
                vf = valid.float()
                g, w = local_grad_a_cached(
                    task.forward_a, pas[i], wsas[i], slot, cos_xi,
                    weighting=celu.weighting, cache_fused=celu.cache_fused,
                    mask=vf)
                oas[i] = _opt_step(opt, pas[i], g, oas[i], vf)
                account(nas[i], valid, w, w_means, w_zeros)

            _, slot_b, _, valid = workset_draw(wsb, celu.R, celu.sampling)
            vf = valid.float()
            g, w = local_grad_b_cached(
                task.loss_b, pb, wsb, slot_b, cos_xi,
                weighting=celu.weighting, cache_fused=celu.cache_fused,
                mask=vf)
            state["opt"]["b"] = _opt_step(opt, pb, g, state["opt"]["b"], vf)
            account(nb, valid, w, w_means, w_zeros)
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
    The state is updated in place.  Metrics are device tensors: reading
    one (``float(m["loss"])``) is the round's only host sync."""
    if celu.pipeline_depth:
        raise NotImplementedError(
            "pipeline_depth > 0: the pipelined scheduler comes with slice 2 "
            "of the port (ROADMAP.md)")
    n_local = celu.R if local_steps < 0 else local_steps
    tp = transport if transport is not None \
        else make_transport(celu, compression)
    exchange_compute, exchange_apply, local_scan = _make_stages(
        task, opt, celu, n_local=n_local, tp=tp)

    def round_fn(state, batches_a, batch_b, batch_idx):
        with torch.enable_grad():
            fresh = exchange_compute(state["params"],
                                     state.get("transport", {}), batches_a,
                                     batch_b, state["comm_rounds"])
            state, m = exchange_apply(state, fresh, batches_a, batch_b,
                                      batch_idx)
            state, lm = local_scan(state)
        m.update(lm)
        return state, m

    return round_fn


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
