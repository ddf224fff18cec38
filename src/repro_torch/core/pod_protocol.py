"""Party-to-pod mapping: CELU-VFL with each party on its own pod.

Port of ``repro/core/pod_protocol.py``.  Party A lives on pod 0, Party B
on pod 1; a pod is one process (one rank of the pod group), and the slow
link between pods plays the paper's WAN.  The cut-tensor exchange
⟨Z_A, ∇Z_A⟩ is a pair of permutes between the pod ranks
(``engine.PodTransport``), the only traffic between pods: the local
updates read each pod's own workset ring, so the bytes between pods per
model update drop by about (R+1)×.

The round itself is :func:`repro_torch.core.engine.make_pod_round`.  This
module keeps the demo model, the paper's WDL DLRM with equal-width towers
(field counts padded to max(F_A, F_B) with dead fields, so both parties'
towers have one shape).  The reference keeps both parties' parameters in
one party-stacked pytree whose leading axis is sharded over ``pod``; here
:func:`stacked_wdl_init` draws that stacked tree and :func:`init_pod_state`
gives each rank its own party's slice as a module (``tower`` and ``top``;
pod 0's ``top`` is the stacked tree's dead copy, which never receives a
gradient).  Labels ride Party B's feature slot, so pod 0 never sees them.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch
from torch import nn

from .. import resolve_device
from ..optim import Optimizer
from . import engine
from .engine import PodTransport  # noqa: F401  (the reference's import site)

TOWER_KEYS = ("embed", "w1", "b1", "w2", "b2")
TOP_KEYS = ("w1", "b1", "w2", "b2")


# --------------------------------------------------------------------------
# Party-stacked WDL: tower parameters with a leading party axis (2, ...)
# --------------------------------------------------------------------------
def stacked_wdl_init(gen: torch.Generator, n_fields: int, vocab: int,
                     embed_dim: int, z_dim: int, hidden: int
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Both parties' towers and the top model in one tree, leading axis =
    party (2,), drawn from ``gen`` with the reference's distributions."""
    def uniform(shape, lim):
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * lim

    def one():
        lim1 = 1.0 / math.sqrt(float(n_fields * embed_dim))
        lim2 = 1.0 / math.sqrt(float(hidden))
        return {
            "embed": torch.randn((n_fields, vocab, embed_dim),
                                 generator=gen) * 0.01,
            "w1": uniform((n_fields * embed_dim, hidden), lim1),
            "b1": torch.zeros(hidden),
            "w2": uniform((hidden, z_dim), lim2),
            "b2": torch.zeros(z_dim),
        }
    a, b = one(), one()
    lim = 1.0 / math.sqrt(float(2 * z_dim))
    top = {
        "w1": uniform((2, 2 * z_dim, z_dim), lim),
        "b1": torch.zeros((2, z_dim)),
        "w2": torch.randn((2, z_dim, 1), generator=gen) * 0.01,
        "b2": torch.zeros((2, 1)),
    }
    return {"tower": {k: torch.stack([a[k], b[k]]) for k in TOWER_KEYS},
            "top": top}


class _Leaves(nn.Module):
    """A dict of tensors as a module's parameters (attribute access)."""

    def __init__(self, leaves: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in leaves.items():
            self.register_parameter(k, nn.Parameter(v))


class PodParty(nn.Module):
    """One pod's party: its ``tower`` and the ``top`` model (live on pod 1,
    a dead copy on pod 0)."""

    def __init__(self, tower: Dict[str, torch.Tensor],
                 top: Dict[str, torch.Tensor]):
        super().__init__()
        self.tower = _Leaves(tower)
        self.top = _Leaves(top)

    def tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"tower": {k: getattr(self.tower, k) for k in TOWER_KEYS},
                "top": {k: getattr(self.top, k) for k in TOP_KEYS}}


def pod_party(stacked, pod: int, device=None) -> PodParty:
    """Pod ``pod``'s slice of a party-stacked tree, as a module (copies)."""
    def take(t):
        return t[pod].detach().clone().to(device)
    return PodParty({k: take(v) for k, v in stacked["tower"].items()},
                    {k: take(v) for k, v in stacked["top"].items()})


def _tower_fwd(tp, x_fields):
    """tp: one party's tower; x_fields: (B, F) int -> Z (B, z_dim)."""
    F = x_fields.shape[1]
    fields = torch.arange(F, device=x_fields.device)[None, :]
    e = tp.embed[fields, x_fields.long()]                  # (B, F, E)
    h = torch.relu(e.reshape(e.shape[0], -1) @ tp.w1 + tp.b1)
    return h @ tp.w2 + tp.b2


def _top_loss(top, z_a, z_b, y):
    """Per-instance logistic loss at Party B."""
    h = torch.cat([z_a, z_b], dim=-1)
    h = torch.relu(h @ top.w1 + top.b1)
    logit = (h @ top.w2)[:, 0] + top.b2[0]
    return torch.maximum(logit, torch.zeros_like(logit)) - logit * y \
        + torch.log1p(torch.exp(-torch.abs(logit)))


# --------------------------------------------------------------------------
# One communication round on each pod (delegates to the engine)
# --------------------------------------------------------------------------
def make_pod_round(mesh, opt: Optimizer, *, R: int, cos_xi: float,
                   weighting: bool = True,
                   transport: Optional[PodTransport] = None,
                   pipeline_depth: int = 0):
    """The pod round over the WDL demo model (``engine.make_pod_round``
    has the schedule; ``pipeline_depth=1`` overlaps the up permute with
    the R local updates)."""
    return engine.make_pod_round(mesh, opt, R=R, cos_xi=cos_xi,
                                 weighting=weighting, tower_fwd=_tower_fwd,
                                 top_loss=_top_loss, transport=transport,
                                 pipeline_depth=pipeline_depth)


def init_pod_state(gen, mesh, opt: Optimizer, *, n_fields: int, vocab: int,
                   batch: int, W: int, embed_dim: int = 16, z_dim: int = 64,
                   hidden: int = 128, cache_dtype: str = "float32",
                   pod: Optional[int] = None, params=None, device=None):
    """This pod's state: (party module, optimizer state, workset ring).

    ``gen`` (a ``torch.Generator``) draws the stacked parameters, or
    ``params`` gives them (a party-stacked tree such as the reference's,
    carried across); ``pod`` defaults to this process's rank in the pod
    group (``mesh``'s ``"pod"`` dimension, or the world).
    ``cache_dtype`` is the rings' at-rest precision, float32 or bfloat16
    (the round casts on write and read); the int8 / int4 storage codecs
    belong to the host engine's rings (``core/workset.py``) and are
    refused.  The ring's clock ``ws["time"]`` is a host int.  ``device``
    defaults to the card (``"cpu"`` only when asked for)."""
    if cache_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"pod cache_dtype must be float32|bfloat16 "
                         f"(int8/int4 are host-engine codecs), "
                         f"got {cache_dtype!r}")
    if pod is None:
        import torch.distributed as dist
        pod = dist.get_rank(None if mesh is None else mesh.get_group("pod"))
    if params is None:
        params = stacked_wdl_init(gen, n_fields, vocab, embed_dim, z_dim,
                                  hidden)
    dev = resolve_device(device)
    party = pod_party(params, pod, dev)
    opt_state = opt.init(engine._params(party))
    cd = getattr(torch, cache_dtype)
    ws = {
        "z": torch.zeros((W, batch, z_dim), dtype=cd, device=dev),
        "dz": torch.zeros((W, batch, z_dim), dtype=cd, device=dev),
        "x": torch.zeros((W, batch, n_fields), dtype=torch.int32,
                         device=dev),
        "y": torch.zeros((W, batch), dtype=torch.float32, device=dev),
        "time": 0,
    }
    return party, opt_state, ws


# --------------------------------------------------------------------------
# A run of pod rounds on every rank (the entry that ``launch.dist`` spawns)
# --------------------------------------------------------------------------
POD_DEFAULTS = dict(n_fields=4, vocab=32, batch=16, W=2, embed_dim=16,
                    z_dim=8, hidden=16, R=2, xi_degrees=60.0, lr=0.05,
                    depth=0, cache_dtype="float32", rounds=3, timed=0,
                    data_seed=0, init_seed=0, fields_b=None, teacher=False,
                    shadow=False, params=None, batches=None,
                    device=None, staged=False)


def pod_batches(run: dict):
    """The run's (x (2, B, F) int32, y (2, B) fp32) rounds from numpy's
    ``default_rng(data_seed)``: every field's id uniform in the
    vocabulary (Party B's fields from ``fields_b`` on are dead, id 0), and
    labels in Party B's slot only: Bernoulli(0.5), or with ``teacher``
    Bernoulli(sigmoid) of a fixed random teacher's sum over both parties'
    live fields (as ``examples/pod_protocol_demo.py`` draws them), so the
    task can be learnt."""
    import numpy as np
    rng = np.random.default_rng(run["data_seed"])
    B, F, V = run["batch"], run["n_fields"], run["vocab"]
    fb = F if run["fields_b"] is None else run["fields_b"]
    teacher = rng.standard_normal((2, F, V)).astype(np.float32) \
        if run["teacher"] else None
    out = []
    for _ in range(run["rounds"] + run["timed"]):
        x = rng.integers(0, V, size=(2, B, F), dtype=np.int32)
        x[1, :, fb:] = 0
        if teacher is None:
            p = np.full(B, 0.5)
        else:
            f = np.arange(F)[None, :]
            logit = (teacher[0][f, x[0]].sum(1)
                     + teacher[1][f, x[1]][:, :fb].sum(1)) / np.sqrt(F + fb)
            p = 1.0 / (1.0 + np.exp(-logit))
        y = np.stack([np.zeros(B, np.float32),
                      (rng.random(B) < p).astype(np.float32)])
        out.append((x, y))
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pod_launches(R: int, rounds: int) -> dict:
    """The kernel launches of ``rounds`` pod rounds, both pods together:
    every update of a pod is one K7 launch (the fresh one and R local
    ones); each local update gates once, Party A's through K2a on pod 0
    and Party B's through K2b on pod 1."""
    gates = R * rounds
    return {"fused_adagrad": 2 * (R + 1) * rounds,
            "cosine_weight_2d": gates, "cosine_weights_2d": gates}


def _rel(a, b, base=None) -> float:
    """||a - b|| / ||b - base|| (``base`` 0 if None), a on any device, b and
    base on the CPU; 0 where both differences are zero."""
    a = a.detach().float().cpu()
    b = b.detach().float()
    num = float((a - b).norm())
    den = float((b if base is None else b - base.float()).norm())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


@torch.no_grad()
def _copy_state(dst, src) -> None:
    """Copy one pod state (party, opt_state, ws) into another in place
    (across devices)."""
    for a, b in zip(engine._params(dst[0]), engine._params(src[0])):
        a.copy_(b)
    for a, b in zip(dst[1]["accum"], src[1]["accum"]):
        a.copy_(b)
    for k, v in src[2].items():
        if isinstance(v, int):
            dst[2][k] = v
        else:
            dst[2][k].copy_(v)


def pod_worker(rank: int, world_size: int, runs) -> list:
    """Run each of ``runs`` (dicts over :data:`POD_DEFAULTS`) as this pod:
    ``rounds`` pod rounds from ``params`` (a party-stacked tree of numpy
    arrays or tensors, else drawn from ``init_seed``), then ``timed``
    rounds on the host clock (``device`` None: the card), on ``batches``
    (a list of (x (2, B, F), y (2, B)) numpy pairs, one a round) or else
    :func:`pod_batches`'.  With
    ``shadow`` each of the ``rounds`` rounds is run once more on a CPU
    copy of the state taken at its start, over a CPU transport of its
    own: the round on the device against the same round on the CPU, from
    the same state.  -> one result a run: per-round losses (and with
    ``shadow``, after each round: the CPU's loss, the largest parameter
    deviation, and the largest deviation of a leaf's update, of a leaf's
    accumulator increment and of a ring, each relative to its own
    norm), the final state (numpy),
    whether pod 0's dead ``top`` kept its initial bits, the transport's
    counters and the kernel launches of all the rounds, and the timed ms
    a round."""
    import numpy as np

    from ..kernels import _cuda
    from ..optim import adagrad
    from .weighting import xi_to_cos
    assert world_size == 2, "a pod world has two ranks"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for run in runs:
        run = {**POD_DEFAULTS, **run}
        dev = resolve_device(run["device"])
        params = run["params"]
        if params is not None:
            params = {g: {k: torch.as_tensor(np.asarray(v))
                          for k, v in params[g].items()} for g in params}
        gen = torch.Generator().manual_seed(run["init_seed"])
        opt = adagrad(run["lr"], use_pallas=True)
        party, opt_state, ws = init_pod_state(
            gen, None, opt, n_fields=run["n_fields"], vocab=run["vocab"],
            batch=run["batch"], W=run["W"], embed_dim=run["embed_dim"],
            z_dim=run["z_dim"], hidden=run["hidden"],
            cache_dtype=run["cache_dtype"], pod=rank, params=params,
            device=dev)
        assert all(p.device.type == dev.type for p in party.parameters())
        top0 = [p.detach().clone() for p in party.top.parameters()]
        tp = PodTransport(staged=run["staged"])
        rnd = make_pod_round(None, opt, R=run["R"],
                             cos_xi=xi_to_cos(run["xi_degrees"]),
                             transport=tp, pipeline_depth=run["depth"])
        batches = run["batches"]
        data = [(torch.from_numpy(x[rank]).to(dev),
                 torch.from_numpy(y[rank]).to(dev))
                for x, y in (pod_batches(run) if batches is None
                             else batches)]
        if run["shadow"]:
            cpu = init_pod_state(
                gen, None, opt, n_fields=run["n_fields"], vocab=run["vocab"],
                batch=run["batch"], W=run["W"], embed_dim=run["embed_dim"],
                z_dim=run["z_dim"], hidden=run["hidden"],
                cache_dtype=run["cache_dtype"], pod=rank, device="cpu")
            cpu_rnd = make_pod_round(None, opt, R=run["R"],
                                     cos_xi=xi_to_cos(run["xi_degrees"]),
                                     transport=PodTransport(),
                                     pipeline_depth=run["depth"])
            shadow = {k: [] for k in ("cpu_losses", "param_dev",
                                      "update_dev", "accum_dev", "ring_dev")}
        _sync(dev)
        _cuda.reset_launches()
        losses = []
        for x, y in data[:run["rounds"]]:
            if run["shadow"]:
                _copy_state(cpu, (party, opt_state, ws))
                p0 = [p.detach().clone() for p in engine._params(cpu[0])]
                a0 = [a.clone() for a in cpu[1]["accum"]]
            party, opt_state, ws, loss = rnd(party, opt_state, ws, x, y)
            losses.append(loss)
            if run["shadow"]:
                cpu = cpu_rnd(*cpu, x.cpu(), y.cpu())
                shadow["cpu_losses"].append(float(cpu[3]))
                cpu = cpu[:3]
                pairs = list(zip(engine._params(party),
                                 engine._params(cpu[0]), p0))
                shadow["param_dev"].append(max(
                    float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b, _ in pairs))
                # each leaf's update and accumulator increment, and each
                # ring, relative to its own norm: what the round's K2a /
                # K2b / K7 launches computed, against the plain versions
                shadow["update_dev"].append(max(
                    _rel(a, b, b0) for a, b, b0 in pairs))
                shadow["accum_dev"].append(max(
                    _rel(a, b, b0) for a, b, b0 in zip(
                        opt_state["accum"], cpu[1]["accum"], a0)))
                shadow["ring_dev"].append(max(
                    _rel(ws[k], cpu[2][k]) for k in ("z", "dz")))
        out = {"losses": [float(v) for v in losses]}
        if run["shadow"]:
            out.update(shadow)
        if run["timed"]:
            stage0 = tp.stage_s
            _sync(dev)
            t0 = time.perf_counter()
            for x, y in data[run["rounds"]:]:
                party, opt_state, ws, loss = rnd(party, opt_state, ws, x, y)
            _sync(dev)
            out["ms_per_round"] = (time.perf_counter() - t0) * 1e3 \
                / run["timed"]
            out["stage_ms_per_round"] = (tp.stage_s - stage0) * 1e3 \
                / run["timed"]
            out["timed_loss"] = float(loss)
        _sync(dev)
        out["launches"] = dict(_cuda.LAUNCHES)
        out["counters"] = {"sent_bytes": tp.sent_bytes,
                           "recv_bytes": tp.recv_bytes,
                           "staged_bytes": tp.staged_bytes}
        out["dead_top_kept"] = all(
            torch.equal(a, b) for a, b in zip(top0, party.top.parameters()))
        out["params"] = {g: {k: v.detach().cpu().numpy()
                             for k, v in leaves.items()}
                         for g, leaves in party.tree().items()}
        out["accum"] = [a.cpu().numpy() for a in opt_state["accum"]]
        out["ws"] = {k: (v if isinstance(v, int) else v.float().cpu().numpy())
                     for k, v in ws.items()}
        results.append(out)
    return results
