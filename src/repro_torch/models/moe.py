"""Mixture-of-Experts FFN with capacity-based dispatch.

Port of ``repro/models/moe.py``.  Top-k routing in fp32, the position of
each assignment in its expert by a cumulative count, a fixed ``(E, C, d)``
buffer per example, the experts' gated-SiLU FFN as batched matrix
products, and a gather-combine weighted by the renormalised gates; a
Switch-style load-balance loss, and llama4's always-on shared expert.

The semantics are the reference's, per example: the capacity ``C`` comes
from the example's length, an assignment's position in its expert counts
the example's earlier assignments to it in token-major, then top-k order,
and an assignment at or past ``C`` is dropped (its gate becomes 0).  The
port batches the examples: the buffer is laid out ``(E, B, C, d)``, so the
experts' products are one ``bmm`` over E with ``B·C`` rows each.  Each
kept assignment owns a distinct slot, so the scatter is an index copy
(dropped ones go to a spare row that is never read); the reference's
scatter-add of zeros into slot 0 gives the same values.

``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``'s
order is not specified, so the routing takes the first k of a stable
descending sort.  A product of an fp32 activation and a bf16 weight runs
in fp32 (``layers._mm``): Party B's ad-hoc ∇Z pass feeds its top tower
fp32 activations, and the dispatch buffer takes their dtype.

Over a mesh (:func:`_moe_on_shards`) the router's logits and the
load-balance loss are DTensor ops, and each device routes its part of the
batch itself and runs its experts' share: the hidden dim ``f`` of every
expert ("tp") or its ``E / m`` experts ("ep"), the output a partial sum
over ``model``.  The batch is whole across ``model``, so expert
parallelism needs no all-to-all.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from .initializers import dense_init
from . import layers as L
from .layers import _mm, mlp_apply, mlp_init


def moe_init(gen, d_model: int, d_ff: int, cfg: MoEConfig, lead=()):
    lead = tuple(lead)
    E = cfg.n_experts
    p = {
        "router": dense_init(gen, d_model, E, lead, dtype=torch.float32),
        "wg": dense_init(gen, d_model, d_ff, lead + (E,)),
        "wu": dense_init(gen, d_model, d_ff, lead + (E,)),
        "wd": dense_init(gen, d_ff, d_model, lead + (E,)),
    }
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, d_model, d_ff * cfg.n_shared, lead)
    return p


def _capacity(seq: int, cfg: MoEConfig) -> int:
    c = int(cfg.capacity_factor * seq * cfg.top_k / cfg.n_experts)
    return max(4, ((c + 3) // 4) * 4)


def top_k(logits, k: int):
    """(values, indices) of the k largest along the last axis, in
    descending order, ties toward the lower index (``jax.lax.top_k``)."""
    idx = torch.sort(logits, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(logits, -1, idx), idx


def _route(logits, cfg: MoEConfig, capacity: int):
    """logits (B, S, E) fp32 -> the flattened (B, S·k) assignments:
    (expert, position in the expert, gate (0 where dropped), keep)."""
    B, S, E = logits.shape
    gate_logits, idx = top_k(logits, cfg.top_k)            # (B, S, k)
    gates = torch.softmax(gate_logits, dim=-1)             # renormalised
    flat_idx = idx.reshape(B, -1)                          # (B, S·k)
    # the running count of each expert's assignments, scanned along the
    # last (contiguous) axis: (B, E, S·k)
    onehot = F.one_hot(flat_idx, E).to(torch.int32).transpose(1, 2)
    pos = torch.cumsum(onehot.contiguous(), dim=2, dtype=torch.int32) - 1
    flat_pos = torch.gather(pos, 1, flat_idx[:, None, :])[:, 0]
    keep = flat_pos < capacity
    flat_gates = gates.reshape(B, -1) * keep
    return flat_idx, flat_pos, flat_gates, keep


def _dispatch(x, flat_idx, flat_pos, keep, E: int, capacity: int):
    """x (B, S, d) -> the (E, B·C, d) buffer in x's dtype: each kept
    assignment's token in its slot, zeros elsewhere (a dropped
    assignment is written to a spare last row, cut off after)."""
    B, S, d = x.shape
    k = flat_idx.shape[1] // S
    b = torch.arange(B, device=x.device)[:, None]
    n_slots = E * B * capacity
    row = (flat_idx * B + b) * capacity + flat_pos
    row = torch.where(keep, row, torch.full_like(row, n_slots))
    src = x[:, :, None, :].expand(B, S, k, d).reshape(B * S * k, d)
    buf = x.new_zeros((n_slots + 1, d)).index_copy(0, row.reshape(-1), src)
    return buf[:n_slots].reshape(E, B * capacity, d)


def _combine(out, flat_idx, flat_pos, flat_gates, keep, S: int, k: int,
             capacity: int):
    """out (E, B·C, d) -> (B, S, d): each assignment's expert output
    (slot 0 of its expert where dropped, as in the reference) times its
    gate, summed over the k assignments of a token."""
    E, _, d = out.shape
    B = flat_idx.shape[0]
    b = torch.arange(B, device=out.device)[:, None]
    row = (flat_idx * B + b) * capacity + torch.where(
        keep, flat_pos, torch.zeros_like(flat_pos))
    y = out.reshape(E * B * capacity, d).index_select(0, row.reshape(-1))
    y = y * (flat_gates * keep).reshape(-1, 1).to(y.dtype)
    return y.reshape(B, S, k, d).float().sum(dim=2).to(out.dtype)


def _experts(params, buf):
    """The experts' gated-SiLU FFN over their rows: buf (E, N, d)."""
    g = F.silu(_mm(buf, params["wg"]).float()).to(buf.dtype)
    u = _mm(buf, params["wu"])
    return _mm(g * u, params["wd"])


def _moe_on_shards(params, x, logits, cfg: MoEConfig, capacity: int):
    """The routed experts over a mesh -> (y, the assignments' experts):
    each device routes its batch shard from its logits and runs the
    experts' share that it holds over ``model`` (see the module's note);
    the weights are gathered on every other mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = params["wg"].device_mesh
    _, md = L._mesh_roles(mesh)
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    R = Replicate()
    mode = None
    if md is not None and isinstance(params["wg"].placements[md], Shard):
        mode = "ep" if params["wg"].placements[md].dim == 0 else "tp"
    wm = {"ep": (Shard(0), Shard(0)), "tp": (Shard(2), Shard(1)),
          None: (R, R)}[mode]
    split = L._batch_splits(mesh, B)
    gu_pl = L._roles(mesh, split, R, wm[0])
    d_pl = L._roles(mesh, split, R, wm[1])
    bpl = L._roles(mesh, split, Shard(0), R)
    part = L._roles(mesh, split, Shard(0), Partial() if mode else R)
    e0 = mesh.get_local_rank(md) * (E // mesh.size(md)) \
        if mode == "ep" else 0

    def local(xl, lg, wg, wu, wd):
        fi, fp, fg, kp = _route(lg, cfg, capacity)
        ei, keep, E_l = fi, kp, E
        if mode == "ep":
            E_l = wg.shape[0]
            own = (fi >= e0) & (fi < e0 + E_l)
            ei = torch.where(own, fi - e0, torch.zeros_like(fi))
            keep = kp & own
        buf = _dispatch(xl, ei, fp, keep, E_l, capacity)
        out = _experts({"wg": wg, "wu": wu, "wd": wd}, buf)
        return _combine(out, ei, fp, fg * keep, keep, S, k, capacity), fi

    wgrad = [L._roles(mesh, split, Partial(), p[md] if md is not None else R)
             for p in (gu_pl, gu_pl, d_pl)]
    run = local_map(local, out_placements=(part, bpl),
                    in_placements=(bpl, bpl, gu_pl, gu_pl, d_pl),
                    in_grad_placements=(part, part, *wgrad),
                    device_mesh=mesh)
    return run(x.redistribute(mesh, bpl), logits.redistribute(mesh, bpl),
               *(params[n].redistribute(mesh, p) for n, p in
                 (("wg", gu_pl), ("wu", gu_pl), ("wd", d_pl))))


def moe_apply(params, x, cfg: MoEConfig):
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    capacity = _capacity(S, cfg)
    logits = _mm(x.float(), params["router"])     # (B, S, E)
    if L._is_dtensor(logits):
        y, fi = _moe_on_shards(params, x, logits, cfg, capacity)
    else:
        fi, fp, fg, kp = _route(logits, cfg, capacity)
        buf = _dispatch(x, fi, fp, kp, E, capacity)
        y = _combine(_experts(params, buf), fi, fp, fg, kp, S, k, capacity)

    # load-balance auxiliary loss (Switch-style)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = F.one_hot(fi, E).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * mean_prob)

    if "shared" in params:
        y = y + mlp_apply(params["shared"], x)
    return y, cfg.router_aux_coef * aux
