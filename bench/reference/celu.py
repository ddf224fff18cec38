"""CELU-VFL training rounds in plain PyTorch (paper Algorithms 1-2), for the
benchmark's check.

A round: Party A's tower gives Z_A; Party B's loss over Z_A gives its
gradient and ∇Z_A; Party A back-propagates ∇Z_A; both parties take an
AdaGrad step (``a += g²``, ``p -= scale · lr · g / (√a + eps)``); each
party puts ⟨Z_A, ∇Z_A, its own batch⟩ into its ring of ``W`` slots (slot
``t mod W`` at the ``t``-th exchange).  Then each party runs ``R`` local
updates.  Each draws the slot under a cursor that walks the ring one slot
a draw; a slot is alive when it was inserted within the last ``W``
exchanges and has been used fewer than ``R`` times, and a draw of a slot
that is not alive (a bubble) still runs, with its update scaled by 0.
Party A runs its tower on the slot's batch and weights each instance by
the cosine of the new Z_A against the cached one, set to 0 below
``cos ξ``, and back-propagates the weighted cached ∇Z_A.  Party B takes
∇Z_A of its mean loss at the cached Z_A (its ad-hoc pass), weights each
instance by that gradient's cosine against the cached ∇Z_A (0 below
``cos ξ``), and steps on the weighted mean loss plus its load-balance
loss.

The state lives on the host where it is bookkeeping (the ring's clocks)
and on the device where it is tensors; every tensor is fp32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from . import model as M

INT_MIN = -(2 ** 30)
COS_EPS = 1e-12


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def named_leaves(tree) -> Dict[str, torch.Tensor]:
    return dict(_leaves(tree))


def gate(new, stale, cos_xi: float):
    """Per-instance cosine of ``new`` against ``stale`` over all but the
    batch axis, 0 below ``cos_xi``."""
    B = new.shape[0]
    a, b = new.reshape(B, -1), stale.reshape(B, -1)
    cos = (a * b).sum(1) / torch.clamp(
        torch.sqrt((a * a).sum(1) * (b * b).sum(1)), min=COS_EPS)
    return torch.where(cos < cos_xi, torch.zeros_like(cos), cos)


class Party:
    """One party's parameters, AdaGrad accumulators and ring.  ``store``:
    the dtype each leaf is kept in between updates (a leaf missing from
    it is kept as it is): a step is computed in the leaf's own dtype and
    rounded to nearest into the stored one."""

    def __init__(self, tree, W: int, store: Optional[dict] = None):
        self.tree = tree
        self.params = named_leaves(tree)
        self.store = store or {}
        for t in self.params.values():
            t.requires_grad_(True)
        self.accum = {k: torch.zeros_like(t) for k, t in self.params.items()}
        self.W = W
        self.ring: List[Optional[dict]] = [None] * W
        self.insert_time = [INT_MIN] * W
        self.use_count = [0] * W
        self.cursor = 0
        self.time = 0

    @torch.no_grad()
    def step(self, grads, lr: float, eps: float, scale: float) -> None:
        for (k, p), g in zip(self.params.items(), grads):
            if g is None:
                g = torch.zeros_like(p)
            a = self.accum[k]
            a.add_(g * g)
            p.sub_(scale * lr * g / (torch.sqrt(a) + eps))
            kept = self.store.get(k, p.dtype)
            if kept != p.dtype:
                p.copy_(p.to(kept))

    def insert(self, entry: dict) -> None:
        s = self.time % self.W
        self.ring[s] = entry
        self.insert_time[s] = self.time
        self.use_count[s] = 0
        self.time += 1

    def draw(self, R: int):
        """-> (the slot's entry, or zeros for a slot never written, and
        1.0 when the slot is alive, else 0.0)."""
        s = self.cursor % self.W
        alive = (self.insert_time[s] > INT_MIN
                 and self.insert_time[s] >= self.time - self.W
                 and self.use_count[s] < R)
        self.use_count[s] += int(alive)
        self.cursor = (s + 1) % self.W
        return self.ring[s], (1.0 if alive else 0.0)


def _zeros_like_entry(entry: dict) -> dict:
    return {k: ({kk: torch.zeros_like(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in entry.items()}


class Rounds:
    """The two-party CELU rounds of one cell, in plain PyTorch.

    ``trees``: {"a", "b"} fp32 trees (the program's layout); ``traffic``:
    the traffic file's parameters (R, W, xi_degrees, lr, eps);
    ``products``: the precision of the products (``model.Products``);
    ``store``: {"a", "b"} each leaf's stored dtype (``Party``);
    ``keep``: a share of each batch's tokens that Party B's loss keeps
    (a fault; None is the whole batch); ``unweighted``: Party A's local
    cotangent left unscaled by its gate weight where that is not 0 (a
    fault)."""

    def __init__(self, cfg: dict, trees, traffic: dict,
                 products: M.Products, keep: Optional[float] = None,
                 unweighted: bool = False, store: Optional[dict] = None):
        self.cfg = cfg
        self.pr = products
        self.R, W = traffic["R"], traffic["W"]
        self.cos_xi = float(torch.tensor(
            math.cos(math.radians(traffic["xi_degrees"])),
            dtype=torch.float32))
        self.lr, self.eps = traffic["lr"], traffic["adagrad_eps"]
        self.keep = keep
        self.unweighted = unweighted
        store = store or {}
        self.a = Party(trees["a"], W, store.get("a"))
        self.b = Party(trees["b"], W, store.get("b"))
        # each leaf's norm of its party's first (fresh) gradient
        self.first_grad: Optional[Dict[str, float]] = None
        # each round's share of local-update weights that are 0 (bubbles
        # and instances under cos ξ), as the program's ``w_zero_frac``
        self.w_zero: List[float] = []
        # each round's mean local-update weight (bubbles count 0), as the
        # program's ``w_mean``
        self.w_mean: List[float] = []
        # every party update's (gradient norm over its leaves, scale), in
        # the round's order, as ``Program.update_norms``
        self.updates: List[tuple] = []

    def _fwd_a(self, batch_a):
        return M.forward_a(self.a.tree, self.cfg, batch_a, self.pr)

    def _loss_b(self, z, batch_b):
        return M.loss_b(self.b.tree, self.cfg, z, batch_b, self.pr,
                        self.keep)

    def round(self, batch_a, batch_b) -> float:
        """One round; -> Party B's fresh loss (mean loss plus the
        load-balance loss)."""
        a, b = self.a, self.b
        pa, pb = list(a.params.values()), list(b.params.values())
        z = self._fwd_a(batch_a)
        zl = z.detach().requires_grad_(True)
        li, aux = self._loss_b(zl, batch_b)
        loss = li.mean() + aux
        g = torch.autograd.grad(loss, pb + [zl], allow_unused=True)
        g_b, dz = g[:-1], g[-1]
        g_a = torch.autograd.grad(z, pa, grad_outputs=dz, allow_unused=True)
        self._step(a, g_a, 1.0)
        self._step(b, g_b, 1.0)
        if self.first_grad is None:
            self.first_grad = self.grad_norms()
        z, dz = z.detach(), dz.detach()
        a.insert({"z": z, "dz": dz, "batch": batch_a})
        b.insert({"z": z, "dz": dz, "batch": batch_b})
        ws = [(self._local_a(), self._local_b()) for _ in range(self.R)]
        self.w_zero.append(sum(float((wa == 0).float().mean() +
                                     (wb == 0).float().mean()) / 2
                               for wa, wb in ws) / self.R)
        self.w_mean.append(sum(float(wa.mean() + wb.mean()) / 2
                               for wa, wb in ws) / self.R)
        return float(loss.detach())

    def _step(self, party: Party, grads, scale: float) -> None:
        norms = [float(torch.linalg.vector_norm(g.float()))
                 for g in grads if g is not None]
        self.updates.append((math.sqrt(sum(n * n for n in norms)), scale))
        party.step(grads, self.lr, self.eps, scale)

    def _entry(self, party: Party, entry):
        if entry is None:        # a slot never written holds zeros
            entry = _zeros_like_entry(next(e for e in party.ring
                                           if e is not None))
        return entry

    def _local_a(self):
        a = self.a
        entry, valid = a.draw(self.R)
        entry = self._entry(a, entry)
        pa = list(a.params.values())
        z = self._fwd_a(entry["batch"])
        w = gate(z.detach(), entry["z"], self.cos_xi) * valid
        scale = (w > 0).to(w.dtype) if self.unweighted else w
        cot = scale.reshape((-1,) + (1,) * (z.dim() - 1)) * entry["dz"]
        g = torch.autograd.grad(z, pa, grad_outputs=cot, allow_unused=True)
        self._step(a, g, valid)
        return w

    def _local_b(self):
        b = self.b
        entry, valid = b.draw(self.R)
        entry = self._entry(b, entry)
        pb = list(b.params.values())
        zl = entry["z"].detach().requires_grad_(True)
        li, _ = self._loss_b(zl, entry["batch"])
        (dz,) = torch.autograd.grad(li.mean(), [zl])
        w = gate(dz, entry["dz"], self.cos_xi) * valid
        li, aux = self._loss_b(entry["z"], entry["batch"])
        g = torch.autograd.grad((w * li).mean() + aux, pb,
                                allow_unused=True)
        self._step(b, g, valid)
        return w

    @torch.no_grad()
    def grad_norms(self) -> Dict[str, float]:
        """Each leaf's √(Σ accumulator): the norm of the gradients its
        optimizer has taken so far."""
        return {f"{p}/{k}": float(torch.sqrt(a.sum(dtype=torch.float64)))
                for p, party in (("a", self.a), ("b", self.b))
                for k, a in party.accum.items()}

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {f"{p}/{k}": t for p, party in (("a", self.a), ("b", self.b))
                for k, t in party.params.items()}
