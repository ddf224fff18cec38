"""Deep-learning recommendation models — the paper's own workloads (§5.1).

Port of ``repro/models/tabular.py``.  Two DLRMs over vertically
partitioned categorical fields:

  * **WDL** (Wide & Deep): each party embeds its fields; Party A's deep MLP
    emits ``Z_A``; Party B fuses ``[Z_A ‖ Z_B]`` through the top MLP and
    adds its own wide (linear) term.
  * **DSSM**: two symmetric towers; the "top model" is the scaled dot
    interaction between the tower embeddings (owned by Party B).

Each party's parameters are one ``nn.Module`` whose ``state_dict`` keys
mirror the reference pytree paths (``tower.embed``, ``tower.mlp.0.w``,
``top.1.b``, ``wide``, ``bias``), so :mod:`repro_torch.bridge` maps one to
the other by name.  The modules only hold parameters: the forward
functions are the task's, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..core.protocol import VFLTask


@dataclass(frozen=True)
class DLRMConfig:
    model: str                  # wdl | dssm
    fields_a: int
    fields_b: int
    vocab: int = 1024
    embed_dim: int = 16
    z_dim: int = 256            # paper: output dimensionality of Z_A = 256
    hidden: Sequence[int] = (512, 256)


# --------------------------------------------------------------------------
# Parameter modules
# --------------------------------------------------------------------------
class Dense(nn.Module):
    """x @ w + b, w (d_in, d_out) uniform in ±1/sqrt(d_in), b zeros."""

    def __init__(self, d_in: int, d_out: int, gen: torch.Generator):
        super().__init__()
        scale = 1.0 / math.sqrt(d_in)
        u = torch.rand((d_in, d_out), generator=gen, dtype=torch.float32)
        self.w = nn.Parameter(u * (2 * scale) - scale)
        self.b = nn.Parameter(torch.zeros(d_out))


class MLP(nn.ModuleList):
    """Dense layers with ReLU between them (none after the last)."""

    def __init__(self, dims: Sequence[int], gen: torch.Generator):
        super().__init__(Dense(i, o, gen) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self):
            x = x @ layer.w + layer.b
            if i < len(self) - 1:
                x = torch.relu(x)
        return x


def _gather_fields(table, x):
    """table (F, V, ...) and x (B, F) ids -> table[f, x[:, f]] (B, F, ...)."""
    f_idx = torch.arange(x.shape[1], device=x.device)
    return table[f_idx[None, :], x]


class Tower(nn.Module):
    """Per-field embeddings (N(0, 0.01²)) flattened into an MLP."""

    def __init__(self, cfg: DLRMConfig, n_fields: int, out_dim: int,
                 gen: torch.Generator):
        super().__init__()
        self.embed = nn.Parameter(torch.randn(
            (n_fields, cfg.vocab, cfg.embed_dim), generator=gen) * 0.01)
        self.mlp = MLP([n_fields * cfg.embed_dim, *cfg.hidden, out_dim], gen)

    def forward(self, x_fields):
        """x_fields: (B, F) integer ids -> (B, out_dim)."""
        e = _gather_fields(self.embed, x_fields)
        return self.mlp(e.reshape(x_fields.shape[0], -1))


class PartyA(nn.Module):
    def __init__(self, cfg: DLRMConfig, gen: torch.Generator):
        super().__init__()
        self.tower = Tower(cfg, cfg.fields_a, cfg.z_dim, gen)


class WDLPartyB(nn.Module):
    def __init__(self, cfg: DLRMConfig, gen: torch.Generator):
        super().__init__()
        self.tower = Tower(cfg, cfg.fields_b, cfg.z_dim, gen)
        self.top = MLP([2 * cfg.z_dim, cfg.hidden[-1], 1], gen)
        self.wide = nn.Parameter(torch.randn(
            (cfg.fields_b, cfg.vocab), generator=gen) * 0.01)
        self.bias = nn.Parameter(torch.zeros(()))


class DSSMPartyB(nn.Module):
    def __init__(self, cfg: DLRMConfig, gen: torch.Generator):
        super().__init__()
        self.tower = Tower(cfg, cfg.fields_b, cfg.z_dim, gen)
        self.scale = nn.Parameter(torch.ones(()))
        self.bias = nn.Parameter(torch.zeros(()))


def _init(party_b):
    def init(seed: int, cfg: DLRMConfig, device=None):
        """-> {"a": PartyA, "b": party B module} on ``device``, drawn from
        a ``torch.Generator`` seeded with ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        return {"a": PartyA(cfg, gen).to(dev), "b": party_b(cfg, gen).to(dev)}
    return init


wdl_init = _init(WDLPartyB)
dssm_init = _init(DSSMPartyB)


# --------------------------------------------------------------------------
# Losses and predictions
# --------------------------------------------------------------------------
def logistic_loss(logit, y):
    """Per-instance binary cross-entropy on logits (stable form)."""
    return torch.relu(logit) - logit * y + torch.log1p(
        torch.exp(-torch.abs(logit)))


def wdl_logit(pb, z_list, x_b):
    """Party B's WDL head over the feature parties' cut tensors
    ``z_list``: top MLP on [Z_1 ‖ .. ‖ Z_K ‖ Z_B] plus the wide term."""
    z_b = pb.tower(x_b)
    h = torch.cat([z.float() for z in z_list] + [z_b], dim=-1)
    logit = pb.top(h)[:, 0]
    wide = _gather_fields(pb.wide, x_b).sum(dim=1)
    return logit + wide + pb.bias


def _wdl_task(cfg: DLRMConfig) -> VFLTask:
    def forward_a(pa, batch_a):
        return pa.tower(batch_a["x_a"])

    def loss_b(pb, z_a, batch_b):
        li = logistic_loss(wdl_logit(pb, [z_a], batch_b["x_b"]),
                           batch_b["y"])
        return li, li.new_zeros(())

    return VFLTask(forward_a, loss_b)


@torch.no_grad()
def wdl_predict(params, cfg: DLRMConfig, batch_a, batch_b):
    z_a = params["a"].tower(batch_a["x_a"])
    return wdl_logit(params["b"], [z_a], batch_b["x_b"])


def _dssm_logit(pb, z_a, z_b):
    # smooth normalization sqrt(|x|^2 + eps): finite gradient at x = 0
    # (zero vectors occur for round-robin "bubble" workset entries)
    def nrm(x):
        return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)
    za = nrm(z_a.float())
    zb = nrm(z_b)
    return pb.scale * 10.0 * (za * zb).sum(dim=-1) + pb.bias


def _dssm_task(cfg: DLRMConfig) -> VFLTask:
    def forward_a(pa, batch_a):
        return pa.tower(batch_a["x_a"])

    def loss_b(pb, z_a, batch_b):
        z_b = pb.tower(batch_b["x_b"])
        li = logistic_loss(_dssm_logit(pb, z_a, z_b), batch_b["y"])
        return li, li.new_zeros(())

    return VFLTask(forward_a, loss_b)


@torch.no_grad()
def dssm_predict(params, cfg: DLRMConfig, batch_a, batch_b):
    z_a = params["a"].tower(batch_a["x_a"])
    z_b = params["b"].tower(batch_b["x_b"])
    return _dssm_logit(params["b"], z_a, z_b)


# --------------------------------------------------------------------------
def make_dlrm(cfg: DLRMConfig):
    """-> (init_fn, task, predict_fn)."""
    if cfg.model == "wdl":
        return wdl_init, _wdl_task(cfg), wdl_predict
    if cfg.model == "dssm":
        return dssm_init, _dssm_task(cfg), dssm_predict
    raise ValueError(cfg.model)


def auc(logits, labels) -> float:
    """Rank-based AUC (ties handled by average rank)."""
    s = np.asarray(logits, np.float64)
    y = np.asarray(labels)
    order = np.argsort(s)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    # average ranks for ties
    ss = s[order]
    i = 0
    while i < len(ss):
        j = i
        while j + 1 < len(ss) and ss[j + 1] == ss[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    n_pos = float(y.sum())
    n_neg = float(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[y > 0.5].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
