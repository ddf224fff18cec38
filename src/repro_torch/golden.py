"""Replay the repository's golden workloads through the port.

``tests/golden/two_party_trace.json`` (vanilla, fedbcd, celu) and
``three_party_trace.json`` pin the reference engine's first 20 rounds on
tiny WDL workloads.  The same workloads run here, on the port, from the
reference's initial parameters (``tests/golden/jax_init_params.npz``,
regenerated and checked by ``tests/test_torch_engine.py``), so the card
can replay the goldens without JAX.  The caller names the directory that
holds these files.

Tolerances: the integer counters must match exactly.  Loss and ``w_mean``
differ from the reference only by float32 summation order (XLA's and
PyTorch's reductions, the embedding scatter-add), which stays within
:data:`LOSS_RTOL` and :data:`W_MEAN_ATOL` over 20 rounds.  ``w_zero_frac``
counts rows that land at cos ξ and is reported, not held.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import resolve_device
from .bridge import load_flat, subtree
from .configs.base import CELUConfig
from .core import engine
from .data import to_device
from .data.synthetic import TabularSpec, aligned_batches, make_tabular
from .models.tabular import (DLRMConfig, MLP, PartyA, WDLPartyB,
                             logistic_loss, make_dlrm, wdl_logit)
from .optim import make_optimizer

PARAMS_NPZ = "jax_init_params.npz"
LOSS_RTOL = 1e-4
W_MEAN_ATOL = 1e-4

TWO_PARTY_CFG = DLRMConfig("wdl", 4, 3, vocab=32, embed_dim=4, z_dim=8,
                           hidden=(16, 8))
THREE_PARTY_CFG = DLRMConfig("wdl", 4, 4, vocab=64, embed_dim=4, z_dim=8,
                             hidden=(16, 8))
THREE_PARTY_TOP = (3 * 8, 16, 1)


def load_params(golden_dir) -> dict:
    with np.load(os.path.join(golden_dir, PARAMS_NPZ)) as f:
        return {k: f[k] for k in f.files}


def load_golden(golden_dir, name: str) -> dict:
    with open(os.path.join(golden_dir, name)) as f:
        return json.load(f)


def _rows_metrics(m) -> dict:
    return {"loss": float(m["loss"]), "w_mean": float(m["w_mean"]),
            "w_zero_frac": float(m["w_zero_frac"]),
            "local_steps": int(m["local_steps"])}


def _replay(task, opt, celu, nloc, state, batches, rounds: int, depth):
    """Run ``rounds`` rounds of ``batches`` ((batches_a, batch_b,
    batch_idx) tuples): through :func:`engine.make_round` when ``depth``
    is None, else through :func:`engine.make_pipeline` at that depth,
    flushed and finalized after the last step.  -> (rows, final state)."""
    rows = []
    if depth is None:
        rnd = engine.make_round(task, opt, celu, local_steps=nloc)
        for _, (bas, b, bi) in zip(range(rounds), batches):
            state, m = rnd(state, bas, b, bi)
            rows.append(_rows_metrics(m))
        return rows, state
    pe = engine.make_pipeline(task, opt, celu, depth=depth,
                              local_steps=nloc)
    rs = pe.init(state)
    for _, (bas, b, bi) in zip(range(rounds), batches):
        rs, m = pe.step(rs, bas, b, bi)
        rows.append(_rows_metrics(m))
    rs, _ = pe.flush(rs)
    return rows, pe.finalize(rs)


def two_party_trace(protocol: str, flat_params: dict, *, device=None,
                    cache_fused: bool = True, rounds: int = 20,
                    cache_dtype: str = "float32", compression: str = "",
                    uniforms=None, optimizer: str = "adagrad",
                    opt_kw=None, depth=None, celu_kw=None) -> list:
    """The two-party golden workload (``tests/test_engine.py::_workload``)
    through the port -> rows in the golden JSON's schema.  ``cache_dtype``,
    ``compression``, ``uniforms`` (the rounding uniforms' source),
    ``optimizer`` and its keywords ``opt_kw`` (e.g. ``use_pallas=True``,
    the fused AdaGrad kernel route) vary it beyond the goldens, which pin
    the defaults; ``celu_kw`` overrides fields of its ``CELUConfig`` (R =
    W = 3 by default).  ``depth`` runs it through the pipelined
    scheduler at that depth (:func:`pipelined_trace`)."""
    dev = resolve_device(device)
    cfg = TWO_PARTY_CFG
    data = make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=2048, n_test=512),
                        seed=0)
    init_fn, task, _ = make_dlrm(cfg)
    params = init_fn(0, cfg, dev)
    load_flat(params["a"], subtree(flat_params, "two_party.a"))
    load_flat(params["b"], subtree(flat_params, "two_party.b"))
    base = CELUConfig(**{"R": 3, "W": 3, "xi_degrees": 60.0,
                         "cache_fused": cache_fused,
                         "cache_dtype": cache_dtype,
                         "compression": compression, **(celu_kw or {})})
    ccfg, nloc = engine.preset_config(protocol, base)
    opt = make_optimizer(optimizer, 0.05, **(opt_kw or {}))
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    etask = engine.lift_two_party(task)
    state = engine.init_state(etask, engine.lift_two_party_params(params),
                              opt, ccfg, [to_device(ba, dev)],
                              to_device(bb, dev), uniforms=uniforms)
    batches = (([to_device(ba, dev)], to_device(bb, dev), bi)
               for bi, ba, bb in aligned_batches(data["train"], 64, seed=0))
    rows, state = _replay(etask, opt, ccfg, nloc, state, batches, rounds,
                          depth)
    rows.append({"steps_a": int(state["steps"]["a"][0]),
                 "steps_b": int(state["steps"]["b"]),
                 "comm_rounds": int(state["comm_rounds"])})
    return rows


def pipelined_trace(protocol: str, flat_params: dict, depth: int,
                    **kw) -> list:
    """:func:`two_party_trace` through ``engine.make_pipeline`` at
    ``depth`` (the reference's ``tests/test_pipeline.py::_run_pipelined``
    and, with ``celu_kw`` W = 5, ``test_pipeline_depth.py::_drive``): one
    row a step, the first D - 1 with a NaN loss at depth D >= 2, then the
    counters after the flush."""
    return two_party_trace(protocol, flat_params, depth=depth, **kw)


def three_party_task() -> engine.KPartyTask:
    """Two feature parties and Party B's WDL head over both cut tensors
    (``tests/test_engine.py::_three_party_workload``)."""
    def forward_a(pa, batch_a):
        return pa.tower(batch_a["x_a"])

    def loss_b(pb, z_list, batch_b):
        li = logistic_loss(wdl_logit(pb, z_list, batch_b["x_b"]),
                           batch_b["y"])
        return li, li.new_zeros(())

    return engine.KPartyTask(forward_a, loss_b)


def three_party_trace(flat_params: dict, *, device=None,
                      cache_fused: bool = True, rounds: int = 20,
                      opt_kw=None, depth=None) -> list:
    """The three-party (K = 2 feature parties) golden workload; ``opt_kw``
    are AdaGrad's keywords; ``depth`` runs it through the pipelined
    scheduler."""
    dev = resolve_device(device)
    cfg = THREE_PARTY_CFG
    data = make_tabular(TabularSpec("t", fields_a=8, fields_b=4, vocab=64,
                                    n_train=4096, n_test=512), seed=0)
    gen = torch.Generator().manual_seed(0)
    pas = [PartyA(cfg, gen), PartyA(cfg, gen)]
    pb = WDLPartyB(cfg, gen)
    pb.top = MLP(THREE_PARTY_TOP, gen)
    for i, pa in enumerate(pas):
        load_flat(pa, subtree(flat_params, f"three_party.a{i}"))
    load_flat(pb, subtree(flat_params, "three_party.b"))
    pas = [pa.to(dev) for pa in pas]
    pb = pb.to(dev)
    task = three_party_task()
    celu = CELUConfig(R=2, W=2, xi_degrees=60.0, cache_fused=cache_fused)
    opt = make_optimizer("adagrad", 0.02, **(opt_kw or {}))

    def split(ba, bb):
        return ([to_device({"x_a": ba["x_a"][:, :4]}, dev),
                 to_device({"x_a": ba["x_a"][:, 4:]}, dev)],
                to_device(bb, dev))

    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    state = engine.init_state(task, {"a": pas, "b": pb}, opt, celu,
                              *split(ba, bb))
    batches = (split(ba, bb) + (bi,)
               for bi, ba, bb in aligned_batches(data["train"], 64, seed=0))
    rows, state = _replay(task, opt, celu, celu.R, state, batches, rounds,
                          depth)
    rows.append({"steps_a": [int(s) for s in state["steps"]["a"]],
                 "steps_b": int(state["steps"]["b"]),
                 "comm_rounds": int(state["comm_rounds"])})
    return rows


def compare(got: list, want: list) -> dict:
    """Deviation of a replayed trace from the golden one: exact counter
    agreement plus the largest loss (relative), ``w_mean`` and
    ``w_zero_frac`` (absolute) deviations over the rounds compared."""
    n = len(got) - 1
    rows = want[:n]
    return {
        "rounds": n,
        "counters_equal": (got[-1] == want[-1] if n == len(want) - 1
                           else True) and all(
            g["local_steps"] == w["local_steps"]
            for g, w in zip(got, rows)),
        "loss_rel": max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                        for g, w in zip(got, rows)),
        "w_mean_abs": max(abs(g["w_mean"] - w["w_mean"])
                          for g, w in zip(got, rows)),
        "w_zero_frac_abs": max(abs(g["w_zero_frac"] - w["w_zero_frac"])
                               for g, w in zip(got, rows)),
    }


def within_tolerance(dev: dict) -> bool:
    return (dev["counters_equal"] and dev["loss_rel"] <= LOSS_RTOL
            and dev["w_mean_abs"] <= W_MEAN_ATOL)
