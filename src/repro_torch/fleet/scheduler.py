"""The fleet's round scheduler: the pipelined engine's schedule as ONE step
function for one job, which ``torch.func.vmap`` batches over a leading
job axis.

Port of ``repro/fleet/scheduler.py``.  :class:`~repro_torch.core.engine.
PipelinedEngine` keeps its exchange queue as a tuple of in-flight
exchanges.  Here the schedule is re-expressed so that one step serves
warm-up, steady state and (through :func:`make_fleet_step`'s ``flush``)
the drain, and batches over jobs:

  * the exchange queue is a FIXED-CAPACITY stacked
    :class:`~repro_torch.core.engine.PendingExchange`: every tensor of an
    exchange's payload grows a leading ``depth`` axis (slot 0 oldest), and
    :func:`_at` / :func:`_put` / :func:`_pop` read, write and shift it.
    The slots' batches, batch indices and dispatch rounds are the
    cohort's (every job shares the batch schedule), kept as host tuples;
  * the queue phase ``n_pending`` is a HOST int.  The reference carries it
    as a traced int32 and branches with ``lax.cond``; every job of a
    cohort shares depth and schedule, so the count is the same for all of
    them, and the port branches in Python.  No decision reads a tensor
    back from the card;
  * the per-job knobs that the scalar engine bakes into its stages (the
    optimizer's lr, the Algorithm-2 ``cos ξ``, the uniform source) arrive
    as :class:`JobHyper`, so ``vmap`` batches them: lr and cos ξ become
    0-d tensors of each job, and cos ξ reaches the gate kernels as the
    job's threshold operand (``kernels/jobs.py``).

The stages are the engine's own (``engine._make_stages``), built with
``functional=True`` (gradients through ``torch.func.vjp``) and the job's
overrides, and run under ``torch.no_grad()``: a ``torch.func`` transform
takes its gradients all the same, and no autograd graph is recorded
around it.  With the default hyper (seed 0) the step replays
``PipelinedEngine.step`` / ``flush`` at depths 0, 1, 2 and beyond: the same
stage composition, dispatch keys, per-slot staleness charges and NaN-loss
warm-up rows (``tests/test_torch_fleet.py``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..configs.base import CELUConfig, validate_pipeline_depth
from ..core.engine import (KPartyTask, PendingExchange, _make_stages,
                           _zero_local_metrics, make_transport)
from ..core.weighting import xi_to_cos
from ..core.workset import tree_map
from ..optim import make_optimizer

# the reference's fixed PRNG bases of the engine's three chains; a job
# with seed 0 keeps them (the golden-pinned chain), any other seed starts
# each chain from fold_in(PRNGKey(base), seed)
ENGINE_RNG_BASES = {"exchange": 17, "insert": 0xCE1, "draw": 29}

# the port's uniform tags of each chain (core/uniforms.py)
_CHAIN_TAGS = {"wire": "exchange", "insert": "insert", "draw": "draw",
               "draw_s": "draw"}


class JobUniforms:
    """One job's uniform source: ``source`` under the job's chain.  Seed
    0 hands the engine's tags through unchanged; any other seed prefixes
    the three engine chains' tags with ``("job", seed)``, which names the
    reference's ``fold_in(PRNGKey(base), seed)`` of
    :data:`ENGINE_RNG_BASES` (``tests/test_torch_compression.py::jax_key``
    computes it)."""

    def __init__(self, source, seed: int = 0):
        self.source = source
        self.seed = int(seed)

    def __call__(self, tag, shape):
        if self.seed and tag[0] in _CHAIN_TAGS:
            tag = ("job", self.seed) + tuple(tag)
        return self.source(tag, shape)


class JobHyper(NamedTuple):
    """Per-job knobs: everything a fleet batches over without building
    another program.  Static knobs (depth, codec, cache dtype, W, R,
    sampling...) stay in :class:`~repro_torch.configs.base.CELUConfig` and
    partition the fleet into cohorts (``runner.cohort_key``).

    ``lr`` and ``cos_xi`` are Python floats for one job, or fp32 tensors
    (0-d inside ``vmap``, each job's own); ``uniforms`` is the job's
    uniform source (None: the state's)."""
    lr: Any
    cos_xi: Any
    uniforms: Any = None

    @classmethod
    def for_spec(cls, lr: float, xi_degrees: float, seed: int = 0,
                 source=None) -> "JobHyper":
        """Concrete hyper for one job; ``source`` is its uniform source,
        put under the job's chain (:class:`JobUniforms`)."""
        return cls(lr=float(lr),
                   cos_xi=float(np.float32(xi_to_cos(xi_degrees))),
                   uniforms=None if source is None
                   else JobUniforms(source, seed))


class FleetRoundState(NamedTuple):
    """One job's scheduler state: the engine's state dict
    (``engine.init_state``) plus the stacked exchange queue.

    ``pending`` is a :class:`PendingExchange` whose ``fresh`` tensors carry
    a leading ``depth`` axis (slot 0 oldest) and whose other fields are
    ``depth``-tuples, or None at depths 0 / 1, whose queue never outlives
    a step.  ``n_pending`` is the live in-flight count (a host int)."""
    state: Dict[str, Any]
    pending: Optional[PendingExchange]
    n_pending: int


def _at(pending: PendingExchange, i: int) -> PendingExchange:
    """Slot ``i`` of the queue (a view of the stacked payload)."""
    return PendingExchange(
        fresh=tree_map(lambda x: x[i], pending.fresh),
        batches_a=pending.batches_a[i], batch_b=pending.batch_b[i],
        batch_idx=pending.batch_idx[i],
        dispatched_at=pending.dispatched_at[i])


def _set(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


def _put(pending: PendingExchange, slot: PendingExchange,
         i: int) -> PendingExchange:
    """Write ``slot`` into slot ``i``: its payload copied into the stacked
    tensors in place, its host fields into the tuples."""
    tree_map(lambda buf, v: buf[i].copy_(v), pending.fresh, slot.fresh)
    return PendingExchange(
        fresh=pending.fresh,
        batches_a=_set(pending.batches_a, i, slot.batches_a),
        batch_b=_set(pending.batch_b, i, slot.batch_b),
        batch_idx=_set(pending.batch_idx, i, slot.batch_idx),
        dispatched_at=_set(pending.dispatched_at, i, slot.dispatched_at))


def _pop(pending: PendingExchange) -> PendingExchange:
    """Shift the queue left (slot 1 -> 0, ...); the vacated tail slot
    holds a stale copy that ``n_pending`` guards from reads."""
    def roll(t):
        return t[1:] + t[:1]
    return PendingExchange(
        fresh=tree_map(lambda x: torch.roll(x, -1, 0), pending.fresh),
        batches_a=roll(pending.batches_a), batch_b=roll(pending.batch_b),
        batch_idx=roll(pending.batch_idx),
        dispatched_at=roll(pending.dispatched_at))


def average_flush_metrics(m: Dict[str, Any]) -> Dict[str, Any]:
    """Finish ONE job's flush metrics on the host: sum the per-scan float
    rows one float32 add at a time, as ``PipelinedEngine.flush``'s
    ``sum(...) / n`` does, and divide by the number of scans that ran.
    Idle rows are zeros, so including them in the sum is exact.  Depth
    0 / 1 metrics pass through unchanged."""
    if "w_mean_scans" not in m:
        return dict(m)
    n = np.float32(np.asarray(m["n_scans"]))
    out = {"local_steps": np.asarray(m["local_steps"])}
    for key in ("w_mean", "w_zero_frac"):
        acc = np.float32(0.0)
        for v in np.asarray(m[key + "_scans"], np.float32):
            acc = np.float32(acc + v)
        out[key] = np.float32(acc / n)
    return out


def _queue_like(fresh, depth: int):
    """A ``depth``-slot stacked payload shaped like ``fresh``: each tensor
    repeated down a new leading axis (batched like ``fresh`` under
    ``vmap``; a slot is read only after a dispatch writes it)."""
    return tree_map(lambda x: x.unsqueeze(0).repeat(
        (depth,) + (1,) * x.dim()), fresh)


def make_fleet_step(task: KPartyTask, celu: CELUConfig, *,
                    depth: Optional[int] = None,
                    optimizer: str = "adagrad",
                    opt_kwargs: Optional[Dict[str, Any]] = None,
                    local_steps: int = -1, transport=None,
                    compression: Optional[str] = None):
    """-> ``(init, step, flush)``, the schedule of ONE job (``vmap`` or a
    loop over jobs is the caller's move, ``fleet.runner``):

      * ``init(state) -> FleetRoundState`` adopts an
        :func:`~repro_torch.core.engine.init_state` dict; at depth >= 2 the
        queue's stacked slots are made at the first dispatch, from its
        payload (the reference sizes them from the payload's abstract
        shapes at init);
      * ``step(fs, hyper, batches_a, batch_b, batch_idx) -> (fs, metrics)``
        is one communication round, :meth:`PipelinedEngine.step`'s
        composition at this depth;
      * ``flush(fs, hyper) -> (fs, metrics)`` drains the queue: ``depth``
        conditional scan + merge pairs (no-ops once the queue is empty)
        and the final scan, as :meth:`PipelinedEngine.flush` alternates.
        At depth >= 2 the float metrics come back as per-scan rows: finish
        them with :func:`average_flush_metrics`.

    The optimizer is ``make_optimizer(optimizer, hyper.lr)``, the plain
    route as in the reference's fleet.  The stages are built for each
    call from ``hyper``, so a batched lr / cos ξ flows into them."""
    if depth is None:
        depth = celu.pipeline_depth
    validate_pipeline_depth(depth, celu.W)
    dynamic = depth >= 2
    n_local = celu.R if local_steps < 0 else local_steps
    tp = transport if transport is not None \
        else make_transport(celu, compression)

    def _stages(hyper: JobHyper):
        opt = make_optimizer(optimizer, hyper.lr, **(opt_kwargs or {}))
        return _make_stages(
            task, opt, celu, n_local=n_local, tp=tp,
            pipeline_staleness=depth,
            lr_damping=celu.pipeline_lr_damping if dynamic else 0.0,
            cos_xi=hyper.cos_xi, uniforms=hyper.uniforms, functional=True)

    def init(state: Dict[str, Any]) -> FleetRoundState:
        return FleetRoundState(state, None, 0)

    def step(fs: FleetRoundState, hyper: JobHyper, batches_a, batch_b,
             batch_idx):
        compute, apply_, scan = _stages(hyper)
        state = fs.state
        src = state["uniforms"]
        with torch.no_grad():
            if depth <= 1:
                fresh = compute(state["params"], state["transport"],
                                batches_a, batch_b, state["round"], src)
                if depth == 0:      # dispatch -> merge -> local
                    state, m = apply_(state, fresh, batches_a, batch_b,
                                      batch_idx, src)
                    state, lm = scan(state)
                else:               # dispatch -> local (overlap) -> merge
                    state, lm = scan(state)
                    state, m = apply_(state, fresh, batches_a, batch_b,
                                      batch_idx, src)
                m.update(lm)
                return fs._replace(state=state), m

            # depth >= 2: dispatch chains the residuals off the NEWEST
            # in-flight exchange and keys the wire by the dispatch's
            # sequence number (merges done + in flight)
            pending, n = fs.pending, fs.n_pending
            tstate = _at(pending, n - 1).fresh["tstate"] if n \
                else state["transport"]
            fresh = compute(state["params"], tstate, batches_a, batch_b,
                            state["round"] + n, src)
            slot = PendingExchange(fresh, batches_a, batch_b, batch_idx,
                                   dispatched_at=state["round"])
            if pending is None:
                pending = PendingExchange(
                    _queue_like(fresh, depth), (None,) * depth,
                    (None,) * depth, (None,) * depth, (None,) * depth)
            pending = _put(pending, slot, n)
            n += 1
            # the local scan is charged the live in-flight count
            state, lm = scan(state, n)
            if n == depth:
                # merge the oldest, charged its age in rounds
                oldest = _at(pending, 0)
                state, m = apply_(state, oldest.fresh, oldest.batches_a,
                                  oldest.batch_b, oldest.batch_idx, src,
                                  state["round"] - oldest.dispatched_at)
                pending, n = _pop(pending), n - 1
            else:       # warm-up: the queue is filling
                m = {"loss": torch.full((), float("nan"),
                                        device=state["comm_rounds"].device)}
        m.update(lm)
        return FleetRoundState(state, pending, n), m

    def flush(fs: FleetRoundState, hyper: JobHyper):
        _, apply_, scan = _stages(hyper)
        state = fs.state
        src = state["uniforms"]
        dev = state["comm_rounds"].device
        if depth == 0:
            return fs, _zero_local_metrics(dev)
        with torch.no_grad():
            if depth == 1:
                state, lm = scan(state)
                return fs._replace(state=state), lm
            # scan and merge in turn while the queue drains (``depth``
            # conditional pairs, idle ones reporting zeros), then one
            # more scan over the last inserts; the float metrics stay
            # per-scan rows for the host (average_flush_metrics)
            pending, n = fs.pending, fs.n_pending
            n0 = n
            rows = []
            for _ in range(depth):
                if n == 0:
                    rows.append(_zero_local_metrics(dev))
                    continue
                state, lm = scan(state, n)
                oldest = _at(pending, 0)
                state, _ = apply_(state, oldest.fresh, oldest.batches_a,
                                  oldest.batch_b, oldest.batch_idx, src,
                                  state["round"] - oldest.dispatched_at)
                pending, n = _pop(pending), n - 1
                rows.append(lm)
            state, lm = scan(state, n)          # n == 0: the final scan
            rows.append(lm)
        metrics = {
            "local_steps": sum(r["local_steps"] for r in rows),
            "w_mean_scans": torch.stack([r["w_mean"] for r in rows]),
            "w_zero_frac_scans": torch.stack([r["w_zero_frac"]
                                              for r in rows]),
            "n_scans": torch.full((), n0 + 1, dtype=torch.int32,
                                  device=dev),
        }
        return FleetRoundState(state, pending, n), metrics

    return init, step, flush
