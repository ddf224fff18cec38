"""Fleet runner: many CELU-VFL training jobs as one batched program per
cohort.

Port of ``repro/fleet/runner.py``.  ``run_fleet(configs, rounds,
workload=...)`` takes a list of :class:`JobSpec` (one per job), groups
them into COHORTS by their static knobs (:func:`cohort_key`: depth,
codec, cache dtype, W / R, sampling, optimizer... anything that changes
the program), and runs each cohort's rounds and drain:

  * ``mode="vmap"`` (default) stacks the cohort's states along a leading
    job axis and runs ``torch.func.vmap`` of the one-job step
    (``scheduler.make_fleet_step``): each launch serves every job, the
    gate kernels through their job-batched launch (``kernels/jobs.py``).
    A fleet of one job replays the scalar engine within the golden
    tolerance; lanes of one spec are bitwise each other;
  * ``mode="map"`` runs the one-job step lane by lane, each job on its
    own state: bitwise the scalar ``PipelinedEngine`` of that job.

Per-job knobs (lr, seed, ξ) batch inside a cohort through
:class:`~repro_torch.fleet.scheduler.JobHyper`; every job shares the
cohort's batch schedule (the sweep-grid regime: jobs that need their own
data belong in their own cohort).  ``shard=True`` / ``mesh=`` split
each cohort's jobs over the ranks of a ``("fleet",)`` device mesh
(``launch.mesh.make_fleet_mesh``), one contiguous block of jobs a rank,
as the reference's ``P("fleet")`` splits them over devices; every rank
runs its block and the stacked results are gathered on every rank.

Under ``vmap`` the parties' modules are templates: each call binds the
stacked parameters' batched slices into them
(``engine.bind_parameters``).  Random draws are per job: every draw is
each job's own source called under its own tag, stacked, and the step
reads its job's row (``randomness="same"``: nothing inside the step draws
from a batched generator).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import CELUConfig
from ..core import engine
from ..core.uniforms import GeneratorUniforms
from ..core.workset import CastLeaf, QuantLeaf
from ..data import to_device
from ..optim import make_optimizer
from .scheduler import (FleetRoundState, JobHyper, average_flush_metrics,
                        make_fleet_step)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One fleet job.  ``celu`` carries the static engine knobs; ``lr``,
    ``seed`` and ``xi_degrees`` are per-job values (same cohort);
    ``optimizer`` / ``local_steps`` / ``compression`` / ``depth`` are
    static and partition cohorts.  ``seed`` drives both the parameters
    (``workload.params_for``) and the job's uniform chain (seed 0 = the
    scalar engine's golden-pinned chain)."""
    celu: CELUConfig
    lr: float = 0.05
    seed: int = 0
    optimizer: str = "adagrad"
    local_steps: int = -1
    compression: Optional[str] = None
    depth: Optional[int] = None
    xi_degrees: Optional[float] = None

    def resolved_depth(self) -> int:
        return self.celu.pipeline_depth if self.depth is None else self.depth

    def resolved_xi(self) -> float:
        return self.celu.xi_degrees if self.xi_degrees is None \
            else self.xi_degrees


def cohort_key(spec: JobSpec):
    """Static partition key: two jobs run one program iff their keys
    match.  ``xi_degrees`` is normalised OUT of the celu config (it is a
    per-job value through JobHyper); everything else in the config is
    structure."""
    celu = dataclasses.replace(spec.celu, xi_degrees=0.0)
    return (celu, spec.optimizer, spec.local_steps, spec.compression,
            spec.resolved_depth())


class FleetWorkload(NamedTuple):
    """What every job of the fleet trains on.  ``params_for(seed)`` builds
    one job's initial parameters ``{"a": [modules], "b": module}``;
    ``batch_stream()`` returns a fresh iterator of ``(batch_idx,
    batches_a, batch_b)`` (numpy or tensor dicts), shared by the whole
    fleet.  ``uniforms_for(seed)``, if given, is a job's uniform source
    (``core/uniforms.py``; the tests pass the reference's uniforms); the
    default draws from a ``torch.Generator`` seeded with the job's
    seed."""
    task: engine.KPartyTask
    params_for: Callable[[int], Dict[str, Any]]
    batch_stream: Callable[[], Any]
    uniforms_for: Optional[Callable[[int], Any]] = None


@dataclasses.dataclass
class FleetResult:
    """Per-job stacked outcomes, rows in the caller's ``configs`` order.
    Warm-up rounds of depth >= 2 jobs report NaN in ``losses`` (the
    scalar pipeline's warm-up rows)."""
    losses: np.ndarray            # (n_jobs, rounds) f32
    w_mean: np.ndarray            # (n_jobs, rounds) f32
    w_zero_frac: np.ndarray       # (n_jobs, rounds) f32
    local_steps: np.ndarray       # (n_jobs, rounds) int32
    flush_metrics: Dict[str, np.ndarray]   # each (n_jobs,)
    comm_rounds: np.ndarray       # (n_jobs,) int32, queue drained
    steps_a: List[List[int]]      # per job, one counter per party A_i
    steps_b: np.ndarray           # (n_jobs,) int64
    round_wire_bytes: np.ndarray  # (n_jobs,) exact wire bytes per round
    wall_s: float                 # rounds after the warm-up + drain
    compile_s: float              # the warm-up round (first-use build)
    n_cohorts: int
    cohort_sizes: List[int]
    mode: str
    _final: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def final_state(self, j: int) -> Dict[str, Any]:
        """Job ``j``'s final state as numpy: ``params`` {"a": [per party
        a list of arrays], "b": [...]} in the engine's leaf order
        (``engine._params``), the counters and ``comm_rounds``."""
        return self._final[j]


# --------------------------------------------------------------------------
# Stacked states: tensor leaves in, tensor leaves out of vmap
# --------------------------------------------------------------------------
class Party(NamedTuple):
    """A party's parameters outside the vmapped step: the template
    module and the stacked tensors bound into it for each call."""
    module: torch.nn.Module
    tensors: List[torch.Tensor]


def _store_like(store, ts):
    if isinstance(store, QuantLeaf):
        return type(store)(ts[0], ts[1], store.shape, store.dtype)
    return CastLeaf(ts[0], store.dtype)


def flatten(tree):
    """-> (tensor leaves, spec); :func:`unflatten` rebuilds the tree from
    the spec and a list of leaves alike.  A module (or a :class:`Party`)
    contributes its parameters in the engine's order; host values ride in
    the spec."""
    leaves: List[torch.Tensor] = []

    def go(x):
        if torch.is_tensor(x):
            leaves.append(x)
            return ("t",)
        if isinstance(x, (Party, torch.nn.Module)):
            ts = x.tensors if isinstance(x, Party) else engine._params(x)
            leaves.extend(ts)
            return ("party", x.module if isinstance(x, Party) else x,
                    len(ts))
        if isinstance(x, (CastLeaf, QuantLeaf)):
            ts = x.tensors()
            leaves.extend(ts)
            return ("store", x, len(ts))
        if isinstance(x, dict):
            return ("dict", {k: go(v) for k, v in x.items()})
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("named", type(x), [go(v) for v in x])
        if isinstance(x, (list, tuple)):
            return ("seq", type(x), [go(v) for v in x])
        return ("const", x)
    return leaves, go(tree)


def unflatten(spec, leaves):
    """Inverse of :func:`flatten`; a module comes back as a
    :class:`Party` of the template and its new tensors."""
    it = iter(leaves)

    def go(s):
        kind = s[0]
        if kind == "t":
            return next(it)
        if kind == "party":
            return Party(s[1], [next(it) for _ in range(s[2])])
        if kind == "store":
            return _store_like(s[1], [next(it) for _ in range(s[2])])
        if kind == "dict":
            return {k: go(v) for k, v in s[1].items()}
        if kind == "named":
            return s[1](*[go(v) for v in s[2]])
        if kind == "seq":
            return s[1](go(v) for v in s[2])
        return s[1]
    out = go(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def _bind(tree, stack: contextlib.ExitStack):
    """Replace every :class:`Party` of ``tree`` by its module with the
    party's tensors bound (for the life of ``stack``)."""
    if isinstance(tree, Party):
        return stack.enter_context(engine.bind_parameters(tree.module,
                                                          tree.tensors))
    if isinstance(tree, dict):
        return {k: _bind(v, stack) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_bind(v, stack) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_bind(v, stack) for v in tree)
    return tree


class FleetUniforms:
    """The cohort's uniform source under ``vmap``: a draw is N separate
    draws, job j's from its own source under its own tag, stacked, and
    each job reads its row through ``lane`` (the job's index, batched):
    the same uniforms as N scalar runs."""

    def __init__(self, sources: Sequence[Any]):
        self.sources = list(sources)
        self.lane = None

    def __call__(self, tag, shape):
        u = torch.stack([src(tag, shape).to(self.lane.device)
                         for src in self.sources])
        return u.index_select(0, self.lane.reshape(1))[0]


def _stack_states(fstates: Sequence[FleetRoundState]):
    """Per-job states alike -> (stacked leaves (N, ...), the spec)."""
    flat = [flatten(fs) for fs in fstates]
    spec = flat[0][1]
    with torch.no_grad():
        leaves = [torch.stack([x.detach() for x in ls])
                  for ls in zip(*(f[0] for f in flat))]
    return leaves, spec


def _vmapped(fn, n_jobs: int):
    """``fn(fs, hyper, *shared) -> (fs, metrics)`` of one job -> the same
    over the stacked leaves of ``n_jobs`` jobs: ``(leaves, spec, lr,
    cos_xi, sources, *shared) -> (leaves, spec, metrics (N, ...))``.
    ``shared`` (the round's batches) is every job's."""
    def run(leaves, spec, lr, cos_xi, sources, *shared):
        out = {}
        src = FleetUniforms(sources)

        def one(leaves, lr, cos_xi, lane):
            src.lane = lane
            with contextlib.ExitStack() as stack:
                fs = _bind(unflatten(spec, leaves), stack)
                fs, m = fn(fs, JobHyper(lr, cos_xi, src), *shared)
                new_leaves, out["spec"] = flatten(fs)
            return new_leaves, m

        lanes = torch.arange(n_jobs, device=lr.device)
        new_leaves, m = torch.func.vmap(one, randomness="same")(
            leaves, lr, cos_xi, lanes)
        # an output vmap broadcast from one unbatched value is an
        # expanded view: give it storage of its own before it is written
        new_leaves = [x.contiguous() if x.dim() and x.stride(0) == 0
                      else x for x in new_leaves]
        return new_leaves, out["spec"], m
    return run


def _on(batch, dev):
    if isinstance(batch, dict):
        if all(isinstance(v, np.ndarray) for v in batch.values()):
            return to_device(batch, dev)
        return {k: v.to(dev) for k, v in batch.items()}
    return batch


def _batches(workload: FleetWorkload, rounds: int, dev):
    it = workload.batch_stream()
    out = []
    for _ in range(rounds):
        bi, bas, bb = next(it)
        out.append((int(bi), [_on(b, dev) for b in bas], _on(bb, dev)))
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _numpy_state(fs: FleetRoundState, lane: Optional[int]):
    """A job's final state as numpy (``lane`` picks it from stacked
    leaves)."""
    state = fs.state

    def arr(t):
        t = t.detach() if lane is None else t.detach()[lane]
        return t.cpu().numpy()

    def params(p):
        ts = p.tensors if isinstance(p, Party) else engine._params(p)
        return [arr(t) for t in ts]
    return {"params": {"a": [params(p) for p in state["params"]["a"]],
                       "b": params(state["params"]["b"])},
            "steps": {"a": [arr(s) for s in state["steps"]["a"]],
                      "b": arr(state["steps"]["b"])},
            "comm_rounds": arr(state["comm_rounds"])}


def run_fleet(configs: Sequence[JobSpec], rounds: int, *,
              workload: FleetWorkload, mode: str = "vmap",
              shard: bool = False, mesh=None, device=None) -> FleetResult:
    """Train every job for ``rounds`` communication rounds (plus the
    queue drain) and return stacked per-job metrics.  ``device`` defaults
    to the card (``"cpu"`` only when asked for); see the module docstring
    for ``mode``.  ``shard=True`` splits every cohort's jobs over the
    ranks of ``mesh`` (default: ``make_fleet_mesh()`` over the process
    group), and each rank returns the whole fleet's result; a cohort the
    mesh's size does not divide is refused."""
    n_dev, rank, group = 1, 0, None
    if shard or mesh is not None:
        from ..launch.mesh import make_fleet_mesh
        m_ = mesh if mesh is not None else make_fleet_mesh()
        if "fleet" not in (getattr(m_, "mesh_dim_names", None) or ()):
            raise ValueError("the fleet shards over a DeviceMesh with a "
                             "'fleet' dimension (launch.mesh.make_fleet_mesh)")
        n_dev = m_.shape[m_.mesh_dim_names.index("fleet")]
        rank = m_.get_local_rank("fleet")
        group = m_.get_group("fleet")
    if mode not in ("vmap", "map"):
        raise ValueError(f"mode must be 'vmap' or 'map', got {mode!r}")
    if not configs:
        raise ValueError("empty fleet")
    dev = resolve_device(device)
    n_jobs = len(configs)
    batches = _batches(workload, rounds, dev)
    _, ex_ba, ex_bb = batches[0]

    # partition into cohorts, preserving first-seen order
    cohorts: Dict[Any, List[int]] = {}
    for j, spec in enumerate(configs):
        cohorts.setdefault(cohort_key(spec), []).append(j)

    losses = np.full((n_jobs, rounds), np.nan, np.float32)
    w_mean = np.zeros((n_jobs, rounds), np.float32)
    w_zero = np.zeros((n_jobs, rounds), np.float32)
    lsteps = np.zeros((n_jobs, rounds), np.int32)
    flush_m = {"local_steps": np.zeros(n_jobs, np.int32),
               "w_mean": np.zeros(n_jobs, np.float32),
               "w_zero_frac": np.zeros(n_jobs, np.float32)}
    commr = np.zeros(n_jobs, np.int32)
    steps_a: List[List[int]] = [[] for _ in range(n_jobs)]
    steps_b = np.zeros(n_jobs, np.int64)
    rbytes = np.zeros(n_jobs, np.int64)
    finals: List[Dict[str, Any]] = [{} for _ in range(n_jobs)]

    wall = 0.0
    compile_wall = 0.0
    for jobs in cohorts.values():
        if len(jobs) % n_dev != 0:
            raise ValueError(
                f"cohort of {len(jobs)} jobs does not divide the "
                f"{n_dev}-device fleet mesh — pad the sweep or pass "
                f"shard=False")
        block = len(jobs) // n_dev
        jobs = jobs[rank * block:(rank + 1) * block]
        spec0 = configs[jobs[0]]
        celu, depth = spec0.celu, spec0.resolved_depth()
        tp = engine.make_transport(celu, spec0.compression)
        init_fn, step_fn, flush_fn = make_fleet_step(
            workload.task, celu, depth=depth, optimizer=spec0.optimizer,
            local_steps=spec0.local_steps, transport=tp)

        # per-job scalar init
        fstates, hypers, z_shapes = [], [], None
        for j in jobs:
            spec = configs[j]
            params = workload.params_for(spec.seed)
            params = {"a": [p.to(dev) for p in params["a"]],
                      "b": params["b"].to(dev)}
            if z_shapes is None:
                with torch.no_grad():
                    z_shapes = [tuple(workload.task.forward_a(p, b).shape)
                                for p, b in zip(params["a"], ex_ba)]
            hypers.append(JobHyper.for_spec(
                spec.lr, spec.resolved_xi(), spec.seed,
                workload.uniforms_for(spec.seed)
                if workload.uniforms_for is not None
                else GeneratorUniforms(spec.seed, dev)))
            opt = make_optimizer(spec.optimizer, spec.lr)
            state = engine.init_state(workload.task, params, opt, celu,
                                      ex_ba, ex_bb, transport=tp,
                                      uniforms=hypers[-1].uniforms)
            fstates.append(init_fn(state))
        per_round = tp.round_bytes(z_shapes)
        sources = [h.uniforms for h in hypers]

        def timed(t0, first):
            nonlocal wall, compile_wall
            _sync(dev)
            if first:
                compile_wall += time.perf_counter() - t0
            else:
                wall += time.perf_counter() - t0

        if mode == "vmap":
            leaves, spec = _stack_states(fstates)
            lr, cos_xi = (torch.tensor([getattr(h, k) for h in hypers],
                                       dtype=torch.float32, device=dev)
                          for k in ("lr", "cos_xi"))
            vstep = _vmapped(step_fn, len(jobs))
            ms = []
            for t, (bi, ba, bb) in enumerate(batches):
                t0 = time.perf_counter()
                leaves, spec, m = vstep(leaves, spec, lr, cos_xi, sources,
                                        ba, bb, bi)
                ms.append(m)
                timed(t0, t == 0)
            t0 = time.perf_counter()
            leaves, spec, fm = _vmapped(flush_fn, len(jobs))(
                leaves, spec, lr, cos_xi, sources)
            timed(t0, False)
            fs_all = unflatten(spec, leaves)
            lane_states = [(fs_all, lane) for lane in range(len(jobs))]
            lane_fm = [{k: v[lane] for k, v in fm.items()}
                       for lane in range(len(jobs))]
            rows = {k: torch.stack([m[k] for m in ms]).cpu().numpy()
                    for k in ms[0]}
            lane_rows = [{k: v[:, lane] for k, v in rows.items()}
                         for lane in range(len(jobs))]
        else:
            lane_ms: List[List[Any]] = [[] for _ in jobs]
            for t, (bi, ba, bb) in enumerate(batches):
                t0 = time.perf_counter()
                for lane, h in enumerate(hypers):
                    fstates[lane], m = step_fn(fstates[lane], h, ba, bb, bi)
                    lane_ms[lane].append(m)
                timed(t0, t == 0)
            t0 = time.perf_counter()
            lane_fm = []
            for lane, h in enumerate(hypers):
                fstates[lane], fm = flush_fn(fstates[lane], h)
                lane_fm.append(fm)
            timed(t0, False)
            lane_states = [(fs, None) for fs in fstates]
            lane_rows = [{k: torch.stack([m[k] for m in lm]).cpu().numpy()
                          for k in lm[0]} for lm in lane_ms]

        # scatter cohort lanes back into caller order
        for lane, j in enumerate(jobs):
            r = lane_rows[lane]
            losses[j] = r["loss"]
            w_mean[j] = r["w_mean"]
            w_zero[j] = r["w_zero_frac"]
            lsteps[j] = r["local_steps"]
            fmj = average_flush_metrics(
                {k: v.detach().cpu().numpy() for k, v in
                 lane_fm[lane].items()})
            for k in flush_m:
                flush_m[k][j] = np.asarray(fmj[k])
            fin = _numpy_state(*lane_states[lane])
            commr[j] = int(fin["comm_rounds"])
            steps_a[j] = [int(s) for s in fin["steps"]["a"]]
            steps_b[j] = int(fin["steps"]["b"])
            rbytes[j] = per_round
            finals[j] = fin

    if n_dev > 1:
        # every rank ran its block of each cohort: gather the blocks
        mine = {j: (losses[j], w_mean[j], w_zero[j], lsteps[j],
                    {k: flush_m[k][j] for k in flush_m}, commr[j],
                    steps_a[j], steps_b[j], rbytes[j], finals[j])
                for js in cohorts.values() for j in
                js[rank * (len(js) // n_dev):(rank + 1) * (len(js) // n_dev)]}
        import torch.distributed as dist
        packs = [None] * n_dev
        dist.all_gather_object(packs, (mine, wall, compile_wall),
                               group=group)
        for pack, w_, cw_ in packs:
            wall, compile_wall = max(wall, w_), max(compile_wall, cw_)
            for j, (lo, wm, wz, ls, fm, cr, sa, sb, rb, fin) in pack.items():
                losses[j], w_mean[j], w_zero[j], lsteps[j] = lo, wm, wz, ls
                for k in flush_m:
                    flush_m[k][j] = fm[k]
                commr[j], steps_a[j], steps_b[j] = cr, sa, sb
                rbytes[j], finals[j] = rb, fin

    return FleetResult(
        losses=losses, w_mean=w_mean, w_zero_frac=w_zero,
        local_steps=lsteps, flush_metrics=flush_m, comm_rounds=commr,
        steps_a=steps_a, steps_b=steps_b, round_wire_bytes=rbytes,
        wall_s=wall, compile_s=compile_wall, n_cohorts=len(cohorts),
        cohort_sizes=[len(v) for v in cohorts.values()], mode=mode,
        _final=finals)
