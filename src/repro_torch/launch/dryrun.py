"""Multi-pod dry-run: trace every (arch × shape × production mesh) on a
fake process group of the mesh's size and take the H100 roofline terms
(the port of ``repro/launch/dryrun.py``).

Run it as its own process (a process holds one process group):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.jsonl
  ... add --multi-pod for the 2 x 16 x 16 512-GPU mesh.

No card is needed.  Rank 0 of a ``"fake"`` process group of 256 or 512
ranks (``torch.testing._internal.distributed.fake_pg``: every collective
returns at once) builds the production mesh (``launch/mesh.py``), places
the parameters, the AdaGrad state, the batch and the decode caches as
DTensors by ``sharding/rules.py`` (``params_pspecs``, ``batch_pspec``,
``cache_pspecs``) over tensors without data (``FakeTensorMode``), and
runs one step of the shape's kind (train, prefill or decode) eagerly.
There is no compiler to ask, so the trace itself is read
(:class:`StepCounter`, :func:`trace_step`) on the local shards' ops, one
device's program:

  * operations: the matrix products' (``torch.utils.flop_counter``'s
    formulas, 2 a multiply-add) plus the hand-written kernels', which on
    abstract tensors add the counts their bounds use to an accountant
    (``kernels/_cuda.py``): attention past 2,048 tokens is costed as K9 /
    K9-LSE / K10 run on the card, never as a dense score matrix;
  * bytes accessed: the reference's un-fused convention, every op's
    operands and results summed (views, empty allocations and
    collectives move none), plus the kernels' bytes;
  * collective bytes, by kind, from the ``_c10d_functional`` ops that
    DTensor issues (:func:`collective_bytes`);
  * peak device memory: the most bytes that the step's live tensors
    (its arguments included) held at once.

The terms use the card's constants (``launch/mesh.py``).  They are a
model built from the H100 data sheet, not a measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import sys
import time
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import SHAPES, arch_for_shape
from ..configs.base import ArchConfig, ShapeConfig
from ..kernels import _cuda
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# the caching allocator's granule on the card
_CUDA_BLOCK = 512


def _collective_kind(name: str):
    """A ``_c10d_functional`` op's reference key, or None.  DTensor
    issues no point-to-point exchange, so collective-permute stays 0."""
    for pat, kind in (("all_gather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("all_to_all", "all-to-all")):
        if pat in name:
            return kind
    return None


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _tensors(tree):
    """The tensors of a tree (a module's parameters and buffers)."""
    import torch.utils._pytree as pytree
    out = []
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.nn.Module):
            out.extend(t.parameters())
            out.extend(t.buffers())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts one device's operations, bytes, collectives and live memory
    over the ops it sees.  Entered inside the ``FakeTensorMode`` whose
    tensors the step runs on (or on real tensors), it sees the local
    ops: for a DTensor op it steps aside (``NotImplemented``) and sees
    the ops on the shards that DTensor then runs.  DTensor's sharding
    propagation also runs ops, on global shapes, to learn its outputs'
    metadata: :func:`trace_step` marks that span (``shadow``) and those
    ops are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.shadow = 0
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0 for k in COLLECTIVE_OPS}
        self.live = 0
        self.peak = 0
        from torch.utils.weak import WeakIdKeyDictionary
        self._seen = WeakIdKeyDictionary()
        self._roles = {}

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live; -> the bytes newly counted."""
        added = 0
        for t in _tensors(tree):
            t = getattr(t, "_local_tensor", t)
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            if t.device.type == "cuda":
                n = -(-n // _CUDA_BLOCK) * _CUDA_BLOCK
            self._seen[st] = weakref.ref(st, self._freed(n))
            self.live += n
            added += n
        self.peak = max(self.peak, self.live)
        return added

    def _freed(self, n: int):
        def cb(_ref):
            self.live -= n
        return cb

    def _role(self, func):
        """How an op counts: "coll" (a collective), "skip" (no data
        moved: views, empty allocations, metadata, the kernels' ops whose
        costs the accountant has), or "count"."""
        role = self._roles.get(func)
        if role is None:
            name = func.name()
            if func.namespace.startswith("_c10d_functional") \
                    and _collective_kind(name) is not None:
                role = "coll"
            elif func.namespace in ("repro_torch", "prim") \
                    or _is_view(func) or "empty" in name:
                role = "skip"
            else:
                role = "count"
            self._roles[func] = role
        return role

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default \
                and isinstance(args[0], torch.Tensor) \
                and _cuda.is_abstract(args[0]):
            # eager waits return their input; the fake rule makes a copy
            return args[0]
        out = func(*args, **kwargs)
        if self.shadow:
            return out
        role = self._role(func)
        if role == "coll":
            self.collectives[_collective_kind(func.name())] += \
                _nbytes(args[0])
        elif role == "count":
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in _tensors(out))
            count = self._flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += int(count(*args, **kwargs, out_val=out))
        self.track(out)
        return out


@contextlib.contextmanager
def _propagation_marked(counter: StepCounter):
    """Mark DTensor's metadata propagation (its ops on global shapes) as
    ``counter.shadow`` while it runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *a, **k):
        counter.shadow += 1
        try:
            return orig(self, *a, **k)
        finally:
            counter.shadow -= 1
    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def trace_step(step, *args) -> Dict[str, Any]:
    """Run ``step(*args)`` once and read it as one device.  The arguments
    are tensors (or DTensors) made under the ``FakeTensorMode`` that is
    active here, or real tensors.  -> {"peak_bytes", "argument_bytes",
    "output_bytes", "flops", "bytes", "collectives", "kernels",
    "trace_s"}: ``flops`` and ``bytes`` include the kernels' own counts
    (``kernels`` maps a kernel to [calls, operations, bytes])."""
    counter = StepCounter()
    arg_bytes = counter.track(args)
    t0 = time.perf_counter()
    with _cuda.accounting() as acc, _propagation_marked(counter), counter:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    return {"peak_bytes": counter.peak, "argument_bytes": arg_bytes,
            "output_bytes": sum(_nbytes(getattr(t, "_local_tensor", t))
                                for t in _tensors(out)),
            "flops": counter.flops + acc.flops(),
            "bytes": counter.bytes + acc.nbytes(),
            "collectives": dict(counter.collectives),
            "kernels": {k: list(v) for k, v in acc.kernels.items()},
            "trace_s": trace_s}


def collective_bytes(trace: Dict[str, Any]) -> Dict[str, int]:
    """Operand bytes of every collective the trace executed, by the
    reference's keys.  Its convention (all-reduce, all-to-all: operand =
    result; all-gather: result / g; reduce-scatter: result · g) is each
    op's input, which is what :class:`StepCounter` adds.  The reference
    walks the compiled HLO's while loops and multiplies by trip counts;
    an eager trace runs every loop, so each executed collective is seen
    once per execution and nothing is multiplied."""
    return dict(trace["collectives"])


# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _flops_dense(cfg: ArchConfig):
    """(total, MoE-active) parameter counts from abstract shapes: an
    expert leaf is one under a ``wg`` / ``wu`` / ``wd`` key with three
    dims or more, as in the reference."""
    from ..sharding.rules import walk
    from .steps import abstract_params
    leaves = list(walk(abstract_params(cfg).tree()))
    total = sum(math.prod(x.shape) for _, x in leaves)
    active = total
    if cfg.moe is not None:
        expert = sum(math.prod(x.shape) for path, x in leaves
                     if any(k in ("wg", "wu", "wd") for k in path)
                     and x.dim() >= 3)
        frac = (cfg.moe.top_k + cfg.moe.n_shared) / cfg.moe.n_experts
        active = total - expert + int(expert * frac)
    return total, active


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D for training, 2·N_active a token for prefill and decode."""
    total, active = _flops_dense(cfg)
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch  # one token


# --------------------------------------------------------------------------
def fake_world(size: int) -> None:
    """This process as rank 0 of a ``"fake"`` process group of ``size``
    ranks (a group of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _place_caches(caches, mesh, batch_axes):
    """Decode caches (fake tensors) as DTensors placed by
    ``rules.cache_pspecs``."""
    from torch.distributed.tensor import distribute_tensor

    from ..sharding.rules import cache_pspecs, map_leaves, placements
    specs = cache_pspecs(caches, mesh, data_axes=batch_axes)

    def place(path, t):
        spec = specs
        for c in path:
            spec = spec[int(c) if isinstance(spec, list) else c]
        return distribute_tensor(t, mesh, placements(mesh, spec),
                                 src_data_rank=None)
    return map_leaves(place, caches)


def dryrun(arch_id: str, shape_name: str, *, multi_pod: bool = False,
           fsdp: bool = True, moe_sharding: str = "",
           extra_tag: str = "", microbatches: int = 1,
           pure_dp: bool = False, zero1: bool = False,
           moe_capacity: float = 0.0) -> Dict[str, Any]:
    """One (arch, shape, mesh) line.  ``pure_dp``: the batch over every
    mesh axis, the parameters replicated (the profile for archs whose
    head or expert counts defeat 16-way tensor parallelism); ``zero1``:
    only the AdaGrad accumulators sharded over ``data``.  The eager step
    updates its parameters and state in place, as the reference's
    donated buffers do.  ``compile_s`` is the trace's seconds (there is
    no compile)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..bridge import reference_parameters
    from ..models import vfl
    from ..optim import adagrad
    from ..sharding.rules import params_pspecs, placements
    from . import steps
    from .mesh import data_axes, make_production_mesh
    cfg = arch_for_shape(arch_id, shape_name)
    if not moe_sharding:
        moe_sharding = cfg.moe.sharding if cfg.moe is not None else "tp"
    if moe_capacity and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=moe_capacity))
    shape = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    daxes = data_axes(mesh) + (("model",) if pure_dp else ())
    vocab_axis = None if pure_dp else "model"
    t0 = time.time()

    with FakeTensorMode(allow_non_fake_inputs=True):
        params = vfl.PartyParams(vfl.init_all(0, cfg))
        rules = functools.partial(
            params_pspecs, dict(params.named_parameters()), mesh,
            model_axis="__none__" if pure_dp else "model",
            moe_sharding=moe_sharding)
        steps.shard_params(params, mesh,
                           rules(fsdp_axis="data" if fsdp else None))
        specs = steps.input_specs(cfg, shape, device="cpu")
        if shape.kind == "train":
            leaves = reference_parameters(params)
            # the CLI's AdaGrad: the K7 route, fp32 state
            opt = adagrad(0.01, use_pallas=True)
            state = opt.init(leaves)
            if zero1:
                acc_specs = rules(fsdp_axis="data")
                name_of = {id(p): n for n, p in params.named_parameters()}
                state["accum"] = [a.redistribute(mesh, placements(
                    mesh, acc_specs[name_of[id(p)]]))
                    for a, p in zip(state["accum"], leaves)]
            step = steps.make_sharded_train_step(
                cfg, opt, mesh, microbatches=microbatches,
                batch_axes=daxes, vocab_axis=vocab_axis)
            args = (params, state,
                    steps.shard_batch(specs["batch"], mesh, daxes))
        elif shape.kind == "prefill":
            step = steps.on_mesh(steps.make_prefill_step(cfg), mesh, daxes,
                                 vocab_axis)
            args = (params, steps.shard_batch(specs["batch"], mesh, daxes))
        else:
            step = steps.on_mesh(steps.make_serve_step(cfg), mesh, daxes,
                                 vocab_axis)
            args = (params, _place_caches(specs["caches"], mesh, daxes),
                    steps.shard_batch(specs["step_batch"], mesh, daxes),
                    specs["pos"])
        trace = trace_step(step, *args)
    coll = collective_bytes(trace)
    coll_total = sum(coll.values())
    flops = float(trace["flops"])
    bytes_acc = float(trace["bytes"])
    mf = model_flops(cfg, shape)
    terms = {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": coll_total / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    peak = trace["peak_bytes"]
    return {
        "arch": arch_id, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "fsdp": fsdp, "moe_sharding": moe_sharding,
        "tag": extra_tag,
        "pure_dp": pure_dp, "microbatches": microbatches,
        "ok": True,
        "compile_s": round(time.time() - t0, 1),
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": bytes_acc,
        "collective_bytes_per_dev": coll_total,
        "collectives": coll,
        "model_flops_global": mf,
        "model_flops_per_dev": mf / chips,
        "useful_flops_frac": (mf / chips) / flops if flops else 0.0,
        "roofline": terms,
        "dominant": dominant,
        "memory": {
            "argument_bytes": trace["argument_bytes"],
            "output_bytes": trace["output_bytes"],
            "temp_bytes": peak - trace["argument_bytes"],
            "peak_bytes": peak,
        },
        "kernels": trace["kernels"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every assigned arch x shape")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--moe-sharding", default="",
                    choices=("", "tp", "ep"))
    ap.add_argument("--microbatch", type=int, default=1)
    # the reference's choice between a scan over the microbatches and an
    # unrolled loop; a no-op here: the eager loop always runs every
    # microbatch, so the trace sees each one's collectives as executed
    ap.add_argument("--unroll-microbatch", action="store_true")
    ap.add_argument("--pure-dp", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--moe-capacity", type=float, default=0.0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS
    archs = ARCH_IDS if args.all else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    triples = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    rc = 0
    for a, s, mp in triples:
        try:
            res = dryrun(a, s, multi_pod=mp, fsdp=not args.no_fsdp,
                         moe_sharding=args.moe_sharding, extra_tag=args.tag,
                         microbatches=args.microbatch,
                         pure_dp=args.pure_dp, zero1=args.zero1,
                         moe_capacity=args.moe_capacity)
        except Exception as e:  # noqa: BLE001 — record failures, keep going
            res = {"arch": a, "shape": s,
                   "mesh": "2x16x16" if mp else "16x16", "ok": False,
                   "tag": args.tag, "error": f"{type(e).__name__}: {e}"}
            rc = 1
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            import pathlib
            pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
