"""End-to-end VFL training entry point of the port (``repro/launch/
train.py``).

``--arch wdl-criteo | dssm-avazu`` trains on the synthetic vertically
partitioned stream with the selected protocol (vanilla | fedbcd | celu)
and reports AUC and communication accounting (rounds, bytes, simulated-WAN
seconds).  ``--arch`` one of the dense LLM ids (smollm-360m, deepseek-7b,
yi-34b, codeqwen1.5-7b) runs the same round over the split LLM on the
synthetic token stream (``--batch-size``, ``--seq-len``; ``--reduced``
for the small CPU geometry; ``--remat/--no-remat`` for the towers'
activation checkpointing) and reports the loss; past 2,048 tokens its
attention takes gradients through K9-LSE and K10.  The other LLM
families come with slice 7c.  ``--cache-dtype`` sets the workset rings'
at-rest precision (float32 | bfloat16 | int8 | int4) and
``--compression`` the wire codec (a ``core.compression.CODEC_SPECS`` name
or ``up/down``).  ``--pipeline-depth D`` drives the pipelined scheduler
(``engine.make_pipeline``): D = 1 overlaps round t+1's exchange with round
t's local updates, D >= 2 keeps a D-deep queue of exchanges whose
per-slot staleness discounts the weights and damps the updates by
``1 / (1 + c·s)`` (``--pipeline-lr-damping c``); the simulated WAN clock
charges the overlapped schedule.  ``--fault-*`` runs the rounds under the
chaos engine's seeded fault plan (``core/faults.py``: dropped exchanges
with retries, stragglers, ``--fault-dropout PARTY:START:ROUNDS`` spans);
``--checkpoint PATH`` saves the whole round state every
``--checkpoint-every`` rounds and ``--resume PATH`` continues from it,
bitwise the uninterrupted run.  AdaGrad takes
the fused kernel route (K7; K8 for ``--opt-state-dtype int8``);
``--opt-state-dtype`` sets its accumulator's at-rest precision (float32 |
bfloat16 | int8) and ``--optimizer sm3`` the factored state.  It runs on
the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-criteo \\
        --protocol celu --rounds 300 --R 5 --W 5 --xi 60
    PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-criteo \\
        --device cpu --small --rounds 10 --cache-dtype int4 --compression int8
    PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-criteo \\
        --device cpu --small --rounds 10 --opt-state-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-criteo \\
        --device cpu --small --rounds 20 --pipeline-depth 2 \\
        --pipeline-lr-damping 0.5
    PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-criteo \\
        --device cpu --small --rounds 20 --pipeline-depth 2 \\
        --fault-drop-prob 0.3 --checkpoint /tmp/c.npz --checkpoint-every 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch wdl-criteo \\
        --device cpu --small --rounds 40 --pipeline-depth 2 \\
        --fault-drop-prob 0.3 --resume /tmp/c.npz
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --device cpu --reduced --rounds 4 --batch-size 2 --seq-len 16

As in the reference, the LLM path takes no fault plan and no
checkpoint: it ignores those flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from .. import checkpoint as ckpt
from .. import resolve_device
from ..configs import ARCH_IDS, DLRM_IDS, LATER_ARCH_IDS, get_config
from ..configs.base import ArchConfig, CELUConfig, DropoutSpan, FaultPlan
from ..core import engine
from ..core.faults import ChaosEngine
from ..core.protocol import VFLTask
from ..core.uniforms import GeneratorUniforms
from ..core.workset import QUANT_KEYS, workset_nbytes
from ..data import synthetic as synth
from ..data import to_device
from ..models import vfl
from ..models.tabular import DLRMConfig, auc, make_dlrm
from ..optim import make_optimizer
from ..optim.quantized import opt_state_nbytes
from .wan import WANClock, transport_round_updown

DEFAULT_WAN = WANClock()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def refuse_unported(args) -> None:
    """Exit with a message on any flag whose feature this slice of the
    port does not have."""
    later = []
    family = LATER_ARCH_IDS.get(args.arch)
    if family in ("vlm", "audio"):
        raise SystemExit("protocol training demo uses text-family archs; "
                         "vlm/audio exercise the serving path "
                         "(launch.serve) and the dry-run")
    if family is not None:
        later.append(f"--arch {args.arch} (the {family} family, slice 7c)")
    elif args.arch not in DLRM_IDS + ARCH_IDS:
        raise SystemExit(f"repro_torch.launch.train: unknown arch "
                         f"{args.arch!r}: the ids are "
                         f"{DLRM_IDS + ARCH_IDS}")
    if later:
        raise SystemExit("repro_torch.launch.train: not in the port yet: "
                         + "; ".join(later)
                         + " (see ROADMAP.md; repro.launch.train has them)")


def make_opt(args, uniforms=None):
    """Optimizer from --optimizer / --lr / --opt-state-dtype.  The state
    dtype routes AdaGrad only (the paper's optimizer; sgd / adam / sm3
    keep their own state).  AdaGrad takes the fused kernel route; the int8
    state draws its rounding uniforms from ``uniforms``."""
    kw = {}
    if args.opt_state_dtype != "float32":
        if args.optimizer != "adagrad":
            raise SystemExit("--opt-state-dtype requires --optimizer "
                             "adagrad (sm3 is already factored; sgd/adam "
                             "keep fp32 state)")
        kw["state_dtype"] = args.opt_state_dtype
    if args.optimizer == "adagrad":
        kw.update(use_pallas=True, uniforms=uniforms)
    return make_optimizer(args.optimizer, args.lr, **kw)


def fault_plan(args) -> Optional[FaultPlan]:
    """The ``FaultPlan`` of the ``--fault-*`` flags; None when no fault
    axis is set (the scheduler then stays the fault-free one)."""
    spans = []
    for s in args.fault_dropout or ():
        try:
            party, start, rounds = s.split(":")
            spans.append(DropoutSpan(party=party, start=int(start),
                                     rounds=int(rounds)))
        except ValueError:
            raise SystemExit(
                f"--fault-dropout wants PARTY:START:ROUNDS (e.g. "
                f"a0:40:5), got {s!r}")
    if not (args.fault_drop_prob or args.fault_straggler_prob or spans):
        return None
    return FaultPlan(seed=args.fault_seed,
                     drop_prob=args.fault_drop_prob,
                     max_retries=args.fault_max_retries,
                     straggler_prob=args.fault_straggler_prob,
                     straggler_rounds=args.fault_straggler_rounds,
                     dropouts=tuple(spans))


def checkpoint_extra_ref(n_pending: int, chaos: bool) -> Dict[str, Any]:
    """The structure of a checkpoint's ``extra`` tree: the resume round
    and, for a chaos run, the engine's host bookkeeping with one entry a
    pending exchange."""
    extra: Dict[str, Any] = {"round": 0}
    if chaos:
        extra["host"] = {"now": 0, "dispatch_seq": 0,
                         "arrival": [0] * n_pending,
                         "dispatch_round": [0] * n_pending,
                         "last_merged_dispatch": 0}
    return extra


class Schedule(NamedTuple):
    """How the CLI drives the rounds: ``start`` adopts ``init_state``'s
    dict, ``step(state, batches_a, batch_b, batch_idx) -> (state,
    metrics)`` runs a round and ``finish`` returns the dict, drained.
    ``engine`` is the scheduler object (a ``ChaosEngine``), None for the
    sequential ``make_round``."""
    start: Callable
    step: Callable
    finish: Callable
    engine: Optional[ChaosEngine] = None


def make_schedule(etask, opt, celu_cfg, n_local, transport, *,
                  plan: Optional[FaultPlan] = None,
                  engineful: bool = False) -> Schedule:
    """Depth 0 with no fault plan and no checkpoint (``engineful``
    false): ``engine.make_round``.  Otherwise the scheduler object the
    reference's CLI builds, a ``ChaosEngine`` over ``plan`` (with
    ``plan=None`` bitwise ``engine.make_pipeline``) over its
    ``RoundState``; the finish flushes the in-flight queue and
    finalizes."""
    if not (celu_cfg.pipeline_depth or plan is not None or engineful):
        rnd = engine.make_round(etask, opt, celu_cfg, local_steps=n_local,
                                transport=transport)
        return Schedule(lambda state: state, rnd, lambda state: state)
    pe = ChaosEngine(etask, opt, celu_cfg, plan=plan, local_steps=n_local,
                     transport=transport)

    def finish(rs):
        rs, _ = pe.flush(rs)
        return pe.finalize(rs)
    return Schedule(pe.init, pe.step, finish, pe)


def resume(path: str, sched: Schedule, rs, batches, plan, device):
    """Restore ``path`` into the fresh round state ``rs``: peek the
    in-flight count, dispatch that many exchanges from ``batches`` to
    fabricate the reference (every value is overwritten), restore into
    it and set the engine's host bookkeeping.  -> (round state, the
    round to continue from)."""
    pe = sched.engine
    n_pend = ckpt.peek_pending_len(path)
    for _ in range(n_pend):
        bi, ba, bb = next(batches)
        rs = pe.dispatch(rs, [to_device(ba, device)], to_device(bb, device),
                         bi)
    rs, extra = ckpt.restore_round_state(
        path, rs, extra_reference=checkpoint_extra_ref(n_pend,
                                                       plan is not None))
    # without a plan the fabrication moved nothing the file does not hold
    pe.load_host_state(extra["host"] if plan is not None
                       else checkpoint_extra_ref(0, True)["host"])
    start = int(extra["round"])
    print(f"[resume] {path}: round {start}, {n_pend} in-flight "
          f"exchange(s)", flush=True)
    return rs, start


class DLRMSetup(NamedTuple):
    """What ``train_dlrm`` builds before its first round."""
    dev: torch.device
    cfg: DLRMConfig
    data: Dict[str, Any]
    predict: Callable
    celu: CELUConfig
    n_local: int
    params: Dict[str, Any]
    uniforms: Any
    opt: Any
    etask: engine.KPartyTask
    transport: Any
    state: Dict[str, Any]


def setup_dlrm(args, uniforms=None, opt=None, celu=None) -> DLRMSetup:
    """The data, model, optimizer, transport and ``engine.init_state``
    of a DLRM run from the flags (see :func:`train_dlrm`)."""
    refuse_unported(args)
    dev = resolve_device(args.device)
    cfg: DLRMConfig = get_config(args.arch)
    if args.small:
        cfg = dataclasses.replace(cfg, vocab=128, embed_dim=8, z_dim=32,
                                  hidden=(64, 32))
    spec_name = {"wdl-criteo": "criteo", "dssm-avazu": "avazu"}[args.arch]
    spec = dataclasses.replace(synth.TABULAR_SPECS[spec_name],
                               vocab=cfg.vocab, n_train=args.n_train,
                               n_test=args.n_test)
    data = synth.make_tabular(spec, seed=args.seed)
    init_fn, task, predict = make_dlrm(cfg)

    celu_cfg, n_local = engine.preset_config(
        args.protocol, celu_config(args) if celu is None else celu)
    params = init_fn(args.seed, cfg, dev)
    if uniforms is None:
        uniforms = GeneratorUniforms(args.seed, dev)
    if opt is None:
        opt = make_opt(args, uniforms)

    it = synth.aligned_batches(data["train"], args.batch_size,
                               seed=args.seed)
    _, ba0, bb0 = next(it)
    etask = engine.lift_two_party(task)
    transport = engine.make_transport(celu_cfg)
    state = engine.init_state(etask, engine.lift_two_party_params(params),
                              opt, celu_cfg, [to_device(ba0, dev)],
                              to_device(bb0, dev), transport=transport,
                              uniforms=uniforms)
    return DLRMSetup(dev, cfg, data, predict, celu_cfg, n_local, params,
                     uniforms, opt, etask, transport, state)


def train_dlrm(args, uniforms=None, opt=None, celu=None) -> Dict[str, Any]:
    """Train ``args.rounds`` rounds.  ``uniforms`` is the source
    (``core/uniforms.py``) of the wire's rounding uniforms and DP noise,
    the inserts', the uniform draws' and the int8 optimizer state's; the
    default draws from a ``torch.Generator`` on the device, seeded with
    ``--seed``.  ``opt`` replaces the optimizer the flags describe, and
    ``celu`` the ``CELUConfig`` (for fields the reference's CLI has no
    flag for either: ``sampling``, ``dp_sigma``, ``dp_clip``)."""
    su = setup_dlrm(args, uniforms, opt, celu)
    dev, cfg, data, predict = su.dev, su.cfg, su.data, su.predict
    celu_cfg, n_local, params, opt = su.celu, su.n_local, su.params, su.opt
    etask, transport, state = su.etask, su.transport, su.state
    depth = celu_cfg.pipeline_depth
    tables = state["ws"]["a"] + [state["ws"]["b"]]
    cache_stat_b = sum(workset_nbytes(w, QUANT_KEYS) for w in tables)
    cache_total_b = sum(workset_nbytes(w) for w in tables)
    print(f"[cache] workset tables: {cache_total_b} B ({cache_stat_b} B "
          f"cut statistics at {celu_cfg.cache_dtype}; fused sample "
          f"{'on' if celu_cfg.cache_fused else 'off'}; device {dev})",
          flush=True)
    opt_b = [opt_state_nbytes(opt, list(p.parameters()))
             for p in (params["a"], params["b"])]
    print(f"[opt] {args.optimizer} state: Party A {opt_b[0]} B, Party B "
          f"{opt_b[1]} B (--opt-state-dtype {args.opt_state_dtype})",
          flush=True)
    plan = fault_plan(args)
    # a fault plan, a checkpoint or a resume needs the scheduler object,
    # as in the reference (with no plan it is bitwise the pipeline)
    sched = make_schedule(etask, opt, celu_cfg, n_local, transport,
                          plan=plan, engineful=bool(args.checkpoint
                                                    or args.resume))
    state = sched.start(state)
    start_round = 0
    if args.resume:
        state, start_round = resume(
            args.resume, sched, state, synth.aligned_batches(
                data["train"], args.batch_size, seed=args.seed), plan, dev)
    z_shapes = [(args.batch_size, cfg.z_dim)]
    up_bytes, down_bytes = transport_round_updown(transport, z_shapes)
    dp_note = (f"; DP sigma {celu_cfg.dp_sigma} clip {celu_cfg.dp_clip}"
               if celu_cfg.dp_sigma > 0 else "")
    print(f"[wire] compression {args.compression or 'none'}: up "
          f"{up_bytes} B, down {down_bytes} B per round "
          f"({celu_cfg.wire_dtype} wire{dp_note})", flush=True)

    te = data["test"]
    tea = to_device({"x_a": te["x_a"]}, dev)
    teb = to_device({"x_b": te["x_b"], "y": te["y"]}, dev)
    it = synth.aligned_batches(data["train"], args.batch_size,
                               seed=args.seed)
    for _ in range(start_round):    # replay the consumed prefix
        next(it)
    history = []
    train_s = 0.0        # round time only: evaluation is kept out
    steady_s = 0.0       # the same from the second round on (no set-up)
    loss = float("nan")
    t0 = time.perf_counter()
    for i in range(start_round, args.rounds):
        bi, ba, bb = next(it)
        state, m = sched.step(state, [to_device(ba, dev)],
                              to_device(bb, dev), bi)
        if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
            extra: Dict[str, Any] = {"round": i + 1}
            if plan is not None:
                extra["host"] = sched.engine.host_state()
            ckpt.save_round_state(args.checkpoint, state, extra=extra)
        on_cadence = (i + 1) % max(1, args.rounds // 10) == 0 \
            or i + 1 == args.rounds
        if i == start_round or on_cadence:
            _sync(dev)
            dt = time.perf_counter() - t0
            train_s += dt
            steady_s += dt if i > start_round else 0.0
            loss = float(m["loss"])
            if on_cadence and i:    # the parameters are trained in place
                logits = predict(params, cfg, tea, teb)
                a = auc(logits.cpu().numpy(), te["y"])
                history.append((i + 1, loss, a))
                print(f"round {i+1:6d} loss {loss:.4f} AUC {a:.4f} "
                      f"local_steps {int(m['local_steps'])} "
                      f"w_mean {float(m['w_mean']):.3f}", flush=True)
            t0 = time.perf_counter()
    # the pipeline's drain (its last scans and merges) is the last
    # rounds' work: in the compute wall, apart from the steady rounds
    t0 = time.perf_counter()
    state = sched.finish(state)
    _sync(dev)
    flush_s = time.perf_counter() - t0
    train_s += flush_s
    tel = sched.engine.telemetry() if plan is not None else None
    if tel is not None:
        print(f"[chaos] {tel['merges']} merges / {tel['dispatches']} "
              f"dispatches over {tel['rounds']} rounds: "
              f"{tel['drops']} drops, {tel['stalls']} stalls, "
              f"{tel['dropout_rounds']} dropout rounds, "
              f"{tel['wire_attempts']} wire attempts", flush=True)
    n_run = args.rounds - start_round
    # overlap-aware simulated wall-clock, as the reference charges it: the
    # measured compute split into the exchange share (1 fresh update) and
    # the local share (n_local updates); the clock serializes them with
    # the wire at depth 0 and charges max(exchange, local) at depth >= 1
    compute_per_round = train_s / max(args.rounds, 1)
    ex_c = compute_per_round / (1 + n_local)
    loc_c = compute_per_round - ex_c
    comm_s, seq_s = (DEFAULT_WAN.time_to_target(
        args.rounds, up_bytes, down_bytes, exchange_compute_s=ex_c,
        local_compute_s=loc_c, pipeline_depth=d) for d in (depth, 0))
    # a chaos run charges the wire per attempt (a retry sends again; a
    # dropout or stalled round sends nothing)
    wire_rounds = tel["wire_attempts"] if tel is not None else args.rounds
    out = {
        "arch": args.arch, "protocol": args.protocol, "device": str(dev),
        "rounds": args.rounds, "n_local": n_local,
        "final_auc": history[-1][2] if history else None,
        "final_loss": loss,
        "comm_bytes": wire_rounds * (up_bytes + down_bytes),
        "uplink_bytes": wire_rounds * up_bytes,
        "downlink_bytes": wire_rounds * down_bytes,
        "fault_telemetry": tel, "start_round": start_round,
        "sim_wan_s": comm_s, "sim_wan_sequential_s": seq_s,
        "pipeline_depth": depth, "compute_wall_s": train_s,
        "steady_round_ms": (1e3 * steady_s / (n_run - 1)
                            if n_run > 1 else None),
        "flush_ms": 1e3 * flush_s,
        "history": history,
        "state": state,
    }
    pipe_note = (f" (sequential would be {seq_s:.1f}s -> "
                 f"{seq_s / comm_s:.2f}x overlap win)") if depth else ""
    auc_note = "n/a" if out["final_auc"] is None \
        else f"{out['final_auc']:.4f}"
    print(f"[done] {args.protocol}: AUC={auc_note} "
          f"comm={out['comm_bytes']/1e6:.1f}MB "
          f"(up {up_bytes/1e3:.0f}KB/dn {down_bytes/1e3:.0f}KB per round) "
          f"simWAN={comm_s:.1f}s wall={train_s:.1f}s{pipe_note}")
    return out


def llm_task(cfg: ArchConfig, remat: bool = True) -> VFLTask:
    """The two-party task over the LLM split (text family): the parties'
    parameters are ``vfl.PartyParams``; ``remat`` toggles the towers'
    activation checkpointing."""
    def forward_a(pa, batch_a):
        return vfl.forward_a(pa, cfg, batch_a, train=True, remat=remat)

    def loss_b(pb, z_a, batch_b):
        return vfl.per_instance_loss(pb, cfg, z_a, batch_b, train=True,
                                     remat=remat)

    return VFLTask(forward_a, loss_b)


def llm_params(cfg: ArchConfig, seed: int, device):
    """{"a", "b"} ``vfl.PartyParams`` drawn from ``seed`` on ``device``."""
    tree = vfl.init_all(seed, cfg, device)
    return {p: vfl.PartyParams(tree[p]) for p in ("a", "b")}


def train_llm(args, params=None) -> Dict[str, Any]:
    """Train the LLM split model ``args.rounds`` rounds on the synthetic
    token stream.  ``params`` ({"a", "b"} ``vfl.PartyParams``, trained in
    place) replaces the ones drawn from ``--seed``."""
    refuse_unported(args)
    dev = resolve_device(args.device)
    cfg: ArchConfig = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    B, S = args.batch_size, args.seq_len
    data = synth.make_token_stream(max(B * 8, 64), S, cfg.vocab_size,
                                   cfg.aux_vocab_size, seed=args.seed)
    task = llm_task(cfg, remat=args.remat)
    celu_cfg, n_local = engine.preset_config(args.protocol,
                                             celu_config(args))
    if params is None:
        params = llm_params(cfg, args.seed, dev)
    uniforms = GeneratorUniforms(args.seed, dev)
    opt = make_opt(args, uniforms)

    it = synth.token_batches(data, B, seed=args.seed)
    _, ba0, bb0 = next(it)
    etask = engine.lift_two_party(task)
    transport = engine.make_transport(celu_cfg)
    state = engine.init_state(etask, engine.lift_two_party_params(params),
                              opt, celu_cfg, [to_device(ba0, dev)],
                              to_device(bb0, dev), transport=transport,
                              uniforms=uniforms)
    sched = make_schedule(etask, opt, celu_cfg, n_local, transport)
    state = sched.start(state)
    z_shapes = [(B, S, cfg.d_model)]
    up_bytes, down_bytes = transport_round_updown(transport, z_shapes)
    print(f"[llm] {cfg.name}: B={B} S={S} R={celu_cfg.R} W={celu_cfg.W} "
          f"{args.protocol}, remat {'on' if args.remat else 'off'}, "
          f"pipeline depth {celu_cfg.pipeline_depth}, "
          f"device {dev}; wire up {up_bytes} B, down {down_bytes} B per "
          f"round ({celu_cfg.wire_dtype} wire)", flush=True)
    it = synth.token_batches(data, B, seed=args.seed)
    losses, round_s = [], []
    for i in range(args.rounds):
        t0 = time.perf_counter()
        bi, ba, bb = next(it)
        state, m = sched.step(state, [to_device(ba, dev)],
                              to_device(bb, dev), bi)
        _sync(dev)
        round_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        if (i + 1) % max(1, args.rounds // 10) == 0:
            print(f"round {i+1:4d} loss {losses[-1]:.4f} local_steps "
                  f"{int(m['local_steps'])} w_mean "
                  f"{float(m['w_mean']):.3f}", flush=True)
    t0 = time.perf_counter()
    state = sched.finish(state)  # drain the in-flight queue
    _sync(dev)
    flush_s = time.perf_counter() - t0
    print(f"[done] {args.arch} {args.protocol}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"arch": args.arch, "protocol": args.protocol,
            "device": str(dev), "rounds": args.rounds, "n_local": n_local,
            "pipeline_depth": celu_cfg.pipeline_depth,
            "losses": losses, "round_s": round_s, "flush_s": flush_s,
            "comm_bytes": args.rounds * (up_bytes + down_bytes),
            "state": state}


def celu_config(args) -> CELUConfig:
    """The technique's hyper-parameters from the flags."""
    return CELUConfig(R=args.R, W=args.W, xi_degrees=args.xi,
                      weighting=not args.no_weighting,
                      cache_fused=not args.no_cache_fusion,
                      compression=args.compression,
                      cache_dtype=args.cache_dtype,
                      pipeline_depth=args.pipeline_depth,
                      pipeline_lr_damping=args.pipeline_lr_damping)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--protocol", default="celu",
                    choices=("vanilla", "fedbcd", "celu"))
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=64,
                    help="LLM archs: tokens per instance")
    ap.add_argument("--R", type=int, default=5)
    ap.add_argument("--W", type=int, default=5)
    ap.add_argument("--xi", type=float, default=60.0)
    ap.add_argument("--no-weighting", action="store_true")
    ap.add_argument("--no-cache-fusion", action="store_true",
                    help="materialise the sampled workset entry and weight "
                         "it with the row-gate kernel (K2) instead of the "
                         "fused ring-sample kernel (K1)")
    ap.add_argument("--optimizer", default="adagrad",
                    choices=("adagrad", "sgd", "adam", "sm3"))
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true",
                    help="smaller DLRM dims for quick CPU runs")
    ap.add_argument("--reduced", action="store_true",
                    help="LLM archs: the small CPU geometry of "
                         "ArchConfig.reduced()")
    ap.add_argument("--remat", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="LLM archs: activation-checkpoint each tower "
                         "layer (recompute in the backward; --no-remat "
                         "keeps all activations)")
    ap.add_argument("--n-train", type=int, default=32768)
    ap.add_argument("--n-test", type=int, default=8192)
    ap.add_argument("--compression", default="",
                    help="wire codec: identity | int8 | int4 | int4x2 | "
                         "topk | topk_int8 | topk_int4 | int8_topk | "
                         "int4_topk | <up>/<down> (default: the plain wire)")
    ap.add_argument("--cache-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8", "int4"),
                    help="at-rest precision of the workset rings' Z / ∇Z")
    ap.add_argument("--opt-state-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"),
                    help="at-rest precision of AdaGrad's accumulator")
    ap.add_argument("--pipeline-depth", type=int, default=0, metavar="D",
                    help="0 = sequential rounds; 1 = overlap round t+1's "
                         "WAN exchange with round t's local updates "
                         "(paper §4.1 two-worker pipeline); D >= 2 = a "
                         "D-deep queue of in-flight exchanges for "
                         "high-RTT links where one exchange cannot hide "
                         "behind one local scan.  Every cached entry gets "
                         "D exchanges staler, so D >= 2 trades rounds for "
                         "wall-clock: weights are attenuated w -> w^(1+s) "
                         "per slot and updates lr-damped by "
                         "1/(1 + c*s) (see --pipeline-lr-damping); D must "
                         "stay < W")
    ap.add_argument("--pipeline-lr-damping", type=float, default=0.25,
                    metavar="C",
                    help="staleness-aware lr damping coefficient c of the "
                         "eta/(1 + c*s) schedule applied to local and "
                         "fresh updates on the depth-D (D >= 2) pipeline; "
                         "0 disables (depths 0/1 never damp)")
    ap.add_argument("--fault-drop-prob", type=float, default=0.0,
                    metavar="P",
                    help="per-attempt exchange drop probability of the "
                         "chaos layer (core/faults.py); any --fault-* axis "
                         "switches the scheduler to the seeded ChaosEngine")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault schedule")
    ap.add_argument("--fault-max-retries", type=int, default=2,
                    help="wire retries per exchange before the round's "
                         "update is abandoned (the residuals absorb it)")
    ap.add_argument("--fault-straggler-prob", type=float, default=0.0,
                    metavar="P",
                    help="probability that a delivered exchange arrives "
                         "late")
    ap.add_argument("--fault-straggler-rounds", type=int, default=2,
                    help="most rounds of straggler delay")
    ap.add_argument("--fault-dropout", action="append", default=[],
                    metavar="PARTY:START:ROUNDS",
                    help="take a party down for a span of rounds "
                         "(repeatable), e.g. a0:40:5 or b:100:10; the "
                         "others keep updating from cached statistics")
    ap.add_argument("--checkpoint", default="", metavar="PATH",
                    help="save the whole round state (parameters, "
                         "optimizer, worksets, transport residuals, the "
                         "in-flight exchange queue, the uniform "
                         "generator) to PATH every --checkpoint-every "
                         "rounds")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    metavar="N")
    ap.add_argument("--resume", default="", metavar="PATH",
                    help="resume from a --checkpoint file, bitwise the "
                         "uninterrupted run (same flags, same seed)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = (train_dlrm if args.arch in DLRM_IDS else train_llm)(args)
    out.pop("state")
    return out


if __name__ == "__main__":
    main()
