"""Quickstart on the PyTorch port (the twin of ``examples/quickstart.py``):
CELU-VFL against vanilla VFL and FedBCD on the paper's WDL/Criteo workload
(synthetic, far-from-convergence regime like the paper's 41M-row stream).

All protocols are presets of the same K-party round engine
(``repro_torch.core.engine``) over a ``SimWANTransport``; they get the
SAME communication budget (400 rounds = the same WAN bytes), and CELU
funds 1+R model updates per round from its workset.  On the card the
local updates' gate runs K1 (K4 over the int8 cache), the quantising
inserts and the int8 wire K3, and every party update K7.  It runs on the
card unless ``--device cpu`` is given; ``--rounds`` cuts the budget.

    python examples/torch/quickstart.py
    python examples/torch/quickstart.py --device cpu --rounds 30
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.base import CELUConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.uniforms import GeneratorUniforms  # noqa: E402
from repro_torch.core.workset import QUANT_KEYS, workset_nbytes  # noqa: E402
from repro_torch.data import synthetic as synth  # noqa: E402
from repro_torch.data import to_device  # noqa: E402
from repro_torch.launch.wan import WANClock  # noqa: E402
from repro_torch.models.tabular import DLRMConfig, auc, make_dlrm  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

ROUNDS = 400
LR = 0.003
EVAL_EVERY = 100
CLOCK = WANClock()           # paper §2.1: 300 Mbps each way, 10 ms/leg
# The convergence runs are at miniature geometry (Z_A dim 32, B = 256); the
# wall-clock model takes the paper's deployment geometry (Z_A dim 256,
# B = 4096: 2 x 4 MB = 244 ms a round at 300 Mbps, §2.1) with cross-silo
# CPU-party compute, R = 5 updates x ~40 ms filling one exchange's window
# (the paper's Fig. 4 regime).  The same constants as the reference's
# ``benchmarks/end_to_end.py``.
PAPER_Z_SHAPE = (4096, 256)
COMPUTE_PER_UPDATE = 0.04    # s per model update, CPU-party scale
CELU = dict(R=5, W=5, xi=60.0)
# (name, protocol, the run's options): the reference script's presets
PRESETS = (
    ("vanilla", "vanilla", {}),
    ("fedbcd R=5", "fedbcd", dict(R=5)),
    ("celu   R=5", "celu", CELU),
    # the two-worker pipeline (paper Fig. 4): round t+1's WAN exchange is
    # dispatched while round t's local updates run
    ("celu   R=5 pipe=1", "celu", dict(CELU, pipeline_depth=1)),
    # the depth-D exchange queue (D >= 2): entries get D exchanges staler,
    # so weights are attenuated per slot (w -> w^(1+s)) and updates
    # lr-damped by 1/(1 + c*s) (c = 0.25)
    ("celu   R=5 pipe=2", "celu", dict(CELU, pipeline_depth=2)),
    # the compressed wire: top-k + int8 sketches up, dense int8 down, error
    # feedback carrying the compression error between rounds
    ("celu   R=5 int8_topk", "celu", dict(CELU, compression="int8_topk")),
    # the quantised-at-rest workset cache: int8 codes + one fp32 scale per
    # instance row, sampled through the fused gather-dequant-weight kernel
    ("celu   R=5 int8cache", "celu", dict(CELU, cache_dtype="int8")),
)


def hard_workload(model: str = "wdl", dataset: str = "criteo",
                  seed: int = 0):
    """Far-from-convergence regime like the paper's 41M-row stream: 4x the
    hash vocabulary and 4x the rows, so each embedding row is updated
    rarely and the rounds stay mid-curve.  -> (spec, data, cfg)."""
    spec = dataclasses.replace(synth.TABULAR_SPECS[dataset], vocab=512,
                               n_train=131072, n_test=8192)
    data = synth.make_tabular(spec, seed=seed)
    cfg = DLRMConfig(model, spec.fields_a, spec.fields_b, vocab=512,
                     embed_dim=8, z_dim=32, hidden=(64, 32))
    return spec, data, cfg


def paper_round_updown(compression: str = ""):
    """Per-round (uplink, downlink) wire bytes at the paper's deployment
    geometry for a wire codec ('' = the plain fp32 wire)."""
    tp = engine.make_transport(CELUConfig(), compression)
    return (tp.uplink_bytes(PAPER_Z_SHAPE),
            tp.downlink_bytes(PAPER_Z_SHAPE))


def sim_time(rounds: int, updown, local_ratio: float,
             pipeline_depth: int = 0,
             compute_per_update: float = COMPUTE_PER_UPDATE) -> float:
    """Overlap-aware simulated seconds of ``rounds`` rounds: ``updown`` is
    the paper-geometry (uplink, downlink) split, ``local_ratio`` the local
    updates funded per exchange (R)."""
    up, down = updown
    return CLOCK.time_to_target(
        rounds, up, down, exchange_compute_s=compute_per_update,
        local_compute_s=local_ratio * compute_per_update,
        pipeline_depth=pipeline_depth)


def preset_config(protocol: str, *, R=5, W=5, xi=60.0, pipeline_depth=0,
                  cache_dtype="float32"):
    """-> (the preset's ``CELUConfig``, its local updates a round)."""
    return engine.preset_config(protocol, CELUConfig(
        R=R, W=W, xi_degrees=xi, pipeline_depth=pipeline_depth,
        cache_dtype=cache_dtype))


def run_protocol(protocol: str, data, cfg, *, R=5, W=5, xi=60.0,
                 rounds=ROUNDS, batch=256, lr=LR, seed=0,
                 eval_every=EVAL_EVERY, compression=None,
                 pipeline_depth=0, cache_dtype="float32", device=None,
                 params=None, uniforms=None) -> dict:
    """Train with one protocol preset of the round engine and return the
    AUC-vs-round curve, the losses, the counters, the cut statistics'
    ring bytes and the wire bytes a round.
    ``params`` ({"a", "b"} modules on the device) replaces the ones drawn
    from ``seed``; ``uniforms`` (a uniform source, ``core/uniforms.py``)
    the default generator's rounding uniforms.  ``pipeline_depth >= 1``
    runs the pipelined scheduler (the first D-1 rounds of a depth-D queue
    report a NaN loss)."""
    dev = resolve_device(device)
    init_fn, task, predict = make_dlrm(cfg)
    ccfg, nloc = preset_config(protocol, R=R, W=W, xi=xi,
                               pipeline_depth=pipeline_depth,
                               cache_dtype=cache_dtype)
    if params is None:
        params = init_fn(seed, cfg, dev)
    if uniforms is None:
        uniforms = GeneratorUniforms(seed, dev)
    opt = make_optimizer("adagrad", lr, use_pallas=True)
    etask = engine.lift_two_party(task)
    transport = engine.make_transport(ccfg, compression)
    it = synth.aligned_batches(data["train"], batch, seed=seed)
    _, ba, bb = next(it)
    state = engine.init_state(etask, engine.lift_two_party_params(params),
                              opt, ccfg, [to_device(ba, dev)],
                              to_device(bb, dev), transport=transport,
                              uniforms=uniforms)
    tables = state["ws"]["a"] + [state["ws"]["b"]]
    if pipeline_depth:
        drv = engine.make_pipeline(etask, opt, ccfg, depth=pipeline_depth,
                                   local_steps=nloc, transport=transport)
        step = drv.step
        state = drv.init(state)
    else:
        step = engine.make_round(etask, opt, ccfg, local_steps=nloc,
                                 transport=transport)
    it = synth.aligned_batches(data["train"], batch, seed=seed)
    te = data["test"]
    tea = to_device({"x_a": te["x_a"]}, dev)
    teb = to_device({"x_b": te["x_b"], "y": te["y"]}, dev)
    curve, losses, local_steps = [], [], []
    t0 = time.perf_counter()
    for i in range(rounds):
        bi, ba, bb = next(it)
        state, m = step(state, [to_device(ba, dev)], to_device(bb, dev), bi)
        losses.append(m["loss"])          # device tensors: no sync a round
        local_steps.append(m["local_steps"])
        if (i + 1) % eval_every == 0 or i + 1 == rounds:
            # the parameters are trained in place
            logits = predict(params, cfg, tea, teb)
            curve.append((i + 1, auc(logits.cpu().numpy(), te["y"])))
    if pipeline_depth:
        state, _ = drv.flush(state)
        state = drv.finalize(state)
    wall_s = time.perf_counter() - t0
    z_shapes = [(batch, cfg.z_dim)]
    return {
        "curve": curve, "final_auc": curve[-1][1],
        "loss_curve": [float(x) for x in losses],
        "local_steps": [int(x) for x in local_steps],
        "steps_a": int(state["steps"]["a"][0]),
        "steps_b": int(state["steps"]["b"]),
        "comm_rounds": int(state["comm_rounds"]),
        "stat_cache_bytes": sum(workset_nbytes(w, QUANT_KEYS)
                                for w in tables),
        "z_bytes_per_round": transport.round_bytes(z_shapes),
        "wall_s": wall_s,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help="communication rounds a preset (the equal budget)")
    return ap


def main(argv=None) -> dict:
    """-> {"results": each preset's run_protocol result by name, "lines":
    the printed lines, and the printed figures: "z_bytes_per_round",
    "int8_topk_bytes_per_round", "cache_bytes" (fp32, int8), "sim_wan_s"
    (by pipeline depth)}."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    rounds = args.rounds
    lines = []

    def say(s=""):
        print(s, flush=True)
        lines.append(s)

    say("== CELU-VFL quickstart: WDL on synthetic Criteo ==")
    spec, data, cfg = hard_workload("wdl", "criteo")
    say(f"dataset: {spec.n_train} rows, fields A/B = "
        f"{spec.fields_a}/{spec.fields_b}; Z_A dim = {cfg.z_dim}; "
        f"equal budget: {rounds} communication rounds each\n")
    results = {}
    for name, proto, kw in PRESETS:
        r = run_protocol(proto, data, cfg, rounds=rounds, device=dev, **kw)
        results[name] = r
        curve = "  ".join(f"@{s}:{a:.4f}" for s, a in r["curve"])
        say(f"{name}:  {curve}")

    zb = results["vanilla"]["z_bytes_per_round"]
    czb = results["celu   R=5 int8_topk"]["z_bytes_per_round"]
    say(f"\nWAN bytes spent by the fp32 wire: {rounds * zb / 1e6:.1f} MB "
        f"({zb / 1e3:.0f} KB/round); CELU extracted "
        f"{1 + 5}x the model updates from them.")
    say(f"int8_topk wire: {czb / 1e3:.1f} KB/round "
        f"({zb / czb:.1f}x fewer bytes at the same round budget); "
        "bf16 wire (CELUConfig.wire_dtype) is the lighter-touch option — "
        "see benchmarks `beyond` block.")
    # the workset table holds W batches of ⟨Z, ∇Z⟩ per party; int8 at rest
    # cuts it ~4x: fp32 2·W·B·F·4 B, int8 2·W·B·(F + 4) B (codes + scale)
    r32, r8 = results["celu   R=5"], results["celu   R=5 int8cache"]
    say(f"\nworkset cache (this run's geometry): "
        f"{r32['stat_cache_bytes'] / 1e3:.0f} KB fp32 -> "
        f"{r8['stat_cache_bytes'] / 1e3:.0f} KB int8 "
        f"({r32['stat_cache_bytes'] / r8['stat_cache_bytes']:.2f}x "
        f"smaller, measured); at paper geometry (W=5, B=4096, z=256): "
        f"{2 * 5 * 4096 * 256 * 4 / 1e6:.1f} MB -> "
        f"{2 * 5 * 4096 * (256 + 4) / 1e6:.1f} MB per party.  "
        f"AUC parity: {r32['final_auc']:.4f} fp32 vs "
        f"{r8['final_auc']:.4f} int8.")
    # overlap-aware latency at the paper's deployment geometry: the
    # pipelined schedule pays max(exchange, local) a round, the
    # sequential one their sum (launch/wan.py's WANClock)
    updown = paper_round_updown()
    sim = {d: sim_time(rounds, updown, 5.0, pipeline_depth=d)
           for d in (0, 1, 2)}
    t_seq, t_pipe, t_deep = sim[0], sim[1], sim[2]
    say(f"pipelined schedule (pipe=1): the same {rounds} rounds cost "
        f"{t_pipe:.0f}s of simulated WAN time vs {t_seq:.0f}s sequential "
        f"-> {t_seq / t_pipe:.2f}x lower latency at paper geometry "
        f"(300 Mbps, {COMPUTE_PER_UPDATE * 1e3:.0f} ms/update); the "
        f"depth-2 queue amortizes the exchange over 2 rounds -> "
        f"{t_deep:.0f}s ({t_seq / t_deep:.2f}x), bounded below by the "
        f"serial wire occupancy.")
    return {"results": results, "lines": lines, "z_bytes_per_round": zb,
            "int8_topk_bytes_per_round": czb,
            "cache_bytes": {"float32": r32["stat_cache_bytes"],
                            "int8": r8["stat_cache_bytes"]},
            "sim_wan_s": sim}


if __name__ == "__main__":
    main()
