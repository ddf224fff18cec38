"""One run of one cell: set-up, the checked rounds, the timed window, the
traced rounds, the check against the reference, the metrics.

The order matters.  Set-up makes the batches and the weights on
the device from the seed and builds the program's training step once; its
first ``checked_rounds`` rounds, through the window's own call and on
batches that all differ, warm up every shape the cell uses (a round's work
does not depend on how full the ring is) and are the rounds the reference
follows.  The window then times whole rounds, each ending in a
synchronize, until one ends at or past ``seconds``.  A traced run then
profiles ``profiled_rounds`` more.  The peak memory is read, the program's
state freed, and the reference runs over the checked rounds.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from . import check, specs
from . import trace as T
from . import traffic as Tr
from . import weights as Wt
from .reference import reading as reference_reading


@dataclass
class Run:
    """What the metric readers read (``bench/metrics/<name>.py``)."""
    config: dict
    geometry: dict
    traffic: dict
    setup_s: float
    round_s: List[float] = field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: int = 0
    profile: Optional[T.Profile] = None

    @property
    def round_mean_s(self) -> float:
        return self.window_s / len(self.round_s)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().replace("\n", "; ")


def checked_rounds(prog, step, n: int, config: dict, seed: int,
                   sync) -> dict:
    """Drive the program's first ``n`` rounds -> its reading
    (``bench/check.py``): each round's loss and mean gate weight, each
    party update's gradient norm, each leaf's norm of the first gradient
    the optimizer took, each leaf's change after the last round."""
    got = {"loss": [], "w_zero": [], "w_mean": []}
    for i in range(n):
        m = step(i)
        sync()
        got["loss"].append(float(m["loss"]))
        got["w_zero"].append(float(m["w_zero_frac"]))
        got["w_mean"].append(float(m["w_mean"]))
    got["updates"] = prog.update_norms()
    got["grad"] = prog.first_grad_norms()
    leaves = prog.leaves()
    got["change"] = {f"{p}/{s[0]}": Wt.change_norm(seed, p, s,
                                                   leaves[f"{p}/{s[0]}"])
                     for p, s in Wt.iter_leaves(config)}
    sync()
    return got


def build(cell: dict, seed: int, dev):
    """-> (the batches, the program) of one run, made from the seed."""
    from . import program   # the system under test, imported in set-up
    config, traffic = cell["config"], cell["traffic"]
    batches = Tr.make_batches(traffic, config["vocab_size"],
                              config["port"]["aux_vocab_size"], seed, dev)
    prog = program.Program(config, traffic,
                           Wt.make_party_trees(config, seed, dev),
                           batches[0], seed, dev)
    return batches, prog


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """-> the result's fields: correct, attempted, failed, metrics,
    device, breakdown (traced) and checks."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    config, traffic = cell["config"], cell["traffic"]
    g = Wt.geometry(config)
    batches, prog = build(cell, seed, dev)
    sync()
    _say(f"[setup] batches, weights and the program's state: "
         f"{time.perf_counter() - t_start:.3f} s after start")
    up, down = prog.wire_bytes(traffic["batch"], traffic["seq_len"])
    _say(f"[wire] {up} B up, {down} B down a round (exact)")

    def step(i: int) -> dict:
        return prog.step(Tr.batch(batches, i), i)

    n_check = traffic["checked_rounds"]
    got = checked_rounds(prog, step, n_check, config, seed, sync)
    run = Run(config=config, geometry=g, traffic=traffic,
              setup_s=time.perf_counter() - t_start)
    _say(f"[setup] {n_check} checked rounds done: {run.setup_s:.3f} s "
         f"after start")

    i = n_check
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        step(i)
        sync()
        te = time.perf_counter()
        run.round_s.append(te - ts)
        i += 1
        if te - t0 >= seconds:
            break
    run.window_s = te - t0
    _say(f"[window] {len(run.round_s)} rounds in {run.window_s:.3f} s: "
         f"{[round(1e3 * r, 1) for r in run.round_s]} ms")

    if trace:
        first = i
        t_p = time.perf_counter()
        run.profile = T.profile_rounds(lambda j: step(first + j),
                                       traffic["profiled_rounds"], sync)
        _say(f"[trace] {run.profile.rounds} rounds profiled in "
             f"{run.profile.wall_s:.3f} s, read in "
             f"{time.perf_counter() - t_p - run.profile.wall_s:.3f} s: "
             f"{len(run.profile.device)} device and "
             f"{len(run.profile.host)} host events")
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else 0
    del prog, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = reference_reading(config, traffic, seed, batches[:n_check], dev)
    _say(f"[check] reference over {n_check} rounds: "
         f"{time.perf_counter() - t_ref:.3f} s")
    verdict = check.judge(check.gaps(got, want), cell["limits"])

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in specs.metrics_for(cell["bench"], cell["name"], kind):
        value = specs.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": torch.cuda.get_device_name(dev) if on_card
                else dev.type,
                "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": verdict["correct"], "attempted": len(run.round_s),
           "failed": 0, "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = run.profile.busy_s()
        dev_info["window_s"] = run.profile.wall_s
        out["breakdown"] = {"device_ops": T.top_device_ops(run.profile),
                            "idle_gaps": T.idle_gaps(run.profile)}
    out["checks"] = verdict["checks"]
    return out
