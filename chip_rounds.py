#!/usr/bin/env python3
"""Kernels, device-busy ms and host ms per WDL-Criteo celu round, for one
or more checkouts of the repository in turns, on one NVIDIA GPU.

    python3 chip_rounds.py [TREE ...]     # default: this checkout

Each TREE (a directory holding ``src/repro_torch``, e.g. a commit
unpacked with ``git archive``) runs in a process of its own, in the order
given: to compare two commits give them as parent, change, change,
parent.  A run trains WDL-Criteo at full width (B = 256, R = W = 5, celu,
the training CLI's AdaGrad kernel route) with the fp32, bf16 and int8
optimizer states: ``ROUNDS`` rounds on the host clock (ms per steady
round), then ``ROUNDS`` rounds under ``torch.profiler`` (kernels per
round and the card's busy ms per round, evaluation included; the
AdaGrad kernels' launches and ms per round).  Prints one JSON line per
tree and state, then a table; the card's name and power limit first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 20
STATES = ("float32", "bfloat16", "int8")
RUN = r"""
import json, sys, torch
sys.path.insert(0, "src")
from torch.profiler import ProfilerActivity, profile
from repro_torch.launch.train import build_parser, train_dlrm
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def args(state):
    return build_parser().parse_args(
        ["--arch", "wdl-criteo", "--protocol", "celu", "--rounds",
         str({rounds}), "--opt-state-dtype", state])


for state in {states}:
    host = train_dlrm(args(state))["steady_round_ms"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_dlrm(args(state))
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    ag = [e for e in ks if "adagrad" in e.name]
    print("ROW " + json.dumps({{
        "state": state, "host_ms": host,
        "kernels": len(ks) / {rounds},
        "busy_ms": sum(e.device_time_total for e in ks) / 1e3 / {rounds},
        "adagrad_kernels": len(ag) / {rounds},
        "adagrad_ms": sum(e.device_time_total for e in ag) / 1e3 / {rounds},
        "device": torch.cuda.get_device_name(0)}}), flush=True)
"""


def main() -> None:
    trees = [os.path.abspath(t) for t in sys.argv[1:]] or [ROOT]
    for t in trees:
        if not os.path.isdir(os.path.join(t, "src", "repro_torch")):
            sys.exit(f"chip_rounds: {t} holds no src/repro_torch")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    code = RUN.format(rounds=ROUNDS, states=STATES)
    rows = []
    for t in trees:
        r = subprocess.run([sys.executable, "-c", code], cwd=t,
                           capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            sys.exit(f"chip_rounds: FAILED in {t}:\n{r.stderr[-3000:]}")
        for line in r.stdout.splitlines():
            if line.startswith("ROW "):
                row = {"tree": os.path.relpath(t, ROOT), **json.loads(
                    line[4:])}
                rows.append(row)
                print(json.dumps(row), flush=True)
    for row in rows:
        print(f"[rounds] {row['tree']:>18s} {row['state']:8s}: "
              f"{row['kernels']:.0f} kernels, busy {row['busy_ms']:.3f} ms "
              f"a round (AdaGrad {row['adagrad_kernels']:.0f} launches, "
              f"{row['adagrad_ms']:.3f} ms); host {row['host_ms']:.3f} ms "
              f"a round; {card}", flush=True)


if __name__ == "__main__":
    main()
