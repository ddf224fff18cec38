"""The paper's technique across pods, on the PyTorch port (the twin of
``examples/pod_protocol_demo.py``): a 2-pod CELU round where Party A
lives on pod 0 and Party B on pod 1, one process a pod.  The cut-tensor
exchange is the engine's ``PodTransport`` (a pair of point-to-point
permutes between the pod ranks), and local updates hit each pod's own
workset ring (zero inter-pod traffic).  The round itself is the same
K-party engine logic as the host-simulated protocols
(``engine.make_pod_round``); only the transport differs.

Two pod ranks over gloo (``launch.dist.run_ranks``); on the card both
share it, each tensor staged through pinned host memory, and each update
is one K7 launch, each local gate K2a (pod 0) or K2b (pod 1).  Prints the
training losses and the inter-pod bytes per model update for R ∈ {0, 5},
from the transport's exact byte count.  It runs on the card unless
``--device cpu`` is given.

    python examples/torch/pod_protocol_demo.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import pod_protocol as pp  # noqa: E402
from repro_torch.launch.dist import run_ranks  # noqa: E402

# the reference script's demo: 8 fields a party, vocab 64, B = 128, W = 3,
# z 16, hidden 32 (embed 16), R = 3, cos ξ = 0.5, AdaGrad 0.05, 20 rounds
DEMO = dict(n_fields=8, vocab=64, batch=128, W=3, embed_dim=16, z_dim=16,
            hidden=32, R=3, xi_degrees=60.0, lr=0.05, rounds=20)
# the bytes at the paper's geometry: B = 4096, z = 256, W = 5
PAPER = dict(n_fields=16, vocab=512, batch=4096, W=5, embed_dim=16,
             z_dim=256, hidden=256, xi_degrees=60.0, lr=0.05, rounds=1)
BYTES_R = (0, 5)


def demo_batches(rounds: int = DEMO["rounds"]) -> list:
    """The reference script's rounds from numpy's ``default_rng(0)``: a
    fixed random teacher over both parties' 16 fields, each round's ids
    uniform in the vocabulary and Party B's labels Bernoulli(sigmoid) of
    the teacher's sum / 4 (pod 0's label slot stays zero).  -> [(x (2, B,
    F) int32, y (2, B) fp32)]."""
    B, F, V = DEMO["batch"], DEMO["n_fields"], DEMO["vocab"]
    rng = np.random.default_rng(0)
    teacher = rng.normal(size=(2 * F, V)).astype(np.float32)
    out = []
    for _ in range(rounds):
        x = rng.integers(0, V, size=(2, B, F), dtype=np.int32)
        logit = teacher[np.arange(2 * F)[None, :],
                        x.transpose(1, 0, 2).reshape(B, 2 * F)].sum(1) / 4.0
        y = np.stack([np.zeros(B, np.float32),
                      (rng.random(B) < 1 / (1 + np.exp(-logit))).astype(
                          np.float32)])
        out.append((x, y))
    return out


def run(device=None, params=None, say=print) -> dict:
    """Train the demo's rounds on two pod ranks, then one round at the
    paper's geometry for each R of :data:`BYTES_R`.  ``params`` (a
    party-stacked tree, e.g. the reference's) replaces the drawn
    parameters.  -> {"losses": Party B's loss a round, "bytes": {R:
    (inter-pod bytes a round, model updates a round)}, "pods": each
    pod's results (``pod_worker``'s)}."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _cuda
        _cuda.build()                  # the ranks never build the kernels
    common = {"device": str(dev), "staged": dev.type == "cuda"}
    runs = [dict(DEMO, batches=demo_batches(), params=params, **common)]
    runs += [dict(PAPER, R=max(R, 1), **common) for R in BYTES_R]
    pods = run_ranks(pp.pod_worker, 2, backend="gloo", args=(runs,))
    losses = pods[1][0]["losses"]
    say(f"2-pod CELU round (R={DEMO['R']}, W={DEMO['W']}):")
    for i, loss in enumerate(losses):
        if (i + 1) % 5 == 0:
            say(f"  round {i+1:2d}  Party-B loss {loss:.4f}")
    say(f"inter-pod ppermute bytes per model update (B={PAPER['batch']}, "
        f"z={PAPER['z_dim']}):")
    nbytes = {}
    for R, res in zip(BYTES_R, pods[0][1:]):
        # what one pod sends over the link in the round: Z_A up and ∇Z_A
        # down (each permute sends one message from every pod)
        cp = res["counters"]["sent_bytes"] // PAPER["rounds"]
        ups = 1 + R
        nbytes[R] = (cp, ups)
        say(f"  R={R}: {cp/1e6:.2f} MB/round, {ups} updates "
            f"-> {cp/ups/1e6:.2f} MB/update")
    return {"losses": losses, "bytes": nbytes, "pods": pods}


def main(argv=None) -> dict:
    """-> :func:`run`'s result, with the printed ``lines``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)
    out = run(args.device, say=say)
    out["lines"] = lines
    return out


if __name__ == "__main__":
    main()
