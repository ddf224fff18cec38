"""Multi-party CELU-VFL on the PyTorch port (the twin of
``examples/multiparty_vfl.py``): three parties (A1, A2 feature-only + B
with labels), each A with its own workset table and Algorithm-2
weighting; B weights instances by the MINIMUM per-party derivative
cosine.

The paper defers K>1 feature parties to future work (§6); this example
runs the extension end-to-end on a 3-way vertical split, building the
task by hand on the K-party engine (K=2 feature parties over a
SimWANTransport) from ``repro_torch.models.tabular``'s pieces.  On the
card each local update's gate is K1 (Party B's weights-only, once per
feature party) and each party update K7.  It runs on the card unless
``--device cpu`` is given.

    python examples/torch/multiparty_vfl.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.base import CELUConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.uniforms import GeneratorUniforms  # noqa: E402
from repro_torch.data import to_device  # noqa: E402
from repro_torch.data.synthetic import (TabularSpec, aligned_batches,  # noqa: E402,E501
                                        make_tabular)
from repro_torch.models.tabular import (MLP, DLRMConfig, Tower, auc,  # noqa: E402,E501
                                        logistic_loss)
from repro_torch.optim import make_optimizer  # noqa: E402

SPEC = TabularSpec("3party", fields_a=8, fields_b=4, vocab=128,
                   n_train=16384, n_test=4096)
CFG = DLRMConfig("wdl", 4, 4, vocab=128, embed_dim=8, z_dim=16,
                 hidden=(32, 16))
BATCH = 256
ROUNDS = 120
EVAL_EVERY = 30
K = 2                         # feature parties


class FeatureParty(nn.Module):
    """A_i: its fields' tower."""

    def __init__(self, cfg: DLRMConfig, gen: torch.Generator):
        super().__init__()
        self.tower = Tower(cfg, cfg.fields_a, cfg.z_dim, gen)


class LabelParty(nn.Module):
    """B: its fields' tower, the top MLP over [Z_1 ‖ Z_2 ‖ Z_B], the wide
    term and the bias (the reference's leaf names, so ``bridge`` maps a
    reference pytree onto it)."""

    def __init__(self, cfg: DLRMConfig, gen: torch.Generator):
        super().__init__()
        self.tower = Tower(cfg, cfg.fields_b, cfg.z_dim, gen)
        self.top = MLP([(K + 1) * cfg.z_dim, 32, 1], gen)
        self.wide = nn.Parameter(torch.randn(
            (cfg.fields_b, cfg.vocab), generator=gen) * 0.01)
        self.bias = nn.Parameter(torch.zeros(()))


def init_params(device) -> dict:
    """{"a": [A1, A2], "b": B}, each drawn from its own seed as the
    reference draws each from its own key."""
    def gen(s):
        return torch.Generator().manual_seed(s)
    return {"a": [FeatureParty(CFG, gen(i)).to(device) for i in range(K)],
            "b": LabelParty(CFG, gen(K)).to(device)}


def forward_a(pa, batch_a):
    return pa.tower(batch_a["x_a"])


def top_logit(pb, z_list, x_b):
    """The top MLP over the feature parties' cut tensors and B's own."""
    z_b = pb.tower(x_b)
    h = torch.cat([z.float() for z in z_list] + [z_b], dim=-1)
    return pb.top(h)[:, 0]


def loss_b(pb, z_list, batch_b):
    x_b = batch_b["x_b"]
    fields = torch.arange(x_b.shape[1], device=x_b.device)
    wide = pb.wide[fields[None, :], x_b].sum(1)
    logit = top_logit(pb, z_list, x_b) + wide + pb.bias
    li = logistic_loss(logit, batch_b["y"])
    return li, li.new_zeros(())


def split(ba, bb, dev):
    """One aligned batch -> ([A1's, A2's], B's) on ``dev``."""
    return ([to_device({"x_a": ba["x_a"][:, :4]}, dev),
             to_device({"x_a": ba["x_a"][:, 4:]}, dev)],
            to_device(bb, dev))


def run(device=None, rounds=ROUNDS, eval_every=EVAL_EVERY, params=None,
        uniforms=None, say=print) -> dict:
    """Train the three-party task ``rounds`` rounds; Party B evaluates the
    AUC every ``eval_every``.  ``params`` replaces the drawn parameters
    and ``uniforms`` the default uniform source.  -> {"history": [(round,
    loss, AUC)], "comm_rounds", "steps_a", "steps_b", "local_steps",
    "round_bytes"}."""
    dev = resolve_device(device)
    data = make_tabular(SPEC, seed=0)
    task = engine.KPartyTask(forward_a, loss_b)
    if params is None:
        params = init_params(dev)
    celu = CELUConfig(R=3, W=3, xi_degrees=60.0)
    opt = make_optimizer("adagrad", 0.01, use_pallas=True)
    transport = engine.SimWANTransport(celu)
    if uniforms is None:
        uniforms = GeneratorUniforms(0, dev)
    it = aligned_batches(data["train"], BATCH, seed=0)
    _, ba, bb = next(it)
    bas, b = split(ba, bb, dev)
    state = engine.init_state(task, params, opt, celu, bas, b,
                              transport=transport, uniforms=uniforms)
    rnd = engine.make_round(task, opt, celu, transport=transport)

    te = data["test"]
    tes, teb = split({"x_a": te["x_a"]}, {"x_b": te["x_b"]}, dev)
    it = aligned_batches(data["train"], BATCH, seed=0)
    say("3-party CELU-VFL (A1: 4 fields, A2: 4 fields, B: 4 + labels)")
    history, local_steps = [], []
    for i in range(rounds):
        bi, ba, bb = next(it)
        bas, b = split(ba, bb, dev)
        state, m = rnd(state, bas, b, bi)
        local_steps.append(m["local_steps"])
        if (i + 1) % eval_every == 0:
            # Party B evaluates with fresh cut tensors (inference exchange)
            with torch.no_grad():
                zs = [forward_a(p, t) for p, t in zip(params["a"], tes)]
                logit = top_logit(params["b"], zs, teb["x_b"])
            a = auc(logit.cpu().numpy(), te["y"])
            history.append((i + 1, float(m["loss"]), a))
            say(f"  round {i+1:4d}  loss {history[-1][1]:.4f}  AUC {a:.4f}")
    zb = transport.round_bytes([(BATCH, CFG.z_dim)] * K)
    comm = int(state["comm_rounds"])
    say(f"communication rounds: {comm} (each funds {1 + celu.R} "
        f"updates/party; {zb / 1e3:.0f} KB/round over K={K} "
        f"uplink+downlink pairs)")
    return {"history": history, "comm_rounds": comm,
            "steps_a": [int(s) for s in state["steps"]["a"]],
            "steps_b": int(state["steps"]["b"]),
            "local_steps": [int(x) for x in local_steps],
            "round_bytes": zb}


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
