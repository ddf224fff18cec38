"""The system under test: the CELU round of ``repro_torch`` as
``launch/train.py::train_llm`` drives it, built from a cell's files.

The architecture comes from the configuration file (``ArchConfig``), the
round's settings from the traffic file; the weights are the benchmark's
(``weights.py``), handed over in the program's tree layout; the round is
``make_schedule(...).step`` over ``engine.lift_two_party(llm_task(cfg))``
with AdaGrad on its kernel route (K7) and the workset ring's gate (K1).
"""
from __future__ import annotations

import os
import sys
from typing import Dict

import torch

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.bridge import path_key  # noqa: E402
from repro_torch.configs.base import (ArchConfig, CELUConfig,  # noqa: E402
                                      MoEConfig, VFLConfig)
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.uniforms import GeneratorUniforms  # noqa: E402
from repro_torch.launch.train import llm_task, make_schedule  # noqa: E402
from repro_torch.launch.wan import transport_round_updown  # noqa: E402
from repro_torch.models import vfl  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402


def arch_config(config: dict) -> ArchConfig:
    """The program's ``ArchConfig`` of a configuration file."""
    port = config["port"]
    moe = None
    if config.get("num_local_experts"):
        moe = MoEConfig(n_experts=config["num_local_experts"],
                        top_k=config["num_experts_per_tok"],
                        capacity_factor=port["capacity_factor"],
                        router_aux_coef=port["router_aux_coef"])
    return ArchConfig(
        name=port["arch"], family=port["family"],
        n_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        head_dim=config.get("head_dim", 0), moe=moe,
        aux_vocab_size=port["aux_vocab_size"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        vfl=VFLConfig(layers_a=port["layers_a"], layers_b=port["layers_b"],
                      layers_top=port["layers_top"], fusion="add"))


def celu_config(traffic: dict) -> CELUConfig:
    return CELUConfig(R=traffic["R"], W=traffic["W"],
                      xi_degrees=traffic["xi_degrees"],
                      sampling=traffic["sampling"],
                      cache_dtype=traffic["cache_dtype"],
                      cache_fused=traffic["cache_fused"])


class Program:
    """The training step with its model, optimizer state and rings: one
    object, built once, driven through its first rounds in set-up and
    then through the window."""

    def __init__(self, config: dict, traffic: dict, trees, first_batch,
                 seed: int, device):
        self.cfg = arch_config(config)
        self.celu = celu_config(traffic)
        self.params = {p: vfl.PartyParams(trees[p]) for p in ("a", "b")}
        task = llm_task(self.cfg, remat=traffic["remat"])
        base = make_optimizer("adagrad", traffic["lr"],
                              eps=traffic["adagrad_eps"], use_pallas=True,
                              uniforms=GeneratorUniforms(seed, device))
        # each party's first update is its fresh step: its accumulators
        # then hold that gradient's squares, read once (device tensors)
        self._first: Dict[str, list] = {}
        # while ``recording``: each update's (gradient norm over all its
        # leaves, scale), in the order the round makes them
        self.recording = True
        self._updates: list = []

        def step(grads, state, params, scale=None):
            if self.recording:
                norms = torch._foreach_norm(
                    [g for g in grads if g is not None], 2,
                    dtype=torch.float32)
                self._updates.append((torch.linalg.vector_norm(
                    torch.stack(norms)), 1.0 if scale is None else scale))
            out = base.step(grads, state, params, scale)
            if len(self._first) < 2:
                self._first["ab"[len(self._first)]] = [
                    torch.sqrt(a.sum(dtype=torch.float64))
                    for a in state["accum"]]
            return out
        self.opt = base._replace(step=step)
        etask = engine.lift_two_party(task)
        self.transport = transport = engine.make_transport(self.celu)
        ba, bb = first_batch
        self.state = engine.init_state(
            etask, engine.lift_two_party_params(self.params), self.opt,
            self.celu, [ba], bb, transport=transport,
            uniforms=GeneratorUniforms(seed, device))
        self.sched = make_schedule(etask, self.opt, self.celu, self.celu.R,
                                   transport)
        self.state = self.sched.start(self.state)

    def step(self, batch, batch_idx: int):
        """One round; -> its metrics (device tensors)."""
        ba, bb = batch
        self.state, m = self.sched.step(self.state, [ba], bb, batch_idx)
        return m

    def wire_bytes(self, B: int, S: int):
        """(up, down) bytes a round on the simulated WAN, exact."""
        return transport_round_updown(self.transport,
                                      [(B, S, self.cfg.d_model)])

    def _named(self, party: str):
        mod = self.params[party]
        return sorted(mod.named_parameters(), key=lambda kv: path_key(kv[0]))

    def update_norms(self) -> list:
        """[(gradient norm, 1.0 when the update was applied, else 0.0)]
        of every party update recorded, in the round's order (Party A's
        and B's exchange steps, then A's and B's local updates in turn);
        stops the recording."""
        self.recording = False
        return [(float(n), float(s)) for n, s in self._updates]

    def first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's norm of the gradient of its party's first update,
        as the optimizer took it (√(Σ accumulator) after that update; the
        accumulators' order is the engine's,
        ``bridge.reference_parameters``)."""
        return {f"{party}/{name}": float(n) for party in ("a", "b")
                for (name, _), n in zip(self._named(party),
                                        self._first[party])}

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {f"{p}/{n}": t for p in ("a", "b") for n, t in self._named(p)}
