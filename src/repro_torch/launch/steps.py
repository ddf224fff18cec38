"""Step functions of the LLM split models (the run half of
``repro/launch/steps.py``).

``make_train_step``   — the vanilla VFL step: both parties' forward and
                        backward (``models.vfl.joint_loss``) and one
                        optimizer update, with gradient accumulation
                        over ``microbatches`` batch slices;
``make_prefill_step`` — the full-context forward emitting decode caches;
``make_serve_step``   — one new token against the caches;
``make_step``         — the step a shape kind runs.

``batch_specs`` gives a shape's batch as {key: (shape, dtype)} in the
reference's key order, and ``concrete_batch`` draws it from a numpy
generator in that order, so one seed gives the reference's batch.  The
dry-run half of the reference module (``input_specs``, ``decode_specs``,
``abstract_params``, ``unroll_microbatches``) comes with slice 10
(ROADMAP.md).

The parameters of a train step are one module over the whole split
model, ``vfl.PartyParams({"a": tree_a, "b": tree_b})``: its parameters
in the reference's leaf order are the optimizer's list, and the update
is applied in place.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..bridge import reference_parameters
from ..configs.base import ArchConfig, ShapeConfig
from ..models import vfl
from ..optim import Optimizer, apply_updates


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The text family's training / prefill batch: {key: (shape,
    dtype)}, keys in the reference's order."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name} (the {cfg.family} family): its batches come with "
            f"slice 7c of the port (ROADMAP.md)")
    B, S = shape.global_batch, shape.seq_len
    spec: Dict[str, Any] = {"tokens": ((B, S), torch.int64)}
    if shape.kind == "train":
        spec["labels"] = ((B, S), torch.int64)
    spec["tokens_a"] = ((B, S), torch.int64)
    return spec


def concrete_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """A batch of ``batch_specs`` drawn from ``np.random.default_rng(seed)``
    key by key, as the reference draws it: token ids below the vocabulary
    (the auxiliary one for ``tokens_a``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, _) in batch_specs(cfg, shape).items():
        hi = cfg.vocab_size if k != "tokens_a" else cfg.aux_vocab_size
        ids = rng.integers(0, hi, size=shp, dtype=np.int32)
        out[k] = torch.from_numpy(ids.astype(np.int64)).to(device)
    return out


def _slices(batch, microbatches: int):
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    mb = B // microbatches
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(microbatches)]


def make_train_step(cfg: ArchConfig, opt: Optimizer, *,
                    microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, loss): params a
    ``vfl.PartyParams`` over {"a", "b"}, updated in place; opt_state is
    ``opt.init(reference_parameters(params))``.

    ``microbatches`` > 1 accumulates the gradients of the batch's slices
    in fp32, one slice's graph at a time (the activations held scale with
    the slice), and divides loss and gradients by their number."""

    def grads_of(params, leaves, batch):
        with torch.enable_grad():
            loss = vfl.joint_loss(params, cfg, batch, train=True)
            return loss, torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch):
        leaves = reference_parameters(params)
        if microbatches == 1:
            loss, grads = grads_of(params, leaves, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            for mbatch in _slices(batch, microbatches):
                li, gi = grads_of(params, leaves, mbatch)
                loss = loss + li.detach()
                for a, g in zip(grads, gi):
                    a.add_(g.float())
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        if opt.step is not None:
            opt_state = opt.step(list(grads), opt_state, leaves)
        else:
            upd, opt_state = opt.update(list(grads), opt_state, leaves)
            apply_updates(leaves, upd)
        return params, opt_state, loss.detach()

    return train_step


def make_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        return vfl.prefill(vfl.as_tree(params), cfg, batch)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    @torch.no_grad()
    def serve_step(params, caches, step_batch, pos):
        return vfl.decode_step(vfl.as_tree(params), cfg, caches, step_batch,
                               pos)
    return serve_step


def make_step(cfg: ArchConfig, shape: ShapeConfig, opt: Optimizer = None, *,
              microbatches: int = 1):
    """The step function a shape kind runs (train, prefill or decode)."""
    if shape.kind == "train":
        if opt is None:
            raise ValueError("a train step needs an optimizer")
        return make_train_step(cfg, opt, microbatches=microbatches)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg)
