"""Step functions of the LLM split models (the run half of
``repro/launch/steps.py``).

``make_train_step``   — the vanilla VFL step: both parties' forward and
                        backward (``models.vfl.joint_loss``) and one
                        optimizer update, with gradient accumulation
                        over ``microbatches`` batch slices;
``make_prefill_step`` — the full-context forward emitting decode caches;
``make_serve_step``   — one new token against the caches;
``make_step``         — the step a shape kind runs;
``make_sharded_train_step`` — the train step over a device mesh, its
                        parameters placed by ``sharding.rules`` through
                        :func:`shard_params` and its batch by
                        :func:`shard_batch`;
``on_mesh``           — any step run over a mesh (the layers' sharding
                        hints installed), as the dry-run runs prefill
                        and decode.

``batch_specs`` gives a shape's batch as {key: (shape, dtype)} in the
reference's key order, and ``concrete_batch`` draws it from a numpy
generator in that order, so one seed gives the reference's batch.  The
dry-run half (``launch/dryrun.py``'s inputs): ``input_specs`` and
``decode_specs`` give a shape's inputs as tensors without data (on the
meta device, or fake under a ``FakeTensorMode``), the decode caches from
``vfl.make_serve_cache``, and ``abstract_params`` the parameters on the
meta device.  Token ids are int64 where the reference's are int32
(PyTorch's embedding lookup takes int64).

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
    """A family's training / prefill batch: {key: (shape, dtype)}, keys
    in the reference's order.  The frontends are stubs: a vlm batch
    carries patch embeddings (B, n_patches, d_frontend), an audio batch
    frame embeddings (B, S // audio_downsample, d_frontend), both fp32;
    a text batch Party A's token stream."""
    B, S = shape.global_batch, shape.seq_len
    spec: Dict[str, Any] = {"tokens": ((B, S), torch.int64)}
    if shape.kind == "train":
        spec["labels"] = ((B, S), torch.int64)
    if cfg.family == "vlm":
        spec["patches"] = ((B, cfg.n_patches, cfg.d_frontend),
                           torch.float32)
    elif cfg.family == "audio":
        spec["frames"] = ((B, S // cfg.audio_downsample, cfg.d_frontend),
                          torch.float32)
    else:
        spec["tokens_a"] = ((B, S), torch.int64)
    return spec


def concrete_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """A batch of ``batch_specs`` drawn from ``np.random.default_rng(seed)``
    key by key, as the reference draws it: token ids below the vocabulary
    (the auxiliary one for ``tokens_a``), embeddings standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dtype) in batch_specs(cfg, shape).items():
        if dtype == torch.float32:
            x = rng.normal(size=shp).astype(np.float32)
        else:
            hi = cfg.vocab_size if k != "tokens_a" else cfg.aux_vocab_size
            x = rng.integers(0, hi, size=shp, dtype=np.int32).astype(
                np.int64)
        out[k] = torch.from_numpy(x).to(device)
    return out


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def decode_specs(cfg: ArchConfig, shape: ShapeConfig, device="meta"):
    """-> (step_batch, caches, pos) for the serve step, without data: one
    new token a row (and Party A's, for a text family), the empty caches
    of ``vfl.make_serve_cache`` at the reference's memory length (the
    vlm's patches, the audio family's frames), and a 0-d int32
    position."""
    B, S = shape.global_batch, shape.seq_len
    step: Dict[str, Any] = {"token": _empty((B, 1), torch.int64, device)}
    if cfg.family not in ("vlm", "audio"):
        step["token_a"] = _empty((B, 1), torch.int64, device)
    mem_len = 0
    if cfg.family == "vlm":
        mem_len = cfg.n_patches
    elif cfg.family == "audio":
        mem_len = S // cfg.audio_downsample
    caches = vfl.make_serve_cache(cfg, B, S, mem_len, device=device)
    return step, caches, _empty((), torch.int32, device)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, Any]:
    """All inputs of the shape's step without data, keyed as the
    reference keys them: {"batch"} for train and prefill, {"caches",
    "step_batch", "pos"} for decode."""
    if shape.kind == "decode":
        step, caches, pos = decode_specs(cfg, shape, device)
        return {"caches": caches, "step_batch": step, "pos": pos}
    return {"batch": {k: _empty(shp, dtype, device) for k, (shp, dtype)
                      in batch_specs(cfg, shape).items()}}


def abstract_params(cfg: ArchConfig) -> vfl.PartyParams:
    """Both parties' parameters as a ``vfl.PartyParams`` on the meta
    device: every leaf's shape and dtype, no value drawn."""
    from .budget import _param_shapes
    return vfl.PartyParams(_param_shapes(cfg))


def _slice(v, i: int, n: int):
    """Slice i of n along v's batch dim.  A DTensor split on that dim
    gives each device slice i of its own rows (the slices' union over
    the devices is again the whole batch), so no row moves."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(v, DTensor) and Shard(0) in v.placements:
        loc = v.to_local()
        if loc.shape[0] % n:
            raise ValueError(f"a device's {loc.shape[0]} rows do not split "
                             f"into {n} microbatches")
        m = loc.shape[0] // n
        return DTensor.from_local(loc[i * m:(i + 1) * m], v.device_mesh,
                                  v.placements, run_check=False)
    m = v.shape[0] // n
    return v[i * m:(i + 1) * m]


def _slices(batch, microbatches: int):
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         f"microbatches")
    return [{k: _slice(v, i, microbatches) for k, v in batch.items()}
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
        # a leaf the loss does not reach (Party A's, where no cross layer
        # reads Z_A) gets a zero gradient, as jax.grad gives it
        with torch.enable_grad():
            loss = vfl.joint_loss(params, cfg, batch, train=True)
            return loss, torch.autograd.grad(loss, leaves,
                                             allow_unused=True,
                                             materialize_grads=True)

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


# --------------------------------------------------------------------------
# The train step over a device mesh (DTensor)
# --------------------------------------------------------------------------
def shard_params(params, mesh, specs=None):
    """Replace each parameter of ``params`` (a ``vfl.PartyParams``) by a
    DTensor over ``mesh`` placed by ``specs`` ({name: spec}; by default
    ``rules.params_pspecs`` with the big leaves also over ``data``,
    ``fsdp_axis="data"``), in place.  Every rank passes the same full
    parameters and keeps its own shards of them.  -> ``params``."""
    from torch.distributed.tensor import distribute_tensor

    from ..sharding.rules import placements, params_pspecs
    if specs is None:
        specs = params_pspecs(dict(params.named_parameters()), mesh,
                              fsdp_axis="data")
    for name, p in list(params.named_parameters()):
        *path, leaf = name.split(".")
        sub = params
        for c in path:
            sub = getattr(sub, c)
        sub._parameters[leaf] = torch.nn.Parameter(distribute_tensor(
            p.detach(), mesh, placements(mesh, specs[name]),
            src_data_rank=None))
    return params


def shard_batch(batch, mesh, batch_axes=None):
    """Each batch leaf as a DTensor placed by ``rules.batch_pspec`` over
    ``batch_axes`` (the mesh's data axes by default)."""
    from torch.distributed.tensor import distribute_tensor

    from ..sharding.rules import batch_pspec, placements
    from .mesh import data_axes
    axes = data_axes(mesh) if batch_axes is None else tuple(batch_axes)
    return {k: distribute_tensor(v, mesh, placements(
        mesh, batch_pspec(v.shape, mesh, data_axes=axes)),
        src_data_rank=None) for k, v in batch.items()}


def on_mesh(step, mesh, batch_axes=None, vocab_axis="model"):
    """``step`` run over ``mesh`` on DTensor arguments: during a call the
    layers' activation hints pin the batch dim over ``batch_axes`` (the
    mesh's data axes by default) and the logits' vocab dim over
    ``vocab_axis`` (``layers.set_batch_axes``), and the plain tensors the
    model makes (positions, masks) take part as replicated DTensors
    (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models import layers as L
    from .mesh import data_axes
    axes = data_axes(mesh) if batch_axes is None else tuple(batch_axes)

    def sharded_step(*args):
        L.set_batch_axes(axes, vocab_axis=vocab_axis, mesh=mesh)
        try:
            with implicit_replication():
                return step(*args)
        finally:
            L.set_batch_axes(None)

    return sharded_step


def make_sharded_train_step(cfg: ArchConfig, opt: Optimizer, mesh, *,
                            microbatches: int = 1, batch_axes=None,
                            vocab_axis="model"):
    """:func:`make_train_step` over ``mesh`` (axes ``data`` and
    ``model``, ``pod`` optional) through :func:`on_mesh`: the parameters
    and the batch are DTensors (:func:`shard_params`,
    :func:`shard_batch`)."""
    return on_mesh(make_train_step(cfg, opt, microbatches=microbatches),
                   mesh, batch_axes, vocab_axis)
