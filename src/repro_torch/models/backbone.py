"""Family backbones: blocks and stage-stacked towers.

Port of ``repro/models/backbone.py`` for the dense (llama) family.  A
*tower* is a list of stages; each stage is ``(pattern, repeat)``, where
``pattern`` is a tuple of block types forming a super-block that repeats
``repeat`` times.  As in the reference, a stage's parameters stack the
repeats along a leading L axis on every leaf; the reference scans over L,
the port loops over it in Python.

Block types:
  dense : RMSNorm -> GQA attn -> RMSNorm -> gated MLP     (llama family)

The other families' block types of the reference (``moe``, ``hybrid``,
``mlstm``, ``slstm``, ``cross``, ``enc``) come with slice 7c of the port
(ROADMAP.md): :func:`tower_stages` refuses a config of another family.

Three execution modes share block code: full sequence, prefill (full
sequence that also emits the decode caches) and decode (one token against
the caches, which it updates in place).  In training (``Ctx.train``) with
``Ctx.remat`` each layer of the full-sequence forward runs under
``torch.utils.checkpoint``, as the reference wraps its stage-scan body in
``jax.checkpoint``: the backward recomputes the layer's activations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import layers as L


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts / lists; ``rest``
    are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


# --------------------------------------------------------------------------
# Tower stage layouts
# --------------------------------------------------------------------------
def tower_stages(cfg: ArchConfig, n_layers: int
                 ) -> Sequence[Tuple[Tuple[str, ...], int]]:
    """The text tower of ``n_layers`` dense blocks, one stage."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name} (the {cfg.family} family): its blocks come with "
            f"slice 7c of the port (ROADMAP.md); the port runs the dense "
            f"family")
    return [(("dense",), n_layers)] if n_layers > 0 else []


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
def block_init(gen, cfg: ArchConfig, btype: str, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"ln1": L.rmsnorm_init(d, gen.device, lead),
            "ln2": L.rmsnorm_init(d, gen.device, lead),
            "attn": L.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                     hd, qkv_bias=cfg.qkv_bias, lead=lead),
            "ffn": L.mlp_init(gen, d, cfg.d_ff, lead)}


@dataclass
class Ctx:
    """What a block needs besides its parameters and input (the
    reference's ``Ctx`` less the cross-attention memory, which comes with
    slice 7c)."""
    cfg: ArchConfig
    positions: Any = None          # (S,) int32 for full/prefill
    window: int = 0                # sliding window (0 = full)
    causal: bool = True
    pos: Any = None                # decode: int or (B,) int32
    train: bool = False
    # activation checkpointing of each layer (train only): the backward
    # recomputes the layer instead of keeping its activations
    remat: bool = True


def block_apply_full(params, x, btype: str, ctx: Ctx):
    """Full-sequence forward.  Returns (x, aux_loss)."""
    cfg = ctx.cfg
    eps = cfg.norm_eps
    h = L.rmsnorm(params["ln1"], x, eps)
    x = x + L.attention_apply(params["attn"], h, positions=ctx.positions,
                              theta=cfg.rope_theta, causal=ctx.causal,
                              window=ctx.window)
    h2 = L.rmsnorm(params["ln2"], x, eps)
    return x + L.mlp_apply(params["ffn"], h2), 0.0


# ---- caches ---------------------------------------------------------------
def block_make_cache(cfg: ArchConfig, btype: str, batch: int,
                     capacity: int, device, lead=()):
    return {"attn": L.make_kv_cache(batch, capacity, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, device,
                                    lead=lead)}


def block_decode(params, x, btype: str, ctx: Ctx, cache):
    """One-token step; updates ``cache`` in place.  Returns (x, aux,
    cache)."""
    cfg = ctx.cfg
    eps = cfg.norm_eps
    h = L.rmsnorm(params["ln1"], x, eps)
    a, _ = L.attention_decode(params["attn"], h, cache["attn"], ctx.pos,
                              theta=cfg.rope_theta, window=ctx.window)
    x = x + a
    h2 = L.rmsnorm(params["ln2"], x, eps)
    return x + L.mlp_apply(params["ffn"], h2), 0.0, cache


def block_prefill(params, x, btype: str, ctx: Ctx, capacity: int):
    """Full-sequence forward that also emits the decode cache: the last
    ``capacity`` positions' K / V, recomputed from the normed block input
    as in the reference."""
    cfg = ctx.cfg
    y, aux = block_apply_full(params, x, btype, ctx)
    B, Sq = x.shape[0], x.shape[1]
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    attn = params["attn"]
    k = L._proj(h, attn["wk"])
    v = L._proj(h, attn["wv"])
    if "bk" in attn:
        k = k + attn["bk"]
        v = v + attn["bv"]
    k = L.rope(k, ctx.positions, cfg.rope_theta)
    tail = min(capacity, Sq)
    tail_pos = ctx.positions[Sq - tail:].to(torch.int32)
    slots = torch.remainder(tail_pos, capacity).long()
    cache = L.make_kv_cache(B, capacity, k.shape[2], k.shape[3], x.device,
                            dtype=k.dtype)
    cache["k"][:, slots] = k[:, Sq - tail:]
    cache["v"][:, slots] = v[:, Sq - tail:]
    cache["slot_pos"][:, slots] = tail_pos
    return y, aux, {"attn": cache}


# --------------------------------------------------------------------------
# Towers
# --------------------------------------------------------------------------
def layer(stage, i: int):
    """Layer ``i`` of a stage-stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], stage)


def tower_init(gen, cfg: ArchConfig, stages):
    return [{f"b{i}": block_init(gen, cfg, bt, lead=(repeat,))
             for i, bt in enumerate(pattern)}
            for (pattern, repeat) in stages]


def tower_make_cache(cfg: ArchConfig, stages, batch: int, capacity: int,
                     device):
    return [{f"b{i}": block_make_cache(cfg, bt, batch, capacity, device,
                                       lead=(repeat,))
             for i, bt in enumerate(pattern)}
            for (pattern, repeat) in stages]


def _layer_apply(sp, li: int, x, pattern, ctx: Ctx):
    """Layer ``li`` of stage ``sp`` (every block of its pattern) ->
    (x, aux)."""
    p_layer = layer(sp, li)
    aux = 0.0
    for i, bt in enumerate(pattern):
        x, a = block_apply_full(p_layer[f"b{i}"], x, bt, ctx)
        aux = aux + a
    return x, aux


def tower_apply(params, x, cfg: ArchConfig, stages, ctx: Ctx):
    """Full-sequence forward.  Returns (x, aux)."""
    remat = ctx.train and ctx.remat and torch.is_grad_enabled()
    aux = 0.0
    for sp, (pattern, repeat) in zip(params, stages):
        for li in range(repeat):
            if remat:
                x, a = checkpoint(_layer_apply, sp, li, x, pattern, ctx,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = _layer_apply(sp, li, x, pattern, ctx)
            aux = aux + a
    return x, aux


def tower_prefill(params, x, cfg: ArchConfig, stages, ctx: Ctx,
                  capacity: int):
    """-> (x, aux, caches): each stage's caches stacked along L."""
    aux = 0.0
    caches = []
    for sp, (pattern, repeat) in zip(params, stages):
        per_layer = []
        for li in range(repeat):
            p_layer = layer(sp, li)
            cs = {}
            for i, bt in enumerate(pattern):
                x, a, cs[f"b{i}"] = block_prefill(p_layer[f"b{i}"], x, bt,
                                                  ctx, capacity)
                aux = aux + a
            per_layer.append(cs)
        caches.append(tree_map(lambda *ts: torch.stack(ts), *per_layer))
    return x, aux, caches


def tower_decode(params, x, cfg: ArchConfig, stages, ctx: Ctx, caches):
    """One token through the tower; every layer's cache is updated in
    place.  Returns (x, aux, caches)."""
    aux = 0.0
    for sp, sc, (pattern, repeat) in zip(params, caches, stages):
        for li in range(repeat):
            p_layer, c_layer = layer(sp, li), layer(sc, li)
            for i, bt in enumerate(pattern):
                x, a, _ = block_decode(p_layer[f"b{i}"], x, bt, ctx,
                                       c_layer[f"b{i}"])
                aux = aux + a
    return x, aux, caches
