"""Family backbones: blocks and stage-stacked towers.

Port of ``repro/models/backbone.py``.  A *tower* is
a list of stages; each stage is ``(pattern, repeat)``, where ``pattern``
is a tuple of block types forming a super-block that repeats ``repeat``
times.  As in the reference, a stage's parameters stack the repeats along
a leading L axis on every leaf; the reference scans over L, the port
loops over it in Python.

Block types:
  dense   : RMSNorm -> GQA attn -> RMSNorm -> gated MLP     (llama family)
  moe     : RMSNorm -> GQA attn -> RMSNorm -> MoE FFN
  hybrid  : RMSNorm -> (attn ∥ mamba)/2 -> RMSNorm -> MLP   (hymba)
  mlstm   : RMSNorm -> mLSTM cell                            (xlstm)
  slstm   : RMSNorm -> sLSTM cell                            (xlstm)
  cross   : RMSNorm -> self attn -> RMSNorm -> cross attn -> RMSNorm -> MLP
  enc     : RMSNorm -> bidirectional attn -> RMSNorm -> MLP  (audio encoder)

A ``cross`` block attends to ``Ctx.memory`` (the other party's Z) with no
rotary embedding; in decode it reads the memory's K / V, projected once
at prefill into its cache's ``xmem``.

Three execution modes share block code: full sequence, prefill (full
sequence that also emits the decode caches: KV rings, the SSM's state and
conv tail, the xLSTM cells' states) and decode (one token against the
caches, which it updates in place).  In training (``Ctx.train``) with
``Ctx.remat`` each layer of the full-sequence forward runs under
``torch.utils.checkpoint``, as the reference wraps its stage-scan body in
``jax.checkpoint``: the backward recomputes the layer's activations.  A
block's full-sequence forward returns its auxiliary loss (the MoE's
load-balance term, 0.0 for the others), summed over the tower.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import layers as L
from . import moe as M
from . import ssm as S
from . import xlstm as X


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
def tower_stages(cfg: ArchConfig, n_layers: int, role: str = "text"
                 ) -> Sequence[Tuple[Tuple[str, ...], int]]:
    """The stages of a tower of ``n_layers`` layers.  ``role``: ``enc``
    (the audio encoder, ``enc`` blocks), ``audio_dec`` (a ``cross``
    block in every layer), ``vlm`` (a ``("dense",) * (k - 1) +
    ("cross",)`` super-block per ``cross_attn_every`` = k layers and a
    ``("dense",)`` remainder) or ``text``: one stage of the family's
    block, or for xlstm an ``("slstm",) + ("mlstm",) * (k - 1)``
    super-block per ``slstm_every`` = k layers and an ``("mlstm",)``
    remainder."""
    if n_layers <= 0:
        return []
    if role == "enc":
        return [(("enc",), n_layers)]
    if role == "audio_dec":
        return [(("cross",), n_layers)]
    if role == "vlm":
        k = cfg.cross_attn_every
        n_super, rem = divmod(n_layers, k)
        stages = [(("dense",) * (k - 1) + ("cross",), n_super)] \
            if n_super else []
        return stages + ([(("dense",), rem)] if rem else [])
    if cfg.family == "ssm":  # xlstm
        k = cfg.xlstm.slstm_every if cfg.xlstm else 4
        stages = []
        n_super, rem = divmod(n_layers, k)
        if n_super:
            stages.append((("slstm",) + ("mlstm",) * (k - 1), n_super))
        if rem:
            stages.append((("mlstm",), rem))
        return stages
    return [(({"moe": "moe", "hybrid": "hybrid"}.get(cfg.family, "dense"),),
             n_layers)]


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------
def block_init(gen, cfg: ArchConfig, btype: str, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dev = gen.device

    def ln():
        return L.rmsnorm_init(d, dev, lead)
    if btype in ("dense", "moe", "enc"):
        p = {"ln1": ln(), "ln2": ln(),
             "attn": L.attention_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                      hd, qkv_bias=cfg.qkv_bias, lead=lead)}
        p["ffn"] = M.moe_init(gen, d, cfg.d_ff, cfg.moe, lead) \
            if btype == "moe" else L.mlp_init(gen, d, cfg.d_ff, lead)
        return p
    if btype == "hybrid":
        return {"ln1": ln(), "lnm": ln(), "ln2": ln(),
                "attn": L.attention_init(gen, d, cfg.n_heads,
                                         cfg.n_kv_heads, hd, lead=lead),
                "mamba": S.mamba_init(gen, d, cfg.ssm, lead),
                "ffn": L.mlp_init(gen, d, cfg.d_ff, lead)}
    if btype == "cross":
        return {"ln1": ln(), "lnx": ln(), "ln2": ln(),
                "attn": L.attention_init(gen, d, cfg.n_heads,
                                         cfg.n_kv_heads, hd, lead=lead),
                "xattn": L.attention_init(gen, d, cfg.n_heads,
                                          cfg.n_kv_heads, hd, lead=lead),
                "ffn": L.mlp_init(gen, d, cfg.d_ff, lead)}
    if btype == "mlstm":
        return {"ln1": ln(), "cell": X.mlstm_init(gen, d, cfg.n_heads, lead)}
    if btype == "slstm":
        return {"ln1": ln(), "cell": X.slstm_init(gen, d, cfg.n_heads, lead)}
    raise ValueError(btype)


@dataclass
class Ctx:
    """What a block needs besides its parameters and input."""
    cfg: ArchConfig
    positions: Any = None          # (S,) int32 for full/prefill
    memory: Any = None             # (B, S_mem, d) for cross blocks
    memory_positions: Any = None
    window: int = 0                # sliding window (0 = full)
    causal: bool = True
    pos: Any = None                # decode: int or (B,) int32
    train: bool = False
    # activation checkpointing of each layer (train only): the backward
    # recomputes the layer instead of keeping its activations
    remat: bool = True


def _ffn(params, x, cfg, btype):
    if btype == "moe":
        return M.moe_apply(params["ffn"], x, cfg.moe)
    return L.mlp_apply(params["ffn"], x), 0.0


# mLSTM trains in the chunkwise-parallel form; sLSTM is sequential
_CELLS = {"mlstm": X.mlstm_apply_chunked, "slstm": X.slstm_apply}
_DECODE_CELLS = {"mlstm": X.mlstm_decode, "slstm": X.slstm_decode}


def block_apply_full(params, x, btype: str, ctx: Ctx):
    """Full-sequence forward.  Returns (x, aux_loss)."""
    cfg = ctx.cfg
    eps = cfg.norm_eps
    if btype in _CELLS:
        h, _ = L.on_shards(_CELLS[btype], params["cell"],
                           L.rmsnorm(params["ln1"], x, eps))
        return x + h, 0.0
    h = L.rmsnorm(params["ln1"], x, eps)
    a = L.attention_apply(params["attn"], h, positions=ctx.positions,
                          theta=cfg.rope_theta,
                          causal=ctx.causal and btype != "enc",
                          window=ctx.window)
    if btype == "hybrid":
        m = L.on_shards(lambda p, h: S.mamba_apply(p, h, cfg.ssm),
                        params["mamba"], L.rmsnorm(params["lnm"], x, eps))
        x = x + (a + m) * 0.5
    else:
        x = x + a
    # over a mesh, pin the residual stream's batch sharding after each
    # sublayer (the model-axis partial sums reduced there, as Megatron
    # does), so that the next products see one layout
    x = L.shard_batch_dim(x)
    if btype == "cross":
        hx = L.rmsnorm(params["lnx"], x, eps)
        x = L.shard_batch_dim(x + L.attention_apply(
            params["xattn"], hx, positions=ctx.positions,
            theta=cfg.rope_theta, memory=ctx.memory,
            memory_positions=ctx.memory_positions, use_rope=False))
    h2 = L.rmsnorm(params["ln2"], x, eps)
    y, aux = _ffn(params, h2, cfg, btype)
    return x + y, aux


# ---- caches ---------------------------------------------------------------
def block_make_cache(cfg: ArchConfig, btype: str, batch: int,
                     capacity: int, device, lead=(), memory_len: int = 0):
    """A block's decode cache; a ``cross`` block's holds the memory's
    K / V (``xmem``: (B, memory_len, Kv, hd) bf16), written at prefill."""
    d, H = cfg.d_model, cfg.n_heads
    if btype in _CELLS:
        make = X.make_mlstm_state if btype == "mlstm" else \
            X.make_slstm_state
        return {"state": make(batch, H, d // H, device, lead=lead)}
    cache = {"attn": L.make_kv_cache(batch, capacity, cfg.n_kv_heads,
                                     cfg.resolved_head_dim, device,
                                     lead=lead)}
    if btype == "hybrid":
        cache["ssm"] = S.make_ssm_cache(batch, d, cfg.ssm, device,
                                        lead=lead)
    if btype == "cross":
        shape = tuple(lead) + (batch, memory_len, cfg.n_kv_heads,
                               cfg.resolved_head_dim)
        cache["xmem"] = {n: torch.zeros(shape, dtype=L.PARAM_DTYPE,
                                        device=device) for n in "kv"}
    return cache


def _copy_into(cache, new):
    """Copy a tree of new state tensors into ``cache``'s, in place."""
    tree_map(lambda c, n: c.copy_(n), cache, new)


def block_decode(params, x, btype: str, ctx: Ctx, cache):
    """One-token step; updates ``cache`` in place.  Returns (x, aux,
    cache)."""
    cfg = ctx.cfg
    eps = cfg.norm_eps
    if btype in _DECODE_CELLS:
        h, st = L.on_shards(_DECODE_CELLS[btype], params["cell"],
                            L.rmsnorm(params["ln1"], x, eps),
                            cache["state"])
        _copy_into(cache["state"], st)
        return x + h, 0.0, cache
    h = L.rmsnorm(params["ln1"], x, eps)
    a, _ = L.attention_decode(params["attn"], h, cache["attn"], ctx.pos,
                              theta=cfg.rope_theta, window=ctx.window)
    if btype == "hybrid":
        m, _ = L.on_shards(lambda p, h, c: S.mamba_decode(p, h, c, cfg.ssm),
                           params["mamba"], L.rmsnorm(params["lnm"], x, eps),
                           cache["ssm"])
        x = x + (a + m) * 0.5
    else:
        x = x + a
    if btype == "cross":
        hx = L.rmsnorm(params["lnx"], x, eps)
        x = x + L.cross_attention_decode(params["xattn"], hx, cache["xmem"])
    h2 = L.rmsnorm(params["ln2"], x, eps)
    y, aux = _ffn(params, h2, cfg, btype)
    return x + y, aux, cache


def block_prefill(params, x, btype: str, ctx: Ctx, capacity: int):
    """Full-sequence forward that also emits the decode cache: an xLSTM
    cell's last state; otherwise the last ``capacity`` positions' K / V,
    recomputed from the normed block input as in the reference, for
    hybrid blocks the SSM's last state and conv tail, recomputed too, and
    for cross blocks the memory's K / V."""
    cfg = ctx.cfg
    if btype in _CELLS:
        h, st = L.on_shards(_CELLS[btype], params["cell"],
                            L.rmsnorm(params["ln1"], x, cfg.norm_eps))
        return x + h, 0.0, {"state": st}
    y, aux = block_apply_full(params, x, btype, ctx)
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    kv = L.project_memory_kv(params["attn"], h)
    k, v = L.rope(kv["k"], ctx.positions, cfg.rope_theta), kv["v"]
    out = {"attn": L.kv_cache_from(k, v, ctx.positions, capacity)}
    if btype == "hybrid":
        out["ssm"] = L.on_shards(
            lambda p, h: S.mamba_last_state(p, h, cfg.ssm), params["mamba"],
            L.rmsnorm(params["lnm"], x, cfg.norm_eps))
    if btype == "cross":
        out["xmem"] = L.project_memory_kv(params["xattn"], ctx.memory)
    return y, aux, out


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
                     device, memory_len: int = 0):
    return [{f"b{i}": block_make_cache(cfg, bt, batch, capacity, device,
                                       lead=(repeat,),
                                       memory_len=memory_len)
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
            x = L.shard_batch_dim(x)   # pin the batch sharding each layer
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
