"""VFL split model: Party A bottom tower, Party B bottom + top towers.

Port of ``repro/models/vfl.py`` for the text families with token-aligned
fusion (``fusion="add"``): Party A has a token-aligned auxiliary feature
stream and its tower's output ``Z_A`` is the activation that crosses the
party boundary; Party B adds ``Z_A @ fuse_proj`` between its bottom and
top towers.  The party boundary is the argument list: ``forward_a`` /
``prefill_a`` / ``decode_step_a`` touch only Party A's parameters, and
Party B's halves take ``Z_A`` as an argument.

The other families, the vlm / audio ones with cross-attention fusion
among them, come with slice 7c (``backbone.tower_stages`` refuses them),
and the training objective (``per_instance_loss``, ``joint_loss``) with
slice 7b of the port (ROADMAP.md).  Decode updates the caches in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from . import layers as L
from .backbone import (Ctx, tower_apply, tower_decode, tower_init,
                       tower_make_cache, tower_prefill, tower_stages)
from .initializers import dense_init, embed_init

def stages_a(cfg: ArchConfig):
    return tower_stages(cfg, cfg.vfl_split.layers_a)


def stages_b(cfg: ArchConfig):
    return tower_stages(cfg, cfg.vfl_split.layers_b)


def stages_top(cfg: ArchConfig):
    return tower_stages(cfg, cfg.vfl_split.layers_top)


def _embed(table, tokens):
    """table[tokens] for int token ids of any shape."""
    return table.index_select(0, tokens.reshape(-1)).reshape(
        tuple(tokens.shape) + (table.shape[1],))


def _arange(S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_party_a(gen: torch.Generator, cfg: ArchConfig):
    vocab_a = ((cfg.aux_vocab_size + 255) // 256) * 256
    return {"embed": embed_init(gen, vocab_a, cfg.d_model),
            "tower": tower_init(gen, cfg, stages_a(cfg))}


def init_party_b(gen: torch.Generator, cfg: ArchConfig):
    return {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model),
            "bottom": tower_init(gen, cfg, stages_b(cfg)),
            "top": tower_init(gen, cfg, stages_top(cfg)),
            "ln_f": L.rmsnorm_init(cfg.d_model, gen.device),
            "head": dense_init(gen, cfg.d_model, cfg.padded_vocab),
            "fuse_proj": dense_init(gen, cfg.d_model, cfg.d_model)}


def init_all(seed: int, cfg: ArchConfig, device="cpu"):
    """Both parties' parameters, drawn on ``device`` from one generator
    seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return {"a": init_party_a(gen, cfg), "b": init_party_b(gen, cfg)}


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------
def forward_a(params_a, cfg: ArchConfig, batch: Dict[str, Any]):
    """-> Z_A (B, S, d)."""
    x = _embed(params_a["embed"], batch["tokens_a"])
    ctx = Ctx(cfg, positions=_arange(x.shape[1], x.device),
              window=cfg.sliding_window)
    x, _ = tower_apply(params_a["tower"], x, cfg, stages_a(cfg), ctx)
    return x


def _logits(h, params_b, cfg: ArchConfig):
    h = L.rmsnorm(params_b["ln_f"], h, cfg.norm_eps)
    logits = torch.matmul(h, params_b["head"]).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = cfg.padded_vocab - cfg.vocab_size
        mask = torch.cat([
            torch.zeros(cfg.vocab_size, dtype=torch.float32,
                        device=h.device),
            torch.full((pad,), -1e30, dtype=torch.float32,
                       device=h.device)])
        logits = logits + mask
    return logits


def _fuse(x, z_a, params_b):
    return x + torch.matmul(z_a, params_b["fuse_proj"])


def forward_b(params_b, cfg: ArchConfig, z_a, batch: Dict[str, Any]):
    """-> (logits, aux): Z_A enters by the split's additive fusion."""
    x = _embed(params_b["embed"], batch["tokens"])
    ctx = Ctx(cfg, positions=_arange(x.shape[1], x.device),
              window=cfg.sliding_window)
    x, aux1 = tower_apply(params_b["bottom"], x, cfg, stages_b(cfg), ctx)
    x = _fuse(x, z_a, params_b)
    x, aux2 = tower_apply(params_b["top"], x, cfg, stages_top(cfg), ctx)
    return _logits(x, params_b, cfg), aux1 + aux2


# --------------------------------------------------------------------------
# Serving (co-served split model; party boundary = module boundary)
# --------------------------------------------------------------------------
def serve_capacity(cfg: ArchConfig, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window \
        else seq_len


def make_serve_cache(cfg: ArchConfig, batch: int, seq_len: int,
                     device="cpu"):
    cap = serve_capacity(cfg, seq_len)
    return {
        "a": tower_make_cache(cfg, stages_a(cfg), batch, cap, device),
        "b": tower_make_cache(cfg, stages_b(cfg), batch, cap, device),
        "top": tower_make_cache(cfg, stages_top(cfg), batch, cap, device),
    }


def prefill_a(params_a, cfg: ArchConfig, batch, total_len: int = 0):
    """Party A's half of prefill -> (z_a, cache_a): z_a is the activation
    that crosses the party boundary (the only thing Party B may see);
    cache_a is Party A's private decode KV state."""
    tokens_a = batch["tokens_a"]
    S = tokens_a.shape[1]
    cap = serve_capacity(cfg, max(total_len, S))
    xa = _embed(params_a["embed"], tokens_a)
    ctx = Ctx(cfg, positions=_arange(S, xa.device),
              window=cfg.sliding_window)
    z_a, _, cache_a = tower_prefill(params_a["tower"], xa, cfg,
                                    stages_a(cfg), ctx, cap)
    return z_a, cache_a


def prefill_b(params_b, cfg: ArchConfig, z_a, batch, total_len: int = 0):
    """Party B's half of prefill: consumes the exchanged z_a and returns
    (last-position logits, {"b", "top"} caches)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    cap = serve_capacity(cfg, max(total_len, S))
    caches: Dict[str, Any] = {}
    x = _embed(params_b["embed"], tokens)
    ctx = Ctx(cfg, positions=_arange(S, x.device),
              window=cfg.sliding_window)
    x, _, caches["b"] = tower_prefill(params_b["bottom"], x, cfg,
                                      stages_b(cfg), ctx, cap)
    x = _fuse(x, z_a, params_b)
    x, _, caches["top"] = tower_prefill(params_b["top"], x, cfg,
                                        stages_top(cfg), ctx, cap)
    return _logits(x[:, -1:], params_b, cfg), caches


def prefill(params, cfg: ArchConfig, batch, total_len: int = 0):
    """Full-context forward -> (last-position logits, decode caches
    {"a", "b", "top"}).  ``total_len`` (prompt + generation) sizes the KV
    rings.  Composed from the party halves."""
    z_a, cache_a = prefill_a(params["a"], cfg, batch, total_len)
    logits, caches_b = prefill_b(params["b"], cfg, z_a, batch, total_len)
    return logits, {"a": cache_a, **caches_b}


def decode_step_a(params_a, cfg: ArchConfig, cache_a, token_a, pos):
    """Party A's half of one-token decode -> (z_a_t (B, 1, d), cache_a,
    updated in place).  ``pos``: an int or one position per row."""
    pos = L.batch_positions(pos, token_a.shape[0], token_a.device)
    ctx = Ctx(cfg, pos=pos, window=cfg.sliding_window)
    xa = _embed(params_a["embed"], token_a)
    z_a_t, _, cache_a = tower_decode(params_a["tower"], xa, cfg,
                                     stages_a(cfg), ctx, cache_a)
    return z_a_t, cache_a


def decode_step_b(params_b, cfg: ArchConfig, caches, token, z_a_t, pos):
    """Party B's half of one-token decode.  caches: {"b", "top"}; z_a_t
    is the (possibly cache-served, possibly dequantised) Party A
    activation.  -> (logits (B, 1, V), caches, updated in place)."""
    pos = L.batch_positions(pos, token.shape[0], token.device)
    ctx = Ctx(cfg, pos=pos, window=cfg.sliding_window)
    x = _embed(params_b["embed"], token)
    x, _, _ = tower_decode(params_b["bottom"], x, cfg, stages_b(cfg), ctx,
                           caches["b"])
    x = _fuse(x, z_a_t, params_b)
    x, _, _ = tower_decode(params_b["top"], x, cfg, stages_top(cfg), ctx,
                           caches["top"])
    return _logits(x, params_b, cfg), caches


def decode_step(params, cfg: ArchConfig, caches, step_batch, pos):
    """One-token decode.  step_batch: {"token": (B, 1), "token_a":
    (B, 1)}.  -> (logits (B, 1, V), caches, updated in place).  Composed
    from the party halves."""
    z_a_t, _ = decode_step_a(params["a"], cfg, caches["a"],
                             step_batch["token_a"], pos)
    logits, _ = decode_step_b(params["b"], cfg, caches, step_batch["token"],
                              z_a_t, pos)
    return logits, caches
