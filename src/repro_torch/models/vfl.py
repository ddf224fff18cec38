"""VFL split model: Party A bottom tower, Party B bottom + top towers.

Port of ``repro/models/vfl.py`` for the text families with token-aligned
fusion (``fusion="add"``): Party A has a token-aligned auxiliary feature
stream and its tower's output ``Z_A`` is the activation that crosses the
party boundary; Party B adds ``Z_A @ fuse_proj`` between its bottom and
top towers.  The party boundary is the argument list: ``forward_a`` /
``prefill_a`` / ``decode_step_a`` touch only Party A's parameters, and
Party B's halves take ``Z_A`` as an argument.

The other families, the vlm / audio ones with cross-attention fusion
among them, come with slice 7c (``backbone.tower_stages`` refuses them).
Decode updates the caches in place.

Training: ``per_instance_loss`` is Party B's objective and
``joint_loss`` the vanilla one; ``train`` / ``remat`` switch on the
towers' activation checkpointing.  The round engine takes each party's
parameters as an ``nn.Module``: :class:`PartyParams` holds a party's
nested tree with parameter paths equal to the reference's pytree paths;
``forward_a``, ``forward_b``, ``per_instance_loss`` and ``joint_loss``
take either a tree or a :class:`PartyParams`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from . import layers as L
from .backbone import (Ctx, tower_apply, tower_decode, tower_init,
                       tower_make_cache, tower_prefill, tower_stages)
from .initializers import dense_init, embed_init

class PartyParams(torch.nn.Module):
    """A nested tree of tensors (dicts and lists, as the reference's
    pytrees) held as parameters: ``tower.0.b0.attn.wq`` is
    ``tree["tower"][0]["b0"]["attn"]["wq"]``, so ``named_parameters``
    gives the reference's paths (``bridge.load_tree`` and
    ``bridge.reference_parameters`` take it as they take any module).
    :meth:`tree` is the nested view of the parameters themselves."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        items = list(enumerate(tree)) if self._is_list else \
            list(tree.items())
        self._keys = [str(k) for k, _ in items]
        for k, v in items:
            if isinstance(v, (dict, list, tuple)):
                self.add_module(str(k), PartyParams(v))
            else:
                self.register_parameter(str(k), torch.nn.Parameter(v))

    def tree(self):
        out = [self._modules[k].tree() if k in self._modules
               else self._parameters[k] for k in self._keys]
        return out if self._is_list else dict(zip(self._keys, out))


def as_tree(params):
    """A :class:`PartyParams` or a tree -> the tree."""
    return params.tree() if isinstance(params, PartyParams) else params


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
def forward_a(params_a, cfg: ArchConfig, batch: Dict[str, Any],
              train: bool = False, remat: bool = True):
    """-> Z_A (B, S, d)."""
    params_a = as_tree(params_a)
    x = _embed(params_a["embed"], batch["tokens_a"])
    ctx = Ctx(cfg, positions=_arange(x.shape[1], x.device),
              window=cfg.sliding_window, train=train, remat=remat)
    x, _ = tower_apply(params_a["tower"], x, cfg, stages_a(cfg), ctx)
    return x


def _logits(h, params_b, cfg: ArchConfig):
    h = L.rmsnorm(params_b["ln_f"], h, cfg.norm_eps)
    logits = L._mm(h, params_b["head"]).float()
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
    """x + Z_A · fuse_proj; an fp32 Z_A (the ad-hoc ∇Z pass) makes the
    sum, and the top tower after it, fp32, as in the reference."""
    return x + L._mm(z_a, params_b["fuse_proj"])


def forward_b(params_b, cfg: ArchConfig, z_a, batch: Dict[str, Any],
              train: bool = False, remat: bool = True):
    """-> (logits, aux): Z_A enters by the split's additive fusion."""
    params_b = as_tree(params_b)
    x = _embed(params_b["embed"], batch["tokens"])
    ctx = Ctx(cfg, positions=_arange(x.shape[1], x.device),
              window=cfg.sliding_window, train=train, remat=remat)
    x, aux1 = tower_apply(params_b["bottom"], x, cfg, stages_b(cfg), ctx)
    x = _fuse(x, z_a, params_b)
    x, aux2 = tower_apply(params_b["top"], x, cfg, stages_top(cfg), ctx)
    return _logits(x, params_b, cfg), aux1 + aux2


def per_instance_loss(params_b, cfg: ArchConfig, z_a, batch,
                      train: bool = True, remat: bool = True):
    """Cross-entropy per instance (B,) and the aux loss: Party B's
    objective.  As in the reference, logsumexp minus the label's logit
    (read by a gather: the reference's one-hot sum adds only zeros to
    it), averaged over the sequence."""
    logits, aux = forward_b(params_b, cfg, z_a, batch, train=train,
                            remat=remat)
    lse = torch.logsumexp(logits, dim=-1)
    labels = batch["labels"].long()
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - label_logit).mean(dim=-1), aux


def joint_loss(params, cfg: ArchConfig, batch, train: bool = True):
    """The vanilla VFL objective (both parties in one program)."""
    params = as_tree(params)
    z_a = forward_a(params["a"], cfg, batch, train=train)
    li, aux = per_instance_loss(params["b"], cfg, z_a, batch, train=train)
    return li.mean() + aux


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
