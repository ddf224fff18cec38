"""Core transformer layers: RMSNorm, RoPE, GQA attention, gated MLP.

Port of ``repro/models/layers.py`` (the dense family's part).  Pure
functions over parameter dicts, with the reference's bf16 / fp32 cast
points: norms, rotary angles and the softmax run in fp32; projections,
the attention score product and the weighted value sum in the
activations' dtype.  A product of an fp32 activation and a bf16 weight
runs in fp32, as ``jnp``'s promotion runs it (:func:`_mm`): the label
party's ad-hoc ∇Z pass feeds its top tower an fp32 cut tensor.
Attention supports:

  * full-sequence causal (optionally sliding-window) self-attention:
    up to ``BLOCKWISE_THRESHOLD`` tokens through the dense ``_sdpa``,
    beyond it through flash attention, where the reference runs its
    blockwise online-softmax oracle of those kernels
    (``_blockwise_sdpa``): the forward kernel (K9,
    ``kernels/flash_attention.py``) when no gradient is taken, and
    :class:`~repro_torch.kernels.flash_attention_bwd.FlashAttentionFn`
    (K9-LSE forward, K10 backward) when one is.  The kernels take the
    score product in fp32, the blockwise oracle rounds it to bf16
    first, so long sequences differ from the reference by that
    rounding;
  * one-token decode against a ring-buffer KV cache.

Decode differs from the reference in two ways.  ``pos`` may differ per
batch row (the serving engine's lanes are the batch), so the cache keeps
one ``slot_pos`` row per batch entry; and the cache is updated in place.

Cross-attention (the vlm / audio families) comes with slice 7c of the
port (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.ops import flash_attention_trainable
from .initializers import PARAM_DTYPE, dense_init, ones_init, zeros_init

# Sequences longer than this take the flash-attention kernel (the
# reference's blockwise path); they must be a multiple of KV_BLOCK, as
# the reference's blockwise path asserts.
BLOCKWISE_THRESHOLD = 2048
KV_BLOCK = 1024
NEG_INF = -1e30
EMPTY_SLOT = -(2 ** 30)


def _mm(x, w):
    """``torch.matmul`` with ``jnp``'s promotion: operands of two float
    dtypes are both cast to the wider one (PyTorch refuses the mix)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w)


def _f32(x: float, device) -> torch.Tensor:
    """An fp32 0-d tensor: dividing by it is IEEE division on the card
    too (PyTorch multiplies by the reciprocal of a Python scalar)."""
    return torch.full((), x, dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------
def rmsnorm_init(d: int, device, lead=()):
    return {"scale": ones_init(tuple(lead) + (d,), device)}


def rmsnorm(params, x, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope(x, positions, theta: float = 10000.0):
    """Apply rotary embedding.  x: (B, S, H, hd); positions: (S,) or
    (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(_f32(theta, x.device), exps)
    pos = positions.to(device=x.device, dtype=torch.float32)
    if pos.dim() == 1:
        ang = pos[None, :, None] * freqs[None, None, :]   # (1, S, half)
    else:
        ang = pos[:, :, None] * freqs[None, None, :]      # (B, S, half)
    ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def attention_init(gen, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, *, qkv_bias: bool = False, lead=()):
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, lead)
        .reshape(lead + (d_model, n_heads, head_dim)),
        "wk": dense_init(gen, d_model, n_kv * head_dim, lead)
        .reshape(lead + (d_model, n_kv, head_dim)),
        "wv": dense_init(gen, d_model, n_kv * head_dim, lead)
        .reshape(lead + (d_model, n_kv, head_dim)),
        "wo": dense_init(gen, n_heads * head_dim, d_model, lead)
        .reshape(lead + (n_heads, head_dim, d_model)),
    }
    if qkv_bias:
        dev = gen.device
        p["bq"] = zeros_init(lead + (n_heads, head_dim), dev)
        p["bk"] = zeros_init(lead + (n_kv, head_dim), dev)
        p["bv"] = zeros_init(lead + (n_kv, head_dim), dev)
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    return _mm(x, w.reshape(d, h * k)).reshape(
        x.shape[:-1] + (h, k))


def _project_qkv(params, x):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _out_proj(out, wo):
    """einsum("bqhd,hdo->bqo", out, wo) as one matmul."""
    h, d, o = wo.shape
    return _mm(out.reshape(out.shape[:-2] + (h * d,)), wo.reshape(h * d, o))


def _repeat_kv(k, n_heads: int):
    """(B, S, Kv, hd) -> (B, S, H, hd) by repeating each KV group."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


def _sdpa(q, k, v, mask):
    """q: (B,Q,H,hd) k,v: (B,K,H,hd); mask broadcastable to (B,H,Q,K).
    The score product comes out in the operands' dtype before the fp32
    softmax, and the weights are cast back to v's dtype, as in the
    reference."""
    hd = q.shape[-1]
    scores = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)).float()
    scores = scores / torch.sqrt(_f32(hd, q.device))
    scores = torch.where(mask, scores, _f32(NEG_INF, q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.matmul(w.to(v.dtype), v.transpose(1, 2))   # (B,H,Q,hd)
    return out.transpose(1, 2)


def _causal_mask(q_pos, k_pos, window: int):
    """bool (..., Q, K): True where key visible to query."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    m = d >= 0
    if window:
        m &= d < window
    return m


def attention_apply(params, x, *, positions, theta: float = 10000.0,
                    causal: bool = True, window: int = 0):
    """Full-sequence self-attention.  ``positions`` are the tokens'
    absolute positions ``arange(S)`` (the long path's kernels mask by
    index).  Past ``BLOCKWISE_THRESHOLD`` tokens a gradient, when one is
    taken, goes through K10."""
    n_heads = params["wq"].shape[1]
    q, k, v = _project_qkv(params, x)
    S = x.shape[1]
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    if S > BLOCKWISE_THRESHOLD:
        if S % KV_BLOCK:
            raise ValueError(
                f"a sequence longer than {BLOCKWISE_THRESHOLD} tokens must "
                f"be a multiple of {KV_BLOCK} (the reference's blockwise "
                f"path asserts it), got {S}")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            out = flash_attention_trainable(q, k, v, causal=causal,
                                            window=window)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        p = positions if positions.dim() == 1 else positions[0]
        if causal:
            mask = _causal_mask(p, p, window)[None, None]
        else:
            mask = torch.ones((1, 1, S, S), dtype=torch.bool,
                              device=x.device)
        out = _sdpa(q, k, v, mask)
    return _out_proj(out, params["wo"])


# ---- decode with ring-buffer KV cache -------------------------------------
def make_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  device, dtype=PARAM_DTYPE, lead=()):
    lead = tuple(lead)
    return {
        "k": torch.zeros(lead + (batch, capacity, n_kv, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros(lead + (batch, capacity, n_kv, head_dim),
                         dtype=dtype, device=device),
        # absolute position held in each slot, per batch row; very
        # negative = empty
        "slot_pos": torch.full(lead + (batch, capacity), EMPTY_SLOT,
                               dtype=torch.int32, device=device),
    }


def batch_positions(pos, batch: int, device) -> torch.Tensor:
    """``pos`` (an int, a 0-d or a (B,) tensor) -> (B,) int32 on
    ``device``."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.expand(batch) if pos.dim() == 0 else pos


def attention_decode(params, x, cache, pos, *, theta: float = 10000.0,
                     window: int = 0):
    """One-token decode.  x: (B, 1, d); pos: the new token's absolute
    position, an int or one per batch row ((B,) int32).

    The cache is a ring buffer of ``capacity`` slots (== max context):
    row b writes slot ``pos[b] % capacity``, in place.  Returns (out,
    cache)."""
    B = x.shape[0]
    n_heads = params["wq"].shape[1]
    pos = batch_positions(pos, B, x.device)
    q, k_new, v_new = _project_qkv(params, x)
    q = rope(q, pos[:, None], theta)
    k_new = rope(k_new, pos[:, None], theta)
    cap = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(pos, cap).long()
    cache["k"].index_put_((rows, slot), k_new[:, 0])
    cache["v"].index_put_((rows, slot), v_new[:, 0])
    cache["slot_pos"].index_put_((rows, slot), pos)

    k = _repeat_kv(cache["k"], n_heads)
    v = _repeat_kv(cache["v"], n_heads)
    dist = pos[:, None] - cache["slot_pos"]                # (B, cap)
    valid = dist >= 0
    if window:
        valid &= dist < window
    out = _sdpa(q, k, v, valid[:, None, None, :])
    return _out_proj(out, params["wo"]), cache


# --------------------------------------------------------------------------
# Gated MLP (llama-style)
# --------------------------------------------------------------------------
def mlp_init(gen, d_model: int, d_ff: int, lead=()):
    return {
        "wg": dense_init(gen, d_model, d_ff, lead),
        "wu": dense_init(gen, d_model, d_ff, lead),
        "wd": dense_init(gen, d_ff, d_model, lead),
    }


def mlp_apply(params, x):
    g = F.silu(_mm(x, params["wg"]).float()).to(x.dtype)
    u = _mm(x, params["wu"])
    return _mm(g * u, params["wd"])
