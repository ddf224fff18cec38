"""Flash attention backward (K10) and the differentiable attention that
uses it.

K10 replaces ``repro/kernels/flash_attention_bwd.py``: ``_bwd`` with its
two Pallas kernels, ``_dkv_kernel`` and ``_dq_kernel``, the
FlashAttention-2 backward.  Given the forward's q, k, v (B, S, H, hd),
its output o, the row log-sum-exp lse (B, H, S) fp32 that K9-LSE
returns (``kernels/flash_attention.py``) and the output's gradient do,
with D = rowsum(do ∘ o) (one PyTorch reduction, as the reference takes
it outside its kernels):

  * the **dkv kernel** walks, for each key tile, the query tiles the
    mask leaves visible, recomputes p = exp(s − lse) and accumulates
    dv += pᵀ·do, ds = p ∘ (do·vᵀ − D)·scale, dk += dsᵀ·q;
  * the **dq kernel** walks, for each query tile, the key tiles and
    accumulates dq += ds·k.

Both take bf16 or fp32 operands and hd 32, 64 or 128, sum in fp32 and
write q's dtype; the masks (causal, sliding window) and the skipped empty
tiles are the forward's.  The products run on the tensor cores: in bf16
with p and ds split into a bf16 high and low half, so that each output
element stays within a bf16 ulp of the fp32 backward; in fp32 with every
operand split into three bf16 parts and each product taken as six bf16
products, which keeps fp32's accuracy.  ``csrc/flash_attention_bwd.cu``
holds the kernels;
:func:`flash_attention_bwd_dkv_plain` and
:func:`flash_attention_bwd_dq_plain` are their plain versions (dense
tiles of ``_PLAIN_Q_TILE`` query rows, fp32 inside), which the wrappers
run for CPU tensors only.

:class:`FlashAttentionFn` is the reference's ``flash_attention_vjp``:
its forward is K9-LSE (it saves q, k, v, o and lse), its backward D, the
dkv kernel, then the dq kernel.  ``models/layers.py`` applies it, through
``ops.flash_attention_trainable``, past 2,048 tokens when a gradient is
taken.

Bound: operations.  The backward's work is five products of 2·hd flops
per visible (query, key) pair (s, do·vᵀ, dv, dk, dq): at
(1, 4096, 15, 64) causal that is 125,859,840 pairs, 80.55 GFLOP and
81.45 us at the card's bf16 tensor-core peak, against about 63 MB of
operands (19 us at 3.35 TB/s).  Both kernels compute s and do·vᵀ; the
bf16 ones issue each product on p or ds twice (its high and low half), so
the dkv kernel issues six products and the dq kernel four; the fp32 ones
issue six bf16 products for each of their four and three, 24 and 18:
:func:`flops` counts any of these.
"""
from __future__ import annotations

import torch

from . import _cuda
from .flash_attention import (_PLAIN_Q_TILE, check_operands,
                              flash_attention_fwd_lse, softmax_scale,
                              visible, visible_pairs, wide_dtype)

DKV_NAME = "flash_attention_bwd_dkv"
DQ_NAME = "flash_attention_bwd_dq"


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------
def row_delta(o, do) -> torch.Tensor:
    """D = rowsum(do ∘ o) in fp32: (B, S, H, hd) x2 -> (B, H, S)."""
    wide = wide_dtype(o)
    return (o.to(wide) * do.to(wide)).sum(-1).transpose(1, 2).contiguous()


def _tiles(q, k, v, do, lse, delta, causal: bool, window: int):
    """Yield, per tile of query rows [q0, q1), the fp32 operands the two
    gradients are built from: (q0, q1, q tile, do tile, p, ds), q and do
    tiles (B, H, Q, hd), p and ds (B, H, Q, S)."""
    B, S, H, hd = q.shape
    wide = wide_dtype(q)
    qf, kf, vf, dof = (t.to(wide).transpose(1, 2) for t in (q, k, v, do))
    scale = torch.full((), softmax_scale(hd), dtype=wide, device=q.device)
    pos = torch.arange(S, device=q.device)
    kt, vt = kf.transpose(-1, -2), vf.transpose(-1, -2)
    for q0 in range(0, S, _PLAIN_Q_TILE):
        q1 = min(q0 + _PLAIN_Q_TILE, S)
        s = torch.matmul(qf[:, :, q0:q1], kt) * scale
        mask = visible(pos[q0:q1], pos, causal, window)
        p = torch.where(mask, torch.exp(s - lse[:, :, q0:q1, None]), 0.0)
        dp = torch.matmul(dof[:, :, q0:q1], vt)
        ds = p * (dp - delta[:, :, q0:q1, None]) * scale
        yield q0, q1, qf[:, :, q0:q1], dof[:, :, q0:q1], p, ds


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *,
                                  causal: bool = True, window: int = 0):
    """The dkv kernel's plain version -> (dk, dv) in q's dtype."""
    B, S, H, hd = q.shape
    dk = torch.zeros((B, H, S, hd), dtype=wide_dtype(q), device=q.device)
    dv = torch.zeros_like(dk)
    for _, _, qt, dot, p, ds in _tiles(q, k, v, do, lse, delta, causal,
                                       window):
        dv += torch.matmul(p.transpose(-1, -2), dot)
        dk += torch.matmul(ds.transpose(-1, -2), qt)
    return (dk.transpose(1, 2).to(q.dtype), dv.transpose(1, 2).to(q.dtype))


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *,
                                 causal: bool = True, window: int = 0):
    """The dq kernel's plain version -> dq in q's dtype."""
    B, S, H, hd = q.shape
    kf = k.to(wide_dtype(q)).transpose(1, 2)
    dq = torch.empty((B, H, S, hd), dtype=wide_dtype(q), device=q.device)
    for q0, q1, _, _, _, ds in _tiles(q, k, v, do, lse, delta, causal,
                                      window):
        dq[:, :, q0:q1] = torch.matmul(ds, kf)
    return dq.transpose(1, 2).to(q.dtype)


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------
def check_bwd_operands(name, q, k, v, do, lse, delta, window) -> None:
    """K10's operand checks: K9's on q, k, v; ``do`` of q's shape, dtype
    and device, contiguous; lse and D (B, H, S) fp32 contiguous on q's
    device."""
    check_operands(q, k, v, window, name)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError(f"{name}: do must be a contiguous, aligned "
                         f"{tuple(q.shape)} {q.dtype} tensor on "
                         f"{q.device}, got {tuple(do.shape)} {do.dtype} "
                         f"{do.device}")
    B, S, H, _ = q.shape
    for label, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous "
                             f"({B}, {H}, {S}) float32 tensor on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: int = 0):
    """K10's dkv kernel.  -> (dk, dv), (B, S, H, hd) in q's dtype."""
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                             causal=causal, window=window)
    check_bwd_operands(DKV_NAME, q, k, v, do, lse, delta, window)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _cuda.launch_flash_attention_bwd(
        DKV_NAME, q=q, k=k, v=v, do=do, lse=lse, delta=delta, dq=None,
        dk=dk, dv=dv, causal=causal, window=window,
        scale=softmax_scale(q.shape[3]))
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: int = 0):
    """K10's dq kernel.  -> dq, (B, S, H, hd) in q's dtype."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                            causal=causal, window=window)
    check_bwd_operands(DQ_NAME, q, k, v, do, lse, delta, window)
    dq = torch.empty_like(q)
    _cuda.launch_flash_attention_bwd(
        DQ_NAME, q=q, k=k, v=v, do=do, lse=lse, delta=delta, dq=dq,
        dk=None, dv=None, causal=causal, window=window,
        scale=softmax_scale(q.shape[3]))
    return dq


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention (the reference's
    ``flash_attention_vjp``): forward K9-LSE, backward K10."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_attention_fwd_lse(q, k, v, causal=causal,
                                         window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()        # autograd may hand back a strided one
        delta = row_delta(o, do)
        kw = dict(causal=ctx.causal, window=ctx.window)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flops(B: int, S: int, H: int, hd: int, causal: bool = True,
          window: int = 0, products: int = 5) -> int:
    """``products`` matrix products of 2·hd flops per visible pair: 5 for
    the backward's work; 6 (bf16) or 24 (fp32, in bf16 products) issued
    by the dkv kernel, 4 or 18 by the dq kernel."""
    return 2 * products * hd * H * B * visible_pairs(S, causal, window)


def nbytes(q) -> int:
    """q, k, v, o and do read, dq, dk and dv written (each once), lse and
    D read: the backward's bytes."""
    B, S, H, _ = q.shape
    return 8 * q.numel() * q.element_size() + 2 * 4 * B * H * S

