"""Flash attention forward (K9, K9-LSE): online-softmax attention that
never writes the score matrix to device memory.

K9 replaces ``repro/kernels/flash_attention.py``: ``flash_attention``
(``_kernel``); K9-LSE, the training forward, replaces
``repro/kernels/flash_attention_bwd.py``: ``_fwd`` (``_fwd_kernel``),
which also returns each row's log-sum-exp for the backward (K10,
``kernels/flash_attention_bwd.py``).  Both are one kernel,
``csrc/flash_attention.cu``, with the LSE pointer null for K9.  For q,
k, v of shape (B, S, H, hd) in bf16 or fp32, with the KV heads already
repeated to H, it computes softmax(q kᵀ · hd^-½ + mask) v with
the scores, the running max and sum and the accumulator in fp32 (the
products of q and k are exact, as on the TPU, where q and k are converted
to fp32 before the dot), and writes the output in q's dtype.  The mask is causal (key position ≤ query position)
and, with ``window > 0``, also drops keys ``window`` or more positions
behind the query; ``causal=False`` keeps only the window.  Tiles that the
mask empties entirely are skipped.

``csrc/flash_attention.cu`` is the kernel; :func:`flash_attention_plain`
is its plain version (dense attention with fp32 inside, the function of
``repro/kernels/ref.py::flash_attention_ref`` with the TPU kernel's
arithmetic) and :func:`flash_attention_fwd_lse_plain` K9-LSE's, which
the wrappers run for CPU tensors only.  An abstract tensor (meta or
fake, ``_cuda.is_abstract``) gets the launch's outputs, empty, and its
operations and bytes go to the installed accountant (``_cuda.account``):
``launch/budget.py`` and ``launch/dryrun.py`` trace the model that way.

Bound: operations.  At the long-prompt shape (1, 4096, 15, 64), causal,
the two products take 4·hd·H·S(S+1)/2 = 32.2 GFLOP against 31.5 MB read
and written, so 32.6 us at the card's bf16 tensor-core peak and 9.4 us
for the bytes.  The bf16 kernel runs its products on the tensor cores
(``mma.sync``) and takes p into p v as bf16 hi + lo, so it issues three
products, 48.3 GFLOP; the fp32 kernel (the label party's ad-hoc ∇Z pass)
runs on the tensor cores too, every operand in three bf16 parts and six
bf16 products for each fp32 product, at fp32 accuracy (193 GFLOP issued
there, against 195.5 us at the six-product rate).  The source's note
says why ``mma.sync`` and not yet ``wgmma`` with TMA, and what still
holds the kernels back.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cuda

NAME = "flash_attention"
LSE_NAME = "flash_attention_fwd_lse"
DTYPES = (torch.bfloat16, torch.float32)   # operand dtypes of the kernel
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)      # head dims the kernel is built for
SEQ_TILE = 64                  # the kernel's query tile: S % SEQ_TILE == 0
_PLAIN_Q_TILE = 512            # query rows per dense pass of the plain version


def softmax_scale(hd: int) -> float:
    """1 / sqrt(hd) in fp32, as the TPU kernel computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def visible(q_pos, k_pos, causal: bool, window: int):
    """bool (Q, K): key visible to query."""
    d = q_pos[:, None] - k_pos[None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window:
        m &= d < window
    return m


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for one head: the work K9 does
    on this input, for its bound."""
    if not causal:
        return S * S if not window else sum(
            S - max(0, q - window + 1) for q in range(S))
    return sum(min(q + 1, window) if window else q + 1 for q in range(S))


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """Dense masked softmax attention with fp32 inside; output in q's
    dtype.  Runs the queries in tiles of ``_PLAIN_Q_TILE`` rows so that
    a long prompt's score matrix is never held whole."""
    return _dense(q, k, v, causal, window, with_lse=False)[0]


def flash_attention_fwd_lse_plain(q, k, v, *, causal: bool = True,
                                  window: int = 0):
    """K9-LSE's plain version: :func:`flash_attention_plain`'s output and
    each row's log-sum-exp of the masked scaled scores, (B, H, S) fp32."""
    return _dense(q, k, v, causal, window, with_lse=True)


def wide_dtype(q) -> torch.dtype:
    """The plain versions' working dtype: fp32, or fp64 for fp64 operands
    (the gradient checks run there)."""
    return torch.promote_types(q.dtype, torch.float32)


def _dense(q, k, v, causal: bool, window: int, with_lse: bool):
    B, S, H, hd = q.shape
    wide = wide_dtype(q)
    qf, kf, vf = (t.to(wide).transpose(1, 2) for t in (q, k, v))
    kt = kf.transpose(-1, -2)
    scale = torch.full((), softmax_scale(hd), dtype=wide, device=q.device)
    pos = torch.arange(S, device=q.device)
    out = torch.empty((B, H, S, hd), dtype=wide, device=q.device)
    lse = torch.empty((B, H, S), dtype=wide, device=q.device) \
        if with_lse else None
    for q0 in range(0, S, _PLAIN_Q_TILE):
        q1 = min(q0 + _PLAIN_Q_TILE, S)
        s = torch.matmul(qf[:, :, q0:q1], kt) * scale
        s = s.masked_fill(~visible(pos[q0:q1], pos, causal, window),
                          NEG_INF)
        out[:, :, q0:q1] = torch.matmul(torch.softmax(s, dim=-1), vf)
        if with_lse:
            lse[:, :, q0:q1] = torch.logsumexp(s, dim=-1)
    return out.transpose(1, 2).to(q.dtype), lse


def check_operands(q, k, v, window: int, name: str = NAME) -> None:
    """K9's (and K10's) operand checks: contiguous (B, S, H, hd) tensors
    of one dtype, bfloat16 (the model's) or float32 (the label party's
    ad-hoc ∇Z pass), on one CUDA device, hd one of :data:`HEAD_DIMS`, S a
    multiple of :data:`SEQ_TILE`, window >= 0."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must be (B, S, H, hd) alike, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must be bfloat16 or float32 "
                         f"alike, got {q.dtype} {k.dtype} {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if S % SEQ_TILE or 0 in (B, S, H):
        raise ValueError(f"{name}: S must be a positive multiple of "
                         f"{SEQ_TILE}, got {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    if B * H > 65535:
        raise ValueError(f"{name}: B * H = {B * H} exceeds the grid")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on {t.device} and "
                             f"{q.device}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"16-byte aligned")


def lse_like(q) -> torch.Tensor:
    """An empty (B, H, S) fp32 row log-sum-exp for q (B, S, H, hd)."""
    B, S, H, _ = q.shape
    return torch.empty((B, H, S), dtype=torch.float32, device=q.device)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """K9.  q, k, v: (B, S, H, hd), KV heads repeated to H.  -> (B, S, H,
    hd) in q's dtype."""
    if _cuda.is_abstract(q):
        B, S, H, hd = q.shape
        _cuda.account(NAME, flops(B, S, H, hd, causal, window), nbytes(q))
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    check_operands(q, k, v, window)
    out = torch.empty_like(q)
    _cuda.launch_flash_attention(NAME, q=q, k=k, v=v, out=out, lse=None,
                                 causal=causal, window=window,
                                 scale=softmax_scale(q.shape[3]))
    return out


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True,
                            window: int = 0):
    """K9-LSE, the training forward.  q, k, v: (B, S, H, hd).  -> (out
    (B, S, H, hd) in q's dtype, lse (B, H, S) fp32)."""
    if _cuda.is_abstract(q):
        B, S, H, hd = q.shape
        _cuda.account(LSE_NAME, flops(B, S, H, hd, causal, window),
                      nbytes(q, with_lse=True))
        return torch.empty_like(q), lse_like(q)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                             window=window)
    check_operands(q, k, v, window, LSE_NAME)
    out, lse = torch.empty_like(q), lse_like(q)
    _cuda.launch_flash_attention(LSE_NAME, q=q, k=k, v=v, out=out, lse=lse,
                                 causal=causal, window=window,
                                 scale=softmax_scale(q.shape[3]))
    return out, lse


def flops(B: int, S: int, H: int, hd: int, causal: bool = True,
          window: int = 0) -> int:
    """Multiply-adds of both products, counted as two operations each."""
    return 4 * hd * H * B * visible_pairs(S, causal, window)


def nbytes(q, with_lse: bool = False) -> int:
    """q, k, v read once and the output (and the fp32 row log-sum-exp)
    written once."""
    B, S, H, _ = q.shape
    return 4 * q.numel() * q.element_size() + (4 * B * H * S if with_lse
                                               else 0)

