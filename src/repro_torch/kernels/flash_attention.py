"""Flash attention forward (K9): online-softmax attention that never
writes the score matrix to device memory.

K9 replaces ``repro/kernels/flash_attention.py``: ``flash_attention``
(``_kernel``).  For q, k, v of shape (B, S, H, hd), with the KV heads
already repeated to H, it computes softmax(q kᵀ · hd^-½ + mask) v with
the scores, the running max and sum and the accumulator in fp32 (q and k
are converted to fp32 before the dot, as on the TPU), and writes the
output in q's dtype.  The mask is causal (key position ≤ query position)
and, with ``window > 0``, also drops keys ``window`` or more positions
behind the query; ``causal=False`` keeps only the window.  Tiles that the
mask empties entirely are skipped.

``csrc/flash_attention.cu`` is the kernel; :func:`flash_attention_plain`
is its plain version (dense attention with fp32 inside, the function of
``repro/kernels/ref.py::flash_attention_ref`` with the TPU kernel's
arithmetic), which the wrapper runs for CPU tensors only.

Bound: operations.  At the long-prompt shape (1, 4096, 15, 64), causal,
the two products take 4·hd·H·S(S+1)/2 = 32.2 GFLOP against 31.5 MB read
and written, so 32.6 us at the card's bf16 tensor-core peak and 9.4 us
for the bytes.  This first kernel runs both products on the fp32 cores
(see the source's note), so it sits far above that bound.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cuda

NAME = "flash_attention"
NEG_INF = -1e30
HEAD_DIMS = (64, 128)          # head dims the kernel is built for
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
    B, S, H, hd = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    kt = kf.transpose(-1, -2)
    scale = torch.full((), softmax_scale(hd), dtype=torch.float32,
                       device=q.device)
    pos = torch.arange(S, device=q.device)
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, _PLAIN_Q_TILE):
        q1 = min(q0 + _PLAIN_Q_TILE, S)
        s = torch.matmul(qf[:, :, q0:q1], kt) * scale
        s = s.masked_fill(~visible(pos[q0:q1], pos, causal, window),
                          NEG_INF)
        out[:, :, q0:q1] = torch.matmul(torch.softmax(s, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)


def check_operands(q, k, v, window: int) -> None:
    """K9's operand checks: three contiguous (B, S, H, hd) bfloat16
    tensors on one CUDA device (the model's dtype), hd one of
    :data:`HEAD_DIMS`, S a multiple of :data:`SEQ_TILE`, window >= 0."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{NAME}: q, k, v must be (B, S, H, hd) alike, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"{NAME}: q, k, v must be bfloat16, got "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {hd} not in {HEAD_DIMS}")
    if S % SEQ_TILE or 0 in (B, S, H):
        raise ValueError(f"{NAME}: S must be a positive multiple of "
                         f"{SEQ_TILE}, got {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"{NAME}: window must be >= 0, got {window}")
    if B * H > 65535:
        raise ValueError(f"{NAME}: B * H = {B * H} exceeds the grid")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{NAME}: operands on {t.device} and "
                             f"{q.device}")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: operands must be contiguous and "
                             f"16-byte aligned")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """K9.  q, k, v: (B, S, H, hd), KV heads repeated to H.  -> (B, S, H,
    hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    check_operands(q, k, v, window)
    out = torch.empty_like(q)
    _cuda.launch_flash_attention(NAME, q=q, k=k, v=v, out=out,
                                 causal=causal, window=window,
                                 scale=softmax_scale(q.shape[3]))
    return out


def flops(B: int, S: int, H: int, hd: int, causal: bool = True,
          window: int = 0) -> int:
    """Multiply-adds of both products, counted as two operations each."""
    return 4 * hd * H * B * visible_pairs(S, causal, window)


def nbytes(q) -> int:
    """q, k, v read once and the output written once."""
    return 4 * q.numel() * q.element_size()

