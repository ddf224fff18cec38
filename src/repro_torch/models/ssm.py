"""Selective SSM (Mamba-style) block.

Port of ``repro/models/ssm.py``.  Recurrence (diagonal A):

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = C_t · h_t + D * x_t

As in the reference the sequence runs in chunks of ``SCAN_CHUNK`` tokens
(``S % chunk == 0`` asserted), the state carried from chunk to chunk.
Within a chunk the pairs (decay, increment) are combined by an inclusive
Hillis–Steele scan (log2(chunk) elementwise steps; the reference's
``lax.associative_scan`` combines them in another tree, so fp32 results
differ in their last bits).  With a gradient each chunk runs under
``torch.utils.checkpoint``: the backward keeps only the chunks' inputs
and carries, and recomputes a chunk's scan when it reaches it, so it
never holds the scan's log2(chunk) intermediates of every chunk.  The
decay is a product of exponentials, never ``exp`` of a cumulative sum (a
sum over a chunk overflows fp32).

softplus is ``torch.logaddexp(x, 0)``, which is ``jax.nn.softplus``'s
formula (``F.softplus`` switches to the identity above 20).  Decode
updates the cache in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import SSMConfig
from .initializers import dense_init, ones_init, zeros_init
from .layers import _mm

SCAN_CHUNK = 256


def mamba_init(gen, d_model: int, cfg: SSMConfig, lead=()):
    lead = tuple(lead)
    di = cfg.expand * d_model
    N = cfg.state_dim
    r = max(16, d_model // 16)
    dev = gen.device
    a = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
    conv = torch.randn(lead + (cfg.conv_dim, di), generator=gen,
                       dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, d_model, 2 * di, lead),
        "conv_w": (conv * 0.1).to(torch.bfloat16),
        "w_b": dense_init(gen, di, N, lead),
        "w_c": dense_init(gen, di, N, lead),
        "w_dt1": dense_init(gen, di, r, lead),
        "w_dt2": dense_init(gen, r, di, lead),
        "dt_bias": zeros_init(lead + (di,), dev, torch.float32),
        "A_log": torch.log(a).expand(lead + (di, N)).clone(),
        "D": ones_init(lead + (di,), dev, torch.float32),
        "out_proj": dense_init(gen, di, d_model, lead),
    }


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w):
    """Depthwise causal conv.  x: (B, S, di); w: (K, di).  fp32 sums in
    the reference's order, rounded to x's dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(K):
        out = out + xp[:, j:j + S, :].float() * w[K - 1 - j].float()
    return out.to(x.dtype)


def _ssm_scan(decay, inc):
    """Inclusive scan of h_t = decay_t * h_{t-1} + inc_t over axis 1 from
    h = 0 -> (cumulative decay, h)."""
    n, off = decay.shape[1], 1
    while off < n:
        d_prev, h_prev = decay[:, :-off], inc[:, :-off]
        d_cur, h_cur = decay[:, off:], inc[:, off:]
        inc = torch.cat([inc[:, :off], d_cur * h_prev + h_cur], dim=1)
        decay = torch.cat([decay[:, :off], d_prev * d_cur], dim=1)
        off *= 2
    return decay, inc


def _chunk(h, xcs, dts, Bs, Cs, A):
    """One chunk: the carry h (B, di, N) and the chunk's inputs -> (the
    chunk's last state, y (B, c, di))."""
    decay = torch.exp(dts[..., None] * A[None, None])         # (B,c,di,N)
    inc = (dts * xcs)[..., None] * Bs[:, :, None, :]          # (B,c,di,N)
    cum_decay, h_local = _ssm_scan(decay, inc)
    h_all = h_local + cum_decay * h[:, None]                  # add carry
    y = torch.matmul(h_all, Cs[..., None])[..., 0]            # (B,c,di)
    return h_all[:, -1], y


def _selective_ssm(xc, dt, B_t, C_t, A, h0):
    """xc / dt: (B, S, di); B_t / C_t: (B, S, N); A: (di, N); h0: (B, di,
    N).  -> (y (B, S, di), the last state)."""
    S = xc.shape[1]
    chunk = min(SCAN_CHUNK, S)
    assert S % chunk == 0, (S, chunk)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xc, dt, B_t, C_t, A, h0))
    h, ys = h0, []
    for i in range(0, S, chunk):
        sl = [t[:, i:i + chunk] for t in (xc, dt, B_t, C_t)]
        if remat:
            h, y = checkpoint(_chunk, h, *sl, A, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = _chunk(h, *sl, A)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _precompute(params, x):
    di = params["D"].shape[-1]
    xz = _mm(x, params["in_proj"])
    return xz[..., :di], xz[..., di:]


def _dtbc(params, xc):
    dt_pre = torch.matmul(torch.matmul(xc.float(), params["w_dt1"].float()),
                          params["w_dt2"].float())
    dt = softplus(dt_pre + params["dt_bias"])
    B_t = _mm(xc, params["w_b"]).float()
    C_t = _mm(xc, params["w_c"]).float()
    return dt, B_t, C_t


def _gate_out(params, y, xc, z, dtype):
    """y + D x, gated by silu(z) in the activations' dtype, projected."""
    y = y + params["D"] * xc.float()
    y = y.to(dtype) * torch.sigmoid(z.float()).to(dtype) * z
    return _mm(y, params["out_proj"])


def _scan_inputs(params, x):
    """x (B, S, d) -> (x_in, z, xc, the operands of
    :func:`_selective_ssm` from a zero state)."""
    x_in, z = _precompute(params, x)
    xc = F.silu(_causal_conv(x_in, params["conv_w"]).float()).to(x.dtype)
    dt, B_t, C_t = _dtbc(params, xc)
    A = -torch.exp(params["A_log"])
    h0 = torch.zeros((x.shape[0],) + tuple(A.shape), dtype=torch.float32,
                     device=x.device)
    return x_in, z, xc, (xc.float(), dt, B_t, C_t, A, h0)


def mamba_apply(params, x, cfg: SSMConfig):
    """Full-sequence forward.  x: (B, S, d)."""
    _, z, xc, ops = _scan_inputs(params, x)
    y, _ = _selective_ssm(*ops)
    return _gate_out(params, y, xc, z, x.dtype)


def mamba_last_state(params, x, cfg: SSMConfig):
    """The decode cache after the full sequence x (B, S, d): the last
    state h and the conv window's tail (the last K - 1 inputs, in their
    dtype), as the reference's prefill recomputes them."""
    x_in, _, _, ops = _scan_inputs(params, x)
    _, h_last = _selective_ssm(*ops)
    K, S = cfg.conv_dim, x.shape[1]
    return {"h": h_last, "conv": x_in[:, S - (K - 1):]}


def make_ssm_cache(batch: int, d_model: int, cfg: SSMConfig, device,
                   dtype=torch.float32, lead=()):
    lead = tuple(lead)
    di = cfg.expand * d_model
    return {
        "h": torch.zeros(lead + (batch, di, cfg.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_dim - 1, di),
                            dtype=dtype, device=device),
    }


def mamba_decode(params, x, cache, cfg: SSMConfig):
    """One-token decode.  x: (B, 1, d) -> (y, cache), the cache updated
    in place."""
    x_in, z = _precompute(params, x)
    window = torch.cat([cache["conv"], x_in.to(cache["conv"].dtype)],
                       dim=1)                                 # (B, K, di)
    w = params["conv_w"].float()
    xc = (window.float() * w).sum(dim=1)[:, None]
    xc = F.silu(xc).to(x.dtype)
    dt, B_t, C_t = _dtbc(params, xc)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt[:, 0, :, None] * A[None])            # (B,di,N)
    inc = (dt[:, 0] * xc[:, 0].float())[..., None] * B_t[:, 0, None, :]
    h = decay * cache["h"] + inc
    y = torch.matmul(h, C_t[:, 0, :, None])[..., 0][:, None]
    out = _gate_out(params, y, xc, z, x.dtype)
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
