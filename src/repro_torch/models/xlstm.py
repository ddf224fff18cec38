"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro/models/xlstm.py``: the stabilised recurrent cells of the
xLSTM paper (arXiv:2405.04517), with the projections as matrix products
outside the recurrence.  The token-sequential forms run the cell once a
token, in chunks of ``CHUNK`` tokens, each chunk under
``torch.utils.checkpoint`` when a gradient is taken (the backward keeps
the state at chunk boundaries only, as the reference's remat'd nested
scan does); a length that is not a multiple of the chunk runs one flat
loop.  The mLSTM trains in the chunkwise-parallel form
(:func:`mlstm_apply_chunked`, ``PARALLEL_CHUNK`` tokens a step, exact up
to the order of fp32 sums); the sLSTM is token-sequential: at S tokens it
is S small steps.

Maxima whose gradient splits between ties, as ``jnp.max`` /
``jnp.maximum``'s do, are ``torch.amax`` / ``torch.maximum``;
``log_sigmoid`` is ``jax.nn.log_sigmoid``'s ``-softplus(-x)``.  Decode
returns the new state; ``backbone.block_decode`` copies it into the
cache in place.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .initializers import dense_init, zeros_init
from .layers import _f32, _mm, _proj
from .ssm import softplus


def log_sigmoid(x):
    return -softplus(-x)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in ts if isinstance(t, torch.Tensor))


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
def mlstm_init(gen, d_model: int, n_heads: int, lead=()):
    lead = tuple(lead)
    dh = d_model // n_heads
    dev = gen.device

    def heads(w):
        return w.reshape(lead + (d_model, n_heads, dh))
    return {
        "wq": heads(dense_init(gen, d_model, d_model, lead)),
        "wk": heads(dense_init(gen, d_model, d_model, lead)),
        "wv": heads(dense_init(gen, d_model, d_model, lead)),
        "w_i": dense_init(gen, d_model, n_heads, lead, dtype=torch.float32),
        "w_f": dense_init(gen, d_model, n_heads, lead, dtype=torch.float32),
        # open forget gates
        "f_bias": torch.full(lead + (n_heads,), 3.0, dtype=torch.float32,
                             device=dev),
        "w_o": dense_init(gen, d_model, d_model, lead),
        "out_proj": dense_init(gen, d_model, d_model, lead),
    }


def make_mlstm_state(batch: int, n_heads: int, dh: int, device, lead=()):
    lead = tuple(lead) + (batch, n_heads)

    def z(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=device)
    return {"C": z(dh, dh), "n": z(dh), "m": z()}


def _mlstm_cell(state, qkvif):
    """One step.  q, k, v: (B, H, dh); i, f: (B, H) pre-activations."""
    q, k, v, i_pre, f_pre = qkvif
    dh = q.shape[-1]
    logf = log_sigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    f_act = torch.exp(logf + state["m"] - m_new)
    i_act = torch.exp(i_pre - m_new)
    kf = k.float() / torch.sqrt(_f32(dh, k.device))
    vf = v.float()
    C = f_act[..., None, None] * state["C"] + \
        i_act[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = f_act[..., None] * state["n"] + i_act[..., None] * kf
    qf = q.float()
    num = torch.matmul(qf[..., None, :], C)[..., 0, :]
    den = torch.maximum(torch.abs((qf * n).sum(-1)), _f32(1.0, q.device))
    h = num / den[..., None]
    return {"C": C, "n": n, "m": m_new}, h


def _mlstm_proj(params, x):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    i_pre = torch.matmul(x.float(), params["w_i"])
    f_pre = torch.matmul(x.float(), params["w_f"]) + params["f_bias"]
    o = torch.sigmoid(_mm(x, params["w_o"]).float())
    return q, k, v, i_pre, f_pre, o


# Sequence chunk of the token-sequential forms: with a gradient the
# backward keeps the state at chunk boundaries only and recomputes the
# steps within a chunk.
CHUNK = 256


def _scan(cell, state, xs, lo: int, hi: int):
    """Steps lo..hi-1 of ``cell`` over ``xs`` ((B, S, ...) tensors) ->
    (state, [outputs])."""
    hs = []
    for t in range(lo, hi):
        state, h = cell(state, tuple(a[:, t] for a in xs))
        hs.append(h)
    return state, hs


def _chunked_cell_scan(cell, state, xs_seq):
    """xs_seq: (B, S, ...) tensors -> (state, (B, S, ...) outputs), in
    checkpointed chunks of CHUNK steps (one flat loop for an odd
    length)."""
    S = xs_seq[0].shape[1]
    c = min(CHUNK, S)
    if S % c != 0:               # one flat loop for odd lengths
        state, hs = _scan(cell, state, xs_seq, 0, S)
        return state, torch.stack(hs, dim=1)
    remat = _needs_grad(*xs_seq, *state.values())
    keys = list(state)
    out = []
    for lo in range(0, S, c):
        def chunk(*flat, lo=lo):
            st = dict(zip(keys, flat[:len(keys)]))
            st, hs = _scan(cell, st, flat[len(keys):], lo, lo + c)
            return tuple(st[k] for k in keys) + (torch.stack(hs, dim=1),)
        flat = tuple(state[k] for k in keys) + tuple(xs_seq)
        res = checkpoint(chunk, *flat, use_reentrant=False,
                         preserve_rng_state=False) if remat else chunk(*flat)
        state = dict(zip(keys, res[:-1]))
        out.append(res[-1])
    return state, torch.cat(out, dim=1)


def mlstm_apply(params, x, state=None):
    """x: (B, S, d) -> (y, state)."""
    B, S, d = x.shape
    H = params["wq"].shape[-2]
    q, k, v, i_pre, f_pre, o = _mlstm_proj(params, x)
    if state is None:
        state = make_mlstm_state(B, H, d // H, x.device)
    state, hs = _chunked_cell_scan(_mlstm_cell, state,
                                   (q, k, v, i_pre, f_pre))
    h = hs.reshape(B, S, d).to(x.dtype)
    y = h * o.to(x.dtype)
    return _mm(y, params["out_proj"]), state


def mlstm_decode(params, x, state):
    return mlstm_apply(params, x, state)


# --------------------------------------------------------------------------
# Chunkwise-parallel mLSTM: L tokens a step as (L, L) masked products,
# (C, n, m) carried across chunks; the same stabilised recurrence,
# reassociated:
#
#   b_t   = Σ_{s≤t} log σ(f_s)                     (within-chunk cum-decay)
#   m_t   = max(b_t + m_0, max_{s≤t}(b_t - b_s + i_s))
#   C̃_t  = e^{b_t+m_0-m_t} C_0 + Σ_{s≤t} e^{b_t-b_s+i_s-m_t} k̂_s v_sᵀ
#   h_t   = (q_t·C̃_t) / max(|q_t·ñ_t|, 1)          (k̂ = k/√dh)
# --------------------------------------------------------------------------
PARALLEL_CHUNK = 64


def _parallel_step(C0, n0, m0, qL, kL, vL, iL, fL):
    """One chunk of the parallel form: carry (C0, n0, m0), the chunk's
    (B, L, H, ·) inputs -> (C, n, m, h (B, L, H, dh))."""
    L, dh = qL.shape[1], qL.shape[-1]
    kL = kL / torch.sqrt(_f32(dh, kL.device))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                device=qL.device))
    b = torch.cumsum(fL, dim=1)                                # (B,L,H)
    # log-weights D[t, s] = b_t - b_s + i_s (s <= t), else -inf
    D = b[:, :, None, :] - b[:, None, :, :] + iL[:, None, :, :]
    D = torch.where(tri[None, :, :, None], D, _f32(-math.inf, D.device))
    m_intra = torch.amax(D, dim=2)                             # (B,L,H)
    m_t = torch.maximum(b + m0[:, None, :], m_intra)
    # intra-chunk attention
    w = torch.exp(D - m_t[:, :, None, :])                      # (B,L,L,H)
    scores = torch.einsum("blhd,bshd->blsh", qL, kL)
    ws = w * scores
    num = torch.einsum("blsh,bshd->blhd", ws, vL)
    den = torch.sum(ws, dim=2)                                 # (B,L,H)
    # inter-chunk contribution
    scale0 = torch.exp(b + m0[:, None, :] - m_t)
    num = num + scale0[..., None] * torch.einsum("blhd,bhde->blhe", qL, C0)
    den = den + scale0 * torch.einsum("blhd,bhd->blh", qL, n0)
    h = num / torch.maximum(torch.abs(den), _f32(1.0, den.device))[..., None]
    # carry update at the chunk end
    bL = b[:, -1]                                              # (B,H)
    dm = bL[:, None, :] - b + iL                               # (B,L,H)
    m_new = torch.maximum(bL + m0, torch.amax(dm, dim=1))
    wc = torch.exp(dm - m_new[:, None, :])                     # (B,L,H)
    carry = torch.exp(bL + m0 - m_new)
    C_new = carry[..., None, None] * C0 + torch.einsum(
        "blhd,blhe->bhde", wc[..., None] * kL, vL)
    n_new = carry[..., None] * n0 + torch.einsum("blh,blhd->bhd", wc, kL)
    return C_new, n_new, m_new, h


def mlstm_apply_chunked(params, x, state=None, chunk: int = PARALLEL_CHUNK):
    B, S, d = x.shape
    H = params["wq"].shape[-2]
    dh = d // H
    if state is None:
        state = make_mlstm_state(B, H, dh, x.device)
    if S % chunk != 0 or S < chunk:
        return mlstm_apply(params, x, state)

    q, k, v, i_pre, f_pre, o = _mlstm_proj(params, x)
    logf = log_sigmoid(f_pre)                                  # (B,S,H)
    qs, ks, vs = q.float(), k.float(), v.float()
    remat = _needs_grad(qs, ks, vs, i_pre, logf)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for lo in range(0, S, chunk):
        ins = [t[:, lo:lo + chunk] for t in (qs, ks, vs, i_pre, logf)]
        if remat:
            C, n, m, h = checkpoint(_parallel_step, C, n, m, *ins,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            C, n, m, h = _parallel_step(C, n, m, *ins)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, d).to(x.dtype)
    y = h * o.to(x.dtype)
    return _mm(y, params["out_proj"]), {"C": C, "n": n, "m": m}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def slstm_init(gen, d_model: int, n_heads: int, lead=()):
    lead = tuple(lead)
    dh = d_model // n_heads
    dev = gen.device
    r_h = torch.randn(lead + (n_heads, dh, 4 * dh), generator=gen,
                      dtype=torch.float32, device=dev)
    return {
        # input gates pre-acts for (z, i, f, o), computed outside the scan
        "w_x": dense_init(gen, d_model, 4 * d_model, lead,
                          dtype=torch.float32),
        # recurrent, head-block-diagonal: (H, dh, 4*dh)
        "r_h": r_h / math.sqrt(dh),
        "bias": zeros_init(lead + (4 * d_model,), dev, torch.float32),
        "f_bias": torch.full(lead + (n_heads, dh), 3.0, dtype=torch.float32,
                             device=dev),
        "out_proj": dense_init(gen, d_model, d_model, lead),
    }


def make_slstm_state(batch: int, n_heads: int, dh: int, device, lead=()):
    shape = tuple(lead) + (batch, n_heads, dh)
    return {k: torch.zeros(shape, dtype=torch.float32, device=device)
            for k in ("c", "n", "h", "m")}


def _slstm_cell(params, state, wx_t, n_heads, dh):
    """wx_t: (B, 4*d) precomputed input contribution for this step."""
    rec = torch.matmul(state["h"].transpose(0, 1),
                       params["r_h"]).transpose(0, 1)          # (B,H,4dh)
    gates = wx_t.reshape(-1, n_heads, 4 * dh) + rec
    z_pre, i_pre, f_pre, o_pre = torch.split(gates, dh, dim=-1)
    f_pre = f_pre + params["f_bias"]
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    logf = log_sigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    f_act = torch.exp(logf + state["m"] - m_new)
    i_act = torch.exp(i_pre - m_new)
    c = f_act * state["c"] + i_act * z
    n = f_act * state["n"] + i_act
    h = o * c / torch.maximum(n, _f32(1e-6, n.device))
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_apply(params, x, state=None):
    """x: (B, S, d) -> (y, state)."""
    B, S, d = x.shape
    H = params["r_h"].shape[-3]
    dh = d // H
    wx = torch.matmul(x.float(), params["w_x"]) + params["bias"]
    if state is None:
        state = make_slstm_state(B, H, dh, x.device)

    def step(st, xs):
        st = _slstm_cell(params, st, xs[0], H, dh)
        return st, st["h"]

    state, hs = _chunked_cell_scan(step, state, (wx,))
    y = hs.reshape(B, S, d).to(x.dtype)
    return _mm(y, params["out_proj"]), state


def slstm_decode(params, x, state):
    return slstm_apply(params, x, state)
