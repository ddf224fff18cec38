"""Core transformer layers: RMSNorm, RoPE, GQA attention, gated MLP.

Port of ``repro/models/layers.py``.  Pure
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
    rounding.  Non-causal attention (the audio encoder) takes the same
    kernels with no mask;
  * cross-attention to a memory (the vlm / audio families): queries of
    one length against keys and values projected from a memory of
    another, always through the dense ``_sdpa`` with an all-true mask,
    as in the reference, whatever the lengths;
  * over a device mesh (q, k, v DTensors), the flash kernels run on each
    device's shard (:func:`_flash_local`): batch over the data axes,
    heads over ``model``, the sequence whole;
  * one-token decode against a ring-buffer KV cache, and against
    memory K / V projected once at prefill (:func:`project_memory_kv`).

Decode differs from the reference in two ways.  ``pos`` may differ per
batch row (the serving engine's lanes are the batch), so the cache keeps
one ``slot_pos`` row per batch entry; and the cache is updated in place.
"""
from __future__ import annotations

import math

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


# --------------------------------------------------------------------------
# Activation-sharding hints.  The launch layer installs the data-axis names
# and a ``DeviceMesh`` here; ``shard_batch_dim`` then redistributes dim 0 of
# key activations that are DTensors over the batch axes, as the reference
# pins it with ``with_sharding_constraint``, and ``shard_logits`` the
# logits' batch and vocab dims.  No-ops outside a mesh and on plain tensors.
_BATCH_AXES = None
_BATCH_AXES_SIZE = 1
_VOCAB_AXIS = None
_VOCAB_AXIS_SIZE = 1
_MESH = None


def set_batch_axes(axes, vocab_axis=None, mesh=None):
    """axes: mesh axis names carrying the batch dim (None disables);
    vocab_axis: the mesh axis sharding the logits' vocab dim; mesh: the
    ``DeviceMesh`` the DTensors live on, whose shape gives the axes'
    sizes (without one the hints stay no-ops)."""
    global _BATCH_AXES, _BATCH_AXES_SIZE, _VOCAB_AXIS, _VOCAB_AXIS_SIZE
    global _MESH
    _MESH = mesh if axes else None
    sizes = dict(zip(_MESH.mesh_dim_names, _MESH.shape)) \
        if _MESH is not None else {}
    _BATCH_AXES = tuple(axes) if axes else None
    _BATCH_AXES_SIZE = math.prod(sizes.get(a, 1) for a in _BATCH_AXES) \
        if _BATCH_AXES else 1
    _VOCAB_AXIS = vocab_axis
    _VOCAB_AXIS_SIZE = sizes.get(vocab_axis, 1) if vocab_axis else 1


def _pin(x, parts):
    """Redistribute the DTensor ``x`` to the spec ``parts`` (one axis name,
    tuple or None a dim; the other mesh dims replicate)."""
    from ..sharding.rules import placements
    return x.redistribute(_MESH, placements(_MESH, tuple(parts)))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _mesh_roles(mesh):
    """(the mesh dims that carry the batch, the ``model`` mesh dim or
    None) under the installed hints (the data axes by default; in pure
    data parallelism ``model`` is a batch axis)."""
    names = tuple(mesh.mesh_dim_names)
    axes = _BATCH_AXES or tuple(a for a in names if a in ("pod", "data"))
    bdims = [names.index(a) for a in axes if a in names]
    md = names.index("model") if "model" in names and "model" not in axes \
        else None
    return bdims, md


def _as_dtensor(t, mesh):
    """A plain tensor as a DTensor replicated over ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _roles(mesh, batch_splits: bool, batch, model):
    """Placements over ``mesh``: ``batch`` on its batch dims (Replicate
    where the batch does not split), ``model`` on its model dim,
    Replicate elsewhere."""
    from torch.distributed.tensor import Replicate
    bdims, md = _mesh_roles(mesh)
    return [(batch if batch_splits else Replicate()) if i in bdims
            else model if i == md else Replicate()
            for i in range(mesh.ndim)]


def _batch_splits(mesh, n: int) -> bool:
    bdims, _ = _mesh_roles(mesh)
    size = math.prod(mesh.size(i) for i in bdims)
    return size > 1 and n % size == 0


def _heads_placements(mesh, B: int, H: int):
    """An attention operand (B, S, H, hd): batch over the batch axes and
    heads over ``model`` where they divide, the rest whole."""
    from torch.distributed.tensor import Replicate, Shard
    _, md = _mesh_roles(mesh)
    heads = md is not None and H % mesh.size(md) == 0
    return _roles(mesh, _batch_splits(mesh, B), Shard(0),
                  Shard(2) if heads else Replicate())


def shard_logits(x):
    """Pin (batch, ..., vocab) sharding on the logits, so the loss never
    replicates the vocab dim."""
    if _MESH is None or x.dim() == 0 or not _is_dtensor(x):
        return x
    parts = [None] * x.dim()
    if _BATCH_AXES is not None and _BATCH_AXES_SIZE > 1 \
            and x.shape[0] % _BATCH_AXES_SIZE == 0 \
            and x.shape[0] >= _BATCH_AXES_SIZE:
        parts[0] = _BATCH_AXES if len(_BATCH_AXES) > 1 else _BATCH_AXES[0]
    if _VOCAB_AXIS is not None and _VOCAB_AXIS_SIZE > 1 \
            and x.shape[-1] % _VOCAB_AXIS_SIZE == 0:
        parts[-1] = _VOCAB_AXIS
    if all(p is None for p in parts):
        return x
    return _pin(x, parts)


def shard_batch_dim(x):
    """Pin dim 0 of an activation over the batch axes."""
    if _MESH is None or _BATCH_AXES is None or x.dim() == 0 \
            or _BATCH_AXES_SIZE <= 1 or not _is_dtensor(x):
        return x
    if x.shape[0] % _BATCH_AXES_SIZE != 0 or x.shape[0] < _BATCH_AXES_SIZE:
        return x
    ax = _BATCH_AXES if len(_BATCH_AXES) > 1 else _BATCH_AXES[0]
    return _pin(x, (ax,) + (None,) * (x.dim() - 1))


def embed(table, tokens):
    """``table[tokens]`` for int token ids of any shape.  Over a mesh
    (a DTensor table) the lookup is vocab-parallel, as Megatron's: the
    table's rows stay split over ``model`` (its other splits are
    gathered), each device looks up the ids in its rows and zeroes the
    rest, and the result is a partial sum over ``model``; the ids keep
    their batch split (``local_map``, so the gradient is each device's
    own rows', summed over the batch axes)."""
    if not _is_dtensor(table):
        return table.index_select(0, tokens.reshape(-1)).reshape(
            tuple(tokens.shape) + (table.shape[1],))
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    _, md = _mesh_roles(mesh)
    split = md is not None and table.placements[md] == Shard(0)
    bsplit = _batch_splits(mesh, tokens.shape[0])
    R = Replicate()
    tpl = _roles(mesh, bsplit, R, Shard(0) if split else R)
    ipl = _roles(mesh, bsplit, Shard(0), R)
    opl = _roles(mesh, bsplit, Shard(0), Partial() if split else R)
    # a device sees only its part of the batch: the table's gradient is a
    # partial sum over the batch axes
    tgrad = _roles(mesh, bsplit, Partial(), Shard(0) if split else R)
    off = mesh.get_local_rank(md) * (table.shape[0] // mesh.size(md)) \
        if split else 0

    def local(t, ids):
        if split:
            ids = ids - off
            ok = (ids >= 0) & (ids < t.shape[0])
            ids = torch.where(ok, ids, torch.zeros_like(ids))
        rows = t.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + (t.shape[1],))
        return rows * ok[..., None].to(rows.dtype) if split else rows
    return local_map(local, out_placements=(opl,), in_placements=(tpl, ipl),
                     in_grad_placements=(tgrad, ipl), device_mesh=mesh)(
        table.redistribute(mesh, tpl), tokens.redistribute(mesh, ipl))


class _VocabLSE(torch.autograd.Function):
    """logsumexp over the last (vocab) dim of a DTensor split there: the
    rows' max and the sum of exp(x - max) are reductions of the shards'
    partials; the result and its gradient are placed as ``pl`` (the batch
    split), and the gradient g · exp(x - lse) keeps the logits' layout."""

    @staticmethod
    def forward(ctx, x, pl):
        m = x.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]
        lse = lse.redistribute(x.device_mesh, pl)
        ctx.save_for_backward(x, lse)
        ctx.pl = pl
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        g = g.redistribute(x.device_mesh, ctx.pl)
        return g[..., None] * torch.exp(x - lse[..., None]), None


def logsumexp(x):
    """``torch.logsumexp`` over the last dim; over a mesh (a DTensor, the
    vocab dim split over ``model``) the logits are never gathered
    (:class:`_VocabLSE`)."""
    if not _is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    pl = _roles(mesh, _batch_splits(mesh, x.shape[0]), Shard(0),
                Replicate())
    return _VocabLSE.apply(x, tuple(pl))


def take_label(logits, labels):
    """``logits[..., labels]`` (logits (..., V), labels (...) int).  Over a
    mesh with the vocab dim split over ``model`` each device reads the
    labels in its slice and the result is a partial sum over ``model``
    (Megatron's vocab-parallel loss), so the logits are never gathered."""
    if not _is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    labels = _as_dtensor(labels, mesh)
    _, md = _mesh_roles(mesh)
    last = logits.dim() - 1
    split = md is not None and logits.placements[md] == Shard(last)
    bsplit = _batch_splits(mesh, logits.shape[0])
    R = Replicate()
    lpl = _roles(mesh, bsplit, Shard(0), Shard(last) if split else R)
    ipl = _roles(mesh, bsplit, Shard(0), R)
    opl = _roles(mesh, bsplit, Shard(0), Partial() if split else R)
    off = mesh.get_local_rank(md) * (logits.shape[-1] // mesh.size(md)) \
        if split else 0

    def local(lg, ids):
        ids = ids - off
        ok = (ids >= 0) & (ids < lg.shape[-1])
        got = torch.gather(lg, -1, torch.where(
            ok, ids, torch.zeros_like(ids))[..., None])[..., 0]
        return torch.where(ok, got, torch.zeros_like(got))
    return shard_batch_dim(local_map(
        local, out_placements=(opl,), in_placements=(lpl, ipl),
        device_mesh=mesh)(logits.redistribute(mesh, lpl),
                          labels.redistribute(mesh, ipl)))


def _flash_local(fn, q, k, v):
    """``fn(q, k, v)`` (a flash kernel route, (B, S, H, hd) -> (B, S, H,
    hd)) on each device's shard of the DTensors q, k, v: they are placed
    with the batch dim over the batch axes and the heads over ``model``
    where those divide (else replicated; the sequence is never split, so
    the kernels' masks hold per shard), and ``local_map`` runs ``fn`` on
    the local tensors, so a gradient taken through it runs the kernels'
    backward on the shards too."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    pl = _heads_placements(mesh, q.shape[0], q.shape[2])
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    return local_map(lambda a, b, c: fn(a.contiguous(), b.contiguous(),
                                        c.contiguous()),
                     out_placements=(pl,), in_placements=(pl, pl, pl),
                     device_mesh=mesh)(q, k, v)


def _mm(x, w):
    """``torch.matmul`` with ``jnp``'s promotion: operands of two float
    dtypes are both cast to the wider one (PyTorch refuses the mix).
    Over a mesh (a DTensor operand, w 2-D) the product runs on each
    device's shards (:func:`_mm_local`)."""
    if w.dim() == 2 and (_is_dtensor(x) or _is_dtensor(w)):
        return _mm_local(x, w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w)


def _mm_local(x, w):
    """x (B, ..., k) @ w (k, n) over a mesh, Megatron's layout run on the
    local shards: the batch dim over the batch axes, ``w`` gathered on
    every other mesh dim but ``model``, where it stays split by columns
    (the product's last dim split over ``model``) or by rows (x's last
    dim split there and the product a partial sum over ``model``), or
    whole.  Each gradient is declared as what a device computes: x's a
    partial sum over ``model`` under a column split, w's a partial sum
    over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (w if _is_dtensor(w) else x).device_mesh
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    _, md = _mesh_roles(mesh)
    kind = None
    if md is not None and isinstance(w.placements[md], Shard):
        kind = {1: "col", 0: "row"}[w.placements[md].dim]
    last = x.dim() - 1
    split = _batch_splits(mesh, x.shape[0])
    R = Replicate()

    def pl(batch, col, row, neither):
        return _roles(mesh, split, batch, {"col": col, "row": row,
                                           None: neither}[kind])
    wpl = pl(R, Shard(1), Shard(0), R)
    xpl = pl(Shard(0), R, Shard(last), R)
    opl = pl(Shard(0), Shard(last), Partial(), R)
    xgrad = pl(Shard(0), Partial(), Shard(last), R)
    wgrad = _roles(mesh, split, Partial(), wpl[md] if md is not None else R)

    return local_map(_mm, out_placements=(opl,),
                     in_placements=(xpl, wpl),
                     in_grad_placements=(xgrad, wgrad),
                     device_mesh=mesh)(x.redistribute(mesh, xpl),
                                       w.redistribute(mesh, wpl))


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
    return _mm(x, w.reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def _project_q(params, x):
    q = _proj(x, params["wq"])
    return q + params["bq"] if "bq" in params else q


def project_memory_kv(params, memory):
    """K / V projected from ``memory`` (B, S_mem, d): the self-attention's
    from its own input, the cross-attention's from the other party's Z
    (precomputed once for decode).  -> {"k", "v"}: (B, S_mem, Kv, hd)."""
    k = _proj(memory, params["wk"])
    v = _proj(memory, params["wv"])
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    return {"k": k, "v": v}


def _project_qkv(params, x, kv_src=None):
    kv = project_memory_kv(params, x if kv_src is None else kv_src)
    return _project_q(params, x), kv["k"], kv["v"]


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
    reference.  Over a mesh it runs on each device's shards
    (:func:`_sdpa_local`)."""
    if any(_is_dtensor(t) for t in (q, k, v, mask)):
        return _sdpa_local(q, k, v, mask)
    hd = q.shape[-1]
    scores = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)).float()
    scores = scores / torch.sqrt(_f32(hd, q.device))
    scores = torch.where(mask, scores, _f32(NEG_INF, q.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.matmul(w.to(v.dtype), v.transpose(1, 2))   # (B,H,Q,hd)
    return out.transpose(1, 2)


def _sdpa_local(q, k, v, mask):
    """:func:`_sdpa` over a mesh on each device's shards: batch over the
    batch axes and heads over ``model`` where they divide (the mask
    likewise where it has those dims), the key dim whole, so each
    device's softmax is exact and its gradients its own."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in (q, k, v, mask) if _is_dtensor(t)).device_mesh
    q, k, v, mask = (_as_dtensor(t, mesh) for t in (q, k, v, mask))
    _, md = _mesh_roles(mesh)
    B, H = q.shape[0], q.shape[2]
    qpl = _heads_placements(mesh, B, H)
    heads = md is not None and qpl[md] != Replicate()
    mpl = _roles(mesh, _batch_splits(mesh, B) and mask.shape[0] == B,
                 Shard(0), Shard(1) if heads and mask.shape[1] == H
                 else Replicate())
    out = local_map(_sdpa, out_placements=(qpl,),
                    in_placements=(qpl, qpl, qpl, mpl), device_mesh=mesh)
    return out(*(t.redistribute(mesh, p) for t, p in
                 ((q, qpl), (k, qpl), (v, qpl), (mask, mpl))))


def on_shards(fn, params, *args):
    """``fn(params, *args)`` on each device's part of the batch, the
    parameters gathered whole, over a mesh (any DTensor among the
    parameters or the args); a plain call otherwise.  For blocks that
    run a scan or a recurrence over the sequence (Mamba, mLSTM, sLSTM):
    the tensors of ``args`` (trees allowed) and every tensor ``fn``
    returns lead with the batch dim, which is split over the batch axes
    where it divides and is whole elsewhere.  The parameters' gradients
    are partial sums over the batch axes; an arg updated in place by
    ``fn`` (a decode cache placed so) is updated where it lies."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    leaves, spec = pytree.tree_flatten((params, args))
    dts = [t for t in leaves if isinstance(t, DTensor)]
    if not dts:
        return fn(params, *args)
    mesh = dts[0].device_mesh
    B = next(t.shape[0] for t in pytree.tree_leaves(args)
             if isinstance(t, torch.Tensor))
    split = _batch_splits(mesh, B)
    whole = [Replicate()] * mesh.ndim
    ppl = _roles(mesh, split, Partial(), Replicate())
    apl = _roles(mesh, split, Shard(0), Replicate())
    n_params = len(pytree.tree_leaves(params))
    local = []
    for i, t in enumerate(leaves):
        if not isinstance(t, torch.Tensor):
            local.append(t)
            continue
        t = _as_dtensor(t, mesh)
        if i < n_params:
            local.append(t.redistribute(mesh, whole).to_local(
                grad_placements=ppl))
        else:
            local.append(t.redistribute(mesh, apl).to_local(
                grad_placements=apl))
    p_local, a_local = pytree.tree_unflatten(local, spec)
    out = fn(p_local, *a_local)
    return pytree.tree_map_only(
        torch.Tensor, lambda o: DTensor.from_local(
            o, mesh, apl if o.dim() else whole, run_check=False), out)


def _causal_mask(q_pos, k_pos, window: int):
    """bool (..., Q, K): True where key visible to query."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    m = d >= 0
    if window:
        m &= d < window
    return m


def attention_apply(params, x, *, positions, theta: float = 10000.0,
                    causal: bool = True, window: int = 0, memory=None,
                    memory_positions=None, use_rope: bool = True):
    """Full-sequence attention.  ``positions`` are the tokens' absolute
    positions ``arange(S)`` (the long path's kernels mask by index).
    Self-attention past ``BLOCKWISE_THRESHOLD`` tokens takes the flash
    kernels, and a gradient, when one is taken, goes through K10.  With
    ``memory`` (B, S_mem, d) it is cross-attention: K / V come from the
    memory, no mask, and no rotary embedding on them unless
    ``memory_positions`` are given."""
    n_heads = params["wq"].shape[1]
    q, k, v = _project_qkv(params, x, memory)
    S = x.shape[1]
    if use_rope:
        q = rope(q, positions, theta)
        if memory is None:
            k = rope(k, positions, theta)
        elif memory_positions is not None:
            k = rope(k, memory_positions, theta)
    k = _repeat_kv(k, n_heads)
    v = _repeat_kv(v, n_heads)
    if memory is not None:
        mask = torch.ones((1, 1, S, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(q, k, v, mask)
    elif S > BLOCKWISE_THRESHOLD:
        if S % KV_BLOCK:
            raise ValueError(
                f"a sequence longer than {BLOCKWISE_THRESHOLD} tokens must "
                f"be a multiple of {KV_BLOCK} (the reference's blockwise "
                f"path asserts it), got {S}")
        route = flash_attention_trainable if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)) else flash_attention

        def fn(a, b, c):
            return route(a, b, c, causal=causal, window=window)
        out = _flash_local(fn, q, k, v) if _is_dtensor(q) else fn(q, k, v)
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


def kv_cache_from(k, v, positions, capacity: int):
    """The ring cache that prefill leaves: the last ``capacity`` positions'
    k, v (B, S, Kv, hd), position p in slot p % capacity (the positions
    are ``arange(S)``), empty slots past S.  Built out of place (a
    concatenation or a rotation), so it is a DTensor where k is."""
    B, S = k.shape[:2]
    tail = min(capacity, S)
    tail_pos = positions[S - tail:].to(torch.int32)
    kt, vt = k[:, S - tail:], v[:, S - tail:]
    if tail < capacity:
        # positions 0..S-1 sit in slots 0..S-1
        pad = (B, capacity - tail) + tuple(k.shape[2:])
        kt = torch.cat([kt, kt.new_zeros(pad)], dim=1)
        vt = torch.cat([vt, vt.new_zeros(pad)], dim=1)
        tail_pos = torch.cat([tail_pos, torch.full(
            (capacity - tail,), EMPTY_SLOT, dtype=torch.int32,
            device=tail_pos.device)])
    else:
        # slot (S - tail + j) % capacity holds tail position j
        shift = (S - tail) % capacity
        kt, vt = (torch.roll(t, shift, dims=1) for t in (kt, vt))
        tail_pos = torch.roll(tail_pos, shift, dims=0)
    return {"k": kt.contiguous(), "v": vt.contiguous(),
            "slot_pos": tail_pos.expand(B, capacity).contiguous()}


def ring_write_(buf, val, slot) -> None:
    """``buf[b, slot[b]] = val[b]`` for every row b, in place (buf (B,
    cap, ...), val (B, ...), slot (B,) int).  Over a mesh (a DTensor
    buf) each device writes its own shard: val and slot are placed as
    buf's rows are, and a row whose slot lies in another device's part
    of the capacity dim writes its old value back."""
    if not _is_dtensor(buf):
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf.index_put_((rows, slot.long()), val)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = buf.device_mesh
    vpl, spl, cap_dims = [], [], []
    for i, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == 0:
            vpl.append(p)
            spl.append(p)
        elif isinstance(p, Shard) and p.dim >= 2:
            vpl.append(Shard(p.dim - 1))
            spl.append(Replicate())
        else:
            if isinstance(p, Shard):
                cap_dims.append(i)
            vpl.append(Replicate())
            spl.append(Replicate())

    def placed(t, pl):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, pl).to_local()
    b = buf.to_local()
    v, sl = placed(val, vpl), placed(slot, spl).long()
    off = 0
    for i in cap_dims:      # the capacity dim's split, in mesh order
        off = off * mesh.size(i) + mesh.get_local_rank(i)
    off *= b.shape[1]
    local = sl - off
    ok = (local >= 0) & (local < b.shape[1])
    local = torch.where(ok, local, torch.zeros_like(local))
    rows = torch.arange(b.shape[0], device=b.device)
    old = b[rows, local]
    ok = ok.reshape((-1,) + (1,) * (old.dim() - 1))
    b.index_put_((rows, local), torch.where(ok, v.to(b.dtype), old))


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
    slot = torch.remainder(pos, cap).long()
    ring_write_(cache["k"], k_new[:, 0], slot)
    ring_write_(cache["v"], v_new[:, 0], slot)
    ring_write_(cache["slot_pos"], pos, slot)

    k = _repeat_kv(cache["k"], n_heads)
    v = _repeat_kv(cache["v"], n_heads)
    dist = pos[:, None] - cache["slot_pos"]                # (B, cap)
    valid = dist >= 0
    if window:
        valid &= dist < window
    out = _sdpa(q, k, v, valid[:, None, None, :])
    return _out_proj(out, params["wo"]), cache


def cross_attention_decode(params, x, memory_kv):
    """Decode-time cross-attention of x (B, 1, d) against memory K / V
    projected at prefill (``memory_kv``: {"k", "v"}, (B, S_mem, Kv, hd)):
    no rotary embedding and no mask, as in the reference."""
    n_heads = params["wq"].shape[1]
    q = _project_q(params, x)
    k = _repeat_kv(memory_kv["k"], n_heads)
    v = _repeat_kv(memory_kv["v"], n_heads)
    mask = torch.ones((1, 1, 1, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    return _out_proj(_sdpa(q, k, v, mask), params["wo"])


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
