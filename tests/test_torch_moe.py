"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) against
the reference's (``repro.models.moe``).

At the reduced granite-moe-3b-a800m (4 experts, top-2) and
llama4-scout-17b-a16e (4 experts, top-1, one shared expert) geometries,
on parameters drawn in JAX and brought across bitwise, the same numpy
inputs go through both.  Both route on fp32 logits of the same input, but
their fp32 matrix products sum in other orders, so a token whose top-k
margin (the smallest gap between its k + 1 largest logits) is a few fp32
ulps may route differently; such tokens are counted and printed, and the
routing is asserted exactly on every other token.  Tolerances, each a few
times the largest deviation measured here:

  * bf16 outputs: ``ULPS`` bf16 ulps of the largest magnitude (measured:
    0.02 and 0.04; the experts' bf16 products sum in other orders);
  * fp32 outputs and gradients: ``F32_RTOL`` of the largest magnitude
    (measured: 3.9e-7);
  * the load-balance loss: ``AUX_RTOL`` relative (measured: 0);
  * bf16 gradient leaves: ``GRAD_ULPS`` bf16 ulps of the leaf's largest
    magnitude (measured: 0.99).

The routing asserted exactly is the expert of each assignment on every
token past ``MARGIN``; positions, keep masks and gates (to an fp32 ulp)
are asserted on every assignment of an example none of whose tokens
routes differently (so far every example).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as JM
from repro_torch.bridge import tree_to_torch
from repro_torch.configs import get_config
from repro_torch.models import moe as TM

torch.set_num_threads(1)

ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")
ULPS = 2
GRAD_ULPS = 4
F32_RTOL = 1e-5
AUX_RTOL = 1e-6
MARGIN = 1e-3          # routing asserted exactly on tokens past this margin
BF16_ULP = 2.0 ** -7
B, S = 2, 64


def _cfg(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _params(arch, dtype=None):
    """(jax params, the same tree as tensors); ``dtype`` casts every
    leaf (both sides)."""
    jc, _ = _cfg(arch)
    p = JM.moe_init(jax.random.PRNGKey(0), jc.d_model, jc.d_ff, jc.moe)
    if dtype is not None:
        p = jax.tree_util.tree_map(lambda a: a.astype(dtype), p)
    return p, tree_to_torch(jax.tree_util.tree_map(np.asarray, p))


def _x(d, dtype, seed=0, shape=(B, S)):
    x = np.random.default_rng(seed).standard_normal(shape + (d,))
    x = x.astype(np.float32)
    tdt = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[dtype]
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_route(p, jx, cfg, capacity):
    """The reference's per-example dispatch: (idx, pos, gates, keep) of
    every example, each (B, S·k), and the fp32 router logits."""
    logits = jnp.einsum("bsd,de->bse", jx.astype(jnp.float32), p["router"])
    out = [JM._dispatch_one(jx[b], logits[b], cfg, capacity)[1:]
           for b in range(jx.shape[0])]
    return [np.stack([np.asarray(o[i]) for o in out]) for i in range(4)], \
        logits


def _margins(logits, k):
    """Each token's top-k margin: the smallest gap between its k + 1
    largest logits."""
    top = np.sort(np.asarray(logits), axis=-1)[..., ::-1][..., :k + 1]
    return np.min(top[..., :-1] - top[..., 1:], axis=-1)


def _check_routing(jr, tr, logits, cfg, label):
    """The port's routing equals the reference's on every token past the
    margin, and, in an example where no token routes differently, at
    every assignment; -> the number of tokens within the margin."""
    ji, jp, jg, jk = jr
    ti, tp, tg, tk = (t.numpy() for t in tr)
    k = cfg.top_k
    far = np.repeat(_margins(logits, k) > MARGIN, k, axis=-1)
    near = int((~far).sum() // k)
    assert np.array_equal(ji[far], ti[far]), label
    for b in range(ji.shape[0]):
        if np.array_equal(ji[b], ti[b]):
            assert np.array_equal(jp[b], tp[b]), label
            assert np.array_equal(jk[b], tk[b]), label
            np.testing.assert_allclose(tg[b], jg[b], rtol=1e-6, atol=1e-7)
    print(f"{label}: {near} of {ji.shape[0] * ji.shape[1] // k} tokens "
          f"within the top-{k} margin {MARGIN}; {int((~jk).sum())} of "
          f"{jk.size} assignments dropped")
    return near


# --------------------------------------------------------------------------
def test_capacity_matches_reference():
    for arch in ARCHS:
        jc, tc = _cfg(arch)
        for cfg_j, cfg_t in ((jget_config(arch).moe, get_config(arch).moe),
                             (jc.moe, tc.moe)):
            for seq in (1, 7, 16, 64, 1000, 4096):
                assert TM._capacity(seq, cfg_t) == JM._capacity(seq, cfg_j)
    # granite at full width: C = 1,024 slots an expert at 4,096 tokens
    assert TM._capacity(4096, get_config(ARCHS[0]).moe) == 1024


def test_top_k_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k`` keeps tied values in index order; the port's
    stable sort does the same, whatever ``torch.topk`` would do."""
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 3, (64, 40)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 8)
    tv, ti = TM.top_k(torch.from_numpy(logits), 8)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch):
    """bf16 activations and weights: the routing as the reference's, the
    outputs within ULPS bf16 ulps, the load-balance loss within
    AUX_RTOL."""
    jc, tc = _cfg(arch)
    p, tp = _params(arch)
    jx, tx = _x(jc.d_model, jnp.bfloat16)
    jy, jaux = JM.moe_apply(p, jx, jc.moe)
    ty, taux = TM.moe_apply(tp, tx, tc.moe)
    assert ty.dtype == torch.bfloat16 and ty.shape == (B, S, jc.d_model)
    C = TM._capacity(S, tc.moe)
    jr, logits = _jax_route(p, jx, jc.moe, C)
    _check_routing(jr, TM._route(torch.matmul(tx.float(),
                                                     tp["router"]),
                                        tc.moe, C), logits, tc.moe, arch)
    dev = float(np.abs(_np(ty) - _np(jy)).max())
    lim = ULPS * BF16_ULP * float(np.abs(_np(jy)).max())
    aux_dev = abs(float(taux) - float(jaux)) / abs(float(jaux))
    print(f"{arch}: outputs max |dev| {dev:.3g} (limit {lim:.3g}); aux "
          f"{float(taux):.8g} / {float(jaux):.8g}, rel dev {aux_dev:.3g} "
          f"(limit {AUX_RTOL})")
    assert dev <= lim and aux_dev <= AUX_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_the_reference_assignments(arch):
    """At ``capacity_factor`` 0.25 most assignments overflow their
    expert's slots: the port drops the same ones (gate 0) and keeps the
    same outputs."""
    jc, tc = _cfg(arch)
    jm = dataclasses.replace(jc.moe, capacity_factor=0.25)
    tm = dataclasses.replace(tc.moe, capacity_factor=0.25)
    p, tp = _params(arch, jnp.float32)
    jx, tx = _x(jc.d_model, jnp.float32, seed=1)
    C = TM._capacity(S, tm)
    jr, logits = _jax_route(p, jx, jm, C)
    tr = TM._route(torch.matmul(tx, tp["router"]), tm, C)
    _check_routing(jr, tr, logits, tm, f"{arch} cf 0.25")
    keep = jr[3]
    assert 0 < keep.sum() < 0.5 * keep.size
    jy, _ = JM.moe_apply(p, jx, jm)
    ty, _ = TM.moe_apply(tp, tx, tm)
    assert _rel(ty, jy) <= F32_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_and_combine_one_match_reference(arch):
    """The port's routing, dispatch and combine over a batch of one
    example: the buffer (E, C, d) bitwise the reference's per-example
    one (a copy of the tokens), and the combine of one expert output."""
    jc, tc = _cfg(arch)
    p, tp = _params(arch)
    jx, tx = _x(jc.d_model, jnp.bfloat16, seed=2)
    C = TM._capacity(S, tc.moe)
    jl = jnp.einsum("sd,de->se", jx[0].astype(jnp.float32), p["router"])
    tl = torch.from_numpy(np.array(jl))
    jbuf, *jrest = JM._dispatch_one(jx[0], jl, jc.moe, C)
    fi, fp, fg, kp = TM._route(tl[None], tc.moe, C)
    tbuf = TM._dispatch(tx[:1], fi, fp, kp, tc.moe.n_experts, C)
    trest = [fi[0], fp[0], fg[0], kp[0]]
    np.testing.assert_array_equal(_np(tbuf), _np(jbuf))
    for i, (a, b) in enumerate(zip(jrest, trest)):
        if i == 2:      # the gates: fp32 softmax, an ulp apart
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the combine on the reference's gates: bitwise
    out = np.random.default_rng(3).standard_normal(jbuf.shape)
    jo = JM._combine_one(jnp.asarray(out, jnp.bfloat16), *jrest, S,
                         jc.moe.top_k)
    trest[2] = torch.from_numpy(np.array(jrest[2]))
    to = TM._combine(torch.from_numpy(out.astype(np.float32)).to(
        torch.bfloat16), *(t[None] for t in trest), S, tc.moe.top_k, C)
    np.testing.assert_array_equal(_np(to[0]), _np(jo))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gradients_match_reference(arch, dtype):
    """Gradients of ⟨y, c⟩ + aux with respect to every parameter and x:
    fp32 within F32_RTOL, bf16 within GRAD_ULPS bf16 ulps of each leaf's
    largest magnitude."""
    jc, tc = _cfg(arch)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    p, tp = _params(arch, jnp.float32 if dtype == "float32" else None)
    jx, tx = _x(jc.d_model, jdt, seed=4)
    ct = np.random.default_rng(5).standard_normal((B, S, jc.d_model))
    ct = ct.astype(np.float32)

    def jf(p_, x_):
        y, aux = JM.moe_apply(p_, x_, jc.moe)
        return jnp.sum(y.astype(jnp.float32) * ct) + aux
    jg = jax.grad(jf, argnums=(0, 1))(p, jx)
    leaves = jax.tree_util.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tx.requires_grad_(True)
    y, aux = TM.moe_apply(tp, tx, tc.moe)
    (torch.sum(y.float() * torch.from_numpy(ct)) + aux).backward()
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jg[0])]
    worst = {}
    for path, a, t in zip(paths + ["x"], jax.tree_util.tree_leaves(jg[0])
                          + [jg[1]], leaves + [tx]):
        g = t.grad
        assert g.dtype == t.dtype, path
        if dtype == "float32":
            worst[path] = _rel(g, a)
            assert worst[path] <= F32_RTOL, (path, worst[path])
        else:
            dev = float(np.abs(_np(g) - _np(a)).max())
            worst[path] = dev / (BF16_ULP * float(np.abs(_np(a)).max()))
            assert worst[path] <= GRAD_ULPS, (path, worst[path])
    unit = "of the largest magnitude" if dtype == "float32" else \
        "bf16 ulps"
    print(f"{arch} {dtype}: worst gradient deviation "
          f"{max(worst.values()):.3g} {unit} "
          f"({max(worst, key=worst.get)})")


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_activations_run_the_experts_in_fp32(arch):
    """Party B's ad-hoc ∇Z pass feeds fp32 activations against bf16
    weights: the dispatch buffer takes their dtype and the experts'
    products promote to fp32, as ``jnp`` promotes them."""
    jc, tc = _cfg(arch)
    p, tp = _params(arch)
    jx, tx = _x(jc.d_model, jnp.float32, seed=6)
    jy, jaux = JM.moe_apply(p, jx, jc.moe)
    ty, taux = TM.moe_apply(tp, tx, tc.moe)
    assert jy.dtype == jnp.float32 and ty.dtype == torch.float32
    C = TM._capacity(S, tc.moe)
    fi, fp, _, keep = TM._route(torch.matmul(tx, tp["router"]), tc.moe, C)
    buf = TM._dispatch(tx, fi, fp, keep, tc.moe.n_experts, C)
    assert buf.dtype == torch.float32
    dev = _rel(ty, jy)
    print(f"{arch}: fp32 activations, bf16 weights: rel dev {dev:.3g} "
          f"(limit {F32_RTOL})")
    assert dev <= F32_RTOL
    assert abs(float(taux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))


def test_moe_apply_on_the_meta_device():
    """The budget traces the model on the meta device: the routing and
    the dispatch take no value from the data (granite's full width)."""
    cfg = get_config(ARCHS[0])
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    params = {"router": meta(d, E, dtype=torch.float32),
              "wg": meta(E, d, f), "wu": meta(E, d, f), "wd": meta(E, f, d)}
    y, aux = TM.moe_apply(params, meta(2, 4096, d), cfg.moe)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 4096, d)
    assert y.dtype == torch.bfloat16 and tuple(aux.shape) == ()
