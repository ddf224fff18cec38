"""The port's selective SSM (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``).

At the reduced hymba-1.5b geometry (d 128, d_inner 256, state 16, conv
4) on parameters drawn in JAX and brought across bitwise, the same numpy
inputs go through both, over sequences of two or more ``SCAN_CHUNK``
chunks so that the carry between chunks is exercised.  The reference
scans a chunk with ``lax.associative_scan``, the port with a
Hillis–Steele scan: the two combine the same terms in other trees, so
fp32 results differ in their last bits.  Tolerances, each a few times
the largest deviation measured here:

  * fp32 outputs, states and gradients: ``F32_RTOL`` of the largest
    magnitude (measured: 8.0e-7);
  * bf16 outputs: ``ULPS`` bf16 ulps of the largest magnitude;
  * softplus against ``jax.nn.softplus``: two fp32 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as JS
from repro_torch.bridge import tree_to_torch
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

CFG = jget_config("hymba-1.5b").reduced()
D = CFG.d_model
DI = CFG.ssm.expand * D
N = CFG.ssm.state_dim
F32_RTOL = 1e-5
ULPS = 2
BF16_ULP = 2.0 ** -7
LONG = 2 * JS.SCAN_CHUNK


@pytest.fixture(scope="module")
def params():
    """(jax params, tensors) in the model's dtypes, and an all-fp32
    copy of both."""
    p = JS.mamba_init(jax.random.PRNGKey(0), D, CFG.ssm)
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p)
    def tt(q):
        return tree_to_torch(jax.tree_util.tree_map(np.asarray, q))
    return (p, tt(p)), (p32, tt(p32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _x(S, dtype=np.float32, seed=0, B=2):
    x = np.random.default_rng(seed).standard_normal((B, S, D))
    x = x.astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _ssm_inputs(S, seed=1, B=2):
    """fp32 (xc, dt, B_t, C_t, A, h0) of a plausible scan: dt a softplus
    of small values, A = -(1..N) per channel, a random carry."""
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((B, S, DI)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, DI)) - 2.0))
    bt = rng.standard_normal((B, S, N)).astype(np.float32)
    ct = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (DI, 1))
    h0 = rng.standard_normal((B, DI, N)).astype(np.float32)
    arrs = [xc, dt.astype(np.float32), bt, ct, A, h0]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a)
                                            for a in arrs]


# --------------------------------------------------------------------------
def test_softplus_is_jax_softplus():
    """``logaddexp(x, 0)`` is ``jax.nn.softplus``'s formula: within two
    fp32 ulps everywhere, and the identity far above 20 as jax's is
    (``F.softplus``'s threshold switches at 20)."""
    x = np.linspace(-60, 60, 48_001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TS.softplus(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -22 * np.abs(want))
    assert np.array_equal(got[x > 40], x[x > 40])


@pytest.mark.parametrize("S", [LONG, 3 * JS.SCAN_CHUNK, 64])
def test_selective_ssm_matches_reference(S):
    """The chunked scan with a carry in: y and the last state within
    F32_RTOL over one to three chunks."""
    jin, tin = _ssm_inputs(S)
    jy, jh = JS._selective_ssm(*jin)
    ty, th = TS._selective_ssm(*tin)
    dy, dh = _rel(ty, jy), _rel(th, jh)
    print(f"S={S}: y rel dev {dy:.3g}, h rel dev {dh:.3g} (limit "
          f"{F32_RTOL})")
    assert dy <= F32_RTOL and dh <= F32_RTOL


def test_selective_ssm_asserts_whole_chunks():
    """As the reference, a sequence past one chunk must be a whole
    number of chunks."""
    _, tin = _ssm_inputs(JS.SCAN_CHUNK + 64)
    with pytest.raises(AssertionError):
        TS._selective_ssm(*tin)


def test_ssm_scan_is_the_recurrence():
    """The Hillis–Steele scan against the recurrence run step by step
    (fp64)."""
    rng = np.random.default_rng(2)
    decay = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3, 4)))
    inc = torch.from_numpy(rng.standard_normal((2, 37, 3, 4)))
    cum, h = TS._ssm_scan(decay, inc)
    hh, cc = torch.zeros_like(inc[:, 0]), torch.ones_like(inc[:, 0])
    for t in range(37):
        hh = decay[:, t] * hh + inc[:, t]
        cc = cc * decay[:, t]
        assert torch.allclose(h[:, t], hh, rtol=1e-12, atol=1e-12)
        assert torch.allclose(cum[:, t], cc, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mamba_apply_matches_reference(params, dtype):
    """The block over two chunks: fp32 (activations and parameters)
    within F32_RTOL; bf16 activations with the model's parameters within
    ULPS bf16 ulps."""
    (p, tp), (p32, tp32) = params
    jx, tx = _x(LONG, dtype)
    if dtype == "fp32":
        jy = JS.mamba_apply(p32, jx, CFG.ssm)
        ty = TS.mamba_apply(tp32, tx, CFG.ssm)
        dev, lim = _rel(ty, jy), F32_RTOL
    else:
        jy = JS.mamba_apply(p, jx, CFG.ssm)
        ty = TS.mamba_apply(tp, tx, CFG.ssm)
        assert ty.dtype == torch.bfloat16
        dev = float(np.abs(_np(ty) - _np(jy)).max())
        lim = ULPS * BF16_ULP * float(np.abs(_np(jy)).max())
    print(f"{dtype}: mamba_apply max dev {dev:.3g} (limit {lim:.3g})")
    assert dev <= lim


def test_mamba_gradients_match_reference(params):
    """Gradients of ⟨y, c⟩ with respect to every parameter and x (fp32,
    two chunks: the checkpointed chunks' backward) within F32_RTOL."""
    _, (p32, tp32) = params
    jx, tx = _x(LONG, seed=3, B=1)
    ct = np.random.default_rng(4).standard_normal((1, LONG, D))
    ct = ct.astype(np.float32)
    jg = jax.grad(lambda q, x: jnp.sum(JS.mamba_apply(q, x, CFG.ssm) * ct),
                  argnums=(0, 1))(p32, jx)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp32.items()}
    tx.requires_grad_(True)
    (TS.mamba_apply(leaves, tx, CFG.ssm) * torch.from_numpy(ct)).sum() \
        .backward()
    devs = {k: _rel(leaves[k].grad, jg[0][k]) for k in leaves}
    devs["x"] = _rel(tx.grad, jg[1])
    worst = max(devs, key=devs.get)
    print(f"gradients: worst rel dev {devs[worst]:.3g} ({worst}; limit "
          f"{F32_RTOL})")
    assert all(v <= F32_RTOL for v in devs.values()), devs


def test_chunks_are_checkpointed_under_a_gradient(params, monkeypatch):
    """With a gradient each chunk runs under ``torch.utils.checkpoint``
    (the backward recomputes it), without one it runs plainly; the
    gradient is the one of the plain run."""
    _, (_, tp32) = params
    _, tx = _x(LONG, seed=5, B=1)
    calls = []
    orig = TS.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(TS, "checkpoint", counted)
    with torch.no_grad():
        TS.mamba_apply(tp32, tx, CFG.ssm)
    assert not calls
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp32.items()}
    TS.mamba_apply(leaves, tx, CFG.ssm).sum().backward()
    assert len(calls) == LONG // JS.SCAN_CHUNK
    g_ckpt = {k: v.grad.clone() for k, v in leaves.items()}
    monkeypatch.setattr(TS, "checkpoint",
                        lambda fn, *a, **k: fn(*a))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp32.items()}
    TS.mamba_apply(leaves, tx, CFG.ssm).sum().backward()
    for k in leaves:
        torch.testing.assert_close(leaves[k].grad, g_ckpt[k], rtol=0,
                                   atol=0)


def test_prefill_state_matches_reference(params):
    """The decode cache after a full sequence (the last state and the
    conv tail) against the reference prefill's recomputation."""
    (p, tp), _ = params
    jx, tx = _x(LONG, "bf16", seed=6)
    K = CFG.ssm.conv_dim
    x_in, _ = JS._precompute(p, jx)
    xc = jax.nn.silu(JS._causal_conv(x_in, p["conv_w"])
                     .astype(jnp.float32)).astype(jx.dtype)
    dt, bt, ct = JS._dtbc(p, xc)
    A = -jnp.exp(p["A_log"])
    _, jh = JS._selective_ssm(xc.astype(jnp.float32), dt, bt, ct, A,
                              jnp.zeros((2, DI, N), jnp.float32))
    st = TS.mamba_last_state(tp, tx, CFG.ssm)
    assert st["conv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(st["conv"]),
                                  _np(x_in[:, LONG - (K - 1):]))
    dev = _rel(st["h"], jh)
    print(f"prefill state h: rel dev {dev:.3g} (limit {F32_RTOL})")
    assert dev <= F32_RTOL


def test_decode_continues_prefill(params):
    """Decode steps from the prefill cache (the last state and conv tail
    of a 60-token prefill) against the reference's ``mamba_decode`` from
    the same cache (fp32); the cache is updated in place.  (The
    reference's decode weighs its conv window oldest-first by
    ``conv_w[0..K-1]``, where its full-sequence conv weighs the newest
    input by ``conv_w[0]``, so decode does not reproduce the block run
    over the whole sequence; the port keeps the reference's decode.)"""
    _, (p32, tp32) = params
    S0, steps = 60, 4
    jx, tx = _x(S0 + steps, seed=7)
    cache = TS.make_ssm_cache(2, D, CFG.ssm, "cpu")
    st = TS.mamba_last_state(tp32, tx[:, :S0], CFG.ssm)
    for k in cache:
        cache[k].copy_(st[k])
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    worst = 0.0
    for i in range(steps):
        jy, jcache = JS.mamba_decode(p32, jx[:, S0 + i:S0 + i + 1], jcache,
                                     CFG.ssm)
        ty, cache = TS.mamba_decode(tp32, tx[:, S0 + i:S0 + i + 1], cache,
                                    CFG.ssm)
        worst = max(worst, _rel(ty, jy), _rel(cache["h"], jcache["h"]),
                    _rel(cache["conv"], jcache["conv"]))
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    print(f"{steps} decode steps after a {S0}-token prefill: worst rel "
          f"dev {worst:.3g} (limit {F32_RTOL})")
    assert worst <= F32_RTOL


def test_decode_weighs_the_conv_window_as_the_reference(params):
    """One decode step from a cache of known conv inputs: the port's
    output is the reference's, and differs from the full-sequence block
    over the same inputs exactly as the reference's does."""
    _, (p32, tp32) = params
    jx, tx = _x(4, seed=8, B=1)
    x_in, _ = JS._precompute(p32, jx[:, :3])
    jcache = {"h": jnp.zeros((1, DI, N), jnp.float32), "conv": x_in}
    cache = {"h": torch.zeros((1, DI, N)),
             "conv": torch.from_numpy(np.array(x_in))}
    jy, _ = JS.mamba_decode(p32, jx[:, 3:4], jcache, CFG.ssm)
    ty, _ = TS.mamba_decode(tp32, tx[:, 3:4], cache, CFG.ssm)
    assert _rel(ty, jy) <= F32_RTOL
    jfull = JS.mamba_apply(p32, jx, CFG.ssm)[:, 3:4]
    tfull = TS.mamba_apply(tp32, tx, CFG.ssm)[:, 3:4]
    assert _rel(tfull, jfull) <= F32_RTOL
    gap_j, gap_t = _rel(jy, jfull), _rel(ty, tfull)
    print(f"decode against the block at the 4th token: reference "
          f"{gap_j:.3g}, port {gap_t:.3g}")
    assert abs(gap_j - gap_t) <= F32_RTOL
