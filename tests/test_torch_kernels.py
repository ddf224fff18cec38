"""The port's Algorithm-2 gate kernels (K1, K2a, K2b) against the reference.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernels through ``repro.kernels.ops`` in interpret mode.  The
same numpy inputs go through both.  Rows whose cosine lies within
``NEAR`` of cos ξ may land on either side of the threshold under another
summation order, so they are left out of the weight comparison.
Tolerance: float32 reductions of F <= 256 terms in another order, so
``ATOL`` absolute on weights and cotangents (all O(1)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.weighting import instance_weights, xi_to_cos
from repro_torch.kernels import _cuda
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

COS_XI = xi_to_cos(60.0)
NEAR = 1e-6
ATOL = 2e-6
SHAPES = [(3, 64, 8), (5, 256, 256), (2, 37, 8)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _inputs(W, B, F, seed):
    """ad_hoc (B, F) and rings (W, B, F) whose slot-1 rows have cosines
    spread across [-1, 1], so the threshold zeroes some rows and keeps
    others."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, F)).astype(np.float32)
    z = rng.standard_normal((W, B, F)).astype(np.float32)
    mix = rng.uniform(-1.0, 3.0, size=(B, 1)).astype(np.float32)
    z[1] = a * mix + z[1]
    dz = rng.standard_normal((W, B, F)).astype(np.float32)
    return a, z, dz


def _ring(x, dtype):
    """numpy fp32 -> (jax array, torch tensor) in the ring dtype; bf16
    rounding happens once, in JAX, and the torch side takes its bits."""
    _, jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _assert_weights(got, want, margin):
    keep = np.abs(margin - np.float32(COS_XI)) > NEAR
    dev = np.abs(got - want)[keep].max(initial=0.0)
    print(f"w: {keep.sum()} rows compared, max |dev| {dev:.3g}")
    assert dev <= ATOL
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_fused_sample_matches_reference(shape, dtype):
    W, B, F = shape
    a, z, dz = _inputs(W, B, F, seed=W * 1000 + B)
    jz, tz = _ring(z, dtype)
    jdz, tdz = _ring(dz, dtype)
    slot = 1
    jw, jcot = jops.fused_gather_weight(jnp.int32(slot), jnp.asarray(a), jz,
                                        jdz, COS_XI)
    tslot = torch.tensor(slot, dtype=torch.int32)
    tw, tcot = tops.fused_gather_weight(tslot, torch.from_numpy(a), tz, tdz,
                                        COS_XI)
    cos = instance_weights(torch.from_numpy(a), tz[1], -2.0).numpy()
    keep = _assert_weights(tw.numpy(), np.asarray(jw), cos)
    dev = np.abs(tcot.numpy() - np.asarray(jcot))[keep].max(initial=0.0)
    print(f"cot max |dev| {dev:.3g}")
    assert dev <= ATOL
    # weights-only (Party B's call): the reference passes the ring twice
    jw2, _ = jops.fused_gather_weight(jnp.int32(slot), jnp.asarray(a), jdz,
                                      jdz, COS_XI)
    tw2 = tops.fused_gather_weights(tslot, torch.from_numpy(a), tdz, COS_XI)
    cos2 = instance_weights(torch.from_numpy(a), tdz[1], -2.0).numpy()
    _assert_weights(tw2.numpy(), np.asarray(jw2), cos2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_row_gate_matches_reference(shape, dtype):
    W, B, F = shape
    a, z, dz = _inputs(W, B, F, seed=W * 1000 + B + 1)
    jz, tz = _ring(z[1], dtype)
    jd = jnp.asarray(dz[1])
    ja = jnp.asarray(a)
    ta = torch.from_numpy(a)
    cos = instance_weights(ta, tz, -2.0).numpy()
    # K2a: weights and weighted cotangent (the engine passes fp32 dz)
    jw, jcot = jops.weighted_cotangent(ja, jz, jd, COS_XI)
    tw, tcot = tops.weighted_cotangent(ta, tz, torch.from_numpy(dz[1]),
                                       COS_XI)
    keep = _assert_weights(tw.numpy(), np.asarray(jw), cos)
    dev = np.abs(tcot.numpy() - np.asarray(jcot))[keep].max(initial=0.0)
    print(f"cot max |dev| {dev:.3g}")
    assert dev <= ATOL
    # K2b: weights only
    jw2 = jops.cosine_weight(ja, jz, COS_XI)
    tw2 = tops.cosine_weight(ta, tz, COS_XI)
    _assert_weights(tw2.numpy(), np.asarray(jw2), cos)


@pytest.mark.parametrize("staleness", [0, 2])
def test_weighting_module_matches_reference(staleness):
    """``core/weighting.py``: the row cosine over flattened non-batch axes,
    the floored weights and the pipeline attenuation ``w^(1+s)``."""
    from repro.core import weighting as jwt
    from repro_torch.core import weighting as twt
    a, z, _ = _inputs(2, 37, 8, seed=11)
    a3, z3 = a.reshape(37, 2, 4), z[1].reshape(37, 2, 4)
    ta, tz = torch.from_numpy(a3), torch.from_numpy(z3)
    cos = twt.row_cosine(ta, tz).numpy()
    _assert_weights(cos, np.asarray(jwt.row_cosine(a3, z3)), cos)
    jw = jwt.instance_weights(jnp.asarray(a3), jnp.asarray(z3), COS_XI)
    tw = twt.instance_weights(ta, tz, COS_XI)
    keep = _assert_weights(tw.numpy(), np.asarray(jw), cos)
    dev = np.abs(twt.pipeline_attenuation(tw, staleness).numpy()
                 - np.asarray(jwt.pipeline_attenuation(jw, staleness)))
    assert dev[keep].max() <= ATOL
    assert twt.xi_to_cos(60.0) == jwt.xi_to_cos(60.0)


def test_k1_thresholds_some_rows():
    """The inputs above exercise both sides of the gate."""
    a, z, dz = _inputs(5, 256, 256, seed=5256)
    w, _ = tops.fused_gather_weight(torch.tensor(1, dtype=torch.int32),
                                    torch.from_numpy(a), torch.from_numpy(z),
                                    torch.from_numpy(dz), COS_XI)
    frac = float((w == 0).float().mean())
    assert 0.1 < frac < 0.9, frac


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no launch is
    counted (and no CUDA library is built)."""
    _cuda.reset_launches()
    a, z, dz = _inputs(2, 37, 8, seed=0)
    s = torch.tensor(0, dtype=torch.int32)
    tops.fused_gather_weight(s, torch.from_numpy(a), torch.from_numpy(z),
                             torch.from_numpy(dz), COS_XI)
    tops.fused_gather_weights(s, torch.from_numpy(a), torch.from_numpy(z),
                              COS_XI)
    tops.weighted_cotangent(torch.from_numpy(a), torch.from_numpy(z[0]),
                            torch.from_numpy(dz[0]), COS_XI)
    tops.cosine_weight(torch.from_numpy(a), torch.from_numpy(z[0]), COS_XI)
    assert all(v == 0 for v in _cuda.LAUNCHES.values())


# --------------------------------------------------------------------------
# K9: flash attention forward.  The plain version (what the wrapper runs
# on the CPU) against the reference's dense oracle
# (``ref.flash_attention_ref``) and the reference model's blockwise
# online-softmax path (``layers._blockwise_sdpa``, the oracle the JAX
# package names for its Pallas kernel), at the shapes and tolerances of
# tests/test_kernels.py: 2e-4 in float32 (fp32 sums in another order),
# 5e-2 in bfloat16 (the oracle rounds its scores and weights to bf16).
# The Pallas kernel itself does not run in interpret mode under jax 0.9
# (``pl.load`` is gone), as tests/test_kernels.py::test_flash_attention
# shows, so it is not the comparison here.
# --------------------------------------------------------------------------
from repro.kernels import ref as jref                     # noqa: E402
from repro.models import layers as jlayers                # noqa: E402
from repro_torch.kernels import flash_attention as tfa    # noqa: E402


def _qkv(shape, dtype, seed):
    """The same normal draws for both sides; bf16 rounding happens once,
    in JAX, and the torch side takes its bits."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        j = jnp.asarray(rng.normal(size=shape), jnp.dtype(dtype))
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(getattr(torch, dtype))))
    return out


@pytest.mark.parametrize("B,S,H,hd", [(1, 256, 2, 64), (2, 512, 1, 32),
                                      (1, 1024, 2, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0), (False, 128)])
def test_k9_plain_matches_reference_oracles(B, S, H, hd, causal, window):
    qkv = _qkv((B, S, H, hd), "float32", seed=S + hd)
    jq, jk, jv = (x for x, _ in qkv)
    pos = jnp.arange(S, dtype=jnp.int32)
    r = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    bw = jlayers._blockwise_sdpa(jq, jk, jv, pos, pos, causal=causal,
                                 window=window)
    t = tfa.flash_attention(*(x for _, x in qkv), causal=causal,
                             window=window).numpy()
    dev_r, dev_b = (float(np.abs(t - np.asarray(x)).max()) for x in (r, bw))
    print(f"K9 plain vs oracle {dev_r:.3g}, vs blockwise path {dev_b:.3g}")
    assert dev_r <= 2e-4 and dev_b <= 2e-4


def test_k9_plain_bf16_matches_reference_oracle():
    qkv = _qkv((1, 256, 2, 64), "bfloat16", seed=7)
    t = tfa.flash_attention(*(x for _, x in qkv))
    assert t.dtype == torch.bfloat16
    want = jref.flash_attention_ref(*(x for x, _ in qkv))
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 5)])
def test_k9_visible_pairs_counts_the_mask(causal, window):
    """The work K9's bound counts is the mask's: every kept (query, key)
    pair of one head."""
    S = 37
    pos = torch.arange(S)
    kept = int(tfa.visible(pos, pos, causal, window).sum())
    assert tfa.visible_pairs(S, causal, window) == kept


@pytest.mark.parametrize("shape,dtype,window,match", [
    ((1, 128, 2, 48), torch.bfloat16, 0, "head dim"),
    ((1, 128, 2, 16), torch.bfloat16, 0, "head dim"),
    ((1, 100, 2, 64), torch.bfloat16, 0, "multiple of 64"),
    ((1, 128, 2, 64), torch.float16, 0, "bfloat16"),
    ((1, 128, 2, 64), torch.float64, 0, "bfloat16"),
    ((1, 128, 2, 64), torch.bfloat16, -1, "window"),
])
def test_k9_operand_checks(shape, dtype, window, match):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        tfa.check_operands(q, q, q, window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_32_passes_the_operand_checks(dtype):
    """The reduced model's head dim (128 // 4 = 32) is one the kernels
    are built for: K9's, K9-LSE's and K10's checks take it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_bwd as fab
    shape = (2, 3072, 4, get_config("smollm-360m").reduced().head_dim)
    assert shape[3] == 32 and 32 in tfa.HEAD_DIMS
    q = torch.zeros(shape, dtype=dtype)
    lse = torch.zeros((2, 4, 3072))
    tfa.check_operands(q, q, q, 0)
    for name in (fab.DKV_NAME, fab.DQ_NAME):
        fab.check_bwd_operands(name, q, q, q, q.clone(), lse, lse.clone(),
                               0)


def test_k9_cpu_wrapper_launches_nothing():
    _cuda.reset_launches()
    q = torch.randn(1, 64, 2, 32)
    tfa.flash_attention(q, q, q)
    assert all(v == 0 for v in _cuda.LAUNCHES.values())


# --------------------------------------------------------------------------
# K9-LSE and K10: the training forward and the flash-attention backward.
# The plain versions (what the wrappers run on the CPU) under
# ``FlashAttentionFn`` against ``jax.grad`` of the reference's dense
# oracle (``ref.flash_attention_ref``) at the shapes and tolerance of
# tests/test_kernels.py::test_flash_vjp_forward_and_backward (5e-4; the
# reference's Pallas VJP itself fails in interpret mode under jax 0.9);
# against PyTorch's autograd through K9's plain version in fp32 (2e-6:
# the same arithmetic, differentiated by hand); and
# ``torch.autograd.gradcheck`` in fp64.
# --------------------------------------------------------------------------
import jax                                                # noqa: E402

from repro_torch.kernels import flash_attention_bwd as tfab  # noqa: E402

VJP_CASES = [(1, 256, 2, 64, True, 0), (2, 512, 1, 32, True, 128),
             (1, 256, 2, 64, False, 0)]


@pytest.mark.parametrize("B,S,H,hd,causal,window", VJP_CASES)
def test_k10_plain_gradients_match_reference_oracle(B, S, H, hd, causal,
                                                    window):
    qkv = _qkv((B, S, H, hd), "float32", seed=S + hd + int(causal))
    jq, jk, jv = (x for x, _ in qkv)
    tq, tk, tv = (x.requires_grad_(True) for _, x in qkv)
    f_r = lambda *a: jnp.sum(jnp.sin(jref.flash_attention_ref(  # noqa: E731
        *a, causal=causal, window=window)))
    gr = jax.grad(f_r, argnums=(0, 1, 2))(jq, jk, jv)
    o = tops.flash_attention_trainable(tq, tk, tv, causal=causal,
                                       window=window)
    gt = torch.autograd.grad(torch.sin(o).sum(), (tq, tk, tv))
    o_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                     window=window)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               rtol=2e-4, atol=2e-4)
    for a, b, name in zip(gt, gr, "qkv"):
        dev = float(np.abs(a.numpy() - np.asarray(b)).max())
        print(f"d{name}: max |dev| {dev:.3g} (rtol = atol = 5e-4)")
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("B,S,H,hd,causal,window", VJP_CASES)
def test_k10_plain_matches_autograd_of_k9_plain(B, S, H, hd, causal,
                                                window):
    """The hand-written backward against PyTorch's autograd through the
    forward's plain version, both in fp32."""
    rng = np.random.default_rng(S)
    base = [torch.from_numpy(rng.standard_normal((B, S, H, hd))
                             .astype(np.float32)) for _ in range(3)]
    do = torch.from_numpy(rng.standard_normal((B, S, H, hd))
                          .astype(np.float32))
    a = [t.clone().requires_grad_(True) for t in base]
    b = [t.clone().requires_grad_(True) for t in base]
    ga = torch.autograd.grad(tops.flash_attention_trainable(
        *a, causal=causal, window=window), a, do)
    gb = torch.autograd.grad(tfa.flash_attention_plain(
        *b, causal=causal, window=window), b, do)
    for x, y, name in zip(ga, gb, "qkv"):
        dev = float((x - y).abs().max())
        print(f"d{name}: max |dev| {dev:.3g} (limit 2e-6)")
        assert dev <= 2e-6, name


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0), (False, 7)])
def test_k10_gradcheck_fp64(causal, window):
    rng = np.random.default_rng(11)
    qkv = [torch.from_numpy(rng.standard_normal((2, 24, 2, 4)))
           .requires_grad_(True) for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: tops.flash_attention_trainable(
            q, k, v, causal=causal, window=window),
        qkv)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0), (False, 100)])
def test_k9_lse_plain_is_logsumexp_of_masked_scores(causal, window):
    """K9-LSE's plain version: its output is K9's, bitwise, and its lse
    the logsumexp of the masked scaled scores (fp32, 1e-5)."""
    q, k, v = (x for _, x in _qkv((2, 256, 3, 64), "float32", seed=3))
    o, lse = tfa.flash_attention_fwd_lse(q, k, v, causal=causal,
                                         window=window)
    assert torch.equal(o, tfa.flash_attention(q, k, v, causal=causal,
                                              window=window))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(np.float32(64))
    pos = torch.arange(256)
    s = s.masked_fill(~tfa.visible(pos, pos, causal, window), -1e30)
    want = torch.logsumexp(s, dim=-1)
    assert lse.shape == (2, 3, 256) and lse.dtype == torch.float32
    dev = float((lse - want).abs().max())
    print(f"lse max |dev| {dev:.3g} (limit 1e-5)")
    assert dev <= 1e-5


def test_k9_lse_and_k10_take_bf16_and_return_its_dtype():
    qkv = [x.requires_grad_(True)
           for _, x in _qkv((1, 128, 2, 64), "bfloat16", seed=4)]
    o = tops.flash_attention_trainable(*qkv)
    assert o.dtype == torch.bfloat16
    g = torch.autograd.grad(o.float().sum(), qkv)
    assert all(x.dtype == torch.bfloat16 for x in g)


@pytest.mark.parametrize("what,match", [
    ("do_dtype", "do must be"), ("do_shape", "do must be"),
    ("lse_shape", "lse must be"), ("delta_dtype", "delta must be"),
    ("q_dtype", "bfloat16 or float32")])
def test_k10_operand_checks(what, match):
    q = torch.zeros((1, 128, 2, 64))
    do, lse, delta = q.clone(), torch.zeros((1, 2, 128)), \
        torch.zeros((1, 2, 128))
    if what == "do_dtype":
        do = do.to(torch.bfloat16)
    elif what == "do_shape":
        do = torch.zeros((1, 128, 2, 128))
    elif what == "lse_shape":
        lse = torch.zeros((1, 128, 2))
    elif what == "delta_dtype":
        delta = delta.double()
    else:
        q = q.half()
    with pytest.raises(ValueError, match=match):
        tfab.check_bwd_operands(tfab.DKV_NAME, q, q, q, do, lse, delta, 0)


def test_k10_meta_tensors_get_shapes_only():
    q = torch.empty((2, 4096, 15, 64), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((2, 15, 4096), device="meta")
    o, l2 = tfa.flash_attention_fwd_lse(q, q, q)
    dk, dv = tfab.flash_attention_bwd_dkv(q, q, q, q, lse, lse)
    dq = tfab.flash_attention_bwd_dq(q, q, q, q, lse, lse)
    for t in (o, dk, dv, dq):
        assert t.device.type == "meta" and t.shape == q.shape \
            and t.dtype == q.dtype
    assert l2.shape == (2, 15, 4096) and l2.dtype == torch.float32


def test_k10_flops_count_five_products_per_visible_pair():
    """K10's bound: 80.55 GFLOP at (1, 4096, 15, 64) causal, 81.45 us at
    989 TFLOP/s."""
    fl = tfab.flops(1, 4096, 15, 64)
    assert fl == 10 * 64 * 15 * 4096 * 4097 // 2 == 80_550_297_600
    assert abs(fl / 989e12 * 1e6 - 81.45) < 0.01


def test_k9_lse_and_k10_cpu_wrappers_launch_nothing():
    _cuda.reset_launches()
    q = torch.randn(1, 64, 2, 32, requires_grad=True)
    o = tops.flash_attention_trainable(q, q, q)
    torch.autograd.grad(o.sum(), q)
    assert all(v == 0 for v in _cuda.LAUNCHES.values())


# --------------------------------------------------------------------------
# The rounding points of K10's bf16 kernels (csrc/flash_attention_bwd.cu),
# modelled on the CPU: bf16 operands, s and dp as fp32 sums of exact
# products, p and ds in fp32, each taken into its product as bf16 hi + lo
# (hi = bf16(x), lo = bf16(x - hi)), fp32 sums, one rounding of the output
# to bf16.  Every element must lie within chip_smoke's per-element limit
# (|out - ref| <= K10_REL |ref| + K10_ATOL, ref the fp32 plain version
# rounded to bf16), which the card holds the kernels to; with p and ds
# rounded once to bf16, as FlashAttention-2 does, elements must not.
# --------------------------------------------------------------------------
def _chip_smoke():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    return chip_smoke


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _single(x):
    return x.to(torch.bfloat16).float()


def _k10_model(q, k, v, do, lse, delta, causal, window, rnd):
    """K10's gradients with p and ds passed through ``rnd`` before their
    products -> (dk, dv, dq) bf16."""
    B, S, H, hd = q.shape
    dk = torch.zeros((B, H, S, hd))
    dv = torch.zeros_like(dk)
    dq = torch.zeros_like(dk)
    kf = k.float().transpose(1, 2)
    for q0, q1, qt, dot, p, ds in tfab._tiles(q, k, v, do, lse, delta,
                                              causal, window):
        p, ds = rnd(p), rnd(ds)
        dv += torch.matmul(p.transpose(-1, -2), dot)
        dk += torch.matmul(ds.transpose(-1, -2), qt)
        dq[:, :, q0:q1] = torch.matmul(ds, kf)
    return tuple(t.transpose(1, 2).to(torch.bfloat16) for t in (dk, dv, dq))


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 1024, 2, 64), True, 0), ((2, 512, 2, 32), True, 128)])
def test_k10_rounding_design(shape, causal, window):
    cs = _chip_smoke()
    rel, atol = cs.K10_REL["bfloat16"], cs.K10_ATOL["bfloat16"]
    rng = np.random.default_rng(16)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = tfa.flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                               window=window)
    delta = tfab.row_delta(o, do)
    args = (q, k, v, do, lse, delta)
    kw = dict(causal=causal, window=window)
    dk, dv = tfab.flash_attention_bwd_dkv_plain(*args, **kw)
    refs = (dk, dv, tfab.flash_attention_bwd_dq_plain(*args, **kw))

    def worst(outs):
        ratios = []
        for got, ref in zip(outs, refs):
            diff = (got.float() - ref.float()).abs()
            ratios.append(float((diff / (rel * ref.float().abs() + atol))
                                .max()))
        return ratios
    split = worst(_k10_model(*args, causal, window, _split))
    single = worst(_k10_model(*args, causal, window, _single))
    print(f"worst err / limit (dk, dv, dq): hi + lo {split}, "
          f"single rounding {single}")
    assert max(split) <= 1.0
    assert min(single) > 1.0


# --------------------------------------------------------------------------
# The rounding points of K10's fp32 kernels (csrc/flash_attention_bwd.cu,
# flash_bwd_dkv_f32mma / flash_bwd_dq_f32mma), modelled on the CPU: every
# fp32 operand of every product (q, k, v, do; p and ds from fp32) is split
# into three bf16 parts, x = x1 + x2 + x3 with x1 = bf16(x), x2 =
# bf16(x - x1), x3 = bf16(x - x1 - x2), and a b is taken as six bf16
# products, a1 b1 summed apart from a1 b2 + a2 b1 + a1 b3 + a2 b2 + a3 b1,
# in fp32; dk, dv and dq are summed per walked tile of the kernel's rows
# and the tile sums added in fp32.  Every element must lie within
# chip_smoke's fp32 limit (|out - ref| <= K10_REL |ref| + K10_ATOL, ref
# the fp32 plain version); with a single TF32 rounding of each operand,
# or a two-part bf16 split (lo lo dropped), elements must not.
# --------------------------------------------------------------------------
def _bf16_parts(x, n):
    """x -> n bf16 parts as fp32, each the bf16 rounding of what the parts
    before it leave."""
    parts = []
    for _ in range(n):
        parts.append(x.to(torch.bfloat16).float())
        x = x - parts[-1]
    return parts


def _mm_split3(a, b):
    a1, a2, a3 = _bf16_parts(a, 3)
    b1, b2, b3 = _bf16_parts(b, 3)
    small = a1 @ b2 + a2 @ b1 + a1 @ b3 + a2 @ b2 + a3 @ b1
    return a1 @ b1 + small


def _mm_split2(a, b):
    a1, a2 = _bf16_parts(a, 2)
    b1, b2 = _bf16_parts(b, 2)
    return a1 @ b1 + (a1 @ b2 + a2 @ b1)


def _tf32(x):
    """fp32 -> TF32 (10 mantissa bits), rounded half away from zero, as
    cvt.rna.tf32.f32 does."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _k10_f32_model(q, k, v, do, lse, delta, causal, window, mm, tile):
    """K10's fp32 gradients with every product taken by ``mm`` and the
    outputs summed over walked tiles of ``tile`` rows -> (dk, dv, dq)."""
    B, S, H, hd = q.shape
    qf, kf, vf, dof = (t.transpose(1, 2) for t in (q, k, v, do))
    pos = torch.arange(S)
    s = mm(qf, kf.transpose(-1, -2))
    dp = mm(dof, vf.transpose(-1, -2))
    p = torch.where(tfa.visible(pos, pos, causal, window),
                    torch.exp(s * tfa.softmax_scale(hd) - lse[..., None]),
                    0.0)
    ds = p * (dp - delta[..., None]) * tfa.softmax_scale(hd)
    dk, dv, dq = (torch.zeros_like(qf) for _ in range(3))
    for t0 in range(0, S, tile):
        rows = slice(t0, t0 + tile)
        dv += mm(p[..., rows, :].transpose(-1, -2), dof[..., rows, :])
        dk += mm(ds[..., rows, :].transpose(-1, -2), qf[..., rows, :])
        dq += mm(ds[..., :, rows], kf[..., rows, :])
    return tuple(t.transpose(1, 2).contiguous() for t in (dk, dv, dq))


@pytest.mark.parametrize("shape,causal,window,tile", [
    ((1, 1024, 2, 64), True, 0, 32), ((1, 512, 2, 128), True, 0, 16),
    ((2, 512, 2, 32), True, 128, 32)])
def test_k10_f32_split_design(shape, causal, window, tile):
    cs = _chip_smoke()
    rel, atol = cs.K10_REL["float32"], cs.K10_ATOL["float32"]
    rng = np.random.default_rng(16)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)) for _ in range(4))
    x = torch.cat([t.flatten() for t in (q, k, v, do)])
    assert torch.equal(sum(_bf16_parts(x, 3)), x)   # the split is exact
    o, lse = tfa.flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                               window=window)
    delta = tfab.row_delta(o, do)
    kw = dict(causal=causal, window=window)

    def plain(*args):
        return (*tfab.flash_attention_bwd_dkv_plain(*args, **kw),
                tfab.flash_attention_bwd_dq_plain(*args, **kw))
    args = (q, k, v, do, lse, delta)
    refs = plain(*args)
    exact = plain(*(t.double() for t in args))

    def worst(outs, against=refs):
        return [round(float(((got.double() - ref.double()).abs()
                             / (rel * ref.double().abs() + atol)).max()), 3)
                for got, ref in zip(outs, against)]
    model = {name: _k10_f32_model(*args, causal, window, mm, tile)
             for name, mm in (("split3", _mm_split3), ("tf32", _mm_tf32),
                              ("split2", _mm_split2))}
    ratios = {name: worst(out) for name, out in model.items()}
    print(f"worst err / limit (dk, dv, dq) against the fp32 plain version: "
          f"{ratios}; against fp64: three-part split "
          f"{worst(model['split3'], exact)}, the fp32 plain version "
          f"{worst(refs, exact)}")
    assert max(ratios["split3"]) <= 1.0
    assert max(worst(model["split3"], exact)) <= 1.0
    assert min(ratios["tf32"]) > 1.0
    assert min(ratios["split2"]) > 1.0


# --------------------------------------------------------------------------
# The rounding points of K9 / K9-LSE's fp32 kernel (csrc/flash_attention.cu,
# flash_fwd_f32mma), modelled on the CPU: both products take every fp32
# operand (q, k, v; p from fp32) in three bf16 parts, six products each,
# summed in fp32; the online softmax walks key tiles of the kernel's rows
# with the running max, corr and l in fp32 (l from the fp32 p), and each
# tile's share of o is added to acc after acc *= corr.  Every element of o
# must lie within chip_smoke's fp32 limit (K10_REL |ref| + K10_ATOL) and
# every lse within LSE_REL |ref| + LSE_ATOL, against the fp32 plain
# version and against fp64; with a single TF32 rounding of each operand
# (o and lse), or a two-part bf16 split (o), elements must not.
# --------------------------------------------------------------------------
def _k9_f32_model(q, k, v, causal, window, mm, tile):
    """K9-LSE's fp32 forward with both products taken by ``mm`` over key
    tiles of ``tile`` rows -> (o (B, S, H, hd), lse (B, H, S))."""
    B, S, H, hd = q.shape
    qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))
    scale = tfa.softmax_scale(hd)
    pos = torch.arange(S)
    m = torch.full((B, H, S, 1), tfa.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = mm(qf, kt.transpose(-1, -2)) * scale
        s = s.masked_fill(~tfa.visible(pos, pos[k0:k0 + tile], causal,
                                       window), tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm(p, vt)
        m = m_new
    den = l.clamp_min(1e-30)
    return ((acc / den).transpose(1, 2).contiguous(),
            (m + torch.log(den))[..., 0])


@pytest.mark.parametrize("shape,causal,window,tile", [
    ((1, 512, 2, 64), True, 0, 32), ((1, 256, 2, 128), True, 0, 16),
    ((2, 320, 2, 32), True, 100, 32)])
def test_k9_f32_split_design(shape, causal, window, tile):
    cs = _chip_smoke()
    limits = ((cs.K10_REL["float32"], cs.K10_ATOL["float32"]),
              (cs.LSE_REL, cs.LSE_ATOL))
    rng = np.random.default_rng(19)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)) for _ in range(3))
    kw = dict(causal=causal, window=window)
    refs = tfa.flash_attention_fwd_lse_plain(q, k, v, **kw)
    exact = tfa.flash_attention_fwd_lse_plain(q.double(), k.double(),
                                              v.double(), **kw)

    def worst(outs, against=refs):
        return [round(float(((got.double() - ref.double()).abs()
                             / (rel * ref.double().abs() + atol)).max()), 3)
                for got, ref, (rel, atol) in zip(outs, against, limits)]
    model = {name: _k9_f32_model(q, k, v, causal, window, mm, tile)
             for name, mm in (("split3", _mm_split3), ("tf32", _mm_tf32),
                              ("split2", _mm_split2))}
    ratios = {name: worst(out) for name, out in model.items()}
    print(f"worst err / limit (o, lse) against the fp32 plain version: "
          f"{ratios}; against fp64: three-part split "
          f"{worst(model['split3'], exact)}, the fp32 plain version "
          f"{worst(refs, exact)}")
    assert max(ratios["split3"]) <= 1.0
    assert max(worst(model["split3"], exact)) <= 1.0
    assert min(ratios["tf32"]) > 1.0
    assert ratios["split2"][0] > 1.0    # o; its lse stays within


# --------------------------------------------------------------------------
# The split-row path of the cosine gate (csrc/cosine_gate.cu, K1 at the LLM
# cut tensor): pass 1 sums num, aa and zz per (chunk, row) block (each
# thread over its vectors, a vector's products summed apart first, then
# the 32 lanes of a warp by an xor butterfly, then the 8 warps in order);
# pass 2 sums a row's chunk partials the same way, thread t over chunks
# t, t + 256, ..., then the warps' butterflies, then the warps in order.
# Modelled in numpy fp32 at B = 2,
# F = 3,932,160 over a bf16 ring (8-element vectors); the weights must lie
# within chip_smoke's LLM_GATE_TOL of the fp64 cosine.
# --------------------------------------------------------------------------
def _butterfly(x):
    """The xor-shuffle warp sum over the last axis (32 lanes), fp32."""
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., np.arange(32) ^ o]
    return x[..., 0]


def _block_sums(run, threads):
    """(..., threads) per-thread sums -> the block's: each warp's by the
    butterfly, then the warps in order."""
    lanes = _butterfly(run.reshape(run.shape[:-1] + (threads // 32, 32)))
    total = np.zeros(run.shape[:-1], np.float32)
    for w in range(threads // 32):
        total = total + lanes[..., w]
    return total


def _strided_sums(x, threads):
    """(..., n, threads) -> (..., threads): thread t's sequential fp32 sum
    of its terms x[..., i, t]."""
    run = np.zeros(x.shape[:-2] + x.shape[-1:], np.float32)
    for i in range(x.shape[-2]):
        run = run + x[..., i, :]
    return run


def _gate_split_model(a, z, chunks, vec, threads=256):
    """-> (num, aa, zz) per row, summed in the split-row path's order."""
    B, F = a.shape
    n = F // vec
    per = -(-n // chunks)
    iters = -(-per // threads)

    def layout(x):
        x = np.pad(x.reshape(B, n, vec), ((0, 0), (0, chunks * per - n),
                                          (0, 0)))
        x = np.pad(x.reshape(B, chunks, per, vec),
                   ((0, 0), (0, 0), (0, iters * threads - per), (0, 0)))
        return x.reshape(B, chunks, iters, threads, vec)
    av, zv = layout(a), layout(z)
    m = -(-chunks // threads)
    sums = []
    for x, y in ((av, zv), (av, av), (zv, zv)):
        vsum = x[..., 0] * y[..., 0]
        for kk in range(1, vec):
            vsum = vsum + x[..., kk] * y[..., kk]
        part = _block_sums(_strided_sums(vsum, threads), threads)   # pass 1
        part = np.pad(part, ((0, 0), (0, threads * m - chunks)))
        sums.append(_block_sums(_strided_sums(
            part.reshape(B, m, threads), threads), threads))         # pass 2
    return sums


def test_k1_split_row_design():
    from repro_torch.kernels import cosine_weight as tcw
    cs = _chip_smoke()
    W, B, F = cs.LLM_GATE_SHAPE
    assert (B, F) == (2, 4096 * 960)
    # the rule: the narrow path at the paper's shapes and for many rows
    assert tcw.gate_chunks(256, 256) == 1
    assert tcw.gate_chunks(4 * tcw.GATE_SMS, F) == 1
    assert tcw.gate_chunks(2, 2 * tcw.GATE_CHUNK - 1) == 1
    assert tcw.gate_chunks(2, 2 * tcw.GATE_CHUNK) == 2
    for rows, width in ((64, 64 * 960), (3, 1_000_003), (B, F)):
        assert tcw.gate_chunks(rows, width) == -(-width // tcw.GATE_CHUNK)
    chunks = tcw.gate_chunks(B, F)
    assert chunks >= 2 * tcw.GATE_SMS     # some blocks for every SM
    assert tcw.gate_workspace(256, 256, "cpu") is None
    ws = tcw.gate_workspace(B, F, "cpu")
    assert ws.shape == (B, chunks, 3) and ws.dtype == torch.float32

    rng = np.random.default_rng(7)
    a = rng.standard_normal((B, F)).astype(np.float32)
    z = a * np.float32([[0.9], [-0.5]]) \
        + np.float32(0.5) * rng.standard_normal((B, F)).astype(np.float32)
    z = torch.from_numpy(z).to(torch.bfloat16).float().numpy()
    num, aa, zz = _gate_split_model(a, z, chunks, vec=8)
    cos = num / np.maximum(np.sqrt(aa * zz), np.float32(1e-12))
    a64, z64 = a.astype(np.float64), z.astype(np.float64)
    exact = (a64 * z64).sum(1) / np.sqrt((a64 * a64).sum(1)
                                         * (z64 * z64).sum(1))
    thresh = tcw.f32_threshold(COS_XI)
    w = np.where(cos < thresh, 0.0, cos)
    w_exact = np.where(exact < thresh, 0.0, exact)
    print(f"split-row cosines {cos} against fp64 {exact}: |dev| "
          f"{np.abs(cos - exact)}")
    assert np.abs(cos - exact).max() <= cs.LLM_GATE_TOL
    assert np.abs(w - w_exact).max() <= cs.LLM_GATE_TOL
    assert w[0] > 0.5 and w[1] == 0.0


# --------------------------------------------------------------------------
# The rounding points of K9's bf16 kernel (csrc/flash_attention.cu),
# modelled on the CPU: bf16 operands, s = q kᵀ as fp32 sums of exact
# products, the online softmax over key tiles of 64 (the running max, corr
# and the sum l in fp32, l summed from the fp32 p), p taken into p v as
# bf16 hi + lo, fp32 sums, and one rounding of acc / max(l, 1e-30) to
# bf16.  Every element must lie within chip_smoke's per-element limit
# (|out - ref| <= K9_REL_TOL |ref| + K9_ATOL, ref K9-LSE's plain version),
# which the card holds the kernel to; with p rounded once to bf16, as
# FlashAttention-2 does, elements must not.
# --------------------------------------------------------------------------
def _k9_model(q, k, v, causal, window, rnd, tile=64):
    """K9's output with p passed through ``rnd`` before p v -> bf16."""
    B, S, H, hd = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    scale = tfa.softmax_scale(hd)
    pos = torch.arange(S)
    m = torch.full((B, H, S, 1), tfa.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        s = s.masked_fill(~tfa.visible(pos, pos[k0:k0 + tile], causal,
                                       window), tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(rnd(p), vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 1024, 2, 64), True, 0), ((1, 1024, 2, 128), True, 0),
    ((2, 512, 2, 32), True, 128)])
def test_k9_rounding_design(shape, causal, window):
    cs = _chip_smoke()
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    ref, _ = tfa.flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                               window=window)

    def worst(out):
        diff = (out.float() - ref.float()).abs()
        return float((diff / (cs.K9_REL_TOL * ref.float().abs()
                              + cs.K9_ATOL)).max())
    split = worst(_k9_model(q, k, v, causal, window, _split))
    single = worst(_k9_model(q, k, v, causal, window, _single))
    print(f"worst err / limit: hi + lo {split:.3g}, single rounding "
          f"{single:.3g}")
    assert split <= 1.0
    assert single > 1.0


# --------------------------------------------------------------------------
# The kernel library's name hashes the headers the sources include
# (csrc/*.cuh) as well as the sources, so an edited header is rebuilt.
# --------------------------------------------------------------------------
def test_library_path_changes_with_each_header(tmp_path, monkeypatch):
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    headers = _cuda.headers()
    assert headers and all(h.suffix == ".cuh" for h in headers)
    assert all(h.suffix == ".cu" for h in _cuda.sources())
    base = _cuda.library_path()
    for path in headers + _cuda.sources():
        text = path.read_bytes()
        path.write_bytes(text + b"\n")
        assert _cuda.library_path() != base, path.name
        path.write_bytes(text)
        assert _cuda.library_path() == base


# --------------------------------------------------------------------------
# K6 / K11: the ring dequantisers as torch.library ops
# --------------------------------------------------------------------------
def _quant_ring(bits, W=4, B=8, F=960, seed=11):
    from repro_torch.kernels import fused_sample as fs
    from repro_torch.kernels import quantize as qz
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((W * B, F), generator=gen)
    q, s = qz.quantize_sr_plain(x, torch.rand(x.shape, generator=gen),
                                127 if bits == 8 else 7)
    if bits == 4:
        q = fs.pack_nibbles(q)
    return q.reshape(W, B, -1).contiguous(), s.reshape(W, B).contiguous()


@pytest.mark.parametrize("bits", [8, 4])
def test_ring_dequant_ops_equal_their_plain_version_on_cpu(bits):
    from repro_torch.kernels import fused_sample as fs
    name = fs.DEQUANT_NAMES[bits]
    q, s = _quant_ring(bits)
    before = dict(_cuda.LAUNCHES)
    for slot in range(q.shape[0]):
        sl = torch.tensor([slot], dtype=torch.int32)
        want = fs.fused_dequant_plain(bits, sl, q, s)
        assert torch.equal(getattr(torch.ops.repro_torch, name)(sl, q, s),
                           want)
        wrapper = fs.fused_dequant_q8_2d if bits == 8 \
            else fs.fused_dequant_q4_2d
        assert torch.equal(wrapper(sl, q, s), want)
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("bits", [8, 4])
def test_ring_dequant_fake_rule_shapes_and_costs(bits):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import fused_sample as fs
    W, B, P = 4, 8, 960 if bits == 8 else 480
    F = P if bits == 8 else 2 * P
    code = torch.int8 if bits == 8 else torch.uint8
    meta = (torch.empty((1,), dtype=torch.int32, device="meta"),
            torch.empty((W, B, P), dtype=code, device="meta"),
            torch.empty((W, B), device="meta"))
    wrapper = fs.fused_dequant_q8_2d if bits == 8 else fs.fused_dequant_q4_2d
    with _cuda.accounting() as acc:
        out = wrapper(*meta)
        with FakeTensorMode() as mode:
            fake = wrapper(*(mode.from_tensor(torch.zeros(t.shape,
                                                          dtype=t.dtype))
                             for t in meta))
    assert out.shape == fake.shape == (B, F)
    assert out.dtype == fake.dtype == torch.float32
    # one slot's codes and scales read, the fp32 rows written, one
    # multiply an element: the figures the wrapper added before the op
    assert acc.kernels == {fs.DEQUANT_NAMES[bits]: [
        2, 2 * B * F, 2 * (B * P + 4 * B + 4 * B * F)]}


@pytest.mark.parametrize("bits", [8, 4])
def test_ring_dequant_vmap_rule_is_a_loop_of_its_plain_version(bits):
    from repro_torch.kernels import fused_sample as fs
    rings = [_quant_ring(bits, seed=20 + j) for j in range(3)]
    q = torch.stack([r[0] for r in rings])
    s = torch.stack([r[1] for r in rings])
    slots = torch.tensor([[0], [3], [1]], dtype=torch.int32)
    wrapper = fs.fused_dequant_q8_2d if bits == 8 else fs.fused_dequant_q4_2d
    got = torch.func.vmap(wrapper)(slots, q, s)
    for j in range(3):
        assert torch.equal(got[j], fs.fused_dequant_plain(
            bits, slots[j], q[j], s[j]))
