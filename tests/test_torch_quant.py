"""The port's quantisation kernels (K3, K4, K5) and quantised workset
against the reference.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernels through ``repro.kernels.ops`` in interpret mode (and
``repro.kernels.ref`` where its grid cannot tile).  The same numpy inputs,
uniforms included, go through both.

Tolerances: K3 is exact (codes equal, scales bitwise: the same float32
expression in the same order).  K4 and K5 sum F <= 96 float32 products in
another order: 3e-7 on the weights and 3e-6 on the cotangent (relative
and absolute), the reference's own kernel-against-oracle tolerance.  Rows
whose cosine lies within ``NEAR`` of the threshold may land on either
side, so they are left out.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import workset as jws
from repro.kernels import ops as jops
from repro.kernels.ref import quantize_sr_ref
from repro_torch.core import workset as tws
from repro_torch.core.uniforms import UniformKey, insert_key
from repro_torch.kernels import _cuda
from repro_torch.kernels import fused_sample as tfs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tqz
from test_torch_compression import jax_key, jax_uniforms

torch.set_num_threads(1)

THRESH = 0.3
NEAR = 1e-6
W_TOL = dict(rtol=3e-7, atol=3e-7)
COT_TOL = dict(rtol=3e-6, atol=3e-6)


def _xu(T, L, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, L)) * rng.uniform(0.01, 10.0, (T, 1))
         ).astype(np.float32)
    x[0] = 0.0                  # an all-zero tile: the 1e-12 scale floor
    u = rng.uniform(0.0, 1.0, (T, L)).astype(np.float32)
    return x, u


# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------
@pytest.mark.parametrize("levels", [127, 7])
@pytest.mark.parametrize("T,L", [(256, 256), (512, 128), (128, 8),
                                 (4, 128)])
def test_k3_quantize_matches_reference_kernel(T, L, levels):
    x, u = _xu(T, L, seed=T + L + levels)
    jq, js = jops.quantize_stochastic(jnp.asarray(x), jnp.asarray(u), levels)
    tq, ts = tops.quantize_stochastic(torch.from_numpy(x),
                                      torch.from_numpy(u), levels)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert np.abs(tq.numpy()).max() <= levels


@pytest.mark.parametrize("levels", [127, 7])
def test_k3_odd_tile_count_matches_reference_oracle(levels):
    """A T the TPU grid cannot tile goes to the reference's jnp oracle;
    the port's kernel takes any T."""
    x, u = _xu(37, 13, seed=levels)
    jq, js = quantize_sr_ref(jnp.asarray(x), jnp.asarray(u), levels)
    tq, ts = tqz.quantize_sr_2d(torch.from_numpy(x), torch.from_numpy(u),
                                levels)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_k3_operand_checks():
    x = torch.zeros(4, 8)
    tqz.check_operands(x, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="u must be"):
        tqz.check_operands(x, torch.zeros(4, 7))
    with pytest.raises(ValueError, match="x must be"):
        tqz.check_operands(x.double(), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        tqz.check_operands(torch.zeros(8, 4).t(), torch.zeros(4, 8))


# --------------------------------------------------------------------------
# K4 / K5
# --------------------------------------------------------------------------
def _ring_inputs(bits, W, B, F, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, F)).astype(np.float32)
    if bits == 8:
        zq, dzq = (rng.integers(-127, 128, (W, B, F)).astype(np.int8)
                   for _ in range(2))
    else:
        P = (F + 1) // 2
        zq, dzq = (rng.integers(0, 256, (W, B, P)).astype(np.uint8)
                   for _ in range(2))
        if F & 1:   # the storage codec's pad nibble holds code 0 (+8)
            zq, dzq = ((q & 0x0F) | 0x80 for q in (zq, dzq))
    zs, dzs = (np.abs(rng.standard_normal((W, B))).astype(np.float32) + 0.01
               for _ in range(2))
    return a, zq, zs, dzq, dzs


def _keep(a, zq, zs, slot, bits):
    """Rows whose cosine is not within NEAR of the threshold."""
    z = tfs.dequant_rows(torch.from_numpy(zq[slot]),
                         torch.from_numpy(zs[slot]), bits).numpy()
    a = np.pad(a, ((0, 0), (0, z.shape[1] - a.shape[1])))
    cos = (a * z).sum(1) / np.sqrt((a * a).sum(1) * (z * z).sum(1))
    return np.abs(cos - THRESH) > NEAR


@pytest.mark.parametrize("bits,W,B,F", [
    (8, 3, 64, 8), (8, 4, 256, 16), (8, 2, 384, 96),
    (4, 3, 64, 8), (4, 4, 256, 16), (4, 2, 384, 96), (4, 3, 64, 9),
    (4, 4, 128, 33)])
def test_k4_k5_fused_sample_match_reference_kernels(bits, W, B, F):
    a, zq, zs, dzq, dzs = _ring_inputs(bits, W, B, F, seed=bits * W + F)
    jfull = jops.fused_gather_weight_q8 if bits == 8 \
        else jops.fused_gather_weight_q4
    tfull = tops.fused_gather_weight_q8 if bits == 8 \
        else tops.fused_gather_weight_q4
    tw_only = tops.fused_gather_weights_q8 if bits == 8 \
        else tops.fused_gather_weights_q4
    t = [torch.from_numpy(v) for v in (a, zq, zs, dzq, dzs)]
    for slot in (0, W - 1):
        jw, jcot = jfull(jnp.int32(slot), *map(jnp.asarray,
                                               (a, zq, zs, dzq, dzs)),
                         THRESH)
        tslot = torch.tensor(slot, dtype=torch.int32)
        tw, tcot = tfull(tslot, *t, THRESH)
        assert tcot.shape == (B, F)
        keep = _keep(a, zq, zs, slot, bits)
        np.testing.assert_allclose(tw.numpy()[keep], np.asarray(jw)[keep],
                                   **W_TOL)
        np.testing.assert_allclose(tcot.numpy()[keep],
                                   np.asarray(jcot)[keep], **COT_TOL)
        # weights only (Party B): the reference passes the ∇Z ring twice
        jw2, _ = jfull(jnp.int32(slot), *map(jnp.asarray,
                                             (a, dzq, dzs, dzq, dzs)),
                       THRESH)
        tw2 = tw_only(tslot, t[0], t[3], t[4], THRESH)
        keep2 = _keep(a, dzq, dzs, slot, bits)
        np.testing.assert_allclose(tw2.numpy()[keep2],
                                   np.asarray(jw2)[keep2], **W_TOL)


def test_k4_k5_operand_checks():
    a, zq, zs, dzq, dzs = (torch.from_numpy(v)
                           for v in _ring_inputs(8, 3, 16, 8, 0))
    slot = torch.tensor([1], dtype=torch.int32)
    tfs.check_quant_ring(8, slot, a, zq, zs, dzq, dzs)
    tfs.check_quant_ring(8, slot, a, zq, zs, None, None)
    with pytest.raises(ValueError, match="codes must be"):
        tfs.check_quant_ring(4, slot, a, zq, zs, dzq, dzs)
    with pytest.raises(ValueError, match="scales must be"):
        tfs.check_quant_ring(8, slot, a, zq, zs[:, :3], dzq, dzs)
    with pytest.raises(ValueError, match="slot must be"):
        tfs.check_quant_ring(8, slot.long(), a, zq, zs, dzq, dzs)
    with pytest.raises(ValueError, match="even"):
        tfs.check_quant_ring(4, slot, a[:, :7].contiguous(), zq, zs, dzq,
                             dzs)


def test_quant_wrappers_launch_nothing_on_cpu():
    _cuda.reset_launches()
    a, zq, zs, dzq, dzs = (torch.from_numpy(v)
                           for v in _ring_inputs(4, 2, 16, 9, 1))
    s = torch.tensor(0, dtype=torch.int32)
    tops.fused_gather_weight_q4(s, a, zq, zs, dzq, dzs, THRESH)
    tops.quantize_stochastic(a, torch.rand(a.shape), 7)
    assert all(v == 0 for v in _cuda.LAUNCHES.values())


# --------------------------------------------------------------------------
# Nibble packing and the quantised workset
# --------------------------------------------------------------------------
@pytest.mark.parametrize("F", [1, 7, 13, 33])
def test_pack_unpack_nibbles_round_trip_at_odd_widths(F):
    rng = np.random.default_rng(F)
    q = rng.integers(-7, 8, (5, F)).astype(np.int8)
    qp = np.pad(q, ((0, 0), (0, F & 1)))        # the storage codec's pad
    packed = tws.pack_nibbles(torch.from_numpy(qp))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jws.pack_nibbles(qp)))
    back = tws.unpack_nibbles(packed)
    np.testing.assert_array_equal(back.numpy()[:, :F], q)
    np.testing.assert_array_equal(back.numpy()[:, F:], 0)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jws.unpack_nibbles(packed
                                                                .numpy())))


def _entry(rng, B, shape):
    z = (rng.standard_normal((B,) + shape) * 3).astype(np.float32)
    dz = rng.standard_normal((B,) + shape).astype(np.float32)
    x = rng.integers(0, 9, size=(B, 2)).astype(np.int32)
    return {"z": z, "dz": dz, "batch": {"x": x}}


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("shape", [(8,), (9,), (2, 3)])
def test_quantised_workset_matches_reference(cache_dtype, shape):
    """Inserts through K3 with the reference's uniforms: stored codes,
    scales and decoded entries equal the reference's, and so do the table
    bytes of the cut statistics."""
    W, B = 3, 16
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    e0 = _entry(rng, B, shape)
    jw = jws.workset_init(W, jax.tree_util.tree_map(jnp.asarray, e0),
                          cache_dtype=cache_dtype)
    tw = tws.workset_init(W, {"z": torch.from_numpy(e0["z"]),
                              "dz": torch.from_numpy(e0["dz"]),
                              "batch": {"x": torch.from_numpy(
                                  e0["batch"]["x"]).long()}},
                          cache_dtype=cache_dtype)
    for t in range(W + 1):
        e = _entry(rng, B, shape)
        tag = ("insert", t, 0)
        jw = jws.workset_insert(jw, jax.tree_util.tree_map(jnp.asarray, e),
                                t, rng=jax_key(tag))
        tw = tws.workset_insert(
            tw, {"z": torch.from_numpy(e["z"]),
                 "dz": torch.from_numpy(e["dz"]),
                 "batch": {"x": torch.from_numpy(e["batch"]["x"]).long()}},
            t, key=insert_key(jax_uniforms, t, 0))
        for k in ("z", "dz"):
            jl = jax.tree_util.tree_leaves(jw["buf"][k])
            tl = tws.tree_leaves(tw["buf"][k])[0]
            tl = tl.tensors() if tws.is_store(tl) else [tl]
            for a, b in zip(tl, jl, strict=True):
                got = a.float().numpy() if a.dtype == torch.bfloat16 \
                    else a.numpy()
                np.testing.assert_array_equal(
                    got, np.asarray(b.astype(jnp.float32)) if
                    a.dtype == torch.bfloat16 else np.asarray(b))
        slot = torch.tensor(t % W, dtype=torch.int32)
        tentry = tws.workset_entry(tw, slot)
        jentry = jws.workset_entry(jw, jnp.int32(t % W))
        for k in ("z", "dz"):
            assert tentry[k].shape == (B,) + shape
            np.testing.assert_array_equal(tentry[k].numpy(),
                                          np.asarray(jentry[k]))
    assert tws.workset_nbytes(tw, tws.QUANT_KEYS) == \
        jws.workset_nbytes(jw, jws.QUANT_KEYS)


@pytest.mark.parametrize("cache_dtype", tws.CACHE_DTYPES)
def test_sample_hbm_bytes_match_reference(cache_dtype):
    B, F = 256, 255
    jex = {"z": jnp.zeros((B, F)), "dz": jnp.zeros((B, F))}
    tex = {"z": torch.zeros(B, F), "dz": torch.zeros(B, F)}
    for party in ("a", "b"):
        for fused in (True, False):
            assert tws.sample_hbm_bytes(tex, cache_dtype, fused, party) == \
                jws.sample_hbm_bytes(jex, cache_dtype, fused, party)


def test_uniform_key_folds_like_the_reference_key():
    """A key folded in the port names the reference's key folded the same
    way."""
    key = UniformKey(jax_uniforms, ("seed", 3)).fold(1).fold(4)
    want = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(3), 1), 4), (2, 5), jnp.float32)
    np.testing.assert_array_equal(key.uniform((2, 5)).numpy(),
                                  np.asarray(want))
