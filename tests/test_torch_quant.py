"""The port's quantisation kernels (K3, K4, K5, and K6 / K11's thread map)
and quantised workset against the reference.

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
from repro.kernels import fused_sample as jfs
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
    tqz.check_operands(x.bfloat16(), torch.zeros(4, 8))  # widened in K3
    with pytest.raises(ValueError, match="u must be"):
        tqz.check_operands(x, torch.zeros(4, 7))
    with pytest.raises(ValueError, match="u must be"):
        tqz.check_operands(x, torch.zeros(4, 8).bfloat16())
    with pytest.raises(ValueError, match="x must be"):
        tqz.check_operands(x.double(), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        tqz.check_operands(torch.zeros(8, 4).t(), torch.zeros(4, 8))


EPS32 = np.float32(1e-12)


def _k3_two_passes(x, u, levels, chunks, drop=None):
    """A numpy model of K3's split-row path (``csrc/quantize.cu``): pass 1
    takes each (row, chunk)'s |x| max (chunk c holds vectors
    [c * per, min(n, (c + 1) * per)) of a row of n vectors of 4, or of 1
    where L % 4 != 0); pass 2 takes each row's max over its chunks (a max:
    any order), the scale and the codes, in float32.  ``drop`` leaves that
    chunk out of every row's max.  -> (codes, scales, the chunks' element
    bounds)."""
    T, L = x.shape
    kv = 4 if L % 4 == 0 else 1
    n = L // kv
    per = -(-n // chunks)
    bounds = [(min(n, c * per) * kv, min(n, (c + 1) * per) * kv)
              for c in range(chunks)]
    part = np.array([[np.abs(x[r, j0:j1]).max(initial=np.float32(0))
                      for j0, j1 in bounds] for r in range(T)], np.float32)
    if drop is not None:
        part[:, drop] = 0
    amax = part.max(axis=1)
    scale = np.maximum(amax, EPS32) / np.float32(levels)
    q = np.clip(np.floor(x / scale[:, None] + u), -levels, levels)
    return q.astype(np.int8), scale.astype(np.float32), bounds


@pytest.mark.parametrize("levels", [127, 7])
@pytest.mark.parametrize("T,L", [(2, 61_440), (3, 100_003)])
def test_k3_split_row_design(T, L, levels):
    """The split-row rule, and the two passes (chunk maxima, then codes)
    bitwise the plain version and the reference's oracle, with one value
    30x the rest in one chunk of each row: whatever the chunking, and
    a chunk left out moves that row's scale."""
    for shape in ((256, 256), (512, 128), (4 * tqz.QUANT_SMS, 61_440)):
        assert tqz.quant_chunks(*shape) == 1                # narrow
    assert tqz.quant_chunks(4 * tqz.QUANT_SMS - 4, 61_440) == 15
    for width, chunks in ((8_191, 1), (8_192, 2), (61_440, 15),
                          (3_932_160, 960)):
        assert tqz.quant_chunks(2, width) == chunks
    assert tqz.quant_chunks(T, L) >= 2

    rng = np.random.default_rng(T * L + levels)
    x = (rng.standard_normal((T, L)) * rng.uniform(0.5, 4.0, (T, 1))
         ).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (T, L)).astype(np.float32)
    chunks = tqz.quant_chunks(T, L)
    bounds = _k3_two_passes(x, u, levels, chunks)[2]
    hot = rng.integers(0, chunks, T)
    spike = np.float32(30.0) * np.abs(x).max()
    for r, c in enumerate(hot):
        x[r, rng.integers(*bounds[c])] = spike if r % 2 else -spike
    want_q, want_s = tqz.quantize_sr_plain(torch.from_numpy(x),
                                           torch.from_numpy(u), levels)
    ref_q, ref_s = quantize_sr_ref(jnp.asarray(x), jnp.asarray(u), levels)
    for n in (chunks, 2, 7):        # the codes do not depend on the cut
        q, s, _ = _k3_two_passes(x, u, levels, n)
        np.testing.assert_array_equal(q, want_q.numpy())
        np.testing.assert_array_equal(q, np.asarray(ref_q))
        np.testing.assert_array_equal(s.view(np.uint32),
                                      want_s.numpy().view(np.uint32))
        np.testing.assert_array_equal(s.view(np.uint32),
                                      np.asarray(ref_s).view(np.uint32))
    for r, c in enumerate(hot):
        dropped = _k3_two_passes(x, u, levels, chunks, drop=c)[1]
        assert dropped[r] < want_s.numpy()[r]


def _k3_kernel(T, L):
    """The kernel ``csrc/quantize.cu`` launches for (T, L) operands that
    start on 16-byte boundaries (as fresh allocations do): (path, elements
    a thread's vector)."""
    if tqz.quant_chunks(T, L) > 1:
        path = "split"
    else:
        path = "registers" if L <= 512 else "two sweeps"
    return path, 4 if L % 4 == 0 else 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_smoke_shapes_reach_every_kernel(dtype):
    """The card's bitwise K3 checks (``chip_smoke.K3_CHECKED``) launch
    every kernel of ``csrc/quantize.cu`` (each path, with vector and with
    one-element loads), the serving inserts' (C, d) rows among them; and
    at the narrow rows the port's codes and scales equal the reference
    oracle's on the same fp32 or bf16 values."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke as cs
    kernels = {_k3_kernel(T, L) for T, L in cs.K3_CHECKED}
    assert kernels == {(p, v) for p in ("split", "registers", "two sweeps")
                       for v in (4, 1)}
    assert _k3_kernel(*cs.K3_SERVE[0]) == ("two sweeps", 4)
    assert cs.K3_SERVE[0] == cs.SERVE_RING[1:]
    for T, L in cs.K3_CHECKED:
        if T * L > 100_000:
            continue
        x, u = _xu(T, L, seed=T * L)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        xw = xt.float().numpy()
        for levels in (127, 7):
            q, s = tqz.quantize_sr_2d(xt, torch.from_numpy(u), levels)
            rq, rs = quantize_sr_ref(jnp.asarray(xw), jnp.asarray(u), levels)
            np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
            np.testing.assert_array_equal(
                s.numpy().view(np.uint32), np.asarray(rs).view(np.uint32))


def _bf16(a):
    """numpy fp32 -> the same values rounded to bf16, as a torch bf16
    tensor and as exact fp32 numpy."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, t.float().numpy()


@pytest.mark.parametrize("levels,cache_dtype", [(127, "int8"), (7, "int4")])
def test_k3_bf16_rows_match_reference(levels, cache_dtype):
    """bf16 rows go to K3 as they are (the kernel widens them, as the TPU
    kernel does): codes and scales bitwise the reference's Pallas kernel
    (interpret) on the same bf16 values; and a quantised workset insert of
    a bf16 leaf (no fp32 copy made first) stores the reference's codes
    and scales and decodes to its entry."""
    for T, L in ((256, 256), (4, 128)):
        x, u = _xu(T, L, seed=T + levels)
        xt, _ = _bf16(x)
        jq, js = jops.quantize_stochastic(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(u), levels)
        tq, ts = tops.quantize_stochastic(xt, torch.from_numpy(u), levels)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                      np.asarray(js).view(np.uint32))

    W, B, shape = 2, 16, (3, 5)
    rng = np.random.default_rng(levels)
    leaves = [_bf16((rng.standard_normal((B,) + shape) * 3)
                    .astype(np.float32)) for _ in range(2 * (W + 1))]
    x = rng.integers(0, 9, size=(B, 2)).astype(np.int32)

    def entry(i, jax_side):
        z, dz = leaves[2 * i], leaves[2 * i + 1]
        if jax_side:
            return {"z": jnp.asarray(z[1]).astype(jnp.bfloat16),
                    "dz": jnp.asarray(dz[1]).astype(jnp.bfloat16),
                    "batch": {"x": jnp.asarray(x)}}
        return {"z": z[0], "dz": dz[0],
                "batch": {"x": torch.from_numpy(x).long()}}
    jw = jws.workset_init(W, entry(0, True), cache_dtype=cache_dtype)
    tw = tws.workset_init(W, entry(0, False), cache_dtype=cache_dtype)
    for t in range(W + 1):
        jw = jws.workset_insert(jw, entry(t, True), t,
                                rng=jax_key(("insert", t, 0)))
        tw = tws.workset_insert(tw, entry(t, False), t,
                                key=insert_key(jax_uniforms, t, 0))
        for k in ("z", "dz"):
            tl = tws.tree_leaves(tw["buf"][k])[0].tensors()
            jl = jax.tree_util.tree_leaves(jw["buf"][k])
            for a, b in zip(tl, jl, strict=True):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        slot = t % W
        tentry = tws.workset_entry(tw, torch.tensor(slot, dtype=torch.int32))
        jentry = jws.workset_entry(jw, jnp.int32(slot))
        for k in ("z", "dz"):
            assert tentry[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tentry[k].float().numpy(),
                np.asarray(jentry[k].astype(jnp.float32)))


def _ring_dequant_model(bits, slot, zq, zs):
    """The thread map of ``csrc/cosine_gate.cu``'s ``ring_dequant_kernel``
    (K6 / K11): thread e of 256-thread blocks decodes elements
    [kv e, kv (e + 1)) of the row-major (B, F) output (kv = 4 where
    F % 4 == 0, else 1), each its code times its row scale.  -> (the
    output, the writes of each element, each thread's first flat
    offset, the blocks)."""
    _, B, P = zq.shape
    F = P if bits == 8 else 2 * P
    kv = 4 if F % 4 == 0 else 1
    n = B * F // kv
    blocks = -(-n // 256)
    out = np.zeros((B, F), np.float32)
    writes = np.zeros((B, F), np.int64)
    first = []
    for e in range(blocks * 256):
        if e >= n:
            continue
        row, j = divmod(e, F // kv)
        j *= kv
        first.append(row * F + j)
        for col in range(j, j + kv):
            if bits == 8:
                c = int(zq[slot, row, col])
            else:
                b = int(zq[slot, row, col >> 1])
                c = ((b >> 4) if col & 1 else (b & 0xF)) - 8
            out[row, col] = np.float32(c) * zs[slot, row]
            writes[row, col] += 1
    return out, writes, np.array(first), blocks


@pytest.mark.parametrize("bits,F", [(8, 960), (4, 960), (8, 961), (4, 962)])
def test_ring_dequant_thread_map_writes_each_output_once(bits, F):
    """K6 / K11's four-outputs-a-thread map at the serving ring (W, C, F)
    = (4, 8, 960) and at widths that take the one-element variant: every
    output written once, a warp's 32 float4 stores on 512 contiguous
    bytes, and the values bitwise the port's plain version and the
    reference's Pallas kernel (interpret)."""
    W, C, slot = 4, 8, 2
    rng = np.random.default_rng(bits + F)
    P = F if bits == 8 else F // 2
    if bits == 8:
        zq = rng.integers(-127, 128, (W, C, P)).astype(np.int8)
    else:
        zq = rng.integers(0, 256, (W, C, P)).astype(np.uint8)
    zs = np.abs(rng.standard_normal((W, C))).astype(np.float32) + 0.01
    out, writes, first, blocks = _ring_dequant_model(bits, slot, zq, zs)
    assert (writes == 1).all()
    if F % 4 == 0:
        assert blocks == -(-C * F // 1024)
        np.testing.assert_array_equal(first, 4 * np.arange(C * F // 4))
        if F == 960:
            assert (C * F // 4, blocks) == (1920, 8)
    else:
        np.testing.assert_array_equal(first, np.arange(C * F))
    ts = torch.tensor([slot], dtype=torch.int32)
    want = tfs.fused_dequant_plain(bits, ts, torch.from_numpy(zq),
                                   torch.from_numpy(zs))
    jfn = jfs.fused_dequant_q8_2d if bits == 8 else jfs.fused_dequant_q4_2d
    ref = jfn(jnp.asarray([slot], jnp.int32), jnp.asarray(zq),
              jnp.asarray(zs))
    np.testing.assert_array_equal(out.view(np.uint32),
                                  want.numpy().view(np.uint32))
    np.testing.assert_array_equal(out.view(np.uint32),
                                  np.asarray(ref).view(np.uint32))


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
