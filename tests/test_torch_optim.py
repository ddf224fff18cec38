"""The port's fused AdaGrad kernels (K7, K8) and quantised optimizer state
against the reference.

K7's and K8's plain versions (what their wrappers run on a CPU tensor)
take the same numpy inputs as ``repro.kernels.ref`` and the Pallas kernels
of ``repro.kernels.ops`` (interpret mode).  Tolerances:

  * K7: the accumulator ``a + g·g`` is the same two roundings in both
    frameworks, so it is bitwise equal to the ref's; the interpret kernel
    and the update (XLA's division and sqrt) agree within ``RTOL``
    relative.
  * K8: updates and scales within ``RTOL`` relative.  A code is
    ``floor(r'/s' + u)``, so an ulp of difference in r'/s' flips it where
    that sum lies within ``NEAR_INT`` of an integer: codes must be equal
    elsewhere and within one step there (the count is printed).

Then the optimizer: ``optim.quantized`` mirrors every case of
``tests/test_quantized_optim.py`` that has a counterpart (the jit and
sharding cases have none), ``opt_state_nbytes`` equals the reference's
byte counts at WDL-Criteo's full width, and ten steps of
``adagrad(use_pallas=True)`` at fp32 / bf16 / int8 and of ``sm3`` follow
the reference from one bridged state (the int8 state on the reference's
rounding uniforms).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import quantized as JQ
from repro_torch import optim as toptim
from repro_torch.bridge import load_opt_state
from repro_torch.kernels import _cuda as toptim_cuda
from repro_torch.kernels import fused_adagrad as tag
from repro_torch.kernels import ops as tops
from repro_torch.optim import OPT_STATE_DTYPES, adagrad, apply_updates
from repro_torch.optim import quantized as TQ
from test_torch_compression import jax_uniforms

torch.set_num_threads(1)

RTOL = 1e-6
NEAR_INT = 1e-5
LR, EPS = 0.05, 1e-10


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30))
                 .max(initial=0.0))


# --------------------------------------------------------------------------
# K7
# --------------------------------------------------------------------------
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
@pytest.mark.parametrize("n", [1, 37, 1025, 8 * 1024 + 3, 425_984])
def test_k7_plain_matches_reference(n, oracle):
    rng = np.random.default_rng(n)
    g = rng.standard_normal(n).astype(np.float32)
    a = np.abs(rng.standard_normal(n)).astype(np.float32)
    fn = jref.fused_adagrad_ref if oracle == "ref" else jops.fused_adagrad
    ju, ja = fn(jnp.asarray(g), jnp.asarray(a), LR, EPS)
    tu, ta = tag.fused_adagrad(torch.from_numpy(g), torch.from_numpy(a), LR,
                               EPS)
    du, da = _rel(tu, ju), _rel(ta, ja)
    print(f"K7 n={n} vs {oracle}: update rel {du:.3g}, accum rel {da:.3g}")
    assert du <= RTOL
    if oracle == "ref":
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    else:
        assert da <= RTOL


def test_k7_bf16_grad_and_shapes():
    """The ops wrapper takes any shape and a bf16 gradient (upcast), as
    ``tests/test_kernels.py::test_fused_adagrad_bf16_grad``."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((256, 64)).astype(np.float32)
    a = np.abs(rng.standard_normal((256, 64))).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16)
    ju, ja = jref.fused_adagrad_ref(jg, jnp.asarray(a), 0.01, EPS)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).bfloat16()
    tu, ta = tops.fused_adagrad(tg, torch.from_numpy(a), 0.01, EPS)
    assert tu.shape == (256, 64) and tu.dtype == torch.float32
    assert _rel(tu, ju) <= RTOL
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_k7_operand_checks():
    g = torch.zeros(4, 8)
    tag.check_operands(g, torch.zeros(4, 8))
    with pytest.raises(ValueError, match="accum must be"):
        tag.check_operands(g, torch.zeros(32))
    with pytest.raises(ValueError, match="grad must be"):
        tag.check_operands(g.double(), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="grad must be"):
        tag.check_operands(torch.zeros(0), torch.zeros(0))
    with pytest.raises(ValueError, match="contiguous"):
        tag.check_operands(torch.zeros(8, 4).t(), torch.zeros(4, 8))


# --------------------------------------------------------------------------
# K8
# --------------------------------------------------------------------------
def _q8_inputs(R, C, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((R, C)).astype(np.float32)
    q = rng.integers(0, 128, size=(R, C)).astype(np.int8)
    s = rng.uniform(1e-6, 1e-2, size=(R, 1)).astype(np.float32)
    u = rng.uniform(size=(R, C)).astype(np.float32)
    return g, q, s, u


def _near_integer(g, q, s, u, s_new):
    """Where r'/s' + u lies within NEAR_INT of an integer (float64)."""
    r = q.astype(np.float64) * s
    r_new = np.sqrt(r * r + g.astype(np.float64) ** 2)
    x = r_new / np.asarray(s_new, np.float64) + u
    return np.abs(x - np.round(x)) < NEAR_INT


def _check_codes(got, want, near, what):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = got != want
    print(f"{what}: {int(diff.sum())} of {diff.size} codes differ, "
          f"{int(near.sum())} near an integer")
    assert not (diff & ~near).any(), what
    assert np.abs(got - want).max(initial=0) <= 1, what


@pytest.mark.parametrize("oracle", ["ref", "interpret"])
@pytest.mark.parametrize("R,C", [(8, 1), (8, 2), (8, 64), (16, 114),
                                 (32, 1024), (104, 1024), (416, 1024)])
def test_k8_plain_matches_reference(R, C, oracle):
    g, q, s, u = _q8_inputs(R, C, seed=R * 7 + C)
    fn = jref.fused_adagrad_q8_ref if oracle == "ref" \
        else jops.fused_adagrad_q8
    ju, jq, js = fn(*map(jnp.asarray, (g, q, s, u)), LR, EPS)
    tu, tq, ts = tag.fused_adagrad_q8(*map(torch.from_numpy, (g, q, s, u)),
                                      LR, EPS)
    assert tq.dtype == torch.int8 and ts.shape == (R, 1)
    du, ds = _rel(tu, ju), _rel(ts, js)
    print(f"K8 {(R, C)} vs {oracle}: update rel {du:.3g}, scale rel "
          f"{ds:.3g}")
    assert du <= RTOL and ds <= RTOL
    _check_codes(tq.numpy(), jq, _near_integer(g, q, s, u, ts.numpy()),
                 f"K8 {(R, C)} vs {oracle}")


@pytest.mark.parametrize("shape", [(), (37,), (512,), (26 * 1024, 16),
                                   (256, 1)])
def test_k8_flat_gradient_is_the_zero_padded_tiling(shape):
    """The wrapper takes the gradient unpadded: the tail of the (R, C)
    tiling counts as the reference's ``_to2d`` zero pad."""
    rng = np.random.default_rng(len(shape))
    g = rng.standard_normal(shape).astype(np.float32)
    R, C = JQ._tiling(g.size)
    _, q, s, u = _q8_inputs(R, C, seed=3)
    g2d = JQ._to2d(jnp.asarray(g), R, C)
    np.testing.assert_array_equal(
        tag.to2d(torch.from_numpy(g), R, C).numpy(), np.asarray(g2d))
    ju, jq, js = jref.fused_adagrad_q8_ref(g2d, *map(jnp.asarray, (q, s, u)),
                                           LR, EPS)
    tu, tq, ts = tops.fused_adagrad_q8(torch.from_numpy(g),
                                       *map(torch.from_numpy, (q, s, u)),
                                       LR, EPS)
    assert tu.shape == shape
    want = np.asarray(ju).reshape(-1)[:g.size].reshape(shape)
    assert _rel(tu, want) <= RTOL and _rel(ts, js) <= RTOL
    _check_codes(tq.numpy(), jq, _near_integer(np.asarray(g2d), q, s, u,
                                               ts.numpy()), f"K8 {shape}")


def test_k8_operand_checks():
    q = torch.zeros(8, 4, dtype=torch.int8)
    s, u = torch.zeros(8, 1), torch.zeros(8, 4)
    tag.check_q8_operands(torch.zeros(30), q, s, u)
    with pytest.raises(ValueError, match="grad must be"):
        tag.check_q8_operands(torch.zeros(33), q, s, u)
    with pytest.raises(ValueError, match="q must be"):
        tag.check_q8_operands(torch.zeros(30), q.float(), s, u)
    with pytest.raises(ValueError, match="q must be"):
        tag.check_q8_operands(torch.zeros(8),
                              torch.zeros(8, 1025, dtype=torch.int8),
                              s, torch.zeros(8, 1025))
    with pytest.raises(ValueError, match="scale must be"):
        tag.check_q8_operands(torch.zeros(30), q, torch.zeros(8), u)
    with pytest.raises(ValueError, match="u must be"):
        tag.check_q8_operands(torch.zeros(30), q, s, torch.zeros(8, 5))
    with pytest.raises(ValueError, match="contiguous"):
        tag.check_q8_operands(torch.zeros(30), q, s,
                              torch.zeros(4, 8).t())


def test_k8_zero_state_first_step():
    """From the all-zero state the first update equals plain AdaGrad's
    first update (dequantised zero codes are zero)."""
    g = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    tu, _, _ = tag.fused_adagrad_q8(torch.from_numpy(g),
                                    torch.zeros(8, 64, dtype=torch.int8),
                                    torch.zeros(8, 1), torch.zeros(8, 64),
                                    0.1, EPS)
    ju, _ = jref.fused_adagrad_ref(jnp.asarray(g), jnp.zeros((8, 64)), 0.1,
                                   EPS)
    assert _rel(tu, ju) <= RTOL


# --------------------------------------------------------------------------
# The list step: one launch for a party's leaves, applied in place
# --------------------------------------------------------------------------
def _keyed(tag, shape):
    """A uniform source keyed by the tag alone (two routes draw alike)."""
    gen = torch.Generator().manual_seed(zlib.crc32(repr(tag).encode()))
    return torch.rand(tuple(shape), generator=gen)


@pytest.fixture(scope="module")
def wdl_leaves():
    """WDL-Criteo's parameter shapes of each party, full width, in the
    reference's leaf order."""
    from repro_torch.bridge import reference_parameters
    from repro_torch.configs import get_config
    from repro_torch.models.tabular import make_dlrm
    cfg = get_config("wdl-criteo")
    params = make_dlrm(cfg)[0](0, cfg, "cpu")
    return {k: [tuple(p.shape) for p in reference_parameters(params[k])]
            for k in ("a", "b")}


def _leaf_list(shapes, seed, param_dtype):
    rng = np.random.default_rng(seed)
    params = [torch.from_numpy(np.asarray(rng.standard_normal(s),
                                          np.float32)).to(param_dtype)
              for s in shapes]
    grads = [[torch.from_numpy(np.asarray(rng.standard_normal(s) * 0.1,
                                          np.float32)).to(param_dtype)
              for s in shapes] for _ in range(2)]
    return params, grads


def _parent_route(state_dtype, params, state, grads, scale, lr, t):
    """The engine's AdaGrad route before the list step, per leaf: the
    update (``ops.fused_adagrad`` on ``grad.float()``, the bf16 state
    upcast around it; ``ops.fused_adagrad_q8`` on the noise of
    ``("optim", t, i)``), then ``u * scale``, then ``p.add_(u)``."""
    new = []
    for i, (g, a, p) in enumerate(zip(grads, state["accum"], params)):
        if state_dtype == "int8":
            noise = _keyed(("optim", t, i), a.q.shape)
            u, q, sc = tag.fused_adagrad_q8_plain(g.float().contiguous(),
                                                  a.q, a.scale, noise, lr,
                                                  EPS)
            new.append(TQ.QuantAccum(q, sc, a.shape))
        else:
            u, a_new = tag.fused_adagrad_plain(g.float().contiguous(),
                                               a.float(), lr, EPS)
            new.append(a_new.to(a.dtype))
        if scale is not None:
            u = u * scale
        with torch.no_grad():
            p.add_(u)
    return new


def _state_tensors(state):
    out = []
    for e in state["accum"]:
        out += [e.q, e.scale] if isinstance(e, TQ.QuantAccum) else [e]
    return out


@pytest.mark.parametrize("mask", [None, 0.0, 1.0])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("party", ["a", "b"])
def test_list_step_plain_is_bitwise_the_per_leaf_route(
        party, param_dtype, state_dtype, mask, wdl_leaves):
    """AdaGrad's in-place ``step`` (the list step's plain version on the
    CPU) over WDL-Criteo's real leaf lists, two updates, equals the
    parent's per-leaf route (update, scale, ``apply_updates``) bit for
    bit: parameters, accumulators, codes and scales."""
    lr = 0.01
    opt = adagrad(lr, EPS, use_pallas=True, state_dtype=state_dtype,
                  uniforms=_keyed)
    params, grads = _leaf_list(wdl_leaves[party], 7, param_dtype)
    ref_params = [p.clone() for p in params]
    state = opt.init(params)
    ref = {"accum": [TQ.QuantAccum(a.q.clone(), a.scale.clone(), a.shape)
                     if state_dtype == "int8" else a.clone()
                     for a in state["accum"]]}
    scale = None if mask is None else torch.tensor(mask)
    for t, g in enumerate(grads):
        out = opt.step(g, state, params, scale)
        assert out is state
        ref["accum"] = _parent_route(state_dtype, ref_params, ref, g, scale,
                                     lr, t)
    if state_dtype == "int8":
        assert state["t"] == 2
    for got, want in zip(params + _state_tensors(state),
                         ref_params + _state_tensors(ref), strict=True):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_k7_list_matches_reference_per_leaf(oracle):
    """The list kernel's updates and accumulators, leaf by leaf, against
    JAX's K7 (``ref.py`` and the Pallas kernel in interpret mode) within
    the one-leaf tolerances; the in-place step moves each parameter by
    that update."""
    rng = np.random.default_rng(3)
    shapes = [(64, 16), (512,), (), (37,), (9, 1031)]
    g = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    a = [np.asarray(np.abs(rng.standard_normal(s)), np.float32)
         for s in shapes]
    fn = jref.fused_adagrad_ref if oracle == "ref" else jops.fused_adagrad
    tu, ta = tag.fused_adagrad_list([torch.from_numpy(x) for x in g],
                                    [torch.from_numpy(x) for x in a], LR,
                                    EPS)
    params = [torch.zeros(s) for s in shapes]
    accums = [torch.from_numpy(x.copy()) for x in a]
    tag.fused_adagrad_step_([torch.from_numpy(x) for x in g], accums,
                            params, LR, EPS)
    for i, s in enumerate(shapes):
        ju, ja = fn(jnp.asarray(g[i]), jnp.asarray(a[i]), LR, EPS)
        assert tu[i].shape == s and _rel(tu[i], ju) <= RTOL
        assert torch.equal(params[i], tu[i])
        if oracle == "ref":
            np.testing.assert_array_equal(ta[i].numpy(), np.asarray(ja))
            np.testing.assert_array_equal(accums[i].numpy(), np.asarray(ja))
        else:
            assert _rel(ta[i], ja) <= RTOL


@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_k8_list_matches_reference_per_leaf(oracle):
    """The int8 list kernel, leaf by leaf in each leaf's tiling, against
    JAX's K8 within the one-leaf tolerances (codes off by one step only
    where r'/s' + u sits at an integer); the step writes the same codes
    and scales in place."""
    rng = np.random.default_rng(4)
    shapes = [(), (37,), (512,), (26 * 64, 16)]
    fn = jref.fused_adagrad_q8_ref if oracle == "ref" \
        else jops.fused_adagrad_q8
    ins = []
    for k, shape in enumerate(shapes):
        g = np.asarray(rng.standard_normal(shape) * 0.1, np.float32)
        R, C = JQ._tiling(g.size)
        ins.append((g,) + _q8_inputs(R, C, seed=k)[1:])
    tu, tq, ts = tag.fused_adagrad_q8_list(
        *[[torch.from_numpy(x[j]) for x in ins] for j in range(4)], LR, EPS)
    qs = [torch.from_numpy(x[1].copy()) for x in ins]
    ss = [torch.from_numpy(x[2].copy()) for x in ins]
    params = [torch.zeros(s) for s in shapes]
    tag.fused_adagrad_q8_step_([torch.from_numpy(x[0]) for x in ins], qs,
                               ss, [torch.from_numpy(x[3]) for x in ins],
                               params, LR, EPS)
    for i, (g, q, s, u) in enumerate(ins):
        R, C = q.shape
        g2d = JQ._to2d(jnp.asarray(g), R, C)
        ju, jq, js = fn(g2d, *map(jnp.asarray, (q, s, u)), LR, EPS)
        want = np.asarray(ju).reshape(-1)[:g.size].reshape(g.shape)
        assert tu[i].shape == g.shape and _rel(tu[i], want) <= RTOL
        assert _rel(ts[i], js) <= RTOL
        _check_codes(tq[i].numpy(), jq, _near_integer(
            np.asarray(g2d), q, s, u, ts[i].numpy()), f"K8 list leaf {i}")
        assert torch.equal(qs[i], tq[i]) and torch.equal(ss[i], ts[i])
        assert torch.equal(params[i], tu[i])


def _blocks(table, rows=None):
    """The kernel's walk over one table, in Python: -> [(leaf, first,
    last)] element ranges a block, each block finding its leaf by binary
    search over the prefix sum (K8: the row's elements, ``rows`` giving
    each leaf's C)."""
    n, start = table.n_leaves, list(table.start)
    out = []
    for b in range(start[n]):
        lo, hi = 0, n - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if start[mid] <= b else (lo, mid - 1)
        k = b - start[lo]
        if rows is None:
            chunk = toptim_cuda.ADAGRAD_CHUNK
            first = k * chunk
            out.append((lo, first, min(first + chunk, table.leaf[lo].n)))
        else:
            out.append((lo, k * rows[lo], (k + 1) * rows[lo]))
    return out


def _ragged(n_leaves, seed):
    """Leaves of 1 to 70,000 elements (and about a chunk), every third a
    view one element into its storage (not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    sizes = [1, 2, 3, 1023, 1024, 1025, 4097] + [
        int(x) for x in rng.integers(1, 70_000, n_leaves - 7)]
    return [torch.zeros(n + 1)[1:] if i % 3 == 1 else torch.zeros(n)
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("which", ["wdl a", "wdl b", "ragged"])
def test_k7_tables_cover_every_element_once(which, wdl_leaves):
    """The K7 table builder: each launch holds at most the capacity's
    leaves in the list's order (a 100-leaf list takes three launches),
    the blocks cover every element of every leaf exactly once, and only
    the leaves whose four pointers are all 16-byte aligned take the
    vector path; bf16 operands are flagged."""
    cap = toptim_cuda.ADAGRAD_LEAVES
    if which == "ragged":
        grads = _ragged(100, 5)
        params = [torch.zeros(g.shape, dtype=torch.bfloat16) for g in grads]
    else:
        grads = [torch.zeros(s) for s in wdl_leaves[which[-1]]]
        params = [torch.zeros(s) for s in wdl_leaves[which[-1]]]
    accums = [torch.zeros(g.shape) for g in grads]
    tables = tag.k7_tables(grads, accums, accums, params)
    assert len(tables) == -(-len(grads) // cap)
    assert [t.n_leaves for t in tables] == [
        min(cap, len(grads) - i * cap) for i in range(len(tables))]
    seen = [np.zeros(g.numel(), np.int64) for g in grads]
    for j, t in enumerate(tables):
        for k in range(t.n_leaves):
            i = j * cap + k
            e = t.leaf[k]
            assert (e.g, e.a, e.a_out, e.dst, e.n) == (
                grads[i].data_ptr(), accums[i].data_ptr(),
                accums[i].data_ptr(), params[i].data_ptr(), grads[i].numel())
            aligned = all(x.data_ptr() % 16 == 0
                          for x in (grads[i], accums[i], params[i]))
            assert bool(e.flags & tag.ALIGNED) == aligned
            assert bool(e.flags & tag.DST_BF16) == (
                params[i].dtype == torch.bfloat16)
            assert not e.flags & (tag.GRAD_BF16 | tag.ACCUM_BF16)
        for k, lo, hi in _blocks(t):
            seen[j * cap + k][lo:hi] += 1
    assert all((s == 1).all() for s in seen)
    if which == "ragged":
        flags = [t.leaf[k].flags & tag.ALIGNED for t in tables
                 for k in range(t.n_leaves)]
        assert 0 < sum(map(bool, flags)) < len(flags)


@pytest.mark.parametrize("which", ["wdl a", "wdl b", "ragged"])
def test_k8_tables_cover_every_row_once(which, wdl_leaves):
    """The K8 table builder: leaves in the list's order, at most the
    capacity a launch, one block for every row of every leaf's tiling,
    exactly once; the gradient's element count and the row width as the
    tiling says."""
    cap = toptim_cuda.ADAGRAD_LEAVES
    if which == "ragged":
        grads = _ragged(100, 6)
    else:
        grads = [torch.zeros(s) for s in wdl_leaves[which[-1]]]
    accs = [TQ.quant_accum_init(g) for g in grads]
    qs, ss = [a.q for a in accs], [a.scale for a in accs]
    noises = [torch.zeros(q.shape) for q in qs]
    params = [torch.zeros(g.shape) for g in grads]
    tables = tag.k8_tables(grads, qs, ss, qs, ss, noises, params)
    assert len(tables) == -(-len(grads) // cap)
    seen = [np.zeros(q.numel(), np.int64) for q in qs]
    for j, t in enumerate(tables):
        for k in range(t.n_leaves):
            i = j * cap + k
            e = t.leaf[k]
            assert (e.g, e.q, e.s, e.noise, e.dst) == (
                grads[i].data_ptr(), qs[i].data_ptr(), ss[i].data_ptr(),
                noises[i].data_ptr(), params[i].data_ptr())
            assert (e.n, e.C) == (grads[i].numel(), qs[i].shape[1])
            assert e.C <= toptim_cuda.ADAGRAD_MAX_COLS
        widths = [t.leaf[k].C for k in range(t.n_leaves)]
        for k, lo, hi in _blocks(t, widths):
            seen[j * cap + k][lo:hi] += 1
    assert all((s == 1).all() for s in seen)


def test_tables_fit_the_kernel_parameter_limit():
    """A table travels by value as a kernel parameter: with the launch's
    other parameters it stays under the classic 4 KB limit."""
    import ctypes
    for table in (toptim_cuda.K7Table, toptim_cuda.K8Table):
        assert ctypes.sizeof(table) + 32 <= 4096
    assert toptim_cuda.ADAGRAD_LEAVES >= 20     # a WDL party in one launch


def test_step_operand_checks():
    g = [torch.zeros(4, 8), torch.zeros(3)]
    a = [torch.zeros(4, 8), torch.zeros(3, dtype=torch.bfloat16)]
    p = [torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(3)]
    tag.check_step_operands(g, a, p, torch.tensor(1.0))
    with pytest.raises(ValueError, match="parameter must be"):
        tag.check_step_operands(g, a, [p[0], torch.zeros(4)])
    with pytest.raises(ValueError, match="parameters"):
        tag.check_step_operands(g, a, p[:1])
    with pytest.raises(ValueError, match="scale must be"):
        tag.check_step_operands(g, a, p, torch.ones(1))
    with pytest.raises(ValueError, match="accum must be"):
        tag.check_step_operands(g, [a[0], torch.zeros(3).double()], p)
    accs = [TQ.quant_accum_init(x) for x in g]
    noises = [torch.zeros(x.q.shape) for x in accs]
    tag.check_q8_step_operands(g, [x.q for x in accs],
                               [x.scale for x in accs], noises, p)
    with pytest.raises(ValueError, match="unequal length"):
        tag.check_q8_step_operands(g, [x.q for x in accs],
                                   [x.scale for x in accs], noises[:1], p)


# --------------------------------------------------------------------------
# Tiling, init, dequant, byte counts
# --------------------------------------------------------------------------
WDL_LEAVES = [(26 * 1024, 16), (512,), (416, 512), (256,), (512, 256),
              (256,), (256, 256), (13 * 1024, 16), (13 * 1024, 1), ()]


def test_tiling_matches_reference():
    for n in range(1, 20_001):
        assert TQ._tiling(n) == JQ._tiling(n), n
    for shape in WDL_LEAVES:
        n = int(np.prod(shape))
        assert TQ._tiling(n) == JQ._tiling(n), shape


@pytest.mark.parametrize("shape", WDL_LEAVES + [(3, 5, 7), (1,)])
def test_quant_accum_init_and_dequant_match_reference(shape):
    j = JQ.quant_accum_init(jnp.zeros(shape))
    t = TQ.quant_accum_init(torch.zeros(shape))
    assert t.q.shape == j.q.shape and t.q.dtype == torch.int8
    assert t.scale.shape == j.scale.shape and t.shape == j.shape
    assert t.nbytes == j.nbytes
    assert not t.q.any() and not t.scale.any()
    R, C = j.q.shape
    _, q, s, _ = _q8_inputs(R, C, seed=R + C)
    want = JQ.QuantAccum(jnp.asarray(q), jnp.asarray(s), shape).dequant()
    got = TQ.QuantAccum(torch.from_numpy(q), torch.from_numpy(s),
                        shape).dequant()
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Bytes of one party's optimizer state at WDL-Criteo's full width, as the
# reference's ``opt_state_nbytes`` counts them (int8: the int32 step 4 B)
FULL_WIDTH_BYTES = {
    "a": {"float32": 3_346_432, "bfloat16": 1_673_216, "int8": 839_972,
          "sm3": 78_568},
    "b": {"float32": 2_648_072, "bfloat16": 1_324_036, "int8": 667_924,
          "sm3": 86_964},
}


def _opt_pair(kind, lr=0.01, **tkw):
    if kind == "sm3":
        return jmake_optimizer("sm3", lr), toptim.make_optimizer("sm3", lr)
    kw = {} if kind == "float32" else {"state_dtype": kind}
    return (jmake_optimizer("adagrad", lr, **kw),
            toptim.make_optimizer("adagrad", lr, use_pallas=True, **kw,
                                  **tkw))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "sm3"])
@pytest.mark.parametrize("party", ["a", "b"])
def test_opt_state_nbytes_at_full_width(party, kind):
    from repro.configs import get_config as jget_config
    from repro.models.tabular import make_dlrm as jmake_dlrm
    from repro_torch.configs import get_config
    from repro_torch.models.tabular import make_dlrm

    jcfg = jget_config("wdl-criteo")
    jinit, _, _ = jmake_dlrm(jcfg)
    jparams = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    init_fn, _, _ = make_dlrm(get_config("wdl-criteo"))
    params = init_fn(0, get_config("wdl-criteo"), "cpu")
    jopt, topt = _opt_pair(kind)
    want = JQ.opt_state_nbytes(jopt, jparams[party])
    got = TQ.opt_state_nbytes(topt, list(params[party].parameters()))
    assert got == want == FULL_WIDTH_BYTES[party][kind]


def test_state_bytes_ordering():
    """At LLM-ish leaf sizes: int8 < bf16 < fp32, sm3 below int8, int8
    about 4x below fp32."""
    params = [torch.zeros(2048, 960), torch.zeros(960)]
    b32 = TQ.opt_state_nbytes(adagrad(0.1), params)
    b16 = TQ.opt_state_nbytes(adagrad(0.1, state_dtype="bfloat16"), params)
    b8 = TQ.opt_state_nbytes(adagrad(0.1, state_dtype="int8"), params)
    bs = TQ.opt_state_nbytes(toptim.make_optimizer("sm3", 0.1), params)
    assert b8 < b16 < b32 and bs < b8
    assert b32 / b8 > 3.5


def test_bad_state_dtype_rejected():
    with pytest.raises(ValueError, match="state_dtype"):
        adagrad(0.1, state_dtype="fp16")
    with pytest.raises(ValueError, match="state_dtype"):
        TQ.adagrad_quantized(0.1, state_dtype="float32")


# --------------------------------------------------------------------------
# Optimizer behaviour (the cases of tests/test_quantized_optim.py)
# --------------------------------------------------------------------------
def _run(opt, params, grad_seq):
    st = opt.init(params)
    upd = None
    for g in grad_seq:
        upd, st = opt.update(g, st)
    return upd, st


def test_int8_adagrad_exact_on_row_homogeneous_grads():
    """Constant-magnitude gradients keep every element at the row max, so
    the sqrt-space requantisation is exact and int8 AdaGrad reproduces
    the fp32 update to float tolerance."""
    params = [torch.zeros(16, 64)]
    signs = np.random.default_rng(11).choice([-1.0, 1.0], size=(16, 64))
    grads = [[torch.tensor(signs * 0.1, dtype=torch.float32)]] * 6
    u32, _ = _run(adagrad(0.05, use_pallas=True), params, grads)
    u8, _ = _run(adagrad(0.05, use_pallas=True, state_dtype="int8"), params,
                 grads)
    np.testing.assert_allclose(u8[0].numpy(), u32[0].numpy(), rtol=2e-5,
                               atol=1e-8)


@pytest.mark.parametrize("state_dtype,tol", [("bfloat16", 0.02),
                                             ("int8", 0.35)])
def test_quantized_adagrad_tracks_fp32_within_tolerance(state_dtype, tol):
    """Random gradients: the quantised accumulators stay within a bounded
    relative error of the fp32 update where the accumulator is not far
    below the row max (sqrt-space codes cover (1/127)² of it)."""
    params = [torch.zeros(37), torch.zeros(16, 128)]
    grads = [[torch.from_numpy((np.random.default_rng(k).normal(
        size=tuple(p.shape)) * 0.1).astype(np.float32)) for p in params]
        for k in range(6)]
    u32, _ = _run(adagrad(0.05, use_pallas=True), params, grads)
    uq, _ = _run(adagrad(0.05, use_pallas=True, state_dtype=state_dtype),
                 params, grads)
    for a, b in zip(uq, u32):
        a, b = a.numpy(), b.numpy()
        sig = np.abs(b) > 0.25 * np.abs(b).max()
        rel = np.abs(a - b)[sig] / np.abs(b)[sig]
        assert rel.max() <= tol, rel.max()


def test_quantized_adagrad_optimizes_quadratic():
    """Least squares with int8 / bf16 state reaches within 10 % of the
    fp32-state loss."""
    rng = np.random.default_rng(11)
    X = torch.from_numpy((rng.normal(size=(128, 16)) * 0.5)
                         .astype(np.float32))
    y = X @ torch.from_numpy(rng.normal(size=16).astype(np.float32))

    def loss(w):
        r = X @ w - y
        return (r * r).mean()

    finals = {}
    for sd in OPT_STATE_DTYPES:
        opt = adagrad(0.5, use_pallas=True, state_dtype=sd)
        w = [torch.zeros(16, requires_grad=True)]
        st = opt.init(w)
        for _ in range(60):
            (g,) = torch.autograd.grad(loss(w[0]), w)
            upd, st = opt.update([g], st)
            apply_updates(w, upd)
        finals[sd] = float(loss(w[0].detach()))
    base = finals["float32"]
    assert base < 0.05 * float((y * y).mean())
    for sd in ("bfloat16", "int8"):
        assert finals[sd] <= base + 0.1 * abs(base) + 5e-3, finals


def test_int8_adagrad_update_is_deterministic():
    """With a uniform source keyed by the tag (here the reference's chain)
    the same (grads, state) give bit-identical updates and codes: the
    rounding depends on the step counter, not on the call."""
    params = [torch.zeros(8, 32)]
    g = [torch.from_numpy((np.random.default_rng(1).normal(size=(8, 32))
                           * 0.1).astype(np.float32))]
    opt = adagrad(0.05, use_pallas=True, state_dtype="int8",
                  uniforms=jax_uniforms)
    st = opt.init(params)
    u1, st1 = opt.update(g, st)
    u2, st2 = opt.update(g, st)
    assert torch.equal(u1[0], u2[0])
    assert torch.equal(st1["accum"][0].q, st2["accum"][0].q)
    assert st1["t"] == st2["t"] == 1


def test_sm3_state_is_factored_and_optimizes():
    params = [torch.zeros(32), torch.zeros(64, 32)]
    opt = toptim.make_optimizer("sm3", 0.5)
    st = opt.init(params)
    assert st["accum"][0]["full"].shape == (32,)
    assert st["accum"][1]["row"].shape == (64,)
    assert st["accum"][1]["col"].shape == (32,)
    assert TQ.opt_state_nbytes(opt, params) < \
        TQ.opt_state_nbytes(adagrad(0.5), params) / 10

    rng = np.random.default_rng(11)
    X = torch.from_numpy((rng.normal(size=(256, 64)) * 0.5)
                         .astype(np.float32))
    y = X @ torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))

    def loss(w):
        r = X @ w - y
        return (r * r).mean()

    w = [torch.zeros(64, 32, requires_grad=True)]
    st = opt.init(w)
    l0 = float(loss(w[0].detach()))
    for _ in range(50):
        (g,) = torch.autograd.grad(loss(w[0]), w)
        upd, st = opt.update([g], st)
        apply_updates(w, upd)
    assert float(loss(w[0].detach())) < 0.2 * l0


def test_sm3_cover_upper_bounds_adagrad_sum():
    """min(row_i, col_j) >= the true accumulated g² sum at every cell, so
    SM3's steps are never larger than AdaGrad's."""
    opt = TQ.sm3(0.1)
    g = torch.from_numpy((np.random.default_rng(2).normal(size=(8, 16))
                          * 0.3).astype(np.float32))
    st = opt.init([torch.zeros(8, 16)])
    true_sum = np.zeros((8, 16), np.float64)
    for _ in range(4):
        _, st = opt.update([g], st)
        true_sum += g.numpy().astype(np.float64) ** 2
        cover = np.minimum(st["accum"][0]["row"].numpy()[:, None],
                           st["accum"][0]["col"].numpy()[None, :])
        assert (cover >= true_sum - 1e-5).all()


# --------------------------------------------------------------------------
# Ten steps against the reference from one bridged state
# --------------------------------------------------------------------------
def _leaves(state):
    """Port optimizer state -> numpy leaves in the reference's flattening
    order (QuantAccum: q then scale; dicts by sorted key)."""
    out = []
    for e in state["accum"]:
        if isinstance(e, TQ.QuantAccum):
            out += [e.q.numpy(), e.scale.numpy()]
        elif isinstance(e, dict):
            out += [e[k].float().numpy() for k in sorted(e)]
        else:
            out.append(e.float().numpy())
    return out


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "sm3"])
def test_ten_steps_match_reference(kind):
    """Three reference steps make a nonzero state, which
    ``bridge.load_opt_state`` brings across; then ten steps on both sides
    on the same gradients."""
    rng = np.random.default_rng(13)
    shapes = {"w": (64, 32), "b": (32,), "s": (), "e": (40, 3, 5)}
    names = sorted(shapes)                  # the reference's leaf order

    def grads():
        return {k: np.asarray(rng.standard_normal(shapes[k]) * 0.1,
                              np.float32) for k in names}

    jopt, topt = _opt_pair(kind, lr=0.05, **(
        {"uniforms": jax_uniforms} if kind == "int8" else {}))
    jst = jopt.init({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        _, jst = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads()),
                             jst)
    tst = load_opt_state(jax.tree_util.tree_map(np.asarray, jst))
    jl = [np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
          else np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    for got, want in zip(_leaves(tst), jl):
        np.testing.assert_array_equal(got, want)
    flips = 0
    for step in range(10):
        g = grads()
        ju, jst = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jst)
        tu, tst = topt.update([torch.from_numpy(g[k]) for k in names], tst)
        for k, u in zip(names, tu):
            assert u.shape == shapes[k]
            d = _rel(u, ju[k])
            assert d <= 1e-5, (step, k, d)
        for got, want in zip(_leaves(tst), jax.tree_util.tree_leaves(jst)):
            want = np.asarray(want, np.float32) \
                if want.dtype == jnp.bfloat16 else np.asarray(want)
            if got.dtype == np.int8:
                flips += int((got != want).sum())
                assert np.abs(got.astype(int) - want).max() <= 1
            else:
                assert _rel(got, want) <= 1e-5, (step, kind)
    if kind == "int8":
        assert tst["t"] == int(jst["t"]) == 13
        print(f"int8: {flips} codes differ by one step over ten steps")
    assert flips == 0
