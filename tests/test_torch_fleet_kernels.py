"""The job axis of the gate and quantiser ops (``repro_torch/kernels/jobs.py``)
on the CPU.

Under ``torch.func.vmap`` each gate op (K1, K2a, K2b, K4, K5) and K3 runs
its jobs through one job-batched call.  On the CPU that call is the plain
version over the job axis, and it must equal a Python loop over the jobs
of the one-job plain version bit for bit: with every operand batched, and
with each operand that ``vmap`` may leave unbatched (stride 0: shared by
every job) in turn, and with the threshold a per-job tensor or one value.
The fake rules give the output shapes on meta tensors.  On the card the
same rules make one launch (``chip_smoke.py``'s fleet phase holds that
launch bitwise to N scalar launches).  No module of the fleet imports
JAX or the reference package.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch
from torch.func import vmap

from repro_torch.kernels import _cuda
from repro_torch.kernels import cosine_weight as cw
from repro_torch.kernels import fused_sample as fs
from repro_torch.kernels import quantize as qz

torch.set_num_threads(1)

N, W, B, F = 4, 3, 6, 16
THRESH = np.float32([0.5, 0.7071068, 0.2, -0.3])


def _rows(seed, shape):
    """Rows whose cosines against ``base`` spread over (-1, 1), so each
    job's threshold zeroes a different set."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


def _operands(bits=None, dtype=torch.float32):
    """Per-job operands: ad hoc (N, B, F); rings (N, W, B, F) near the
    ad-hoc rows (noise growing with the row); slots (N, 1)."""
    a = _rows(0, (N, B, F))
    noise = _rows(1, (N, W, B, F)) * torch.linspace(0.1, 3.0, B)[:, None]
    z = (a[:, None] + noise)
    dz = _rows(2, (N, W, B, F))
    slot = torch.tensor([[0], [2], [1], [2]], dtype=torch.int32)
    if bits is None:
        return a, z.to(dtype), dz.to(dtype), slot
    levels = 127 if bits == 8 else 7

    def quant(x):
        q, s = qz.quantize_sr_plain(x.reshape(-1, F), torch.rand(
            x.reshape(-1, F).shape, generator=torch.Generator()
            .manual_seed(3)), levels)
        q = q.reshape(x.shape)
        if bits == 4:
            q = fs.pack_nibbles(q)
        return q, s.reshape(x.shape[:-1])
    return a, quant(z), quant(dz), slot


# the shared operand (stride 0) of each case: None = all batched
SHARED = [None, "ring", "ad_hoc", "thr", "float_thr", "slot"]


def _thr(shared, j=None):
    """The threshold of the batched call (j None) or of job j's loop
    call."""
    if shared == "float_thr":
        return float(THRESH[0])
    if shared == "thr":
        return torch.tensor(THRESH[0]) if j is None else float(THRESH[0])
    return torch.tensor(THRESH) if j is None else float(THRESH[j])


def _out(w, c):
    """A gate's (weights, cotangent or None) as vmap may return it."""
    return (w,) if c is None else (w, c)


def _check(got, loop, shared):
    """The batched outputs ``got`` against ``loop(j)`` (a one-job plain
    call's outputs) for every job, bitwise."""
    for j in range(N):
        want = _out(*loop(j))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g[j], w), (shared, j)


def _dims(shared, names):
    return tuple(None if shared == n or (shared == "float_thr"
                                         and n == "thr") else 0
                 for n in names)


@pytest.mark.parametrize("shared", SHARED)
@pytest.mark.parametrize("with_cot", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_vmap_rule_is_a_loop_of_its_plain_version(shared, with_cot,
                                                     dtype):
    a, z, dz, slot = _operands(dtype=dtype)
    za = z[0] if shared == "ring" else z
    dza = dz[0] if shared == "ring" else dz
    aa = a[0] if shared == "ad_hoc" else a
    sl = slot[0] if shared == "slot" else slot
    thr = _thr(shared)

    def one(s, x, zr, dzr, t):
        return _out(*fs.fused_sample_2d(s, x, zr, dzr if with_cot else None,
                                        t))

    if shared == "float_thr":
        got = vmap(lambda s, x, zr, dzr: one(s, x, zr, dzr, thr),
                   in_dims=_dims(shared, ("slot", "ad_hoc", "ring",
                                          "ring")))(sl, aa, za, dza)
    else:
        got = vmap(one, in_dims=_dims(shared, (
            "slot", "ad_hoc", "ring", "ring", "thr")))(sl, aa, za, dza, thr)

    def loop(j):
        return fs.fused_sample_plain(
            slot[0] if shared == "slot" else slot[j],
            a[0] if shared == "ad_hoc" else a[j],
            z[0] if shared == "ring" else z[j],
            (dz[0] if shared == "ring" else dz[j]) if with_cot else None,
            _thr(shared, j))
    assert got[0].shape == (N, B) and len(got) == 1 + with_cot
    _check(got, loop, shared)


@pytest.mark.parametrize("shared", [None, "rows", "ad_hoc", "thr",
                                    "float_thr"])
@pytest.mark.parametrize("k2a", [True, False])
def test_k2_vmap_rule_is_a_loop_of_its_plain_version(shared, k2a):
    a, z, dz, _ = _operands()
    s_rows, d_rows = z[:, 0], dz[:, 0]
    sa = s_rows[0] if shared == "rows" else s_rows
    da = d_rows[0] if shared == "rows" else d_rows
    aa = a[0] if shared == "ad_hoc" else a
    thr = _thr(shared)
    dims = (None if shared == "ad_hoc" else 0,
            None if shared == "rows" else 0,
            None if shared == "rows" else 0)

    def one(x, s, d, t):
        if k2a:
            return cw.cosine_weight_2d(x, s, d, t)
        return (cw.cosine_weights_2d(x, s, t),)

    if shared == "float_thr":
        got = vmap(lambda x, s, d: one(x, s, d, thr), in_dims=dims)(aa, sa,
                                                                    da)
    else:
        got = vmap(one, in_dims=dims + (None if shared == "thr" else 0,))(
            aa, sa, da, thr)

    def loop(j):
        x = a[0] if shared == "ad_hoc" else a[j]
        s = s_rows[0] if shared == "rows" else s_rows[j]
        d = d_rows[0] if shared == "rows" else d_rows[j]
        if k2a:
            return cw.cosine_weight_plain(x, s, d, _thr(shared, j))
        return cw.cosine_weights_plain(x, s, _thr(shared, j)), None
    _check(got, loop, shared)


@pytest.mark.parametrize("shared", SHARED)
@pytest.mark.parametrize("with_cot", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_gate_vmap_rule_is_a_loop_of_its_plain_version(shared,
                                                             with_cot, bits):
    a, (zq, zs), (dzq, dzs), slot = _operands(bits=bits)
    fn = fs.fused_sample_q8_2d if bits == 8 else fs.fused_sample_q4_2d
    ring = (lambda x: x[0] if shared == "ring" else x)
    aa = a[0] if shared == "ad_hoc" else a
    sl = slot[0] if shared == "slot" else slot
    thr = _thr(shared)
    rd = None if shared == "ring" else 0
    dims = (None if shared == "slot" else 0,
            None if shared == "ad_hoc" else 0, rd, rd, rd, rd)

    def one(s, x, q, sc, dq, dsc, t):
        return _out(*fn(s, x, q, sc, dq if with_cot else None,
                        dsc if with_cot else None, t))

    args = (sl, aa, ring(zq), ring(zs), ring(dzq), ring(dzs))
    if shared == "float_thr":
        got = vmap(lambda *xs: one(*xs, thr), in_dims=dims)(*args)
    else:
        got = vmap(one, in_dims=dims + (None if shared == "thr" else 0,))(
            *args, thr)

    def loop(j):
        pick = (lambda x: x[0] if shared == "ring" else x[j])
        return fs.fused_sample_quant_plain(
            bits, slot[0] if shared == "slot" else slot[j],
            a[0] if shared == "ad_hoc" else a[j], pick(zq), pick(zs),
            pick(dzq) if with_cot else None,
            pick(dzs) if with_cot else None, _thr(shared, j))
    assert len(got) == 1 + with_cot
    _check(got, loop, shared)


@pytest.mark.parametrize("shared", [None, "u"])
@pytest.mark.parametrize("levels", [127, 7])
def test_k3_vmap_rule_folds_jobs_into_rows(shared, levels):
    x = _rows(4, (N, B, F))
    u = torch.rand((N, B, F), generator=torch.Generator().manual_seed(5))
    ua = u[0] if shared == "u" else u
    q, s = vmap(lambda x, u: qz.quantize_sr_2d(x, u, levels),
                in_dims=(0, None if shared == "u" else 0))(x, ua)
    for j in range(N):
        qj, sj = qz.quantize_sr_plain(x[j], u[0] if shared == "u" else u[j],
                                      levels)
        assert torch.equal(q[j], qj) and torch.equal(s[j], sj)


def test_fake_rules_give_shapes_on_meta_tensors():
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    slot = meta(1, dtype=torch.int32)
    a, ring = meta(B, F), meta(W, B, F)
    w, c = fs.fused_sample_2d(slot, a, ring, ring, 0.5)
    assert (w.shape, c.shape, w.device.type) == ((B,), (B, F), "meta")
    w, c = fs.fused_sample_2d(slot, a, ring, None, torch.tensor(
        0.5, device="meta"))
    assert w.shape == (B,) and c is None
    w, c = cw.cosine_weight_2d(a, a, a, 0.5)
    assert (w.shape, c.shape) == ((B,), (B, F))
    assert cw.cosine_weights_2d(a, a, 0.5).shape == (B,)
    for bits, width in ((8, F), (4, F // 2)):
        q = meta(W, B, width, dtype=torch.int8 if bits == 8
                 else torch.uint8)
        s = meta(W, B)
        fn = fs.fused_sample_q8_2d if bits == 8 else fs.fused_sample_q4_2d
        w, c = fn(slot, a, q, s, q, s, 0.5)
        assert (w.shape, c.shape) == ((B,), (B, F))
        assert fn(slot, a, q, s, None, None, 0.5)[1] is None
    q, s = qz.quantize_sr_2d(a, a, 127)
    assert (q.shape, q.dtype, s.shape) == ((B, F), torch.int8, (B,))


def test_gate_ops_are_registered_with_torch_library():
    for name in ("fused_sample_2d", "cosine_weight_2d", "cosine_weights_2d",
                 "fused_sample_q8_2d", "fused_sample_q4_2d",
                 "quantize_sr_2d"):
        assert hasattr(torch.ops.repro_torch, name), name


def test_job_strides_follow_the_c_order():
    js = _cuda._job_strides({"z": 7, "thr": 1})
    assert list(js) == [0, 0, 7, 0, 0, 0, 1]
    assert tuple(_cuda.GATE_STRIDES) == ("slot", "a", "z", "zs", "dz",
                                         "dzs", "thr")
    with pytest.raises(ValueError, match="unknown"):
        _cuda._job_strides({"ring": 1})


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_fleet_imports_neither_jax_nor_the_reference():
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / \
        "repro_torch"
    files = sorted((root / "fleet").glob("*.py")) + [root / "kernels" /
                                                     "jobs.py"]
    assert len(files) >= 4
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
