"""The port's xLSTM cells (``repro_torch.models.xlstm``) against the
reference's (``repro.models.xlstm``).

The same numpy inputs go through both on parameters drawn in JAX and
brought across bitwise: the mLSTM in its token-sequential form (chunked,
and one flat loop at an odd length) and its chunkwise-parallel form, the
sLSTM, one-token decode from a carried state, and gradients.  The cells
run in fp32 on both sides; their products sum in other orders.
Tolerances, as ``tests/test_perf_features.py`` holds the reference's
parallel form against its sequential one, and each a few times the
largest deviation measured here:

  * ``RTOL`` / ``ATOL`` (1e-4 / 1e-5) on outputs and states (measured:
    5.7e-6 absolute on the sLSTM's normaliser n, which grows with S, and
    at most 4e-7 elsewhere);
  * gradients: ``GRAD_RTOL`` of each leaf's largest magnitude on fp32
    leaves, ``GRAD_ULPS`` bf16 ulps on bf16 leaves (measured: 0.005);
  * ``log_sigmoid`` against ``jax.nn.log_sigmoid``: two fp32 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JX
from repro_torch.bridge import tree_to_torch
from repro_torch.models import xlstm as TX

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 1e-5
GRAD_ULPS = 2
BF16_ULP = 2.0 ** -7
D, H = 64, 4


def _tt(p):
    return tree_to_torch(jax.tree_util.tree_map(np.asarray, p))


@pytest.fixture(scope="module")
def mlstm():
    p = JX.mlstm_init(jax.random.PRNGKey(3), D, H)
    return p, _tt(p)


@pytest.fixture(scope="module")
def slstm():
    p = JX.slstm_init(jax.random.PRNGKey(5), D, H)
    return p, _tt(p)


def _x(S, seed=0, B=2):
    x = np.random.default_rng(seed).standard_normal((B, S, D))
    x = x.astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, label):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    dev = float(np.abs(got - want).max())
    print(f"{label}: max |dev| {dev:.3g}")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=label)


def _state_close(ts, js, label):
    for k in js:
        _close(ts[k], js[k], f"{label} state {k}")


# --------------------------------------------------------------------------
def test_log_sigmoid_is_jax_log_sigmoid():
    x = np.linspace(-60, 60, 48_001).astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    got = TX.log_sigmoid(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -22 * np.abs(want))


@pytest.mark.parametrize("S", [128, 67, 512, 300])
def test_mlstm_apply_matches_reference(mlstm, S):
    """The sequential form: chunks of CHUNK steps (S = 512: two; 67 and
    128: one), and one flat loop at a length past a chunk that is not a
    multiple of it (S = 300)."""
    p, tp = mlstm
    jx, tx = _x(S)
    jy, js = JX.mlstm_apply(p, jx)
    ty, ts = TX.mlstm_apply(tp, tx)
    _close(ty, jy, f"mlstm_apply S={S}")
    _state_close(ts, js, f"mlstm_apply S={S}")


@pytest.mark.parametrize("S,chunk", [(128, 32), (128, 64), (67, 64),
                                     (32, 64)])
def test_mlstm_apply_chunked_matches_reference(mlstm, S, chunk):
    """The chunkwise-parallel form (and its fallback to the sequential
    one where S is not a multiple of the chunk or is shorter), against
    the reference's and against the port's own sequential form."""
    p, tp = mlstm
    jx, tx = _x(S, seed=1)
    jy, js = JX.mlstm_apply_chunked(p, jx, chunk=chunk)
    ty, ts = TX.mlstm_apply_chunked(tp, tx, chunk=chunk)
    _close(ty, jy, f"mlstm_apply_chunked S={S} chunk={chunk}")
    _state_close(ts, js, f"mlstm_apply_chunked S={S} chunk={chunk}")
    sy, ss = TX.mlstm_apply(tp, tx)
    _close(ty, sy.numpy(), f"parallel vs sequential S={S}")
    _state_close(ts, {k: v.numpy() for k, v in ss.items()},
                 f"parallel vs sequential S={S}")


def test_mlstm_chunked_carries_a_state_in(mlstm):
    """The parallel form from a non-zero state (a prefill's) equals the
    reference's from the same state."""
    p, tp = mlstm
    jx, tx = _x(64, seed=2)
    _, js0 = JX.mlstm_apply(p, jx[:, :32])
    ts0 = {k: torch.from_numpy(np.array(v)) for k, v in js0.items()}
    jy, js = JX.mlstm_apply_chunked(p, jx[:, 32:], js0, chunk=16)
    ty, ts = TX.mlstm_apply_chunked(tp, tx[:, 32:], ts0, chunk=16)
    _close(ty, jy, "chunked from a state")
    _state_close(ts, js, "chunked from a state")


@pytest.mark.parametrize("S", [128, 67, 512])
def test_slstm_apply_matches_reference(slstm, S):
    p, tp = slstm
    jx, tx = _x(S, seed=3)
    jy, js = JX.slstm_apply(p, jx)
    ty, ts = TX.slstm_apply(tp, tx)
    _close(ty, jy, f"slstm_apply S={S}")
    _state_close(ts, js, f"slstm_apply S={S}")


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_decode_continues_the_prefill_state(mlstm, slstm, cell):
    """Four one-token decode steps from a 20-token prefill's state,
    against the reference's decode from its own state and against the
    cell run over the whole 24 tokens."""
    p, tp = mlstm if cell == "mlstm" else slstm
    japply = JX.mlstm_apply if cell == "mlstm" else JX.slstm_apply
    jdec = JX.mlstm_decode if cell == "mlstm" else JX.slstm_decode
    tapply = TX.mlstm_apply if cell == "mlstm" else TX.slstm_apply
    tdec = TX.mlstm_decode if cell == "mlstm" else TX.slstm_decode
    jx, tx = _x(24, seed=4)
    _, js = japply(p, jx[:, :20])
    _, ts = tapply(tp, tx[:, :20])
    tfull, _ = tapply(tp, tx)
    for i in range(20, 24):
        jy, js = jdec(p, jx[:, i:i + 1], js)
        ty, ts = tdec(tp, tx[:, i:i + 1], ts)
        _close(ty, jy, f"{cell} decode step {i}")
        _close(ty, tfull[:, i:i + 1].numpy(), f"{cell} decode vs full {i}")
    _state_close(ts, js, f"{cell} decode")


def _grads(jfn, tfn, p, tp, x, label):
    """Gradients of ⟨y, c⟩ in both frameworks with respect to every
    parameter and x, each leaf held to its dtype's limit."""
    ct = np.random.default_rng(9).standard_normal(x.shape + ())
    ct = np.broadcast_to(ct, x.shape).astype(np.float32)
    jg = jax.grad(lambda q, xx: jnp.sum(jfn(q, xx)[0].astype(jnp.float32)
                                        * ct), argnums=(0, 1))(p,
                                                               jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (tfn(leaves, tx)[0].float() * torch.from_numpy(ct)).sum().backward()
    worst = {}
    for k, t in list(leaves.items()) + [("x", tx)]:
        g, want = t.grad, np.asarray(jg[0][k] if k != "x" else jg[1],
                                     np.float32)
        dev = float(np.abs(g.float().numpy() - want).max())
        scale = float(np.abs(want).max())
        if g.dtype == torch.bfloat16:
            worst[k] = dev / (BF16_ULP * scale)
            assert worst[k] <= GRAD_ULPS, (label, k, worst[k])
        else:
            worst[k] = dev / scale
            assert worst[k] <= GRAD_RTOL, (label, k, worst[k])
    print(f"{label}: worst gradient deviation "
          f"{max(worst.values()):.3g} ({max(worst, key=worst.get)}; fp32 "
          f"leaves relative to their largest magnitude, bf16 leaves in "
          f"bf16 ulps)")


@pytest.mark.parametrize("form", ["chunked", "sequential", "zero_input_gate"])
def test_mlstm_gradients_match_reference(mlstm, form):
    """The parallel form's backward (each chunk checkpointed) and the
    sequential one's; ``zero_input_gate`` sets w_i to 0, so every input
    gate is equal and the running maxima's gradient meets ties, which
    ``torch.amax`` / ``torch.maximum`` split as ``jnp.max`` /
    ``jnp.maximum`` do."""
    p, tp = mlstm
    if form == "zero_input_gate":
        p = dict(p, w_i=jnp.zeros_like(p["w_i"]))
        tp = dict(tp, w_i=torch.zeros_like(tp["w_i"]))
    x = np.random.default_rng(6).standard_normal((1, 64, D))
    x = x.astype(np.float32)
    if form == "sequential":
        jfn, tfn = JX.mlstm_apply, TX.mlstm_apply
    else:
        def jfn(q, xx):
            return JX.mlstm_apply_chunked(q, xx, chunk=16)

        def tfn(q, xx):
            return TX.mlstm_apply_chunked(q, xx, chunk=16)
    _grads(jfn, tfn, p, tp, x, f"mlstm {form}")


def test_slstm_gradients_match_reference(slstm):
    p, tp = slstm
    x = np.random.default_rng(7).standard_normal((1, 48, D))
    _grads(JX.slstm_apply, TX.slstm_apply, p, tp, x.astype(np.float32),
           "slstm")


def test_sequential_chunks_are_checkpointed(mlstm, monkeypatch):
    """Under a gradient each CHUNK-step chunk of the sequential form runs
    under ``torch.utils.checkpoint``; the flat loop of a length past one
    chunk that is not a multiple of it (300) and a run without a gradient
    do not."""
    p, tp = mlstm
    calls = []
    orig = TX.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(TX, "checkpoint", counted)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    _, tx = _x(512, seed=8, B=1)
    TX.mlstm_apply(leaves, tx)[0].sum().backward()
    assert len(calls) == 512 // TX.CHUNK
    calls.clear()
    TX.mlstm_apply(leaves, tx[:, :300])[0].sum().backward()
    with torch.no_grad():
        TX.mlstm_apply(leaves, tx)
    assert not calls
