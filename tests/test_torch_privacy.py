"""DP on the wire (``core/privacy.py``, the transports' DP sends) and the
K-party preset (``core/multiparty.py``) of the port, on the CPU.

The cases mirror ``tests/test_dp_residual.py`` and
``tests/test_multiparty.py`` one for one.  Beyond those, the port's DP
sends and rounds run beside the reference's on injected uniforms
(``jax_uniforms``).  The noise is ``sqrt(2) · erfinv(u)`` on both sides
from the same u, but ``torch.erfinv`` and XLA's ``erf_inv`` differ: held
to the float64 ``scipy.special.erfinv`` of the same u, the port's noise
is within 1.5 float32 ulps of ``max(|x|, 1)`` and XLA's within 91 (its
tails), so the two differ by up to 5.8e-6 of ``max(|x|, 1)``, measured on
the CPU over 786,432 draws (:data:`NOISE_ULPS`, :data:`NOISE_RTOL`);
``clip_rows`` sums its norms in another order (within 2e-7 relative).
Over five rounds of the golden workload at ``dp_sigma = 0.5`` the loss
stays within 8.6e-8 relative and ``w_mean`` within 3.8e-9 of the
reference's, on the plain and on the int8 wire alike (no code flipped);
:data:`DP_LOSS_RTOL` and :data:`DP_W_MEAN_ATOL` leave room for a few
flipped codes, as the quantised rounds of ``test_torch_engine.py`` do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro_torch import golden
from repro_torch.configs.base import CELUConfig
from repro_torch.core import engine
from repro_torch.core import multiparty as MP
from repro_torch.core import protocol as P
from repro_torch.core.compression import IdentityCodec, TopKCodec
from repro_torch.core.engine import CompressedWANTransport
from repro_torch.core.privacy import (DPConfig, clip_rows,
                                      epsilon_per_release, normal,
                                      privatize, wire_noise)
from repro_torch.core.uniforms import UniformKey
from repro_torch.data import to_device
from repro_torch.data.synthetic import (TabularSpec, aligned_batches,
                                        make_tabular)
from repro_torch.models.tabular import (MLP, DLRMConfig, PartyA, WDLPartyB,
                                        make_dlrm)
from repro_torch.optim import make_optimizer
from test_torch_compression import jax_uniforms
from test_torch_engine import GOLDEN

torch.set_num_threads(1)

NOISE_ULPS = 2        # the port's noise against float64
NOISE_RTOL = 1e-5     # the port's against the reference's
DP_LOSS_RTOL = 1e-5
DP_W_MEAN_ATOL = 1e-5


def _key(seed):
    return UniformKey(jax_uniforms, ("seed", seed))


def _deterministic_codec():
    # top-k over identity values: encode / decode draw nothing, so a
    # residual that differs across noise keys could only come from DP
    return TopKCodec(0.25, value_codec=IdentityCodec())


def _dp_transport(sigma=0.3, clip=0.5):
    celu = CELUConfig(dp_sigma=sigma, dp_clip=clip)
    return CompressedWANTransport(celu, _deterministic_codec(),
                                  _deterministic_codec()), celu


@pytest.fixture
def x():
    return torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(7), (64, 8))))


@pytest.fixture
def res():
    return torch.from_numpy(np.asarray(
        0.1 * jax.random.normal(jax.random.PRNGKey(8), (64, 8))))


def _scale(x):
    """``max(|x|, 1)``: near 0 the noise's error is absolute, since its
    uniform input sits on a grid of 2^-23."""
    return np.maximum(np.abs(np.asarray(x, np.float64)), 1.0)


# --------------------------------------------------------------------------
# tests/test_dp_residual.py
# --------------------------------------------------------------------------
def test_residual_independent_of_noise_key(x, res):
    """The error-feedback residual does not depend on the DP noise draw:
    the noise is added after the residual is taken."""
    tp, _ = _dp_transport()
    y1, r1 = tp.send(_key(1), x, res, "up")
    y2, r2 = tp.send(_key(2), x, res, "up")
    assert torch.equal(r1, r2)
    assert not torch.allclose(y1, y2)


def test_send_matches_whitebox_pipeline(x, res):
    """The order clip -> wire cast -> + residual -> encode -> decode ->
    residual out -> noise -> release, bitwise on the port, and against the
    reference's send on the same uniforms."""
    from repro.configs.base import CELUConfig as JCELU
    from repro.core import compression as JC
    from repro.core import engine as jengine
    tp, celu = _dp_transport()
    key = _key(3)
    y, r = tp.send(key, x, res, "up")
    cfg = DPConfig(clip=celu.dp_clip, sigma=celu.dp_sigma)
    codec = tp.codecs["up"]
    e = tp._wire_cast(clip_rows(x, cfg.clip)).float() + res
    decoded = codec.decode(codec.encode(key.fold(1), e), e)
    assert torch.equal(r, e - decoded)
    assert torch.equal(y, wire_noise(key.fold(2), decoded, cfg).to(x.dtype))
    jtp = jengine.CompressedWANTransport(
        JCELU(dp_sigma=0.3, dp_clip=0.5),
        JC.TopKCodec(0.25, value_codec=JC.IdentityCodec()),
        JC.TopKCodec(0.25, value_codec=JC.IdentityCodec()))
    jy, jr = jtp.send(jax.random.PRNGKey(3), jnp.asarray(x.numpy()),
                      jnp.asarray(res.numpy()), "up")
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)


def test_release_noise_has_dp_scale(x, res):
    """y - decode(encode(e)) is Gaussian noise at sigma · clip."""
    sigma, clip = 0.3, 0.5
    tp, _ = _dp_transport(sigma, clip)
    key = _key(4)
    y, _ = tp.send(key, x, res, "up")
    codec = tp.codecs["up"]
    e = tp._wire_cast(clip_rows(x, clip)).float() + res
    decoded = codec.decode(codec.encode(key.fold(1), e), e)
    noise = (y - decoded).numpy()
    assert abs(noise.std() - sigma * clip) < 0.25 * sigma * clip
    assert abs(noise.mean()) < 3 * sigma * clip / np.sqrt(noise.size)


def test_dp_zero_path_is_unnoised_error_feedback(x, res):
    """sigma = 0 keeps the lossy path: no clip, no noise."""
    tp = CompressedWANTransport(CELUConfig(), _deterministic_codec(),
                                _deterministic_codec())
    key = _key(5)
    y, r = tp.send(key, x, res, "up")
    codec = tp.codecs["up"]
    e = x.float() + res
    decoded = codec.decode(codec.encode(key.fold(1), e), e)
    assert torch.equal(y, decoded.to(x.dtype))
    assert torch.equal(r, e - decoded)


def test_exact_codec_passes_residual_through(x, res):
    """An exact codec keeps no residual, under DP too."""
    tp = CompressedWANTransport(CELUConfig(dp_sigma=0.3, dp_clip=0.5),
                                IdentityCodec(), IdentityCodec())
    _, r = tp.send(_key(6), x, res, "up")
    assert torch.equal(r, res)


class _ToyA(nn.Module):
    """The reference auditor's toy feature party, ``tanh(x @ w + b)``."""

    def __init__(self, fa=6, z=8):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fa, z))
        self.b = nn.Parameter(torch.zeros(z))


class _ToyB(nn.Module):
    def __init__(self, fb=5, z=8, K=1):
        super().__init__()
        self.w_own = nn.Parameter(torch.zeros(fb, z))
        self.w_top = nn.Parameter(torch.zeros((K + 1) * z, 1))


def _toy_task():
    def forward_a(p, batch):
        return torch.tanh(batch["x"] @ p.w + p.b)

    def loss_b(p, z_list, batch):
        own = torch.tanh(batch["x"] @ p.w_own)
        logits = (torch.cat(list(z_list) + [own], dim=1) @ p.w_top)[:, 0]
        y = batch["y"]
        li = torch.clamp_min(logits, 0.0) - logits * y + torch.log1p(
            torch.exp(-logits.abs()))
        return li, logits.new_zeros(())

    return engine.KPartyTask(forward_a, loss_b)


def test_round_with_dp_and_lossy_codec_trains():
    """Three rounds under DP + top-k + int8: finite loss and residuals."""
    celu = CELUConfig(R=2, W=3, dp_sigma=0.3, compression="topk_int8")
    rng = np.random.default_rng(0)
    batches_a = [{"x": torch.from_numpy(
        rng.standard_normal((64, 6)).astype(np.float32))}]
    batch_b = {"x": torch.from_numpy(
        rng.standard_normal((64, 5)).astype(np.float32)),
        "y": torch.from_numpy((rng.uniform(size=64) > 0.5).astype(
            np.float32))}
    task, opt = _toy_task(), make_optimizer("adagrad", 0.1)
    tp = engine.make_transport(celu)
    state = engine.init_state(task, {"a": [_ToyA()], "b": _ToyB()}, opt,
                              celu, batches_a, batch_b, transport=tp)
    fn = engine.make_round(task, opt, celu, transport=tp)
    for i in range(3):
        state, m = fn(state, batches_a, batch_b, i)
    assert np.isfinite(float(m["loss"]))
    for d in ("up", "down"):
        for r in state["transport"][d]:
            assert torch.isfinite(r).all()


# --------------------------------------------------------------------------
# tests/test_multiparty.py
# --------------------------------------------------------------------------
def _three_party_setup(seed=0):
    """A 12-field dataset split A1: 4, A2: 4, B: 4 (+ labels); B's top
    takes [Z1 | Z2 | Z_B]."""
    spec = TabularSpec("t", fields_a=8, fields_b=4, vocab=64,
                       n_train=8192, n_test=2048)
    data = make_tabular(spec, seed=seed)
    cfg = DLRMConfig("wdl", 4, 4, vocab=64, embed_dim=4, z_dim=8,
                     hidden=(16, 8))
    gen = torch.Generator().manual_seed(seed)
    pb = WDLPartyB(cfg, gen)
    pb.top = MLP((3 * cfg.z_dim, 16, 1), gen)
    params = {"a": [PartyA(cfg, gen), PartyA(cfg, gen)], "b": pb}
    return data, MP.MultiVFLTask(*golden.three_party_task()), params


def _split(ba, bb):
    return ([to_device({"x_a": ba["x_a"][:, :4]}, "cpu"),
             to_device({"x_a": ba["x_a"][:, 4:]}, "cpu")],
            to_device(bb, "cpu"))


def test_three_party_celu_trains():
    data, task, params = _three_party_setup()
    celu = CELUConfig(R=2, W=2, xi_degrees=60.0)
    opt = make_optimizer("adagrad", 0.02)
    it = aligned_batches(data["train"], 128, seed=0)
    _, ba, bb = next(it)
    state = MP.init_state(task, params, opt, celu, *_split(ba, bb))
    rnd = MP.make_round(task, opt, celu)
    it = aligned_batches(data["train"], 128, seed=0)
    losses = []
    for _ in range(30):
        bi, ba, bb = next(it)
        state, m = rnd(state, *_split(ba, bb), bi)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert int(state["comm_rounds"]) == 30


def test_three_party_matches_interface_counts():
    data, task, params = _three_party_setup()
    celu = CELUConfig(R=2, W=2)
    opt = make_optimizer("sgd", 0.05)
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    state = MP.init_state(task, params, opt, celu, *_split(ba, bb))
    assert len(state["ws"]["a"]) == 2
    assert len(state["params"]["a"]) == 2


def test_clip_rows_bounds_norm():
    """Clipped rows have norm at most ``clip``, and equal the reference's
    within its norm's summation order."""
    from repro.core.privacy import clip_rows as jclip_rows
    x = (np.random.default_rng(0).normal(size=(16, 32)) * 10).astype(
        np.float32)
    y = clip_rows(torch.from_numpy(x), 1.0).numpy()
    assert (np.linalg.norm(y.reshape(16, -1), axis=1) <= 1.0 + 1e-5).all()
    np.testing.assert_allclose(y, np.asarray(jclip_rows(jnp.asarray(x),
                                                        1.0)),
                               rtol=2e-7, atol=1e-8)


def test_privatize_noise_scale():
    x = torch.ones((512, 64)) * 0.01
    y = privatize(_key(0), x, DPConfig(clip=1.0, sigma=0.5))
    assert abs((y - clip_rows(x, 1.0)).numpy().std() - 0.5) < 0.05


def test_epsilon_monotone_in_sigma():
    from repro.core.privacy import DPConfig as JDP
    from repro.core.privacy import epsilon_per_release as jeps
    e1 = epsilon_per_release(DPConfig(sigma=0.5))
    e2 = epsilon_per_release(DPConfig(sigma=1.0))
    assert e2 < e1
    assert (e1, e2) == (jeps(JDP(sigma=0.5)), jeps(JDP(sigma=1.0)))
    assert epsilon_per_release(DPConfig()) == float("inf")


def test_protocol_with_dp_still_converges():
    spec = TabularSpec("t", fields_a=4, fields_b=3, vocab=64, n_train=4096,
                       n_test=512)
    data = make_tabular(spec, seed=0)
    cfg = DLRMConfig("wdl", 4, 3, vocab=64, embed_dim=4, z_dim=8,
                     hidden=(16, 8))
    init_fn, task, _ = make_dlrm(cfg)
    celu = CELUConfig(R=2, W=2, dp_sigma=0.1, dp_clip=5.0)
    params = init_fn(0, cfg, "cpu")
    opt = make_optimizer("adagrad", 0.02)
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    state = P.init_state(task, params, opt, celu, to_device(ba, "cpu"),
                         to_device(bb, "cpu"))
    rnd = P.make_round(task, opt, celu)
    it = aligned_batches(data["train"], 64, seed=0)
    losses = []
    for _ in range(25):
        bi, ba, bb = next(it)
        state, m = rnd(state, to_device(ba, "cpu"), to_device(bb, "cpu"),
                       bi)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


# --------------------------------------------------------------------------
# Against the reference on injected uniforms
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64, 8), (3, 7, 11), (512, 512)])
def test_normal_matches_jax_random_normal(shape):
    """The noise transform of a key's uniforms: within 2 ulps of the
    float64 normal of the same uniforms, and within 1e-5 of ``max(|x|,
    1)`` of the reference's ``jax.random.normal`` of that key."""
    from scipy.special import erfinv

    from repro_torch.core.privacy import _LO, _WIDTH
    for seed in range(3):
        got = normal(_key(seed), shape).numpy()
        f = jax_uniforms(("seed", seed), shape)
        u = torch.clamp_min(f * _WIDTH + _LO, _LO).numpy()
        exact = np.sqrt(2.0) * erfinv(u.astype(np.float64))
        ulps = np.abs(got - exact) / np.spacing(
            _scale(exact).astype(np.float32))
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                            shape, jnp.float32))
        rel = np.abs(got - want) / _scale(want)
        print(shape, seed, "ulps against float64", ulps.max(),
              "against the reference", rel.max())
        assert ulps.max() <= NOISE_ULPS
        assert rel.max() <= NOISE_RTOL


@pytest.mark.parametrize("compression", ["", "int8", "identity"])
def test_dp_send_matches_reference(compression, x, res):
    """A DP send on the plain, the int8 and the identity wire against the
    reference's on the same uniforms, both directions."""
    from repro.configs.base import CELUConfig as JCELU
    from repro.core import engine as jengine
    celu = CELUConfig(dp_sigma=0.5, dp_clip=1.0)
    jcelu = JCELU(dp_sigma=0.5, dp_clip=1.0)
    tp = engine.make_transport(celu, compression)
    jtp = jengine.make_transport(jcelu, compression)
    r = None if compression in ("", "identity") else res
    for j, d in enumerate(("up", "down")):
        tag = ("wire", 3, 2, j)
        y, nr = tp.send(UniformKey(jax_uniforms, tag), x, r, d)
        jy, jr = jtp.send(jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(17), 3), 2)[j], jnp.asarray(x.numpy()),
            None if r is None else jnp.asarray(r.numpy()), d)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6)
        if r is not None:
            np.testing.assert_allclose(nr.numpy(), np.asarray(jr),
                                       rtol=1e-6, atol=1e-7)


def _jax_dp_trace(compression, rounds, sigma, clip):
    """The two-party golden workload through the reference's engine at
    ``dp_sigma`` / ``dp_clip``, from the fixture's initial parameters."""
    from repro.configs.base import CELUConfig as JCELU
    from repro.core import engine as jengine
    from repro.models.tabular import DLRMConfig as JDLRMConfig
    from repro.models.tabular import make_dlrm as jmake_dlrm
    from repro.optim import make_optimizer as jmake_optimizer
    c2 = golden.TWO_PARTY_CFG
    cfg = JDLRMConfig(c2.model, c2.fields_a, c2.fields_b, c2.vocab,
                      c2.embed_dim, c2.z_dim, tuple(c2.hidden))
    init_fn, task, _ = jmake_dlrm(cfg)
    with jax.threefry_partitionable(False):
        p = init_fn(jax.random.PRNGKey(0), cfg)
    data = make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=2048, n_test=512), 0)
    celu = JCELU(R=3, W=3, xi_degrees=60.0, compression=compression,
                 dp_sigma=sigma, dp_clip=clip)
    opt = jmake_optimizer("adagrad", 0.05)
    asj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    etask = jengine.lift_two_party(task)
    state = jengine.init_state(etask, jengine.lift_two_party_params(p), opt,
                               celu, [asj(ba)], asj(bb))
    rnd = jengine.make_round(etask, opt, celu)
    it = aligned_batches(data["train"], 64, seed=0)
    rows = []
    for _ in range(rounds):
        bi, ba, bb = next(it)
        state, m = rnd(state, [asj(ba)], asj(bb), bi)
        rows.append(golden._rows_metrics(m))
    rows.append({"steps_a": int(state["steps"]["a"][0]),
                 "steps_b": int(state["steps"]["b"]),
                 "comm_rounds": int(state["comm_rounds"])})
    return rows


@pytest.mark.parametrize("compression", ["", "int8"])
def test_dp_rounds_match_reference_on_injected_uniforms(compression):
    """Five celu rounds at ``dp_sigma = 0.5`` on the plain and the int8
    wire: the port fed the reference's uniforms against the reference."""
    sigma, clip = 0.5, 1.0
    want = _jax_dp_trace(compression, 5, sigma, clip)
    got = golden.two_party_trace(
        "celu", golden.load_params(GOLDEN), device="cpu", rounds=5,
        compression=compression, uniforms=jax_uniforms,
        celu_kw={"dp_sigma": sigma, "dp_clip": clip})
    dev = golden.compare(got, want)
    print(compression or "plain", dev)
    assert dev["counters_equal"], dev
    assert dev["loss_rel"] <= DP_LOSS_RTOL, dev
    assert dev["w_mean_abs"] <= DP_W_MEAN_ATOL, dev
    # the noise moved the run: the same rounds without DP differ
    plain = golden.two_party_trace("celu", golden.load_params(GOLDEN),
                                   device="cpu", rounds=5,
                                   compression=compression,
                                   uniforms=jax_uniforms)
    assert golden.compare(plain, want)["loss_rel"] > 100 * DP_LOSS_RTOL
