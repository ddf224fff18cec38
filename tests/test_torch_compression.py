"""The port's wire codecs and compressed transport against the reference.

``repro_torch.core.compression`` and ``engine.CompressedWANTransport`` run
beside ``repro.core.compression`` and ``repro.core.engine`` on the same
numpy inputs.  The reference draws its stochastic-rounding uniforms from
``jax.random`` keys; the port takes them from a uniform source, and here
that source (:func:`jax_uniforms`) computes the reference's uniforms from
the tag the port hands it.  So codes, scales and indices must be equal,
and decoded values bitwise equal.  Byte accounting is exact:
``wire_bytes`` is the payload's size for every spec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CELUConfig as JCELU
from repro.core import compression as JC
from repro.core import engine as jengine
from repro_torch.configs.base import CELUConfig
from repro_torch.core import compression as TC
from repro_torch.core import engine as tengine
from repro_torch.core.uniforms import UniformKey

torch.set_num_threads(1)

SHAPES = [(64, 8), (37, 5), (1, 1), (3, 7, 11), (256, 256), (40000,)]


def jax_key(tag):
    """The reference's ``jax.random`` key for a port uniform tag:
    ``("wire", round, 2K, j, *folds)`` — ``split(fold_in(PRNGKey(17),
    round), 2K)[j]``; ``("insert", round, party, *folds)`` —
    ``fold_in(fold_in(PRNGKey(0xCE1), round), party)``; ``("optim", t,
    *folds)`` — ``fold_in(PRNGKey(0xAD49), t)``, the int8 AdaGrad state's
    requantisation; ``("draw", round, j, party)`` — the uniform workset
    draw, ``PRNGKey(29)`` folded by round, local step and party, and
    ``("draw_s", s, round, j, party)`` — the same on the pipelined
    scheduler's dynamic path, folded by the staleness ``s`` first;
    ``("seed", s, *folds)`` — ``PRNGKey(s)``; then ``fold_in`` by each
    fold.  ``("job", seed, *tag)`` is a fleet job's chain
    (``repro_torch.fleet.JobUniforms``): the engine chains' bases (17,
    0xCE1, 29) start from ``fold_in(PRNGKey(base), seed)``, as the
    reference's ``JobHyper.for_spec`` keys do."""
    kind, *rest = tag
    job = None
    if kind == "job":
        job, kind, *rest = rest

    def base(b):
        key = jax.random.PRNGKey(b)
        return key if job is None else jax.random.fold_in(key, job)
    if kind in ("draw", "draw_s"):
        key, folds = base(29), rest
    elif kind == "wire":
        rnd, n, j, *folds = rest
        key = jax.random.split(jax.random.fold_in(base(17), rnd), n)[j]
    elif kind == "insert":
        rnd, *folds = rest
        key = jax.random.fold_in(base(0xCE1), rnd)
    elif kind == "optim":
        t, *folds = rest
        key = jax.random.fold_in(jax.random.PRNGKey(0xAD49), t)
    else:
        seed, *folds = rest
        key = jax.random.PRNGKey(seed)
    for f in folds:
        key = jax.random.fold_in(key, f)
    return key


def jax_uniforms(tag, shape):
    """A uniform source that hands the port the reference's uniforms."""
    u = jax.random.uniform(jax_key(tag), shape, jnp.float32)
    return torch.from_numpy(np.array(u))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _leaves(payload):
    if isinstance(payload, dict):
        return [x for k in sorted(payload) for x in _leaves(payload[k])]
    if isinstance(payload, (list, tuple)):
        return [x for v in payload for x in _leaves(v)]
    return [np.asarray(payload)]


def _codecs(spec):
    return list(zip(JC.make_codec_pair(spec), TC.make_codec_pair(spec)))


@pytest.mark.parametrize("spec", TC.CODEC_SPECS)
def test_wire_bytes_equal_payload_nbytes(spec):
    """For every spec and direction: the port's wire_bytes is its
    payload's size and the reference's wire_bytes."""
    for shape in SHAPES:
        x = torch.from_numpy(_x(shape, 0))
        for jc, tc in _codecs(spec):
            payload = tc.encode(UniformKey(jax_uniforms, ("seed", 1)), x)
            got = tc.wire_bytes(shape, torch.float32)
            assert got == TC.payload_nbytes(payload), (spec, shape)
            assert got == jc.wire_bytes(shape, jnp.float32), (spec, shape)


@pytest.mark.parametrize("spec", TC.CODEC_SPECS)
def test_codecs_decode_like_reference_on_injected_uniforms(spec):
    """Same x, same uniforms: every payload leaf equal, decode bitwise
    equal (codes and indices exact, scales bitwise)."""
    for seed, shape in enumerate([(64, 8), (3, 7, 11), (256, 256)]):
        x = _x(shape, seed)
        for jc, tc in _codecs(spec):
            jp = jc.encode(jax.random.PRNGKey(seed), jnp.asarray(x))
            tp = tc.encode(UniformKey(jax_uniforms, ("seed", seed)),
                           torch.from_numpy(x))
            for a, b in zip(_leaves(tp), _leaves(jp), strict=True):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            like = torch.zeros(shape)
            np.testing.assert_array_equal(
                tc.decode(tp, like).numpy(),
                np.asarray(jc.decode(jp, jnp.zeros(shape))))


@pytest.mark.parametrize("n,dtype", [(32768, torch.int16),
                                     (32769, torch.int32)])
def test_topk_index_dtype(n, dtype):
    payload = TC.TopKCodec(0.01).encode(UniformKey(jax_uniforms, ("seed",
                                                                  0)),
                                        torch.from_numpy(_x((n,), 3)))
    assert payload["idx"].dtype == dtype


@pytest.mark.parametrize("spec", ["int8", "int4x2", "topk", "topk_int8"])
def test_error_feedback_residuals_telescope(spec):
    """sum(decoded) + final residual == sum(sent), and each send equals
    the reference transport's on the same uniforms."""
    jtp = jengine.make_transport(JCELU(), spec)
    ttp = tengine.make_transport(CELUConfig(), spec)
    (jres,) = jtp.init_state([jnp.zeros((16, 8))])["up"]
    (tres,) = ttp.init_state([torch.zeros(16, 8)])["up"]
    total_in = np.zeros((16, 8), np.float64)
    total_out = torch.zeros(16, 8, dtype=torch.float64)
    for t in range(12):
        x = _x((16, 8), 100 + t)
        tag = ("wire", t, 2, 0)
        jy, jres = jtp.send(jax_key(tag), jnp.asarray(x), jres, "up")
        ty, tres = ttp.send(UniformKey(jax_uniforms, tag),
                            torch.from_numpy(x), tres, "up")
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        total_in += x
        total_out += ty.double()
    np.testing.assert_allclose((total_out + tres.double()).numpy(),
                               total_in, rtol=1e-5, atol=1e-5)
    assert float(tres.abs().max()) < 10 * np.abs(total_in).max()


def test_identity_codec_send_is_bitwise_plain_wire():
    for wire in ("float32", "bfloat16"):
        celu = CELUConfig(wire_dtype=wire)
        plain = tengine.SimWANTransport(celu)
        ident = tengine.make_transport(celu, "identity")
        assert isinstance(ident, tengine.CompressedWANTransport)
        assert ident.init_state([torch.zeros(8, 4)]) == {}
        x = torch.from_numpy(_x((32, 8), 16))
        key = UniformKey(jax_uniforms, ("wire", 0, 2, 0))
        yp, _ = plain.send(key, x, None, "up")
        yc, _ = ident.send(key, x, None, "up")
        assert torch.equal(yp, yc)
        assert ident.round_bytes([(32, 8)]) == plain.round_bytes([(32, 8)])


def test_plateau_schedule_and_transport_rebuild_match_reference():
    """The host-side ratio ladder steps on the same observations as the
    reference's, and a symmetric wire consults its shared codec once."""
    losses = [1.0, 0.9, 0.9, 0.9, 0.9, float("nan"), 0.9, 0.9, 0.5, 0.5,
              0.5, 0.5, 0.5, 0.5, 0.5]
    js = JC.PlateauRatioSchedule(patience=2)
    ts = TC.PlateauRatioSchedule(patience=2)
    assert [ts.update(v) for v in losses] == [js.update(v) for v in losses]
    jcodec = JC.TopKCodec(0.125, ratio_schedule=JC.PlateauRatioSchedule(
        patience=1))
    tcodec = TC.TopKCodec(0.125, ratio_schedule=TC.PlateauRatioSchedule(
        patience=1))
    jtp = jengine.CompressedWANTransport(JCELU(), jcodec)
    ttp = tengine.CompressedWANTransport(CELUConfig(), tcodec)
    for v in (1.0, 1.0, 1.0, 0.2, 0.2):
        jtp, ttp = jtp.scheduled(v), ttp.scheduled(v)
        assert ttp.codecs["up"].ratio == jtp.codecs["up"].ratio
        assert ttp.codecs["up"] is ttp.codecs["down"]
    assert ttp.codecs["up"].ratio == 0.5
    with pytest.raises(ValueError, match="ladder"):
        TC.TopKCodec(0.3, ratio_schedule=TC.PlateauRatioSchedule())


def test_make_codec_pair_specs():
    for spec in ("int8_topk", "topk/int8", "int4x2"):
        for (jc, tc) in _codecs(spec):
            assert type(tc).__name__ == type(jc).__name__
            assert tc.lossless == jc.lossless
    with pytest.raises(ValueError, match="unknown codec"):
        TC.make_codec("int3")
