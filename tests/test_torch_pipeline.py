"""The port's pipelined scheduler (``engine.PipelinedEngine``) against the
reference's, on the CPU at the golden geometry.

The cases mirror ``tests/test_pipeline.py`` and
``tests/test_pipeline_depth.py`` one for one, on the port, except the
reference's ``test_pod_round_rejects_deep_queue``, whose counterpart is
in ``tests/test_torch_pod.py`` with the pod round.

Beyond those: depth 0 reproduces both goldens and is bitwise the port's
``make_round``; depths 1, 2 and 4 (round-robin and uniform sampling, the
int8-topk wire, damping 0, 0.25 and 5) run beside the reference's
``PipelinedEngine`` fed the same uniforms (``jax_uniforms``, which maps
the port's draw tags onto the reference's ``PRNGKey(29)`` chain).  The
integer counters must match exactly.  Loss and ``w_mean`` differ by
float32 summation order, and on the dynamic path by the power
``w ** s``, which XLA takes as ``pow`` of a float32 and an int32 and
PyTorch as products (s = 2, 3) or ``powf``: measured on the CPU over
16 rounds, the largest deviations over the cases are 7.1e-7 relative in
loss and 6.0e-7 in ``w_mean`` (each case prints its own);
:data:`PIPE_LOSS_RTOL` and :data:`PIPE_W_MEAN_ATOL` leave room for a few
more ulps.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import golden
from repro_torch.bridge import load_flat, subtree
from repro_torch.configs.base import CELUConfig
from repro_torch.core import engine
from repro_torch.core.workset import (workset_draw, workset_init,
                                      workset_insert, workset_sample)
from repro_torch.data import to_device
from repro_torch.data.synthetic import (TabularSpec, aligned_batches,
                                        make_tabular)
from repro_torch.launch.wan import (WANClock, transport_round_updown,
                                    wan_seconds)
from repro_torch.models.tabular import make_dlrm
from repro_torch.optim import make_optimizer
from test_torch_compression import jax_uniforms
from test_torch_engine import GOLDEN, _check

torch.set_num_threads(1)

PIPE_LOSS_RTOL = 1e-5
PIPE_W_MEAN_ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return golden.load_params(GOLDEN)


@pytest.fixture(scope="module")
def golden2():
    return golden.load_golden(GOLDEN, "two_party_trace.json")


def _drive(params, depth, rounds=20, *, W=5, R=3, damping=0.25,
           sampling="round_robin", compression="", uniforms=None):
    """The reference's ``test_pipeline_depth._drive`` on the port: the
    two-party golden workload at W wide enough for deep queues -> rows."""
    return golden.pipelined_trace(
        "celu", params, depth, device="cpu", rounds=rounds,
        compression=compression, uniforms=uniforms,
        celu_kw={"R": R, "W": W, "sampling": sampling,
                 "pipeline_lr_damping": damping})


def _build(params, depth, *, W=3, R=3, compression="topk_int8",
           damping=0.25, sampling="round_robin", uniforms=None,
           dynamic=None):
    """-> (engine, its round state, a batch iterator, the initial
    parameters as arrays) on the two-party golden workload; ``dynamic``
    is the engine's ``dynamic_staleness``."""
    cfg = golden.TWO_PARTY_CFG
    data = make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=2048, n_test=512), 0)
    init_fn, task, _ = make_dlrm(cfg)
    p = init_fn(0, cfg, "cpu")
    load_flat(p["a"], subtree(params, "two_party.a"))
    load_flat(p["b"], subtree(params, "two_party.b"))
    p0 = [t.detach().clone() for k in ("a", "b") for t in p[k].parameters()]
    celu = CELUConfig(R=R, W=W, xi_degrees=60.0, sampling=sampling,
                      pipeline_lr_damping=damping)
    opt = make_optimizer("adagrad", 0.05)
    tp = engine.make_transport(celu, compression)
    etask = engine.lift_two_party(task)
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    state = engine.init_state(etask, engine.lift_two_party_params(p), opt,
                              celu, [to_device(ba, "cpu")],
                              to_device(bb, "cpu"), transport=tp,
                              uniforms=uniforms)
    pe = engine.PipelinedEngine(etask, opt, celu, depth=depth, transport=tp,
                                dynamic_staleness=dynamic)
    batches = (([to_device(ba, "cpu")], to_device(bb, "cpu"), bi)
               for bi, ba, bb in aligned_batches(data["train"], 64, seed=0))
    return pe, pe.init(state), batches, p0


def _losses(rows):
    return [r["loss"] for r in rows[:-1] if not math.isnan(r["loss"])]


def _rows_equal(a, b) -> bool:
    """Row lists equal, NaN equal to NaN (the warm-up losses)."""
    def same(x, y):
        if isinstance(x, float) and math.isnan(x):
            return isinstance(y, float) and math.isnan(y)
        return x == y
    return len(a) == len(b) and all(
        ra.keys() == rb.keys() and all(same(ra[k], rb[k]) for k in ra)
        for ra, rb in zip(a, b))


# --------------------------------------------------------------------------
# Depth 0: the staged pipeline is the sequential round
# --------------------------------------------------------------------------
@pytest.mark.parametrize("protocol", ["vanilla", "fedbcd", "celu"])
def test_depth0_matches_golden_two_party(protocol, params, golden2):
    """dispatch -> merge -> local at depth 0: within the goldens'
    tolerance, and bitwise the port's ``make_round``."""
    got = golden.pipelined_trace(protocol, params, 0, device="cpu")
    _check(golden.compare(got, golden2[protocol]))
    assert got == golden.two_party_trace(protocol, params, device="cpu")


def test_depth0_matches_golden_two_party_identity_codec(params, golden2):
    got = golden.pipelined_trace("celu", params, 0, device="cpu",
                                 compression="identity")
    _check(golden.compare(got, golden2["celu"]))
    assert got == golden.two_party_trace("celu", params, device="cpu")


def test_depth0_matches_golden_three_party(params):
    """The K = 2 feature-party workload through the depth-0 pipeline:
    within the golden's tolerance and bitwise ``make_round``."""
    got = golden.three_party_trace(params, device="cpu", depth=0)
    _check(golden.compare(got, golden.load_golden(
        GOLDEN, "three_party_trace.json")["celu"]))
    assert got == golden.three_party_trace(params, device="cpu")


# --------------------------------------------------------------------------
# Depth 1: overlap semantics
# --------------------------------------------------------------------------
def test_depth1_converges_to_depth0_quality(params):
    """One exchange of extra staleness, the same loss region."""
    seq = golden.pipelined_trace("celu", params, 0, device="cpu",
                                 rounds=40)
    pipe = golden.pipelined_trace("celu", params, 1, device="cpu",
                                  rounds=40)
    l_seq, l_pipe = _losses(seq), _losses(pipe)
    assert np.isfinite(l_pipe).all()
    assert np.mean(l_pipe[-10:]) < np.mean(l_pipe[:5])
    assert np.mean(l_pipe[-10:]) <= 1.10 * np.mean(l_seq[-10:])


def test_depth1_step_accounting(params):
    """Every round funds 1 fresh + up to R local updates; the flush
    drains the last in-flight local scan."""
    rounds, R = 20, 3
    rows = golden.pipelined_trace("celu", params, 1, device="cpu",
                                  rounds=rounds)
    tail = rows[-1]
    assert tail["comm_rounds"] == rounds
    assert rounds < tail["steps_a"] <= rounds * (1 + R)
    assert rounds < tail["steps_b"] <= rounds * (1 + R)
    assert rows[0]["local_steps"] == 0      # round 0 scans an empty ring


def test_depth1_compressed_transport_in_flight_residuals(params):
    """Error feedback composes with the pipeline."""
    rows = golden.pipelined_trace("celu", params, 1, device="cpu",
                                  rounds=12, compression="int8_topk")
    losses = _losses(rows)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_scheduler_stage_protocol_errors(params):
    """Dispatch twice without a merge, a merge without a dispatch and a
    finalize with an exchange in flight are loud scheduler bugs."""
    pe, rs, it, _ = _build(params, 1, W=2, R=2, compression="")
    bas, b, bi = next(it)
    with pytest.raises(RuntimeError, match="no exchange in flight"):
        pe.merge(rs)
    rs = pe.dispatch(rs, bas, b, bi)
    with pytest.raises(RuntimeError, match="already in flight"):
        pe.dispatch(rs, bas, b, bi)
    with pytest.raises(RuntimeError, match="still in flight"):
        pe.finalize(rs)
    rs, _ = pe.merge(rs)
    assert int(pe.finalize(rs)["comm_rounds"]) == 1


def test_invalid_depth_rejected():
    """Negative depths and depths the W-slot ring cannot serve are
    refused up front; D = W - 1 is the deepest queue."""
    init_fn, task, _ = make_dlrm(golden.TWO_PARTY_CFG)
    opt = make_optimizer("adagrad", 0.05)
    etask = engine.lift_two_party(task)
    with pytest.raises(ValueError, match="depth"):
        engine.make_pipeline(etask, opt, CELUConfig(), depth=-1)
    with pytest.raises(ValueError, match="depth"):
        engine.make_pipeline(etask, opt, CELUConfig(W=5), depth=5)
    pe = engine.make_pipeline(etask, opt, CELUConfig(W=5), depth=4)
    assert pe.depth == 4 and pe.queue_capacity == 4
    # the sequential round refuses a depth and names the scheduler
    with pytest.raises(ValueError, match="make_pipeline"):
        engine.make_round(etask, opt, CELUConfig(W=5, pipeline_depth=2))


# --------------------------------------------------------------------------
# Pipeline-staleness plumbing
# --------------------------------------------------------------------------
def _entry(v):
    return {"z": torch.full((4, 2), float(v)), "dz": torch.full((4, 2), 1.0)}


def _full_ring(W):
    ws = workset_init(W, _entry(0))
    for t in range(W):
        workset_insert(ws, _entry(t), t)
    return ws


def _copy(ws):
    return {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in ws.items()}


def test_pipeline_staleness_tightens_validity_window():
    """At staleness s the oldest s ring slots are retired early."""
    W, R = 4, 8
    ws = _full_ring(W)
    for s, expected in ((0, W), (1, W - 1), (2, W - 2)):
        w2, valid = _copy(ws), 0
        for _ in range(W):
            _, _, _, v = workset_sample(w2, R, "round_robin",
                                        pipeline_staleness=s)
            valid += int(v)
        assert valid == expected, (s, valid)


def test_pipeline_attenuation_properties():
    from repro_torch.core.weighting import pipeline_attenuation
    w = torch.tensor([0.0, 0.5, 0.9, 1.0])
    out = pipeline_attenuation(w, 1).numpy()
    assert out[0] == 0.0 and out[3] == 1.0
    assert np.all(out <= w.numpy() + 1e-7)
    np.testing.assert_allclose(out[1], 0.25, rtol=1e-6)
    np.testing.assert_array_equal(pipeline_attenuation(w, 0).numpy(),
                                  w.numpy())


def _rows3(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(64, 8)).astype(np.float32) for _ in range(3)]


def test_weighted_cotangent_staleness_fused_matches_reference():
    """The gate kernel's post-scale composition of the discount (K2a's
    plain version here) against the reference's, fused and unfused: the
    discounted weight multiplies the cotangent once."""
    from repro.core import engine as jengine
    a, s, dz = _rows3(7)
    w_t, cot_t = engine.weighted_cotangent(
        torch.from_numpy(a), torch.from_numpy(s), torch.from_numpy(dz), 0.5,
        pipeline_staleness=1)
    for fused in (True, False):
        w_r, cot_r = jengine.weighted_cotangent(
            jnp.asarray(a), jnp.asarray(s), jnp.asarray(dz), 0.5,
            fused=fused, pipeline_staleness=1)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_r), rtol=3e-7,
                                   atol=3e-7)
        np.testing.assert_allclose(cot_t.numpy(), np.asarray(cot_r),
                                   rtol=3e-6, atol=3e-6)
    alive = w_t.numpy() > 0
    np.testing.assert_allclose(cot_t.numpy()[alive],
                               (w_t.numpy()[:, None] * dz)[alive],
                               rtol=3e-6, atol=3e-6)


@pytest.mark.parametrize("s", [0, 1, 2, 3])
@pytest.mark.parametrize("dynamic", [False, True])
def test_post_scale_matches_reference(s, dynamic):
    """``_attenuate_post_scale`` against the reference's, on the same
    gate output: static s (a Python int there, bitwise) and runtime s (a
    traced int32 there, ``pow`` in XLA; within an ulp or two)."""
    from repro.core import engine as jengine
    a, st, dz = _rows3(11 + s)
    w0, cot0 = engine.weighted_cotangent(torch.from_numpy(a),
                                         torch.from_numpy(st),
                                         torch.from_numpy(dz), 0.5)
    w_t, cot_t = engine._attenuate_post_scale(w0, cot0, s, dynamic)
    jw, jc = jnp.asarray(w0.numpy()), jnp.asarray(cot0.numpy())
    if dynamic:
        w_r, cot_r = jax.jit(jengine._attenuate_post_scale)(jw, jc,
                                                            jnp.int32(s))
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_r), rtol=3e-7,
                                   atol=0)
        np.testing.assert_allclose(cot_t.numpy(), np.asarray(cot_r),
                                   rtol=3e-7, atol=1e-9)
    else:
        w_r, cot_r = jengine._attenuate_post_scale(jw, jc, s)
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_r))
        np.testing.assert_array_equal(cot_t.numpy(), np.asarray(cot_r))


# --------------------------------------------------------------------------
# The WAN clock (overlap-aware simulated time)
# --------------------------------------------------------------------------
def test_wanclock_per_direction_bandwidth():
    clock = WANClock(up_bandwidth=1e6, down_bandwidth=2e6, latency=0.01)
    assert clock.up_seconds(1e6) == pytest.approx(1.0)
    assert clock.down_seconds(1e6) == pytest.approx(0.5)
    assert clock.wire_seconds(1e6, 1e6) == pytest.approx(1.52)


def test_wanclock_overlap_round_latency():
    clock = WANClock(up_bandwidth=1e6, down_bandwidth=1e6, latency=0.0)
    kw = dict(exchange_compute_s=0.1, local_compute_s=0.9)
    seq = clock.round_seconds(5e5, 5e5, pipeline_depth=0, **kw)
    pipe = clock.round_seconds(5e5, 5e5, pipeline_depth=1, **kw)
    assert seq == pytest.approx(0.1 + 1.0 + 0.9)
    assert pipe == pytest.approx(max(0.1 + 1.0, 0.9))
    assert seq / pipe == pytest.approx(2.0 / 1.1)
    pipe2 = clock.round_seconds(5e4, 5e4, pipeline_depth=1,
                                exchange_compute_s=0.1, local_compute_s=5.0)
    assert pipe2 == pytest.approx(5.0)


def test_wanclock_paper_geometry_example():
    """Paper §2.1: an 8 MB fp32 exchange over 300 Mbps + latency."""
    t = WANClock().wire_seconds(4096 * 256 * 4, 4096 * 256 * 4)
    assert 0.20 < t < 0.26


def test_wan_seconds_wrapper_and_transport_split():
    tp = engine.make_transport(CELUConfig(), "int8_topk")
    up, down = transport_round_updown(tp, [(256, 32)])
    assert up == tp.uplink_bytes((256, 32))
    assert down == tp.downlink_bytes((256, 32))
    assert up != down
    clock = WANClock(up_bandwidth=1e6, down_bandwidth=1e6, latency=0.0)
    assert wan_seconds(up, down, clock=clock) == \
        pytest.approx((up + down) / 1e6)
    with pytest.raises(TypeError):
        wan_seconds(1e6, clock=clock)


# --------------------------------------------------------------------------
# Flush / merge drain on a partly filled queue
# --------------------------------------------------------------------------
def test_flush_partial_queue_merges_in_dispatch_order(params):
    """Interrupted mid-warm-up, a depth-2 queue is merged oldest first,
    once each, and the in-flight residual chain is adopted intact."""
    pe, rs, it, _ = _build(params, 2)
    idxs = []
    for _ in range(2):
        bas, b, bi = next(it)
        rs = pe.dispatch(rs, bas, b, bi)
        idxs.append(int(bi))
    assert [int(p.batch_idx) for p in rs.pending] == idxs
    with pytest.raises(RuntimeError, match="in flight"):
        pe.dispatch(rs, bas, b, bi)
    tail_ts = {d: [r.clone() for r in v]
               for d, v in rs.pending[-1].fresh["tstate"].items()}
    merged, orig_merge = [], pe.merge

    def recording_merge(rs, **kw):
        merged.append(int(rs.pending[0].batch_idx))
        return orig_merge(rs, **kw)

    pe.merge = recording_merge
    c0 = rs.round
    rs, lm = pe.flush(rs)
    assert merged == idxs
    assert int(rs.comm_rounds) == rs.round == c0 + 2
    assert not rs.pending
    assert int(lm["local_steps"]) > 0
    for d, v in tail_ts.items():
        for got, want in zip(rs.transport[d], v):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no exchange in flight"):
        orig_merge(rs)
    pe.finalize(rs)


def test_flush_partial_queue_single_slot(params):
    """One step into a depth-2 run: NaN loss, one exchange in flight; the
    flush merges exactly that one."""
    pe, rs, it, _ = _build(params, 2)
    bas, b, bi = next(it)
    rs, m = pe.step(rs, bas, b, bi)
    assert math.isnan(float(m["loss"]))
    assert len(rs.pending) == 1
    rs, _ = pe.flush(rs)
    assert not rs.pending
    st = pe.finalize(rs)
    assert int(st["comm_rounds"]) == 1
    assert int(st["steps"]["b"]) > 0


# --------------------------------------------------------------------------
# Depth D >= 2: scheduling, determinism, accounting
# --------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [2, 4])
def test_depthD_queue_fill_and_step_accounting(depth, params):
    """The first D - 1 steps only fill the queue (NaN loss); after the
    flush every exchange is merged and every funded scan has run."""
    rounds, R = 24, 3
    rows = _drive(params, depth, rounds=rounds, R=R)
    for i in range(depth - 1):
        assert math.isnan(rows[i]["loss"]), (depth, i)
    assert not math.isnan(rows[depth - 1]["loss"])
    tail = rows[-1]
    assert tail["comm_rounds"] == rounds
    assert rounds < tail["steps_a"] <= rounds * (1 + R)
    assert rounds < tail["steps_b"] <= rounds * (1 + R)
    assert rows[0]["local_steps"] == 0


@pytest.mark.parametrize("depth", [2, 4])
def test_depthD_deterministic(depth, params):
    a = _drive(params, depth, rounds=16)
    b = _drive(params, depth, rounds=16)
    assert _rows_equal(a, b)


def test_merge_consumes_oldest_exchange_first(params):
    pe, rs, it, _ = _build(params, 2, W=5, compression="")
    bas, b, _ = next(it)
    rs = pe.dispatch(rs, bas, b, 100)
    rs = pe.dispatch(rs, bas, b, 101)
    assert [int(p.batch_idx) for p in rs.pending] == [100, 101]
    rs, _ = pe.merge(rs)
    inserted = rs.ws["a"][0]["batch_idx"].numpy()
    assert 100 in inserted and 101 not in inserted
    rs, _ = pe.merge(rs)
    assert 101 in rs.ws["a"][0]["batch_idx"].numpy()
    assert int(pe.finalize(rs)["comm_rounds"]) == 2


def test_dispatch_beyond_queue_capacity_rejected(params):
    pe, rs, it, _ = _build(params, 2, W=5, compression="")
    bas, b, bi = next(it)
    rs = pe.dispatch(rs, bas, b, bi)
    rs = pe.dispatch(rs, bas, b, bi)
    with pytest.raises(RuntimeError, match="already in flight"):
        pe.dispatch(rs, bas, b, bi)
    with pytest.raises(RuntimeError, match="still in flight"):
        pe.finalize(rs)


def test_depth_exceeding_ring_capacity_rejected():
    with pytest.raises(ValueError, match="pipeline_depth"):
        CELUConfig(W=5, pipeline_depth=5)
    with pytest.raises(ValueError, match="pipeline_depth"):
        CELUConfig(pipeline_depth=-1)
    with pytest.raises(ValueError, match="pipeline_lr_damping"):
        CELUConfig(pipeline_lr_damping=-0.5)
    _, task, _ = make_dlrm(golden.TWO_PARTY_CFG)
    with pytest.raises(ValueError, match="depth"):
        engine.make_pipeline(engine.lift_two_party(task),
                             make_optimizer("adagrad", 0.05),
                             CELUConfig(W=3), depth=3)


def test_depth2_converges_to_depth0_quality(params):
    seq = _drive(params, 0, rounds=40)
    deep = _drive(params, 2, rounds=40)
    l_seq, l_deep = _losses(seq), _losses(deep)
    assert np.isfinite(l_deep).all()
    assert np.mean(l_deep[-10:]) < np.mean(l_deep[:5])
    assert np.mean(l_deep[-10:]) <= 1.15 * np.mean(l_seq[-10:])


def test_lr_damping_shrinks_parameter_drift(params):
    """1 / (1 + c·s): a larger c moves the parameters less over the same
    depth-2 schedule."""
    def drift(damping):
        pe, rs, it, p0 = _build(params, 2, W=5, compression="",
                                damping=damping)
        for _, (bas, b, bi) in zip(range(12), it):
            rs, _ = pe.step(rs, bas, b, bi)
        rs, _ = pe.flush(rs)
        st = pe.finalize(rs)
        p1 = [t for k in ("a", "b") for t in
              engine.unlift_params(st["params"])[k].parameters()]
        return float(sum(((a.detach() - b) ** 2).sum()
                         for a, b in zip(p1, p0)) ** 0.5)
    d_undamped, d_damped = drift(0.0), drift(5.0)
    assert 0 < d_damped < d_undamped


def test_inflight_residual_chain_follows_dispatch_order(params):
    """Lossy wire, two exchanges in flight: the second encodes against
    the first's residuals, not the merged prefix's."""
    pe, rs, it, _ = _build(params, 2, W=5, compression="int8_topk",
                           uniforms=jax_uniforms)
    bas, b, bi = next(it)
    rs = pe.dispatch(rs, bas, b, bi)
    bas2, b2, bi2 = next(it)
    rs = pe.dispatch(rs, bas2, b2, bi2)
    r1 = rs.pending[0].fresh["tstate"]["up"][0]
    assert float(r1.abs().sum()) > 0.0
    with torch.enable_grad():
        expect = pe._compute(rs.params, rs.pending[0].fresh["tstate"],
                             bas2, b2, rs.round + 1, rs.uniforms)
        stale = pe._compute(rs.params, rs.transport, bas2, b2,
                            rs.round + 1, rs.uniforms)
    # the source is a function of the key, so the recomputation from the
    # first exchange's residuals reproduces the payload exactly, and the
    # one from the merged prefix's (zero) residuals does not
    got = rs.pending[1].fresh["zs"][0]
    assert torch.equal(got, expect["zs"][0])
    assert not torch.equal(got, stale["zs"][0])


def test_depth2_compressed_transport_trains(params):
    pe, rs, it, _ = _build(params, 2, W=5, compression="int8_topk")
    losses = []
    for _, (bas, b, bi) in zip(range(14), it):
        rs, m = pe.step(rs, bas, b, bi)
        losses.append(float(m["loss"]))
    rs, _ = pe.flush(rs)
    st = pe.finalize(rs)
    losses = [x for x in losses if not math.isnan(x)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert float(st["transport"]["up"][0].abs().sum()) > 0.0


def test_uniform_sampling_depth2_trains(params):
    rows = _drive(params, 2, rounds=16, sampling="uniform")
    assert np.isfinite(_losses(rows)).all()
    assert rows[-1]["comm_rounds"] == 16


# --------------------------------------------------------------------------
# Per-slot staleness: a host int on the dynamic path
# --------------------------------------------------------------------------
def test_traced_staleness_reaches_workset_draw():
    """A per-slot offset tightens the validity window like the depth."""
    W, R = 4, 8
    ws = _full_ring(W)
    for s, expected in ((0, W), (1, W - 1), (2, W - 2), (3, W - 3)):
        w2, valid = _copy(ws), 0
        for _ in range(W):
            _, _, _, v = workset_draw(w2, R, "round_robin",
                                      pipeline_staleness=s)
            valid += int(v)
        assert valid == expected, (s, valid)


def test_traced_staleness_reaches_workset_sample():
    W, R = 4, 8
    ws = _full_ring(W)
    _, e, _, v0 = workset_sample(_copy(ws), R, "consecutive",
                                 pipeline_staleness=0)
    assert bool(v0)
    np.testing.assert_array_equal(e["z"].numpy(), _entry(W - 1)["z"].numpy())
    _, _, _, v_dead = workset_sample(_copy(ws), R, "consecutive",
                                     pipeline_staleness=W)
    assert not bool(v_dead)


@pytest.mark.parametrize("s", [0, 1, 3])
def test_fused_post_scale_traced_staleness_parity(s):
    """The dynamic post-scale of the gate kernel's output against the
    unfused reference composition and against the static path."""
    from repro.core import engine as jengine
    a, st, dz = _rows3(11)
    ta, tst, tdz = (torch.from_numpy(x) for x in (a, st, dz))
    w_f, cot_f = engine.weighted_cotangent(ta, tst, tdz, 0.5,
                                           pipeline_staleness=s,
                                           dynamic=True)
    w_r, cot_r = jax.jit(lambda s_: jengine.weighted_cotangent(
        jnp.asarray(a), jnp.asarray(st), jnp.asarray(dz), 0.5, fused=False,
        pipeline_staleness=s_))(jnp.int32(s))
    np.testing.assert_allclose(w_f.numpy(), np.asarray(w_r), rtol=3e-6,
                               atol=3e-7)
    np.testing.assert_allclose(cot_f.numpy(), np.asarray(cot_r), rtol=3e-6,
                               atol=3e-6)
    w_s, cot_s = engine.weighted_cotangent(ta, tst, tdz, 0.5,
                                           pipeline_staleness=s)
    np.testing.assert_allclose(w_f.numpy(), w_s.numpy(), rtol=3e-6,
                               atol=3e-7)
    np.testing.assert_allclose(cot_f.numpy(), cot_s.numpy(), rtol=3e-6,
                               atol=3e-6)
    assert np.all(w_f.numpy()[np.asarray(w_r) == 0.0] == 0.0)


def test_traced_staleness_zero_is_identity():
    a, st, dz = (torch.from_numpy(x) for x in _rows3(12))
    w_d, cot_d = engine.weighted_cotangent(a, st, dz, 0.5, dynamic=True)
    w_0, cot_0 = engine.weighted_cotangent(a, st, dz, 0.5)
    assert torch.equal(w_d, w_0) and torch.equal(cot_d, cot_0)


# --------------------------------------------------------------------------
# The port against the reference's PipelinedEngine on injected uniforms
# --------------------------------------------------------------------------
def _jax_drive(depth, rounds, *, W=5, R=3, damping=0.25,
               sampling="round_robin", compression="", dynamic=None):
    """The reference's ``test_pipeline_depth._drive`` from the fixture's
    initial parameters -> golden rows; ``dynamic`` is its engine's
    ``dynamic_staleness``."""
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
    celu = JCELU(R=R, W=W, xi_degrees=60.0, sampling=sampling,
                 pipeline_lr_damping=damping, compression=compression)
    opt = jmake_optimizer("adagrad", 0.05)
    asj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    etask = jengine.lift_two_party(task)
    state = jengine.init_state(etask, jengine.lift_two_party_params(p), opt,
                               celu, [asj(ba)], asj(bb))
    pe = jengine.PipelinedEngine(etask, opt, celu, depth=depth,
                                 dynamic_staleness=dynamic)
    rs = pe.init(state)
    it = aligned_batches(data["train"], 64, seed=0)
    rows = []
    for _ in range(rounds):
        bi, ba, bb = next(it)
        rs, m = pe.step(rs, [asj(ba)], asj(bb), bi)
        rows.append(golden._rows_metrics(m))
    rs, _ = pe.flush(rs)
    st = pe.finalize(rs)
    rows.append({"steps_a": int(st["steps"]["a"][0]),
                 "steps_b": int(st["steps"]["b"]),
                 "comm_rounds": int(st["comm_rounds"])})
    return rows


def _deviation(got, want) -> dict:
    """Exact counters (NaN warm-up losses on the same rounds) and the
    largest loss (relative) and ``w_mean`` deviations."""
    assert got[-1] == want[-1], (got[-1], want[-1])
    loss, w_mean = 0.0, 0.0
    for g, w in zip(got[:-1], want[:-1], strict=True):
        assert g["local_steps"] == w["local_steps"], (g, w)
        assert math.isnan(g["loss"]) == math.isnan(w["loss"]), (g, w)
        if not math.isnan(w["loss"]):
            loss = max(loss, abs(g["loss"] - w["loss"]) / abs(w["loss"]))
        w_mean = max(w_mean, abs(g["w_mean"] - w["w_mean"]))
    return {"loss_rel": loss, "w_mean_abs": w_mean}


REF_CASES = [
    (1, {}), (2, {}), (4, {}),
    (1, {"sampling": "uniform"}), (2, {"sampling": "uniform"}),
    (4, {"sampling": "uniform"}),
    (1, {"compression": "int8_topk"}), (2, {"compression": "int8_topk"}),
    (2, {"damping": 0.0}), (2, {"damping": 5.0}),
]


@pytest.mark.parametrize("depth,kw", REF_CASES)
def test_pipeline_matches_reference_on_injected_uniforms(depth, kw, params):
    rounds = 16
    want = _jax_drive(depth, rounds, **kw)
    got = _drive(params, depth, rounds=rounds, uniforms=jax_uniforms, **kw)
    dev = _deviation(got, want)
    print(depth, kw, dev)
    assert dev["loss_rel"] <= PIPE_LOSS_RTOL, dev
    assert dev["w_mean_abs"] <= PIPE_W_MEAN_ATOL, dev


@pytest.mark.parametrize("depth", [0, 1])
def test_forced_dynamic_staleness_matches_reference(depth, params):
    """``dynamic_staleness=True`` takes the dynamic path at depths 0 / 1
    (the chaos engine's switch): the always-applied float power, the
    damping (1 at s = 0) and the ``("draw_s", ...)`` keys, against the
    reference's engine built the same way, on uniform draws."""
    rounds = 12
    want = _jax_drive(depth, rounds, sampling="uniform", dynamic=True)
    pe, rs, it, _ = _build(params, depth, W=5, compression="",
                           sampling="uniform", uniforms=jax_uniforms,
                           dynamic=True)
    assert pe.dynamic
    rows = []
    for _, (bas, b, bi) in zip(range(rounds), it):
        rs, m = pe.step(rs, bas, b, bi)
        rows.append(golden._rows_metrics(m))
    rs, _ = pe.flush(rs)
    st = pe.finalize(rs)
    rows.append({"steps_a": int(st["steps"]["a"][0]),
                 "steps_b": int(st["steps"]["b"]),
                 "comm_rounds": int(st["comm_rounds"])})
    dev = _deviation(rows, want)
    print(depth, dev)
    assert dev["loss_rel"] <= PIPE_LOSS_RTOL, dev
    assert dev["w_mean_abs"] <= PIPE_W_MEAN_ATOL, dev


def test_uniform_draw_matches_reference_categorical():
    """The uniform draw is ``jax.random.categorical`` over the alive slots
    on the same key: the same slots, also with none alive (zero
    logits), and the cursor stays put."""
    from repro.core import workset as jws
    from repro_torch.core.uniforms import UniformKey
    W, R = 5, 2
    e = {"z": np.zeros((4, 2), np.float32), "dz": np.ones((4, 2),
                                                          np.float32)}
    tw = workset_init(W, {k: torch.from_numpy(v) for k, v in e.items()})
    jw = jws.workset_init(W, {k: jnp.asarray(v) for k, v in e.items()})
    slots = []
    for t in range(3 * W):
        if t % 2 == 0 and t < 2 * W:
            workset_insert(tw, {k: torch.from_numpy(v) for k, v in
                                e.items()}, t)
            jw = jws.workset_insert(jw, {k: jnp.asarray(v) for k, v in
                                         e.items()}, t)
        tag = ("draw", t, 0, 1)
        _, slot, _, valid = workset_draw(
            tw, R, "uniform", rng=UniformKey(jax_uniforms, tag))
        jw, jslot, _, jvalid = jws.workset_draw(
            jw, R, "uniform", rng=jax.random.fold_in(jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(29), t), 0), 1))
        assert slot.dtype == torch.int32 and slot.dim() == 0
        assert (int(slot), bool(valid)) == (int(jslot), bool(jvalid))
        for k in ("use_count", "cursor"):
            np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))
        slots.append(int(slot))
    assert len(set(slots)) > 1
    with pytest.raises(ValueError, match="rng"):
        workset_draw(tw, R, "uniform")


def test_inflight_payload_aliases_no_state(params):
    """An in-flight exchange's tensors are not written by the local scans
    and merges that run while it waits: a depth-2 queue's newest payload,
    cloned at dispatch, is unchanged at its merge."""
    pe, rs, it, _ = _build(params, 2, W=5, compression="int8_topk")

    def tensors(fresh):
        out = list(fresh["zs"]) + list(fresh["dzs"]) + list(fresh["g_b"])
        for g in fresh["g_as"]:
            out += list(g)
        return out + [fresh["loss"]] + [r for v in fresh["tstate"].values()
                                        for r in v]
    seen = {}
    for _, (bas, b, bi) in zip(range(8), it):
        rs = pe.dispatch(rs, bas, b, bi)
        seen[id(rs.pending[-1])] = (rs.pending[-1],
                                    [t.clone() for t in tensors(
                                        rs.pending[-1].fresh)])
        rs, _ = pe.local(rs)
        if len(rs.pending) == pe.depth:
            p = rs.pending[0]
            for got, want in zip(tensors(p.fresh), seen.pop(id(p))[1]):
                assert torch.equal(got, want)
            rs, _ = pe.merge(rs)


def test_schedule_never_reads_the_card(params, monkeypatch):
    """No stage of the scheduler reads a tensor back to the host: the
    staleness, the wire round and the draw round are host ints.  Reading
    a value (``item``, ``bool``, ``int``, ``float``) raises here."""
    pe, rs, it, _ = _build(params, 2, W=5, compression="int8",
                           sampling="uniform")
    batches = [next(it) for _ in range(6)]

    def refuse(self, *a, **kw):
        raise AssertionError("a stage read a tensor back to the host")

    for name in ("item", "__bool__", "__int__", "__float__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for bas, b, bi in batches:
        rs, m = pe.step(rs, bas, b, bi)
    rs, _ = pe.flush(rs)
    monkeypatch.undo()
    assert int(pe.finalize(rs)["comm_rounds"]) == 6


@pytest.mark.parametrize("depth", [0, 1, 2, 4])
def test_chip_smoke_schedule_launch_counts_are_the_engines_calls(
        depth, monkeypatch):
    """``chip_smoke.py`` holds the pipeline phase's K1 and K7 launches on
    the card to counts it derives from the scheduler's code
    (``_pipeline_schedule``); here the derivation must equal the calls of
    the two kernels' wrappers in a small CLI run at each depth (their
    plain versions run on the CPU, so the calls are counted)."""
    import collections
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from repro_torch.kernels import fused_adagrad as fag
    from repro_torch.kernels import fused_sample as fs
    from repro_torch.launch.train import train_dlrm
    calls = collections.Counter()
    for mod, name, key in ((fs, "fused_sample_2d", "fused_sample_2d"),
                           (fag, "fused_adagrad_step_", "fused_adagrad")):
        def run(*a, fn=getattr(mod, name), key=key, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, run)
    rounds = 6
    args = chip_smoke.train_args("wdl-criteo", rounds=rounds, device="cpu",
                                 small=True, n_train=1024, n_test=256,
                                 batch_size=32, pipeline_depth=depth)
    out = train_dlrm(args)
    n = chip_smoke._adagrad_launches(chip_smoke._party_tensors(out))
    assert dict(calls) == chip_smoke._wdl_launches(depth, rounds, n)
    assert chip_smoke._pipeline_schedule(depth, rounds)[1] == rounds
