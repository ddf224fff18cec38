"""The port's chaos layer (``repro_torch.core.faults``) on the CPU.

The first eleven cases mirror ``tests/test_faults.py`` one for one, on the
port, at the same geometry:
  * ``plan=None`` is bitwise ``PipelinedEngine`` at every depth;
  * the fault schedule is a function of ``(seed, round)`` alone;
  * a dropped exchange is absorbed into the error-feedback residuals and
    training goes on from cached statistics;
  * a dropout span freezes exactly the down party, which rejoins;
  * a checkpoint of the round state and ``host_state`` restores into a
    fresh engine, and the continued run is bitwise the uninterrupted one.

Then the port against the reference: the fates and masks of three plans
over 200 rounds are equal; ``ChaosEngine`` beside the reference's, at
depths 1 and 2 under a plan that drops, straggles and takes a party down,
fed the same uniforms (``jax_uniforms``; the wire's tag carries the
dispatch sequence number), has equal counters and event logs, and its
losses and ``w_mean`` within ``PIPE_LOSS_RTOL`` / ``PIPE_W_MEAN_ATOL`` of
``test_torch_pipeline.py`` (the chaos path is always the dynamic one);
``recover_dropped`` equals the reference's within 1e-6.  The schedule
reads no tensor back to the host through a dropped, a stalled and a
down round, and ``chip_smoke.py``'s launch derivation for its chaos
phase equals the kernel wrappers' calls.
"""
import collections
import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import golden
from repro_torch.bridge import load_flat, subtree
from repro_torch.configs.base import CELUConfig, DropoutSpan, FaultPlan
from repro_torch.core import engine
from repro_torch.core.faults import (ExchangeFate, FaultSchedule,
                                     make_chaos_engine)
from repro_torch.core.uniforms import UniformKey
from repro_torch.data import to_device
from repro_torch.data.synthetic import (TabularSpec, aligned_batches,
                                        make_tabular)
from repro_torch.launch import wan
from repro_torch.models.tabular import make_dlrm
from repro_torch.optim import make_optimizer
from test_torch_compression import jax_key, jax_uniforms
from test_torch_engine import GOLDEN
from test_torch_pipeline import PIPE_LOSS_RTOL, PIPE_W_MEAN_ATOL, _deviation

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# drops (rounds 8, 11), stragglers (0, 10, 12, 13) and a0 down over
# rounds 4-6 in 16 rounds
PARITY_PLAN = FaultPlan(seed=2, drop_prob=0.25, max_retries=1,
                        straggler_prob=0.3, straggler_rounds=2,
                        dropouts=(DropoutSpan(party="a0", start=4,
                                              rounds=3),))


def _workload():
    spec = TabularSpec("criteo", fields_a=4, fields_b=3, vocab=32,
                       n_train=2048, n_test=512)
    return make_tabular(spec, seed=0), golden.TWO_PARTY_CFG


def _build(depth, plan=None, *, chaos=True, compression="topk_int8",
           cache_dtype="float32", seed=0, params=None, uniforms=None):
    """The reference's ``test_faults._build`` on the port -> (engine,
    round state, batch iterator).  ``params``: the golden fixture's
    parameters (the reference's draw), else the port's own from
    ``seed``."""
    data, cfg = _workload()
    init_fn, task, _ = make_dlrm(cfg)
    base = CELUConfig(R=3, W=3, xi_degrees=60.0, cache_dtype=cache_dtype)
    ccfg, nloc = engine.preset_config("celu", base)
    p = init_fn(seed, cfg, "cpu")
    if params is not None:
        load_flat(p["a"], subtree(params, "two_party.a"))
        load_flat(p["b"], subtree(params, "two_party.b"))
    opt = make_optimizer("adagrad", 0.05)
    etask = engine.lift_two_party(task)
    tp = engine.make_transport(ccfg, compression)
    it = aligned_batches(data["train"], 64, seed=seed)
    _, ba, bb = next(it)
    state = engine.init_state(etask, engine.lift_two_party_params(p), opt,
                              ccfg, [to_device(ba, "cpu")],
                              to_device(bb, "cpu"), transport=tp,
                              uniforms=uniforms)
    if chaos:
        pe = make_chaos_engine(etask, opt, ccfg, plan=plan, depth=depth,
                               local_steps=nloc, transport=tp)
    else:
        pe = engine.make_pipeline(etask, opt, ccfg, depth=depth,
                                  local_steps=nloc, transport=tp)
    batches = (([to_device(ba, "cpu")], to_device(bb, "cpu"), bi)
               for bi, ba, bb in aligned_batches(data["train"], 64,
                                                 seed=seed))
    return pe, pe.init(state), batches


def _drive(pe, rs, batches, rounds):
    losses = []
    for _ in range(rounds):
        bas, b, bi = next(batches)
        rs, m = pe.step(rs, bas, b, bi)
        losses.append(float(m["loss"]))
    return rs, losses


def _leaves(tree):
    """Every tensor and host int of a state dict, in a fixed order."""
    if isinstance(tree, torch.nn.Module):
        return [p.detach() for _, p in sorted(tree.named_parameters())]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "tensors"):
        return list(tree.tensors())
    if hasattr(tree, "q"):
        return [tree.q, tree.scale]
    if isinstance(tree, (int, torch.Tensor)):
        return [tree]
    return []


def _assert_states_equal(s0, s1):
    l0 = _leaves({k: v for k, v in s0.items() if k != "uniforms"})
    l1 = _leaves({k: v for k, v in s1.items() if k != "uniforms"})
    assert len(l0) == len(l1)
    for a, b in zip(l0, l1):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


# --------------------------------------------------------------------------
# plan=None: bitwise the base scheduler
# --------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_plan_none_bit_identical(depth):
    pe0, rs0, it0 = _build(depth, chaos=False)
    rs0, l0 = _drive(pe0, rs0, it0, 10)
    rs0, _ = pe0.flush(rs0)
    st0 = pe0.finalize(rs0)

    pe1, rs1, it1 = _build(depth, plan=None, chaos=True)
    rs1, l1 = _drive(pe1, rs1, it1, 10)
    rs1, _ = pe1.flush(rs1)
    st1 = pe1.finalize(rs1)

    np.testing.assert_array_equal(np.asarray(l0, np.float32),
                                  np.asarray(l1, np.float32))
    _assert_states_equal(st0, st1)


def test_overrides_need_the_dynamic_path():
    """The chaos hooks of ``local`` / ``merge`` raise the reference's
    error on the static path (depths 0 / 1 without a plan); the chaos
    engine under a plan always takes the dynamic one."""
    pe, rs, it = _build(1, chaos=False)
    bas, b, bi = next(it)
    rs = pe.dispatch(rs, bas, b, bi)
    mask = torch.ones(2)
    for call in (lambda: pe.local(rs, staleness=1),
                 lambda: pe.local(rs, party_mask=mask),
                 lambda: pe.merge(rs, staleness=1)):
        with pytest.raises(RuntimeError, match="dynamic"):
            call()
    assert not _build(0, plan=None)[0].dynamic
    assert _build(0, plan=FaultPlan(drop_prob=0.1))[0].dynamic


# --------------------------------------------------------------------------
# Deterministic schedule
# --------------------------------------------------------------------------
def test_fault_schedule_deterministic():
    plan = FaultPlan(seed=11, drop_prob=0.4, max_retries=3,
                     straggler_prob=0.5, straggler_rounds=4)
    a, b = FaultSchedule(plan), FaultSchedule(plan)
    fates_fwd = [a.exchange_fate(t) for t in range(50)]
    fates_rev = [b.exchange_fate(t) for t in reversed(range(50))][::-1]
    assert fates_fwd == fates_rev
    c = FaultSchedule(dataclasses.replace(plan, seed=12))
    assert fates_fwd != [c.exchange_fate(t) for t in range(50)]
    for f in fates_fwd:
        assert 1 <= f.attempts <= 4
        assert 0 <= f.delay_rounds <= 4
        if not f.delivered:
            assert f.attempts == 4 and f.delay_rounds == 0
    quiet = FaultSchedule(FaultPlan(seed=0))
    assert quiet.exchange_fate(7) == ExchangeFate(True, 1, 0)


def test_dropout_span_and_mask():
    plan = FaultPlan(dropouts=(DropoutSpan(party="a0", start=3, rounds=2),
                               DropoutSpan(party="b", start=4, rounds=1)))
    sched = FaultSchedule(plan)
    assert sched.down(2) == ()
    assert sched.down(3) == ("a0",)
    assert set(sched.down(4)) == {"a0", "b"}
    assert sched.down(5) == ()
    mask = sched.party_mask(4, K=2)
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), [0.0, 1.0, 0.0])
    assert sched.party_mask(2, K=2) is None
    bad = FaultSchedule(FaultPlan(
        dropouts=(DropoutSpan(party="a1", start=0, rounds=1),)))
    with pytest.raises(ValueError, match="K=1"):
        bad.party_mask(0, K=1)


# --------------------------------------------------------------------------
# Drop-absorb: the error-feedback telescoping survives as delay
# --------------------------------------------------------------------------
def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_recover_dropped_absorbs_decoded_update():
    celu = CELUConfig()
    tp = engine.make_transport(celu, "topk_int8")
    z, dz = [_x((32, 8), 0)], [_x((32, 8), 1)]
    ts = tp.init_state(z)
    key = UniformKey(jax_uniforms, ("seed", 2))
    assert set(tp.stateful_directions) == {"up", "down"}
    z_wire, r_up = tp.send(key, z[0], ts["up"][0], "up")
    dz_wire, r_down = tp.send(key, dz[0], ts["down"][0], "down")
    ts2 = {"up": [r_up], "down": [r_down]}
    fresh = {"tstate": ts2, "zs": [z_wire], "dzs": [dz_wire]}
    rec = tp.recover_dropped(fresh)
    # r'' = r' + y = x + r: the next delivered send carries the signal
    for d, x in (("up", z[0]), ("down", dz[0])):
        xw = tp._wire_cast(x).float()
        np.testing.assert_allclose(rec[d][0].numpy(),
                                   (xw + ts[d][0]).numpy(), rtol=1e-6,
                                   atol=1e-6)
    # new tensors: the dropped payload is not written
    assert rec["up"][0] is not r_up and fresh["tstate"]["up"][0] is r_up
    tp_plain = engine.SimWANTransport(celu)
    ts_p = tp_plain.init_state(z)
    assert tp_plain.recover_dropped({"tstate": ts_p}) is ts_p


def test_dropped_exchange_training_continues():
    """Every exchange is lost (seed 3 drops all 6 rounds at p = 0.95 with
    no retry): the scans go on from the initial cache, the state stays
    finite and no merge lands."""
    plan = FaultPlan(seed=3, drop_prob=0.95, max_retries=0)
    pe, rs, it = _build(1, plan=plan)
    rs, losses = _drive(pe, rs, it, 6)
    assert all(math.isnan(x) for x in losses)
    assert pe.counters["drops"] == 6
    assert pe.counters["merges"] == 0
    assert pe.counters["wire_attempts"] == 6
    assert int(rs.comm_rounds) == 0 and rs.round == 0
    for m in rs.params["a"] + [rs.params["b"]]:
        for p in m.parameters():
            assert torch.isfinite(p).all()
    rs, _ = pe.flush(rs)
    pe.finalize(rs)


# --------------------------------------------------------------------------
# Dropout span: freeze exactly the down party, elastic rejoin
# --------------------------------------------------------------------------
def _party(rs, who):
    m = rs.params["a"][0] if who == "a" else rs.params["b"]
    o = rs.opt["a"][0] if who == "a" else rs.opt["b"]
    return [p.detach().clone() for p in engine._params(m)] + \
        [a.clone() for a in o["accum"]]


def test_dropout_recovery_smoke():
    """a0 down over rounds 3-5: its tower, its AdaGrad state and its step
    counter freeze while Party B keeps stepping; after the rejoin both
    advance."""
    span = DropoutSpan(party="a0", start=3, rounds=3)
    plan = FaultPlan(seed=0, dropouts=(span,))
    pe, rs, it = _build(1, plan=plan)
    rs, _ = _drive(pe, rs, it, 3)
    frozen_a = _party(rs, "a")
    steps_a = int(rs.steps["a"][0])
    sb_before = int(rs.steps["b"])
    rs, _ = _drive(pe, rs, it, 3)
    for x, y in zip(frozen_a, _party(rs, "a")):
        assert torch.equal(x, y)
    assert int(rs.steps["a"][0]) == steps_a
    assert int(rs.steps["b"]) > sb_before
    assert pe.counters["dropout_rounds"] == 3
    rs, losses = _drive(pe, rs, it, 4)
    assert int(rs.steps["a"][0]) > steps_a
    assert any(math.isfinite(x) for x in losses)
    rs, _ = pe.flush(rs)
    st = pe.finalize(rs)
    for m in st["params"]["a"] + [st["params"]["b"]]:
        for p in m.parameters():
            assert torch.isfinite(p).all()


def test_straggler_defers_merge():
    """Every exchange arrives a round late at depth 1: merges lag (stall
    rounds appear), and by the flush each dispatched exchange has merged
    once."""
    plan = FaultPlan(seed=5, straggler_prob=1.0, straggler_rounds=1)
    pe, rs, it = _build(1, plan=plan)
    rs, _ = _drive(pe, rs, it, 8)
    assert pe.counters["stalls"] > 0
    rs, _ = pe.flush(rs)
    st = pe.finalize(rs)
    assert int(st["comm_rounds"]) == pe.counters["dispatches"]
    assert pe.counters["merges"] == pe.counters["dispatches"]


# --------------------------------------------------------------------------
# Checkpointed recovery: bitwise resume into a fresh engine
# --------------------------------------------------------------------------
CKPT_PLAN = FaultPlan(seed=9, drop_prob=0.25, max_retries=1,
                      straggler_prob=0.3, straggler_rounds=2,
                      dropouts=(DropoutSpan(party="a0", start=5, rounds=2),))


def test_chaos_checkpoint_resume_bit_exact(tmp_path):
    """On the default uniform source (a generator whose position the
    file keeps: the topk_int8 wire draws from it)."""
    pe0, rs0, it0 = _build(2, plan=CKPT_PLAN)
    rs0, l0 = _drive(pe0, rs0, it0, 12)
    rs0, _ = pe0.flush(rs0)
    st0 = pe0.finalize(rs0)

    pe1, rs1, it1 = _build(2, plan=CKPT_PLAN)
    rs1, l1a = _drive(pe1, rs1, it1, 7)
    path = str(tmp_path / "chaos.npz")
    ckpt.save_round_state(path, rs1, extra=pe1.host_state())
    n_pend = len(rs1.pending)
    del pe1, rs1

    pe2, rs_ref, it_ref = _build(2, plan=CKPT_PLAN)
    for _ in range(n_pend):
        bas, b, bi = next(it_ref)
        rs_ref = pe2.dispatch(rs_ref, bas, b, bi)
    host_ref = {"now": 0, "dispatch_seq": 0, "arrival": [0] * n_pend,
                "dispatch_round": [0] * n_pend, "last_merged_dispatch": 0}
    rs2, host = ckpt.restore_round_state(path, rs_ref,
                                         extra_reference=host_ref)
    pe2.load_host_state(host)
    rs2, l1b = _drive(pe2, rs2, it1, 5)
    rs2, _ = pe2.flush(rs2)
    st2 = pe2.finalize(rs2)

    np.testing.assert_array_equal(np.asarray(l0, np.float32),
                                  np.asarray(l1a + l1b, np.float32))
    _assert_states_equal(st0, st2)


# --------------------------------------------------------------------------
# Chaos + flush drain after a dropped dispatch
# --------------------------------------------------------------------------
def test_flush_after_drop_drains_clean():
    plan = FaultPlan(seed=2, drop_prob=0.35, max_retries=0)
    pe, rs, it = _build(2, plan=plan)
    rs, _ = _drive(pe, rs, it, 9)
    assert pe.counters["drops"] > 0
    n_pending = len(rs.pending)
    merges_before = pe.counters["merges"]
    rs, _ = pe.flush(rs)
    assert not rs.pending
    assert pe.counters["merges"] == merges_before + n_pending
    st = pe.finalize(rs)
    assert int(st["comm_rounds"]) == pe.counters["merges"]
    assert int(st["comm_rounds"]) == \
        pe.counters["dispatches"] - pe.counters["drops"]


# --------------------------------------------------------------------------
# The port against the reference
# --------------------------------------------------------------------------
SCHEDULE_PLANS = [
    FaultPlan(seed=7, drop_prob=0.05, max_retries=2, straggler_prob=0.1,
              straggler_rounds=2,
              dropouts=(DropoutSpan(party="a0", start=25, rounds=5),)),
    FaultPlan(seed=11, drop_prob=0.4, max_retries=3, straggler_prob=0.5,
              straggler_rounds=4,
              dropouts=(DropoutSpan(party="a1", start=3, rounds=7),
                        DropoutSpan(party="b", start=5, rounds=2))),
    FaultPlan(seed=2, drop_prob=0.35, max_retries=0),
]


@pytest.mark.parametrize("plan", SCHEDULE_PLANS)
def test_fault_schedule_matches_reference(plan):
    """Fates and masks over 200 rounds, equal to the reference's."""
    from repro.configs.base import DropoutSpan as JSpan
    from repro.configs.base import FaultPlan as JPlan
    from repro.core.faults import FaultSchedule as JSchedule
    jplan = JPlan(**{**dataclasses.asdict(plan), "dropouts": tuple(
        JSpan(**dataclasses.asdict(d)) for d in plan.dropouts)})
    ours, theirs = FaultSchedule(plan), JSchedule(jplan)
    for t in range(200):
        f, g = ours.exchange_fate(t), theirs.exchange_fate(t)
        assert (f.delivered, f.attempts, f.delay_rounds) == \
            (g.delivered, g.attempts, g.delay_rounds), t
        assert ours.down(t) == theirs.down(t)
        m, jm = ours.party_mask(t, 2), theirs.party_mask(t, 2)
        assert (m is None) == (jm is None), t
        if m is not None:
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_wan_price_model_matches_reference():
    from repro.configs.base import FaultPlan as JPlan
    from repro.core import engine as jengine
    from repro.configs.base import CELUConfig as JCELU
    from repro.launch import wan as jwan
    clocks = ((100e6 / 8, 100e6 / 8, 0.02), (300e6 / 8, 200e6 / 8, 0.01))
    plan = FaultPlan(party_clocks=clocks, retry_backoff_s=0.5)
    jplan = JPlan(party_clocks=clocks, retry_backoff_s=0.5)
    shapes = [(256, 256), (256, 256), (256, 256)]
    for spec in ("", "int8", "topk_int8"):
        tp = engine.make_transport(CELUConfig(), spec)
        jtp = jengine.make_transport(JCELU(), spec)
        ud = wan.transport_party_updown(tp, shapes)
        assert ud == jwan.transport_party_updown(jtp, shapes)
        for K in (1, 3):
            cs = wan.clocks_from_plan(plan, K)
            jcs = jwan.clocks_from_plan(jplan, K)
            assert [dataclasses.astuple(c) for c in cs] == \
                [dataclasses.astuple(c) for c in jcs]
            for attempts in (1, 2, 3):
                assert wan.retry_exchange_seconds(
                    cs, ud[:K], attempts=attempts, backoff_s=0.5) == \
                    jwan.retry_exchange_seconds(jcs, ud[:K],
                                                attempts=attempts,
                                                backoff_s=0.5)
    assert wan.clocks_from_plan(None, 2) == [wan.DEFAULT_CLOCK] * 2
    with pytest.raises(ValueError, match="attempts"):
        wan.retry_exchange_seconds(wan.clocks_from_plan(None, 1),
                                   [(1, 1)], attempts=0)


def test_recover_dropped_matches_reference():
    """Both transports' recovery of the same lossy sends, within 1e-6."""
    import jax.numpy as jnp
    from repro.configs.base import CELUConfig as JCELU
    from repro.core import engine as jengine
    for spec in ("int8", "topk_int8", "int8/topk"):
        tp = engine.make_transport(CELUConfig(), spec)
        jtp = jengine.make_transport(JCELU(), spec)
        x = [_x((64, 8), 10), _x((64, 8), 11)]
        r = [_x((64, 8), 12), _x((64, 8), 13)]
        ours, theirs = {"up": [], "down": []}, {"up": [], "down": []}
        ys = {"up": [], "down": []}
        jys = {"up": [], "down": []}
        for j, d in enumerate(("up", "down")):
            tag = ("wire", 3, 2, j)
            y, nr = tp.send(UniformKey(jax_uniforms, tag), x[j], r[j], d)
            jy, jr = jtp.send(jax_key(tag), jnp.asarray(x[j].numpy()),
                              jnp.asarray(r[j].numpy()), d)
            ours[d].append(nr)
            theirs[d].append(jr)
            ys[d].append(y)
            jys[d].append(jy)
        rec = tp.recover_dropped({"tstate": ours, "zs": ys["up"],
                                  "dzs": ys["down"]})
        jrec = jtp.recover_dropped({"tstate": theirs, "zs": jys["up"],
                                    "dzs": jys["down"]})
        for d in ("up", "down"):
            np.testing.assert_allclose(rec[d][0].numpy(),
                                       np.asarray(jrec[d][0]), rtol=1e-6,
                                       atol=1e-6)


def _jax_chaos_drive(depth, rounds, plan):
    """The reference's ChaosEngine on the two-party golden workload from
    the fixture's initial parameters -> (rows, counters, events)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import CELUConfig as JCELU
    from repro.configs.base import DropoutSpan as JSpan
    from repro.configs.base import FaultPlan as JPlan
    from repro.core import engine as jengine
    from repro.core.faults import ChaosEngine as JChaos
    from repro.models.tabular import DLRMConfig as JDLRMConfig
    from repro.models.tabular import make_dlrm as jmake_dlrm
    from repro.optim import make_optimizer as jmake_optimizer
    c2 = golden.TWO_PARTY_CFG
    cfg = JDLRMConfig(c2.model, c2.fields_a, c2.fields_b, c2.vocab,
                      c2.embed_dim, c2.z_dim, tuple(c2.hidden))
    init_fn, task, _ = jmake_dlrm(cfg)
    with jax.threefry_partitionable(False):
        p = init_fn(jax.random.PRNGKey(0), cfg)
    data, _ = _workload()
    base = JCELU(R=3, W=3, xi_degrees=60.0)
    ccfg, nloc = jengine.preset_config("celu", base)
    opt = jmake_optimizer("adagrad", 0.05)
    asj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa
    etask = jengine.lift_two_party(task)
    tp = jengine.make_transport(ccfg, "topk_int8")
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    state = jengine.init_state(etask, jengine.lift_two_party_params(p),
                               opt, ccfg, [asj(ba)], asj(bb),
                               transport=tp)
    jplan = JPlan(**{**dataclasses.asdict(plan), "dropouts": tuple(
        JSpan(**dataclasses.asdict(d)) for d in plan.dropouts)})
    pe = JChaos(etask, opt, ccfg, plan=jplan, depth=depth,
                local_steps=nloc, transport=tp)
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
    return rows, dict(pe.counters), pe.telemetry()["events"]


@pytest.mark.parametrize("depth", [1, 2])
def test_chaos_engine_matches_reference_on_injected_uniforms(depth):
    rounds = 16
    want, jcounters, jevents = _jax_chaos_drive(depth, rounds, PARITY_PLAN)
    params = golden.load_params(GOLDEN)
    pe, rs, it = _build(depth, PARITY_PLAN, params=params,
                        uniforms=jax_uniforms)
    rows = []
    for _ in range(rounds):
        bas, b, bi = next(it)
        rs, m = pe.step(rs, bas, b, bi)
        rows.append(golden._rows_metrics(m))
    rs, _ = pe.flush(rs)
    st = pe.finalize(rs)
    rows.append({"steps_a": int(st["steps"]["a"][0]),
                 "steps_b": int(st["steps"]["b"]),
                 "comm_rounds": int(st["comm_rounds"])})
    tel = pe.telemetry()
    assert dict(pe.counters) == jcounters
    assert tel["events"] == jevents
    kinds = {e["kind"] for e in tel["events"]}
    assert {"drop", "straggler", "dropout"} <= kinds, kinds
    dev = _deviation(rows, want)
    print(depth, dev, pe.counters)
    assert dev["loss_rel"] <= PIPE_LOSS_RTOL, dev
    assert dev["w_mean_abs"] <= PIPE_W_MEAN_ATOL, dev


def test_chaos_schedule_never_reads_the_card(monkeypatch):
    """No stage of the chaos scheduler reads a tensor back to the host,
    through dropped, stalled and down rounds: every fate is a host
    decision."""
    plan = FaultPlan(seed=6, drop_prob=0.3, max_retries=0,
                     straggler_prob=0.5, straggler_rounds=2,
                     dropouts=(DropoutSpan(party="a0", start=3, rounds=2),))
    pe, rs, it = _build(2, plan, compression="int8")
    batches = [next(it) for _ in range(8)]

    def refuse(self, *a, **kw):
        raise AssertionError("a stage read a tensor back to the host")

    for name in ("item", "__bool__", "__int__", "__float__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for bas, b, bi in batches:
        rs, m = pe.step(rs, bas, b, bi)
    rs, _ = pe.flush(rs)
    monkeypatch.undo()
    c = pe.counters
    assert c["drops"] > 0 and c["dropout_rounds"] == 2
    assert c["stalls"] + c["stalled_dispatches"] > 0
    assert int(pe.finalize(rs)["comm_rounds"]) == c["merges"]


@pytest.mark.parametrize("depth,compression", [(1, ""), (2, "int8")])
def test_chip_smoke_chaos_launch_counts_are_the_engines_calls(
        depth, compression, monkeypatch):
    """``chip_smoke.py`` holds its chaos phase's K1, K7 and K3 launches on
    the card to counts it derives from the schedule the engine's
    telemetry records (``_chaos_launches``); here the derivation must
    equal the calls of the kernels' wrappers in a small CLI run under a
    plan that drops, straggles and takes a0 down (their plain versions
    run on the CPU, so the calls are counted)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import fused_adagrad as fag
    from repro_torch.kernels import fused_sample as fs
    from repro_torch.kernels import quantize as qz
    from repro_torch.launch.train import train_dlrm
    calls = collections.Counter()
    for mod, name, key in ((fs, "fused_sample_2d", "fused_sample_2d"),
                           (fag, "fused_adagrad_step_", "fused_adagrad"),
                           (qz, "quantize_sr_2d", "quantize_sr_2d")):
        def run(*a, fn=getattr(mod, name), key=key, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, run)
    rounds = 12
    args = chip_smoke.train_args(
        "wdl-criteo", rounds=rounds, device="cpu", small=True,
        n_train=1024, n_test=256, batch_size=32, pipeline_depth=depth,
        compression=compression, fault_seed=2, fault_drop_prob=0.3,
        fault_max_retries=0, fault_straggler_prob=0.3,
        fault_dropout=["a0:4:3"])
    out = train_dlrm(args)
    tel = out["fault_telemetry"]
    assert tel["drops"] > 0 and tel["dropout_rounds"] == 3
    n = chip_smoke._adagrad_launches(chip_smoke._party_tensors(out))
    want = chip_smoke._chaos_launches(tel, rounds, depth, n,
                                      wire_k3=2 if compression else 0)
    assert dict(calls) == {k: v for k, v in want.items() if v}
