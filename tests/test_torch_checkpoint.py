"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU.

The first eight cases mirror ``tests/test_checkpoint.py`` one for one,
on the port: native bf16 storage, the legacy fp32 detour, host scalars,
the quantised storage leaves, and whole round states (parameters,
optimizer, quantised rings, residuals and the in-flight queue) restored
into a fresh engine, bitwise.

Beyond those: a restore writes into the reference's tensors (their
storage is kept, as the in-place optimizer step needs); the default
uniform generator's position rides in the file, and a file without it
restores only into a keyless source; the keys the port writes are the
reference's; and the two packages read each other's files.  A
mid-pipeline depth-2 chaos checkpoint written by the reference restores
into the port with every leaf bitwise the file's, and the resumed port
run stays within ``PIPE_LOSS_RTOL`` / ``PIPE_W_MEAN_ATOL`` of the
resumed reference run (both on the reference's uniforms); a file the
port writes restores through ``repro.checkpoint.restore_round_state``
with every leaf bitwise the port's.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import golden
from repro_torch.bridge import load_flat, subtree
from repro_torch.configs.base import CELUConfig, DropoutSpan, FaultPlan
from repro_torch.core import engine
from repro_torch.core.faults import ChaosEngine
from repro_torch.core.uniforms import GeneratorUniforms
from repro_torch.core.workset import Quant4Leaf
from repro_torch.data import to_device
from repro_torch.data.synthetic import (TabularSpec, aligned_batches,
                                        make_tabular)
from repro_torch.models.tabular import make_dlrm
from repro_torch.optim import make_optimizer
from repro_torch.optim.quantized import QuantAccum
from test_torch_compression import jax_uniforms
from test_torch_engine import GOLDEN
from test_torch_pipeline import PIPE_LOSS_RTOL, PIPE_W_MEAN_ATOL

torch.set_num_threads(1)

INTERCHANGE_PLAN = FaultPlan(seed=2, drop_prob=0.25, max_retries=1,
                             straggler_prob=0.3, straggler_rounds=2,
                             dropouts=(DropoutSpan(party="a0", start=4,
                                                   rounds=3),))


# --------------------------------------------------------------------------
# Leaf-level storage rules
# --------------------------------------------------------------------------
def test_bf16_stored_natively_and_bit_exact(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 8)).astype(np.float32)).to(torch.bfloat16)
    path = str(tmp_path / "bf16.npz")
    ckpt.save(path, {"x": x})
    with np.load(path) as data:
        assert data["x"].dtype == np.uint16
    ref = torch.zeros_like(x)
    got = ckpt.restore(path, {"x": ref})["x"]
    assert got is ref and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))


def test_legacy_fp32_stored_bf16_still_restores(tmp_path):
    x = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    path = str(tmp_path / "legacy.npz")
    np.savez(path, x=x.float().numpy())
    got = ckpt.restore(path, {"x": torch.zeros_like(x)})["x"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, x)


def test_python_scalar_leaves_roundtrip(tmp_path):
    tree = {"n": 7, "lr": 0.05, "on": True}
    path = str(tmp_path / "scalars.npz")
    ckpt.save(path, tree)
    got = ckpt.restore(path, {"n": 0, "lr": 0.0, "on": False})
    assert got == tree
    assert {k: type(v) for k, v in got.items()} == \
        {"n": int, "lr": float, "on": bool}


# --------------------------------------------------------------------------
# Whole round states
# --------------------------------------------------------------------------
def _build(depth, *, cache_dtype="int8", opt_state_dtype="float32",
           seed=0, uniforms=None, params=None, plan=None,
           compression="topk_int8"):
    """The reference's ``test_checkpoint._build`` on the port -> (engine,
    round state, batch iterator).  The optimizer draws from the round
    state's uniform source (a fresh generator unless ``uniforms`` names
    one), as the CLI's does.  ``params``: the golden fixture's (the
    reference's draw); ``plan``: a chaos engine's."""
    spec = TabularSpec("criteo", fields_a=4, fields_b=3, vocab=32,
                       n_train=2048, n_test=512)
    data = make_tabular(spec, seed=0)
    cfg = golden.TWO_PARTY_CFG
    init_fn, task, _ = make_dlrm(cfg)
    base = CELUConfig(R=3, W=3, xi_degrees=60.0, cache_dtype=cache_dtype)
    ccfg, nloc = engine.preset_config("celu", base)
    p = init_fn(seed, cfg, "cpu")
    if params is not None:
        load_flat(p["a"], subtree(params, "two_party.a"))
        load_flat(p["b"], subtree(params, "two_party.b"))
    src = GeneratorUniforms(seed, "cpu") if uniforms is None else uniforms
    kw = {} if opt_state_dtype == "float32" else {
        "state_dtype": opt_state_dtype, "uniforms": src}
    opt = make_optimizer("adagrad", 0.05, **kw)
    etask = engine.lift_two_party(task)
    tp = engine.make_transport(ccfg, compression)
    it = aligned_batches(data["train"], 64, seed=seed)
    _, ba, bb = next(it)
    state = engine.init_state(etask, engine.lift_two_party_params(p), opt,
                              ccfg, [to_device(ba, "cpu")],
                              to_device(bb, "cpu"), transport=tp,
                              uniforms=src)
    if plan is None:
        pe = engine.make_pipeline(etask, opt, ccfg, depth=depth,
                                  local_steps=nloc, transport=tp)
    else:
        pe = ChaosEngine(etask, opt, ccfg, plan=plan, depth=depth,
                         local_steps=nloc, transport=tp)
    batches = (([to_device(ba, "cpu")], to_device(bb, "cpu"), bi)
               for bi, ba, bb in aligned_batches(data["train"], 64,
                                                 seed=seed))
    return pe, pe.init(state), batches


def _steps(pe, rs, it, n):
    ms = []
    for _ in range(n):
        bas, b, bi = next(it)
        rs, m = pe.step(rs, bas, b, bi)
        ms.append(float(m["loss"]))
    return rs, ms


def _fabricate(pe, rs, it, n):
    for _ in range(n):
        bas, b, bi = next(it)
        rs = pe.dispatch(rs, bas, b, bi)
    return rs


def _tensors(rs):
    """Every tensor of a round state (pending slots included) and its
    host ints, in a fixed order."""
    out = []

    def walk(x):
        if isinstance(x, torch.nn.Module):
            out.extend(p.detach() for _, p in sorted(x.named_parameters()))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, (torch.Tensor, int)):
            out.append(x)
        elif hasattr(x, "tensors"):
            out.extend(x.tensors())
        elif isinstance(x, QuantAccum):
            out.extend([x.q, x.scale])
    walk({k: v for k, v in rs.as_state().items() if k != "uniforms"})
    for p in rs.pending:
        walk([p.fresh, p.batches_a, p.batch_b, int(p.batch_idx),
              p.dispatched_at])
    return out


def _assert_round_states_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _resume_one_step(tmp_path, name, **kw):
    """Save after 4 depth-2 steps, step on; restore into a fresh engine
    and take the same step: bitwise."""
    pe0, rs0, it0 = _build(2, **kw)
    rs0, _ = _steps(pe0, rs0, it0, 4)
    path = str(tmp_path / name)
    ckpt.save_round_state(path, rs0, extra={"round": 4})
    rs0, l_ref = _steps(pe0, rs0, it0, 1)

    n = ckpt.peek_pending_len(path)
    pe1, rs_ref, it1 = _build(2, **kw)
    rs_ref = _fabricate(pe1, rs_ref, it1, n)
    rs1, extra = ckpt.restore_round_state(path, rs_ref,
                                          extra_reference={"round": 0})
    assert extra == {"round": 4}
    for _ in range(4 - n):
        next(it1)
    rs1, l_got = _steps(pe1, rs1, it1, 1)
    np.testing.assert_array_equal(np.asarray(l_ref, np.float32),
                                  np.asarray(l_got, np.float32))
    _assert_round_states_equal(rs0, rs1)
    return n, rs0


def test_round_state_mid_pipeline_resume_bit_exact(tmp_path):
    """Depth 2, an int8 ring and topk_int8 residuals, on the default
    generator source (the ring's inserts and the wire draw from it)."""
    n, rs0 = _resume_one_step(tmp_path, "mid.npz")
    assert n == len(rs0.pending)


def test_quantized_leaves_stored_natively(tmp_path):
    g = np.random.default_rng
    q4 = Quant4Leaf(torch.from_numpy(g(0).integers(0, 256, (3, 8, 4)).astype(
        np.uint8)), torch.from_numpy(g(1).uniform(size=(3, 8)).astype(
            np.float32)), (8, 8), torch.float32)
    acc = QuantAccum(torch.from_numpy(g(2).integers(0, 128, (8, 16)).astype(
        np.int8)), torch.from_numpy(g(3).uniform(size=(8, 1)).astype(
            np.float32)), (128,))
    path = str(tmp_path / "quant.npz")
    ckpt.save(path, {"ring": q4, "acc": acc})
    with np.load(path) as data:
        assert sorted(data.files) == ["acc/0", "acc/1", "ring/0", "ring/1"]
        assert sorted(str(data[k].dtype) for k in data.files) == \
            ["float32", "float32", "int8", "uint8"]
    ref = {"ring": Quant4Leaf(torch.zeros((3, 8, 4), dtype=torch.uint8),
                              torch.zeros((3, 8)), (8, 8), torch.float32),
           "acc": QuantAccum(torch.zeros((8, 16), dtype=torch.int8),
                             torch.zeros((8, 1)), (128,))}
    got = ckpt.restore(path, ref)
    assert got["ring"] is ref["ring"] and got["acc"] is ref["acc"]
    for x, y in ((got["ring"].q, q4.q), (got["ring"].scale, q4.scale),
                 (got["acc"].q, acc.q), (got["acc"].scale, acc.scale)):
        assert torch.equal(x, y)


def test_round_state_resume_int4_cache_quantized_opt(tmp_path):
    """Depth 2 over an int4 ring with the int8 AdaGrad state, whose
    requantisation uniforms come from the round state's generator (its
    step counter ``t`` rides the file as the reference's int32)."""
    _resume_one_step(tmp_path, "mid4.npz", cache_dtype="int4",
                     opt_state_dtype="int8")
    with np.load(str(tmp_path / "mid4.npz")) as data:
        assert data["state/opt/b/t"].dtype == np.int32
        assert data["state/opt/b/accum/0/0"].dtype == np.int8
        assert data["state/ws/a/0/buf/z/0"].dtype == np.uint8


def test_round_state_wrong_queue_depth_fails_loud(tmp_path):
    pe, rs, it = _build(1)
    rs, _ = _steps(pe, rs, it, 2)
    path = str(tmp_path / "d1.npz")
    ckpt.save_round_state(path, rs)
    assert ckpt.peek_pending_len(path) == 0
    rs_bad = _fabricate(pe, rs, it, 1)
    with pytest.raises(ValueError, match="in-flight"):
        ckpt.restore_round_state(path, rs_bad)


def test_plain_pytree_file_is_not_a_round_state(tmp_path):
    path = str(tmp_path / "plain.npz")
    ckpt.save(path, {"x": torch.zeros(3)})
    with pytest.raises(KeyError, match="round-state"):
        ckpt.peek_pending_len(path)


# --------------------------------------------------------------------------
# The port's own rules: storage kept, the generator's position
# --------------------------------------------------------------------------
@pytest.mark.parametrize("opt_state_dtype", ["float32", "bfloat16", "int8"])
def test_restore_keeps_every_tensors_storage(opt_state_dtype, tmp_path):
    """The restore copies into the reference's tensors: parameters,
    optimizer state (K7 / K8 step in place on them), rings, counters and
    residuals keep their addresses."""
    pe0, rs0, it0 = _build(2, opt_state_dtype=opt_state_dtype)
    rs0, _ = _steps(pe0, rs0, it0, 3)
    path = str(tmp_path / "s.npz")
    ckpt.save_round_state(path, rs0)
    pe1, rs_ref, it1 = _build(2, opt_state_dtype=opt_state_dtype, seed=1)
    rs_ref = _fabricate(pe1, rs_ref, it1, ckpt.peek_pending_len(path))
    before = [t.data_ptr() for t in _tensors(rs_ref)
              if isinstance(t, torch.Tensor)]
    rs1, _ = ckpt.restore_round_state(path, rs_ref)
    after = [t.data_ptr() for t in _tensors(rs1)
             if isinstance(t, torch.Tensor)]
    assert before == after
    _assert_round_states_equal(rs0, rs1)


def test_generator_position_rides_the_file(tmp_path):
    """The default source's position is saved, restored, and required:
    without it a generator source refuses to resume; a keyless source
    (a function of the tag) restores the same file."""
    pe0, rs0, it0 = _build(2)
    rs0, _ = _steps(pe0, rs0, it0, 3)
    path = str(tmp_path / "g.npz")
    ckpt.save_round_state(path, rs0)
    with np.load(path) as data:
        assert np.array_equal(data["__repro_torch__/uniforms"],
                              rs0.uniforms.get_state().numpy())
        flat = {k: data[k] for k in data.files
                if k != "__repro_torch__/uniforms"}
    bare = str(tmp_path / "bare.npz")
    np.savez(bare, **flat)
    n = ckpt.peek_pending_len(path)
    pe1, rs_ref, it1 = _build(2)
    rs_ref = _fabricate(pe1, rs_ref, it1, n)
    with pytest.raises(ValueError, match="generator"):
        ckpt.restore_round_state(bare, rs_ref)
    rs1, _ = ckpt.restore_round_state(path, rs_ref)
    assert torch.equal(rs1.uniforms.get_state(), rs0.uniforms.get_state())
    pe2, rs_k, it2 = _build(2, uniforms=jax_uniforms)
    rs_k = _fabricate(pe2, rs_k, it2, n)
    rs2, _ = ckpt.restore_round_state(bare, rs_k)
    _assert_round_states_equal(rs0, rs2)


# --------------------------------------------------------------------------
# Interchange with the reference package
# --------------------------------------------------------------------------
def _jax_build(depth, plan, cache_dtype, opt_state_dtype):
    """The reference's chaos engine at the golden geometry from the
    fixture's initial parameters -> (engine, round state, batches)."""
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
    data = make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=2048, n_test=512), 0)
    base = JCELU(R=3, W=3, xi_degrees=60.0, cache_dtype=cache_dtype)
    ccfg, nloc = jengine.preset_config("celu", base)
    kw = {} if opt_state_dtype == "float32" else {
        "state_dtype": opt_state_dtype}
    opt = jmake_optimizer("adagrad", 0.05, **kw)
    asj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa
    etask = jengine.lift_two_party(task)
    tp = jengine.make_transport(ccfg, "topk_int8")
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    state = jengine.init_state(etask, jengine.lift_two_party_params(p), opt,
                               ccfg, [asj(ba)], asj(bb), transport=tp)
    jplan = JPlan(**{**dataclasses.asdict(plan), "dropouts": tuple(
        JSpan(**dataclasses.asdict(d)) for d in plan.dropouts)})
    pe = JChaos(etask, opt, ccfg, plan=jplan, depth=depth,
                local_steps=nloc, transport=tp)
    batches = (([asj(ba)], asj(bb), bi) for bi, ba, bb in
               aligned_batches(data["train"], 64, seed=0))
    return pe, pe.init(state), batches


def _host_ref(n):
    return {"now": 0, "dispatch_seq": 0, "arrival": [0] * n,
            "dispatch_round": [0] * n, "last_merged_dispatch": 0}


def _port_leaves_against(flat, rs, prefix_ok=lambda k: True):
    """Every key of ``flat`` (a file's arrays) against the port round
    state's tensor at that key, bitwise after the file's dtype cast."""
    from repro_torch.checkpoint.checkpoint import (_flatten, _pending_view,
                                                   _state_view)
    mine = _flatten({"state": _state_view(rs),
                     "pending": _pending_view(rs)})
    for k, v in flat.items():
        if not prefix_ok(k):
            continue
        want = v.view(np.uint16) if v.dtype == np.uint16 else v
        got = mine[k]
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=k)


CASES = [("float32", "float32"), ("int4", "int8")]


@pytest.mark.parametrize("cache_dtype,opt_state_dtype", CASES)
def test_reference_checkpoint_restores_into_port(cache_dtype,
                                                 opt_state_dtype, tmp_path):
    """A depth-2 chaos checkpoint the reference wrote mid-pipeline
    restores into the port, every leaf bitwise the file's; both resumed
    runs then agree within the pipeline tests' tolerance."""
    from repro import checkpoint as jckpt
    plan, cut, more = INTERCHANGE_PLAN, 7, 5
    jpe, jrs, jit = _jax_build(2, plan, cache_dtype, opt_state_dtype)
    for _ in range(cut):
        bas, b, bi = next(jit)
        jrs, _ = jpe.step(jrs, bas, b, bi)
    path = str(tmp_path / "jax.npz")
    jckpt.save_round_state(path, jrs, extra=jpe.host_state())
    at_cut = dict(jpe.counters)
    n_events = len(jpe.events)
    n = jckpt.peek_pending_len(path)
    assert n == ckpt.peek_pending_len(path) == len(jrs.pending) >= 1

    params = golden.load_params(GOLDEN)
    pe, rs_ref, it = _build(2, cache_dtype=cache_dtype,
                            opt_state_dtype=opt_state_dtype,
                            uniforms=jax_uniforms, params=params, plan=plan)
    rs_ref = _fabricate(pe, rs_ref, it, n)
    rs, host = ckpt.restore_round_state(path, rs_ref,
                                        extra_reference=_host_ref(n))
    pe.load_host_state(host)
    assert host == jpe.host_state()
    assert rs.round == int(jrs.comm_rounds)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files
                if not k.startswith(("__", "extra/"))}
    _port_leaves_against(flat, rs)

    # both resume: the reference in its own engine, the port from the file
    for _ in range(cut - n):
        next(it)
    rows, jrows = [], []
    for _ in range(more):
        bas, b, bi = next(it)
        rs, m = pe.step(rs, bas, b, bi)
        rows.append(golden._rows_metrics(m))
        jbas, jb, jbi = next(jit)
        jrs, jm = jpe.step(jrs, jbas, jb, jbi)
        jrows.append(golden._rows_metrics(jm))
    rs, _ = pe.flush(rs)
    jrs, _ = jpe.flush(jrs)
    # a resumed engine counts its own rounds only, as the reference's
    assert pe.counters == {k: v - at_cut[k] for k, v in jpe.counters.items()}
    assert pe.telemetry()["events"] == jpe.telemetry()["events"][n_events:]
    loss, w_mean = 0.0, 0.0
    for g, w in zip(rows, jrows):
        assert g["local_steps"] == w["local_steps"]
        assert math.isnan(g["loss"]) == math.isnan(w["loss"])
        if not math.isnan(w["loss"]):
            loss = max(loss, abs(g["loss"] - w["loss"]) / abs(w["loss"]))
        w_mean = max(w_mean, abs(g["w_mean"] - w["w_mean"]))
    print(cache_dtype, opt_state_dtype, {"loss_rel": loss,
                                         "w_mean_abs": w_mean})
    assert loss <= PIPE_LOSS_RTOL and w_mean <= PIPE_W_MEAN_ATOL
    assert int(rs.comm_rounds) == int(jrs.comm_rounds)


@pytest.mark.parametrize("cache_dtype,opt_state_dtype", CASES)
def test_port_checkpoint_restores_in_reference(cache_dtype, opt_state_dtype,
                                               tmp_path):
    """A file the port wrote mid-pipeline restores through
    ``repro.checkpoint.restore_round_state``: the keys are the
    reference's (plus the port's generator key, absent on a keyless
    source) and every restored leaf is bitwise the port's."""
    import jax
    from repro import checkpoint as jckpt
    plan = INTERCHANGE_PLAN
    params = golden.load_params(GOLDEN)
    pe, rs, it = _build(2, cache_dtype=cache_dtype,
                        opt_state_dtype=opt_state_dtype,
                        uniforms=jax_uniforms, params=params, plan=plan)
    for _ in range(7):
        bas, b, bi = next(it)
        rs, _ = pe.step(rs, bas, b, bi)
    path = str(tmp_path / "port.npz")
    ckpt.save_round_state(path, rs, extra=pe.host_state())
    n = ckpt.peek_pending_len(path)
    assert n == jckpt.peek_pending_len(path) >= 1

    jpe, jrs, jit = _jax_build(2, plan, cache_dtype, opt_state_dtype)
    for _ in range(n):
        bas, b, bi = next(jit)
        jrs = jpe.dispatch(jrs, bas, b, bi)
    jsave = str(tmp_path / "jkeys.npz")
    jckpt.save_round_state(jsave, jrs, extra=_host_ref(n))
    with np.load(jsave) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
    jrs2, host = jckpt.restore_round_state(path, jrs,
                                           extra_reference=_host_ref(n))
    assert host == pe.host_state()
    from repro.checkpoint.checkpoint import _flatten as jflatten
    restored = jflatten({"state": jrs2.as_state(),
                         "pending": tuple(jrs2.pending)})
    _port_leaves_against(restored, rs)
    assert all(np.asarray(x).dtype != np.float64 for x in
               jax.tree_util.tree_leaves(jrs2.as_state()))
