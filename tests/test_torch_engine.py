"""The port's round engine against the reference's golden traces.

Both golden workloads (``golden/two_party_trace.json``: vanilla, fedbcd,
celu; ``golden/three_party_trace.json``) run through ``repro_torch`` on
the CPU from the reference's initial parameters, with the fused ring
sample (K1) on and off (K2).  The integer counters must match exactly;
loss is held to ``LOSS_RTOL`` relative and ``w_mean`` to ``W_MEAN_ATOL``
absolute (float32 summation order differs between XLA and PyTorch).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.models.tabular import DLRMConfig as JDLRMConfig
from repro.models.tabular import _mlp_init, make_dlrm as jmake_dlrm
from repro_torch import golden
from repro_torch.bridge import flatten_tree

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _jax_init_params() -> dict:
    """The reference's initial parameters of both golden workloads, as the
    recorders in ``tests/test_engine.py`` draw them, flattened to dotted
    paths under ``two_party`` / ``three_party``.  The goldens were recorded
    before JAX made the partitionable threefry its default, so the draw
    uses the earlier threefry."""
    with jax.threefry_partitionable(False):
        return _draw_init_params()


def _draw_init_params() -> dict:
    c2 = golden.TWO_PARTY_CFG
    init2, _, _ = jmake_dlrm(JDLRMConfig(c2.model, c2.fields_a, c2.fields_b,
                                         c2.vocab, c2.embed_dim, c2.z_dim,
                                         tuple(c2.hidden)))
    c3 = golden.THREE_PARTY_CFG
    cfg3 = JDLRMConfig(c3.model, c3.fields_a, c3.fields_b, c3.vocab,
                       c3.embed_dim, c3.z_dim, tuple(c3.hidden))
    init3, _, _ = jmake_dlrm(cfg3)
    pb = dict(init3(jax.random.PRNGKey(2), cfg3)["b"])
    pb["top"] = _mlp_init(jax.random.PRNGKey(3), list(golden.THREE_PARTY_TOP))
    tree = {"two_party": init2(jax.random.PRNGKey(0), JDLRMConfig(
                c2.model, c2.fields_a, c2.fields_b, c2.vocab, c2.embed_dim,
                c2.z_dim, tuple(c2.hidden))),
            "three_party": {"a0": init3(jax.random.PRNGKey(0), cfg3)["a"],
                            "a1": init3(jax.random.PRNGKey(1), cfg3)["a"],
                            "b": pb}}
    return {k: np.asarray(v) for k, v in
            flatten_tree(jax.tree_util.tree_map(np.asarray, tree)).items()}


def test_committed_init_params_match_jax():
    """The committed fixture is what JAX draws today (it cannot go
    stale)."""
    want = _jax_init_params()
    got = golden.load_params(GOLDEN)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def params():
    return golden.load_params(GOLDEN)


def _check(dev):
    print(dev)
    assert dev["counters_equal"], dev
    assert dev["loss_rel"] <= golden.LOSS_RTOL, dev
    assert dev["w_mean_abs"] <= golden.W_MEAN_ATOL, dev


@pytest.mark.parametrize("cache_fused", [True, False])
@pytest.mark.parametrize("protocol", ["vanilla", "fedbcd", "celu"])
def test_two_party_golden(protocol, cache_fused, params):
    got = golden.two_party_trace(protocol, params, device="cpu",
                                 cache_fused=cache_fused)
    _check(golden.compare(got, golden.load_golden(GOLDEN,
        "two_party_trace.json")[protocol]))


@pytest.mark.parametrize("cache_fused", [True, False])
def test_three_party_golden(cache_fused, params):
    got = golden.three_party_trace(params, device="cpu",
                                   cache_fused=cache_fused)
    _check(golden.compare(got, golden.load_golden(GOLDEN,
        "three_party_trace.json")["celu"]))


@pytest.mark.parametrize("cache_fused", [True, False])
def test_engine_hands_kernels_operands_they_take(cache_fused, params,
                                                 monkeypatch):
    """The CUDA wrappers check their operands (device, dtype, shape,
    contiguity, the slot) before a launch; the CPU path skips the checks.
    Run them here on every call the engine makes, so an operand the card
    would refuse shows up on the CPU."""
    from repro_torch.kernels import cosine_weight as cw
    from repro_torch.kernels import fused_sample as fs
    seen = []

    def k1(slot, a, z, dz, cos_xi):
        fs.check_ring(slot, a, z, dz)
        seen.append("k1")
        return fs.fused_sample_plain(slot, a, z, dz, cos_xi)

    def k2a(a, s, dz, cos_xi):
        cw.check_rows("cosine_weight_2d", a, s, dz)
        seen.append("k2a")
        return cw.cosine_weight_plain(a, s, dz, cos_xi)

    def k2b(a, s, cos_xi):
        cw.check_rows("cosine_weights_2d", a, s)
        seen.append("k2b")
        return cw.cosine_weights_plain(a, s, cos_xi)

    monkeypatch.setattr(fs, "fused_sample_2d", k1)
    monkeypatch.setattr(cw, "cosine_weight_2d", k2a)
    monkeypatch.setattr(cw, "cosine_weights_2d", k2b)
    golden.two_party_trace("celu", params, device="cpu",
                           cache_fused=cache_fused, rounds=3)
    golden.three_party_trace(params, device="cpu", cache_fused=cache_fused,
                             rounds=3)
    want = {"k1"} if cache_fused else {"k2a", "k2b"}
    assert set(seen) == want


def test_protocol_shim_reproduces_golden_prefix(params):
    """``core/protocol.py``: the two-party shim (its own state layout over
    the K-party engine) runs the golden celu workload like the engine."""
    from repro_torch.bridge import load_flat, subtree
    from repro_torch.configs.base import CELUConfig
    from repro_torch.core import protocol
    from repro_torch.data import to_device
    from repro_torch.data.synthetic import (TabularSpec, aligned_batches,
                                            make_tabular)
    from repro_torch.models.tabular import make_dlrm
    from repro_torch.optim import make_optimizer
    cfg = golden.TWO_PARTY_CFG
    data = make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=2048, n_test=512), 0)
    init_fn, task, _ = make_dlrm(cfg)
    p = init_fn(0, cfg, "cpu")
    load_flat(p["a"], subtree(params, "two_party.a"))
    load_flat(p["b"], subtree(params, "two_party.b"))
    celu = CELUConfig(R=3, W=3, xi_degrees=60.0)
    opt = make_optimizer("adagrad", 0.05)
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    state = protocol.init_state(task, p, opt, celu, to_device(ba, "cpu"),
                                to_device(bb, "cpu"))
    rnd = protocol.make_round(task, opt, celu)
    it = aligned_batches(data["train"], 64, seed=0)
    rows = []
    for _ in range(6):
        bi, ba, bb = next(it)
        state, m = rnd(state, to_device(ba, "cpu"), to_device(bb, "cpu"), bi)
        rows.append(golden._rows_metrics(m))
    rows.append({})
    _check(golden.compare(rows, golden.load_golden(GOLDEN,
        "two_party_trace.json")["celu"]))
    assert int(state["steps"]["a"]) == 6 + sum(r["local_steps"]
                                               for r in rows[:-1]) // 2
    assert protocol.exchange_bytes((64, 8)) == 2 * 64 * 8 * 4


@pytest.mark.parametrize("cache_fused", [True, False])
def test_local_grads_on_entry_match_ring_reads(cache_fused, params):
    """``local_grad_a`` / ``local_grad_b`` on a materialised workset entry
    give the gradients and weights that the round's ring reads give."""
    from repro_torch.bridge import load_flat, subtree
    from repro_torch.configs.base import CELUConfig
    from repro_torch.core import engine
    from repro_torch.core.workset import workset_entry
    from repro_torch.data import to_device
    from repro_torch.data.synthetic import (TabularSpec, aligned_batches,
                                            make_tabular)
    from repro_torch.models.tabular import make_dlrm
    from repro_torch.optim import make_optimizer
    cfg = golden.TWO_PARTY_CFG
    data = make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=512, n_test=64), 0)
    init_fn, task, _ = make_dlrm(cfg)
    p = init_fn(0, cfg, "cpu")
    load_flat(p["a"], subtree(params, "two_party.a"))
    load_flat(p["b"], subtree(params, "two_party.b"))
    celu = CELUConfig(R=3, W=3, cache_fused=cache_fused)
    opt = make_optimizer("adagrad", 0.05)
    etask = engine.lift_two_party(task)
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    state = engine.init_state(etask, engine.lift_two_party_params(p), opt,
                              celu, [to_device(ba, "cpu")],
                              to_device(bb, "cpu"))
    rnd = engine.make_round(etask, opt, celu)
    for _ in range(2):
        bi, ba, bb = next(it)
        state, _ = rnd(state, [to_device(ba, "cpu")], to_device(bb, "cpu"),
                       bi)
    cos_xi = engine.xi_to_cos(60.0)
    slot = torch.tensor(0, dtype=torch.int32)
    pa, pb = state["params"]["a"][0], state["params"]["b"]
    wsa, wsb = state["ws"]["a"][0], state["ws"]["b"]
    got = [engine.local_grad_a(task.forward_a, pa, workset_entry(wsa, slot),
                               cos_xi),
           engine.local_grad_b(etask.loss_b, pb, workset_entry(wsb, slot),
                               cos_xi)]
    want = [engine.local_grad_a_cached(task.forward_a, pa, wsa, slot, cos_xi,
                                       cache_fused=cache_fused),
            engine.local_grad_b_cached(etask.loss_b, pb, wsb, slot, cos_xi,
                                       cache_fused=cache_fused)]
    for (g, w), (g0, w0) in zip(got, want):
        assert 0.0 < float(w.mean()) < 1.0
        torch.testing.assert_close(w, w0, rtol=0, atol=1e-6)
        for a, b in zip(g, g0):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_synthetic_stream_and_configs_match_reference():
    """The port's copies of ``data/synthetic.py`` and the DLRM configs give
    the reference's stream and widths exactly."""
    from repro.configs import get_config as jget_config
    from repro.configs.base import CELUConfig as JCELU
    from repro.data import synthetic as jsyn
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CELUConfig
    from repro_torch.data import synthetic as tsyn
    for name in ("criteo", "avazu", "d3"):
        assert tsyn.TABULAR_SPECS[name] == tsyn.TabularSpec(
            **vars(jsyn.TABULAR_SPECS[name]))
    spec = dict(name="t", fields_a=5, fields_b=3, vocab=50, n_train=300,
                n_test=40)
    want = jsyn.make_tabular(jsyn.TabularSpec(**spec), seed=4)
    got = tsyn.make_tabular(tsyn.TabularSpec(**spec), seed=4)
    for split in ("train", "test"):
        for k in ("x_a", "x_b", "y"):
            np.testing.assert_array_equal(got[split][k], want[split][k])
    jit = jsyn.aligned_batches(want["train"], 64, seed=4)
    tit = tsyn.aligned_batches(got["train"], 64, seed=4)
    for _ in range(6):      # crosses an epoch boundary (4 batches each)
        (ji, ja, jb), (ti, ta, tb) = next(jit), next(tit)
        assert ti == ji
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k])
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    for arch in ("wdl-criteo", "dssm-avazu"):
        j, t = jget_config(arch), get_config(arch)
        assert (t.model, t.fields_a, t.fields_b, t.vocab, t.embed_dim,
                t.z_dim, tuple(t.hidden)) == (
                    j.model, j.fields_a, j.fields_b, j.vocab, j.embed_dim,
                    j.z_dim, tuple(j.hidden))
    for k, v in vars(CELUConfig()).items():
        assert getattr(JCELU(), k) == v, k


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_transport_and_wan_clock_match_reference(wire):
    """``SimWANTransport``'s wire cast and byte accounting, and the WAN
    clock's seconds per round, against the reference."""
    import jax.numpy as jnp
    from repro.configs.base import CELUConfig as JCELU
    from repro.core import engine as jengine
    from repro.launch import wan as jwan
    from repro_torch.configs.base import CELUConfig
    from repro_torch.core import engine as tengine
    from repro_torch.launch import wan as twan
    jtp = jengine.SimWANTransport(JCELU(wire_dtype=wire))
    ttp = tengine.make_transport(CELUConfig(wire_dtype=wire))
    x = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        ttp.send(None, torch.from_numpy(x))[0].numpy(),
        np.asarray(jtp.send(None, jnp.asarray(x))[0]))
    shapes = [(256, 256), (256, 64)]
    assert ttp.round_bytes(shapes) == jtp.round_bytes(shapes)
    up, down = twan.transport_round_updown(ttp, shapes)
    assert (up, down) == jwan.transport_round_updown(jtp, shapes)
    for depth in (0, 1, 3):
        kw = dict(exchange_compute_s=0.004, local_compute_s=0.02,
                  pipeline_depth=depth)
        assert twan.WANClock().time_to_target(10, up, down, **kw) == \
            jwan.WANClock().time_to_target(10, up, down, **kw)
    clock = twan.WANClock().with_bandwidth(1e6, 2e6)
    assert twan.wan_seconds(up, down, clock=clock) == jwan.wan_seconds(
        up, down, clock=jwan.WANClock().with_bandwidth(1e6, 2e6))
    # the compressed wire is in; so is DP on both wires: the noised sends
    # against the reference's on the same uniforms (the noise's erfinv
    # differs in its last bits, tests/test_torch_privacy.py)
    from test_torch_compression import jax_uniforms
    from repro_torch.core.uniforms import UniformKey
    tp = tengine.make_transport(CELUConfig(wire_dtype=wire), "int8")
    assert isinstance(tp, tengine.CompressedWANTransport)
    jkey = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(17), 2),
                            2)[1]
    key = UniformKey(jax_uniforms, ("wire", 2, 2, 1))
    for spec in ("", "int8"):
        kw = dict(wire_dtype=wire, dp_sigma=0.5, dp_clip=2.0)
        dtp = tengine.make_transport(CELUConfig(**kw), spec)
        jdtp = jengine.make_transport(JCELU(**kw), spec)
        assert isinstance(dtp, tengine.SimWANTransport)
        res = None if not spec else torch.zeros(16, 8)
        y, r = dtp.send(key, torch.from_numpy(x), res, "down")
        jy, jr = jdtp.send(jkey, jnp.asarray(x),
                           None if res is None else jnp.zeros((16, 8)),
                           "down")
        assert not np.array_equal(y.numpy(), ttp.send(
            key, torch.from_numpy(x))[0].numpy())
        # a bf16 wire rounds the noised value: a last-bit difference in
        # the noise may move it one bf16 step
        rtol = 1e-5 if wire == "float32" else 2.0 ** -8
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=rtol,
                                   atol=1e-5)
        if res is not None:
            np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5,
                                       atol=1e-6)
    # the chaos engine's recovery of a lost exchange stays refused
    with pytest.raises(NotImplementedError, match="slice 6"):
        tp.recover_dropped({})


# Quantised cache and compressed wire, 5 rounds at the golden geometry,
# against the reference fed the same uniforms.  Stochastic rounding turns
# an ulp of difference in Z (float32 sums in another order) into a whole
# code where floor(x / s + u) sits at an integer.  Measured on the CPU,
# the largest deviations over the four cases are 1.75e-7 relative in loss
# and 1.79e-7 in ``w_mean`` (no code flipped); the limits leave room for
# a few flipped codes, each of which moves one element by one scale step.
QUANT_LOSS_RTOL = 1e-5
QUANT_W_MEAN_ATOL = 1e-5


def _jax_two_party_trace(cache_dtype, compression, rounds,
                         optimizer="adagrad", opt_kw=None):
    """The two-party golden workload through the reference's engine, from
    the fixture's initial parameters (drawn as the fixture draws them)."""
    import jax.numpy as jnp
    from repro.configs.base import CELUConfig as JCELU
    from repro.core import engine as jengine
    from repro.data.synthetic import (TabularSpec, aligned_batches,
                                      make_tabular)
    from repro.optim import make_optimizer as jmake_optimizer
    c2 = golden.TWO_PARTY_CFG
    cfg = JDLRMConfig(c2.model, c2.fields_a, c2.fields_b, c2.vocab,
                      c2.embed_dim, c2.z_dim, tuple(c2.hidden))
    init_fn, task, _ = jmake_dlrm(cfg)
    with jax.threefry_partitionable(False):
        params = init_fn(jax.random.PRNGKey(0), cfg)
    data = make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=2048, n_test=512), 0)
    celu = JCELU(R=3, W=3, xi_degrees=60.0, cache_dtype=cache_dtype,
                 compression=compression)
    opt = jmake_optimizer(optimizer, 0.05, **(opt_kw or {}))
    asj = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    it = aligned_batches(data["train"], 64, seed=0)
    _, ba, bb = next(it)
    etask = jengine.lift_two_party(task)
    state = jengine.init_state(etask, jengine.lift_two_party_params(params),
                               opt, celu, [asj(ba)], asj(bb))
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
@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_quantised_rounds_match_reference_on_injected_uniforms(
        cache_dtype, compression, params):
    """The int8 / int4 cache (K3 inserts, K4 / K5 samples) and the int8
    wire (K3 encodes, error feedback) over 5 celu rounds: the port, fed
    the reference's uniforms, against the reference's engine."""
    from test_torch_compression import jax_uniforms
    want = _jax_two_party_trace(cache_dtype, compression, 5)
    got = golden.two_party_trace("celu", params, device="cpu", rounds=5,
                                 cache_dtype=cache_dtype,
                                 compression=compression,
                                 uniforms=jax_uniforms)
    dev = golden.compare(got, want)
    print(dev)
    assert dev["counters_equal"], dev
    assert dev["loss_rel"] <= QUANT_LOSS_RTOL, dev
    assert dev["w_mean_abs"] <= QUANT_W_MEAN_ATOL, dev


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "int4"])
def test_engine_hands_quant_kernels_operands_they_take(cache_dtype, params,
                                                       monkeypatch):
    """As above for the quantised paths: K3 on every insert and wire
    encode, K1 (bf16), K4 (int8) or K5 (int4) on every fused sample."""
    from repro_torch.kernels import fused_sample as fs
    from repro_torch.kernels import quantize as qz
    seen = []

    def k3(x, u, levels):
        qz.check_operands(x, u)
        seen.append("k3")
        return qz.quantize_sr_plain(x, u, levels)

    def k1(slot, a, z, dz, cos_xi):
        fs.check_ring(slot, a, z, dz)
        seen.append("k1")
        return fs.fused_sample_plain(slot, a, z, dz, cos_xi)

    def quant(bits):
        def k(slot, a, zq, zs, dzq, dzs, cos_xi):
            fs.check_quant_ring(bits, slot, a, zq, zs, dzq, dzs)
            seen.append(f"q{bits}")
            return fs.fused_sample_quant_plain(bits, slot, a, zq, zs, dzq,
                                               dzs, cos_xi)
        return k

    monkeypatch.setattr(qz, "quantize_sr_2d", k3)
    monkeypatch.setattr(fs, "fused_sample_2d", k1)
    monkeypatch.setattr(fs, "fused_sample_q8_2d", quant(8))
    monkeypatch.setattr(fs, "fused_sample_q4_2d", quant(4))
    golden.two_party_trace("celu", params, device="cpu", rounds=3,
                           cache_dtype=cache_dtype, compression="int4x2")
    kernel = {"bfloat16": "k1", "int8": "q8", "int4": "q4"}[cache_dtype]
    assert set(seen) == {"k3", kernel}
    # per round: 2 wire sends x 2 chain stages, plus 4 quantised inserts
    assert seen.count("k3") == 3 * (4 + (0 if kernel == "k1" else 4))


def test_identity_wire_and_unfused_quantised_cache_rounds(params):
    """``--compression identity`` keeps the plain wire bitwise; the
    unfused path decodes the entry and runs K2, as the fused one reads
    the ring through K4."""
    plain = golden.two_party_trace("celu", params, device="cpu", rounds=4)
    ident = golden.two_party_trace("celu", params, device="cpu", rounds=4,
                                   compression="identity")
    assert plain == ident
    fused = golden.two_party_trace("celu", params, device="cpu", rounds=4,
                                   cache_dtype="int8")
    unfused = golden.two_party_trace("celu", params, device="cpu",
                                     rounds=4, cache_dtype="int8",
                                     cache_fused=False)
    dev = golden.compare(unfused, fused + [{}])
    print(dev)
    assert dev["counters_equal"] and dev["loss_rel"] <= 1e-6 \
        and dev["w_mean_abs"] <= 1e-6, dev


# The optimizer states over 5 rounds at the golden geometry, against the
# reference's engine (the int8 state on the reference's uniforms).  The
# port takes the kernel route (K7 for bf16, K8 for int8; their plain
# versions here).  Measured on the CPU: loss within 1.75e-7 relative and
# ``w_mean`` within 9.5e-7 (bf16), 8.8e-8 and 1.2e-7 (int8, no code
# flipped), 1.7e-7 and 6.0e-8 (sm3); the limits leave room for a few int8
# codes that flip where r'/s' + u sits at an integer.  An int8 state whose
# K8 returns zero updates misses by 2.5e-2 in loss (the mutation test
# below).
OPT_LOSS_RTOL = 1e-5
OPT_W_MEAN_ATOL = 1e-5
OPT_CASES = {"bfloat16": ("adagrad", {"state_dtype": "bfloat16"}),
             "int8": ("adagrad", {"state_dtype": "int8"}),
             "sm3": ("sm3", {})}


def _opt_trace(kind, params, rounds=5):
    from test_torch_compression import jax_uniforms
    name, kw = OPT_CASES[kind]
    tkw = dict(kw)
    if name == "adagrad":
        tkw["use_pallas"] = True
    if kind == "int8":
        tkw["uniforms"] = jax_uniforms
    return golden.two_party_trace("celu", params, device="cpu",
                                  rounds=rounds, uniforms=jax_uniforms,
                                  optimizer=name, opt_kw=tkw)


@pytest.mark.parametrize("kind", list(OPT_CASES))
def test_optimizer_state_rounds_match_reference(kind, params):
    want = _jax_two_party_trace("float32", "", 5, *OPT_CASES[kind])
    dev = golden.compare(_opt_trace(kind, params), want)
    print(kind, dev)
    assert dev["counters_equal"], dev
    assert dev["loss_rel"] <= OPT_LOSS_RTOL, dev
    assert dev["w_mean_abs"] <= OPT_W_MEAN_ATOL, dev


def test_optimizer_rounds_tolerance_catches_zero_updates(params,
                                                         monkeypatch):
    """Mutation check of the limits above: an int8 state whose step moves
    no parameter (the state still advances) must fall outside them."""
    from repro_torch.kernels import fused_adagrad as fag
    plain = fag.fused_adagrad_q8_step_

    def zero_update(grads, qs, scales, noises, params, *args, **kw):
        plain(grads, qs, scales, noises, [p.clone() for p in params], *args,
              **kw)

    monkeypatch.setattr(fag, "fused_adagrad_q8_step_", zero_update)
    want = _jax_two_party_trace("float32", "", 5, *OPT_CASES["int8"])
    dev = golden.compare(_opt_trace("int8", params), want)
    print(dev)
    assert dev["loss_rel"] > 10 * OPT_LOSS_RTOL, dev


@pytest.mark.parametrize("state_dtype,kernel", [
    ("float32", "k7"), ("bfloat16", "k7"), ("int8", "k8")])
def test_engine_hands_adagrad_kernels_operands_they_take(
        state_dtype, kernel, params, monkeypatch):
    """With the kernel route every optimizer update of a party reaches the
    in-place K7 step (fp32, bf16) or K8 step (int8) once, for all of the
    party's tensors in the reference's leaf order, with operands the
    kernel takes: (1 + R) updates of both parties a celu round, the fresh
    one unscaled and each local one scaled by its draw's valid mask."""
    from repro_torch.core.engine import _params
    from repro_torch.kernels import fused_adagrad as fag
    from repro_torch.models.tabular import make_dlrm
    seen = []

    def k7(grads, accums, params, lr, eps, scale=None):
        fag.check_step_operands(grads, accums, params, scale)
        seen.append(("k7", [tuple(p.shape) for p in params], scale))
        return fag.fused_adagrad_step_plain(grads, accums, params, lr, eps,
                                            scale)

    def k8(grads, qs, scales, noises, params, lr, eps, scale=None):
        fag.check_q8_step_operands(grads, qs, scales, noises, params, scale)
        seen.append(("k8", [tuple(p.shape) for p in params], scale))
        return fag.fused_adagrad_q8_step_plain(grads, qs, scales, noises,
                                               params, lr, eps, scale)

    monkeypatch.setattr(fag, "fused_adagrad_step_", k7)
    monkeypatch.setattr(fag, "fused_adagrad_q8_step_", k8)
    rounds, R = 3, 3
    golden.two_party_trace("celu", params, device="cpu", rounds=rounds,
                           opt_kw={"use_pallas": True,
                                   "state_dtype": state_dtype})
    init_fn, _, _ = make_dlrm(golden.TWO_PARTY_CFG)
    p = init_fn(0, golden.TWO_PARTY_CFG, "cpu")
    leaves = [[tuple(t.shape) for t in _params(p[k])] for k in ("a", "b")]
    assert {k for k, _, _ in seen} == {kernel}
    assert len(seen) == rounds * (1 + R) * 2
    # each round: A's and B's fresh updates, then R local updates of each
    for r in range(rounds):
        block = seen[r * 2 * (1 + R):(r + 1) * 2 * (1 + R)]
        assert [shapes for _, shapes, _ in block] == leaves * (1 + R)
        assert [s is None for _, _, s in block] == [True, True] + [False] * (
            2 * R)
        for _, _, s in block[2:]:
            assert s.dim() == 0 and s.dtype == torch.float32
            assert float(s) in (0.0, 1.0)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adagrad_state_keeps_its_storage_across_rounds(state_dtype, params,
                                                       monkeypatch):
    """The in-place step updates the accumulators (codes and scales) where
    they are: before the first round and after each of three, every state
    tensor of both parties has the same ``data_ptr``, and the state has
    moved."""
    from repro_torch.core import engine
    make, seen = engine.make_round, []

    def ptrs(state):
        out = []
        for st in state["opt"]["a"] + [state["opt"]["b"]]:
            for e in st["accum"]:
                out += [e.q, e.scale] if hasattr(e, "q") else [e]
        return [(t.data_ptr(), t.float().sum().item()) for t in out]

    def recording(*a, **kw):
        rnd = make(*a, **kw)

        def run(state, *ra, **rkw):
            if not seen:
                seen.append(ptrs(state))
            out = rnd(state, *ra, **rkw)
            seen.append(ptrs(out[0]))
            return out
        return run

    monkeypatch.setattr(engine, "make_round", recording)
    golden.two_party_trace("celu", params, device="cpu", rounds=3,
                           opt_kw={"use_pallas": True,
                                   "state_dtype": state_dtype})
    assert len(seen) == 4
    for later in seen[1:]:
        assert [p for p, _ in later] == [p for p, _ in seen[0]]
    assert [v for _, v in seen[3]] != [v for _, v in seen[0]]


def test_engine_lists_parameters_in_reference_leaf_order():
    """The engine's parameter lists (hence the optimizer's leaf index
    ``i``) follow JAX's flattening of the reference pytree: Party B's
    ``bias, top…, tower…, wide``, each layer's ``b`` before its ``w``."""
    from repro_torch.core.engine import _params
    from repro_torch.models.tabular import make_dlrm
    c = golden.TWO_PARTY_CFG
    jcfg = JDLRMConfig(c.model, c.fields_a, c.fields_b, c.vocab, c.embed_dim,
                       c.z_dim, tuple(c.hidden))
    jinit, _, _ = jmake_dlrm(jcfg)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    init_fn, _, _ = make_dlrm(c)
    tp = init_fn(0, c, "cpu")
    for party in ("a", "b"):
        names = {id(p): n for n, p in tp[party].named_parameters()}
        got = [names[id(p)] for p in _params(tp[party])]
        want = [jax.tree_util.keystr(path, simple=True, separator=".")
                for path, _ in
                jax.tree_util.tree_flatten_with_path(jp[party])[0]]
        assert got == want, (party, got, want)


if __name__ == "__main__":
    # regenerate the fixture (only when the golden workloads change)
    np.savez(os.path.join(GOLDEN, golden.PARAMS_NPZ), **_jax_init_params())
