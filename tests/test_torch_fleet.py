"""The port's fleet (``repro_torch.fleet``) against the scalar port engine,
the goldens and the reference's fleet, on the CPU at the golden geometry.

The cases mirror ``tests/test_fleet.py`` on the port:

  * a one-job vmap fleet replays the two-party goldens (vanilla, fedbcd,
    celu) and the three-party golden within the port's golden tolerance
    (``golden.within_tolerance``);
  * ``mode="map"`` lanes are bitwise the scalar port ``PipelinedEngine``
    of their job (rows, flush metrics, counters, final parameters), at
    depths 0 and 2;
  * vmap lanes of one spec are bitwise each other;
  * a one-job vmap fleet at depths 0, 1 and 2 against the scalar port
    ``PipelinedEngine``: counters and warm-up rows exact, losses and
    ``w_mean`` within :data:`VMAP_RTOL` / :data:`VMAP_ATOL` (measured on
    the CPU over 12 rounds: each case prints its largest deviation);
  * an N = 3 cohort with different lr, ξ and seed (seeds 1-3, so every
    uniform chain starts from ``fold_in(PRNGKey(base), seed)``) against
    the reference's ``run_fleet(mode="vmap")`` on the same parameters
    (JAX init through ``bridge.load_tree``) and the reference's uniforms
    (``jax_uniforms``): round-robin over an fp32 cache, uniform sampling
    at depth 2 and the int8 cache.  Counters exact, loss and ``w_mean``
    within the pipeline tolerance of ``tests/test_torch_pipeline.py``
    (measured: at most 1.8e-7 relative in loss, 1.8e-7 in ``w_mean``);
  * cohorts: per-job knobs share one cohort, static knobs partition the
    fleet and keep the caller's order, and ``average_flush_metrics``;
  * the int8-cache (K3 + K4) and ``cache_fused=False`` (K2a / K2b)
    cohorts run under vmap, each lane against its scalar engine;
  * ``shard=True`` without a process group, and a ``mesh=`` that is not
    a fleet mesh, are refused.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CELUConfig as JCELU
from repro.core import engine as jengine
from repro.data.synthetic import TabularSpec as JSpec
from repro.data.synthetic import aligned_batches as jbatches
from repro.data.synthetic import make_tabular as jtabular
from repro.fleet import FleetWorkload as JWorkload
from repro.fleet import JobSpec as JJobSpec
from repro.fleet import run_fleet as jrun_fleet
from repro.models.tabular import DLRMConfig as JDLRM
from repro.models.tabular import make_dlrm as jmake_dlrm
from repro_torch import golden
from repro_torch.bridge import load_flat, load_tree, subtree
from repro_torch.configs.base import CELUConfig
from repro_torch.core import engine
from repro_torch.core.uniforms import GeneratorUniforms
from repro_torch.data import to_device
from repro_torch.data.synthetic import (TabularSpec, aligned_batches,
                                        make_tabular)
from repro_torch.fleet import (FleetWorkload, JobSpec, JobUniforms,
                               average_flush_metrics, cohort_key, run_fleet)
from repro_torch.models.tabular import MLP, PartyA, WDLPartyB, make_dlrm
from repro_torch.optim import make_optimizer
from test_torch_compression import jax_uniforms
from test_torch_engine import GOLDEN
from test_torch_pipeline import PIPE_LOSS_RTOL, PIPE_W_MEAN_ATOL

torch.set_num_threads(1)

BASE = CELUConfig(R=3, W=3, xi_degrees=60.0)
# a one-job vmap fleet against the scalar engine: the batched matmuls may
# sum in another order than the unbatched ones
VMAP_RTOL = 1e-5
VMAP_ATOL = 1e-5


@pytest.fixture(scope="module")
def flat():
    return golden.load_params(GOLDEN)


def _two_party_data():
    return make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=2048, n_test=512), 0)


def _workload(flat, params_for=None, uniforms_for=None):
    """The two-party golden workload as a fleet workload: every seed gets
    the golden's initial parameters unless ``params_for`` is given."""
    cfg = golden.TWO_PARTY_CFG
    data = _two_party_data()
    init_fn, task, _ = make_dlrm(cfg)

    def golden_params(seed):
        p = init_fn(0, cfg, "cpu")
        load_flat(p["a"], subtree(flat, "two_party.a"))
        load_flat(p["b"], subtree(flat, "two_party.b"))
        return engine.lift_two_party_params(p)

    def batch_stream():
        for bi, ba, bb in aligned_batches(data["train"], 64, seed=0):
            yield bi, [ba], bb

    return FleetWorkload(engine.lift_two_party(task),
                         params_for or golden_params, batch_stream,
                         uniforms_for)


@pytest.fixture(scope="module")
def workload(flat):
    return _workload(flat)


def _rows(res, j, rounds, k3=False):
    """FleetResult job ``j`` -> rows in the golden JSON's schema."""
    rows = [{"loss": float(res.losses[j, t]),
             "w_mean": float(res.w_mean[j, t]),
             "w_zero_frac": float(res.w_zero_frac[j, t]),
             "local_steps": int(res.local_steps[j, t])}
            for t in range(rounds)]
    sa = res.steps_a[j] if k3 else res.steps_a[j][0]
    rows.append({"steps_a": sa, "steps_b": int(res.steps_b[j]),
                 "comm_rounds": int(res.comm_rounds[j])})
    return rows


def _scalar_run(wl, spec, rounds):
    """The scalar port ``PipelinedEngine`` on job ``spec`` of ``wl``, with
    the job's uniform source as the fleet makes it -> (rows, flush
    metrics, final state)."""
    celu, depth = spec.celu, spec.resolved_depth()
    celu = CELUConfig(**{**celu.__dict__, "xi_degrees": spec.resolved_xi()})
    opt = make_optimizer(spec.optimizer, spec.lr)
    params = wl.params_for(spec.seed)
    it = wl.batch_stream()
    _, ba, bb = next(it)
    bas = [to_device(b, "cpu") for b in ba]
    src = GeneratorUniforms(spec.seed, "cpu") if wl.uniforms_for is None \
        else wl.uniforms_for(spec.seed)
    state = engine.init_state(wl.task, params, opt, celu, bas,
                              to_device(bb, "cpu"),
                              uniforms=JobUniforms(src, spec.seed))
    pe = engine.make_pipeline(wl.task, opt, celu, depth=depth,
                              local_steps=spec.local_steps)
    rs = pe.init(state)
    rows = []
    it = wl.batch_stream()
    for _ in range(rounds):
        bi, ba, bb = next(it)
        rs, m = pe.step(rs, [to_device(b, "cpu") for b in ba],
                        to_device(bb, "cpu"), bi)
        rows.append({k: float(m[k]) for k in ("loss", "w_mean",
                                              "w_zero_frac")}
                    | {"local_steps": int(m["local_steps"])})
    rs, fm = pe.flush(rs)
    return rows, fm, pe.finalize(rs)


def _same(x, y):
    return (math.isnan(x) and math.isnan(y)) or x == y


# --------------------------------------------------------------------------
# Goldens: a one-job vmap fleet is the scalar engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("protocol", ["vanilla", "fedbcd", "celu"])
def test_fleet_vmap_n1_matches_two_party_golden(protocol, workload, flat):
    ccfg, nloc = engine.preset_config(protocol, BASE)
    res = run_fleet([JobSpec(celu=ccfg, local_steps=nloc)], 20,
                    workload=workload, mode="vmap", device="cpu")
    dev = golden.compare(_rows(res, 0, 20), golden.load_golden(
        GOLDEN, "two_party_trace.json")[protocol])
    print(protocol, dev)
    assert golden.within_tolerance(dev), dev
    assert res.n_cohorts == 1 and res.mode == "vmap"


def _three_party_workload(flat):
    """The three-party golden workload (``golden.three_party_trace``) as a
    fleet workload."""
    cfg = golden.THREE_PARTY_CFG
    data = make_tabular(TabularSpec("t", fields_a=8, fields_b=4, vocab=64,
                                    n_train=4096, n_test=512), seed=0)

    def params_for(seed):
        gen = torch.Generator().manual_seed(0)
        pas = [PartyA(cfg, gen), PartyA(cfg, gen)]
        pb = WDLPartyB(cfg, gen)
        pb.top = MLP(golden.THREE_PARTY_TOP, gen)
        for i, pa in enumerate(pas):
            load_flat(pa, subtree(flat, f"three_party.a{i}"))
        load_flat(pb, subtree(flat, "three_party.b"))
        return {"a": pas, "b": pb}

    def batch_stream():
        for bi, ba, bb in aligned_batches(data["train"], 64, seed=0):
            yield bi, [{"x_a": ba["x_a"][:, :4]},
                       {"x_a": ba["x_a"][:, 4:]}], bb

    return FleetWorkload(golden.three_party_task(), params_for,
                         batch_stream)


def test_fleet_vmap_n1_matches_three_party_golden(flat):
    wl = _three_party_workload(flat)
    celu = CELUConfig(R=2, W=2, xi_degrees=60.0)
    res = run_fleet([JobSpec(celu=celu, lr=0.02)], 20, workload=wl,
                    mode="vmap", device="cpu")
    dev = golden.compare(_rows(res, 0, 20, k3=True), golden.load_golden(
        GOLDEN, "three_party_trace.json")["celu"])
    print(dev)
    assert golden.within_tolerance(dev), dev


# --------------------------------------------------------------------------
# map lanes are the scalar engine, bit for bit; vmap lanes each other
# --------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [0, 2])
def test_fleet_map_n3_bitwise_scalar_engine(depth, workload):
    """Three jobs (different lr and ξ) lane by lane: each lane's rows,
    flush metrics, counters and final parameters are bitwise the scalar
    ``PipelinedEngine`` run of that job."""
    rounds = 10
    ccfg, nloc = engine.preset_config("celu", BASE)
    specs = [JobSpec(celu=ccfg, local_steps=nloc, depth=depth, lr=lr,
                     xi_degrees=xi)
             for lr, xi in ((0.05, 60.0), (0.08, 45.0), (0.02, 75.0))]
    res = run_fleet(specs, rounds, workload=workload, mode="map",
                    device="cpu")
    assert res.n_cohorts == 1 and res.cohort_sizes == [3]
    for j, spec in enumerate(specs):
        rows, fm, fin = _scalar_run(workload, spec, rounds)
        for t, row in enumerate(rows):
            got = _rows(res, j, rounds)[t]
            assert all(_same(got[k], row[k]) for k in row), (j, t, got, row)
        for k in ("w_mean", "w_zero_frac"):
            assert np.float32(res.flush_metrics[k][j]) == np.float32(
                float(fm[k])), (j, k)
        assert int(res.flush_metrics["local_steps"][j]) == int(
            fm["local_steps"])
        assert int(res.comm_rounds[j]) == int(fin["comm_rounds"])
        assert res.steps_a[j] == [int(s) for s in fin["steps"]["a"]]
        assert int(res.steps_b[j]) == int(fin["steps"]["b"])
        want = [p.detach().numpy() for m in fin["params"]["a"]
                + [fin["params"]["b"]] for p in engine._params(m)]
        got = [p for ps in res.final_state(j)["params"]["a"] for p in ps] \
            + res.final_state(j)["params"]["b"]
        assert all(np.array_equal(a, b) for a, b in zip(got, want,
                                                         strict=True))


def test_fleet_vmap_n3_lanes_bit_identical(workload):
    ccfg, nloc = engine.preset_config("celu", BASE)
    res = run_fleet([JobSpec(celu=ccfg, local_steps=nloc)] * 3, 10,
                    workload=workload, mode="vmap", device="cpu")
    for arr in (res.losses, res.w_mean, res.w_zero_frac, res.local_steps):
        for j in (1, 2):
            np.testing.assert_array_equal(arr[j], arr[0])
    p0 = res.final_state(0)["params"]
    for j in (1, 2):
        pj = res.final_state(j)["params"]
        for a, b in zip(p0["a"][0] + p0["b"], pj["a"][0] + pj["b"]):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# Pipelined depths: a one-job vmap fleet against the scalar engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_fleet_vmap_n1_matches_pipelined_engine(depth, workload):
    rounds = 12
    ccfg, nloc = engine.preset_config("celu", BASE)
    spec = JobSpec(celu=ccfg, local_steps=nloc, depth=depth)
    rows, fm, fin = _scalar_run(workload, spec, rounds)
    res = run_fleet([spec], rounds, workload=workload, mode="vmap",
                    device="cpu")
    loss_rel = w_abs = 0.0
    for t, row in enumerate(rows):
        got = _rows(res, 0, rounds)[t]
        assert got["local_steps"] == row["local_steps"], t
        assert math.isnan(got["loss"]) == math.isnan(row["loss"]), t
        if not math.isnan(row["loss"]):
            loss_rel = max(loss_rel, abs(got["loss"] - row["loss"])
                           / abs(row["loss"]))
        w_abs = max(w_abs, abs(got["w_mean"] - row["w_mean"]))
    w_abs = max(w_abs, abs(float(res.flush_metrics["w_mean"][0])
                           - float(fm["w_mean"])))
    print(f"depth {depth}: loss {loss_rel:.3g} rel, w_mean {w_abs:.3g}")
    assert loss_rel <= VMAP_RTOL and w_abs <= VMAP_ATOL
    assert int(res.flush_metrics["local_steps"][0]) == int(fm["local_steps"])
    assert int(res.comm_rounds[0]) == int(fin["comm_rounds"])
    assert res.steps_a[0] == [int(s) for s in fin["steps"]["a"]]
    assert int(res.steps_b[0]) == int(fin["steps"]["b"])


# --------------------------------------------------------------------------
# A mixed-knob cohort against the reference's vmap fleet
# --------------------------------------------------------------------------
JCFG = JDLRM("wdl", 4, 3, vocab=32, embed_dim=4, z_dim=8, hidden=(16, 8))
KNOBS = [(0.05, 60.0, 1), (0.08, 45.0, 2), (0.02, 60.0, 3)]


@pytest.fixture(scope="module")
def jax_workload():
    jinit, jtask, _ = jmake_dlrm(JCFG)
    data = jtabular(JSpec("criteo", fields_a=4, fields_b=3, vocab=32,
                          n_train=2048, n_test=512), seed=0)

    def asj(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    def batch_stream():
        for bi, ba, bb in jbatches(data["train"], 64, seed=0):
            yield bi, [asj(ba)], asj(bb)

    def params_for(seed):
        return jengine.lift_two_party_params(
            jinit(jax.random.PRNGKey(seed), JCFG))
    return JWorkload(jengine.lift_two_party(jtask), params_for,
                     batch_stream)


@pytest.mark.parametrize("case,celu_kw,depth", [
    ("round_robin", {}, 0),
    ("uniform", {"sampling": "uniform", "W": 4}, 2),
    ("int8_cache", {"cache_dtype": "int8"}, 0),
])
def test_fleet_mixed_knob_cohort_matches_reference_fleet(
        case, celu_kw, depth, flat, jax_workload):
    jinit, _, _ = jmake_dlrm(JCFG)
    init_fn, _, _ = make_dlrm(golden.TWO_PARTY_CFG)

    def params_for(seed):       # the reference's init, bridged
        jp = jax.tree_util.tree_map(
            np.asarray, jinit(jax.random.PRNGKey(seed), JCFG))
        p = init_fn(0, golden.TWO_PARTY_CFG, "cpu")
        load_tree(p["a"], jp["a"])
        load_tree(p["b"], jp["b"])
        return engine.lift_two_party_params(p)

    wl = _workload(flat, params_for, lambda seed: jax_uniforms)
    kw = {"R": 3, "W": 3, "xi_degrees": 60.0, **celu_kw}
    jres = jrun_fleet([JJobSpec(celu=JCELU(**kw), lr=lr, seed=s,
                                xi_degrees=xi, depth=depth)
                       for lr, xi, s in KNOBS], 8, workload=jax_workload,
                      mode="vmap")
    specs = [JobSpec(celu=CELUConfig(**kw), lr=lr, seed=s, xi_degrees=xi,
                     depth=depth) for lr, xi, s in KNOBS]
    res = run_fleet(specs, 8, workload=wl, mode="vmap", device="cpu")
    assert res.n_cohorts == 1 and res.cohort_sizes == [3]
    np.testing.assert_array_equal(res.local_steps, jres.local_steps)
    np.testing.assert_array_equal(res.comm_rounds, jres.comm_rounds)
    np.testing.assert_array_equal(res.steps_b, jres.steps_b)
    assert res.steps_a == [[int(s) for s in sa] for sa in jres.steps_a]
    np.testing.assert_array_equal(np.isnan(res.losses),
                                  np.isnan(jres.losses))
    ok = np.isfinite(jres.losses)
    loss_rel = np.max(np.abs(res.losses[ok] - jres.losses[ok])
                      / np.abs(jres.losses[ok]))
    w_abs = np.max(np.abs(res.w_mean - jres.w_mean))
    print(f"{case}: loss {loss_rel:.3g} rel, w_mean {w_abs:.3g}")
    assert loss_rel <= PIPE_LOSS_RTOL and w_abs <= PIPE_W_MEAN_ATOL
    # the three jobs are three trajectories
    assert not np.array_equal(res.losses[0], res.losses[1])


# --------------------------------------------------------------------------
# Cohorts and flush metrics
# --------------------------------------------------------------------------
def test_fleet_traced_knobs_share_one_cohort(workload):
    ccfg, nloc = engine.preset_config("celu", BASE)
    specs = [JobSpec(celu=ccfg, local_steps=nloc, lr=0.05, seed=0),
             JobSpec(celu=ccfg, local_steps=nloc, lr=0.1, seed=1,
                     xi_degrees=45.0),
             JobSpec(celu=ccfg, local_steps=nloc, lr=0.02, seed=2,
                     xi_degrees=75.0)]
    assert len({cohort_key(s) for s in specs}) == 1
    res = run_fleet(specs, 6, workload=workload, mode="vmap", device="cpu")
    assert res.n_cohorts == 1 and res.cohort_sizes == [3]
    assert res.losses.shape == (3, 6)
    assert np.isfinite(res.losses).all()
    assert not np.array_equal(res.losses[0], res.losses[1])
    assert not np.array_equal(res.losses[1], res.losses[2])
    assert (res.round_wire_bytes > 0).all()
    assert len(set(res.round_wire_bytes.tolist())) == 1


def test_fleet_mixed_depths_partition_and_keep_order(workload):
    rounds = 6
    ccfg, nloc = engine.preset_config("celu", BASE)
    specs = [JobSpec(celu=ccfg, local_steps=nloc, depth=0),
             JobSpec(celu=ccfg, local_steps=nloc, depth=2),
             JobSpec(celu=ccfg, local_steps=nloc, depth=0, lr=0.1)]
    assert len({cohort_key(s) for s in specs}) == 2
    res = run_fleet(specs, rounds, workload=workload, mode="vmap",
                    device="cpu")
    assert res.n_cohorts == 2 and sorted(res.cohort_sizes) == [1, 2]
    assert (res.comm_rounds == rounds).all()   # depth-2 queue drained
    assert np.isfinite(res.losses[0]).all()
    assert np.isfinite(res.losses[2]).all()
    assert np.isnan(res.losses[1, 0]) and np.isfinite(res.losses[1, 1:]).all()
    assert not np.array_equal(res.losses[0], res.losses[2])


def test_average_flush_metrics_passthrough_and_average():
    m = {"local_steps": np.int32(6), "w_mean": np.float32(0.5),
         "w_zero_frac": np.float32(0.25)}
    assert average_flush_metrics(m) == m
    rows = {"local_steps": torch.tensor(9, dtype=torch.int32),
            "w_mean_scans": torch.tensor([0.3, 0.0, 0.6]),
            "w_zero_frac_scans": torch.tensor([0.1, 0.0, 0.2]),
            "n_scans": torch.tensor(2, dtype=torch.int32)}
    out = average_flush_metrics(rows)
    assert out["local_steps"] == 9
    a, b = np.float32(0.3), np.float32(0.6)
    assert out["w_mean"] == np.float32(
        np.float32(np.float32(np.float32(0.0) + a) + np.float32(0.0) + b)
        / np.float32(2.0))


@pytest.mark.parametrize("kw,err,match", [
    ({"shard": True}, RuntimeError, "process group"),
    ({"mesh": object()}, ValueError, "'fleet' dimension")])
def test_fleet_sharding_is_refused(kw, err, match, workload):
    """Sharding needs a fleet mesh over a process group: without one it
    is refused before anything runs (``tests/test_torch_pod.py`` runs
    the sharded fleet over two ranks)."""
    with pytest.raises(err, match=match):
        run_fleet([JobSpec(celu=BASE)], 2, workload=workload, device="cpu",
                  **kw)


# --------------------------------------------------------------------------
# The other gate kernels under vmap: the int8 cache and the unfused gate
# --------------------------------------------------------------------------
@pytest.mark.parametrize("celu_kw", [{"cache_dtype": "int8"},
                                     {"cache_fused": False}])
def test_fleet_quantised_and_unfused_cohorts_under_vmap(celu_kw, flat):
    """int8 cache: K3 on every insert and K4 on every sample; unfused:
    K2a / K2b.  Each lane of a two-job vmap cohort (seeds 0 and 1, the
    reference's uniforms) against the scalar engine of its job."""
    wl = _workload(flat, uniforms_for=lambda seed: jax_uniforms)
    celu = CELUConfig(R=3, W=3, xi_degrees=60.0, **celu_kw)
    specs = [JobSpec(celu=celu, lr=0.05, seed=0),
             JobSpec(celu=celu, lr=0.08, seed=1, xi_degrees=45.0)]
    rounds = 6
    res = run_fleet(specs, rounds, workload=wl, mode="vmap", device="cpu")
    for j, spec in enumerate(specs):
        want, _, _ = _scalar_run(wl, spec, rounds)
        got = _rows(res, j, rounds)[:-1]
        for g, w in zip(got, want, strict=True):
            assert g["local_steps"] == w["local_steps"]
            assert abs(g["loss"] - w["loss"]) <= VMAP_RTOL * abs(w["loss"])
            assert abs(g["w_mean"] - w["w_mean"]) <= VMAP_ATOL
