"""The port's party-to-pod round (``repro_torch.core.pod_protocol``) against
the reference's, on the CPU: two pod ranks over gloo against the JAX round
on two forced host devices.

The reference's round is one SPMD program over a ``("pod",)`` mesh; it
runs when the mesh's axis is Auto (jax 0.9's ``jax.make_mesh`` makes
Explicit axes, on which the round stops with a ``ShardingTypeError``), so
the JAX side builds its mesh with ``axis_types=(AxisType.Auto,)`` in a
subprocess with ``--xla_force_host_platform_device_count=2``.  The port
runs one process a pod (``launch.dist.run_ranks``), from the reference's
stacked parameters sliced by pod.  Both worlds are started once for the
module and run every case; the cases read their results.

Cases: pipeline depths 0 and 1, fp32 and bf16 rings, at the reference
test's geometry (``tests/test_system.py::test_pod_protocol_subprocess``)
and a wider one.  Held: each pod's per-round loss, the final parameters,
the AdaGrad accumulators and the rings within :data:`ATOL` +
:data:`RTOL` (bf16 rings to one bf16 ulp; each case prints its largest
deviation as a share of its tolerance); pod 0's dead
``top`` copy bitwise its initial value; the transport's byte counters
exactly 2 × B × z × 4 B sent and received a pod a round (4 × B × z × 4 B
between the pods).  At the smoke's full widths (``FULL``, B = 256, depths
0 and 1): one round leaf by leaf, each leaf's update, accumulator and
ring within :data:`FULL_RTOL` of its own norm, and four free-running
rounds' losses within :data:`FULL_LOSS_ATOL`, which also witness that
the loss growth the smoke's pod phase sees is the reference's own.  Also
the mirror of
``tests/test_pipeline_depth.py::test_pod_round_rejects_deep_queue``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.pod_protocol import stacked_wdl_init as jstacked_wdl_init
from repro_torch.core import engine
from repro_torch.core import pod_protocol as pp
from repro_torch.launch.dist import run_ranks
from repro_torch.optim import make_optimizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GEOMS = {
    "ref": dict(n_fields=4, vocab=32, batch=16, W=2, z_dim=8, hidden=16,
                R=2, lr=0.05, xi_degrees=60.0, rounds=3),
    "wide": dict(n_fields=8, vocab=64, batch=48, W=3, z_dim=32, hidden=64,
                 R=3, lr=0.05, xi_degrees=60.0, rounds=4),
}
CASES = [(g, d, c) for g in GEOMS for d in (0, 1)
         for c in ("float32", "bfloat16")]
# the smoke's pod phase (chip_smoke.POD_RUN) at its parity batch: one
# round held leaf by leaf, and four rounds' losses
FULL = dict(n_fields=26, fields_b=13, vocab=1024, embed_dim=16, hidden=512,
            z_dim=256, R=5, W=5, xi_degrees=60.0, lr=0.01, teacher=True,
            batch=256)
GEOMS.update(full=dict(FULL, rounds=1), full4=dict(FULL, rounds=4))
FULL_CASES = [(g, d, "float32") for g in ("full", "full4") for d in (0, 1)]
ALL_CASES = CASES + FULL_CASES
# fp32 across frameworks: the two compute the same ops in another order,
# and AdaGrad divides a gradient by its own running norm, so where a
# gradient is a small difference of large terms its relative rounding
# error reaches the step (measured: at most 6.8e-5 in an embedding row
# after 4 rounds at lr 0.05).  A bf16 ring may round a value to the next
# bf16 on the other side: its rings are held to one bf16 ulp.
ATOL, RTOL = 1e-4, 1e-3
BF16_RTOL = 2.0 ** -7       # one bf16 ulp, relative, at its largest
# At the full widths an element-wise limit cannot hold: AdaGrad's first
# step moves every coordinate by about ±lr whatever its gradient's size,
# so one coordinate whose gradient rounds to the other sign on the other
# side is 2·lr off.  There each leaf is held by its norm (its update, its
# accumulator, each ring: FULL_RTOL of its own norm; measured at most
# 1.9e-5 after one round), and four free-running rounds by their losses
# (measured: at most 1.4e-3, at depth 0's round 4, where Party B's loss
# has risen to 1.41 on both sides).
FULL_RTOL, FULL_LOSS_ATOL = 2e-4, 5e-3

JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.core.pod_protocol import make_pod_round, init_pod_state
from repro.optim import adagrad
mesh = jax.make_mesh((2,), ("pod",),
                     axis_types=(jax.sharding.AxisType.Auto,))
with open(sys.argv[1], "rb") as f:
    runs = pickle.load(f)
out = {}
for i, (run, batches) in enumerate(runs):
    opt = adagrad(run["lr"])
    params, opt_state, ws = init_pod_state(
        jax.random.PRNGKey(run["init_seed"]), mesh, opt,
        n_fields=run["n_fields"], vocab=run["vocab"], batch=run["batch"],
        W=run["W"], embed_dim=run["embed_dim"], z_dim=run["z_dim"],
        hidden=run["hidden"], cache_dtype=run["cache_dtype"])
    rnd = make_pod_round(mesh, opt, R=run["R"],
                         cos_xi=float(np.cos(np.deg2rad(run["xi_degrees"]))),
                         pipeline_depth=run["depth"])
    losses = []
    for x, y in batches:
        params, opt_state, ws, loss = rnd(params, opt_state, ws,
                                          jnp.asarray(x), jnp.asarray(y))
        losses.append(np.asarray(loss))
    out[f"{i}/losses"] = np.stack(losses)
    for name, tree in (("params", params), ("accum", opt_state["accum"]),
                       ("ws", ws)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(p.key) for p in path)
            out[f"{i}/{name}/{key}"] = np.asarray(leaf, np.float32) \
                if leaf.dtype == jnp.bfloat16 else np.asarray(leaf)
np.savez(sys.argv[2], **out)
print("JAX_POD_OK")
"""


def _run(case):
    g, depth, cache = case
    return {**GEOMS[g], "depth": depth, "cache_dtype": cache,
            "device": "cpu"}


def _start_jax(runs, tmp, tag):
    """The reference's rounds for ``runs`` in a subprocess (the batches
    go in a pickle, so the subprocess imports no torch)."""
    import pickle
    inp, out = str(tmp / f"{tag}.pkl"), str(tmp / f"{tag}.npz")
    with open(inp, "wb") as f:
        pickle.dump([(r, pp.pod_batches(r)) for r in runs], f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", JAX_CODE, inp, out],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _collect(proc, out, n):
    stdout, stderr = proc.communicate(timeout=600)
    assert "JAX_POD_OK" in stdout, stderr[-3000:]
    with np.load(out) as z:
        return [{k.split("/", 1)[1]: z[k] for k in z.files
                 if k.split("/", 1)[0] == str(i)} for i in range(n)]


_FLEET = {}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the JAX subprocesses (one a geometry), run the port's two pod
    ranks and the sharded fleet's world meanwhile, and return (JAX
    results by case, port results by case, initial parameters)."""
    runs = [{**pp.POD_DEFAULTS, **_run(c)} for c in ALL_CASES]
    inits = []
    for run in runs:
        jp = jstacked_wdl_init(jax.random.PRNGKey(run["init_seed"]),
                               run["n_fields"], run["vocab"],
                               run["embed_dim"], run["z_dim"],
                               run["hidden"])
        inits.append(jax.tree_util.tree_map(np.asarray, jp))
    tmp = tmp_path_factory.mktemp("jpod")
    procs = {g: _start_jax([r for c, r in zip(ALL_CASES, runs)
                            if c[0] == g], tmp, g) for g in GEOMS}
    try:
        port = run_ranks(pp.pod_worker, 2, backend="gloo",
                         args=([{**r, "params": p}
                                for r, p in zip(runs, inits)],))
        _FLEET["world"] = run_ranks(_fleet_rank, 2, backend="gloo")
    finally:
        jres = {g: _collect(*procs[g], sum(c[0] == g for c in ALL_CASES))
                for g in GEOMS}
    jres = [jres[c[0]][[d for d in ALL_CASES if d[0] == c[0]].index(c)]
            for c in ALL_CASES]
    return jres, port, inits


def _dev(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (ATOL + rtol * np.abs(b))))


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_pod_round_matches_jax_pod_round(case, worlds):
    jres, port, inits = worlds
    i = ALL_CASES.index(case)
    run = {**pp.POD_DEFAULTS, **_run(case)}
    J = jres[i]
    B, z = run["batch"], run["z_dim"]
    worst = {}
    for pod in (0, 1):
        got = port[pod][i]
        worst[f"loss{pod}"] = _dev(got["losses"], J["losses"][:, pod])
        for g in ("tower", "top"):
            for k, v in got["params"][g].items():
                worst[f"{g}.{k}{pod}"] = _dev(v, J[f"params/{g}/{k}"][pod])
        # the accumulators in JAX's leaf order (top then tower, sorted)
        keys = [f"{g}/{k}" for g in ("top", "tower")
                for k in sorted(got["params"][g])]
        for key, acc in zip(keys, got["accum"], strict=True):
            worst[f"accum.{key}{pod}"] = _dev(acc, J[f"accum/{key}"][pod])
        for k in ("z", "dz", "x", "y"):
            rtol = BF16_RTOL if k in ("z", "dz") and \
                run["cache_dtype"] == "bfloat16" else RTOL
            worst[f"ws.{k}{pod}"] = _dev(got["ws"][k], J[f"ws/{k}"][pod],
                                         rtol)
        assert got["ws"]["time"] == int(J["ws/time"][pod]) == run["rounds"]
        # bytes over the link: one up and one down message a round
        c = got["counters"]
        assert c["sent_bytes"] == c["recv_bytes"] \
            == 2 * run["rounds"] * B * z * 4
        assert c["staged_bytes"] == 0
    # what crossed the link is what each pod cached: Z_A and ∇Z_A are
    # bitwise the same on both pods (the rings' other slots hold zeros)
    for k in ("z", "dz"):
        np.testing.assert_array_equal(port[0][i]["ws"][k],
                                      port[1][i]["ws"][k])
    # pod 0's dead top copy never moves, in either framework
    assert port[0][i]["dead_top_kept"]
    for k, v in port[0][i]["params"]["top"].items():
        np.testing.assert_array_equal(v, inits[i]["top"][k][0])
        np.testing.assert_array_equal(J[f"params/top/{k}"][0],
                                      inits[i]["top"][k][0])
    total = sum(port[p][i]["counters"]["sent_bytes"] for p in (0, 1))
    assert total == 4 * B * z * 4 * run["rounds"]
    name = max(worst, key=worst.get)
    print(f"{case}: largest deviation {worst[name]:.3f} of the tolerance "
          f"at {name}")
    assert worst[name] <= 1.0, (name, worst[name])


def _rel(a, b, base=None):
    """||a - b|| / ||b - base|| over one leaf (0 where both are zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if base is not None:
        b0 = np.asarray(base, np.float64)
        a, b = a - b0, b - b0
    num, den = float(np.linalg.norm(a - b)), float(np.linalg.norm(b))
    return num / den if den > 0 else (0.0 if num == 0 else np.inf)


def _full_case(case, worlds):
    jres, port, inits = worlds
    i = ALL_CASES.index(case)
    return jres[i], [port[0][i], port[1][i]], inits[i]


@pytest.mark.parametrize("depth", [0, 1])
def test_pod_round_at_full_width_matches_jax(depth, worlds):
    """One round at the smoke's widths, leaf by leaf: each leaf's update,
    each accumulator and each ring within FULL_RTOL of its own norm."""
    J, got, init = _full_case(("full", depth, "float32"), worlds)
    worst = {}
    for pod in (0, 1):
        r = got[pod]
        worst[f"loss{pod}"] = float(np.abs(
            np.asarray(r["losses"]) - J["losses"][:, pod]).max())
        for g in ("tower", "top"):
            for k, v in r["params"][g].items():
                worst[f"update {g}.{k}{pod}"] = _rel(
                    v, J[f"params/{g}/{k}"][pod], init[g][k][pod])
        keys = [f"{g}/{k}" for g in ("top", "tower")
                for k in sorted(r["params"][g])]
        for key, acc in zip(keys, r["accum"], strict=True):
            worst[f"accum {key}{pod}"] = _rel(acc, J[f"accum/{key}"][pod])
        for k in ("z", "dz"):
            worst[f"ring {k}{pod}"] = _rel(r["ws"][k], J[f"ws/{k}"][pod])
        assert r["counters"]["sent_bytes"] == 2 * 256 * 256 * 4
    assert got[0]["dead_top_kept"]
    loss = max(v for k, v in worst.items() if k.startswith("loss"))
    name = max((k for k in worst if not k.startswith("loss")),
               key=worst.get)
    print(f"full width, depth {depth}: losses within {loss:.3g} (limit "
          f"{FULL_LOSS_ATOL}); largest relative deviation {worst[name]:.3g} "
          f"at {name} (limit {FULL_RTOL})")
    assert loss <= FULL_LOSS_ATOL and worst[name] <= FULL_RTOL


@pytest.mark.parametrize("depth", [0, 1])
def test_pod_loss_growth_at_full_width_is_the_references(depth, worlds):
    """Four rounds at the smoke's widths, each side free-running: Party
    B's loss rises from ln 2 in the JAX round itself (AdaGrad at lr 0.01
    moves each of some 10^6 coordinates by about lr in its first steps),
    and the port's per-round losses follow it within FULL_LOSS_ATOL."""
    J, got, _ = _full_case(("full4", depth, "float32"), worlds)
    dev = max(float(np.abs(np.asarray(got[pod]["losses"])
                           - J["losses"][:, pod]).max()) for pod in (0, 1))
    jb = J["losses"][:, 1]
    print(f"full width, depth {depth}, 4 rounds: JAX's Party B losses "
          f"{np.round(jb, 5).tolist()}, the port's "
          f"{np.round(got[1]['losses'], 5).tolist()}; largest deviation "
          f"{dev:.3g} (limit {FULL_LOSS_ATOL})")
    assert jb.max() > jb[0] + 0.2
    assert dev <= FULL_LOSS_ATOL


def test_pod_round_rejects_deep_queue():
    """The pod round runs one exchange a round: it cannot host a D-deep
    queue."""
    with pytest.raises(ValueError, match="pipeline_depth"):
        engine.make_pod_round(None, make_optimizer("adagrad", 0.01),
                              R=2, cos_xi=0.5, tower_fwd=lambda p, x: x,
                              top_loss=lambda p, a, b, y: y,
                              pipeline_depth=2)


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_pod_state_refuses_quantised_rings(cache_dtype):
    with pytest.raises(ValueError, match="cache_dtype"):
        pp.init_pod_state(torch.Generator(), None,
                          make_optimizer("adagrad", 0.01), n_fields=2,
                          vocab=4, batch=2, W=1, cache_dtype=cache_dtype,
                          pod=0, device="cpu")


# --------------------------------------------------------------------------
# The fleet's job axis over two ranks (the reference's shard=True / mesh=)
# --------------------------------------------------------------------------
FLEET_JOBS, FLEET_ROUNDS = 8, 4


def _fleet_workload():
    from repro_torch.core import engine as E
    from repro_torch.data.synthetic import (TabularSpec, aligned_batches,
                                            make_tabular)
    from repro_torch.fleet import FleetWorkload
    from repro_torch.models.tabular import DLRMConfig, make_dlrm
    data = make_tabular(TabularSpec("criteo", fields_a=4, fields_b=3,
                                    vocab=32, n_train=2048, n_test=512), 0)
    cfg = DLRMConfig("wdl", 4, 3, vocab=32, embed_dim=4, z_dim=8,
                     hidden=(16, 8))
    init_fn, task, _ = make_dlrm(cfg)

    def batch_stream():
        for bi, ba, bb in aligned_batches(data["train"], 64, seed=0):
            yield bi, [ba], bb
    return FleetWorkload(E.lift_two_party(task),
                         lambda s: E.lift_two_party_params(
                             init_fn(s, cfg, "cpu")), batch_stream)


def _fleet_specs(n):
    from repro_torch.configs.base import CELUConfig
    from repro_torch.core import engine as E
    from repro_torch.fleet import JobSpec
    ccfg, nloc = E.preset_config("celu", CELUConfig(R=3, W=3,
                                                    xi_degrees=60.0))
    return [JobSpec(celu=ccfg, local_steps=nloc, seed=s) for s in range(n)]


def _fleet_rank(rank, world):
    """Each rank: the sharded fleet in both modes (and rank 0 the
    one-process fleet), and the refusal of a job count that the world
    does not divide."""
    from repro_torch.fleet import run_fleet
    from repro_torch.launch.mesh import make_fleet_mesh
    torch.set_num_threads(1)
    wl, specs = _fleet_workload(), _fleet_specs(FLEET_JOBS)
    mesh = make_fleet_mesh()
    out = {}
    for mode in ("vmap", "map"):
        res = run_fleet(specs, FLEET_ROUNDS, workload=wl, mode=mode,
                        mesh=mesh, device="cpu")
        out[mode] = (res.losses, res.w_mean, res.comm_rounds,
                     res._final)
        if rank == 0:
            one = run_fleet(specs, FLEET_ROUNDS, workload=wl, mode=mode,
                            device="cpu")
            out[mode + "_one"] = (one.losses, one.w_mean, one.comm_rounds,
                                  one._final)
    try:
        run_fleet(_fleet_specs(3), 1, workload=wl, shard=True, device="cpu")
    except ValueError as e:
        out["refused"] = str(e)
    from repro_torch.launch.mesh import make_production_mesh
    for multi in (False, True):
        try:
            make_production_mesh(multi_pod=multi)
        except ValueError as e:
            out[f"production{int(multi)}"] = str(e)
    return out


@pytest.fixture(scope="module")
def fleet_world(worlds):
    """Run in ``worlds`` while the JAX subprocesses run."""
    return _FLEET["world"]


def _flat_params(final):
    return [x for p in final["params"]["a"] for x in p] \
        + list(final["params"]["b"])


def test_sharded_fleet_map_is_bitwise_the_one_process_fleet(fleet_world):
    got, want = fleet_world[0]["map"], fleet_world[0]["map_one"]
    for r in fleet_world:      # every rank holds the gathered result
        np.testing.assert_array_equal(r["map"][0], want[0])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for fa, fb in zip(got[3], want[3], strict=True):
        for a, b in zip(_flat_params(fa), _flat_params(fb), strict=True):
            np.testing.assert_array_equal(a, b)


def test_sharded_fleet_vmap_matches_the_one_process_fleet(fleet_world):
    """Two blocks of four jobs batch their GEMMs otherwise than eight:
    allclose, as the reference's sharded fleet test holds it."""
    got, want = fleet_world[0]["vmap"], fleet_world[0]["vmap_one"]
    assert np.isfinite(got[0]).all()
    np.testing.assert_array_equal(fleet_world[1]["vmap"][0], got[0])
    print("largest loss deviation", np.abs(got[0] - want[0]).max())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])


def test_sharded_fleet_refuses_an_undivided_cohort(fleet_world):
    for r in fleet_world:
        assert "does not divide the 2-device fleet mesh" in r["refused"]


def test_production_mesh_needs_its_world(fleet_world):
    """The (16, 16) and (2, 16, 16) meshes need 256 and 512 ranks: a
    two-rank world is refused with the mesh's axes named."""
    r = fleet_world[0]
    assert "needs 256 ranks" in r["production0"] and "'data', 'model'" \
        in r["production0"]
    assert "needs 512 ranks" in r["production1"] and "'pod'" \
        in r["production1"]


def test_staged_transport_takes_card_tensors_only():
    """Staging carries a CUDA tensor through the host; a CPU tensor is
    refused, not sent as it is."""
    with pytest.raises(ValueError, match="CUDA"):
        engine.PodTransport(staged=True)._stage_out(torch.zeros(2), "up")
