"""The twins of the reference's example scripts (``examples/torch``)
against the JAX package, on the CPU.

Each twin is loaded by its path and held to the reference script it
mirrors:

  * ``quickstart``: the seven presets' ``CELUConfig`` and local updates
    equal ``repro.core.engine.preset_config`` over the reference's base;
    the hard workload's arrays equal ``repro.data.synthetic``'s; three
    rounds of each preset, from JAX-initialised parameters and on the
    reference's uniforms (``jax_uniforms``), against the reference
    engine: counters exact, losses within :data:`LOSS_RTOL` relative,
    the AUC within :data:`AUC_ATOL`; the printed byte and cache figures
    and simulated-WAN seconds equal the reference's (computed with its
    ``make_transport``, ``workset_nbytes`` and ``WANClock``);
  * ``multiparty_vfl``: ten rounds of the three-party task from bridged
    parameters against the reference engine on the task the JAX script
    builds: counters and bytes exact, losses and AUC as above;
  * ``llm_vfl_training``: the budget lines and the training argv equal
    the reference script's (full and reduced smollm-360m); a two-round
    reduced run ends with finite losses and the reference's wire bytes;
  * ``serve_split_model``: the engine's wire line equals the reference
    serving CLI's at the same flags;
  * ``pod_protocol_demo``: two gloo ranks from the reference's stacked
    parameters on the reference script's batches, the 20 Party-B losses
    against the JAX pod round (mesh axis Auto, as
    ``tests/test_torch_pod.py``) within :data:`POD_ATOL` +
    :data:`POD_RTOL`; the bytes per update equal the reference's
    ``collective_bytes`` of the compiled round, with no factor: XLA counts
    the two permutes one device executes, each with a (B, z) fp32
    operand, and the transport's ``sent_bytes`` of one pod counts the
    same two messages;
  * ``multipod_dryrun``: the cheapest line (smollm-360m decode_32k)
    prints the fields of the dry-run CLI's JSON.

Each twin imports neither ``jax``, nor ``repro``, nor ``benchmarks``, and
raises when asked for a card that is absent.  ``chip_smoke.py`` holds the
twins' kernel launches on the card to counts it derives; here each
derivation must equal the calls of the kernels' wrappers (their plain
versions run on the CPU, so the calls are counted).

The pod round's JAX side and the dry-run run in the background from the
module's start (:func:`background`), so the file takes about as long as
its slowest part.
"""
import ast
import collections
import concurrent.futures
import dataclasses
import importlib.util
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CELUConfig as JCELU
from repro.core import engine as jengine
from repro.core.pod_protocol import stacked_wdl_init as jstacked_wdl_init
from repro.core.workset import QUANT_KEYS as JQUANT_KEYS
from repro.core.workset import workset_nbytes as jworkset_nbytes
from repro.data import synthetic as jsynth
from repro.launch.wan import WANClock as JWANClock
from repro.models import tabular as JT
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.bridge import load_tree
from repro_torch.kernels import fused_adagrad as fag
from repro_torch.kernels import fused_sample as fs
from repro_torch.kernels import quantize as qz
from repro_torch.models.tabular import make_dlrm
from test_torch_compression import jax_uniforms

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "torch")
TWINS = ("quickstart", "multiparty_vfl", "llm_vfl_training",
         "serve_split_model", "pod_protocol_demo", "multipod_dryrun")
# float32 in two frameworks: the same ops in other orders (measured on the
# CPU: at most 1.1e-6 relative in a quickstart loss, at the int8_topk
# wire, whose stochastic rounding can meet a one-ulp difference near a
# code boundary; 8.9e-8 in a multiparty loss; 4.5e-7 and 2.4e-7 in an
# AUC)
LOSS_RTOL = 1e-5
AUC_ATOL = 1e-5
# the pod round over 20 rounds at lr 0.05: AdaGrad divides a gradient by
# its own running norm, so where a gradient is a small difference of large
# terms its rounding reaches the step (tests/test_torch_pod.py; measured
# here: at most 0.0063 of this limit)
POD_ATOL, POD_RTOL = 1e-4, 1e-3
QS_ROUNDS = 3
MP_ROUNDS = 10
DRYRUN = ("smollm-360m", "decode_32k")

_TWINS = {}


def twin(name: str):
    """The twin ``examples/torch/<name>.py`` as a module (once)."""
    if name not in _TWINS:
        spec = importlib.util.spec_from_file_location(
            f"twin_{name}", os.path.join(EXAMPLES, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _TWINS[name] = mod
    return _TWINS[name]


def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


@pytest.fixture
def calls(monkeypatch):
    """A Counter of the calls of the kernels' wrappers on the twins'
    paths, keyed like ``_cuda.LAUNCHES``."""
    counts = collections.Counter()
    for mod, name, key in (
            (fs, "fused_sample_2d", "fused_sample_2d"),
            (fs, "fused_sample_q8_2d", "fused_sample_q8_2d"),
            (fs, "fused_sample_q4_2d", "fused_sample_q4_2d"),
            (qz, "quantize_sr_2d", "quantize_sr_2d"),
            (fag, "fused_adagrad_step_", "fused_adagrad"),
            (fag, "fused_adagrad_q8_step_", "fused_adagrad_q8")):
        def run(*a, fn=getattr(mod, name), key=key, **k):
            counts[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, run)
    return counts


# --------------------------------------------------------------------------
# Work that runs in the background from the module's start
# --------------------------------------------------------------------------
JAX_POD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.core.engine import PodTransport
from repro.core.pod_protocol import make_pod_round, init_pod_state
from repro.optim import adagrad
from repro.launch.dryrun import collective_bytes

# examples/pod_protocol_demo.py's round, on an Auto mesh axis
mesh = jax.make_mesh((2,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
opt = adagrad(0.05)
params, opt_state, ws = init_pod_state(jax.random.PRNGKey(0), mesh, opt,
                                        n_fields=8, vocab=64, batch=128,
                                        W=3, z_dim=16, hidden=32)
rnd = make_pod_round(mesh, opt, R=3, cos_xi=0.5,
                     transport=PodTransport(axis="pod"))
rng = np.random.default_rng(0)
teacher = rng.normal(size=(16, 64)).astype(np.float32)
losses, xs, ys = [], [], []
for i in range(20):
    x = rng.integers(0, 64, size=(2, 128, 8), dtype=np.int32)
    logit = teacher[np.arange(16)[None, :],
                    x.transpose(1, 0, 2).reshape(128, 16)].sum(1) / 4.0
    y = np.stack([np.zeros(128, np.float32),
                  (rng.random(128) < 1/(1+np.exp(-logit))).astype(np.float32)])
    params, opt_state, ws, loss = rnd(params, opt_state, ws,
                                      jnp.asarray(x), jnp.asarray(y))
    losses.append(np.asarray(loss)); xs.append(x); ys.append(y)
cp = {}
for R in (0, 5):
    p, o, w = init_pod_state(jax.random.PRNGKey(0), mesh, opt, n_fields=16,
                             vocab=512, batch=4096, W=5, z_dim=256,
                             hidden=256)
    r = make_pod_round(mesh, opt, R=max(R, 1), cos_xi=0.5)
    x = jax.ShapeDtypeStruct((2, 4096, 16), jnp.int32)
    y = jax.ShapeDtypeStruct((2, 4096), jnp.float32)
    txt = r.lower(p, o, w, x, y).compile().as_text()
    cp[f"cp{R}"] = np.int64(collective_bytes(txt)["collective-permute"])
np.savez(sys.argv[1], losses=np.stack(losses), x=np.stack(xs),
         y=np.stack(ys), **cp)
print("JAX_POD_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """Start the reference's pod rounds (a subprocess on two forced host
    devices) and the multipod twin's dry-run (its own subprocess, from a
    thread) before the module's first test; -> their handles."""
    out = str(tmp_path_factory.mktemp("examples") / "jax_pod.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", JAX_POD, out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    dry = pool.submit(twin("multipod_dryrun").main,
                      ["--arch", DRYRUN[0], "--shape", DRYRUN[1]])
    yield {"pod": (proc, out), "dryrun": dry}
    if proc.poll() is None:
        proc.kill()
        proc.communicate()
    pool.shutdown(wait=True)


# --------------------------------------------------------------------------
# Every twin
# --------------------------------------------------------------------------
def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_twins_import_neither_jax_nor_the_reference():
    """No twin imports ``jax``, ``repro`` or ``benchmarks``, in its text
    or through what it imports (six twins loaded in a fresh process)."""
    files = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    assert files == sorted(f"{t}.py" for t in TWINS)
    for f in files:
        for mod in _imports(os.path.join(EXAMPLES, f)):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro",
                                             "benchmarks"), (f, mod)
    code = (
        "import importlib.util, os, sys\n"
        f"d = {EXAMPLES!r}\n"
        "for f in sorted(os.listdir(d)):\n"
        "    if f.endswith('.py'):\n"
        "        s = importlib.util.spec_from_file_location(f[:-3], "
        "os.path.join(d, f))\n"
        "        s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "BAD []" in out.stdout, out.stdout + out.stderr[-2000:]


@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_an_absent_card(name, monkeypatch):
    """``--device cuda`` raises where no card is (no fallback to the CPU);
    so does the default of every twin but the dry-run's, whose trace needs
    no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin(name).main(["--device", "cuda"])
    if name != "multipod_dryrun":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twin(name).main([])


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------
QS_PRESETS = [p[0] for p in twin("quickstart").PRESETS]


def _reference_base(kw):
    """The reference benchmark's base ``CELUConfig`` for a preset's
    options (``benchmarks/common.py::run_protocol``'s defaults)."""
    return JCELU(R=kw.get("R", 5), W=kw.get("W", 5),
                 xi_degrees=kw.get("xi", 60.0), weighting=True,
                 sampling="round_robin",
                 pipeline_depth=kw.get("pipeline_depth", 0),
                 pipeline_lr_damping=0.25,
                 cache_dtype=kw.get("cache_dtype", "float32"),
                 cache_fused=True)


def _preset(name):
    return next(p for p in twin("quickstart").PRESETS if p[0] == name)


@pytest.mark.parametrize("name", QS_PRESETS)
def test_quickstart_presets_are_the_references(name):
    qs = twin("quickstart")
    _, proto, kw = _preset(name)
    opts = {k: v for k, v in kw.items() if k != "compression"}
    got, n = qs.preset_config(proto, **opts)
    want, jn = jengine.preset_config(proto, _reference_base(kw))
    assert n == jn
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def workload():
    return twin("quickstart").hard_workload()


def test_quickstart_data_is_the_references(workload):
    spec, data, cfg = workload
    jspec = dataclasses.replace(jsynth.TABULAR_SPECS["criteo"], vocab=512,
                                n_train=131072, n_test=8192)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    want = jsynth.make_tabular(jspec, seed=0)
    for split in ("train", "test"):
        for k in ("x_a", "x_b", "y"):
            np.testing.assert_array_equal(data[split][k], want[split][k])
    assert (cfg.model, cfg.fields_a, cfg.fields_b, cfg.vocab, cfg.embed_dim,
            cfg.z_dim, tuple(cfg.hidden)) == ("wdl", 26, 13, 512, 8, 32,
                                              (64, 32))


def _jcfg(cfg):
    return JT.DLRMConfig(cfg.model, cfg.fields_a, cfg.fields_b, cfg.vocab,
                         cfg.embed_dim, cfg.z_dim, tuple(cfg.hidden))


def _asj(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _jax_protocol(proto, kw, data, jcfg, params, rounds):
    """``benchmarks/common.py::run_protocol``'s path through the
    reference engine for one preset -> (per-round (loss, local steps),
    final counters, final AUC, the cut statistics' cache bytes, the wire
    bytes a round)."""
    _, task, predict = JT.make_dlrm(jcfg)
    depth = kw.get("pipeline_depth", 0)
    ccfg, nloc = jengine.preset_config(proto, _reference_base(kw))
    opt = jmake_optimizer("adagrad", 0.003)
    etask = jengine.lift_two_party(task)
    tp = jengine.make_transport(ccfg, kw.get("compression"))
    it = jsynth.aligned_batches(data["train"], 256, seed=0)
    _, ba, bb = next(it)
    state = jengine.init_state(etask, jengine.lift_two_party_params(params),
                               opt, ccfg, [_asj(ba)], _asj(bb), transport=tp)
    tables = list(state["ws"]["a"]) + [state["ws"]["b"]]
    cache = sum(jworkset_nbytes(w, JQUANT_KEYS) for w in tables)
    if depth:
        drv = jengine.make_pipeline(etask, opt, ccfg, depth=depth,
                                    local_steps=nloc, transport=tp)
        state = drv.init(state)
        step = drv.step
    else:
        step = jengine.make_round(etask, opt, ccfg, local_steps=nloc,
                                  transport=tp)
    it = jsynth.aligned_batches(data["train"], 256, seed=0)
    rows = []
    for _ in range(rounds):
        bi, ba, bb = next(it)
        state, m = step(state, [_asj(ba)], _asj(bb), bi)
        rows.append((float(m["loss"]), int(m["local_steps"])))
    # the reference evaluates after the last round's step, before the drain
    te = data["test"]
    logits = predict(jengine.unlift_params(state.params if depth
                                           else state["params"]), jcfg,
                     {"x_a": jnp.asarray(te["x_a"])},
                     {"x_b": jnp.asarray(te["x_b"]),
                      "y": jnp.asarray(te["y"])})
    if depth:
        state, _ = drv.flush(state)
        state = drv.finalize(state)
    counters = (int(state["steps"]["a"][0]), int(state["steps"]["b"]),
                int(state["comm_rounds"]))
    return rows, counters, JT.auc(np.asarray(logits, np.float64), te["y"]), \
        cache, tp.round_bytes([(256, jcfg.z_dim)])


def _bridged_dlrm(cfg, jcfg, seed=0):
    """(reference parameters, the port's modules loaded from them)."""
    jp = jax.tree_util.tree_map(
        np.asarray, JT.make_dlrm(jcfg)[0](jax.random.PRNGKey(seed), jcfg))
    init_fn = make_dlrm(cfg)[0]
    p = init_fn(seed, cfg, "cpu")
    for k in ("a", "b"):
        load_tree(p[k], jp[k])
    return jax.tree_util.tree_map(jnp.asarray, jp), p


@pytest.mark.parametrize("name", QS_PRESETS)
def test_quickstart_rounds_match_the_reference_engine(name, workload,
                                                      calls):
    """Three rounds of each preset from the same parameters on the same
    uniforms: the counters and bytes exact, the losses and the AUC within
    the limits; and ``chip_smoke``'s derived launches equal the
    wrappers' calls."""
    qs = twin("quickstart")
    _, proto, kw = _preset(name)
    spec, data, cfg = workload
    jcfg = _jcfg(cfg)
    jp, params = _bridged_dlrm(cfg, jcfg)
    got = qs.run_protocol(proto, data, cfg, rounds=QS_ROUNDS,
                          eval_every=QS_ROUNDS, device="cpu", params=params,
                          uniforms=jax_uniforms, **kw)
    launches = dict(calls)
    rows, counters, a, cache, zb = _jax_protocol(proto, kw, data, jcfg, jp,
                                                 QS_ROUNDS)
    assert got["local_steps"] == [r[1] for r in rows]
    assert (got["steps_a"], got["steps_b"], got["comm_rounds"]) == counters
    assert got["stat_cache_bytes"] == cache and got["z_bytes_per_round"] == zb
    dev = 0.0
    for g, (w, _) in zip(got["loss_curve"], rows, strict=True):
        assert math.isnan(g) == math.isnan(w)
        if not math.isnan(w):
            dev = max(dev, abs(g - w) / abs(w))
    auc_dev = abs(got["final_auc"] - a)
    print(f"{name}: loss rel dev {dev:.3g} (limit {LOSS_RTOL}), AUC dev "
          f"{auc_dev:.3g} (limit {AUC_ATOL}); launches {launches}")
    assert dev <= LOSS_RTOL and auc_dev <= AUC_ATOL
    want = _chip_smoke()._quickstart_launches(proto, kw, QS_ROUNDS, 2)
    assert launches == want


def test_quickstart_prints_the_references_figures():
    """The printed byte, cache and simulated-WAN figures equal the
    reference's, computed with its transports, rings and WAN clock."""
    qs = twin("quickstart")
    rounds = 2
    out = qs.main(["--device", "cpu", "--rounds", str(rounds)])
    spec, data, cfg = qs.hard_workload()
    jcfg = _jcfg(cfg)
    zshape = [(256, jcfg.z_dim)]
    assert out["z_bytes_per_round"] == jengine.make_transport(
        JCELU()).round_bytes(zshape) == 65536
    assert out["int8_topk_bytes_per_round"] == jengine.make_transport(
        JCELU(), "int8_topk").round_bytes(zshape)
    # the rings as the reference's init_state sizes them
    _, task, _ = JT.make_dlrm(jcfg)
    jp = JT.make_dlrm(jcfg)[0](jax.random.PRNGKey(0), jcfg)
    _, ba, bb = next(jsynth.aligned_batches(data["train"], 256, seed=0))
    for dtype in ("float32", "int8"):
        ccfg = JCELU(R=5, W=5, cache_dtype=dtype)
        st = jengine.init_state(jengine.lift_two_party(task),
                                jengine.lift_two_party_params(jp),
                                jmake_optimizer("adagrad", 0.003), ccfg,
                                [_asj(ba)], _asj(bb))
        want = sum(jworkset_nbytes(w, JQUANT_KEYS)
                   for w in list(st["ws"]["a"]) + [st["ws"]["b"]])
        assert out["cache_bytes"][dtype] == want
    tp = jengine.make_transport(JCELU())
    up, down = tp.uplink_bytes((4096, 256)), tp.downlink_bytes((4096, 256))
    for depth in (0, 1, 2):
        want = JWANClock().time_to_target(
            rounds, up, down, exchange_compute_s=0.04,
            local_compute_s=5 * 0.04, pipeline_depth=depth)
        assert out["sim_wan_s"][depth] == want
    assert out["lines"][0] == \
        "== CELU-VFL quickstart: WDL on synthetic Criteo =="
    assert [ln.split(":")[0] for ln in out["lines"][2:9]] == QS_PRESETS
    assert len(out["lines"]) == 13


# --------------------------------------------------------------------------
# multiparty_vfl
# --------------------------------------------------------------------------
def _jax_multiparty(rounds, eval_every):
    """``examples/multiparty_vfl.py``'s run in the reference, cut to
    ``rounds`` -> (history, counters, local steps a round, bytes, the
    initial parameters)."""
    spec = jsynth.TabularSpec("3party", fields_a=8, fields_b=4, vocab=128,
                              n_train=16384, n_test=4096)
    data = jsynth.make_tabular(spec, seed=0)
    cfg = JT.DLRMConfig("wdl", 4, 4, vocab=128, embed_dim=8, z_dim=16,
                        hidden=(32, 16))
    init_fn, _, _ = JT.make_dlrm(cfg)
    pa1 = init_fn(jax.random.PRNGKey(0), cfg)["a"]
    pa2 = init_fn(jax.random.PRNGKey(1), cfg)["a"]
    pb = dict(init_fn(jax.random.PRNGKey(2), cfg)["b"])
    pb["top"] = JT._mlp_init(jax.random.PRNGKey(3), [3 * cfg.z_dim, 32, 1])
    init = jax.tree_util.tree_map(np.asarray,
                                  {"a": [pa1, pa2], "b": pb})

    def forward_a(pa, batch_a):
        return JT._tower(pa["tower"], batch_a["x_a"])

    def loss_b(pb_, z_list, batch_b):
        z_b = JT._tower(pb_["tower"], batch_b["x_b"])
        h = jnp.concatenate([z.astype(jnp.float32) for z in z_list] + [z_b],
                            axis=-1)
        logit = JT._mlp(pb_["top"], h)[:, 0]
        F = batch_b["x_b"].shape[1]
        wide = pb_["wide"][jnp.arange(F)[None, :], batch_b["x_b"]].sum(1)
        logit = logit + wide + pb_["bias"]
        y = batch_b["y"]
        li = jnp.maximum(logit, 0) - logit * y + jnp.log1p(
            jnp.exp(-jnp.abs(logit)))
        return li, jnp.float32(0.0)

    task = jengine.KPartyTask(forward_a, loss_b)
    celu = JCELU(R=3, W=3, xi_degrees=60.0)
    opt = jmake_optimizer("adagrad", 0.01)
    transport = jengine.SimWANTransport(celu)

    def split(ba, bb):
        return ([{"x_a": jnp.asarray(ba["x_a"][:, :4])},
                 {"x_a": jnp.asarray(ba["x_a"][:, 4:])}],
                {"x_b": jnp.asarray(bb["x_b"]), "y": jnp.asarray(bb["y"])})
    it = jsynth.aligned_batches(data["train"], 256, seed=0)
    _, ba, bb = next(it)
    bas, b = split(ba, bb)
    state = jengine.init_state(task, {"a": [pa1, pa2], "b": pb}, opt, celu,
                               bas, b)
    rnd = jengine.make_round(task, opt, celu, transport=transport)
    it = jsynth.aligned_batches(data["train"], 256, seed=0)
    history, local = [], []
    te = data["test"]
    for i in range(rounds):
        bi, ba, bb = next(it)
        bas, b = split(ba, bb)
        state, m = rnd(state, bas, b, bi)
        local.append(int(m["local_steps"]))
        if (i + 1) % eval_every == 0:
            p = state["params"]
            z1 = forward_a(p["a"][0], {"x_a": jnp.asarray(te["x_a"][:, :4])})
            z2 = forward_a(p["a"][1], {"x_a": jnp.asarray(te["x_a"][:, 4:])})
            z_b = JT._tower(p["b"]["tower"], jnp.asarray(te["x_b"]))
            logit = JT._mlp(p["b"]["top"],
                            jnp.concatenate([z1, z2, z_b], axis=-1))[:, 0]
            history.append((i + 1, float(m["loss"]),
                            JT.auc(np.asarray(logit), te["y"])))
    counters = ([int(s) for s in state["steps"]["a"]],
                int(state["steps"]["b"]), int(state["comm_rounds"]))
    return history, counters, local, \
        transport.round_bytes([(256, cfg.z_dim)] * 2), init


def test_multiparty_matches_the_reference_engine(calls):
    mp = twin("multiparty_vfl")
    history, counters, local, zb, init = _jax_multiparty(MP_ROUNDS, 5)
    params = mp.init_params("cpu")
    for module, tree in zip(params["a"] + [params["b"]],
                            init["a"] + [init["b"]]):
        load_tree(module, tree)
    got = mp.run("cpu", rounds=MP_ROUNDS, eval_every=5, params=params,
                 uniforms=jax_uniforms, say=lambda s: None)
    assert (got["steps_a"], got["steps_b"], got["comm_rounds"]) == counters
    assert got["local_steps"] == local and got["round_bytes"] == zb
    loss_dev = auc_dev = 0.0
    for (r, loss, a), (jr, jloss, ja) in zip(got["history"], history,
                                             strict=True):
        assert r == jr
        loss_dev = max(loss_dev, abs(loss - jloss) / abs(jloss))
        auc_dev = max(auc_dev, abs(a - ja))
    print(f"multiparty: loss rel dev {loss_dev:.3g} (limit {LOSS_RTOL}), "
          f"AUC dev {auc_dev:.3g} (limit {AUC_ATOL})")
    assert loss_dev <= LOSS_RTOL and auc_dev <= AUC_ATOL
    assert dict(calls) == _chip_smoke()._multiparty_launches(
        MP_ROUNDS, 3, mp.K, 1 + mp.K)


# --------------------------------------------------------------------------
# llm_vfl_training
# --------------------------------------------------------------------------
def _reference_script(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], ["--reduced"]], ids=["full",
                                                           "reduced"])
def test_llm_budget_lines_and_argv_are_the_references(argv, monkeypatch,
                                                      capsys):
    """The reference script prints its budget blocks and hands its argv
    to the training CLI (captured here, not run): the twin's blocks and
    argv (less ``--device``) are the same."""
    from repro.launch import train as jtrain
    seen = []
    monkeypatch.setattr(jtrain, "main", seen.append)
    monkeypatch.setattr(sys, "argv", ["llm_vfl_training.py"] + argv)
    _reference_script("llm_vfl_training").main()
    want = capsys.readouterr().out.rstrip("\n")
    llm = twin("llm_vfl_training")
    args = llm.build_parser().parse_args(argv + ["--device", "cpu"])
    lines, _ = llm.budget_lines(args)
    assert "\n".join(lines) == want
    assert len(lines) == (1 if argv else 3)
    assert llm.train_argv(args) == seen[0] + ["--device", "cpu"]


def test_llm_reduced_run_on_the_cpu(calls):
    """Two reduced rounds at the twin's int4 ring and int8 state: finite
    losses, the reference's wire bytes, and the derived launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import llm_params
    llm = twin("llm_vfl_training")
    rounds = 2
    out = llm.main(["--reduced", "--device", "cpu", "--rounds",
                    str(rounds)])
    tr = out["train"]
    assert len(tr["losses"]) == rounds
    assert all(math.isfinite(x) for x in tr["losses"])
    cfg = get_config("smollm-360m").reduced()
    tp = jengine.make_transport(JCELU(R=3, W=3, cache_dtype="int4"))
    assert tr["comm_bytes"] == rounds * tp.round_bytes(
        [(4, 32, cfg.d_model)])
    smoke = _chip_smoke()
    n = smoke._adagrad_launches([len(list(p.parameters())) for p in
                                 llm_params(cfg, 0, "cpu").values()])
    assert dict(calls) == smoke._llm_example_launches(3, rounds, n)


# --------------------------------------------------------------------------
# serve_split_model
# --------------------------------------------------------------------------
def test_serve_wire_bytes_are_the_reference_engines(capsys):
    """The engine run's wire line (bytes up and down, per token and per
    decode uplink row) and its request / token counts equal the reference
    serving CLI's at the same flags; the cross-attention run generates
    its 8 tokens."""
    from repro.launch import serve as jserve
    sv = twin("serve_split_model")
    out = sv.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    jserve.main(sv.ENGINE_ARGV)
    want = capsys.readouterr().out.splitlines()

    def line(lines, start):
        (hit,) = [ln for ln in lines if ln.startswith(start)]
        return hit
    assert line(got, "wire:") == line(want, "wire:")
    assert line(got, "12 requests,").split(" in ")[0] == \
        line(want, "12 requests,").split(" in ")[0]
    comps, stats = out["engine"]
    assert stats["n_requests"] == 12 and len(comps) == 12
    toks, _ = out["naive"]
    assert tuple(toks.shape) == (1, 8)


# --------------------------------------------------------------------------
# pod_protocol_demo
# --------------------------------------------------------------------------
def test_pod_twin_matches_the_reference_pod_round(background):
    pod = twin("pod_protocol_demo")
    init = jax.tree_util.tree_map(np.asarray, jstacked_wdl_init(
        jax.random.PRNGKey(0), 8, 64, 16, 16, 32))
    got = pod.run("cpu", params=init, say=lambda s: None)
    proc, path = background["pod"]
    stdout, stderr = proc.communicate(timeout=600)
    assert "JAX_POD_OK" in stdout, stderr[-3000:]
    with np.load(path) as z:
        J = {k: z[k] for k in z.files}
    # the twin's batches are the reference script's
    for (x, y), jx, jy in zip(pod.demo_batches(), J["x"], J["y"],
                              strict=True):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    worst = 0.0
    for p in (0, 1):
        a = np.asarray(got["pods"][p][0]["losses"], np.float64)
        b = J["losses"][:, p].astype(np.float64)
        worst = max(worst, float(np.max(np.abs(a - b)
                                        / (POD_ATOL + POD_RTOL * np.abs(b)))))
    print(f"pod: largest loss deviation {worst:.3g} of the limit")
    assert worst <= 1.0
    assert got["losses"] == got["pods"][1][0]["losses"]
    for R in (0, 5):
        cp, ups = got["bytes"][R]
        assert cp == int(J[f"cp{R}"]) == 2 * 4096 * 256 * 4 and ups == 1 + R


# --------------------------------------------------------------------------
# multipod_dryrun
# --------------------------------------------------------------------------
def test_multipod_twin_prints_the_dry_run_fields(background):
    out = background["dryrun"].result(timeout=600)
    r = out["result"]
    assert out["returncode"] == 0 and r["ok"] is True
    assert (r["arch"], r["shape"], r["mesh"]) == (*DRYRUN, "2x16x16")
    lines = out["lines"]
    assert lines[0] == f"arch={DRYRUN[0]} shape={DRYRUN[1]} " \
        f"mesh=2x16x16 ok=True"
    assert lines[1] == "  roofline: " + ", ".join(
        f"{k}={v:.4f}s" for k, v in r["roofline"].items())
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert lines[2] == f"  dominant: {r['dominant']}  " \
        f"peak={r['memory']['peak_bytes'] / 1e9:.1f} GB/device"
    assert r["dominant"] == max(r["roofline"], key=r["roofline"].get)
    assert lines[3] == f"  collectives: {r['collectives']}"
    assert len(lines) == 4
