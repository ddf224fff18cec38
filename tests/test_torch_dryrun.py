"""The port's dry-run (``repro_torch.launch.dryrun``) and the dry-run half
of ``launch/steps.py`` against the reference's, on the CPU.

  * ``configs.SHAPES`` and ``arch_for_shape`` for every (arch, shape),
    field by field;
  * ``abstract_params`` leaf by leaf (shape and dtype) against
    ``jax.eval_shape`` of the reference's ``init_all``, in its leaf order;
  * ``input_specs`` for every (arch, shape);
  * ``model_flops`` equal to the reference's for every (arch, shape);
  * on a (2, 2) fake process group: one device's operations of a
    batch-sharded, column-sharded product a quarter of the product's, and
    the collective bytes of a two-layer toy against a hand count;
  * the accountant's K9-LSE / K10 costs the kernels' ``flops`` /
    ``nbytes``, and a model step past 2,048 tokens costed through them;
  * the fake trace's peak memory equal to ``MemTracker``'s peak of the
    same step run for real on the CPU;
  * one production-mesh line of the CLI.

A process holds one process group, so the fake-group cases run in
subprocesses; so does the reference's ``model_flops``, whose module sets
``XLA_FLAGS`` to 512 devices when it is imported.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.launch import steps as JS
from repro.models import vfl as JV
from repro_torch import configs as TC
from repro_torch.bridge import reference_parameters
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as TS
from repro_torch.sharding.rules import walk

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PAIRS = [(a, s) for a in TC.ARCH_IDS for s in TC.SHAPES]
# the reference's keys of a dry-run line
LINE_KEYS = {"arch", "shape", "mesh", "chips", "fsdp", "moe_sharding", "tag",
             "pure_dp", "microbatches", "ok", "compile_s",
             "hlo_flops_per_dev", "hlo_bytes_per_dev",
             "collective_bytes_per_dev", "collectives", "model_flops_global",
             "model_flops_per_dev", "useful_flops_frac", "roofline",
             "dominant", "memory"}
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}


def _run(code: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _fields(cfg):
    """A config's fields but its ``source``: the port cites smollm-360m's
    own checkpoint (SmolLM-360M) where the reference names SmolLM-135M
    beside the same 360M widths."""
    d = dataclasses.asdict(cfg)
    d.pop("source", None)
    return d


# --------------------------------------------------------------------------
def test_shapes_match_reference():
    assert list(TC.SHAPES) == list(JC.SHAPES)
    for name, s in TC.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JC.SHAPES[name])
    assert TC.LONG_CONTEXT_WINDOW == JC.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_arch_for_shape_matches_reference(arch, shape):
    got, want = TC.arch_for_shape(arch, shape), JC.arch_for_shape(arch, shape)
    assert _fields(got) == _fields(want)
    if arch != "smollm-360m":
        assert got.source == want.source


@functools.lru_cache(maxsize=None)
def _port_leaves(arch):
    p = TS.abstract_params(TC.get_config(arch))
    return [(tuple(t.shape), t.dtype, t.device.type)
            for t in reference_parameters(p)]


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_abstract_params_match_reference(arch):
    want = jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: JV.init_all(jax.random.PRNGKey(0), JC.get_config(arch))))
    got = _port_leaves(arch)
    assert len(got) == len(want)
    for (shape, dtype, dev), w in zip(got, want):
        assert dev == "meta"
        assert shape == tuple(w.shape) and dtype == DTYPES[w.dtype]


def _flat(tree):
    """(path, shape, dtype) in the reference's leaf order."""
    return [(p, tuple(t.shape), t.dtype) for p, t in walk(tree)]


def _jflat(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        out.append((keys, tuple(leaf.shape), DTYPES[jnp.dtype(leaf.dtype)]))
    return out


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_reference(arch, shape):
    """Every input of the shape's step, by the reference's keys.  Two
    differences are the port's by design: token ids are int64 (PyTorch's
    embedding lookup), and a KV cache's ``slot_pos`` holds one row a
    batch entry (the serving lanes decode at their own positions)."""
    cfg_t, cfg_j = TC.arch_for_shape(arch, shape), JC.arch_for_shape(arch,
                                                                     shape)
    shp = TC.SHAPES[shape]
    got = TS.input_specs(cfg_t, shp)
    want = JS.input_specs(cfg_j, JC.SHAPES[shape])
    assert list(got) == list(want)
    for key in got:
        g, w = _flat(got[key]), _jflat(want[key])
        assert [p for p, _, _ in g] == [p for p, _, _ in w], key
        for (path, gs, gd), (_, ws, wd) in zip(g, w):
            assert all(t.device.type == "meta"
                       for _, t in walk(got[key]))
            if key in ("batch", "step_batch") and wd == torch.int32:
                assert (gs, gd) == (ws, torch.int64), (key, path)
            elif path and path[-1] == "slot_pos":
                # (L, cap) in the reference, (L, B, cap) here
                assert (gs[:-2], gs[-2], gs[-1], gd) == (
                    ws[:-1], shp.global_batch, ws[-1], wd), (key, path)
            else:
                assert (gs, gd) == (ws, wd), (key, path)


@pytest.fixture(scope="module")
def reference_model_flops():
    code = (
        "import functools, json\n"
        "from repro.launch import dryrun as D\n"
        "from repro.configs import ARCH_IDS, SHAPES, arch_for_shape\n"
        "D.abstract_params = functools.lru_cache(maxsize=None)"
        "(D.abstract_params)\n"
        "print(json.dumps({f'{a}|{s}': D.model_flops(arch_for_shape(a, s), "
        "SHAPES[s]) for a in ARCH_IDS for s in SHAPES}))\n")
    return json.loads(_run(code).strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_match_reference(arch, shape, reference_model_flops):
    got = D.model_flops(TC.arch_for_shape(arch, shape), TC.SHAPES[shape])
    assert got == reference_model_flops[f"{arch}|{shape}"]


# --------------------------------------------------------------------------
FAKE_GROUP = r"""
import json, torch
torch.set_num_threads(1)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
D.fake_world(4)
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
B, K, N = 64, 128, 256
def place(shape, pl):
    return distribute_tensor(torch.empty(shape), mesh, pl, src_data_rank=None)
out = {}
with FakeTensorMode():
    x = place((B, K), [Shard(0), Replicate()])
    w = place((K, N), [Replicate(), Shard(1)])
    out["matmul"] = D.trace_step(lambda a, b: a @ b, x, w)["flops"]
    w2 = place((N, K), [Replicate(), Shard(0)])
    L.set_batch_axes(("data",), mesh=mesh)
    def toy(a, p, q):
        y = L._mm(L._mm(a, p), q)
        y = y.redistribute(mesh, [Shard(0), Replicate()])
        return y.redistribute(mesh, [Replicate(), Replicate()])
    t = D.trace_step(toy, x, w, w2)
    L.set_batch_axes(None)
    out["toy"] = t["collectives"]
    out["toy_flops"] = t["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_group():
    return json.loads(_run(FAKE_GROUP).strip().splitlines()[-1])


def test_per_device_flops_are_the_local_shards(fake_group):
    """A (64, 128) @ (128, 256) product, its batch over ``data`` and its
    weight's columns over ``model``: one device multiplies a quarter."""
    B, K, N = 64, 128, 256
    assert fake_group["matmul"] == 2 * B * K * N // 4


def test_collective_bytes_of_a_two_layer_toy(fake_group):
    """x (64, 128) over ``data`` through a column-split (128, 256) and a
    row-split (256, 128) weight: no collective in the products (Megatron's
    pair), then the partial sum reduced over ``model`` (an all-reduce of
    the device's (32, 128) fp32 rows) and the rows gathered over ``data``
    (an all-gather whose operand is those rows)."""
    rows = 32 * 128 * 4
    assert fake_group["toy"] == {"all-gather": rows, "all-reduce": rows,
                                 "reduce-scatter": 0, "all-to-all": 0,
                                 "collective-permute": 0}
    assert D.collective_bytes({"collectives": fake_group["toy"]}) \
        == fake_group["toy"]
    assert fake_group["toy_flops"] == 2 * (2 * 32 * 128 * 128)


# --------------------------------------------------------------------------
def test_accountant_costs_are_the_kernels():
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, S, H, hd = 2, 3072, 4, 32
    with FakeTensorMode():
        q, k, v = (torch.empty(B, S, H, hd, requires_grad=True)
                   for _ in range(3))
        with _cuda.accounting() as acc:
            o = fab.FlashAttentionFn.apply(q, k, v, True, 0)
            o.sum().backward()
    got = acc.kernels
    assert got["flash_attention_fwd_lse"] == [
        1, fa.flops(B, S, H, hd, True, 0), fa.nbytes(q, with_lse=True)]
    # each K10 kernel as its bound counts it: the dkv kernel computes
    # four products and writes dk and dv, the dq kernel three and dq
    n, rows = q.numel() * q.element_size(), 2 * 4 * B * H * S
    assert got["flash_attention_bwd_dkv"] == [
        1, fab.flops(B, S, H, hd, True, 0, products=4), 6 * n + rows]
    assert got["flash_attention_bwd_dq"] == [
        1, fab.flops(B, S, H, hd, True, 0, products=3), 5 * n + rows]


def _train(cfg, seq_len, batch_size=2, use_pallas=True):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import vfl
    from repro_torch.optim import adagrad
    shape = ShapeConfig("t", seq_len=seq_len, global_batch=batch_size,
                        kind="train")
    opt = adagrad(0.01, use_pallas=use_pallas)
    params = vfl.PartyParams(vfl.init_all(0, cfg))
    state = opt.init(reference_parameters(params))
    return TS.make_train_step(cfg, opt), params, state, shape


def test_long_attention_is_costed_as_the_kernels():
    """A reduced model past 2,048 tokens: the trace runs K9-LSE (twice a
    layer, remat) and K10, and its operations include theirs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = TC.get_config("smollm-360m").reduced()
    with FakeTensorMode():
        step, params, state, shape = _train(cfg, 3072)
        batch = TS.input_specs(cfg, shape, device="cpu")["batch"]
        t = D.trace_step(step, params, state, batch)
    layers = 3       # Party A's one, Party B's bottom and top
    k = t["kernels"]
    assert k["flash_attention_fwd_lse"][0] == 2 * layers
    assert k["flash_attention_bwd_dkv"][0] == k["flash_attention_bwd_dq"][0] \
        == layers
    assert k["fused_adagrad"][0] == 1
    fwd = fa.flops(2, 3072, 4, 32, True, 0)
    assert k["flash_attention_fwd_lse"][1] == 2 * layers * fwd
    assert t["flops"] > sum(r[1] for r in k.values())


def test_fake_peak_equals_real_peak():
    """The same reduced train step (64 tokens, the dense attention path,
    AdaGrad's plain route: no kernel, so the CPU runs what the trace
    sees), run for real on the CPU under ``MemTracker`` and traced on
    fake tensors: the same peak bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = TC.get_config("smollm-360m").reduced()
    step, params, state, shape = _train(cfg, 64, use_pallas=False)
    batch = TS.concrete_batch(cfg, shape, seed=0)
    mt = MemTracker()
    mt.track_external(params, *state["accum"], *batch.values())
    with mt:
        step(params, state, batch)
    real = mt.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
    with FakeTensorMode():
        fstep, fparams, fstate, _ = _train(cfg, 64, use_pallas=False)
        fbatch = TS.input_specs(cfg, shape, device="cpu")["batch"]
        fake = D.trace_step(fstep, fparams, fstate, fbatch)["peak_bytes"]
    print(f"peak: {fake:,} B traced on fake tensors, {real:,} B measured")
    assert fake == real


# --------------------------------------------------------------------------
def test_cli_production_mesh_line():
    out = _run("from repro_torch.launch.dryrun import main; import sys; "
               "sys.exit(main(['--arch', 'smollm-360m', '--shape', "
               "'train_4k']))", timeout=600)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    r = lines[0]
    assert r["ok"] and LINE_KEYS <= set(r)
    assert (r["arch"], r["shape"], r["mesh"], r["chips"]) == (
        "smollm-360m", "train_4k", "16x16", 256)
    assert list(r["collectives"]) == list(D.COLLECTIVE_OPS)
    assert all(math.isfinite(v) and v > 0 for v in r["roofline"].values())
    assert r["dominant"] in r["roofline"]
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "peak_bytes"}
    assert 0 < r["memory"]["peak_bytes"] < 80e9
    assert r["model_flops_global"] == D.model_flops(
        TC.arch_for_shape("smollm-360m", "train_4k"), TC.SHAPES["train_4k"])
    # 32 layers: K9-LSE twice a layer (remat), K10 once
    assert r["kernels"]["flash_attention_fwd_lse"][0] == 64
    assert r["kernels"]["flash_attention_bwd_dkv"][0] == 32
