"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's, leaf by leaf, with no devices.

The reference side takes ``jax.eval_shape`` parameters and a
``jax.sharding.AbstractMesh``; the port side takes parameters drawn on
the meta device (``launch/budget.py``) and the mesh's axis sizes.  Every
``configs.ARCH_IDS`` entry at full size, on the single-pod (16, 16), the
multi-pod (2, 16, 16) and a (2, 2) mesh, with ``moe_sharding`` "tp" and
"ep", ``fsdp_axis`` on and off: each leaf's spec equals the reference's
(its PartitionSpec as a tuple).  Also the specs of worksets over fp32,
int8 and int4 rings, of AdaGrad's fp32 / int8 (``QuantAccum``) state and
SM3's, of decode caches, and ``batch_pspec`` at decode's tiny batches.
These mirror ``tests/test_system.py::test_sharding_rules_divisibility``,
``tests/test_quantized_optim.py::test_opt_state_pspecs_quantized_layouts``
and ``tests/test_workset_cache.py::test_workset_pspecs_shard_batch_never_ring``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.core import workset as JWS
from repro.models import vfl as JV
from repro.optim import make_optimizer as jmake_optimizer
from repro.sharding import rules as JR
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import workset as WS
from repro_torch.launch.budget import _param_shapes
from repro_torch.models import vfl as TV
from repro_torch.optim import make_optimizer
from repro_torch.sharding import rules as R

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
OPTIONS = [("tp", None), ("ep", None), ("tp", "data"), ("ep", "data")]


def _jmesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _sizes(name):
    shape, axes = MESHES[name]
    return dict(zip(axes, shape))


def _jflat(spec_tree, skip=()):
    """Reference specs as tuples, in flattening order (``skip``: leaf
    names the port keeps as host ints)."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return [tuple(s) for path, s in flat
            if not (path and getattr(path[-1], "key", None) in skip)]


def _paths_equal(jtree, ttree):
    jp = [tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
          for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tp = [p for p, _ in R.walk(ttree)]
    assert jp == tp


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(reference abstract parameters, the port's meta parameters)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jp = jax.eval_shape(lambda: JV.init_all(jax.random.PRNGKey(0), jcfg))
    tp = _param_shapes(cfg)
    _paths_equal(jp, tp)
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                              R.walk(tp), strict=True):
        assert tuple(a.shape) == tuple(b.shape)
    return jp, tp


def test_arch_ids_are_the_reference_s():
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS)


@pytest.mark.parametrize("opt", OPTIONS, ids=[f"{m}-fsdp_{f}"
                                              for m, f in OPTIONS])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_pspecs_match_reference(arch, mesh, opt):
    moe, fsdp = opt
    jp, tp = _params(arch)
    want = _jflat(JR.params_pspecs(jp, _jmesh(mesh), moe_sharding=moe,
                                   fsdp_axis=fsdp))
    got = R.flat_specs(R.params_pspecs(tp, _sizes(mesh), moe_sharding=moe,
                                       fsdp_axis=fsdp))
    assert len(got) == len(want)
    bad = [(p, g, w) for (p, _), g, w in zip(R.walk(tp), got, want)
           if g != w]
    assert not bad, bad[:5]
    # every sharded dim divides its leaf
    sizes = _sizes(mesh)
    for (_, leaf), spec in zip(R.walk(tp), got):
        for d, ax in enumerate(spec):
            if ax is not None:
                assert leaf.shape[d] % R._axis_size(sizes, ax) == 0


def test_flat_dotted_names_take_the_tree_s_specs():
    """A module's ``named_parameters`` (dotted names, list indices as
    digits) get the same specs as the nested tree."""
    _, tp = _params("smollm-360m")
    flat = {".".join(p): t for p, t in R.walk(tp)}
    sizes = _sizes("16x16")
    assert R.flat_specs(R.params_pspecs(flat, sizes, fsdp_axis="data")) \
        == R.flat_specs(R.params_pspecs(tp, sizes, fsdp_axis="data"))


@pytest.mark.parametrize("sizes", [{"data": 2}, {"data": 4}, {"data": 5},
                                   {"data": 16, "model": 16}])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8",
                                         "int4"])
def test_workset_pspecs_match_reference(cache_dtype, sizes):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((8, 16)).astype(np.float32)
    x = rng.integers(0, 9, (8, 3)).astype(np.int32)
    jws = JWS.workset_init(5, {"z": jnp.asarray(z), "dz": jnp.asarray(z),
                               "batch": jnp.asarray(x)},
                           cache_dtype=cache_dtype)
    tws = WS.workset_init(5, {"z": torch.from_numpy(z),
                              "dz": torch.from_numpy(z),
                              "batch": torch.from_numpy(x)},
                          cache_dtype=cache_dtype)
    mesh = type("M", (), {"shape": sizes})()
    want = _jflat(JR.workset_pspecs(jws, mesh))
    got = R.flat_specs(R.workset_pspecs(tws, sizes))
    assert got == want
    # never the ring axis
    assert all(not s or s[0] is None for s in got)


@pytest.mark.parametrize("sizes", [{"data": 2}, {"data": 8}, {"data": 3}])
@pytest.mark.parametrize("name,kw", [("adagrad", {}),
                                     ("adagrad", {"state_dtype": "int8"}),
                                     ("adagrad",
                                      {"state_dtype": "bfloat16"}),
                                     ("sm3", {})])
def test_opt_state_pspecs_match_reference(name, kw, sizes):
    rng = np.random.default_rng(1)
    shapes = {"b": (16,), "w": (16, 24), "v": (40, 3, 5)}
    arrs = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    jst = jax.eval_shape(jmake_optimizer(name, 0.01, **kw).init,
                         {k: jnp.asarray(v) for k, v in arrs.items()})
    # the port lists a party's tensors in the reference's leaf order
    tst = make_optimizer(name, 0.01, **kw).init(
        [torch.from_numpy(arrs[k]) for k in sorted(arrs)])
    mesh = type("M", (), {"shape": sizes})()
    # the int8 state's update counter is a host int in the port
    want = _jflat(JR.opt_state_pspecs(jst, mesh), skip=("t",))
    got = R.flat_specs(R.opt_state_pspecs(tst, sizes))
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch,seq", [(1, 64), (2, 32), (32, 16)])
@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b",
                                  "xlstm-125m", "granite-moe-3b-a800m"])
def test_cache_pspecs_match_reference(arch, batch, seq, mesh):
    """The rule on the reference's cache shapes (the port's serving cache
    keeps a ``slot_pos`` row a lane, so its own tree differs there), and
    the port's own cache: its k / v leaves get the same specs."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jc = jax.eval_shape(lambda: JV.make_serve_cache(jcfg, batch, seq))
    tc = jax.tree_util.tree_map(
        lambda a: torch.empty(a.shape, device="meta"), jc)
    want = _jflat(JR.cache_pspecs(jc, _jmesh(mesh)))
    got = R.flat_specs(R.cache_pspecs(tc, _sizes(mesh)))
    assert got == want
    own = TV.make_serve_cache(cfg, batch, seq, device="meta")
    kv = lambda tree: [s for (p, _), s in zip(  # noqa: E731
        R.walk(tree), R.flat_specs(R.cache_pspecs(tree, _sizes(mesh))))
        if p[-1] in ("k", "v")]
    assert kv(own) == kv(tc)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", [(1,), (1, 1), (1, 7), (1, 4096),
                                   (2, 1), (2, 2048), (4, 1, 960),
                                   (16, 8), (32, 64), (3, 5, 7), ()])
def test_batch_pspec_matches_reference(shape, mesh):
    for axes in (("data",), ("pod", "data")):
        if axes[0] not in MESHES[mesh][1]:
            continue
        want = tuple(JR.batch_pspec(shape, _jmesh(mesh), data_axes=axes))
        assert R.batch_pspec(shape, _sizes(mesh), data_axes=axes) == want


def test_placements_follow_the_mesh_order():
    """A tuple of axes on one dim shards it over each, in the mesh's
    order; every other mesh dim replicates."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = type("M", (), {"mesh_dim_names": ("pod", "data", "model")})()
    assert R.placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert R.placements(mesh, ()) == (Replicate(),) * 3
    assert R.placements(mesh, (None, "data")) == \
        (Replicate(), Shard(1), Replicate())


def test_activation_hints_are_no_ops_outside_a_mesh():
    """``shard_batch_dim`` / ``shard_logits`` leave a tensor as it is when
    no mesh is installed, or when it is not a DTensor; the mesh-aware
    embedding, label read and logsumexp are the plain ops on a plain
    tensor."""
    from repro_torch.models import layers as L
    x = torch.randn(4, 8, 16)
    assert L.shard_batch_dim(x) is x and L.shard_logits(x) is x
    L.set_batch_axes(("data",), vocab_axis="model")
    try:
        assert L._MESH is None           # no mesh given: still no-ops
        assert L.shard_batch_dim(x) is x and L.shard_logits(x) is x
    finally:
        L.set_batch_axes(None)
    assert L._BATCH_AXES is None
    labels = torch.randint(0, 16, (4, 8))
    assert torch.equal(L.take_label(x, labels),
                       torch.gather(x, -1, labels[..., None])[..., 0])
    assert torch.equal(L.logsumexp(x), torch.logsumexp(x, dim=-1))
    table = torch.randn(16, 5)
    assert torch.equal(L.embed(table, labels), table[labels])
