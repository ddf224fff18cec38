"""The port's DLRMs and optimizers against the reference.

Models: WDL and DSSM forward (Z_A), per-instance loss, predict, and the
gradients of the mean loss (Party B's parameters and Z_A; Party A's
parameters through the cotangent), from the reference's parameters
bridged into the port.  Optimizers: AdaGrad, SGD (with and without
momentum), Adam, AdaGrad's kernel route (``use_pallas``) and its bf16 and
int8 states, and SM3, over three steps on the same gradients (the int8
state on the reference's rounding uniforms).  Tolerance:
float32 results of the same ops in another summation order, ``RTOL`` /
``ATOL``; DSSM normalises each Z by its norm (~1e-2 at init), which
amplifies rounding in its gradients tenfold, hence ``DSSM_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.data.synthetic import TabularSpec, aligned_batches, make_tabular
from repro.models.tabular import DLRMConfig as JCfg
from repro.models.tabular import make_dlrm as jmake
from repro_torch import optim as toptim
from repro_torch.bridge import flatten_tree, load_tree, to_tree
from repro_torch.data import to_device
from repro_torch.models.tabular import DLRMConfig, make_dlrm

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1e-6
DSSM_TOL = (1e-4, 1e-5)


def _close(got, want, what, tol=(RTOL, ATOL)):
    got, want = np.asarray(got), np.asarray(want)
    dev = np.abs(got - want).max(initial=0.0)
    print(f"{what}: max |dev| {dev:.3g}")
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                               err_msg=what)


def _trees_close(got, want, what, tol=(RTOL, ATOL)):
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        _close(g[k], w[k], f"{what}:{k}", tol)


def _setup(model):
    cfg = DLRMConfig(model, 4, 3, vocab=32, embed_dim=4, z_dim=8,
                     hidden=(16, 8))
    jcfg = JCfg(model, 4, 3, vocab=32, embed_dim=4, z_dim=8, hidden=(16, 8))
    jinit, jtask, jpred = jmake(jcfg)
    jp = jinit(jax.random.PRNGKey(3), jcfg)
    init, task, pred = make_dlrm(cfg)
    tp = init(0, cfg, "cpu")
    load_tree(tp["a"], jax.tree_util.tree_map(np.asarray, jp["a"]))
    load_tree(tp["b"], jax.tree_util.tree_map(np.asarray, jp["b"]))
    data = make_tabular(TabularSpec("t", 4, 3, vocab=32, n_train=256,
                                    n_test=64), seed=1)
    _, ba, bb = next(aligned_batches(data["train"], 64, seed=1))
    return (jcfg, jtask, jpred, jp), (cfg, task, pred, tp), ba, bb


@pytest.mark.parametrize("model", ["wdl", "dssm"])
def test_port_init_has_reference_layout(model):
    """The port's own init gives the reference's parameter paths and
    shapes."""
    (jcfg, _, _, jp), (cfg, _, _, tp), _, _ = _setup(model)
    for party in ("a", "b"):
        want = {k: v.shape for k, v in flatten_tree(
            jax.tree_util.tree_map(np.asarray, jp[party])).items()}
        fresh = make_dlrm(cfg)[0](7, cfg, "cpu")[party]
        got = {k: tuple(v.shape) for k, v in fresh.state_dict().items()}
        assert got == want


@pytest.mark.parametrize("model", ["wdl", "dssm"])
def test_forward_loss_predict_grads_match_reference(model):
    (jcfg, jtask, jpred, jp), (cfg, task, pred, tp), ba, bb = _setup(model)
    tol = DSSM_TOL if model == "dssm" else (RTOL, ATOL)
    jba = {k: jnp.asarray(v) for k, v in ba.items()}
    jbb = {k: jnp.asarray(v) for k, v in bb.items()}
    tba, tbb = to_device(ba, "cpu"), to_device(bb, "cpu")

    # forward and per-instance loss
    jz, jvjp = jax.vjp(lambda p: jtask.forward_a(p, jba), jp["a"])
    tz = task.forward_a(tp["a"], tba)
    _close(tz.detach().numpy(), jz, "z", tol)
    jli, _ = jtask.loss_b(jp["b"], jz, jbb)
    zl = tz.detach().requires_grad_(True)
    tli, _ = task.loss_b(tp["b"], zl, tbb)
    _close(tli.detach().numpy(), jli, "per-instance loss", tol)

    # grads of the mean loss wrt Party B's params and Z_A
    (jgb, jdz) = jax.grad(
        lambda p, z: jnp.mean(jtask.loss_b(p, z, jbb)[0]),
        argnums=(0, 1))(jp["b"], jz)
    names = [n for n, _ in tp["b"].named_parameters()]
    grads = torch.autograd.grad(tli.mean(),
                                list(tp["b"].parameters()) + [zl])
    _close(grads[-1].numpy(), jdz, "dZ", tol)
    gb = {n: g.numpy() for n, g in zip(names, grads[:-1])}
    _trees_close(gb, jax.tree_util.tree_map(np.asarray, jgb), "grad b", tol)

    # Party A's backward with the cotangent
    (jga,) = jvjp(jdz)
    ga = torch.autograd.grad(tz, list(tp["a"].parameters()),
                             grad_outputs=grads[-1])
    names_a = [n for n, _ in tp["a"].named_parameters()]
    _trees_close({n: g.numpy() for n, g in zip(names_a, ga)},
                 jax.tree_util.tree_map(np.asarray, jga), "grad a", tol)

    # predict
    tpred = pred(tp, cfg, tba, tbb)
    jp_logits = jpred(jp, jcfg, jba, jbb)
    _close(tpred.numpy(), jp_logits, "predict", tol)


def test_bridge_round_trip():
    (_, _, _, jp), (_, _, _, tp), _, _ = _setup("wdl")
    want = jax.tree_util.tree_map(np.asarray, jp["b"])
    got = to_tree(tp["b"])
    assert flatten_tree(got).keys() == flatten_tree(want).keys()
    for k, v in flatten_tree(want).items():
        np.testing.assert_array_equal(flatten_tree(got)[k], v)


def _opt_cases():
    return [("adagrad", {}), ("sgd", {}), ("sgd", {"momentum": 0.9}),
            ("adam", {}), ("adagrad", {"use_pallas": True}),
            ("adagrad", {"use_pallas": True, "state_dtype": "bfloat16"}),
            ("adagrad", {"use_pallas": True, "state_dtype": "int8"}),
            ("adagrad", {"state_dtype": "int8"}), ("sm3", {})]


@pytest.mark.parametrize("name,kw", _opt_cases())
def test_optimizer_updates_match_reference(name, kw):
    from test_torch_compression import jax_uniforms
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (7,), ()]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jopt = joptim.make_optimizer(name, 0.05, **kw)
    if kw.get("state_dtype") == "int8":
        kw = {**kw, "uniforms": jax_uniforms}
    topt = toptim.make_optimizer(name, 0.05, **kw)
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    jstate = jopt.init(jparams)
    tstate = topt.init(tparams)
    for step in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jupd, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate,
                                   jparams)
        jparams = joptim.apply_updates(jparams, jupd)
        tupd, tstate = topt.update([torch.from_numpy(g) for g in grads],
                                   tstate, tparams)
        toptim.apply_updates(tparams, tupd)
        for i in range(len(shapes)):
            _close(tupd[i].numpy(), jupd[i], f"{name} step {step} update {i}")
            _close(tparams[i].numpy(), jparams[i],
                   f"{name} step {step} param {i}")
