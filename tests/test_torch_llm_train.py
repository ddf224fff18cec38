"""The port's LLM training path against the reference.

At reduced smollm-360m geometry (2 layers split 1 / 1 / 1, d 128, 4
query and 2 KV heads of dim 32, vocabulary 512) on parameters drawn in
JAX and brought across bitwise, the same batches go through
``repro.models.vfl`` / ``repro.core.engine`` and their counterparts in
``repro_torch``.  Both sides compute in bf16 with fp32 norms, softmax and
loss, but their bf16 matrix products sum in other orders, so a product
may round to the neighbouring bf16 value; past 2,048 tokens the
reference differentiates its blockwise path (bf16 scores) where the port
runs K9-LSE and K10 (their plain versions here; fp32 scores).
Tolerances, each a few times the largest deviation measured here:

  * a gradient leaf (bf16): ``GRAD_ULPS`` bf16 ulps of the leaf's largest
    magnitude (measured: 1.99);
  * the per-instance loss: ``LOSS_ATOL`` (measured: 0.0017 at S = 32,
    1.3e-4 at S = 3,072);
  * the ad-hoc ∇Z (fp32): ``DZ_ULPS`` bf16 ulps of its largest magnitude
    (measured: 0.30 at S = 32, 0.45 at S = 3,072);
  * the CELU round's losses: ``ROUND_LOSS_RTOL`` relative over the first
    three rounds (measured: 1.1e-3; AdaGrad's first steps move each
    coordinate by ±lr whatever its gradient's size, so the runs part
    after a few rounds, ROADMAP.md §3).
"""
import dataclasses
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import CELUConfig as JCELUConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import engine as JE
from repro.launch import budget as JBudget
from repro.launch import steps as JSteps
from repro.launch import train as JTrain
from repro.models import vfl as JV
from repro.optim import apply_updates as japply_updates
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.bridge import reference_parameters, tree_to_torch
from repro_torch.configs import get_config
from repro_torch.configs.base import CELUConfig, ShapeConfig
from repro_torch.core import engine as TE
from repro_torch.core.uniforms import GeneratorUniforms
from repro_torch.data import synthetic as tsynth
from repro_torch.data import to_device
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfab
from repro_torch.kernels import fused_sample as tfs
from repro_torch.launch import budget as TBudget
from repro_torch.launch import steps as TSteps
from repro_torch.launch import train as TTrain
from repro_torch.models import vfl as TV
from repro_torch.models.initializers import _leaves
from repro_torch.optim import apply_updates, make_optimizer

torch.set_num_threads(1)

JCFG = jget_config("smollm-360m").reduced()
CFG = get_config("smollm-360m").reduced()
LONG_S = 3072                     # past BLOCKWISE_THRESHOLD: K9-LSE / K10
GRAD_ULPS = 4
LOSS_ATOL = 0.01
DZ_ULPS = 2
ROUND_LOSS_RTOL = 4e-3
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def params():
    """(jax tree, {"a", "b"} numpy trees) drawn once in JAX."""
    jp = JV.init_all(jax.random.PRNGKey(0), JCFG)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _party(np_tree):
    return TV.PartyParams(tree_to_torch(np_tree))


def _batch(B, S, seed):
    rng = np.random.default_rng(seed)
    raw = {k: rng.integers(0, 512, (B, S)).astype(np.int32)
           for k in ("tokens", "tokens_a", "labels")}
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v.astype(np.int64)) for k, v in raw.items()})


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _within_ulps(got, want, ulps):
    """-> (max |got - want|, ``ulps`` bf16 ulps of want's largest
    magnitude)."""
    got, want = _np(got), _np(want)
    dev = float(np.abs(got - want).max())
    lim = ulps * BF16_ULP * float(np.abs(want).max())
    return dev, lim


def _assert_leaves(jtree, tgrads, label):
    """Each gradient leaf within GRAD_ULPS bf16 ulps of its largest
    magnitude (reference leaf order on both sides)."""
    jl = jax.tree_util.tree_leaves(jtree)
    assert len(jl) == len(tgrads)
    worst = 0.0
    for i, (a, b) in enumerate(zip(jl, tgrads)):
        assert b.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16, i
        dev, lim = _within_ulps(b, a, GRAD_ULPS)
        assert dev <= lim, (label, i, dev, lim)
        worst = max(worst, dev / lim * GRAD_ULPS)
    print(f"{label}: {len(jl)} leaves, worst |dev| {worst:.3g} bf16 ulps "
          f"of the leaf's largest magnitude (limit {GRAD_ULPS})")


# --------------------------------------------------------------------------
# the objective and both parties' gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("S", [32, LONG_S])
def test_loss_and_gradients_match_reference(params, S, remat):
    """``per_instance_loss`` and the joint loss's gradients of both
    parties against ``jax.value_and_grad`` of the reference's, on the
    dense path (S = 32) and past 2,048 tokens (K9-LSE / K10 against the
    reference's blockwise path)."""
    jp, npp = params
    B = 2 if S <= 2048 else 1
    jb, tb = _batch(B, S, seed=S)

    def jloss(p):
        z = JV.forward_a(p["a"], JCFG, jb, train=True, remat=remat)
        li, aux = JV.per_instance_loss(p["b"], JCFG, z, jb, train=True,
                                       remat=remat)
        return jnp.mean(li) + aux, li
    (jl, jli), jg = jax.value_and_grad(jloss, has_aux=True)(jp)

    pp = TV.PartyParams({"a": tree_to_torch(npp["a"]),
                         "b": tree_to_torch(npp["b"])})
    z = TV.forward_a(pp.a, CFG, tb, train=True, remat=remat)
    li, aux = TV.per_instance_loss(pp.b, CFG, z, tb, train=True, remat=remat)
    grads = torch.autograd.grad(li.mean() + aux, reference_parameters(pp))
    dev = float(np.abs(_np(li) - np.asarray(jli)).max())
    print(f"S={S} remat={remat}: per-instance loss max |dev| {dev:.3g} "
          f"(limit {LOSS_ATOL})")
    assert li.shape == (B,) and li.dtype == torch.float32
    assert dev <= LOSS_ATOL
    _assert_leaves(jg, grads, f"S={S} remat={remat} grads")


def test_joint_loss_matches_per_instance_composition(params):
    _, npp = params
    _, tb = _batch(2, 32, seed=5)
    pp = TV.PartyParams({"a": tree_to_torch(npp["a"]),
                         "b": tree_to_torch(npp["b"])})
    z = TV.forward_a(pp.a, CFG, tb, train=True)
    li, aux = TV.per_instance_loss(pp.b, CFG, z, tb)
    assert torch.equal(TV.joint_loss(pp, CFG, tb), li.mean() + aux)


def test_party_params_paths_are_the_reference_paths(params):
    """``PartyParams``' parameter names are the pytree's dotted paths,
    its reference order is JAX's leaf order, and ``tree()`` gives the
    parameters themselves."""
    jp, npp = params
    pb = _party(npp["b"])
    jpaths = [jax.tree_util.keystr(p, simple=True, separator=".")
              for p, _ in jax.tree_util.tree_leaves_with_path(jp["b"])]
    from repro_torch.bridge import path_key
    names = sorted((n for n, _ in pb.named_parameters()), key=path_key)
    assert names == jpaths
    tree = pb.tree()
    assert tree["top"][0]["b0"]["attn"]["wq"] is \
        dict(pb.named_parameters())["top.0.b0.attn.wq"]
    for a, b in zip(jax.tree_util.tree_leaves(jp["b"]),
                    reference_parameters(pb)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.detach().float().numpy())


# --------------------------------------------------------------------------
# Party B's ad-hoc ∇Z pass at a bf16 cut tensor (fp32 top tower)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("S", [32, LONG_S])
def test_ad_hoc_dz_pass_matches_reference(params, S):
    """The reference casts the cached bf16 Z to fp32 before ``jax.grad``,
    so ``jnp`` promotion runs the whole top tower in fp32 against bf16
    weights (past 2,048 tokens with fp32 q, k, v).  The port's
    ``_ad_hoc_dz`` must do the same."""
    jp, npp = params
    B = 2 if S <= 2048 else 1
    jb, tb = _batch(B, S, seed=S + 1)
    jz = JV.forward_a(jp["a"], JCFG, jb)
    jtask = JTrain.llm_task(JCFG)
    jdz = jax.grad(lambda zl: jnp.mean(jtask.loss_b(jp["b"], zl[0], jb)[0]))(
        [jz.astype(jnp.float32)])[0]
    ttask = TE.lift_two_party(TTrain.llm_task(CFG))
    tz = torch.from_numpy(np.array(jz.astype(jnp.float32))).to(
        torch.bfloat16)
    seen = []
    orig = TV._fuse

    def fuse(x, z_a, params_b):
        out = orig(x, z_a, params_b)
        seen.append((z_a.dtype, out.dtype))
        return out
    import unittest.mock as mock
    with mock.patch.object(TV, "_fuse", fuse):
        (tdz,) = TE._ad_hoc_dz(ttask.loss_b, _party(npp["b"]), [tz], tb)
    assert seen == [(torch.float32, torch.float32)]
    assert tdz.dtype == torch.float32 and jdz.dtype == jnp.float32
    dev, lim = _within_ulps(tdz, jdz, DZ_ULPS)
    print(f"S={S}: ad-hoc dz max |dev| {dev:.3g} (limit {lim:.3g}, "
          f"{DZ_ULPS} bf16 ulps of its largest magnitude)")
    assert dev <= lim


def test_k9_and_k10_take_the_fp32_ad_hoc_operands(params, monkeypatch):
    """Past 2,048 tokens the ad-hoc pass hands K9-LSE and K10 fp32
    operands of the top tower (bf16 in the bottom), each of which their
    CUDA checks accept (run here on every call).  The reduced model's head
    dim (32) is below the kernels', so this runs at head dim 64."""
    cfg = dataclasses.replace(CFG, n_heads=2, n_kv_heads=1, head_dim=64)
    tree = TV.init_all(0, cfg)
    seen = []
    fwd, dkv, dq = (tfab.flash_attention_fwd_lse,
                    tfab.flash_attention_bwd_dkv, tfab.flash_attention_bwd_dq)

    def checked_fwd(q, k, v, **kw):
        tfa.check_operands(q, k, v, kw["window"], tfa.LSE_NAME)
        seen.append(("fwd", q.dtype))
        return fwd(q, k, v, **kw)

    def checked(name, fn):
        def run(q, k, v, do, lse, delta, **kw):
            tfab.check_bwd_operands(name, q, k, v, do, lse, delta,
                                    kw["window"])
            seen.append((name, q.dtype))
            return fn(q, k, v, do, lse, delta, **kw)
        return run
    monkeypatch.setattr(tfab, "flash_attention_fwd_lse", checked_fwd)
    monkeypatch.setattr(tfab, "flash_attention_bwd_dkv",
                        checked(tfab.DKV_NAME, dkv))
    monkeypatch.setattr(tfab, "flash_attention_bwd_dq",
                        checked(tfab.DQ_NAME, dq))
    _, tb = _batch(1, LONG_S, seed=9)
    task = TE.lift_two_party(TTrain.llm_task(cfg))
    z = TV.forward_a(tree["a"], cfg, tb)
    TE._ad_hoc_dz(task.loss_b, TV.PartyParams(tree["b"]), [z], tb)
    # bottom tower bf16, top tower fp32; the backward reaches the top only
    # (the remat recompute runs the top layer's forward once more)
    assert seen == [("fwd", torch.bfloat16), ("fwd", torch.float32),
                    ("fwd", torch.float32),
                    (tfab.DKV_NAME, torch.float32),
                    (tfab.DQ_NAME, torch.float32)]


# --------------------------------------------------------------------------
# the CELU round
# --------------------------------------------------------------------------
def _jax_round(npp, protocol, rounds, B, S):
    """The reference engine over the LLM task: -> (metrics per round,
    final state)."""
    celu, n_local = JE.preset_config(protocol, JCELUConfig(R=2, W=2))
    task = JE.lift_two_party(JTrain.llm_task(JCFG))
    opt = jmake_optimizer("adagrad", 0.01)
    data = tsynth.make_token_stream(64, S, 512, 512, seed=0)
    it = tsynth.token_batches(data, B, seed=0)
    _, ba, bb = next(it)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)

    def j(d):
        return {k: jnp.asarray(v) for k, v in d.items()}
    state = JE.init_state(task, JE.lift_two_party_params(jp), opt, celu,
                          [j(ba)], j(bb))
    rnd = JE.make_round(task, opt, celu, local_steps=n_local)
    it = tsynth.token_batches(data, B, seed=0)
    out = []
    for _ in range(rounds):
        bi, ba, bb = next(it)
        state, m = rnd(state, [j(ba)], j(bb), bi)
        out.append({k: np.asarray(v) for k, v in m.items()})
    return out, state


def _torch_round(npp, protocol, rounds, B, S):
    celu, n_local = TE.preset_config(protocol, CELUConfig(R=2, W=2))
    task = TE.lift_two_party(TTrain.llm_task(CFG))
    opt = make_optimizer("adagrad", 0.01, use_pallas=True)
    data = tsynth.make_token_stream(64, S, 512, 512, seed=0)
    it = tsynth.token_batches(data, B, seed=0)
    _, ba, bb = next(it)
    params = {"a": _party(npp["a"]), "b": _party(npp["b"])}
    state = TE.init_state(task, TE.lift_two_party_params(params), opt, celu,
                          [to_device(ba, "cpu")], to_device(bb, "cpu"),
                          uniforms=GeneratorUniforms(0, "cpu"))
    rnd = TE.make_round(task, opt, celu, local_steps=n_local)
    it = tsynth.token_batches(data, B, seed=0)
    out = []
    for _ in range(rounds):
        bi, ba, bb = next(it)
        state, m = rnd(state, [to_device(ba, "cpu")], to_device(bb, "cpu"),
                       bi)
        out.append({k: v.detach().numpy() for k, v in m.items()})
    return out, state


@pytest.mark.parametrize("protocol", ["celu", "vanilla"])
def test_llm_round_matches_reference_engine(params, protocol,
                                            monkeypatch):
    """Three rounds of the engine over the LLM task (B = 2, S = 32,
    R = W = 2) against the reference engine on the same parameters and
    batches: counters exact, losses within ROUND_LOSS_RTOL, and the cut
    tensors, the ring and the ad-hoc statistics in the reference's
    dtypes.  Every K1 call is held to the card's operand checks (the bf16
    cut tensor reaches the gate as fp32)."""
    _, npp = params
    rounds, B, S = 3, 2, 32
    k1 = tfs.fused_sample_2d
    calls = []

    def checked_k1(slot, a, z, dz, cos_xi):
        tfs.check_ring(slot, a, z, dz)
        calls.append((a.dtype, z.dtype))
        return k1(slot, a, z, dz, cos_xi)
    monkeypatch.setattr(tfs, "fused_sample_2d", checked_k1)
    jm, js = _jax_round(npp, protocol, rounds, B, S)
    tm, ts = _torch_round(npp, protocol, rounds, B, S)
    for r, (a, b) in enumerate(zip(jm, tm)):
        assert int(a["local_steps"]) == int(b["local_steps"]), r
        dev = abs(float(b["loss"]) - float(a["loss"])) / abs(float(a["loss"]))
        print(f"{protocol} round {r + 1}: loss {float(a['loss']):.5f} / "
              f"{float(b['loss']):.5f}, rel dev {dev:.3g} (limit "
              f"{ROUND_LOSS_RTOL}); w_mean {float(a['w_mean']):.4f} / "
              f"{float(b['w_mean']):.4f}")
        assert dev <= ROUND_LOSS_RTOL
    assert int(js["comm_rounds"]) == int(ts["comm_rounds"]) == rounds
    assert int(js["steps"]["b"]) == int(ts["steps"]["b"])
    assert int(js["steps"]["a"][0]) == int(ts["steps"]["a"][0])
    for key in ("z", "dz"):
        jring = js["ws"]["b"]["buf"][key][0]
        tring = ts["ws"]["b"]["buf"][key][0]
        assert str(jring.dtype) == "bfloat16" and \
            tring.dtype == torch.bfloat16, key
        assert tuple(jring.shape) == tuple(tring.shape) == (2, B, S, 128)
    if protocol == "celu":
        # R = 2 local updates a round, one K1 call a party each
        assert len(calls) == 2 * 2 * rounds
        assert set(calls) == {(torch.float32, torch.bfloat16)}
    else:
        assert not calls


def test_wire_bytes_equal_reference_for_a_bf16_cut_tensor():
    shape = (2, 32, CFG.d_model)
    for wire in ("float32", "bfloat16"):
        jt = JE.make_transport(JCELUConfig(wire_dtype=wire))
        tt = TE.make_transport(CELUConfig(wire_dtype=wire))
        assert tt.round_bytes([shape]) == jt.round_bytes([shape])
        z = torch.randn(shape).to(torch.bfloat16)
        sent, _ = tt.send(None, z)
        assert sent.dtype == torch.bfloat16 and torch.equal(sent, z)


def test_gate_reads_a_bf16_ad_hoc_operand_as_the_reference(params):
    """K1 with the bf16 cut tensor as its ad-hoc operand: the reference
    casts it inside the kernel; the port's wrapper casts it, and the
    weights and cotangent are the reference's."""
    from repro.kernels import ops as jops
    from repro_torch.core.weighting import xi_to_cos
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(3)
    B, F = 2, 32 * 128
    a = rng.standard_normal((B, F)).astype(np.float32)
    z = rng.standard_normal((2, B, F)).astype(np.float32)
    z[1] = a * np.float32([[0.9], [-0.2]]) + 0.3 * z[1]
    dz = rng.standard_normal((2, B, F)).astype(np.float32)
    ja, jz, jdz = (jnp.asarray(x, jnp.bfloat16) for x in (a, z, dz))
    ta, tz, tdz = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (ja, jz, jdz))
    cos_xi = xi_to_cos(60.0)
    jw, jcot = jops.fused_gather_weight(jnp.int32(1), ja, jz, jdz, cos_xi)
    tw, tcot = tops.fused_gather_weight(torch.tensor(1, dtype=torch.int32),
                                        ta, tz, tdz, cos_xi)
    assert tw.dtype == tcot.dtype == torch.float32
    assert float(tw[1]) == 0.0 and float(tw[0]) > 0.5
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-6)
    np.testing.assert_allclose(tcot.numpy(), np.asarray(jcot), atol=2e-6)


# --------------------------------------------------------------------------
# the optimizer on bf16 leaves
# --------------------------------------------------------------------------
def test_apply_updates_on_bf16_leaves_is_bitwise_the_reference():
    """The reference applies (p.astype(f32) + u).astype(p.dtype); the port
    adds the fp32 update to the bf16 leaf in place, rounding once."""
    rng = np.random.default_rng(0)
    p = rng.standard_normal((64, 96)).astype(np.float32)
    u = (rng.standard_normal((64, 96)) * 0.01).astype(np.float32)
    u[0, :8] = [1e-3, -1e-3, 1e-6, -1e-6, 0.0, 5e-3, 2.0 ** -9, 3.0]
    jpd = jnp.asarray(p, jnp.bfloat16)
    want = japply_updates({"w": jpd}, {"w": jnp.asarray(u)})["w"]
    tp = torch.from_numpy(np.asarray(jpd.astype(jnp.float32))).to(
        torch.bfloat16)
    apply_updates([tp], [torch.from_numpy(u)])
    assert tp.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp.view(torch.int16).numpy().view(np.uint16),
        np.asarray(want).view(np.uint16))


# --------------------------------------------------------------------------
# launch/steps.py
# --------------------------------------------------------------------------
TRAIN = ShapeConfig("train_smoke", seq_len=32, global_batch=4, kind="train")
JTRAIN = JShapeConfig("train_smoke", seq_len=32, global_batch=4,
                      kind="train")


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_concrete_batch_is_the_reference_batch(kind):
    shape = dataclasses.replace(TRAIN, kind=kind)
    jshape = dataclasses.replace(JTRAIN, kind=kind)
    jb = JSteps.concrete_batch(JCFG, jshape, seed=3)
    tb = TSteps.concrete_batch(CFG, shape, seed=3)
    assert list(tb) == list(jb)
    assert list(TSteps.batch_specs(CFG, shape)) == \
        list(JSteps.batch_specs(JCFG, jshape))
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def _train_params(npp):
    return TV.PartyParams({"a": tree_to_torch(npp["a"]),
                           "b": tree_to_torch(npp["b"])})


def test_train_step_matches_reference_step(params):
    """One vanilla train step (joint loss, AdaGrad) against the
    reference's: the loss within LOSS_ATOL and every updated leaf within
    GRAD_ULPS bf16 ulps of its largest magnitude.  An AdaGrad first step
    moves a coordinate by ±lr whatever its gradient's size (0 for a zero
    gradient), so where a gradient near zero differs in sign, or is zero
    on one side only, the leaves part by lr or 2·lr: those coordinates
    are counted, not compared, and must stay under 1 %."""
    jp, npp = params
    jopt = jmake_optimizer("adagrad", 0.01)
    jb = JSteps.concrete_batch(JCFG, JTRAIN, seed=1)
    jnew, _, jl = JSteps.make_train_step(JCFG, jopt)(jp, jopt.init(jp), jb)
    opt = make_optimizer("adagrad", 0.01, use_pallas=True)
    pp = _train_params(npp)
    tb = TSteps.concrete_batch(CFG, TRAIN, seed=1)
    state = opt.init(reference_parameters(pp))
    pp2, state, tl = TSteps.make_train_step(CFG, opt)(pp, state, tb)
    assert pp2 is pp
    print(f"train step loss {float(jl):.6f} / {float(tl):.6f}")
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    flips = total = 0
    for a, b in zip(jax.tree_util.tree_leaves(jnew), reference_parameters(pp)):
        a, b = np.asarray(a, np.float32), b.detach().float().numpy()
        far = np.abs(a - b) > 0.5 * 0.01
        flips += int(far.sum())
        total += a.size
        dev = float(np.abs(a - b)[~far].max(initial=0.0))
        assert dev <= GRAD_ULPS * BF16_ULP * float(np.abs(a).max())
    print(f"train step: {flips} of {total} coordinates stepped the other "
          f"way")
    assert flips <= total // 100


def test_train_step_microbatches_match_one_batch(params):
    """``microbatches=2`` against one batch (as
    tests/test_perf_features.py holds the reference): the same loss, and
    the same gradient reaches the optimizer (the mean of the halves'
    gradients, summed in fp32), within GRAD_ULPS bf16 ulps of each leaf's
    largest magnitude."""
    from repro_torch.optim import Optimizer
    _, npp = params
    tb = TSteps.concrete_batch(CFG, TRAIN, seed=2)
    out = []
    for mb in (1, 2):
        seen = []

        def update(grads, state, params=None):
            seen.append([g.float() for g in grads])
            return [torch.zeros_like(g, dtype=torch.float32)
                    for g in grads], state
        opt = Optimizer(lambda p: {}, update)
        pp = _train_params(npp)
        _, _, loss = TSteps.make_train_step(CFG, opt, microbatches=mb)(
            pp, {}, tb)
        out.append((float(loss), seen[0]))
    (l1, g1), (l2, g2) = out
    print(f"loss one batch {l1:.6f}, two microbatches {l2:.6f}")
    assert abs(l1 - l2) <= 1e-5
    for a, b in zip(g1, g2):
        lim = GRAD_ULPS * BF16_ULP * float(a.abs().max())
        assert float((a - b).abs().max()) <= lim
    with pytest.raises(ValueError, match="microbatches"):
        TSteps.make_train_step(CFG, opt, microbatches=3)(
            _train_params(npp), {}, tb)


def test_make_step_picks_the_shape_kinds_step(params):
    _, npp = params
    pp = _train_params(npp)
    shape = dataclasses.replace(TRAIN, kind="prefill", global_batch=1)
    batch = TSteps.concrete_batch(CFG, shape, seed=0)
    logits, caches = TSteps.make_step(CFG, shape)(pp, batch)
    assert logits.shape == (1, 1, CFG.padded_vocab)
    serve = TSteps.make_step(CFG, dataclasses.replace(shape, kind="decode"))
    sb = {"token": batch["tokens"][:, -1:], "token_a": batch["tokens_a"][:, -1:]}
    logits2, _ = serve(pp, caches, sb, 32)
    assert logits2.shape == (1, 1, CFG.padded_vocab)
    with pytest.raises(ValueError, match="optimizer"):
        TSteps.make_step(CFG, TRAIN)


# --------------------------------------------------------------------------
# launch/budget.py at full geometry, on the meta device
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cache,opt_state", [
    ("float32", "float32"), ("int4", "int8"), ("bfloat16", "bfloat16"),
    ("int8", "int8")])
def test_party_hbm_budget_matches_reference(cache, opt_state):
    """smollm-360m at full width, B = 256, S = 4,096, W = 5: every byte
    counter equal to the reference's (``jax.eval_shape`` there, the meta
    device here), with no weight allocated."""
    kw = dict(batch_size=256, seq_len=4096, W=5, cache_dtype=cache,
              opt_state_dtype=opt_state)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    got = TBudget.party_hbm_budget(get_config("smollm-360m"), **kw)
    grown_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                - rss0) / 1024
    want = JBudget.party_hbm_budget(jget_config("smollm-360m"), **kw)
    print(f"{cache}/{opt_state}: {got}; peak RSS grew {grown_mb:.0f} MB")
    assert got == want
    # the fp32 parameters alone would take 3.8 GB
    assert grown_mb < 500
    assert "party a" in TBudget.format_budget("smollm-360m", got)


def test_budget_traces_on_the_meta_device():
    """The parameters and the cut tensor of the budget are meta tensors,
    and the forward that makes Z reaches the attention kernels' wrappers
    without launching anything."""
    cfg = get_config("smollm-360m")
    _cuda.reset_launches()
    p = TBudget._param_shapes(cfg)
    leaves = _leaves(p)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    z = TBudget._z_struct(cfg, p["a"], 4, 4096)
    assert z.device.type == "meta" and tuple(z.shape) == (4, 4096, 960)
    assert z.dtype == torch.bfloat16
    assert all(v == 0 for v in _cuda.LAUNCHES.values())


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def test_cli_trains_reduced_smollm_on_the_cpu(capsys):
    out = TTrain.main(["--arch", "smollm-360m", "--reduced", "--device",
                       "cpu", "--rounds", "2", "--batch-size", "2",
                       "--seq-len", "16", "--R", "2", "--W", "2"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["comm_bytes"] == 2 * 2 * (2 * 16 * 128 * 4)
    text = capsys.readouterr().out
    assert "[done] smollm-360m celu" in text


@pytest.mark.parametrize("arch", [
    "granite-moe-3b-a800m", "hymba-1.5b", "llama-3.2-vision-90b",
    "llama4-scout-17b-a16e", "seamless-m4t-large-v2", "xlstm-125m"])
def test_cli_refuses_other_families(arch):
    """The cross-attention families (vlm, audio) are refused in the
    reference's words (they train by ``launch/steps.py``'s train step:
    tests/test_torch_cross.py); the other text families train a reduced
    round on the CPU."""
    if get_config(arch).family in ("vlm", "audio"):
        with pytest.raises(SystemExit) as want:
            JTrain.main(["--arch", arch, "--reduced"])
        with pytest.raises(SystemExit, match="text-family") as got:
            TTrain.main(["--arch", arch, "--reduced", "--device", "cpu"])
        assert str(got.value) == str(want.value)
        return
    out = TTrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--rounds", "1", "--batch-size", "2", "--seq-len",
                       "16", "--R", "1", "--W", "2"])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])


def _count_kernel_calls(monkeypatch):
    """-> a Counter of the calls of each kernel wrapper that the LLM
    training path launches (their plain versions run on the CPU, so the
    calls are counted, not the launches), keyed like ``_cuda.LAUNCHES``;
    and the ``chip_smoke`` module."""
    import collections
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke
    from repro_torch.kernels import fused_adagrad as tag
    from repro_torch.models import layers as TL
    calls = collections.Counter()

    def counted(mod, name, key=None):
        fn = getattr(mod, name)

        def run(*a, **k):
            calls[key or name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, run)
    for name in ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        counted(tfab, name)
    counted(TL, "flash_attention")
    counted(tfs, "fused_sample_2d")
    counted(tag, "fused_adagrad_step_", "fused_adagrad")
    return calls, chip_smoke


@pytest.mark.parametrize("remat", [True, False])
def test_chip_smoke_launch_counts_are_the_engines_calls(remat, monkeypatch):
    """``chip_smoke.py`` holds the training path's kernel launches on the
    card to counts it derives from the engine's code; here the same
    derivation must equal the calls of each kernel's wrapper in one celu
    round past 2,048 tokens at reduced geometry."""
    calls, chip_smoke = _count_kernel_calls(monkeypatch)
    args = chip_smoke.train_args("smollm-360m", rounds=1, device="cpu",
                                 reduced=True, batch_size=1, seq_len=LONG_S,
                                 R=1, W=2, remat=remat)
    out = TTrain.train_llm(args)
    params = out["state"]["params"]
    n = [len(list(p.parameters())) for p in params["a"] + [params["b"]]]
    want = chip_smoke._llm_launches(CFG, 1, 1, remat, n)
    print(f"remat={remat}: calls {dict(calls)}")
    assert dict(calls) == want


def test_chip_smoke_launch_counts_at_pipeline_depth_1(monkeypatch):
    """The same at ``--pipeline-depth 1``: one round, whose drain runs one
    more local scan (the derivation's ``depth``)."""
    calls, chip_smoke = _count_kernel_calls(monkeypatch)
    args = chip_smoke.train_args("smollm-360m", rounds=1, device="cpu",
                                 reduced=True, batch_size=1, seq_len=LONG_S,
                                 R=1, W=2, remat=False, pipeline_depth=1)
    out = TTrain.train_llm(args)
    params = out["state"]["params"]
    n = [len(list(p.parameters())) for p in params["a"] + [params["b"]]]
    want = chip_smoke._llm_launches(CFG, 1, 1, False, n, depth=1)
    print(f"depth 1: calls {dict(calls)}")
    assert dict(calls) == want
    assert want != chip_smoke._llm_launches(CFG, 1, 1, False, n)
