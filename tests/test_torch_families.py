"""The port's text families beyond dense (moe, hybrid, ssm / xlstm)
against the reference, model and engine.

At the ``reduced()`` geometry of granite-moe-3b-a800m, llama4-scout-17b-
a16e, hymba-1.5b and xlstm-125m (2 or 3 towers of one layer, d 128, 4
query and 2 KV heads of dim 32, 4 experts, vocabulary 512) on parameters
drawn in JAX and brought across bitwise, the same batches go through
``repro.models.vfl`` / ``repro.core.engine`` and their counterparts in
``repro_torch``.  Both sides compute in bf16 with fp32 norms, softmax,
router logits, SSM scans and xLSTM cells, but their bf16 matrix products
sum in other orders, so an activation may round to the neighbouring bf16
value.  In a MoE layer such an ulp can move a token whose router logits
nearly tie to another expert, which moves that token's output by much
more than an ulp, and AdaGrad's first steps (±lr whatever a gradient's
size) carry it into the next rounds.  So the MoE families' gradients and
rounds are held on fp32 parameters (both sides then route alike), and in
bf16 only through the loss, logits and tokens.  Tolerances, each a few
times the largest deviation measured here:

  * logits: ``LOGIT_ATOL`` (tests/test_torch_llm.py; measured: 0.0215,
    and 2.1e-6 for the MoE families on fp32 parameters);
  * per-instance loss and aux loss: ``LOSS_ATOL``
    (tests/test_torch_llm_train.py; measured: 1.6e-3);
  * gradients on fp32 parameters: ``F32_GRAD_RTOL`` of each leaf's
    largest magnitude (measured: 2.7e-6);
  * each party's gradients on the model's (bf16) parameters, hybrid and
    xlstm: ``GRAD_REL_L2`` relative L2 per leaf (measured: 0.0235);
  * the ad-hoc ∇Z pass (fp32 top tower): ``DZ_ULPS`` bf16 ulps of its
    largest magnitude (tests/test_torch_llm_train.py; measured: 0.46);
  * three CELU rounds: ``ROUND_LOSS_RTOL`` relative (measured: 6.1e-5 on
    fp32 parameters, 2.1e-3 in bf16);
  * a cached state (SSM, xLSTM) after prefill: ``STATE_RTOL`` of its
    largest magnitude (measured: 7.7e-3).
"""
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import CELUConfig as JCELUConfig
from repro.core import engine as JE
from repro.launch import budget as JBudget
from repro.launch import train as JTrain
from repro.models import backbone as JB
from repro.models import vfl as JV
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.bridge import path_key, reference_parameters, tree_to_torch
from repro_torch.configs import get_config
from repro_torch.configs.base import CELUConfig
from repro_torch.core import engine as TE
from repro_torch.core.uniforms import GeneratorUniforms
from repro_torch.data import synthetic as tsynth
from repro_torch.data import to_device
from repro_torch.launch import budget as TBudget
from repro_torch.launch import serve as TServe
from repro_torch.launch import train as TTrain
from repro_torch.models import backbone as TB
from repro_torch.models import vfl as TV
from repro_torch.optim import make_optimizer
from repro_torch.serve import Request, ServeConfig, ServeEngine, \
    naive_generate

torch.set_num_threads(1)

ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e", "hymba-1.5b",
         "xlstm-125m")
MOE = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")
LOGIT_ATOL = 0.05
LOSS_ATOL = 0.01
F32_GRAD_RTOL = 1e-5
GRAD_REL_L2 = 0.05
DZ_ULPS = 2
ROUND_LOSS_RTOL = 4e-3
STATE_RTOL = 0.02
BF16_ULP = 2.0 ** -7
B, S = 2, 32

_PARAMS = {}


def _cfgs(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _params(arch, f32=False):
    """(jax tree, numpy tree) drawn once in JAX; ``f32`` casts every leaf
    to fp32 (both sides then compute in fp32)."""
    key = (arch, f32)
    if key not in _PARAMS:
        jp = JV.init_all(jax.random.PRNGKey(0), _cfgs(arch)[0])
        if f32:
            jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        _PARAMS[key] = (jp, jax.tree_util.tree_map(np.asarray, jp))
    return _PARAMS[key]


def _batch(S_, seed, B_=B):
    rng = np.random.default_rng(seed)
    raw = {k: rng.integers(0, 512, (B_, S_)).astype(np.int32)
           for k in ("tokens", "tokens_a", "labels")}
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v.astype(np.int64)) for k, v in raw.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _paths(tree):
    return [jax.tree_util.keystr(p, simple=True, separator=".")
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]


# --------------------------------------------------------------------------
# layouts, trees and the bridge
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_tower_stages_match_reference(arch):
    """The text towers' stage layouts for 1-9 layers, and the full and
    reduced configs' three towers, equal the reference's."""
    for jc, tc in ((jget_config(arch), get_config(arch)), _cfgs(arch)):
        for n in range(1, 10):
            assert TB.tower_stages(tc, n) == JB.tower_stages(jc, n, "text")
        for part in ("a", "b", "top"):
            assert getattr(TV, f"stages_{part}")(tc) == \
                getattr(JV, f"stages_{part}")(jc)
    if arch == "xlstm-125m":           # 3 / 6 / 3: Party A all mLSTM
        cfg = get_config(arch)
        assert TV.stages_a(cfg) == [(("mlstm",), 3)]
        assert TV.stages_b(cfg) == [(("slstm", "mlstm", "mlstm", "mlstm"),
                                     1), (("mlstm",), 2)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("geometry", ["reduced", "full"])
def test_parameter_trees_match_reference(arch, geometry):
    """The port's own init draws every leaf of the reference's tree at
    its path, shape and dtype (full width on the meta device)."""
    jc = jget_config(arch)
    tc = get_config(arch)
    if geometry == "reduced":
        jc, tc = jc.reduced(), tc.reduced()
        tp = TV.init_all(0, tc)
    else:
        tp = TBudget._param_shapes(tc)
    jp = jax.eval_shape(lambda: JV.init_all(jax.random.PRNGKey(0), jc))

    def desc(tree):
        return [(p, tuple(s.shape), str(s.dtype).replace("torch.", ""))
                for p, s in zip(_paths(tree),
                                jax.tree_util.tree_leaves(tree))]
    assert desc(jp) == desc(tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_parameters_are_in_jax_leaf_order(arch):
    """``PartyParams``' paths sorted as JAX flattens (``"A_log" < "D" <
    "conv_w"``), and the bridge carries every leaf bitwise (the fp32
    router, A_log, D, dt_bias, w_i, w_f, f_bias, w_x, r_h, bias and the
    (d, H, dh) mLSTM projections among them)."""
    jp, npp = _params(arch)
    for party in ("a", "b"):
        pp = TV.PartyParams(tree_to_torch(npp[party]))
        names = sorted((n for n, _ in pp.named_parameters()), key=path_key)
        assert names == _paths(jp[party])
        for a, b in zip(jax.tree_util.tree_leaves(jp[party]),
                        reference_parameters(pp)):
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.detach().float().numpy())
    if arch == "hymba-1.5b":
        mamba = [n for n in _paths(jp["b"]) if ".mamba." in n][:3]
        assert [n.rsplit(".", 1)[1] for n in mamba] == ["A_log", "D",
                                                        "conv_w"]


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------
def _forward(arch, f32):
    """(jax, port) of Party B's logits, per-instance loss and aux loss
    on each side's own Z."""
    jc, tc = _cfgs(arch)
    jp, npp = _params(arch, f32)
    tp = tree_to_torch(npp)
    jb, tb = _batch(S, seed=1)
    jz = JV.forward_a(jp["a"], jc, jb)
    tz = TV.forward_a(tp["a"], tc, tb)
    jl, jaux = JV.forward_b(jp["b"], jc, jz, jb)
    tl, taux = TV.forward_b(tp["b"], tc, tz, tb)
    jli, _ = JV.per_instance_loss(jp["b"], jc, jz, jb)
    tli, _ = TV.per_instance_loss(tp["b"], tc, tz, tb)
    return (jl, jli, jaux), (tl, tli, taux)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_reference(arch):
    """bf16, as the model runs: the per-instance loss and the aux loss
    (the MoE's load-balance term, 0 otherwise) within LOSS_ATOL, Party
    B's logits within LOGIT_ATOL.  In a MoE family a token that routes
    to another expert on one side moves its position's logits by more:
    there the positions past LOGIT_ATOL are counted, and the logits are
    held to LOGIT_ATOL on fp32 parameters, where both sides route
    alike."""
    (jl, jli, jaux), (tl, tli, taux) = _forward(arch, False)
    dev = np.abs(_np(tl) - _np(jl)).max(axis=-1)
    ldev = float(np.abs(_np(tli) - _np(jli)).max())
    adev = abs(float(taux) - float(jaux))
    far = int((dev > LOGIT_ATOL).sum())
    print(f"{arch}: logits max |dev| {dev.max():.3g} (limit {LOGIT_ATOL}; "
          f"{far} of {dev.size} positions past it); loss max |dev| "
          f"{ldev:.3g}, aux {float(taux):.6g} / {float(jaux):.6g} (limit "
          f"{LOSS_ATOL})")
    assert ldev <= LOSS_ATOL and adev <= LOSS_ATOL
    assert (arch in MOE) == (float(jaux) > 0)
    if arch in MOE:
        (jl, _, _), (tl, _, _) = _forward(arch, True)
        dev = np.abs(_np(tl) - _np(jl)).max(axis=-1)
        print(f"{arch} on fp32 parameters: logits max |dev| "
              f"{dev.max():.3g}")
    assert dev.max() <= LOGIT_ATOL


def _grads(arch, f32):
    """(jax gradient leaves, the port's, leaf paths) of the joint loss."""
    jc, tc = _cfgs(arch)
    jp, npp = _params(arch, f32)
    jb, tb = _batch(S, seed=2)
    jg = jax.grad(lambda p: JV.joint_loss(p, jc, jb))(jp)
    pp = TV.PartyParams(tree_to_torch(npp))
    leaves = reference_parameters(pp)
    tg = torch.autograd.grad(TV.joint_loss(pp, tc, tb), leaves)
    return jax.tree_util.tree_leaves(jg), tg, _paths(jg)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_on_fp32_parameters_match_reference(arch):
    """Both parties' gradients of the joint loss (aux included) on fp32
    parameters, where both sides route alike: every leaf within
    F32_GRAD_RTOL of its largest magnitude."""
    jl, tl, paths = _grads(arch, True)
    worst = {}
    for p, a, b in zip(paths, jl, tl):
        a, b = _np(a), _np(b)
        worst[p] = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
    w = max(worst, key=worst.get)
    print(f"{arch}: {len(worst)} leaves, worst rel dev {worst[w]:.3g} "
          f"({w}; limit {F32_GRAD_RTOL})")
    assert worst[w] <= F32_GRAD_RTOL


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_party_gradients_on_bf16_parameters_match_reference(arch):
    """Each party's gradients on the model's own (bf16) parameters, for
    the families whose routing cannot flip, from the same inputs: Party
    B's at the reference's Z, Party A's from the reference's ∇Z (the
    engine's exchange).  Each leaf within GRAD_REL_L2 relative L2.  (The
    joint gradient is not compared in bf16: at this geometry xlstm's
    Party B gradient moves by 3.5 % relative L2 when 21 of Z's 8,192
    values move by a bf16 ulp, in either framework.)"""
    jc, tc = _cfgs(arch)
    jp, npp = _params(arch)
    jb, tb = _batch(S, seed=2)
    jz, jpull = jax.vjp(lambda pa: JV.forward_a(pa, jc, jb, train=True),
                        jp["a"])
    jgb, jdz = jax.grad(lambda pb, z: jnp.mean(JV.per_instance_loss(
        pb, jc, z, jb)[0]), argnums=(0, 1))(jp["b"], jz)
    (jga,) = jpull(jdz)
    pa = TV.PartyParams(tree_to_torch(npp["a"]))
    pb = TV.PartyParams(tree_to_torch(npp["b"]))
    z = torch.from_numpy(np.array(jz.astype(jnp.float32))).to(
        torch.bfloat16)
    li, _ = TV.per_instance_loss(pb, tc, z, tb)
    tgb = torch.autograd.grad(li.mean(), reference_parameters(pb))
    tz = TV.forward_a(pa, tc, tb, train=True)
    dz = torch.from_numpy(np.array(jdz.astype(jnp.float32))).to(
        torch.bfloat16)
    tga = torch.autograd.grad(tz, reference_parameters(pa), dz)
    worst = {}
    for party, jg, tg in (("a", jga, tga), ("b", jgb, tgb)):
        for p, a, b in zip(_paths(jg), jax.tree_util.tree_leaves(jg), tg):
            assert str(a.dtype) == str(b.dtype).replace("torch.", ""), p
            a, b = _np(a), _np(b)
            worst[f"{party}.{p}"] = float(np.linalg.norm(a - b) / max(
                np.linalg.norm(a), 1e-30))
    w = max(worst, key=worst.get)
    print(f"{arch}: {len(worst)} leaves, worst relative L2 "
          f"{worst[w]:.3g} ({w}; limit {GRAD_REL_L2})")
    assert worst[w] <= GRAD_REL_L2


@pytest.mark.parametrize("arch", ARCHS)
def test_ad_hoc_dz_pass_matches_reference(arch):
    """Party B's ad-hoc ∇Z pass: the cached bf16 Z enters in fp32, so the
    top tower (its MoE buffers, SSM and cells too) runs in fp32 against
    bf16 weights, as ``jnp`` promotes it."""
    jc, tc = _cfgs(arch)
    jp, npp = _params(arch, arch in MOE)
    jb, tb = _batch(S, seed=3)
    jz = JV.forward_a(jp["a"], jc, jb)
    jtask = JTrain.llm_task(jc)
    jdz = jax.grad(lambda zl: jnp.mean(jtask.loss_b(jp["b"], zl[0], jb)[0]))(
        [jz.astype(jnp.float32)])[0]
    ttask = TE.lift_two_party(TTrain.llm_task(tc))
    tz = torch.from_numpy(np.array(jz.astype(jnp.float32))).to(
        torch.bfloat16 if jz.dtype == jnp.bfloat16 else torch.float32)
    (tdz,) = TE._ad_hoc_dz(ttask.loss_b,
                           TV.PartyParams(tree_to_torch(npp["b"])), [tz], tb)
    assert tdz.dtype == torch.float32 and jdz.dtype == jnp.float32
    dev = float(np.abs(_np(tdz) - _np(jdz)).max())
    lim = DZ_ULPS * BF16_ULP * float(np.abs(_np(jdz)).max())
    print(f"{arch}: ad-hoc dz max |dev| {dev:.3g} (limit {lim:.3g})")
    assert dev <= lim


# --------------------------------------------------------------------------
# serving: prefill, decode, the engine's lanes
# --------------------------------------------------------------------------
def _state_leaves(caches):
    """The non-KV cache leaves (SSM h / conv, xLSTM states) by path."""
    return {p: v for p, v in zip(_paths(caches),
                                 jax.tree_util.tree_leaves(caches))
            if ".attn." not in p}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A 16-token prefill and three decode steps: logits within
    LOGIT_ATOL at each, the caches' layout the reference's, and the SSM /
    xLSTM states within STATE_RTOL of the reference's after prefill."""
    jc, tc = _cfgs(arch)
    jp, npp = _params(arch)
    tp = tree_to_torch(npp)
    jb, tb = _batch(20, seed=4, B_=1)
    pre = {k: v[:, :16] for k, v in jb.items() if k != "labels"}
    jl, jcache = JV.prefill(jp, jc, pre, 20)
    tl, tcache = TV.prefill(tp, tc, {k: tb[k][:, :16]
                                     for k in ("tokens", "tokens_a")}, 20)
    devs = [float(np.abs(_np(tl) - _np(jl)).max())]
    jst = _state_leaves(jcache)
    tst = _state_leaves(TB.tree_map(lambda t: t, tcache))
    assert sorted(jst) == sorted(tst)
    assert (arch in MOE) == (not jst)
    sdev = 0.0
    for p in jst:
        a, b = _np(jst[p]), _np(tst[p])
        assert a.shape == b.shape, p
        sdev = max(sdev, float(np.abs(a - b).max()
                               / max(np.abs(a).max(), 1e-30)))
    assert sdev <= STATE_RTOL
    for i in range(3):
        sb = {"token": jb["tokens"][:, 16 + i:17 + i],
              "token_a": jb["tokens_a"][:, 16 + i:17 + i]}
        jl, jcache = JV.decode_step(jp, jc, jcache, sb, jnp.int32(16 + i))
        tl, tcache = TV.decode_step(tp, tc, tcache, {
            k: torch.from_numpy(np.array(v)) for k, v in sb.items()},
            16 + i)
        devs.append(float(np.abs(_np(tl) - _np(jl)).max()))
    print(f"{arch}: prefill and 3 decode steps, logits max |dev| "
          f"{[float(f'{d:.3g}') for d in devs]} (limit {LOGIT_ATOL}); "
          f"{len(jst)} state leaves within {sdev:.3g} of their largest "
          f"magnitude (limit {STATE_RTOL})")
    assert max(devs) <= LOGIT_ATOL
    # the engine's empty cache has the prefill's layout (the conv tail is
    # fp32 there and the prefill's activations' dtype here, as in the
    # reference)
    empty = TV.make_serve_cache(tc, 1, 20)
    for p, a, b in zip(_paths(empty), jax.tree_util.tree_leaves(
            TB.tree_map(lambda t: t, empty)),
            jax.tree_util.tree_leaves(TB.tree_map(lambda t: t, tcache))):
        assert a.shape == b.shape, p


def _requests(cfg, n, gens, P=8, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, P).astype(np.int32),
                    rng.integers(0, cfg.aux_vocab_size, P).astype(np.int32),
                    g) for i, g in zip(range(n), gens)]


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_engine_matches_naive_with_churn(arch):
    """Six requests through four lanes with admits and evictions mid-
    flight: each lane's SSM / xLSTM states are written at admission and
    updated in place, and the tokens equal the sequential loop's."""
    _, tc = _cfgs(arch)
    _, npp = _params(arch)
    tp = tree_to_torch(npp)
    reqs = _requests(tc, 6, [6, 4, 5, 6, 4, 6])
    scfg = ServeConfig(capacity=4, prompt_len=8, max_new_tokens=6,
                       compression="", cache_dtype="float32", ring_slots=3)
    comps, stats = ServeEngine(tp, tc, scfg).run(reqs)
    assert len(comps) == 6
    for c in comps:
        r = reqs[c.req_id]
        batch = {"tokens": torch.from_numpy(r.prompt[None]),
                 "tokens_a": torch.from_numpy(r.prompt_a[None])}
        ref = naive_generate(tp, tc, batch, 6, 14)[0].numpy()
        np.testing.assert_array_equal(c.tokens, ref[:len(c.tokens)],
                                      err_msg=f"{arch} req {c.req_id}")
        assert len(c.tokens) == r.max_new_tokens


# --------------------------------------------------------------------------
# the CELU round
# --------------------------------------------------------------------------
def _jax_rounds(arch, npp, rounds):
    jc, _ = _cfgs(arch)
    celu, n_local = JE.preset_config("celu", JCELUConfig(R=2, W=2))
    task = JE.lift_two_party(JTrain.llm_task(jc))
    opt = jmake_optimizer("adagrad", 0.01)
    data = tsynth.make_token_stream(64, S, 512, 512, seed=0)
    it = tsynth.token_batches(data, B, seed=0)
    _, ba, bb = next(it)

    def j(d):
        return {k: jnp.asarray(v) for k, v in d.items()}
    state = JE.init_state(task, JE.lift_two_party_params(
        jax.tree_util.tree_map(jnp.asarray, npp)), opt, celu, [j(ba)], j(bb))
    rnd = JE.make_round(task, opt, celu, local_steps=n_local)
    it = tsynth.token_batches(data, B, seed=0)
    out = []
    for _ in range(rounds):
        bi, ba, bb = next(it)
        state, m = rnd(state, [j(ba)], j(bb), bi)
        out.append({k: np.asarray(v) for k, v in m.items()})
    return out, state


def _torch_rounds(arch, npp, rounds):
    _, tc = _cfgs(arch)
    celu, n_local = TE.preset_config("celu", CELUConfig(R=2, W=2))
    task = TE.lift_two_party(TTrain.llm_task(tc))
    opt = make_optimizer("adagrad", 0.01, use_pallas=True)
    data = tsynth.make_token_stream(64, S, 512, 512, seed=0)
    it = tsynth.token_batches(data, B, seed=0)
    _, ba, bb = next(it)
    params = {p: TV.PartyParams(tree_to_torch(npp[p])) for p in ("a", "b")}
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


@pytest.mark.parametrize("arch", ARCHS)
def test_celu_rounds_match_reference_engine(arch):
    """Three celu rounds (B = 2, S = 32, R = W = 2, AdaGrad lr 0.01 on
    the kernel route) against the reference engine on the same
    parameters and batches: counters exact, losses within
    ROUND_LOSS_RTOL.  The MoE families run on fp32 parameters (module
    docstring)."""
    _, npp = _params(arch, arch in MOE)
    rounds = 3
    jm, js = _jax_rounds(arch, npp, rounds)
    tm, ts = _torch_rounds(arch, npp, rounds)
    for r, (a, b) in enumerate(zip(jm, tm)):
        assert int(a["local_steps"]) == int(b["local_steps"]), r
        dev = abs(float(b["loss"]) - float(a["loss"])) / abs(float(a["loss"]))
        print(f"{arch} round {r + 1}: loss {float(a['loss']):.5f} / "
              f"{float(b['loss']):.5f}, rel dev {dev:.3g} (limit "
              f"{ROUND_LOSS_RTOL}); w_mean {float(a['w_mean']):.4f} / "
              f"{float(b['w_mean']):.4f}")
        assert dev <= ROUND_LOSS_RTOL
    assert int(js["comm_rounds"]) == int(ts["comm_rounds"]) == rounds
    assert int(js["steps"]["b"]) == int(ts["steps"]["b"])
    assert int(js["steps"]["a"][0]) == int(ts["steps"]["a"][0])


# --------------------------------------------------------------------------
# the budget and the CLIs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_party_hbm_budget_matches_reference(arch):
    """Each family at its full width (B = 2, S = 4,096, W = 2; llama4's
    216 GB of bf16 parameters too): every byte counter equal to the
    reference's, traced on the meta device with no weight allocated."""
    kw = dict(batch_size=2, seq_len=4096, W=2)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    got = TBudget.party_hbm_budget(get_config(arch), **kw)
    grown_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                - rss0) / 1024
    want = JBudget.party_hbm_budget(jget_config(arch), **kw)
    print(f"{arch}: {got}; peak RSS grew {grown_mb:.0f} MB")
    assert got == want
    assert grown_mb < 500


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_reduced_on_the_cpu(arch, capsys):
    out = TTrain.main(["--arch", arch, "--device", "cpu", "--reduced",
                       "--protocol", "celu", "--rounds", "3",
                       "--batch-size", "2", "--seq-len", "16"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["comm_bytes"] == 3 * 2 * (2 * 16 * 128 * 4)
    assert f"[done] {arch} celu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_reduced_on_the_cpu(arch, capsys):
    comps, stats = TServe.main(["--arch", arch, "--device", "cpu",
                                "--requests", "4", "--capacity", "2",
                                "--prompt-len", "8", "--gen", "6"])
    assert len(comps) == 4 and stats["n_requests"] == 4
    out = capsys.readouterr().out
    assert "(132 B per decode uplink row)" in out
    assert f"arch={arch}-smoke" in out


def test_llama4_full_width_does_not_fit_one_card():
    """The sizes the README states: llama4-scout's bf16 parameters alone
    are 216 GB (both parties), past one 80 GB card; granite's 6.96 GB
    fit."""
    n = {}
    for arch in ("llama4-scout-17b-a16e", "granite-moe-3b-a800m"):
        p = TBudget._param_shapes(get_config(arch))
        n[arch] = TBudget.tree_nbytes(p["a"]) + TBudget.tree_nbytes(p["b"])
    assert round(n["llama4-scout-17b-a16e"] / 1e9) == 216
    assert round(n["granite-moe-3b-a800m"] / 1e9, 2) == 6.96


@pytest.mark.parametrize("arch,seq_len", [
    ("granite-moe-3b-a800m", 3072), ("hymba-1.5b", 3072),
    ("xlstm-125m", 64)])
def test_chip_smoke_launch_counts_are_the_engines_calls(arch, seq_len,
                                                         monkeypatch):
    """``chip_smoke.py``'s families phase holds each run's kernel
    launches to ``_llm_launches``, which counts the attention-bearing
    layers of each tower (none in xlstm) and a K7 table a 48 tensors;
    here the derivation must equal the calls of each kernel wrapper in
    one celu round (past 2,048 tokens where the family has attention)."""
    from test_torch_llm_train import _count_kernel_calls
    calls, chip_smoke = _count_kernel_calls(monkeypatch)
    _, tc = _cfgs(arch)
    args = chip_smoke.train_args(arch, rounds=1, device="cpu", reduced=True,
                                 batch_size=1, seq_len=seq_len, R=1, W=2)
    out = TTrain.train_llm(args)
    params = out["state"]["params"]
    n = [len(list(p.parameters())) for p in params["a"] + [params["b"]]]
    want = chip_smoke._llm_launches(tc, 1, 1, True, n)
    print(f"{arch}: calls {dict(calls)}")
    assert {k: v for k, v in dict(calls).items() if v} == \
        {k: v for k, v in want.items() if v}
    assert (want["flash_attention_fwd_lse"] > 0) == (arch != "xlstm-125m")
