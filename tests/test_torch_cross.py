"""The port's cross-attention families (vlm, audio) against the reference.

At the ``reduced()`` geometry of llama-3.2-vision-90b and
seamless-m4t-large-v2 (d 128, 4 query and 2 KV heads of dim 32,
vocabulary 512, 16 patches or S / 4 frames of 32 features) on parameters
drawn in JAX and brought across bitwise (``bridge.tree_to_torch``), the
same inputs go through ``repro.models`` / ``repro.launch.steps`` /
``repro.serve`` and their counterparts in ``repro_torch``.  The reduced
vlm config has one layer a tower and a cross layer every second layer, so
its towers hold no cross layer at all: Party B never reads Party A's Z
and Party A's gradient is zero, in the reference too.  So the vlm path
is also held at ``VFL_X`` (two layers a tower: one dense and one cross
layer each), where Party A's gradient must not be zero.

Both sides compute in bf16 with fp32 norms, rotary angles and softmax,
but their bf16 matrix products sum in other orders, so an activation may
round to the neighbouring bf16 value.  Tolerances, each stated with the
largest deviation measured here (printed by every test):

  * a layer's fp32 output: ``F32_RTOL`` of its largest magnitude
    (measured: 4.2e-7);
  * a layer's bf16 output: ``ULPS`` bf16 ulps of its largest magnitude,
    also past 2,048 frames, where the reference's blockwise path rounds
    the scores to bf16 and the port's K9 route does not (measured: 0.5
    and 0.95 ulps);
  * Z_A and fp32 gradients of both parties (through ``make_train_step``):
    ``F32_RTOL`` of each leaf's largest magnitude (measured: 1.6e-6);
  * the joint loss: ``LOSS_ATOL`` in bf16 (measured: 2.3e-4);
  * logits: ``LOGIT_ATOL`` (measured: 0.012);
  * greedy tokens: equal up to the first step where the reference's
    top-1 margin is below twice ``LOGIT_ATOL``; the rest are counted.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import VFLConfig as JVFLConfig
from repro.launch import steps as JSteps
from repro.models import backbone as JB
from repro.models import layers as JL
from repro.models import vfl as JV
from repro.optim import make_optimizer as jmake_optimizer
from repro.serve import make_naive_fns as jmake_naive_fns
from repro.serve import naive_generate as jnaive_generate
from repro_torch.bridge import path_key, reference_parameters, tree_to_torch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig, VFLConfig
from repro_torch.kernels import _cuda
from repro_torch.launch import budget as TBudget
from repro_torch.launch import serve as TServe
from repro_torch.launch import steps as TSteps
from repro_torch.models import backbone as TB
from repro_torch.models import layers as TL
from repro_torch.models import vfl as TV
from repro_torch.optim import make_optimizer
from repro_torch.serve import naive_generate

torch.set_num_threads(1)

VISION, AUDIO = "llama-3.2-vision-90b", "seamless-m4t-large-v2"
VFL_X = (0, 2, 2, "cross_attn")      # vlm with a cross layer a tower
# family -> (arch, the split replacing reduced()'s, or None)
FAMILIES = {"vlm": (VISION, None), "vlm-x": (VISION, VFL_X),
            "audio": (AUDIO, None)}
F32_RTOL = 1e-5
ULPS = 2
BF16_ULP = 2.0 ** -7
LOSS_ATOL = 0.01
LOGIT_ATOL = 0.05
LONG_FRAMES = 3072             # past BLOCKWISE_THRESHOLD: the K9 route
B, S = 2, 16


def _cfgs(family):
    arch, split = FAMILIES[family]
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    if split is not None:
        jc = dataclasses.replace(jc, vfl=JVFLConfig(*split))
        tc = dataclasses.replace(tc, vfl=VFLConfig(*split))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_params(family):
    jc, _ = _cfgs(family)
    return jax.jit(lambda k: JV.init_all(k, jc))(jax.random.PRNGKey(0))


def _params(family, f32=False):
    """(jax tree, torch tree) drawn in JAX, bf16 or cast to fp32."""
    jp = _jax_params(family)
    if f32:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return jp, tree_to_torch(jax.tree_util.tree_map(np.asarray, jp))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _paths(tree):
    return [jax.tree_util.keystr(p, simple=True, separator=".")
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _rel(got, want, label, rtol):
    """|got - want| <= rtol of want's largest magnitude; -> the ratio."""
    got, want = _np(got), _np(want)
    dev = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"{label}: max |dev| {dev:.3g} ({dev / max(scale, 1e-30):.3g} "
          f"of the largest {scale:.3g}; limit {rtol:.3g})")
    assert dev <= rtol * scale, (label, dev, scale)
    return dev / max(scale, 1e-30)


def _within(got, want, label, dtype):
    rtol = F32_RTOL if dtype == "f32" else ULPS * BF16_ULP
    return _rel(got, want, label, rtol)


def _batches(family, kind="train", S_=S, B_=B, seed=1):
    jc, tc = _cfgs(family)
    jb = JSteps.concrete_batch(jc, JShapeConfig("t", S_, B_, kind), seed)
    tb = TSteps.concrete_batch(tc, ShapeConfig("t", S_, B_, kind), seed)
    return jb, tb


# --------------------------------------------------------------------------
# configs, layouts, trees
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_configs_copy_the_reference(arch):
    """Both ids are in the registry; full and reduced configs and their
    splits are the reference's, field for field."""
    assert arch in ARCH_IDS
    jc, tc = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for j, t in ((jc, tc), (jc.reduced(), tc.reduced())):
        assert dataclasses.asdict(t.vfl_split) == \
            dataclasses.asdict(j.vfl_split)
        assert t.resolved_head_dim == j.resolved_head_dim


@pytest.mark.parametrize("role", ["enc", "audio_dec", "vlm", "text"])
def test_tower_stages_match_reference(role):
    """Each role's layout for 1-12 layers, at the full and the reduced
    configs, and the three towers of every family's split."""
    arch = AUDIO if role in ("enc", "audio_dec") else VISION
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jget_config(arch).reduced(), get_config(arch).reduced())):
        for n in range(1, 13):
            assert TB.tower_stages(tc, n, role) == \
                JB.tower_stages(jc, n, role), (role, n)
    for family in FAMILIES:
        jc, tc = _cfgs(family)
        for part in ("a", "b", "top"):
            assert getattr(TV, f"stages_{part}")(tc) == \
                getattr(JV, f"stages_{part}")(jc)
    assert TV.stages_b(_cfgs("vlm")[1]) == [(("dense",), 1)]
    assert TV.stages_b(_cfgs("vlm-x")[1]) == [(("dense", "cross"), 1)]


@pytest.mark.parametrize("geometry", ["reduced", "vlm-x", "full"])
def test_parameter_trees_and_leaf_order(geometry):
    """The port's own init draws every leaf of the reference's tree at
    its path, shape and dtype (full width on the meta device; the vision
    config cut to 10 layers as the chip smoke serves it), and a party's
    ``reference_parameters`` list runs in JAX's leaf order: seamless
    11 + 31 leaves, the 10-layer vision config 2 + 103."""
    counts = {}
    for arch in (VISION, AUDIO):
        jc, tc = jget_config(arch), get_config(arch)
        if geometry == "reduced":
            jc, tc = jc.reduced(), tc.reduced()
        elif geometry == "vlm-x":
            jc, tc = _cfgs("vlm-x") if arch == VISION else \
                (jc.reduced(), tc.reduced())
        elif arch == VISION:
            jc = dataclasses.replace(jc, vfl=JVFLConfig(0, 5, 5,
                                                        "cross_attn"))
            tc = dataclasses.replace(tc, vfl=VFLConfig(0, 5, 5,
                                                       "cross_attn"))
        tp = TV.init_all(0, tc) if geometry != "full" else \
            TBudget._param_shapes(tc)
        jp = jax.eval_shape(lambda: JV.init_all(jax.random.PRNGKey(0), jc))

        def desc(tree):
            return [(p, tuple(s.shape), str(s.dtype).replace("torch.", ""))
                    for p, s in zip(_paths(tree),
                                    jax.tree_util.tree_leaves(tree))]
        assert desc(jp) == desc(tp)
        for party in ("a", "b"):
            names = [n for n, _ in sorted(
                TV.PartyParams(tp[party]).named_parameters(),
                key=lambda kv: path_key(kv[0]))]
            assert names == _paths(jp[party])
        counts[arch] = tuple(len(_paths(jp[p])) for p in ("a", "b"))
    print(f"{geometry}: leaves a party {counts}")
    if geometry == "full":
        assert counts == {AUDIO: (11, 31), VISION: (2, 103)}
    assert "fuse_proj" not in _paths(jp["b"])


def test_bridge_carries_cross_trees_bitwise():
    """Every leaf of the vlm (with cross layers: the super-block's b0, b1
    keys) and audio trees crosses bitwise, bf16 through int16."""
    for family in ("vlm-x", "audio"):
        jp, tp = _params(family)
        for party in ("a", "b"):
            pp = TV.PartyParams(tp[party])
            for a, b in zip(jax.tree_util.tree_leaves(jp[party]),
                            reference_parameters(pp)):
                assert str(a.dtype) == str(b.dtype).replace("torch.", "")
                np.testing.assert_array_equal(
                    np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                    else np.asarray(a),
                    b.detach().view(torch.int16).numpy().view(np.uint16)
                    if b.dtype == torch.bfloat16 else b.detach().numpy())


@pytest.mark.parametrize("family", ["vlm", "audio"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_batches_match_reference(family, kind):
    """``batch_specs`` keys in the reference's order with its shapes and
    dtypes; ``concrete_batch`` bitwise from one seed (S = 32, so the
    audio batch has 8 frames)."""
    jc, tc = _cfgs(family)
    js = JSteps.batch_specs(jc, JShapeConfig("t", 32, 3, kind))
    ts = TSteps.batch_specs(tc, ShapeConfig("t", 32, 3, kind))
    assert list(js) == list(ts)
    for k in js:
        assert tuple(js[k].shape) == ts[k][0]
        assert ("float" in str(js[k].dtype)) == ts[k][1].is_floating_point
    jb, tb = _batches(family, kind, S_=32, B_=3, seed=7)
    assert list(jb) == list(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
    assert tb.get("frames", tb.get("patches")).shape[1] == (
        32 // tc.audio_downsample if family == "audio" else tc.n_patches)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def _xattn(dtype):
    """The cross layer's xattn parameters (vlm-x, bottom tower): (jax,
    torch), bf16 or fp32."""
    jp, tp = _params("vlm-x", f32=dtype == "f32")
    return (jax.tree_util.tree_map(lambda t: t[0],
                                   jp["b"]["bottom"][0]["b1"]["xattn"]),
            TB.layer(tp["b"]["bottom"][0], 0)["b1"]["xattn"])


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rope", ["none", "queries", "both"])
def test_cross_attention_apply_matches_reference(dtype, rope):
    """``attention_apply(memory=...)``: 12 queries against a memory of 20,
    through the dense ``_sdpa`` with no mask; no rotary embedding (the
    cross block's), on the queries only, or on both with the memory's
    positions."""
    jw, tw = _xattn(dtype)
    jx, tx = _x((2, 12, 128), dtype, 1)
    jm, tm = _x((2, 20, 128), dtype, 2)
    pos, mpos = np.arange(12, dtype=np.int32), np.arange(20, dtype=np.int32)
    kw = dict(use_rope=rope != "none")
    jkw, tkw = dict(kw), dict(kw)
    if rope == "both":
        jkw["memory_positions"] = jnp.asarray(mpos)
        tkw["memory_positions"] = torch.from_numpy(mpos)
    got = TL.attention_apply(tw, tx, positions=torch.from_numpy(pos),
                             memory=tm, **tkw)
    want = JL.attention_apply(jw, jx, positions=jnp.asarray(pos),
                              memory=jm, **jkw)
    assert tuple(got.shape) == (2, 12, 128)
    _within(got, want, f"cross attention_apply {dtype} rope={rope}", dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_memory_kv_and_cross_decode_match_reference(dtype):
    """``project_memory_kv`` and ``cross_attention_decode`` of one token
    against it (no rotary embedding on the query, as in the
    reference)."""
    jw, tw = _xattn(dtype)
    jm, tm = _x((2, 20, 128), dtype, 3)
    jx, tx = _x((2, 1, 128), dtype, 4)
    jkv, tkv = JL.project_memory_kv(jw, jm), TL.project_memory_kv(tw, tm)
    for k in ("k", "v"):
        assert tuple(tkv[k].shape) == (2, 20, 2, 32)
        _within(tkv[k], jkv[k], f"project_memory_kv {k} {dtype}", dtype)
    _within(TL.cross_attention_decode(tw, tx, tkv),
            JL.cross_attention_decode(jw, jx, jkv),
            f"cross_attention_decode {dtype}", dtype)


@pytest.mark.parametrize("frames", [16, LONG_FRAMES])
def test_encoder_block_matches_reference(frames):
    """The audio encoder's ``enc`` block (bidirectional attention) over
    16 frames (dense ``_sdpa`` on both sides) and over 3,072: the
    reference's blockwise path with ``causal=False`` against the port's
    K9 route with no mask (its plain version here)."""
    jp, tp = _params("audio")
    jc, tc = _cfgs("audio")
    jblk = jax.tree_util.tree_map(lambda t: t[0], jp["a"]["tower"][0]["b0"])
    tblk = TB.layer(tp["a"]["tower"][0], 0)["b0"]
    jx, tx = _x((1, frames, 128), "bf16", frames)
    pos = np.arange(frames, dtype=np.int32)
    jy, _ = jax.jit(lambda p, x: JB.block_apply_full(p, x, "enc", JB.Ctx(
        jc, positions=jnp.asarray(pos), causal=False)))(jblk, jx)
    ty, _ = TB.block_apply_full(tblk, tx, "enc", TB.Ctx(
        tc, positions=torch.from_numpy(pos), causal=False))
    _within(ty, jy, f"enc block over {frames} frames", "bf16")
    # bidirectional: the first frame's output depends on the last frame
    tx2 = tx.clone()
    tx2[:, -1] += 1.0
    ty2, _ = TB.block_apply_full(tblk, tx2, "enc", TB.Ctx(
        tc, positions=torch.from_numpy(pos), causal=False))
    assert not torch.equal(ty2[:, 0], ty[:, 0])


# --------------------------------------------------------------------------
# the split model: forward, loss, gradients, train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_forward_a_matches_reference(family):
    """Z_A: the projector (its SiLU in fp32, cast to bf16) or the
    encoder and its final RMSNorm, on fp32 and on bf16 parameters."""
    jc, tc = _cfgs(family)
    jb, tb = _batches(family, "prefill")
    for f32 in (True, False):
        jp, tp = _params(family, f32=f32)
        jz = jax.jit(lambda p: JV.forward_a(p, jc, jb))(jp["a"])
        tz = TV.forward_a(tp["a"], tc, tb)
        assert tuple(tz.shape) == tuple(jz.shape)
        assert tz.dtype == (torch.float32 if f32 else torch.bfloat16)
        _within(tz, jz, f"{family} Z_A {'fp32' if f32 else 'bf16'}",
                "f32" if f32 else "bf16")


def _capture_grads():
    """An optimizer that records the gradients a train step gives it, in
    the order it gives them, and applies zero updates."""
    from repro_torch.optim import Optimizer
    seen = []

    def update(grads, state, params=None):
        seen.append([g.detach() for g in grads])
        return [0.0 * g for g in grads], state
    return Optimizer(lambda p: {}, update), seen


@pytest.mark.parametrize("family", list(FAMILIES))
def test_joint_loss_and_gradients_match_reference(family):
    """The gradients a ``make_train_step`` hands its optimizer (remat on;
    the list in JAX's leaf order) against ``jax.grad`` of the joint loss
    on fp32 parameters, every leaf within F32_RTOL of its largest
    magnitude, the loss too; the bf16 joint loss within LOSS_ATOL.
    Party A's gradient is non-zero wherever a cross layer reads Z_A, and
    zero in the reduced vlm config, which has none (in the reference
    too: the port's step gives those leaves zeros, as ``jax.grad``
    does)."""
    jc, tc = _cfgs(family)
    jb, tb = _batches(family)
    jp, tp = _params(family, f32=True)
    # op by op: under jit XLA may round the projector's bf16 cast of
    # ∇h otherwise, which moves proj1's gradient by 2e-5 of its largest
    jl, jg = jax.value_and_grad(
        lambda p: JV.joint_loss(p, jc, jb, train=True))(jp)
    paths = _paths(jg)
    opt, seen = _capture_grads()
    _, _, tl = TSteps.make_train_step(tc, opt)(TV.PartyParams(tp), {}, tb)
    tg = seen[0]
    print(f"{family} fp32 joint loss {float(jl):.7f} / {float(tl):.7f}")
    assert abs(float(tl) - float(jl)) <= F32_RTOL * abs(float(jl))
    assert len(tg) == len(paths)
    worst = 0.0
    for p, a, b in zip(paths, jax.tree_util.tree_leaves(jg), tg):
        a, b = np.asarray(a), b.numpy()
        scale = float(np.abs(a).max())
        dev = float(np.abs(a - b).max())
        worst = max(worst, dev / max(scale, 1e-30))
        assert dev <= F32_RTOL * scale, (p, dev, scale)
    a_norm = [float(np.abs(np.asarray(g)).sum()) for p, g in
              zip(paths, jax.tree_util.tree_leaves(jg)) if p[0] == "a"]
    t_norm = [float(g.abs().sum()) for p, g in zip(paths, tg)
              if p[0] == "a"]
    print(f"{family}: {len(tg)} fp32 gradient leaves within {worst:.3g} of "
          f"their largest (limit {F32_RTOL}); |grad A|_1 per leaf "
          f"{[float(f'{x:.4g}') for x in a_norm]} / "
          f"{[float(f'{x:.4g}') for x in t_norm]}")
    if family == "vlm":
        assert sum(a_norm) == 0.0 and sum(t_norm) == 0.0
    else:
        assert all(x > 0.0 for x in t_norm)
    jp16, tp16 = _params(family)
    jl16 = float(jax.jit(lambda p: JV.joint_loss(p, jc, jb, train=True))(
        jp16))
    with torch.no_grad():
        tl16 = float(TV.joint_loss(tp16, tc, tb, train=True))
    print(f"{family} bf16 joint loss {jl16:.6f} / {tl16:.6f} (limit "
          f"{LOSS_ATOL})")
    assert abs(tl16 - jl16) <= LOSS_ATOL


@pytest.mark.parametrize("family", ["vlm-x", "audio"])
def test_train_step_matches_reference(family):
    """One ``make_train_step`` on bf16 parameters (joint loss, AdaGrad lr
    0.01 through the kernel route, its plain version here) against the
    reference's: the loss within LOSS_ATOL, and every parameter within 4
    bf16 ulps of its leaf's largest magnitude of the reference's updated
    one but for a counted few, under 1 %.  An AdaGrad first step moves a
    coordinate by lr g / (|g| + eps), ±lr but where |g| is near eps
    (1e-10): where a gradient near zero differs in sign or size between
    the two sides (a query projection of a cross layer reads 1.1e-10 on
    one side, 3.3e-7 on the other), their steps part by up to 2 lr."""
    jc, tc = _cfgs(family)
    jb, tb = _batches(family, seed=5)
    jp, tp = _params(family)
    jopt = jmake_optimizer("adagrad", 0.01)
    jnew, _, jl = jax.jit(JSteps.make_train_step(jc, jopt))(
        jp, jopt.init(jp), jb)
    opt = make_optimizer("adagrad", 0.01, use_pallas=True)
    pp = TV.PartyParams(tp)
    state = opt.init(reference_parameters(pp))
    _, state, tl = TSteps.make_train_step(tc, opt)(pp, state, tb)
    print(f"{family} train step (bf16): loss {float(jl):.6f} / "
          f"{float(tl):.6f} (limit {LOSS_ATOL})")
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    apart = total = 0
    for a, b in zip(jax.tree_util.tree_leaves(jnew),
                    reference_parameters(pp)):
        a, b = np.asarray(a, np.float32), b.detach().float().numpy()
        apart += int((np.abs(a - b) > 4 * BF16_ULP * np.abs(a).max()).sum())
        total += a.size
    print(f"{family} train step: {apart} of {total} coordinates stepped "
          f"otherwise than the reference's")
    assert apart <= total // 100


# --------------------------------------------------------------------------
# serving: prefill, decode, naive_generate, the CLI
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _teacher_forced(family, S_=16, steps=5):
    """Prefill and ``steps`` decode steps on both sides, each fed the
    reference's greedy token -> (logits max |dev| per step, the
    reference's greedy tokens, their top-1 margins, the port's argmax
    tokens), as tuples."""
    jc, tc = _cfgs(family)
    jp, tp = _params(family)
    jb, tb = _batches(family, "prefill", S_=S_, B_=1, seed=11)
    jprefill, jdecode = jmake_naive_fns(jc, S_ + steps)
    jl, jcache = jprefill(jp, jb)
    tl, tcache = TV.prefill(tp, tc, tb, S_ + steps)
    assert "a" not in tcache
    devs, jtok, margins, ttok = [], [], [], []
    for i in range(steps + 1):
        jrow, trow = _np(jl)[0, -1], _np(tl)[0, -1]
        devs.append(float(np.abs(jrow - trow).max()))
        top2 = np.sort(jrow)[-2:]
        margins.append(float(top2[1] - top2[0]))
        jtok.append(int(np.argmax(jrow)))
        ttok.append(int(np.argmax(trow)))
        if i == steps:
            break
        tok = jtok[-1]
        jl, jcache = jdecode(jp, jcache,
                             {"token": jnp.array([[tok]], jnp.int32)},
                             jnp.int32(S_ + i))
        tl, tcache = TV.decode_step(tp, tc, tcache,
                                    {"token": torch.tensor([[tok]])}, S_ + i)
    return tuple(devs), tuple(jtok), tuple(margins), tuple(ttok)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_match_reference(family):
    """Prefill (the memory's K / V written into every cross layer's
    ``xmem``) and five decode steps on Party B alone, both fed the
    reference's greedy tokens: logits within LOGIT_ATOL each step, the
    port's argmax equal to the reference's wherever its top-1 margin
    exceeds 2 LOGIT_ATOL; the port's empty serve cache has the
    prefill's layout, and the reference's paths."""
    devs, jtok, margins, ttok = _teacher_forced(family)
    wide = [i for i, m in enumerate(margins) if m > 2 * LOGIT_ATOL]
    print(f"{family}: prefill and 5 decode steps, logits max |dev| "
          f"{[float(f'{d:.3g}') for d in devs]} (limit {LOGIT_ATOL}); "
          f"{len(wide)} of 6 greedy tokens past the margin, all equal")
    assert max(devs) <= LOGIT_ATOL and len(wide) >= 2
    assert all(ttok[i] == jtok[i] for i in wide)
    jc, tc = _cfgs(family)
    _, tp = _params(family)
    _, tb = _batches(family, "prefill", S_=16, B_=1)
    _, caches = TV.prefill(tp, tc, tb, 20)
    mem = tb["frames" if family == "audio" else "patches"].shape[1]
    empty = TV.make_serve_cache(tc, 1, 20, memory_len=mem)
    assert _paths(empty) == _paths(caches)
    for a, b in zip(jax.tree_util.tree_leaves(empty),
                    jax.tree_util.tree_leaves(caches)):
        assert a.shape == b.shape and a.dtype == b.dtype
    jcache = jax.eval_shape(lambda: JV.make_serve_cache(jc, 1, 20, mem))
    assert _paths(jcache) == _paths(empty)


@pytest.mark.parametrize("family", ["vlm-x", "audio"])
def test_naive_generate_matches_reference(family):
    """``naive_generate`` (no ``token_a`` for these families) against the
    reference's: the tokens equal up to the first step whose reference
    top-1 margin is within 2 LOGIT_ATOL (from the teacher-forced run
    above, which feeds both sides the reference's greedy tokens), the
    rest counted."""
    jc, tc = _cfgs(family)
    jp, tp = _params(family)
    jb, tb = _batches(family, "prefill", S_=16, B_=1, seed=11)
    gen = 6
    jt = np.asarray(jnaive_generate(jp, jc, jb, gen,
                                    fns=jmake_naive_fns(jc, 16 + gen)))[0]
    tt = naive_generate(tp, tc, tb, gen).numpy()
    assert tt.shape == (1, gen) and tt.dtype == np.int32
    _, jtok, margins, _ = _teacher_forced(family)
    assert tuple(jt.tolist()) == jtok    # the reference's own greedy run
    near = next((i for i, m in enumerate(margins)
                 if m <= 2 * LOGIT_ATOL), gen)
    same = tt[0] == jt
    print(f"{family}: naive_generate tokens {tt[0].tolist()} / reference "
          f"{jt.tolist()}: the first near-tie at step {near}; "
          f"{int(same[near:].sum())} of the {gen - near} after it equal")
    assert same[:near].all()


@pytest.mark.parametrize("arch", [VISION, AUDIO])
def test_cli_serves_cross_families_on_the_cpu(arch, capsys):
    """``launch/serve.py`` takes the cross-attention families through
    ``serve_naive`` (B = 1, one warm call, then the timed requests), the
    batch drawn as the reference's CLI draws it."""
    toks, stats = TServe.main(["--arch", arch, "--device", "cpu",
                               "--requests", "2", "--prompt-len", "8",
                               "--gen", "3"])
    assert tuple(toks.shape) == (1, 3) and len(stats["walls"]) == 2
    assert stats["tok_per_s"] > 0
    text = capsys.readouterr().out
    assert "sequential naive_generate loop" in text and "ms/token" in text
    cfg = get_config(arch).reduced()
    b = TServe.naive_batch(cfg, 8, 0, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        b["tokens"].numpy(), rng.integers(0, cfg.vocab_size, (1, 8),
                                          dtype=np.int32))
    key = "patches" if cfg.family == "vlm" else "frames"
    shape = (1, cfg.n_patches if cfg.family == "vlm" else 8, cfg.d_frontend)
    np.testing.assert_array_equal(
        b[key].numpy(), rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("family,kind", [("audio", "train"),
                                         ("audio", "serve"),
                                         ("vlm-x", "serve")])
def test_chip_smoke_launch_counts_are_the_calls(family, kind, monkeypatch):
    """``chip_smoke.py``'s cross phase holds its runs' kernel launches to
    counts derived from the model: ``_cross_step_launches`` for a train
    step (K9-LSE twice and K10 once in each long-path attention layer,
    a K7 table a 48 tensors) and ``_layers(cfg, frames) * (requests + 1)``
    K9 for ``serve_naive``, which counts the audio encoder's layers only
    past 2,048 frames (training batches carry S / 4 frames, serving
    prompts S).  Here the derivations must equal the calls of each
    kernel wrapper at 3,072 tokens."""
    from test_torch_llm_train import _count_kernel_calls
    calls, chip_smoke = _count_kernel_calls(monkeypatch)
    _, tc = _cfgs(family)
    _, tp = _params(family)
    S_ = 3072
    if kind == "train":
        pp = TV.PartyParams(tp)
        n = len(reference_parameters(pp))
        opt = make_optimizer("adagrad", 0.01, use_pallas=True)
        TSteps.make_train_step(tc, opt)(
            pp, opt.init(reference_parameters(pp)),
            TSteps.concrete_batch(tc, ShapeConfig("t", S_, 1, "train")))
        # a K7 call launches one kernel a table of ADAGRAD_LEAVES tensors
        calls["fused_adagrad"] *= -(-n // _cuda.ADAGRAD_LEAVES)
        want = chip_smoke._cross_step_launches(tc, S_, 1, n)
    else:
        args = TServe.build_parser().parse_args(
            ["--requests", "1", "--prompt-len", str(S_), "--gen", "2"])
        TServe.serve_naive(args, tc, tp)
        frames = S_ if family == "audio" else 0
        want = {"flash_attention": chip_smoke._layers(tc, frames) * 2}
    print(f"{family} {kind}: calls {dict(calls)}")
    assert {k: v for k, v in dict(calls).items() if v} == \
        {k: v for k, v in want.items() if v}
    assert want.get("flash_attention", 0) + want.get(
        "flash_attention_fwd_lse", 0) > 0
