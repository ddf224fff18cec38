"""The port's LLM split model (dense family) against the reference.

``repro_torch.models`` (layers, backbone, vfl) runs beside
``repro.models`` at reduced smollm-360m geometry (2 layers split 1 / 1 /
1, d 128, 4 query and 2 KV heads of dim 32) on parameters drawn in JAX
and brought across bitwise (``bridge.tree_to_torch``).  Both sides
compute in bf16 with fp32 norms, rotary angles and softmax, at the same
cast points, but their bf16 matrix products sum in other orders, so a
product may round to the neighbouring bf16 value.  Tolerances, each a
few times the largest deviation measured here:

  * a layer's bf16 output: ``ULPS`` bf16 ulps of its largest magnitude;
  * logits (fp32, |logit| <= ~2.5 after four bf16 layers): ``LOGIT_ATOL``
    (measured: 0.0176);
  * greedy tokens: equal wherever the reference's top-1 margin exceeds
    twice ``LOGIT_ATOL``.

Past 2,048 tokens the reference runs its blockwise online-softmax path,
which rounds the score product to bf16; the port runs K9 (its plain
version here), which takes it in fp32.  That rounding is measured at
S = 3,072 below.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import backbone as JB
from repro.models import layers as JL
from repro.models import vfl as JV
from repro_torch.bridge import tree_to_torch
from repro_torch.configs import ARCH_IDS, LATER_ARCH_IDS, get_config
from repro_torch.models import backbone as TB
from repro_torch.models import layers as TL
from repro_torch.models import vfl as TV

torch.set_num_threads(1)

JCFG = jget_config("smollm-360m").reduced()
CFG = get_config("smollm-360m").reduced()
ULPS = 2
LOGIT_ATOL = 0.05
LONG_S = 3072                     # past BLOCKWISE_THRESHOLD: the K9 route


@pytest.fixture(scope="module")
def params():
    jp = JV.init_all(jax.random.PRNGKey(0), JCFG)
    return jp, tree_to_torch(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module")
def block(params):
    """Layer 0 of Party B's bottom tower: (jax tree, torch tree)."""
    jp, tp = params
    return (jax.tree_util.tree_map(lambda t: t[0], jp["b"]["bottom"][0]["b0"]),
            TB.layer(tp["b"]["bottom"][0], 0)["b0"])


def tree_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays (bf16 as
    float32, which holds it exactly)."""
    return TB.tree_map(lambda t: t.detach().float().numpy()
                       if t.dtype == torch.bfloat16 else t.numpy(), tree)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def _x(S, seed=0):
    x = np.random.default_rng(seed).standard_normal((1, S, CFG.d_model))
    x = x.astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def _within_ulps(got, want, label):
    got, want = _np(got), _np(want)
    dev = float(np.abs(got - want).max())
    lim = ULPS * 2.0 ** -7 * float(np.abs(want).max())
    print(f"{label}: max |dev| {dev:.3g} (limit {lim:.3g})")
    assert dev <= lim, (label, dev, lim)


def _tokens(S, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, CFG.vocab_size, (1, S)).astype(np.int32)
    tok_a = rng.integers(0, CFG.aux_vocab_size, (1, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok), "tokens_a": jnp.asarray(tok_a)},
            {"tokens": torch.from_numpy(tok),
             "tokens_a": torch.from_numpy(tok_a)})


def _logits_close(jl, tl, label):
    dev = float(np.abs(_np(jl) - _np(tl)).max())
    print(f"{label}: logits max |dev| {dev:.3g} (limit {LOGIT_ATOL})")
    assert dev <= LOGIT_ATOL, (label, dev)
    return dev


# --------------------------------------------------------------------------
# configs and bridge
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_llm_configs_copy_the_reference(arch):
    j, t = dataclasses.asdict(jget_config(arch)), \
        dataclasses.asdict(get_config(arch))
    if arch == "smollm-360m":          # the port names the model's source
        assert t.pop("source") == "hf:HuggingFaceTB/SmolLM-360M"
        j.pop("source")
    assert t == j
    jr, tr = jget_config(arch).reduced(), get_config(arch).reduced()
    assert dataclasses.asdict(tr.vfl_split) == \
        dataclasses.asdict(jr.vfl_split)
    assert (tr.padded_vocab, tr.resolved_head_dim) == \
        (jr.padded_vocab, jr.resolved_head_dim)


def test_bridge_is_bitwise_for_bf16(params):
    jp, tp = params
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_t = jax.tree_util.tree_leaves(tree_to_numpy(tp))
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    emb = tp["b"]["embed"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jp["b"]["embed"]).view(np.uint16),
        emb.view(torch.int16).numpy().view(np.uint16))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_rmsnorm_matches_reference(block):
    jb, tb = block
    jx, tx = _x(16)
    _within_ulps(TL.rmsnorm(tb["ln1"], tx), JL.rmsnorm(jb["ln1"], jx),
                 "rmsnorm")


@pytest.mark.parametrize("pos_kind", ["1d", "2d"])
def test_rope_matches_reference(block, pos_kind):
    jb, tb = block
    jx, tx = _x(16)
    jq = jnp.einsum("bsd,dhk->bshk", jx, jb["attn"]["wq"])
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        torch.bfloat16)
    pos = np.arange(16, dtype=np.int32) + 5
    if pos_kind == "2d":
        pos = pos[None]
    _within_ulps(TL.rope(tq, torch.from_numpy(pos)),
                 JL.rope(jq, jnp.asarray(pos)), f"rope {pos_kind}")


@pytest.mark.parametrize("S", [16, LONG_S])
def test_attention_apply_matches_reference(block, S):
    """S = 16: the dense ``_sdpa`` on both sides.  S = 3,072: the
    reference's blockwise path (bf16 scores) against K9's route (fp32
    scores)."""
    jb, tb = block
    jx, tx = _x(S, seed=S)
    pos = np.arange(S, dtype=np.int32)
    _within_ulps(TL.attention_apply(tb["attn"], tx,
                                    positions=torch.from_numpy(pos)),
                 JL.attention_apply(jb["attn"], jx,
                                    positions=jnp.asarray(pos)),
                 f"attention_apply S={S}")


def test_long_attention_needs_whole_kv_blocks(block):
    _, tb = block
    _, tx = _x(LONG_S + 64)
    with pytest.raises(ValueError, match="multiple of 1024"):
        TL.attention_apply(tb["attn"], tx,
                           positions=torch.arange(LONG_S + 64))


def test_mlp_matches_reference(block):
    jb, tb = block
    jx, tx = _x(16)
    _within_ulps(TL.mlp_apply(tb["ffn"], tx), JL.mlp_apply(jb["ffn"], jx),
                 "mlp_apply")


@pytest.mark.parametrize("window", [0, 5])
def test_attention_decode_matches_reference(block, window):
    """One token against a ring filled by ``block_prefill`` on each side;
    the port's cache, updated in place, holds what the reference's new
    cache holds."""
    jb, tb = block
    S, cap = 8, 12
    jx, tx = _x(S)
    cfg_j = dataclasses.replace(JCFG, sliding_window=window)
    cfg_t = dataclasses.replace(CFG, sliding_window=window)
    pos = np.arange(S, dtype=np.int32)
    _, _, jc = JB.block_prefill(jb, jx, "dense",
                                JB.Ctx(cfg_j, positions=jnp.asarray(pos),
                                       window=window), cap)
    _, _, tc = TB.block_prefill(tb, tx, "dense",
                                TB.Ctx(cfg_t, positions=torch.from_numpy(pos),
                                       window=window), cap)
    for k in ("k", "v"):
        _within_ulps(tc["attn"][k][0], jc["attn"][k][0], f"prefill {k}")
    np.testing.assert_array_equal(tc["attn"]["slot_pos"][0].numpy(),
                                  np.asarray(jc["attn"]["slot_pos"]))
    jh, th = _x(1, seed=7)
    jo, jcache = JL.attention_decode(jb["attn"], jh, jc["attn"],
                                     jnp.int32(S), window=window)
    to, tcache = TL.attention_decode(tb["attn"], th, tc["attn"], S,
                                     window=window)
    assert tcache is tc["attn"]
    _within_ulps(to, jo, f"attention_decode window={window}")
    _within_ulps(tcache["k"][0], jcache["k"][0], "decode k cache")
    np.testing.assert_array_equal(tcache["slot_pos"][0].numpy(),
                                  np.asarray(jcache["slot_pos"]))


def test_decode_positions_per_row(block):
    """Rows at different positions decode as each would alone: the lane
    batch of the serving engine."""
    _, tb = block
    S, cap = 8, 12
    _, tx = _x(S)
    ctx = TB.Ctx(CFG, positions=torch.arange(S, dtype=torch.int32))
    _, _, c1 = TB.block_prefill(tb, tx, "dense", ctx, cap)
    two = TB.tree_map(lambda t: torch.cat([t, t]), c1)
    _, th = _x(1, seed=3)
    h2 = torch.cat([th, th])
    pos = torch.tensor([S, S + 2], dtype=torch.int32)
    out, _ = TL.attention_decode(tb["attn"], h2, two["attn"], pos)
    for row, p in enumerate((S, S + 2)):
        one = TB.tree_map(lambda t: t.clone(), c1)
        o1, _ = TL.attention_decode(tb["attn"], th, one["attn"], p)
        torch.testing.assert_close(out[row:row + 1], o1, atol=0, rtol=0)
        slot = p % cap
        assert int(two["attn"]["slot_pos"][row, slot]) == p


# --------------------------------------------------------------------------
# the split model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("S", [8, LONG_S])
def test_prefill_matches_reference(params, S):
    jp, tp = params
    jb, tb = _tokens(S)
    jl, jc = JV.prefill(jp, JCFG, jb, S + 4)
    tl, tc = TV.prefill(tp, CFG, tb, S + 4)
    _logits_close(jl, tl, f"prefill S={S}")
    for part in ("a", "b", "top"):
        _within_ulps(tc[part][0]["b0"]["attn"]["k"],
                     jc[part][0]["b0"]["attn"]["k"], f"cache {part} k")


def test_prefill_halves_compose_bitexact(params):
    _, tp = params
    _, tb = _tokens(8)
    logits, caches = TV.prefill(tp, CFG, tb, 12)
    z, cache_a = TV.prefill_a(tp["a"], CFG, tb, 12)
    logits2, caches_b = TV.prefill_b(tp["b"], CFG, z, tb, 12)
    assert torch.equal(logits, logits2)
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(caches["a"])),
                    jax.tree_util.tree_leaves(tree_to_numpy(cache_a))):
        np.testing.assert_array_equal(a, b)
    za = TV.forward_a(tp["a"], CFG, tb)
    assert torch.equal(za, z)


def test_forward_b_matches_reference(params):
    jp, tp = params
    jb, tb = _tokens(8)
    jz = JV.forward_a(jp["a"], JCFG, jb)
    tz = TV.forward_a(tp["a"], CFG, tb)
    _within_ulps(tz, jz, "forward_a")
    jl, _ = JV.forward_b(jp["b"], JCFG, jz, jb)
    tl, _ = TV.forward_b(tp["b"], CFG, tz, tb)
    _logits_close(jl, tl, "forward_b")


def test_decode_halves_compose_bitexact(params):
    _, tp = params
    _, tb = _tokens(8)
    _, caches = TV.prefill(tp, CFG, tb, 12)
    clone = TB.tree_map(lambda t: t.clone(), caches)
    sb = {"token": torch.tensor([[3]], dtype=torch.int32),
          "token_a": torch.tensor([[5]], dtype=torch.int32)}
    logits, _ = TV.decode_step(tp, CFG, caches, sb, 8)
    z_t, _ = TV.decode_step_a(tp["a"], CFG, clone["a"], sb["token_a"], 8)
    logits2, _ = TV.decode_step_b(tp["b"], CFG, clone, sb["token"], z_t, 8)
    assert torch.equal(logits, logits2)


@pytest.mark.parametrize("S", [8, LONG_S])
def test_teacher_forced_decode_matches_reference(params, S):
    """Six decode steps, both sides fed the reference's greedy tokens:
    logits within LOGIT_ATOL every step, and the port's argmax equal to
    the reference's wherever its top-1 margin exceeds 2·LOGIT_ATOL."""
    jp, tp = params
    jb, tb = _tokens(S, seed=2)
    jl, jc = JV.prefill(jp, JCFG, jb, S + 8)
    tl, tc = TV.prefill(tp, CFG, tb, S + 8)
    checked = 0
    for i in range(7):
        jrow, trow = _np(jl)[0, -1], _np(tl)[0, -1]
        _logits_close(jl, tl, f"S={S} step {i}")
        top2 = np.sort(jrow)[-2:]
        if top2[1] - top2[0] > 2 * LOGIT_ATOL:
            assert int(np.argmax(trow)) == int(np.argmax(jrow)), i
            checked += 1
        tok = int(np.argmax(jrow))
        jsb = {"token": jnp.array([[tok]], jnp.int32),
               "token_a": jnp.array([[tok % JCFG.aux_vocab_size]],
                                    jnp.int32)}
        tsb = {k: torch.from_numpy(np.array(v)) for k, v in jsb.items()}
        jl, jc = JV.decode_step(jp, JCFG, jc, jsb, jnp.int32(S + i))
        tl, tc = TV.decode_step(tp, CFG, tc, tsb, S + i)
    print(f"S={S}: {checked} of 7 greedy tokens past the margin, all equal")
    assert checked >= 3


def test_init_all_shapes_match_reference():
    """The port's own init draws every leaf of the reference's tree, at
    the reference's shapes and dtypes."""
    jp = jax.eval_shape(lambda: JV.init_all(jax.random.PRNGKey(0), JCFG))
    tp = TV.init_all(0, CFG)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(
        TB.tree_map(lambda t: jax.ShapeDtypeStruct(
            tuple(t.shape), jnp.bfloat16 if t.dtype == torch.bfloat16
            else t.dtype), tp))
    assert [(jax.tree_util.keystr(p), s.shape, s.dtype) for p, s in jl] == \
        [(jax.tree_util.keystr(p), s.shape, s.dtype) for p, s in tl]


@pytest.mark.parametrize("arch", sorted(LATER_ARCH_IDS))
def test_other_families_name_their_slice(arch):
    assert jget_config(arch).family != "dense"
    with pytest.raises(NotImplementedError, match="slice 7c"):
        get_config(arch)


@pytest.mark.parametrize("family", ["moe", "hybrid", "ssm", "vlm", "audio"])
def test_towers_refuse_other_families(family):
    """A config of another family built by hand is refused where the
    towers are laid out, before any parameter is drawn."""
    cfg = dataclasses.replace(CFG, family=family)
    with pytest.raises(NotImplementedError, match="slice 7c"):
        TV.init_all(0, cfg)


def test_make_serve_cache_matches_prefill_layout(params):
    _, tp = params
    _, tb = _tokens(8)
    _, caches = TV.prefill(tp, CFG, tb, 12)
    empty = TV.make_serve_cache(CFG, 1, 12)
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(caches)),
                    jax.tree_util.tree_leaves(tree_to_numpy(empty))):
        assert a.shape == b.shape and a.dtype == b.dtype
