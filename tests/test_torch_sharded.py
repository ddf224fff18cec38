"""The port's train step over a 2 × 2 (data, model) device mesh against
the same step on one device: the port's ``tests/test_sharded_execution.py``.

Four gloo ranks on the CPU (``launch.dist.run_ranks``) build the mesh,
place the parameters by ``sharding.rules.params_pspecs(...,
fsdp_axis="data")`` and the batch by ``batch_pspec`` as DTensors
(``launch.steps.shard_params`` / ``shard_batch``), and run one AdaGrad
train step (``launch.steps.make_sharded_train_step``); rank 0 also runs
the step on plain tensors.  As the model runs (bf16 parameters) the reference
test's limits hold: the loss within 5e-3 and every updated leaf within
0.05 (AdaGrad's first step moves a coordinate by ±lr whatever its
gradient's size, so a gradient that rounds to the other sign moves it
2·lr).  Those limits cannot see a step that applies no update, or the
loss, taken before it, a wrong gradient; so the same step also runs on
fp32 parameters, where each leaf's AdaGrad accumulator (its g²) and its
update are held to limits set from readings (``ACCUM_RTOL``,
``UPDATE_RTOL``).  Each case prints its largest deviations.  The world is
started once for the module; the cases read its results.

``granite-moe-3b-a800m``'s top-k expert dispatch runs through DTensor as
well; see CHANGES.md for the ops the step redistributes explicitly.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.dist import run_ranks

ARCHES = ["smollm-360m", "granite-moe-3b-a800m"]
# each arch as it runs (bf16 parameters) and on fp32 parameters
# on fp32 parameters the two steps differ by their sums' order alone:
# each leaf's accumulator (g² after the first step) within ACCUM_RTOL of
# its norm (measured: at most 1.9e-6), its update within UPDATE_RTOL
# (measured: at most 4.1e-4, from the few coordinates whose tiny gradient
# rounds to the other sign).  A step that drops or scales a gradient, or
# applies no update, is off by O(1) in one of the two.
ACCUM_RTOL, UPDATE_RTOL = 1e-4, 1e-2
CASES = [(arch, f32) for arch in ARCHES for f32 in (False, True)]


def _full(t):
    """A DTensor's (or a tensor's) whole value, fp32."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t) \
        .detach().float()


def _rel(a, b):
    """||a - b|| / ||b|| over one leaf (0 where both are zero)."""
    num, den = float((a - b).norm()), float(b.norm())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def _step_rank(rank, world):
    from repro_torch.bridge import reference_parameters
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import data_axes, make_mesh
    from repro_torch.models import vfl
    from repro_torch.optim import adagrad
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"))
    assert data_axes(mesh) == ("data",)
    shape = ShapeConfig("smoke", seq_len=64, global_batch=4, kind="train")
    out = {}
    for arch, f32 in CASES:
        cfg = get_config(arch).reduced()
        opt = adagrad(0.01, use_pallas=True)
        batch = steps.concrete_batch(cfg, shape, seed=1)

        def fresh():
            p = vfl.PartyParams(vfl.init_all(0, cfg))
            return p.float() if f32 else p
        params = steps.shard_params(fresh(), mesh)
        init = [_full(p).clone() for p in reference_parameters(params)]
        state = opt.init(reference_parameters(params))
        step = steps.make_sharded_train_step(cfg, opt, mesh)
        params, state, loss = step(params, state,
                                   steps.shard_batch(batch, mesh))
        leaves = [_full(p) for p in reference_parameters(params)]
        accum = [_full(a) for a in state["accum"]]
        loss = float(loss.full_tensor())
        if rank == 0:
            ref = fresh()
            rstate = opt.init(reference_parameters(ref))
            _, rstate, rloss = steps.make_train_step(cfg, opt)(ref, rstate,
                                                               batch)
            rleaves = [p.detach().float() for p in reference_parameters(ref)]
            out[arch, f32] = {
                "loss": (loss, float(rloss)),
                "leaf_dev": [float((a - b).abs().max())
                             for a, b in zip(leaves, rleaves, strict=True)],
                "accum_dev": [_rel(a, b.float()) for a, b in
                              zip(accum, rstate["accum"], strict=True)],
                "update_dev": [_rel(a - p0, b - p0) for a, b, p0 in
                               zip(leaves, rleaves, init, strict=True)],
                "placed": [[type(q).__name__ for q in p.placements]
                           for p in reference_parameters(params)]}
    return out


@pytest.fixture(scope="module")
def world():
    return run_ranks(_step_rank, 4, backend="gloo")[0]


@pytest.mark.parametrize("arch", ARCHES)
def test_sharded_matches_single_device(arch, world):
    r = world[arch, False]
    sharded, single = r["loss"]
    worst = max(r["leaf_dev"])
    accum, update = max(r["accum_dev"]), max(r["update_dev"])
    print(f"{arch}: loss {sharded} sharded, {single} on one device "
          f"(deviation {abs(sharded - single):.3g}); largest leaf "
          f"deviation {worst:.3g}; largest relative deviation of a leaf's "
          f"accumulator {accum:.3g}, of its update {update:.3g}")
    assert np.isfinite(sharded)
    assert abs(sharded - single) < 5e-3
    assert worst < 0.05
    # the rules did shard leaves over model (the reduced leaves are below
    # the fsdp rule's 2^20 elements, so none shards over data)
    assert any(p[1] == "Shard" for p in r["placed"])


@pytest.mark.parametrize("arch", ARCHES)
def test_sharded_step_gradients_match_on_fp32_parameters(arch, world):
    r = world[arch, True]
    sharded, single = r["loss"]
    accum, update = max(r["accum_dev"]), max(r["update_dev"])
    print(f"{arch} fp32: loss deviation {abs(sharded - single):.3g}; "
          f"largest relative deviation of a leaf's accumulator {accum:.3g} "
          f"(limit {ACCUM_RTOL}), of its update {update:.3g} (limit "
          f"{UPDATE_RTOL}); largest leaf deviation {max(r['leaf_dev']):.3g}")
    assert accum <= ACCUM_RTOL and update <= UPDATE_RTOL
