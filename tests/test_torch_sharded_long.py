"""The sharded train step past 2,048 tokens: its attention takes the
flash route on each device's shard (``models/layers.py::_flash_local``,
``local_map`` over K9-LSE forward and K10 backward, their plain versions
on the CPU), and the step matches the same step on one device.

Two gloo ranks form a (1, 2) (data, model) mesh; smollm-360m's reduced
config (4 heads of 32, so two heads a rank) trains one AdaGrad step
(the kernel route, K7 on each shard) on fp32 parameters at B = 2,
S = 3,072 (a multiple of ``KV_BLOCK``).  Rank 0 also runs the step on
plain tensors.  The two differ by their sums' order alone, so the limits
are tight: the loss within ``LOSS_ATOL``, each leaf's AdaGrad accumulator
(its g²) within ``ACCUM_RTOL`` of its norm and its update within
``UPDATE_RTOL`` (as ``tests/test_torch_sharded.py`` sets them on fp32
parameters).  The test prints its largest deviations.
"""
import torch

from repro_torch.launch.dist import run_ranks

SEQ, BATCH = 3072, 2
LOSS_ATOL, ACCUM_RTOL, UPDATE_RTOL = 1e-5, 1e-4, 1e-2


def _rel(a, b):
    num, den = float((a - b).norm()), float(b.norm())
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t) \
        .detach().float()


def _rank(rank, world):
    from repro_torch.bridge import reference_parameters
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import vfl
    from repro_torch.optim import adagrad
    torch.set_num_threads(1)
    mesh = make_mesh((1, 2), ("data", "model"))
    cfg = get_config("smollm-360m").reduced()
    shape = ShapeConfig("long", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    batch = steps.concrete_batch(cfg, shape, seed=3)
    opt = adagrad(0.01, use_pallas=True)

    def fresh():
        return vfl.PartyParams(vfl.init_all(0, cfg)).float()
    calls = [0]
    flash_local = L._flash_local

    def counted(*a):
        calls[0] += 1
        return flash_local(*a)
    L._flash_local = counted
    params = steps.shard_params(fresh(), mesh)
    init = [_full(p).clone() for p in reference_parameters(params)]
    state = opt.init(reference_parameters(params))
    step = steps.make_sharded_train_step(cfg, opt, mesh)
    params, state, loss = step(params, state, steps.shard_batch(batch, mesh))
    L._flash_local = flash_local
    leaves = [_full(p) for p in reference_parameters(params)]
    accum = [_full(a) for a in state["accum"]]
    loss = float(loss.full_tensor())
    if rank:
        return None
    ref = fresh()
    rstate = opt.init(reference_parameters(ref))
    _, rstate, rloss = steps.make_train_step(cfg, opt)(ref, rstate, batch)
    rleaves = [p.detach().float() for p in reference_parameters(ref)]
    return {"loss": (loss, float(rloss)), "flash_local": calls[0],
            "accum_dev": [_rel(a, b.float()) for a, b in
                          zip(accum, rstate["accum"], strict=True)],
            "update_dev": [_rel(a - p0, b - p0) for a, b, p0 in
                           zip(leaves, rleaves, init, strict=True)]}


def test_sharded_long_step_matches_single_device():
    r = run_ranks(_rank, 2, backend="gloo")[0]
    sharded, single = r["loss"]
    accum, update = max(r["accum_dev"]), max(r["update_dev"])
    print(f"S = {SEQ}: loss {sharded} sharded, {single} on one device "
          f"(deviation {abs(sharded - single):.3g}, limit {LOSS_ATOL}); "
          f"largest relative deviation of a leaf's accumulator {accum:.3g} "
          f"(limit {ACCUM_RTOL}), of its update {update:.3g} (limit "
          f"{UPDATE_RTOL}); flash route on the shards {r['flash_local']} "
          f"times")
    # Party A's layer, Party B's bottom and top layers: each forward once
    # and once more under remat
    assert r["flash_local"] == 6
    assert abs(sharded - single) <= LOSS_ATOL
    assert accum <= ACCUM_RTOL and update <= UPDATE_RTOL
