"""A run whose timed path is broken underneath reads ``correct`` false.

Each test drives the harness's run on the CPU, past the look for a chip,
at a size a test holds, with the cell's own limits, and plants one fault
that a training cell can have: a step that leaves its state unchanged,
Party B's loss over half of each batch's tokens, and Party A's local
cotangent not scaled by its gate weight.  The controls (the
reference put in the program's place, in bf16 throughout on the card at
the cell's size, with float8 products here) are held to the same
limits.  One chip runs no exchange between chips, so that fault has
no place here."""
import pytest
import torch

from bench import check, harness, specs, tiny
from bench import traffic as Tr
from bench.reference import reading

CELLS = ("smollm-360m.s2k", "granite-moe-3b-a800m.s4k")
SEED = 2 ** 31 + 211


def _limits(cell_name):
    limits = specs.load_cell(cell_name)["limits"]
    assert any(v is not None for v in limits.values()), limits
    return limits


def _run(cell_name):
    cell = tiny.tiny_cell(cell_name, limits=_limits(cell_name))
    return harness.run_cell(cell, SEED, 0.0, trace=False, device="cpu")


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_step_that_leaves_its_state_unchanged(cell_name, monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "fused_adagrad_step_",
                        lambda *args, **kw: None)
    out = _run(cell_name)
    assert out["correct"] is False
    assert out["checks"]["grad_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell_name", CELLS)
def test_half_of_the_batch_left_out(cell_name, monkeypatch):
    from repro_torch.models import vfl
    whole = vfl.per_instance_loss

    def half(params_b, cfg, z_a, batch, train=True, remat=True):
        li, aux = whole(params_b, cfg, z_a, batch, train=train, remat=remat)
        keep = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        lk, _ = whole(params_b, cfg, z_a[: z_a.shape[0] // 2], keep,
                      train=train, remat=remat)
        return torch.cat([lk, lk]), aux
    monkeypatch.setattr(vfl, "per_instance_loss", half)
    assert _run(cell_name)["correct"] is False


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_local_cotangent_not_scaled_by_its_weight(cell_name,
                                                    monkeypatch):
    """K1's gate weights each cached instance of Party A's local update;
    here the cotangent it hands back is the cached ∇Z unscaled wherever
    the weight is not 0."""
    from repro_torch.kernels import ops
    gate = ops.fused_gather_weight

    def unscaled(slot, ad_hoc, z_ring, dz_ring, cos_xi):
        w, cot = gate(slot, ad_hoc, z_ring, dz_ring, cos_xi)
        live = (w > 0).reshape(w.shape + (1,) * (cot.dim() - 1))
        wb = w.reshape(live.shape)
        return w, torch.where(live, cot / torch.where(live, wb, 1.0), 0.0)
    monkeypatch.setattr(ops, "fused_gather_weight", unscaled)
    out = _run(cell_name)
    assert out["correct"] is False
    assert out["checks"]["local_grad_gap"]["value"] > \
        out["checks"]["local_grad_gap"]["limit"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails(cell_name):
    """The reference with float8 products in the program's place.  At this
    size the control proper (bf16 throughout) rounds too much like the
    program to tell them apart: the card test below holds it at the
    cell's size."""
    cell = tiny.tiny_cell(cell_name)
    config, traffic = cell["config"], cell["traffic"]
    batches = Tr.make_batches(traffic, config["vocab_size"],
                              config["port"]["aux_vocab_size"], SEED, "cpu")
    n = traffic["checked_rounds"]
    want = reading(config, traffic, SEED, batches[:n], "cpu")
    got = reading(config, traffic, SEED, batches[:n], "cpu",
                  products="fp8")
    assert check.judge(check.gaps(got, want),
                       _limits(cell_name))["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell_name):
    """On the card, at the cell's own size: the control, the reference
    computed in bf16 throughout (norms, softmax, routing, logits, the
    optimizer's state), against the reference (``bench/calibrate.py``
    reads three seeds)."""
    cell = specs.load_cell(cell_name)
    config, traffic = cell["config"], cell["traffic"]
    batches = Tr.make_batches(traffic, config["vocab_size"],
                              config["port"]["aux_vocab_size"], SEED, card)
    n = traffic["checked_rounds"]
    want = reading(config, traffic, SEED, batches[:n], card)
    got = reading(config, traffic, SEED, batches[:n], card,
                  dtype=torch.bfloat16)
    assert check.judge(check.gaps(got, want),
                       cell["limits"])["correct"] is False
