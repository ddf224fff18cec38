"""The plain reference against ``repro_torch`` on the CPU, at a size a test
holds: in fp32 the two compute the same rounds, so they agree to rounding;
in the program's bf16 the run's own comparison decides."""
import torch
import pytest

from bench import check, harness, tiny
from bench import weights as Wt
from bench.reference import reading

CELLS = ("smollm-360m.s2k", "granite-moe-3b-a800m.s4k")
SEED = 2 ** 31 + 101


def _program_reading(cell, seed, dtype=None):
    from bench import program
    from bench import traffic as Tr
    config, traffic = cell["config"], cell["traffic"]
    batches = Tr.make_batches(traffic, config["vocab_size"],
                              config["port"]["aux_vocab_size"], seed, "cpu")
    prog = program.Program(config, traffic,
                           Wt.make_party_trees(config, seed, "cpu", dtype),
                           batches[0], seed, "cpu")
    got = harness.checked_rounds(
        prog, lambda i: prog.step(batches[i], i),
        traffic["checked_rounds"], config, seed, lambda: None)
    return got, batches


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_is_the_programs_rounds_in_fp32(cell_name):
    """Given fp32 weights the program computes in fp32 too: three rounds
    (fresh exchange, ring, gate, bubbles, AdaGrad, experts) agree to
    fp32 rounding, leaf by leaf."""
    cell = tiny.tiny_cell(cell_name)
    got, batches = _program_reading(cell, SEED, torch.float32)
    want = reading(cell["config"], cell["traffic"], SEED,
                   batches[:cell["traffic"]["checked_rounds"]], "cpu",
                   stored=torch.float32)
    gaps = check.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["gate_gap"] < 1e-5, gaps
    assert gaps["local_grad_gap"] < 1e-4, gaps
    assert gaps["grad_norm_gap"] < 1e-4, gaps
    assert gaps["change_norm_gap_median_leaf"] < 1e-4, gaps
    # AdaGrad's first step moves an element by lr whatever its gradient's
    # size, so where a gradient is rounding noise the two sides may step
    # either way: the worst leaf's change agrees less closely
    assert gaps["change_norm_gap"] < 1e-3, gaps


@pytest.mark.parametrize("cell_name", CELLS)
def test_one_reduced_round_of_the_program_against_the_reference(cell_name):
    """The program as it runs (bf16 weights) over one round; the gap is
    bf16 rounding: the loss within a few parts in 1e3, each leaf's
    gradient norm within a few parts in 1e2."""
    cell = tiny.tiny_cell(cell_name)
    cell["traffic"]["checked_rounds"] = 1
    got, batches = _program_reading(cell, SEED)
    want = reading(cell["config"], cell["traffic"], SEED, batches[:1],
                   "cpu")
    gaps = check.gaps(got, want)
    assert gaps["loss_gap"] < 5e-3, gaps
    assert gaps["grad_norm_gap"] < 5e-2, gaps


def test_the_gate_and_the_ring_follow_the_paper():
    from bench.reference import celu
    new = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 0.0]])
    stale = torch.tensor([[1.0, 0.0], [1.0, 1.8], [1.0, 0.0]])
    w = celu.gate(new, stale, 0.5)
    assert w[0] == 1.0 and w[1] == 0.0 and w[2] == 0.0
    p = celu.Party({"x": torch.zeros(1)}, W=3)
    p.insert({"z": torch.ones(1)})
    draws = [p.draw(R=2)[1] for _ in range(3)]
    assert draws == [1.0, 0.0, 0.0]
    p.insert({"z": torch.ones(1)})
    assert [p.draw(R=2)[1] for _ in range(3)] == [1.0, 1.0, 0.0]
    assert [p.draw(R=2)[1] for _ in range(3)] == [0.0, 1.0, 0.0]
