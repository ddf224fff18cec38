"""A cell at a size a CPU test holds: the cells' shapes shrunk (four heads
of 16 over two KV heads, four experts top-2, one layer a tower, 32
positions, and AdaGrad's lr at 1e-3: at this width a step turns Party A's
Z about as far as 4e-5 does at the cells' widths, so K1 keeps every live
instance at weights of 0.8-0.95, over the cut and under 1, as in the
cells), for the benchmark's own tests.  Not a cell of ``BENCHMARK.json``."""
from __future__ import annotations

import copy

from . import specs


def tiny_cell(cell_name: str = "granite-moe-3b-a800m.s4k",
              limits=None) -> dict:
    cell = copy.deepcopy(specs.load_cell(cell_name))
    c = cell["config"]
    c.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, vocab_size=500)
    if c.get("num_local_experts"):
        c.update(num_local_experts=4, num_experts_per_tok=2)
    c["port"].update(layers_a=1, layers_b=1, layers_top=1,
                     aux_vocab_size=512)
    cell["traffic"].update(batch=2, seq_len=32, n_batches=8,
                           profiled_rounds=1, lr=1e-3)
    if limits is not None:
        cell["limits"] = dict(limits)
    return cell
