"""The model FLOPs of one CELU round, counted from the cell's shapes.

A forward over T = B·S tokens costs 2 × its matmul parameters × T (the
experts' parameters counted for the ``top_k`` that each token uses, the
router's too; the embedding gather costs nothing) plus causal attention,
half of 4·S·(H·hd) per token and layer.  A backward costs twice its
forward.  Party B's ad-hoc pass, which takes ∇Z_A alone, costs a forward
of Party B and a backward of what lies after the fusion that computes
only the activations' gradient: once the forward of its products, twice
its attention.  Recomputation by activation checkpointing is not counted.

A round (``core/engine.py``'s ``make_round``): the fresh forward and
backward of both parties; then R local updates of Party A (a forward and
a backward each) and R of Party B (its ad-hoc pass, then a forward and a
backward), whether or not the drawn slot is alive: a bubble's update runs
at scale 0.
"""
from __future__ import annotations


def layer_params(g: dict) -> int:
    d, H, Kv, hd, f = g["d"], g["H"], g["Kv"], g["hd"], g["f"]
    attn = 2 * d * H * hd + 2 * d * Kv * hd
    ffn = d * g["E"] + g["top_k"] * 3 * d * f if g["E"] else 3 * d * f
    return attn + ffn


def round_flops(g: dict, B: int, S: int, R: int) -> dict:
    """{"fwd_a", "fwd_b", "adhoc_bwd_b", "round"}: FLOPs over one batch
    of B sequences of S tokens."""
    T = B * S
    lay = layer_params(g)
    attn = 2 * S * g["H"] * g["hd"] * T          # one layer's forward
    la, lb, lt = (g["layers"][k] for k in ("a", "bottom", "top"))
    d = g["d"]
    after = d * d + lt * lay + d * g["vocab"]   # fusion, top tower, head
    fwd_a = 2 * la * lay * T + la * attn
    fwd_b = 2 * (lb * lay + after) * T + (lb + lt) * attn
    adhoc_bwd_b = 2 * after * T + 2 * lt * attn
    fresh = 3 * (fwd_a + fwd_b)
    local = R * 3 * fwd_a + R * (fwd_b + adhoc_bwd_b + 3 * fwd_b)
    return {"fwd_a": fwd_a, "fwd_b": fwd_b, "adhoc_bwd_b": adhoc_bwd_b,
            "round": fresh + local}
