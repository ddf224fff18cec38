"""The weights of a cell, made from the seed on the device.

Both the program and the reference get the same tensors.  The tree has the
program's layout (``models/vfl.py``): each party a nested dict, a tower a
list of stages, a stage's leaves stacked along a leading layer axis.  The
shapes follow from the configuration file alone, so this module imports
nothing of the program.

Each leaf is drawn by one call from a generator of its own, seeded from
the run's seed and the leaf's path, so any one leaf can be drawn again
(the reference's start, the program's change after its checked rounds)
without drawing the others.  Matrices are uniform in +-1/sqrt(fan-in),
embeddings uniform with a standard deviation of 0.02, norm scales one:
the program's own distributions (``models/initializers.py``), with the
embeddings' normal draw replaced by a uniform one of the same spread.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

PARAM_DTYPE = torch.bfloat16


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def geometry(config: dict) -> dict:
    """The sizes a tree needs, from a configuration file's keys."""
    port = config["port"]
    d = config["hidden_size"]
    H = config["num_attention_heads"]
    g = {
        "d": d, "H": H, "Kv": config["num_key_value_heads"],
        "hd": config.get("head_dim") or d // H,
        "f": config["intermediate_size"],
        "vocab": config["vocab_size"],
        "vocab_padded": _round_up(config["vocab_size"], 256),
        "vocab_a_padded": _round_up(port["aux_vocab_size"], 256),
        "layers": {"a": port["layers_a"], "bottom": port["layers_b"],
                   "top": port["layers_top"]},
        "E": config.get("num_local_experts", 0),
        "top_k": config.get("num_experts_per_tok", 0),
    }
    return g


def _block_leaves(g: dict, L: int, prefix: str) -> List[tuple]:
    """(path, shape, dtype, bound) of one stage of L stacked blocks; a
    bound of None is a norm scale (ones)."""
    d, H, Kv, hd, f, E = g["d"], g["H"], g["Kv"], g["hd"], g["f"], g["E"]
    out = [
        (f"{prefix}.ln1.scale", (L, d), PARAM_DTYPE, None),
        (f"{prefix}.ln2.scale", (L, d), PARAM_DTYPE, None),
        (f"{prefix}.attn.wq", (L, d, H, hd), PARAM_DTYPE, d),
        (f"{prefix}.attn.wk", (L, d, Kv, hd), PARAM_DTYPE, d),
        (f"{prefix}.attn.wv", (L, d, Kv, hd), PARAM_DTYPE, d),
        (f"{prefix}.attn.wo", (L, H, hd, d), PARAM_DTYPE, H * hd),
    ]
    if E:
        out += [
            (f"{prefix}.ffn.router", (L, d, E), torch.float32, d),
            (f"{prefix}.ffn.wg", (L, E, d, f), PARAM_DTYPE, d),
            (f"{prefix}.ffn.wu", (L, E, d, f), PARAM_DTYPE, d),
            (f"{prefix}.ffn.wd", (L, E, f, d), PARAM_DTYPE, f),
        ]
    else:
        out += [
            (f"{prefix}.ffn.wg", (L, d, f), PARAM_DTYPE, d),
            (f"{prefix}.ffn.wu", (L, d, f), PARAM_DTYPE, d),
            (f"{prefix}.ffn.wd", (L, f, d), PARAM_DTYPE, f),
        ]
    return out


EMBED_STD = 0.02


def leaf_specs(config: dict) -> Dict[str, List[tuple]]:
    """{"a", "b"}: each party's (path, shape, dtype, bound) leaves, in
    path order; bound is the uniform draw's half-width over its fan-in
    (an int), "embed" for an embedding, None for a norm scale."""
    g = geometry(config)
    d = g["d"]
    a = [("embed", (g["vocab_a_padded"], d), PARAM_DTYPE, "embed")]
    a += _block_leaves(g, g["layers"]["a"], "tower.0.b0")
    b = [("embed", (g["vocab_padded"], d), PARAM_DTYPE, "embed")]
    b += _block_leaves(g, g["layers"]["bottom"], "bottom.0.b0")
    b += _block_leaves(g, g["layers"]["top"], "top.0.b0")
    b += [("ln_f.scale", (d,), PARAM_DTYPE, None),
          ("head", (d, g["vocab_padded"]), PARAM_DTYPE, d),
          ("fuse_proj", (d, d), PARAM_DTYPE, d)]
    return {"a": a, "b": b}


def leaf_seed(seed: int, party: str, path: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{party}/{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draw_leaf(seed: int, party: str, spec: tuple, device,
              dtype=None) -> torch.Tensor:
    """One leaf as the program gets it (in its own dtype), or cast to
    ``dtype`` after the draw (the reference's fp32 copy of the same
    values)."""
    path, shape, dt, bound = spec
    if bound is None:
        t = torch.ones(shape, dtype=dt, device=device)
    else:
        half = EMBED_STD * math.sqrt(3.0) if bound == "embed" \
            else 1.0 / math.sqrt(bound)
        gen = torch.Generator(device=device)
        gen.manual_seed(leaf_seed(seed, party, path))
        t = torch.empty(shape, dtype=dt, device=device).uniform_(
            -half, half, generator=gen)
    return t if dtype is None else t.to(dtype)


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"tower.0.b0.attn.wq": t, ...} -> the nested tree (an all-digit
    component is a list index)."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def make_party_trees(config: dict, seed: int, device, dtype=None
                     ) -> Dict[str, dict]:
    """{"a", "b"} nested trees of the cell's weights."""
    specs = leaf_specs(config)
    return {p: nest({s[0]: draw_leaf(seed, p, s, device, dtype)
                     for s in specs[p]}) for p in ("a", "b")}


def iter_leaves(config: dict) -> Iterator[Tuple[str, tuple]]:
    """(party, spec) over every leaf of both parties."""
    for party, specs in leaf_specs(config).items():
        for s in specs:
            yield party, s


@torch.no_grad()
def change_norm(seed: int, party: str, spec: tuple, now: torch.Tensor
                ) -> float:
    """||now - the leaf's start||, in fp32, one layer slice at a time (the
    start is drawn again from its seed)."""
    start = draw_leaf(seed, party, spec, now.device)
    acc = torch.zeros((), dtype=torch.float64, device=now.device)
    rows = now.shape[0] if now.dim() > 2 else 1
    pairs = zip(now.unbind(0), start.unbind(0)) if rows > 1 \
        else [(now, start)]
    for x, x0 in pairs:
        acc += ((x.float() - x0.float()) ** 2).sum(dtype=torch.float64)
    return float(acc.sqrt())
