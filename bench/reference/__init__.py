"""The plain reference the benchmark holds the program to: the split
language model (``model.py``) and the CELU rounds (``celu.py``) in plain
PyTorch, fp32 with TF32 off; each weight is kept between updates in the
dtype the configuration states for it (bf16, the router fp32).  It imports nothing of the program; it takes
the benchmark's weights (drawn again from the seed, ``bench/weights.py``)
and batches, never the program's state."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import weights as Wt
from . import celu, model


def reading(config: dict, traffic: dict, seed: int,
            batches: List[Tuple[dict, dict]], device,
            products: str = "fp32", keep: Optional[float] = None,
            dtype=torch.float32, unweighted: bool = False,
            stored: Optional[torch.dtype] = None) -> dict:
    """The reference's reading over ``batches`` (one round each): its
    fresh losses, each leaf's norm of its first gradient and each leaf's
    change after the last round (``bench/check.py``).
    ``dtype=torch.bfloat16`` (every tensor in bf16) is the check's
    control, ``products="fp8"`` a lower one; ``keep`` and ``unweighted``
    faults (``celu.Rounds``); ``stored`` keeps every weight in that
    dtype instead of the configuration's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trees = Wt.make_party_trees(config, seed, device, dtype=dtype)
    rounds = celu.Rounds(model.model_cfg(config), trees, traffic,
                         model.Products(products), keep, unweighted,
                         {p: {s[0]: stored or s[2] for s in specs}
                          for p, specs in Wt.leaf_specs(config).items()})
    del trees
    losses = [rounds.round(ba, bb) for ba, bb in batches]
    grad = rounds.first_grad
    leaves = rounds.leaves()
    change = {f"{party}/{spec[0]}": Wt.change_norm(
        seed, party, spec, leaves[f"{party}/{spec[0]}"].detach())
        for party, spec in Wt.iter_leaves(config)}
    return {"loss": losses, "grad": grad, "change": change,
            "w_zero": rounds.w_zero, "w_mean": rounds.w_mean,
            "updates": rounds.updates}
