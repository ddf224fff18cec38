"""CELU-VFL hyper-parameters (copy of ``repro/configs/base.py``'s
``validate_pipeline_depth`` and ``CELUConfig``; the port keeps its own so
that it imports nothing of the JAX package)."""
from __future__ import annotations

from dataclasses import dataclass


def validate_pipeline_depth(depth: int, W: int) -> None:
    """A depth-D exchange queue retires the oldest D workset ring slots
    early, so D must stay < W or every draw is a bubble."""
    if depth < 0:
        raise ValueError(f"pipeline_depth must be >= 0, got {depth}")
    if depth and depth >= max(W, 1):
        raise ValueError(
            f"pipeline_depth ({depth}) must be < W "
            f"({W}): a depth-D queue retires the oldest D ring "
            f"slots early, so D >= W leaves no valid workset draws")


@dataclass(frozen=True)
class CELUConfig:
    """Hyper-parameters of the paper's technique (Section 3 notation).
    Field meanings and defaults are those of the reference."""
    R: int = 5               # max local updates per cached batch
    W: int = 5               # workset table capacity (mini-batches)
    xi_degrees: float = 60.0  # weighting threshold ξ (cos ξ floor)
    weighting: bool = True
    # round_robin | consecutive (FedBCD) | uniform (random over alive slots)
    sampling: str = "round_robin"
    wire_dtype: str = "float32"   # float32 | bfloat16
    dp_sigma: float = 0.0
    dp_clip: float = 1.0
    compression: str = ""
    cache_dtype: str = "float32"
    # route the local updates through the fused ring-sample kernel (K1);
    # False materialises the sampled entry and runs K2
    cache_fused: bool = True
    pipeline_depth: int = 0
    pipeline_lr_damping: float = 0.25

    def __post_init__(self):
        validate_pipeline_depth(self.pipeline_depth, self.W)
        if self.pipeline_lr_damping < 0.0:
            raise ValueError(
                f"pipeline_lr_damping must be >= 0, got "
                f"{self.pipeline_lr_damping}")
