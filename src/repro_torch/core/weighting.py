"""Staleness-aware instance weighting (paper Algorithm 2).

Port of ``repro/core/weighting.py``.  ``instance_weights(ad_hoc, stale,
cos_xi)`` measures the per-instance cosine similarity between the ad-hoc
statistics (computed this local step) and the cached stale statistics,
and floors it at ``cos ξ`` (below the threshold the instance weight is
zeroed).  The cosine is taken over all non-batch axes flattened per
instance.  The engine computes the same weights through the gate kernels
(``kernels/ops.py``); this plain version is what the tests hold them to.
"""
from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-12


def row_cosine(a, b):
    """Per-instance cosine similarity.  a, b: (B, ...) -> (B,) float32."""
    B = a.shape[0]
    af = a.reshape(B, -1).float()
    bf = b.reshape(B, -1).float()
    num = (af * bf).sum(dim=1)
    den = torch.sqrt((af * af).sum(dim=1) * (bf * bf).sum(dim=1))
    return num / torch.clamp(den, min=EPS)


def instance_weights(ad_hoc, stale, cos_xi: float):
    """Algorithm 2 ``InsWeight``: cosine similarities floored at cos ξ.

    Returns float32 weights of shape (B,); entries below the threshold
    are 0."""
    w = row_cosine(ad_hoc, stale)
    return torch.where(w < float(np.float32(cos_xi)), 0.0, w)


def pipeline_attenuation(w, staleness: int, dynamic: bool = False):
    """Discount Algorithm-2 weights for known extra staleness:
    ``w -> w^(1+s)``.  ``staleness`` is a host int.  On the static path
    (``dynamic`` False: pipeline depths 0 / 1) ``s = 0`` is skipped and
    the power is the reference's ``integer_pow`` (products); the dynamic
    path (the depth-D queue's per-slot staleness) always applies it as a
    float power, as the reference's ``lax.pow`` of a traced exponent
    does, which is the identity at ``s = 0``."""
    if not dynamic:
        return w if staleness <= 0 else w ** (1 + int(staleness))
    return torch.pow(w, float(1 + staleness))


def xi_to_cos(xi_degrees: float) -> float:
    """Paper parameterizes the threshold as an angle ξ (e.g. 60°)."""
    return math.cos(math.radians(xi_degrees))
