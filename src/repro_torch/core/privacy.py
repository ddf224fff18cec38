"""Differential-privacy noise on the exchanged statistics (paper §4.2).

Port of ``repro/core/privacy.py``: per-message Gaussian noise on the wire
tensors (Z uplink, ∇Z downlink) after per-instance L2 clipping, the
Gaussian mechanism applied to the cut tensors.  The noised statistics are
what both parties see and cache, so local updates add no privacy cost.

The reference draws the noise with ``jax.random.normal(key)``, which is
``sqrt(2) · erfinv(u)`` for ``u`` uniform on ``[nextafter(-1, 0), 1)``
from the key's bits.  The port takes the key's [0, 1) uniforms from a
:class:`~repro_torch.core.uniforms.UniformKey` and applies the same
transform, so a source that hands in the reference's uniforms gives the
reference's noise up to ``torch.erfinv``'s last bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# the reference normal's uniform range: [nextafter(-1, 0), 1) in float32,
# whose width 1 - lo rounds to 2
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_WIDTH = float(np.float32(1.0) - np.float32(_LO))
_SQRT2 = float(np.float32(np.sqrt(2)))


class DPConfig(NamedTuple):
    clip: float = 1.0        # per-instance L2 clip of the message rows
    sigma: float = 0.0       # noise stddev as a multiple of clip (0 = off)


def clip_rows(x: torch.Tensor, clip: float) -> torch.Tensor:
    """Per-instance L2 clipping over the flattened non-batch dims."""
    B = x.shape[0]
    flat = x.reshape(B, -1).float()
    n = torch.sqrt((flat * flat).sum(dim=1, keepdim=True))
    scale = torch.clamp_max(clip / torch.clamp_min(n, 1e-12), 1.0)
    return (flat * scale).reshape(x.shape).to(x.dtype)


def normal(key, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` from the key's [0, 1) uniforms:
    ``sqrt(2) · erfinv(max(lo, f · (1 - lo) + lo))``, float32."""
    f = key.uniform(shape)
    u = torch.clamp_min(f * _WIDTH + _LO, _LO)
    return _SQRT2 * torch.erfinv(u)


def wire_noise(key, y: torch.Tensor, cfg: DPConfig) -> torch.Tensor:
    """The Gaussian-mechanism noise alone: ``y`` must already be clipped
    (sensitivity = ``cfg.clip``).  Split out of :func:`privatize` so the
    compressed transport can add it to the decoded wire value, after the
    error-feedback residual was taken noise-free."""
    if cfg.sigma <= 0.0:
        return y
    noise = (cfg.sigma * cfg.clip) * normal(key, y.shape).to(y.device)
    return (y.float() + noise).to(y.dtype)


def privatize(key, x: torch.Tensor, cfg: DPConfig) -> torch.Tensor:
    """Clip + Gaussian noise: the released message."""
    if cfg.sigma <= 0.0:
        return x
    return wire_noise(key, clip_rows(x, cfg.clip), cfg)


def epsilon_per_release(cfg: DPConfig, delta: float = 1e-5) -> float:
    """Gaussian-mechanism bound per released message (sensitivity = clip):
    ``eps = sqrt(2 ln(1.25 / delta)) / sigma``.  CELU releases 1 / (1 + R)
    as many messages per model update as vanilla training."""
    if cfg.sigma <= 0:
        return float("inf")
    return math.sqrt(2 * math.log(1.25 / delta)) / cfg.sigma
