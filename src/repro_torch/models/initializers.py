"""Parameter initialisation helpers for the LLM split models.

Port of ``repro/models/initializers.py``.  Parameters are plain nested
dicts (and lists, one entry per tower stage) of tensors, as the
reference's pytrees are, so :mod:`repro_torch.bridge` copies a reference
tree path for path.  The draws come from an explicit ``torch.Generator``
on the device the parameters are made on; they follow the reference's
distributions, not its bits (parity tests bring the reference's
parameters across instead).

``lead`` is a leading shape put in front of every leaf: a tower stage
stacks its ``repeat`` layers along a leading L axis, as the reference's
``stacked_init`` does.
"""
from __future__ import annotations

import math

import torch

# Parameter dtype used across the LLM models; norms, softmax and the
# logits are computed in fp32.
PARAM_DTYPE = torch.bfloat16


def dense_init(gen: torch.Generator, d_in: int, d_out: int, lead=(),
               dtype=None):
    """Uniform in ±1/sqrt(d_in), drawn in fp32, cast to ``dtype``."""
    scale = 1.0 / math.sqrt(d_in)
    u = torch.rand(tuple(lead) + (d_in, d_out), generator=gen,
                   dtype=torch.float32, device=gen.device)
    return (u * (2 * scale) - scale).to(dtype or PARAM_DTYPE)


def embed_init(gen: torch.Generator, vocab: int, d: int, lead=(),
               dtype=None):
    """N(0, 0.02²), drawn in fp32, cast to ``dtype``."""
    w = torch.randn(tuple(lead) + (vocab, d), generator=gen,
                    dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(dtype or PARAM_DTYPE)


def zeros_init(shape, device, dtype=None):
    return torch.zeros(tuple(shape), dtype=dtype or PARAM_DTYPE,
                       device=device)


def ones_init(shape, device, dtype=None):
    return torch.ones(tuple(shape), dtype=dtype or PARAM_DTYPE,
                      device=device)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))
