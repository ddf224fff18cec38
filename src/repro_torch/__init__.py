"""PyTorch and CUDA port of ``repro`` (CELU-VFL) for NVIDIA Hopper.

Module names mirror ``repro``; the JAX package stays the reference.  Entry
points take ``device=None``, which means ``"cuda"``: they raise when no
CUDA device exists unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run the port on the CPU")
    return dev
