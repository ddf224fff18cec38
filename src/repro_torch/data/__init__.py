"""Data of the port: the synthetic tabular and token streams
(``data/synthetic.py``) and the move of a numpy batch onto the device."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; integer ids become int64 (the
    embedding gather's index type)."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.int64) if np.issubdtype(v.dtype, np.integer) else v)
    ).to(device) for k, v in batch.items()}
