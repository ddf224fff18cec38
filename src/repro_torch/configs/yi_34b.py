"""yi-34b — llama-arch GQA [arXiv:2403.04652]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000,
    source="arXiv:2403.04652",
)
