"""hymba-1.5b — hybrid parallel attn+mamba heads [arXiv:2411.13676] (a
copy of the reference's config)."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    source="arXiv:2411.13676",
)
