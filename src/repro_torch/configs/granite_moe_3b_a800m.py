"""granite-moe-3b-a800m — MoE 40 experts top-8, d_ff=512 per expert
[hf:ibm-granite/granite-3.0-1b-a400m-base] (a copy of the reference's
config)."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(n_experts=40, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
