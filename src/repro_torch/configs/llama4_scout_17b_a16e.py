"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E] (a copy of the reference's
config).  Its 216 GB of bf16 parameters do not fit one card: the port
runs it at ``reduced()`` geometry."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(n_experts=16, top_k=1, n_shared=1, sharding="ep"),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
