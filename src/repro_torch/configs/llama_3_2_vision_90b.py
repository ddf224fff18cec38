"""llama-3.2-vision-90b — VLM, cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision] (a copy of the reference's config).
The vision frontend is a stub: the batch carries precomputed patch
embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5, n_patches=1024, d_frontend=1152,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
