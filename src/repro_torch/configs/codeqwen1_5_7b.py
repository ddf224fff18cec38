"""codeqwen1.5-7b — qwen1.5-arch (attention QKV bias)
[hf:Qwen/CodeQwen1.5-7B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab_size=92416, qkv_bias=True,
    source="hf:Qwen/CodeQwen1.5-7B",
)
