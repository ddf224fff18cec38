"""seamless-m4t-large-v2 — enc-dec multimodal [arXiv:2308.11596] (a copy
of the reference's config).

Read as 24 encoder + 24 decoder layers.  The mel + conv audio codec is a
stub: the batch carries precomputed frame embeddings.  Party A (the audio
owner) runs the encoder; Party B is the text decoder with per-layer
cross-attention."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=256206,
    enc_layers=24, d_frontend=160, audio_downsample=4,
    source="arXiv:2308.11596",
)
