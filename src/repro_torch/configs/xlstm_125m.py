"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517] (a copy of the
reference's config).  d_ff=0: the xLSTM cells replace the FFN."""
from .base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=4),
    source="arXiv:2405.04517",
)
