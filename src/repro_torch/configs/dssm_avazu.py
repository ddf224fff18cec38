"""DSSM on Avazu field layout — the paper's own Table-1 workload."""
from ..models.tabular import DLRMConfig

CONFIG = DLRMConfig(model="dssm", fields_a=14, fields_b=8,
                    vocab=1024, embed_dim=16, z_dim=256, hidden=(512, 256))
