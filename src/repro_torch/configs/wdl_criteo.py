"""WDL on Criteo field layout — the paper's own Table-1 workload."""
from ..models.tabular import DLRMConfig

CONFIG = DLRMConfig(model="wdl", fields_a=26, fields_b=13,
                    vocab=1024, embed_dim=16, z_dim=256, hidden=(512, 256))
