"""Config registry: ``get_config("<arch-id>")`` for the paper's DLRMs.

The LLM architectures of ``repro.configs`` belong to a later slice of the
port."""
from .base import CELUConfig, validate_pipeline_depth  # noqa: F401

DLRM_IDS = ("wdl-criteo", "dssm-avazu")


def get_config(arch_id: str):
    """DLRMConfig for ``wdl-criteo`` / ``dssm-avazu``."""
    if arch_id not in DLRM_IDS:
        raise NotImplementedError(
            f"{arch_id!r}: the port has only the DLRM archs {DLRM_IDS}; "
            f"the LLM split models come with slice 7 (ROADMAP.md)")
    import importlib
    mod = importlib.import_module(f".{arch_id.replace('-', '_')}",
                                  __package__)
    return mod.CONFIG
