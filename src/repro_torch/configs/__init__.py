"""Config registry: ``get_config("<arch-id>")`` -> the paper's DLRMs'
``DLRMConfig`` or an LLM's ``ArchConfig`` (copies of ``repro.configs``).

Ids use the public pool spelling (dashes); module names use underscores.
The port runs the text-family LLM configs of :data:`ARCH_IDS` (dense,
moe, hybrid and ssm / xlstm); the cross-attention configs (vlm, audio)
come with slice 7d of ROADMAP.md, and asking for one raises
``NotImplementedError`` that says so."""
from .base import (ArchConfig, CELUConfig, MoEConfig, ShapeConfig,  # noqa: F401
                   SSMConfig, VFLConfig, XLSTMConfig,
                   validate_pipeline_depth)

ARCH_IDS = (
    "hymba-1.5b",
    "deepseek-7b",
    "granite-moe-3b-a800m",
    "smollm-360m",
    "llama4-scout-17b-a16e",
    "yi-34b",
    "xlstm-125m",
    "codeqwen1.5-7b",
)

# the reference's other LLM configs -> their family; they come with the
# slice that ports the family's blocks
LATER_ARCH_IDS = {
    "llama-3.2-vision-90b": "vlm",
    "seamless-m4t-large-v2": "audio",
}

DLRM_IDS = ("wdl-criteo", "dssm-avazu")


def get_config(arch_id: str):
    """DLRMConfig for ``wdl-criteo`` / ``dssm-avazu``; ArchConfig for the
    LLM ids of :data:`ARCH_IDS`."""
    if arch_id in LATER_ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id} (the {LATER_ARCH_IDS[arch_id]} family) comes with "
            f"slice 7d of the port (ROADMAP.md); the port runs the text "
            f"configs {ARCH_IDS}")
    if arch_id not in DLRM_IDS + ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}: the ids are "
                         f"{DLRM_IDS + ARCH_IDS}")
    import importlib
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f".{name}", __package__).CONFIG
