"""Config registry: ``get_config("<arch-id>")`` -> the paper's DLRMs'
``DLRMConfig`` or an LLM's ``ArchConfig`` (copies of ``repro.configs``).

Ids use the public pool spelling (dashes); module names use underscores.
:data:`ARCH_IDS` are the reference's LLM configs, in its order: the text
families (dense, moe, hybrid, ssm / xlstm) and the cross-attention ones
(vlm, audio).  :func:`arch_for_shape` gives the config a dry-run shape
of :data:`SHAPES` runs."""
from .base import (LONG_CONTEXT_WINDOW, SHAPES,  # noqa: F401
                   ArchConfig, CELUConfig, MoEConfig, ShapeConfig, SSMConfig,
                   VFLConfig, XLSTMConfig, validate_pipeline_depth)

ARCH_IDS = (
    "hymba-1.5b",
    "deepseek-7b",
    "llama-3.2-vision-90b",
    "granite-moe-3b-a800m",
    "smollm-360m",
    "seamless-m4t-large-v2",
    "llama4-scout-17b-a16e",
    "yi-34b",
    "xlstm-125m",
    "codeqwen1.5-7b",
)

DLRM_IDS = ("wdl-criteo", "dssm-avazu")


def get_config(arch_id: str):
    """DLRMConfig for ``wdl-criteo`` / ``dssm-avazu``; ArchConfig for the
    LLM ids of :data:`ARCH_IDS`."""
    if arch_id not in DLRM_IDS + ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}: the ids are "
                         f"{DLRM_IDS + ARCH_IDS}")
    import importlib
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f".{name}", __package__).CONFIG


def arch_for_shape(arch_id: str, shape_name: str):
    """The config a shape runs: at ``long_500k`` every family but ssm
    takes its sliding-window variant (window :data:`LONG_CONTEXT_WINDOW`);
    the ssm family decodes in O(1) state and keeps its config."""
    cfg = get_config(arch_id)
    if shape_name == "long_500k" and cfg.family != "ssm":
        return cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    return cfg
