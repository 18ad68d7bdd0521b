"""Assigned-architecture registry: ``get_config(name)`` / ``ARCHS``."""

from .base import (
    ArchConfig,
    BlockDef,
    MambaSpec,
    MoESpec,
    SHAPES,
    ShapeConfig,
    applicable_shapes,
    shape_by_name,
)
from .chatglm3_6b import CONFIG as chatglm3_6b
from .gemma2_9b import CONFIG as gemma2_9b
from .stablelm_12b import CONFIG as stablelm_12b
from .qwen2_5_32b import CONFIG as qwen2_5_32b
from .grok_1_314b import CONFIG as grok_1_314b
from .deepseek_moe_16b import CONFIG as deepseek_moe_16b
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from .xlstm_125m import CONFIG as xlstm_125m
from .llava_next_mistral_7b import CONFIG as llava_next_mistral_7b
from .whisper_base import CONFIG as whisper_base

ARCHS = {
    c.name: c
    for c in (
        chatglm3_6b,
        gemma2_9b,
        stablelm_12b,
        qwen2_5_32b,
        grok_1_314b,
        deepseek_moe_16b,
        jamba_v0_1_52b,
        xlstm_125m,
        llava_next_mistral_7b,
        whisper_base,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ARCHS",
    "get_config",
    "ArchConfig",
    "BlockDef",
    "MambaSpec",
    "MoESpec",
    "SHAPES",
    "ShapeConfig",
    "applicable_shapes",
    "shape_by_name",
]
