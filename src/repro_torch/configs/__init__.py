"""Architecture registry: every config of the reference's registry, and
the canonical input shapes."""
from .base import SHAPES, ArchConfig, ShapeCfg, shape_applicable

from . import (grok_1_314b, internvl2_1b, minitron_8b, qwen1_5_0_5b,
               qwen2_7b, qwen3_moe_30b_a3b, recurrentgemma_9b,
               seamless_m4t_large_v2, xlstm_350m, yi_6b)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (minitron_8b, qwen2_7b, qwen1_5_0_5b, yi_6b,
                   recurrentgemma_9b, xlstm_350m, qwen3_moe_30b_a3b,
                   grok_1_314b, internvl2_1b, seamless_m4t_large_v2)}


def get_config(name: str) -> ArchConfig:
    """Config by name; a `-smoke` suffix gives the reduced variant."""
    if name.endswith("-smoke"):
        return ARCHS[name[:-len("-smoke")]].reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeCfg:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; options: {sorted(SHAPES)}")
    return SHAPES[name]
