"""Architecture registry (the dense and MoE configs ported so far)."""
from .base import ArchConfig

from . import grok_1_314b, qwen1_5_0_5b, qwen3_moe_30b_a3b

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (qwen1_5_0_5b, qwen3_moe_30b_a3b, grok_1_314b)}


def get_config(name: str) -> ArchConfig:
    """Config by name; a `-smoke` suffix gives the reduced variant."""
    if name.endswith("-smoke"):
        return ARCHS[name[:-len("-smoke")]].reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]
