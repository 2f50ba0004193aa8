"""Model configurations of the port: the FNO family (``fno_paper``) and the
LM architecture pool (``get_config(arch_id)`` / ``--arch <id>``)."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import SHAPES, LMArchConfig, ShapeConfig, cell_is_runnable  # noqa: F401
from .fno_paper import (  # noqa: F401
    FNO_DARCY,
    FNO_DARCY_SMOKE,
    GINO_CAR,
    GINO_CAR_SMOKE,
    SFNO_SWE,
    SFNO_SWE_SMOKE,
    TFNO_NS,
    TFNO_NS_SMOKE,
    UNET_BASELINE,
)

ARCH_IDS = [
    "smollm-360m",
    "granite-34b",
    "stablelm-3b",
    "starcoder2-15b",
    "whisper-large-v3",
    "mamba2-370m",
    "granite-moe-3b-a800m",
    "deepseek-v2-lite-16b",
    "hymba-1.5b",
    "llava-next-mistral-7b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str, smoke: bool = False) -> LMArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, LMArchConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}
