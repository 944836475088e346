"""Configurations of the port.

- the paper's cascade shape and the pretrained synthetic-face cascade
  (``viola_jones.py``);
- the LM architecture registry, one module per assigned architecture:
  ``get_config(name)`` returns the full published config; ``smoke``-reduced
  twins (same family, tiny dims) back the per-arch CPU smoke tests.
"""

from __future__ import annotations

import importlib

from .base import (ModelConfig, MoEConfig, MLAConfig, RGLRUConfig,
                   SSDConfig, ShapeSpec, SHAPES)

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "RGLRUConfig",
           "SSDConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "get_config",
           "get_smoke_config", "list_archs"]

ARCH_IDS = (
    "deepseek-v2-236b",
    "qwen3-moe-235b-a22b",
    "recurrentgemma-2b",
    "stablelm-1.6b",
    "olmo-1b",
    "qwen2-72b",
    "llama3-405b",
    "internvl2-1b",
    "musicgen-medium",
    "mamba2-780m",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch: str):
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MOD)}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS
