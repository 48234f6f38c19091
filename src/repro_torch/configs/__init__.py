"""Architecture configs of the port (one module per arch).

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` returns a reduced same-family config for CPU
tests (small widths/layers, same structural features).
"""
from __future__ import annotations

import importlib

from ..models.common import ModelConfig

#: the architectures ported so far (decoder-only; global attention or a
#: local : global pattern of windowed and global layers; a dense or a
#: mixture-of-experts FFN)
ARCH_IDS = ["qwen3_14b", "yi_6b", "gemma3_4b", "qwen3_moe_235b_a22b",
            "kimi_k2_1t_a32b", "nemotron_4_15b", "chameleon_34b"]


def _module(name: str):
    name = name.replace("-", "_")
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ROADMAP queue 1 item 11); "
            f"ported: {ARCH_IDS}")
    return importlib.import_module(f".{name}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE_CONFIG
