"""Architecture configs of the port (one module per arch).

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` returns a reduced same-family config for CPU
tests (small widths/layers, same structural features).
"""
from __future__ import annotations

import importlib

from ..models.common import ModelConfig

#: every architecture of the reference: dense global attention, a local :
#: global pattern, mixture-of-experts FFNs, Mamba-2 SSD, the RG-LRU hybrid
#: and the Whisper encoder-decoder
ARCH_IDS = ["qwen3_14b", "yi_6b", "gemma3_4b", "qwen3_moe_235b_a22b",
            "kimi_k2_1t_a32b", "nemotron_4_15b", "chameleon_34b",
            "mamba2_370m", "recurrentgemma_2b", "whisper_base"]


def _module(name: str):
    """The config module of ``name``; an unknown name raises
    ModuleNotFoundError, as the reference's registry does."""
    return importlib.import_module(f".{name.replace('-', '_')}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE_CONFIG
