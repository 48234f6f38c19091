"""Architecture configs of the port (one module per arch).

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` returns a reduced same-family config for CPU
tests (small widths/layers, same structural features).  ``SHAPES`` are the
reference's four cell shapes, and ``shape_cells`` / ``all_cells`` the
(arch x shape) cells of the dry run (``launch/dryrun.py``): every arch
trains at 4 096 tokens, prefills and decodes at 32 768, and the
sub-quadratic ones also decode one sequence at 524 288.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_cells(arch: str) -> List[str]:
    """The shapes ``arch`` runs: ``long_500k`` only where the config is
    sub-quadratic (a recurrent state or a local window in place of a
    growing KV cache)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(arch).sub_quadratic:
        cells.append("long_500k")
    return cells


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in shape_cells(a)]
