"""Architecture registry of the port: ``get_config(name)`` / ``ARCHS``.

Holds the architectures the port runs: the reference's dense family, its
Mixtral MoE and DeepSeek-V3 (MLA, top-8 sigmoid MoE, MTP).
The reference's other architectures raise and name the ROADMAP item
that ports them.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeSpec

ARCHS = ("starcoder2-15b", "mixtral-8x7b", "qwen2.5-3b", "granite-3-2b",
         "deepseek-v3-671b", "mistral-large-123b", "nanogpt-124m")

# the reference's registry (repro/configs) beyond what the port runs:
# the VLM, audio and recurrent families
NOT_YET_PORTED = (
    "qwen2-vl-7b", "whisper-small", "xlstm-1.3b", "recurrentgemma-2b",
)


def get_config(name: str) -> ArchConfig:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch '{name}' is not ported to repro_torch yet: ROADMAP "
            "Queue 1 item 9 (the other model families)")
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {ARCHS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeSpec", "get_config"]
