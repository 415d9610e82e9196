"""Architecture registry of the port: ``get_config(name)`` / ``ARCHS``.

Holds only the architectures the port runs. The reference's other
architectures raise and name the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig, ShapeSpec

ARCHS = ("nanogpt-124m",)

# the reference's registry (repro/configs) beyond what the port runs
NOT_YET_PORTED = (
    "qwen2-vl-7b", "whisper-small", "starcoder2-15b", "xlstm-1.3b",
    "mixtral-8x7b", "qwen2.5-3b", "granite-3-2b", "deepseek-v3-671b",
    "mistral-large-123b", "recurrentgemma-2b",
)


def get_config(name: str) -> ArchConfig:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch '{name}' is not ported to repro_torch yet: ROADMAP "
            "Queue 1 item 9 (the rest of the model zoo)")
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {ARCHS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


__all__ = ["ARCHS", "ArchConfig", "ShapeSpec", "get_config"]
