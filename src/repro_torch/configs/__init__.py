"""Architecture registry of the port: ``get_config(name)`` / ``ARCHS``.

Holds every architecture of the reference's registry: its dense family,
its Mixtral MoE, DeepSeek-V3 (MLA, top-8 sigmoid MoE, MTP), Qwen2-VL
(M-RoPE over patch-embedding inputs), Whisper (encoder-decoder),
RecurrentGemma (Griffin: RG-LRU and local attention) and xLSTM (mLSTM and
sLSTM blocks).
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeSpec

ARCHS = ("starcoder2-15b", "mixtral-8x7b", "qwen2.5-3b", "granite-3-2b",
         "deepseek-v3-671b", "mistral-large-123b", "nanogpt-124m",
         "qwen2-vl-7b", "whisper-small", "recurrentgemma-2b", "xlstm-1.3b")


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {ARCHS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeSpec", "get_config"]
