"""Mistral-Large-Instruct-2407 (123B) [hf:mistralai/Mistral-Large-Instruct-2407].

88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768,
head_dim 128, RoPE base 1e6, RMSNorm + SwiGLU. Deepest assigned arch;
pure full attention => long_500k skipped (documented in DESIGN.md).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab=32768, head_dim=128, rope="rope", rope_base=1e6,
    norm="rmsnorm", act="swiglu",
)
