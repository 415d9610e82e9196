"""Qwen2.5-3B [hf:Qwen/Qwen2.5-0.5B family card].

36L, d_model 2048, 16 heads (GQA kv=2), d_ff 11008, vocab 151936,
QKV bias, RoPE base 1e6, RMSNorm + SwiGLU, tied embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense", source="hf:Qwen/Qwen2.5-3B",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab=151936, qkv_bias=True, rope="rope", rope_base=1e6,
    norm="rmsnorm", act="swiglu", tied_embeddings=True,
)
