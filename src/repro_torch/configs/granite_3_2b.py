"""Granite-3.0-2B base [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model 2048, 32 heads (GQA kv=8), d_ff 8192, vocab 49155,
RoPE, RMSNorm + SwiGLU, tied embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=49155, rope="rope", rope_base=10000.0,
    norm="rmsnorm", act="swiglu", tied_embeddings=True,
)
