"""Mixtral-8x7B [arXiv:2401.04088].

32L, d_model 4096, 32 heads (GQA kv=8), MoE: 8 experts, top-2,
d_expert 14336 (the dense-equivalent d_ff), sliding window 4096
(original Mixtral config), vocab 32000, RMSNorm + SwiGLU, untied.
"""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", source="arXiv:2401.04088",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, rope="rope", rope_base=1e6, window=4096,
    norm="rmsnorm", act="swiglu",
    moe=MoECfg(n_experts=8, top_k=2, d_expert=14336),
)
