"""StarCoder2-15B [arXiv:2402.19173].

40L, d_model 6144, 48 heads (GQA kv=4), d_ff 24576, vocab 49152, RoPE
(base 1e5), sliding-window 4096, LayerNorm + GELU, linear-layer bias.
The 4096 sliding window makes long_500k decode admissible (ring cache).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense", source="arXiv:2402.19173",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab=49152, qkv_bias=True, rope="rope", rope_base=1e5, window=4096,
    norm="layernorm", act="gelu", norm_eps=1e-5,
)
