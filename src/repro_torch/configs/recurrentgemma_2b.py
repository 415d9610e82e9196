"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

26L, d_model 2560, 10 heads (MQA kv=1), d_ff 7680 (GeGLU), vocab 256000,
RG-LRU recurrent width 2560, conv width 4, local attention window 2048,
block pattern (rec, rec, attn). O(1)/O(window) state => long_500k runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", source="arXiv:2402.19427",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, rope="rope", rope_base=10000.0, window=2048,
    norm="rmsnorm", act="geglu", d_rnn=2560, conv_width=4,
    block_pattern=("rec", "rec", "attn"),
)
