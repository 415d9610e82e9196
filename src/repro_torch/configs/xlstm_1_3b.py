"""xLSTM-1.3B [arXiv:2405.04517].

48 blocks, d_model 2048, 4 heads, d_ff 0 (the mLSTM up/down projection
plays the FFN role), vocab 50304. Block pattern 7:1 mLSTM:sLSTM
(xLSTM[7:1]), matrix-memory mLSTM with chunkwise-parallel training and
O(1) recurrent decode state => long_500k admissible.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm", source="arXiv:2405.04517",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, rope="none", norm="rmsnorm", act="swiglu",
    block_pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
)
