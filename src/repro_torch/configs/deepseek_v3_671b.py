"""DeepSeek-V3 (671B total / 37B active) [arXiv:2412.19437].

61L, d_model 7168, 128 heads, MLA (q_lora 1536, kv_lora 512, qk_nope 128,
qk_rope 64, v 128), MoE: 1 shared + 256 routed experts top-8,
d_expert 2048, first 3 layers dense (d_ff 18432), MTP head, vocab 129280.
MLA is full attention => long_500k skipped.
"""
from .base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe", source="arXiv:2412.19437",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=2048,
    vocab=129280, rope="rope", rope_base=10000.0,
    norm="rmsnorm", act="swiglu",
    moe=MoECfg(n_experts=256, top_k=8, d_expert=2048, n_shared=1),
    moe_start_layer=3, dense_ff=18432,
    mla=MLACfg(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_dim=128),
    mtp=True,
)
