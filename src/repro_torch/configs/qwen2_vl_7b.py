"""Qwen2-VL-7B language backbone [arXiv:2409.12191].

28L, d_model 3584, 28 heads (GQA kv=4), d_ff 18944, vocab 152064, QKV bias,
M-RoPE with (temporal, height, width) sections (16, 24, 24). The ViT vision
encoder + projector is a STUB: ``input_specs`` feeds precomputed patch
embeddings [B, S, d_model] plus 3-channel M-RoPE position ids.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm", source="arXiv:2409.12191",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, qkv_bias=True, rope="mrope", rope_base=1e6,
    mrope_sections=(16, 24, 24), norm="rmsnorm", act="swiglu",
)
