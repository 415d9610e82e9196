"""NanoGPT-124M — the paper's own experimental model (Karpathy 2023,
paper §5: 12L, d_model 768, 12 heads, d_ff 3072, GPT-2 vocab 50304,
sequence 1024, tied embeddings, learned positions)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nanogpt-124m", family="dense", source="github:karpathy/nanoGPT",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=50304, rope="learned", norm="layernorm", act="gelu",
    norm_eps=1e-5, tied_embeddings=True, max_position=1024,
)
