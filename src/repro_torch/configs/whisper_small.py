"""Whisper-small decoder + encoder backbone [arXiv:2212.04356].

12L enc + 12L dec, d_model 768, 12 heads (MHA: kv=12), d_ff 3072,
vocab 51865, LayerNorm + GELU, learned decoder positions. The mel
spectrogram + conv frontend is a STUB: ``input_specs`` feeds precomputed
frame embeddings [B, 1500, d_model] to the encoder.
"""
from .base import ArchConfig, EncoderCfg

CONFIG = ArchConfig(
    name="whisper-small", family="audio", source="arXiv:2212.04356",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, rope="learned", norm="layernorm", act="gelu",
    norm_eps=1e-5, encoder=EncoderCfg(n_layers=12, n_frames=1500),
    frontend="audio", max_position=32768,
)
