"""Architecture + input-shape configs of the port.

The port's own copy of ``repro/configs/base.py``, cut to the fields the
port's models read (the dense transformer family). ``reduced()`` follows
the reference's rules for those fields, so a reduced config here equals
the reference's field for field.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense (the only family ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""                  # citation
    head_dim: int | None = None       # default d_model // n_heads
    rope: str = "rope"                # learned (the only kind ported)
    qkv_bias: bool = False
    tied_embeddings: bool = False
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | gelu | geglu
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    max_position: int = 32768         # learned-position table size

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else \
            self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, <= 4 heads,
        d_ff <= 512, vocab <= 512, f32; same family structure."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kvh = min(self.n_kv_heads, heads)
        heads = (heads // kvh) * kvh
        return replace(
            self, dtype="float32", n_layers=2, d_model=d, n_heads=heads,
            n_kv_heads=kvh, head_dim=d // heads if self.head_dim else None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512), max_position=512)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train (the only kind ported)
    seq: int
    batch: int
