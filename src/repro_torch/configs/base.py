"""Architecture + input-shape configs of the port.

The port's own copy of ``repro/configs/base.py``, cut to the fields the
port's models read (the dense and MoE transformer families, DeepSeek-V3's
multi-head latent attention and multi-token prediction, Qwen2-VL's
M-RoPE sections, Whisper's encoder, the recurrent families' block
pattern, RG-LRU width and conv width) and the reference's input shapes
(``SHAPES``). ``reduced()`` and ``with_depth()``
follow the reference's rules for those fields, so a reduced or
depth-scaled config here equals the reference's field for field.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int            # expert FFN hidden dim
    n_shared: int = 0        # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLACfg:
    """DeepSeek-V3 multi-head latent attention dims."""
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class EncoderCfg:
    """Whisper-style encoder (consumes stub frame embeddings)."""
    n_layers: int = 12
    n_frames: int = 1500


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""                  # citation
    head_dim: int | None = None       # default d_model // n_heads
    rope: str = "rope"                # rope | mrope | learned | none
    rope_base: float = 10000.0
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    qkv_bias: bool = False
    window: int | None = None         # sliding-window attention
    moe: MoECfg | None = None
    moe_start_layer: int = 0          # leading dense layers (DeepSeek: 3)
    dense_ff: int | None = None       # FFN dim of those dense layers
    mla: MLACfg | None = None
    mtp: bool = False                 # multi-token-prediction head
    tied_embeddings: bool = False
    block_pattern: tuple[str, ...] | None = None  # kinds of a period
    d_rnn: int | None = None          # recurrent width (RG-LRU)
    conv_width: int = 4
    encoder: EncoderCfg | None = None
    frontend: str | None = None       # vision | audio (stubbed)
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | gelu | geglu
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    max_position: int = 32768         # learned-position table size

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else \
            self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True when long_500k decode is admissible (O(1) or O(window)
        state)."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers (one period of the block pattern
        for the patterned families), d_model <= 256, <= 4 heads,
        d_ff <= 512, vocab <= 512, window <= 64, <= 4 experts of top-2
        and d_expert <= 128, MLA ranks cut to the reference's (q_lora 64,
        kv_lora 32, qk_rope 16, qk_nope = v_dim = the head dim), the
        M-RoPE sections rescaled to the reduced head_dim // 2, an encoder
        of 2 layers over 64 frames, the RG-LRU width d_model, f32; same
        family structure."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kvh = min(self.n_kv_heads, heads)
        heads = (heads // kvh) * kvh
        kw: dict = {}
        if self.moe:
            kw["moe"] = replace(self.moe, n_experts=min(self.moe.n_experts, 4),
                                top_k=min(self.moe.top_k, 2),
                                d_expert=min(self.moe.d_expert, 128))
            kw["moe_start_layer"] = min(self.moe_start_layer, 1)
            kw["dense_ff"] = min(self.dense_ff, 256) if self.dense_ff else None
        if self.mla:
            kw["mla"] = MLACfg(q_lora=64, kv_lora=32, qk_nope=d // heads,
                               qk_rope=16, v_dim=d // heads)
        if self.rope == "mrope":
            d2 = (d // heads) // 2
            tot = sum(self.mrope_sections)
            secs = [max(1, (s * d2) // tot) for s in self.mrope_sections[:-1]]
            kw["mrope_sections"] = tuple(secs) + (d2 - sum(secs),)
        if self.encoder:
            kw["encoder"] = EncoderCfg(n_layers=2, n_frames=64)
        if self.d_rnn:
            kw["d_rnn"] = d
        n_layers = 2 if self.block_pattern is None else len(self.block_pattern)
        return replace(
            self, dtype="float32", n_layers=n_layers, d_model=d, n_heads=heads,
            n_kv_heads=kvh, head_dim=d // heads if self.head_dim else None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            window=min(self.window, 64) if self.window else None,
            max_position=512, **kw)

    def with_depth(self, periods: int) -> "ArchConfig":
        """Depth-scaled variant: ``periods`` repetitions of the block
        pattern, or ``periods`` layers of a uniform stack (with leading
        dense layers, one of them and ``periods`` MoE layers), every
        width kept exact."""
        if self.block_pattern is not None:
            return replace(self, n_layers=periods * len(self.block_pattern))
        if self.moe and self.moe_start_layer:
            return replace(self, moe_start_layer=1, n_layers=1 + periods)
        return replace(self, n_layers=periods)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
