"""Decoder-only transformer — the dense nanogpt path of
``repro/models/transformer.py``: learned positions, LayerNorm, GELU MLP
(tanh form, ``jax.nn.gelu``'s default), multi-head attention, tied
embeddings.

Parameters are a nested dict of tensors with the reference's names and
layout: weights ``[in, out]``, the layers stacked ``[L, ...]`` under
``dense_blocks``, the tied unembedding is ``embed.T``. The layer loop is
a Python loop over the stack (the reference's ``lax.scan``), without
rematerialisation (the reference CLI runs with ``remat=False``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from .common import (attention, chunked_softmax_xent, embed_init, layer_norm,
                     matrix_init, vector_init)


def _check_ported(cfg: ArchConfig) -> None:
    why = []
    if cfg.family != "dense":
        why.append(f"family {cfg.family!r}")
    if cfg.rope != "learned":
        why.append(f"rope {cfg.rope!r}")
    if cfg.norm != "layernorm":
        why.append(f"norm {cfg.norm!r}")
    if cfg.act != "gelu":
        why.append(f"act {cfg.act!r}")
    if cfg.qkv_bias:
        why.append("qkv_bias")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(why)} not ported to repro_torch yet "
            "(ROADMAP Queue 1 item 9, the rest of the model zoo)")


class _Builder:
    """Accumulates (params, metas) dicts with identical structure."""

    def __init__(self, generator, dtype, device):
        self.generator, self.dtype, self.device = generator, dtype, device
        self.params: dict = {}
        self.metas: dict = {}

    def matrix(self, path, in_dim, out_dim, stack=(), scale=None):
        self._set(path, *matrix_init(self.generator, in_dim, out_dim,
                                     self.dtype, self.device, stack=stack,
                                     scale=scale))

    def vector(self, path, dim, value, stack=()):
        self._set(path, *vector_init(dim, value, self.dtype, self.device,
                                     stack=stack))

    def embed(self, path, vocab, dim):
        self._set(path, *embed_init(self.generator, vocab, dim, self.dtype,
                                    self.device))

    def _set(self, path: str, p, m):
        *parents, leaf = path.split("/")
        d_p, d_m = self.params, self.metas
        for k in parents:
            d_p = d_p.setdefault(k, {})
            d_m = d_m.setdefault(k, {})
        d_p[leaf] = p
        d_m[leaf] = m


class Transformer:
    def __init__(self, cfg: ArchConfig):
        _check_ported(cfg)
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator | None,
             device: str | torch.device = "cuda"):
        """(params, metas). Weights are drawn on the CPU from
        ``generator`` and moved to ``device``; ``device="meta"`` makes
        shapes only."""
        cfg = self.cfg
        dev = torch.device(device)
        dtype = getattr(torch, cfg.dtype)
        b = _Builder(generator, dtype, dev)
        d, hd, ff, L = cfg.d_model, cfg.hd, cfg.d_ff, (cfg.n_layers,)
        b.embed("embed", cfg.vocab, d)
        b.embed("pos_embed", cfg.max_position, d)
        b.vector("final_ln_w", d, 1.0)
        b.vector("final_ln_b", d, 0.0)
        for ln in ("ln1", "ln2"):
            b.vector(f"dense_blocks/{ln}_w", d, 1.0, stack=L)
            b.vector(f"dense_blocks/{ln}_b", d, 0.0, stack=L)
        b.matrix("dense_blocks/attn/wq", d, cfg.n_heads * hd, stack=L)
        b.matrix("dense_blocks/attn/wk", d, cfg.n_kv_heads * hd, stack=L)
        b.matrix("dense_blocks/attn/wv", d, cfg.n_kv_heads * hd, stack=L)
        b.matrix("dense_blocks/attn/wo", cfg.n_heads * hd, d, stack=L,
                 scale=1.0 / math.sqrt(cfg.n_heads * hd))
        b.matrix("dense_blocks/mlp/w_up", d, ff, stack=L)
        b.matrix("dense_blocks/mlp/w_down", ff, d, stack=L,
                 scale=1.0 / math.sqrt(ff))
        return b.params, b.metas

    # ------------------------------------------------------------------ loss
    def _block(self, p: dict, l: int, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        bsz, s, _ = x.shape
        at, mlp = p["attn"], p["mlp"]
        h = layer_norm(x, p["ln1_w"][l], p["ln1_b"][l], cfg.norm_eps)
        q = (h @ at["wq"][l]).reshape(bsz, s, cfg.n_heads, cfg.hd)
        k = (h @ at["wk"][l]).reshape(bsz, s, cfg.n_kv_heads, cfg.hd)
        v = (h @ at["wv"][l]).reshape(bsz, s, cfg.n_kv_heads, cfg.hd)
        a = attention(q, k, v)
        x = x + a.reshape(bsz, s, cfg.n_heads * cfg.hd) @ at["wo"][l]
        h = layer_norm(x, p["ln2_w"][l], p["ln2_b"][l], cfg.norm_eps)
        up = h @ mlp["w_up"][l]
        act = F.gelu(up.to(torch.float32), approximate="tanh").to(up.dtype)
        return x + act @ mlp["w_down"][l]

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` ({"tokens",
        "labels"}: [B, S] int)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        s = tokens.shape[1]
        pos = torch.clamp(torch.arange(s, device=tokens.device), 0,
                          cfg.max_position - 1)
        x = params["embed"][tokens] + params["pos_embed"][pos][None]
        for l in range(cfg.n_layers):
            x = self._block(params["dense_blocks"], l, x)
        x = layer_norm(x, params["final_ln_w"], params["final_ln_b"],
                       cfg.norm_eps)
        return chunked_softmax_xent(x, params["embed"].T, batch["labels"])
