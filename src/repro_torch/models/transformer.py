"""Decoder-only transformer — the dense path of
``repro/models/transformer.py``: GQA attention with RoPE (or learned
positions), optional QKV bias and sliding window, SwiGLU / GeGLU / GELU
MLPs (GELU in the tanh form, ``jax.nn.gelu``'s default), RMSNorm or
LayerNorm, tied or untied embeddings.

Parameters are a nested dict of tensors with the reference's names and
layout: weights ``[in, out]``, the layers stacked ``[L, ...]`` under
``dense_blocks``, the tied unembedding is ``embed.T``, an untied one is
``unembed [d_model, vocab]``. The layer loop is a Python loop over the
stack (the reference's ``lax.scan``), without rematerialisation (the
reference CLI runs with ``remat=False``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.muon import ParamMeta

from .common import (apply_rope, attention, chunked_softmax_xent, embed_init,
                     layer_norm, matrix_init, rms_norm, vector_init)


def _check_ported(cfg: ArchConfig) -> None:
    why = []
    if cfg.family != "dense":
        why.append(f"family {cfg.family!r}")
    if cfg.rope not in ("rope", "learned", "none"):
        why.append(f"rope {cfg.rope!r}")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        why.append(f"norm {cfg.norm!r}")
    if cfg.act not in ("swiglu", "geglu", "gelu"):
        why.append(f"act {cfg.act!r}")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(why)} not ported to repro_torch yet "
            "(ROADMAP Queue 1 item 9, the other model families)")


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


def _gated(cfg: ArchConfig) -> bool:
    return cfg.act in ("swiglu", "geglu")


class Transformer:
    def __init__(self, cfg: ArchConfig):
        _check_ported(cfg)
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def _norm_params(self, b: _Builder, path: str, stack=()) -> None:
        b.vector(path + "_w", self.cfg.d_model, 1.0, stack=stack)
        if self.cfg.norm == "layernorm":
            b.vector(path + "_b", self.cfg.d_model, 0.0, stack=stack)

    def init(self, generator: torch.Generator | None,
             device: str | torch.device = "cuda"):
        """(params, metas). Weights are drawn from ``generator`` on its
        device, in the reference's order of leaves, and moved to
        ``device``; ``device="meta"`` makes shapes only."""
        cfg = self.cfg
        dev = torch.device(device)
        dtype = getattr(torch, cfg.dtype)
        b = _Builder(generator, dtype, dev)
        d, hd, ff, L = cfg.d_model, cfg.hd, cfg.d_ff, (cfg.n_layers,)
        b.embed("embed", cfg.vocab, d)
        if cfg.rope == "learned":
            b.embed("pos_embed", cfg.max_position, d)
        if not cfg.tied_embeddings:
            b.matrix("unembed", d, cfg.vocab, scale=1.0 / math.sqrt(d))
            # the sign LMO, as the embeddings (Scion's treatment)
            b.metas["unembed"] = ParamMeta("sign", 1.0, 0)
        self._norm_params(b, "final_ln")
        self._norm_params(b, "dense_blocks/ln1", L)
        self._norm_params(b, "dense_blocks/ln2", L)
        at = "dense_blocks/attn/"
        b.matrix(at + "wq", d, cfg.n_heads * hd, stack=L)
        b.matrix(at + "wk", d, cfg.n_kv_heads * hd, stack=L)
        b.matrix(at + "wv", d, cfg.n_kv_heads * hd, stack=L)
        b.matrix(at + "wo", cfg.n_heads * hd, d, stack=L,
                 scale=1.0 / math.sqrt(cfg.n_heads * hd))
        if cfg.qkv_bias:
            b.vector(at + "bq", cfg.n_heads * hd, 0.0, stack=L)
            b.vector(at + "bk", cfg.n_kv_heads * hd, 0.0, stack=L)
            b.vector(at + "bv", cfg.n_kv_heads * hd, 0.0, stack=L)
        if _gated(cfg):
            b.matrix("dense_blocks/mlp/w_gate", d, ff, stack=L)
        b.matrix("dense_blocks/mlp/w_up", d, ff, stack=L)
        b.matrix("dense_blocks/mlp/w_down", ff, d, stack=L,
                 scale=1.0 / math.sqrt(ff))
        return b.params, b.metas

    # ------------------------------------------------------------------ loss
    def _norm(self, p: dict, prefix: str, x: torch.Tensor,
              l: int | None = None) -> torch.Tensor:
        w = p[prefix + "_w"] if l is None else p[prefix + "_w"][l]
        if self.cfg.norm == "layernorm":
            bias = p[prefix + "_b"] if l is None else p[prefix + "_b"][l]
            return layer_norm(x, w, bias, self.cfg.norm_eps)
        return rms_norm(x, w, self.cfg.norm_eps)

    def _act(self, gate: torch.Tensor | None,
             up: torch.Tensor) -> torch.Tensor:
        act = self.cfg.act
        if act == "swiglu":
            return F.silu(gate.to(torch.float32)).to(up.dtype) * up
        if act == "geglu":
            return F.gelu(gate.to(torch.float32),
                          approximate="tanh").to(up.dtype) * up
        return F.gelu(up.to(torch.float32), approximate="tanh").to(up.dtype)

    def _block(self, p: dict, l: int, x: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        bsz, s, _ = x.shape
        at, mlp = p["attn"], p["mlp"]
        h = self._norm(p, "ln1", x, l)
        q, k, v = h @ at["wq"][l], h @ at["wk"][l], h @ at["wv"][l]
        if cfg.qkv_bias:
            q, k, v = q + at["bq"][l], k + at["bk"][l], v + at["bv"][l]
        q = q.reshape(bsz, s, cfg.n_heads, cfg.hd)
        k = k.reshape(bsz, s, cfg.n_kv_heads, cfg.hd)
        v = v.reshape(bsz, s, cfg.n_kv_heads, cfg.hd)
        if cfg.rope == "rope":
            q = apply_rope(q, pos[None], cfg.rope_base)
            k = apply_rope(k, pos[None], cfg.rope_base)
        a = attention(q, k, v, window=cfg.window)
        x = x + a.reshape(bsz, s, cfg.n_heads * cfg.hd) @ at["wo"][l]
        h = self._norm(p, "ln2", x, l)
        up = h @ mlp["w_up"][l]
        gate = h @ mlp["w_gate"][l] if _gated(cfg) else None
        return x + self._act(gate, up) @ mlp["w_down"][l]

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` ({"tokens",
        "labels"}: [B, S] int)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = params["embed"][tokens]
        if cfg.rope == "learned":
            x = x + params["pos_embed"][
                torch.clamp(pos, 0, cfg.max_position - 1)][None]
        for l in range(cfg.n_layers):
            x = self._block(params["dense_blocks"], l, x, pos)
        x = self._norm(params, "final_ln", x)
        unembed = (params["embed"].T if cfg.tied_embeddings
                   else params["unembed"])
        return chunked_softmax_xent(x, unembed, batch["labels"])
