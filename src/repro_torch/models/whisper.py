"""Whisper (Radford et al., arXiv:2212.04356): the encoder-decoder
backbone of ``repro/models/whisper.py``.

The mel spectrogram and conv feature extractor are the reference's stub:
the encoder takes precomputed frame embeddings ``frames`` [B, F, d_model].

* Encoder: bidirectional attention over the frames, fixed sinusoid
  positions (``sinusoids``), pre-norm LayerNorm and tanh GELU, a final
  LayerNorm.
* Decoder: causal self-attention, cross-attention to the encoder output,
  the GELU MLP; learned positions (``pos_embed``, clipped to
  ``max_position - 1``).
* Serving: ``prefill`` encodes the frames once and writes each layer's
  cross K/V (``xk``, ``xv`` of ``[L, B, F, KVH, hd]``) into the cache
  beside the self-attention's ``k``, ``v`` (``[L, B, cap, KVH, hd]``);
  ``decode_step`` attends one token against both, in place, under
  ``torch.inference_mode()``.

The norms, MLP and GQA attention and their parameter helpers are the
transformer's (``models/transformer.py``); the layer loops are Python
loops over the stacks (the reference's ``lax.scan``), without
rematerialisation.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.muon import ParamMeta

from .common import (attention, chunked_softmax_xent, decode_attention,
                     logits_last, sinusoids)
from .transformer import (_add_attn_params, _add_mlp_params,
                          _add_norm_params, _Builder, _check_ported,
                          _gqa_attn, _mlp, _norm)


def _add_cross_params(b: _Builder, cfg: ArchConfig, at: str, stack) -> None:
    d, hd = cfg.d_model, cfg.hd
    b.matrix(at + "wq", d, cfg.n_heads * hd, stack=stack)
    b.matrix(at + "wk", d, cfg.n_kv_heads * hd, stack=stack)
    b.matrix(at + "wv", d, cfg.n_kv_heads * hd, stack=stack)
    b.matrix(at + "wo", cfg.n_heads * hd, d, stack=stack,
             scale=1.0 / math.sqrt(cfg.n_heads * hd))


class WhisperModel:
    def __init__(self, cfg: ArchConfig):
        _check_ported(cfg, families=("audio",))
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name}: an audio config needs an encoder")
        self.cfg = cfg

    def init(self, generator: torch.Generator | None,
             device: str | torch.device = "cuda"):
        """(params, metas), drawn from ``generator`` on its device in the
        reference's order of leaves and moved to ``device``;
        ``device="meta"`` makes shapes only."""
        cfg = self.cfg
        b = _Builder(generator, getattr(torch, cfg.dtype),
                     torch.device(device))
        b.embed("embed", cfg.vocab, cfg.d_model)
        b.embed("pos_embed", cfg.max_position, cfg.d_model)
        b.matrix("unembed", cfg.d_model, cfg.vocab,
                 scale=1.0 / math.sqrt(cfg.d_model))
        b.metas["unembed"] = ParamMeta("sign", 1.0, 0)
        enc = (cfg.encoder.n_layers,)
        _add_norm_params(b, cfg, "enc_blocks/ln1", enc)
        _add_norm_params(b, cfg, "enc_blocks/ln2", enc)
        _add_attn_params(b, cfg, "enc_blocks/attn/", enc)
        _add_mlp_params(b, cfg, "enc_blocks/mlp", cfg.d_ff, enc)
        _add_norm_params(b, cfg, "enc_final_ln")
        dec = (cfg.n_layers,)
        for ln in ("ln1", "ln_x", "ln2"):
            _add_norm_params(b, cfg, f"dec_blocks/{ln}", dec)
        _add_attn_params(b, cfg, "dec_blocks/attn/", dec)
        _add_cross_params(b, cfg, "dec_blocks/xattn/", dec)
        _add_mlp_params(b, cfg, "dec_blocks/mlp", cfg.d_ff, dec)
        _add_norm_params(b, cfg, "final_ln")
        return b.params, b.metas

    # ---------------------------------------------------------------- encode
    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """The encoder's output [B, F, D] of ``frames`` [B, F, D]: the
        sinusoids (f32, cast to the model's dtype) added, bidirectional
        pre-norm blocks, the final LayerNorm."""
        cfg = self.cfg
        x = frames.to(getattr(torch, cfg.dtype))
        x = x + sinusoids(x.shape[1], cfg.d_model).to(x.device, x.dtype)[None]
        p = params["enc_blocks"]
        for l in range(cfg.encoder.n_layers):
            h = _norm(cfg, p, "ln1", x, l)
            a = _gqa_attn(cfg, p["attn"], l, h, None, None, None, "full",
                          causal=False)
            x = x + a @ p["attn"]["wo"][l]
            x = x + _mlp(cfg, p["mlp"], _norm(cfg, p, "ln2", x, l), l)
        return _norm(cfg, params, "enc_final_ln", x)

    # ---------------------------------------------------------------- decode
    def _cross_kv(self, params: dict, enc_out: torch.Tensor) -> dict:
        """Each decoder layer's cross-attention keys and values of the
        encoder output: {"xk", "xv"}, lists of [B, F, KVH, hd]."""
        cfg = self.cfg
        b_, f = enc_out.shape[:2]
        p = params["dec_blocks"]["xattn"]
        shape = (b_, f, cfg.n_kv_heads, cfg.hd)
        return {"xk": [(enc_out @ p["wk"][l]).reshape(shape)
                       for l in range(cfg.n_layers)],
                "xv": [(enc_out @ p["wv"][l]).reshape(shape)
                       for l in range(cfg.n_layers)]}

    def _decoder(self, params: dict, x: torch.Tensor, pos: torch.Tensor,
                 cache: dict | None, t: int | None, mode: str,
                 cross_kv: dict) -> torch.Tensor:
        """The decoder blocks over ``x`` [B, S, D], then the final norm.
        Self-attention writes and reads ``cache`` (prefill, decode); the
        cross-attention is bidirectional over the F frames in full and
        prefill modes and one query against all F in decode."""
        cfg = self.cfg
        p = params["dec_blocks"]
        b_, s = x.shape[:2]
        for l in range(cfg.n_layers):
            h = _norm(cfg, p, "ln1", x, l)
            x = x + _gqa_attn(cfg, p["attn"], l, h, pos, cache, t, mode) \
                @ p["attn"]["wo"][l]
            h = _norm(cfg, p, "ln_x", x, l)
            q = (h @ p["xattn"]["wq"][l]).reshape(b_, s, cfg.n_heads, cfg.hd)
            xk, xv = cross_kv["xk"][l], cross_kv["xv"][l]
            if mode == "decode":
                xa = decode_attention(q, xk, xv, kv_len=xk.shape[1])
            else:
                xa = attention(q, xk, xv, causal=False)
            x = x + xa.reshape(b_, s, -1) @ p["xattn"]["wo"][l]
            x = x + _mlp(cfg, p["mlp"], _norm(cfg, p, "ln2", x, l), l)
        return _norm(cfg, params, "final_ln", x)

    def _embed_tokens(self, params: dict, tokens: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens] + params["pos_embed"][
            torch.clamp(pos, 0, self.cfg.max_position - 1)]

    def hidden(self, params: dict, batch: dict) -> torch.Tensor:
        """The decoder's final hidden states [B, S, D] of ``batch``
        ({"frames", "tokens"}), every position at once."""
        cross_kv = self._cross_kv(params, self.encode(params,
                                                      batch["frames"]))
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = self._embed_tokens(params, tokens, pos)
        return self._decoder(params, x, pos, None, None, "full", cross_kv)

    # ------------------------------------------------------------------ loss
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` ({"frames" [B, F, D],
        "tokens", "labels" [B, S] int})."""
        return chunked_softmax_xent(self.hidden(params, batch),
                                    params["unembed"], batch["labels"])

    def unreached_leaves(self, batch: dict) -> frozenset:
        """Paths of the leaves ``loss`` does not reach: none."""
        return frozenset()

    # ----------------------------------------------------------------- cache
    def _cache_tree(self, batch_size: int, max_len: int, make) -> dict:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        lead = (cfg.n_layers, batch_size)
        head = (cfg.n_kv_heads, cfg.hd)
        own = lead + (max_len,) + head
        cross = lead + (cfg.encoder.n_frames,) + head
        return {"k": make(own, dt), "v": make(own, dt),
                "xk": make(cross, dt), "xv": make(cross, dt)}

    def cache_spec(self, batch_size: int, max_len: int) -> dict:
        """The cache's shapes and dtypes as meta tensors (no memory)."""
        return self._cache_tree(batch_size, max_len, lambda s, dt: torch.empty(
            s, dtype=dt, device="meta"))

    def init_cache(self, batch_size: int, max_len: int,
                   device: str | torch.device = "cuda") -> dict:
        dev = torch.device(device)
        return self._cache_tree(batch_size, max_len, lambda s, dt: torch.zeros(
            s, dtype=dt, device=dev))

    # --------------------------------------------------------------- serving
    @torch.inference_mode()
    def prefill(self, params: dict, batch: dict, cache: dict):
        """The prompt (``frames`` [B, F, D] and ``tokens`` [B, S]): the last
        position's f32 logits [B, V]; writes the cross K/V and the
        prompt's self-attention K/V into the cache in place and returns
        it."""
        cross_kv = self._cross_kv(params, self.encode(params,
                                                      batch["frames"]))
        for l in range(self.cfg.n_layers):
            cache["xk"][l] = cross_kv["xk"][l]
            cache["xv"][l] = cross_kv["xv"][l]
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        x = self._embed_tokens(params, tokens, pos)
        h = self._decoder(params, x, pos, cache, None, "prefill", cross_kv)
        return logits_last(h[:, -1], params["unembed"]), cache

    @torch.inference_mode()
    def decode_step(self, params: dict, batch: dict, cache: dict):
        """One token ``batch["token"]`` [B, 1] at position ``batch["t"]``
        against the cache: f32 logits [B, V]; writes self-attention slot
        ``t`` in place and returns the cache."""
        t = int(batch["t"])
        tok = batch["token"]
        pos = torch.full((1, 1), t, device=tok.device)
        x = self._embed_tokens(params, tok, pos)
        h = self._decoder(params, x, pos, cache, t, "decode",
                          {"xk": cache["xk"], "xv": cache["xv"]})
        return logits_last(h[:, -1], params["unembed"]), cache
