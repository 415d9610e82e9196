"""Griffin / RecurrentGemma (De et al., arXiv:2402.19427): the port of
``repro/models/griffin.py``.

Residual blocks with a temporal-mixing layer (an RG-LRU recurrent block
or local sliding-window MQA attention, pattern rec:rec:attn), each
followed by a GeGLU MLP block (tanh GELU).

Recurrent block: x -> [GELU gate branch] * [causal depthwise conv (width
4) -> RG-LRU] -> out projection, where

    r_t = sigmoid(W_r x_t + b_r),  i_t = sigmoid(W_i x_t + b_i)
    a_t = exp(-c * softplus(lam) * r_t)            (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

in f32. Training and prefill evaluate the linear recurrence as a
log-depth (Hillis-Steele) scan of the combine ``(a1 a2, a2 b1 + b2)``:
ceil(log2 S) levels of elementwise ops on ``[B, S, d_rnn]``, so autograd
gives its backward (the reference's ``jax.lax.associative_scan``; its
combine order is XLA's, so the two agree within f32 rounding, not bit
for bit). Decode is the exact one-step cell ``rglru_step``.

Parameters, as the reference's: the ``block_pattern`` periods stacked
``[n_periods, n_rec | n_attn | len(pattern), ...]`` under ``blocks``
(``rec``, ``attn``, ``mlp``), and the pattern's remainder (26 layers = 8
full periods + 2 recurrent layers) as its own stack ``rem`` of one
period; the unembedding is the tied ``embed.T``. The attention blocks
reuse the transformer's ``_gqa_attn`` (RoPE, the window, the ring cache).

Cache (O(1) in the sequence, but for the attention's ring): per group
``{"rec": {"h": [P, n_rec, B, d_rnn] f32, "conv": [P, n_rec, B, W-1,
d_rnn]}, "attn": {"k", "v": [P, n_attn, B, cap, KVH, hd]}}`` with ``cap =
min(window, max_len)``; a group without a kind has no entry (the
reference's None). Prefill's conv tail is the last ``W-1`` inputs of the
conv, not its outputs. ``prefill`` and ``decode_step`` run under
``torch.inference_mode()`` and write the cache in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from .common import chunked_softmax_xent, logits_last, slot
from .transformer import (_add_attn_params, _add_mlp_params,
                          _add_norm_params, _Builder, _check_ported,
                          _gqa_attn, _mlp, _norm)

LRU_C = 8.0
KINDS = ("rec", "attn")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ------------------------------------------------------------------- RG-LRU

def _add_rec_params(b: _Builder, cfg: ArchConfig, path: str, stack) -> None:
    d, dr, w = cfg.d_model, cfg.d_rnn, cfg.conv_width
    _add_norm_params(b, cfg, path + "/ln", stack)
    b.matrix(path + "/w_gate", d, dr, stack=stack)
    b.matrix(path + "/w_x", d, dr, stack=stack)
    b.matrix(path + "/conv_w", w, dr, stack=stack, scale=1.0 / math.sqrt(w))
    b.vector(path + "/conv_b", dr, 0.0, stack=stack)
    b.matrix(path + "/w_r", dr, dr, stack=stack)
    b.vector(path + "/b_r", dr, 0.0, stack=stack)
    b.matrix(path + "/w_i", dr, dr, stack=stack)
    b.vector(path + "/b_i", dr, 0.0, stack=stack)
    # the reference's constant at every entry (its "set below" sets nothing)
    b.vector(path + "/lam", dr, 0.649, stack=stack)
    b.matrix(path + "/w_out", dr, d, stack=stack, scale=1.0 / math.sqrt(dr))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv in x's dtype. x [B,S,D], w [W,D], b [D];
    ``tail`` [B,W-1,D] the previous inputs (decode), zeros when None.
    Returns (y [B,S,D], the last W-1 inputs)."""
    width, s = w.shape[0], x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    new_tail = xp[:, xp.shape[1] - (width - 1):] if width > 1 else tail
    return y + b, new_tail


def _gates(x: torch.Tensor, p: dict):
    """(x in f32, log a_t, i_t) of the RG-LRU."""
    f32 = torch.float32
    xf = x.to(f32)
    r = torch.sigmoid(xf @ p["w_r"].to(f32) + p["b_r"].to(f32))
    i = torch.sigmoid(xf @ p["w_i"].to(f32) + p["b_i"].to(f32))
    log_a = -LRU_C * _softplus(p["lam"].to(f32)) * r
    return xf, log_a, i


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, as a
    Hillis-Steele scan of the combine ``(a1 a2, a2 b1 + b2)``: at level
    ``k`` every position t >= 2^k folds in the prefix ending at t - 2^k.
    ceil(log2 S) levels of elementwise ops (no loop over S, and no
    ``exp(cumsum(log a))``, which overflows within a few steps)."""
    s, shift = a.shape[1], 1
    while shift < s:
        a_hi, b_hi = a[:, shift:], b[:, shift:]
        b = torch.cat([b[:, :shift], a_hi * b[:, :s - shift] + b_hi], dim=1)
        a = torch.cat([a[:, :shift], a_hi * a[:, :s - shift]], dim=1)
        shift *= 2
    return b


def rglru(x: torch.Tensor, p: dict, h0: torch.Tensor | None):
    """RG-LRU over a sequence: x [B,S,Dr]; ``p`` one layer's {"w_r",
    "b_r", "w_i", "b_i", "lam"}; h0 [B,Dr] or None. Returns (y [B,S,Dr]
    in x's dtype, h_last [B,Dr] f32)."""
    xf, log_a, i = _gates(x, p)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * xf)
    if h0 is not None:
        # the carried state as a virtual timestep 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        gated = torch.cat([h0.to(torch.float32)[:, None], gated], dim=1)
    hh = linear_scan(a, gated)
    if h0 is not None:
        hh = hh[:, 1:]
    return hh.to(x.dtype), hh[:, -1]


def rglru_step(x: torch.Tensor, p: dict, h: torch.Tensor):
    """One RG-LRU step: x [B,Dr], h [B,Dr] (f32). Returns (y in x's
    dtype, h_new f32)."""
    xf, log_a, i = _gates(x, p)
    a = torch.exp(log_a)
    h_new = a * h.to(torch.float32) + torch.sqrt(
        torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return h_new.to(x.dtype), h_new


def _rec_block(cfg: ArchConfig, p: dict, l: int, x: torch.Tensor,
               cache: dict | None, mode: str) -> torch.Tensor:
    """Recurrent block ``l`` of a period's stack ``p``; prefill and decode
    write ``cache["h"][l]`` and ``cache["conv"][l]`` in place."""
    h = _norm(cfg, p, "ln", x, l)
    gate = F.gelu((h @ p["w_gate"][l]).to(torch.float32),
                  approximate="tanh").to(x.dtype)
    xr_in = h @ p["w_x"][l]
    tail = cache["conv"][l] if mode == "decode" else None
    xr, new_tail = _causal_conv(xr_in, p["conv_w"][l], p["conv_b"][l], tail)
    lru = {k: p[k][l] for k in ("w_r", "b_r", "w_i", "b_i", "lam")}
    if mode == "decode":
        y, h_new = rglru_step(xr[:, 0], lru, cache["h"][l])
        y = y[:, None]
        cache["h"][l] = h_new
        cache["conv"][l] = new_tail
    else:
        y, h_last = rglru(xr, lru, None)
        if mode == "prefill":
            width = cfg.conv_width
            pad_in = F.pad(xr_in, (0, 0, width - 1, 0))
            cache["h"][l] = h_last
            cache["conv"][l] = pad_in[:, pad_in.shape[1] - (width - 1):]
    return x + (gate * y) @ p["w_out"][l]


def _attn_block(cfg: ArchConfig, p: dict, l: int, x: torch.Tensor,
                pos: torch.Tensor, cache: dict | None, t: int | None,
                mode: str) -> torch.Tensor:
    """Local MQA attention block ``l`` (the transformer's ``_gqa_attn``:
    RoPE, the window, the ring cache)."""
    h = _norm(cfg, p, "ln", x, l)
    a = _gqa_attn(cfg, p["attn"], l, h, pos, cache, t, mode)
    return x + a @ p["attn"]["wo"][l]


def _mlp_block(cfg: ArchConfig, p: dict, l: int,
               x: torch.Tensor) -> torch.Tensor:
    return x + _mlp(cfg, p["mlp"], _norm(cfg, p, "ln", x, l), l)


# -------------------------------------------------------------------- model

class GriffinModel:
    def __init__(self, cfg: ArchConfig):
        _check_ported(cfg, families=("hybrid",))
        pat = cfg.block_pattern
        if not pat or set(pat) - set(KINDS) or cfg.d_rnn is None:
            raise ValueError(f"{cfg.name}: a hybrid config needs a "
                             f"block_pattern of {KINDS} and d_rnn")
        self.cfg = cfg
        self.pat = tuple(pat)
        self.n_periods = cfg.n_layers // len(pat)
        self.rem = tuple(pat[:cfg.n_layers % len(pat)])

    def _groups(self):
        """(name, periods, pattern, recurrent slots, attention slots) of
        each stack: the periods, then the remainder (one period of the
        pattern's first kinds)."""
        groups = [("blocks", self.n_periods, self.pat)]
        if self.rem:
            groups.append(("rem", 1, self.rem))
        return [(name, nper, pat, pat.count("rec"), pat.count("attn"))
                for name, nper, pat in groups]

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator | None,
             device: str | torch.device = "cuda"):
        """(params, metas), drawn from ``generator`` on its device in the
        reference's order of leaves and moved to ``device``;
        ``device="meta"`` makes shapes only."""
        cfg = self.cfg
        b = _Builder(generator, getattr(torch, cfg.dtype),
                     torch.device(device))
        b.embed("embed", cfg.vocab, cfg.d_model)
        _add_norm_params(b, cfg, "final_ln")
        for prefix, nper, pattern, n_rec, n_attn in self._groups():
            if n_rec:
                _add_rec_params(b, cfg, f"{prefix}/rec", (nper, n_rec))
            if n_attn:
                stack = (nper, n_attn)
                _add_norm_params(b, cfg, f"{prefix}/attn/ln", stack)
                _add_attn_params(b, cfg, f"{prefix}/attn/attn/", stack)
            stack = (nper, len(pattern))
            _add_norm_params(b, cfg, f"{prefix}/mlp/ln", stack)
            _add_mlp_params(b, cfg, f"{prefix}/mlp/mlp", cfg.d_ff, stack)
        return b.params, b.metas

    # ------------------------------------------------------------------- run
    def _run(self, params: dict, x: torch.Tensor, pos: torch.Tensor,
             cache: dict | None = None, t: int | None = None,
             mode: str = "full") -> torch.Tensor:
        """Every group's periods in order, each slot's temporal block then
        its MLP block; then the final norm."""
        cfg = self.cfg
        for name, nper, pattern, _, _ in self._groups():
            gp = params[name]
            gc = cache[name] if cache is not None else None
            for i in range(nper):
                pp = slot(gp, i)
                cc = slot(gc, i) if gc is not None else None
                ir = ia = 0
                for j, kind in enumerate(pattern):
                    if kind == "rec":
                        x = _rec_block(cfg, pp["rec"], ir, x,
                                       cc["rec"] if cc else None, mode)
                        ir += 1
                    else:
                        x = _attn_block(cfg, pp["attn"], ia, x, pos,
                                        cc["attn"] if cc else None, t, mode)
                        ia += 1
                    x = _mlp_block(cfg, pp["mlp"], j, x)
        return _norm(cfg, params, "final_ln", x)

    def hidden(self, params: dict, batch: dict) -> torch.Tensor:
        """The final hidden states [B, S, D] of ``batch["tokens"]``."""
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        return self._run(params, params["embed"][tokens], pos)

    def _unembed(self, params: dict) -> torch.Tensor:
        # RecurrentGemma ties the unembedding to the input embedding
        return params["embed"].T

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` ({"tokens",
        "labels"}: [B, S] int)."""
        return chunked_softmax_xent(self.hidden(params, batch),
                                    self._unembed(params), batch["labels"])

    def unreached_leaves(self, batch: dict) -> frozenset:
        """Paths of the leaves ``loss`` does not reach: none."""
        return frozenset()

    # ----------------------------------------------------------------- cache
    def _cache_tree(self, batch_size: int, max_len: int, make) -> dict:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        cap = min(cfg.window or max_len, max_len)
        out = {}
        for name, nper, _, n_rec, n_attn in self._groups():
            group = {}
            if n_rec:
                lead = (nper, n_rec, batch_size)
                group["rec"] = {
                    "h": make(lead + (cfg.d_rnn,), torch.float32),
                    "conv": make(lead + (cfg.conv_width - 1, cfg.d_rnn), dt)}
            if n_attn:
                shape = (nper, n_attn, batch_size, cap, cfg.n_kv_heads,
                         cfg.hd)
                group["attn"] = {"k": make(shape, dt), "v": make(shape, dt)}
            out[name] = group
        return out

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
        """The prompt ``batch["tokens"]`` [B, S]: the last position's f32
        logits [B, V]; writes the cache in place and returns it."""
        tokens = batch["tokens"]
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
        h = self._run(params, params["embed"][tokens], pos, cache, None,
                      "prefill")
        return logits_last(h[:, -1], self._unembed(params)), cache

    @torch.inference_mode()
    def decode_step(self, params: dict, batch: dict, cache: dict):
        """One token ``batch["token"]`` [B, 1] at position ``batch["t"]``
        against the cache: f32 logits [B, V]; advances the recurrent
        states and writes ring slot ``t % cap`` in place."""
        t = int(batch["t"])
        tok = batch["token"]
        pos = torch.full((1, 1), t, device=tok.device)
        h = self._run(params, params["embed"][tok], pos, cache, t, "decode")
        return logits_last(h[:, -1], self._unembed(params)), cache
