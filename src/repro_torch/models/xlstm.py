"""xLSTM (Beck et al., arXiv:2405.04517): the port of
``repro/models/xlstm.py``, mLSTM and sLSTM blocks.

* mLSTM: matrix-memory LSTM with exponential gating. Training and
  prefill use the chunkwise-parallel form (``mlstm_chunkwise``: an
  attention-like pass inside each chunk of ``CHUNK`` steps plus the
  carried state between chunks, log-space stabilised), a Python loop over
  the chunks; decode is the exact cell ``mlstm_step``.
* sLSTM: scalar-memory LSTM with exponential gating and block-diagonal
  per-head recurrent weights ``r_gates`` [.., 4, H, hd, hd]; inherently
  serial: a Python loop over time (``slstm_step``), ~20 elementwise
  launches a step.

Both loops run under autograd (the reference's ``lax.scan``). Blocks are
pre-norm residual: the mLSTM block up-projects by 2 (the FFN role; the
config has d_ff = 0), the sLSTM block is followed by a GeGLU up/down
projection of 4/3 (tanh GELU). Parameters are stacked ``[n_periods,
slots, ...]`` under ``m_blocks`` (7 a period for xLSTM[7:1]) and
``s_blocks`` (1); the unembedding ``unembed`` is untied, with the sign
LMO.

Precision, as the reference's: q, k and v stay in the model's dtype; the
chunkwise products take f32 copies of their operands (the reference's
bf16 dots with ``preferred_element_type=f32``: the products of two bf16
values are exact in f32, and TF32 is off), and the intermediates are
rounded to the model's dtype at the reference's points only (the scores
and ``D`` before their products with v and k, the carried ``c`` before
q's product, ``n`` before q's, the state update's weights before k's).
Log-space masks are the finite ``-1e30`` (``-inf - -inf`` is NaN).

Cache (all f32, O(1) in the sequence): ``{"m_blocks": {"c": [P, n_m, B,
H, hd, hd], "n": [P, n_m, B, H, hd], "m": [P, n_m, B, H]}, "s_blocks":
{"c", "n", "h", "m": [P, n_s, B, d]}}``. As in the reference, prefill
starts every mLSTM block from a zero state, whatever the cache holds.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.muon import ParamMeta

from .common import (acc_dtype, chunked_softmax_xent, logits_last, rms_norm,
                     slot)
from .transformer import _add_norm_params, _Builder, _check_ported, _norm

CHUNK = 256
NEG = -1e30
KINDS = ("m", "s")


# ------------------------------------------------------------------- mLSTM

def _mlstm_dims(cfg: ArchConfig) -> tuple[int, int]:
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // cfg.n_heads


def _add_mlstm_params(b: _Builder, cfg: ArchConfig, path: str, stack) -> None:
    d = cfg.d_model
    d_inner, _ = _mlstm_dims(cfg)
    _add_norm_params(b, cfg, path + "/ln", stack)
    b.matrix(path + "/w_up", d, 2 * d_inner, stack=stack)
    for n in ("wq", "wk", "wv"):
        b.matrix(path + f"/{n}", d_inner, d_inner, stack=stack)
    b.matrix(path + "/w_if", d_inner, 2 * cfg.n_heads, stack=stack)
    b.vector(path + "/b_i", cfg.n_heads, 0.0, stack=stack)
    # forget bias ~ +3..6 keeps early training stable (paper App. B)
    b.vector(path + "/b_f", cfg.n_heads, 4.0, stack=stack)
    b.vector(path + "/ln_out_w", d_inner, 1.0, stack=stack)
    b.matrix(path + "/w_down", d_inner, d, stack=stack,
             scale=1.0 / math.sqrt(d_inner))


def _mlstm_gates(cfg: ArchConfig, p: dict, l: int, xm: torch.Tensor):
    """(log_i, log_f) pre-activations [B, S, H] in f32."""
    gif = _acc(xm @ p["w_if"][l])
    h = cfg.n_heads
    log_i = gif[..., :h] + p["b_i"][l].to(gif.dtype)
    log_f = F.logsigmoid(gif[..., h:] + p["b_f"][l].to(gif.dtype))
    return log_i, log_f


def _mlstm_qkv(cfg: ArchConfig, p: dict, l: int, xm: torch.Tensor):
    """q, k, v [B, S, H, hd] in the model's dtype; k divided by sqrt(hd)
    in that dtype."""
    b_, s, _ = xm.shape
    _, hd = _mlstm_dims(cfg)
    shp = (b_, s, cfg.n_heads, hd)
    q = (xm @ p["wq"][l]).reshape(shp)
    k = (xm @ p["wk"][l]).reshape(shp) / math.sqrt(hd)
    v = (xm @ p["wv"][l]).reshape(shp)
    return q, k, v


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in f32 (f64 in a float64 model: ``common.acc_dtype``)."""
    return x.to(acc_dtype(x.dtype))


def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, chunk: int = CHUNK):
    """Chunkwise-parallel stabilised mLSTM.

    q, k, v [B,S,H,hd]; log_i, log_f [B,S,H] f32; state = (c [B,H,hd,hd],
    n [B,H,hd], m [B,H]) or None. Returns (h [B,S,H,hd] in v's dtype,
    state' f32). The state is stored stabilised: the true C is ``c *
    exp(m)``. A ragged tail is padded with ``log_i = -1e30`` (weight 0)
    and ``log_f = 0``."""
    b_, s, nh, hd = q.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    nc = (s + pad) // chunk

    def chunks(a):     # [B, S, H, ...] -> [nc, B, H, chunk, ...]
        a = a.reshape((b_, nc, chunk, nh) + tuple(a.shape[3:]))
        return a.transpose(2, 3).transpose(0, 1)

    qc, kc, vc, ic, fc = (chunks(a) for a in (q, k, v, log_i, log_f))
    acc = acc_dtype(q.dtype)
    dev = q.device
    if state is None:
        c_st = torch.zeros((b_, nh, hd, hd), dtype=acc, device=dev)
        n_st = torch.zeros((b_, nh, hd), dtype=acc, device=dev)
        m_st = torch.full((b_, nh), NEG, dtype=acc, device=dev)
    else:
        c_st, n_st, m_st = (_acc(a) for a in state)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))
    hs = []
    for j in range(nc):
        qb, kb, vb, ib, fb = qc[j], kc[j], vc[j], ic[j], fc[j]
        qf, kf, vf = _acc(qb), _acc(kb), _acc(vb)
        cum = torch.cumsum(fb, dim=-1)     # inclusive cumulative log-forget
        # log weight of key j for query i (j <= i): F_i - F_j + i_j
        lw = cum[..., :, None] - cum[..., None, :] + ib[..., None, :]
        lw = torch.where(tri, lw, NEG)
        b_inter = cum + m_st[..., None]                       # [B,H,c]
        m_loc = torch.maximum(torch.amax(lw, dim=-1), b_inter)
        m_loc = torch.clamp(m_loc, min=NEG)
        d_mat = torch.exp(lw - m_loc[..., None])              # [B,H,c,c]
        scores = (qf @ kf.transpose(-1, -2)) * d_mat
        inter = torch.exp(b_inter - m_loc)[..., None]         # [B,H,c,1]
        num = (_acc(scores.to(vb.dtype)) @ vf
               + inter * (qf @ _acc(c_st.to(qb.dtype))))
        # normaliser n_i = sum_j D_ij k_j + inter_i * n_state
        n_vec = _acc(d_mat.to(kb.dtype)) @ kf + inter * n_st[:, :, None, :]
        qn = torch.abs(torch.sum(qf * _acc(n_vec.to(qb.dtype)), dim=-1))
        den = torch.maximum(qn, torch.exp(-m_loc))
        hs.append(num / den[..., None])
        # the state at the chunk's end
        f_tot = cum[..., -1]                                  # [B,H]
        dk = f_tot[..., None] - cum + ib                      # [B,H,c]
        m_new = torch.maximum(f_tot + m_st, torch.amax(dk, dim=-1))
        sc = _acc(torch.exp(dk - m_new[..., None]).to(kb.dtype))
        decay = torch.exp(f_tot + m_st - m_new)
        skf = sc[..., None] * kf                              # [B,H,c,hd]
        c_st = decay[..., None, None] * c_st + skf.transpose(-1, -2) @ vf
        n_st = decay[..., None] * n_st + torch.sum(skf, dim=-2)
        m_st = m_new
    h = torch.stack(hs, 0).transpose(0, 1).transpose(2, 3)
    h = h.reshape(b_, nc * chunk, nh, hd)[:, :s]
    return h.to(v.dtype), (c_st, n_st, m_st)


def mlstm_step(q, k, v, log_i, log_f, state):
    """Exact sequential mLSTM cell (decode; also the chunkwise oracle).

    q, k, v [B,H,hd]; log_i, log_f [B,H]; state as in
    ``mlstm_chunkwise``. Returns (h [B,H,hd] in v's dtype, state' f32)."""
    out_dtype = v.dtype
    c_st, n_st, m_st = (_acc(a) for a in state)
    q, k, v = (_acc(a) for a in (q, k, v))
    m_new = torch.maximum(log_f + m_st, log_i)
    f_sc = torch.exp(log_f + m_st - m_new)
    i_sc = torch.exp(log_i - m_new)
    c_new = (f_sc[..., None, None] * c_st
             + i_sc[..., None, None] * k[..., :, None] * v[..., None, :])
    n_new = f_sc[..., None] * n_st + i_sc[..., None] * k
    num = (q[..., None, :] @ c_new)[..., 0, :]
    den = torch.maximum(torch.abs(torch.sum(q * n_new, dim=-1)),
                        torch.exp(-m_new))
    h = num / den[..., None]
    return h.to(out_dtype), (c_new, n_new, m_new)


def _mlstm_block(cfg: ArchConfig, p: dict, l: int, x: torch.Tensor,
                 cache: dict | None, mode: str) -> torch.Tensor:
    """mLSTM block ``l`` of a period's stack ``p``; prefill and decode
    write ``cache[...][l]`` in place."""
    d_inner, _ = _mlstm_dims(cfg)
    h = _norm(cfg, p, "ln", x, l)
    up = h @ p["w_up"][l]
    xm, z = up[..., :d_inner], up[..., d_inner:]
    q, k, v = _mlstm_qkv(cfg, p, l, xm)
    log_i, log_f = _mlstm_gates(cfg, p, l, xm)
    if mode == "decode":
        state = (cache["c"][l], cache["n"][l], cache["m"][l])
        hq, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_i[:, 0],
                               log_f[:, 0], state)
        hv = hq[:, None]
    else:
        # the reference starts prefill from a zero state too
        hv, state = mlstm_chunkwise(q, k, v, log_i, log_f, state=None)
    if mode in ("prefill", "decode"):
        for key, val in zip(("c", "n", "m"), state):
            cache[key][l] = val
    b_, s = x.shape[:2]
    hv = rms_norm(hv.reshape(b_, s, d_inner), p["ln_out_w"][l], cfg.norm_eps)
    gate = F.silu(_acc(z)).to(z.dtype)
    return x + (hv * gate) @ p["w_down"][l]


# ------------------------------------------------------------------- sLSTM

def _slstm_ff(cfg: ArchConfig) -> int:
    return ((4 * cfg.d_model // 3 + 63) // 64) * 64


def _add_slstm_params(b: _Builder, cfg: ArchConfig, path: str, stack) -> None:
    d = cfg.d_model
    hd = d // cfg.n_heads
    _add_norm_params(b, cfg, path + "/ln", stack)
    b.matrix(path + "/w_gates", d, 4 * d, stack=stack)     # z, i, f, o
    # block-diagonal recurrent weights per gate and head: [4, H, hd, hd]
    b.matrix(path + "/r_gates", hd, hd, stack=stack + (4, cfg.n_heads))
    b.vector(path + "/b_i", d, 0.0, stack=stack)
    b.vector(path + "/b_f", d, 4.0, stack=stack)
    b.vector(path + "/ln_out_w", d, 1.0, stack=stack)
    ff = _slstm_ff(cfg)
    b.matrix(path + "/w_up_gate", d, ff, stack=stack)
    b.matrix(path + "/w_up", d, ff, stack=stack)
    b.matrix(path + "/w_down", ff, d, stack=stack,
             scale=1.0 / math.sqrt(ff))


def slstm_step(cfg: ArchConfig, p: dict, gates_x, state):
    """One sLSTM timestep. ``p`` one layer's {"r_gates" [4,H,hd,hd],
    "b_i", "b_f" [D]}; gates_x [B, 4, D] (the input's contributions);
    state = (c, n, h, m), each [B, D]. Returns the new state, f32."""
    nh, d = cfg.n_heads, cfg.d_model
    hd = d // nh
    c, n, h, m = (_acc(a) for a in state)
    hh = h.reshape(-1, nh, hd).transpose(0, 1)                # [H,B,hd]
    rec = (hh[None] @ _acc(p["r_gates"])).transpose(1, 2)     # [4,B,H,hd]
    rec = rec.reshape(4, -1, d)
    pre = _acc(gates_x).transpose(0, 1) + rec                 # [4,B,D]
    z_pre, i_pre, f_pre, o_pre = pre.unbind(0)
    i_pre = i_pre + p["b_i"].to(pre.dtype)
    log_f = F.logsigmoid(f_pre + p["b_f"].to(pre.dtype))
    m_new = torch.maximum(log_f + m, i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(log_f + m - m_new)
    c_new = f_sc * c + i_sc * torch.tanh(z_pre)
    n_new = torch.clamp(f_sc * n + i_sc, min=1e-6)
    h_new = torch.sigmoid(o_pre) * c_new / n_new
    return (c_new, n_new, h_new, m_new)


def _slstm_block(cfg: ArchConfig, p: dict, l: int, x: torch.Tensor,
                 cache: dict | None, mode: str) -> torch.Tensor:
    """sLSTM block ``l`` of a period's stack ``p``: the serial scan from
    ``n = 1e-6``, ``m = -1e30`` (or one step from the cache in decode),
    then its GeGLU projection."""
    b_, s, d = x.shape
    hin = _norm(cfg, p, "ln", x, l)
    gates_x = (hin @ p["w_gates"][l]).reshape(b_, s, 4, d)
    cell = {k: p[k][l] for k in ("b_i", "b_f")}
    cell["r_gates"] = _acc(p["r_gates"][l])       # cast once, not per step
    if mode == "decode":
        state = slstm_step(cfg, cell, gates_x[:, 0],
                           tuple(cache[k][l] for k in ("c", "n", "h", "m")))
        hs = state[2][:, None].to(x.dtype)
    else:
        z0 = torch.zeros((b_, d), dtype=acc_dtype(x.dtype), device=x.device)
        state = (z0, z0 + 1e-6, z0, z0 + NEG)
        outs = []
        for t in range(s):
            state = slstm_step(cfg, cell, gates_x[:, t], state)
            outs.append(state[2])
        hs = torch.stack(outs, 1).to(x.dtype)
    if mode in ("prefill", "decode"):
        for key, val in zip(("c", "n", "h", "m"), state):
            cache[key][l] = val
    hs = rms_norm(hs, p["ln_out_w"][l], cfg.norm_eps)
    gate = F.gelu(_acc(hs @ p["w_up_gate"][l]),
                  approximate="tanh").to(x.dtype)
    return x + (gate * (hs @ p["w_up"][l])) @ p["w_down"][l]


# ------------------------------------------------------------------- model

class XLSTMModel:
    def __init__(self, cfg: ArchConfig):
        _check_ported(cfg, families=("ssm",))
        pat = cfg.block_pattern
        if not pat or set(pat) - set(KINDS) or cfg.n_layers % len(pat):
            raise ValueError(f"{cfg.name}: an ssm config needs a "
                             f"block_pattern of {KINDS} dividing n_layers")
        self.cfg = cfg
        self.pat = tuple(pat)
        self.n_periods = cfg.n_layers // len(pat)
        self.n_m, self.n_s = self.pat.count("m"), self.pat.count("s")

    def init(self, generator: torch.Generator | None,
             device: str | torch.device = "cuda"):
        """(params, metas), drawn from ``generator`` on its device in the
        reference's order of leaves and moved to ``device``;
        ``device="meta"`` makes shapes only."""
        cfg = self.cfg
        b = _Builder(generator, getattr(torch, cfg.dtype),
                     torch.device(device))
        b.embed("embed", cfg.vocab, cfg.d_model)
        b.matrix("unembed", cfg.d_model, cfg.vocab,
                 scale=1.0 / math.sqrt(cfg.d_model))
        b.metas["unembed"] = ParamMeta("sign", 1.0, 0)
        _add_norm_params(b, cfg, "final_ln")
        _add_mlstm_params(b, cfg, "m_blocks", (self.n_periods, self.n_m))
        _add_slstm_params(b, cfg, "s_blocks", (self.n_periods, self.n_s))
        return b.params, b.metas

    def _run(self, params: dict, x: torch.Tensor, cache: dict | None = None,
             mode: str = "full") -> torch.Tensor:
        """Every period's blocks in the pattern's order, then the final
        norm."""
        cfg = self.cfg
        for i in range(self.n_periods):
            pm, ps = slot(params["m_blocks"], i), slot(params["s_blocks"], i)
            cm = slot(cache["m_blocks"], i) if cache is not None else None
            cs = slot(cache["s_blocks"], i) if cache is not None else None
            im = is_ = 0
            for kind in self.pat:
                if kind == "m":
                    x = _mlstm_block(cfg, pm, im, x, cm, mode)
                    im += 1
                else:
                    x = _slstm_block(cfg, ps, is_, x, cs, mode)
                    is_ += 1
        return _norm(cfg, params, "final_ln", x)

    def hidden(self, params: dict, batch: dict) -> torch.Tensor:
        """The final hidden states [B, S, D] of ``batch["tokens"]``."""
        return self._run(params, params["embed"][batch["tokens"]])

    def _unembed(self, params: dict) -> torch.Tensor:
        return params["unembed"]

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` ({"tokens",
        "labels"}: [B, S] int)."""
        return chunked_softmax_xent(self.hidden(params, batch),
                                    params["unembed"], batch["labels"])

    def unreached_leaves(self, batch: dict) -> frozenset:
        """Paths of the leaves ``loss`` does not reach: none."""
        return frozenset()

    # ----------------------------------------------------------------- cache
    def _cache_tree(self, batch_size: int, max_len: int, make) -> dict:
        cfg = self.cfg
        _, hd = _mlstm_dims(cfg)
        nh, d = cfg.n_heads, cfg.d_model
        f32 = acc_dtype(getattr(torch, cfg.dtype))
        lead_m = (self.n_periods, self.n_m, batch_size)
        lead_s = (self.n_periods, self.n_s, batch_size)
        return {"m_blocks": {"c": make(lead_m + (nh, hd, hd), f32),
                             "n": make(lead_m + (nh, hd), f32),
                             "m": make(lead_m + (nh,), f32)},
                "s_blocks": {k: make(lead_s + (d,), f32)
                             for k in ("c", "n", "h", "m")}}

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
        logits [B, V]; writes every block's final state into the cache in
        place and returns it."""
        h = self._run(params, params["embed"][batch["tokens"]], cache,
                      "prefill")
        return logits_last(h[:, -1], params["unembed"]), cache

    @torch.inference_mode()
    def decode_step(self, params: dict, batch: dict, cache: dict):
        """One token ``batch["token"]`` [B, 1] against the cache: f32
        logits [B, V]; advances every state in place (``t`` is unused: no
        positions)."""
        h = self._run(params, params["embed"][batch["token"]], cache,
                      "decode")
        return logits_last(h[:, -1], params["unembed"]), cache
