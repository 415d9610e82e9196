"""Decoder-only transformer — the dense, MoE and DeepSeek-V3 paths of
``repro/models/transformer.py``: GQA attention with RoPE (or learned
positions), optional QKV bias and sliding window (a ring-buffer decode
cache), SwiGLU / GeGLU / GELU MLPs (GELU in the tanh form,
``jax.nn.gelu``'s default), RMSNorm or LayerNorm, tied or untied
embeddings, Mixture-of-Experts with sort-based capacity dispatch
(Mixtral's softmax top-k; DeepSeek's sigmoid top-k with shared experts)
and the switch-style load-balance auxiliary loss, DeepSeek-V3's
multi-head latent attention (MLA: low-rank Q and KV, a decoupled RoPE
key of one head, a latent decode cache with *absorbed* decode), its
multi-token-prediction (MTP) head, and Qwen2-VL's M-RoPE (three position
channels, each turning its own section of frequencies) over a prompt of
precomputed patch embeddings (``embeds`` and ``pos``: the vision tower
is the reference's stub). The norm, MLP and GQA layers and their
parameter helpers are module functions (``_norm``, ``_mlp``,
``_gqa_attn``, ``_add_*_params``), as the reference's, which Whisper's
encoder-decoder (``whisper.py``) shares.

Parameters are a nested dict of tensors with the reference's names and
layout: weights ``[in, out]``, the layers stacked ``[L, ...]`` under
``dense_blocks`` and ``moe_blocks`` (the experts ``[L, E, in, out]``),
the tied unembedding is ``embed.T``, an untied one is ``unembed
[d_model, vocab]``; the MTP head's block is a stack of one under
``mtp/block``. The layer loop is a Python loop over each stack (the
reference's ``lax.scan``), without rematerialisation (the reference CLI
runs with ``remat=False``).

The MoE combine adds each token's expert outputs in ascending expert id,
one rounded add at a time, as the reference's (XLA's) expert-major
scatter-add does; the dispatch gather's gradient adds in the same order
(``_Route``). Neither is a scatter-add: the card's ``index_add_`` adds
by atomics in an order that changes from run to run, and the CPU's
rounds a bf16 sum once.

Serving: ``init_cache`` / ``cache_spec`` give the decode cache, one
``{"k", "v"}`` of ``[L, B, cap, KVH, hd]`` per stack, ``cap`` the
window for windowed archs (a ring: slot ``pos % cap``), or with MLA one
``{"c_kv": [L, B, cap, kv_lora], "k_rope": [L, B, cap, qk_rope]}``;
``prefill`` and ``decode_step`` run under ``torch.inference_mode()`` and
write the cache in place. Serving does not run the MTP head.

Sharded serving and training: ``prefill``, ``decode_step`` and ``loss``
take a ``dist.sharding.RankMesh`` (``mesh``), passed down to every layer,
with a rank's chunks of the params (and cache) as the mesh placed them. The
activations stay whole on every rank of a model subgroup: a weight cut
on its last dim multiplies the rank's columns and one all-gather joins
them (``_mm``), so each output entry is the one-rank dot product; the
routed experts cut on E run the rank's experts' ``bmm`` on their slots
and gather the slots' outputs before the one-rank combine; MLA's absorbed
decode runs the rank's heads of ``kv_b``; attention at decode gathers its
layer's cache whole for the step. Under autograd (the loss) the same
collectives are differentiable: a gather's
backward keeps the rank's chunk of the gradient, and the replicated
input of every product with a cut weight (``RankMesh.replicated``) gets
the subgroup's partial gradients summed; the loss head computes each
chunk's logits over the cut unembedding (``chunked_softmax_xent``), and
the MTP head looks up and projects through the same helpers. Without a
mesh every line runs as it did.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.muon import ParamMeta

from .common import (NEG_INF, apply_rope, attention, chunked_softmax_xent,
                     decode_attention, embed_init, layer_norm, logits_last,
                     matrix_init, rms_norm, vector_init)

# accumulate the MoE combine in f32 instead of the model dtype (the
# reference's switch of the same name and default)
MOE_COMBINE_F32 = False


def _check_ported(cfg: ArchConfig,
                  families: tuple[str, ...] = ("dense", "moe", "vlm")) -> None:
    why = []
    if cfg.family not in families:
        why.append(f"family {cfg.family!r}")
    if cfg.family == "moe" and cfg.moe is None:
        why.append("family 'moe' without a MoECfg")
    if cfg.rope not in ("rope", "mrope", "learned", "none"):
        why.append(f"rope {cfg.rope!r}")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        why.append(f"norm {cfg.norm!r}")
    if cfg.act not in ("swiglu", "geglu", "gelu"):
        why.append(f"act {cfg.act!r}")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(why)} not in repro_torch, nor in the "
            "reference (ROADMAP Queue 1 item 9 ported every model family "
            "the reference has)")


class _Builder:
    """Accumulates (params, metas) dicts with identical structure."""

    def __init__(self, generator, dtype, device, leaf_hook=None):
        self.generator, self.dtype, self.device = generator, dtype, device
        # leaf_hook(path, param, meta) -> the param to keep (a rank's chunk
        # of the leaf just drawn, ``dist.sharding.draw_shards``)
        self.leaf_hook = leaf_hook
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
        d_p[leaf] = p if self.leaf_hook is None else self.leaf_hook(path, p, m)
        d_m[leaf] = m


def _gated(cfg: ArchConfig) -> bool:
    return cfg.act in ("swiglu", "geglu")


# ------------------------------------------- layers shared with whisper.py

def _add_norm_params(b: _Builder, cfg: ArchConfig, path: str,
                     stack=()) -> None:
    b.vector(path + "_w", cfg.d_model, 1.0, stack=stack)
    if cfg.norm == "layernorm":
        b.vector(path + "_b", cfg.d_model, 0.0, stack=stack)


def _add_mlp_params(b: _Builder, cfg: ArchConfig, path: str, ff: int,
                    stack) -> None:
    d = cfg.d_model
    if _gated(cfg):
        b.matrix(path + "/w_gate", d, ff, stack=stack)
    b.matrix(path + "/w_up", d, ff, stack=stack)
    b.matrix(path + "/w_down", ff, d, stack=stack, scale=1.0 / math.sqrt(ff))


def _add_attn_params(b: _Builder, cfg: ArchConfig, at: str, stack) -> None:
    """Attention's leaves under ``at`` (a path ending in "/"): MLA's
    low-rank projections, or GQA's wq, wk, wv, wo (and QKV biases)."""
    mla = cfg.mla
    d, hd = cfg.d_model, cfg.hd
    if mla is not None:
        b.matrix(at + "q_a", d, mla.q_lora, stack=stack)
        b.vector(at + "q_norm_w", mla.q_lora, 1.0, stack=stack)
        b.matrix(at + "q_b", mla.q_lora,
                 cfg.n_heads * (mla.qk_nope + mla.qk_rope), stack=stack)
        b.matrix(at + "kv_a", d, mla.kv_lora + mla.qk_rope, stack=stack)
        b.vector(at + "kv_norm_w", mla.kv_lora, 1.0, stack=stack)
        b.matrix(at + "kv_b", mla.kv_lora,
                 cfg.n_heads * (mla.qk_nope + mla.v_dim), stack=stack)
        b.matrix(at + "wo", cfg.n_heads * mla.v_dim, d, stack=stack,
                 scale=1.0 / math.sqrt(cfg.n_heads * mla.v_dim))
        return
    b.matrix(at + "wq", d, cfg.n_heads * hd, stack=stack)
    b.matrix(at + "wk", d, cfg.n_kv_heads * hd, stack=stack)
    b.matrix(at + "wv", d, cfg.n_kv_heads * hd, stack=stack)
    b.matrix(at + "wo", cfg.n_heads * hd, d, stack=stack,
             scale=1.0 / math.sqrt(cfg.n_heads * hd))
    if cfg.qkv_bias:
        b.vector(at + "bq", cfg.n_heads * hd, 0.0, stack=stack)
        b.vector(at + "bk", cfg.n_kv_heads * hd, 0.0, stack=stack)
        b.vector(at + "bv", cfg.n_kv_heads * hd, 0.0, stack=stack)


def _norm(cfg: ArchConfig, p: dict, prefix: str, x: torch.Tensor,
          l: int | None = None) -> torch.Tensor:
    """The norm ``prefix`` of ``p`` (layer ``l`` of a stack) over x."""
    w = p[prefix + "_w"] if l is None else p[prefix + "_w"][l]
    if cfg.norm == "layernorm":
        bias = p[prefix + "_b"] if l is None else p[prefix + "_b"][l]
        return layer_norm(x, w, bias, cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps)


def _act(cfg: ArchConfig, gate: torch.Tensor | None,
         up: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(gate.to(torch.float32)).to(up.dtype) * up
    if cfg.act == "geglu":
        return F.gelu(gate.to(torch.float32),
                      approximate="tanh").to(up.dtype) * up
    return F.gelu(up.to(torch.float32), approximate="tanh").to(up.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, l: int, mesh=None) -> torch.Tensor:
    """``x @ w[l]``; over a mesh, by the cut of the rank's chunk of ``w``
    (``RankMesh.matmul``)."""
    return x @ w[l] if mesh is None else mesh.matmul(x, w, l)


def _mlp(cfg: ArchConfig, p: dict, x: torch.Tensor, l: int,
         mesh=None) -> torch.Tensor:
    up = _mm(x, p["w_up"], l, mesh)
    gate = _mm(x, p["w_gate"], l, mesh) if _gated(cfg) else None
    return _mm(_act(cfg, gate, up), p["w_down"], l, mesh)


def _lookup(table: torch.Tensor, idx: torch.Tensor, mesh=None) -> torch.Tensor:
    """Rows ``idx`` of an embedding table; over a mesh, of the rank's
    columns (a table cut on D), all-gathered on D."""
    if mesh is None or mesh.model_dim(table) is None:
        return table[idx]
    return mesh.gather(table[idx], -1, "activation")


def _rope(cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if cfg.rope in ("none", "learned"):
        return x
    sections = cfg.mrope_sections if cfg.rope == "mrope" else None
    return apply_rope(x, pos, cfg.rope_base, sections)


def _write_prompt(kc: torch.Tensor, k: torch.Tensor) -> None:
    """The prompt's keys (or values) ``k`` [B, S, ...] into one layer's
    cache ``kc`` [B, cap, ...]: padded with zeros to the capacity, or a
    ring of the last ``cap`` tokens at slot ``position % cap``."""
    cap, s = kc.shape[1], k.shape[1]
    if cap >= s:
        kc[:, :s] = k
        kc[:, s:] = 0
    else:
        idx = torch.arange(s - cap, s, device=k.device) % cap
        kc[:, idx] = k[:, s - cap:]


def _cache_prompt(cache: dict, l: int, vals: dict, mesh) -> None:
    """Prefill's writes of layer ``l``: each ``vals[name]`` [B, S, ...]
    into ``cache[name][l]`` (``_write_prompt``); over a mesh into the
    layer whole, of which each rank keeps its chunk."""
    for name, val in vals.items():
        c = cache[name]
        if mesh is None:
            _write_prompt(c[l], val)
            continue
        whole = val.new_empty(mesh.whole_shape(c)[1:])
        _write_prompt(whole, val)
        mesh.write_layer(c, l, whole)


def _cache_step(cache: dict, l: int, t: int, vals: dict, mesh) -> tuple:
    """Decode's writes of layer ``l``: slot ``t % cap`` of each
    ``cache[name]`` set to ``vals[name]`` [B, 1, ...]; returns the
    layers (whole over a mesh, gathered for this step) and ``cap``."""
    out = []
    for name, val in vals.items():
        c = cache[name]
        if mesh is None:
            cap = c.shape[2]
            c[l][:, t % cap] = val[:, 0]
            out.append(c[l])
        else:
            cap = mesh.whole_shape(c)[2]
            mesh.write_slot(c, l, t % cap, val[:, 0])
            out.append(mesh.whole_layer(c, l))
    return (*out, cap)


def _gqa_attn(cfg: ArchConfig, p: dict, l: int, h: torch.Tensor,
              pos: torch.Tensor, cache: dict | None, t: int | None,
              mode: str, causal: bool = True, mesh=None) -> torch.Tensor:
    """GQA attention of layer ``l`` before ``wo``: [B, S, Hq * hd].
    ``prefill`` writes k/v into ``cache`` (padded to its capacity, or
    a ring of the last ``cap`` tokens at slot ``pos % cap``);
    ``decode`` writes slot ``t % cap`` and attends over ``min(t + 1,
    cap)`` slots; ``causal=False`` (Whisper's encoder) in full mode."""
    bsz, s, _ = h.shape
    q, k, v = (_mm(h, p["wq"], l, mesh), _mm(h, p["wk"], l, mesh),
               _mm(h, p["wv"], l, mesh))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"][l], k + p["bk"][l], v + p["bv"][l]
    q = _rope(cfg, q.reshape(bsz, s, cfg.n_heads, cfg.hd), pos)
    k = _rope(cfg, k.reshape(bsz, s, cfg.n_kv_heads, cfg.hd), pos)
    v = v.reshape(bsz, s, cfg.n_kv_heads, cfg.hd)
    if mode == "decode":
        kc, vc, cap = _cache_step(cache, l, t, {"k": k, "v": v}, mesh)
        a = decode_attention(q, kc, vc, kv_len=min(t + 1, cap))
    else:
        a = attention(q, k, v, window=cfg.window, causal=causal)
    if mode == "prefill":
        _cache_prompt(cache, l, {"k": k, "v": v}, mesh)
    return a.reshape(bsz, s, cfg.n_heads * cfg.hd)


def moe_capacity(moe, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens of one pass."""
    c = int(math.ceil(moe.top_k * n_tokens * moe.capacity_factor
                      / moe.n_experts))
    return max(1, min(c, n_tokens))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last dim: values descending, ties by
    the lower index first (a stable descending sort, as
    ``core/compressors.py``'s ``_top_indices``; ``torch.topk`` promises
    no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(src: torch.Tensor, idx: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """Rows of ``src`` at ``idx`` [M] (zero where ``mask`` is False); for
    ``idx`` [M, K] their sum over K from zero, one add of ``src``'s dtype
    at a time in column order, skipping the masked entries."""
    if idx.dim() == 2:
        out = torch.zeros((idx.shape[0],) + src.shape[1:], dtype=src.dtype,
                          device=src.device)
        for j in range(idx.shape[1]):
            m = mask[:, j].reshape((-1,) + (1,) * (src.dim() - 1))
            out = torch.where(m, out + src.index_select(0, idx[:, j]), out)
        return out
    m = mask.reshape((-1,) + (1,) * (src.dim() - 1))
    return torch.where(m, src.index_select(0, idx), 0)


class _Route(torch.autograd.Function):
    """``_take(src, idx, mask)`` whose gradient is ``_take(grad, bwd_idx,
    bwd_mask)``: the backward map is the forward's transpose, given as
    another gather (or fold), so the gradient is computed by gathers and
    adds in a fixed order, never by a scatter-add."""

    @staticmethod
    def forward(ctx, src, idx, mask, bwd_idx, bwd_mask):
        ctx.save_for_backward(bwd_idx, bwd_mask)
        return _take(src, idx, mask)

    @staticmethod
    def backward(ctx, grad):
        bwd_idx, bwd_mask = ctx.saved_tensors
        return _take(grad, bwd_idx, bwd_mask), None, None, None, None


@torch.no_grad()
def moe_route(top_idx: torch.Tensor, n_exp: int, cap: int) -> dict:
    """The capacity dispatch of ``top_idx`` [T, K] (each token's experts),
    as the reference's: the T·K assignments sorted by expert (stable, so
    in token order within an expert), expert e's first ``cap`` of them in
    slots ``e·cap ..``, the rest dropped. Returns, over the E·cap slots,
    ``tok`` (the token of each slot; a slot past its expert's count
    points at a clamped neighbour, as the reference's grid does),
    ``assign`` (the assignment ``t·K + k``) and ``valid``; over the
    assignments, ``pos`` (the slot, clamped to 0 where dropped) and
    ``kept``; and ``table`` / ``table_kept`` [T, K]: each token's slots in
    ascending expert id, the order the reference's expert-major
    scatter-add adds them in."""
    n_tok, k = top_idx.shape
    dev = top_idx.device
    a = top_idx.reshape(-1)
    order = torch.sort(a, stable=True).indices
    counts = torch.bincount(a, minlength=n_exp)
    starts = torch.cumsum(counts, 0) - counts
    slots = torch.arange(cap, device=dev)
    grid = torch.clamp(starts[:, None] + slots[None, :], 0, n_tok * k - 1)
    assign = order[grid].reshape(-1)                        # [E * C]
    valid = (slots[None, :] < counts[:, None]).reshape(-1)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n_tok * k, device=dev))
    slot = rank - starts[a]
    kept = slot < cap
    pos = torch.where(kept, a * cap + slot, 0)              # [T * K]
    asc = torch.sort(top_idx, dim=1).indices                # [T, K]
    return {"tok": assign // k, "assign": assign, "valid": valid,
            "pos": pos, "kept": kept,
            "table": pos.reshape(n_tok, k).gather(1, asc),
            "table_kept": kept.reshape(n_tok, k).gather(1, asc)}


def moe_dispatch(xf: torch.Tensor, r: dict) -> torch.Tensor:
    """Each slot's token row, ``xf[tok]`` [E·C, D]; its gradient adds a
    token's kept slots in ascending expert id."""
    return _Route.apply(xf, r["tok"], torch.ones_like(r["valid"]),
                        r["table"], r["table_kept"])


def moe_slot_weights(weights: torch.Tensor, r: dict) -> torch.Tensor:
    """The routing weights [T, K] at the slots [E·C], zero past a slot's
    expert's count (the reference's ``where(valid, w_s[grid], 0)``)."""
    return _Route.apply(weights.reshape(-1), r["assign"], r["valid"],
                        r["pos"], r["kept"])


def moe_combine(contrib: torch.Tensor, r: dict) -> torch.Tensor:
    """The slots' contributions [E·C, D] summed per token [T, D] from zero,
    in ascending expert id, one rounded add at a time (dropped
    assignments add nothing); the gradient of a valid slot is its
    token's."""
    return _Route.apply(contrib, r["table"], r["table_kept"], r["tok"],
                        r["valid"])


class Transformer:
    def __init__(self, cfg: ArchConfig):
        _check_ported(cfg)
        self.cfg = cfg
        self.n_dense = cfg.moe_start_layer if cfg.moe else cfg.n_layers
        self.n_moe = cfg.n_layers - self.n_dense if cfg.moe else 0

    # ------------------------------------------------------------------ init
    def _moe_params(self, b: _Builder, path: str, stack) -> None:
        moe, d = self.cfg.moe, self.cfg.d_model
        b.matrix(path + "/router", d, moe.n_experts, stack=stack)
        estack = stack + (moe.n_experts,)
        if _gated(self.cfg):
            b.matrix(path + "/e_gate", d, moe.d_expert, stack=estack)
        b.matrix(path + "/e_up", d, moe.d_expert, stack=estack)
        b.matrix(path + "/e_down", moe.d_expert, d, stack=estack,
                 scale=1.0 / math.sqrt(moe.d_expert))
        if moe.n_shared:
            _add_mlp_params(b, self.cfg, path + "/shared",
                            moe.n_shared * moe.d_expert, stack)

    def _block_params(self, b: _Builder, name: str, n: int,
                      is_moe: bool, ff: int) -> None:
        if n == 0:
            return
        stack = (n,)
        _add_norm_params(b, self.cfg, f"{name}/ln1", stack)
        _add_norm_params(b, self.cfg, f"{name}/ln2", stack)
        _add_attn_params(b, self.cfg, f"{name}/attn/", stack)
        if is_moe:
            self._moe_params(b, f"{name}/moe", stack)
        else:
            _add_mlp_params(b, self.cfg, f"{name}/mlp", ff, stack)

    def init(self, generator: torch.Generator | None,
             device: str | torch.device = "cuda", leaf_hook=None):
        """(params, metas). Weights are drawn from ``generator`` on its
        device, in the reference's order of leaves, and moved to
        ``device``; ``device="meta"`` makes shapes only. ``leaf_hook(path,
        param, meta)`` gives what is kept of each leaf as it is drawn
        (``dist.sharding.draw_shards``: a rank's chunk)."""
        cfg = self.cfg
        b = _Builder(generator, getattr(torch, cfg.dtype),
                     torch.device(device), leaf_hook)
        d = cfg.d_model
        b.embed("embed", cfg.vocab, d)
        if cfg.rope == "learned":
            b.embed("pos_embed", cfg.max_position, d)
        if not cfg.tied_embeddings:
            b.matrix("unembed", d, cfg.vocab, scale=1.0 / math.sqrt(d))
            # the sign LMO, as the embeddings (Scion's treatment)
            b.metas["unembed"] = ParamMeta("sign", 1.0, 0)
        _add_norm_params(b, cfg, "final_ln")
        dense_ff = cfg.dense_ff if cfg.dense_ff else cfg.d_ff
        self._block_params(b, "dense_blocks", self.n_dense, False, dense_ff)
        self._block_params(b, "moe_blocks", self.n_moe, True, 0)
        if cfg.mtp:
            b.matrix("mtp/proj", 2 * d, d)
            _add_norm_params(b, cfg, "mtp/ln_h")
            _add_norm_params(b, cfg, "mtp/ln_e")
            self._block_params(b, "mtp/block", 1, False, dense_ff)
        return b.params, b.metas

    # ---------------------------------------------------------------- layers
    def _act(self, gate: torch.Tensor | None,
             up: torch.Tensor) -> torch.Tensor:
        # the module's _act; kept as a method for callers that hold a model
        return _act(self.cfg, gate, up)

    def _mla_attn(self, p: dict, l: int, h: torch.Tensor, pos: torch.Tensor,
                  cache: dict | None, t: int | None,
                  mode: str, mesh=None) -> torch.Tensor:
        """DeepSeek-V3 multi-head latent attention of layer ``l`` before
        ``wo``: [B, S, H * v_dim]. RoPE on the rope parts only; the rope
        key is one head, broadcast to all. The full and prefill modes
        expand the latent ``c_kv`` through ``kv_b``; ``attention`` takes
        v at its own head dim (the reference zero-pads it to q's and
        slices the output back: the same values) and scales by
        ``1/sqrt(qk_nope + qk_rope)``, q's head dim, the reference's
        ``softmax_scale``. ``prefill`` writes ``c_kv`` and ``k_rope``
        into the cache, zero past the prompt; ``decode`` writes slot
        ``t`` and attends in the latent space (``_mla_decode``)."""
        cfg, mla = self.cfg, self.cfg.mla
        bsz, s, _ = h.shape
        nh, nope, rope_d, vd = cfg.n_heads, mla.qk_nope, mla.qk_rope, \
            mla.v_dim
        q = _mm(rms_norm(_mm(h, p["q_a"], l, mesh), p["q_norm_w"][l],
                         cfg.norm_eps), p["q_b"], l, mesh)
        q = q.reshape(bsz, s, nh, nope + rope_d)
        q_nope = q[..., :nope]
        q_rope = apply_rope(q[..., nope:], pos, cfg.rope_base)
        kv_a = _mm(h, p["kv_a"], l, mesh)
        c_kv = rms_norm(kv_a[..., :mla.kv_lora], p["kv_norm_w"][l],
                        cfg.norm_eps)
        k_rope = apply_rope(kv_a[..., None, mla.kv_lora:], pos,
                            cfg.rope_base)[:, :, 0]             # [B, S, rope]
        if mode == "decode":
            return self._mla_decode(p, l, q_nope, q_rope, c_kv, k_rope,
                                    cache, t, h.dtype, mesh)
        kv = _mm(c_kv, p["kv_b"], l, mesh).reshape(bsz, s, nh, nope + vd)
        k = torch.cat([kv[..., :nope],
                       k_rope[:, :, None].expand(bsz, s, nh, rope_d)], -1)
        a = attention(torch.cat([q_nope, q_rope], -1), k, kv[..., nope:])
        if mode == "prefill":
            _cache_prompt(cache, l, {"c_kv": c_kv, "k_rope": k_rope}, mesh)
        return a.reshape(bsz, s, nh * vd)

    def _mla_decode(self, p: dict, l: int, q_nope, q_rope, c_kv, k_rope,
                    cache: dict, t: int, dt, mesh=None) -> torch.Tensor:
        """Absorbed decode: ``W_uk`` folded into the query (``q_lat``),
        scores against the latent cache plus the rope scores, the mask by
        ``kv_len``, softmax, values in the latent space (``o_lat``), then
        ``W_uv``. The products take f32 copies of their bf16 operands
        (the reference's ``preferred_element_type=f32``; 576 cache
        entries a token a layer), with the reference's casts: the weights
        to the cache's dtype before ``o_lat``, ``o_lat`` to ``h``'s before
        ``W_uv``. Over a mesh ``kv_b`` is cut on whole heads: each rank
        runs its heads against the latent cache gathered whole, and the
        heads' outputs are all-gathered before ``wo``."""
        cfg, mla = self.cfg, self.cfg.mla
        bsz = q_nope.shape[0]
        nh, nope, vd = cfg.n_heads, mla.qk_nope, mla.v_dim
        ck, kr, cap = _cache_step(cache, l, t,
                                  {"c_kv": c_kv, "k_rope": k_rope}, mesh)
        if mesh is not None:
            nh //= mesh.m
            heads = slice(mesh.model_index * nh, (mesh.model_index + 1) * nh)
            q_nope, q_rope = q_nope[:, :, heads], q_rope[:, :, heads]
        kv_len = min(t + 1, cap)
        f32 = torch.float32
        w_kv = p["kv_b"][l].reshape(mla.kv_lora, nh, nope + vd).to(f32)
        w_uk, w_uv = w_kv[..., :nope], w_kv[..., nope:]
        ckf = ck.to(f32)
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope.to(f32), w_uk)
        s_lat = torch.einsum("bshl,bkl->bhsk",
                             q_lat.to(ck.dtype).to(f32), ckf)
        s_rope = torch.einsum("bshr,bkr->bhsk", q_rope.to(f32), kr.to(f32))
        scores = (s_lat + s_rope) * (1.0 / math.sqrt(nope + mla.qk_rope))
        if kv_len < cap:
            scores[..., kv_len:] = NEG_INF
        w = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhsk,bkl->bshl", w.to(ck.dtype).to(f32), ckf)
        o = torch.einsum("bshl,lhv->bshv", o_lat.to(dt).to(f32), w_uv)
        o = o.reshape(bsz, 1, nh * vd).to(dt)
        return o if mesh is None else mesh.gather(o, -1, "activation")

    def _moe_ffn(self, p: dict, l: int, x: torch.Tensor, mesh=None):
        """Sort-based capacity-dispatch MoE of layer ``l``: x [B,S,D] ->
        (out, aux). Each expert takes at most ``moe_capacity`` of the
        pass's tokens in token order; the rest are dropped. The combine
        adds into x's dtype, each token's experts in ascending id
        (``moe_combine``), the order of the reference's expert-major
        scatter-add; where the reference also adds its empty slots'
        exact zeros (weight 0), the port adds nothing, which can differ
        only in the sign of an exactly-zero sum, or where an empty slot's
        output is infinite (0 x inf: NaN in the reference). Over a mesh
        with the experts cut on E, the router, the routing and the combine
        run on every rank, the rank's E/m experts on their slots, and one
        all-gather gives every slot's output. Where the batch's rows are
        split over ``data``, the dispatch takes the pass's every token, as
        one rank does: the rows are all-gathered over ``data`` first (under
        autograd the gather's backward keeps the rank's rows) and the data
        index keeps its own after the combine. The aux loss is then the
        rank's part of the pass's: the expert fractions count every token,
        the mean router probabilities only the rank's (so the data ranks'
        aux losses average to one rank's, and each token's gradient
        reaches its own rank alone)."""
        if mesh is not None and mesh.batch_split:
            n = x.shape[0]
            lo = mesh.data_index * n
            out, aux = self._moe_tokens(
                p, l, mesh.gather(x, 0, "activation", axis="data"), mesh,
                own=(lo * x.shape[1], (lo + n) * x.shape[1]))
            return out[lo:lo + n], aux
        return self._moe_tokens(p, l, x, mesh)

    def _moe_tokens(self, p: dict, l: int, x: torch.Tensor, mesh=None,
                    own: tuple[int, int] | None = None):
        cfg, moe = self.cfg, self.cfg.moe
        b_, s, d = x.shape
        n_tok, n_exp, k = b_ * s, moe.n_experts, moe.top_k
        cap = moe_capacity(moe, n_tok)
        xf = x.reshape(n_tok, d)
        if mesh is None:
            logits = xf.to(torch.float32) @ p["router"][l].to(torch.float32)
        else:
            logits = mesh.matmul(xf.to(torch.float32), p["router"], l,
                                 dtype=torch.float32)
        probs = (torch.sigmoid(logits) if moe.n_shared
                 else torch.softmax(logits, dim=-1))
        top_vals, top_idx = _top_k(probs, k)
        weights = top_vals / (torch.sum(top_vals, dim=-1, keepdim=True)
                              + 1e-9)
        # switch-style load-balance auxiliary loss
        sm = torch.softmax(logits, dim=-1)
        me = torch.mean(sm if own is None else sm[own[0]:own[1]], dim=0)
        ce = torch.mean(F.one_hot(top_idx[:, 0], n_exp).to(torch.float32),
                        dim=0)
        aux = n_exp * torch.sum(me * ce)

        r = moe_route(top_idx, n_exp, cap)
        xin = moe_dispatch(xf, r).reshape(n_exp, cap, d)      # [E, C, D]
        if mesh is None:
            up = torch.bmm(xin, p["e_up"][l])
            gate = torch.bmm(xin, p["e_gate"][l]) if _gated(cfg) else None
            out_ec = torch.bmm(_act(self.cfg, gate, up), p["e_down"][l])
        elif mesh.model_dim(p["e_up"]) == 1:     # the experts cut on E
            n = p["e_up"].shape[1]
            xin_j = mesh.replicated(xin)[mesh.model_index * n:
                                         (mesh.model_index + 1) * n]
            up = torch.bmm(xin_j, p["e_up"][l])
            gate = torch.bmm(xin_j, p["e_gate"][l]) if _gated(cfg) else None
            out_ec = mesh.gather(torch.bmm(_act(self.cfg, gate, up),
                                           p["e_down"][l]), 0, "expert_out")
        else:
            up = _mm(xin, p["e_up"], l, mesh)
            gate = _mm(xin, p["e_gate"], l, mesh) if _gated(cfg) else None
            out_ec = _mm(_act(self.cfg, gate, up), p["e_down"], l, mesh)
        w_ec = moe_slot_weights(weights, r).reshape(n_exp, cap)
        acc_dt = torch.float32 if MOE_COMBINE_F32 else x.dtype
        contrib = (out_ec * w_ec[..., None].to(out_ec.dtype)).to(acc_dt)
        out = moe_combine(contrib.reshape(-1, d), r).to(x.dtype)
        if moe.n_shared:
            out = out + _mlp(cfg, p["shared"], xf, l, mesh)
        return out.reshape(b_, s, d), aux

    def _block(self, p: dict, l: int, x: torch.Tensor, pos: torch.Tensor,
               is_moe: bool = False, cache: dict | None = None,
               t: int | None = None, mode: str = "full", mesh=None):
        cfg = self.cfg
        h = _norm(cfg, p, "ln1", x, l)
        if cfg.mla is not None:
            a = self._mla_attn(p["attn"], l, h, pos, cache, t, mode, mesh)
        else:
            a = _gqa_attn(cfg, p["attn"], l, h, pos, cache, t, mode,
                          mesh=mesh)
        x = x + _mm(a, p["attn"]["wo"], l, mesh)
        h = _norm(cfg, p, "ln2", x, l)
        if is_moe:
            f, aux = self._moe_ffn(p["moe"], l, h, mesh)
            return x + f, aux
        return x + _mlp(cfg, p["mlp"], h, l, mesh), None

    # -------------------------------------------------------------- plumbing
    def _stacks(self, params: dict):
        out = []
        if self.n_dense:
            out.append(("dense_blocks", params["dense_blocks"], False))
        if self.n_moe:
            out.append(("moe_blocks", params["moe_blocks"], True))
        return out

    def _run(self, params: dict, x: torch.Tensor, pos: torch.Tensor,
             cache: dict | None = None, t: int | None = None,
             mode: str = "full", mesh=None):
        """Every block of every stack, then the final norm: (h, the MoE
        layers' summed aux loss)."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for name, stack_p, is_moe in self._stacks(params):
            c = cache[name] if cache is not None else None
            n = self.n_moe if is_moe else self.n_dense
            for l in range(n):
                x, aux = self._block(stack_p, l, x, pos, is_moe, c, t, mode,
                                     mesh)
                if aux is not None:
                    aux_total = aux_total + aux
        return _norm(self.cfg, params, "final_ln", x), aux_total

    def _embed_in(self, params: dict, batch: dict, mesh=None):
        """(x, pos) of a batch: ``embeds`` [B, S, D] with their ``pos``
        (Qwen2-VL's patch embeddings: x cast to the model's dtype, the
        positions as given), or ``tokens`` (train, prefill) or ``token``
        (decode, with ``t``) through ``embed`` at positions [1, S] (under
        M-RoPE the same position on all three channels, [1, S, 3]). Over
        a mesh a table cut on D is looked up in the rank's columns, then
        all-gathered on D."""
        cfg = self.cfg
        if "embeds" in batch:
            x = batch["embeds"].to(getattr(torch, cfg.dtype))
            pos = batch["pos"]
        else:
            if "tokens" in batch:
                tokens = batch["tokens"]
                pos = torch.arange(tokens.shape[1], device=tokens.device)
            else:
                tokens = batch["token"]
                pos = torch.full((1,), int(batch["t"]), device=tokens.device)
            x = _lookup(params["embed"], tokens, mesh)
            pos = pos[None, :, None].expand(1, -1, 3) \
                if cfg.rope == "mrope" else pos[None]
        if cfg.rope == "learned":
            x = x + _lookup(params["pos_embed"],
                            torch.clamp(pos, 0, cfg.max_position - 1), mesh)
        return x, pos

    def unreached_leaves(self, batch: dict) -> frozenset:
        """Paths of the leaves ``loss`` of ``batch`` does not reach: an
        untied ``embed`` under an ``embeds`` batch."""
        if "embeds" in batch and not self.cfg.tied_embeddings:
            return frozenset({("embed",)})
        return frozenset()

    def _unembed(self, params: dict) -> torch.Tensor:
        if self.cfg.tied_embeddings:
            return params["embed"].T
        return params["unembed"]

    def _unembed_dim(self, params: dict, mesh) -> int | None:
        """The dim of the unembedding a mesh cuts (the tied ``embed.T`` is
        cut on D where ``embed`` is), None without a mesh or a cut."""
        if mesh is None:
            return None
        if self.cfg.tied_embeddings:
            d = mesh.model_dim(params["embed"])
            return None if d is None else 1 - d
        return mesh.model_dim(params["unembed"])

    # ------------------------------------------------------------------ loss
    def loss(self, params: dict, batch: dict, mesh=None) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` ({"tokens",
        "labels"}: [B, S] int; or ``embeds`` and ``pos`` for ``tokens``,
        ``_embed_in``), plus 0.01 x the MoE layers' mean aux,
        plus 0.3 x the MTP head's loss (``_mtp_loss``). ``mesh``: a
        training ``RankMesh`` that placed ``params`` (a rank's chunks,
        bound to it); every rank of a model subgroup returns the same
        loss."""
        x, pos = self._embed_in(params, batch, mesh)
        h, aux = self._run(params, x, pos, mesh=mesh)
        out = chunked_softmax_xent(h, self._unembed(params), batch["labels"],
                                   mesh=mesh,
                                   dim=self._unembed_dim(params, mesh))
        if self.cfg.moe:
            out = out + 0.01 * aux / max(self.n_moe, 1)
        if self.cfg.mtp and "tokens" in batch:
            out = out + 0.3 * self._mtp_loss(params, h, batch, mesh)
        return out

    def _mtp_loss(self, params: dict, h: torch.Tensor, batch: dict,
                  mesh=None) -> torch.Tensor:
        """DeepSeek-V3 MTP: one dense block predicts token t+2 from the
        normed ``h_t`` beside the normed ``embed(token_{t+1})``, projected
        back to d_model; its cross-entropy without a final norm, the last
        position masked."""
        p = params["mtp"]
        e = _lookup(params["embed"], batch["tokens"][:, 1:], mesh)
        comb = torch.cat([_norm(self.cfg, p, "ln_h", h[:, :-1]),
                          _norm(self.cfg, p, "ln_e", e)], dim=-1)
        comb = comb @ p["proj"] if mesh is None else mesh.matmul(comb,
                                                                 p["proj"])
        pos = torch.arange(comb.shape[1], device=comb.device)[None]
        hm, _ = self._block(p["block"], 0, comb, pos, mesh=mesh)
        labels = batch["labels"][:, 1:]
        mask = torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
        mask[:, -1] = False
        return chunked_softmax_xent(hm, self._unembed(params), labels,
                                    mask=mask, mesh=mesh,
                                    dim=self._unembed_dim(params, mesh))

    # ----------------------------------------------------------------- cache
    def _cache_entry(self, batch_size: int, cap: int) -> dict:
        cfg = self.cfg
        if cfg.mla is not None:
            return {"c_kv": (batch_size, cap, cfg.mla.kv_lora),
                    "k_rope": (batch_size, cap, cfg.mla.qk_rope)}
        shape = (batch_size, cap, cfg.n_kv_heads, cfg.hd)
        return {"k": shape, "v": shape}

    def _cache_tree(self, batch_size: int, max_len: int, make) -> dict:
        cfg = self.cfg
        cap = min(cfg.window, max_len) if cfg.window else max_len
        dt = getattr(torch, cfg.dtype)
        entry = self._cache_entry(batch_size, cap)
        return {name: {k: make((self.n_moe if is_moe else self.n_dense,)
                               + shape, dt) for k, shape in entry.items()}
                for name, _, is_moe in self._stacks(
                    {"dense_blocks": None, "moe_blocks": None})}

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
    def _logits(self, params: dict, h_last: torch.Tensor, mesh):
        """The decode head's f32 logits; over a mesh by the unembedding's
        cut (the tied ``embed.T`` is cut on D where ``embed`` is)."""
        return logits_last(h_last, self._unembed(params), mesh,
                           self._unembed_dim(params, mesh))

    @torch.inference_mode()
    def prefill(self, params: dict, batch: dict, cache: dict, mesh=None):
        """The prompt ``batch["tokens"]`` [B, S] (or ``embeds`` and
        ``pos``): the last position's f32 logits [B, V]; writes the cache
        in place and returns it. ``mesh``: a ``RankMesh`` that placed
        ``params`` and ``cache`` (a rank's chunks)."""
        x, pos = self._embed_in(params, batch, mesh)
        h, _ = self._run(params, x, pos, cache, None, "prefill", mesh)
        return self._logits(params, h[:, -1], mesh), cache

    @torch.inference_mode()
    def decode_step(self, params: dict, batch: dict, cache: dict,
                    mesh=None):
        """One token ``batch["token"]`` [B, 1] at position ``batch["t"]``
        against the cache: f32 logits [B, V]; writes slot ``t % cap`` in
        place and returns the cache."""
        x, pos = self._embed_in(params, batch, mesh)
        h, _ = self._run(params, x, pos, cache, int(batch["t"]), "decode",
                         mesh)
        return self._logits(params, h[:, -1], mesh), cache
