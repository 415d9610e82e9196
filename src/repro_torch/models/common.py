"""Shared model primitives: inits + metas, RMSNorm and LayerNorm, RoPE
and M-RoPE, causal (optionally sliding-window) or bidirectional GQA
attention, single-query decode attention against a padded cache,
Whisper's sinusoid positions, chunked softmax cross-entropy and the
decode head's logits.

Port of the parts of ``repro/models/common.py`` the transformer and
Whisper families use. Conventions kept from the reference:
  * weights are [in, out] (stacked layers [L, in, out]); activations are
    x @ W;
  * every init returns (param, meta) pairs; ParamMeta drives the
    layer-wise LMO (hidden matrices -> spectral, embeddings and vectors
    -> sign);
  * attention scores, softmax and the logits of the loss are f32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.lmo import default_radius_scale
from repro_torch.core.muon import ParamMeta

NEG_INF = -1e30
# query rows of one attention pass: f32 scores of [B, H, 1024, S] (at
# starcoder2-15b's prompt of 4608 and batch 2, 1.8 GB against 8.2 GB in
# one pass)
ATTN_Q_CHUNK = 1024
# the most entries one draw of ``_normal`` makes: a larger leaf is drawn a
# slice of its leading dim at a time, so the f32 draw beside the bf16
# weights stays within 8 GiB (deepseek-v3 at 2 MoE layers stacks 7.5 G
# expert weights in a leaf, a 30 GB f32 draw)
DRAW_LIMIT = 2 ** 31

# --------------------------------------------------------------------- inits


def _normal(generator, shape, dtype, device, scale: float) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn from ``generator`` on its device, cast
    to ``dtype`` before the scaling (as the reference samples in the
    param dtype), then moved. A leaf of more than ``DRAW_LIMIT`` entries
    is drawn slice by slice along its leading dim. On the meta device
    only the shape is made."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if math.prod(shape) > DRAW_LIMIT:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = _normal(generator, shape[1:], dtype, device, scale)
        return out
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w.to(dtype) * scale).to(device)


def matrix_init(generator, in_dim: int, out_dim: int, dtype, device,
                stack: tuple[int, ...] = (), scale: float | None = None):
    """Gaussian fan-in init for a (possibly stacked) weight matrix, with
    the spectral-LMO meta."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = _normal(generator, stack + (in_dim, out_dim), dtype, device, scale)
    meta = ParamMeta("spectral",
                     default_radius_scale((in_dim, out_dim), "spectral"),
                     stack_dims=len(stack))
    return w, meta


def vector_init(dim: int, value: float, dtype, device,
                stack: tuple[int, ...] = ()):
    """A constant (norm scale or bias) vector: sign LMO, never
    compressed."""
    v = torch.full(stack + (dim,), value, dtype=dtype, device=device)
    return v, ParamMeta("sign", 1.0, stack_dims=len(stack),
                        compressible=False)


def embed_init(generator, vocab: int, dim: int, dtype, device):
    w = _normal(generator, (vocab, dim), dtype, device, 0.02)
    return w, ParamMeta("sign", 1.0, stack_dims=0)


def slot(tree: dict, i: int) -> dict:
    """Entry ``i`` of every stacked leaf of a nested dict (views): one
    period of a block pattern's ``[n_periods, slots, ...]`` stacks."""
    return {k: slot(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# --------------------------------------------------------------------- norms

def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a recurrence or norm of ``dtype`` values computes in: f32
    (the reference's, for bf16 and f32 models), f64 for a float64 copy of
    a model (a check of two forms of one function without f32
    rounding)."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(acc_dtype(x.dtype))
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.to(xf.dtype)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * weight.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, base: float = 10000.0,
               device=None) -> torch.Tensor:
    d2 = head_dim // 2
    return base ** (-torch.arange(0, d2, dtype=torch.float32,
                                  device=device) / d2)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, base: float = 10000.0,
               mrope_sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """Rotary embedding, the half-split layout: x [B,S,H,D], pos [B,S]
    (or [1,S], the same positions in every row); angles, cos and sin in
    f32, the result cast back to x's dtype. With ``mrope_sections``
    (M-RoPE, Qwen2-VL) pos is [B,S,3] (temporal, height, width) and
    channel c turns its own run of ``mrope_sections[c]`` frequencies."""
    d2 = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], base, x.device)
    if mrope_sections is None:
        angle = pos.to(torch.float32)[..., None] * freqs
    else:
        if sum(mrope_sections) != d2:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to the half head dim {d2}")
        bounds = [0]
        for sec in mrope_sections:
            bounds.append(bounds[-1] + sec)
        angle = torch.cat([pos[..., c].to(torch.float32)[..., None]
                           * freqs[lo:hi] for c, (lo, hi) in
                           enumerate(zip(bounds, bounds[1:]))], dim=-1)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x[..., :d2].to(torch.float32), x[..., d2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int | None = None, chunk: int = ATTN_Q_CHUNK,
              causal: bool = True) -> torch.Tensor:
    """Causal softmax attention with GQA, scores and softmax in f32;
    with ``window`` each query sees the keys at positions > its own
    minus ``window``; ``causal=False`` masks nothing (Whisper's encoder
    and its cross-attention, whose keys are the encoder's frames).

    q [B,S,Hq,D]; k [B,Skv,KVH,D], v [B,Skv,KVH,Dv] with Hq = KVH * G
    (Skv = S when causal); the
    scale is ``1/sqrt(D)`` (MLA's v is narrower than q and k: the
    reference pads it with zeros to D and slices the output back, which
    gives these values). The probabilities
    are cast to v's dtype before the PV product and normalised after it,
    as the reference's online softmax does. The queries go ``chunk`` rows
    at a time, each against every key, so the f32 scores are
    ``[B,H,chunk,Skv]`` and each row's arithmetic is that of one pass (the
    reference walks the keys in chunks of 1024 with an online softmax:
    the same values, summed in another order past 1024 keys). Plain
    torch ops: attention was never a Pallas kernel in the reference."""
    b, s, hq, d = q.shape
    if window is not None and not causal:
        raise ValueError("a sliding window needs causal attention")
    kvh = k.shape[2]
    g = hq // kvh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kvh, g, d).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    pos = torch.arange(s, device=q.device)
    outs = []
    for lo in range(0, s, chunk):
        qpos = pos[lo:lo + chunk, None]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, lo:lo + chunk],
                              kf) * scale
        if causal:
            mask = pos[None, :] <= qpos
            if window is not None:
                mask = mask & (pos[None, :] > qpos - window)
            scores = scores.masked_fill(~mask, NEG_INF)
        m = torch.amax(scores, dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        del scores
        denom = torch.sum(p, dim=-1)
        acc = torch.einsum("bhgqk,bkhd->bhgqd",
                           p.to(v.dtype).to(torch.float32), vf)
        outs.append(acc / torch.clamp(denom, min=1e-30)[..., None])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, v.shape[-1]).to(
        v.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: int) -> torch.Tensor:
    """One query against a (padded) cache: q [B,1,Hq,D]; caches
    [B,Smax,KVH,D], of which the first ``kv_len`` slots are valid. A
    windowed cache is a ring of the last ``Smax`` tokens, so positions
    are implicit and the mask is by validity only. Scores and softmax in
    f32, the probabilities cast to the cache's dtype before the PV
    product, the output in the cache's dtype."""
    b, _, hq, d = q.shape
    _, smax, kvh, _ = k_cache.shape
    g = hq // kvh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, 1, kvh, g, d).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                     k_cache.to(torch.float32)) * scale
    if kv_len < smax:
        s[..., kv_len:] = NEG_INF
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, 1, hq, d).to(v_cache.dtype)


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed sinusoid position table [length, channels], f32:
    sin of each position times ``channels // 2`` log-spaced inverse
    timescales (1 down to 1/10000), then their cos."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2,
                                                   dtype=torch.float32))
    t = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


# -------------------------------------------------------------- loss helpers

def chunked_softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor,
                         mask: torch.Tensor | None = None,
                         chunk: int = 1024, mesh=None,
                         dim: int | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy with f32 logits computed one
    sequence chunk at a time.

    hidden [B,S,D], unembed [D,V], labels [B,S] (already shifted); with
    ``mask`` [B,S] (bool) the masked positions' NLL is left out and the
    sum divided by the mask's count (at least 1), as the reference's.
    Over a mesh (``dist.sharding.RankMesh``) ``unembed`` is a rank's
    chunk cut on ``dim``, each chunk's logits as ``logits_last`` makes
    them: on V (1) the rank's f32 logit columns, then one all-gather; on
    D (0, the tied ``embed.T``) partial f32 logits summed over the model
    subgroup. Under autograd both are differentiable."""
    un = unembed.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, hidden.shape[1], chunk):
        logits = logits_last(hidden[:, lo:lo + chunk], un, mesh, dim)
        lse = torch.logsumexp(logits, dim=-1)
        lbl = labels[:, lo:lo + chunk].to(torch.int64)
        gold = torch.gather(logits, -1, lbl[..., None])[..., 0]
        nll = lse - gold
        if mask is not None:
            nll = nll * mask[:, lo:lo + chunk].to(torch.float32)
        tot = tot + torch.sum(nll)
    if mask is None:
        return tot / labels.numel()
    return tot / torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)


def logits_last(hidden_last: torch.Tensor, unembed: torch.Tensor,
                mesh=None, dim: int | None = None) -> torch.Tensor:
    """[..., D] x [D, V] -> [..., V] f32 logits (the decode head). Over a
    mesh (``dist.sharding.RankMesh``) ``unembed`` is a rank's chunk cut
    on ``dim``: on V (1), each rank's f32 logit columns, then one
    all-gather; on D (0, the tied ``embed.T``), partial f32 logits summed
    over the model subgroup."""
    h, un = hidden_last.to(torch.float32), unembed.to(torch.float32)
    if mesh is None or dim is None:
        return h @ un
    h = mesh.replicated(h)
    if dim == 1:
        return mesh.gather(h @ un, -1, "logits")
    n = un.shape[0]
    return mesh.sum_partials(
        h[..., mesh.model_index * n:(mesh.model_index + 1) * n] @ un,
        "logits")
