"""Shared model primitives: inits + metas, RMSNorm and LayerNorm, RoPE,
causal (optionally sliding-window) GQA attention, single-query decode
attention against a padded cache, chunked softmax cross-entropy and the
decode head's logits.

Port of the parts of ``repro/models/common.py`` the dense and MoE
families use (standard RoPE; M-RoPE is not ported). Conventions kept
from the reference:
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


# --------------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.to(torch.float32)
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


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, the half-split layout: x [B,S,H,D], pos [B,S]
    (or [1,S], the same positions in every row); angles, cos and sin in
    f32, the result cast back to x's dtype."""
    d2 = x.shape[-1] // 2
    angle = pos.to(torch.float32)[..., None] * rope_freqs(
        x.shape[-1], base, x.device)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x[..., :d2].to(torch.float32), x[..., d2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int | None = None,
              chunk: int = ATTN_Q_CHUNK) -> torch.Tensor:
    """Causal softmax attention with GQA, scores and softmax in f32;
    with ``window`` each query sees the keys at positions > its own
    minus ``window``.

    q [B,S,Hq,D]; k [B,S,KVH,D], v [B,S,KVH,Dv] with Hq = KVH * G; the
    scale is ``1/sqrt(D)`` (MLA's v is narrower than q and k: the
    reference pads it with zeros to D and slices the output back, which
    gives these values). The probabilities
    are cast to v's dtype before the PV product and normalised after it,
    as the reference's online softmax does. The queries go ``chunk`` rows
    at a time, each against every key, so the f32 scores are
    ``[B,H,chunk,S]`` and each row's arithmetic is that of one pass. Plain
    torch ops: attention was never a Pallas kernel in the reference."""
    b, s, hq, d = q.shape
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


# -------------------------------------------------------------- loss helpers

def chunked_softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor,
                         mask: torch.Tensor | None = None,
                         chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy with f32 logits computed one
    sequence chunk at a time.

    hidden [B,S,D], unembed [D,V], labels [B,S] (already shifted); with
    ``mask`` [B,S] (bool) the masked positions' NLL is left out and the
    sum divided by the mask's count (at least 1), as the reference's."""
    un = unembed.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, hidden.shape[1], chunk):
        logits = hidden[:, lo:lo + chunk].to(torch.float32) @ un
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


def logits_last(hidden_last: torch.Tensor,
                unembed: torch.Tensor) -> torch.Tensor:
    """[B,D] x [D,V] -> [B,V] f32 logits (the decode head)."""
    return hidden_last.to(torch.float32) @ unembed.to(torch.float32)
