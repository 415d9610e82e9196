"""Shared model primitives: inits + metas, layer norm, causal attention,
chunked softmax cross-entropy.

Port of the parts of ``repro/models/common.py`` the dense nanogpt path
uses. Conventions kept from the reference:
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

# --------------------------------------------------------------------- inits


def _normal(generator, shape, dtype, device, scale: float) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn on the CPU from ``generator``, cast to
    ``dtype`` before the scaling (as the reference samples in the param
    dtype), then moved. On the meta device only the shape is made."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
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

def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * weight.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention with GQA, scores and softmax in f32.

    q [B,S,Hq,D]; k, v [B,S,KVH,D] with Hq = KVH * G. The probabilities
    are cast to v's dtype before the PV product and normalised after it,
    as the reference's online softmax does. Plain torch ops: attention
    was never a Pallas kernel in the reference."""
    b, s, hq, d = q.shape
    kvh = k.shape[2]
    g = hq // kvh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, kvh, g, d).to(torch.float32)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k.to(torch.float32)) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(v.dtype)


# -------------------------------------------------------------- loss helpers

def chunked_softmax_xent(hidden: torch.Tensor, unembed: torch.Tensor,
                         labels: torch.Tensor,
                         chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy with f32 logits computed one
    sequence chunk at a time.

    hidden [B,S,D], unembed [D,V], labels [B,S] (already shifted)."""
    un = unembed.to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, hidden.shape[1], chunk):
        logits = hidden[:, lo:lo + chunk].to(torch.float32) @ un
        lse = torch.logsumexp(logits, dim=-1)
        lbl = labels[:, lo:lo + chunk].to(torch.int64)
        gold = torch.gather(logits, -1, lbl[..., None])[..., 0]
        tot = tot + torch.sum(lse - gold)
    return tot / labels.numel()
