"""Deterministic synthetic LM data: Zipf-Markov token streams.

Port of ``repro/data/synthetic.py`` with ``torch.Generator``s in place of
``jax.random`` (so the numbers differ from the reference's; parity tests
feed both the reference's batches). Tokens follow a per-worker
affine-Markov chain with Zipf-distributed jumps:

    x_{t+1} = (a_j * x_t + b_j) mod V   with probability 0.85,
              z_t ~ Zipf-ish(V)          otherwise,

so the stream has a Zipf marginal and learnable bigram structure that
differs across workers (the paper's heterogeneous setting). Every batch
is a pure function of (seed, step): reproducible and resumable. On a
process group (``group``, the worker axis of ``dist/sharding.py``) every
rank draws the whole batch and keeps its own workers' rows of every key,
so they are the one-process batch's.

The stubbed frontends, as the reference's: a ``vlm`` batch (Qwen2-VL)
holds pseudo patch embeddings ``embeds`` (``N(0, 1) x 0.02`` in the
model's dtype) and M-RoPE ids ``pos`` (``arange(seq)`` on all three
channels) in place of ``tokens``, beside the labels; an ``audio`` batch
(Whisper) adds pseudo frame embeddings ``frames`` [.., n_frames,
d_model] to the tokens. Both are drawn after the tokens from the step's
generator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device


def _zipf(gen: torch.Generator, shape, vocab: int) -> torch.Tensor:
    """Approximate Zipf(1) sampler via the inverse CDF of a log-uniform."""
    u = torch.rand(shape, generator=gen) * (1.0 - 1e-6) + 1e-6
    return torch.clamp(torch.floor(torch.exp(u * math.log(vocab))) - 1,
                       0, vocab - 1).to(torch.int64)


@dataclass(frozen=True)
class SyntheticLM:
    cfg: ArchConfig
    shape: ShapeSpec
    n_workers: int = 1
    seed: int = 0
    device: str = "cuda"
    group: Any = None

    def __post_init__(self):
        if self.shape.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown shape kind {self.shape.kind!r}")
        if self.shape.kind == "train" and self.shape.batch % self.n_workers:
            raise ValueError(f"batch {self.shape.batch} does not split over "
                             f"{self.n_workers} workers")

    def _laws(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-worker Markov laws (odd multiplier a_j, offset b_j): fixed
        across steps, derived from the seed only."""
        gen = torch.Generator().manual_seed((1 << 62) + self.seed)
        a = 1 + 2 * torch.randint(0, 16, (self.n_workers,), generator=gen)
        b = torch.randint(0, self.cfg.vocab, (self.n_workers,),
                          generator=gen)
        return a[:, None], b[:, None]

    def batch_at(self, step: int) -> dict:
        """The batch of a global step: {"tokens", "labels"}, each
        ``[n_workers, batch / n_workers, seq]`` int64 on ``device`` (on a
        group: this rank's workers' rows of it), with the ``vlm`` and
        ``audio`` families' inputs (the module's docstring). Other kinds
        lead with ``[batch]`` and follow worker 0's law; a prefill batch
        has no labels."""
        v, seq = self.cfg.vocab, self.shape.seq + 1
        train = self.shape.kind == "train"
        lead = ((self.n_workers, self.shape.batch // self.n_workers) if train
                else (self.shape.batch,))
        gen = torch.Generator().manual_seed(self.seed * 2**32 + step)
        a, b = self._laws()
        if not train:
            a, b = a[0], b[0]
        x = _zipf(gen, lead, v)
        z = _zipf(gen, lead + (seq,), v)
        follow = torch.rand(lead + (seq,), generator=gen) < 0.85
        toks = torch.empty(lead + (seq,), dtype=torch.int64)
        for t in range(seq):
            x = torch.where(follow[..., t], (a * x + b) % v, z[..., t])
            toks[..., t] = x
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if self.shape.kind == "prefill":
            batch.pop("labels")
        cfg, seq = self.cfg, self.shape.seq
        dt = getattr(torch, cfg.dtype)
        if cfg.family == "vlm":
            emb = torch.randn(lead + (seq, cfg.d_model), generator=gen)
            pos = torch.arange(seq)[:, None].expand(lead + (seq, 3))
            batch = {"embeds": emb.to(dt) * 0.02, "pos": pos,
                     **{k: v for k, v in batch.items() if k == "labels"}}
        if cfg.family == "audio":
            frames = torch.randn(lead + (cfg.encoder.n_frames, cfg.d_model),
                                 generator=gen)
            batch["frames"] = frames.to(dt) * 0.02
        if self.group is not None and train:
            from repro_torch.dist.sharding import local_workers
            rows = local_workers(self.group, self.n_workers)
            batch = {k: v[rows.start:rows.stop] for k, v in batch.items()}
        dev = resolve_device(self.device)
        return {k: v.to(dev) for k, v in batch.items()}
