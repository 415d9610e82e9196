"""Deterministic synthetic LM data: Zipf-Markov token streams.

Port of ``repro/data/synthetic.py`` with ``torch.Generator``s in place of
``jax.random`` (so the numbers differ from the reference's; parity tests
feed both the reference's batches). Tokens follow a per-worker
affine-Markov chain with Zipf-distributed jumps:

    x_{t+1} = (a_j * x_t + b_j) mod V   with probability 0.85,
              z_t ~ Zipf-ish(V)          otherwise,

so the stream has a Zipf marginal and learnable bigram structure that
differs across workers (the paper's heterogeneous setting). Every batch
is a pure function of (seed, step): reproducible and resumable.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

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

    def __post_init__(self):
        if self.shape.kind != "train":
            raise NotImplementedError(
                f"shape kind {self.shape.kind!r}: only train batches are "
                "ported (serving is ROADMAP Queue 1 item 9)")
        if self.shape.batch % self.n_workers:
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
        ``[n_workers, batch / n_workers, seq]`` int64 on ``device``."""
        v, seq = self.cfg.vocab, self.shape.seq + 1
        lead = (self.n_workers, self.shape.batch // self.n_workers)
        gen = torch.Generator().manual_seed(self.seed * 2**32 + step)
        a, b = self._laws()
        x = _zipf(gen, lead, v)
        z = _zipf(gen, lead + (seq,), v)
        follow = torch.rand(lead + (seq,), generator=gen) < 0.85
        toks = torch.empty(lead + (seq,), dtype=torch.int64)
        for t in range(seq):
            x = torch.where(follow[..., t], (a * x + b) % v, z[..., t])
            toks[..., t] = x
        dev = resolve_device(self.device)
        return {"tokens": toks[..., :-1].to(dev),
                "labels": toks[..., 1:].to(dev)}
