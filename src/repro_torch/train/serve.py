"""Serving: batched prefill, then a greedy or temperature decode loop
(the port of ``repro/train/serve.py``).

``Server.generate`` allocates the cache for prompt + ``max_new`` tokens,
runs the prompt through ``model.prefill`` once and then ``max_new``
calls of ``model.decode_step``, each on the token sampled from the last
logits: ``argmax`` when greedy (the first index among ties, as
``jnp.argmax``), else a draw from ``softmax(logits / temperature)`` by
``torch.multinomial`` on a ``torch.Generator`` (the reference draws
from ``jax.random.categorical``: the same law, other numbers).

The reference places params, batch and cache over a device mesh
(tensor and expert parallel); that has no counterpart here yet, and a
``mesh`` raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass
class Server:
    model: Any
    mesh: Any = None
    # the last generate's prefill seconds and decode seconds (all steps)
    timings: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "sharded serving over several cards is not ported to "
                "repro_torch yet (ROADMAP Queue 1 item 15)")

    def serve_step_fn(self):
        """The serving step: ONE token against a cache."""
        return self.model.decode_step

    def generate(self, params: dict, batch: dict, max_new: int,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Prefill on ``batch`` ({"tokens": [B, S]}; Qwen2-VL's {"embeds":
        [B, S, D], "pos"}; Whisper's {"frames", "tokens"}), then decode
        ``max_new`` tokens: int32 ``[B, max_new]`` on the prompt's
        device (``[B, 0]`` for ``max_new=0``)."""
        prompt = batch["tokens"] if "tokens" in batch else batch["embeds"]
        dev = prompt.device
        bsz, prompt_len = prompt.shape[:2]
        cache = self.model.init_cache(bsz, prompt_len + max_new, dev)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(params, batch, cache)
        tok = self._sample(logits, temperature, generator)
        _sync(dev)
        t1 = time.perf_counter()
        toks = []
        for i in range(max_new):
            toks.append(tok)
            logits, cache = self.model.decode_step(
                params, {"token": tok, "t": prompt_len + i}, cache)
            tok = self._sample(logits, temperature, generator)
        _sync(dev)
        self.timings = {"prefill_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1,
                        "decode_steps": max_new}
        if not toks:     # max_new=0: prefill only
            return torch.zeros((bsz, 0), dtype=torch.int32, device=dev)
        return torch.cat(toks, dim=1)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: torch.Generator | None) -> torch.Tensor:
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(
            torch.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
