"""Serving: batched prefill, then a greedy or temperature decode loop
(the port of ``repro/train/serve.py``).

``Server.generate`` allocates the cache for prompt + ``max_new`` tokens,
runs the prompt through ``model.prefill`` once and then ``max_new``
calls of ``model.decode_step``, each on the token sampled from the last
logits: ``argmax`` when greedy (the first index among ties, as
``jnp.argmax``), else a draw from ``softmax(logits / temperature)`` by
``torch.multinomial`` on a ``torch.Generator`` (the reference draws
from ``jax.random.categorical``: the same law, other numbers).

With a mesh (``dist.sharding.MeshShape(data=d, model=m)``) and a process
group of its d x m ranks, all placement comes from the reference's rules
(``dist.sharding``): params follow ``param_pspecs`` (tensor parallel on
``model``, the routed experts on E), the prompt ``batch_pspec`` (its
rows over ``data``) and the cache ``serve_pspecs``. Each rank holds its
chunks only; its forward gets a ``RankMesh``, whose collectives carry
activations, expert outputs, cache layers, logits and tokens, never a
parameter. Each data index runs its rows, every rank of its model
subgroup the same activations; ``generate`` gathers the tokens of every
row on every rank at the end. The transformer families serve at any
``model``; the others (Whisper, RecurrentGemma, xLSTM) over ``data``
only (ROADMAP Queue 1 item 15b). A mesh with a ``pod`` axis raises
(item 21): the reference's serving specs never name ``pod``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.models.api import (TP_FAMILIES, abstract_params,
                                    check_model_cut)


@dataclass
class Server:
    model: Any
    mesh: Any = None
    group: Any = None
    # the last generate's prefill seconds and decode seconds (all steps);
    # over a mesh also its collectives (seconds and bytes a decode step by
    # tag, the prefill's by tag, the host-staged seconds)
    timings: dict = field(default_factory=dict)

    def __post_init__(self):
        self._sm = None
        if self.mesh is None:
            return
        from repro_torch.dist.sharding import RankMesh
        if "pod" in self.mesh.axis_names:
            raise NotImplementedError(
                "serving over a mesh with a 'pod' axis (replicas on pod) "
                "is not in repro_torch (ROADMAP Queue 1 item 21)")
        self._abstract, self._metas = abstract_params(self.model)
        check_model_cut(self.model, self._abstract, self._metas, self.mesh,
                        "serving")
        self._sm = RankMesh(self.mesh, self.group)
        self._placed = None
        self._memo: dict = {}

    def serve_step_fn(self):
        """The serving step: ONE token against a cache."""
        return self.model.decode_step

    # ------------------------------------------------------------ placement
    def shardings(self, params: Any, batch: dict, cache: Any,
                  cache_alt: Any = None):
        """(param, batch, cache) specs from the dist rules, as tuples a
        leaf (the reference's are ``NamedSharding``s). ``cache_alt`` (the
        cache spec at another batch size) makes the batch-dim detection
        exact — see ``serve_pspecs``."""
        from repro_torch.dist.sharding import (batch_pspec, param_pspecs,
                                               serve_pspecs)
        assert self.mesh is not None
        bsz = next(iter(batch.values())).shape[0]
        return (param_pspecs(params, self._metas, self.mesh),
                batch_pspec(batch, self.mesh, "prefill"),
                serve_pspecs(cache, bsz, self.mesh, cache_alt=cache_alt))

    def place(self, params: Any, chunks: bool = False) -> Any:
        """This rank's chunks of a whole params tree (``shard_params``).
        A one-slot cache keyed by the identity of the leaves: a long-lived
        server generates repeatedly with the same weights, and the entry's
        strong references keep the leaves' ids from being recycled.
        ``chunks``: ``params`` is this rank's chunks already (each leaf of
        its spec's chunk shape, else ValueError), taken as they are."""
        from repro_torch.dist.layerwise import tree_leaves
        from repro_torch.dist.sharding import shard_params
        leaves = tree_leaves(params)
        if chunks:
            self._check_chunks(params)
            self._bind(leaves, params)
            return params
        if self._placed is not None:
            src, local = self._placed
            if len(src) == len(leaves) and all(
                    a is b for a, b in zip(src, leaves)):
                return local
        if self._sm.holds("params", params):
            return params        # place's output, or draw's
        local = shard_params(params, self._metas, self.mesh, self._sm.coords)
        self._bind(leaves, local)
        return local

    def draw(self, generator: torch.Generator,
             device: str | torch.device = "cuda") -> Any:
        """This rank's chunks of ``model.init(generator, device)``, each
        leaf cut as it is drawn (``draw_shards``): equal to the cuts of the
        one-rank draw, at a rank's chunks plus one whole leaf."""
        from repro_torch.dist.layerwise import tree_leaves
        from repro_torch.dist.sharding import draw_shards
        local, _ = draw_shards(self.model, generator, device, self.mesh,
                               self._sm.coords)
        self._bind(tree_leaves(local), local)
        return local

    def _check_chunks(self, params: Any) -> None:
        from repro_torch.dist.sharding import (_tree_map, param_pspecs,
                                               spec_shape)
        specs = param_pspecs(self._abstract, self._metas, self.mesh)
        bad = []
        _tree_map(lambda t, a, sp: bad.append((tuple(t.shape), sp))
                  if tuple(t.shape) != spec_shape(tuple(a.shape), sp,
                                                  self.mesh) else None,
                  params, self._abstract, specs)
        if bad:
            raise ValueError(f"chunks of other shapes than the specs': {bad}")

    def _bind(self, src_leaves: list, local: Any) -> None:
        from repro_torch.dist.sharding import param_pspecs
        self._sm.bind("params", local,
                      param_pspecs(self._abstract, self._metas, self.mesh))
        self._placed = (src_leaves, local)

    def _placement(self, batch: dict, bsz: int, total: int):
        """(batch specs, cache specs, whole cache spec) of a request shape,
        memoised (a few shapes at most)."""
        key = (bsz, total, tuple(sorted((k, tuple(v.shape))
                                        for k, v in batch.items())))
        if key not in self._memo:
            if len(self._memo) >= 8:
                self._memo.clear()
            spec = self.model.cache_spec(bsz, total)
            _, b_sp, c_sp = self.shardings(
                self._abstract, batch, spec,
                cache_alt=self.model.cache_spec(bsz + 1, total))
            self._memo[key] = (b_sp, c_sp, spec)
        return self._memo[key]

    # ------------------------------------------------------------- stepping
    def prefill(self, params: Any, batch: dict, max_len: int):
        """The prompt through the model with a cache of ``max_len``:
        (the last position's f32 logits, the state ``decode`` continues).
        Over a mesh the logits are this rank's data index's rows
        (``state["rows"]`` of the batch), the same on every rank of its
        model subgroup, and ``params`` may be whole or already placed."""
        prompt = batch["tokens"] if "tokens" in batch else batch["embeds"]
        bsz = prompt.shape[0]
        if self.mesh is None:
            cache = self.model.init_cache(bsz, max_len, prompt.device)
            logits, cache = self.model.prefill(params, batch, cache)
            return logits, {"params": params, "cache": cache,
                            "rows": slice(0, bsz)}
        from repro_torch.dist.sharding import _tree_map, cut, spec_shape
        sm = self._sm
        local = self.place(params)
        b_sp, c_sp, spec = self._placement(batch, bsz, max_len)
        batch = {k: cut(v, b_sp[k], self.mesh, sm.coords)
                 for k, v in batch.items()}
        lead = b_sp[next(iter(b_sp))][0]
        n = bsz // sm.d if lead == "data" else bsz
        rows = slice(sm.data_index * n, (sm.data_index + 1) * n) \
            if lead == "data" else slice(0, bsz)
        sm.batch_split = lead == "data"
        if self.model.cfg.family not in TP_FAMILIES:
            # data only: the one-rank model on the rank's rows
            cache = self.model.init_cache(n, max_len, prompt.device)
            logits, cache = self.model.prefill(local, batch, cache)
        else:
            cache = _tree_map(lambda t, s: torch.zeros(
                spec_shape(tuple(t.shape), s, self.mesh), dtype=t.dtype,
                device=prompt.device), spec, c_sp)
            sm.bind("cache", cache, c_sp)
            logits, cache = self.model.prefill(local, batch, cache, sm)
        return logits, {"params": local, "cache": cache, "rows": rows,
                        "batch_split": sm.batch_split}

    def decode(self, state: dict, token: torch.Tensor, t: int):
        """One token (``[n, 1]``, the state's rows) at position ``t``: the
        f32 logits of those rows."""
        step = {"token": token, "t": t}
        if self._sm is None or self.model.cfg.family not in TP_FAMILIES:
            logits, state["cache"] = self.model.decode_step(
                state["params"], step, state["cache"])
        else:
            self._sm.batch_split = state["batch_split"]
            logits, state["cache"] = self.model.decode_step(
                state["params"], step, state["cache"], self._sm)
        return logits

    # -------------------------------------------------------------- decoding
    def generate(self, params: dict, batch: dict, max_new: int,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Prefill on ``batch`` ({"tokens": [B, S]}; Qwen2-VL's {"embeds":
        [B, S, D], "pos"}; Whisper's {"frames", "tokens"}), then decode
        ``max_new`` tokens: int32 ``[B, max_new]`` on the prompt's
        device (``[B, 0]`` for ``max_new=0``). Over a mesh every rank
        returns every row; temperature tokens are drawn on the model
        subgroup's rank 0 from its ``generator`` and broadcast."""
        if self.mesh is not None:
            return self._generate_mesh(params, batch, max_new, temperature,
                                       generator)
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

    def _generate_mesh(self, params, batch, max_new, temperature, generator):
        sm = self._sm
        prompt = batch["tokens"] if "tokens" in batch else batch["embeds"]
        dev = prompt.device
        bsz, prompt_len = prompt.shape[:2]
        local = self.place(params)
        sm.record.clear()
        t0 = time.perf_counter()
        logits, state = self.prefill(local, batch, prompt_len + max_new)
        tok = self._mesh_sample(logits, temperature, generator)
        _sync(dev)
        t1 = time.perf_counter()
        n_prefill = len(sm.record)
        toks = []
        for i in range(max_new):
            toks.append(tok)
            logits = self.decode(state, tok, prompt_len + i)
            tok = self._mesh_sample(logits, temperature, generator)
        _sync(dev)
        t2 = time.perf_counter()
        rows = state["rows"].stop - state["rows"].start
        out = torch.cat(toks, dim=1) if toks else torch.zeros(
            (rows, 0), dtype=torch.int32, device=dev)
        if rows != bsz:
            out = sm.gather(out, 0, "tokens", axis="data")
        self.timings = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                        "decode_steps": max_new,
                        **_collectives(sm.record, n_prefill, max_new)}
        return out

    def _mesh_sample(self, logits, temperature, generator):
        """Greedy: every rank's argmax of the same logits. Temperature:
        the model subgroup's rank 0 draws, the others receive its token."""
        if temperature <= 0.0 or generator is None:
            return self._sample(logits, 0.0, None)
        if self._sm.model_index == 0:
            tok = self._sample(logits, temperature, generator)
        else:
            tok = torch.empty((logits.shape[0], 1), dtype=torch.int32,
                              device=logits.device)
        return self._sm.broadcast(tok, 0, "tokens")

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: torch.Generator | None) -> torch.Tensor:
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(
            torch.int32)


def _collectives(record: list, n_prefill: int, steps: int) -> dict:
    """A generate's collectives: the prefill's bytes by tag, a decode
    step's bytes and seconds by tag (the mean over ``steps``), and the
    seconds of those that went through pinned host memory."""
    prefill: dict = {}
    for tag, nb, _, _ in record[:n_prefill]:
        prefill[tag] = prefill.get(tag, 0) + nb
    per_step: dict = {}
    for tag, nb, s, _ in record[n_prefill:]:
        e = per_step.setdefault(tag, {"bytes": 0, "s": 0.0, "calls": 0})
        e["bytes"] += nb
        e["s"] += s
        e["calls"] += 1
    if steps:
        for e in per_step.values():
            e["bytes"] //= steps
            e["s"] /= steps
            e["calls"] //= steps
    return {"prefill_collective_bytes": prefill,
            "decode_collectives": per_step,
            "host_staged_s": sum(s for _, _, s, staged in record if staged)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
