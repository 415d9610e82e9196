"""EF21-Muon trainer.

Port of ``repro/train/trainer.py``: model loss, the EF21Muon optimizer,
the per-worker gradient function and, with a ``torch.distributed``
process group (the counterpart of the reference's mesh), the two
communication hooks. The dataflow per step (DESIGN.md §5):

  1. EF21-P (``s2w``): the server compresses S = C_P(X - W); with a
     group it is packed into uint8 wire buffers of lead 1 (one per wire
     stage) and each broadcast from the group's rank 0, and both ends
     advance W from the bytes; ``s2w="identity"`` keeps W = X;
  2. per-worker grads at W, one autograd pass per worker;
  3. per-worker momentum + EF21 compress: R_j = C_D(M_j - G_j);
  4. with a group, the payloads packed into uint8 wire buffers
     (``repro_torch.wire``; one per wire stage) and each all-gathered
     over the group; without one, nothing is packed;
  5. server fold G += mean_j decompress(R_j), then X = LMO_B(X, t)(G),
     the spectral leaves through the batched Newton-Schulz chain (the
     CUDA kernels on the card).

``TrainerConfig`` adds to that the reference's run-time switches:
metrics (``aux["metrics"]``), trace spans, elastic participation, the
non-finite guard, a fault plan, ``donate`` (the step writes the new
state into the input state's tensors; the caller drops the old state)
and ``resync`` (the desynchronized-worker rejoin, §13).

With a group of P ranks the EF21 workers are spread over them
(``dist/sharding.py``): ``n_workers = P * n_local``, rank r owns workers
``[r * n_local, (r + 1) * n_local)``, computes their gradients, momentum
and EF21 compress on its own batch rows, and all-gathers their packed
payloads; every rank then runs the same server fold and LMO on the
gathered bytes (the reference's replicated server). The state's
worker-lead leaves (``g_w``, ``m_w``, ``cw_state``, ``w_w``) hold the
rank's rows; the rest is replicated. Each all-gather the hooks make is
recorded in ``Trainer.gathered`` and each broadcast in
``Trainer.broadcast_bytes`` (the bytes this rank sent or received, in
order), and each is checked at run time against ``wire_budget()``: a
call of another size, or a step that makes more or fewer of them,
raises. The step's per-worker scalars (losses and the per-worker
metrics) move in one f32 all-gather a step, recorded apart in
``Trainer.aux_gathered`` with the checkpoint's gathers: they are not
wire traffic.

The server's state follows the reference's placement rules over the
group's stand-in mesh ``{"data": P}`` (``dist/sharding.py``,
``Trainer.state_specs``). With P > 1 every NS bucket that P divides
(``ns_bucket_pspec``) is split: each rank runs its P-th of the slices
and the updated x rows, in x's dtype, are all-gathered. With
``zero1_lmo`` the leading stack dim of ``x``, ``g_server`` and ``w`` is
cut over the ranks where P divides it (``_zero1_pspec``), and a bucket's
rows go only to the ranks that hold them (one all-to-all); with
``fsdp`` the last dim P divides (``param_pspec(..., fsdp=True)``). The
step then gathers a leaf whole where it needs it, W whole for the
gradients among them. These collectives (the leaves' chunks, the
buckets' x rows) are recorded in ``Trainer.state_gathered`` and each is
checked at run time against the bytes the specs give. Without a group both switches change
nothing, as the reference ignores them without a mesh.

Over the reference's ``(data, model)`` mesh (``mesh=MeshShape(data=d,
model=m)``, d x m the group's size; ``dist.sharding.RankMesh`` at
``(r // m, r % m)``) the workers go on ``data``: the m ranks of a data
row own the same workers and batch rows, and run each worker's forward
and backward together with the weights cut on ``model`` as
``param_pspecs`` says (tensor parallel on a core dim, expert parallel on
E), through the model's differentiable collectives
(``models.transformer``). ``x``, ``g_server`` and ``w`` and the inner
dims of ``g_w``, ``m_w`` and ``w_w`` hold the rank's chunks
(``state_pspecs``); the compressor states stay whole. Each compressor
sees its leaf whole: the difference (``M - G``, ``X - W``) is gathered
over the model subgroup one leaf at a time and compressed alike on every
rank of the row, so the payload is the same there; the wire and the s2w
broadcast move over the worker axis's subgroup, each checked against the
budget per rank; each rank keeps its chunk of every decoded delta. The
NS buckets run as ``ns_bucket_pspec`` cuts them (columns on ``model``:
the gram partials summed; rows or experts: the members gathered whole).
The mesh's collectives are recorded in ``Trainer.rm.record`` by tag
(``TRAIN_TAGS``). With ``zero1_lmo`` or ``fsdp`` the model chunks are cut
over ``data`` too (a ``ServerPlacement`` over the data subgroup).
``model=1`` without ``pod`` is the group path above, bit for bit.

Over the reference's multi-pod mesh (``mesh=MeshShape(pod=p, data=d,
model=m)``, rank r at ``(r // (d m), (r // m) % d, r % m)``) the workers
go on ``pod`` (``worker_axis_for``) and each worker's rows on ``data``
(``batch_pspec``): a rank runs its data index's rows of its pod's
workers, its loss is its part of the worker's mean, and the loss and
every gradient leaf are summed over the data subgroup in f32, in rank
order (``row_grad``), so the data ranks of a pod hold the worker's
gradient and run the same compressors on the same whole leaves; the MoE
gathers the rows over ``data`` before its dispatch, as one rank's pass
(``models.transformer``). The wire and the s2w broadcast move over the
pod subgroups; the NS buckets split over ``("pod", "data")``, pod-major
(``kernels.ops.split_rows``). Zero-1 and FSDP cut the server's state
over ``data``, replicated over ``pod``; with FSDP the worker-lead
leaves' inner dims are cut over ``data`` too (``Trainer.worker_data``),
and their compressor inputs gathered whole over ``data`` before
``model``. The metrics run on every mesh (a cut leaf's squares summed
over the subgroups that hold it). The Whisper, RecurrentGemma and xLSTM
families train at ``model=1`` only (ROADMAP Queue 1 item 15b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.muon import (EF21Muon, EF21MuonConfig, WireBudget,
                                   resolve_stage_plan)
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.dist.layerwise import (leaf_paths, tree_get, tree_leaves,
                                       tree_unflatten)
from repro_torch.dist.pipeline import s2w_issue_order
from repro_torch.models.api import (TP_FAMILIES, abstract_params,
                                    check_model_cut)


@dataclass
class TrainerConfig:
    n_workers: int = 1
    beta: float = 0.1
    w2s: str = "identity"
    s2w: str = "identity"
    wire_pack: bool = True  # fused uint8 payload buffer (needs a group)
    wire_stages: Any = "auto"  # staged wire pipeline (§8): "auto" = one
                               # stage per NS bucket + eager chunk; 1 =
                               # the monolithic single-gather A/B arm
    wire_pack_s2w: Any = "auto"  # pack the s2w model update (§9); "auto"
                                 # follows wire_pack
    metrics: bool = False      # MetricSet in aux["metrics"] (§10)
    trace_spans: bool = False  # record_function/NVTX around the phases
                               # and wire stages (§10)
    participation: Any = "full"  # elastic participation (§11): "full" |
                                 # "bernoulli(p)" | "round_robin(k)" |
                                 # dist.participation.Explicit
    participation_seed: int = 0  # seeds bernoulli participation
    nonfinite_guard: Any = "auto"  # payload finiteness guard (§11):
                                   # "auto" = on iff participation is
                                   # elastic or faults are declared
    faults: Any = None         # train.faults.FaultPlan (§11); forces the
                               # guard on
    donate: bool = False       # in-place state updates: the caller must
                               # not use a state it passed in again
    resync: Any = None         # desynchronized-worker rejoin (§13):
                               # None/0 off; R >= 1 keeps per-worker W_j
                               # and an R-deep replay ring of s2w rounds
    fsdp: bool = False         # server state cut over the group along
                               # each leaf's last dim it divides
    zero1_lmo: bool = False    # server state cut over the group along
                               # each stack's leading dim it divides


def _map_tensors(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tensors(fn, v) for v in tree]
    return tree


class _Expected:
    """One direction's collectives of a step, in order, as the budget
    says: each call is checked against the next entry, and the cursor
    wraps at the step's end (so direct calls between steps cycle through
    the stages in order)."""

    def __init__(self, what: str, sizes: list[int]):
        self.what, self.sizes, self.pos = what, sizes, 0

    def take(self, nbytes: int) -> None:
        if not self.sizes or nbytes != self.sizes[self.pos]:
            want = self.sizes[self.pos] if self.sizes else "none"
            raise ValueError(
                f"{self.what} {self.pos} of the step moves {nbytes} B, the "
                f"wire budget says {want} (sizes {self.sizes})")
        self.pos = (self.pos + 1) % len(self.sizes)

    def check_done(self) -> None:
        if self.pos:
            raise ValueError(
                f"the step made {self.pos} {self.what}s of the "
                f"{len(self.sizes)} the wire budget says")


class Trainer:
    def __init__(self, model, tcfg: TrainerConfig,
                 device: str | torch.device = "cuda", group=None,
                 mesh=None, timeout=None):
        # metas are static: build once from the model's abstract init
        self._params_shapes, self.metas = abstract_params(model)
        self.rm = None      # the RankMesh of a mesh with a model or pod axis
        self.cuts = None    # the leaves' model cuts on it
        worker_group = group
        if mesh is not None:
            extra = set(mesh.axis_names) - set(sharding.AXES)
            if extra:
                raise ValueError("a training mesh has the axes 'pod', "
                                 f"'data' and 'model', not {sorted(extra)}")
            check_model_cut(model, self._params_shapes, self.metas, mesh,
                            "training")
            if group is None:
                raise ValueError("a training mesh needs a process group of "
                                 "its ranks (group=...)")
            p, d, m = (mesh.shape.get(a, 1) for a in sharding.AXES)
            if p * d * m != group.size():
                raise ValueError(f"mesh pod={p} x data={d} x model={m} over "
                                 f"a group of {group.size()} ranks")
            if m > 1 or "pod" in mesh.axis_names:
                self.rm = sharding.RankMesh(mesh, group, timeout)
                worker_group = self.rm.axis_group(
                    sharding.worker_axis_for(mesh))
        # the ranks of the worker axis: the group, or a mesh's data (pod)
        # subgroup
        self.worker_group = worker_group
        # each rank owns whole workers: raises where P does not divide
        self.workers = sharding.local_workers(worker_group, tcfg.n_workers)
        self.model = model
        self.tcfg = tcfg
        device = resolve_device(device)
        if (group is not None and device.type == "cuda"
                and device.index is None
                and dist.get_backend(group) == "nccl"):
            # NCCL: one card per rank, rank r on cuda:r
            device = torch.device("cuda", dist.get_rank()
                                  % torch.cuda.device_count())
        self.device = device
        self.group = group
        self.gathered: list[int] = []   # bytes of each all-gather, in order
        self.broadcast_bytes: list[int] = []   # bytes of each broadcast
        self.aux_gathered: list[int] = []   # the scalar and state gathers
        # the server state's gathers (leaf chunks, a bucket's x rows)
        self.state_gathered: list[int] = []
        self.mesh = (self.rm.mesh if self.rm is not None
                     else sharding.mesh_for(group))
        guard = tcfg.nonfinite_guard
        if guard == "auto":
            # chaos implies the guard: declared faults or an elastic
            # schedule turn it on; the plain arm stays bit-equal (§11)
            guard = tcfg.faults is not None or tcfg.participation != "full"
        self.opt = EF21Muon(EF21MuonConfig(
            n_workers=tcfg.n_workers, beta=tcfg.beta, w2s=tcfg.w2s,
            s2w=tcfg.s2w, wire_pack=tcfg.wire_pack,
            wire_stages=tcfg.wire_stages, wire_pack_s2w=tcfg.wire_pack_s2w,
            metrics=tcfg.metrics, trace_spans=tcfg.trace_spans,
            participation=tcfg.participation,
            participation_seed=tcfg.participation_seed,
            nonfinite_guard=bool(guard), resync=tcfg.resync))
        self._w2s_check = self._s2w_check = self._sizes = None
        self.server = None      # where the server's state lies
        # where the worker-lead leaves' inner dims lie over ``data`` (FSDP
        # on a pod mesh, whose worker lead is on ``pod``)
        self.worker_data = None
        if self.rm is not None:
            self.cuts = sharding.ModelCuts(self.rm, self._params_shapes,
                                           self.metas)
            # the compositions the NS buckets split over, made here by
            # every rank in plan order
            for b in self.layer_plan().ns_buckets(mesh=self.mesh,
                                                  fsdp=tcfg.fsdp):
                if b.pspec is not None and isinstance(b.pspec[0], tuple):
                    self.rm.compose(b.pspec[0])
            self._param_specs = sharding.param_pspecs(
                self._params_shapes, self.metas, self.mesh)
            if self.rm.d > 1 and (tcfg.zero1_lmo or tcfg.fsdp):
                # zero-1 and FSDP cut the model chunks over ``data``
                specs = self.state_specs()
                self.server = self._data_placement(specs["x"], 0)
                wd = self._data_placement(specs["g_w"], 1)
                self.worker_data = wd if wd.sharded else None
        elif group is not None and group.size() > 1:
            self.server = sharding.server_placement(
                group, self._params_shapes, self.metas,
                self.state_specs()["x"], record=self.state_gathered,
                aux_record=self.aux_gathered)

    def _data_placement(self, specs, lead: int):
        """The ``data`` cuts of the model chunks (a ``ServerPlacement``
        over the data subgroup) as ``specs`` put them, behind ``lead``
        leading dims (the worker dim: its axis is not ``data``'s)."""
        paths = leaf_paths(self._params_shapes)
        return sharding.ServerPlacement(
            self.rm.data_group,
            [tuple(a if a == "data" else None
                   for a in tree_get(specs, p)[lead:]) for p in paths],
            [self.cuts.local_shape(i) for i in range(len(paths))],
            params=self._params_shapes, record=self.state_gathered,
            aux_record=self.aux_gathered)

    @property
    def n_local(self) -> int:
        """Workers this rank owns."""
        return len(self.workers)

    def init(self, seed: int) -> dict:
        """Fresh params from ``seed`` and the optimizer state around them:
        the global state, drawn as one rank draws it, then this rank's
        slice of its worker-lead leaves (so a P-rank state is the
        one-rank state's slices, bit for bit). With ``donate``, tensors
        that share memory (tied leaves) are copied apart, as the
        reference's ``_dedup`` does: an in-place update of one must not
        move the other."""
        gen = torch.Generator().manual_seed(seed)
        if self.rm is None:
            params, _ = self.model.init(gen, self.device)
            state = self.place(self.opt.init(gen, params, self.metas))
        else:
            # a rank draws its model chunks and builds its workers' rows
            # around them: it never holds a whole state
            params, _ = sharding.draw_shards(self.model, gen, self.device,
                                             self.mesh, self.rm.coords)
            state = self._shard_server(self.opt.init(
                gen, params, self.metas, shapes=self._params_shapes,
                workers=self.workers))
        if self.tcfg.donate:
            seen: set = set()

            def dedup(t: torch.Tensor) -> torch.Tensor:
                ptr = t.untyped_storage().data_ptr()
                if ptr in seen:
                    return t.clone()
                seen.add(ptr)
                return t

            state = _map_tensors(dedup, state)
        return state

    def place(self, state: dict) -> dict:
        """This rank's slice of a global (one-rank) state: its workers'
        rows of the worker-lead leaves, its chunks of the server's leaves
        (zero-1, FSDP) and of every leaf cut on ``model``."""
        state = sharding.shard_state(state, self.worker_group,
                                     self.tcfg.n_workers)
        return self._cut_model(self._shard_server(state))

    def state_specs(self) -> dict:
        """The specs of the optimizer state over the group's stand-in
        mesh (the reference's ``shardings()``): ``state_pspecs`` with
        ``fsdp`` and ``zero1_lmo``, except that ``cw_state`` leads with
        the worker axis, as the port holds its rows."""
        if self.mesh is None:
            raise ValueError("state_specs needs a group (the reference's "
                             "shardings() needs a mesh)")
        st = self.opt.init(None, self._params_shapes, self.metas)
        specs = sharding.state_pspecs(st, self._params_shapes, self.metas,
                                      self.mesh, fsdp=self.tcfg.fsdp,
                                      zero1_lmo=self.tcfg.zero1_lmo)
        waxis = sharding.worker_axis_for(self.mesh)
        lead = waxis if self.mesh.shape.get(waxis, 1) > 1 else None
        specs["cw_state"] = _map_tensors(
            lambda t: (lead,) + (None,) * (t.ndim - 1), st["cw_state"])
        return specs

    def _server_keys(self, state: dict) -> tuple[str, ...]:
        return tuple(k for k in sharding.SERVER_KEYS
                     if state.get(k) is not None)

    def _model_keys(self, state: dict) -> list[tuple[str, int]]:
        """(key, lead dims) of the state's leaves cut on ``model``: the
        server's, and the worker-lead trees behind their worker dim."""
        return ([(k, 0) for k in self._server_keys(state)]
                + [(k, 1) for k in ("g_w", "m_w", "w_w")
                   if state.get(k) is not None])

    def _cut_model(self, state: dict) -> dict:
        """The rank's chunks (``cuts``) of a state whole over ``model``
        (the state itself without a model axis)."""
        if self.cuts is None:
            return state
        plan = self.layer_plan()
        state = dict(state)
        for key, lead in self._model_keys(state):
            state[key] = plan.unflatten(
                [self.cuts.cut(i, t, lead)
                 for i, t in enumerate(plan.flatten(state[key]))])
        return state

    def _whole_model(self, state: dict, to_host: bool = False) -> dict:
        """``state`` with its model-cut leaves whole: one gather over the
        model subgroup a cut leaf (recorded in ``state_gathered``), the
        server's moved to the host at once with ``to_host``."""
        plan = self.layer_plan()
        group = self.rm.model_group
        state = dict(state)
        for key, lead in self._model_keys(state):
            leaves = []
            for i, t in enumerate(plan.flatten(state[key])):
                d = self.cuts.dims[i]
                if d is not None:
                    t = sharding.gather_shards(t, d + lead, group,
                                               self.state_gathered)
                leaves.append(t.cpu() if to_host and not lead else t)
            state[key] = plan.unflatten(leaves)
        return state

    def _shard_server(self, state: dict) -> dict:
        """The rank's chunks of the server's leaves of a whole state, as
        ``state_specs`` cuts them, and of the worker-lead leaves' inner
        dims cut over ``data`` (the state itself where nothing is cut)."""
        plan = self.layer_plan()
        state = dict(state)
        for place, keys, lead in self._data_cuts(state):
            for key in keys:
                state[key] = plan.unflatten(
                    [place.local(i, t, lead)
                     for i, t in enumerate(plan.flatten(state[key]))])
        return state

    def _data_cuts(self, state: dict) -> list:
        """(placement, keys, lead dims) of the state's leaves cut over
        ``data``: the server's, then the worker-lead ones (FSDP on a pod
        mesh)."""
        out = []
        if self.server is not None and self.server.sharded:
            out.append((self.server, self._server_keys(state), 0))
        if self.worker_data is not None:
            out.append((self.worker_data, [k for k in ("g_w", "m_w", "w_w")
                                           if state.get(k) is not None], 1))
        return out

    def gather_server(self, state: dict, to_host: bool = False) -> dict:
        """``state`` with the server's leaves whole: every rank takes part
        (one gather a cut leaf, recorded in ``state_gathered``) and gets
        them, each moved to the host at once with ``to_host``, so the card
        never holds them all. Over a model axis the inner dims of the
        worker-lead leaves are gathered too (over ``data`` first, then
        over ``model``)."""
        plan = self.layer_plan()
        state = dict(state)
        for place, keys, lead in self._data_cuts(state):
            for key in keys:
                leaves = []
                for i, t in enumerate(plan.flatten(state[key])):
                    t = place.whole(i, t, lead)
                    leaves.append(t.cpu() if to_host and self.cuts is None
                                  and not lead else t)
                state[key] = plan.unflatten(leaves)
        if self.cuts is not None:
            state = self._whole_model(state, to_host)
        return state

    def layer_plan(self):
        """The optimizer's LayerPlan for this model — per-leaf
        compressors, the w2s wire bytes (Table 2) and the wire layout."""
        return self.opt.plan(self._params_shapes, self.metas)

    def wire_budget(self) -> WireBudget:
        """What one step's hooks move, per rank: ``gathered`` grows by
        ``n_local * s`` for each ``s`` in ``w2s_sizes``, and
        ``broadcast_bytes`` by ``s2w_sizes`` in ``s2w_issue_order``, per
        step."""
        return self.opt.wire_budget(self._params_shapes, self.metas,
                                    distributed=self.group is not None,
                                    mesh=self._bucket_mesh())

    def _bucket_mesh(self):
        # the mesh whose NS buckets (and so wire stages) the step runs:
        # a model axis splits them by their members' cuts
        return self.mesh if self.rm is not None else None

    def _unpacked_sizes(self) -> list[int]:
        """The bytes one worker's per-leaf payload tensors take, in the
        order the unpacked arm's hook meets them: each leaf's compressor
        run on the meta device (no memory, no numbers)."""
        cfg = self.opt.cfg
        sizes = []
        for lp, cw in zip(self.layer_plan().leaves, self.opt.init(
                None, self._params_shapes, self.metas)["cw_state"]):
            x = torch.empty((1,) + lp.shape, dtype=cfg.wire_dtype,
                            device="meta")
            cw1 = _map_tensors(lambda t: t[:1], cw)
            pl, _ = lp.w2s.compress(
                cw1, x.to(torch.float32) if getattr(
                    lp.w2s, "lossless_wire", False) else x, lp.slice_shape)
            # in the order the hook's _map_tensors meets them
            _map_tensors(lambda t: sizes.append(t.numel()
                                                * t.element_size()), pl)
        return sizes

    def _arm_checks(self) -> None:
        """The runtime byte check of one step: the gathers' and the
        broadcasts' sizes in order, from ``wire_budget()`` (the unpacked
        arm's from the plan), worked out once."""
        if self._sizes is None:
            b = self.wire_budget()
            if b.pack_w2s:
                w2s = [self.n_local * s for s in b.w2s_sizes]
            else:
                w2s = [self.n_local * s for s in self._unpacked_sizes()]
            s2w = []
            if b.pack_s2w:
                plan = self.layer_plan()
                splan = resolve_stage_plan(self.opt.cfg, plan,
                                           mesh=self._bucket_mesh())
                order = (s2w_issue_order(plan, splan) if splan is not None
                         else (0,))
                s2w = [b.s2w_sizes[k] for k in order]
            self._sizes = (w2s, s2w)
        self._w2s_check = _Expected("all-gather", self._sizes[0])
        self._s2w_check = _Expected("broadcast", self._sizes[1])

    def _grad_and_loss(self, params: dict, batch_slice: dict):
        """(loss, grads) of one worker at ``params``. On a pod mesh the
        rank holds its data index's rows of the worker's batch: its loss
        is its part of the worker's mean (a d-th of its rows' mean), and
        the loss and every gradient leaf are summed over the data
        subgroup in f32, in rank order (``row_grad``), so every rank of
        it holds the worker's."""
        paths = leaf_paths(params)
        rm = self.rm
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(params)]
            tree = tree_unflatten(paths, leaves)
            if rm is None or self.model.cfg.family not in TP_FAMILIES:
                loss = self.model.loss(tree, batch_slice)
            else:
                # the rank's chunks, known to the mesh by their cuts
                rm.bind("params", tree, self._param_specs)
                loss = self.model.loss(tree, batch_slice, mesh=rm)
            if rm is not None and rm.batch_split:
                loss = loss / rm.d
            unreached = self.model.unreached_leaves(batch_slice)
            grads = list(torch.autograd.grad(loss, leaves,
                                             allow_unused=bool(unreached)))
        # the leaves the model names, and only those, get zeros, as
        # jax.grad gives them (qwen2-vl's embed under an embeds batch)
        unused = {p for p, g in zip(paths, grads) if g is None}
        if unused != unreached:
            raise RuntimeError(f"leaves without a gradient {sorted(unused)}, "
                               f"the model names {sorted(unreached)}")
        loss = loss.detach()
        if rm is not None and rm.batch_split:
            grads = [None if g is None else rm.sum_partials(
                g.to(torch.float32), "row_grad", "data").to(g.dtype)
                for g in grads]
            loss = rm.sum_partials(loss.reshape(1), "row_grad", "data")[0]
        for i, g in enumerate(grads):
            if g is None:
                grads[i] = torch.zeros_like(leaves[i])
        return loss, tree_unflatten(paths, grads)

    def _gather(self, tree: Any) -> Any:
        """The worker->server hook: all-gather every tensor of ``tree``
        (a wire buffer ``[n_local, nbytes]``, or per-leaf payloads
        without the wire) over the group along its leading (worker) dim,
        into ``[n_workers, ...]``, each checked against the budget."""
        if self._w2s_check is None:
            self._arm_checks()

        def one(x: torch.Tensor) -> torch.Tensor:
            nbytes = x.numel() * x.element_size()
            self._w2s_check.take(nbytes)
            # over a mesh the worker axis's subgroup (the ranks of a data
            # row, or of a pod, hold the same payloads); where it has one
            # rank, that rank holds every worker
            out = (x if self.worker_group is None
                   else sharding.gather_tensor(x, self.worker_group))
            self.gathered.append(nbytes)
            return out

        return _map_tensors(one, tree)

    def _broadcast(self, buf: torch.Tensor) -> torch.Tensor:
        """The server->worker hook: broadcast the ``[1, nbytes]`` uint8 s2w
        (stage) buffer from rank 0 of the worker axis's subgroup to every
        rank of it, in place, checked against the budget. The server sends
        one message, so every link moves exactly the buffer's bytes."""
        if buf.dtype != torch.uint8 or buf.ndim != 2 or buf.shape[0] != 1:
            raise ValueError(f"the s2w broadcast takes a [1, nbytes] uint8 "
                             f"buffer, got {buf.dtype} {tuple(buf.shape)}")
        if self._s2w_check is None:
            self._arm_checks()
        self._s2w_check.take(buf.numel())
        if self.worker_group is not None:
            sharding.broadcast_tensor(buf, self.worker_group)
        self.broadcast_bytes.append(buf.numel())
        return buf

    def _gather_scalars(self, x: torch.Tensor) -> torch.Tensor:
        """The step's per-worker scalars ``[n_local, m]`` f32 -> ``[n_workers,
        m]``: one all-gather a step, recorded in ``aux_gathered``."""
        if self.worker_group is None:
            return x
        return sharding.gather_tensor(x, self.worker_group,
                                      self.aux_gathered)

    def make_step(self) -> Callable:
        """Returns step(state, batch, t) -> (state, aux); ``batch`` holds
        this rank's workers' rows (``[n_local, per_worker, ...]``), of
        which a rank of a pod mesh keeps its data index's where ``data``
        divides them (the reference's ``batch_pspec``: a worker's rows on
        ``data``; else every data rank runs them all)."""
        grouped = self.group is not None
        opt_step = self.opt.make_step(
            self.metas,
            reshard_payloads=self._gather if grouped else None,
            reshard_updates=self._broadcast if grouped else None,
            faults=self.tcfg.faults, donate=self.tcfg.donate,
            workers=self.workers,
            gather_scalars=self._gather_scalars if grouped else None,
            server=self.server, fsdp=self.tcfg.fsdp, cuts=self.cuts,
            worker_data=self.worker_data)
        pod = self.rm is not None and "pod" in self.mesh.axis_names

        def step(state: dict, batch: Any, t):
            if pod:
                # a worker's rows split over ``data`` where it divides
                # them, as ``batch_pspec`` puts them
                specs = sharding.batch_pspec(batch, self.mesh, "train")
                self.rm.batch_split = all(
                    len(sp) > 1 and sp[1] == "data" for sp in specs.values())
                if self.rm.batch_split:
                    batch = {k: self.rm.chunk(v, 1, "data")
                             for k, v in batch.items()}
            if not grouped:
                return opt_step(state, self._grad_and_loss, batch, t)
            self._arm_checks()
            out = opt_step(state, self._grad_and_loss, batch, t)
            self._w2s_check.check_done()
            self._s2w_check.check_done()
            return out

        return step

    def regroup(self, group, timeout=None) -> "Trainer":
        """A trainer like this one (its class, model, config, device and
        mesh) over ``group``, a group of the same ranks, its mesh's
        subgroups waiting ``timeout``: its records, byte checks and mesh
        its own, so nothing a step on one writes is the other's. A state
        carries over unchanged (its tensors do not depend on the group).
        ``train.supervisor.Supervisor`` makes one for each generation of
        its groups."""
        return type(self)(self.model, self.tcfg, device=self.device,
                          group=group, mesh=(self.rm.mesh if self.rm
                                             is not None else None),
                          timeout=timeout)

    def save_checkpoint(self, path: str, state: dict,
                        step: int | None = None) -> None:
        """``train.checkpoint.save_checkpoint`` of this rank's state: on a
        group every rank takes part in gathering the worker-lead leaves
        (recorded in ``aux_gathered``) and the server's cut leaves (in
        ``state_gathered``, each to the host as it comes), and rank 0
        writes the one-rank archive, byte for byte."""
        from repro_torch.train.checkpoint import save_checkpoint
        if self.rm is None:
            save_checkpoint(path, self.gather_server(state, to_host=True),
                            step=step, group=self.group,
                            record=self.aux_gathered)
            return
        # the server's leaves whole and the workers' whole over model on
        # every rank; the ranks at model index 0 (and, on a pod mesh, data
        # index 0: the data ranks of a pod hold the same workers) gather
        # the workers over the worker axis and its rank 0 writes
        state = self.gather_server(state, to_host=True)
        if self.rm.model_index == 0 and (
                self.rm.data_index == 0
                or sharding.worker_axis_for(self.mesh) == "data"):
            save_checkpoint(path, state, step=step, group=self.worker_group,
                            record=self.aux_gathered)
        dist.barrier(group=self.group)

    def load_checkpoint(self, path: str, like: dict) -> tuple[dict, Any]:
        """``train.checkpoint.load_checkpoint`` into this rank's slice: its
        workers' rows and its chunks of the server's leaves. Over a model
        axis the archive's leaves are cut on the host, so the card only
        ever holds the rank's chunks."""
        from repro_torch.train.checkpoint import load_checkpoint
        if self.cuts is None:
            state, step = load_checkpoint(path, like,
                                          group=self.worker_group)
            return self._shard_server(state), step
        device = tree_leaves(like["x"])[0].device
        host = _map_tensors(lambda t: torch.empty(0, dtype=t.dtype), like)
        state, step = load_checkpoint(path, host, group=self.worker_group)
        state = self._shard_server(self._cut_model(state))
        return _map_tensors(lambda t: t.to(device), state), step
