"""Placement over ``torch.distributed`` ranks (DESIGN.md §3).

Port of ``repro/dist/sharding.py``. Three parts:

* **The reference's placement rules**, as pure functions over a
  shape-only mesh (``MeshShape``: ``axis_names`` and a ``shape`` dict,
  what the reference's rules read): ``param_pspec``/``param_pspecs``
  (tensor parallel on ``model``, expert parallel on a stack dim, FSDP on
  ``data``), ``_worker_pspec``, ``_zero1_pspec``, ``state_pspecs``,
  ``ns_bucket_pspec``, ``batch_pspec`` and ``serve_pspecs``, with the
  ``model`` and ``pod`` branches. A spec is a tuple with one entry a
  dim: an axis name, a tuple of them, or None (the counterpart of a
  ``PartitionSpec``). ``to_shardings`` has no counterpart.
* **A group of P ranks as the worker axis** (``mesh_for``: the stand-in
  ``{"data": P}``, as ``worker_axis_for`` names it for one pod). With
  ``n_workers = P * n_local``, rank r owns workers ``[r * n_local, (r +
  1) * n_local)``: the rows of every leaf with a leading worker dim
  (``g_w``, ``m_w``, ``cw_state``, ``w_w``; the train batch). The
  server's state (``x``, ``g_server``, ``w``) is whole on every rank, or,
  with the trainer's ``zero1_lmo`` or ``fsdp``, held as ``state_pspecs``
  says (``ServerPlacement``): each rank keeps its chunk of a leaf along
  the one dim the spec puts on ``data``, and the step gathers a leaf
  whole where it needs it. Each rank owns whole workers, as the
  reference shards only a worker lead its axis divides.
* **Serving over a ``(data, model)`` mesh of ranks and training over a
  ``(pod, data, model)`` one** (``RankMesh``, the sharded
  ``train/serve.py`` ``Server`` and the mesh ``train/trainer.py``
  ``Trainer``): ``shard_params`` and ``draw_shards`` give a rank its
  chunks of the params as ``param_pspecs`` says (``cut``, ``spec_shape``,
  ``spec_bytes``), and the mesh holds the subgroups of each axis and of
  the compositions asked for, the ``model`` dim of each leaf it placed and the
  forward's collectives, each tagged with what it carries
  (``SERVE_TAGS``, ``TRAIN_TAGS``: never a parameter); under autograd
  they are differentiable. ``ModelCuts`` cuts and gathers the optimizer
  state's leaves on ``model``.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

# the state's leaves whose leading dim is the worker axis
WORKER_LEAD_KEYS = ("g_w", "m_w", "cw_state", "w_w")

# all_gather_single is the newer name of all_gather_into_tensor (same
# arguments); the older torch on some installations has only the latter
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def n_workers_for(group) -> int:
    """Ranks of the worker axis: the group's size (1 without one). Each
    rank holds ``n_workers / n_workers_for(group)`` EF21 workers."""
    return 1 if group is None else group.size()


def rank_of(group) -> int:
    """This process's rank in ``group`` (0 without one)."""
    return 0 if group is None else dist.get_rank(group)


def local_workers(group, n_workers: int) -> range:
    """The global ids of the workers this rank owns; raises where the
    group's size does not divide ``n_workers``."""
    p = n_workers_for(group)
    if n_workers % p:
        raise ValueError(
            f"{n_workers} workers over a group of {p} ranks: each rank "
            "owns whole workers, so the group's size must divide n_workers")
    n_local = n_workers // p
    r = rank_of(group)
    return range(r * n_local, (r + 1) * n_local)


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return tree


def shard_workers(tree: Any, group, n_workers: int) -> Any:
    """This rank's rows of every ``[n_workers, ...]`` tensor of ``tree``
    (a tensor of another lead raises), each a copy of its own, so the
    other ranks' rows are freed with the global tensor."""
    rows = local_workers(group, n_workers)

    def one(t: torch.Tensor) -> torch.Tensor:
        if t.ndim == 0 or t.shape[0] != n_workers:
            raise ValueError(f"a worker-lead leaf of shape {tuple(t.shape)}"
                             f" for {n_workers} workers")
        if len(rows) == n_workers:
            return t
        return t[rows.start:rows.stop].clone()

    return _map(one, tree)


def worker_lead_paths(state: dict) -> tuple[str, ...]:
    """The keys of ``state`` whose leaves lead with the worker axis, in
    ``WORKER_LEAD_KEYS`` order (``m_w`` is None without momentum)."""
    return tuple(k for k in WORKER_LEAD_KEYS if state.get(k) is not None)


def shard_state(state: dict, group, n_workers: int) -> dict:
    """The rank's slice of a global EF21-Muon state: the worker-lead
    leaves (``worker_lead_paths``) sharded, the rest as it is."""
    out = dict(state)
    for key in worker_lead_paths(state):
        out[key] = shard_workers(state[key], group, n_workers)
    return out


def gather_tensor(t: torch.Tensor, group, record: list | None = None
                  ) -> torch.Tensor:
    """``[n_local, ...]`` on every rank -> ``[P * n_local, ...]``, rank
    order, by one all-gather in ``t``'s dtype (an int16 tensor, which
    gloo does not take, as its bytes); a collective copies bytes, so
    NaN payloads keep their bits. A gloo group moves a CUDA tensor
    through pinned host memory (``host_staged``). ``record`` gets the
    bytes each rank sent."""
    t = t.contiguous()
    wire = t.view(torch.uint8) if t.dtype == torch.int16 else t
    out = torch.empty((group.size() * wire.shape[0],)
                      + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=t.device)
    if host_staged(group, t):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        _all_gather(host, wire.cpu(), group=group)
        out.copy_(host)
    else:
        _all_gather(out, wire, group=group)
    if record is not None:
        record.append(t.numel() * t.element_size())
    return out.view(t.dtype)


def broadcast_tensor(t: torch.Tensor, group, src_rank: int = 0
                     ) -> torch.Tensor:
    """``t`` of the group's rank ``src_rank`` written into ``t`` on every
    rank, by one broadcast (through pinned host memory where
    ``host_staged``)."""
    src = dist.get_global_rank(group, src_rank)
    if host_staged(group, t):
        host = t.cpu().pin_memory()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def exchange_tensor(t: torch.Tensor, send_rows: list[int],
                    recv_rows: list[int], group) -> torch.Tensor:
    """One all-to-all of ``t``'s leading rows: ``send_rows[q]`` rows (in
    order) to rank q, ``recv_rows[r]`` rows back from each rank r, in rank
    order (through pinned host memory where ``host_staged``)."""
    t = t.contiguous()
    out = torch.empty((sum(recv_rows),) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    if host_staged(group, t):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_to_all_single(host, t.cpu(), output_split_sizes=recv_rows,
                               input_split_sizes=send_rows, group=group)
        out.copy_(host)
    else:
        dist.all_to_all_single(out, t, output_split_sizes=recv_rows,
                               input_split_sizes=send_rows, group=group)
    return out


def gather_workers(tree: Any, group, record: list | None = None) -> Any:
    """Every worker-lead tensor of ``tree`` gathered from its ranks'
    slices (``gather_tensor``), in worker order."""
    return _map(lambda t: gather_tensor(t, group, record), tree)


def gather_state(state: dict, group, record: list | None = None) -> dict:
    """The global EF21-Muon state from the ranks' slices: every rank
    takes part (one all-gather per worker-lead tensor) and gets it."""
    out = dict(state)
    for key in worker_lead_paths(state):
        out[key] = gather_workers(state[key], group, record)
    return out


def host_staged(group, t: torch.Tensor) -> bool:
    """True where a collective of ``t`` goes through pinned host memory:
    a CUDA tensor over a gloo group (a gloo group is the transport of
    ranks that share one card, where NCCL refuses two ranks; its
    collectives take host tensors). Chosen by the group's backend, never
    after a failure: the compute stays on the card."""
    return (t.device.type == "cuda" and group is not None
            and dist.get_backend(group) == "gloo")


# ------------------------------------------------------ placement rules


class MeshShape:
    """A shape-only mesh: what the placement rules read of one."""

    def __init__(self, **axes: int):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def mesh_for(group) -> MeshShape | None:
    """The stand-in mesh of a group of P ranks, ``{"data": P}``: the group
    is the worker axis, which ``worker_axis_for`` names ``data`` on one
    pod (None without a group)."""
    return None if group is None else MeshShape(data=group.size())


def worker_axis_for(mesh) -> str:
    """The mesh axis of the EF21 workers: ``pod`` on a multi-pod mesh,
    else ``data``."""
    return "pod" if "pod" in mesh.axis_names else "data"


def param_pspec(meta, shape: tuple[int, ...], mesh,
                fsdp: bool = False) -> tuple:
    """The spec of one parameter leaf (``meta.stack_dims`` leading stack
    dims, then the core operand): ``model`` on an expert dim of a
    ``[L, E, ...]`` stack it divides, else on the last core dim it
    divides; with ``fsdp``, ``data`` on the last free dim it divides;
    vectors (a core of rank < 2) replicated."""
    model_n = mesh.shape.get("model", 1)
    data_n = mesh.shape.get("data", 1)
    nd = len(shape)
    sd = min(meta.stack_dims, nd)
    axes: list = [None] * nd
    if len(shape[sd:]) < 2:
        return tuple(axes)
    if model_n > 1:
        if sd >= 2 and shape[sd - 1] % model_n == 0:
            axes[sd - 1] = "model"
        else:
            for i in range(nd - 1, sd - 1, -1):
                if shape[i] % model_n == 0:
                    axes[i] = "model"
                    break
    if fsdp and data_n > 1:
        for i in range(nd - 1, -1, -1):
            if axes[i] is None and shape[i] % data_n == 0:
                axes[i] = "data"
                break
    return tuple(axes)


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts/lists (a None stays None);
    ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def param_pspecs(params: Any, metas: Any, mesh, fsdp: bool = False) -> Any:
    """``param_pspec`` over a params tree (``metas`` mirrors it)."""
    return _tree_map(lambda p, m: param_pspec(m, tuple(p.shape), mesh, fsdp),
                     params, metas)


def _worker_pspec(meta, shape: tuple[int, ...], mesh, fsdp: bool) -> tuple:
    """The spec of a leaf with a leading worker dim: the worker axis where
    it divides the lead, then the parameter rule, less any use of the
    worker axis (the worker dim wins)."""
    waxis = worker_axis_for(mesh)
    inner = list(param_pspec(meta, shape[1:], mesh, fsdp=fsdp))
    lead = waxis if mesh.shape.get(waxis, 1) > 1 \
        and shape[0] % mesh.shape[waxis] == 0 else None
    if lead is not None and lead in inner:
        inner[inner.index(lead)] = None
    return (lead, *inner)


def _zero1_pspec(meta, shape: tuple[int, ...], mesh, fsdp: bool) -> tuple:
    """The zero-1 rule of the server's state (``x``, ``g_server``,
    ``w``): the parameter rule, plus the leading stack dim on ``data``
    where it divides it and the rule left both free."""
    spec = param_pspec(meta, shape, mesh, fsdp=fsdp)
    data_n = mesh.shape.get("data", 1)
    if (meta.stack_dims >= 1 and data_n > 1 and len(shape) >= 1
            and shape[0] % data_n == 0
            and spec[0] is None and "data" not in spec):
        spec = ("data", *spec[1:])
    return spec


SERVER_KEYS = ("x", "g_server", "w")


def state_pspecs(state: dict, params: Any, metas: Any, mesh,
                 fsdp: bool = False, zero1_lmo: bool = False) -> dict:
    """The specs of an EF21-Muon state (only shapes are read, so meta
    tensors do): ``x``/``g_server``/``w`` by the parameter rule (the
    zero-1 rule with ``zero1_lmo``), ``g_w``/``m_w``/``w_w`` by
    ``_worker_pspec``, the step and everything else (the compressor
    states, the resync state) replicated, ``()``."""
    out: dict = {}
    for k, v in state.items():
        if v is None:
            out[k] = None
        elif k in SERVER_KEYS:
            rule = _zero1_pspec if zero1_lmo else param_pspec
            out[k] = _tree_map(
                lambda p, m: rule(m, tuple(p.shape), mesh, fsdp), v, metas)
        elif k in ("g_w", "m_w", "w_w"):
            out[k] = _tree_map(
                lambda p, m: _worker_pspec(m, tuple(p.shape), mesh, fsdp),
                v, metas)
        elif k == "step":
            out[k] = ()
        else:
            out[k] = _tree_map(lambda t: (), v)
    return out


def ns_bucket_pspec(batch: int, shape: tuple[int, int], member_specs, mesh,
                    stack_model: bool = False) -> tuple:
    """The spec of one ``[batch, m, n]`` Newton-Schulz bucket stack: the
    batch dim on the largest composition of the slow axes (``data``,
    ``pod``, ``("pod", "data")``; with ``stack_model`` also ``model``
    where the trailing dims leave it free) that divides it; the trailing
    dims on ``model`` where every TP-sharded member (``member_specs``,
    ``(row, col)`` in canonical orientation) puts it on the same one and
    it divides. No axis is used twice."""
    model_n = mesh.shape.get("model", 1)
    row = col = None
    if model_n > 1:
        pos = {(0 if r == "model" else 1)
               for r, c in member_specs if "model" in (r, c)}
        if pos == {0} and shape[0] % model_n == 0:
            row = "model"
        elif pos == {1} and shape[1] % model_n == 0:
            col = "model"
    slow = [a for a in ("pod", "data")
            if a in mesh.axis_names and mesh.shape.get(a, 1) > 1]
    cands: list[tuple[str, ...]] = [(a,) for a in slow]
    if len(slow) == 2:
        cands.append(("pod", "data"))
    if stack_model and model_n > 1 and row is None and col is None:
        cands += [c + ("model",) for c in cands] + [("model",)]
    lead: Any = None
    lead_n = 1
    for c in cands:
        n = 1
        for a in c:
            n *= mesh.shape[a]
        if batch % n == 0 and n > lead_n:
            lead, lead_n = c, n
    if lead is not None and len(lead) == 1:
        lead = lead[0]
    return (lead, row, col)


def batch_pspec(batch: Any, mesh, kind: str) -> Any:
    """Input batch specs: a train batch's ``[n_workers, per_worker, ...]``
    lead on the worker axis (and on a multi-pod mesh the per-worker rows
    on ``data``); a prefill or decode batch's lead on ``data``."""
    waxis = worker_axis_for(mesh)
    data_n = mesh.shape.get("data", 1)

    def one(x):
        shape = tuple(x.shape)
        axes: list = [None] * len(shape)
        if not shape:
            return ()
        if kind == "train":
            if mesh.shape.get(waxis, 1) > 1 \
                    and shape[0] % mesh.shape[waxis] == 0:
                axes[0] = waxis
            if waxis == "pod" and len(shape) > 1 and data_n > 1 \
                    and shape[1] % data_n == 0:
                axes[1] = "data"
        elif data_n > 1 and shape[0] % data_n == 0:
            axes[0] = "data"
        return tuple(axes)

    return _tree_map(one, batch)


def serve_pspecs(cache: Any, batch: int, mesh, cache_alt: Any = None) -> Any:
    """Decode-cache specs: the batch dim on ``data``, the largest other
    dim that ``model`` divides on ``model``, the rest replicated. The
    batch dim is where ``cache_alt`` (the same cache at another batch
    size) differs; without it, the first dim of size ``batch``,
    preferring dim 1 of a ``[L, B, ...]`` stack where L == B."""
    model_n = mesh.shape.get("model", 1)
    data_n = mesh.shape.get("data", 1)

    def one(x, alt=None):
        shape = tuple(x.shape)
        axes: list = [None] * len(shape)
        if alt is not None:
            if len(alt.shape) != len(shape):
                raise ValueError(
                    f"serve_pspecs: cache/cache_alt leaf rank mismatch "
                    f"({shape} vs {tuple(alt.shape)}): the batch dim is "
                    "found by elementwise shape diff, so both cache trees "
                    "must come from the same cache_spec at different batch "
                    "sizes")
            diff = [i for i, (s, t) in enumerate(zip(shape, alt.shape))
                    if s != t]
            b_i = diff[0] if diff else None
        else:
            cand = [i for i, s in enumerate(shape) if s == batch]
            b_i = cand[0] if cand else None
            if cand[:2] == [0, 1] and len(shape) >= 3:
                b_i = 1
        if b_i is not None and data_n > 1 and batch % data_n == 0:
            axes[b_i] = "data"
        cand = [(s, i) for i, s in enumerate(shape)
                if axes[i] is None and model_n > 1 and s > 1
                and s % model_n == 0]
        if cand:
            axes[max(cand)[1]] = "model"
        return tuple(axes)

    if cache_alt is not None:
        return _tree_map(one, cache, cache_alt)
    return _tree_map(one, cache)


# ------------------------------------------ shards of a leaf over ranks


def data_dim(spec: tuple) -> int | None:
    """The dim a spec puts on ``data`` (the group's axis), or None. A spec
    over a group's stand-in mesh uses ``data`` once at most and no other
    axis; one that names another raises."""
    other = [a for a in spec if a not in (None, "data")]
    if other:
        raise ValueError(f"spec {spec} names an axis other than the "
                         "group's 'data'")
    return spec.index("data") if "data" in spec else None


def shard_tensor(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` (rank r holds the r-th of
    P equal chunks), a copy of its own, so the rest is freed with ``t``.
    Every rank holds ``t`` whole (drawn or read alike): the chunk is cut
    where it lies, and no byte moves."""
    p = group.size()
    if t.shape[dim] % p:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} over {p} ranks")
    n = t.shape[dim] // p
    return t.narrow(dim, rank_of(group) * n, n).contiguous()


def gather_shards(t: torch.Tensor, dim: int, group,
                  record: list | None = None) -> torch.Tensor:
    """The inverse of ``shard_tensor``: every rank's chunk along ``dim``,
    in rank order, by one all-gather in ``t``'s dtype (through pinned
    host memory where ``host_staged``); ``record`` gets the bytes this
    rank sent."""
    out = gather_tensor(t.movedim(dim, 0), group, record)
    return out.movedim(0, dim).contiguous()


class ServerPlacement:
    """Where the server's state (``x``, ``g_server``, ``w``: one spec a
    leaf, the same for the three) lies over a group, and the step's
    moves between a leaf's chunk and the leaf whole. ``dims[i]`` is the
    dim leaf i is cut along (None: whole on every rank); ``params`` is
    the whole params tree (meta tensors do), whose shapes the step plans
    by. Each gather is checked against the bytes the spec gives (a
    leaf's P-th, or a bucket stack's ``[B/P, m, n]`` rows) and recorded
    in ``record``; one of another size raises before any byte moves.
    The metrics' per-slice values go to ``aux_record``."""

    def __init__(self, group, specs: list[tuple],
                 shapes: list[tuple[int, ...]], params: Any = None,
                 record: list | None = None, aux_record: list | None = None):
        self.group = group
        self.n = group.size()
        self.shapes = shapes
        self.params = params
        self.dims = [data_dim(s) for s in specs]
        self.record = record
        self.aux_record = aux_record

    @property
    def sharded(self) -> bool:
        """True where some leaf is held in chunks."""
        return any(d is not None for d in self.dims)

    def local(self, i: int, t: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """Leaf i whole (behind ``lead`` leading dims, e.g. the workers')
        -> this rank's chunk (itself where unsharded)."""
        d = self.dims[i]
        return t if d is None else shard_tensor(t, d + lead, self.group)

    def local_shape(self, i: int) -> tuple[int, ...]:
        shape = list(self.shapes[i])
        if self.dims[i] is not None:
            shape[self.dims[i]] //= self.n
        return tuple(shape)

    def _check(self, what: str, t: torch.Tensor, want: int) -> None:
        got = t.numel() * t.element_size()
        if got != want:
            raise ValueError(f"{what} moves {got} B a rank, the specs say "
                             f"{want} B")

    def whole(self, i: int, t: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """Leaf i's chunk (behind ``lead`` leading dims) -> leaf i whole,
        every rank (itself where unsharded: no collective)."""
        d = self.dims[i]
        if d is None:
            return t
        n = math.prod(t.shape[:lead]) * math.prod(self.local_shape(i))
        self._check(f"the gather of leaf {i}", t, n * t.element_size())
        return gather_shards(t, d + lead, self.group, self.record)

    def _needs(self, b, q: int) -> list[tuple[int, int]]:
        """The rows of bucket ``b``'s stack rank q needs, as ranges: a
        member cut along its stack lead (zero-1), its chunk's rows; any
        other member, all of its rows."""
        out, off = [], 0
        for i, shape, cnt in zip(b.leaf_ids, b.leaf_shapes, b.counts):
            if self.dims[i] == 0 and len(shape) > 2:
                n = cnt // self.n
                out.append((off + q * n, off + (q + 1) * n))
            else:
                out.append((off, off + cnt))
            off += cnt
        return out

    def share_rows(self, t: torch.Tensor, b) -> torch.Tensor:
        """This rank's ``[B/P, m, n]`` rows of bucket ``b``'s stack ->
        ``[B, m, n]`` holding every row this rank needs: all-gathered in
        rank order, or, where some member is cut along its stack lead
        (zero-1), each row sent only to the ranks that hold it, by one
        all-to-all (rows this rank does not need are left unset).
        ``record`` gets the bytes this rank sends: its rows (to each
        other rank) for the gather, the rows the others need for the
        all-to-all."""
        per = b.batch // self.n
        rest = tuple(t.shape[1:])
        self._check("a bucket's rows", t,
                    per * t.shape[1] * t.shape[2] * t.element_size())
        if not any(self.dims[i] == 0 and len(s) > 2
                   for i, s in zip(b.leaf_ids, b.leaf_shapes)):
            return gather_tensor(t, self.group, self.record)
        me = rank_of(self.group)

        def within(ranges, lo, hi):
            return [(max(a, lo), min(c, hi)) for a, c in ranges
                    if max(a, lo) < min(c, hi)]

        send = [within(self._needs(b, q), me * per, (me + 1) * per)
                for q in range(self.n)]
        recv = [within(self._needs(b, me), r * per, (r + 1) * per)
                for r in range(self.n)]
        count = lambda rs: [sum(c - a for a, c in r) for r in rs]  # noqa
        n_send, n_recv = count(send), count(recv)
        flat = t.reshape(per, -1)
        out = exchange_tensor(
            torch.cat([flat[a - me * per:c - me * per]
                       for ranges in send for a, c in ranges]),
            n_send, n_recv, self.group)
        if self.record is not None:
            self.record.append((sum(n_send) - n_send[me]) * flat.shape[1]
                               * t.element_size())
        full = t.new_empty((b.batch,) + rest)
        pos = 0
        for ranges in recv:
            for a, c in ranges:
                full[a:c] = out[pos:pos + c - a].view((c - a,) + rest)
                pos += c - a
        return full

    def gather_values(self, t: torch.Tensor) -> torch.Tensor:
        """Per-slice values of this rank's rows -> every rank's, rank
        order (a metric's, recorded in ``aux_record``)."""
        return gather_tensor(t.contiguous(), self.group, self.aux_record)


def server_placement(group, params: Any, metas: Any, specs: Any,
                     record: list | None = None,
                     aux_record: list | None = None) -> ServerPlacement:
    """The placement of a state whose ``x`` specs are ``specs`` (a tree
    like ``params``), leaves in the plan's order."""
    from repro_torch.dist.layerwise import leaf_paths, tree_get
    paths = leaf_paths(params)
    return ServerPlacement(
        group, [tuple(tree_get(specs, p)) for p in paths],
        [tuple(tree_get(params, p).shape) for p in paths], params=params,
        record=record, aux_record=aux_record)


# ------------------------------------------- serving over a (data, model) mesh

# what a serving collective may carry; a parameter never crosses
SERVE_TAGS = ("activation", "expert_out", "cache", "logits", "tokens")
# what a training collective over the mesh may carry: the forward's
# activations, expert outputs and logits, the backward's partial input
# gradients, a worker's gradient and loss partials over its rows (a pod
# mesh's ``data``), the compressors' whole inputs (a difference of the
# state's chunks, never x or w), the Newton-Schulz gram partials and slice
# rows, an LMO's whole gradient, squared-norm partials and the metrics'
# per-slice residuals. The wire, the s2w broadcast and the per-worker
# scalars move through the trainer's hooks
TRAIN_TAGS = ("activation", "activation_grad", "expert_out", "logits",
              "row_grad", "compressor_in", "gram", "ns_rows", "lmo_in",
              "norms")


def spec_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of one rank's chunk of a leaf of ``shape`` cut as ``spec``
    says (each named dim divided by its axis's size)."""
    out = list(shape)
    for i, a in enumerate(spec):
        if a is not None:
            if out[i] % mesh.shape[a]:
                raise ValueError(f"dim {i} of {tuple(shape)} over "
                                 f"{mesh.shape[a]} ranks of {a!r}")
            out[i] //= mesh.shape[a]
    return tuple(out)


def cut(t: torch.Tensor, spec: tuple, mesh, coords: dict) -> torch.Tensor:
    """This rank's chunk of ``t`` (``coords``: the rank's index on each
    axis), a copy of its own; ``t`` itself where ``spec`` cuts nothing."""
    if all(a is None for a in spec):
        return t
    for i, a in enumerate(spec):
        if a is not None:
            n = t.shape[i] // mesh.shape[a]
            t = t.narrow(i, coords[a] * n, n)
    return t.contiguous()


def shard_params(params: Any, metas: Any, mesh, coords: dict) -> Any:
    """A whole params tree (the port's, or the reference's carried by
    ``params_from_jax``) cut into one rank's chunks as ``param_pspecs``
    says."""
    return _tree_map(lambda p, m: cut(p, param_pspec(m, tuple(p.shape),
                                                     mesh), mesh, coords),
                     params, metas)


def draw_shards(model, generator, device, mesh, coords: dict):
    """(this rank's chunks of ``model.init``'s params, metas): each leaf is
    drawn whole from ``generator`` (the one-rank stream, so the chunks are
    the cuts of the one-rank draw) and cut as ``param_pspec`` says before
    the next is drawn, so a rank holds its chunks and one whole leaf at
    most."""
    def hook(path: str, p: torch.Tensor, meta) -> torch.Tensor:
        return cut(p, param_pspec(meta, tuple(p.shape), mesh), mesh, coords)

    if mesh.shape.get("model", 1) == 1:
        return model.init(generator, device)
    return model.init(generator, device, leaf_hook=hook)


def spec_bytes(tree: Any, specs: Any, mesh) -> int:
    """The bytes of one rank's chunks of ``tree``'s leaves (meta tensors
    do) cut as ``specs`` say."""
    out = []
    _tree_map(lambda t, s: out.append(
        math.prod(spec_shape(tuple(t.shape), s, mesh)) * t.element_size()),
        tree, specs)
    return sum(out)


_SUBGROUPS: dict = {}
# a mesh's axes, in the order the reference's ``Mesh`` lays them out
AXES = ("pod", "data", "model")


def destroy_group(group) -> None:
    """``dist.destroy_process_group`` of ``group`` and of every subgroup a
    ``RankMesh`` made from it, and their entries dropped (local to the
    rank: no collective). A collective still inside one ends at its own
    timeout; one begun after raises. ``train/supervisor.py`` retires a
    generation of groups so."""
    for key in [k for k in _SUBGROUPS if k[0] is group]:
        for sub in _SUBGROUPS.pop(key).values():
            if sub is not group:
                dist.destroy_process_group(sub)
    dist.destroy_process_group(group)


def _subgroups(group, p: int, d: int, m: int, axes: tuple,
               timeout=None) -> dict:
    """The subgroups of the composition ``axes`` (a tuple in mesh order of
    axes with several ranks) of a group of p x d x m ranks at ``(r // (d
    m), (r // m) % d, r % m)``: the ranks that share the other axes'
    indices, keyed by those indices; the group itself where ``axes`` is
    every axis with several ranks (the other indices all 0).
    ``dist.new_group`` is entered by every process of the job, so the
    group must be the job's whole world where two axes or more have
    several ranks; made once per (group, p, d, m, axes, timeout), with
    the collective ``timeout`` (a ``timedelta``; None: the backend's
    default)."""
    key = (group, p, d, m, axes, timeout)
    if key not in _SUBGROUPS:
        sizes = {"pod": p, "data": d, "model": m}
        others = [a for a in AXES if a not in axes]
        if all(sizes[a] == 1 for a in others):
            _SUBGROUPS[key] = {(0,) * len(others): group}
        else:
            n = p * d * m
            members: dict = {}
            for r in range(n):
                at = {"pod": r // (d * m), "data": (r // m) % d,
                      "model": r % m}
                members.setdefault(tuple(at[a] for a in others), []).append(
                    dist.get_global_rank(group, r))
            _SUBGROUPS[key] = {k: dist.new_group(v, timeout=timeout)
                               for k, v in sorted(members.items())}
    return _SUBGROUPS[key]


class RankMesh:
    """A ``(pod, data, model)`` mesh over the ranks of ``group`` (``pod``
    may be absent): rank r sits at ``(r // (d m), (r // m) % d, r % m)``,
    the row-major order of the reference's ``Mesh(devices.reshape(p, d,
    m), ("pod", "data", "model"))``. The model subgroup of a rank holds
    the m ranks of its (pod, data) index, the data subgroup the d ranks
    of its (pod, model) index, the pod subgroup the p ranks of its (data,
    model) index; a composition of axes (``("pod", "data")``, in mesh
    order, made by ``compose`` where a bucket's lead asks for it) holds
    the ranks that share the other axes' indices, its index pod-major.
    ``pod`` never cuts a parameter. The sharded ``Server`` and
    the mesh ``Trainer`` both run on one.

    It holds what a rank's forward needs to compute what one rank does:
    the ``model`` dim of each leaf it placed (``bind``; a leaf is known by
    its identity while it is bound), and the collectives, each recorded
    as ``(tag, bytes this rank sent, seconds, host-staged)`` in
    ``record``, its tag one of ``SERVE_TAGS`` or ``TRAIN_TAGS``. Over a
    gloo group a CUDA tensor moves through pinned host memory
    (``host_staged``).

    The collectives of a forward under autograd (a training step's;
    serving runs under ``inference_mode``) are differentiable (Megatron's
    pair): a gather's backward keeps the rank's chunk of the gradient (no
    collective: what follows the gather is replicated over the subgroup);
    a replicated activation entering a product with a cut weight passes
    an identity whose backward sums the model subgroup's partial input
    gradients (``activation_grad``); a product cut on its reduction dim
    sums its partials forward and passes its gradient through. Its
    subgroups' collectives wait ``timeout`` (a ``timedelta``; None: the
    backend's default)."""

    def __init__(self, mesh, group, timeout=None):
        if group is None:
            raise ValueError("a mesh needs a process group of its ranks "
                             "(group=...)")
        extra = set(mesh.axis_names) - set(AXES)
        if extra:
            raise ValueError("a mesh has the axes 'pod', 'data' and "
                             f"'model', not {sorted(extra)}")
        self.p = mesh.shape.get("pod", 1)
        self.d = mesh.shape.get("data", 1)
        self.m = mesh.shape.get("model", 1)
        self.mesh = (MeshShape(pod=self.p, data=self.d, model=self.m)
                     if "pod" in mesh.axis_names
                     else MeshShape(data=self.d, model=self.m))
        if self.p * self.d * self.m != group.size():
            raise ValueError(f"mesh pod={self.p} x data={self.d} x "
                             f"model={self.m} over a group of "
                             f"{group.size()} ranks")
        if sum(n > 1 for n in (self.p, self.d, self.m)) > 1 \
                and group.size() != dist.get_world_size():
            raise ValueError("a mesh with two axes or more over several "
                             "ranks makes its subgroups with "
                             "dist.new_group, which every process of the "
                             "job enters: give the world's group")
        self.group = group
        self.timeout = timeout
        r = dist.get_rank(group)
        self.pod_index = r // (self.d * self.m)
        self.data_index, self.model_index = (r // self.m) % self.d, \
            r % self.m
        self.coords = {"pod": self.pod_index, "data": self.data_index,
                       "model": self.model_index}
        # each axis with several ranks, in one fixed order, and all of
        # them (the group); any other composition where ``compose`` asks
        self._groups: dict = {}
        for axis in ("model", "data", "pod", AXES):
            self.compose(axis)
        self.model_group = self.axis_group("model")
        self.data_group = self.axis_group("data")
        self.record: list[tuple[str, int, float, bool]] = []
        # True while the request's (or a worker's) rows are split over
        # ``data``
        self.batch_split = False
        self._dims: dict[str, dict] = {}
        self._held: dict[str, list] = {}

    def _axes(self, axis) -> tuple[str, ...]:
        """An axis ("pod", "data", "model") or a composition of them in
        mesh order, less the axes of one rank."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if any(a not in AXES for a in axes) or list(axes) != sorted(
                axes, key=AXES.index):
            raise ValueError(f"mesh axes {axis!r}: 'pod', 'data', "
                             "'model', or a composition in that order")
        return tuple(a for a in axes if self.mesh.shape.get(a, 1) > 1)

    # ------------------------------------------------------------ leaves
    def bind(self, kind: str, tree: Any, specs: Any) -> None:
        """Know the leaves of ``tree`` (a rank's chunks; ``kind`` "params"
        or "cache", each replacing the last of its kind) by the dim each
        spec puts on ``model``."""
        dims, held = {}, []

        def one(t, s):
            dims[id(t)] = s.index("model") if "model" in s else None
            held.append(t)

        _tree_map(one, tree, specs)
        self._dims[kind], self._held[kind] = dims, held

    def holds(self, kind: str, tree: Any) -> bool:
        """True where every leaf of ``tree`` is a bound leaf of ``kind``."""
        dims = self._dims.get(kind, {})
        leaves = []
        _tree_map(leaves.append, tree)
        return bool(leaves) and all(id(t) in dims for t in leaves)

    def model_dim(self, t: torch.Tensor) -> int | None:
        """The dim of a bound leaf its spec puts on ``model`` (None:
        whole on every rank); an unbound tensor raises."""
        for dims in self._dims.values():
            if id(t) in dims:
                return dims[id(t)]
        raise KeyError("a tensor this mesh did not place")

    def whole_shape(self, t: torch.Tensor) -> tuple[int, ...]:
        """A bound leaf's shape whole over ``model``."""
        shape = list(t.shape)
        d = self.model_dim(t)
        if d is not None:
            shape[d] *= self.m
        return tuple(shape)

    # ------------------------------------------------------- collectives
    def _log(self, tag: str, fn: Callable, t: torch.Tensor, group):
        if tag not in SERVE_TAGS and tag not in TRAIN_TAGS:
            raise ValueError(f"collective tag {tag!r} not in SERVE_TAGS "
                             "or TRAIN_TAGS")
        rec: list = []
        t0 = time.perf_counter()
        out = fn(rec)
        self.record.append((tag, sum(rec) if rec else
                            t.numel() * t.element_size(),
                            time.perf_counter() - t0,
                            host_staged(group, t)))
        return out

    def compose(self, axis) -> None:
        """Make the subgroups of ``axis`` (see ``_axes``) where they are
        not made yet. ``dist.new_group`` is entered by every process of
        the job: every rank calls this with the same axes in the same
        order."""
        axes = self._axes(axis)
        if axes and axes not in self._groups:
            subs = _subgroups(self.group, self.p, self.d, self.m, axes,
                              self.timeout)
            self._groups[axes] = subs[tuple(self.coords[a] for a in AXES
                                            if a not in axes)]

    def axis_group(self, axis):
        """The subgroup of ``axis`` (see ``_axes``), None where it has one
        rank; a composition ``compose`` has not made raises."""
        axes = self._axes(axis)
        if not axes:
            return None
        if axes not in self._groups:
            raise KeyError(f"mesh axes {axes}: no subgroups made "
                           "(RankMesh.compose, on every rank)")
        return self._groups[axes]

    def axis_size(self, axis) -> int:
        """The ranks of ``axis`` (see ``_axes``)."""
        return math.prod(self.mesh.shape[a] for a in self._axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's index on ``axis`` (see ``_axes``), a composition's
        row-major in mesh order."""
        out = 0
        for a in self._axes(axis):
            out = out * self.mesh.shape[a] + self.coords[a]
        return out

    @staticmethod
    def _tracked(t: torch.Tensor, group) -> bool:
        # a collective that autograd sees
        return (group is not None and t.requires_grad
                and torch.is_grad_enabled())

    def _gather(self, t: torch.Tensor, dim: int, tag: str, g):
        return self._log(tag, lambda rec: gather_shards(t, dim, g, rec), t, g)

    def _sum(self, t: torch.Tensor, tag: str, g) -> torch.Tensor:
        parts = self._log(tag, lambda rec: gather_tensor(t[None], g, rec),
                          t, g)
        out = parts[0]
        for i in range(1, parts.shape[0]):
            out = out + parts[i]
        return out

    def gather(self, t: torch.Tensor, dim: int, tag: str,
               axis="model") -> torch.Tensor:
        """Every rank's ``t`` of the ``axis`` subgroup concatenated along
        ``dim`` in rank order (one all-gather); under autograd its
        backward keeps the rank's chunk of the gradient."""
        g = self.axis_group(axis)
        if g is None:
            return t
        if self._tracked(t, g):
            return _GatherAxis.apply(t, self, dim % t.dim(), tag, axis)
        return self._gather(t, dim % t.dim(), tag, g)

    def sum_partials(self, t: torch.Tensor, tag: str,
                     axis="model") -> torch.Tensor:
        """The sum of the ``axis`` subgroup's partial ``t`` (f32): an
        all-reduce made of one all-gather and adds in rank order, so every
        rank holds the same bits; under autograd its backward passes the
        gradient through."""
        g = self.axis_group(axis)
        if g is None:
            return t
        if self._tracked(t, g):
            return _SumForward.apply(t, self, tag, g)
        return self._sum(t, tag, g)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (an activation every rank of the model subgroup holds
        alike) as the input of a product with a cut weight: itself, whose
        gradient under autograd is the sum of the subgroup's partial
        gradients, in f32 and rank order."""
        return _SumBackward.apply(x, self) \
            if self._tracked(x, self.model_group) else x

    def chunk(self, t: torch.Tensor, dim: int, axis="model") -> torch.Tensor:
        """This rank's chunk of ``t`` along ``dim`` over ``axis`` (``t``
        itself where the axis has one rank)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        k = t.shape[dim] // n
        return t.narrow(dim, self.axis_index(axis) * k, k).contiguous()

    def broadcast(self, t: torch.Tensor, src: int, tag: str) -> torch.Tensor:
        """``t`` of the model subgroup's rank ``src`` on every rank of it."""
        if self.model_group is None:
            return t
        return self._log(tag, lambda rec: broadcast_tensor(
            t, self.model_group, src), t, self.model_group)

    # --------------------------------------------------------- products
    def matmul(self, x: torch.Tensor, w: torch.Tensor, l: int | None = None,
               dtype: torch.dtype | None = None) -> torch.Tensor:
        """``x @ w[l]`` (``w`` itself where ``l`` is None; the weight cast
        to ``dtype`` where given) with ``w`` a bound leaf, replicated
        ``x``: a weight cut on its last dim multiplies the rank's columns,
        then one all-gather along the last dim (each output entry one
        rank's dot product over the whole K); cut on the dim before it,
        the rank's rows against x's matching columns in f32, summed over
        the subgroup (``sum_partials``) and cast back."""
        dim = self.model_dim(w)
        wl = w if l is None else w[l]
        if dtype is not None:
            wl = wl.to(dtype)
        if dim is None:
            return x @ wl
        x = self.replicated(x)
        dim -= w.dim() - wl.dim()
        if dim == wl.dim() - 1:
            return self.gather(x @ wl, -1, "activation")
        if dim == wl.dim() - 2:
            n = wl.shape[-2]
            part = x[..., self.model_index * n:(self.model_index + 1) * n]
            out = self.sum_partials(part.to(torch.float32)
                                    @ wl.to(torch.float32), "activation")
            return out.to(torch.promote_types(x.dtype, wl.dtype))
        raise NotImplementedError(
            f"a product with a weight cut on its dim {dim} of {wl.dim()}")

    # ------------------------------------------------------------ caches
    def whole_layer(self, c: torch.Tensor, l: int) -> torch.Tensor:
        """Layer ``l`` of a bound ``[L, ...]`` cache leaf, whole over
        ``model``, for this step only: gathered along its cut dim, or,
        cut on the layers, sent by the rank that holds it."""
        dim = self.model_dim(c)
        if dim is None:
            return c[l]
        if dim > 0:
            return self.gather(c[l], dim - 1, "cache")
        n = c.shape[0]
        owner = l // n
        buf = c[l - owner * n].clone() if owner == self.model_index \
            else c.new_empty(c.shape[1:])
        return self.broadcast(buf, owner, "cache")

    def write_layer(self, c: torch.Tensor, l: int,
                    whole: torch.Tensor) -> None:
        """Layer ``l`` of a bound cache leaf set from its whole value: each
        rank writes its chunk (the rank holding the layer, cut on the
        layers)."""
        dim = self.model_dim(c)
        if dim is None:
            c[l] = whole
        elif dim == 0:
            n = c.shape[0]
            if l // n == self.model_index:
                c[l - self.model_index * n] = whole
        else:
            n = c.shape[dim]
            c[l] = whole.narrow(dim - 1, self.model_index * n, n)

    def write_slot(self, c: torch.Tensor, l: int, slot: int,
                   val: torch.Tensor) -> None:
        """Slot ``slot`` (dim 2, the sequence) of layer ``l`` of a bound
        ``[L, B, cap, ...]`` cache leaf set to ``val`` (``[B, ...]``): on
        the rank that owns it where the cut is on the sequence or the
        layers, each rank its chunk of ``val`` where it is on another
        dim."""
        dim = self.model_dim(c)
        if dim is None:
            c[l][:, slot] = val
            return
        n, j = c.shape[dim], self.model_index
        if dim == 0:
            if l // n == j:
                c[l - j * n][:, slot] = val
        elif dim == 2:
            if slot // n == j:
                c[l][:, slot - j * n] = val
        else:   # the batch (dim 1) or a dim after the sequence
            c[l][:, slot] = val.narrow(dim - 1 if dim == 1 else dim - 2,
                                       j * n, n)



class ModelCuts:
    """The ``model`` cut of each leaf of a params tree, in the plan's
    leaf order, on one rank of a training ``RankMesh``: the server's state
    (``x``, ``g_server``, ``w``) and the inner dims of the worker-lead
    leaves hold the rank's chunks as ``param_pspec`` cuts them.
    ``params`` is the whole params tree (meta tensors do), whose shapes
    the step plans by. ``whole`` gathers a chunk whole over the model
    subgroup (checked against the spec's bytes before any byte moves),
    ``cut`` keeps the rank's chunk of a whole leaf."""

    def __init__(self, rm: RankMesh, params: Any, metas: Any):
        from repro_torch.dist.layerwise import leaf_paths, tree_get
        self.rm, self.params, self.mesh = rm, params, rm.mesh
        paths = leaf_paths(params)
        self.shapes = [tuple(tree_get(params, p).shape) for p in paths]
        self.specs = [param_pspec(tree_get(metas, p), shape, rm.mesh)
                      for p, shape in zip(paths, self.shapes)]
        self.dims = [s.index("model") if "model" in s else None
                     for s in self.specs]

    def local_shape(self, i: int) -> tuple[int, ...]:
        """Leaf i's chunk shape over ``model``."""
        return spec_shape(self.shapes[i], self.specs[i], self.mesh)

    def cut(self, i: int, t: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """Leaf i whole (behind ``lead`` leading dims) -> the rank's chunk
        (itself where the leaf is not cut)."""
        d = self.dims[i]
        return t if d is None else self.rm.chunk(t, d + lead)

    def whole(self, i: int, t: torch.Tensor, tag: str,
              lead: int = 0) -> torch.Tensor:
        """Leaf i's chunk (behind ``lead`` leading dims) -> leaf i whole
        on every rank of the model subgroup, one all-gather tagged
        ``tag`` (itself where the leaf is not cut)."""
        d = self.dims[i]
        if d is None:
            return t
        want = self.local_shape(i)
        if tuple(t.shape[lead:]) != want:
            raise ValueError(f"the gather of leaf {i} holds "
                             f"{tuple(t.shape[lead:])}, the spec says "
                             f"{want}")
        return self.rm.gather(t, d + lead, tag)


class _GatherAxis(torch.autograd.Function):
    """The ``axis`` subgroup's chunks along ``dim`` -> whole; the backward
    keeps the rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, t, rm: RankMesh, dim: int, tag: str, axis):
        ctx.rm, ctx.dim, ctx.n, ctx.axis = rm, dim, t.shape[dim], axis
        return rm._gather(t, dim, tag, rm.axis_group(axis))

    @staticmethod
    def backward(ctx, grad):
        j = ctx.rm.axis_index(ctx.axis)
        return (grad.narrow(ctx.dim, j * ctx.n, ctx.n).contiguous(), None,
                None, None, None)


class _SumBackward(torch.autograd.Function):
    """Identity forward; the backward sums the model subgroup's partial
    gradients in f32, in rank order (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, rm: RankMesh):
        ctx.rm = rm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.rm._sum(grad.to(torch.float32), "activation_grad",
                            ctx.rm.model_group).to(grad.dtype), None)


class _SumForward(torch.autograd.Function):
    """A subgroup's partials summed forward; identity backward
    (Megatron's ``g``, for a product cut on its reduction dim)."""

    @staticmethod
    def forward(ctx, t, rm: RankMesh, tag: str, g):
        return rm._sum(t, tag, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None
