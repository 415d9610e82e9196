"""The EF21 worker axis spread over ``torch.distributed`` ranks.

On the CPU over gloo: four processes (``torch.multiprocessing`` with a
``FileStore``) run reduced nanogpt-124m with 4 workers, ``--w2s
top10+natural --s2w natural``, as 4 ranks of 1 worker and, on a
two-rank subgroup, as 2 ranks of 2, in the three scenarios of the
reference's SPMD tests (``tests/test_sharding.py``: the plain step, a
dropped worker under elastic participation, the rejoin). Every rank's
losses, x, W and g_server are held bit for bit against the one-process
run of the same 4 workers, its worker-lead state (``g_w``, ``m_w``,
``cw_state``, ``w_w``) against that run's rows, and its collectives
against the wire budget: K u8 all-gathers of ``n_local * w2s_sizes[k]``
and K broadcasts of ``s2w_sizes`` in ``s2w_issue_order`` a step, the
per-worker scalars in one f32 all-gather (``aux_gathered``). Beside
them: the unpacked arm, a buffer one byte short, a group that does not
divide the workers, and checkpoints moving between 2 ranks and 1.

The server's placement (``Trainer.state_specs``): every arm splits each
NS bucket its ranks divide, each rank's NS chain taking ``[B/P, m, n]``;
the ``zero1`` arms hold ``x``, ``g_server`` and ``w`` cut along the
2-layer stacks' leading dim on 2 ranks (on 4 the rule leaves them whole
and only the buckets split), the ``fsdp`` arm along each leaf's last dim
2 divides. Each is bit for bit the one-process run (x, W and g_server
gathered whole), holds exactly the bytes its specs give, and its state
gathers (``state_gathered``) are the specs' sizes, the same every step;
sharded checkpoints move between 2 ranks and 1 both ways. A
fifth process runs the reference (JAX) from the port's initial state on
the port's batches; the losses agree within the two-way tolerance of
``tests/test_torch_s2w.py``.

Every process runs one torch thread, and every join has a timeout, so a
hung collective fails the test instead of waiting.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.dist.layerwise import tree_leaves
from repro_torch.dist.pipeline import s2w_issue_order
from repro_torch.dist.sharding import worker_lead_paths
from repro_torch.models.api import build_model
from repro_torch.train.faults import parse_faults
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS, SEQ, BATCH, N_WORKERS, WORLD = 3, 16, 4, 4, 4
BASE = dict(n_workers=N_WORKERS, beta=0.5, w2s="top10+natural",
            s2w="natural")
DROP = "drop:w=1:steps=0-2"
# scenario -> TrainerConfig switches; the reference's three SPMD tests
SCENARIOS = {
    "plain": {},
    "elastic": {"participation": "round_robin(3)", "faults": DROP},
    "resync": {"resync": 4, "faults": DROP},
}
# (scenario, arm) -> (ranks, TrainerConfig switches of the arm)
ARMS = {
    ("plain", "4x1"): (4, {}),
    ("plain", "4x1-mono"): (4, {"wire_stages": 1}),
    ("plain", "2x2"): (2, {}),
    ("plain", "2x2-mono"): (2, {"wire_stages": 1}),
    ("plain", "2x2-unpacked"): (2, {"wire_pack": False}),
    ("elastic", "4x1"): (4, {}),
    ("elastic", "2x2"): (2, {}),
    ("resync", "4x1"): (4, {}),
    ("resync", "2x2"): (2, {}),
    ("plain", "2x2-zero1"): (2, {"zero1_lmo": True}),
    ("plain", "4x1-zero1"): (4, {"zero1_lmo": True}),
    ("plain", "2x2-fsdp"): (2, {"fsdp": True}),
    ("elastic", "2x2-zero1"): (2, {"zero1_lmo": True}),
    ("resync", "2x2-zero1"): (2, {"zero1_lmo": True}),
}
# the arms whose state is checkpointed after step 1
SAVES = {("plain", "2x2"): "ck_2ranks", ("plain", "2x2-zero1"): "ck_zero1",
         ("plain", "2x2-fsdp"): "ck_fsdp"}
# the placements a one-rank checkpoint is resumed into on 2 ranks
RESUMES = {"resume_on_2": {}, "resume_on_2_zero1": {"zero1_lmo": True},
           "resume_on_2_fsdp": {"fsdp": True}}
JOIN_S = 240


def _setup(group, scenario: str, **arm):
    kw = dict(BASE, **SCENARIOS[scenario], **arm)
    if kw.get("faults"):
        kw["faults"] = parse_faults(kw["faults"], N_WORKERS)
    cfg = get_config("nanogpt-124m").reduced()
    tr = Trainer(build_model(cfg), TrainerConfig(**kw), device="cpu",
                 group=group)
    data = SyntheticLM(cfg, ShapeSpec("t", "train", SEQ, BATCH),
                       n_workers=N_WORKERS, seed=0, device="cpu", group=group)
    return tr, data, warmup_linear_decay(0.01, 3, STEPS)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _digest(tree, rows: range | None = None) -> str:
    """sha256 of every tensor's bytes, in tree order (``rows``: only
    those rows of each, the leading dim being the workers')."""
    h = hashlib.sha256()
    for t in _tensors(tree):
        if rows is not None:
            t = t[rows.start:rows.stop]
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _record(tr, state, out: dict, rows: range | None) -> dict:
    """What a run leaves to compare: losses and counts, the bytes of the
    server's leaves this rank holds, digests of the server's state
    gathered whole and of the worker-lead leaves (this rank's rows)."""
    rec = dict(out)
    rec["state_gathered"] = list(tr.state_gathered)
    rec["server_bytes"] = {key: sum(t.numel() * t.element_size()
                                    for t in _tensors(state[key]))
                           for key in ("x", "w", "g_server")}
    state = tr.gather_server(state)
    for key in ("x", "w", "g_server", "cs_state"):
        rec[key] = _digest(state[key])
    for key in worker_lead_paths(state):
        rec["local/" + key] = _digest(state[key], rows)
    rec["local_state_bytes"] = sum(
        t.numel() * t.element_size() for key in worker_lead_paths(state)
        for t in _tensors(state[key]))
    if "w_w" in state:
        rec["w_j_equal_w"] = all(
            torch.equal(ww[j].view(torch.int32), w.view(torch.int32))
            for w, ww in zip(tree_leaves(state["w"]),
                             tree_leaves(state["w_w"]))
            for j in range(ww.shape[0]))
    return rec


def _run(tr, data, sched, state=None, start: int = 0,
         steps: int = STEPS, save_at: tuple | None = None):
    """Steps ``start`` .. ``steps - 1``: per step the loss and the
    elastic and resync counts. ``save_at=(step, path)`` checkpoints the
    state after that step."""
    step_fn = tr.make_step()
    state = tr.init(0) if state is None else state
    out = {"losses": [], "n_participants": [], "skipped": [],
           "lags": [], "replayed": [], "full": []}
    for i in range(start, steps):
        state, aux = step_fn(state, data.batch_at(i), sched(i))
        out["losses"].append(float(aux["loss"]))
        if "n_participants" in aux:
            out["n_participants"].append(int(aux["n_participants"]))
            out["skipped"].append(bool(aux["skipped"]))
        if "resync_replayed" in aux:
            out["lags"].append(int(aux["version_lag_max"]))
            out["replayed"].append(int(aux["resync_replayed"]))
            out["full"].append(int(aux["resync_full"]))
        if save_at is not None and i == save_at[0]:
            n0, n1 = len(tr.aux_gathered), len(tr.state_gathered)
            tr.save_checkpoint(save_at[1], state, step=i + 1)
            out["ckpt_gathered"] = tr.aux_gathered[n0:]
            # the server's cut leaves, gathered for the archive
            out["ckpt_state_gathered"] = [n1, tr.state_gathered[n1:]]
    return state, out


def _state_budget(tr, scenario: str) -> dict:
    """What the specs give a step's state gathers, from the plan and
    ``state_specs`` alone: per leaf the specs cut, its chunk's bytes in
    f32 for ``w`` and ``g_server`` and in x's dtype for x (twice: the s2w
    compress and the LMO) and for W before the gradients (with resync,
    in f32 for the full copy instead); per bucket the group divides, its
    ``[B/P, m, n]`` rows in x's dtype when all-gathered, or, where zero-1
    cuts the members' stacks, the rows the other ranks hold, counted row
    by row. Returned as sizes -> count, and
    each rank's bytes at rest of x, w and g_server."""
    from collections import Counter
    from repro_torch.dist.layerwise import leaf_paths as paths_of
    from repro_torch.dist.layerwise import tree_get
    p = tr.group.size()
    specs = tr.state_specs()["x"]
    shapes = tr._params_shapes
    want: Counter = Counter()
    held = {"x": 0, "w": 0, "g_server": 0}
    for path in paths_of(shapes):
        t, spec = tree_get(shapes, path), tree_get(specs, path)
        n, xb = t.numel(), t.element_size()
        cut = "data" in spec
        chunk = n // p if cut else n
        held["x"] += chunk * xb
        held["w"] += chunk * 4
        held["g_server"] += chunk * 4
        if cut:
            want[chunk * 4] += 2          # w (s2w compress), g_server
            want[chunk * xb] += 2         # x (s2w compress, LMO)
            want[chunk * (4 if scenario == "resync" else xb)] += 1  # W
    me = tr.group.rank()
    for b in tr.layer_plan().ns_buckets(mesh=tr.mesh):
        if b.pspec is None or b.batch % p:
            continue
        m, n = b.shape
        per = b.batch // p
        # who needs row j: the holder of its chunk where zero-1 cuts its
        # member's stack lead, else every rank
        owner = []
        for i, shape, cnt in zip(b.leaf_ids, b.leaf_shapes, b.counts):
            lead = "data" == tree_get(specs, tr.layer_plan().paths[i])[0]
            owner += [j // (cnt // p) if lead and len(shape) > 2 else None
                      for j in range(cnt)]
        if all(o is None for o in owner):
            want[per * m * n * 4] += 1    # all-gathered: its rows
        else:                             # the rows the others need
            sent = sum(1 for j in range(me * per, (me + 1) * per)
                       for q in range(p)
                       if q != me and owner[j] in (None, q))
            want[sent * m * n * 4] += 1
    return {"want_state": {str(k): v for k, v in want.items()},
            "want_held": held}


def _ns_shapes(record: list):
    """Patch the NS chain to record the stacks it is handed."""
    from repro_torch.kernels import ops
    plain = ops._iterate

    def iterate(x, steps, coeffs):
        record.append(list(x.shape))
        return plain(x, steps, coeffs)

    ops._iterate = iterate


def _last_metrics(tr, data, sched) -> dict:
    """The last step's metrics (host floats, as their bits) of a run."""
    step_fn, state = tr.make_step(), tr.init(0)
    for i in range(STEPS):
        state, aux = step_fn(state, data.batch_at(i), sched(i))
    return {k: np.float32(v).view(np.int32).item()
            for k, v in aux["metrics"].host_floats().items()}


def _budget_checks(tr) -> dict:
    """The rank's collectives against the wire budget, per step."""
    b = tr.wire_budget()
    plan = tr.layer_plan()
    if b.pack_w2s:
        order = (s2w_issue_order(plan, plan.stage_plan())
                 if b.n_stages > 1 else (0,))
        want_g = [tr.n_local * s for s in b.w2s_sizes] * STEPS
        want_b = ([b.s2w_sizes[k] for k in order] * STEPS
                  if b.pack_s2w else [])
    else:
        want_g = None                     # per-leaf payloads: the plan's
        want_b = []
    return {"gathered": tr.gathered, "broadcast": tr.broadcast_bytes,
            "aux_gathered": tr.aux_gathered, "want_gathered": want_g,
            "want_broadcast": want_b, "n_stages": b.n_stages,
            "w2s_sizes": list(b.w2s_sizes), "s2w_sizes": list(b.s2w_sizes)}


def _rank_main(rank: int, tmp: str) -> None:
    """One rank of the 4-process world: every arm of every scenario, the
    refusals, and the checkpoints' 2-rank halves."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    results: dict = {}
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), WORLD)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=WORLD)
        pair = dist.new_group([0, 1])
        shapes: list = []
        _ns_shapes(shapes)
        for (scenario, arm), (ranks, kw) in ARMS.items():
            if rank >= ranks:
                continue
            group = dist.group.WORLD if ranks == WORLD else pair
            tr, data, sched = _setup(group, scenario, **kw)
            save = ((1, os.path.join(tmp, SAVES[(scenario, arm)]))
                    if (scenario, arm) in SAVES else None)
            shapes.clear()
            state, out = _run(tr, data, sched, save_at=save)
            rec = _record(tr, state, out, None)   # the rows it holds
            rec["ns_shapes"] = list(shapes)
            rec.update(_budget_checks(tr))
            rec.update(_state_budget(tr, scenario))
            rec["workers"] = [tr.workers.start, tr.workers.stop]
            # a buffer one byte short of the budget's raises, before any
            # collective starts
            try:
                tr._gather(torch.zeros((tr.n_local, 7), dtype=torch.uint8))
                rec["short_raises"] = False
            except ValueError:
                rec["short_raises"] = True
            results[f"{scenario}/{arm}"] = rec
        # the batched chain split over the 4 ranks and gathered back: 8
        # slices in quarters, 6 (which 4 does not divide) whole on each
        from repro_torch.kernels.ops import newton_schulz_batched, split_rows
        g = torch.randn((8, 16, 32), generator=torch.Generator().manual_seed(1))
        spec = ("data", None, None)
        results["ns_split"] = {
            "rows": list(split_rows(8, dist.group.WORLD, spec)),
            "gathered": torch.equal(
                newton_schulz_batched(g, group=dist.group.WORLD, pspec=spec),
                newton_schulz_batched(g)),
            "indivisible_whole": split_rows(6, dist.group.WORLD, spec) is None
            and torch.equal(newton_schulz_batched(g[:6], group=dist.group.WORLD,
                                                  pspec=spec),
                            newton_schulz_batched(g[:6]))}
        if rank < 2:
            # the step's metrics with the server cut and the buckets split
            tr, data, sched = _setup(pair, "plain", zero1_lmo=True,
                                     metrics=True)
            results["metrics_zero1"] = _last_metrics(tr, data, sched)
            # the one-rank checkpoint after step 1, resumed on 2 ranks,
            # whole and cut by the zero-1 and FSDP specs
            for name, kw in RESUMES.items():
                tr, data, sched = _setup(pair, "plain", **kw)
                state, step = tr.load_checkpoint(
                    os.path.join(tmp, "ck_1rank"), tr.init(0))
                held = _record(tr, state, {}, None)["server_bytes"]
                state, out = _run(tr, data, sched, state=state, start=step)
                results[name] = _record(tr, state, out, None)
                results[name]["held_at_load"] = held
            try:
                Trainer(build_model(get_config("nanogpt-124m").reduced()),
                        TrainerConfig(**dict(BASE, n_workers=3)),
                        device="cpu", group=pair)
                results["three_workers_raise"] = False
            except ValueError as e:
                results["three_workers_raise"] = "must divide" in str(e)
            # the sink: both ranks write a step record, rank 0's file
            from repro_torch.obs.sink import MetricsWriter
            w = MetricsWriter(os.path.join(tmp, "metrics.jsonl"), group=pair)
            w.write("step", step=0, loss=float(rank))
            w.close()
            results["sink_active"] = w.active
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        results["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


def _jax_main(tmp: str) -> None:
    """The reference's losses from the port's initial state on the port's
    batches, one process, every scenario."""
    try:
        import jax
        import jax.numpy as jnp
        import ml_dtypes

        from repro.configs import get_config as jget_config
        from repro.core.schedule import warmup_linear_decay as jsched
        from repro.models.api import build_model as jbuild_model
        from repro.train import faults as jfaults
        from repro.train.trainer import Trainer as JTrainer
        from repro.train.trainer import TrainerConfig as JTrainerConfig
        from repro_torch.models.api import state_to_numpy
        torch.set_num_threads(1)

        def to_jax(tree):
            if isinstance(tree, dict):
                return {k: to_jax(v) for k, v in tree.items()}
            if tree is None:
                return None
            a = np.asarray(tree)
            if a.dtype == np.dtype("V2"):
                a = a.view(ml_dtypes.bfloat16)
            return jnp.asarray(a)

        jmodel = jbuild_model(jget_config("nanogpt-124m").reduced())
        out = {}
        for scenario, kw in SCENARIOS.items():
            kw = dict(BASE, **kw)
            if kw.get("faults"):
                kw["faults"] = jfaults.parse_faults(kw["faults"], N_WORKERS)
            tr, data, _ = _setup(None, scenario)
            jstate = to_jax(state_to_numpy(tr.init(0)))
            jtr = JTrainer(jmodel, JTrainerConfig(remat=False,
                                                  use_pallas=False, **kw))
            step = jtr.jit_step(None)
            sched = jsched(0.01, 3, STEPS)
            losses = []
            for i in range(STEPS):
                b = {k: jnp.asarray(v.numpy().astype(np.int32))
                     for k, v in data.batch_at(i).items()}
                jstate, aux = step(jstate, b, sched(i))
                losses.append(float(aux["loss"]))
            out[scenario] = losses
    except Exception:
        out = {"error": traceback.format_exc()}
    with open(os.path.join(tmp, "jax.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks and the reference, run the one-process arms here
    meanwhile, and collect everything."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # the one-rank checkpoint the 2-rank world resumes from
        tr, data, sched = _setup(None, "plain")
        _run(tr, data, sched, steps=2,
             save_at=(1, os.path.join(tmp, "ck_1rank")))
        ctx = mp.get_context("spawn")
        ref = ctx.Process(target=_jax_main, args=(tmp,))
        ref.start()
        ranks = mp.start_processes(_rank_main, args=(tmp,), nprocs=WORLD,
                                   join=False, start_method="spawn")
        tr, data, sched = _setup(None, "plain", metrics=True)
        one = {"metrics": _last_metrics(tr, data, sched)}
        for scenario in SCENARIOS:
            tr, data, sched = _setup(None, scenario)
            state, out = _run(tr, data, sched)
            one[scenario] = (state, out)
        deadline = time.time() + JOIN_S
        done = False
        while not done and time.time() < deadline:
            done = ranks.join(timeout=5)
        ref.join(timeout=max(1.0, deadline - time.time()))
        hung = [p.pid for p in ranks.processes if p.is_alive()]
        if ref.is_alive():
            hung.append(ref.pid)
        for p in ranks.processes + [ref]:
            if p.is_alive():
                p.kill()
        assert not hung, f"processes {hung} did not end in {JOIN_S} s"
        got = {}
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                got[r] = json.load(f)
            assert "error" not in got[r], got[r]["error"]
        with open(os.path.join(tmp, "jax.json")) as f:
            jax_losses = json.load(f)
        assert "error" not in jax_losses, jax_losses["error"]
        yield {"tmp": tmp, "one": one, "ranks": got, "jax": jax_losses}
    finally:
        torch.set_num_threads(n)


def _rows(rank: int, ranks: int) -> range:
    n_local = N_WORKERS // ranks
    return range(rank * n_local, (rank + 1) * n_local)


@pytest.mark.parametrize("scenario,arm", list(ARMS))
def test_ranks_are_the_one_process_run(runs, scenario, arm):
    """Losses, x, W, g_server and the EF21-P compressor states bit-equal
    to the one-process run on every rank; each rank's worker-lead state
    is that run's rows of it."""
    state, out = runs["one"][scenario]
    ranks = ARMS[(scenario, arm)][0]
    for r in range(ranks):
        got = runs["ranks"][r][f"{scenario}/{arm}"]
        assert got["workers"] == [_rows(r, ranks).start, _rows(r, ranks).stop]
        assert got["losses"] == out["losses"], (r, got["losses"])
        for key in ("x", "w", "g_server", "cs_state"):
            assert got[key] == _digest(state[key]), (r, key)
        for key in worker_lead_paths(state):
            assert got["local/" + key] == _digest(state[key],
                                                  _rows(r, ranks)), (r, key)
        for key in ("n_participants", "skipped", "lags", "replayed", "full"):
            assert got[key] == out[key], (r, key)


@pytest.mark.parametrize("scenario,arm", list(ARMS))
def test_every_collective_is_the_budgets(runs, scenario, arm):
    """K u8 all-gathers of n_local * w2s_sizes[k] and K broadcasts of
    s2w_sizes in issue order a step (the unpacked arm: the per-leaf
    payloads, none broadcast); the per-worker scalars in one f32 gather a
    step; a buffer one byte short raises."""
    ranks, kw = ARMS[(scenario, arm)]
    n_local = N_WORKERS // ranks
    for r in range(ranks):
        got = runs["ranks"][r][f"{scenario}/{arm}"]
        assert got["short_raises"]
        scalars = [n_local * 4] * STEPS
        if "ckpt_gathered" in got:
            # the checkpoint after step 1 gathered the worker-lead leaves
            # (this rank's bytes of each), beside the steps' scalars
            scalars[2:2] = got["ckpt_gathered"]
            assert sum(got["ckpt_gathered"]) == got["local_state_bytes"]
        assert got["aux_gathered"] == scalars
        if kw.get("wire_pack") is False:
            assert got["broadcast"] == [] and got["s2w_sizes"] == []
            assert got["gathered"] and len(got["gathered"]) % STEPS == 0
            per_step = len(got["gathered"]) // STEPS
            assert got["gathered"] == got["gathered"][:per_step] * STEPS
            continue
        k = 1 if kw.get("wire_stages") == 1 else 3
        assert got["n_stages"] == k and len(got["w2s_sizes"]) == k
        assert got["gathered"] == got["want_gathered"]
        assert got["broadcast"] == got["want_broadcast"]
        assert len(got["gathered"]) == len(got["broadcast"]) == k * STEPS
        if ranks == WORLD:
            # one worker a rank: each gather is the budget's stage bytes
            assert got["gathered"][:k] == got["w2s_sizes"]


def test_unpacked_arm_gathers_each_payload_leaf(runs):
    """``wire_pack=False``: one gather per payload tensor, n_local times
    one worker's bytes of it, whose sum is n_local times the plan's
    unpacked payload bytes."""
    tr, _, _ = _setup(None, "plain", wire_pack=False)
    sizes = tr._unpacked_sizes()
    for r in range(2):
        got = runs["ranks"][r]["plain/2x2-unpacked"]["gathered"]
        assert got == [2 * s for s in sizes] * STEPS


def test_scenario_facts(runs):
    """(b): some but not all workers fold, no step skipped; (c): the lag
    1, 2, 0, a replay at step 2, no full copy, every W_j equal to W."""
    for r in range(WORLD):
        el = runs["ranks"][r]["elastic/4x1"]
        assert all(0 < n < N_WORKERS for n in el["n_participants"])
        assert el["skipped"] == [False] * STEPS
        rs = runs["ranks"][r]["resync/4x1"]
        assert rs["lags"] == [1, 2, 0]
        assert rs["replayed"][2] >= 1 and sum(rs["full"]) == 0
        assert rs["w_j_equal_w"]
    assert runs["ranks"][0]["resync/2x2"]["w_j_equal_w"]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_losses_track_the_reference(runs, scenario):
    """The one-process losses, which every rank reproduced, against the
    reference's from the same state and batches, within the two-way
    trajectory's bounds (``tests/test_torch_s2w.py``): every step within
    ``LOSS_ATOL``, the first two within ``LOSS_ATOL_WARMUP``. (The
    gradients differ from the reference's in summation order, which
    moves TopK's choice among bf16 ties; on these 4 workers the elastic
    run's third loss is 1.05e-5 from the reference's, on the parent
    commit's port as well.)"""
    from test_torch_s2w import LOSS_ATOL, LOSS_ATOL_WARMUP
    _, out = runs["one"][scenario]
    want = runs["jax"][scenario]
    np.testing.assert_allclose(out["losses"][:2], want[:2], rtol=0,
                               atol=LOSS_ATOL_WARMUP)
    np.testing.assert_allclose(out["losses"], want, rtol=0, atol=LOSS_ATOL)


def test_checkpoints_move_between_two_ranks_and_one(runs):
    """A 1-rank checkpoint after step 1 resumed on 2 ranks, and a 2-rank
    one resumed on 1, each bit-equal to the uninterrupted run; the
    archive is the one-rank format (the same keys and shapes)."""
    from repro_torch.train.checkpoint import _read_verified
    state, out = runs["one"]["plain"]
    for r in range(2):
        got = runs["ranks"][r]["resume_on_2"]
        assert got["losses"] == out["losses"][2:]
        for key in ("x", "w", "g_server"):
            assert got[key] == _digest(state[key])
        for key in worker_lead_paths(state):
            assert got["local/" + key] == _digest(state[key], _rows(r, 2))
    tmp = runs["tmp"]
    one = _read_verified(os.path.join(tmp, "ck_1rank.npz"))
    two = _read_verified(os.path.join(tmp, "ck_2ranks.npz"))
    assert {k: v.shape for k, v in one.items()} \
        == {k: v.shape for k, v in two.items()}
    tr, data, sched = _setup(None, "plain")
    resumed, step = tr.load_checkpoint(os.path.join(tmp, "ck_2ranks"),
                                       tr.init(0))
    assert step == 2
    resumed, rout = _run(tr, data, sched, state=resumed, start=step)
    assert rout["losses"] == out["losses"][2:]
    for key in ("x", "w", "g_server", *worker_lead_paths(state)):
        assert _digest(resumed[key]) == _digest(state[key]), key


def _per_step(got: dict) -> list:
    """A run's state gathers with the checkpoint's taken out, cut into
    its steps (each the same)."""
    sg = list(got["state_gathered"])
    if "ckpt_state_gathered" in got:
        at, ck = got["ckpt_state_gathered"]
        assert sg[at:at + len(ck)] == ck
        del sg[at:at + len(ck)]
    assert len(sg) % STEPS == 0
    n = len(sg) // STEPS
    return [sg[i * n:(i + 1) * n] for i in range(STEPS)]


@pytest.mark.parametrize("scenario,arm", list(ARMS))
def test_state_gathers_are_the_specs(runs, scenario, arm):
    """Every rank's state gathers are the same each step, and their sizes
    are what ``state_specs`` gives: the chunks of the cut leaves and the
    x rows of each split bucket (``_state_budget``); the bytes of x, w
    and g_server a rank holds between steps are the specs' to the byte.
    Without zero-1 or FSDP nothing is cut and only the rows move."""
    from collections import Counter
    ranks, kw = ARMS[(scenario, arm)]
    for r in range(ranks):
        got = runs["ranks"][r][f"{scenario}/{arm}"]
        steps = _per_step(got)
        assert all(st == steps[0] for st in steps), r
        assert {str(k): v for k, v in Counter(steps[0]).items()} \
            == got["want_state"], r
        assert got["server_bytes"] == got["want_held"], r
        if not (kw.get("zero1_lmo") or kw.get("fsdp")):
            assert len(steps[0]) == 2            # the two buckets' rows
    if arm == "2x2-zero1":
        # the 2-layer stacks halve on each of the 2 ranks
        held = runs["ranks"][0][f"{scenario}/{arm}"]["server_bytes"]
        whole = runs["ranks"][0][f"{scenario}/2x2"]["server_bytes"]
        assert all(held[k] < whole[k] for k in held)


@pytest.mark.parametrize("scenario,arm", list(ARMS))
def test_ns_chains_take_the_ranks_slices(runs, scenario, arm):
    """Each rank's NS chain is handed ``[B/P, m, n]`` of every bucket its
    P ranks divide (reduced nanogpt's ``(256,256) x 8`` and ``(256,512)
    x 4`` on 2 and on 4 ranks), once a step."""
    ranks = ARMS[(scenario, arm)][0]
    tr, _, _ = _setup(None, scenario)
    want = sorted([b.batch // ranks, *b.shape]
                  for b in tr.layer_plan().ns_buckets()) * STEPS
    for r in range(ranks):
        got = runs["ranks"][r][f"{scenario}/{arm}"]["ns_shapes"]
        assert sorted(got) == sorted(want), (r, got)


def test_sharded_checkpoints_move_between_two_ranks_and_one(runs):
    """The zero-1 and FSDP runs' checkpoints after step 1 are the
    one-rank archive byte for byte; one resumes on 1 rank bit-equal to
    the uninterrupted run, and ``serve_full_resync`` serves its W as the
    one-rank archive's. The one-rank checkpoint resumes on 2 ranks cut by
    either rule, each rank holding the specs' bytes, bit-equal too."""
    from repro_torch.dist.resync import serve_full_resync
    from repro_torch.train.checkpoint import state_template
    tmp = runs["tmp"]
    state, out = runs["one"]["plain"]

    def read(name):
        with open(os.path.join(tmp, name + ".npz"), "rb") as f:
            return f.read()

    one = read("ck_1rank")
    for name in ("ck_2ranks", "ck_zero1", "ck_fsdp"):
        assert read(name) == one, name
    tr, data, sched = _setup(None, "plain")
    resumed, step = tr.load_checkpoint(os.path.join(tmp, "ck_zero1"),
                                       tr.init(0))
    assert step == 2
    resumed, rout = _run(tr, data, sched, state=resumed, start=step)
    assert rout["losses"] == out["losses"][2:]
    for key in ("x", "w", "g_server", *worker_lead_paths(state)):
        assert _digest(resumed[key]) == _digest(state[key]), key
    like = state_template(tr.init(0))
    w_one, v_one = serve_full_resync(os.path.join(tmp, "ck_1rank"), like)
    w_cut, v_cut = serve_full_resync(os.path.join(tmp, "ck_zero1"), like)
    assert v_one == v_cut == 2 and _digest(w_one) == _digest(w_cut)
    for name, arm in (("resume_on_2_zero1", "2x2-zero1"),
                      ("resume_on_2_fsdp", "2x2-fsdp")):
        for r in range(2):
            got = runs["ranks"][r][name]
            assert got["losses"] == out["losses"][2:], (name, r)
            for key in ("x", "w", "g_server"):
                assert got[key] == _digest(state[key]), (name, r, key)
            for key in worker_lead_paths(state):
                assert got["local/" + key] == _digest(state[key],
                                                      _rows(r, 2))
            want = runs["ranks"][r][f"plain/{arm}"]["want_held"]
            assert got["held_at_load"] == want, (name, r)


def test_the_split_chain_gathers_the_whole_stack(runs):
    """``newton_schulz_batched(g, group=, pspec=)``: rank r runs slices
    ``[2r, 2r + 2)`` of 8 and the all-gathered pieces are the one-process
    chain's bits; a stack of 6 runs whole on every rank."""
    for r in range(WORLD):
        got = runs["ranks"][r]["ns_split"]
        assert got == {"rows": [2 * r, 2 * r + 1], "gathered": True,
                       "indivisible_whole": True}


def test_metrics_are_the_one_process_runs(runs):
    """With zero-1 on 2 ranks every metric of the step is the
    one-process run's, bit for bit: ``ns/orth_residual`` of each split
    bucket among them (its per-slice values gathered), ``efp/err_norm``
    from x and W gathered whole. ``wire/n_stages`` aside: the
    one-process step packs no wire (one stage), the ranks' stage it."""
    want = dict(runs["one"]["metrics"])
    assert any(k.startswith("ns/orth_residual") for k in want)
    for r in range(2):
        got = dict(runs["ranks"][r]["metrics_zero1"])
        assert np.int32(got.pop("wire/n_stages")).view(np.float32) == 3.0
        want.pop("wire/n_stages", None)
        assert got == want, r


def test_switches_without_a_group_change_nothing(runs):
    """No group, no mesh: ``zero1_lmo`` and ``fsdp`` leave the step and
    its state as they are, as the reference ignores them off-mesh."""
    state, out = runs["one"]["plain"]
    for kw in ({"zero1_lmo": True}, {"fsdp": True}):
        tr, data, sched = _setup(None, "plain", **kw)
        assert tr.server is None and tr.mesh is None
        got, gout = _run(tr, data, sched)
        assert gout["losses"] == out["losses"]
        for key in ("x", "w", "g_server", *worker_lead_paths(state)):
            assert _digest(got[key]) == _digest(state[key]), key


def test_ranks_refuse_a_lead_they_do_not_divide(runs):
    assert runs["ranks"][0]["three_workers_raise"]
    assert runs["ranks"][1]["three_workers_raise"]


def test_only_rank_0_writes_the_sink(runs):
    """Over a group, rank 0 writes the JSONL sink; rank 1 validates its
    records and drops them."""
    assert runs["ranks"][0]["sink_active"]
    assert not runs["ranks"][1]["sink_active"]
    with open(os.path.join(runs["tmp"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["kind"], r["loss"]) for r in rows] == [("step", 0.0)]


def test_supervisor_refuses_a_group_of_ranks():
    """A retry must restart every rank's step together: the supervisor
    watches one process and refuses a group of more (ROADMAP Queue 1
    item 13); a one-rank group is one process."""
    from repro_torch.train.supervisor import Supervisor, SupervisorConfig

    class Ranks:
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n

    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        Supervisor(SupervisorConfig(), group=Ranks(2))
    assert Supervisor(SupervisorConfig(), group=Ranks(1)).retries == 0
