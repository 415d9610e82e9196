"""Shared parity checks of the port's recurrent families against the
reference's: ``tests/test_torch_griffin.py`` (recurrentgemma-2b) and
``tests/test_torch_xlstm.py`` (xlstm-1.3b) call these with their arch and
tolerances.

Variants of a config: ``full`` (published), ``reduced``, ``depth<k>``
(``with_depth(k)``) and ``rem``: ``replace(reduced, n_layers=5)``, which
leaves a remainder of the block pattern (Griffin: one period of (rec,
rec, attn) and a ``rem`` stack of (rec, rec)); for Griffin it also cuts
the window to 6, so training attends through the window and serving
wraps the ring. Neither ``reduced()`` nor ``with_depth()`` makes a
remainder.

Every reference compile is cached per (arch, variant) for the module
that asks, the batches are the reference's ``SyntheticLM``'s, and its
parameters, states and caches reach the port through ``params_from_jax``,
``state_from_jax`` and ``cache_from_jax``.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import serve as jserve_cli
from repro.launch import train as jtrain_cli
from repro.models.api import abstract_params as jabstract_params
from repro.models.api import build_model as jbuild_model
from repro.models.api import input_specs as jinput_specs
from repro.train.serve import Server as JServer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.muon import EF21Muon, EF21MuonConfig
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.dist.layerwise import (leaf_paths, tree_get, tree_leaves,
                                        tree_unflatten)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import common
from repro_torch.models.api import (abstract_params, build_model,
                                    cache_from_jax, input_specs,
                                    params_from_jax, state_from_jax)
from repro_torch.train.serve import Server
from repro_torch.train.trainer import Trainer, TrainerConfig

X_ATOL = 1e-6         # x after NS-driven LMO steps (test_torch_s2w.py)
SEQ, BATCH, WORKERS, STEPS = 24, 4, 2, 3
OPT = dict(n_workers=WORKERS, beta=0.5, w2s="top10", s2w="natural")
_t = warmup_linear_decay(0.01, 3, 10)
B, PROMPT, N_DECODE = 2, 10, 4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def cfgs(arch: str, variant: str):
    """(port config, reference config) of ``arch``'s variant."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    if variant == "full":
        return cfg, jcfg
    if variant.startswith("depth"):
        k = int(variant[5:])
        return cfg.with_depth(k), jcfg.with_depth(k)
    cfg, jcfg = cfg.reduced(), jcfg.reduced()
    if variant == "rem":
        kw = {"n_layers": 5}
        if cfg.window:
            kw["window"] = 6
        cfg, jcfg = (dataclasses.replace(c, **kw) for c in (cfg, jcfg))
    return cfg, jcfg


def to_torch(batch: dict) -> dict:
    """A reference batch as the port's: ints as int64."""
    return {k: torch.from_numpy(np.array(v)).to(torch.int64)
            for k, v in batch.items()}


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference(arch: str, variant: str = "reduced"):
    """The reference's model, params, metas, 3 synthetic batches of 2
    workers and its compiled loss-and-gradient."""
    _, jcfg = cfgs(arch, variant)
    jmodel = jbuild_model(jcfg)
    _, jmetas = jabstract_params(jmodel)
    jparams = jax.jit(lambda k: jmodel.init(k)[0])(jax.random.key(0))
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=WORKERS, seed=0)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, remat=False)))
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, jmetas=jmetas,
                batches=[data.batch_at(s) for s in range(STEPS)],
                jgrad=jgrad)


def port(arch: str, variant: str = "reduced"):
    return (build_model(cfgs(arch, variant)[0]),
            params_from_jax(np_tree(reference(arch, variant)["jparams"])))


# ------------------------------------------------------------------ configs

def check_config(arch: str, variant: str) -> None:
    cfg, jcfg = cfgs(arch, variant)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert {f.name for f in dataclasses.fields(cfg)} == \
        {f.name for f in dataclasses.fields(jcfg)}
    assert cfg.hd == jcfg.hd and cfg.sub_quadratic


def check_tree(arch: str, size: str, n_params: int) -> dict:
    """Leaf paths in flatten order, shapes, dtypes, every meta and the
    parameter count against the reference's (meta tensors); the port's
    params and metas."""
    cfg, jcfg = cfgs(arch, size)
    jparams, jmetas = jabstract_params(jbuild_model(jcfg))
    params, metas = build_model(cfg).init(None, "meta")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jm = jax.tree.leaves(jmetas, is_leaf=lambda m: hasattr(m, "lmo"))
    assert ["/".join(p) for p in leaf_paths(params)] == \
        ["/".join(k.key for k in path) for path, _ in jflat]
    assert [(tuple(p.shape), str(p.dtype).split(".")[1])
            for p in tree_leaves(params)] == \
        [(tuple(v.shape), str(v.dtype)) for _, v in jflat]
    assert [(m.lmo, m.radius_scale, m.stack_dims, m.compressible)
            for m in tree_leaves(metas)] == \
        [(m.lmo, m.radius_scale, m.stack_dims, m.compressible) for m in jm]
    assert sum(p.numel() for p in tree_leaves(params)) == n_params
    return params


def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _budget_fields(b):
    return (b.pack_w2s, b.pack_s2w, b.n_stages, b.w2s_sizes, b.s2w_sizes,
            b.n_workers, b.two_way_nbytes)


def check_plan(arch: str, depth: int, buckets, pins) -> None:
    """At full width cut to ``depth`` periods, 2 workers (the smoke's
    run): the NS buckets, both wire layouts and the budgets of top10,
    top10 / natural and top10+natural / natural equal the reference's and
    the smoke's pins."""
    variant = f"depth{depth}"
    shapes, metas = abstract_params(build_model(cfgs(arch, variant)[0]))
    jshapes, jmetas = jabstract_params(jbuild_model(cfgs(arch, variant)[1]))
    for w2s, s2w in (("top10", "identity"), ("top10", "natural"),
                     ("top10+natural", "natural")):
        kw = dict(n_workers=2, w2s=w2s, s2w=s2w)
        opt, jopt = EF21Muon(EF21MuonConfig(**kw)), JEF21Muon(
            JEF21MuonConfig(**kw))
        plan, jplan = opt.plan(shapes, metas), jopt.plan(jshapes, jmetas)
        got = [(sum(b.counts),) + b.shape for b in plan.ns_buckets()]
        assert got == [(sum(b.counts),) + b.shape
                       for b in jplan.ns_buckets()]
        assert sorted(got) == sorted(buckets)
        for direction in ("w2s", "s2w"):
            assert plan.wire_layout(torch.bfloat16, direction).describe() \
                == jplan.wire_layout(jnp.bfloat16,
                                     direction=direction).describe()
        b = opt.wire_budget(shapes, metas)
        assert _budget_fields(b) == _budget_fields(
            jopt.wire_budget(jshapes, jmetas))
        assert b.w2s_sizes == pins["w2s"][w2s]
        assert b.s2w_sizes == pins["s2w"].get(s2w, ())


# ------------------------------------------------------- loss and gradients

def check_loss_and_grads(arch: str, variant: str, rel: float,
                         floor: float = 0.0) -> None:
    """The loss within rtol 1e-5 and every gradient leaf within ``rel``
    of its largest entry (plus ``floor``) of the reference's, on a token
    batch; every leaf reached."""
    ref = reference(arch, variant)
    jb = jax.tree.map(lambda v: v[0], ref["batches"][0])
    jloss, jgrads = ref["jgrad"](ref["jparams"], jb)
    model, params = port(arch, variant)
    tr = Trainer(model, TrainerConfig(), device="cpu")
    loss, grads = tr._grad_and_loss(params, to_torch(jb))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tree_leaves(grads))
    for path, jg in jflat:
        key = tuple(k.key for k in path)
        g, jg = tree_get(grads, key).numpy(), np.asarray(jg)
        scale = np.max(np.abs(jg))
        assert scale > 0, key
        err = np.max(np.abs(g - jg))
        assert err <= rel * scale + floor, (key, err, scale)


# ------------------------------------------------------ the carried steps

@functools.lru_cache(maxsize=None)
def reference_states(arch: str):
    """The reference's two-way states after each of STEPS steps of the
    reduced model from its init state, each step on the reference
    model's gradients at the W it reaches; the losses."""
    ref = reference(arch)
    jgrad = ref["jgrad"]
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **OPT))
    fn = jopt.make_step(ref["jmetas"], reshard_payloads=lambda t: t,
                        reshard_updates=lambda t: t)
    jstep = jax.jit(lambda s, b, t: fn(s, lambda p, b: (b["loss"],
                                                        b["grads"]), b, t))
    state = jopt.init(jax.random.key(1), ref["jparams"], ref["jmetas"])
    states, losses = [state], []
    for s in range(STEPS):
        zeros = {"loss": jnp.zeros((WORKERS,), jnp.float32),
                 "grads": jax.tree.map(
                     lambda x: jnp.zeros((WORKERS,) + x.shape, x.dtype),
                     state["x"])}
        w = jstep(state, zeros, jnp.float32(_t(s)))[0]["w"]
        w = jax.tree.map(lambda a, x: a.astype(x.dtype), w, state["x"])
        outs = [jgrad(w, jax.tree.map(lambda v: v[j], ref["batches"][s]))
                for j in range(WORKERS)]
        batch = {"loss": jnp.stack([o[0] for o in outs]),
                 "grads": jax.tree.map(lambda *g: jnp.stack(g),
                                       *[o[1] for o in outs])}
        state, aux = jstep(state, batch, jnp.float32(_t(s)))
        states.append(state)
        losses.append(float(aux["loss"]))
    return states, losses


def _port_step():
    return EF21Muon(EF21MuonConfig(**OPT))


def check_carried_step(arch: str) -> None:
    """From the reference's state after step 0 (X != W), one packed
    two-way ``top10`` / ``natural`` step, both sides fed the reference
    model's gradients at the W each reaches: w, g_w, m_w and g_server
    bit-equal, x within X_ATOL, every leaf moved."""
    ref = reference(arch)
    states, _ = reference_states(arch)
    jstate, want = np_tree(states[1]), np_tree(states[2])
    paths = leaf_paths(jstate["x"])

    def grad_and_loss(params, batch):
        jp = tree_unflatten(paths, [jnp.asarray(tree_get(params, p).numpy())
                                    for p in paths])
        loss, grads = ref["jgrad"](jp, to_jax(batch))
        return torch.tensor(float(loss)), params_from_jax(np_tree(grads))

    _, metas = build_model(cfgs(arch, "reduced")[0]).init(None, "meta")
    step = _port_step().make_step(metas, reshard_payloads=lambda t: t,
                                  reshard_updates=lambda t: t)
    tstate, _ = step(state_from_jax(jstate), grad_and_loss,
                     to_torch(ref["batches"][1]), _t(1))
    assert tstate["step"] == int(want["step"]) == 2
    for key in ("w", "g_w", "m_w", "g_server"):
        for p in paths:
            np.testing.assert_array_equal(
                tree_get(tstate[key], p).numpy(), tree_get(want[key], p),
                err_msg=f"{key}/{p}")
    for p in paths:
        got, w = tree_get(tstate["x"], p).numpy(), tree_get(want["x"], p)
        np.testing.assert_allclose(got, w, rtol=0, atol=X_ATOL,
                                   err_msg=f"x/{p}")
        assert np.any(w != tree_get(jstate["x"], p)), p


def check_three_steps(arch: str) -> None:
    """STEPS packed two-way steps from the reference's initial state
    carried across, both sides fed the reference model's gradients at the
    W each reaches: every loss within rtol 1e-5 of the reference's (x
    parts from it only by the NS chain's X_ATOL a step)."""
    ref = reference(arch)
    states, want = reference_states(arch)
    paths = leaf_paths(np_tree(states[0]["x"]))

    def grad_and_loss(params, batch):
        jp = tree_unflatten(paths, [jnp.asarray(tree_get(params, p).numpy())
                                    for p in paths])
        loss, grads = ref["jgrad"](jp, to_jax(batch))
        return torch.tensor(float(loss)), params_from_jax(np_tree(grads))

    _, metas = build_model(cfgs(arch, "reduced")[0]).init(None, "meta")
    step = _port_step().make_step(metas, reshard_payloads=lambda t: t,
                                  reshard_updates=lambda t: t)
    state = state_from_jax(np_tree(states[0]))
    losses = []
    for s in range(STEPS):
        state, aux = step(state, grad_and_loss, to_torch(ref["batches"][s]),
                          _t(s))
        losses.append(aux["loss"].item())
    np.testing.assert_allclose(losses, want, rtol=1e-5, atol=0)


def check_own_gradient_steps(arch: str) -> list[float]:
    """The same STEPS steps, the port on its own model's gradients: every
    loss finite; steps 0-1, which read the carried initial W only (the
    s2w leg first moves W in step 2), within rtol 1e-5 of the
    reference's. Step 2's loss follows TopK's picks (among bf16 ties)
    and the sign LMO's on embed's gradient, which each side rounds in its
    own summation order (ROADMAP Queue 3 item 2), so it is not held."""
    ref = reference(arch)
    states, want = reference_states(arch)
    model, _ = port(arch)
    _, metas = model.init(None, "meta")
    step = _port_step().make_step(metas, reshard_payloads=lambda t: t,
                                  reshard_updates=lambda t: t)
    tr = Trainer(model, TrainerConfig(), device="cpu")
    state = state_from_jax(np_tree(states[0]))
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree.leaves(states[0]["w"]), jax.tree.leaves(states[2]["w"])))
    losses = []
    for s in range(STEPS):
        state, aux = step(state, tr._grad_and_loss,
                          to_torch(ref["batches"][s]), _t(s))
        losses.append(aux["loss"].item())
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses[:2], want[:2], rtol=1e-5, atol=0)
    return losses


# ------------------------------------------------------------------ serving

@functools.lru_cache(maxsize=None)
def serving_reference(arch: str, variant: str = "reduced"):
    """The reference's prefill of a PROMPT-token prompt into a cache of
    PROMPT + N_DECODE, then N_DECODE teacher-forced decode steps: logits
    and caches."""
    ref = reference(arch, variant)
    jm, jp = ref["jmodel"], ref["jparams"]
    vocab = ref["jcfg"].vocab
    toks = np.random.default_rng(1).integers(
        0, vocab, (B, PROMPT + N_DECODE)).astype(np.int32)
    logits, cache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT])},
        jm.init_cache(B, PROMPT + N_DECODE))
    out = {"tokens": toks, "prefill": (np.asarray(logits), np_tree(cache)),
           "decode": []}
    dec = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        logits, cache = dec(jp, {"token": jnp.asarray(
            toks[:, PROMPT + i:PROMPT + i + 1]),
            "t": jnp.asarray(PROMPT + i, jnp.int32)}, cache)
        out["decode"].append((np.asarray(logits), np_tree(cache)))
    return out


def close(got: np.ndarray, want: np.ndarray, rel: float, what) -> None:
    """max |got - want| within ``rel`` of max |want| (at least ``rel``)."""
    assert got.shape == want.shape, what
    err = np.max(np.abs(got - want))
    assert err <= rel * max(1.0, np.max(np.abs(want))), (what, err)


def caches_close(got: dict, want: dict, rel: float) -> None:
    """The port's cache against the reference's (its None entries left
    out), leaf by leaf."""
    want = cache_from_jax(want)
    assert leaf_paths(got) == leaf_paths(want)
    for p in leaf_paths(want):
        g, w = tree_get(got, p), tree_get(want, p)
        assert g.dtype == w.dtype, p
        close(g.numpy(), w.numpy(), rel, p)


def check_prefill_decode(arch: str, variant: str, source: str,
                         rel: float) -> None:
    """Prefill's logits and cache, then N_DECODE decode steps from the
    port's cache or the reference's (``cache_from_jax``), within ``rel``
    (``close``)."""
    sref = serving_reference(arch, variant)
    model, params = port(arch, variant)
    toks = torch.from_numpy(sref["tokens"]).to(torch.int64)
    cache = model.init_cache(B, PROMPT + N_DECODE, "cpu")
    logits, cache = model.prefill(params, {"tokens": toks[:, :PROMPT]},
                                  cache)
    close(logits.numpy(), sref["prefill"][0], rel, "prefill logits")
    caches_close(cache, sref["prefill"][1], rel)
    if source == "reference":
        cache = cache_from_jax(sref["prefill"][1])
    for i, (want_logits, want_cache) in enumerate(sref["decode"]):
        logits, cache = model.decode_step(params, {
            "token": toks[:, PROMPT + i:PROMPT + i + 1],
            "t": torch.tensor(PROMPT + i, dtype=torch.int32)}, cache)
        close(logits.numpy(), want_logits, rel, f"decode step {i}")
    caches_close(cache, want_cache, rel)


def check_decode_vs_full(arch: str, variant: str, rel: float) -> None:
    """Decode after the prompt against the port's own full forward over
    the prompt and the decoded tokens (the scans over every position)."""
    sref = serving_reference(arch, variant)
    model, params = port(arch, variant)
    toks = torch.from_numpy(sref["tokens"]).to(torch.int64)
    _, cache = model.prefill(params, {"tokens": toks[:, :PROMPT]},
                             model.init_cache(B, PROMPT + N_DECODE, "cpu"))
    dec = []
    for i in range(N_DECODE):
        lg, cache = model.decode_step(params, {
            "token": toks[:, PROMPT + i:PROMPT + i + 1], "t": PROMPT + i},
            cache)
        dec.append(lg)
    with torch.inference_mode():
        h = model.hidden(params, {"tokens": toks})
    for i in range(N_DECODE):
        want = common.logits_last(h[:, PROMPT + i], model._unembed(params))
        close(dec[i].numpy(), want.numpy(), rel, f"step {i}")


def check_generate(arch: str) -> None:
    """Greedy tokens equal the reference Server's."""
    ref, sref = reference(arch), serving_reference(arch)
    model, params = port(arch)
    prompt = sref["tokens"][:, :PROMPT]
    jtoks = np.asarray(JServer(ref["jmodel"]).generate(
        ref["jparams"], {"tokens": jnp.asarray(prompt)}, 5))
    toks = Server(model).generate(
        params, {"tokens": torch.from_numpy(prompt).to(torch.int64)}, 5)
    assert toks.dtype == torch.int32 and toks.shape == (B, 5)
    np.testing.assert_array_equal(toks.numpy(), jtoks)


# -------------------------------------------------------------- batches

def check_specs(arch: str, sizes=("reduced", "full")) -> None:
    """Every shape kind's keys, shapes and dtypes equal the reference's
    (each of ``sizes``), token batches; the cache's leaves
    (``cache_spec``, meta) equal the reference's but its None entries;
    ``SyntheticLM``'s batch keys and shapes."""
    for size in sizes:
        cfg, jcfg = cfgs(arch, size)
        for kind in ("train", "prefill", "decode"):
            specs = input_specs(cfg, ShapeSpec("s", kind, 48, 8), 2)
            jspecs = jinput_specs(jcfg, JShapeSpec("s", kind, 48, 8), 2)
            assert list(specs) == list(jspecs)
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                    for k, v in specs.items()} == \
                {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
        cs = build_model(cfg).cache_spec(8, 4096)
        jcs = jbuild_model(jcfg).cache_spec(8, 4096)
        jflat = [(tuple(k.key for k in path), v) for path, v in
                 jax.tree_util.tree_flatten_with_path(jcs)[0]]
        assert leaf_paths(cs) == [p for p, _ in jflat]
        for p, v in jflat:
            t = tree_get(cs, p)
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).split(".")[1]) == \
                (v.shape, str(v.dtype)), p
    cfg, jcfg = cfgs(arch, "reduced")
    shape = ShapeSpec("t", "train", SEQ, BATCH)
    b = SyntheticLM(cfg, shape, n_workers=WORKERS, device="cpu").batch_at(3)
    jb = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                      n_workers=WORKERS).batch_at(3)
    assert list(b) == list(jb) == ["tokens", "labels"]
    for k in b:
        assert tuple(b[k].shape) == jb[k].shape, k


def check_cli(arch: str, capsys, monkeypatch) -> None:
    """The train CLI's header field for field (``device=`` aside), one
    way and two-way, and the serve CLI's line but for the wall time and
    rate."""
    for w2s, s2w in (("top10", "identity"), ("top10", "natural")):
        argv = ["--arch", arch, "--reduced", "--steps", "0", "--seq", "16",
                "--batch", "2", "--workers", "2", "--w2s", w2s, "--s2w", s2w]
        train_cli.main(argv + ["--device", "cpu"])
        ours = capsys.readouterr().out.splitlines()[0].split()
        monkeypatch.setattr(sys, "argv", ["train"] + argv)
        jtrain_cli.main()
        theirs = capsys.readouterr().out.splitlines()[0].split()
        assert ours[-1] == "device=cpu" and ours[:-1] == theirs
        assert ours[0] == f"arch={arch}"
    sargv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
             "8", "--max-new", "4"]
    out = serve_cli.main(sargv + ["--device", "cpu"])
    line = capsys.readouterr().out.splitlines()[1].split()
    monkeypatch.setattr(sys, "argv", ["serve"] + sargv)
    jserve_cli.main()
    jline = capsys.readouterr().out.splitlines()[0].split()
    assert line[-1] == "device=cpu"
    assert [w for w in line if not w.startswith(("wall=", "("))][:-1] == \
        [w for w in jline if not w.startswith(("wall=", "("))]
    assert tuple(out["tokens"].shape) == (2, 4)
