"""The serving path of the port against the reference's.

On the reduced f32 configs of granite-3-2b, qwen2.5-3b, starcoder2-15b
(with ``window=6`` and a prompt of 12: a ring cache), nanogpt-124m
(learned positions) and mixtral-8x7b, from the reference's parameters
carried across with ``params_from_jax``:

  * prefill's logits and the cache it writes, ring slots included;
  * 3 teacher-forced decode steps, from the port's own cache and from
    the reference's carried in with ``cache_from_jax``;
  * decode against the port's own full forward;
  * ``Server.generate``'s greedy tokens against the reference
    ``Server``'s, every step's top-2 margin far above the tolerance;
  * ``cache_spec`` and ``input_specs`` at full size for every shape of
    ``SHAPES``, on the meta device; the serve CLI's line against the
    reference CLI's; temperature sampling reproducible from ``--seed``.

Tolerances: the port computes the reference's f32 arithmetic in another
summation order (attention in one pass per query chunk against the
reference's online softmax, RoPE's f32 angles): logits and cache within
``ATOL`` (2e-5; measured at most 4.5e-6 on logits of magnitude ~1-4).
"""
from __future__ import annotations

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve_cli
from repro.models.api import build_model as jbuild_model
from repro.models.api import input_specs as jinput_specs
from repro.train.serve import Server as JServer
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.dist.layerwise import leaf_paths, tree_get
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common
from repro_torch.models.api import (build_model, cache_from_jax,
                                    input_specs, make_batch, params_from_jax)
from repro_torch.train.serve import Server
from test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5
B = 2
# arch -> (window override, prompt length, cache length)
CASES = {"granite-3-2b": (None, 8, 16), "qwen2.5-3b": (None, 8, 16),
         "starcoder2-15b": (6, 12, 32), "nanogpt-124m": (None, 8, 16),
         "mixtral-8x7b": (None, 8, 16)}
N_DECODE = 3


def _cfgs(arch):
    win = CASES[arch][0]
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    if win:
        cfg = dataclasses.replace(cfg, window=win)
        jcfg = dataclasses.replace(jcfg, window=win)
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's run: params, the prompt and the 3 tokens after it,
    prefill's logits and cache, each decode step's logits and cache."""
    _, jcfg = _cfgs(arch)
    _, s, cap = CASES[arch]
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab, (B, s + N_DECODE)).astype(np.int32)
    logits, cache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :s])}, jm.init_cache(B, cap))
    out = {"params": jax.tree.map(np.asarray, jp), "tokens": toks,
           "prefill": (np.asarray(logits), jax.tree.map(np.asarray, cache)),
           "decode": []}
    dec = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        t = s + i
        logits, cache = dec(jp, {"token": jnp.asarray(toks[:, t:t + 1]),
                                 "t": jnp.asarray(t, jnp.int32)}, cache)
        out["decode"].append((np.asarray(logits),
                              jax.tree.map(np.asarray, cache)))
    return out


def _port(arch):
    cfg, _ = _cfgs(arch)
    return build_model(cfg), params_from_jax(_reference(arch)["params"])


def _caches_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name in want:
        for kv in ("k", "v"):
            assert tuple(got[name][kv].shape) == want[name][kv].shape
            np.testing.assert_allclose(got[name][kv].numpy(),
                                       want[name][kv], rtol=0, atol=ATOL,
                                       err_msg=f"{name}/{kv}")


@pytest.mark.parametrize("arch", list(CASES))
def test_prefill_logits_and_cache_match_reference(arch):
    ref = _reference(arch)
    model, params = _port(arch)
    _, s, cap = CASES[arch]
    cache = model.init_cache(B, cap, "cpu")
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(ref["tokens"][:, :s])}, cache)
    assert logits.dtype == torch.float32 and logits.shape == (B, 512)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"][0], rtol=0,
                               atol=ATOL)
    _caches_close(cache, ref["prefill"][1])
    if arch == "starcoder2-15b":
        # a ring of the window's 6 slots: position p at slot p % 6, every
        # slot written, none of the first 6 positions left
        k = cache["dense_blocks"]["k"]
        assert k.shape[2] == 6 and bool((k[0].abs().sum((0, 2, 3)) > 0)
                                        .all())


@pytest.mark.parametrize("source", ["port", "reference"])
@pytest.mark.parametrize("arch", list(CASES))
def test_decode_steps_match_reference(arch, source):
    """Three teacher-forced decode steps after prefill, from the port's
    own cache or the reference's carried in with ``cache_from_jax``."""
    ref = _reference(arch)
    model, params = _port(arch)
    _, s, cap = CASES[arch]
    if source == "reference":
        cache = cache_from_jax(ref["prefill"][1])
    else:
        cache = model.prefill(params, {"tokens": torch.from_numpy(
            ref["tokens"][:, :s])}, model.init_cache(B, cap, "cpu"))[1]
    for i, (want_logits, want_cache) in enumerate(ref["decode"]):
        t = s + i
        logits, cache = model.decode_step(params, {
            "token": torch.from_numpy(ref["tokens"][:, t:t + 1]),
            "t": torch.tensor(t, dtype=torch.int32)}, cache)
        np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")
    _caches_close(cache, want_cache)


@pytest.mark.parametrize("arch", list(CASES))
def test_decode_matches_the_full_forward(arch):
    """Decode at position s against the port's own forward over s + 1
    tokens, its last position (mixtral with a no-drop capacity factor:
    capacity dispatch drops different tokens at another token count)."""
    cfg, _ = _cfgs(arch)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    model, params = build_model(cfg), _port(arch)[1]
    ref = _reference(arch)
    _, s, cap = CASES[arch]
    toks = torch.from_numpy(ref["tokens"][:, :s + 1])
    _, cache = model.prefill(params, {"tokens": toks[:, :s]},
                             model.init_cache(B, cap, "cpu"))
    got, _ = model.decode_step(params, {"token": toks[:, s:],
                                        "t": torch.tensor(s)}, cache)
    with torch.inference_mode():
        x, pos = model._embed_in(params, {"tokens": toks})
        h, _ = model._run(params, x, pos)
        want = common.logits_last(h[:, -1], model._unembed(params))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "starcoder2-15b",
                                  "mixtral-8x7b"])
def test_generate_greedy_equals_reference(arch):
    """Greedy tokens equal the reference Server's; each step's top-2
    margin exceeds 100 x ATOL, so no near-tie decides a token."""
    ref = _reference(arch)
    model, params = _port(arch)
    cfg, jcfg = _cfgs(arch)
    _, s, _ = CASES[arch]
    max_new = 4
    prompt = ref["tokens"][:, :s]
    jtoks = np.asarray(JServer(jbuild_model(jcfg)).generate(
        jax.tree.map(jnp.asarray, ref["params"]),
        {"tokens": jnp.asarray(prompt)}, max_new))
    toks = Server(model).generate(
        params, {"tokens": torch.from_numpy(prompt)}, max_new)
    assert toks.dtype == torch.int32 and toks.shape == (B, max_new)
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    # the margins, along the generated tokens
    cache = model.init_cache(B, s + max_new, "cpu")
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
        prompt)}, cache)
    for i in range(max_new):
        top2 = torch.topk(logits, 2, dim=-1).values
        assert bool((top2[:, 0] - top2[:, 1] > 100 * ATOL).all()), i
        logits, cache = model.decode_step(
            params, {"token": toks[:, i:i + 1], "t": s + i}, cache)


def test_generate_max_new_zero_and_no_mesh():
    model, params = _port("granite-3-2b")
    out = Server(model).generate(
        params, {"tokens": torch.zeros((3, 5), dtype=torch.int32)}, 0)
    assert out.shape == (3, 0) and out.dtype == torch.int32
    # a mesh needs the process group of its ranks; whisper serves over
    # ``data`` only (ROADMAP item 15b)
    from repro_torch.dist.sharding import MeshShape
    with pytest.raises(ValueError, match="process group"):
        Server(model, mesh=MeshShape(data=1, model=2))
    with pytest.raises(NotImplementedError, match="item 15b"):
        Server(build_model(get_config("whisper-small").reduced()),
               mesh=MeshShape(data=1, model=2))
    assert Server(model).serve_step_fn() == model.decode_step


def test_query_chunked_attention_is_one_pass():
    """Chunking the queries keeps each row's arithmetic: bit-equal to one
    pass, with and without a window, f32 and bf16."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 100, 8, 32, generator=g)
    k, v = (torch.randn(2, 100, 2, 32, generator=g) for _ in range(2))
    for window in (None, 16):
        for dt in (torch.float32, torch.bfloat16):
            a = common.attention(q.to(dt), k.to(dt), v.to(dt), window)
            b = common.attention(q.to(dt), k.to(dt), v.to(dt), window,
                                 chunk=24)
            assert torch.equal(a, b), (window, dt)
    assert common.ATTN_Q_CHUNK == 1024


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_and_input_specs_match_reference(arch):
    """Full size, every shape of SHAPES: the cache's shapes and dtypes
    (meta tensors, nothing allocated) and every input spec equal the
    reference's; the ring's capacity (the attention K/V's third dim from
    the end) is the window."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    assert sorted(SHAPES) == sorted(JSHAPES)
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JSHAPES[name])
        nw = 16 if shape.kind == "train" else 1
        specs = input_specs(cfg, shape, n_workers=nw)
        jspecs = jinput_specs(jcfg, JSHAPES[name], n_workers=nw)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                for k, v in specs.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
        assert all(v.device.type == "meta" for v in specs.values())
        if shape.kind != "decode":
            continue
        # {stack: {"k", "v"}} (whisper's: {"k", "v", "xk", "xv"}; the
        # recurrent families' states, Griffin's ring under "attn")
        cs = model.cache_spec(shape.batch, shape.seq)
        jcs = jax.tree_util.tree_flatten_with_path(
            jmodel.cache_spec(shape.batch, shape.seq))[0]
        assert leaf_paths(cs) == [tuple(k.key for k in path)
                                  for path, _ in jcs]
        for path, j in jcs:
            t = tree_get(cs, tuple(k.key for k in path))
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).split(".")[1]) == \
                (j.shape, str(j.dtype))
            if cfg.window and path[-1].key in ("k", "v"):
                assert t.shape[-3] == min(cfg.window, shape.seq)


def test_make_batch_and_prefill_data():
    cfg = get_config("qwen2.5-3b").reduced()
    g = torch.Generator().manual_seed(0)
    dec = make_batch(cfg, ShapeSpec("d", "decode", 64, 3), g, device="cpu")
    assert dec["token"].shape == (3, 1) and int(dec["t"]) == 63
    pre = make_batch(cfg, ShapeSpec("p", "prefill", 16, 3), g, device="cpu")
    assert pre["tokens"].shape == (3, 16) and set(pre) == {"tokens"}
    assert int(pre["tokens"].max()) < cfg.vocab
    data = SyntheticLM(cfg, ShapeSpec("p", "prefill", 16, 3), n_workers=2,
                       device="cpu")
    b0 = data.batch_at(0)
    assert set(b0) == {"tokens"} and b0["tokens"].shape == (3, 16)
    assert torch.equal(b0["tokens"], data.batch_at(0)["tokens"])
    assert int(b0["tokens"].max()) < cfg.vocab


CLI_ARGS = ["--arch", "granite-3-2b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--max-new", "4"]


def test_serve_cli_line_equals_reference(capsys, monkeypatch):
    """The reference's line field for field (the wall time and rate are
    each run's own), ``device=`` after it, the timing line before it,
    and one row of tokens per sequence."""
    serve_cli.main(CLI_ARGS + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve"] + CLI_ARGS)
    jserve_cli.main()
    theirs = capsys.readouterr().out.splitlines()
    assert ours[0].startswith("prefill_s=") and "decode_ms/token=" in ours[0]
    line, jline = ours[1].split(), theirs[0].split()
    assert line[-1] == "device=cpu"
    def fields(words):
        return [w.split("=")[0] if "=" in w else w.strip("0123456789.")
                for w in words]

    # wall= and the rate are each run's own
    assert fields(line[:-1]) == fields(jline)
    assert [w for w in line if not w.startswith(("wall=", "("))][:-1] == \
        [w for w in jline if not w.startswith(("wall=", "("))]
    assert len(ours) == 2 + 2 and len(theirs) == 1 + 2
    for row in ours[2:]:
        assert len(row.split()) == 4


def test_temperature_sampling_reproducible_from_seed(capsys):
    args = CLI_ARGS + ["--temperature", "1.0", "--device", "cpu"]
    a = serve_cli.main(args + ["--seed", "3"])["tokens"]
    b = serve_cli.main(args + ["--seed", "3"])["tokens"]
    c = serve_cli.main(args + ["--seed", "4"])["tokens"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int32 and int(a.min()) >= 0 \
        and int(a.max()) < 512
    capsys.readouterr()
