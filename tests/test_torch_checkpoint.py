"""The port's checkpoints and ``--donate`` against the reference.

Checkpoints: the reference's robustness cases (manifest, ``.prev``
rotation, torn-file fallback, checksum mismatch, both generations bad,
pre-manifest archives) on the port; a reference checkpoint of a two-way
rank10+natural state (bf16 sketches) resumed in the port and the port's
archive resumed by ``repro.train.checkpoint.load_checkpoint``, each with
the state's bits unchanged and one step after it equal to the
reference's step within ``tests/test_torch_rank.py``'s bounds for a
RankK step from a carried state (RankK's f32 algebra runs in other
summation orders, so its bf16 sketches may sit one ulp apart).

``--donate``: the donated step writes the new state into the input
state's tensors, with the same arithmetic, so it is bit-equal to the
undonated step; the undonated step leaves its input state untouched.
"""
from __future__ import annotations

import json
import os
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.core.muon import ParamMeta as JParamMeta
from repro.train import checkpoint as jckpt
from repro_torch.core.muon import EF21Muon, EF21MuonConfig, ParamMeta
from repro_torch.dist.layerwise import tree_leaves
from repro_torch.models.api import state_from_jax, state_to_numpy
from repro_torch.train.checkpoint import (CheckpointError, load_checkpoint,
                                          save_checkpoint, state_template)
from test_torch_rank import assert_bf16_close
from test_torch_s2w import (_coeffs, _grad_jax, _grad_torch, _np_tree,
                            _tiny_tree)


def _tree(v=0.0):
    return {"a": torch.full((4, 3), 1.5 + v), "m": None,
            "nested": {"b": torch.arange(6, dtype=torch.int32)}}


# ------------------------------------------------- the reference's cases

def test_checkpoint_manifest_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, _tree(), step=3)
    with np.load(path) as data:
        assert "__manifest__" in data.files
        man = json.loads(bytes(data["__manifest__"]).decode())
    assert man["a"]["dtype"] == "float32" and man["a"]["shape"] == [4, 3]
    out, step = load_checkpoint(path, _tree())
    assert step == 3
    assert torch.equal(out["a"], _tree()["a"])
    assert out["nested"]["b"].dtype == torch.int32
    assert out["m"] is None
    assert not os.path.exists(path + ".tmp")


def test_checkpoint_rotates_prev_generation(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, _tree(0.0), step=1)
    save_checkpoint(path, _tree(9.0), step=2)
    assert os.path.exists(path + ".prev")
    out, step = load_checkpoint(path, _tree())
    assert step == 2 and float(out["a"][0, 0]) == pytest.approx(10.5)
    prev, pstep = load_checkpoint(path + ".prev", _tree())
    assert pstep == 1 and float(prev["a"][0, 0]) == pytest.approx(1.5)


def test_corrupt_checkpoint_falls_back_to_prev(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, _tree(0.0), step=1)
    save_checkpoint(path, _tree(9.0), step=2)
    with open(path, "r+b") as f:   # torn write: truncate the newest
        f.truncate(os.path.getsize(path) // 2)
    with pytest.warns(RuntimeWarning, match="falling back"):
        out, step = load_checkpoint(path, _tree())
    assert step == 1
    assert float(out["a"][0, 0]) == pytest.approx(1.5)


def test_checksum_mismatch_detected(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, _tree(), step=1)
    man = json.dumps({"a": {"crc32": 1, "shape": [4, 3],
                            "dtype": "float32"}})
    flat = {"a": np.zeros((4, 3), np.float32),
            "__manifest__": np.frombuffer(man.encode(), np.uint8)}
    with open(path, "wb") as f:    # forged content, stale checksum
        np.savez(f, **flat)
    with pytest.raises(CheckpointError, match="checksum mismatch"):
        load_checkpoint(path, {"a": torch.zeros((4, 3))})


def test_both_generations_corrupt_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, _tree(), step=1)
    save_checkpoint(path, _tree(), step=2)
    for p in (path, path + ".prev"):
        with open(p, "wb") as f:
            f.write(b"not a zip")
    with pytest.raises(CheckpointError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            load_checkpoint(path, _tree())


def test_premanifest_checkpoint_still_loads(tmp_path):
    path = str(tmp_path / "old.npz")
    np.savez(path, **{"a": np.ones((2, 2)), "__step__": np.asarray(5)})
    out, step = load_checkpoint(path, {"a": torch.zeros((2, 2))})
    assert step == 5 and out["a"].sum().item() == 4.0


def test_legacy_bare_archive_rotates_and_dir_is_fsynced(tmp_path,
                                                       monkeypatch):
    import repro_torch.train.checkpoint as ck
    bare = str(tmp_path / "ck")
    with open(bare, "wb") as f:
        np.savez(f, **{"x": np.zeros(3), "__step__": np.asarray(1)})
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(ck.os, "fsync",
                        lambda fd: (synced.append(fd), real_fsync(fd)))
    save_checkpoint(bare, {"x": torch.ones(3)}, step=5)
    assert len(synced) == 2     # the temp file, then the directory
    assert not os.path.exists(bare)
    assert os.path.exists(bare + ".npz.prev")
    tree, step = load_checkpoint(bare, {"x": torch.zeros(3)})
    assert step == 5 and tree["x"].tolist() == [1.0] * 3


# ---------------------------------------------------------- bf16 leaves

def _bf16_bits():
    """bf16 patterns with NaNs of both signs, infs, zeros, subnormals."""
    bits = np.array([0x3F80, 0xBF80, 0x7FC0, 0xFFC1, 0x7F80, 0xFF80, 0x0000,
                     0x8000, 0x0001, 0x807F, 0x7F7F, 0x1234], np.uint16)
    return bits.reshape(3, 4)


def test_bf16_leaves_keep_their_bits_both_ways(tmp_path):
    """The reference writes a bf16 leaf as ``<V2``, the port as
    ``bfloat16``; the manifest names both ``bfloat16``. Each package reads
    the other's with every bit, NaN payloads included."""
    bits = _bf16_bits()
    jtree = {"q": jnp.asarray(bits.view(ml_dtypes.bfloat16)),
             "f": jnp.arange(3.0)}
    jckpt.save_checkpoint(str(tmp_path / "ref"), jtree, step=4)
    like = {"q": torch.zeros((3, 4), dtype=torch.bfloat16),
            "f": torch.zeros(3)}
    got, step = load_checkpoint(str(tmp_path / "ref"), like)
    assert step == 4 and got["q"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["q"].view(torch.int16).numpy(),
                                  bits.view(np.int16))
    save_checkpoint(str(tmp_path / "port"), got, step=4)
    with np.load(str(tmp_path / "port.npz")) as data:
        man = json.loads(bytes(data["__manifest__"]).decode())
        assert data["q"].dtype == ml_dtypes.bfloat16
    assert man["q"]["dtype"] == "bfloat16"
    back, jstep = jckpt.load_checkpoint(str(tmp_path / "port"), jtree)
    assert jstep == 4 and back["q"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["q"]).view(np.uint16),
                                  bits)


# ------------------------------------ the optimizer state, both packages

def _two_way_rank():
    params, metas = _tiny_tree()
    cfg = dict(n_workers=2, beta=0.5, w2s="rank10+natural",
               s2w="rank10+natural")
    jmetas = {k: JParamMeta(*m) for k, m in metas.items()}
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **cfg))
    topt = EF21Muon(EF21MuonConfig(**cfg))
    hook = lambda t: t      # noqa: E731
    jfn = jopt.make_step(jmetas, reshard_payloads=hook)
    jstep = jax.jit(lambda s, c, t: jfn(s, _grad_jax, c, t))
    tfn = topt.make_step(tmetas, reshard_payloads=hook)
    tstep = lambda s, c, t: tfn(s, _grad_torch, c, t)   # noqa: E731
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                               _coeffs(params, 100).items()}, 0.02)
    return params, jstate, jstep, tstep


def _bits(a):
    a = np.asarray(a)
    return a.reshape(-1).view(np.uint8)


def _assert_same_tree(tstate, jstate):
    """Every array of the port's state, in the reference's layout, equal
    to the reference state's bit for bit."""
    want = jax.tree_util.tree_flatten_with_path(_np_tree(jstate))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_to_numpy(tstate))[0])
    assert len(got) == len(want)
    for path, w in want:
        g = got[path]
        if g.dtype == np.dtype("V2"):
            g = g.view(ml_dtypes.bfloat16)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))


def _step_both(params, jstate, tstate, jstep, tstep):
    """One step on both sides, held as ``test_torch_rank.py``'s
    ``test_step_from_carried_state_on_tiny_tree`` holds it."""
    w_before = _np_tree(jstate["w"])
    c = _coeffs(params, 200)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in c.items()},
                      0.04)
    tstate, _ = tstep(tstate, {k: torch.from_numpy(v) for k, v in c.items()},
                      0.04)
    js = _np_tree(jstate)
    for k in params:
        np.testing.assert_allclose(tstate["m_w"][k].numpy(), js["m_w"][k],
                                   rtol=0,
                                   atol=1e-5 * np.abs(js["m_w"][k]).max())
        for key in ("g_w", "g_server"):
            a, b = tstate[key][k].numpy(), js[key][k]
            assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), key
        a, b = tstate["w"][k].numpy(), js["w"][k]
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b - w_before[k])
    want = state_from_jax(js)
    for key in ("cw_state", "cs_state"):
        for got, w in zip(tstate[key], want[key]):
            if got:
                assert_bf16_close(got["q"], w["q"], share=0.9, what=key)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    params, jstate, jstep, tstep = _two_way_rank()
    path = str(tmp_path / "ref")
    jckpt.save_checkpoint(path, jstate, step=1)
    like = state_from_jax(_np_tree(jstate))
    tstate, step = load_checkpoint(path, state_template(like))
    assert step == 1 and tstate["step"] == 1
    assert sum(bool(q) for q in tstate["cw_state"]) > 0
    _assert_same_tree(tstate, jstate)
    _step_both(params, jstate, tstate, jstep, tstep)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    params, jstate, jstep, tstep = _two_way_rank()
    tstate = state_from_jax(_np_tree(jstate))
    path = str(tmp_path / "port")
    save_checkpoint(path, tstate, step=1)
    back, step = jckpt.load_checkpoint(path, jstate)
    assert step == 1
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    _assert_same_tree(tstate, back)
    _step_both(params, back, tstate, jstep, tstep)


# -------------------------------------------------------------- donate

def _run(s2w, hook, donate, steps=3, **kw):
    params, metas = _tiny_tree()
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    opt = EF21Muon(EF21MuonConfig(n_workers=2, beta=0.5, w2s="top10+natural",
                                  s2w=s2w, **kw))
    state = opt.init(None, {k: torch.from_numpy(v.copy())
                            for k, v in params.items()}, tmetas)
    step = opt.make_step(tmetas, reshard_payloads=hook, donate=donate)
    ids = {id(t) for t in tree_leaves(state["x"])}
    for s in range(steps):
        state, _ = step(state, _grad_torch, {
            k: torch.from_numpy(v) for k, v in
            _coeffs(params, 100 + 10 * s).items()}, 0.02 * (s + 1))
    return state, ids


def _assert_states_bit_equal(a, b):
    for key in ("x", "w", "g_server", "g_w", "m_w"):
        if key in a:
            for u, v in zip(tree_leaves(a[key]), tree_leaves(b[key])):
                assert u.dtype == v.dtype and torch.equal(u, v), key
    assert a["step"] == b["step"]


@pytest.mark.parametrize("s2w", ["identity", "natural"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(participation="round_robin(1)",
                                         metrics=True)])
def test_donated_step_is_bit_equal(s2w, packed, kw):
    """3 steps: the donated state equals the undonated one bit for bit;
    a full-participation donated step keeps x's tensors (in place), and
    both keep x's leaves contiguous."""
    hook = (lambda t: t) if packed else None
    plain, _ = _run(s2w, hook, False, **kw)
    donated, ids = _run(s2w, hook, True, **kw)
    _assert_states_bit_equal(donated, plain)
    # the transposed bucket member (w_out) comes back contiguous too: the
    # next forward reads one layout, donated or not
    for state in (plain, donated):
        assert all(t.is_contiguous() for t in tree_leaves(state["x"]))
    if not kw:
        assert {id(t) for t in tree_leaves(donated["x"])} == ids


@pytest.mark.parametrize("s2w", ["identity", "natural"])
def test_undonated_step_leaves_its_input_untouched(s2w):
    params, metas = _tiny_tree()
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    opt = EF21Muon(EF21MuonConfig(n_workers=2, beta=0.5,
                                  w2s="rank10+natural", s2w=s2w))
    state = opt.init(torch.Generator().manual_seed(0),
                     {k: torch.from_numpy(v.copy())
                      for k, v in params.items()}, tmetas)
    step = opt.make_step(tmetas, reshard_payloads=lambda t: t)
    batch = {k: torch.from_numpy(v) for k, v in _coeffs(params, 7).items()}
    state, _ = step(state, _grad_torch, batch, 0.02)   # X != W after it
    before = state_to_numpy(state)
    new, _ = step(state, _grad_torch, batch, 0.04)
    after = state_to_numpy(state)
    flat_b = jax.tree_util.tree_flatten_with_path(before)[0]
    flat_a = dict(jax.tree_util.tree_flatten_with_path(after)[0])
    for path, v in flat_b:
        np.testing.assert_array_equal(_bits(flat_a[path]), _bits(v),
                                      err_msg=str(path))
    assert new["step"] == state["step"] + 1
