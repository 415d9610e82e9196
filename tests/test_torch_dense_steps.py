"""The two-way EF21-Muon step on the dense family's trees, against the
reference's.

For each of the four reduced dense architectures (qwen2.5-3b,
granite-3-2b, starcoder2-15b, mistral-large-123b), with 2 workers,
``top10+natural`` from the workers, ``natural`` from the server and both
wires packed (identity hooks):

  * one step from the reference's state after its first two steps
    (X != W),
    carried across with ``state_from_jax``. Both steps take the
    reference's own gradients of that state: the reference's step reads
    them from its batch, computed by the reference's model at the W its
    own step reaches (a first run of the step finds that W; the EF21-P
    leg comes before the gradients), and the port's step calls the same
    compiled reference function on the W it reaches. ``w``, ``g_w``,
    ``m_w`` and ``g_server`` must then be bit-equal and ``x`` within
    ``X_ATOL``, the bar ``test_torch_s2w.py`` sets;
  * three steps from the same init (qwen2.5-3b and starcoder2-15b,
    which carry every mechanism of the four), each side on its own
    model's gradients, whose losses stay within the two-way warm-up
    bound of ROADMAP Queue 3 item 2 (``test_torch_s2w.py``'s
    trajectory): at the same x the gradients differ only in summation
    order, and a TopK tie can flip, so the step on them is held by the
    curve, not by bits;
  * the carried state back through ``state_to_numpy`` and through each
    package's checkpoint into the other's, bit for bit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.api import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_config
from repro_torch.core.muon import EF21Muon, EF21MuonConfig
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.dist.layerwise import leaf_paths, tree_get, tree_unflatten
from repro_torch.models.api import (build_model, params_from_jax,
                                    state_from_jax, state_to_numpy)
from repro_torch.train.checkpoint import (load_checkpoint, save_checkpoint,
                                          state_template)
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_threads import one_torch_thread  # noqa: F401

DENSE = ["qwen2.5-3b", "granite-3-2b", "starcoder2-15b",
         "mistral-large-123b"]
# the trajectory runs on two archs that between them carry every
# mechanism of the four: qwen RMSNorm, SwiGLU, GQA 8:1, QKV bias and a
# tied embedding; starcoder2 LayerNorm with GELU, a sliding window and
# an untied unembedding (granite and mistral add none)
TRAJECTORY = ["qwen2.5-3b", "starcoder2-15b"]
SEQ, BATCH, WORKERS, STEPS = 96, 4, 2, 3
OPT = dict(n_workers=WORKERS, beta=0.5, w2s="top10+natural", s2w="natural")
X_ATOL = 1e-6         # x after NS-driven LMO steps (test_torch_s2w.py)
# two-way loss curves from one init agree to f32 rounding for steps 0-2
# (ROADMAP Queue 3 item 2; test_torch_s2w.py's LOSS_ATOL_WARMUP)
LOSS_ATOL_WARMUP = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# the CLI's radius schedule (--radius 0.01 --warmup 3) over 10 steps, as
# the trajectory tests of test_torch_slice.py and test_torch_s2w.py run it
_t = warmup_linear_decay(0.01, 3, 10)


def _grad_from_batch(p, b):
    """The reference step's gradient function: the gradients and loss
    its batch carries (one worker's, under the step's vmap)."""
    return b["loss"], b["grads"]


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's pieces for ``arch``: its initial params, batches
    and compiled gradient function, and its states and losses after each
    of STEPS steps from init (each step on the reference model's
    gradients at the W the step reaches)."""
    jcfg = jget_config(arch).reduced()
    jmodel = jbuild_model(jcfg)
    jparams, jmetas = jmodel.init(jax.random.key(0))
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=WORKERS, seed=0)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b, remat=False)))
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, **OPT))
    fn = jopt.make_step(jmetas, reshard_payloads=lambda t: t,
                        reshard_updates=lambda t: t)
    jstep = jax.jit(lambda s, b, t: fn(s, _grad_from_batch, b, t))
    batches = [data.batch_at(s) for s in range(STEPS)]
    state = jopt.init(jax.random.key(1), jparams, jmetas)
    states, losses = [state], []
    for s in range(STEPS):
        state, loss = _ref_step(jstep, jgrad, batches[s], state, s)
        states.append(state)
        losses.append(loss)
    return dict(jparams=jparams, batches=batches, jgrad=jgrad,
                states=states, losses=losses)


def _ref_step(jstep, jgrad, tokens, state, s):
    """One reference step at step ``s`` on batch ``tokens``: a first run
    finds the W its EF21-P leg reaches (gradients zero), then the step
    runs again on the reference model's gradients at that W, worker by
    worker."""
    zeros = {"loss": jnp.zeros((WORKERS,), jnp.float32),
             "grads": jax.tree.map(
                 lambda x: jnp.zeros((WORKERS,) + x.shape, x.dtype),
                 state["x"])}
    w = jstep(state, zeros, jnp.float32(_t(s)))[0]["w"]
    w = jax.tree.map(lambda a, x: a.astype(x.dtype), w, state["x"])
    outs = [jgrad(w, jax.tree.map(lambda v: v[j], tokens))
            for j in range(WORKERS)]
    batch = {"loss": jnp.stack([o[0] for o in outs]),
             "grads": jax.tree.map(lambda *g: jnp.stack(g),
                                   *[o[1] for o in outs])}
    state, aux = jstep(state, batch, jnp.float32(_t(s)))
    return state, float(aux["loss"])


def _port_opt(arch: str):
    model = build_model(get_config(arch).reduced())
    _, metas = model.init(None, "meta")
    opt = EF21Muon(EF21MuonConfig(**OPT))
    step = opt.make_step(metas, reshard_payloads=lambda t: t,
                         reshard_updates=lambda t: t)
    return model, metas, opt, step


def _torch_tokens(jbatch):
    return {k: torch.from_numpy(np.array(v)).to(torch.int64)
            for k, v in jbatch.items()}


# ----------------------------------------------------- the carried step

@pytest.mark.parametrize("arch", DENSE)
def test_two_way_step_from_carried_state_matches_reference(arch):
    """From the reference's state after steps 0-1 (X != W), one packed
    two-way step on both sides, each fed the reference model's
    gradients at the W it reached: w, g_w, m_w and g_server bit-equal,
    x within X_ATOL."""
    ref = _reference(arch)
    jstate, want = ref["states"][2], ref["states"][3]
    assert any(np.any(np.asarray(a) != np.asarray(b)) for a, b in zip(
        jax.tree.leaves(jstate["x"]), jax.tree.leaves(jstate["w"])))
    paths = leaf_paths(_np_tree(jstate["x"]))
    jgrad = ref["jgrad"]
    seen = []

    def grad_and_loss(params, batch):
        # the reference's compiled gradient at the port's W
        jp = tree_unflatten(paths, [jnp.asarray(tree_get(params, p).numpy())
                                    for p in paths])
        loss, grads = jgrad(jp, {k: jnp.asarray(v.numpy(), jnp.int32)
                                 for k, v in batch.items()})
        seen.append(float(loss))
        return torch.tensor(float(loss)), params_from_jax(_np_tree(grads))

    _, metas, _, step = _port_opt(arch)
    tstate = state_from_jax(_np_tree(jstate))
    tstate, taux = step(tstate, grad_and_loss,
                        _torch_tokens(ref["batches"][2]), _t(2))
    assert len(seen) == WORKERS
    assert tstate["step"] == int(want["step"]) == 3
    for key in ("w", "g_w", "m_w", "g_server"):
        for p in paths:
            np.testing.assert_array_equal(
                tree_get(tstate[key], p).numpy(),
                np.asarray(tree_get(want[key], p)), err_msg=f"{key}/{p}")
    moved = 0
    for p in paths:
        got, w = tree_get(tstate["x"], p).numpy(), np.asarray(
            tree_get(want["x"], p))
        np.testing.assert_allclose(got, w, rtol=0, atol=X_ATOL,
                                   err_msg=f"x/{p}")
        moved += int(np.any(w != np.asarray(tree_get(jstate["x"], p))))
    assert moved == len(paths)
    np.testing.assert_allclose(taux["loss"].item(), ref["losses"][2],
                               rtol=1e-6)


# ------------------------------------------------------ the trajectory

@pytest.mark.parametrize("arch", TRAJECTORY)
def test_two_way_three_steps_track_reference(arch):
    """Three packed two-way steps from the reference's init, each side
    on its own model's gradients: the loss curves within
    LOSS_ATOL_WARMUP, every loss finite."""
    ref = _reference(arch)
    model, metas, opt, step = _port_opt(arch)
    tr = Trainer(model, TrainerConfig(), device="cpu")
    state = opt.init(None, params_from_jax(_np_tree(ref["jparams"])), metas)
    losses = []
    for s in range(STEPS):
        state, aux = step(state, tr._grad_and_loss,
                          _torch_tokens(ref["batches"][s]), _t(s))
        losses.append(aux["loss"].item())
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref["losses"], rtol=0,
                               atol=LOSS_ATOL_WARMUP)


# ------------------------------------------- state exchange, checkpoints

def _assert_same_state(tstate, jstate):
    want = jax.tree_util.tree_flatten_with_path(_np_tree(jstate))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        state_to_numpy(tstate))[0])
    assert len(got) == len(want)
    for path, w in want:
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8),
                                      err_msg=str(path))


@pytest.mark.parametrize("arch", DENSE)
def test_state_and_checkpoints_cross_both_ways(arch, tmp_path):
    """The carried state: ``state_from_jax`` then ``state_to_numpy``
    gives the reference's arrays back; the port's checkpoint loads in
    the reference and the reference's in the port, bit for bit."""
    jstate = _reference(arch)["states"][1]
    tstate = state_from_jax(_np_tree(jstate))
    _assert_same_state(tstate, jstate)
    save_checkpoint(str(tmp_path / "port"), tstate, step=1)
    back, step = jckpt.load_checkpoint(str(tmp_path / "port"), jstate)
    assert step == 1
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    _assert_same_state(tstate, back)
    jckpt.save_checkpoint(str(tmp_path / "ref"), jstate, step=1)
    loaded, step = load_checkpoint(str(tmp_path / "ref"),
                                   state_template(tstate))
    assert step == 1
    _assert_same_state(loaded, jstate)
