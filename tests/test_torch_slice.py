"""The port's first slice as a whole, against the reference.

Reduced nanogpt (2 layers, d_model 256, vocab 512, f32): the model's
loss and gradients from the reference's parameters, and the trainer
over 10 steps from the same initial state and the same batches. Also
the train CLI, the data stream, device selection, and two properties of
the port's files: none imports JAX or the reference package, and
``chip_smoke.py`` refuses to run without a card or outside a checkout.
"""
from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.schedule import warmup_linear_decay as jwarmup_linear_decay
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.api import build_model as jbuild_model
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import train as train_cli
from repro_torch.models.api import build_model, params_from_jax
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH, WORKERS, STEPS = 32, 4, 2, 10

# 10-step loss curves. Both sides are f32, and at the same x their
# gradients differ only in summation order (~1e-7 relative). But the
# payload is bf16, so TopK meets ties at the k-th magnitude, and such a
# difference flips which entry is sent (5 of 131,072 embed entries at
# step 0 here); the sign LMO turns each flipped entry of g_server into a
# +-radius step of x. Until the radius warms up the curves agree to f32
# rounding; after it the flips compound (measured: 2.4e-3 by step 10).
LOSS_ATOL_WARMUP = 1e-5    # steps 0-3
LOSS_ATOL = 1e-2           # all 10 steps


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch_torch(jbatch, worker=None):
    out = {k: torch.from_numpy(np.array(v)).to(torch.int64)
           for k, v in jbatch.items()}
    return out if worker is None else {k: v[worker] for k, v in out.items()}


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config("nanogpt-124m").reduced()
    jmodel = jbuild_model(jcfg)
    jparams, _ = jmodel.init(jax.random.key(0))
    data = JSyntheticLM(jcfg, JShapeSpec("t", "train", SEQ, BATCH),
                        n_workers=WORKERS, seed=0)
    return jcfg, jmodel, jparams, data


def test_reduced_config_matches_reference():
    jcfg = jget_config("nanogpt-124m").reduced()
    cfg = get_config("nanogpt-124m").reduced()
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "rope", "norm",
              "act", "norm_eps", "dtype", "max_position", "tied_embeddings",
              "qkv_bias"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert get_config("nanogpt-124m").hd == jget_config("nanogpt-124m").hd


def test_model_loss_and_grads_match_reference(reduced):
    """Loss and every gradient leaf of reduced nanogpt from the
    reference's parameters (f32; summation order only: rtol 1e-5 on the
    loss, 1e-4 of each leaf's gradient scale)."""
    jcfg, jmodel, jparams, data = reduced
    jb = jax.tree.map(lambda v: v[0], data.batch_at(0))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, remat=False)))(jparams)
    model = build_model(get_config("nanogpt-124m").reduced())
    params = params_from_jax(_np_tree(jparams))
    tr = Trainer(model, TrainerConfig(), device="cpu")
    loss, grads = tr._grad_and_loss(params, _batch_torch(jb))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, jg in jflat:
        g = grads
        for k in path:
            g = g[k.key]
        jg = np.asarray(jg)
        err = np.max(np.abs(g.numpy() - jg)) / np.max(np.abs(jg))
        assert err < 1e-4, (path, err)


def test_param_tree_and_metas_match_reference(reduced):
    _, jmodel, jparams, _ = reduced
    _, jmetas = jmodel.init(jax.random.key(0))
    params, metas = build_model(get_config("nanogpt-124m").reduced()).init(
        torch.Generator().manual_seed(0), "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jm = jax.tree.leaves(jmetas, is_leaf=lambda m: hasattr(m, "lmo"))
    from repro_torch.dist.layerwise import leaf_paths, tree_leaves
    assert ["/".join(p) for p in leaf_paths(params)] == \
        ["/".join(k.key for k in path) for path, _ in jflat]
    assert [tuple(p.shape) for p in tree_leaves(params)] == \
        [tuple(v.shape) for _, v in jflat]
    assert [(m.lmo, m.radius_scale, m.stack_dims, m.compressible)
            for m in tree_leaves(metas)] == \
        [(m.lmo, m.radius_scale, m.stack_dims, m.compressible) for m in jm]


def test_params_from_jax_keeps_values_and_bf16():
    tree = {"a": jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)
                             .reshape(3, 4)).astype(jnp.bfloat16),
            "b": {"c": jnp.arange(5, dtype=jnp.float32)}}
    out = params_from_jax(_np_tree(tree))
    assert out["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["a"].float().numpy(), np.asarray(tree["a"].astype(jnp.float32)))
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.arange(5))


def test_trainer_tracks_reference_over_10_steps(reduced):
    """The whole slice: reduced-nanogpt Trainer, 2 workers, top10, beta
    0.5, from the reference's initial params and on its batches; the
    loss curve stays within LOSS_ATOL of the reference's and descends."""
    jcfg, jmodel, jparams, data = reduced
    kw = dict(n_workers=WORKERS, beta=0.5, w2s="top10")
    jtr = JTrainer(jmodel, JTrainerConfig(remat=False, use_pallas=False,
                                          **kw))
    jstate = jtr.opt.init(jax.random.key(1), jparams, jtr.metas)
    jstep = jtr.jit_step(None)
    tr = Trainer(build_model(get_config("nanogpt-124m").reduced()),
                 TrainerConfig(**kw), device="cpu")
    state = tr.opt.init(None, params_from_jax(_np_tree(jparams)), tr.metas)
    step = tr.make_step()
    jsched = jwarmup_linear_decay(0.01, 3, STEPS)
    sched = warmup_linear_decay(0.01, 3, STEPS)
    jl, tl = [], []
    for i in range(STEPS):
        jb = data.batch_at(i)
        jstate, jaux = jstep(jstate, jb, jsched(i))
        state, aux = step(state, _batch_torch(jb), sched(i))
        jl.append(float(jaux["loss"]))
        tl.append(float(aux["loss"]))
    np.testing.assert_allclose(tl[:4], jl[:4], rtol=0,
                               atol=LOSS_ATOL_WARMUP)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_ATOL)
    assert tl[-1] < tl[0] - 0.1


def test_train_cli_prints_header_and_loss_lines(capsys):
    out = train_cli.main(["--arch", "nanogpt-124m", "--reduced", "--steps",
                          "2", "--seq", "16", "--batch", "2", "--workers",
                          "2", "--log-every", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("arch=nanogpt-124m params=1313280 "
                               "w2s_bytes/worker=791600 (0.301 of dense)")
    # a loss line a step, then the reference's summary line last
    assert [json.loads(x)["step"] for x in lines[1:3]] == [0, 1]
    summary = json.loads(lines[-1].split("RESYNC_SUMMARY ", 1)[1])
    assert summary["final_loss"] == round(out["losses"][-1], 4)
    assert summary["supervisor_retries"] == summary["resync_full"] == 0
    assert len(out["losses"]) == 2 and all(map(math.isfinite,
                                               out["losses"]))


@pytest.mark.parametrize("flag", ["--participation=bernoulli(0.5)",
                                  "--faults=drop:w=1:steps=1-2",
                                  "--resync=2", "--supervise",
                                  "--metrics-out=m.jsonl", "--checkpoint=c",
                                  "--resume=c", "--donate",
                                  "--trace-spans"])
def test_train_cli_refuses_unported_flags(flag, capsys):
    """The port refuses none of the reference CLI's flags since the
    rejoin slice ported ``--resync N``: each parses beside ``--resync
    2``, and only the run it then asks for with the default ``--s2w
    identity`` is refused, with the reference's error."""
    argv = ["--arch", "nanogpt-124m", "--reduced", "--device", "cpu", flag]
    if flag != "--resync=2":
        assert train_cli.parse_args(argv).resync == 0
        argv.append("--resync=2")
    args = train_cli.parse_args(argv)
    assert args.resync == 2 and "ROADMAP" not in capsys.readouterr().err
    _, tr, _, _ = train_cli.setup(args)
    with pytest.raises(ValueError, match="resync requires a compressing "
                                         "s2w leg"):
        tr.make_step()


def test_synthetic_stream_shapes_range_and_determinism():
    cfg = get_config("nanogpt-124m").reduced()
    data = SyntheticLM(cfg, ShapeSpec("t", "train", 24, 6), n_workers=3,
                       seed=7, device="cpu")
    b0, b0_again, b1 = data.batch_at(0), data.batch_at(0), data.batch_at(1)
    assert b0["tokens"].shape == b0["labels"].shape == (3, 2, 24)
    assert torch.equal(b0["tokens"], b0_again["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert torch.equal(b0["tokens"][..., 1:], b0["labels"][..., :-1])
    assert 0 <= int(b0["tokens"].min()) and int(b0["tokens"].max()) < 512
    with pytest.raises(ValueError):
        SyntheticLM(cfg, ShapeSpec("t", "train", 8, 5), n_workers=2)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(build_model(get_config("nanogpt-124m")), TrainerConfig())
    assert resolve_device("cpu") == torch.device("cpu")


def _imports(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return mods


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "wire/codecs", "wire/layout", "dist/pipeline", "kernels/bitpack",
        "kernels/natural_pack", "train/serve", "launch/serve",
        "configs/mixtral_8x7b")} <= names
    assert len(files) > 25
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    """No result without a card; none either from a directory that holds
    chip_smoke.py and nothing else of the repository."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    runs = [[sys.executable, str(alone)]]
    if not torch.cuda.is_available():
        runs.append([sys.executable, str(ROOT / "chip_smoke.py")])
    for cmd in runs:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=tmp_path, timeout=120)
        assert proc.returncode != 0, cmd
        assert '"ok"' not in proc.stdout, cmd
