"""The examples' torch twins (``examples/*_torch.py``) on the CPU.

Each twin's ``main`` runs with ``--device cpu`` for 2 steps, trials or
tokens and prints the lines its original (``examples/<name>.py``)
prints, in the original's formats; each imports ``repro_torch`` and
nothing of JAX or ``repro``. Without ``--device`` each asks for the
card.
"""
from __future__ import annotations

import ast
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWINS = ("quickstart", "compressor_zoo", "train_nanogpt_ef21",
         "serve_batched")


def _load(name: str):
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_only_the_port(name):
    """The twin imports ``repro_torch`` (and torch and the standard
    library), never JAX or ``repro``; its original is left beside it."""
    tree = ast.parse((EXAMPLES / f"{name}_torch.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "repro", "flax", "optax"}, mods
    assert (EXAMPLES / f"{name}.py").is_file()


def test_quickstart(capsys):
    losses = _load("quickstart").main(["--steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"w2s payload: \d+ kB/worker/step \(\d+\.\d\d% of "
                        r"dense\)", lines[0])
    assert [re.fullmatch(r"step +(\d+)  loss \d+\.\d{3}", ln).group(1)
            for ln in lines[1:]] == ["0", "1"]
    assert len(losses) == 2 and all(5.0 < v < 7.0 for v in losses)


def test_compressor_zoo(capsys):
    rows = _load("compressor_zoo").main(["--trials", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["compressor", "norm", "alpha_emp", "bytes"]
    body = [ln for ln in lines[1:] if ln.strip()]
    assert len(body) == 11 and len(rows) == 10
    for ln, (name, kind, a, b) in zip(body, rows):
        assert re.fullmatch(r"\S+ +\S+ +-?\d+\.\d{3} +\d+", ln)
        assert ln.split()[:2] == [name, kind] and int(ln.split()[3]) == b
    # the names and wire costs of the original's rows
    assert [r[0] for r in rows] == [
        "top10%", "svd4", "svd4", "svd4", "coltop25%", "natural", "natural",
        "dropout0.6", "rank15%", "top15%+natural"]
    assert [r[3] for r in rows] == [1848, 896, 896, 896, 1584, 3456, 3456,
                                    3687, 1792, 2363]
    assert re.fullmatch(r"nuclear-norm sharp operator as compressor: rank=1 "
                        r"frobenius residual \d+\.\d{3} \(alpha ~ "
                        r"1/rank\(X\)\)", body[-1])


def test_train_nanogpt_ef21(capsys, tmp_path):
    final = _load("train_nanogpt_ef21").main(
        ["--steps", "2", "--device", "cpu",
         "--checkpoint", str(tmp_path / "ck")])
    lines = capsys.readouterr().out.splitlines()
    assert list(final) == ["identity", "top15+natural", "rank15+natural"]
    assert len(lines) == 6
    for i, w2s in enumerate(final):
        assert re.fullmatch(rf"\[{re.escape(w2s)} *\] step   0 loss "
                            r"\d+\.\d{3} \(sent \d+\.\d MB/worker\)",
                            lines[2 * i])
        assert re.fullmatch(rf"\[{re.escape(w2s)} *\] FINAL loss \d+\.\d{{3}}"
                            r" after \d+\.\d MB/worker w2s traffic",
                            lines[2 * i + 1])
        assert (tmp_path / f"ck.{w2s}.npz").is_file()


def test_serve_batched(capsys):
    out = _load("serve_batched").main(["--max-new", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert list(out) == ["granite-3-2b", "recurrentgemma-2b", "xlstm-1.3b"]
    for ln, (arch, toks) in zip(lines, out.items()):
        assert toks.shape == (4, 2) and toks.dtype == torch.int32
        assert re.fullmatch(
            rf"{re.escape(arch)} +generated \(4, 2\) in +\d+\.\d\ds "
            r"\( *\d+\.\d tok/s\)   first row: \d+ \d+", ln)


def test_twins_ask_for_the_card(monkeypatch):
    """Without ``--device`` a twin runs on cuda, which raises on a box
    without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _load("quickstart").main(["--steps", "1"])
