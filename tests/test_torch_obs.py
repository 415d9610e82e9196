"""The port's observability against the reference's (DESIGN.md §10):
trace spans, the in-step MetricSet and the JSONL sink.

The span names are the reference's; the metrics-on and spans-on steps
are bit-equal to the off arms (metrics are pure reads); each metric from
a carried state is within ``METRIC_RTOL`` of the reference's
``MetricSet`` (f32 reductions in another order; the NS residual of a
direction within X's tolerance), under the same names in the same
order; a ``torch.profiler`` capture of one step on the CPU holds every
phase and wire stage span; the sink's cases of ``tests/test_obs.py`` and
``tests/test_robustness.py`` on the port's ``MetricsWriter``, and the
port's JSONL passes the reference's validator.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.muon import EF21Muon as JEF21Muon
from repro.core.muon import EF21MuonConfig as JEF21MuonConfig
from repro.core.muon import ParamMeta as JParamMeta
from repro.dist import participation as jpart
from repro.obs import metrics as jmetrics
from repro.obs import sink as jsink
from repro.obs import trace as jtrace
from repro_torch.core.muon import EF21Muon, EF21MuonConfig, ParamMeta
from repro_torch.dist.layerwise import tree_leaves
from repro_torch.dist.participation import Explicit
from repro_torch.launch import train as train_cli
from repro_torch.models.api import state_from_jax
from repro_torch.obs import metrics, trace
from repro_torch.obs.sink import (SCHEMA, MetricsWriter, SchemaError,
                                  config_hash, run_manifest, validate_jsonl,
                                  validate_record)
from test_torch_s2w import (_coeffs, _grad_jax, _grad_torch, _np_tree,
                            _tiny_tree)
from test_torch_threads import one_torch_thread  # noqa: F401

# f32 norms of the same tensors summed in another order; the residual of
# an NS direction that differs from the reference's by X_ATOL-sized
# rounding
METRIC_RTOL = 1e-4


# ---------------------------------------------------------------- spans

def test_span_names_equal_reference():
    assert trace.PHASE_SPANS == jtrace.PHASE_SPANS
    for d in ("w2s", "s2w"):
        for k in range(4):
            assert trace.wire_stage_span(d, k) == jtrace.wire_stage_span(d, k)
    with pytest.raises(ValueError, match="w2s|s2w"):
        trace.wire_stage_span("up", 0)


def test_span_recorder_and_summary():
    rec = trace.SpanRecorder()
    for _ in range(3):
        with trace.span("ckpt/save", recorder=rec):
            pass
    (row,) = trace.span_summary(rec)
    assert row["name"] == "ckpt/save" and row["count"] == 3
    assert row["total_s"] >= row["max_s"] >= 0.0
    rec.clear()
    assert trace.span_summary(rec) == []


def _run(w2s="top10+natural", s2w="natural", hook=True, steps=2, **kw):
    params, metas = _tiny_tree()
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    opt = EF21Muon(EF21MuonConfig(n_workers=2, beta=0.5, w2s=w2s, s2w=s2w,
                                  **kw))
    state = opt.init(None, {k: torch.from_numpy(v.copy())
                            for k, v in params.items()}, tmetas)
    step = opt.make_step(tmetas,
                         reshard_payloads=(lambda t: t) if hook else None)
    aux = None
    for s in range(steps):
        state, aux = step(state, _grad_torch, {
            k: torch.from_numpy(v) for k, v in
            _coeffs(params, 100 + 10 * s).items()}, 0.02 * (s + 1))
    return state, aux


@pytest.mark.parametrize("hook", [False, True])
@pytest.mark.parametrize("extra", [dict(),
                                   dict(participation="round_robin(1)"),
                                   dict(participation="round_robin(1)",
                                        resync=2)])
def test_metrics_and_spans_change_no_bit(hook, extra):
    plain, _ = _run(hook=hook, **extra)
    for on in (dict(metrics=True), dict(trace_spans=True),
               dict(metrics=True, trace_spans=True)):
        state, aux = _run(hook=hook, **extra, **on)
        for key in ("x", "w", "g_server", "g_w", "m_w"):
            for u, v in zip(tree_leaves(state[key]), tree_leaves(plain[key])):
                assert torch.equal(u, v), (key, on)
        assert ("metrics" in aux) == on.get("metrics", False)


def test_profiler_capture_holds_every_span():
    """One packed two-way step under ``torch.profiler`` on the CPU: every
    phase span and every wire stage span of both directions."""
    from torch.profiler import ProfilerActivity, profile
    params, metas = _tiny_tree()
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    opt = EF21Muon(EF21MuonConfig(n_workers=2, beta=0.5, w2s="top10",
                                  s2w="natural", trace_spans=True))
    state = opt.init(None, {k: torch.from_numpy(v.copy())
                            for k, v in params.items()}, tmetas)
    step = opt.make_step(tmetas, reshard_payloads=lambda t: t)
    n_stages = opt.wire_budget(state["x"], tmetas).n_stages
    assert n_stages > 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _grad_torch, {k: torch.from_numpy(v) for k, v in
                                  _coeffs(params, 5).items()}, 0.02)
    names = {e.name for e in prof.events()}
    for name in trace.PHASE_SPANS:
        assert name in names, name
    for d in ("w2s", "s2w"):
        for k in range(n_stages):
            assert trace.wire_stage_span(d, k) in names


# -------------------------------------------------------------- metrics

def _carried(w2s, s2w, participation="full", hook=True):
    """One step of each side from the reference's state after its first
    step, both with metrics: (port metrics, reference metrics)."""
    params, metas = _tiny_tree()
    cfg = dict(n_workers=2, beta=0.5, w2s=w2s, s2w=s2w, metrics=True)
    jp = (jpart.Explicit(participation.masks)
          if isinstance(participation, Explicit) else participation)
    jopt = JEF21Muon(JEF21MuonConfig(use_pallas=False, participation=jp,
                                     **cfg))
    topt = EF21Muon(EF21MuonConfig(participation=participation, **cfg))
    jmetas = {k: JParamMeta(*m) for k, m in metas.items()}
    tmetas = {k: ParamMeta(*m) for k, m in metas.items()}
    h = (lambda t: t) if hook else None
    jfn = jopt.make_step(jmetas, reshard_payloads=h)
    jstep = jax.jit(lambda s, c, t: jfn(s, _grad_jax, c, t))
    tstep = topt.make_step(tmetas, reshard_payloads=h)
    jstate = jopt.init(jax.random.key(0),
                       {k: jnp.asarray(v) for k, v in params.items()},
                       jmetas)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                               _coeffs(params, 100).items()}, 0.02)
    tstate = state_from_jax(_np_tree(jstate))
    c = _coeffs(params, 200)
    _, jaux = jstep(jstate, {k: jnp.asarray(v) for k, v in c.items()}, 0.04)
    _, taux = tstep(tstate, _grad_torch,
                    {k: torch.from_numpy(v) for k, v in c.items()}, 0.04)
    return taux["metrics"], jaux["metrics"]


@pytest.mark.parametrize("w2s,s2w,participation,hook", [
    ("top10", "identity", "full", True),
    ("top10+natural", "natural", "full", True),
    ("top10", "natural", "full", False),
    ("top10", "identity", Explicit(((1, 0), (0, 1))), True),
    ("top10+natural", "identity", "round_robin(1)", False)])
def test_metrics_equal_reference(w2s, s2w, participation, hook):
    got, want = _carried(w2s, s2w, participation, hook)
    assert got.names() == want.names()
    wf = want.host_floats()
    for name, v in got.host_floats().items():
        np.testing.assert_allclose(v, wf[name], rtol=METRIC_RTOL,
                                   atol=1e-6, err_msg=name)


def test_host_floats_is_one_transfer_of_every_value():
    ms = metrics.MetricSet()
    ms.add("a/x", torch.tensor(1.5))
    ms.add("wire/bytes_w2s", 7)
    with pytest.raises(ValueError, match="duplicate"):
        ms.add("a/x", 2.0)
    with pytest.raises(ValueError, match="bad metric name"):
        ms.add("a b", 2.0)
    assert ms.host_floats() == {"a/x": 1.5, "wire/bytes_w2s": 7.0}
    assert "a/x" in ms and len(ms) == 2 and ms["a/x"].ndim == 0


@pytest.mark.parametrize("shape", [(3, 8, 12), (2, 12, 8)])
def test_metric_helpers_equal_reference(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    b[1] = 0.0
    for lead in (0, 1):
        np.testing.assert_allclose(
            metrics.worker_mean_norm(torch.from_numpy(a), lead).item(),
            float(jmetrics.worker_mean_norm(a, lead)), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.rel_error(torch.from_numpy(a), torch.from_numpy(b)).item(),
        float(jmetrics.rel_error(a, b)), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.orth_residual(torch.from_numpy(a)).item(),
        float(jmetrics.orth_residual(a)), rtol=1e-5)
    params, _ = _tiny_tree()
    assert metrics.leaf_names({k: torch.from_numpy(v) for k, v in
                               params.items()}) \
        == jmetrics.leaf_names(params)


# ----------------------------------------------------------------- sink

def test_metrics_writer_roundtrip(tmp_path):
    path = str(tmp_path / "m.jsonl")
    manifest = run_manifest(config={"beta": 0.5}, mesh=None,
                            extra={"arch": "t"})
    with MetricsWriter(path, manifest=manifest, flush_every=2) as w:
        w.write("step", step=0, loss=torch.tensor(3.25),
                metrics={"ef/err_norm/a": torch.tensor(0.5)})
        w.write("step", step=1, loss=1.0)
        w.write("span", name="plan/build", count=1, total_s=0.01)
        w.write("summary", spans=[{"name": "plan/build", "count": 1,
                                   "total_s": 0.01}])
    counts = validate_jsonl(path)
    assert counts == {"manifest": 1, "step": 2, "span": 1, "summary": 1}
    recs = [json.loads(line) for line in open(path)]
    assert all(r["schema"] == SCHEMA == jsink.SCHEMA for r in recs)
    assert recs[0]["kind"] == "manifest"
    assert recs[0]["config_hash"] == config_hash({"beta": 0.5}) \
        == jsink.config_hash({"beta": 0.5})
    assert recs[0]["arch"] == "t" and "argv" in recs[0]
    # 0-d tensors landed as plain JSON numbers
    assert recs[1]["loss"] == 3.25
    assert recs[1]["metrics"]["ef/err_norm/a"] == 0.5
    assert jsink.validate_jsonl(path) == counts


def test_metrics_writer_append_resume(tmp_path):
    path = str(tmp_path / "d.jsonl")
    row = dict(arch="a", shape="s", mesh="single", tag="t", status="ok")
    with MetricsWriter(path, append=True) as w:
        w.write_record({"kind": "dryrun", **row})
    with MetricsWriter(path, append=True) as w:     # resume: no rewrite
        w.write_record({"kind": "dryrun", **row, "tag": "t2"})
    assert validate_jsonl(path) == {"dryrun": 2}
    tags = [json.loads(line)["tag"] for line in open(path)]
    assert tags == ["t", "t2"]


def test_writer_rejects_bad_records(tmp_path):
    with MetricsWriter(str(tmp_path / "x.jsonl")) as w:
        with pytest.raises(SchemaError):
            w.write("step", step=0)                 # missing loss
        with pytest.raises(SchemaError):
            w.write("nope", a=1)                    # unknown kind
        with pytest.raises(SchemaError):
            w.write("step", step=0, loss=1.0,
                    metrics={"a": "not-a-number"})
    assert validate_jsonl(str(tmp_path / "x.jsonl")) == {}


def test_validate_record_legacy_and_envelope():
    assert validate_record({"bench": "ns", "kind": "dispatch"}) == "bench"
    assert validate_record({"arch": "a", "shape": "s", "mesh": "m",
                            "tag": "t", "status": "ok"}) == "dryrun"
    bad = [({"schema": SCHEMA, "kind": "step", "bench": "x"}, "bench"),
           ({"schema": "repro.metrics/v0", "kind": "bench", "bench": "x"},
            None),
           ({"mystery": 1}, None),
           ({"schema": SCHEMA, "kind": "step", "step": "0", "loss": 1.0},
            None)]
    for rec, kind in bad:
        with pytest.raises(SchemaError) as got:
            validate_record(rec, kind=kind)
        with pytest.raises(jsink.SchemaError) as want:
            jsink.validate_record(rec, kind=kind)
        assert str(got.value) == str(want.value)


class _FlakyFile:
    """File wrapper failing the first ``n_fail`` write() calls."""

    def __init__(self, inner, n_fail):
        self._inner = inner
        self._left = n_fail
        self.attempts = 0

    def write(self, s):
        self.attempts += 1
        if self._left > 0:
            self._left -= 1
            raise OSError(28, "No space left on device")
        return self._inner.write(s)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_sink_retries_transient_oserror(tmp_path):
    path = str(tmp_path / "m.jsonl")
    w = MetricsWriter(path, write_retries=3, retry_backoff_s=0.001)
    flaky = _FlakyFile(w._file, n_fail=2)
    w._file = flaky
    w.write("step", step=0, loss=1.0)
    w.close()
    assert w.dropped == 0
    assert flaky.attempts == 3          # 2 failures + 1 success
    with open(path) as f:
        recs = [json.loads(x) for x in f if x.strip()]
    assert recs and recs[-1]["loss"] == 1.0


def test_sink_drops_with_counter_after_retries(tmp_path):
    path = str(tmp_path / "m.jsonl")
    w = MetricsWriter(path, write_retries=2, retry_backoff_s=0.001)
    w._file = _FlakyFile(w._file, n_fail=10 ** 6)   # permanent failure
    w.write("step", step=0, loss=1.0)
    w.write("step", step=1, loss=2.0)
    with pytest.warns(RuntimeWarning, match="dropped 2 record"):
        w.close()
    assert w.dropped == 2


def test_sink_drop_does_not_block_later_records(tmp_path):
    path = str(tmp_path / "m.jsonl")
    w = MetricsWriter(path, write_retries=1, retry_backoff_s=0.001)
    w._file = _FlakyFile(w._file, n_fail=2)   # kills exactly record 1
    w.write("step", step=0, loss=1.0)
    w.flush()
    w.write("step", step=1, loss=2.0)
    with pytest.warns(RuntimeWarning):
        w.close()
    assert w.dropped == 1
    with open(path) as f:
        recs = [json.loads(x) for x in f if x.strip()]
    assert [r["step"] for r in recs] == [1]


def test_cli_jsonl_passes_the_reference_validator(tmp_path, capsys):
    """Reduced nanogpt through the CLI with --metrics-out and
    --trace-spans: manifest, step, span and summary records the
    reference's validator accepts, every metric finite, and the EF21
    error table printed."""
    path = str(tmp_path / "m.jsonl")
    train_cli.main(["--arch", "nanogpt-124m", "--reduced", "--steps", "3",
                    "--seq", "16", "--batch", "2", "--workers", "2",
                    "--log-every", "1", "--device", "cpu", "--s2w",
                    "natural", "--metrics-out", path, "--trace-spans"])
    out = capsys.readouterr().out
    assert "-- EF21 error by layer" in out
    assert f"metrics written to {path}" in out
    counts = jsink.validate_jsonl(path)
    assert counts["manifest"] == 1 and counts["step"] == 3
    assert counts["summary"] == 1
    steps = [json.loads(x) for x in open(path) if '"kind": "step"' in x]
    for r in steps:
        assert all(np.isfinite(v) for v in r["metrics"].values())
        assert any(k.startswith("efp/err_norm/") for k in r["metrics"])
