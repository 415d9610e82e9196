"""In-step metrics: a ``MetricSet`` collected inside the step (DESIGN.md §10).

Port of ``repro/obs/metrics.py``. A MetricSet is an ordered name ->
0-d tensor mapping that the optimizer fills as it goes and returns in
``aux["metrics"]``; every value stays on the step's device until
``host_floats()`` copies them all to the host in one transfer (the one
sync, which the sink makes every N steps, never the step). Collection is
gated by ``EF21MuonConfig.metrics``: the metrics-off step builds no
MetricSet and runs no metric code.

Metric names are ``/``-separated taxonomies (DESIGN.md §10):

  ef/err_norm/<leaf>        ‖M_j - G_j'‖   post-update EF21 error, mean
                            over workers of the per-worker F-norm
  ef/rel_err/<leaf>         ‖C(v)-v‖/‖v‖   compression relative error of
                            v = M_j - G_j (0 where ‖v‖ == 0)
  ef/momentum_norm/<leaf>   ‖M_j‖          worker-mean momentum norm
  efp/err_norm/<leaf>       ‖X - W‖        EF21-P server model-estimate
                            error (s2w leg only)
  ns/orth_residual/<bucket> ‖G - I‖_F      Newton-Schulz orthogonality
                            residual, G the small-side gram of the
                            bucket direction, mean over the batch
  wire/...                  static per-direction wire bytes + stage count
  part/...                  participants, guard demotions, skipped step
  supervisor/retries        host-side: cumulative supervised-step
                            re-dispatches, merged into the step record by
                            the train CLI (never in the step)

The helpers are pure functions of tensors the step already holds: they
never feed the update, so the metrics-on step is bit-equal to the off one.
"""
from __future__ import annotations

import re

import torch

_NAME_RE = re.compile(r"^[A-Za-z0-9_.+\-]+(/[A-Za-z0-9_.+\-]+)*$")


class MetricSet:
    """Ordered mapping of metric name -> 0-d tensor on the step's device."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self._values: dict[str, torch.Tensor] = {}

    def add(self, name: str, value) -> None:
        """``value`` a 0-d tensor, or a host number (a static account),
        which is filled into a 0-d f32 tensor on the device (a fill, no
        transfer)."""
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        if name in self._values:
            raise ValueError(f"duplicate metric {name!r}")
        if not isinstance(value, torch.Tensor):
            value = torch.full((), float(value), dtype=torch.float32,
                               device=self.device)
        self._values[name] = value.reshape(())

    def names(self) -> tuple[str, ...]:
        return tuple(self._values)

    def as_dict(self) -> dict:
        return dict(self._values)

    def host_floats(self) -> dict[str, float]:
        """Every value as a Python float, through one device-to-host copy
        of the whole set (the one intentional sync)."""
        if not self._values:
            return {}
        vals = torch.stack([v.to(torch.float32)
                            for v in self._values.values()]).cpu().tolist()
        return dict(zip(self._values, vals))

    def __len__(self) -> int:
        return len(self._values)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._values[name]

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def __repr__(self) -> str:
        return f"MetricSet({list(self._values)})"


# ------------------------------------------------------------- norm helpers

def worker_norms(x: torch.Tensor, lead: int = 1) -> torch.Tensor:
    """The F-norm over everything after the ``lead`` leading dims."""
    x = x.to(torch.float32)
    return torch.sqrt(torch.sum(torch.square(x),
                                dim=tuple(range(lead, x.ndim))))


def worker_mean_norm(x: torch.Tensor, lead: int = 1) -> torch.Tensor:
    """Mean over the ``lead`` leading (worker) dims of the F-norm over
    everything else — the per-layer norm the paper plots per worker."""
    return torch.mean(worker_norms(x, lead))


def rel_error_of_norms(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``rel_error`` from the per-worker norms of its two operands."""
    return torch.mean(torch.where(d > 0, n / torch.where(d > 0, d, 1.0),
                                  0.0))


def rel_error(num: torch.Tensor, den: torch.Tensor,
              lead: int = 1) -> torch.Tensor:
    """Worker-mean of ‖num‖/‖den‖ per worker, 0 where ‖den‖ == 0."""
    return rel_error_of_norms(worker_norms(num, lead),
                              worker_norms(den, lead))


def orth_residual(d_b: torch.Tensor) -> torch.Tensor:
    """NS orthogonality residual of a bucket direction ``[B, m, n]``:
    mean over the batch of ‖G - I_k‖_F with G the gram over the smaller
    side (D Dᵀ for m <= n, Dᵀ D otherwise)."""
    d = d_b.to(torch.float32)
    m, n = d.shape[-2:]
    g = d @ d.mT if m <= n else d.mT @ d
    r = g - torch.eye(min(m, n), dtype=torch.float32, device=d.device)
    return torch.mean(torch.sqrt(torch.sum(torch.square(r), dim=(-2, -1))))


def leaf_names(params) -> tuple[str, ...]:
    """Stable ``/``-joined key-path name per leaf of ``params``, in the
    reference's leaf order — the <leaf> component of metric names."""
    from repro_torch.dist.layerwise import leaf_paths
    out = []
    for path in leaf_paths(params):
        parts = [re.sub(r"[^A-Za-z0-9_.+\-]", "-", str(p)) for p in path]
        out.append("/".join(parts) if parts else "param")
    return tuple(out)
