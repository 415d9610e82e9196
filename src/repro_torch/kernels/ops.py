"""Newton-Schulz and Natural entry points over the kernel wrappers.

Port of ``repro/kernels/ops.py:62-223``. Both entry points normalise, pad each slice with zeros to the
kernels' tile (exact for NS: padded rows and columns stay zero through
X' = aX + (bA + cA^2)X), run ``steps`` iterations and slice back. Which
device runs them follows the tensor: the kernel wrappers take their
plain versions for CPU tensors and launch the CUDA kernels for CUDA
tensors.

Each iteration is one ``ns_iteration`` (upper-tile gram, then poly and
update, over a ``[B, m, m]`` gram + poly workspace). Two callers: the
spectral LMO (``core/lmo.py``) on the gradient's slices, and RankK
(``core/compressors.py``) on its transposed sketches ``[L, r, m]``. A stack whose
workspace would exceed ``NS_WORKSPACE_BUDGET`` runs in batch chunks that
fit; the slices are independent, so chunking changes no value.

The split over ranks (the reference's ``shard_map`` of the batched
chain): with a process group and a bucket's ``ns_bucket_pspec`` whose
batch dim lies on the group's axis, P ranks dividing B, rank r runs
only slices ``[r B/P, (r+1) B/P)`` through the same chain, and the
pieces are all-gathered in rank order. The same fact makes it exact:
each slice is iterated on its own; its norm, whose reduction order on
the card follows the stack's shape, is taken over the whole stack
(``newton_schulz_rows``). Where P does not
divide B every rank runs the whole stack: the reference's rule, not a
fallback.

``natural_compress`` / ``natural_decompress`` are Natural compression
over a batch of rows ``[*lead, n]``, one message per row: 8-bit exponent
codes plus a 1-bit sign bitmap, zero-padded to a whole byte *per row*
(9 bits per value on the wire), as the reference pads each slice.
``pack_bits`` packs the ragged sign rows itself, and ``natural_decode``
turns codes and packed signs into bf16 in one pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import gather_tensor, rank_of

from .bitpack import natural_decode, pack_bits
from .natural_pack import natural_encode
from .newton_schulz import (TILE, fused_matmul, ns_iteration,
                            ns_workspace_bytes, syrk_upper)
from .ref import NS_COEFFS

# Device bytes one ns_iteration may take for its gram + poly workspace.
# nanogpt-124m's largest bucket, [48, 768, 768], takes 226 MB.
NS_WORKSPACE_BUDGET = 1 << 30


def ns_batch_chunk(bsz: int, m: int) -> int:
    """Slices of a ``[bsz, m, *]`` stack that one ``ns_iteration`` takes
    within ``NS_WORKSPACE_BUDGET`` (at least one)."""
    return max(1, min(bsz, NS_WORKSPACE_BUDGET // ns_workspace_bytes(1, m)))


def _iterate(x: torch.Tensor, steps: int, coeffs) -> torch.Tensor:
    """``steps`` NS iterations over a normalised ``[B, m, n]`` stack."""
    bsz, m, n = x.shape
    pm, pn = (-m) % TILE, (-n) % TILE
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    parts = []
    for part in x.split(ns_batch_chunk(bsz, x.shape[1])):
        for _ in range(steps):
            part = ns_iteration(part, coeffs)
        parts.append(part)
    x = parts[0] if len(parts) == 1 else torch.cat(parts)
    return x[:, :m, :n]


def newton_schulz(g: torch.Tensor, steps: int = 5, coeffs=NS_COEFFS,
                  eps: float = 1e-7) -> torch.Tensor:
    """Orthogonalise a matrix ``g`` (approximate UV^T of its SVD),
    iterating on the transpose when rows > cols."""
    if g.ndim != 2:
        raise ValueError("newton_schulz expects 2-D input")
    transpose = g.shape[0] > g.shape[1]
    x = g.T if transpose else g
    x = x / (torch.linalg.norm(x.to(torch.float32)) + eps).to(x.dtype)
    x = _iterate(x.contiguous()[None], steps, coeffs)[0]
    return x.T if transpose else x


def split_rows(bsz: int, group=None, pspec=None,
               mesh=None) -> range | None:
    """The slices of a ``[bsz, m, n]`` stack this rank runs: its P-th
    where ``pspec`` puts the batch dim on the group's axis (``data``)
    and the group's P > 1 ranks divide ``bsz``; None (the whole stack on
    every rank) otherwise. A spec over another axis raises: a group is
    the worker axis only. Over a ``dist.sharding.RankMesh`` (``mesh``, in
    place of ``group``) the lead may be any axis of it or a composition in
    mesh order (``"pod"``, ``("pod", "data")``, ``("pod", "data",
    "model")``, ...), its index row-major (pod-major): what the
    reference's ``PartitionSpec`` of those axes lays out."""
    if pspec is None or pspec[0] is None:
        return None
    lead = pspec[0]
    if mesh is not None:
        return lead_rows(bsz, mesh.axis_size(lead), mesh.axis_index(lead))
    if group is None:
        return None
    if ((lead,) if isinstance(lead, str) else tuple(lead)) != ("data",):
        raise ValueError(f"bucket spec {pspec}: a group splits a stack "
                         "over its 'data' axis only")
    p = group.size()
    if p == 1 or bsz % p:
        return None
    return lead_rows(bsz, p, rank_of(group))


def newton_schulz_rows(g: torch.Tensor, rows: range | None = None,
                       steps: int = 5, coeffs=NS_COEFFS, eps: float = 1e-7
                       ) -> torch.Tensor:
    """The batched chain's output for slices ``rows`` of a ``[B, m, n]``
    stack (all of them for None): each slice's f32 Frobenius norm is
    taken over the whole stack, since a batched reduction's order on the
    card follows the stack's shape (the NS kernels' does not), so a
    rank's rows get the bits of the one-rank run's."""
    nrm = torch.sqrt(torch.sum(torch.square(g.to(torch.float32)),
                               dim=(-2, -1), keepdim=True))
    if rows is not None:
        g, nrm = g[rows.start:rows.stop], nrm[rows.start:rows.stop]
    x = g / (nrm + eps).to(g.dtype)
    return _iterate(x.contiguous(), steps, coeffs)


def newton_schulz_cols(g: torch.Tensor, sum_partials,
                      rows: range | None = None, steps: int = 5,
                      coeffs=NS_COEFFS, eps: float = 1e-7) -> torch.Tensor:
    """The batched chain over a ``[B, m, n]`` stack whose columns are cut
    over the ranks of a model subgroup (a bucket spec ``(·, None,
    'model')``): ``g`` is this rank's ``[B, m, n/M]`` columns and
    ``sum_partials`` sums an f32 tensor over the subgroup in rank order
    (every rank gets the same bits). Each slice's squared norm is summed
    over the ranks; each iteration runs ``syrk_upper`` on the rank's
    columns, sums the partial grams, runs the poly (``syrk_upper`` again)
    on the whole ``m x m`` gram and the update (``fused_matmul``) on the
    rank's columns, so a rank does 1/M of the gram's and the update's
    work. Returns this rank's columns of the chain's output for slices
    ``rows`` (all of them for None)."""
    sq = torch.sum(torch.square(g.to(torch.float32)), dim=(-2, -1),
                   keepdim=True)
    nrm = torch.sqrt(sum_partials(sq))
    if rows is not None:
        g, nrm = g[rows.start:rows.stop], nrm[rows.start:rows.stop]
    x = (g / (nrm + eps).to(g.dtype)).to(torch.float32)
    bsz, m, n = x.shape
    pm, pn = (-m) % TILE, (-n) % TILE
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    a, b, c = coeffs
    parts = []
    for part in x.split(ns_batch_chunk(bsz, x.shape[1])):
        part = part.contiguous()
        for _ in range(steps):
            gram = sum_partials(syrk_upper(part))
            poly = syrk_upper(gram, gram, alpha=b, beta=c)
            part = fused_matmul(poly, part, part, alpha=a, beta=1.0)
        parts.append(part)
    x = parts[0] if len(parts) == 1 else torch.cat(parts)
    return x[:, :m, :n]


def lead_rows(bsz: int, n: int, index: int) -> range | None:
    """Slices ``[index B/n, (index+1) B/n)`` of a ``[B, m, n]`` stack
    whose batch dim lies on an axis (or a composition of axes) of ``n``
    ranks, this rank at ``index``; None where ``n`` is 1 or does not
    divide B (every rank runs the whole stack, the reference's rule)."""
    if n == 1 or bsz % n:
        return None
    k = bsz // n
    return range(index * k, (index + 1) * k)


def newton_schulz_batched(g: torch.Tensor, steps: int = 5,
                          coeffs=NS_COEFFS, eps: float = 1e-7,
                          group=None, pspec=None, gather: bool = True
                          ) -> torch.Tensor:
    """Orthogonalise a ``[B, m, n]`` stack of independent slices (m <= n:
    callers canonicalise orientation before stacking), with per-slice
    f32 Frobenius normalisation. With ``group`` and ``pspec`` (a
    bucket's ``ns_bucket_pspec``) the rank runs its ``split_rows``
    (``newton_schulz_rows``) and all-gathers the pieces in rank order;
    ``gather=False`` returns its rows only, for a caller that gathers
    what it derives from them."""
    if g.ndim != 3:
        raise ValueError("newton_schulz_batched expects [B, m, n]")
    rows = split_rows(g.shape[0], group, pspec)
    x = newton_schulz_rows(g, rows, steps, coeffs, eps)
    if rows is None or not gather:
        return x
    return gather_tensor(x.contiguous(), group)


def natural_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Natural-compress ``[*lead, n]`` rows -> (codes uint8 ``[*lead, n]``,
    packed signs uint8 ``[*lead, ceil(n/8)]``)."""
    code, sign = natural_encode(x.contiguous())
    return code, pack_bits(sign)


def natural_decompress(code: torch.Tensor, packed_sign: torch.Tensor,
                       shape: tuple[int, ...],
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of ``natural_compress`` (bf16 powers of two), reshaped to
    ``shape`` and cast to ``dtype`` (no cast for bf16)."""
    return natural_decode(code, packed_sign).reshape(shape).to(dtype)
