"""Tour of the non-Euclidean compressor zoo (paper §D), in PyTorch (the
twin of ``compressor_zoo.py``): empirical contraction factors alpha
w.r.t. different norms, wire cost, and the "LMO as compressor" view
(§D.1: the nuclear-norm sharp operator IS a Rank-1 compressor). Runs on
the card; ``--device cpu`` runs on the CPU.

    PYTHONPATH=src python examples/compressor_zoo_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.compressors import (ColumnTopK, Natural, RandomDropout,
                                          RankK, TopK, TopKSVD, WithNatural,
                                          empirical_alpha)
from repro_torch.core.lmo import sharp
from repro_torch.core.norms import norm


def main(argv=None) -> list[tuple]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, 48), generator=gen).to(args.device)

    print(f"{'compressor':22s} {'norm':10s} {'alpha_emp':>9s} {'bytes':>8s}")
    rows = []
    for comp, kind in [
            (TopK(0.1), "frobenius"),
            (TopKSVD(rank=4), "spectral"),
            (TopKSVD(rank=4), "nuclear"),
            (TopKSVD(rank=4), "frobenius"),
            (ColumnTopK(0.25), "col_l2_dual"),
            (Natural(), "frobenius"),
            (Natural(), "linf"),
            (RandomDropout(0.6), "frobenius"),
            (RankK(fraction=0.15), "frobenius"),
            (WithNatural(TopK(0.15)), "frobenius")]:
        a = empirical_alpha(comp, torch.Generator().manual_seed(0), x,
                            n_trials=args.trials, norm_kind=kind)
        b = comp.payload_bytes(tuple(x.shape), torch.bfloat16)
        rows.append((comp.name, kind, a, b))
        print(f"{comp.name:22s} {kind:10s} {a:9.3f} {b:8d}")

    # §D.1: the sharp operator of the nuclear norm is a Rank-1 compressor
    gs = sharp(x, "nuclear")
    res = float(norm(x - (-gs), "frobenius") / norm(x, "frobenius"))
    print(f"\nnuclear-norm sharp operator as compressor: "
          f"rank={int(torch.linalg.matrix_rank(-gs))} "
          f"frobenius residual {res:.3f} (alpha ~ 1/rank(X))")
    return rows


if __name__ == "__main__":
    main()
