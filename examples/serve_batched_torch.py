"""Serve a small model with batched requests: prefill once, decode many,
in PyTorch (the twin of ``serve_batched.py``).

Exercises the decode path (ring/KV/recurrent caches) on three different
architecture families. Runs on the card; ``--device cpu`` runs on the
CPU.

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models.api import build_model, make_batch
from repro_torch.train.serve import Server


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = {}
    for arch in ("granite-3-2b", "recurrentgemma-2b", "xlstm-1.3b"):
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params, _ = model.init(torch.Generator().manual_seed(0), args.device)
        server = Server(model)
        batch = make_batch(cfg, ShapeSpec("s", "prefill", 24, 4),
                           torch.Generator().manual_seed(1),
                           device=args.device)
        t0 = time.time()
        toks = server.generate(params, batch, max_new=args.max_new,
                               temperature=0.8,
                               generator=torch.Generator(
                                   device=args.device).manual_seed(2))
        dt = time.time() - t0
        print(f"{arch:20s} generated {tuple(toks.shape)} in {dt:5.2f}s "
              f"({toks.numel() / dt:6.1f} tok/s)   first row: "
              f"{' '.join(str(int(t)) for t in toks[0][:8])}")
        out[arch] = toks
    return out


if __name__ == "__main__":
    main()
