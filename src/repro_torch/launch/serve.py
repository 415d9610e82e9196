"""Serving CLI of the port (``repro.launch.serve``'s flags, PyTorch):
batched prefill + decode on a (reduced) model with random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduced --batch 4 --prompt-len 32 --max-new 16 --device cpu

Prints ``prefill_s=`` and ``decode_ms/token=`` on one line, then the
reference's line (``arch= batch= prompt= new= wall= (tok/s)``, with
``device=`` after it) and up to 4 rows of generated tokens. Weights come
from a generator seeded with ``--seed`` on the device, the prompt
(``make_batch``'s: tokens; Qwen2-VL's patch embeddings and M-RoPE ids;
Whisper's frames and tokens) from one seeded with 1, and ``--temperature
> 0`` samples from a generator seeded with ``--seed``. ``--device``
defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model, make_batch
from repro_torch.train.serve import Server


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    params, _ = model.init(gen(args.seed), dev)
    server = Server(model)
    batch = make_batch(cfg, ShapeSpec("p", "prefill", args.prompt_len,
                                      args.batch), gen(1), device=dev)
    t0 = time.time()
    toks = server.generate(params, batch, args.max_new,
                           temperature=args.temperature,
                           generator=gen(args.seed))
    dt = time.time() - t0
    tm = server.timings
    print(f"prefill_s={tm['prefill_s']:.4f} decode_ms/token="
          f"{1e3 * tm['decode_s'] / max(args.max_new, 1):.3f}")
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.max_new} wall={dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s) device={dev.type}")
    for row in toks[: min(4, toks.shape[0])].tolist():
        print("  ", " ".join(str(t) for t in row))
    return {"tokens": toks, "wall_s": dt, **tm}


if __name__ == "__main__":
    main()
