"""End-to-end run (paper §5 analogue), in PyTorch (the twin of
``train_nanogpt_ef21.py``): train a reduced NanoGPT for a few hundred
steps with EF21-Muon under three compression settings and compare
loss-vs-wire-bytes — the small-scale version of Figure 1. Runs on the
card; ``--device cpu`` runs the kernels' plain versions on the CPU.

    PYTHONPATH=src python examples/train_nanogpt_ef21_torch.py \\
        [--steps 200] [--checkpoint PATH] [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.api import build_model
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("nanogpt-124m").reduced()
    model = build_model(cfg)
    data = SyntheticLM(cfg, ShapeSpec("n", "train", 64, 16), n_workers=4,
                       device=args.device)

    final = {}
    for w2s in ("identity", "top15+natural", "rank15+natural"):
        tr = Trainer(model, TrainerConfig(n_workers=4, beta=0.7, w2s=w2s),
                     device=args.device)
        state = tr.init(0)
        step = tr.make_step()
        sched = warmup_linear_decay(0.01, 10, args.steps, final_frac=0.3)
        wire = tr.layer_plan().w2s_bytes_per_worker(tr.opt.cfg.wire_dtype)
        loss = None
        for i in range(args.steps):
            state, aux = step(state, data.batch_at(i), sched(i))
            loss = float(aux["loss"])
            if i % 25 == 0:
                print(f"[{w2s:16s}] step {i:3d} loss {loss:.3f} "
                      f"(sent {wire * (i + 1) / 1e6:.1f} MB/worker)")
        print(f"[{w2s:16s}] FINAL loss {loss:.3f} after "
              f"{wire * args.steps / 1e6:.1f} MB/worker w2s traffic")
        final[w2s] = loss
        if args.checkpoint:
            save_checkpoint(f"{args.checkpoint}.{w2s}.npz", state,
                            args.steps)
    return final


if __name__ == "__main__":
    main()
