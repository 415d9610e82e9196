"""Quickstart: EF21-Muon in ~40 lines, in PyTorch (the twin of
``quickstart.py``).

Train a reduced Granite-3-2B on the synthetic corpus with 2 heterogeneous
workers, Top-10% + error feedback w2s compression, and a spectral-norm
LMO (= distributed compressed Muon). Runs on the card; ``--device cpu``
runs the kernels' plain versions on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.schedule import warmup_linear_decay
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.api import build_model
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("granite-3-2b").reduced()  # 2 layers, d=256
    trainer = Trainer(build_model(cfg), TrainerConfig(
        n_workers=2,          # EF21 workers (pods / DP groups at scale)
        beta=0.5,             # momentum: M <- (1-b) M + b grad
        w2s="top10",          # worker->server compressor (EF21)
        s2w="identity"),      # server->worker compressor (EF21-P off)
        device=args.device)

    data = SyntheticLM(cfg, ShapeSpec("q", "train", seq=64, batch=8),
                       n_workers=2, device=args.device)
    state = trainer.init(0)
    step = trainer.make_step()
    radius = warmup_linear_decay(0.01, warmup=5, total=args.steps)

    plan = trainer.layer_plan()
    wire = plan.w2s_bytes_per_worker(trainer.opt.cfg.wire_dtype)
    dense = plan.dense_bytes(trainer.opt.cfg.wire_dtype)
    print(f"w2s payload: {wire / 1e3:.0f} kB/worker/step "
          f"({wire / dense:.2%} of dense)")

    losses = []
    for i in range(args.steps):
        state, aux = step(state, data.batch_at(i), radius(i))
        losses.append(float(aux["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
