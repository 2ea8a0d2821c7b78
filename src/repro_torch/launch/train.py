"""Training launcher on the port: supervised (restartable) training of any
``--arch`` — the counterpart of the JAX package's
``repro/launch/train.py``, with its flags, plus ``--device`` (the card
unless ``--device cpu`` is given).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --steps 200 --seq 128 --batch 8 --smoke --device cpu

``--smoke`` uses the reduced config (CPU-runnable); without it the
published widths train on the card, seeded with seed 0.
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.ft.supervisor import Supervisor
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainJobConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    oc = OptimizerConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10),
                         total_steps=args.steps)
    job = TrainJobConfig(steps=args.steps, seq_len=args.seq,
                         global_batch=args.batch,
                         checkpoint_dir=args.checkpoint_dir,
                         num_microbatches=args.microbatches,
                         grad_compression=args.grad_compression)

    def make_loop():
        return Trainer(cfg, oc, job, device=args.device).run

    out = Supervisor(max_restarts=args.max_restarts).run(make_loop)
    print(f"done: final loss {out['final_metrics'].get('loss'):.4f} over "
          f"{args.steps} steps; stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
