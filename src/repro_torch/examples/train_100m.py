"""End to end: train a ~100M-parameter dense LM for a few hundred
steps with checkpointing + restart supervision — the port of the JAX
package's ``examples/train_100m.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_100m --device cpu \\
        --steps 2 --seq 16 --batch 2

The model is a scaled-down codeqwen (12 layers x 768, fp32, no remat):
135,313,152 parameters. Its fp32 checkpoint (params, m, v and the
master) is about 2.2 GB, written at every 100th step and again at the
end. ``params`` (a flat state dict) replaces the weights the trainer
seeds.
"""
from __future__ import annotations

import dataclasses
import logging
import tempfile

from repro_torch.configs import get_config
from repro_torch.examples import check_device, parser, trainer
from repro_torch.ft.supervisor import Supervisor
from repro_torch.models import Model
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import TrainJobConfig


def config():
    """~100M params: a scaled-down codeqwen (12 layers x 768)."""
    return dataclasses.replace(
        get_config("codeqwen1.5-7b"),
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=2048, vocab_size=32768,
        param_dtype="float32", compute_dtype="float32", remat="none")


def main(argv=None, *, params=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    check_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    cfg = config()
    n = Model(cfg, device="meta").param_count()
    print(f"model: {n / 1e6:.1f}M params")

    with tempfile.TemporaryDirectory() as d:
        oc = OptimizerConfig(lr=6e-4, warmup_steps=30,
                             total_steps=args.steps)
        job = TrainJobConfig(steps=args.steps, seq_len=args.seq,
                             global_batch=args.batch, checkpoint_every=100,
                             checkpoint_dir=d, log_every=20)

        def make_loop():
            return trainer(cfg, oc, job, args.device, params).run

        sup = Supervisor(max_restarts=3)
        out = sup.run(make_loop)
        h = out["history"]
        print(f"loss: {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} "
              f"({len(h)} steps, {sum(x['step_time_s'] for x in h):.0f}s)")
    return {"param_count": n, "history": h, "losses": [x["loss"] for x in h],
            "restarts": sup.restarts, "steps": args.steps, "seq": args.seq,
            "batch": args.batch}


if __name__ == "__main__":
    main()
