"""Quickstart: train a small LM for a few steps, checkpoint, resume, serve
— the port of the JAX package's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``params`` (a flat state dict, e.g. the JAX trainer's initial weights
carried by `repro_torch.convert.params_from_numpy`) replaces the weights
the trainer seeds.
"""
from __future__ import annotations

import tempfile

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.examples import check_device, parser, trainer
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import TrainJobConfig


def main(argv=None, *, params=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    check_device(args.device)
    cfg = smoke_config("codeqwen1.5-7b")
    print(f"arch={cfg.name} (reduced) d_model={cfg.d_model} "
          f"layers={cfg.num_layers}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        oc = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=40)
        job = TrainJobConfig(steps=40, seq_len=64, global_batch=8,
                             checkpoint_every=20, checkpoint_dir=ckpt_dir,
                             log_every=10)
        out = trainer(cfg, oc, job, args.device, params).run()
        h = out["history"]
        print(f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} "
              f"over {len(h)} steps")

        # serve with the trained weights
        trained = {n: p.detach() for n, p in out["state"]["params"].items()}
        eng = ServeEngine(cfg, params=trained, device=args.device)
        rng = np.random.default_rng(0)
        reqs = [Request(rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                        max_new_tokens=8) for _ in range(2)]
        outs = eng.generate(reqs)
        print("generated:", [o.tolist() for o in outs])
    return {"history": h, "losses": [x["loss"] for x in h],
            "params": trained, "prompts": [r.prompt for r in reqs],
            "generated": outs}


if __name__ == "__main__":
    main()
