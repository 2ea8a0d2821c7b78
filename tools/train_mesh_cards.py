#!/usr/bin/env python3
"""Training on a mesh with every plan position on a card of its own: the
``collectives`` and ``exact`` parts of ``chip_smoke.py``'s phase
``train`` part ``mesh``, alone, for a machine with four cards.

    python3 tools/train_mesh_cards.py | tee chiprun_out/<name>.log

`chip_smoke.serve_mesh` lays position i on cuda:i when the machine has a
card for each, so the plans' seams are NCCL all-reduces (`AllReduceSum`),
the FSDP gathers copy between cards and the replicated slices' gradients
meet in NCCL all-reduces: the same checks as on one card (losses, grad
norms and each leaf's update against the 1x1 trainer on cuda:0, every
per-shard launch held to its plain version forward and backward), over
distinct cards. Exits non-zero with fewer than four cards or on any
failed check.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if torch.cuda.device_count() < 4:
        print(f"train_mesh_cards: {torch.cuda.device_count()} CUDA devices, "
              f"want 4", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False    # plain fp32 is fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_device()["nvidia_smi"]
    cs.train_mesh_collectives(smi)
    launches = cs.train_mesh_exact(smi)
    cs.emit({"phase": "train_mesh_cards", "launches": launches, "ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
