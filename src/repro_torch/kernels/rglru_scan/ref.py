"""Plain PyTorch version of the RG-LRU linear recurrence.

The JAX package's oracle (``repro/kernels/rglru_scan/ref.py``): the
sequential gated recurrence ``h_t = a_t h_{t-1} + b_t`` from a zero
state, a product then a sum per step, each rounded to fp32. The CUDA
kernel takes the same two roundings in the same order, so on the card
the two agree to the bit. The serving model prefills through it on the
CPU.
"""
from __future__ import annotations

import torch


def lru_scan(a, b):
    """a, b: (B, S, W). Returns h: (B, S, W) fp32 (h_0 = b_0)."""
    a, b = a.float(), b.float()
    h = torch.zeros(a.shape[0], a.shape[2], dtype=torch.float32,
                    device=a.device)
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
