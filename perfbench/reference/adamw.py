"""Plain AdamW with fp32 master weights (Loshchilov and Hutter,
arXiv:1711.05101) and the trained program's settings: the global
gradient norm clipped to ``grad_clip``, bias-corrected moments, weight
decay on the master decoupled from the moments, and a learning rate that
rises linearly over ``warmup_steps`` and then falls on a cosine to a
tenth by ``total_steps``. The settings come from the mix's file.
"""
from __future__ import annotations

import math

import torch


def lr_at(o: dict, step: int) -> float:
    if step < o["warmup_steps"]:
        return o["lr"] * (step + 1) / max(o["warmup_steps"], 1)
    t = min(max((step - o["warmup_steps"])
                / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    return o["lr"] * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


class AdamW:
    """One state per leaf: ``m``, ``v`` and the fp32 ``master``."""

    def __init__(self, master: dict, o: dict):
        self.o = o
        self.master = master
        self.m = {n: torch.zeros_like(t) for n, t in master.items()}
        self.v = {n: torch.zeros_like(t) for n, t in master.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, grads: dict) -> float:
        """Apply one step; returns the global gradient norm."""
        o = self.o
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                             for g in grads.values()))
        clip = min(1.0, o["grad_clip"] / max(norm, 1e-9))
        lr = lr_at(o, self.step)
        b1, b2 = o["beta1"], o["beta2"]
        c1 = 1 - b1 ** (self.step + 1)
        c2 = 1 - b2 ** (self.step + 1)
        for n, p in self.master.items():
            g = grads[n] * clip
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).add_(g * g, alpha=1 - b2)
            upd = (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + o["eps"])
            p.sub_(lr * (upd + o["weight_decay"] * p))
        self.step += 1
        return norm
