"""Helpers the plain references share: seeded weights made on the device
in a few large draws, the fp32 arithmetic, and the lower precision that
the control computes in.

Nothing here imports the program: the references take their sizes from
``perfbench/configs/`` and their weights from `make_weights`, which the
benchmark hands to the program too.
"""
from __future__ import annotations

import math

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def no_tf32():
    """fp32 products in fp32: on this card a float32 matmul may otherwise
    run in TF32, a lower precision than the reference states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for draw `stream` of a seed: the same (seed, stream)
    gives the same numbers on the same device."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def make_weights(leaves: dict, seed: int, device, dtype) -> dict:
    """``{name: tensor}`` from ``{name: (shape, init, scale, fp32)}``:
    ``init`` "normal" (N(0, scale^2)), "zeros", "ones", "alog" (log of
    uniform [1, 16], mamba2's A), "dt_bias" (softplus^-1 of a log-uniform
    step in [1e-3, 1e-1], mamba2's). The normal leaves come from one draw
    in `dtype` (the served type), the fp32 ones from another, each leaf a
    view of its draw scaled in place."""
    gen = generator(seed, device, 0)
    groups = {False: [], True: []}
    for name, (shape, init, scale, fp32) in leaves.items():
        groups[fp32].append((name, shape, init, scale))
    out = {}
    for fp32, items in groups.items():
        dt = torch.float32 if fp32 else dtype
        sizes = [math.prod(shape) for _, shape, _, _ in items]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=dt)
        uni = torch.rand(sum(sizes), generator=gen, device=device,
                         dtype=torch.float32) if fp32 else None
        off = 0
        for (name, shape, init, scale), n in zip(items, sizes):
            t = flat[off:off + n].view(shape)
            if init == "normal":
                t.mul_(scale)
            elif init == "zeros":
                t.zero_()
            elif init == "ones":
                t.fill_(1.0)
            elif init == "alog":
                t.copy_(torch.log(1.0 + 15.0 * uni[off:off + n].view(shape)))
            elif init == "dt_bias":
                step = torch.exp(math.log(1e-3) + (math.log(1e-1)
                                 - math.log(1e-3)) * uni[off:off + n])
                t.copy_(torch.log(torch.expm1(step)).view(shape))
            else:
                raise ValueError(f"{name}: init {init!r}")
            out[name] = t
            off += n
    return out


def fp8_round(x, dim: int):
    """x rounded to float8 e4m3 with one scale per slice along `dim`
    (its absolute maximum maps to the format's largest value), returned
    in fp32. The gradient passes straight through the rounding, as in
    training with fp8 products."""
    x = x.float()
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(FP8).float() / scale
    return x + (q - x.detach())


def weight(w, prec: str):
    """A weight (in, out) as the products read it: fp32, or rounded to
    fp8 per output column for the control."""
    return fp8_round(w, 0) if prec == "fp8" else w.float()


def matmul(a, w, prec: str):
    """``a @ w`` in fp32 for a `weight`; the control rounds `a` to fp8
    per row first."""
    return (fp8_round(a, -1) if prec == "fp8" else a.float()) @ w


def rms_norm(x, delta, eps: float = 1e-6):
    """RMSNorm scaling by ``1 + delta`` (the weights store the scale as a
    delta around 1)."""
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + delta.float())
