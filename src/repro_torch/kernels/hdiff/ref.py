"""Plain PyTorch version of COSMO horizontal diffusion (thesis Ch. 3,
Algorithm 1): Laplacian -> flux-limited fluxes -> output.

Grid layout (nz, ny, nx); the halo is 2 cells in y and x, and the outer
2-cell ring of each plane passes through unchanged. The interior is the
slicing form of the JAX package's Pallas kernel (``_hdiff_kernel``),
which equals its oracle ``repro/kernels/hdiff/ref.py`` to the bit in
fp32: each operation rounds once, in the order written. The CUDA kernel
takes the same roundings in the same order, so on the card the two agree
to the bit. Any storage type is computed in fp32 and rounded once on the
way out.
"""
from __future__ import annotations

import torch

HALO = 2
COEFF = 0.025


def hdiff(src, coeff: float = COEFF):
    """src: (nz, ny, nx) -> (nz, ny, nx), independent per z-plane."""
    nz, ny, nx = src.shape
    out = src.clone()
    if ny <= 2 * HALO or nx <= 2 * HALO:
        return out                        # no interior
    p = src.float()

    def s(dy, dx):
        return p[:, 2 + dy:ny - 2 + dy, 2 + dx:nx - 2 + dx]

    def lap(dy, dx):
        return (4.0 * s(dy, dx)
                - (s(dy - 1, dx) + s(dy + 1, dx)
                   + s(dy, dx - 1) + s(dy, dx + 1)))

    lap_c = lap(0, 0)
    flx_c = lap(0, 1) - lap_c
    flx_c = torch.where(flx_c * (s(0, 1) - s(0, 0)) > 0, 0.0, flx_c)
    flx_m = lap_c - lap(0, -1)
    flx_m = torch.where(flx_m * (s(0, 0) - s(0, -1)) > 0, 0.0, flx_m)
    fly_c = lap(1, 0) - lap_c
    fly_c = torch.where(fly_c * (s(1, 0) - s(0, 0)) > 0, 0.0, fly_c)
    fly_m = lap_c - lap(-1, 0)
    fly_m = torch.where(fly_m * (s(0, 0) - s(-1, 0)) > 0, 0.0, fly_m)

    interior = s(0, 0) - coeff * ((flx_c - flx_m) + (fly_c - fly_m))
    out[:, HALO:ny - HALO, HALO:nx - HALO] = interior.to(src.dtype)
    return out
