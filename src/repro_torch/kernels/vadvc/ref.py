"""Plain PyTorch version of COSMO vertical advection (a Thomas
tridiagonal solve along z per (y, x) column).

Follows the gridtools ``vertical_advection_dycore`` u-stage benchmark the
thesis accelerates, in the order of the JAX oracle
``repro/kernels/vadvc/ref.py``: a forward sweep vectorised over the
horizontal plane with a Python loop over z, then the backward sweep. The
end levels take the oracle's rules (neighbour indices clamped; k = 0 has
no lower coefficient and only the upper correction, nz - 1 no upper
coefficient and only the lower correction), so nz = 1 and 2 work. Each
operation rounds once in the order written, and the CUDA kernel takes
the same roundings, so on the card the two agree to the bit.

Fields (nz, ny, nx); wcon staggered: (nz+1, ny, nx+1).
"""
from __future__ import annotations

import torch

DTR_STAGE = 3.0 / 20.0
BET_M = 0.5
BET_P = 0.5


def vadvc(ustage, upos, utens, utens_stage, wcon):
    nz = ustage.shape[0]
    ccols, dcols = [], []
    ccol_prev = dcol_prev = torch.zeros_like(ustage[0])
    for k in range(nz):
        first, last = k == 0, k == nz - 1
        gav = -0.25 * (wcon[k, :, 1:] + wcon[k, :, :-1])
        gcv = 0.25 * (wcon[k + 1, :, 1:] + wcon[k + 1, :, :-1])
        as_ = gav * BET_M
        cs = gcv * BET_M
        acol = gav * BET_P
        ccol = gcv * BET_P

        u_k = ustage[k]
        u_km1 = ustage[max(k - 1, 0)]
        u_kp1 = ustage[min(k + 1, nz - 1)]
        corr_lo = -as_ * (u_km1 - u_k)
        corr_hi = -cs * (u_kp1 - u_k)
        correction = corr_hi if first else (
            corr_lo if last else corr_lo + corr_hi)
        if first:
            acol = torch.zeros_like(acol)
        if last:
            ccol = torch.zeros_like(ccol)
        bcol = DTR_STAGE - acol - ccol

        dcol = DTR_STAGE * upos[k] + utens[k] + utens_stage[k] + correction
        divided = 1.0 / (bcol - ccol_prev * acol)
        ccol_prev = ccol * divided
        dcol_prev = (dcol - dcol_prev * acol) * divided
        ccols.append(ccol_prev)
        dcols.append(dcol_prev)

    out = torch.empty_like(ustage)
    data_next = torch.zeros_like(ustage[0])
    for k in range(nz - 1, -1, -1):
        datacol = dcols[k] - ccols[k] * data_next
        out[k] = DTR_STAGE * (datacol - upos[k])
        data_next = datacol
    return out
