"""Plain PyTorch versions of the Mamba2 SSD scan.

`ssd` is the token-level recurrence of the JAX package's oracle
(``repro/kernels/ssd_scan/ref.py``)::

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t ;   y_t = h_t . C_t

`ssd_chunked` is the chunked parallel form of the JAX package's model
path (``repro/models/ssm.py``, `ssd_chunked`): within a chunk the scores
``(C_i . B_j) exp(cum_i - cum_j) dt_j`` (j <= i) weigh x, across chunks
the state carries ``exp(cum)`` decays; a sequence whose length the chunk
does not divide runs as one chunk, as there. The serving model prefills
through it on the CPU, and on the card `chip_smoke.py` holds the CUDA
kernel against it.

x: (B, S, H, P); b_mat, c_mat: (B, S, G, N); dt: (B, S, H) post-softplus;
a: (H,) negative. Both return fp32 ``(y (B, S, H, P), final state
(B, H, P, N))``. `ssd_chunked`'s ``bf16_intra`` is the reference's
rounding (the ``ssm_bf16_intra`` config): the intra-chunk scores and x
go to bf16 and their product accumulates in fp32; the cumsums, the
exponents and the states stay fp32.
"""
from __future__ import annotations

import torch

PLAIN_CHUNK = 256        # mamba2-780m's published ssm_chunk


def ssd(x, b_mat, c_mat, dt, a):
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    rep = H // G
    bh = b_mat.float().repeat_interleave(rep, dim=2)      # (B, S, H, N)
    ch = c_mat.float().repeat_interleave(rep, dim=2)
    xf, dtf, af = x.float(), dt.float(), a.float()
    h = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t] * af)                    # (B, H)
        h = h * da[..., None, None] + dtf[:, t, :, None, None] \
            * xf[:, t, :, :, None] * bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, ch[:, t]))
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, b_mat, c_mat, dt, a, chunk: int = PLAIN_CHUNK,
                bf16_intra: bool = False):
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    rep = H // G
    Q = min(chunk, S)
    if S % Q:
        Q = S
    nc = S // Q
    xc = x.reshape(B, nc, Q, H, P).float()
    bc = b_mat.reshape(B, nc, Q, G, N).float()
    cc = c_mat.reshape(B, nc, Q, G, N).float()
    dtc = dt.reshape(B, nc, Q, H).float()
    da = dtc * a.float()[None, None, None, :]              # (B, nc, Q, H)
    cum = torch.cumsum(da, dim=2)

    # intra-chunk: s[i, j, h] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i;
    # the exponent is masked before exp (i < j would overflow)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)       # (B, nc, G, Q, Q)
    cb = cb.repeat_interleave(rep, dim=2)                 # (B, nc, H, Q, Q)
    ii = torch.arange(Q, device=x.device)[:, None]
    jj = torch.arange(Q, device=x.device)[None, :]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    diff = torch.where((ii >= jj)[None, None, :, :, None], diff,
                       float("-inf"))
    decay = torch.exp(diff)
    dt_k = dtc.permute(0, 1, 3, 2)[:, :, :, None, :]       # (B, nc, H, 1, Q)
    s_mat = cb * decay.permute(0, 1, 4, 2, 3) * dt_k       # (B, nc, H, Q, Q)
    if bf16_intra:
        # bf16 x bf16 products are exact in fp32: the sum is fp32's
        y_intra = torch.einsum(
            "bchqk,bckhp->bcqhp", s_mat.to(torch.bfloat16).float(),
            xc.to(torch.bfloat16).float())
    else:
        y_intra = torch.einsum("bchqk,bckhp->bcqhp", s_mat, xc)

    # chunk-final states: sum_j exp(cum_last - cum_j) dt_j B_j x_j
    bc_h = bc.repeat_interleave(rep, dim=3)               # (B, nc, Q, H, N)
    dec_last = torch.exp(cum[:, :, -1:, :] - cum)         # (B, nc, Q, H)
    dtx = (dec_last * dtc)[..., None] * xc                # (B, nc, Q, H, P)
    states = torch.einsum("bcqhn,bcqhp->bchpn", bc_h, dtx)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B, nc, H)
    h = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                  # (B, nc, H, P, N)

    # inter-chunk contribution: C_i . (exp(cum_i) h_prev)
    c_rep = cc.repeat_interleave(rep, dim=3) if G != H else cc
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", c_rep, h_prev) \
        * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(B, S, H, P), h
