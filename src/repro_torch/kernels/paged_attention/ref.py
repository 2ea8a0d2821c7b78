"""Plain PyTorch version of paged decode attention.

The same function as the JAX package's oracle
(``repro/kernels/paged_attention/ref.py``): gather each sequence's pages
through its page table, dequantize them (fast pages carry float rows and
zeros in the int8 pool, slow pages the reverse, so ``pages + quant *
scale`` is exact either way), and run a masked fp32 softmax over the
valid positions of the decode token(s). The CPU tests run it; on the card
`chip_smoke.py` holds the CUDA kernel against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def dequantize_pool(pages, quant, scale):
    return pages.float() + quant.float() * scale.float()[..., None]


def paged_attention(q, k_pages, v_pages, k_quant, v_quant, k_scale, v_scale,
                    page_table, lengths, layer=None, *, softmax_scale=None):
    """q: (b, hq, d) single decode token or (b, k, hq, d) for k consecutive
    causal positions per sequence — row j is valid up to ``lengths[b] + j``
    KV positions; {k,v}_pages: (P, T, hkv, d) float; {k,v}_quant:
    (P, T, hkv, d) int8; {k,v}_scale: (P, T, hkv) float; page_table:
    (b, slots) int32; lengths: (b,) int32, row 0's valid length. Returns
    q's shape and dtype. Layer-stacked pools (L, P, T, hkv, d) take a
    ``layer`` index and reduce to the 4-D case."""
    if k_pages.ndim == 5:
        if layer is None:
            raise ValueError("layer-stacked pools need a layer index")
        lyr = int(layer)
        k_pages, v_pages, k_quant, v_quant, k_scale, v_scale = (
            a[lyr] for a in (k_pages, v_pages, k_quant, v_quant,
                             k_scale, v_scale))
    elif layer is not None:
        raise ValueError("layer index given but pools are not layer-stacked")
    multi = q.ndim == 4
    if not multi:
        q = q[:, None]
    b, kq, hq, d = q.shape
    _, t, hkv, _ = k_pages.shape
    slots = page_table.shape[1]
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)

    # gather first, then dequantize: (b, slots, T, hkv, d) -> (b, S, hkv, d)
    table = page_table.long()
    ks = dequantize_pool(k_pages[table], k_quant[table], k_scale[table]) \
        .reshape(b, slots * t, hkv, d)
    vs = dequantize_pool(v_pages[table], v_quant[table], v_scale[table]) \
        .reshape(b, slots * t, hkv, d)

    qg = q.reshape(b, kq, hkv, g, d).float() * scale
    s = torch.einsum("bkhgd,bshd->bhkgs", qg, ks)
    pos = torch.arange(slots * t, device=q.device)
    # query row j of a sequence is valid up to lengths + j positions
    limit = lengths.long()[:, None] + torch.arange(kq, device=q.device)[None]
    s = torch.where(pos < limit[:, None, :, None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhkgs,bshd->bkhgd", p, vs)
    out = out.reshape(b, kq, hq, d).to(q.dtype)
    return out if multi else out[:, 0]
