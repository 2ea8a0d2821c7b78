"""Plain PyTorch version of blocked flash attention.

The function of the JAX package's Pallas kernel
(``repro/kernels/flash_attention/flash_attention.py``, `_flash_kernel`)
with its arithmetic: q is scaled in fp32, scores, probabilities and the
p @ V sum stay in fp32, masked scores are -1e30 and the normaliser is
clamped at 1e-30. Unlike the JAX package's jnp oracle it does not cast p
to the input dtype before p @ V, so on the card the CUDA kernel and this
version compute the same numbers up to the order of their sums. The
softmax is taken over the whole key range at once, which equals the
kernel's online softmax wherever a query row sees at least one key.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softmax_scale=None):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) -> (b, sq, hq, d) in q's
    dtype. Query head ``h`` attends kv head ``h // (hq // hkv)``; with
    ``causal`` key position ``kp`` is visible to query position ``qp``
    when ``kp <= qp``, with ``window`` when ``kp > qp - window``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d).float() * scale
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    s = torch.where(ok, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                     # (b, hkv, g, sq)
    acc = torch.einsum("bhgqs,bshd->bhgqd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
