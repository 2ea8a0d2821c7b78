"""Plain PyTorch starcoder2 forward (arXiv:2402.19173, HF
``bigcode/starcoder2-7b``), in fp32, over the weights `weights` makes.

Pre-norm decoder layers: grouped-query attention with q/k/v biases and
rotary embeddings on split halves, a tanh-GELU MLP of two products, each
sublayer added to the residual; a final norm and an untied LM head. The
departures from the published model, the ones the served program makes
too, are listed in the configuration file under ``departures``. The
weights' names and shapes are the served program's parameter layout
(the layer stack as the leading axis of each leaf), so that one set of
tensors feeds both sides.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import plain


def leaves(c: dict) -> dict:
    """``{name: (shape, init, scale, fp32)}`` of the weights."""
    L, d, hq, hkv, hd, f, v = (c["num_layers"], c["d_model"], c["num_heads"],
                               c["num_kv_heads"], c["head_dim"], c["d_ff"],
                               c["vocab_size"])
    vp = -(-v // 256) * 256
    g = "groups.l0."
    out = {
        "embed.tok": ((vp, d), "normal", 1.0, False),
        "embed.lm_head": ((d, vp), "normal", 1 / math.sqrt(d), False),
        "final_norm": ((d,), "normal", 0.1, True),
        g + "norm1": ((L, d), "normal", 0.1, True),
        g + "norm2": ((L, d), "normal", 0.1, True),
        g + "attn.wq": ((L, d, hq, hd), "normal", 1 / math.sqrt(d), False),
        g + "attn.wk": ((L, d, hkv, hd), "normal", 1 / math.sqrt(d), False),
        g + "attn.wv": ((L, d, hkv, hd), "normal", 1 / math.sqrt(d), False),
        g + "attn.wo": ((L, hq, hd, d), "normal", 1 / math.sqrt(hq * hd),
                        False),
        g + "mlp.up": ((L, d, f), "normal", 1 / math.sqrt(d), False),
        g + "mlp.down": ((L, f, d), "normal", 1 / math.sqrt(f), False),
    }
    if c["qkv_bias"]:
        out[g + "attn.bq"] = ((L, hq, hd), "normal", 0.02, False)
        out[g + "attn.bk"] = ((L, hkv, hd), "normal", 0.02, False)
        out[g + "attn.bv"] = ((L, hkv, hd), "normal", 0.02, False)
    return out


def weights(c: dict, seed: int, device) -> dict:
    return plain.make_weights(leaves(c), seed, device,
                              getattr(torch, c["dtype"]))


def rope(x, theta: float):
    """x (S, h, hd) rotated at positions 0..S-1, halves split."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v):
    """Causal grouped-query attention: q (S, hq, hd), k, v (S, hkv, hd)."""
    S, hq, hd = q.shape
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(mask, float("-inf")), -1)
    return torch.einsum("hqk,khd->qhd", p, v)


@torch.no_grad()
def sequence_logits(c: dict, w: dict, seqs: list, prec: str = "fp32"
                    ) -> list:
    """fp32 logits (S, vocab) at every position of each token sequence
    (1-D int tensors on the weights' device). Layer by layer, each
    layer's weights cast once for every sequence; ``prec`` "fp8" rounds
    both operands of every weight product to fp8 first (the control)."""
    plain.no_tf32()
    L, d = c["num_layers"], c["d_model"]
    hq, hkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    g = "groups.l0."
    xs = [w["embed.tok"][s.long()].float() for s in seqs]
    for i in range(L):
        wq, wk, wv, wo, up, down = (plain.weight(t, prec) for t in (
            w[g + "attn.wq"][i].reshape(d, hq * hd),
            w[g + "attn.wk"][i].reshape(d, hkv * hd),
            w[g + "attn.wv"][i].reshape(d, hkv * hd),
            w[g + "attn.wo"][i].reshape(hq * hd, d),
            w[g + "mlp.up"][i], w[g + "mlp.down"][i]))
        for j, x in enumerate(xs):
            S = x.shape[0]
            h = plain.rms_norm(x, w[g + "norm1"][i])
            q = plain.matmul(h, wq, prec).view(S, hq, hd)
            k = plain.matmul(h, wk, prec).view(S, hkv, hd)
            v = plain.matmul(h, wv, prec).view(S, hkv, hd)
            if g + "attn.bq" in w:
                q = q + w[g + "attn.bq"][i].float()
                k = k + w[g + "attn.bk"][i].float()
                v = v + w[g + "attn.bv"][i].float()
            q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
            y = attention(q, k, v).reshape(S, hq * hd)
            x = x + plain.matmul(y, wo, prec)
            h = plain.rms_norm(x, w[g + "norm2"][i])
            h = F.gelu(plain.matmul(h, up, prec), approximate="tanh")
            xs[j] = x + plain.matmul(h, down, prec)
        del wq, wk, wv, wo, up, down
    head = plain.weight(w["embed.lm_head"], prec)
    return [plain.matmul(plain.rms_norm(x, w["final_norm"]), head, prec)
            [:, :c["vocab_size"]] for x in xs]
