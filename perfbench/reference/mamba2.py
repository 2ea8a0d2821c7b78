"""Plain PyTorch Mamba2 forward and loss (arXiv:2405.21060, HF
``state-spaces/mamba2-780m``), in fp32, over the weights `weights` makes.

Each layer: RMSNorm, one input product to the gate z, the convolved
channels (x, B, C) and the step dt; a causal depthwise convolution of
width 4 and SiLU over x, B, C; the SSD state-space recurrence

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t ,   y_t = h_t . C_t

with a skip ``D x_t``; y gated by SiLU(z), RMS-normed over the inner
width and projected back into the residual. A final norm and an untied
LM head. The recurrence is computed by blocks of 64 steps, the block
decomposition of the paper's section 6: the same numbers as the
step-by-step loop, which under autograd at 2,048 steps and 48 layers
would keep terabytes of states (the tests hold it to the loop at a small
size). The weights' names and shapes are the trained program's parameter
layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import plain


def dims(c: dict):
    din = c["ssm_expand"] * c["d_model"]
    nh = din // c["ssm_head_dim"]
    gn = c["ssm_ngroups"] * c["ssm_state"]
    return din, nh, gn, din + 2 * gn


def leaves(c: dict) -> dict:
    """``{name: (shape, init, scale, fp32)}`` of the weights."""
    L, d, v = c["num_layers"], c["d_model"], c["vocab_size"]
    din, nh, gn, conv = dims(c)
    vp = -(-v // 256) * 256
    k = c["ssm_conv_width"]
    g = "groups.l0."
    return {
        "embed.tok": ((vp, d), "normal", 1.0, False),
        "embed.lm_head": ((d, vp), "normal", 1 / math.sqrt(d), False),
        "final_norm": ((d,), "normal", 0.1, True),
        g + "norm1": ((L, d), "normal", 0.1, True),
        g + "ssm.in_proj": ((L, d, 2 * din + 2 * gn + nh), "normal",
                            1 / math.sqrt(d), False),
        g + "ssm.conv_w": ((L, k, conv), "normal", 1 / math.sqrt(k), False),
        g + "ssm.conv_b": ((L, conv), "normal", 0.02, False),
        g + "ssm.dt_bias": ((L, nh), "dt_bias", 0.0, True),
        g + "ssm.a_log": ((L, nh), "alog", 0.0, True),
        g + "ssm.d_skip": ((L, nh), "ones", 0.0, True),
        g + "ssm.gate_norm": ((L, din), "normal", 0.1, True),
        g + "ssm.out_proj": ((L, din, d), "normal", 1 / math.sqrt(din),
                             False),
    }


def weights(c: dict, seed: int, device) -> dict:
    return plain.make_weights(leaves(c), seed, device,
                              getattr(torch, c["dtype"]))


def segsum(x):
    """(..., T) -> (..., T, T): entry [t, s] the sum of x over (s, t],
    -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd(x, bm, cm, dt, a, chunk: int = 64):
    """The recurrence over a batch: x (B, S, H, P), bm, cm (B, S, G, N),
    dt (B, S, H) after softplus, a (H,) negative; y (B, S, H, P) fp32.
    Computed by blocks of `chunk` steps (the state-space duality's block
    decomposition, arXiv:2405.21060 section 6): inside a block the
    masked products of C and B, across blocks the carried states."""
    B, S, H, P = x.shape
    Q = chunk if S % chunk == 0 else S
    nc = S // Q
    rep = H // bm.shape[2]
    bh = bm.float().repeat_interleave(rep, dim=2).reshape(B, nc, Q, H, -1)
    ch = cm.float().repeat_interleave(rep, dim=2).reshape(B, nc, Q, H, -1)
    xd = (x.float() * dt.float()[..., None]).reshape(B, nc, Q, H, P)
    da = (dt.float() * a.float()).reshape(B, nc, Q, H).permute(0, 3, 1, 2)
    cum = torch.cumsum(da, -1)                                   # b h c l
    y = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", ch, bh,
                     torch.exp(segsum(da)), xd)
    decay = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bh, decay, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    carry = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", ch, states,
                         torch.exp(cum))
    return y.reshape(B, S, H, P)


def layer(c: dict, p: dict, x, prec: str):
    """One Mamba2 layer over x (B, S, d) fp32; returns the new
    residual."""
    din, nh, gn, conv = dims(c)
    B, S = x.shape[:2]
    P = c["ssm_head_dim"]
    k = c["ssm_conv_width"]
    h = plain.rms_norm(x, p["norm1"])
    proj = plain.matmul(h, plain.weight(p["in_proj"], prec), prec)
    z, xbc, dt = (proj[..., :din], proj[..., din:din + conv],
                  proj[..., -nh:])
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    w = p["conv_w"].float()
    xbc = sum(pad[:, i:i + S] * w[i] for i in range(k)) \
        + p["conv_b"].float()
    xbc = F.silu(xbc)
    xs = xbc[..., :din].reshape(B, S, nh, P)
    g = c["ssm_ngroups"]
    bm = xbc[..., din:din + gn].reshape(B, S, g, -1)
    cm = xbc[..., din + gn:].reshape(B, S, g, -1)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    y = ssd(xs, bm, cm, dt, a) + p["d_skip"].float()[:, None] * xs
    y = y.reshape(B, S, din) * F.silu(z)
    y = plain.rms_norm(y, p["gate_norm"])
    return x + plain.matmul(y, plain.weight(p["out_proj"], prec), prec)


def layer_params(w: dict, i: int) -> dict:
    g = "groups.l0."
    return {"norm1": w[g + "norm1"][i],
            **{n: w[g + "ssm." + n][i] for n in
               ("in_proj", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip",
                "gate_norm", "out_proj")}}


def logits(c: dict, w: dict, tokens, prec: str = "fp32", remat=False):
    """fp32 logits (B, S, vocab) of a batch of sequences (B, S). With
    ``remat`` each layer is recomputed in the backward instead of
    kept."""
    x = w["embed.tok"][tokens.long()].float()
    for i in range(c["num_layers"]):
        p = layer_params(w, i)
        if remat:
            x = checkpoint(layer, c, p, x, prec, use_reentrant=False)
        else:
            x = layer(c, p, x, prec)
    x = plain.rms_norm(x, w["final_norm"])
    head = plain.weight(w["embed.lm_head"], prec)
    return plain.matmul(x, head, prec)[..., :c["vocab_size"]]


@torch.no_grad()
def sequence_logits(c: dict, w: dict, seqs: list, prec: str = "fp32"
                    ) -> list:
    """fp32 logits (S, vocab) at every position of each token sequence
    (1-D int tensors on the weights' device), one sequence at a time."""
    plain.no_tf32()
    return [logits(c, w, s[None], prec)[0] for s in seqs]


def loss_and_grads(c: dict, w: dict, tokens, labels, prec: str = "fp32"):
    """Mean cross-entropy over every position of the batch (tokens,
    labels (B, S)) and its gradient for every leaf of `w` (fp32 leaves
    with ``requires_grad``), each layer recomputed in the backward."""
    plain.no_tf32()
    lg = logits(c, w, tokens, prec, remat=True)
    loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.reshape(-1).long())
    del lg
    gs = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
    grads = {n: torch.zeros_like(t) if g is None else g
             for (n, t), g in zip(w.items(), gs)}
    return loss.item(), grads
