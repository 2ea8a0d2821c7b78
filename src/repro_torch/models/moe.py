"""Mixture-of-experts: top-k routing into per-expert capacity buckets and
three batched expert products — the port of ``repro/models/moe.py``.

Routing is per batch row, as in the reference, but batched over the rows
with tensor ops: no Python loop per row and no host sync (no boolean-mask
indexing, no ``.item()``), so the fused paged step runs it unchanged.
Buckets live as (e, b, cap, d), so each product is one ``torch.bmm``
over the expert stack in its stored (e, d, f) layout.

Pinned reference semantics:

- top-k: ``jax.lax.top_k`` puts the lower expert index first on a tie;
  a stable descending sort does the same (``torch.topk`` promises no
  order among ties);
- the sort of (token, slot) pairs by expert is stable and each pair's
  place in its expert's group comes from ``searchsorted(side="left")``;
- capacity is ``expert_capacity(cfg, s)`` for the call's own sequence
  length, so padded and phantom rows are routed and can take capacity;
- a dropped pair adds zeros into bucket (expert 0, slot 0) of its row
  (the reference's ``.at[...].add``): an accumulating ``index_put_``;
- the combine reads the bucket of each (token, slot) and weights it by
  ``keep * w`` cast to the activation dtype, summed over the k slots.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec


def moe_spec(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {"router": ParamSpec((d, e), init="fan_in", dtype="float32",
                             logical=("embed", None)),
         "up": ParamSpec((e, d, f), init="fan_in",
                         logical=("experts", "embed", "ffn")),
         "down": ParamSpec((e, f, d), init="fan_in",
                           logical=("experts", "ffn", "embed"))}
    if not cfg.mlp_gelu:
        s["gate"] = ParamSpec((e, d, f), init="fan_in",
                              logical=("experts", "embed", "ffn"))
    return s


def expert_capacity(cfg: ModelConfig, seq: int) -> int:
    cap = int(seq * cfg.top_k * cfg.moe_capacity_factor / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)   # round up to 8


def route(cfg: ModelConfig, router, x):
    """Top-k routing of x (b, s, d). Returns (probs (b, s, e) fp32,
    topw (b, s, k) fp32 normalised, topi (b, s, k) int64)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :cfg.top_k], topi[..., :cfg.top_k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


def dispatch(cfg: ModelConfig, topi, cap: int):
    """Each (token, slot) pair's place in its expert's bucket, per batch
    row. Returns (order (b, s*k): pairs sorted by expert, e_sorted, pos
    (place within the expert's group, sorted order), pos_tok (b, s, k):
    the same in token order)."""
    b, s, k = topi.shape
    flat_e = topi.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = torch.gather(flat_e, 1, order)
    experts = torch.arange(cfg.num_experts, device=topi.device)
    starts = torch.searchsorted(e_sorted, experts.expand(b, -1).contiguous(),
                                side="left")
    pos = torch.arange(s * k, device=topi.device) \
        - torch.gather(starts, 1, e_sorted)
    pos_tok = torch.empty_like(pos).scatter_(1, order, pos)
    return order, e_sorted, pos, pos_tok.reshape(b, s, k)


def balance_loss(cfg: ModelConfig, me, ce):
    """The Switch load-balancing loss ``e * sum_e me_e * ce_e / k`` of a
    layer's batch means: ``me`` the router probability of each expert,
    ``ce`` the tokens routed to it (fp32 scalar). A product of two means:
    over a plan's data shards the means meet first
    (`train.sharding`), then this."""
    return cfg.num_experts * torch.sum(me * ce / cfg.top_k)


def moe_apply(cfg: ModelConfig, p, x):
    """x: (b, s, d) -> (y, aux) with aux the Switch load-balancing loss
    (fp32 scalar): `moe_stats` and `balance_loss`."""
    y, me, ce = moe_stats(cfg, p, x)
    return y, balance_loss(cfg, me, ce)


def moe_stats(cfg: ModelConfig, p, x):
    """x: (b, s, d) -> (y, me, ce): the layer's output and the batch means
    of its load-balancing loss (`balance_loss`), each (e,) fp32."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = expert_capacity(cfg, s)
    probs, topw, topi = route(cfg, p["router"], x)

    # load-balance statistics (Switch): the mean router probability and
    # the mean routed-token count of each expert
    me = probs.mean(dim=(0, 1))
    # one-hot by comparison: `F.one_hot` checks its range on the host
    # (a sync) on the CPU and the card, and dispatches other ops there
    # than on ``meta``
    onehot = topi[..., None] == torch.arange(e, device=topi.device)
    ce = onehot.float().sum(2).mean(dim=(0, 1))

    order, e_sorted, pos, pos_tok = dispatch(cfg, topi, cap)
    keep = pos < cap
    rows = torch.arange(b, device=x.device)[:, None]
    src = x[rows, order // k]                              # (b, s*k, d)
    buckets = x.new_zeros((e, b, cap, d))
    buckets.index_put_(
        (torch.where(keep, e_sorted, 0), rows.expand(-1, s * k),
         torch.where(keep, pos, 0)),
        torch.where(keep[..., None], src, 0), accumulate=True)

    xb = buckets.view(e, b * cap, d)
    up = torch.bmm(xb, p["up"])
    if cfg.mlp_gelu:
        h = F.gelu(up, approximate="tanh")
    else:
        h = F.silu(torch.bmm(xb, p["gate"])) * up
    out_b = torch.bmm(h, p["down"]).view(e, b, cap, d)

    keep_tok = pos_tok < cap
    vals = out_b[topi, rows[:, :, None], torch.where(keep_tok, pos_tok, 0)]
    wk = (keep_tok.to(x.dtype) * topw.to(x.dtype))[..., None]
    return (vals * wk).sum(dim=2).to(x.dtype), me, ce
