"""RG-LRU recurrent block (Griffin / RecurrentGemma): prefill through the
`rglru_scan` kernel, and the one-token step form.

The port of ``repro/models/rglru.py``. Prefill runs the recurrence
``h_t = a_t h_{t-1} + b_t`` through ``api.run("rglru_scan", a, gated)``
where the reference runs a log-depth ``associative_scan``: the same
recurrence, summed in sequence order. `rglru_decode_core` is the
one-token step that the dense decode and the serve layer's fused paged
step share.

The bodies (`rglru_decode_core_tp`, `rglru_apply_tp`) are written for
the model axis of a mesh plan, under one controller: lists of per-shard
params and inputs, reduced through ``psum``. w_in / w_gate / conv split
the width by column like heads; the row-sharded gate matrices w_a / w_i
complete their full-width contraction with one reduction each, after
which each shard keeps its own gate columns; the row-sharded w_out
reduces the output. The unsharded `rglru_decode_core` and `rglru_apply`
are their one-shard case.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import api
from repro_torch.models.common import ParamSpec, as_seam, psum_one

C_EXP = 8.0          # Griffin's fixed gate exponent
CONV_TAPS = 4        # temporal conv width


def rglru_spec(cfg: ModelConfig):
    d, w = cfg.d_model, cfg.lru_width
    k = CONV_TAPS
    return {
        "w_in": ParamSpec((d, w), init="fan_in", logical=("embed", "lru")),
        "w_gate": ParamSpec((d, w), init="fan_in", logical=("embed", "lru")),
        "conv_w": ParamSpec((k, w), init="fan_in", logical=(None, "lru")),
        "conv_b": ParamSpec((w,), init="zeros", logical=("lru",)),
        "w_a": ParamSpec((w, w), init="fan_in", logical=("lru", "lru_out")),
        "b_a": ParamSpec((w,), init="zeros", dtype="float32",
                         logical=("lru",)),
        "w_i": ParamSpec((w, w), init="fan_in", logical=("lru", "lru_out")),
        "b_i": ParamSpec((w,), init="zeros", dtype="float32",
                         logical=("lru",)),
        "lam": ParamSpec((w,), init="lambda", dtype="float32",
                         logical=("lru",)),
        "w_out": ParamSpec((w, d), init="fan_in", logical=("lru", "embed")),
    }


def _conv1d(u, w, bias):
    """Causal depthwise conv from a zero history. u: (B, S, W)."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * w[i] for i in range(k))
    return out + bias


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default form


def _gates(ps, us, psum):
    """a and the gated input, fp32, of each shard's width-local u (B, S,
    W/tp) against its rows of w_a / w_i: one reduction completes each
    full-width pre-activation, then shard m keeps columns ``[m W/tp,
    (m + 1) W/tp)``. Returns the lists (a, gated)."""
    pre_a = psum([(u @ p["w_a"]).float() for p, u in zip(ps, us)])
    pre_i = psum([(u @ p["w_i"]).float() for p, u in zip(ps, us)])
    out_a, out_g = [], []
    for m, p, u, ra, ri in zip(psum.indices, ps, us, pre_a, pre_i):
        w_l = p["b_a"].shape[0]
        c0 = m * w_l
        r = torch.sigmoid(ra[..., c0:c0 + w_l] + p["b_a"])
        i = torch.sigmoid(ri[..., c0:c0 + w_l] + p["b_i"])
        log_a = C_EXP * r * F.logsigmoid(p["lam"])[None, None, :]
        a = torch.exp(log_a)
        beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-6,
                                      1.0))
        out_a.append(a)
        out_g.append(beta * i * u.float())
    return out_a, out_g


def rglru_decode_core_tp(cfg: ModelConfig, ps, xs, hs, convs, psum):
    """One-token RG-LRU step over a plan's model axis: ``ps``, ``xs`` (B,
    1, d), ``hs`` (B, W/tp) fp32 states and ``convs`` (B, K-1, W/tp)
    prior raw conv inputs hold one entry per model shard. Returns the
    lists ``(y (B, 1, d), new_h, new_conv)``, y reduced."""
    psum = as_seam(psum, len(ps))
    us, new_convs = [], []
    for p, x, conv in zip(ps, xs, convs):
        u_raw = x @ p["w_in"]
        window = torch.cat([conv.to(u_raw.dtype), u_raw], dim=1)
        u = torch.einsum("bkw,kw->bw", window, p["conv_w"]) + p["conv_b"]
        us.append(u[:, None, :])
        new_convs.append(window[:, 1:, :])
    a, gated = _gates(ps, us, psum)
    new_hs = [aa[:, 0] * h + gg[:, 0] for aa, gg, h in zip(a, gated, hs)]
    parts = [(h[:, None, :].to(x.dtype) * _gelu(x @ p["w_gate"]))
             @ p["w_out"] for p, x, h in zip(ps, xs, new_hs)]
    return psum.out(parts), new_hs, new_convs


def rglru_decode_core(cfg: ModelConfig, p, x, h, conv):
    """One-token RG-LRU step, `rglru_decode_core_tp` on one shard. x: (B,
    1, d); h: (B, W) fp32 state; conv: (B, K-1, W) prior raw conv inputs.
    Returns ``(y (B, 1, d), new_h, new_conv)``."""
    y, h, conv = rglru_decode_core_tp(cfg, [p], [x], [h], [conv], psum_one)
    return y[0], h[0], conv[0]


def rglru_apply_tp(cfg: ModelConfig, ps, xs, psum, *, mode: str,
                   caches=None, backend: str = "auto"):
    """`rglru_apply` over a plan's model axis: ``ps``, ``xs`` and
    ``caches`` hold one entry per model shard; a prefill or training
    forward scans each shard's W/tp columns through the `rglru_scan`
    kernel. Returns the lists ``(y, cache)``, y reduced. A plan whose model
    axis does not divide the width runs the whole layer on every shard
    (``psum`` then `Seam.local`)."""
    psum = as_seam(psum, len(ps))
    if psum.size > 1 and ps[0]["b_a"].shape[0] == cfg.lru_width:
        psum = psum.local()
    if mode == "decode":
        ys, hs, convs = rglru_decode_core_tp(
            cfg, ps, xs, [c["h"] for c in caches],
            [c["conv"] for c in caches], psum)
        for c, h, conv in zip(caches, hs, convs):
            c["h"], c["conv"] = h, conv
        return ys, caches
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r} not in ('prefill', 'decode', "
                         f"'train')")
    u_raws = [x @ p["w_in"] for p, x in zip(ps, xs)]
    us = [_conv1d(u, p["conv_w"], p["conv_b"]) for p, u in zip(ps, u_raws)]
    a, gated = _gates(ps, us, psum)
    parts, out_caches = [], []
    for p, x, u_raw, aa, gg in zip(ps, xs, u_raws, a, gated):
        hh = api.run("rglru_scan", aa.contiguous(), gg.contiguous(),
                     backend=backend)
        k = p["conv_w"].shape[0]
        out_caches.append({"h": hh[:, -1, :],
                           "conv": u_raw[:, -(k - 1):, :].float()}
                          if mode == "prefill" else None)
        parts.append((hh.to(x.dtype) * _gelu(x @ p["w_gate"])) @ p["w_out"])
    return psum.out(parts), out_caches


def rglru_apply(cfg: ModelConfig, p, x, *, mode: str, cache=None,
                backend: str = "auto"):
    """Returns (y, cache), cache = ``{"h": (B, W) fp32, "conv": (B, K-1,
    W) fp32}``. mode "prefill" runs the recurrence through the
    `rglru_scan` kernel (`backend` as in `kernels.api.run`); "train" does
    the same, differentiable through the kernel's autograd Function, and
    emits no cache; "decode" runs one token and updates `cache` in
    place. `rglru_apply_tp` on one shard."""
    ys, caches = rglru_apply_tp(cfg, [p], [x], psum_one, mode=mode,
                                caches=[cache], backend=backend)
    return ys[0], caches[0]
