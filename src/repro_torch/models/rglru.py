"""RG-LRU recurrent block (Griffin / RecurrentGemma): prefill through the
`rglru_scan` kernel, and the one-token step form.

The port of ``repro/models/rglru.py`` at one device (tp = 1). Prefill
runs the recurrence ``h_t = a_t h_{t-1} + b_t`` through
``api.run("rglru_scan", a, gated)`` where the reference runs a log-depth
``associative_scan``: the same recurrence, summed in sequence order.
`rglru_decode_core` is the one-token step that the dense decode and the
serve layer's fused paged step share.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import api
from repro_torch.models.common import ParamSpec

C_EXP = 8.0          # Griffin's fixed gate exponent
CONV_TAPS = 4        # temporal conv width


def rglru_spec(cfg: ModelConfig):
    d, w = cfg.d_model, cfg.lru_width
    k = CONV_TAPS
    return {
        "w_in": ParamSpec((d, w), init="fan_in"),
        "w_gate": ParamSpec((d, w), init="fan_in"),
        "conv_w": ParamSpec((k, w), init="fan_in"),
        "conv_b": ParamSpec((w,), init="zeros"),
        "w_a": ParamSpec((w, w), init="fan_in"),
        "b_a": ParamSpec((w,), init="zeros", dtype="float32"),
        "w_i": ParamSpec((w, w), init="fan_in"),
        "b_i": ParamSpec((w,), init="zeros", dtype="float32"),
        "lam": ParamSpec((w,), init="lambda", dtype="float32"),
        "w_out": ParamSpec((w, d), init="fan_in"),
    }


def _gates(p, u):
    """a (B, S, W) fp32 and the gated input (B, S, W) fp32."""
    r = torch.sigmoid((u @ p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid((u @ p["w_i"]).float() + p["b_i"])
    log_a = C_EXP * r * F.logsigmoid(p["lam"])[None, None, :]
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-6, 1.0))
    gated = beta * i * u.float()
    return a, gated


def _conv1d(u, w, bias):
    """Causal depthwise conv from a zero history. u: (B, S, W)."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * w[i] for i in range(k))
    return out + bias


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default form


def rglru_decode_core(cfg: ModelConfig, p, x, h, conv):
    """One-token RG-LRU step. x: (B, 1, d); h: (B, W) fp32 state; conv:
    (B, K-1, W) prior raw conv inputs. Returns ``(y (B, 1, d), new_h,
    new_conv)``."""
    u_raw = x @ p["w_in"]
    conv_window = torch.cat([conv.to(u_raw.dtype), u_raw], dim=1)
    u = torch.einsum("bkw,kw->bw", conv_window, p["conv_w"]) + p["conv_b"]
    a, gated = _gates(p, u[:, None, :])
    new_h = a[:, 0] * h + gated[:, 0]
    new_conv = conv_window[:, 1:, :]
    y = new_h[:, None, :].to(x.dtype) * _gelu(x @ p["w_gate"])
    return y @ p["w_out"], new_h, new_conv


def rglru_apply(cfg: ModelConfig, p, x, *, mode: str, cache=None,
                backend: str = "auto"):
    """Returns (y, cache), cache = ``{"h": (B, W) fp32, "conv": (B, K-1,
    W) fp32}``. mode "prefill" runs the recurrence through the
    `rglru_scan` kernel (`backend` as in `kernels.api.run`); "train" does
    the same, differentiable through the kernel's autograd Function, and
    emits no cache; "decode" runs one token and updates `cache` in
    place."""
    if mode == "decode":
        y, cache["h"], cache["conv"] = rglru_decode_core(
            cfg, p, x, cache["h"], cache["conv"])
        return y, cache
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r} not in ('prefill', 'decode', "
                         f"'train')")
    u_raw = x @ p["w_in"]
    u = _conv1d(u_raw, p["conv_w"], p["conv_b"])
    a, gated = _gates(p, u)
    hh = api.run("rglru_scan", a.contiguous(), gated.contiguous(),
                 backend=backend)
    k = p["conv_w"].shape[0]
    cache = {"h": hh[:, -1, :], "conv": u_raw[:, -(k - 1):, :].float()} \
        if mode == "prefill" else None
    y = hh.to(x.dtype) * _gelu(x @ p["w_gate"])
    return y @ p["w_out"], cache
