"""Mamba2 SSD (state-space duality) mixer: prefill through the `ssd_scan`
kernel, and the one-token step form.

The port of ``repro/models/ssm.py`` at one device (tp = 1). Prefill runs
the sequence scan through ``api.run("ssd_scan", ...)``, which returns y
and the final state; the reference's chunked jnp form, `ssd_chunked`, is
the kernel's plain version (``kernels/ssd_scan/ref.py``), which the
wrapper runs on CPU tensors. `ssd_decode_core` is the one-token step that
the dense decode and the serve layer's fused paged step share.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import api
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: F401
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import rms_norm


def ssm_dims(cfg: ModelConfig):
    din = cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_head_dim
    conv_dim = din + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return din, nh, conv_dim


def ssm_spec(cfg: ModelConfig):
    d = cfg.d_model
    din, nh, conv_dim = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    return {
        "in_proj": ParamSpec((d, 2 * din + 2 * g * n + nh), init="fan_in"),
        "conv_w": ParamSpec((cfg.ssm_conv_width, conv_dim), init="fan_in"),
        "conv_b": ParamSpec((conv_dim,), init="zeros"),
        "dt_bias": ParamSpec((nh,), init="zeros", dtype="float32"),
        "a_log": ParamSpec((nh,), init="alog", dtype="float32"),
        "d_skip": ParamSpec((nh,), init="ones", dtype="float32"),
        "gate_norm": ParamSpec((din,), init="zeros", dtype="float32"),
        "out_proj": ParamSpec((din, d), init="fan_in"),
    }


def _split_proj(cfg: ModelConfig, proj):
    din, nh, _ = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    z = proj[..., :din]
    xbc = proj[..., din:din + din + 2 * g * n]
    dt = proj[..., -nh:]
    return z, xbc, dt


def _conv1d(xbc, w, bias):
    """Causal depthwise conv along seq. xbc: (B, S, C); w: (K, C)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return out + bias


def ssd_decode_core(cfg: ModelConfig, p, x, conv, state):
    """One-token SSD step. x: (B, 1, d); conv: (B, K-1, conv_dim) raw
    pre-conv inputs; state: (B, H, P, N) fp32. Returns ``(y (B, 1, d),
    new_conv, new_state)``."""
    din, nh, conv_dim = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    P = cfg.ssm_head_dim
    B = x.shape[0]
    proj = x @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    window = torch.cat([conv, xbc], dim=1)                # (B, K, C)
    xbc_t = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc_t = F.silu(xbc_t)[:, None, :]
    new_conv = window[:, 1:, :]

    a = -torch.exp(p["a_log"])
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    xs = xbc_t[..., :din].reshape(B, 1, nh, P)
    bm = xbc_t[..., din:din + g * n].reshape(B, 1, g, n)
    cm = xbc_t[..., din + g * n:].reshape(B, 1, g, n)
    da = torch.exp(dt[:, 0, :] * a)                       # (B, H)
    bm_h = bm[:, 0].repeat_interleave(nh // g, dim=1).float()
    cm_h = cm[:, 0].repeat_interleave(nh // g, dim=1).float()
    dbx = dt[:, 0, :, None, None] * bm_h[:, :, None, :] * \
        xs[:, 0, :, :, None].float()                      # (B, H, P, N)
    new_state = state * da[..., None, None] + dbx
    y = torch.einsum("bhpn,bhn->bhp", new_state, cm_h)
    y = y + p["d_skip"][None, :, None] * xs[:, 0].float()
    y = y.reshape(B, 1, din)
    y = y * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), p["gate_norm"])
    return y @ p["out_proj"], new_conv, new_state


def ssm_apply(cfg: ModelConfig, p, x, *, mode: str, cache=None,
              backend: str = "auto"):
    """Returns (y, cache), cache = ``{"conv": (B, K-1, C), "state": (B, H,
    P, N) fp32}``. mode "prefill" scans the sequence through the
    `ssd_scan` kernel (`backend` as in `kernels.api.run`); "train" does
    the same, differentiable through the kernel's autograd Function, and
    emits no cache; "decode" runs one token and updates `cache` in
    place."""
    if mode == "decode":
        y, cache["conv"], cache["state"] = ssd_decode_core(
            cfg, p, x, cache["conv"], cache["state"])
        return y, cache
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r} not in ('prefill', 'decode', "
                         f"'train')")
    if cfg.ssm_bf16_intra:
        raise NotImplementedError(
            f"{cfg.name}: ssm_bf16_intra is not ported — the ssd_scan "
            f"kernel keeps its intra-chunk scores in fp32")
    din, nh, conv_dim = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    P = cfg.ssm_head_dim
    B = x.shape[0]
    a = -torch.exp(p["a_log"])
    proj = x @ p["in_proj"]
    z, xbc_raw, dt = _split_proj(cfg, proj)
    dt = F.softplus(dt.float() + p["dt_bias"])
    xbc = F.silu(_conv1d(xbc_raw, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :din].reshape(B, -1, nh, P)
    bm = xbc[..., din:din + g * n].reshape(B, -1, g, n)
    cm = xbc[..., din + g * n:].reshape(B, -1, g, n)
    y, h_final = api.run("ssd_scan", xs.contiguous(), bm.contiguous(),
                         cm.contiguous(), dt.contiguous(), a.contiguous(),
                         backend=backend)
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(B, x.shape[1], din)
    k = cfg.ssm_conv_width
    cache = {"conv": xbc_raw[:, -(k - 1):, :], "state": h_final} \
        if mode == "prefill" else None
    y = y * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), p["gate_norm"])
    return y @ p["out_proj"], cache
