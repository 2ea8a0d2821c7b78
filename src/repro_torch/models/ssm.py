"""Mamba2 SSD (state-space duality) mixer: prefill through the `ssd_scan`
kernel, and the one-token step form.

The port of ``repro/models/ssm.py``. Prefill runs the sequence scan
through ``api.run("ssd_scan", ...)``, which returns y and the final
state; the reference's chunked jnp form, `ssd_chunked`, is the kernel's
plain version (``kernels/ssd_scan/ref.py``), which the wrapper runs on
CPU tensors. `ssd_decode_core` is the one-token step that the dense
decode and the serve layer's fused paged step share.

The bodies (`ssd_decode_core_tp`, `ssm_apply_tp`) are written for the
model axis of a mesh plan (`serve.sharding.ServePlan`) under one
controller: they take each model shard's params and input as lists and
reduce through ``psum`` (a list of per-shard parts -> a list of sums).
The in/conv projections replicate and run at full width (the B / C
channels are shared by every head of a group); each shard keeps its
block of heads, the gate norm completes its mean square with one
reduction, and the row-sharded out projection with another. The
unsharded `ssd_decode_core` and `ssm_apply` are their one-shard case.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import api
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: F401
from repro_torch.models.common import ParamSpec, as_seam, psum_one


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
        "in_proj": ParamSpec((d, 2 * din + 2 * g * n + nh), init="fan_in",
                             logical=("embed", "ssm_proj")),
        "conv_w": ParamSpec((cfg.ssm_conv_width, conv_dim), init="fan_in",
                            logical=(None, "ssm_proj")),
        "conv_b": ParamSpec((conv_dim,), init="zeros", logical=("ssm_proj",)),
        "dt_bias": ParamSpec((nh,), init="zeros", dtype="float32",
                             logical=("ssm_heads",)),
        "a_log": ParamSpec((nh,), init="alog", dtype="float32",
                           logical=("ssm_heads",)),
        "d_skip": ParamSpec((nh,), init="ones", dtype="float32",
                            logical=("ssm_heads",)),
        "gate_norm": ParamSpec((din,), init="zeros", dtype="float32",
                               logical=("ssm_inner",)),
        "out_proj": ParamSpec((din, d), init="fan_in",
                              logical=("ssm_inner", "embed")),
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


def _head_block(p, m: int):
    """(first head, heads) of model shard `m`'s block."""
    nh_l = p["a_log"].shape[0]
    return m * nh_l, nh_l


def _group_block(cfg: ModelConfig, h0: int, nh_l: int):
    """(first group, groups) that a block of heads reads its B / C from:
    head h belongs to group ``h // (nh / ngroups)``."""
    _, nh, _ = ssm_dims(cfg)
    hpg = nh // cfg.ssm_ngroups
    return h0 // hpg, max(1, nh_l // hpg)


def _gate_norm(ps, ys, dtype, psum):
    """The gate `rms_norm` over the full inner width, each shard holding
    an equal block of it: the blocks' mean squares meet in one reduction
    and their mean is the full width's (one shard: `rms_norm` itself).
    Returns each shard's normed block in `dtype`."""
    y32 = [y.to(dtype).float() for y in ys]
    var = psum([torch.mean(y * y, dim=-1, keepdim=True) for y in y32])
    if psum.size > 1:
        var = [v / psum.size for v in var]
    return [((y * torch.rsqrt(v + 1e-6)) * (1.0 + p["gate_norm"].float()))
            .to(dtype) for p, y, v in zip(ps, y32, var)]


def ssd_decode_core_tp(cfg: ModelConfig, ps, xs, convs, states, psum):
    """One-token SSD step over a plan's model axis: ``ps``, ``xs`` (B, 1,
    d), ``convs`` (B, K-1, conv_dim) raw pre-conv inputs and ``states``
    (B, H/tp, P, N) fp32 hold one entry per model shard; ``psum`` reduces
    a list of parts. Returns the lists ``(y (B, 1, d), new_conv,
    new_state)``, y reduced."""
    psum = as_seam(psum, len(ps))
    din, nh, conv_dim = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    P = cfg.ssm_head_dim
    pre, new_convs, new_states = [], [], []
    for m, p, x, conv, state in zip(psum.indices, ps, xs, convs, states):
        B = x.shape[0]
        h0, nh_l = _head_block(p, m)
        proj = x @ p["in_proj"]
        z, xbc, dt_raw = _split_proj(cfg, proj)
        window = torch.cat([conv, xbc], dim=1)            # (B, K, C)
        xbc_t = torch.einsum("bkc,kc->bc", window, p["conv_w"]) \
            + p["conv_b"]
        xbc_t = F.silu(xbc_t)[:, None, :]
        new_convs.append(window[:, 1:, :])
        a = -torch.exp(p["a_log"])
        dt = F.softplus(dt_raw[..., h0:h0 + nh_l].float() + p["dt_bias"])
        xs_l = xbc_t[..., :din].reshape(B, 1, nh, P)[:, :, h0:h0 + nh_l]
        bm = xbc_t[..., din:din + g * n].reshape(B, 1, g, n)
        cm = xbc_t[..., din + g * n:].reshape(B, 1, g, n)
        da = torch.exp(dt[:, 0, :] * a)                   # (B, H/tp)
        bm_h = bm[:, 0].repeat_interleave(nh // g, dim=1)[:, h0:h0 + nh_l] \
            .float()
        cm_h = cm[:, 0].repeat_interleave(nh // g, dim=1)[:, h0:h0 + nh_l] \
            .float()
        dbx = dt[:, 0, :, None, None] * bm_h[:, :, None, :] * \
            xs_l[:, 0, :, :, None].float()                # (B, H/tp, P, N)
        new_state = state * da[..., None, None] + dbx
        new_states.append(new_state)
        y = torch.einsum("bhpn,bhn->bhp", new_state, cm_h)
        y = y + p["d_skip"][None, :, None] * xs_l[:, 0].float()
        y = y.reshape(B, 1, nh_l * P)
        pre.append(y * F.silu(z[..., h0 * P:(h0 + nh_l) * P].float()))
    normed = _gate_norm(ps, pre, xs[0].dtype, psum)
    ys = psum.out([y @ p["out_proj"] for p, y in zip(ps, normed)])
    return ys, new_convs, new_states


def ssd_decode_core(cfg: ModelConfig, p, x, conv, state):
    """One-token SSD step, `ssd_decode_core_tp` on one shard. x: (B, 1,
    d); conv: (B, K-1, conv_dim) raw pre-conv inputs; state: (B, H, P, N)
    fp32. Returns ``(y (B, 1, d), new_conv, new_state)``."""
    y, conv, state = ssd_decode_core_tp(cfg, [p], [x], [conv], [state],
                                        psum_one)
    return y[0], conv[0], state[0]


def ssm_apply_tp(cfg: ModelConfig, ps, xs, psum, *, mode: str, caches=None,
                 backend: str = "auto"):
    """`ssm_apply` over a plan's model axis: ``ps``, ``xs`` and
    ``caches`` hold one entry per model shard. A prefill or training
    forward scans each shard's block of heads through the `ssd_scan`
    kernel (at H / tp heads and the groups that block reads). Returns the
    lists ``(y, cache)``, y reduced; a shard's cache holds the full-width
    conv inputs (replicated) and its heads' state. A plan whose model axis
    does not divide the SSD heads runs the whole layer on every shard
    (``psum`` then `Seam.local`)."""
    psum = as_seam(psum, len(ps))
    if psum.size > 1 and ps[0]["a_log"].shape[0] == ssm_dims(cfg)[1]:
        psum = psum.local()
    if mode == "decode":
        ys, convs, sts = ssd_decode_core_tp(
            cfg, ps, xs, [c["conv"] for c in caches],
            [c["state"] for c in caches], psum)
        for c, conv, st in zip(caches, convs, sts):
            c["conv"], c["state"] = conv, st
        return ys, caches
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode {mode!r} not in ('prefill', 'decode', "
                         f"'train')")
    din, nh, conv_dim = ssm_dims(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    P = cfg.ssm_head_dim
    k = cfg.ssm_conv_width
    pre, out_caches = [], []
    for m, p, x in zip(psum.indices, ps, xs):
        B, S = x.shape[:2]
        h0, nh_l = _head_block(p, m)
        g0, g_l = _group_block(cfg, h0, nh_l)
        a = -torch.exp(p["a_log"])
        proj = x @ p["in_proj"]
        z, xbc_raw, dt = _split_proj(cfg, proj)
        dt = F.softplus(dt[..., h0:h0 + nh_l].float() + p["dt_bias"])
        xbc = F.silu(_conv1d(xbc_raw, p["conv_w"], p["conv_b"]))
        xs_l = xbc[..., :din].reshape(B, S, nh, P)[:, :, h0:h0 + nh_l]
        bm = xbc[..., din:din + g * n].reshape(B, S, g, n)[:, :, g0:g0 + g_l]
        cm = xbc[..., din + g * n:].reshape(B, S, g, n)[:, :, g0:g0 + g_l]
        y, h_final = api.run("ssd_scan", xs_l.contiguous(), bm.contiguous(),
                             cm.contiguous(), dt.contiguous(), a.contiguous(),
                             backend=backend,
                             bf16_intra=cfg.ssm_bf16_intra)
        y = y + p["d_skip"][None, None, :, None] * xs_l.float()
        y = y.reshape(B, S, nh_l * P)
        out_caches.append({"conv": xbc_raw[:, -(k - 1):, :],
                           "state": h_final} if mode == "prefill" else None)
        pre.append(y * F.silu(z[..., h0 * P:(h0 + nh_l) * P].float()))
    normed = _gate_norm(ps, pre, xs[0].dtype, psum)
    ys = psum.out([y @ p["out_proj"] for p, y in zip(ps, normed)])
    return ys, out_caches


def ssm_apply(cfg: ModelConfig, p, x, *, mode: str, cache=None,
              backend: str = "auto"):
    """Returns (y, cache), cache = ``{"conv": (B, K-1, C), "state": (B, H,
    P, N) fp32}``. mode "prefill" scans the sequence through the
    `ssd_scan` kernel (`backend` as in `kernels.api.run`); "train" does
    the same, differentiable through the kernel's autograd Function, and
    emits no cache; "decode" runs one token and updates `cache` in
    place. `ssm_apply_tp` on one shard."""
    ys, caches = ssm_apply_tp(cfg, [p], [x], psum_one, mode=mode,
                              caches=[cache], backend=backend)
    return ys[0], caches[0]
