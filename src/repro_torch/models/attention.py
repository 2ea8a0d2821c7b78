"""Self-attention (GQA/MQA/MHA by num_kv_heads): global (ATTN) and
sliding-window (LOCAL_ATTN) layers.

Prefill attends through the flash-attention kernel
(``api.run("flash_attention", ...)``, with the layer's window).
`attention_core` is the plain masked-softmax attention of the JAX
package's ``repro/models/attention.py`` written as tensor ops (einsum +
fp32 softmax); it serves the dense-cache decode, where a sliding-window
layer keeps a ring buffer of the last ``window`` positions. The paged
decode step attends through the paged-attention kernel.
Query heads fold as (hkv, g): query head ``h`` attends kv head
``h // g``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import api
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import apply_rope, norm_spec, rms_norm

NEG_INF = -1e30


def attention_core(q, k, v, *, causal=True, window=0, q_offset=0,
                   kv_valid_len=None, softmax_scale=None):
    """q: (b, sq, hq, dd); k, v: (b, skv, hkv, dd). Returns (b, sq, hq, dd).

    Scores and softmax in fp32 over the whole key range at once: masked
    scores are -1e30 and the normaliser is clamped at 1e-30, as in the
    reference's online-softmax form."""
    b, sq, hq, dd = q.shape
    _, skv, hkv, dv = v.shape
    g = hq // hkv
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    qg = (q.reshape(b, sq, hkv, g, dd) * scale).to(q.dtype)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    ok = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if kv_valid_len is not None:
        ok &= k_pos[None, :] < kv_valid_len
    s = s + torch.where(ok, 0.0, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgqs,bshd->bhgqd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # (b, hkv, g, sq, dv) -> (b, sq, hq, dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(v.dtype)


def attn_spec(cfg: ModelConfig):
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, hq, hd), init="fan_in"),
        "wk": ParamSpec((d, hkv, hd), init="fan_in"),
        "wv": ParamSpec((d, hkv, hd), init="fan_in"),
        "wo": ParamSpec((hq, hd, d), init="fan_in"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((hq, hd), init="zeros")
        s["bk"] = ParamSpec((hkv, hd), init="zeros")
        s["bv"] = ParamSpec((hkv, hd), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = norm_spec(hd)
        s["k_norm"] = norm_spec(hd)
    return s


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _qkv(p, x):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def roped_qkv(cfg: ModelConfig, p, x, positions):
    """Project + (optional) qk-norm + rope at (b, s) `positions`."""
    q, k_new, v_new = _qkv(p, x)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k_new = rms_norm(k_new, p["k_norm"])
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k_new, positions, cfg.rope_theta), v_new)


def decode_qkv(cfg: ModelConfig, p, x, pos):
    """`roped_qkv` for decode token(s) at absolute position `pos`: a
    scalar shared by the batch, a (b,) tensor of per-sequence positions
    (continuous batching), or a (b, s) tensor with one position per
    token."""
    b, s, _ = x.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if pos.ndim == 0:
        positions = pos.expand(b, s)
    elif pos.ndim == 1:
        positions = pos[:, None].expand(b, s)
    else:
        positions = pos.expand(b, s)
    return roped_qkv(cfg, p, x, positions)


def out_proj(p, y, dtype):
    """einsum("bshk,hkd->bsd", y, wo) as one matmul (y: (..., hq, hd))."""
    h, k, d = p["wo"].shape
    return y.to(dtype).reshape(*y.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)


def attn_apply(cfg: ModelConfig, p, x, *, mode: str, positions=None,
               cache=None, window: int = 0, backend: str = "auto"):
    """Returns (y, cache).

    mode: "prefill" (causal attention over the prompt, within `window`
    positions when it is set, through the flash-attention kernel,
    `backend` as in `kernels.api.run`; emit the (b, s, hkv, hd) cache) |
    "decode" (write the step's row into the cache IN PLACE at scalar
    position `positions` — slot ``pos % capacity`` of a sliding-window
    layer's ring buffer — then attend its valid rows with
    `attention_core`)."""
    if mode == "decode":
        pos = int(positions)
        q, k_new, v_new = decode_qkv(cfg, p, x, pos)
        s = x.shape[1]
        if window:
            # ring buffer: RoPE is absolute, so slot order does not matter
            # under the mask
            cap = cache["k"].shape[1]
            slot = pos % cap
            cache["k"][:, slot:slot + s] = k_new.to(cache["k"].dtype)
            cache["v"][:, slot:slot + s] = v_new.to(cache["v"].dtype)
            y = attention_core(q, cache["k"], cache["v"], causal=False,
                               kv_valid_len=min(pos + 1, cap))
        else:
            cache["k"][:, pos:pos + s] = k_new.to(cache["k"].dtype)
            cache["v"][:, pos:pos + s] = v_new.to(cache["v"].dtype)
            y = attention_core(q, cache["k"], cache["v"], causal=False,
                               q_offset=pos, kv_valid_len=pos + 1)
    elif mode == "prefill":
        q, k_new, v_new = roped_qkv(cfg, p, x, positions)
        k_new, v_new = k_new.contiguous(), v_new.contiguous()
        y = api.run("flash_attention", q.contiguous(), k_new, v_new,
                    causal=True, window=window, backend=backend)
        cache = {"k": k_new, "v": v_new}
    else:
        raise ValueError(f"mode {mode!r} not in ('prefill', 'decode')")
    return out_proj(p, y, x.dtype), cache
