"""Attention: self-attention (GQA/MQA/MHA by num_kv_heads), global (ATTN)
and sliding-window (LOCAL_ATTN); the cross-attention of CROSS_ATTN
layers; and multi-head latent attention (MLA, MiniCPM3 / DeepSeek-V2
style).

Self-attention prefill attends through the flash-attention kernel
(``api.run("flash_attention", ...)``, with the layer's window).
`attention_core` is the plain masked-softmax attention of the JAX
package's ``repro/models/attention.py`` written as tensor ops (einsum +
fp32 softmax); it serves the dense-cache decode, where a sliding-window
layer keeps a ring buffer of the last ``window`` positions, and — as in
the reference, which runs them in jnp and no Pallas kernel — every
cross-attention and MLA product. The paged decode step attends through
the paged-attention kernel.
Query heads fold as (hkv, g): query head ``h`` attends kv head
``h // g``.

Over a plan's model axis (`models.transformer.mixer_apply_tp`) a shard
holds a block of query heads. When the axis divides the query heads but
not the kv heads, the shard holds every kv head and projects only those
its block maps to (`kv_block`, `select_kv`), as GSPMD computes the
reference's layout. `attn_decode_seq_tp` and `mla_decode_seq_tp` decode
over a cache whose positions split over the model shards: each shard
attends its positions and the partial softmax results combine by
log-sum-exp (`models.common.Seam.combine`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import api
from repro_torch.models.common import ParamSpec, as_seam
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


def attn_spec(cfg: ModelConfig, cross: bool = False):
    """Self-attention weights; a cross layer adds the tanh gates of its
    attention and MLP outputs (scalars, zero init) and the q/k norms of
    its cross branch."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, hq, hd), init="fan_in",
                        logical=("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, hkv, hd), init="fan_in",
                        logical=("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, hkv, hd), init="fan_in",
                        logical=("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((hq, hd, d), init="fan_in",
                        logical=("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((hq, hd), init="zeros",
                            logical=("heads", "head_dim"))
        s["bk"] = ParamSpec((hkv, hd), init="zeros",
                            logical=("kv_heads", "head_dim"))
        s["bv"] = ParamSpec((hkv, hd), init="zeros",
                            logical=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        s["q_norm"] = norm_spec(hd)
        s["k_norm"] = norm_spec(hd)
    if cross:
        s["gate_attn"] = ParamSpec((), init="zeros", dtype="float32",
                                 logical=())
        s["gate_ffn"] = ParamSpec((), init="zeros", dtype="float32",
                                logical=())
        s["q_norm_x"] = norm_spec(hd)
        s["k_norm_x"] = norm_spec(hd)
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


def cross_apply(p, x, *, mode: str, cache=None, cross_embeds=None):
    """The cross branch of a CROSS_ATTN layer: non-causal attention of the
    tokens over the image embeddings, tanh-gated. Prefill projects
    ``cross_embeds`` (b, n, d) into the ``{"xk", "xv"}`` cache; decode
    reads it; train projects them and emits no cache. No RoPE, no q/k/v
    bias. Returns (y, cache)."""
    q = rms_norm(_proj(x, p["wq"]), p["q_norm_x"])
    if mode == "decode":
        k, v = cache["xk"], cache["xv"]
    else:
        k = rms_norm(_proj(cross_embeds, p["wk"]), p["k_norm_x"])
        v = _proj(cross_embeds, p["wv"])
        cache = {"xk": k, "xv": v} if mode == "prefill" else None
    out = out_proj(p, attention_core(q, k, v, causal=False), x.dtype)
    return torch.tanh(p["gate_attn"]).to(out.dtype) * out, cache


def attn_apply(cfg: ModelConfig, p, x, *, mode: str, positions=None,
               cache=None, window: int = 0, backend: str = "auto",
               cross_embeds=None):
    """Returns (y, cache).

    mode: "prefill" (causal attention over the prompt, within `window`
    positions when it is set, through the flash-attention kernel,
    `backend` as in `kernels.api.run`; emit the (b, s, hkv, hd) cache) |
    "train" (the same attention, differentiable through the kernel's
    autograd Function; no cache) |
    "decode" (write the step's row into the cache IN PLACE at scalar
    position `positions` — slot ``pos % capacity`` of a sliding-window
    layer's ring buffer — then attend its valid rows with
    `attention_core`). As in the reference, a layer given
    ``cross_embeds``, or decoding over an ``"xk"`` cache, runs the cross
    branch (`cross_apply`) instead."""
    if cross_embeds is not None or (cache is not None and "xk" in cache):
        return cross_apply(p, x, mode=mode, cache=cache,
                           cross_embeds=cross_embeds)
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
    elif mode in ("prefill", "train"):
        q, k_new, v_new = roped_qkv(cfg, p, x, positions)
        k_new, v_new = k_new.contiguous(), v_new.contiguous()
        y = api.run("flash_attention", q.contiguous(), k_new, v_new,
                    causal=True, window=window, backend=backend)
        cache = {"k": k_new, "v": v_new} if mode == "prefill" else None
    else:
        raise ValueError(f"mode {mode!r} not in ('prefill', 'decode', "
                         f"'train')")
    return out_proj(p, y, x.dtype), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------
def mla_spec(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.num_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wdq": ParamSpec((d, qr), init="fan_in", logical=("embed", "q_lora")),
        "q_norm": norm_spec(qr),
        "wuq": ParamSpec((qr, h, nope + rope), init="fan_in",
                         logical=("q_lora", "heads", "head_dim")),
        "wdkv": ParamSpec((d, kr + rope), init="fan_in",
                          logical=("embed", "kv_lora")),
        "kv_norm": norm_spec(kr),
        "wuk": ParamSpec((kr, h, nope), init="fan_in",
                         logical=("kv_lora", "heads", "head_dim")),
        "wuv": ParamSpec((kr, h, vd), init="fan_in",
                         logical=("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((h, vd, d), init="fan_in",
                        logical=("heads", "head_dim", "embed")),
    }


def mla_apply(cfg: ModelConfig, p, x, *, mode: str, positions=None,
              cache=None):
    """Returns (y, cache). The cache is the compressed latent ``ckv`` (b,
    s, kv_lora_rank) and the roped shared key ``krope`` (b, s,
    qk_rope_dim). Prefill expands the latent into per-head keys (nope +
    rope) and values and attends causally with `attention_core` at scale
    1/sqrt(nope + rope); decode writes the step's row IN PLACE at scalar
    position `positions` and attends in the latent space (the absorbed
    form: q_nope through wuk scores against ckv, the context through
    wuv), fp32 scores; train attends as prefill and emits no cache."""
    b, s, _ = x.shape
    nope, rope, kr = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rope)

    q = _proj(rms_norm(x @ p["wdq"], p["q_norm"]), p["wuq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = x @ p["wdkv"]
    ckv_new = rms_norm(dkv[..., :kr], p["kv_norm"])
    krope_new = dkv[..., kr:]

    if mode == "decode":
        pos = int(positions)
        at = torch.full((b, s), pos, dtype=torch.int32, device=x.device)
        q_rope = apply_rope(q_rope, at, cfg.rope_theta)
        krope_new = apply_rope(krope_new[:, :, None, :], at,
                               cfg.rope_theta)[:, :, 0, :]
        ckv, krope = cache["ckv"], cache["krope"]
        ckv[:, pos:pos + s] = ckv_new.to(ckv.dtype)
        krope[:, pos:pos + s] = krope_new.to(krope.dtype)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"])
        scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
                  + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                 krope.float())) * scale
        k_pos = torch.arange(ckv.shape[1], device=x.device)
        scores = torch.where(k_pos <= pos, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        ctx_lat = torch.einsum("bhst,btr->bshr", w.to(ckv.dtype), ckv)
        y = torch.einsum("bshr,rhk->bshk", ctx_lat, p["wuv"])
    elif mode in ("prefill", "train"):
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        krope_r = apply_rope(krope_new[:, :, None, :], positions,
                             cfg.rope_theta)[:, :, 0, :]
        k_nope = _proj(ckv_new, p["wuk"])
        v = _proj(ckv_new, p["wuv"])
        k = torch.cat([k_nope, krope_r[:, :, None, :].expand(
            *k_nope.shape[:3], rope)], dim=-1)
        y = attention_core(torch.cat([q_nope, q_rope], dim=-1), k, v,
                           causal=True, softmax_scale=scale)
        cache = {"ckv": ckv_new, "krope": krope_r} \
            if mode == "prefill" else None
    else:
        raise ValueError(f"mode {mode!r} not in ('prefill', 'decode', "
                         f"'train')")
    return out_proj(p, y, x.dtype), cache


# ---------------------------------------------------------------------------
# Layouts of a plan's model axis
# ---------------------------------------------------------------------------
def kv_block(cfg: ModelConfig, tp: int, m: int):
    """The kv heads model shard `m` of `tp` reads when the axis divides the
    q heads and not the kv heads: a ``slice`` when its q block maps onto
    whole kv heads at one group size (qwen3-moe-30b-a3b at tp 8: one kv
    head a shard), else the list of each q head's kv head (a shard then
    attends with one q head a kv head). None when the kv heads split
    too, or do not need to."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if tp == 1 or hq % tp or hkv % tp == 0:
        return None
    qb, g = hq // tp, hq // hkv
    idx = [(m * qb + j) // g for j in range(qb)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if qb % n == 0 and idx == [lo + j // (qb // n) for j in range(qb)]:
        return slice(lo, lo + n)
    return idx


def select_kv(cfg: ModelConfig, p: dict, tp: int, m: int) -> dict:
    """Shard `m`'s attention params with `wk` / `wv` (and their biases)
    cut to its `kv_block` (views, or an index copy), as they are."""
    blk = kv_block(cfg, tp, m)
    if blk is None or p["wk"].shape[-2] != cfg.num_kv_heads:
        return p
    out = dict(p)
    for name, dim in (("wk", -2), ("wv", -2), ("bk", -2), ("bv", -2)):
        if name in p:
            t = p[name]
            if isinstance(blk, slice):
                out[name] = t.narrow(dim, blk.start, blk.stop - blk.start)
            else:
                out[name] = torch.index_select(
                    t, t.ndim + dim, torch.as_tensor(blk, device=t.device))
    return out


def _partial_softmax(s, ok, v_fn):
    """A block of masked fp32 scores `s` (..., keys): its max, normaliser
    and unnormalised output ``v_fn(p)``, as `attention_core` computes
    them over every key."""
    s = s + torch.where(ok, 0.0, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return m, p.sum(dim=-1, keepdim=True), v_fn(p)


def _seq_rows(cache_len: int, idx: int, pos: int, cap: int, valid: int,
              device):
    """(local row written at `pos`, or None; the valid mask of a shard's
    `cache_len` rows from global row ``idx * cache_len``): slot ``pos %
    cap``, rows below `valid`."""
    lo = idx * cache_len
    slot = pos % cap
    row = slot - lo if lo <= slot < lo + cache_len else None
    ok = (lo + torch.arange(cache_len, device=device)) < valid
    return row, ok


def attn_decode_seq_tp(cfg: ModelConfig, ps, xs, psum, *, pos: int,
                       caches, window: int = 0):
    """One decode step of self-attention over caches whose positions
    split over the model shards (the reference's layout when the model
    axis takes ``kv_seq``): every entry of ``caches`` holds all kv heads
    of its positions. The shard owning the step's slot writes its row;
    each attends every q head over its positions (the q blocks gathered
    when the heads split); the partials combine by log-sum-exp; each
    shard projects its head block out and the seam sums them (a whole
    projection on each shard when the heads do not split). Returns the
    lists (y, caches)."""
    psum = as_seam(psum, len(ps))
    hq = cfg.num_heads
    qs, news = [], []
    for p, x in zip(ps, xs):
        q, k_new, v_new = decode_qkv(cfg, p, x, pos)
        qs.append(q)
        news.append((k_new, v_new))
    split = qs[0].shape[2] < hq
    if split:
        qs = psum.gather(qs, dim=2)
    ms, ls, accs = [], [], []
    for idx, q, (k_new, v_new), c in zip(psum.indices, qs, news, caches):
        k, v = c["k"], c["v"]
        L = k.shape[1]
        cap = L * psum.size
        valid = min(pos + 1, cap) if window else pos + 1
        row, ok = _seq_rows(L, idx, pos, cap, valid, q.device)
        if row is not None:
            k[:, row:row + 1] = k_new.to(k.dtype)
            v[:, row:row + 1] = v_new.to(v.dtype)
        b, sq, _, dd = q.shape
        hkv = k.shape[2]
        g = hq // hkv
        scale = 1.0 / math.sqrt(dd)
        qg = (q.reshape(b, sq, hkv, g, dd) * scale).to(q.dtype)
        sc = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float())
        m, l, acc = _partial_softmax(
            sc, ok, lambda pr: torch.einsum("bhgqs,bshd->bhgqd",
                                            pr.to(v.dtype).float(),
                                            v.float()))
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    outs = psum.combine(ms, ls, accs)
    ys = []
    for idx, p, x, o in zip(psum.indices, ps, xs, outs):
        b, hkv, g, sq, dv = o.shape
        y = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv)
        if split:
            hl = p["wo"].shape[0]
            y = y[:, :, idx * hl:(idx + 1) * hl]
        ys.append(out_proj(p, y.to(caches[0]["v"].dtype), x.dtype))
    return (psum(ys) if split else ys), list(caches)


def mla_decode_seq_tp(cfg: ModelConfig, ps, xs, psum, *, pos: int, caches):
    """`attn_decode_seq_tp` for MLA: every shard computes the step's latent
    row (``wdkv`` whole), the owner writes it; the absorbed queries (its
    heads through ``wuk``) are gathered over the heads, each shard scores
    every head against its positions of ``ckv`` / ``krope``, the latent
    contexts combine by log-sum-exp, and each shard takes its heads'
    contexts through ``wuv`` and ``wo`` into the seam."""
    psum = as_seam(psum, len(ps))
    nope, rope, kr = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rope)
    h = cfg.num_heads
    lats, ropes, news = [], [], []
    for p, x in zip(ps, xs):
        b, s, _ = x.shape
        q = _proj(rms_norm(x @ p["wdq"], p["q_norm"]), p["wuq"])
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        dkv = x @ p["wdkv"]
        ckv_new = rms_norm(dkv[..., :kr], p["kv_norm"])
        at = torch.full((b, s), pos, dtype=torch.int32, device=x.device)
        q_rope = apply_rope(q_rope, at, cfg.rope_theta)
        krope_new = apply_rope(dkv[..., kr:][:, :, None, :], at,
                               cfg.rope_theta)[:, :, 0, :]
        lats.append(torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"]))
        ropes.append(q_rope)
        news.append((ckv_new, krope_new))
    split = lats[0].shape[2] < h
    if split:
        lats = psum.gather(lats, dim=2)
        ropes = psum.gather(ropes, dim=2)
    ms, ls, accs = [], [], []
    for idx, ql, qr, (ckv_new, krope_new), c in zip(
            psum.indices, lats, ropes, news, caches):
        ckv, krope = c["ckv"], c["krope"]
        L = ckv.shape[1]
        row, ok = _seq_rows(L, idx, pos, L * psum.size, pos + 1, ql.device)
        if row is not None:
            ckv[:, row:row + 1] = ckv_new.to(ckv.dtype)
            krope[:, row:row + 1] = krope_new.to(krope.dtype)
        sc = (torch.einsum("bshr,btr->bhst", ql.float(), ckv.float())
              + torch.einsum("bshk,btk->bhst", qr.float(),
                             krope.float())) * scale
        m, l, acc = _partial_softmax(
            sc, ok, lambda pr: torch.einsum("bhst,btr->bhsr",
                                            pr.to(ckv.dtype).float(),
                                            ckv.float()))
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    outs = psum.combine(ms, ls, accs)
    ys = []
    for idx, p, x, o, c in zip(psum.indices, ps, xs, outs, caches):
        ctx = o.permute(0, 2, 1, 3).to(c["ckv"].dtype)      # (b, s, h, r)
        if split:
            hl = p["wuv"].shape[1]
            ctx = ctx[:, :, idx * hl:(idx + 1) * hl]
        y = torch.einsum("bshr,rhk->bshk", ctx, p["wuv"])
        ys.append(out_proj(p, y, x.dtype))
    return (psum(ys) if split else ys), list(caches)
