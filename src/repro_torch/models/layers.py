"""Norms, RoPE, MLPs, embeddings.

Each function pins a reference semantic (``repro/models/layers.py``)
that differs from the PyTorch default: RMSNorm in fp32 scaling by
``1 + scale`` with eps 1e-6; RoPE rotating split halves in fp32; the
GELU MLP in its tanh form (``jax.nn.gelu``'s default); padded-vocab
logits masked to -1e30.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, torch_dtype

NEG_INF = -1e30


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def norm_spec(d: int) -> ParamSpec:
    # stored as delta around 1 (zeros init) in fp32
    return ParamSpec((d,), init="zeros", dtype="float32", logical=(None,))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    dim = x.shape[-1]
    inv = rope_freqs(dim, theta, x.device)                 # (dim/2,)
    ang = positions.float()[..., None] * inv               # (..., seq, dim/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or classic GELU)
# ---------------------------------------------------------------------------
def mlp_spec(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_gelu:
        return {"up": ParamSpec((d, f), init="fan_in",
                              logical=("embed", "ffn")),
                "down": ParamSpec((f, d), init="fan_in",
                                  logical=("ffn", "embed"))}
    return {"gate": ParamSpec((d, f), init="fan_in", logical=("embed", "ffn")),
            "up": ParamSpec((d, f), init="fan_in", logical=("embed", "ffn")),
            "down": ParamSpec((f, d), init="fan_in", logical=("ffn", "embed"))}


def mlp_apply(cfg: ModelConfig, p, x):
    if cfg.mlp_gelu:
        h = F.gelu(x @ p["up"], approximate="tanh")
    else:
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    return h @ p["down"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embed_spec(cfg: ModelConfig):
    """The LM head, and the token table unless the config takes external
    embeddings (musicgen's frame embeddings: no ``tok`` leaf)."""
    vp = cfg.padded_vocab_size
    out = {"lm_head": ParamSpec((cfg.d_model, vp), init="fan_in",
                                 logical=("embed", "vocab"))}
    if not cfg.external_embed:
        out["tok"] = ParamSpec((vp, cfg.d_model), logical=("vocab", "embed"))
    return out


def embed_apply(cfg: ModelConfig, p, tokens):
    # F.embedding, not p["tok"][tokens]: the same rows, and a backward
    # that sums repeated tokens in a fixed order (indexing's accumulates
    # with atomics on the CPU, so training would not resume to the bit)
    return F.embedding(tokens, p["tok"]).to(torch_dtype(cfg.compute_dtype))


def lm_head_apply(cfg: ModelConfig, p, x):
    logits = x @ p["lm_head"]
    if cfg.padded_vocab_size != cfg.vocab_size:   # mask padded vocab entries
        # one ``fill_`` on every device (an indexed assignment of a Python
        # scalar dispatches other ops on the card than on the CPU)
        logits[..., cfg.vocab_size:].fill_(NEG_INF)
    return logits
