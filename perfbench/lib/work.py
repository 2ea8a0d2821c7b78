"""The yardstick's arithmetic: the card's peaks, the least work each
kernel call needs, and a model's FLOPs per token, all from the call's
arguments or the configuration's sizes, never from the program's own
counts (a change that rewrites a kernel would rewrite its count).

Each input byte is counted read once and each output byte written once;
where the work depends on the data (the lengths of a paged attention
call), what these inputs need is counted, not the most they could.
"""
from __future__ import annotations

import statistics

# NVIDIA's data sheet for the H100 SXM part, dense rates, at 700 W
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peaks for {kind!r}; have {sorted(PEAKS)}")
    return PEAKS[kind]


def least_seconds(flops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take: the larger of the operations
    at the bf16 tensor rate (the highest that applies) and the bytes at
    the memory bandwidth."""
    p = peaks(kind)
    return max(flops / p["bf16_flops"], nbytes / p["hbm_bytes"])


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def paged_attention_work(q, k_pages, lengths_host, k_rows: int) -> tuple:
    """(flops, bytes) of one paged attention call: q (b, [k,] hq, d); the
    pool's rows in its own dtype; row j of sequence b attends ``lengths[b]
    + j`` positions. Reads q and the K and V rows those positions need in
    the fast tier's dtype; writes the output (q's shape and dtype)."""
    hq, d = q.shape[-2], q.shape[-1]
    hkv = k_pages.shape[-2]
    elt = k_pages.element_size()
    positions = sum(sum(max(int(n) + j, 0) for j in range(k_rows))
                    for n in lengths_host)
    kv_rows = sum(max(int(n) + k_rows - 1, 0) for n in lengths_host)
    flops = 4.0 * hq * d * positions
    nbytes = 2 * _nbytes(q) + 2.0 * kv_rows * hkv * d * elt
    return flops, nbytes


def ssd_scan_work(x, b_mat, c_mat, dt) -> tuple:
    """(flops, bytes) of one SSD scan forward: the recurrence's 4 P N
    operations per head and token (the state's decay-and-add and its
    contraction with C); reads x, B, C, dt, writes y and the final state
    in fp32."""
    B, S, H, P = x.shape
    N = b_mat.shape[-1]
    flops = 4.0 * B * S * H * P * N
    nbytes = (_nbytes(x) + _nbytes(b_mat) + _nbytes(c_mat) + _nbytes(dt)
              + 4.0 * B * S * H * P + 4.0 * B * H * P * N)
    return flops, nbytes


def matmul_params(c: dict) -> int:
    """Parameters that a token multiplies through (the LM head included,
    the embedding lookup not), from a configuration file's sizes."""
    d, L = c["d_model"], c["num_layers"]
    n = d * c["vocab_size"]
    if c["family"] == "dense":
        hq, hkv, hd, f = (c["num_heads"], c["num_kv_heads"], c["head_dim"],
                          c["d_ff"])
        n += L * (2 * d * hq * hd + 2 * d * hkv * hd + 2 * d * f)
    elif c["family"] == "ssm":
        din = c["ssm_expand"] * d
        nh = din // c["ssm_head_dim"]
        g, ns = c["ssm_ngroups"], c["ssm_state"]
        n += L * (d * (2 * din + 2 * g * ns + nh) + din * d)
    else:
        raise ValueError(f"no FLOP formula for family {c['family']!r}")
    return n


def forward_flops(c: dict, tokens: int, context_sum: int = 0) -> float:
    """Model FLOPs of a forward over `tokens` tokens: 2 x parameters per
    token, plus attention's 4 hq hd per layer for each position a token
    attends (``context_sum`` summed over the tokens), plus the SSD
    recurrence's 4 H P N per layer and token."""
    flops = 2.0 * matmul_params(c) * tokens
    if c["family"] == "dense":
        flops += 4.0 * c["num_layers"] * c["num_heads"] * c["head_dim"] \
            * context_sum
    elif c["family"] == "ssm":
        din = c["ssm_expand"] * c["d_model"]
        flops += 4.0 * c["num_layers"] * din * c["ssm_state"] * tokens
    return flops


def p95(values) -> float | None:
    """The 95th percentile (inclusive method) of every value, or None
    for fewer than two."""
    values = list(values)
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def median(values) -> float | None:
    values = list(values)
    return statistics.median(values) if values else None
