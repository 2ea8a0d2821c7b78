#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --only kernel   # or exact | serve | chunked |
                                          # spec | overload | hybrid |
                                          # stencil

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. device  — the card, ``nvidia-smi``'s name and power limit, versions.
   Builds the CUDA kernels from the sources in the checkout (into
   ``build/kernels/``) and prints what ``ptxas -v`` reported, per paged
   route with the dynamic shared memory its launch asks for, per scan
   kernel with the SSD wgmma route's chunk-scan shared memory.
2. kernel  — each kernel against its plain PyTorch version on its spec's
   cases (paged attention: flat and layer-stacked pools; bf16 inputs
   against the fp32 plain version, held to the spec's tolerance), then
   at starcoder2-7b's shapes with the same inputs on both sides, held per
   element to 2 ulps of |want| in the output dtype: paged attention at
   b=4, hq=36, hkv=4, d=128, T=128, L=32 (mixed fast/slow pages, one dead
   row) with 1, 4 and 128 query rows per sequence, each row checking the
   route it took (`route`: split, wgmma or simt) and timed by
   `device_ms` beside SDPA's; at k = 1 and 128 in bf16 three broken
   plain variants (K's float tier in one bf16 piece, the last split
   dropped, the int8 scale left off) must exceed the limit, and the
   kernel before the redesign (the simt route) and the new route run in
   10 alternating pairs; then edge shapes through the wgmma route (d =
   64, 128, 256, a ragged block of rows, length 1, a dead row, 16-token
   pages, bf16 pools) and the split route (g = 9 at lengths 1, 129, 384,
   a page, 16-token pages with bf16 pools). Flash
   attention:
   every spec case cast to bf16 and five edge shapes (sq != skv, one
   position, b=3 at d=256) through the route each takes (`route`: wgmma
   or simt), then b=1, s = 2048, 1000 (ragged) and 600, causal and
   not, and recurrentgemma-2b's local-attention prefill (the generate
   prefill's b=2, s = 2300, hq=10, hkv=1, d=256, window 2048), each row
   checking its route and timed by `device_ms` beside SDPA's; at s =
   2048 two broken plain variants (P rounded to bf16 once, the last
   128-key tile dropped) must exceed the limit, and at s = 2048 and at
   recurrentgemma's shape the kernel bf16 took before the redesign (the
   simt route) and the wgmma route run in 10 alternating pairs. The SSD
   scan (5 spec cases, on the simt route; five edge shapes on the wgmma
   route: S < the chunk, S = 1, G = 2, N = 64, B = 3 ragged; then
   mamba2-780m's B=1, S=2048, H=48, P=64, G=1, N=128 in bf16 (wgmma)
   and fp32 (simt), ragged S=1000 and the generate prefill's B=3,
   S=1536; y and the final state) and the RG-LRU scan (5 spec cases,
   serial at S = 1 and 4, chunked above; three edge shapes on the
   chunked route; then W=2560 at S=2048, ragged S=1000 and the generate
   prefill's B=2, S=2300), each row checking the route it took and
   timed by `device_ms`. The SSD scan chunks differently from its plain
   version, so it is held to a limit scaled by max |want| and sqrt(S)
   (`ssd_limit`), which deliberately broken loops must exceed: the simt
   route's 64-chunk loop (`ssd_chunk_loop`) without an inter-chunk term
   or the ragged chunk, the wgmma route's arithmetic (`ssd_wgmma_loop`)
   with a chunk left out of the state pass or the scores or w . x in
   one bf16 piece (h_prev in one piece is recorded: the limit does not
   reject it). The RG-LRU scan is held to 2 ulps, which the chunked
   loop with a dropped carry (`rglru_chunked_loop`) must exceed. At the
   generate prefills' shapes the kernel before the redesign (simt,
   serial) and the new route run in 10 alternating pairs. Times kernel,
   plain version and one PyTorch call (``scaled_dot_product_attention``;
   none computes either scan) in alternation within one run.
3. exact   — starcoder2-7b at full width, 2 layers, fp32, seeded weights:
   identical greedy tokens with the kernels and with the plain versions
   for ``generate``, monolithic ``serve``, the default chunked + radix
   ``serve`` and k = 4 speculative ``serve``; preempt / resume through
   ``ServeSession`` (one request parked mid chunk fill, one mid decode, a
   k = 4 speculative row mid decode) giving the never-preempted run's
   tokens; then mamba2-780m (2 layers) and recurrentgemma-2b (3 layers,
   one of each kind) at full width, fp32: identical tokens for
   ``generate``, the default ``serve`` and k = 4 ``serve``, and the
   reference's swap protocol (the sequence parked at decode step 6, its
   recurrent slot and ring pages restored) giving the uninterrupted
   stream.
4. serve   — the main path: starcoder2-7b, all 32 layers, bf16, seeded
   weights made on the card, a 128-token page pool with every other page
   in the int8 tier; ``serve`` 5 requests (prompts 120..600, 32 new
   tokens) with ``max_active=2`` and one prefill pass per prompt. Checks
   outputs, an empty pool, paged-attention launches == decode steps x
   layers, flash-attention launches == prefills x layers and 2 transfers
   per steady token, every flash launch on the wgmma route and every
   paged launch on the split route. Then 16 decode steps of the same
   model (2 rows, 500-token context) timed bare and under
   ``torch.profiler``: device busy share, kernels per step, the largest
   kernels.
5. chunked — the default ``serve`` path (chunked prefill + radix prefix
   cache) on 6 prompts sharing a 512-token head: prefix hit rate, chunk
   and decode step times, time to first token, an empty pool after
   ``close``, the chunk-fill (k = 128) steps' paged launches on the wgmma
   route and the others' on split; then 4 chunk-fill steps of 2 rows
   traced (the paged kernel's share of the device's busy time).
6. spec    — k = 4 speculative ``serve`` with n-gram drafts on the serve
   phase's prompts: accept rate, tokens per verify step; verify steps on
   the split route, chunk-fill steps on wgmma.
7. overload — the main path under load: the reference's ``overload``
   traffic mix (16 requests, three deadline classes, priorities 0 / 1)
   replayed open-loop through ``traffic.run_trace`` and the async front
   end over the serve phase's model, prompts 120-600 and 16-32 new
   tokens, arrivals at `ARRIVAL_X_SERVICE` times the serve phase's
   measured service rate, deadlines at `DEADLINE_X_STEP` times its decode
   step; the pool's invariants checked after every step
   (``REPRO_SERVE_DEBUG``). Checks every request's outcome, preemptions
   with swap traffic both ways, an empty pool, decode / verify launches
   on the split route and chunk fills on wgmma, 2 transfers per steady
   token; prints the latency summary (queue wait, TTFT, TPOT p50 / p99,
   SLO attainment) and the swap-out / swap-in ms (CUDA events). Then a
   ``REPRO_SERVE_FAULT=swap_fail:1`` pass (the victim ends as a
   ``swap_fail`` error, the rest finish) and one recurrentgemma-2b
   request at full depth parked and resumed.
8. hybrid  — the hybrid stacks at full depth, bf16, seeded weights:
   mamba2-780m ``generate`` (prompts 256/700/1536, 32 new tokens) and
   the default ``serve`` (3 prompts of 200-350 tokens), recurrentgemma-2b
   ``generate`` (prompts 2300 and 1000, 40 new tokens: a ring page drops
   during decode) and the default ``serve`` (3 short prompts). Checks
   SSD / RG-LRU / flash launches per prefill (SSD and flash on the wgmma
   route, RG-LRU on the chunked route), no scan launch from ``serve``
   (its prompts stream through the one-token cores, as in the
   reference), 2 transfers per steady token, no recurrent-store
   readback, live ring pages within ``ring_pages()``.
9. stencil — NERO's COSMO stencils, hdiff (routes tma and simt) and
   vadvc (prefetch and simt): every spec case and the edge grids of
   `STENCIL_EDGE_GRIDS` (ragged against every tile; rows not a multiple
   of 16 bytes, which hdiff sends to simt; vadvc's nz = 1, 2, 3) on each
   route the grid can take, at every tile of the tune space the route
   launches at, held to the plain version to the bit, the wrapper's route
   checked; at the COSMO grid (64 x 256 x 256; hdiff fp32 and bf16,
   vadvc fp32) the knee tile on the new route against the plain version
   to the bit and a deliberately broken variant (`hdiff_variant`,
   `vadvc_variant`) shown to differ; device times at every tile beside
   the Hopper cost model's estimate (inputs rotated through copies larger
   than L2), the plain version's time and the bound; the first port
   (simt; hdiff at PR 14's knee) against the new route in 10 alternating
   pairs; one launch's device time; then the main path,
   `weather_stencil.main` at the COSMO grid with the counts set to 0 just
   before it, every launch on the new routes, its hdiff sweep equal to
   the same sweep through the plain version on the card; then the same
   call once more under cProfile, its top host functions on a line of
   their own. `hdiff_tiled_loop` and `vadvc_prefetch_loop` restate the
   new routes' blocking in plain PyTorch for the CPU tests.

Then the ``kernels`` line and, last, ``{"ok": true, "device": ...}``.
Needs one CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "paged_attention": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:110"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:72"),
    "ssd_scan": (
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_scan.py:60"),
    "rglru_scan": (
        "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan/rglru_scan.py:37"),
    "hdiff": (
        "src/repro_torch/kernels/hdiff/csrc/hdiff.cu",
        "src/repro/kernels/hdiff/hdiff.py:49"),
    "vadvc": (
        "src/repro_torch/kernels/vadvc/csrc/vadvc.cu",
        "src/repro/kernels/vadvc/vadvc.py:83"),
}

# routes whose kernel lives in a header the library's source includes
ROUTE_SOURCES = {
    ("paged_attention", "split"):
        "src/repro_torch/kernels/paged_attention/csrc/paged_split.cuh",
    ("paged_attention", "simt"):
        "src/repro_torch/kernels/paged_attention/csrc/paged_simt.cuh",
    ("flash_attention", "simt"):
        "src/repro_torch/kernels/flash_attention/csrc/flash_simt.cuh",
    ("ssd_scan", "simt"):
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_simt.cuh",
    ("rglru_scan", "serial"):
        "src/repro_torch/kernels/rglru_scan/csrc/rglru_serial.cuh",
    ("hdiff", "simt"): "src/repro_torch/kernels/hdiff/csrc/hdiff_simt.cuh",
    ("vadvc", "simt"): "src/repro_torch/kernels/vadvc/csrc/vadvc_simt.cuh",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fns: dict, warmup: int = 5, rounds: int = 30) -> dict:
    """Time several functions in alternation: each round times every
    function once with CUDA events (the order rotating from round to
    round), so all of them see the same state of the card and the host.
    Returns, per name, the median event time and the median host time of
    the call alone (the time to enqueue its work; where it comes near the
    event time, the host's launches set the pace, not the device)."""
    names = list(fns)
    for _ in range(warmup):
        for name in names:
            fns[name]()
    torch.cuda.synchronize()
    dev = {n: [] for n in names}
    host = {n: [] for n in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fns[name]()
            host[name].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            dev[name].append(start.elapsed_time(end))
    return {n: (statistics.median(dev[n]), statistics.median(host[n]))
            for n in names}


def same_input_limit(want):
    """Per-element limit for a kernel and its plain version run on the
    same inputs: both compute in fp32 and differ only in the order of
    their sums and in the final rounding, so 2 ulps of |want| in the
    output dtype, plus 1e-6 for entries near 0."""
    mant = {torch.float32: 23, torch.bfloat16: 7}[want.dtype]
    a = want.float().abs().clamp_min(2.0 ** -126)
    return 2.0 * torch.exp2(torch.floor(torch.log2(a)) - mant) + 1e-6


SSD_LIMIT_RULE = ("per tensor (y, final state): 256 * 2^-23 * sqrt(S) * "
                  "max |want|")


def ssd_limit(want, s_len: int) -> float:
    """Limit for the SSD scan against its plain version on the same
    inputs, for one output tensor (y or the final state) of a sequence
    of `s_len` positions. Both compute in fp32, but the kernel chunks by
    64 positions and the plain version by 256 (or the whole sequence when
    256 does not divide it): the sums and the state carry run in other
    orders, and the error grows with the magnitudes summed and about
    with sqrt(S). A correct 64-chunk loop (`ssd_chunk_loop`) stays within
    1/16 of this limit on the CPU at the spec's cases and at S = 300,
    1000, 2048; one that drops a chunk's inter-chunk term or skips the
    ragged last chunk exceeds it 50-fold or more."""
    scale = max(want.float().abs().max().item(), 2.0 ** -126)
    return 256.0 * 2.0 ** -23 * s_len ** 0.5 * scale


def ssd_chunk_loop(x, b_mat, c_mat, dt, a, fault=None):
    """The ssd_scan kernel's algorithm in plain PyTorch: chunks of 64
    positions, the last one ragged, the state carried chunk to chunk.
    ``fault`` breaks it on purpose, to show that `ssd_limit` catches
    such a kernel: "drop_inter" drops chunk 1's inter-chunk term C
    exp(cum) @ state, "skip_ragged" skips a ragged last chunk (its y
    stays 0, the state is not updated)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import CHUNK
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    rep = H // G
    xf, dtf, af = x.float(), dt.float(), a.float()
    bh = b_mat.float().repeat_interleave(rep, 2)
    ch = c_mat.float().repeat_interleave(rep, 2)
    state = torch.zeros(B, H, P, N, device=x.device)
    y = torch.zeros(B, S, H, P, device=x.device)
    for ci, c0 in enumerate(range(0, S, CHUNK)):
        q = min(CHUNK, S - c0)
        if fault == "skip_ragged" and q < CHUNK:
            break
        dtc = dtf[:, c0:c0 + q]
        cum = torch.cumsum(dtc * af, dim=1)                  # (B, q, H)
        xc, bc, cc = xf[:, c0:c0 + q], bh[:, c0:c0 + q], ch[:, c0:c0 + q]
        ii = torch.arange(q, device=x.device)[:, None]
        jj = torch.arange(q, device=x.device)[None, :]
        diff = torch.where((ii >= jj)[None, :, :, None],
                           cum[:, :, None, :] - cum[:, None, :, :],
                           float("-inf"))
        s = torch.einsum("bihn,bjhn->bhij", cc, bc) \
            * torch.exp(diff).permute(0, 3, 1, 2) \
            * dtc.permute(0, 2, 1)[:, :, None, :]
        inter = torch.einsum("bihn,bhpn->bihp", cc, state) \
            * torch.exp(cum)[..., None]
        if fault == "drop_inter" and ci == 1:
            inter = torch.zeros_like(inter)
        y[:, c0:c0 + q] = torch.einsum("bhij,bjhp->bihp", s, xc) + inter
        w = torch.exp(cum[:, -1:] - cum) * dtc
        state = state * torch.exp(cum[:, -1])[..., None, None] \
            + torch.einsum("bjhn,bjhp->bhpn", bc, xc * w[..., None])
    return y, state


def over_ssd_limit(got, want) -> float:
    """max over y and the final state of max |got - want| / `ssd_limit`."""
    s_len = want[0].shape[1]
    return max((g.float() - w.float()).abs().max().item()
               / ssd_limit(w, s_len) for g, w in zip(got, want))


def bf16_pieces(t, n: int):
    """fp32 `t` as n bf16 pieces (returned as fp32 tensors): each the bf16
    rounding of what the pieces before it left, as the kernels'
    `split_pieces` cuts an operand for the tensor cores."""
    out, rest = [], t.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def ssd_wgmma_loop(x, b_mat, c_mat, dt, a, *, chunk=None, pieces=None,
                   score_pieces=None, wx_pieces=None, state_pieces=None,
                   fault=None):
    """The ssd_scan kernel's wgmma route in plain PyTorch: chunks of
    `chunk` positions (the last one short), all chunks at once; the chunk
    states (w . x)^T B with w . x in `wx_pieces` bf16 pieces; the state
    pass over the chunks in fp32; y = exp(cum_i) C_i . h_prev (h_prev in
    `state_pieces` pieces) + s . x, the scores s in `score_pieces` pieces.
    Each product of pieces is exact in fp32 (bf16 x bf16), as on the
    tensor cores; x, B and C are taken as given (bf16 on the route).
    Unset piece counts are `pieces`, by default the route's. ``fault``
    breaks it on purpose, in the design's own way: "skip_state_chunk"
    leaves chunk 1's state out of the state pass, "one_piece_state" takes
    h_prev in one bf16 piece."""
    from repro_torch.kernels.ssd_scan.ssd_scan import WGMMA_CHUNK, \
        WGMMA_PIECES
    Q = chunk or WGMMA_CHUNK
    pieces = pieces or WGMMA_PIECES
    score_pieces = score_pieces or pieces
    wx_pieces = wx_pieces or pieces
    state_pieces = 1 if fault == "one_piece_state" else \
        (state_pieces or pieces)
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    rep = H // G
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):
        t = t.float()
        t = torch.cat([t, t.new_zeros((B, pad) + t.shape[2:])], dim=1)
        return t.reshape((B, nc, Q) + t.shape[2:])

    xc, bc, cc, dtc = chunks(x), chunks(b_mat), chunks(c_mat), chunks(dt)
    bh = bc.repeat_interleave(rep, dim=3)                 # (B, nc, Q, H, N)
    ch = cc.repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dtc * a.float(), dim=2)            # (B, nc, Q, H)
    last = cum[:, :, -1:]
    # 1. chunk states
    wx = (torch.exp(last - cum) * dtc)[..., None] * xc    # (B, nc, Q, H, P)
    states = sum(torch.einsum("bcqhp,bcqhn->bchpn", piece, bh)
                 for piece in bf16_pieces(wx, wx_pieces))
    # 2. state pass
    decay = torch.exp(last[:, :, 0])                      # (B, nc, H)
    h = torch.zeros(B, H, P, N, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        add = 0.0 if fault == "skip_state_chunk" and c == 1 else states[:, c]
        h = h * decay[:, c, :, None, None] + add
    h_prev = torch.stack(h_prev, dim=1)                   # (B, nc, H, P, N)
    # 3. chunk scan
    inter = sum(torch.einsum("bcqhn,bchpn->bcqhp", ch, piece)
                for piece in bf16_pieces(h_prev, state_pieces))
    y = inter * torch.exp(cum)[..., None]
    cb = torch.einsum("bcihn,bcjhn->bchij", ch, bh)
    ii = torch.arange(Q, device=x.device)[:, None]
    jj = torch.arange(Q, device=x.device)[None, :]
    diff = torch.where((ii >= jj)[None, None, None],
                       cum.permute(0, 1, 3, 2)[..., :, None]
                       - cum.permute(0, 1, 3, 2)[..., None, :],
                       float("-inf"))
    s = cb * torch.exp(diff) * dtc.permute(0, 1, 3, 2)[..., None, :]
    y = y + sum(torch.einsum("bchij,bcjhp->bcihp", piece, xc)
                for piece in bf16_pieces(s, score_pieces))
    return y.reshape(B, nc * Q, H, P)[:, :S], h


RGLRU_FAULTS = ("drop_carry",)


def rglru_chunked_loop(a, b, chunk=None, fault=None):
    """The rglru_scan kernel's chunked route in plain PyTorch, step for
    step (a product, then a sum, each rounded to fp32): per chunk of
    `chunk` positions the product of its a's and its scan from zero, the
    carry chained over the chunks, then each chunk's recurrence from its
    carry. ``fault`` "drop_carry" sets the carry entering the middle chunk
    to 0, to show that `same_input_limit` catches such a kernel."""
    from repro_torch.kernels.rglru_scan.rglru_scan import CHUNK
    L = chunk or CHUNK
    B, S, W = a.shape
    nc = -(-S // L)
    pad = nc * L - S
    ac = torch.cat([a.float(), a.new_ones(B, pad, W)], 1).reshape(B, nc, L, W)
    bc = torch.cat([b.float(), b.new_zeros(B, pad, W)], 1).reshape(B, nc, L,
                                                                   W)
    local = torch.zeros(B, nc, W, device=a.device)
    prod = torch.ones(B, nc, W, device=a.device)
    for t in range(L):
        local = ac[:, :, t] * local + bc[:, :, t]
        prod = prod * ac[:, :, t]
    carry = [torch.zeros(B, W, device=a.device)]
    for c in range(1, nc):
        carry.append(prod[:, c - 1] * carry[-1] + local[:, c - 1])
    if fault == "drop_carry":
        carry[nc // 2] = torch.zeros_like(carry[0])
    h = torch.stack(carry, dim=1)                          # (B, nc, W)
    out = torch.empty(B, nc, L, W, device=a.device)
    for t in range(L):
        h = ac[:, :, t] * h + bc[:, :, t]
        out[:, :, t] = h
    return out.reshape(B, nc * L, W)[:, :S]


# ---------------------------------------------------------------------------
# 1. device + build
# ---------------------------------------------------------------------------
def ptxas_by_kernel(log: str) -> dict:
    """`ptxas -v`'s report per entry function (mangled name): registers,
    stack frame and spill bytes."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
    return out


def paged_ptxas(log: str) -> dict:
    """Registers, spills and dynamic shared memory of each paged route's
    kernels (ptxas reports only static shared memory; the dynamic size
    is what the launch asks for at starcoder2-7b's shapes: d = 128, fp32
    pools, k * g = 9 and 36 rows on split)."""
    from repro_torch.kernels.paged_attention.paged_attention import _lib
    lib = _lib()
    smem = {"split": {f"rows={kg}": lib.paged_attention_split_smem(kg, 128, 0)
                      for kg in (9, 36)},
            "wgmma": {"d=128": lib.paged_attention_wgmma_smem(128, 0)}}
    out = {}
    for name, info in ptxas_by_kernel(log).items():
        kind = ("split" if "split_kernel" in name else
                "wgmma" if "wgmma_kernel" in name else "simt")
        out.setdefault(kind, {"kernels": {}, "dynamic_smem": smem.get(kind)})
        out[kind]["kernels"][name] = info
    return out


def scan_ptxas(build) -> dict:
    """Registers and spills of each scan kernel (`ptxas -v`), the
    warpgroup arrives ptxas added to the SSD kernels, and the
    dynamic shared memory of the SSD wgmma route's chunk-scan block (its
    largest) at its chunk and pieces, N = 128 and 64."""
    from repro_torch.kernels.ssd_scan.ssd_scan import _lib
    logs = {name: (build.BUILD_DIR / f"{name}.log").read_text()
            for name in ("ssd_scan", "rglru_scan")}
    out = {name: ptxas_by_kernel(log) for name, log in logs.items()}
    # ptxas note C7519: a warpgroup.arrive it added before a wgmma that
    # reads registers written since the last one
    for fn in re.findall(r"C7519\).*in function '([^']+)'", logs["ssd_scan"]):
        entry = out["ssd_scan"].setdefault(fn, {})
        entry["wgmma_arrives_added"] = entry.get("wgmma_arrives_added", 0) + 1
    out["ssd_wgmma_scan_smem"] = {f"N={n}": _lib().ssd_scan_wgmma_smem(n)
                                  for n in (128, 64)}
    return out


def stencil_ptxas(build) -> dict:
    """Registers and spills of each stencil kernel (`ptxas -v`; hdiff's
    tma route has one entry per built tile and dtype) and the dynamic
    shared memory of a tma block at each built tile, fp32 and bf16, as
    the library reports it: it must equal the wrapper's
    `tma_smem_bytes`, which the cost model prices."""
    from repro_torch.kernels.hdiff.hdiff import _lib, tma_smem_bytes, \
        tma_tiles
    out = {name: ptxas_by_kernel(
        (build.BUILD_DIR / f"{name}.log").read_text())
        for name in ("hdiff", "vadvc")}
    lib, smem = _lib(), {}
    for t in tma_tiles():
        tile = (t["tile_x"], t["tile_y"], t["block_z"])
        got = [lib.hdiff_tma_smem(*tile, bf16) for bf16 in (0, 1)]
        mine = [tma_smem_bytes(*tile, b) for b in (4, 2)]
        if got != mine:
            raise AssertionError(f"hdiff tma smem at {tile}: library {got}, "
                                 f"wrapper {mine}")
        smem["x".join(map(str, tile))] = got
    out["hdiff_tma_smem"] = smem
    return out


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in
                    (build.BUILD_DIR / f"{name}.log").read_text().splitlines()
                    if ("registers" in ln or "spill" in ln)
                    and "C7519" not in ln]
             for name in libs if (build.BUILD_DIR / f"{name}.log").exists()
             and name not in ("hdiff", "vadvc")}
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "build_s": build_s,
            "ptxas": ptxas, "paged_ptxas": paged_ptxas(
                (build.BUILD_DIR / "paged_attention.log").read_text()),
            "scan_ptxas": scan_ptxas(build),
            "stencil_ptxas": stencil_ptxas(build)}
    emit(info)
    return info


# ---------------------------------------------------------------------------
# 2. kernel vs plain version
# ---------------------------------------------------------------------------
def _cast(x, dtype):
    return x if not x.is_floating_point() else x.to(dtype)


def quantize(raw):
    """The serve tier's int8 format (`quant.quantize_page`) on the card."""
    amax = raw.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(raw / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def decode_inputs(gen, *, b, hq, hkv, d, t, n_layers, lengths, dead,
                  q_dtype, rows=1):
    """Layer-stacked mixed-tier pool (odd page ids slow) on the card, each
    row with its own pages; `dead` rows have length 1 and a zero table.
    ``rows`` > 1 gives q (b, rows, hq, d): consecutive query rows of a
    verify or chunk-fill step, row j seeing lengths + j positions."""
    dev = "cuda"
    slots = max(-(-(n + rows - 1) // t) for n in lengths)
    pages = b * slots
    shape = (n_layers, pages, t, hkv, d)
    slow = (torch.arange(pages, device=dev) % 2 == 1)[None, :, None, None]

    def pool():
        raw = torch.randn(shape, generator=gen, device=dev)
        q8, sc = quantize(raw)
        fast = torch.where(slow[..., None], 0.0, raw)
        q8 = torch.where(slow[..., None], q8, torch.zeros_like(q8))
        sc = torch.where(slow, sc, 0.0)
        return fast, q8, sc

    kf, kq, ks = pool()
    vf, vq, vs = pool()
    table = torch.randperm(pages, generator=gen, device=dev) \
        .reshape(b, slots).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for i in dead:
        table[i] = 0
        lens[i] = 1
    q_shape = (b, hq, d) if rows == 1 else (b, rows, hq, d)
    q = torch.randn(q_shape, generator=gen, device=dev).to(q_dtype)
    return [q, kf, vf, kq, vq, ks, vs, table, lens]


def bytes_and_flops(args, rows: int = 1):
    """Least bytes the function must move (q, out, and for every position
    a row can see the float, int8 and scale entries of K and V) and its
    flops, from this call's inputs."""
    q, kf = args[0], args[1]
    lengths = args[8].tolist()
    hq, d, hkv = q.shape[-2], q.shape[-1], kf.shape[-2]
    per_pos = 2 * hkv * (d * (kf.element_size() + 1) + args[5].element_size())
    span = sum(n + rows - 1 for n in lengths)
    nbytes = (2 * q.numel() * q.element_size() + span * per_pos
              + args[7].numel() * 4 + args[8].numel() * 4)
    flops = 4 * hq * d * sum(rows * n + rows * (rows - 1) // 2
                             for n in lengths)
    return nbytes, flops


def sdpa_yardstick(args, layer, rows: int = 1):
    """`scaled_dot_product_attention` over K/V gathered and dequantized
    beforehand (untimed), masked to each row's length. It omits the
    page gather and the dequant the kernel does."""
    from repro_torch.kernels.paged_attention.ref import dequantize_pool
    q, kf, vf, kq, vq, ks, vs, table, lens = args
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    t, hkv = kf.shape[-3], kf.shape[-2]
    tab = table.long()
    k = dequantize_pool(kf[layer][tab], kq[layer][tab], ks[layer][tab])
    v = dequantize_pool(vf[layer][tab], vq[layer][tab], vs[layer][tab])
    s = tab.shape[1] * t
    k = k.reshape(b, s, hkv, d).transpose(1, 2).to(q.dtype).contiguous()
    v = v.reshape(b, s, hkv, d).transpose(1, 2).to(q.dtype).contiguous()
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    limit = lens[:, None].long() + torch.arange(rows, device=q.device)
    mask = torch.arange(s, device=q.device)[None, None, :] < limit[..., None]
    mask = mask[:, None]                                # (b, 1, rows, s)
    qq = q.reshape(b, rows, hq, d).transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


# bf16 products the wgmma route issues per 64-position tile, by the part
# of the tile that holds a nonzero value (a part that is zero throughout
# the tile is skipped)
WGMMA_PRODUCTS = {"k_float": 3, "k_int8": 1, "v_float": 6, "v_int8": 3}


def paged_tc_products(args, layer, rows: int):
    """The bf16 products the wgmma route issues on these inputs, and
    their flops: per block (128 rows, kv head, sequence) and tile of 64
    positions (16 at d = 256) up to the last position its last row sees,
    `WGMMA_PRODUCTS` for each part of K and V holding a nonzero value;
    each a 64-row product per warpgroup, 2 warpgroups a block, 2 * 64 *
    tile * d flops."""
    q, kf, vf, kq, vq = args[:5]
    table, lens = args[7], args[8]
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    t, hkv = kf.shape[-3], kf.shape[-2]
    g, bn = hq // hkv, 64 if d <= 128 else 16
    kg = rows * g
    tab = table.long()
    span = tab.shape[1] * t

    def nonzero(pool):                        # (b, positions, hkv)
        return (pool[layer][tab] != 0).any(-1).reshape(b, span, hkv)

    parts = [(nonzero(x), WGMMA_PRODUCTS[n]) for x, n in (
        (kf, "k_float"), (kq, "k_int8"), (vf, "v_float"), (vq, "v_int8"))]
    total = 0
    for bi, n in enumerate(lens.tolist()):
        for r0 in range(0, kg, 128):
            end = min(n + (min(r0 + 128, kg) - 1) // g, span)
            tiles = -(-end // bn)
            for nz, w in parts:
                m = torch.zeros(tiles * bn, hkv, dtype=torch.bool,
                                device=nz.device)
                m[:end] = nz[bi, :end]
                total += w * int(m.view(tiles, bn, hkv).any(1).sum())
    products = 2 * total
    return products, products * 2 * 64 * bn * d


PAGED_FAULTS = ("k_one_piece", "drop_last_split", "no_int8_scale")


def paged_variant(args, layer, rows: int = 1, *, fault):
    """The plain version broken on purpose, to show that
    `same_input_limit` tells a right paged kernel from a wrong one:
    "k_one_piece" rounds K's float tier to bf16 once (the wgmma route with
    one piece of K), "drop_last_split" leaves out each sequence's
    positions from the start of the split (`split_plan`) that holds its
    last row's last position, "no_int8_scale" reads the int8 tier of K
    without its scale."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        _sm_count, split_plan)
    from repro_torch.kernels.paged_attention.ref import dequantize_pool
    q, kf, vf, kq, vq, ks, vs, table, lens = args
    kf, vf, kq, vq, ks, vs = (x[layer] for x in (kf, vf, kq, vq, ks, vs))
    if fault == "k_one_piece":
        kf = kf.to(torch.bfloat16).float()
    if fault == "no_int8_scale":
        ks = torch.ones_like(ks)
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    t, hkv = kf.shape[-3], kf.shape[-2]
    g = hq // hkv
    tab = table.long()
    span = tab.shape[1] * t
    k = dequantize_pool(kf[tab], kq[tab], ks[tab]).reshape(b, span, hkv, d)
    v = dequantize_pool(vf[tab], vq[tab], vs[tab]).reshape(b, span, hkv, d)
    qg = q.reshape(b, rows, hkv, g, d).float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bkhgd,bshd->bhkgs", qg, k)
    pos = torch.arange(span, device=q.device)
    limit = lens.long()[:, None] + torch.arange(rows, device=q.device)
    ok = pos[None, None, :] < limit[..., None]              # (b, rows, S)
    if fault == "drop_last_split":
        _, chunk = split_plan(b, hkv, span, d, _sm_count(q.device.index))
        last = (lens.long() + rows - 2) // chunk * chunk    # (b,)
        ok &= (pos[None, :] < last[:, None])[:, None, :] | (last == 0)[
            :, None, None]
    s = torch.where(ok[:, None, :, None, :], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhkgs,bshd->bkhgd", p, v)
    return out.reshape(q.shape).to(q.dtype)


def paged_broken_variants(args, layer, rows, label) -> dict:
    """Each `paged_variant` against the plain version on the same inputs:
    its error over `same_input_limit` must exceed 1."""
    from repro_torch.kernels import api
    want = api.run("paged_attention", *args, layer, backend="ref")
    out = {}
    for fault in PAGED_FAULTS:
        err, tol, over = ulp_check(paged_variant(args, layer, rows,
                                                 fault=fault), want)
        out[fault] = over
        emit({"phase": "kernel", "case": f"{label} broken: {fault}",
              "kernel": "paged_attention", "fault": fault,
              "max_abs_err": err, "max_err_over_limit": over})
        if not over > 1.0:
            raise AssertionError(f"{label}: the {fault} variant passes the "
                                 f"limit ({over:.2f}x)")
    return out


def paged_before_after(args, layer, rows, label, pairs: int = 10) -> dict:
    """The redesign against the kernel it replaced, on one card: the same
    inputs through the simt route (the first kernel, unchanged, which
    every call took before the redesign) and through
    the route `route` picks, `pairs` pairs of `device_ms`, alternating
    which runs first. Launched through the library directly, so no
    launch counts."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        LOG2E, _lib, route, split_scratch)
    lib = _lib()
    q, kf = args[0], args[1]
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    pages, t, hkv = kf.shape[-4], kf.shape[-3], kf.shape[-2]
    slots = args[7].shape[1]
    kg = rows * (hq // hkv)
    scale = 1.0 / math.sqrt(d)
    q_bf16 = int(q.dtype == torch.bfloat16)
    pool_bf16 = int(kf.dtype == torch.bfloat16)
    out = torch.empty_like(q)
    ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
    shape = (b, rows, hq, hkv, d, pages, t, slots, layer)
    new = route(q.dtype, kg, d)
    stream = torch.cuda.current_stream().cuda_stream

    def simt():
        if lib.paged_attention_launch(*ptrs, *shape, scale, q_bf16,
                                      pool_bf16, stream):
            raise RuntimeError("simt launch failed")

    if new == "split":
        splits, chunk, *scratch, _keep = split_scratch(
            q.device, b, hkv, kg, d, slots * t)

        def after():
            if lib.paged_attention_split_launch(
                    *ptrs, *scratch, *shape, scale, splits, chunk, q_bf16,
                    pool_bf16, stream):
                raise RuntimeError("split launch failed")
    else:
        def after():
            if lib.paged_attention_wgmma_launch(
                    *ptrs, *shape, scale * LOG2E, pool_bf16, stream):
                raise RuntimeError("wgmma launch failed")

    times = {"simt": [], new: []}
    for i in range(pairs):
        for name, fn in ((("simt", simt), (new, after)) if i % 2 == 0
                         else ((new, after), ("simt", simt))):
            times[name].append(device_ms(fn, calls=5, reps=3))
    q1, q3 = np.percentile(times["simt"], [25, 75])
    row = {"phase": "kernel", "case": f"{label}: simt (before) vs {new}",
           "kernel": "paged_attention", "pairs": pairs, "device_ms": times,
           "median_ms": {n: statistics.median(v) for n, v in times.items()},
           "simt_iqr_ms": q3 - q1,
           "new_route_wins": sum(w < s for w, s in zip(times[new],
                                                       times["simt"]))}
    emit(row)
    if row["new_route_wins"] != pairs:
        raise AssertionError(f"{label}: the {new} route won "
                             f"{row['new_route_wins']} of {pairs} pairs")
    return row


# shapes in bf16 that reach the wgmma route (k * g > 64) and no spec case
# has: d = 64, 128, 256; a ragged last block of rows; a row of length 1;
# a dead row (length 1, zero table); pages shorter than a tile; bf16
# pools; and split-route shapes at g = 9: lengths 1, a split edge, a
# page + 1. (shape, rows, route, pools in bf16)
PAGED_EDGE_CASES = (
    (dict(b=3, hq=18, hkv=2, d=64, t=64, n_layers=2, lengths=[300, 1, 77],
          dead=[1]), 40, "wgmma", False),
    (dict(b=2, hq=36, hkv=4, d=128, t=128, n_layers=2, lengths=[1, 900],
          dead=[]), 13, "wgmma", False),
    (dict(b=2, hq=20, hkv=2, d=256, t=32, n_layers=2, lengths=[200, 1],
          dead=[]), 13, "wgmma", False),
    (dict(b=2, hq=9, hkv=1, d=128, t=16, n_layers=2, lengths=[150, 33],
          dead=[]), 8, "wgmma", False),
    (dict(b=2, hq=36, hkv=4, d=128, t=128, n_layers=2, lengths=[600, 1],
          dead=[1]), 8, "wgmma", True),
    (dict(b=3, hq=36, hkv=4, d=128, t=128, n_layers=2,
          lengths=[1, 129, 384], dead=[0]), 1, "split", False),
    (dict(b=2, hq=36, hkv=4, d=128, t=128, n_layers=2, lengths=[128, 1],
          dead=[1]), 4, "split", False),
    (dict(b=2, hq=36, hkv=4, d=128, t=16, n_layers=2, lengths=[300, 17],
          dead=[]), 1, "split", True),
)


def paged_edge_cases():
    """`PAGED_EDGE_CASES` through the route each must take, held to the
    plain version on the same inputs by `same_input_limit`."""
    from repro_torch.kernels import api
    gen = torch.Generator(device="cuda").manual_seed(2)
    for i, (shape, rows, expect, pool_bf16) in enumerate(PAGED_EDGE_CASES):
        args = decode_inputs(gen, q_dtype=torch.bfloat16, rows=rows,
                             **shape)
        if pool_bf16:
            for j in (1, 2, 5, 6):
                args[j] = args[j].to(torch.bfloat16)
        got = {}
        taken = route_taken("paged_attention", lambda: got.setdefault(
            "out", api.run("paged_attention", *args, 1,  # noqa: B023
                           backend="cuda")))
        want = api.run("paged_attention", *args, 1, backend="ref")
        err, tol, over = ulp_check(got["out"], want)
        emit({"phase": "kernel", "kernel": "paged_attention",
              "case": f"edge {i}", "dtype": "bfloat16", "rows": rows,
              "shape": shape, "pools": "bfloat16" if pool_bf16 else
              "float32", "route": taken, "max_abs_err": err,
              "tol": tol, "tol_rule": ULP_RULE, "max_err_over_limit": over})
        if taken != expect or not over <= 1.0:
            raise AssertionError(f"paged edge {shape} k={rows}: route "
                                 f"{taken} (want {expect}), {over:.2f}x "
                                 f"the limit")


ULP_RULE = ("per element: 2 ulps of |want| in the output dtype + 1e-6; "
            "tol is the limit at the element of the largest error")


def ulp_check(got, want):
    """`same_input_limit` per element: (max abs error, the limit at that
    element, max error / limit)."""
    diff = (got.float() - want.float()).abs()
    limit = same_input_limit(want)
    worst = int(torch.argmax(diff))
    return (diff.flatten()[worst].item(), limit.flatten()[worst].item(),
            (diff / limit).max().item())


def ssd_check(got, want):
    """`ssd_limit` over y and the final state: (max abs error, y's limit,
    max error / limit)."""
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    return err, ssd_limit(want[0], want[0].shape[1]), \
        over_ssd_limit(got, want)


def compare_and_time(label, kernel, plain, library, nbytes, flops, peak,
                     extra, check=ulp_check, rule=ULP_RULE,
                     device: bool = False) -> dict:
    """Hold a kernel to its plain version on the same inputs with
    `check` (default: per element to 2 ulps of |want| in the output
    dtype), then time kernel, plain version and library call (None when
    no PyTorch call computes the function) in alternation. With
    ``device`` the kernel's and the library call's ``kernel_ms`` and
    ``library_ms`` (and so the bound share) are `device_ms`, the card's
    time without the host's enqueue; the event times stay beside them as
    ``event_ms``. Returns the row, with the bound from this call's bytes
    and flops."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, tol, over = check(got, want)
    del got, want
    if not over <= 1.0:
        raise AssertionError(f"{label}: error {err} beyond the limit "
                             f"({over:.2f}x; {rule})")
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    fns = {"kernel": kernel, "plain": plain}
    if library is not None:
        fns["library"] = library
    times = cuda_ms(fns, rounds=20)
    row = {"phase": "kernel", "case": label, **extra,
           "max_abs_err": err, "tol": tol, "tol_rule": rule,
           "max_err_over_limit": over,
           "kernel_ms": times["kernel"][0], "plain_ms": times["plain"][0],
           "library_ms": times["library"][0] if library else None,
           "host_ms": {k: v[1] for k, v in times.items()},
           "timing": "cuda events, one call",
           "bytes": nbytes, "flops": flops,
           "bound_ms": max(t_bytes, t_flops),
           "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
    if device:
        row["event_ms"] = {"kernel": row["kernel_ms"],
                           "library": row["library_ms"]}
        row["kernel_ms"] = device_ms(kernel)
        if library is not None:
            row["library_ms"] = device_ms(library)
        row["timing"] = ("device_ms: 20 calls queued behind a sleep, "
                         "median of 5")
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    emit(row)
    return row


def spec_cases(name, run_case):
    """Every case of a kernel's spec: the kernel on the case's dtype
    against the plain version on fp32 inputs, held to the spec's tol."""
    from repro_torch.kernels import api, registry
    spec = registry.get(name)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for i, case in enumerate(spec.cases):
        inputs = spec.example_inputs(shape=dict(case.shape))
        args = [torch.from_numpy(v).cuda() for v in inputs.values()]
        want = api.run(name, *args, backend="ref", **case.kwargs)
        errs = run_case(spec, case, args, want, dtypes[case.dtype])
        taken = errs.pop("route", None)
        tol = spec.tol[case.dtype]
        err = max(errs.values())
        emit({"phase": "kernel", "kernel": name, "case": i,
              "shape": dict(case.shape), "kwargs": dict(case.kwargs),
              "dtype": case.dtype, "max_abs_err": errs, "tol": tol,
              "ok": err <= tol, **({"route": taken} if taken else {})})
        if not err <= tol:
            raise AssertionError(f"{name} case {i}: error {err} > tol {tol}")


def _paged_case(spec, case, args, want, dtype):
    """Flat pools, and a layer-stacked pool with the case's pool as layer
    1 of 3."""
    from repro_torch.kernels import api
    others = [spec.example_inputs(shape=dict(case.shape), seed=s)
              for s in (1, 2)]
    names = spec.arg_names[1:7]
    stacked = [torch.stack([torch.from_numpy(others[0][n]).cuda(), a,
                            torch.from_numpy(others[1][n]).cuda()])
               for n, a in zip(names, args[1:7])]
    errs = {}
    for form, pools, layer in (("flat", args[1:7], None),
                               ("stacked", stacked, 1)):
        kargs = [_cast(a, dtype) for a in [args[0], *pools, args[7], args[8]]]
        extra = () if layer is None else (layer,)
        got = api.run(spec.name, *kargs, *extra, backend="cuda")
        torch.cuda.synchronize()
        errs[form] = (got.float() - want.float()).abs().max().item()
    return errs


def _flash_case(spec, case, args, want, dtype):
    from repro_torch.kernels import api
    got = api.run(spec.name, *[a.to(dtype) for a in args], backend="cuda",
                  **case.kwargs)
    torch.cuda.synchronize()
    return {"kernel": (got.float() - want.float()).abs().max().item()}


def _ssd_case(spec, case, args, want, dtype):
    """y and the final state of the kernel against the plain version,
    through the route the case takes (fp32: simt)."""
    from repro_torch.kernels import api
    from repro_torch.kernels.ssd_scan.ssd_scan import route
    got = {}
    taken = route_taken("ssd_scan", lambda: got.setdefault(
        "out", api.run(spec.name, *args, backend="cuda")))
    B, S, H, P = args[0].shape
    expect = route(args[0].dtype, S, P, args[1].shape[3], args[1].shape[2])
    if taken != expect:
        raise AssertionError(f"ssd_scan {dict(case.shape)}: route {taken}, "
                             f"want {expect}")
    return {"route": taken, **{part: (g - w).abs().max().item()
                               for part, g, w in zip(("y", "state"),
                                                     got["out"], want)}}


def _rglru_case(spec, case, args, want, dtype):
    """The kernel against the plain version through the route the case
    takes (S up to one chunk: serial, else chunked)."""
    from repro_torch.kernels import api
    from repro_torch.kernels.rglru_scan.rglru_scan import route
    got = {}
    taken = route_taken("rglru_scan", lambda: got.setdefault(
        "out", api.run(spec.name, *args, backend="cuda")))
    if taken != route(args[0].shape[1]):
        raise AssertionError(f"rglru_scan {dict(case.shape)}: route {taken}")
    return {"route": taken, "h": (got["out"] - want).abs().max().item()}


def ssd_inputs(shape, dtype, seed):
    """The spec's generator (numpy, seeded) at a full-width shape: x, B
    and C in `dtype`, dt and a fp32, on the card."""
    from repro_torch.kernels.ssd_scan.spec import example_inputs
    inp = example_inputs(shape=shape, seed=seed)
    return [torch.from_numpy(v).cuda().to(dtype if n in ("x", "b_mat",
                                                         "c_mat")
                                          else torch.float32)
            for n, v in inp.items()]


def ssd_bytes_and_flops(args):
    """Bytes of x, B, C, dt, a, y and the final state, each once, and the
    operations the chunked form needs at the kernel's chunk Q, by type:
    {peak rate: flops}. Counted are the multiply-adds of its products
    over the causal half of each chunk (pairs j <= i): C Bt once per
    group (on the tensor cores when B and C are bf16), the scores times
    x per head, C exp(cum) @ state per head in every chunk but the first
    (whose incoming state is zero), and the state update per head with
    its per-chunk decay; the O(pairs x H) decay weights are left out."""
    from repro_torch.kernels.ssd_scan.ssd_scan import CHUNK
    x, b_mat = args[0], args[1]
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + (B * S * H * P + B * H * P * N) * 4
    q = min(CHUNK, S)
    lens = [min(q, S - i) for i in range(0, S, q)]
    pairs = sum(n * (n + 1) // 2 for n in lens)
    cb = 2 * B * G * pairs * N
    fp32 = B * H * (2 * pairs * P + 2 * (S - lens[0]) * N * P
                    + 2 * S * N * P + len(lens) * N * P)
    if b_mat.dtype == torch.bfloat16:
        return nbytes, {BF16_FLOPS: cb, FP32_FLOPS: fp32}
    return nbytes, {FP32_FLOPS: cb + fp32}


def routes(kernel: str) -> dict:
    """A kernel wrapper's launch counts by route ("wgmma", "simt", ...)."""
    return dict(_counters()[kernel].launches_by_route)


def route_taken(kernel: str, fn) -> str:
    """Run `fn`, which must launch `kernel` once, and return the route
    whose count rose."""
    before = routes(kernel)
    fn()
    torch.cuda.synchronize()
    after = routes(kernel)
    taken = [r for r in after if after[r] != before[r]]
    if len(taken) != 1 or after[taken[0]] != before[taken[0]] + 1:
        raise AssertionError(f"{kernel} routes {before} -> {after}: want one "
                             f"launch")
    return taken[0]


FLASH_FAULTS = ("bf16_p", "drop_last_tile")


def flash_variant(q, k, v, *, causal=True, window=0, fault):
    """The plain version broken on purpose, to show that
    `same_input_limit` tells a right flash kernel from a wrong one:
    "bf16_p" rounds P to bf16 once before P V (the JAX model's
    `attention_core` form; l stays the fp32 sum), "drop_last_tile" leaves
    out the keys of the last 128-key tile."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float() * (1.0 / math.sqrt(d))
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    if fault == "drop_last_tile":
        ok &= k_pos < (skv - 1) // 128 * 128
    s = torch.where(ok, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    if fault == "bf16_p":
        p = p.to(torch.bfloat16).float()
    acc = torch.einsum("bhgqs,bshd->bhgqd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


# shapes the kernels take that no spec case has, each row seeing at least
# one key: sq != skv (causal, windowed), one position, batch > 1 at d = 256
FLASH_EDGE_CASES = (
    ({"b": 1, "sq": 1, "skv": 1, "hq": 2, "hkv": 1, "d": 64}, {}),
    ({"b": 2, "sq": 5, "skv": 300, "hq": 4, "hkv": 2, "d": 128}, {}),
    ({"b": 1, "sq": 300, "skv": 77, "hq": 9, "hkv": 1, "d": 128}, {}),
    ({"b": 3, "sq": 129, "skv": 129, "hq": 6, "hkv": 3, "d": 256},
     {"window": 64}),
    ({"b": 1, "sq": 200, "skv": 333, "hq": 2, "hkv": 2, "d": 64},
     {"causal": False, "window": 100}),
)


def flash_cases_bf16():
    """Every flash spec case cast to bf16, then `FLASH_EDGE_CASES`, through
    the route each takes (`route`: wgmma at d = 64, 128, 256, simt at
    d = 32), held to the plain version on the same bf16 inputs by
    `same_input_limit`."""
    from repro_torch.kernels import api, registry
    from repro_torch.kernels.flash_attention.flash_attention import route
    spec = registry.get("flash_attention")
    cases = [(dict(c.shape), dict(c.kwargs), [
        torch.from_numpy(v).cuda().to(torch.bfloat16)
        for v in spec.example_inputs(shape=dict(c.shape)).values()])
        for c in spec.cases]
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases += [(shape, kw, flash_inputs(gen, dtype=torch.bfloat16, **shape))
              for shape, kw in FLASH_EDGE_CASES]
    for i, (shape, kw, args) in enumerate(cases):
        got = {}
        taken = route_taken("flash_attention", lambda: got.setdefault(
            "out", api.run("flash_attention", *args,  # noqa: B023
                           backend="cuda", **kw)))  # noqa: B023
        want = api.run("flash_attention", *args, backend="ref", **kw)
        err, tol, over = ulp_check(got["out"], want)
        expect = route(torch.bfloat16, shape["d"])
        emit({"phase": "kernel", "kernel": "flash_attention",
              "case": i if i < len(spec.cases) else f"edge {i}",
              "dtype": "bfloat16", "shape": shape, "kwargs": kw,
              "route": taken, "max_abs_err": err, "tol": tol,
              "tol_rule": ULP_RULE, "max_err_over_limit": over})
        if taken != expect or not over <= 1.0:
            raise AssertionError(f"flash {shape} {kw} in bf16: route {taken} "
                                 f"(want {expect}), {over:.2f}x the limit")


def flash_broken_variants(q, k, v, label, **kw) -> dict:
    """Each `flash_variant` against the plain version on the same inputs:
    its error over `same_input_limit` must exceed 1."""
    from repro_torch.kernels import api
    want = api.run("flash_attention", q, k, v, backend="ref", **kw)
    out = {}
    for fault in FLASH_FAULTS:
        err, tol, over = ulp_check(flash_variant(q, k, v, fault=fault, **kw),
                                   want)
        out[fault] = over
        emit({"phase": "kernel", "case": f"{label} broken: {fault}",
              "kernel": "flash_attention", "fault": fault,
              "max_abs_err": err, "max_err_over_limit": over})
        if not over > 1.0:
            raise AssertionError(f"{label}: the {fault} variant passes the "
                                 f"limit ({over:.2f}x)")
    return out


def flash_before_after(q, k, v, label, pairs: int = 10, **kw) -> dict:
    """The redesign against the kernel it replaced, on one card: bf16
    inputs through the simt route (the first prefill slice's kernel,
    unchanged, which bf16 took before the wgmma route existed) and the
    wgmma route, `pairs` pairs of `device_ms`, alternating which runs
    first. Launched through the library directly, so no launch counts."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        LOG2E, _lib
    lib = _lib()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    causal, window = int(kw.get("causal", True)), kw.get("window", 0)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, hq, hkv, d, causal, window)

    def simt():
        if lib.flash_attention_launch(
                *args, scale, 1, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("simt launch failed")

    def wgmma():
        if lib.flash_attention_wgmma_launch(
                *args, scale * LOG2E, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("wgmma launch failed")

    times = {"simt": [], "wgmma": []}
    for i in range(pairs):
        for name, fn in ((("simt", simt), ("wgmma", wgmma)) if i % 2 == 0
                         else (("wgmma", wgmma), ("simt", simt))):
            times[name].append(device_ms(fn, calls=5, reps=3))
    q1, q3 = np.percentile(times["simt"], [25, 75])
    row = {"phase": "kernel", "case": f"{label}: simt (before) vs wgmma",
           "kernel": "flash_attention", "pairs": pairs, "device_ms": times,
           "median_ms": {n: statistics.median(t) for n, t in times.items()},
           "simt_iqr_ms": q3 - q1,
           "wgmma_wins": sum(w < s for w, s in zip(times["wgmma"],
                                                   times["simt"]))}
    emit(row)
    return row


def flash_inputs(gen, *, b, sq, skv, hq, hkv, d, dtype):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def flash_bytes_and_flops(q, k, v, window: int = 0, causal: bool = True):
    """Bytes of q, k, v and out, each once; 4 d flops per (query, key) pair
    the mask lets through: with `causal` kp <= qp, with `window`
    kp > qp - window (queries and keys aligned at 0)."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    pairs = sum((min(i + 1, skv) if causal else skv)
                - (max(0, i - window + 1) if window else 0)
                for i in range(sq))
    return nbytes, 4 * b * hq * d * pairs


def phase_kernel() -> dict:
    spec_cases("paged_attention", _paged_case)
    spec_cases("flash_attention", _flash_case)
    gen = torch.Generator(device="cuda").manual_seed(0)
    full = {}
    full.update(paged_full_width(gen))
    paged_edge_cases()
    flash_cases_bf16()
    full.update(flash_full_width(gen))
    full.update(scan_kernels())
    torch.cuda.empty_cache()
    return full


def paged_full_width(gen) -> dict:
    """Paged attention at the starcoder2-7b shapes of the main path (b=4,
    36 query heads over 4 kv heads, d=128, 128-token pages, 32 layers,
    mixed tiers, one dead row): one decode row, a k = 4 verify step (the
    split route) and a k = 128 chunk-fill step (1152 query rows per kv
    head: the wgmma route in bf16, simt in fp32). Each row checks its
    route and is timed by `device_ms` beside SDPA's; the wgmma row adds
    its bound at the bf16 peak and the products it issues. At k = 1 and
    k = 128 in bf16 the broken variants must fail the limit the kernel
    meets, and the simt route (the kernel before the redesign) and the
    new route run in 10 alternating pairs."""
    from repro_torch.kernels import api
    from repro_torch.kernels.paged_attention.paged_attention import route
    rows_out = {}
    shape = dict(b=4, hq=36, hkv=4, d=128, t=128, n_layers=32,
                 lengths=[2048, 700, 1, 1500], dead=[2])
    layer = 17
    for rows, dtypes in ((1, ("bfloat16", "float32")), (4, ("bfloat16",)),
                         (128, ("bfloat16", "float32"))):
        for name in dtypes:
            dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
            args = decode_inputs(gen, q_dtype=dtype, rows=rows, **shape)
            nbytes, flops = bytes_and_flops(args, rows)

            def kernel():
                return api.run("paged_attention", *args, layer,  # noqa: B023
                               backend="cuda")

            taken = route_taken("paged_attention", kernel)
            if taken != route(dtype, rows * 9, 128):
                raise AssertionError(f"paged k={rows} {name}: route {taken}")
            extra = {"kernel": "paged_attention", "rows": rows, "dtype": name,
                     "route": taken, "shape": shape, "layer": layer,
                     "library": "scaled_dot_product_attention over K/V "
                                "gathered and dequantized beforehand "
                                "(omits gather and dequant)"}
            if taken == "wgmma":
                products, tc_flops = paged_tc_products(args, layer, rows)
                extra.update(
                    bound_ms_fp32_peak=max(nbytes / HBM_BYTES_PER_S,
                                           flops / FP32_FLOPS) * 1e3,
                    bound_ms_bf16_peak=max(nbytes / HBM_BYTES_PER_S,
                                           flops / BF16_FLOPS) * 1e3,
                    bf16_products=products,
                    bf16_products_per_tile=WGMMA_PRODUCTS,
                    bf16_product_flops=tc_flops,
                    bf16_product_ms_at_peak=tc_flops / BF16_FLOPS * 1e3)
            label = f"paged_attention starcoder2-7b k={rows} {name}"
            key = ("paged_attention", rows, name)
            rows_out[key] = compare_and_time(
                label, kernel,
                lambda: api.run("paged_attention", *args, layer,  # noqa
                                backend="ref"),
                sdpa_yardstick(args, layer, rows), nbytes, flops,
                FP32_FLOPS, extra, device=True)
            if name == "bfloat16" and rows in (1, 128):
                rows_out[key]["broken_over_limit"] = paged_broken_variants(
                    args, layer, rows, label)
                rows_out[key]["before_after"] = paged_before_after(
                    args, layer, rows, label)
            del args
            torch.cuda.empty_cache()
    return rows_out


def flash_full_width(gen) -> dict:
    """Flash attention at full width: starcoder2-7b's prefill (b=1, 36
    query heads over 4 kv heads, d=128; 600 is the serve phase's longest
    prompt), causal and not, and recurrentgemma-2b's local-attention
    prefill at the hybrid phase's `generate` batch (2 prompts padded to
    2300: MQA, 10 query heads, d=256, window 2048; SDPA takes the window
    as a boolean mask). Each row checks the route its launch took and is
    timed by `device_ms`; at s = 2048 the two broken variants must fail
    the limit the kernel meets."""
    from repro_torch.kernels import api
    from repro_torch.kernels.flash_attention.flash_attention import route
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    rows = {}
    shapes = [(2048, True, ("bfloat16", "float32")),
              (2048, False, ("bfloat16",)),
              (1000, True, ("bfloat16", "float32")),
              (1000, False, ("bfloat16",)),
              (600, True, ("bfloat16",)), (600, False, ("bfloat16",))]
    for sq, causal, names in shapes:
        for name in names:
            dtype = dtypes[name]
            q, k, v = flash_inputs(gen, b=1, sq=sq, skv=sq, hq=36, hkv=4,
                                   d=128, dtype=dtype)
            nbytes, flops = flash_bytes_and_flops(q, k, v, causal=causal)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

            def kernel():
                return api.run("flash_attention", q, k, v, causal=causal,
                               backend="cuda")

            taken = route_taken("flash_attention", kernel)
            if taken != route(dtype, 128):
                raise AssertionError(f"s={sq} {name}: route {taken}")
            label = (f"flash_attention starcoder2-7b prefill s={sq} "
                     f"{'causal' if causal else 'non-causal'} {name}")
            key = ("flash_attention", sq, name) + (() if causal
                                                   else ("non-causal",))
            rows[key] = compare_and_time(
                label, kernel,
                lambda: api.run("flash_attention", q, k, v,  # noqa
                                causal=causal, backend="ref"),
                lambda: F.scaled_dot_product_attention(  # noqa
                    qt, kt, vt, is_causal=causal, enable_gqa=True),
                nbytes, flops,
                BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS,
                {"kernel": "flash_attention", "dtype": name, "route": taken,
                 "shape": {"b": 1, "sq": sq, "skv": sq, "hq": 36, "hkv": 4,
                           "d": 128, "causal": causal},
                 "library": f"scaled_dot_product_attention(is_causal="
                            f"{causal}, enable_gqa=True) on (b, h, s, d) "
                            f"copies made beforehand"}, device=True)
            if sq == 2048 and causal and name == "bfloat16":
                rows[key]["broken_over_limit"] = flash_broken_variants(
                    q, k, v, label, causal=True)
                rows[key]["before_after"] = flash_before_after(
                    q, k, v, label, causal=True)
            del q, k, v, qt, kt, vt
    q, k, v = flash_inputs(gen, b=2, sq=2300, skv=2300, hq=10, hkv=1,
                           d=256, dtype=torch.bfloat16)
    nbytes, flops = flash_bytes_and_flops(q, k, v, window=2048)
    pos = torch.arange(2300, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - 2048)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def kernel():
        return api.run("flash_attention", q, k, v, causal=True, window=2048,
                       backend="cuda")

    taken = route_taken("flash_attention", kernel)
    if taken != "wgmma":
        raise AssertionError(f"recurrentgemma flash: route {taken}")
    rows[("flash_attention", "recurrentgemma", "bfloat16")] = \
        compare_and_time(
            "flash_attention recurrentgemma-2b prefill b=2 s=2300 "
            "window=2048 bfloat16", kernel,
            lambda: api.run("flash_attention", q, k, v, causal=True,
                            window=2048, backend="ref"),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            nbytes, flops, BF16_FLOPS,
            {"kernel": "flash_attention", "dtype": "bfloat16",
             "route": taken,
             "shape": {"b": 2, "sq": 2300, "skv": 2300, "hq": 10, "hkv": 1,
                       "d": 256, "causal": True, "window": 2048},
             "library": "scaled_dot_product_attention(attn_mask=causal "
                        "window mask, enable_gqa=True) on (b, h, s, d) "
                        "copies made beforehand"}, device=True)
    flash_before_after(q, k, v, "flash_attention recurrentgemma-2b prefill "
                       "b=2 s=2300 window=2048 bfloat16", causal=True,
                       window=2048)
    return rows


# shapes of the SSD scan's wgmma route that mamba2's prefill does not show:
# S shorter than a chunk, one position, G = 2, N = 64, a chunk and one
# position, B = 3 with a ragged last chunk
SSD_EDGE_CASES = (
    {"B": 1, "S": 50, "H": 4, "P": 64, "G": 1, "N": 128},
    {"B": 1, "S": 1, "H": 4, "P": 64, "G": 1, "N": 128},
    {"B": 2, "S": 300, "H": 6, "P": 64, "G": 2, "N": 128},
    {"B": 2, "S": 129, "H": 4, "P": 64, "G": 1, "N": 64},
    {"B": 3, "S": 1000, "H": 8, "P": 64, "G": 2, "N": 64},
)
# shapes of the RG-LRU scan's chunked route (B, S, W): one position past
# whole chunks (65, 129), W not a multiple of the block, B = 3 ragged
RGLRU_EDGE_CASES = ((1, 65, 100), (3, 1000, 130), (2, 129, 2560))


def ssd_edge_cases():
    """`SSD_EDGE_CASES` in bf16 through the wgmma route, held to the plain
    version on the same inputs by `ssd_limit`."""
    from repro_torch.kernels import api
    for i, shape in enumerate(SSD_EDGE_CASES):
        args = ssd_inputs(shape, torch.bfloat16, seed=100 + i)
        got = {}
        taken = route_taken("ssd_scan", lambda: got.setdefault(  # noqa: B023
            "out", api.run("ssd_scan", *args, backend="cuda")))  # noqa: B023
        err, tol, over = ssd_check(got["out"], api.run("ssd_scan", *args,
                                                      backend="ref"))
        emit({"phase": "kernel", "kernel": "ssd_scan", "case": f"edge {i}",
              "dtype": "bfloat16", "shape": shape, "route": taken,
              "max_abs_err": err, "tol": tol, "tol_rule": SSD_LIMIT_RULE,
              "max_err_over_limit": over})
        if taken != "wgmma" or not over <= 1.0:
            raise AssertionError(f"ssd {shape} in bf16: route {taken}, "
                                 f"{over:.3f}x the limit")


def rglru_edge_cases(gen):
    """`RGLRU_EDGE_CASES` through the chunked route, held to the plain
    version by `same_input_limit`."""
    from repro_torch.kernels import api
    for b, s_len, w in RGLRU_EDGE_CASES:
        a = torch.rand(b, s_len, w, generator=gen, device="cuda") * 0.149 \
            + 0.85
        x = torch.randn(b, s_len, w, generator=gen, device="cuda") * 0.1
        got = {}
        taken = route_taken("rglru_scan", lambda: got.setdefault(  # noqa
            "out", api.run("rglru_scan", a, x, backend="cuda")))  # noqa
        err, tol, over = ulp_check(got["out"],
                                   api.run("rglru_scan", a, x, backend="ref"))
        emit({"phase": "kernel", "kernel": "rglru_scan",
              "case": f"edge B={b} S={s_len} W={w}", "route": taken,
              "max_abs_err": err, "tol": tol, "tol_rule": ULP_RULE,
              "max_err_over_limit": over})
        if taken != "chunked" or not over <= 1.0:
            raise AssertionError(f"rglru B={b} S={s_len} W={w}: route "
                                 f"{taken}, {over:.3f}x the limit")


def ssd_wgmma_products(args) -> dict:
    """The tensor-core work the SSD scan's wgmma route issues at these
    shapes, pieces included: its wgmma instructions (one m64 x n x k16
    bf16 product of a warpgroup each) and their flops; chunk states (w .
    x)^T B, C B^T, C . h_prev^T (chunks after the first) and s . x (the
    k-steps up to each warpgroup's last row)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import WGMMA_CHUNK, \
        WGMMA_PIECES
    q, k = WGMMA_CHUNK, WGMMA_PIECES
    B, S, H, P = args[0].shape
    N = args[1].shape[3]
    nc = -(-S // q)
    wgs = q // 64
    intra = sum(min(q // 16, (64 * wg + 63) // 16 + 1) for wg in range(wgs))
    per = {"chunk_states": (q // 16 * k, 2 * 64 * N * 16),
           "c_bt": (wgs * N // 16, 2 * 64 * q * 16),
           "c_h_prev": (wgs * k * N // 16, 2 * 64 * 64 * 16),
           "s_x": (intra * k, 2 * 64 * 64 * 16)}
    count = {name: B * H * (nc - 1 if name == "c_h_prev" else nc) * n
             for name, (n, _) in per.items()}
    flops = sum(count[name] * f for name, (_, f) in per.items())
    return {"wgmma_instructions": count, "flops": flops,
            "ms_at_bf16_peak": flops / BF16_FLOPS * 1e3,
            "chunk_state_bytes": B * nc * H * P * N * 4}


def scan_before_after(kernel, old, new, launch, label,
                      pairs: int = 10, phase: str = "kernel") -> dict:
    """The redesign against the kernel it replaced, on one card and the
    same inputs: `launch(route)` (the wrapper's `launch`, which counts
    nothing) through route `old` (the first port, unchanged) and route
    `new`, `pairs` pairs of `device_ms`, alternating which runs first."""
    times = {old: [], new: []}
    for i in range(pairs):
        for name in ((old, new) if i % 2 == 0 else (new, old)):
            times[name].append(device_ms(lambda: launch(name),  # noqa: B023
                                         calls=5, reps=3))
    q1, q3 = np.percentile(times[old], [25, 75])
    row = {"phase": phase, "case": f"{label}: {old} (before) vs {new}",
           "kernel": kernel, "pairs": pairs, "device_ms": times,
           "median_ms": {n: statistics.median(t) for n, t in times.items()},
           f"{old}_iqr_ms": q3 - q1,
           f"{new}_wins": sum(w < s for w, s in zip(times[new], times[old]))}
    emit(row)
    return row


def ssd_broken_variants(args, want, label) -> dict:
    """Plain loops broken on purpose against the plain version: the simt
    route's 64-chunk loop without chunk 1's inter-chunk term or without
    the ragged last chunk (`ssd_chunk_loop`), and the wgmma route's
    arithmetic (`ssd_wgmma_loop`) with the scores or w . x in one bf16
    piece or chunk 1's state left out of the state pass: each must exceed
    `ssd_limit`. h_prev in one piece is recorded beside them (the limit
    does not reject it at these shapes; the route keeps two pieces for
    the margin), as are both correct loops, which must meet it."""
    out = {fault: over_ssd_limit(ssd_chunk_loop(*args, fault=fault), want)
           for fault in ("drop_inter", "skip_ragged")}
    out["skip_state_chunk"] = over_ssd_limit(
        ssd_wgmma_loop(*args, fault="skip_state_chunk"), want)
    out["one_piece_scores"] = over_ssd_limit(
        ssd_wgmma_loop(*args, score_pieces=1), want)
    out["one_piece_wx"] = over_ssd_limit(
        ssd_wgmma_loop(*args, wx_pieces=1), want)
    kept = {"one_piece_state": over_ssd_limit(
        ssd_wgmma_loop(*args, fault="one_piece_state"), want),
        "chunk_loop": over_ssd_limit(ssd_chunk_loop(*args), want),
        "wgmma_loop": over_ssd_limit(ssd_wgmma_loop(*args), want)}
    emit({"phase": "kernel", "case": label, "kernel": "ssd_scan",
          "broken_over_limit": out, "recorded_over_limit": kept})
    if not (min(out.values()) > 1.0 >= max(kept["chunk_loop"],
                                           kept["wgmma_loop"])):
        raise AssertionError(f"ssd_limit does not separate broken from "
                             f"correct: {out}, {kept}")
    return {**out, **kept}


def scan_kernels() -> dict:
    """The SSD and RG-LRU scans: spec cases through the route each takes,
    the new routes' edge shapes, then full width against the plain
    versions, each row checking its route and timed by `device_ms` (SSD:
    `ssd_limit`, which the broken loops must exceed; RG-LRU: 2 ulps, which
    the chunked loop with a dropped carry must exceed), and the first
    port's kernel against the new route in 10 alternating pairs at the
    generate prefills' shapes."""
    from repro_torch.kernels import api
    from repro_torch.kernels.rglru_scan import rglru_scan as rg
    from repro_torch.kernels.ssd_scan import ssd_scan as sd
    spec_cases("ssd_scan", _ssd_case)
    spec_cases("rglru_scan", _rglru_case)
    ssd_edge_cases()
    full = {}
    mamba = dict(H=48, P=64, G=1, N=128)
    for (b, s_len), dtypes in (((1, 2048), ("bfloat16", "float32")),
                               ((1, 1000), ("bfloat16",)),
                               ((3, 1536), ("bfloat16",))):
        for name in dtypes:
            dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
            shape = dict(B=b, S=s_len, **mamba)
            args = ssd_inputs(shape, dtype, seed=s_len)
            nbytes, by_rate = ssd_bytes_and_flops(args)
            # one rate that gives the mix's time: flops / rate
            flops = sum(by_rate.values())
            rate = flops / sum(n / r for r, n in by_rate.items())

            def kernel():
                return api.run("ssd_scan", *args, backend="cuda")  # noqa

            taken = route_taken("ssd_scan", kernel)
            if taken != sd.route(dtype, s_len, 64, 128, 1):
                raise AssertionError(f"ssd B={b} S={s_len} {name}: route "
                                     f"{taken}")
            extra = {"kernel": "ssd_scan", "dtype": name, "shape": shape,
                     "route": taken,
                     "flops_by_peak": {f"{r:.3g}": n
                                       for r, n in by_rate.items()},
                     "bound_ms_bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "library": "none: no single PyTorch call computes the "
                                "SSD scan"}
            if taken == "wgmma":
                extra["wgmma"] = ssd_wgmma_products(args)
            label = f"ssd_scan mamba2-780m B={b} S={s_len} {name}"
            row = compare_and_time(
                label, kernel,
                lambda: api.run("ssd_scan", *args, backend="ref"),  # noqa
                None, nbytes, flops, rate, extra, check=ssd_check,
                rule=SSD_LIMIT_RULE, device=True)
            if s_len == 1000:
                want = api.run("ssd_scan", *args, backend="ref")
                row["broken_over_limit"] = ssd_broken_variants(
                    args, want, label)
                del want
            if (b, s_len, name) == (3, 1536, "bfloat16"):
                B, S, H, P = args[0].shape
                y = torch.empty(B, S, H, P, device="cuda")
                st = torch.empty(B, H, P, 128, device="cuda")
                scratch = sd.wgmma_scratch(B, S, H, 128, "cuda")
                row["before_after"] = scan_before_after(
                    "ssd_scan", "simt", "wgmma",
                    lambda r: sd.launch(*args, y, st, r,  # noqa: B023
                                        scratch=scratch), label)
                del y, st, scratch
            full[("ssd_scan", b, s_len, name)] = row
            del args
            torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rglru_edge_cases(gen)
    for b, s_len in ((1, 2048), (1, 1000), (2, 2300)):
        a = torch.rand(b, s_len, 2560, generator=gen, device="cuda") \
            * 0.149 + 0.85
        x = torch.randn(b, s_len, 2560, generator=gen, device="cuda") * 0.1

        def kernel():
            return api.run("rglru_scan", a, x, backend="cuda")  # noqa

        taken = route_taken("rglru_scan", kernel)
        if taken != rg.route(s_len):
            raise AssertionError(f"rglru S={s_len}: route {taken}")
        label = f"rglru_scan recurrentgemma-2b B={b} S={s_len} W=2560 float32"
        row = compare_and_time(
            label, kernel,
            lambda: api.run("rglru_scan", a, x, backend="ref"),  # noqa
            None, 3 * a.numel() * 4, 2 * a.numel(), FP32_FLOPS,
            {"kernel": "rglru_scan", "dtype": "float32", "route": taken,
             "chunk": rg.CHUNK, "shape": {"B": b, "S": s_len, "W": 2560},
             "library": "none: no single PyTorch call computes the linear "
                        "recurrence"}, device=True)
        if (b, s_len) == (2, 2300):
            want = api.run("rglru_scan", a, x, backend="ref")
            loop = rglru_chunked_loop(a, x)
            # the kernel takes the loop's operations in the loop's order
            row["kernel_equals_chunked_loop"] = torch.equal(kernel(), loop)
            row["chunked_loop_over_limit"] = ulp_check(loop, want)[2]
            del loop
            row["broken_over_limit"] = {
                fault: ulp_check(rglru_chunked_loop(a, x, fault=fault),
                                 want)[2] for fault in RGLRU_FAULTS}
            emit({"phase": "kernel", "case": label, "kernel": "rglru_scan",
                  "broken_over_limit": row["broken_over_limit"],
                  "chunked_loop_over_limit": row["chunked_loop_over_limit"],
                  "kernel_equals_chunked_loop":
                      row["kernel_equals_chunked_loop"]})
            if not (min(row["broken_over_limit"].values()) > 1.0
                    >= row["chunked_loop_over_limit"]) \
                    or not row["kernel_equals_chunked_loop"]:
                raise AssertionError(f"the 2-ulp limit does not separate "
                                     f"broken from correct: {row}")
            h = torch.empty_like(a)
            row["before_after"] = scan_before_after(
                "rglru_scan", "serial", "chunked",
                lambda r: rg.launch(a, x, h, r), label)  # noqa: B023
            del want, h
        full[("rglru_scan", b, s_len, "float32")] = row
        del a, x
    return full


# ---------------------------------------------------------------------------
# 3. exactness at full width
# ---------------------------------------------------------------------------
class EveryOtherSlow:
    """Placement policy: every other page goes to the slow (int8) tier."""

    def __init__(self):
        self.n = 0

    def place(self, feats):
        self.n += 1
        return "slow" if self.n % 2 == 0 else "fast"


def _requests(vocab, lengths, new, seed):
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, vocab, n).astype(np.int32), m)
            for n, m in zip(lengths, new)]


def _shared_prefix_requests(vocab, prefix, suffixes, new, seed):
    """Requests whose prompts share one `prefix`-token head."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, prefix).astype(np.int32)
    return [Request(np.concatenate([head, rng.integers(0, vocab, n)
                                    .astype(np.int32)]), new)
            for n in suffixes]


def _tokens(outs):
    return [None if o is None else o.tolist() for o in outs]


def phase_exact() -> dict:
    """Kernel and plain paths give identical greedy tokens at full width
    (2 layers, fp32) on every path the serving code has: the monolithic
    prefill (flash kernel) of `generate` and of ``serve(chunked_prefill=
    False)``, the default chunked + radix `serve` (k = page_tokens chunk
    fills, adopted prefixes) and a k = 4 speculative `serve`."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    cfg = get_config("starcoder2-7b", num_layers=2, param_dtype="float32",
                     compute_dtype="float32")
    lengths, new = [70, 130, 200, 257], [9, 12, 15, 18]
    v = cfg.vocab_size
    outs = {}
    for backend in ("auto", "ref"):
        def engine(speculate=0):
            return ServeEngine(cfg, seed=0, backend=backend,
                               speculate=speculate, kv_pool=PagedKVPool(
                                   page_tokens=64,
                                   placement_policy=EveryOtherSlow()))
        eng = engine()
        got = {"generate": _tokens(eng.generate(
            _requests(v, lengths, new, 0), free_pages=True))}
        got["serve_monolithic"] = _tokens(eng.serve(
            _requests(v, lengths, new, 1), max_active=2,
            chunked_prefill=False, radix=False))
        got["serve_chunked_radix"] = _tokens(eng.serve(
            _shared_prefix_requests(v, 150, [20, 90, 45, 130], 10, 2),
            max_active=2))
        got["prefix_hit_rate"] = eng.last_prefix_hit_rate
        if eng.kv_pool.live_pages:
            raise AssertionError("pages left in the pool")
        del eng
        eng = engine(speculate=4)
        got["serve_speculative_k4"] = _tokens(eng.serve(
            _requests(v, lengths, new, 3), max_active=2))
        got["spec_stats"] = eng.last_request_stats
        if eng.kv_pool.live_pages:
            raise AssertionError("pages left in the pool")
        outs[backend] = got
        del eng
        torch.cuda.empty_cache()
    paths = ("generate", "serve_monolithic", "serve_chunked_radix",
             "serve_speculative_k4")
    same = {p: outs["auto"][p] == outs["ref"][p] for p in paths}
    row = {"phase": "exact", "config": "starcoder2-7b full width, 2 layers, "
           "fp32", "page_tokens": 64, "prompt_lengths": lengths,
           "max_new": new, "identical_tokens": same,
           "prefix_hit_rate": outs["auto"]["prefix_hit_rate"],
           "spec_accept_rates": [d["accept_rate"] for d in
                                 outs["auto"]["spec_stats"]],
           **{p: outs["auto"][p] for p in paths}}
    emit(row)
    if not all(same.values()) or not outs["auto"]["prefix_hit_rate"]:
        raise AssertionError(f"kernel and plain tokens differ, or no prefix "
                             f"was adopted: {same}, {outs}")
    return row, exact_preempt(cfg), exact_hybrid(), exact_hybrid_swap()


def _session_run(eng, reqs, *, park, max_active=2, speculate=None):
    """Drive a `ServeSession` to its end. ``park`` maps a request index to
    the condition on its row (``"chunk"``: still streaming prompt chunks,
    ``"decode"``: decoding, at least 3 tokens out) under which it is
    preempted once; the admission loop resumes it. Returns the tokens and
    the session's preempt / resume counts."""
    from repro_torch.serve.engine import ServeSession
    cap = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    ses = ServeSession(eng, capacity=cap, max_active=max_active,
                       speculate=speculate)
    for r in reqs:
        if not ses.submit(r):
            raise AssertionError(f"rejected: {ses.request_stats(r)}")
    todo = dict(park)
    while not ses.done:
        ses.step()
        for i, when in list(todo.items()):
            act = ses._recs[id(reqs[i])].active
            if act is None:
                continue
            if (when == "chunk" and act.prefilling) or \
                    (when == "decode" and len(act.outs) >= 3):
                if not ses.preempt(reqs[i]):
                    raise AssertionError(f"request {i} did not park")
                del todo[i]
    if todo:
        raise AssertionError(f"never reached the park point: {todo}")
    ses.close()
    if eng.kv_pool.live_pages:
        raise AssertionError("pages left in the pool")
    return {"tokens": [ses.result(r).tolist() for r in reqs],
            "preemptions": ses.preemptions, "resumes": ses.resumes,
            "swap_out_bytes": eng.kv_pool.stats["swap_out_bytes"]}


def exact_preempt(cfg) -> dict:
    """Preempt / resume at full width, fp32 (2 layers): a `ServeSession`
    with one request parked mid chunk fill and one mid decode, and a k = 4
    speculative row parked mid decode, each resumed by the admission loop.
    Greedy tokens equal the never-preempted session's, with the kernels
    and with the plain versions (and kernel equals plain)."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    v = cfg.vocab_size
    cases = {"chunk_and_decode": ({0: "chunk", 1: "decode"}, 0,
                                  [200, 70], [12, 14]),
             "speculative_k4": ({0: "decode"}, 4, [130], [20])}
    out = {}
    for backend in ("auto", "ref"):
        for name, (park, k, lengths, new) in cases.items():
            for parked in (False, True):
                eng = ServeEngine(cfg, seed=0, backend=backend, speculate=k,
                                  kv_pool=PagedKVPool(
                                      page_tokens=64,
                                      placement_policy=EveryOtherSlow()))
                out[(backend, name, parked)] = _session_run(
                    eng, _requests(v, lengths, new, 7),
                    park=park if parked else {}, speculate=k or None)
                del eng
                torch.cuda.empty_cache()
    same = {f"{name} {backend}": out[(backend, name, True)]["tokens"]
            == out[(backend, name, False)]["tokens"]
            for backend in ("auto", "ref") for name in cases}
    same.update({f"{name} kernel vs plain": out[("auto", name, True)]
                 ["tokens"] == out[("ref", name, True)]["tokens"]
                 for name in cases})
    row = {"phase": "exact", "config": "starcoder2-7b full width, 2 layers, "
           "fp32", "path": "ServeSession preempt / resume (host tier)",
           "page_tokens": 64, "identical_tokens": same,
           **{name: {k: out[("auto", name, True)][k] for k in
                     ("tokens", "preemptions", "resumes", "swap_out_bytes")}
              for name in cases}}
    emit(row)
    parks = all(out[("auto", n, True)]["preemptions"] == len(cases[n][0])
                == out[("auto", n, True)]["resumes"] for n in cases)
    if not all(same.values()) or not parks:
        raise AssertionError(f"preempted tokens differ from the "
                             f"never-preempted run's: {same}, {out}")
    return row


def exact_hybrid_swap() -> list:
    """The reference's ``test_swap_out_in_bit_identical`` protocol at full
    width, fp32: mamba2-780m (2 SSD layers) and recurrentgemma-2b (3
    layers: RG-LRU, RG-LRU, local attention) prefill one 200-token prompt,
    decode 12 steps and park the sequence at step 6 — its recurrent slot
    read back whole, its ring pages to the host tier, its tail rows read
    back — while another sequence takes the freed slots; the resumed
    stream equals the uninterrupted one, with the kernels and with the
    plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.paged_decode import (PagedKVState,
                                                build_fused_step,
                                                extract_prefill_pages)
    from repro_torch.serve.paged_state import StateLayout
    from repro_torch.models import Model
    rows = []
    for arch, layers in (("mamba2-780m", 2), ("recurrentgemma-2b", 3)):
        cfg = get_config(arch, num_layers=layers, param_dtype="float32",
                         compute_dtype="float32")
        lay = StateLayout(cfg, 64)
        model = Model(cfg, device="cuda", seed=0)
        prompt = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (1, 200)).astype(np.int32)).cuda()
        out = {}
        for backend in ("auto", "ref"):
            for swap_at in (None, 6):
                pool = PagedKVPool(page_tokens=64,
                                   placement_policy=EveryOtherSlow())
                state = PagedKVState(pool, 256, lay, cfg.num_kv_heads,
                                     cfg.head_dim, device="cuda")
                logits, caches = model.forward_prefill(prompt,
                                                       backend=backend)
                extract_prefill_pages(model, caches, state, [0])
                del caches
                step = build_fused_step(model, state.slots, layout=lay,
                                        backend=backend)
                tok = torch.argmax(logits, -1).to(torch.int32)
                toks, parked = [int(tok[0])], {}
                for s in range(12):
                    if s == swap_at:
                        parked["out_bytes"] = state.swap_out(0)
                        parked["host_pages"] = pool.host_pages
                        state._ensure_rec_slot(99)   # takes the freed slots
                        if lay.n_kv:
                            state._ensure_tail_slot(99)
                        parked["in_bytes"] = state.swap_in(0)
                        tok = torch.tensor([toks[-1]], dtype=torch.int32,
                                           device="cuda")
                    _, tok = state.run_fused(step, tok, [0], 200 + s)
                    toks.append(int(tok[0]))
                for seq in (0, 99):
                    state.free_seq(seq)
                if pool.live_pages:
                    raise AssertionError(f"{arch}: pages left")
                out[(backend, swap_at)] = (toks, parked)
        same = {b: out[(b, 6)][0] == out[(b, None)][0]
                for b in ("auto", "ref")}
        same["kernel vs plain"] = out[("auto", 6)][0] == out[("ref", 6)][0]
        parked = out[("auto", 6)][1]
        row = {"phase": "exact", "config": f"{arch} full width, {layers} "
               "layers, fp32", "path": "PagedKVState swap_out / swap_in "
               "at decode step 6 of 12", "prompt": 200, "page_tokens": 64,
               "identical_tokens": same, "tokens": out[("auto", 6)][0],
               **parked}
        emit(row)
        if not all(same.values()) or not parked["out_bytes"] or \
                (lay.n_kv and not parked["host_pages"]):
            raise AssertionError(f"{arch}: swapped run differs or nothing "
                                 f"moved: {same}, {parked}")
        rows.append(row)
        del model
        torch.cuda.empty_cache()
    return rows


def exact_hybrid() -> list:
    """The hybrid stacks at full width, fp32: mamba2-780m with 2 SSD
    layers, recurrentgemma-2b with 3 (RG-LRU, RG-LRU, local attention).
    Kernel and plain paths give identical greedy tokens for `generate`
    (prefill through the SSD / RG-LRU scans and windowed flash
    attention), the default `serve` (chunked prefill through the
    one-token cores) and k = 4 speculative `serve`."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    lengths, new = [70, 130, 200, 257], [9, 12, 15, 18]
    paths = ("generate", "serve", "serve_speculative_k4")
    rows = []
    for arch, layers in (("mamba2-780m", 2), ("recurrentgemma-2b", 3)):
        cfg = get_config(arch, num_layers=layers, param_dtype="float32",
                         compute_dtype="float32")
        v = cfg.vocab_size
        outs = {}
        for backend in ("auto", "ref"):
            got = {}
            for path in paths:
                eng = ServeEngine(
                    cfg, seed=0, backend=backend,
                    speculate=4 if path == "serve_speculative_k4" else 0,
                    kv_pool=PagedKVPool(page_tokens=64,
                                        placement_policy=EveryOtherSlow()))
                reqs = _requests(v, lengths, new, paths.index(path))
                got[path] = _tokens(
                    eng.generate(reqs, free_pages=True)
                    if path == "generate" else eng.serve(reqs, max_active=2))
                if eng.kv_pool.live_pages:
                    raise AssertionError(f"{arch} {path}: pages left")
                del eng
                torch.cuda.empty_cache()
            outs[backend] = got
        same = {p: outs["auto"][p] == outs["ref"][p] for p in paths}
        row = {"phase": "exact", "config": f"{arch} full width, {layers} "
               f"layers, fp32", "page_tokens": 64, "prompt_lengths": lengths,
               "max_new": new, "identical_tokens": same,
               **{p: outs["auto"][p] for p in paths}}
        emit(row)
        if not all(same.values()):
            raise AssertionError(f"{arch}: kernel and plain tokens differ: "
                                 f"{same}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# 4. the main path at full size
# ---------------------------------------------------------------------------
def _counters():
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro_torch.kernels.hdiff.hdiff import hdiff
    from repro_torch.kernels.vadvc.vadvc import vadvc
    return {"paged_attention": paged_attention,
            "flash_attention": flash_attention,
            "ssd_scan": ssd_scan, "rglru_scan": rglru_scan,
            "hdiff": hdiff, "vadvc": vadvc}


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_serve() -> dict:
    """The first slice's workload through the monolithic-prefill path (kept
    so its numbers stay comparable): every prompt
    prefills in one pass through the flash-attention kernel, then decodes
    through the paged-attention kernel."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.steps import prefill_all_positions
    cfg = get_config("starcoder2-7b")
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, seed=0, kv_pool=PagedKVPool(
        page_tokens=128, placement_policy=EveryOtherSlow()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lengths, new = [120, 250, 380, 500, 600], [32] * 5
    reqs = _requests(cfg.vocab_size, lengths, new, 2)
    steps0 = eng.stats["decode_steps"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve(reqs, max_active=2, chunked_prefill=False, radix=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    steps = eng.stats["decode_steps"] - steps0
    for o in outs:
        if o is None or len(o) != 32 or not ((0 <= o) & (o < cfg.vocab_size)).all():
            raise AssertionError(f"bad output {o}")
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
    if launches["paged_attention"] != steps * cfg.num_layers:
        raise AssertionError(f"{launches} launches for {steps} steps")
    if launches["flash_attention"] != len(reqs) * cfg.num_layers:
        raise AssertionError(f"{launches} launches for {len(reqs)} prefills")
    flash = routes("flash_attention")
    if flash != {"wgmma": launches["flash_attention"], "simt": 0}:
        raise AssertionError(f"flash launches by route {flash}: the bf16 "
                             f"prefill must take the wgmma route")
    paged = routes("paged_attention")
    if paged != {"split": launches["paged_attention"], "wgmma": 0,
                 "simt": 0}:
        raise AssertionError(f"paged launches by route {paged}: decode must "
                             f"take the split route")
    steady = eng.last_steady_transfers
    if not steady or any(s != (1, 1) for s in steady):
        raise AssertionError(f"steady-state transfers {steady}")
    decode_tokens = eng.stats["tokens"] - len(reqs)
    # prefill of each prompt with the flash kernel and with the plain
    # version (the materialized fp32 softmax the prefill ran before the
    # kernel), in alternation, synchronized
    ab = {"kernel": [], "plain": []}
    for r in reqs:
        toks = torch.from_numpy(r.prompt[None]).cuda()
        for _ in range(2):
            for name, backend in (("kernel", "auto"), ("plain", "ref")):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                prefill_all_positions(eng.model, toks, backend=backend)
                torch.cuda.synchronize()
                ab[name].append((time.perf_counter() - t1) * 1e3)
    row = {"phase": "serve", "config": "starcoder2-7b, 32 layers, bf16",
           "path": "monolithic prefill (chunked_prefill=False, radix=False)",
           "params": sum(p.numel() for p in eng.model.parameters()),
           "init_s": init_s, "requests": len(reqs), "prompt_lengths": lengths,
           "max_new": 32, "max_active": 2, "page_tokens": 128,
           "wall_s": wall_s, "decode_steps": steps, "launches": launches,
           "flash_launches_by_route": flash,
           "paged_launches_by_route": paged,
           "prefill_ms_per_request": eng.stats["prefill_s"] / len(reqs) * 1e3,
           "prefill_forward_ms_by_prompt": {
               "kernel": [statistics.median(ab["kernel"][2 * i:2 * i + 2])
                          for i in range(len(reqs))],
               "plain": [statistics.median(ab["plain"][2 * i:2 * i + 2])
                         for i in range(len(reqs))]},
           "decode_ms_per_step": eng.stats["decode_s"] / steps * 1e3,
           "decode_tok_s": decode_tokens / eng.stats["decode_s"],
           "steady_steps": len(steady), "transfers_per_steady_token": 2,
           "transfers": eng.last_transfers,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "pool": {k: eng.kv_pool.stats[k] for k in
                    ("fast_hits", "slow_hits", "evictions")}}
    emit(row)
    return row, eng


def _shared_engine(eng, **kw):
    """A new engine over the same weights (no copy) and a fresh pool."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    return ServeEngine(eng.cfg, params=dict(eng.model.weights
                                            .named_parameters()),
                       kv_pool=PagedKVPool(page_tokens=128,
                                           placement_policy=EveryOtherSlow()),
                       **kw)


def drive_session(eng, reqs, max_active=2) -> dict:
    """The reference's default serving path, step by step: a
    `ServeSession` with chunked prefill and the radix prefix cache on.
    Returns per-request time to first token and per-step times, split
    into steps that carried a prompt chunk and steps that only decoded."""
    from repro_torch.serve.engine import ServeSession
    cap = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    session = ServeSession(eng, capacity=cap, max_active=max_active)
    t0 = time.perf_counter()
    for r in reqs:
        if not session.submit(r):
            raise AssertionError(f"request rejected: {session.request_stats(r)}")
    ttft, wide_ms, narrow_ms = {}, [], []
    while not session.done:
        chunks0 = session.chunk_steps
        t1 = time.perf_counter()
        events = session.step()
        torch.cuda.synchronize()
        now = time.perf_counter()
        (wide_ms if session.chunk_steps > chunks0 else narrow_ms).append(
            (now - t1) * 1e3)
        for ev in events:
            if ev.tokens and id(ev.request) not in ttft:
                ttft[id(ev.request)] = (now - t0) * 1e3
    outs = [session.result(r) for r in reqs]
    stats = [session.request_stats(r) for r in reqs]
    hit_rate = session.prefix_hit_rate
    session.close()
    return {"outs": outs, "stats": stats, "hit_rate": hit_rate,
            "ttft_ms": [ttft[id(r)] for r in reqs], "wide_ms": wide_ms,
            "narrow_ms": narrow_ms, "wall_s": time.perf_counter() - t0,
            "steps": session.steps, "chunked": session.chunked,
            "radix": session.radix,
            "steady": list(session.steady_transfers)}


def _check_outs(outs, reqs, vocab):
    for o, r in zip(outs, reqs):
        if o is None or len(o) != r.max_new_tokens or \
                not ((0 <= o) & (o < vocab)).all():
            raise AssertionError(f"bad output {o}")


def check_paged_routes(run, n_layers) -> dict:
    """A session's paged launches by route: its chunk-fill (k = 128) steps
    on the wgmma route, its other steps (decode, k = 4 verify) on split."""
    paged = routes("paged_attention")
    chunk = len(run["wide_ms"])
    want = {"split": (run["steps"] - chunk) * n_layers,
            "wgmma": chunk * n_layers, "simt": 0}
    if paged != want:
        raise AssertionError(f"paged launches by route {paged}, want {want}")
    return paged


def phase_chunked(base) -> dict:
    """The reference's default `serve` path at full width: 6 requests whose
    prompts share a 512-token head (4 pages), prefilled in page-sized
    chunks riding k = 128 verify steps (the row-blocked paged-attention
    kernel: 1152 query rows per kv head), with later requests adopting the
    cached head from the radix prefix tree."""
    eng = _shared_engine(base)
    cfg = eng.cfg
    reqs = _shared_prefix_requests(cfg.vocab_size, 512,
                                   [40, 130, 250, 70, 300, 10], 32, 4)
    reset_launches()
    run = drive_session(eng, reqs)
    launches = read_launches()
    _check_outs(run["outs"], reqs, cfg.vocab_size)
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left after "
                             f"close")
    if not run["hit_rate"]:
        raise AssertionError(f"no prefix hit: {run['hit_rate']}")
    if not run["wide_ms"]:
        raise AssertionError("no chunk-fill (k = 128) step ran")
    if launches["paged_attention"] != run["steps"] * cfg.num_layers or \
            launches["flash_attention"]:
        raise AssertionError(f"{launches} launches for {run['steps']} steps")
    paged = check_paged_routes(run, cfg.num_layers)
    row = {"phase": "chunked", "config": "starcoder2-7b, 32 layers, bf16",
           "path": "default serve: chunked prefill + radix prefix cache",
           "requests": len(reqs), "shared_prefix": 512,
           "prompt_lengths": [len(r.prompt) for r in reqs], "max_new": 32,
           "max_active": 2, "page_tokens": 128, "launches": launches,
           "paged_launches_by_route": paged,
           "steps": run["steps"], "chunk_steps": len(run["wide_ms"]),
           "prefix_hit_rate": run["hit_rate"], "wall_s": run["wall_s"],
           "ttft_ms": run["ttft_ms"],
           "chunk_step_ms_mean": statistics.mean(run["wide_ms"]),
           "prefill_ms_per_request": sum(run["wide_ms"]) / len(reqs),
           "decode_ms_per_step": statistics.mean(run["narrow_ms"]),
           "decode_steps": len(run["narrow_ms"])}
    emit(row)
    row["profile"] = phase_profile(eng, steps=4, k=128)
    return row


def phase_spec(base) -> dict:
    """k = 4 speculative decode with n-gram drafts through the default
    serve path, on the serve phase's workload."""
    eng = _shared_engine(base, speculate=4)
    cfg = eng.cfg
    reqs = _requests(cfg.vocab_size, [120, 250, 380, 500, 600], [32] * 5, 2)
    reset_launches()
    run = drive_session(eng, reqs)
    launches = read_launches()
    _check_outs(run["outs"], reqs, cfg.vocab_size)
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
    if launches["paged_attention"] != run["steps"] * cfg.num_layers:
        raise AssertionError(f"{launches} launches for {run['steps']} steps")
    paged = check_paged_routes(run, cfg.num_layers)
    proposed = sum(d["proposed"] for d in run["stats"])
    accepted = sum(d["accepted"] for d in run["stats"])
    decode_tokens = sum(d["tokens"] - 1 for d in run["stats"])
    verify_steps = sum(d["steps"] for d in run["stats"])
    row = {"phase": "spec", "config": "starcoder2-7b, 32 layers, bf16",
           "path": "default serve, speculate=4, n-gram draft",
           "requests": len(reqs), "max_new": 32, "max_active": 2,
           "launches": launches, "paged_launches_by_route": paged,
           "steps": run["steps"], "chunk_steps": len(run["wide_ms"]),
           "accept_rate": accepted / proposed if proposed else None,
           "tokens_per_step": decode_tokens / verify_steps,
           "per_request": [{k: d[k] for k in ("accept_rate",
                                              "tokens_per_step")}
                           for d in run["stats"]],
           "verify_step_ms_mean": statistics.mean(run["narrow_ms"]),
           "verify_steps": len(run["narrow_ms"]),
           "ttft_ms": run["ttft_ms"], "wall_s": run["wall_s"]}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# 7. overload: the main path under load (SLO scheduling, host swap tier)
# ---------------------------------------------------------------------------
ARRIVAL_X_SERVICE = 2.0             # arrival rate / measured service rate
DEADLINE_X_STEP = (10, 80, 600)     # the mix's 3 deadline classes, in steps
OVERLOAD_PROMPTS = (120, 250, 380, 500, 600)    # the serve phase's range
OVERLOAD_NEW = (16, 24, 32)


class SwapTimer:
    """CUDA events (and the host clock) around every `PagedKVState`
    swap_out / swap_in while installed: the ms each takes on the card's
    stream. A swap-out ends in a host copy, so its events bracket the
    readback; a swap-in's pages upload at the next step's sync, so its
    events bracket the tail rows' and recurrent state's writes only."""

    def __init__(self):
        from repro_torch.serve.paged_decode import PagedKVState
        self.cls = PagedKVState
        self.orig = {n: getattr(PagedKVState, n) for n in ("swap_out",
                                                            "swap_in")}
        self.events = {n: [] for n in self.orig}

    def __enter__(self):
        def wrap(name, fn):
            def timed(state, seq):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                moved = fn(state, seq)
                host = (time.perf_counter() - t0) * 1e3
                end.record()
                self.events[name].append((start, end, host))
                return moved
            return timed
        for name, fn in self.orig.items():
            setattr(self.cls, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)

    def summary(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for name, evs in self.events.items():
            dev = [a.elapsed_time(b) for a, b, _ in evs]
            host = [h for _, _, h in evs]
            out[name] = {"n": len(evs),
                         "ms_median": statistics.median(dev) if dev else None,
                         "ms_max": max(dev) if dev else None,
                         "host_ms_median": statistics.median(host)
                         if host else None}
        return out


def _recording_frontend():
    """A front-end class that keeps every instance, so the phase can read
    the session `traffic.run_trace` built (its step counts)."""
    from repro_torch.serve.frontend import AsyncServeFrontend
    made = []

    class Recorded(AsyncServeFrontend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    return Recorded, made


def phase_overload(base, serve_row, smi: str) -> dict:
    """The main path under load, through the entry points a user calls:
    the reference's ``overload`` mix (16 requests, deadline classes,
    priorities 0 / 1) replayed open-loop by `traffic.run_trace` through
    `AsyncServeFrontend` over the serve phase's weights (starcoder2-7b,
    32 layers, bf16, 128-token pages, every other one int8), with the
    mix's prompt and output lengths scaled to the serve phase's range,
    the arrival rate set to ARRIVAL_X_SERVICE times the service rate the
    serve phase measured and the deadlines to DEADLINE_X_STEP times its
    decode step. ``REPRO_SERVE_DEBUG`` checks the pool invariants after
    every step. Then a fault pass (``REPRO_SERVE_FAULT=swap_fail:1``)
    and one recurrentgemma-2b request parked and resumed at full depth."""
    import os
    from repro_torch.serve import traffic
    from repro_torch.serve.frontend import AsyncServeFrontend
    eng = _shared_engine(base)
    cfg = eng.cfg
    service_rps = serve_row["requests"] / serve_row["wall_s"]
    step_s = serve_row["decode_ms_per_step"] / 1e3
    mix = traffic.MIXES["overload"]
    spec = mix.override(prompt_lens=OVERLOAD_PROMPTS, new_tokens=OVERLOAD_NEW,
                        arrival_rate=ARRIVAL_X_SERVICE * service_rps,
                        deadlines=tuple(m * step_s for m in DEADLINE_X_STEP))
    recorded, fronts = _recording_frontend()
    traffic.AsyncServeFrontend = recorded
    os.environ["REPRO_SERVE_DEBUG"] = "1"
    reset_launches()
    try:
        with SwapTimer() as timer:
            t0 = time.perf_counter()
            summary = traffic.run_trace(eng, spec, max_active=2,
                                        max_queue=16)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        traffic.AsyncServeFrontend = AsyncServeFrontend
        del os.environ["REPRO_SERVE_DEBUG"]
    launches = read_launches()
    paged = routes("paged_attention")
    ses = fronts[0].session
    if not ses._debug:
        raise AssertionError("the session did not run with "
                             "REPRO_SERVE_DEBUG")
    accounted = sum(summary[k] for k in ("n_done", "n_cancelled",
                                         "n_rejected", "n_errors"))
    want_routes = {"split": (ses.steps - ses.chunk_steps) * cfg.num_layers,
                   "wgmma": ses.chunk_steps * cfg.num_layers, "simt": 0}
    steady = list(ses.steady_transfers)
    pool = eng.kv_pool
    swaps = timer.summary()
    row = {"phase": "overload", "config": "starcoder2-7b, 32 layers, bf16",
           "path": "traffic.run_trace -> AsyncServeFrontend -> ServeSession "
                   "(chunked prefill + radix, preemption on, LRU victims)",
           "nvidia_smi": smi, "mix": "overload", "n_requests": spec.n_requests,
           "prompt_lens": list(spec.prompt_lens),
           "new_tokens": list(spec.new_tokens),
           "priorities": list(spec.priorities), "max_active": 2,
           "max_queue": 16, "page_tokens": 128,
           "service_rate_rps": service_rps,
           "arrival_x_service": ARRIVAL_X_SERVICE,
           "arrival_rate_rps": spec.arrival_rate,
           "decode_step_s": step_s, "deadline_x_step": list(DEADLINE_X_STEP),
           "deadlines_s": list(spec.deadlines),
           "mix_deadlines_s": list(mix.deadlines),
           "wall_s": wall_s, "steps": ses.steps,
           "chunk_steps": ses.chunk_steps, "launches": launches,
           "paged_launches_by_route": paged,
           "steady_steps": len(steady),
           "summary": summary, "swap_ms": swaps,
           "pool_swap": {k: pool.stats[k] for k in (
               "swapped_out", "swapped_in", "swap_out_bytes",
               "swap_in_bytes")},
           "invariants_checked_every_step": True}
    emit(row)
    if accounted != spec.n_requests or summary["n_trace"] != spec.n_requests:
        raise AssertionError(f"{accounted} of {spec.n_requests} requests "
                             f"accounted for: {summary}")
    if not summary["preemptions"] or not ses.preemptions or \
            not summary["swap_out_bytes"] or not summary["swap_in_bytes"]:
        raise AssertionError(f"no preemption with swap traffic: {summary}")
    if summary["pool_live_pages_end"] or pool.live_pages:
        raise AssertionError(f"{pool.live_pages} pages left after close")
    if paged != want_routes:
        raise AssertionError(f"paged launches by route {paged}, want "
                             f"{want_routes}")
    if any(s != (1, 1) for s in steady):
        raise AssertionError(f"steady-state transfers {steady}")
    row["fault"] = overload_fault_pass(eng)
    row["hybrid"] = overload_hybrid_park()
    return row


def overload_fault_pass(eng) -> dict:
    """``REPRO_SERVE_FAULT=swap_fail:1``: two priority-0 requests decode,
    a priority-1 arrival parks one of them, and its swap-in at resume
    fails. The victim must end as a ``swap_fail`` error event with its
    partial tokens; the other two finish; the pool ends empty."""
    import os
    from repro_torch.serve.engine import ServeSession
    from repro_torch.serve.metrics import MetricsRegistry
    cfg = eng.cfg
    reqs = _requests(cfg.vocab_size, [250, 380, 120], [24, 24, 16], 9)
    reqs[2].priority = 1
    metrics = MetricsRegistry()
    os.environ["REPRO_SERVE_FAULT"] = "swap_fail:1"
    try:
        ses = ServeSession(eng, capacity=420, max_active=2, metrics=metrics)
    finally:
        del os.environ["REPRO_SERVE_FAULT"]
    events = []
    for r in reqs[:2]:
        ses.submit(r)
    while not all(ses._recs[id(r)].active is not None
                  and len(ses._recs[id(r)].active.outs) >= 4
                  for r in reqs[:2]):
        events += ses.step()
    ses.submit(reqs[2])
    while not ses.done:
        events += ses.step()
    ses.close()
    errors = [(next(i for i, r in enumerate(reqs) if r is ev.request),
               ev.done) for ev in events if ev.error == "swap_fail"]
    status = [ses._recs[id(r)].status for r in reqs]
    s = metrics.summary()
    row = {"phase": "overload", "case": "REPRO_SERVE_FAULT=swap_fail:1",
           "requests": [len(r.prompt) for r in reqs],
           "priorities": [r.priority for r in reqs],
           "status": status, "swap_fail_events": errors,
           "tokens": [len(ses.result(r)) for r in reqs],
           "preemptions": ses.preemptions, "n_errors": s["n_errors"],
           "n_done": s["n_done"], "live_pages": eng.kv_pool.live_pages}
    emit(row)
    if len(errors) != 1 or sorted(status) != ["done", "done", "error"] \
            or status[2] != "done" or not errors[0][1] \
            or eng.kv_pool.live_pages or s["n_errors"] != 1:
        raise AssertionError(f"fault pass: {row}")
    return row


def overload_hybrid_park() -> dict:
    """recurrentgemma-2b at full depth, bf16: one request parked mid
    decode and resumed through `ServeSession.preempt` / `resume` (its
    recurrent slots read back whole, its ring pages to the host tier).
    Its outcome is checked: it terminates, the pool ends empty, its ring
    pages stay within ``ring_pages()``, and the recurrent store is read
    back only by the swap (one read per store tensor)."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine, ServeSession
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.paged_state import rec_array_names
    cfg = get_config("recurrentgemma-2b")
    eng = ServeEngine(cfg, seed=0, kv_pool=PagedKVPool(
        page_tokens=128, placement_policy=EveryOtherSlow()))
    [req] = _requests(cfg.vocab_size, [300], [24], 10)
    ses = ServeSession(eng, capacity=324, max_active=1)
    ses.submit(req)
    lay, pool = eng.layout, eng.kv_pool
    ring_max, parked = 0, None
    with SwapTimer() as timer:
        while not ses.done:
            ses.step()
            rec = ses._recs[id(req)]
            if rec.active is not None:
                ring_max = max(ring_max,
                               len(pool.seq_pages(rec.active.seq, 0)))
            if parked is None and rec.active is not None \
                    and len(rec.active.outs) >= 8:
                reads0 = ses.state._rec.reads
                if not ses.preempt(req):
                    raise AssertionError("recurrentgemma request did not park")
                parked = {"host_pages": pool.host_pages,
                          "rec_reads": ses.state._rec.reads - reads0,
                          "swap_out_bytes": pool.stats["swap_out_bytes"]}
                if not ses.resume(req):
                    raise AssertionError("recurrentgemma request did not "
                                         "resume")
    ses.close()
    n_names = len(rec_array_names(lay))
    store = ses.state.rec_store_counts()
    row = {"phase": "overload", "case": "recurrentgemma-2b, 26 layers, bf16:"
           " park and resume one request", "prompt": 300, "max_new": 24,
           "tokens": len(ses.result(req)), "status": ses._recs[id(req)].status,
           "parked": parked, "ring_pages_max": ring_max,
           "ring_pages_bound": lay.ring_pages(), "rec_store": store,
           "swap_ms": timer.summary(), "live_pages": pool.live_pages,
           "preemptions": ses.preemptions, "resumes": ses.resumes}
    emit(row)
    if row["status"] != "done" or row["tokens"] != 24 or pool.live_pages \
            or ring_max > lay.ring_pages() or parked is None \
            or not parked["host_pages"] or parked["rec_reads"] != n_names \
            or store["reads"] != n_names:
        raise AssertionError(f"recurrentgemma park / resume: {row}")
    del eng, ses
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _hybrid_generate(eng, reqs, n_layers_by_kernel) -> dict:
    """One `generate` call of a hybrid engine with the counts set to 0
    just before it: launches, recurrent-store traffic, transfers, times."""
    from repro_torch.serve.paged_state import rec_array_names
    seq0 = eng._next_seq
    st0 = dict(eng.stats)
    reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    flash = routes("flash_attention")
    _check_outs(outs, reqs, eng.cfg.vocab_size)
    for name, n in n_layers_by_kernel.items():
        if launches[name] != n:       # one batched prefill per generate
            raise AssertionError(f"{launches} launches, want {name} == {n}")
    if flash != {"wgmma": launches["flash_attention"], "simt": 0}:
        raise AssertionError(f"flash launches by route {flash}: the bf16 "
                             f"windowed prefill must take the wgmma route")
    scans = {"ssd_scan": routes("ssd_scan"),
             "rglru_scan": routes("rglru_scan")}
    if scans != {"ssd_scan": {"wgmma": launches["ssd_scan"], "simt": 0},
                 "rglru_scan": {"chunked": launches["rglru_scan"],
                                "serial": 0}}:
        raise AssertionError(f"scan launches by route {scans}: the bf16 SSD "
                             f"prefill must take the wgmma route, the "
                             f"RG-LRU prefill the chunked route")
    steps = eng.stats["decode_steps"] - st0["decode_steps"]
    store = eng.last_rec_store
    # the prefill installs one block per recurrent tensor and sequence;
    # decode never reads a state back nor writes one from the host
    n_names = len(rec_array_names(eng.layout))
    if store["reads"] or store["writes"] != n_names * len(reqs):
        raise AssertionError(f"recurrent store {store}, want "
                             f"{n_names * len(reqs)} writes, 0 reads")
    h2d, d2h = eng.last_transfers
    seqs = list(range(seq0, eng._next_seq))
    return {"outs": outs, "launches": launches,
            "flash_launches_by_route": flash,
            "scan_launches_by_route": scans, "steps": steps,
            "wall_s": wall_s, "seqs": seqs, "transfers": [h2d, d2h],
            "rec_store": dict(store),
            "prefill_ms_per_request":
                (eng.stats["prefill_s"] - st0["prefill_s"]) / len(reqs) * 1e3,
            "decode_ms_per_step":
                (eng.stats["decode_s"] - st0["decode_s"]) / steps * 1e3}


def _hybrid_serve(eng, reqs) -> dict:
    """The default `serve` path (a `ServeSession`) of a hybrid engine:
    chunked prefill through the one-token cores, no scan launches."""
    reset_launches()
    run = drive_session(eng, reqs, max_active=len(reqs))
    launches = read_launches()
    _check_outs(run["outs"], reqs, eng.cfg.vocab_size)
    if launches["ssd_scan"] or launches["rglru_scan"] or \
            launches["flash_attention"]:
        raise AssertionError(f"serve() launched a prefill kernel: {launches}")
    if not run["chunked"] or run["radix"]:
        raise AssertionError("a hybrid session must chunk, without radix")
    if not run["steady"] or any(s != (1, 1) for s in run["steady"]):
        raise AssertionError(f"steady-state transfers {run['steady']}")
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
    return {"launches": launches, "steps": run["steps"],
            "chunk_steps": len(run["wide_ms"]),
            "chunk_step_ms_mean": statistics.mean(run["wide_ms"]),
            "decode_ms_per_step": statistics.mean(run["narrow_ms"]),
            "steady_steps": len(run["steady"]),
            "transfers_per_steady_token": 2, "ttft_ms": run["ttft_ms"],
            "wall_s": run["wall_s"]}


def phase_hybrid() -> dict:
    """The hybrid stacks at full depth, bf16, seeded random weights made on
    the card: `generate` prefills through the SSD / RG-LRU scan kernels
    (and, for recurrentgemma's local-attention layers, the flash kernel
    with a 2048 window), then decodes with one recurrent slot per
    sequence and ring pages; the default `serve` streams short prompts
    in page-sized chunks through the one-token cores."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    from repro_torch.serve.paged_state import StateLayout
    rows, launches = {}, {}
    for arch, gen_lengths, gen_new, serve_lengths in (
            ("mamba2-780m", [256, 700, 1536], 32, [200, 280, 350]),
            ("recurrentgemma-2b", [2300, 1000], 40, [150, 220, 300])):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, seed=0, kv_pool=PagedKVPool(
            page_tokens=128, placement_policy=EveryOtherSlow()))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        lay = StateLayout(cfg, 128)
        per_prefill = {"ssd_scan": lay.n_ssd, "rglru_scan": lay.n_rg,
                       "flash_attention": lay.n_kv, "paged_attention": 0}
        torch.cuda.reset_peak_memory_stats()
        gen = _hybrid_generate(
            eng, _requests(cfg.vocab_size, gen_lengths,
                           [gen_new] * len(gen_lengths), 5), per_prefill)
        row = {"phase": "hybrid", "config": f"{arch}, {cfg.num_layers} "
               f"layers, bf16", "params": sum(
                   p.numel() for p in eng.model.parameters()),
               "init_s": init_s, "page_tokens": 128,
               "generate": {"prompt_lengths": gen_lengths,
                            "padded_to": max(gen_lengths),
                            "max_new": gen_new,
                            **{k: v for k, v in gen.items()
                               if k not in ("outs", "seqs")}}}
        if lay.has_ring:
            pool = eng.kv_pool
            live = [len(pool.seq_pages(s, 0)) for s in gen["seqs"]]
            # nothing but ring drops frees a page inside generate()
            drops = pool.stats["freed"]
            row["generate"].update(ring_pages_live=live,
                                   ring_pages_max=lay.ring_pages(),
                                   ring_pages_dropped_in_decode=drops)
            if max(live) > lay.ring_pages() or not drops:
                raise AssertionError(f"ring pages {live} (max "
                                     f"{lay.ring_pages()}), {drops} drops")
            for seq in gen["seqs"]:
                pool.free(seq)
        elif gen["transfers"][1] != gen["steps"] or \
                gen["transfers"][0] - gen["rec_store"]["writes"] \
                != gen["steps"]:
            # pure SSM: one control upload and one token download per
            # step, nothing else crosses
            raise AssertionError(f"transfers {gen['transfers']} for "
                                 f"{gen['steps']} steps")
        row["generate"]["peak_mem_gb"] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        launches[arch] = gen["launches"]
        # the chunk step holds all k = page_tokens recurrent checkpoints
        # of every recurrent layer until its accept rule, as the reference
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated() / 2 ** 30
        row["serve"] = {"prompt_lengths": serve_lengths, "max_new": 16,
                        **_hybrid_serve(eng, _requests(
                            cfg.vocab_size, serve_lengths,
                            [16] * len(serve_lengths), 6))}
        row["serve"].update(mem_before_gb=mem0, peak_mem_gb=torch.cuda
                            .max_memory_allocated() / 2 ** 30)
        emit(row)
        row["profile"] = phase_profile(eng)
        rows[arch] = row
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return rows, launches


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def phase_profile(eng, steps: int = 16, k: int = 1) -> dict:
    """Steps of 2 rows at ~500 tokens of context, timed without and then
    with `torch.profiler`: device busy share of the traced window (union
    of kernel intervals over its wall time), kernels per step, the paged
    kernel's and the port's kernels' share of the busy time and the
    kernels that take the most device time. ``k`` = 1: decode steps; k >
    1: chunk-fill steps, each feeding k tokens a row through the k-row
    step (`build_fused_step(k=...)`) as the default `serve()` feeds a
    prompt chunk. Any stack the engine serves (the hybrids' decode runs
    none of the port's kernels: their recurrent and ring layers step
    through plain PyTorch, as the reference's do through jnp)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.paged_decode import (PagedKVState,
                                                build_fused_step,
                                                extract_prefill_pages)
    cfg = eng.cfg
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 500)).astype(np.int32)).cuda()
    state = PagedKVState(eng.kv_pool, 500 + (2 * steps + 3) * k + 8,
                         eng.layout, cfg.num_kv_heads, cfg.head_dim,
                         batch_hint=2, device=eng.device)
    logits, caches = eng.model.forward_prefill(prompts)
    seqs = [10_000, 10_001]
    extract_prefill_pages(eng.model, caches, state, seqs)
    del caches
    step_fn = build_fused_step(eng.model, state.slots, k=k,
                               layout=eng.layout)
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = 500

    def one_step():
        nonlocal tok, pos
        if k == 1:
            _, tok = state.run_fused(step_fn, tok, seqs, pos)
        else:
            chunk = rng.integers(0, cfg.vocab_size, (2, k)).astype(np.int32)
            state.run_spec(step_fn, chunk, seqs, pos)
            state.end_step(seqs, [k, k])
        pos += k

    for _ in range(3 if k == 1 else 1):              # warm-up
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    plain_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    attn_us = sum(v for k, v in by_name.items() if "paged_attention" in k)
    port_us = sum(v for k, v in by_name.items()
                  if any(name in k for name in KERNELS))
    for seq in seqs:
        state.free_seq(seq)
    row = {"phase": "profile", "config": f"{cfg.name}, {cfg.num_layers} "
           f"layers, {cfg.compute_dtype}", "rows": 2, "context": 500,
           "k": k, "steps": steps,
           ("decode_ms_per_step" if k == 1 else "chunk_step_ms"): plain_ms,
           "traced_ms_per_step": traced_s / steps * 1e3,
           "device_busy_share": busy_us / (traced_s * 1e6),
           "kernels_per_step": len(kernels) / steps,
           "paged_attention_share_of_busy": attn_us / busy_us if busy_us
           else None,
           "paged_attention_us_per_launch":
               attn_us / (steps * cfg.num_layers),
           "port_kernels_share_of_busy": port_us / busy_us if busy_us
           else None,
           "top_kernels_us_per_step": [[k[:80], v / steps] for k, v in top]}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# 8. the stencil path: NERO's COSMO hdiff and vadvc
# ---------------------------------------------------------------------------
EXACT_RULE = ("bit equality with the plain version on the same inputs "
              "(NaN where it has NaN): both round each operation once, in "
              "the same order")
L2_BYTES = 50e6                  # H100 L2 cache
SLEEP_CYCLES = 10_000_000        # ~5 ms of `torch.cuda._sleep` at 1.98 GHz
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def exact_check(got, want) -> dict:
    """`EXACT_RULE`: the elements that differ, the largest difference and
    its distance in ulps of |want| (in want's dtype)."""
    g, w = got.float(), want.float()
    same = (g == w) | (g.isnan() & w.isnan())
    diff = torch.where(same, 0.0, (g - w).abs().nan_to_num(nan=float("inf")))
    mant = {torch.float32: 23, torch.bfloat16: 7}[want.dtype]
    ulp = torch.exp2(torch.floor(torch.log2(
        w.double().abs().nan_to_num(0.0).clamp_min(2.0 ** -126))) - mant)
    return {"mismatches": int((~same).sum()),
            "max_abs_err": diff.max().item(),
            "max_ulps": (diff.double() / ulp).max().item()}


def hdiff_variant(src, fault=None):
    """The hdiff algorithm of `kernels/hdiff/ref.py` once more, in plain
    PyTorch; ``fault="skip_limiter"`` skips the limiter of the x flux at
    each cell's east face, to show that `exact_check` catches a kernel
    that does."""
    from repro_torch.kernels.hdiff.ref import COEFF, HALO
    nz, ny, nx = src.shape
    p = src.float()

    def s(dy, dx):
        return p[:, 2 + dy:ny - 2 + dy, 2 + dx:nx - 2 + dx]

    def lap(dy, dx):
        return (4.0 * s(dy, dx) - (s(dy - 1, dx) + s(dy + 1, dx)
                                   + s(dy, dx - 1) + s(dy, dx + 1)))

    def limited(flx, dif, skip=False):
        return flx if skip else torch.where(flx * dif > 0, 0.0, flx)

    lap_c = lap(0, 0)
    flx_c = limited(lap(0, 1) - lap_c, s(0, 1) - s(0, 0),
                    skip=fault == "skip_limiter")
    flx_m = limited(lap_c - lap(0, -1), s(0, 0) - s(0, -1))
    fly_c = limited(lap(1, 0) - lap_c, s(1, 0) - s(0, 0))
    fly_m = limited(lap_c - lap(-1, 0), s(0, 0) - s(-1, 0))
    out = src.clone()
    out[:, HALO:ny - HALO, HALO:nx - HALO] = (
        s(0, 0) - COEFF * ((flx_c - flx_m) + (fly_c - fly_m))).to(src.dtype)
    return out


def vadvc_variant(ustage, upos, utens, utens_stage, wcon, fault=None):
    """The vadvc algorithm of `kernels/vadvc/ref.py` once more, in plain
    PyTorch; ``fault="drop_k0_correction"`` drops the correction term of
    level 0, to show that `exact_check` catches a kernel that does."""
    from repro_torch.kernels.vadvc.ref import BET_M, BET_P, DTR_STAGE
    nz = ustage.shape[0]
    cc = dd = torch.zeros_like(ustage[0])
    ccols, dcols = [], []
    for k in range(nz):
        gav = -0.25 * (wcon[k, :, 1:] + wcon[k, :, :-1])
        gcv = 0.25 * (wcon[k + 1, :, 1:] + wcon[k + 1, :, :-1])
        u_k = ustage[k]
        corr_lo = -(gav * BET_M) * (ustage[max(k - 1, 0)] - u_k)
        corr_hi = -(gcv * BET_M) * (ustage[min(k + 1, nz - 1)] - u_k)
        acol = torch.zeros_like(gav) if k == 0 else gav * BET_P
        ccol = torch.zeros_like(gcv) if k == nz - 1 else gcv * BET_P
        if k == 0:
            corr = torch.zeros_like(corr_hi) \
                if fault == "drop_k0_correction" else corr_hi
        else:
            corr = corr_lo if k == nz - 1 else corr_lo + corr_hi
        rhs = DTR_STAGE * upos[k] + utens[k] + utens_stage[k] + corr
        divided = 1.0 / (DTR_STAGE - acol - ccol - cc * acol)
        cc, dd = ccol * divided, (rhs - dd * acol) * divided
        ccols.append(cc)
        dcols.append(dd)
    out = torch.empty_like(ustage)
    data = torch.zeros_like(ustage[0])
    for k in range(nz - 1, -1, -1):
        data = dcols[k] - ccols[k] * data
        out[k] = DTR_STAGE * (data - upos[k])
    return out


STENCIL_FAULTS = {"hdiff": (hdiff_variant, "skip_limiter"),
                  "vadvc": (vadvc_variant, "drop_k0_correction")}


STENCIL_ROUTES = {"hdiff": ("tma", "simt"), "vadvc": ("prefetch", "simt")}


def hdiff_tiled_loop(src, tile_x=64, tile_y=16, block_z=1, fault=None):
    """The hdiff kernel's tma route in plain PyTorch, item by item: the
    box of block_z planes x (tile_y + 4) rows x `tma_box_width` columns
    from (z0, y0 - 2, x0 - 16 bytes), zero where it leaves the grid (as
    TMA fills it); the (tile_y + 2) x (tile_x + 2) Laplacian tile computed
    once from the box; the limited fluxes and the output of the tile's cells from
    the box and that tile, ring cells copied from the box; cells of the
    ragged last tiles past the grid dropped. Each operation rounds once in
    fp32, in the kernel's order. ``fault`` "lap_interior_only" leaves the
    Laplacian tile's outer ring at 0 (a tile built over the output cells
    alone), to show that `exact_check` catches such a kernel."""
    from repro_torch.kernels.hdiff.hdiff import tma_box_width
    from repro_torch.kernels.hdiff.ref import COEFF, HALO
    nz, ny, nx = src.shape
    tx, ty, p = tile_x, tile_y, block_z
    tiles_z, tiles_y, tiles_x = -(-nz // p), -(-ny // ty), -(-nx // tx)
    width = tma_box_width(tx, src.element_size())
    lead = 16 // src.element_size()           # box columns before x0
    off = lead - HALO                         # box column of x0 - 2
    pad = src.new_zeros(tiles_z * p, tiles_y * ty + 4,
                        (tiles_x - 1) * tx + width)
    pad[:nz, HALO:HALO + ny, lead:lead + nx] = src
    out = torch.empty_like(src)
    for bz in range(tiles_z):
        for by in range(tiles_y):
            for bx in range(tiles_x):
                z0, y0, x0 = bz * p, by * ty, bx * tx
                raw = pad[z0:z0 + p, y0:y0 + ty + 4, x0:x0 + width]
                b = raw.float()

                def box(r, c, h, w):
                    return b[:, r:r + h, off + c:off + c + w]
                h, w = ty + 2, tx + 2
                lap = 4.0 * box(1, 1, h, w) - (
                    ((box(0, 1, h, w) + box(2, 1, h, w)) + box(1, 0, h, w))
                    + box(1, 2, h, w))
                if fault == "lap_interior_only":
                    inner = torch.zeros_like(lap)
                    inner[:, 1:-1, 1:-1] = lap[:, 1:-1, 1:-1]
                    lap = inner

                def lp(r, c):
                    return lap[:, r:r + ty, c:c + tx]
                s_c, l_c = box(2, 2, ty, tx), lp(1, 1)

                def limited(flx, dif):
                    return torch.where(flx * dif > 0, 0.0, flx)
                flx_c = limited(lp(1, 2) - l_c, box(2, 3, ty, tx) - s_c)
                flx_m = limited(l_c - lp(1, 0), s_c - box(2, 1, ty, tx))
                fly_c = limited(lp(2, 1) - l_c, box(3, 2, ty, tx) - s_c)
                fly_m = limited(l_c - lp(0, 1), s_c - box(1, 2, ty, tx))
                res = (s_c - COEFF * ((flx_c - flx_m) + (fly_c - fly_m))
                       ).to(src.dtype)
                y = torch.arange(y0, y0 + ty)[:, None]
                x = torch.arange(x0, x0 + tx)[None, :]
                ring = (y < HALO) | (y >= ny - HALO) | (x < HALO) \
                    | (x >= nx - HALO)
                cells = torch.where(ring.to(src.device),
                                    raw[:, 2:2 + ty, off + 2:off + 2 + tx],
                                    res)
                ze, ye, xe = min(p, nz - z0), min(ty, ny - y0), \
                    min(tx, nx - x0)
                out[z0:z0 + ze, y0:y0 + ye, x0:x0 + xe] = \
                    cells[:ze, :ye, :xe]
    return out


def vadvc_prefetch_loop(ustage, upos, utens, utens_stage, wcon, ahead=None,
                        fault=None):
    """The vadvc kernel's prefetch route in plain PyTorch, over all
    columns at once: the forward sweep takes level k's six loads
    (ustage[k + 1] clamped, wcon[k + 1] at x and x + 1, upos, utens,
    utens_stage at k) from slot k % `ahead` of a ring filled `ahead`
    levels before, and refills the slot with level k + ahead's; it keeps
    ccol, dcol and the upos it loaded for the backward sweep, which reads
    nothing else. The arithmetic is the kernel's, each operation rounded
    once in fp32. ``fault`` "stale_slot" skips the first refill, so level
    `ahead` reuses level 0's loads, to show that `exact_check` catches
    such a kernel."""
    from repro_torch.kernels.vadvc.ref import BET_M, BET_P, DTR_STAGE
    from repro_torch.kernels.vadvc.vadvc import AHEAD
    ahead = ahead or AHEAD
    nz = ustage.shape[0]

    def fetch(k):
        if k >= nz:
            return None
        return (ustage[min(k + 1, nz - 1)], wcon[k + 1, :, :-1],
                wcon[k + 1, :, 1:], upos[k], utens[k], utens_stage[k])
    ring = [fetch(j) for j in range(ahead)]
    wsum = wcon[0, :, 1:] + wcon[0, :, :-1]
    u_km1 = u_k = ustage[0]
    c_prev = d_prev = torch.zeros_like(ustage[0])
    ccols, dcols, ucols = [], [], []
    for k in range(nz):
        u_kp1, w0, w1, up, ut, uts = ring[k % ahead]
        if not (fault == "stale_slot" and k == 0):
            ring[k % ahead] = fetch(k + ahead)
        wnext = w1 + w0
        gav, gcv = -0.25 * wsum, 0.25 * wnext
        as_, cs = gav * BET_M, gcv * BET_M
        acol, ccol = gav * BET_P, gcv * BET_P
        corr_lo = -as_ * (u_km1 - u_k)
        corr_hi = -cs * (u_kp1 - u_k)
        first, last = k == 0, k == nz - 1
        corr = corr_hi if first else corr_lo if last else corr_lo + corr_hi
        if first:
            acol = torch.zeros_like(acol)
        if last:
            ccol = torch.zeros_like(ccol)
        bcol = DTR_STAGE - acol - ccol
        rhs = DTR_STAGE * up + ut + uts + corr
        divided = 1.0 / (bcol - c_prev * acol)
        c_prev = ccol * divided
        d_prev = (rhs - d_prev * acol) * divided
        ccols.append(c_prev)
        dcols.append(d_prev)
        ucols.append(up)
        wsum, u_km1, u_k = wnext, u_k, u_kp1
    out = torch.empty_like(ustage)
    nxt = torch.zeros_like(ustage[0])
    for k in range(nz - 1, -1, -1):
        data = dcols[k] - ccols[k] * nxt
        out[k] = DTR_STAGE * (data - ucols[k])
        nxt = data
    return out


def device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call of `fn` in a stream of `calls` calls, the
    median over `reps`: the card is held busy (`torch.cuda._sleep`) while
    the host enqueues the start event, the calls and the end event, so
    the interval holds the device's work and the gaps between launches,
    not the host's enqueueing. A rep whose sleep ended before the host
    finished is run again with a longer sleep."""
    fn()
    torch.cuda.synchronize()
    times, cycles = [], SLEEP_CYCLES
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        if start.query():             # the card had idled: enqueue-bound
            cycles *= 2
            torch.cuda.synchronize()
            continue
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def rotating(args, nbytes):
    """A function returning, call by call, one of enough copies of `args`
    to exceed twice the L2 cache, so that timed calls read their inputs
    from device memory."""
    sets = [args] + [[a.clone() for a in args]
                     for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes))
                                    - 1)]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(sets)
        return sets[state["i"]]
    return nxt


def _ranks(xs):
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    r = [0] * len(xs)
    for rank, i in enumerate(order):
        r[i] = rank
    return r


def spearman(xs, ys) -> float:
    """Rank correlation of two equally long lists (no ties expected)."""
    rx, ry = _ranks(xs), _ranks(ys)
    n = len(xs)
    return 1.0 - 6.0 * sum((a - b) ** 2 for a, b in zip(rx, ry)) \
        / (n * (n * n - 1))


def route_tiles(name, kind, grid, dtype_name) -> list:
    """The tiles of the kernel's tune space route `kind` launches at on
    this grid: the tma route's built tiles whose ring fits, the simt
    route's blocks within the thread and shared-memory limits."""
    from repro_torch.core.autotune import MAX_THREADS, SMEM_BYTES
    from repro_torch.kernels import registry
    spec = registry.get(name)
    names = sorted(spec.tune_space)
    tiles = [dict(zip(names, v)) for v in itertools.product(
        *(spec.tune_space[n] for n in names))]
    if name == "hdiff":
        from repro_torch.kernels.hdiff.hdiff import simt_smem_bytes, \
            tma_smem_bytes
        esize = DTYPES[dtype_name].itemsize
        if kind == "tma":
            return [t for t in tiles if tma_smem_bytes(
                t["tile_x"], t["tile_y"], t["block_z"], esize)
                <= SMEM_BYTES]
        return [t for t in tiles if t["tile_x"] * t["tile_y"] <= MAX_THREADS
                and simt_smem_bytes(t["tile_x"], t["tile_y"],
                                    t["block_z"]) <= SMEM_BYTES]
    from repro_torch.kernels.vadvc.vadvc import PREFETCH_MAX_THREADS, \
        simt_smem_bytes, smem_bytes
    threads, smem = (PREFETCH_MAX_THREADS, smem_bytes) \
        if kind == "prefetch" else (MAX_THREADS, simt_smem_bytes)
    return [t for t in tiles if t["tile_x"] * t["tile_y"] <= threads
            and smem(grid[0], t["tile_x"], t["tile_y"]) <= SMEM_BYTES]


def stencil_launch(name, args, tile, kind):
    """One launch of route `kind` at `tile` through the wrapper's
    `launch` (no checks, no counts); returns the output."""
    if name == "hdiff":
        from repro_torch.kernels.hdiff.hdiff import launch
        out = torch.empty_like(args[0])
        launch(args[0], out, tile["tile_x"], tile["tile_y"],
               tile["block_z"], kind)
        return out
    from repro_torch.kernels.vadvc.vadvc import launch
    out = torch.empty_like(args[0])
    launch(*args, out, tile["tile_x"], tile["tile_y"], kind)
    return out


# beside the spec cases: grids ragged against every tile (nz, ny, nx),
# grids whose rows are not a multiple of 16 bytes (hdiff: simt only), and
# vadvc's short columns
STENCIL_EDGE_GRIDS = {
    "hdiff": (((5, 37, 72), "float32"), ((3, 21, 40), "bfloat16"),
              ((4, 19, 50), "float32"), ((2, 13, 36), "bfloat16")),
    "vadvc": (((3, 5, 45), "float32"), ((1, 6, 40), "float32"),
              ((2, 7, 33), "float32")),
}


def stencil_cases():
    """Every spec case of hdiff and vadvc and the edge grids of
    `STENCIL_EDGE_GRIDS`, on each route the grid can take (hdiff's tma
    route only on rows a multiple of 16 bytes), at every tile of the
    kernel's tune space the route launches at: held to the plain version
    on the same inputs under `EXACT_RULE`. Through the wrapper (the route
    `route` picks: the new route on every spec case), also against the
    plain version on fp32 inputs under the spec's tolerance."""
    from repro_torch.kernels import api, registry
    from repro_torch.kernels.hdiff.hdiff import route as hdiff_route
    for name in ("hdiff", "vadvc"):
        spec = registry.get(name)
        grids = [(dict(c.shape), c.dtype, f"case {i}")
                 for i, c in enumerate(spec.cases)]
        grids += [(dict(zip(spec.shape_keys, g)), d, "edge")
                  for g, d in STENCIL_EDGE_GRIDS[name]]
        for shape, dtype_name, label in grids:
            inputs = spec.example_inputs(shape=shape)
            args32 = [torch.from_numpy(v).cuda() for v in inputs.values()]
            args = [a.to(DTYPES[dtype_name]) for a in args32]
            grid = spec.grid_of(*args)
            want = api.run(name, *args, backend="ref")
            kinds = STENCIL_ROUTES[name]
            if name == "hdiff" and hdiff_route(args[0].dtype,
                                               grid[2]) == "simt":
                kinds = ("simt",)
            tiles, mismatches = {}, {}
            for kind in kinds:
                ts = route_tiles(name, kind, grid, dtype_name)
                tiles[kind] = len(ts)
                mismatches[kind] = sum(exact_check(
                    stencil_launch(name, args, t, kind), want)["mismatches"]
                    for t in ts)
            taken = route_taken(name, lambda: api.run(  # noqa: B023
                name, *args, backend="auto"))
            want_route = kinds[0]
            got = api.run(name, *args, backend="auto")
            tol_err = (got.float() - api.run(name, *args32, backend="ref")
                       ).abs().max().item()
            tol = spec.tol[dtype_name]
            row = {"phase": "stencil", "kernel": name, "case": label,
                   "shape": shape, "dtype": dtype_name, "route": taken,
                   "tiles": tiles, "mismatches": mismatches,
                   "max_abs_err_vs_fp32_plain": tol_err, "tol": tol}
            emit(row)
            if any(mismatches.values()) or taken != want_route \
                    or not tol_err <= tol:
                raise AssertionError(f"{name} {label} {shape}: {row}")


def stencil_grid(name, dtype_name) -> dict:
    """One kernel at the COSMO grid (the spec's bench shape): the knee
    tile (`backend="auto"`, which must take the new route) against the
    plain version under `EXACT_RULE`, the broken variant above it; then
    device times at every tile of the route beside the cost model's
    estimate, the knee's time against the fastest tile's, the plain
    version's time and the bound; then the first port (route simt: hdiff
    at PR 14's knee, from its model and tune space; vadvc at the same
    tile) against the new route in 10 alternating pairs."""
    from repro_torch.core.autotune import (LAUNCH_OVERHEAD_S, autotune,
                                           autotune_kernel, dtype_nbytes)
    from repro_torch.kernels import api, registry
    spec = registry.get(name)
    inputs = spec.example_inputs(shape=dict(spec.bench_shape))
    args = [torch.from_numpy(v).cuda().to(DTYPES[dtype_name])
            for v in inputs.values()]
    grid = spec.grid_of(*args)
    new = STENCIL_ROUTES[name][0]
    tune = autotune_kernel(spec, grid, dtype_name)
    knee = api.resolve_tile(spec, args)
    if knee != tune["knee"].params:
        raise AssertionError(f"{name}: resolve_tile {knee} is not the knee "
                             f"{tune['knee'].params}")
    want = api.run(name, *args, backend="ref")
    taken = route_taken(name, lambda: api.run(name, *args, backend="auto"))
    got = api.run(name, *args, backend="auto")
    torch.cuda.synchronize()
    check = exact_check(got, want)
    variant, fault = STENCIL_FAULTS[name]
    broken = exact_check(variant(*args, fault=fault), want)
    if check["mismatches"] or not broken["mismatches"] or taken != new:
        raise AssertionError(f"{name} {dtype_name}: route {taken}, kernel "
                             f"{check}, broken variant {fault} {broken} "
                             f"({EXACT_RULE})")
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    nbytes = in_bytes + got.numel() * got.element_size()
    flops = spec.flops(grid)
    del got
    nxt = rotating(args, in_bytes)
    tiles = []
    for c in tune["candidates"]:
        if c.feasible:
            tiles.append({"tile": c.params, "smem": c.smem_bytes,
                          "est_ms": c.est_time_s * 1e3,
                          "ms": device_ms(lambda t=c.params: api.run(
                              name, *nxt(), backend="cuda", tile=t))})
    kernel_ms = device_ms(lambda: api.run(name, *nxt(), backend="auto"))
    warm_ms = device_ms(lambda: api.run(name, *args, backend="auto"))
    times = cuda_ms({"plain": lambda: api.run(name, *nxt(), backend="ref")},
                    warmup=1, rounds=5)
    fastest = min(tiles, key=lambda r: r["ms"])
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    if name == "hdiff":
        from repro_torch.kernels.hdiff.spec import SIMT_TUNE_SPACE, \
            simt_cost
        old_tile = autotune(simt_cost, grid, SIMT_TUNE_SPACE,
                            dtype_nbytes(dtype_name))["knee"].params
    else:
        old_tile = knee
    check_old = exact_check(stencil_launch(name, args, old_tile, "simt"),
                            want)
    if check_old["mismatches"]:
        raise AssertionError(f"{name} {dtype_name} simt at {old_tile}: "
                             f"{check_old}")
    pairs = scan_before_after(
        name, "simt", new, lambda kind: stencil_launch(
            name, nxt(), old_tile if kind == "simt" else knee, kind),
        f"{name} COSMO grid {dtype_name}, simt at {old_tile}, {new} at "
        f"{knee}", phase="stencil")
    row = {"phase": "stencil", "case": f"{name} COSMO grid {dtype_name}",
           "kernel": name, "dtype": dtype_name, "route": taken,
           "shape": dict(zip(spec.shape_keys, grid)),
           "knee": knee, "knee_est_ms": tune["knee"].est_time_s * 1e3,
           "max_abs_err": check["max_abs_err"], "tol": 0.0,
           "tol_rule": EXACT_RULE, "mismatches": check["mismatches"],
           "max_err_over_limit": 0.0,
           "broken": {fault: broken},
           "kernel_ms": kernel_ms, "warm_ms": warm_ms,
           "plain_ms": times["plain"][0], "library_ms": None,
           "library": f"none: no single PyTorch call computes {name}"
                      + (" (its flux limiter)" if name == "hdiff" else
                         " (an assembled tridiagonal solve and its "
                         "epilogue)"),
           "bytes": nbytes, "flops": flops,
           "bound_ms": max(t_bytes, t_flops),
           "bound_by": "bytes" if t_bytes >= t_flops else "operations",
           "fastest": fastest, "knee_over_fastest": kernel_ms / fastest["ms"],
           "est_vs_ms_rank_correlation": spearman(
               [r["est_ms"] for r in tiles], [r["ms"] for r in tiles]),
           "launch_overhead_model_ms": LAUNCH_OVERHEAD_S * 1e3,
           "simt_tile": old_tile,
           "simt_mismatches": check_old["mismatches"],
           "before_after_median_ms": pairs["median_ms"],
           f"{new}_wins": pairs[f"{new}_wins"],
           "tiles": tiles}
    row["bound_share"] = row["bound_ms"] / kernel_ms
    emit(row)
    return row


def stencil_main_path() -> dict:
    """The stencil path's entry point, `weather_stencil.main`, at the
    COSMO grid on the card, with the counts set to 0 just before it: the
    kernel check, the knees and the hdiff sweep through the kernels, every
    launch on the new routes; the sweep must equal the same sweep through
    the plain version on the card."""
    from repro_torch.core import precision as prec
    from repro_torch.kernels import api, registry
    from repro_torch.launch import weather_stencil
    reset_launches()
    t0 = time.perf_counter()
    res = weather_stencil.main(["--grid", "cosmo"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    by_route = {n: routes(n) for n in ("hdiff", "vadvc")}
    fmts = weather_stencil.SWEEP_FORMATS
    # one check each, then the sweep's exact run and one run per format
    want = {n: 0 for n in launches}
    want.update(hdiff=2 + len(fmts), vadvc=1)
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if any(by_route[n][STENCIL_ROUTES[n][0]] != want[n] for n in by_route):
        raise AssertionError(f"routes {by_route}: every launch of the main "
                             f"path must take the new route")
    if any(res["check"].values()):
        raise AssertionError(f"kernel against plain: {res['check']}")
    inputs = registry.get("hdiff").example_inputs(shape=res["grid"],
                                                  dtype=np.float64)
    plain = prec.precision_sweep(api.numpy_fn("hdiff", backend="ref"),
                                 inputs, fmts)
    if plain != res["sweep"] or not all(
            0.0 < r["accuracy_pct"] <= 100.0 for r in plain):
        raise AssertionError(f"sweep {res['sweep']} != plain {plain}")
    row = {"phase": "stencil", "path": "weather_stencil.main(['--grid', "
           "'cosmo'])", "grid": res["grid"], "wall_s": wall_s,
           "launches": launches, "launches_by_route": by_route,
           "check": res["check"],
           "knees": {f"{k[0]} {k[1]}": {"tile": v.params,
                                        "smem": v.smem_bytes,
                                        "est_ms": v.est_time_s * 1e3}
                     for k, v in res["knee"].items()},
           "sweep": res["sweep"], "sweep_equals_plain": True}
    emit(row)
    return row


def stencil_host_profile(top: int = 15) -> dict:
    """`weather_stencil.main(["--grid", "cosmo"])` once more, under
    cProfile: where its host time goes, by cumulative and by own time
    (the program untouched; the profiler's own cost is in the wall
    time)."""
    import cProfile
    import pstats
    from repro_torch.launch import weather_stencil
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    weather_stencil.main(["--grid", "cosmo"])
    torch.cuda.synchronize()
    prof.disable()
    wall_s = time.perf_counter() - t0
    rows = []
    for (path, line, fn), (_, calls, own, cum, _) in \
            pstats.Stats(prof).stats.items():
        where = path.replace(str(ROOT) + "/", "")
        if "site-packages/" in where:
            where = where.split("site-packages/", 1)[1]
        rows.append({"fn": f"{where}:{line}({fn})", "calls": calls,
                     "cum_s": round(cum, 4), "own_s": round(own, 4)})
    row = {"phase": "stencil", "case": "host profile of weather_stencil."
           "main(['--grid', 'cosmo']) under cProfile", "wall_s": wall_s,
           "top_cumulative": sorted(rows, key=lambda r: -r["cum_s"])[:top],
           "top_own": sorted(rows, key=lambda r: -r["own_s"])[:top]}
    emit(row)
    return row


def phase_stencil():
    """NERO's stencils: spec cases and edge grids at every tile on both
    routes, the COSMO grid for hdiff fp32 and bf16 and vadvc fp32 (with
    the before/after pairs), one launch's device time, the main path, then
    the main path's host profile. Returns the grid rows and the main
    path's launches."""
    from repro_torch.kernels import api
    stencil_cases()
    rows = {(n, d): stencil_grid(n, d) for n, d in (
        ("hdiff", "float32"), ("hdiff", "bfloat16"), ("vadvc", "float32"))}
    tiny = torch.randn(1, 16, 64, device="cuda")
    launch_ms = device_ms(lambda: api.run(
        "hdiff", tiny, backend="cuda",
        tile={"tile_x": 64, "tile_y": 16, "block_z": 1}), calls=50)
    emit({"phase": "stencil", "case": "one launch: hdiff of one item "
          "(1 x 16 x 64, tma route) in a stream of 50",
          "launch_ms": launch_ms})
    main_row = stencil_main_path()
    stencil_host_profile()
    torch.cuda.empty_cache()
    return rows, {k: main_row["launches"][k] for k in ("hdiff", "vadvc")}


def kernels_line(full, launches, stencil=None) -> dict:
    """One entry per kernel at its main path's shapes (bf16 where the path
    runs bf16): paged attention at one decode row and flash attention at
    the longest serve prompt (600 tokens, its `device_ms`), launches from
    the serve phase's run; the SSD scan at mamba2-780m's generate prefill (B=3,
    S=1536) and the RG-LRU scan at recurrentgemma-2b's (B=2, S=2300),
    launches from the hybrid phase's generate calls; hdiff and vadvc at
    the COSMO grid in fp32, launches from the stencil phase's main path.
    Kernels whose phase did not run are left out."""
    rows = []
    if full is not None:
        rows += [(name, full[key]) for name, key in (
            ("paged_attention", ("paged_attention", 1, "bfloat16")),
            ("flash_attention", ("flash_attention", 600, "bfloat16")),
            ("ssd_scan", ("ssd_scan", 3, 1536, "bfloat16")),
            ("rglru_scan", ("rglru_scan", 2, 2300, "float32")))]
    if stencil is not None:
        rows += [(name, stencil[(name, "float32")])
                 for name in ("hdiff", "vadvc")]
    out = []
    for name, k in rows:
        source, replaces = KERNELS[name]
        source = ROUTE_SOURCES.get((name, k.get("route")), source)
        out.append({
            "name": name, "route": "cuda", "impl": "cuda",
            "kernel_route": k.get("route", "simt"), "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": k["max_abs_err"], "max_err": k["max_abs_err"],
            "tol": k["tol"], "tol_rule": k["tol_rule"],
            "max_err_over_limit": k["max_err_over_limit"],
            "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"],
            "timing": k.get("timing"),
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "library": k.get("library"), "shape": k["shape"]})
    return {"kernels": out}


PHASES = ("kernel", "exact", "serve", "chunked", "spec", "overload",
          "hybrid", "stencil")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=PHASES,
                    help="run the device phase and this one phase only "
                         "(chunked, spec and overload build the serve "
                         "phase's model)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False    # plain fp32 is fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    run = (lambda p: args.only in (None, p))
    full = serve = None
    launches = {}
    if run("kernel"):
        full = phase_kernel()
    if run("exact"):
        phase_exact()
    if run("serve") or run("chunked") or run("spec") or run("overload"):
        serve, eng = phase_serve()
        if args.only in (None, "serve"):
            phase_profile(eng)
        if run("chunked"):
            phase_chunked(eng)
        if run("spec"):
            phase_spec(eng)
        if run("overload"):
            phase_overload(eng, serve, dev["nvidia_smi"])
        del eng
        # a finished session's radix tree and its release callback form
        # reference cycles: collect them so the next phase's memory
        # readings start from its own weights
        gc.collect()
        torch.cuda.empty_cache()
        launches.update({k: serve["launches"][k]
                         for k in ("paged_attention", "flash_attention")})
    if run("hybrid"):
        _, hybrid_launches = phase_hybrid()
        launches["ssd_scan"] = hybrid_launches["mamba2-780m"]["ssd_scan"]
        launches["rglru_scan"] = \
            hybrid_launches["recurrentgemma-2b"]["rglru_scan"]
    stencil = None
    if run("stencil"):
        stencil, stencil_launches = phase_stencil()
        launches.update(stencil_launches)
    if full is not None or stencil is not None:
        emit(kernels_line(full, launches, stencil))
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
