#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --only kernel

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. device  — the card, ``nvidia-smi``'s name and power limit, versions.
   Builds the CUDA kernels from the sources in the checkout (into
   ``build/kernels/``) and prints what ``ptxas -v`` reported.
2. kernel  — the paged-attention kernel against its plain PyTorch version
   on the spec's 7 cases (flat and layer-stacked pools) and at the
   starcoder2-7b decode shape (b=4, hq=36, hkv=4, d=128, T=128, L=32,
   mixed fast/slow pages, one dead row) in bf16 and fp32. The spec cases
   (bf16 inputs against the fp32 plain version) hold to the spec's
   tolerance; the full-width cases (both sides on the same inputs) to 2
   ulps of |want| in the output dtype. Times kernel, plain version and
   ``scaled_dot_product_attention`` (over K/V gathered and dequantized
   beforehand) with CUDA events, in alternation within one run.
3. exact   — starcoder2-7b at full width, 2 layers, fp32, seeded weights:
   ``generate`` and ``serve(max_active=2)`` give identical greedy tokens
   with the kernel and with the plain version.
4. serve   — the main path: starcoder2-7b, all 32 layers, bf16, seeded
   weights made on the card, a 128-token page pool with every other page
   in the int8 tier; ``serve`` 5 requests (prompts 120..600, 32 new
   tokens) with ``max_active=2``. Checks outputs, an empty pool, kernel
   launches == decode steps x layers and 2 transfers per steady token.
   Then 16 decode steps of the same model (2 rows, 500-token context)
   timed bare and under ``torch.profiler``: device busy share, kernels
   per step, the largest kernels.

Then the ``kernels`` line and, last, ``{"ok": true, "device": ...}``.
Needs one CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
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
KERNEL_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:110"


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


# ---------------------------------------------------------------------------
# 1. device + build
# ---------------------------------------------------------------------------
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
                    if "registers" in ln or "spill" in ln]
             for name in libs if (build.BUILD_DIR / f"{name}.log").exists()}
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "build_s": build_s,
            "ptxas": ptxas}
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
                  q_dtype):
    """Layer-stacked mixed-tier pool (odd page ids slow) on the card, each
    row with its own pages; `dead` rows have length 1 and a zero table."""
    dev = "cuda"
    slots = max(-(-n // t) for n in lengths)
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
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(q_dtype)
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
    flops = 4 * hq * d * sum(rows * (n + rows - 1) for n in lengths)
    return nbytes, flops


def sdpa_yardstick(args, layer):
    """`scaled_dot_product_attention` over K/V gathered and dequantized
    beforehand (untimed), masked to each row's length. It omits the
    page gather and the dequant the kernel does."""
    from repro_torch.kernels.paged_attention.ref import dequantize_pool
    q, kf, vf, kq, vq, ks, vs, table, lens = args
    b, hq, d = q.shape
    t, hkv = kf.shape[-3], kf.shape[-2]
    tab = table.long()
    k = dequantize_pool(kf[layer][tab], kq[layer][tab], ks[layer][tab])
    v = dequantize_pool(vf[layer][tab], vq[layer][tab], vs[layer][tab])
    s = tab.shape[1] * t
    k = k.reshape(b, s, hkv, d).transpose(1, 2).to(q.dtype).contiguous()
    v = v.reshape(b, s, hkv, d).transpose(1, 2).to(q.dtype).contiguous()
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    mask = (torch.arange(s, device=q.device)[None, :] < lens[:, None].long())
    mask = mask[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def phase_kernel() -> dict:
    from repro_torch.kernels import api, registry
    spec = registry.get("paged_attention")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for i, case in enumerate(spec.cases):
        inputs = spec.example_inputs(shape=dict(case.shape))
        args = [torch.from_numpy(v).cuda() for v in inputs.values()]
        # a layer-stacked pool with the case's pool as layer 1 of 3
        others = [spec.example_inputs(shape=dict(case.shape), seed=s)
                  for s in (1, 2)]
        names = spec.arg_names[1:7]
        stacked = [torch.stack([torch.from_numpy(others[0][n]).cuda(), a,
                                torch.from_numpy(others[1][n]).cuda()])
                   for n, a in zip(names, args[1:7])]
        want = api.run(spec.name, *args, backend="ref")
        tol = spec.tol[case.dtype]
        errs = {}
        for form, pools, layer in (("flat", args[1:7], None),
                                   ("stacked", stacked, 1)):
            kargs = [_cast(a, dtypes[case.dtype])
                     for a in [args[0], *pools, args[7], args[8]]]
            extra = () if layer is None else (layer,)
            got = api.run(spec.name, *kargs, *extra, backend="cuda")
            torch.cuda.synchronize()
            errs[form] = (got.float() - want.float()).abs().max().item()
        err = max(errs.values())
        emit({"phase": "kernel", "case": i, "shape": dict(case.shape),
              "dtype": case.dtype, "max_abs_err": errs, "tol": tol,
              "ok": err <= tol})
        if not err <= tol:
            raise AssertionError(f"case {i}: error {err} > tol {tol}")

    # the starcoder2-7b decode shape of the main path
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = dict(b=4, hq=36, hkv=4, d=128, t=128, n_layers=32,
                 lengths=[2048, 700, 1, 1500], dead=[2])
    full = {}
    for name, q_dtype in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
        args = decode_inputs(gen, q_dtype=q_dtype, **shape)
        layer = 17
        kernel = lambda: api.run("paged_attention", *args, layer,  # noqa
                                 backend="cuda")
        plain = lambda: api.run("paged_attention", *args, layer,   # noqa
                                backend="ref")
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        limit = same_input_limit(want)
        worst = int(torch.argmax(diff))
        err = diff.flatten()[worst].item()
        tol = limit.flatten()[worst].item()
        over = (diff / limit).max().item()
        if not over <= 1.0:
            raise AssertionError(f"full-width {name}: error {err} beyond "
                                 f"2 ulps of |want| ({over:.2f}x the limit)")
        nbytes, flops = bytes_and_flops(args)
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S * 1e3, \
            flops / FP32_FLOPS * 1e3
        times = cuda_ms({"kernel": kernel, "plain": plain,
                         "library": sdpa_yardstick(args, layer)})
        row = {"phase": "kernel", "case": f"starcoder2-7b decode {name}",
               "shape": {k: v for k, v in shape.items()}, "layer": layer,
               "max_abs_err": err, "tol": tol,
               "tol_rule": "per element: 2 ulps of |want| in the output "
                           "dtype + 1e-6; tol is the limit at the element "
                           "of the largest error",
               "max_err_over_limit": over,
               "kernel_ms": times["kernel"][0], "plain_ms": times["plain"][0],
               "library_ms": times["library"][0],
               "host_ms": {k: v[1] for k, v in times.items()},
               "library": "scaled_dot_product_attention over K/V gathered "
                          "and dequantized beforehand (omits gather and "
                          "dequant)",
               "bytes": nbytes, "flops": flops,
               "bound_ms": max(t_bytes, t_flops),
               "bound_by": "bytes" if t_bytes >= t_flops else "operations"}
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        emit(row)
        full[name] = row
        del args
    torch.cuda.empty_cache()
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


def phase_exact() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    cfg = get_config("starcoder2-7b", num_layers=2, param_dtype="float32",
                     compute_dtype="float32")
    lengths, new = [70, 130, 200, 257], [9, 12, 15, 18]
    outs = {}
    for backend in ("auto", "ref"):
        eng = ServeEngine(cfg, seed=0, backend=backend, kv_pool=PagedKVPool(
            page_tokens=64, placement_policy=EveryOtherSlow()))
        gen_out = eng.generate(_requests(cfg.vocab_size, lengths, new, 0),
                               free_pages=True)
        srv_out = eng.serve(_requests(cfg.vocab_size, lengths, new, 1),
                            max_active=2)
        if eng.kv_pool.live_pages:
            raise AssertionError("pages left in the pool")
        outs[backend] = ([o.tolist() for o in gen_out],
                         [o.tolist() for o in srv_out])
        del eng
        torch.cuda.empty_cache()
    same = outs["auto"] == outs["ref"]
    row = {"phase": "exact", "config": "starcoder2-7b full width, 2 layers, "
           "fp32", "page_tokens": 64, "prompt_lengths": lengths,
           "max_new": new, "identical_tokens": same,
           "generate_tokens": outs["auto"][0], "serve_tokens": outs["auto"][1]}
    emit(row)
    if not same:
        raise AssertionError(f"kernel and plain tokens differ: {outs}")
    return row


# ---------------------------------------------------------------------------
# 4. the main path at full size
# ---------------------------------------------------------------------------
def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.paged_attention import \
        paged_attention
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    cfg = get_config("starcoder2-7b")
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, seed=0, kv_pool=PagedKVPool(
        page_tokens=128, placement_policy=EveryOtherSlow()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lengths, new = [120, 250, 380, 500, 600], [32] * 5
    reqs = _requests(cfg.vocab_size, lengths, new, 2)
    steps0 = eng.stats["decode_steps"]
    paged_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.serve(reqs, max_active=2)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = paged_attention.launches
    steps = eng.stats["decode_steps"] - steps0
    for o in outs:
        if o is None or len(o) != 32 or not ((0 <= o) & (o < cfg.vocab_size)).all():
            raise AssertionError(f"bad output {o}")
    if eng.kv_pool.live_pages:
        raise AssertionError(f"{eng.kv_pool.live_pages} pages left")
    if launches != steps * cfg.num_layers:
        raise AssertionError(f"{launches} launches for {steps} steps")
    steady = eng.last_steady_transfers
    if not steady or any(s != (1, 1) for s in steady):
        raise AssertionError(f"steady-state transfers {steady}")
    decode_tokens = eng.stats["tokens"] - len(reqs)
    row = {"phase": "serve", "config": "starcoder2-7b, 32 layers, bf16",
           "params": sum(p.numel() for p in eng.model.parameters()),
           "init_s": init_s, "requests": len(reqs), "prompt_lengths": lengths,
           "max_new": 32, "max_active": 2, "page_tokens": 128,
           "wall_s": wall_s, "decode_steps": steps, "launches": launches,
           "prefill_ms_per_request": eng.stats["prefill_s"] / len(reqs) * 1e3,
           "decode_ms_per_step": eng.stats["decode_s"] / steps * 1e3,
           "decode_tok_s": decode_tokens / eng.stats["decode_s"],
           "steady_steps": len(steady), "transfers_per_steady_token": 2,
           "transfers": eng.last_transfers,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "pool": {k: eng.kv_pool.stats[k] for k in
                    ("fast_hits", "slow_hits", "evictions")}}
    emit(row)
    return row, eng


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


def phase_profile(eng, steps: int = 16) -> dict:
    """Decode steps of 2 rows at ~500 tokens of context, timed without
    and then with `torch.profiler`: device busy share of the traced window
    (union of kernel intervals over its wall time), kernels per step, and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.paged_decode import (PagedKVState,
                                                build_fused_step,
                                                extract_prefill_pages)
    cfg = eng.cfg
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 500)).astype(np.int32)).cuda()
    state = PagedKVState(eng.kv_pool, 500 + 2 * steps + 8, eng.layout,
                         cfg.num_kv_heads, cfg.head_dim, batch_hint=2)
    logits, caches = eng.model.forward_prefill(prompts)
    seqs = [10_000, 10_001]
    extract_prefill_pages(eng.model, caches, state, seqs)
    del caches
    step_fn = build_fused_step(eng.model, state.slots)
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = 500
    for _ in range(3):                              # warm-up
        _, tok = state.run_fused(step_fn, tok, seqs, pos)
        pos += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, tok = state.run_fused(step_fn, tok, seqs, pos)
        pos += 1
    plain_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            _, tok = state.run_fused(step_fn, tok, seqs, pos)
            pos += 1
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
    for seq in seqs:
        state.free_seq(seq)
    row = {"phase": "profile", "rows": 2, "context": 500, "steps": steps,
           "decode_ms_per_step": plain_ms,
           "traced_ms_per_step": traced_s / steps * 1e3,
           "device_busy_share": busy_us / (traced_s * 1e6),
           "kernels_per_step": len(kernels) / steps,
           "paged_attention_share_of_busy": attn_us / busy_us if busy_us
           else None,
           "paged_attention_us_per_launch":
               attn_us / (steps * cfg.num_layers),
           "top_kernels_us_per_step": [[k[:80], v / steps] for k, v in top]}
    emit(row)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernel", "exact", "serve"),
                    help="run the device phase and this one phase only")
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
    full = serve = None
    if args.only in (None, "kernel"):
        full = phase_kernel()
    if args.only in (None, "exact"):
        phase_exact()
    if args.only in (None, "serve"):
        serve, eng = phase_serve()
        phase_profile(eng)
        del eng
    if full is not None:
        k = full["bfloat16"]
        emit({"kernels": [{
            "name": "paged_attention", "route": "cuda", "impl": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": serve["launches"] if serve else 0,
            "max_abs_err": k["max_abs_err"], "max_err": k["max_abs_err"],
            "tol": k["tol"], "tol_rule": k["tol_rule"],
            "max_err_over_limit": k["max_err_over_limit"],
            "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
