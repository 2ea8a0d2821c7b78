#!/usr/bin/env python3
"""Two measurements of the paged-attention kernel's new routes on one card,
beside what ``chip_smoke.py`` checks:

    python3 tools/paged_variants.py

1. The split route at other split counts than `split_plan` picks: at
   starcoder2-7b's decode (k = 1) and verify (k = 4) shapes of
   ``chip_smoke.py`` (b = 4, 36 query heads over 4 kv heads, d = 128,
   32 layers of 128-token pages, lengths 2048, 700, 1 (dead), 1500),
   bf16 q, launched through the library with 8-64 splits, each timed by
   `chip_smoke.device_ms` and held to `chip_smoke.same_input_limit`.
2. The wgmma route's error against that limit as the pool's data
   changes, at a k = 128 chunk-fill step (b = 2, lengths 700 and 300):
   only the float tier, only the int8 tier, both tiers on every page
   (which the function allows and the serve pool never writes), and the
   float tier at 3x the magnitude. Per case: the largest error over the
   limit, the elements over it and over 0.51 of it, and the worst
   element's kernel and plain values.

Prints one JSON line per result. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_counts(cs, gen):
    from repro_torch.kernels import api
    from repro_torch.kernels.paged_attention import paged_attention as pa
    lib = pa._lib()
    shape = dict(b=4, hq=36, hkv=4, d=128, t=128, n_layers=32,
                 lengths=[2048, 700, 1, 1500], dead=[2])
    layer = 17
    for rows in (1, 4):
        args = cs.decode_inputs(gen, q_dtype=torch.bfloat16, rows=rows,
                                **shape)
        q, slots = args[0], args[7].shape[1]
        b, hkv, d, t = 4, 4, 128, 128
        kg = rows * 9
        want = api.run("paged_attention", *args, layer, backend="ref")
        row = {"case": f"split counts, starcoder2-7b k={rows} bfloat16",
               "planned": pa.split_plan(b, hkv, slots * t, d,
                                        pa._sm_count(q.device.index)),
               "sdpa_ms": cs.device_ms(cs.sdpa_yardstick(args, layer, rows))}
        for target in (8, 16, 24, 32, 48, 64):
            tile = pa.split_tile(d)
            chunk = -(-(-(-slots * t // target)) // tile) * tile
            splits = -(-slots * t // chunk)
            n_rows = b * hkv * splits * kg
            n_ml = -(-2 * n_rows // 4) * 4
            part = torch.empty(n_ml + n_rows * d, device=q.device)
            counters = pa._counters(q.device, b * hkv)
            out = torch.empty_like(q)
            ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]

            def launch():
                err = lib.paged_attention_split_launch(
                    *ptrs, part.data_ptr(), part.data_ptr() + 4 * n_ml,
                    counters.data_ptr(), b, rows, 36, hkv, d,
                    args[1].shape[1], t, slots, layer, 1 / math.sqrt(d),
                    splits, chunk, 1, 0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"split launch failed: {err}")

            launch()
            torch.cuda.synchronize()
            row[f"{splits} x {chunk}"] = {
                "ms": cs.device_ms(launch),
                "over_limit": cs.ulp_check(out, want)[2]}
        print(json.dumps(row), flush=True)
        del args


def magnitudes(cs, gen):
    from repro_torch.kernels import api
    shape = dict(b=2, hq=36, hkv=4, d=128, t=128, n_layers=2,
                 lengths=[700, 300], dead=[])
    base = cs.decode_inputs(gen, q_dtype=torch.bfloat16, rows=128, **shape)
    f1, f2 = (torch.randn(base[1].shape, generator=gen, device="cuda")
              for _ in range(2))
    q1, q2 = (torch.randint(-127, 128, base[3].shape, generator=gen,
                            device="cuda").to(torch.int8) for _ in range(2))
    s1, s2 = (torch.rand(base[5].shape, generator=gen, device="cuda") * 0.02
              for _ in range(2))
    zero = torch.zeros_like
    cases = {
        "float tier only": (f1, f2, zero(q1), zero(q2), zero(s1), zero(s2)),
        "int8 tier only": (zero(f1), zero(f2), q1, q2, s1, s2),
        "both tiers": (f1, f2, q1, q2, s1, s2),
        "float tier only, 3x magnitude": (3 * f1, 3 * f2, zero(q1),
                                          zero(q2), zero(s1), zero(s2)),
    }
    for name, pools in cases.items():
        args = [base[0], *pools, base[7], base[8]]
        got = api.run("paged_attention", *args, 1, backend="cuda")
        want = api.run("paged_attention", *args, 1, backend="ref")
        ratio = (got.float() - want.float()).abs() / cs.same_input_limit(want)
        i = int(torch.argmax(ratio))
        print(json.dumps({
            "case": f"wgmma k=128, {name}", "over_limit": ratio.max().item(),
            "elements_over": int((ratio > 1).sum()),
            "elements_over_0.51": int((ratio > 0.51).sum()),
            "worst_got": got.flatten()[i].item(),
            "worst_want": want.flatten()[i].item(),
            "max_abs_want": want.float().abs().max().item()}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cs = _chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(0)
    split_counts(cs, gen)
    magnitudes(cs, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
