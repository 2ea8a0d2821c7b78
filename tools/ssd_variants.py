#!/usr/bin/env python3
"""Variants of the two scan kernels' new routes on one card, beside what
``chip_smoke.py`` checks:

    python3 tools/ssd_variants.py

1. The SSD scan's wgmma route as ``src/repro_torch/kernels/ssd_scan/
   csrc/`` builds it (chunks of 128 positions, the fp32 tensor-core
   operands in 2 bf16 pieces) and variants of that source, each with one
   choice changed and built with the port's nvcc flags: chunks of 64,
   3 pieces, both; h_prev's pieces in a tile of their own instead of
   B's (115 KB of shared memory, one chunk-scan block an SM), the shared
   tile with one block an SM (no register bound), and h_prev loaded only
   after C B^T (its registers not held across that product). For each:
   what ``ptxas -v`` reports for its chunk-scan kernel at N = 128; at
   mamba2-780m's generate prefill (B = 3, S = 1536, H = 48, P = 64, G =
   1, N = 128, bf16) and at B = 1, S = 2048 its error against the plain
   version over `chip_smoke.ssd_limit` and its `chip_smoke.device_ms`, in
   rounds that rotate the order of the variants and of the simt route;
   then each kernel of the route, at chunks of 128 and 64, timed apart
   under ``torch.profiler``.
2. The RG-LRU scan's chunked route at chunks of 32, 64, 128 and 256
   positions (a launch argument), and the serial route, at
   recurrentgemma-2b's generate prefill (B = 2, S = 2300, W = 2560) and
   at B = 1, S = 2048: each held to `chip_smoke.same_input_limit` and
   timed the same way; then its two kernels apart under the profiler at
   the wrapper's chunk.

Prints one JSON line per result. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/ssd_scan/csrc"
KERNEL = "ssd_scan.cu"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(obj):
    print(json.dumps(obj), flush=True)


def _sub(old, new):
    def patch(src):
        if old not in src:
            raise ValueError(f"variant patch no longer applies: {old[:60]!r}")
        return src.replace(old, new)
    return patch


def _chain(*patches):
    def patch(src):
        for p in patches:
            src = p(src)
        return src
    return patch


_CHUNK64 = _sub("constexpr int kChunk = 128;", "constexpr int kChunk = 64;")
_PIECES3 = _sub("constexpr int kPieces = 2;", "constexpr int kPieces = 3;")
_HP_LOAD = """  if (c > 0) {
    const float4* hp = reinterpret_cast<const float4*>(
        a.states + (((int64_t)bi * a.nc + c) * a.H + h) * kP * N);
#pragma unroll
    for (int it = 0; it < kHpIters; ++it) {
      hv[it][0] = hp[2 * (tid + it * T)];
      hv[it][1] = hp[2 * (tid + it * T) + 1];
    }
  }
"""
_AFTER_CBT = "  wgmma_commit();\n  wgmma_wait0();\n  fence_regs(cb);\n"
VARIANTS = {
    "as_built": lambda src: src,
    "chunk_64": _CHUNK64,
    "pieces_3": _PIECES3,
    "chunk_64_pieces_3": _chain(_CHUNK64, _PIECES3),
    "own_h_prev_tile": _sub(
        "static constexpr bool kAlias = Pieces * kP <= Q;",
        "static constexpr bool kAlias = false;"),
    "one_block_an_sm": _sub(
        "static constexpr int kScanBlocks = kAlias ? 2 : 1;",
        "static constexpr int kScanBlocks = 1;"),
    "h_prev_after_cbt": _chain(_sub(_HP_LOAD, ""),
                               _sub(_AFTER_CBT, _AFTER_CBT + _HP_LOAD)),
}
SCAN_FN = re.compile(r"ssd_chunk_scan_kernelILi(\d+)ELi128ELi(\d+)E")


def build_variants(cs, tmp) -> dict:
    """Compile the variants in parallel; {name: lib} for those that
    built, each reported with its chunk-scan kernel's ptxas figures."""
    from repro_torch.kernels import build as kbuild
    flags = kbuild.NVCC_FLAGS + ("-I", str(kbuild.include_dir()))
    procs = {}
    for name, patch in VARIANTS.items():
        d = tmp / name
        shutil.copytree(CSRC, d)
        (d / KERNEL).write_text(patch((CSRC / KERNEL).read_text()))
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *flags, "-o", str(d / "lib.so"), str(d / KERNEL)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            emit({"variant": name, "built": False, "log": log[-2000:]})
            continue
        scan = {fn: info for fn, info in cs.ptxas_by_kernel(log).items()
                if SCAN_FN.search(fn)}
        for fn, info in scan.items():
            info["wgmma_arrives_added"] = len(re.findall(
                rf"C7519\).*'{fn}'", log))
        lib = ctypes.CDLL(str(tmp / name / "lib.so"))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [vp] * 9 + [i32] * 8 + [vp]
        lib.ssd_scan_wgmma_smem.argtypes = [i32]
        emit({"variant": name, "built": True,
              "chunk": lib.ssd_scan_wgmma_chunk(),
              "pieces": lib.ssd_scan_wgmma_pieces(),
              "chunk_scan_ptxas": scan,
              "chunk_scan_smem": lib.ssd_scan_wgmma_smem(128)})
        libs[name] = lib
    return libs


def in_rounds(cs, fns: dict, rounds: int = 5) -> dict:
    """`device_ms` of every function in each round, the order rotating
    from round to round; per name the times and their median."""
    names = list(fns)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in names[r % len(names):] + names[:r % len(names)]:
            times[n].append(cs.device_ms(fns[n], calls=5, reps=3))
    return {n: {"median_ms": statistics.median(t), "ms": t}
            for n, t in times.items()}


def kernel_split(fn, calls: int = 10) -> dict:
    """Device microseconds per call of each CUDA kernel `fn` launches,
    from `torch.profiler`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / calls
    return by_name


def launcher(lib, args, y, st):
    """A function launching a variant library's wgmma route on these
    inputs into y and st, with scratch for its chunk."""
    b, s_len, h, p = args[0].shape
    n = args[1].shape[3]
    nc = -(-s_len // lib.ssd_scan_wgmma_chunk())
    states = torch.empty(b, nc, h, p, n, device="cuda")
    decay = torch.empty(b, nc, h, device="cuda")
    ptrs = [t.data_ptr() for t in (*args, y, st, states, decay)]

    def run():
        err = lib.ssd_scan_launch(*ptrs, b, s_len, h, p, args[1].shape[2], n,
                                  1, 1, torch.cuda.current_stream()
                                  .cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
    run.scratch = (states, decay)   # the launch holds raw pointers to it
    return run


def ssd(cs):
    from repro_torch.kernels.ssd_scan import ssd_scan as sd
    libs = build_variants(cs, Path(tempfile.mkdtemp()))
    for b, s_len in ((3, 1536), (1, 2048)):
        shape = dict(B=b, S=s_len, H=48, P=64, G=1, N=128)
        args = cs.ssd_inputs(shape, torch.bfloat16, seed=s_len)
        want = sd.ref.ssd_chunked(*args)
        y = torch.empty(b, s_len, 48, 64, device="cuda")
        st = torch.empty(b, 48, 64, 128, device="cuda")
        fns = {name: launcher(lib, args, y, st) for name, lib in libs.items()}
        fns["simt"] = lambda: sd.launch(*args, y, st, "simt")  # noqa: B023
        over = {}
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            over[name] = cs.over_ssd_limit((y, st), want)
        times = in_rounds(cs, fns)
        emit({"kernel": "ssd_scan", "shape": shape, "dtype": "bfloat16",
              "variants": {n: {**times[n], "max_err_over_limit": over[n]}
                           for n in fns}})
        for name in ("as_built", "chunk_64"):
            if name in fns:
                emit({"kernel": "ssd_scan", "shape": shape, "variant": name,
                      "profiler_us_per_call": kernel_split(fns[name])})
        del args, want, y, st, fns
        torch.cuda.empty_cache()


def rglru(cs):
    from repro_torch.kernels.rglru_scan import rglru_scan as rg
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, s_len in ((2, 2300), (1, 2048)):
        a = torch.rand(b, s_len, 2560, generator=gen, device="cuda") \
            * 0.149 + 0.85
        x = torch.randn(b, s_len, 2560, generator=gen, device="cuda") * 0.1
        want = rg.ref.lru_scan(a, x)
        h = torch.empty_like(a)
        fns, over = {}, {}
        for chunk in (32, 64, 128, 256):
            fns[f"chunked chunk={chunk}"] = (
                lambda c=chunk: rg.launch(a, x, h, "chunked",  # noqa: B023
                                          chunk=c))
        fns["serial"] = lambda: rg.launch(a, x, h, "serial")  # noqa: B023
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            over[name] = cs.ulp_check(h, want)[2]
        times = in_rounds(cs, fns)
        emit({"kernel": "rglru_scan", "shape": {"B": b, "S": s_len,
                                                "W": 2560},
              "variants": {n: {**times[n], "max_err_over_limit": over[n]}
                           for n in fns},
              "route_default": {"chunk": rg.CHUNK}})
        emit({"kernel": "rglru_scan", "shape": {"B": b, "S": s_len,
                                                "W": 2560},
              "profiler_us_per_call": kernel_split(
                  lambda: rg.launch(a, x, h, "chunked"))})  # noqa: B023
        del a, x, want, h


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cs = _chip_smoke()
    ssd(cs)
    rglru(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
