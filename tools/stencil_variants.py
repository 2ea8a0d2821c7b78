#!/usr/bin/env python3
"""Variants of the two stencil kernels' new routes on one card, beside what
``chip_smoke.py`` checks:

    python3 tools/stencil_variants.py | tee chiprun_out/<name>.log

Builds ``src/repro_torch/kernels/{vadvc,hdiff}/csrc/`` as they are and
text-patched variants of their new routes, each with one choice changed
and built with the port's nvcc flags (a patch that no longer applies
raises): vadvc's prefetch route with upos read again by the backward
sweep, 16 levels ahead in registers, instead of kept in shared memory (2
nz floats a column instead of 3), and with its forward ring 4 or 16
levels deep instead of 8; hdiff's tma route with a ring of 2 or 4 boxes
instead of 3. For each: what ``ptxas -v``
reports, then at the COSMO grid (64 x 256 x 256; hdiff in fp32 and bf16)
at a few tiles its mismatches against the plain version (`chip_smoke.
EXACT_RULE`) and its `chip_smoke.device_ms` on inputs rotated past L2, in
rounds that rotate the order of the variants. Prints one JSON line per
result. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src/repro_torch/kernels"


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


_UPOS_REREAD = _chain(
    _sub("  float* ucol = dcol + (int64_t)nz * threads;     // upos, kept\n",
         ""),
    _sub("      ucol[k * threads + tid] = l.up;\n", ""),
    _sub("""  float next = 0.f;
  for (int k = nz - 1; k >= 0; --k) {
    const int at = k * threads + tid;
    const float data = __fsub_rn(dcol[at], __fmul_rn(ccol[at], next));
    out[k * plane + col] = __fmul_rn(dtr, __fsub_rn(data, ucol[at]));
    next = data;
  }""", """  constexpr int kBack = 16;
  float up[kBack];
#pragma unroll
  for (int j = 0; j < kBack; ++j)
    up[j] = upos[(j < nz ? nz - 1 - j : 0) * plane + col];
  float next = 0.f;
  for (int i0 = 0; i0 < nz; i0 += kBack) {
#pragma unroll
    for (int j = 0; j < kBack; ++j) {
      const int i = i0 + j;
      if (i >= nz) break;
      const int k = nz - 1 - i;
      const int at = k * threads + tid;
      const float data = __fsub_rn(dcol[at], __fmul_rn(ccol[at], next));
      out[k * plane + col] = __fmul_rn(dtr, __fsub_rn(data, up[j]));
      next = data;
      up[j] = upos[(k >= kBack ? k - kBack : 0) * plane + col];
    }
  }"""),
    _sub("  const size_t smem = (size_t)3 * nz * tile_x * tile_y * "
         "sizeof(float);", "  const size_t smem = (size_t)2 * nz * tile_x * "
         "tile_y * sizeof(float);"))
VARIANTS = {
    "vadvc": ("vadvc.cu", {
        "as_built": lambda src: src,
        "upos_reread": _UPOS_REREAD,
        "ahead_4": _sub("constexpr int kAhead = 8;",
                        "constexpr int kAhead = 4;"),
        "ahead_16": _sub("constexpr int kAhead = 8;",
                         "constexpr int kAhead = 16;")}),
    "hdiff": ("hdiff.cu", {
        "as_built": lambda src: src,
        "stages_2": _sub("constexpr int kStages = 3;",
                         "constexpr int kStages = 2;"),
        "stages_4": _sub("constexpr int kStages = 3;",
                         "constexpr int kStages = 4;")}),
}
TILES = {"vadvc": ((128, 2), (64, 4), (128, 1), (32, 1)),
         "hdiff": ((128, 32, 1), (64, 32, 1), (64, 16, 1))}


def build_variants(cs, kernel, tmp) -> dict:
    """Compile the kernel's variants in parallel; {name: lib} for those
    that built, each reported with its ptxas figures."""
    from repro_torch.kernels import build as kbuild
    source, variants = VARIANTS[kernel]
    csrc = KERNELS / kernel / "csrc"
    flags = kbuild.NVCC_FLAGS + ("-I", str(kbuild.include_dir()))
    procs = {}
    for name, patch in variants.items():
        d = tmp / kernel / name
        shutil.copytree(csrc, d)
        (d / source).write_text(patch((csrc / source).read_text()))
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *flags, "-o", str(d / "lib.so"), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            emit({"kernel": kernel, "variant": name, "built": False,
                  "log": log[-2000:]})
            continue
        ptxas = {fn: info for fn, info in cs.ptxas_by_kernel(log).items()
                 if "simt" not in fn}
        emit({"kernel": kernel, "variant": name, "built": True,
              "ptxas": ptxas})
        libs[name] = ctypes.CDLL(str(tmp / kernel / name / "lib.so"))
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


def vadvc_launcher(lib, tile):
    from repro_torch.kernels.vadvc import ref
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.vadvc_launch.argtypes = [vp] * 6 + [i32] * 3 + [i64] * 2 \
        + [i32] * 2 + [f32] * 3 + [i32, vp]

    def run(args):
        out = torch.empty_like(args[0])
        nz, ny, nx = args[0].shape
        err = lib.vadvc_launch(
            *(t.data_ptr() for t in (*args, out)), nz, ny, nx,
            args[4].stride(0), args[4].stride(1), *tile, ref.DTR_STAGE,
            ref.BET_M, ref.BET_P, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"vadvc variant launch failed: {err}")
        return out
    return run


def hdiff_launcher(lib, tile):
    from repro_torch.kernels.hdiff import ref
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hdiff_launch.argtypes = [vp, vp] + [i32] * 6 + [ctypes.c_float, i32,
                                                        i32, vp]

    def run(args):
        src = args[0]
        out = torch.empty_like(src)
        err = lib.hdiff_launch(
            src.data_ptr(), out.data_ptr(), *src.shape, *tile, ref.COEFF,
            int(src.dtype == torch.bfloat16), 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"hdiff variant launch failed: {err}")
        return out
    return run


def compare(cs, kernel, libs, dtype_name):
    from repro_torch.kernels import api, registry
    spec = registry.get(kernel)
    inputs = spec.example_inputs(shape=dict(spec.bench_shape))
    args = [torch.from_numpy(v).cuda().to(cs.DTYPES[dtype_name])
            for v in inputs.values()]
    want = api.run(kernel, *args, backend="ref")
    nxt = cs.rotating(args, sum(a.numel() * a.element_size() for a in args))
    make = vadvc_launcher if kernel == "vadvc" else hdiff_launcher
    for tile in TILES[kernel]:
        fns, exact = {}, {}
        for name, lib in libs.items():
            run = make(lib, tile)
            try:
                got = run(args)
                torch.cuda.synchronize()
            except RuntimeError as e:          # a tile the variant refuses
                exact[name] = str(e)
                continue
            exact[name] = cs.exact_check(got, want)["mismatches"]
            fns[name] = lambda run=run: run(nxt())
        emit({"kernel": kernel, "dtype": dtype_name, "tile": tile,
              "mismatches": exact, "times": in_rounds(cs, fns)})


def main() -> int:
    if not torch.cuda.is_available():
        print("stencil_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    tmp = Path(tempfile.mkdtemp())
    try:
        for kernel, dtypes in (("vadvc", ("float32",)),
                               ("hdiff", ("float32", "bfloat16"))):
            libs = build_variants(cs, kernel, tmp)
            for dtype_name in dtypes:
                compare(cs, kernel, libs, dtype_name)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
