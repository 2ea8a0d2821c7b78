#!/usr/bin/env python3
"""Variants of the flash-attention kernel's wgmma route, side by side on
one card: each is the source in ``src/repro_torch/kernels/flash_attention/
csrc/`` with one design choice undone, built with the port's nvcc flags.

    python3 tools/flash_variants.py                 # every variant
    python3 tools/flash_variants.py as_is,exp2f     # some

For each variant: what ``ptxas -v`` reports per head dim (registers,
spills, serialised wgmmas), its error against the plain version on the
same bf16 inputs (`chip_smoke.same_input_limit`) at d = 64, 128 and 256,
and its `chip_smoke.device_ms` at the full-width rows of ``chip_smoke.py``
(starcoder2-7b s = 2048 causal and not, s = 600; recurrentgemma-2b b = 2,
s = 2300, d = 256, window 2048), the variants timed in turns, twice.
Prints one JSON line per result. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
KERNEL = "flash_attention.cu"


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


# A warpgroup (or a warp) that only lowers its registers and leaves, after
# the barriers are set up: the launch shape of a producer warpgroup with
# setmaxnreg (FlashAttention-3's) or of one producer warp, with the loads
# still issued by the consumers, to read what ptxas makes of it.
_IDLE_ROLE = _sub(
    "  // warpgroup c owns query rows 64 c .. 64 c + 63 of the block\n"
    "  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);\n",
    "  const int c = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);\n"
    "  if (c == kConsumers) {\n    DEC;\n    return;\n  }\n  INC;\n")
VARIANTS = {
    "as_is": lambda src: src,
    # FlashAttention-3's layout: 384 threads, a producer warpgroup that
    # gives registers to the consumers with setmaxnreg
    "setmaxnreg_warpgroup": _chain(
        _sub("constexpr int kThreads = 128 * kConsumers;",
             "constexpr int kThreads = 128 * (kConsumers + 1);"),
        _IDLE_ROLE,
        _sub("    DEC;", '    asm volatile("setmaxnreg.dec.sync.aligned.u32 '
                         '24;\\n" ::: "memory");'),
        _sub("  INC;", '  asm volatile("setmaxnreg.inc.sync.aligned.u32 '
                       '240;\\n" ::: "memory");')),
    # one producer warp beside the two consumer warpgroups: 288 threads
    "producer_warp": _chain(
        _sub("constexpr int kThreads = 128 * kConsumers;",
             "constexpr int kThreads = 128 * kConsumers + 32;"),
        _IDLE_ROLE, _sub("    DEC;\n", ""), _sub("  INC;\n", "")),
    # the CUDA math library's exp2f in place of ex2.approx.ftz
    "exp2f": lambda src: re.sub(r"\bex2\(", "exp2f(", src).replace(
        "__device__ __forceinline__ float exp2f(float x) {",
        "__device__ __forceinline__ float unused_ex2(float x) {"),
    # P V as one n = 64 product per 64-wide box of d
    "pv_n64": _sub(
        "      const uint64_t db = desc(v_tile + kk * 16 * kRow, BN * kRow, "
        "1024);\n#pragma unroll\n      for (int piece = 0; piece < 3; "
        "++piece) {\n        if constexpr (D == 64)\n          "
        "wgmma_rs_n64(o, pa[piece][kk], db);\n        else if constexpr "
        "(D == 128)\n          wgmma_rs_n128(o, pa[piece][kk], db);\n"
        "        else\n          wgmma_rs_n256(o, pa[piece][kk], db);\n"
        "      }\n",
        "#pragma unroll\n      for (int j = 0; j < T::kBoxes; ++j) {\n"
        "        const uint64_t db = desc(v_tile + j * BN * kRow + kk * 16 "
        "* kRow, 1024, 1024);\n#pragma unroll\n        for (int piece = 0; "
        "piece < 3; ++piece)\n          wgmma_rs_n64(o + 32 * j, "
        "pa[piece][kk], db);\n      }\n"),
    # a third stage in the ring at d <= 128 (Q + 3 x 64 KB at d = 128)
    "stages3": _chain(
        _sub("  static constexpr int kBoxes",
             "  static constexpr int kStages = D <= 128 ? 3 : 2;\n"
             "  static constexpr int kBoxes"),
        _sub("  constexpr int kConsumers = T::kConsumers;\n",
             "  constexpr int kConsumers = T::kConsumers, "
             "kStages = T::kStages;\n")),
}
FUNC = re.compile(r"flash_wgmma_kernelILi(\d+)E")


def build(names, nvcc, flags, tmp):
    """Compile the variants in parallel; returns {name: (lib, ptxas)} for
    those that built, ptxas as {d: [lines]}."""
    procs = {}
    for name in names:
        d = tmp / name
        shutil.copytree(CSRC, d)
        (d / KERNEL).write_text(VARIANTS[name]((CSRC / KERNEL).read_text()))
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", str(d / "lib.so"), str(d / KERNEL)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        ptxas, current = {}, None
        for line in log.splitlines():
            m = FUNC.search(line)
            if m and ("Compiling entry" in line or "C751" in line):
                current = int(m.group(1))
                if "C751" in line:
                    ptxas.setdefault(current, []).append(
                        line.split("Potential Performance Loss: ")[-1]
                        .split(" in the function")[0].split(" for the")[0])
                    current = None
            elif current and ("spill" in line or "Used" in line):
                ptxas.setdefault(current, []).append(line.strip())
        print(json.dumps({"variant": name, "built": proc.returncode == 0,
                          "ptxas": ptxas} if proc.returncode == 0 else
                         {"variant": name, "built": False,
                          "log": log[-2000:]}), flush=True)
        if proc.returncode == 0:
            lib = ctypes.CDLL(str(tmp / name / "lib.so"))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.flash_attention_wgmma_launch.argtypes = \
                [vp] * 4 + [i32] * 8 + [ctypes.c_float, i32, i32, vp]
            built[name] = lib
    return built


def launch(lib, q, k, v, causal, window):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = lib.flash_attention_wgmma_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
        skv, hq, hkv, d, int(causal), window,
        1.0 / math.sqrt(d) * math.log2(math.e), 128, 128 if d <= 128 else 64,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    names = argv[0].split(",") if argv else list(VARIANTS)
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(names, kbuild._nvcc(),
                 kbuild.NVCC_FLAGS + ("-I", str(kbuild.include_dir())),
                 Path(tempfile.mkdtemp()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = [(dict(b=2, sq=300, skv=300, hq=4, hkv=2, d=64), True, 0),
              (dict(b=1, sq=1000, skv=1000, hq=9, hkv=1, d=128), False, 0),
              (dict(b=1, sq=700, skv=700, hq=2, hkv=1, d=256), True, 200)]
    right = {}
    for shape, causal, window in checks:
        q, k, v = cs.flash_inputs(gen, dtype=torch.bfloat16, **shape)
        want = ref.attention(q, k, v, causal=causal, window=window)
        for name, lib in libs.items():
            got = launch(lib, q, k, v, causal, window)
            torch.cuda.synchronize()
            over = cs.ulp_check(got, want)[2]
            right[name] = right.get(name, True) and over <= 1.0
            print(json.dumps({"variant": name, "d": shape["d"],
                              "max_err_over_limit": over}), flush=True)
    rows = [("starcoder2-7b s=2048 causal",
             dict(b=1, sq=2048, skv=2048, hq=36, hkv=4, d=128), True, 0),
            ("starcoder2-7b s=2048 non-causal",
             dict(b=1, sq=2048, skv=2048, hq=36, hkv=4, d=128), False, 0),
            ("starcoder2-7b s=600 causal",
             dict(b=1, sq=600, skv=600, hq=36, hkv=4, d=128), True, 0),
            ("recurrentgemma-2b b=2 s=2300 window 2048",
             dict(b=2, sq=2300, skv=2300, hq=10, hkv=1, d=256), True, 2048)]
    for label, shape, causal, window in rows:
        q, k, v = cs.flash_inputs(gen, dtype=torch.bfloat16, **shape)
        times = {}
        for _ in range(2):
            for name, lib in libs.items():
                if right[name]:
                    times.setdefault(name, []).append(cs.device_ms(
                        lambda: launch(lib, q, k, v, causal, window)))
        print(json.dumps({"shape": label, "device_ms": times}), flush=True)
    return 0 if all(right.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
