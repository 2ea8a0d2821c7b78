"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload sc2-7b.decode-c32 --seed 7 \\
        --seconds 30 --trace 0

Run from the root of a checkout. The system under test is the PyTorch
and CUDA package ``repro_torch`` under ``src/``; every build and kernel
cache it makes goes under ``build/`` in the checkout. The run needs as
many CUDA cards as the cell asks for and fails without them: nothing
falls back to the CPU. ``--trace 1`` reads the cell's per-layer metrics
from a profiler trace of the window, ``--trace 0`` its end-to-end
metrics with tracing off. The last line of standard output is the
result; the numbers that decided ``correct`` are the last lines of
standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment():
    """Caches inside the checkout at fixed paths, and no JAX pulled in by
    a library."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from perfbench.lib import harness, spec

    cell = spec.cell(args.workload, spec.benchmark(ROOT))
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules the benchmark may not load were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in line["checked"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
