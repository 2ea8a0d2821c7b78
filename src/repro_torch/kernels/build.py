"""Build the port's CUDA kernels on first use and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface under ``build/kernels/`` at
the repository root (listed in ``.gitignore``), with ``kernels/include/``
(headers shared by several kernels) on the include path. A library's
file name carries a digest of every file in its ``csrc/``, of each
shared header those files include (directly or through each other) and
of the compiler flags, so an edited source or header rebuilds the
kernels that use it and an unchanged one is reused. All missing libraries
build at once, one ``nvcc`` per source started together. A failed build
raises with the compiler's output; ``ptxas -v`` (registers, shared
memory, spills) is kept beside each library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def include_dir() -> Path:
    return KERNELS_DIR / "include"


def sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def shared_headers(name: str) -> list[Path]:
    """The files of `include_dir` that kernel `name`'s ``csrc/`` includes
    (a quoted ``#include`` that its own directory does not resolve),
    directly or through each other."""
    csrc, inc = sources()[name].parent, include_dir()
    todo = [p for p in csrc.rglob("*") if p.is_file()]
    found: set[Path] = set()
    while todo:
        f = todo.pop()
        for m in _INCLUDE.finditer(f.read_bytes()):
            rel = m.group(1).decode()
            h = inc / rel
            if not (f.parent / rel).is_file() and h.is_file() \
                    and h not in found:
                found.add(h)
                todo.append(h)
    return sorted(found)


def library_path(name: str) -> Path:
    csrc = sources()[name].parent
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = [(f, f.relative_to(csrc)) for f in sorted(
        p for p in csrc.rglob("*") if p.is_file())]
    files += [(h, Path("include") / h.relative_to(include_dir()))
              for h in shared_headers(name)]
    for f, rel in files:
        digest.update(f"\0{rel}\0".encode())
        digest.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel whose library is missing, all in parallel.
    Returns ``{name: library path}``."""
    targets = {name: library_path(name) for name in sources()}
    missing = {n: p for n, p in targets.items() if not p.exists()}
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, lib in missing.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(include_dir()), "-o", str(tmp),
                 str(sources()[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, missing[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (the source's stem), built if needed."""
    return ctypes.CDLL(str(build_all()[name]))
