"""One `KernelSpec` per hand-written kernel, one `run()` dispatch over
all of them — the port's counterpart of ``repro/kernels/api.py``.

    from repro_torch.kernels import api
    y = api.run("paged_attention", *args)                   # "auto"
    y = api.run("paged_attention", *args, backend="cuda")   # the kernel
    y = api.run("paged_attention", *args, backend="ref")    # plain PyTorch

``auto`` runs the kernel on CUDA tensors and the plain version on CPU
tensors (through the kernel's wrapper, which makes that choice). The
kernels' launch shapes are fixed: tile parameters are refused.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One validation case: a shape dict, a dtype and the keyword
    arguments the function is called with."""
    shape: Mapping[str, int]
    dtype: str = "float32"
    kwargs: Mapping = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    fn: Callable                 # the wrapper: kernel on CUDA, plain on CPU
    ref_fn: Callable             # the plain PyTorch version
    arg_names: tuple             # positional argument names, in order
    example_inputs: Callable     # (shape=None, dtype=..., seed=0) -> dict
    tol: Mapping[str, float]     # per-dtype max abs error vs ref_fn
    cases: tuple = ()            # KernelCase sweep for tests


BACKENDS = ("cuda", "ref", "auto")


def run(name: str, *args, backend: str = "auto", tile=None, **kwargs):
    """Single entry point over every registered kernel. ``backend="cuda"``
    on CPU tensors raises, as does any ``tile``: the launch shape is
    fixed, and a tile passed with ``"ref"`` would silently measure the
    plain version."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    from repro_torch.kernels import registry
    spec = registry.get(name)
    if tile is not None:
        raise ValueError(f"{spec.name}: tile={tile!r} — the kernel's launch "
                         f"shape is fixed and the plain version takes no "
                         f"tile parameters")
    if backend == "ref":
        return spec.ref_fn(*args, **kwargs)
    if backend == "cuda" and not args[0].is_cuda:
        raise ValueError(f"{spec.name}: backend='cuda' needs CUDA tensors, "
                         f"got {args[0].device}")
    return spec.fn(*args, **kwargs)
