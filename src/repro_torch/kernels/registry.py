"""KernelSpec registry: which kernels the port has. Kernel packages
register at import of their ``spec`` module; the builtins load lazily on
first lookup."""
from __future__ import annotations

import importlib

from repro_torch.kernels.api import KernelSpec

_REGISTRY: dict[str, KernelSpec] = {}
_BUILTIN = ("paged_attention", "flash_attention", "ssd_scan", "rglru_scan",
            "hdiff", "vadvc")


def register(spec: KernelSpec) -> KernelSpec:
    if not isinstance(spec, KernelSpec):
        raise TypeError(f"expected KernelSpec, got {type(spec)}")
    _REGISTRY[spec.name] = spec
    return spec


def _load_builtin():
    for pkg in _BUILTIN:
        importlib.import_module(f"repro_torch.kernels.{pkg}.spec")


def get(name: str) -> KernelSpec:
    _load_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel {name!r} registered "
                       f"(available: {names()})") from None


def names() -> list[str]:
    _load_builtin()
    return sorted(_REGISTRY)


def all_kernels() -> list[KernelSpec]:
    return [_REGISTRY[n] for n in names()]
