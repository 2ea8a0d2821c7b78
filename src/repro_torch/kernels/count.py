"""The kernels' side of the cost counter (`repro_torch.core.hlo_cost`).

Each kernel wrapper sends its call through `call`. With no counter
active, `call` runs the wrapper's body as it is: the CUDA launch on the
card, the plain version on the CPU. Under an active counter the call
becomes one entry ``(kernel, route, work)``: ``work`` is the function's
bytes and flops from its spec (``spec.work``), the same whatever runs
it; the route is the one the card takes (on the card and on ``meta``
tensors, from static shapes) or "plain" on the CPU. The body's own
operations are hidden from the counter, and on ``meta`` tensors the body
does not run at all: the call returns outputs of the right shapes and
dtypes (``empty``), so counting a full-width step allocates nothing and
never runs a plain version.
"""
from __future__ import annotations

from typing import Callable

_ACTIVE: list = []     # counters, innermost last


def active():
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def call(name: str, device, route: Callable[[], str],
         work: Callable[[], dict], run: Callable, empty: Callable):
    """`run()` as the wrapper's body; under an active counter, one entry
    for kernel `name` (see the module docstring). `device` is the first
    input's device; `route`, `work` and `empty` are called only under a
    counter."""
    counter = active()
    if counter is None:
        return run()
    kind = "plain" if device.type == "cpu" else route()
    return counter.kernel(name, kind, work,
                          empty if device.type == "meta" else run)
