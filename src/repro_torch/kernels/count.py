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
         work: Callable[[], dict], run: Callable, empty: Callable,
         inputs: tuple = ()):
    """`run()` as the wrapper's body; under an active counter, one entry
    for kernel `name` (see the module docstring). `device` is the first
    input's device; `route`, `work` and `empty` are called only under a
    counter; the entry counts at the position of `inputs` (a plan's
    count)."""
    counter = active()
    if counter is None:
        return run()
    kind = "plain" if device.type == "cpu" else route()
    return counter.kernel(name, kind, work,
                          empty if device.type == "meta" else run, inputs)


# -- positions and seams ----------------------------------------------------
# A plan (`train.sharding.TrainPlan`) marks which mesh position each tensor
# belongs to and records its seams' collectives; the counter then keeps a
# count per position beside its totals (`CostCounter.position_summary`).
# With no counter active every helper below does nothing.
def tag(t, pos) -> None:
    """Mark tensor `t` as position `pos`'s: the ops that read it count
    there."""
    counter = active()
    if counter is not None and t is not None:
        counter.tag(t, pos)


def collective(kind: str, nbytes: int, pos, shape=None) -> None:
    """One collective of `kind` (the reference's names: "all-reduce",
    "all-gather", "reduce-scatter", ...) with `nbytes` operand bytes on
    position `pos`'s device; `shape` is the operand's, where known (the
    op log's row, `core.hlo_inspect`)."""
    counter = active()
    if counter is not None:
        counter.collective(kind, nbytes, pos, shape)


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def hidden():
    """A context in which the counter counts no op: a seam's own
    arithmetic, which stands for the collective it records."""
    counter = active()
    return counter.hide() if counter is not None else _Nothing()


def at(pos):
    """A context in which ops that read no marked tensor count at `pos`."""
    counter = active()
    return counter.at(pos) if counter is not None else _Nothing()
