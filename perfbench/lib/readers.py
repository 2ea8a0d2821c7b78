"""Per-layer readings from a traced run's record (the dict a traffic
module builds: ``trace``, ``kind``, ``config``, ``calls``, ``flops``,
``window_s`` and what the mix adds). Each returns None where the record
holds nothing to read, and never 0 for a share of a roofline or a peak.
Each file of ``perfbench/metrics/`` names one of these as its ``read``.
"""
from __future__ import annotations

from perfbench.lib import work

PROBE = "bench.probe"


def _ops(rec, under: str):
    return [op for op in rec["trace"].ops_under(under)
            if PROBE not in op[3]]


def kernels_per(rec, under: str, every_thread: bool = False):
    """Device operations launched inside the ``under`` ranges, per
    range; with ``every_thread``, every operation of the window per
    range (a training step's backward launches from autograd's own
    threads, outside the range)."""
    tr = rec["trace"]
    n = len(tr.ranges.get(under, []))
    if not n or not tr.ops:
        return None
    ops = [op for op in tr.ops if PROBE not in op[3]] if every_thread \
        else _ops(rec, under)
    return len(ops) / n


def roofline(rec, kernel: str):
    """The least time for the work of the window's calls of `kernel`
    over the device time of the operations launched inside them, in %."""
    calls = rec["calls"].get(kernel) or []
    ops = _ops(rec, f"bench.kernel.{kernel}")
    busy = sum(e - s for _, s, e, _ in ops)
    if not calls or busy <= 0 or rec["kind"] not in work.PEAKS:
        return None
    least = sum(work.least_seconds(f, b, rec["kind"]) for f, b in calls)
    return 100.0 * least / busy


def idle_share(rec):
    tr = rec["trace"]
    if tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(rec):
    """Model FLOPs of the window by the configuration's formula, over its
    seconds, over the card's bf16 peak, in %."""
    if not rec["flops"] or rec["window_s"] <= 0 or \
            rec["kind"] not in work.PEAKS:
        return None
    return 100.0 * rec["flops"] / rec["window_s"] \
        / work.peaks(rec["kind"])["bf16_flops"]


def median_step_ms(rec):
    return work.median(rec["steps_ms"])


def counter(rec, name: str, scale: float = 1.0):
    v = rec["counters"].get(name)
    return None if v is None else v * scale


def tail(rec, name: str):
    return rec["tails"].get(name)
