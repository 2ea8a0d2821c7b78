"""The traced run's record: the benchmark's own ranges and the device's
operations, read from one `torch.profiler` trace.

The benchmark opens `torch.profiler.record_function` ranges named
``bench.<what>`` around the calls it makes into the program (a serving
step, a kernel call through ``kernels.api.run``, a training step). After
the window the trace's raw events are read once (a tree of function
events would take minutes at tens of thousands of kernels):

- every device operation (kernel, copy, set) with its start and end;
- every ``bench.`` range, with its thread;
- every runtime call that launched a device operation, linked to it by
  the trace's correlation id, so that each device operation is
  attributed to the innermost ``bench.`` range open on the launching
  thread when it was launched.

Busy time is the union of the device operations' intervals (as
``chip_smoke.py`` computes its busy share); an idle gap is named by the
innermost ``bench.`` range open on the main thread at its middle.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "bench."


def union_seconds(intervals) -> float:
    """Total length of the union of (start, end) intervals, in their
    unit."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Ranges:
    """``bench.`` ranges of one thread, for the innermost one open at a
    time (ranges nest: a later-starting open range is inside an earlier
    one)."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
        self.starts = [r[1] for r in self.ranges]
        # each range's parent: the innermost earlier range covering it
        self.parent, stack = [], []
        for i, (_, start, end) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][2] < start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t) -> tuple:
        """The names of the ranges open at `t`, innermost first."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.ranges[j][2] < t:
            j = self.parent[j]
        out = []
        while j >= 0:
            out.append(self.ranges[j][0])
            j = self.parent[j]
        return tuple(out)


class Trace:
    """The reduced trace of one traced window.

    ``ops``: device operations as (name, start s, end s, names of the
    ranges open at the launch, innermost first), times from the window's
    start; ``ranges``: ``{name: [(start,
    end)]}`` on every thread; ``window_s``, ``busy_s``; ``gaps``: idle
    seconds by the range open on the main thread."""

    def __init__(self, ops, ranges, window_s, gaps):
        self.ops = ops
        self.ranges = ranges
        self.window_s = window_s
        self.busy_s = union_seconds((s, e) for _, s, e, _ in ops)
        self.gaps = gaps

    def ops_under(self, range_name: str):
        """Device operations launched inside a range of that name."""
        return [op for op in self.ops if range_name in op[3]]

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = defaultdict(float)
        for name, s, e, _ in self.ops:
            by_name[name[:160]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def reduce(prof) -> Trace:
    """Read a finished profiler's raw events inside the ``bench.window``
    range that the caller opened around the traced window, on the thread
    that opened it."""
    from torch.autograd import DeviceType
    device, cpu_by_corr, ranges = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the ranges' own marks on the device's timeline are no work
            if not name.startswith(PREFIX):
                device.append((name, e.start_ns(), e.end_ns(),
                               e.correlation_id()))
            continue
        if name.startswith(PREFIX):
            ranges.append((name, e.start_thread_id(), e.start_ns(),
                           e.end_ns()))
        else:
            corr = e.correlation_id()
            if corr and (name.startswith("cu") or "Launch" in name
                         or "Memcpy" in name or "Memset" in name):
                cpu_by_corr[corr] = (e.start_thread_id(), e.start_ns())
    by_tid = defaultdict(list)
    for name, tid, s, e in ranges:
        by_tid[tid].append((name, s, e))
    lookup = {tid: Ranges(rs) for tid, rs in by_tid.items()}
    win = [r for r in ranges if r[0] == PREFIX + "window"]
    if not win:
        raise RuntimeError("the trace holds no bench.window range")
    _, main_tid, t0_ns, t1_ns = win[0]
    ops = []
    for name, s, e, corr in device:
        if e < t0_ns or s > t1_ns:
            continue
        chain = ()
        launch = cpu_by_corr.get(corr)
        if launch is not None:
            tid, t = launch
            chain = lookup[tid].at(t) if tid in lookup else ()
        ops.append((name, (max(s, t0_ns) - t0_ns) / 1e9,
                    (min(e, t1_ns) - t0_ns) / 1e9, chain))
    ops.sort(key=lambda op: op[1])
    window_s = (t1_ns - t0_ns) / 1e9
    gaps: dict = defaultdict(float)
    main = lookup.get(main_tid)
    end = 0.0
    for _, s, e, _ in ops + [("", window_s, window_s, ())]:
        if s > end:
            mid = t0_ns + (s + end) / 2 * 1e9
            found = main.at(mid) if main is not None else ()
            gaps[found[0] if found else "none"] += s - end
        end = max(end, e)
    named = defaultdict(list)
    for name, _, s, e in ranges:
        if s >= t0_ns and e <= t1_ns:
            named[name].append(((s - t0_ns) / 1e9, (e - t0_ns) / 1e9))
    return Trace(ops, dict(named), window_s, dict(gaps))
