"""Named spans at the port's layer boundaries, for a profiler's timeline.

`span(name)` opens a profiler range while a profiler runs on the calling
thread, and does nothing otherwise: on an Intel Xeon core the check and
an empty context cost under 1 us. The range is an op-scope range
(``torch._C._profiler._RecordFunctionFast``), not the user annotation
``torch.profiler.record_function`` opens: it dispatches no ``profiler``
op, so the cost counter's op log stays as it was (`core.hlo_cost` takes
an op's source from the innermost dispatched range), and it leaves no
mark on the device timeline. A user annotation there spans all the
device work launched inside it, idle gaps included, and a trace reader
that takes every device event for an operation would count it as one.
The spans show on the host threads' timelines, on the device trace's
clock. The autograd engine hands the profiler's state to its device
threads, so a span inside a backward opens there too.

Every name starts with ``repro_torch.``; the spans and what they cover:

- ``repro_torch.serve.admit``: `ServeSession.step`'s admission round
  (the scheduler, radix adoption, the non-chunked prefill);
- ``repro_torch.serve.control``: the step's per-row inputs, `begin_step`
  and the control and token uploads;
- ``repro_torch.serve.launch``: the host issuing the fused step;
- ``repro_torch.serve.tokens``: the host waiting for the sampled tokens;
- ``repro_torch.serve.pages``: `end_step`, filled pages read back into
  the pool;
- ``repro_torch.serve.stream``: tokens appended, finishes, radix inserts
  and events after the step;
- ``repro_torch.train.forward``, ``repro_torch.train.backward``,
  ``repro_torch.train.optimizer``: the train step's loss, its gradients
  and the clip norm with AdamW;
- ``repro_torch.ssd_scan.backward``: `SsdScanFn.backward`, on the thread
  that runs the backward.
"""
from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

_CLOSED = contextlib.nullcontext()


def span(name: str):
    """A context for the span `name`: a profiler range while a profiler
    runs on this thread, else a shared context that does nothing."""
    if _profiler_enabled():
        return _RecordFunctionFast(name)
    return _CLOSED
