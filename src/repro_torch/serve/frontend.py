"""Async streaming serve front end: the open-loop request lifecycle over
the continuous-batching stepper — the JAX package's
``repro/serve/frontend.py`` over the port's `ServeSession` (the port
imports nothing of that package).

`AsyncServeFrontend` wraps a `ServeSession` (the step-granular serving
core shared with `ServeEngine.serve`) in an asyncio driver:

    submit -> bounded queue -> admit -> fused step -> stream / cancel

- ``submit`` returns a `StreamHandle` whose tokens stream out per fused
  decode step (``async for tok in handle``). Greedy streams are
  token-for-token identical to `ServeEngine.serve` on the same requests
  — the session's `StreamEvent` tokens ARE the final output, incl. the
  eos/max_new clamping.
- Admission backpressure: ``max_queue`` bounds the waiting line. A
  submit that finds it full is rejected with a structured `Admission`
  verdict (reason ``queue_full``) instead of blocking — open-loop load
  sheds instead of deadlocking. Pool-capacity/session-capacity verdicts
  from the session surface the same way (``handle.rejected``).
- ``handle.cancel()`` retires the request mid-decode at the next step
  boundary: its row frees, its pool pages drop their refs, and the
  stream ends with the tokens delivered so far as the partial result.
- Per-request metrics (queue wait, TTFT, per-token latency, accept
  rate) collect into a `serve.metrics.MetricsRegistry`
  (``frontend.metrics.summary()`` for p50/p99).

The driver runs decode steps synchronously inside the event loop (one
process, one device): a step blocks the loop for its duration, and
``await asyncio.sleep(0)`` between steps lets submissions, cancels and
consumers interleave. That is the right shape for a single-device
engine — concurrency buys request multiplexing, not compute overlap.
"""
from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np

from repro_torch.serve.engine import ServeEngine, ServeSession
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.scheduler import Admission, Request

_EOS = object()      # end-of-stream sentinel on handle queues


class StreamHandle:
    """One submitted request's streaming view.

    ``async for tok in handle`` yields ints as decode steps land them
    (a speculative step may land several at once). ``await
    handle.result()`` waits for completion and returns the full output
    (np.int64, exactly what `ServeEngine.serve` would return; partial if
    cancelled; empty if rejected). ``handle.cancel()`` stops the request
    at the next step boundary. ``handle.admission`` is the structured
    verdict; ``handle.rejected`` is True when it said no."""

    def __init__(self, frontend: "AsyncServeFrontend", request: Request):
        self._frontend = frontend
        self.request = request
        self.admission: Optional[Admission] = None
        self.cancelled = False
        self.error: Optional[BaseException] = None
        # structured mid-flight failure reason ("swap_fail", a late
        # deadline shed, ...) — the stream still ends cleanly with the
        # tokens delivered so far as the partial result
        self.error_reason: Optional[str] = None
        self._queue: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()
        self._result: Optional[np.ndarray] = None

    @property
    def rejected(self) -> bool:
        return self.admission is not None and not self.admission.admitted

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        item = await self._queue.get()
        if item is _EOS:
            if self.error is not None:
                raise self.error
            raise StopAsyncIteration
        return item

    async def result(self) -> np.ndarray:
        await self._done.wait()
        if self.error is not None:
            raise self.error
        return self._result

    def cancel(self) -> bool:
        """Cancel this request (no-op once finished). The stream ends
        after the tokens already delivered."""
        return self._frontend._cancel(self)

    # -- driver side --------------------------------------------------------
    def _push(self, tokens) -> None:
        for t in tokens:
            self._queue.put_nowait(int(t))

    def _finalize(self, result, error: Optional[BaseException] = None):
        if self._done.is_set():
            return
        self.error = error
        self._result = result if result is not None \
            else np.zeros(0, np.int64)
        self._done.set()
        self._queue.put_nowait(_EOS)


class AsyncServeFrontend:
    """Open-loop streaming front end over one `ServeEngine`.

        async with AsyncServeFrontend(engine, capacity=256) as front:
            handle = await front.submit(Request(prompt, max_new_tokens=32))
            async for tok in handle:
                ...
        print(front.metrics.summary())

    ``capacity`` (tokens) sizes the session page table for the longest
    request the front end will accept; ``max_active`` bounds the decode
    rows; ``max_queue`` bounds the waiting line (backpressure);
    ``speculate`` fixes the verify-graph width for speculative requests.
    The driver task starts at ``start()`` (or async-with entry) and
    drains remaining work at ``close()`` exit."""

    def __init__(self, engine: ServeEngine, *, capacity: int = 1024,
                 max_active: int = 4, max_queue: int = 16,
                 speculate: Optional[int] = None, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 prefix_cache: bool = True, metrics=None,
                 chunked_prefill: Optional[bool] = None,
                 prefill_budget: int = 1, radix: Optional[bool] = None,
                 preempt: bool = True, preempt_policy=None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.session = ServeSession(
            engine, capacity=capacity, max_active=max_active,
            speculate=speculate, greedy=greedy, temperature=temperature,
            seed=seed, prefix_cache=prefix_cache, metrics=self.metrics,
            chunked_prefill=chunked_prefill, prefill_budget=prefill_budget,
            radix=radix, preempt=preempt, preempt_policy=preempt_policy)
        self.engine = engine
        self.max_queue = max_queue
        self._handles: dict[int, StreamHandle] = {}
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._closing = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Start the driver task on the running event loop."""
        if self._task is not None:
            raise RuntimeError("front end already started")
        self._wake = asyncio.Event()
        self._task = asyncio.get_running_loop().create_task(self._drive())

    async def close(self) -> None:
        """Drain in-flight and queued requests, then stop the driver.
        New submissions are refused once closing."""
        if self._task is None:
            return
        self._closing = True
        self._wake.set()
        await self._task
        self._task = None
        # drop the session's radix pins so a closed front end leaves
        # only truly in-flight pages live in the pool
        self.session.close()

    async def __aenter__(self) -> "AsyncServeFrontend":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- client side --------------------------------------------------------
    async def submit(self, request: Request) -> StreamHandle:
        """Submit a request; returns its `StreamHandle` immediately. A
        full queue or an impossible request yields an already-finished
        handle with ``handle.rejected`` set — check it (or just iterate:
        a rejected stream is simply empty)."""
        if self._task is None or self._closing:
            raise RuntimeError("front end is not running (use `async with`"
                               " or call start())")
        handle = StreamHandle(self, request)
        if self.session.queue_depth >= self.max_queue:
            handle.admission = Admission(
                False, reason="queue_full",
                detail=f"waiting queue is at max_queue={self.max_queue}; "
                       f"retry after in-flight requests retire")
            self.metrics.reject("queue_full")
            handle._finalize(None)
            return handle
        verdict = self.session.submit(request)
        handle.admission = verdict
        if not verdict:
            handle._finalize(None)
            return handle
        self._handles[id(request)] = handle
        self._wake.set()
        return handle

    async def drain(self) -> None:
        """Wait until every accepted request has finished or been
        cancelled (the front end stays open for more submissions)."""
        while True:
            pending = [h for h in self._handles.values() if not h.done]
            if not pending:
                return
            await asyncio.gather(*(h._done.wait() for h in pending))

    def _cancel(self, handle: StreamHandle) -> bool:
        ok = self.session.cancel(handle.request)
        if ok:
            handle.cancelled = True
            handle._finalize(self.session.result(handle.request))
            self._handles.pop(id(handle.request), None)
        return ok

    # -- driver -------------------------------------------------------------
    async def _drive(self) -> None:
        try:
            while True:
                if self.session.done:
                    if self._closing:
                        return
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                events = self.session.step()
                for ev in events:
                    handle = self._handles.get(id(ev.request))
                    if handle is None:        # cancelled mid-step
                        continue
                    handle._push(ev.tokens)
                    if ev.error is not None:
                        handle.error_reason = ev.error
                    if ev.done:
                        # a late pool-capacity rejection replaces the
                        # admission verdict — refresh so handle.rejected
                        # reflects it
                        handle.admission = self.session.admission(
                            ev.request)
                        handle._finalize(self.session.result(ev.request))
                        self._handles.pop(id(ev.request), None)
                # let submitters / consumers / cancellers interleave
                await asyncio.sleep(0)
        except BaseException as e:
            for handle in list(self._handles.values()):
                handle._finalize(None, error=e)
            self._handles.clear()
            raise
