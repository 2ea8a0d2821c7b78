"""Serving metrics: ONE latency vocabulary for the whole serve layer —
a copy of the JAX package's ``repro/serve/metrics.py`` (numpy only; the
port imports nothing of that package).

The port's `ServeSession`, the async front end (`serve.frontend`) and
trace replay (`serve.traffic`) all report through these helpers, so a
"TTFT" or a "per-token latency" means the same thing in every number the
port emits:

- queue wait         admit time - submit time (scheduler wait)
- TTFT               first streamed token - submit time. The prefill
                     token counts: it is the first token the client sees.
- per-token latency  the gap between consecutive token deliveries,
  (TPOT / ITL)       divided evenly over the tokens a delivery carries —
                     a speculative verify step that lands an accepted run
                     of n tokens contributes n samples of gap/n, so
                     speculation shows up as *lower* per-token latency
                     rather than as fewer, larger gaps.
- accept_rate        accepted drafts / proposed drafts (speculative rows
                     only; None elsewhere), from `SpecStats`.

`MetricsRegistry` collects one `RequestMetrics` per request across its
lifecycle (submit -> admit -> stream -> [preempt -> resume] -> finish /
cancel / reject / error) and summarizes p50/p99 TTFT, p50/p99 per-token
latency, queue wait, throughput and SLO attainment over the population.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np


def percentile(xs, q) -> Optional[float]:
    """q-th percentile of a sample list; None on an empty sample (a mix
    with zero completed requests has no p99, not a fake 0.0)."""
    xs = [x for x in xs if x is not None]
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


def us_per(seconds: float, n: int) -> float:
    """Microseconds per event."""
    return 1e6 * seconds / max(n, 1)


def toks_per_s(tokens: int, seconds: float) -> float:
    return tokens / max(seconds, 1e-9)


class RequestMetrics:
    """One request's lifecycle timestamps + derived latencies.

    ``status``: queued -> active -> done | cancelled; or rejected (never
    admitted — admission verdict said no, or the front-end queue was
    full); or error (admitted but failed mid-flight, e.g. a swap-in
    fault — partial tokens may have streamed). Preemption transitions
    (active -> parked -> active) are counted per request (``preempts``)
    with the parked spans collected in ``resume_wait_s``. Times come from
    the registry's clock (``time.perf_counter`` by default; injectable
    for tests)."""

    __slots__ = ("status", "reject_reason", "error_reason", "submit_s",
                 "admit_s", "first_token_s", "end_s", "tokens", "itl_s",
                 "accept_rate", "deadline_s", "preempts", "resume_wait_s",
                 "_clock", "_last_s", "_parked_s")

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.status = "queued"
        self.reject_reason = None
        self.error_reason = None
        self.submit_s = clock()
        self.admit_s = None
        self.first_token_s = None
        self.end_s = None
        self.tokens = 0
        self.itl_s: list[float] = []     # per-token delivery gaps
        self.accept_rate = None
        self.deadline_s = None           # SLO budget (Request.deadline)
        self.preempts = 0                # times parked to the host tier
        self.resume_wait_s: list[float] = []  # parked span per preemption
        self._last_s = None
        self._parked_s = None

    # -- lifecycle events ---------------------------------------------------
    def on_admit(self):
        self.status = "active"
        self.admit_s = self._clock()

    def on_tokens(self, n: int):
        """n tokens delivered now (n > 1 for an accepted speculative run:
        the step's gap is split evenly over its tokens)."""
        now = self._clock()
        if self.first_token_s is None:
            self.first_token_s = now
            gap, n_gaps = now - self.submit_s, n - 1   # 1st gap is the TTFT
        else:
            gap, n_gaps = now - self._last_s, n
        if n_gaps > 0:
            self.itl_s.extend([gap / max(n, 1)] * n_gaps)
        self.tokens += n
        self._last_s = now

    def on_finish(self, tokens: int, accept_rate=None):
        """`tokens` is the final eos-trimmed count — the engine may have
        streamed a token the eos clamp then kept, so trust its number."""
        self.status = "done"
        self.end_s = self._clock()
        self.tokens = tokens
        self.accept_rate = accept_rate

    def on_cancel(self):
        self.status = "cancelled"
        self.end_s = self._clock()

    def on_reject(self, reason: str):
        self.status = "rejected"
        self.reject_reason = reason
        self.end_s = self.submit_s

    def on_preempt(self):
        self.preempts += 1
        self._parked_s = self._clock()

    def on_resume(self):
        if self._parked_s is not None:
            self.resume_wait_s.append(self._clock() - self._parked_s)
            self._parked_s = None
        # the parked span must not pollute per-token gaps: restart the
        # inter-token clock at resume
        if self._last_s is not None:
            self._last_s = self._clock()

    def on_error(self, reason: str):
        """Admitted but failed mid-flight (structured per-request error,
        e.g. a swap-in fault) — terminal, partial tokens stand."""
        self.status = "error"
        self.error_reason = reason
        self.end_s = self._clock()

    # -- derived ------------------------------------------------------------
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_s is None:
            return None
        return self.admit_s - self.submit_s

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s

    @property
    def total_s(self) -> Optional[float]:
        if self.end_s is None:
            return None
        return self.end_s - self.submit_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean per-token latency past the first token."""
        if not self.itl_s:
            return None
        return sum(self.itl_s) / len(self.itl_s)

    @property
    def met_deadline(self) -> Optional[bool]:
        """True/False for finished deadline-carrying requests; None when
        no deadline was set or the request never finished (sheds and
        errors count as misses in the summary's SLO attainment)."""
        if self.deadline_s is None:
            return None
        if self.status != "done" or self.total_s is None:
            return False
        return self.total_s <= self.deadline_s

    def as_dict(self) -> dict:
        return {"status": self.status, "tokens": self.tokens,
                "queue_wait_s": self.queue_wait_s, "ttft_s": self.ttft_s,
                "tpot_s": self.tpot_s, "total_s": self.total_s,
                "accept_rate": self.accept_rate,
                "reject_reason": self.reject_reason,
                "error_reason": self.error_reason,
                "deadline_s": self.deadline_s,
                "preempts": self.preempts,
                "met_deadline": self.met_deadline}


class MetricsRegistry:
    """Per-request metrics for one serving run (a front-end lifetime, a
    trace replay, one `serve()` call)."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.requests: list[RequestMetrics] = []

    def submit(self) -> RequestMetrics:
        m = RequestMetrics(self._clock)
        self.requests.append(m)
        return m

    def reject(self, reason: str) -> RequestMetrics:
        """Record a request turned away before it reached the session
        (e.g. the front end's bounded queue was full)."""
        m = self.submit()
        m.on_reject(reason)
        return m

    def summary(self) -> dict:
        """Population summary, the reference's schema.
        Latencies in ms (p50/p99/mean), throughput in tokens/s over the
        wall span from first submit to last end."""
        ms = 1e3
        reqs = self.requests
        done = [m for m in reqs if m.status == "done"]
        cancelled = [m for m in reqs if m.status == "cancelled"]
        rejected = [m for m in reqs if m.status == "rejected"]
        errors = [m for m in reqs if m.status == "error"]
        served = done + cancelled + errors
        tokens = sum(m.tokens for m in served)
        ends = [m.end_s for m in reqs if m.end_s is not None]
        wall = (max(ends) - min(m.submit_s for m in reqs)) if ends else 0.0
        ttft = [m.ttft_s for m in served]
        itl = [g for m in served for g in m.itl_s]
        waits = [m.queue_wait_s for m in served]
        rates = [m.accept_rate for m in done if m.accept_rate is not None]
        # SLO attainment over every deadline-carrying request the system
        # owed an answer to: sheds and errors count as misses, client
        # cancellations don't count at all. None when nothing carried a
        # deadline (so "no SLOs in play" never reads as "100% attained").
        dl = [m for m in reqs
              if m.deadline_s is not None and m.status != "cancelled"]
        resume_waits = [w for m in reqs for w in m.resume_wait_s]
        reject_reasons: dict[str, int] = {}
        for m in rejected:
            r = m.reject_reason or "unknown"
            reject_reasons[r] = reject_reasons.get(r, 0) + 1

        def stats(xs):
            xs = [x for x in xs if x is not None]
            return {"p50_ms": None if not xs else percentile(xs, 50) * ms,
                    "p99_ms": None if not xs else percentile(xs, 99) * ms,
                    "mean_ms": None if not xs else sum(xs) / len(xs) * ms}

        return {
            "n_requests": len(reqs), "n_done": len(done),
            "n_cancelled": len(cancelled), "n_rejected": len(rejected),
            "n_errors": len(errors),
            "tokens": tokens, "wall_s": wall,
            "throughput_tok_s": toks_per_s(tokens, wall) if wall else None,
            "ttft": stats(ttft), "tpot": stats(itl),
            "queue_wait": stats(waits),
            "accept_rate": sum(rates) / len(rates) if rates else None,
            "preemptions": sum(m.preempts for m in reqs),
            "n_preempted": sum(1 for m in reqs if m.preempts),
            "resume_wait": stats(resume_waits),
            "slo_attainment": (sum(1 for m in dl if m.met_deadline)
                               / len(dl)) if dl else None,
            "deadline_misses": sum(1 for m in dl if not m.met_deadline),
            "reject_reasons": reject_reasons,
        }
