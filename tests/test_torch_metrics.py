"""The port's ``serve/metrics.py`` against the JAX package's: the cases of
``tests/test_metrics.py`` (empty series, one-sample percentiles, the
speculative run-splitting rule for per-token latency) and the preemption
/ SLO cases of ``tests/test_preemption.py``, each driven through both
modules on the same fake clock. Every latency, summary and per-request
dict must be equal (exact float equality: both compute the same numpy
expressions on the same inputs), and the reference's own assertions
hold for the port."""
import pytest

from repro.serve import metrics as jax_metrics
from repro_torch.serve import metrics as port_metrics

MODULES = (jax_metrics, port_metrics)


class FakeClock:
    """Deterministic monotonic clock: `advance` then read."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt
        return self.now


def both(scenario):
    """Run ``scenario(module)`` on the JAX module and on the port's; the
    results must be equal. Returns the port's."""
    want, got = (scenario(mod) for mod in MODULES)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# percentile and the unit helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("xs", [[], [None, None], [0.25], [None, 0.25],
                                [0.1, 0.5, 0.2, 0.9, 0.3]],
                         ids=["empty", "all_none", "one", "none_and_one",
                              "five"])
def test_percentile_matches_reference(xs):
    out = both(lambda m: [m.percentile(list(xs), q) for q in (0, 50, 99)])
    if not [x for x in xs if x is not None]:
        assert out == [None, None, None]
    if xs in ([0.25], [None, 0.25]):
        assert out[1] == out[2] == 0.25


def test_unit_helpers_guard_zero():
    out = both(lambda m: (m.us_per(1.0, 0), m.toks_per_s(0, 0.0),
                          m.us_per(2.0, 4), m.toks_per_s(10, 2.0)))
    assert out == (1e6, 0.0, 5e5, 5.0)


# ---------------------------------------------------------------------------
# RequestMetrics lifecycle with a fake clock
# ---------------------------------------------------------------------------
def _lifecycle(m, events):
    """Replay ``events`` ((op, arg) pairs) on a fresh RequestMetrics of
    module m; returns its dict, itl samples and queue wait."""
    clk = FakeClock()
    r = m.RequestMetrics(clk)
    for op, arg in events:
        if op == "advance":
            clk.advance(arg)
        elif op == "finish":
            r.on_finish(*arg)
        elif arg is None:
            getattr(r, op)()
        else:
            getattr(r, op)(arg)
    return r.as_dict(), list(r.itl_s), r.queue_wait_s


LIFECYCLES = {
    # first delivery's gap is the TTFT; a 1-token first delivery has no
    # per-token sample
    "first_delivery_ttft": [("advance", 0.5), ("on_admit", None),
                            ("advance", 1.5), ("on_tokens", 1)],
    # a first delivery of n > 1 tokens: n - 1 samples of gap / n
    "first_delivery_spec_run": [("advance", 3.0), ("on_tokens", 4)],
    # later 1-token deliveries: one sample of the whole gap each
    "later_n1": [("advance", 1.0), ("on_tokens", 1), ("advance", 0.2),
                 ("on_tokens", 1), ("advance", 0.4), ("on_tokens", 1)],
    # a later accepted run of n tokens: n samples of gap / n
    "later_spec_run": [("advance", 1.0), ("on_tokens", 1),
                       ("advance", 0.6), ("on_tokens", 3)],
    # the engine's eos-trimmed count wins
    "finish_trusts_engine": [("advance", 1.0), ("on_tokens", 5),
                             ("finish", (4, 0.5))],
    "cancel": [("on_admit", None), ("advance", 0.3), ("on_tokens", 2),
               ("on_cancel", None)],
    "reject": [("on_reject", "queue_full")],
    "error": [("on_admit", None), ("advance", 0.1), ("on_tokens", 1),
              ("on_error", "swap_fail")],
}


@pytest.mark.parametrize("name", sorted(LIFECYCLES))
def test_request_lifecycle_matches_reference(name):
    d, itl, wait = both(lambda m: _lifecycle(m, LIFECYCLES[name]))
    if name == "first_delivery_ttft":
        assert wait == 0.5 and d["ttft_s"] == 2.0 and itl == []
        assert d["tpot_s"] is None
    elif name == "first_delivery_spec_run":
        assert d["ttft_s"] == 3.0 and itl == pytest.approx([0.75] * 3)
    elif name == "later_n1":
        assert itl == pytest.approx([0.2, 0.4])
        assert d["tpot_s"] == pytest.approx(0.3)
    elif name == "later_spec_run":
        assert itl == pytest.approx([0.2, 0.2, 0.2]) and d["tokens"] == 4
    elif name == "finish_trusts_engine":
        assert d["tokens"] == 4 and d["accept_rate"] == 0.5
        assert d["status"] == "done"


# ---------------------------------------------------------------------------
# MetricsRegistry summaries
# ---------------------------------------------------------------------------
def _empty(m):
    return m.MetricsRegistry(FakeClock()).summary()


def _all_rejected(m):
    reg = m.MetricsRegistry(FakeClock())
    reg.reject("queue_full")
    reg.reject("pool_capacity")
    return reg.summary(), reg.requests[0].reject_reason


def _single(m):
    clk = FakeClock()
    reg = m.MetricsRegistry(clk)
    r = reg.submit()
    clk.advance(0.5)
    r.on_admit()
    clk.advance(0.5)
    r.on_tokens(1)
    clk.advance(0.1)
    r.on_tokens(1)
    r.on_finish(tokens=2)
    return reg.summary()


def test_summary_empty_registry():
    s = both(_empty)
    assert s["n_requests"] == 0 and s["tokens"] == 0
    assert s["throughput_tok_s"] is None
    for key in ("ttft", "tpot", "queue_wait"):
        assert s[key] == {"p50_ms": None, "p99_ms": None, "mean_ms": None}
    assert s["accept_rate"] is None


def test_summary_all_rejected_has_no_latencies():
    s, reason = both(_all_rejected)
    assert s["n_rejected"] == 2 and s["n_done"] == 0
    assert s["wall_s"] == 0.0 and s["throughput_tok_s"] is None
    assert s["ttft"]["p99_ms"] is None
    assert reason == "queue_full"


def test_summary_single_request_p50_equals_p99():
    s = both(_single)
    assert s["ttft"]["p50_ms"] == s["ttft"]["p99_ms"] \
        == pytest.approx(1000.0)
    assert s["tpot"]["p50_ms"] == s["tpot"]["p99_ms"] \
        == pytest.approx(100.0)
    assert s["queue_wait"]["mean_ms"] == pytest.approx(500.0)
    assert s["tokens"] == 2
    assert s["throughput_tok_s"] == pytest.approx(2 / 1.1)


# ---------------------------------------------------------------------------
# Preempt / resume spans and SLO attainment (tests/test_preemption.py)
# ---------------------------------------------------------------------------
def _slo(m):
    now = [0.0]
    reg = m.MetricsRegistry(clock=lambda: now[0])
    r = reg.submit()
    r.deadline_s = 5.0
    r.on_admit()
    now[0] = 1.0
    r.on_tokens(1)
    r.on_preempt()
    now[0] = 3.0
    r.on_resume()
    now[0] = 3.5
    r.on_tokens(1)
    now[0] = 4.0
    r.on_finish(2)
    first = (r.preempts, list(r.resume_wait_s), max(r.itl_s),
             r.met_deadline)
    missed = reg.submit()
    missed.deadline_s = 0.5
    missed.on_admit()
    now[0] = 6.0
    missed.on_tokens(1)
    missed.on_finish(1)
    shed = reg.submit()
    shed.deadline_s = 1.0
    shed.on_reject("deadline_infeasible")
    err = reg.submit()
    err.deadline_s = 1.0
    err.on_error("swap_fail")
    return first, missed.met_deadline, reg.summary(), \
        [x.as_dict() for x in reg.requests]


def test_metrics_preempt_resume_and_slo():
    (preempts, waits, max_itl, met), missed, s, _ = both(_slo)
    assert preempts == 1 and waits == [2.0]
    assert max_itl <= 1.0          # the parked span is not a token gap
    assert met is True and missed is False
    assert s["preemptions"] == 1 and s["n_preempted"] == 1
    assert s["resume_wait"]["p50_ms"] == 2000.0
    assert s["slo_attainment"] == 0.25           # 1 of 4 deadline-carriers
    assert s["deadline_misses"] == 3             # shed + error count
    assert s["n_errors"] == 1
    assert s["reject_reasons"] == {"deadline_infeasible": 1}


def test_request_metrics_no_deadline_has_no_slo():
    def scenario(m):
        r = m.RequestMetrics(clock=lambda: 0.0)
        reg = m.MetricsRegistry(clock=lambda: 0.0)
        reg.submit().on_finish(1)
        return r.met_deadline, reg.summary()["slo_attainment"]

    assert both(scenario) == (None, None)
