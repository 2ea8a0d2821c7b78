"""The port's host swap tier and SLO-aware preemption against the JAX
package's, on the starcoder2-7b smoke config with shared params and
4-token pages — the cases of ``tests/test_preemption.py`` (all but the
Sibyl policy's, which is not ported): swap-out parks a sequence's pages
on the host tier bit-identically (float stays float, int8 stays int8;
shared pages stay resident), preempt / resume rejoins decode with greedy
tokens equal to the never-preempted run (plain, mid chunk fill, a k = 4
speculative row), cancelling a parked request frees everything, a failed
swap-in surfaces as a structured per-request error, and the scheduler
orders by urgency and sheds by deadline on a fake clock.

Each session case runs the same scenario through both engines and
requires equality of greedy tokens, request stats, `Admission` verdicts,
pool stats (the swap stats included), transfer counts and the
preempt / resume counts. The overload mix replays deterministically (a
fake clock, a fixed step time) through both sessions with the same
equalities, and once through the port's async `run_trace` with the
reference test's accounting checks."""
import types

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.engine import ServeSession as JaxSession
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro.serve.metrics import MetricsRegistry as JaxRegistry
from repro.serve.preemption import LRUVictimPolicy as JaxLRU
from repro.serve.preemption import RequestView as JaxView
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro.serve.traffic import MIXES as JAX_MIXES
from repro.serve.traffic import make_trace as jax_make_trace
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine, ServeSession
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.paged_state import StateLayout
from repro_torch.serve.preemption import LRUVictimPolicy, RequestView
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.traffic import MIXES, make_trace

ARCH = "starcoder2-7b"

SIDES = {
    "jax": types.SimpleNamespace(
        name="jax", Engine=JaxEngine, Session=JaxSession, Request=JaxRequest,
        Pool=JaxPool, Registry=JaxRegistry, cfg=jax_smoke(ARCH),
        kw={"decode_mode": "fused"}),
    "port": types.SimpleNamespace(
        name="port", Engine=ServeEngine, Session=ServeSession,
        Request=Request, Pool=PagedKVPool, Registry=MetricsRegistry,
        cfg=smoke_config(ARCH), kw={"device": "cpu"}),
}


@pytest.fixture(scope="module")
def params():
    """side -> params: the JAX engine's and the port's copy of them."""
    jparams = JaxEngine(jax_smoke(ARCH)).params
    return {"jax": jparams,
            "port": params_from_numpy(smoke_config(ARCH),
                                      jax.tree.map(np.asarray, jparams))}


def _engine(side, params, policy=None, **kw):
    pool = side.Pool(page_tokens=4,
                     placement_policy=policy() if policy else None)
    return side.Engine(side.cfg, params=params[side.name], kv_pool=pool,
                       **side.kw, **kw)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, smoke_config(ARCH).vocab_size, n).astype(np.int32)


def _drain(ses, events=None):
    while not ses.done:
        evs = ses.step()
        if events is not None:
            events.extend(evs)


def _outcome(ses, eng, reqs):
    """What both engines must agree on after a session drained."""
    return {
        "results": [None if ses.result(r) is None else ses.result(r).tolist()
                    for r in reqs],
        "stats": [ses.request_stats(r) for r in reqs],
        "admissions": [ses.admission(r).as_dict() for r in reqs],
        "pool": dict(eng.kv_pool.stats),
        "transfers": tuple(ses.transfer_counts()),
        "preemptions": ses.preemptions, "resumes": ses.resumes,
        "live_pages": eng.kv_pool.live_pages,
        "host_pages": eng.kv_pool.host_pages}


def both(params, scenario):
    """Run ``scenario(side, params)`` through the JAX engine and the
    port's; the outcomes must be equal. Returns the port's."""
    want = scenario(SIDES["jax"], params)
    got = scenario(SIDES["port"], params)
    assert got == want
    return got


def _solo(params, prompt, new, **kw):
    """The never-preempted run: the port's generate of one request."""
    eng = _engine(SIDES["port"], params, **kw)
    return eng.generate([Request(prompt.copy(), new)],
                        free_pages=True)[0].tolist()


# ---------------------------------------------------------------------------
# Pool tier mechanics
# ---------------------------------------------------------------------------
def _pages(n, seed=0, t=4, h=2, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, h, d)).astype(np.float32)
            for _ in range(n)]


def test_pool_swap_roundtrip_bit_identical():
    """Swap-out keeps each page's resident representation (fast float
    stays float, demoted int8 stays int8); swap-in restores it on its
    tier, byte for byte — on both pools, with equal stats."""
    k0, v0, k1, v1 = _pages(4)

    def scenario(Pool):
        pool = Pool(page_tokens=4, fast_capacity_pages=1)
        p0 = pool.put(7, k0, v0)
        p1 = pool.put(7, k1, v1)                 # demotes p0 to int8
        demoted = [x.copy() for x in pool.get(p0)]
        moved = sorted(pid for pid, _ in pool.swap_out_seq(7))
        parked = (pool.host_pages, pool.resident_pages, pool.headroom(),
                  pool.pages[p0].resident_tier, pool.pages[p1].resident_tier,
                  dict(pool.stats))
        pool.check_invariants()
        pool.swap_in_seq(7)
        back = (pool.pages[p0].tier, pool.pages[p0].quantized,
                pool.pages[p1].tier, pool.pages[p1].quantized)
        data = [x.copy() for x in pool.get(p1)] + \
            [x.copy() for x in pool.get(p0)]
        pool.check_invariants()
        pool.free(7)
        return moved, parked, back, demoted, data, pool.live_pages, \
            dict(pool.stats)

    want, got = scenario(JaxPool), scenario(PagedKVPool)
    moved, parked, back, demoted, data, live, stats = got
    assert (moved, parked, back, live, stats) == \
        (want[0], want[1], want[2], want[5], want[6])
    for a, b in zip(data + demoted, want[4] + want[3]):
        np.testing.assert_array_equal(a, b)      # bit-identical to JAX's
    assert moved == [0, 1] and parked[:2] == (2, 0)
    assert parked[3:5] == ("slow", "fast") and parked[5]["swap_out_bytes"]
    assert back == ("slow", True, "fast", False)
    np.testing.assert_array_equal(data[0], k1)
    np.testing.assert_array_equal(data[1], v1)
    for a, b in zip(data[2:], demoted):
        np.testing.assert_array_equal(a, b)
    assert live == 0


def test_pool_swap_skips_shared_pages():
    """A page another holder still references stays resident; when the
    last live holder parks too, it parks with it."""
    a, b, c, d, e, f = _pages(6, seed=1)

    def scenario(Pool):
        pool = Pool(page_tokens=4)
        shared = pool.put(1, a, b, content_hash="h0")
        own = pool.put(1, c, d)
        assert pool.put(2, e, f, content_hash="h0") == shared
        first = [pid for pid, _ in pool.swap_out_seq(1)]
        tiers = (pool.pages[shared].tier, pool.pages[own].tier)
        second = [pid for pid, _ in pool.swap_out_seq(2)]
        pool.check_invariants()
        pool.swap_in_seq(1)
        pool.swap_in_seq(2)
        pool.check_invariants()
        pool.free(1)
        pool.free(2)
        return first, tiers, second, dict(pool.stats), pool.live_pages

    got = scenario(PagedKVPool)
    assert got == scenario(JaxPool)
    assert got[0] == [1] and got[1] == ("fast", "host")
    assert got[2] == [0] and got[4] == 0


def test_invariant_checker_catches_corruption():
    for Pool in (JaxPool, PagedKVPool):
        pool = Pool(page_tokens=4)
        k, v = _pages(2, seed=2)
        pid = pool.put(0, k, v)
        pool.check_invariants()
        pool.pages[pid].refs = 5                 # corrupt: no holders
        with pytest.raises(AssertionError):
            pool.check_invariants(pins={})
        pool.pages[pid].refs = 1
        pool.swap_out_seq(0)
        pool.pages[pid].resident_tier = None     # corrupt: tier lost
        with pytest.raises(AssertionError):
            pool.check_invariants(pins={})
        pool.pages[pid].resident_tier = "fast"
        pool.swap_in_seq(0)
        pool.free(0)


# ---------------------------------------------------------------------------
# Session preempt / resume: token-identical to the unpreempted run
# ---------------------------------------------------------------------------
def test_preempt_resume_token_identical(params):
    pA, pB = _prompt(12, seed=1), _prompt(10, seed=2)

    def scenario(side, params):
        eng = _engine(side, params)
        ses = side.Session(eng, capacity=64, max_active=2)
        A, B = side.Request(pA.copy(), 12), side.Request(pB.copy(), 8)
        ses.submit(A)
        ses.submit(B)
        for _ in range(4):
            ses.step()
        assert ses.preempt(A)
        assert not ses.preempt(A)                # already parked
        assert ses.request_stats(A) is None      # still in flight
        parked = dict(eng.kv_pool.stats)
        for _ in range(2):
            ses.step()                           # B decodes; A resumes
        _drain(ses)
        out = _outcome(ses, eng, [A, B])
        ses.close()
        out["parked_pool"] = parked
        out["closed_live"] = eng.kv_pool.live_pages
        return out

    got = both(params, scenario)
    assert got["parked_pool"]["swap_out_bytes"] > 0
    assert got["results"] == [_solo(params, pA, 12), _solo(params, pB, 8)]
    assert got["preemptions"] == 1 and got["resumes"] == 1
    assert got["closed_live"] == 0


def test_explicit_resume_and_no_radix_pages_park(params):
    """Without the radix tree a sequence's full pages are its own: they
    move to the host tier (``swapped_out`` counts them) and come back on
    an explicit `resume`."""
    pA, pB = _prompt(14, seed=21), _prompt(9, seed=22)

    def scenario(side, params):
        eng = _engine(side, params)
        ses = side.Session(eng, capacity=48, max_active=2, radix=False)
        A, B = side.Request(pA.copy(), 10), side.Request(pB.copy(), 6)
        ses.submit(A)
        ses.submit(B)
        for _ in range(6):
            ses.step()
        assert ses.preempt(A)
        host = eng.kv_pool.host_pages
        assert ses.resume(A) and not ses.resume(A)
        _drain(ses)
        out = _outcome(ses, eng, [A, B])
        out["host_after_park"] = host
        ses.close()
        return out

    got = both(params, scenario)
    assert got["host_after_park"] > 0
    assert got["pool"]["swapped_out"] == got["pool"]["swapped_in"] > 0
    assert got["results"][0] == _solo(params, pA, 10)


def test_priority_arrival_auto_preempts_and_resumes(params):
    """max_active=1: a priority-1 arrival outranks the active priority-0
    row, which parks on the host tier; both finish with their solo
    outputs."""
    pA, pB = _prompt(8, seed=3), _prompt(8, seed=4)

    def scenario(side, params):
        eng = _engine(side, params)
        ses = side.Session(eng, capacity=32, max_active=1)
        A = side.Request(pA.copy(), 10, priority=0)
        B = side.Request(pB.copy(), 4, priority=1)
        ses.submit(A)
        for _ in range(3):
            ses.step()
        ses.submit(B)                            # B strictly outranks A
        _drain(ses)
        out = _outcome(ses, eng, [A, B])
        ses.close()
        out["closed_live"] = eng.kv_pool.live_pages
        return out

    got = both(params, scenario)
    assert got["preemptions"] == 1 and got["resumes"] == 1
    assert got["results"] == [_solo(params, pA, 10), _solo(params, pB, 4)]
    assert got["closed_live"] == 0


def test_preempt_during_chunked_prefill(params):
    """Parking a row still streaming prompt chunks keeps its pending
    suffix and partial tail; the resumed prefill completes and the output
    is the never-preempted run's."""
    prompt = _prompt(22, seed=5)                 # several pages + tail

    def scenario(side, params):
        eng = _engine(side, params)
        ses = side.Session(eng, capacity=48, max_active=1,
                           chunked_prefill=True)
        A = side.Request(prompt.copy(), 8)
        ses.submit(A)
        ses.step()                               # first chunk lands
        assert ses._recs[id(A)].active.prefilling
        assert ses.preempt(A)
        host = eng.kv_pool.host_pages
        _drain(ses)
        out = _outcome(ses, eng, [A])
        out["host_after_park"] = host
        ses.close()
        return out

    got = both(params, scenario)
    assert got["host_after_park"] > 0            # real pages parked
    assert got["results"] == [_solo(params, prompt, 8)]


def test_preempt_speculative_row(params):
    prompt = _prompt(12, seed=6)

    def scenario(side, params):
        eng = _engine(side, params, speculate=4, draft="ngram")
        ses = side.Session(eng, capacity=64, max_active=1, speculate=4)
        A = side.Request(prompt.copy(), 12, speculate=4)
        ses.submit(A)
        for _ in range(2):
            ses.step()
        assert ses.preempt(A)
        _drain(ses)
        out = _outcome(ses, eng, [A])
        ses.close()
        out["closed_live"] = eng.kv_pool.live_pages
        return out

    got = both(params, scenario)
    assert got["results"] == [_solo(params, prompt, 12)]
    assert got["resumes"] == 1 and got["closed_live"] == 0


def test_cancel_swapped_out_sequence(params):
    """Cancelling a parked request frees its host-tier pages and parked
    tail; its partial tokens stand."""
    pA, pB = _prompt(8, seed=7), _prompt(8, seed=8)

    def scenario(side, params):
        eng = _engine(side, params)
        ses = side.Session(eng, capacity=32, max_active=1)
        A = side.Request(pA.copy(), 10)
        B = side.Request(pB.copy(), 4, priority=1)
        ses.submit(A)
        for _ in range(3):
            ses.step()
        ses.submit(B)
        ses.step()                               # B preempts A
        assert ses._recs[id(A)].status == "preempted"
        assert ses.cancel(A) and not ses.cancel(A)
        assert ses._recs[id(A)].status == "cancelled"
        _drain(ses)
        out = _outcome(ses, eng, [A, B])
        ses.close()
        out["closed"] = (eng.kv_pool.live_pages, eng.kv_pool.host_pages)
        return out

    got = both(params, scenario)
    assert len(got["results"][0]) > 0            # partial output stands
    assert got["results"][1] == _solo(params, pB, 4)
    assert got["closed"] == (0, 0)


def test_swap_in_fault_surfaces_structured_error(params, monkeypatch):
    """REPRO_SERVE_FAULT=swap_fail:1.0: the resume's swap-in fails, the
    victim ends as a structured error event with its partial result and
    its pages free; the preemptor is untouched."""
    monkeypatch.setenv("REPRO_SERVE_FAULT", "swap_fail:1.0")
    pA, pB = _prompt(8, seed=9), _prompt(8, seed=10)

    def scenario(side, params):
        eng = _engine(side, params)
        metrics = side.Registry(clock=lambda: 0.0)
        ses = side.Session(eng, capacity=32, max_active=1, metrics=metrics)
        A = side.Request(pA.copy(), 10)
        B = side.Request(pB.copy(), 4, priority=1)
        ses.submit(A)
        for _ in range(3):
            ses.step()
        ses.submit(B)
        events = []
        _drain(ses, events)
        out = _outcome(ses, eng, [A, B])
        out["errors"] = [(ev.request is A, ev.done, ev.tokens)
                         for ev in events if ev.error == "swap_fail"]
        out["status"] = ses._recs[id(A)].status
        out["summary"] = metrics.summary()
        ses.close()
        out["closed_live"] = eng.kv_pool.live_pages
        return out

    got = both(params, scenario)
    assert got["status"] == "error"
    assert got["stats"][0]["error"] == "swap_fail"
    assert got["errors"] == [(True, True, [])]
    assert 0 < len(got["results"][0]) < 10      # partial tokens stand
    assert got["results"][1] == _solo(params, pB, 4)
    assert got["summary"]["n_errors"] == 1
    assert got["closed_live"] == 0


def test_debug_mode_checks_invariants_each_step(params, monkeypatch):
    """REPRO_SERVE_DEBUG checks the pool (and, in the port, the device
    mirror's) invariants after every step; a corrupted refcount fails the
    next step."""
    monkeypatch.setenv("REPRO_SERVE_DEBUG", "1")
    eng = _engine(SIDES["port"], params)
    ses = ServeSession(eng, capacity=32, max_active=2)
    assert ses._debug
    A = Request(_prompt(8, seed=11), 4)
    ses.submit(A)
    _drain(ses)
    assert ses.result(A) is not None
    ses.close()
    ses = ServeSession(eng, capacity=32, max_active=1, radix=False)
    B = Request(_prompt(8, seed=12), 6)
    ses.submit(B)
    ses.step()
    pid = next(iter(eng.kv_pool.pages))
    eng.kv_pool.pages[pid].refs += 1
    with pytest.raises(AssertionError):
        ses.step()
    eng.kv_pool.pages[pid].refs -= 1
    ses.cancel(B)


# ---------------------------------------------------------------------------
# Scheduler: urgency order, deadline shedding (fake clock)
# ---------------------------------------------------------------------------
def _scheds(**kw):
    """(the JAX scheduler, the port's) over empty pools, one fake clock."""
    now = [0.0]
    layout = StateLayout(smoke_config(ARCH), 4)
    js = JaxScheduler(JaxPool(page_tokens=4), num_layers=2, **kw)
    ps = Scheduler(PagedKVPool(page_tokens=4), layout, **kw)
    for s in (js, ps):
        s._clock = lambda: now[0]
    return js, ps, now


def _req(cls, plen=4, new=4, **kw):
    return cls(np.zeros(plen, np.int32), new, **kw)


def test_waiting_queue_sorted_by_urgency():
    js, ps, _ = _scheds(max_active=1)
    out = []
    for s, cls in ((js, JaxRequest), (ps, Request)):
        lo = _req(cls, priority=0)
        hi = _req(cls, priority=1)
        dl = _req(cls, priority=1, deadline=0.5)
        verdicts = [s.submit(r).as_dict() for r in (lo, hi, dl)]
        order = [next(j for j, x in enumerate((lo, hi, dl)) if x is r)
                 for r in s.waiting]
        out.append((verdicts, order, s.preempts(dl, hi), s.preempts(hi, lo),
                    s.preempts(lo, hi), s.preempts(lo, lo)))
    assert out[1] == out[0]
    # higher priority first; within a priority, earlier deadline first;
    # strict: never self
    assert out[1][1:] == ([2, 1, 0], True, True, False, False)


def test_deadline_infeasible_shed_at_submit():
    js, ps, _ = _scheds(max_active=2)
    out = []
    for s, cls in ((js, JaxRequest), (ps, Request)):
        s.observe_step(0.1)                      # 100 ms a step
        s.observe_step(0.3)                      # EMA: 0.12
        shed = s.submit(_req(cls, new=50, deadline=0.5))
        ok = s.submit(_req(cls, new=2, deadline=60.0))
        est = s.estimate_completion_s(_req(cls, new=10))
        out.append((shed.as_dict(), ok.as_dict(), bool(shed), bool(ok),
                    est))
    assert out[1] == out[0]
    shed, ok = out[1][0], out[1][1]
    assert shed["reason"] == "deadline_infeasible"
    assert shed["deadline_headroom_s"] < 0 < ok["deadline_headroom_s"]


def test_expired_deadline_sheds_late():
    js, ps, now = _scheds(max_active=1)
    out = []
    for s, cls in ((js, JaxRequest), (ps, Request)):
        now[0] = 0.0
        a = _req(cls, new=8, priority=1)         # outranks b: admits first
        b = _req(cls, new=4, deadline=0.5)
        assert s.submit(a) and s.submit(b)
        first = [x is a for x in s.admit()]
        blocked = s.head_blocked() is b
        now[0] = 1.0                             # b's deadline passes
        s.retire(a)
        second = s.admit()                       # b sheds instead of running
        (req, verdict), = s.late_rejections
        out.append((first, blocked, second, req is b, verdict.as_dict(),
                    s.done))
    assert out[1] == out[0]
    assert out[1][:4] == ([True], True, [], True)
    assert out[1][4]["reason"] == "deadline_infeasible"
    assert out[1][4]["deadline_headroom_s"] < 0 and out[1][5]


def test_scheduler_preempt_and_resume_restore_reservation():
    js, ps, _ = _scheds(max_active=1)
    out = []
    for s, cls in ((js, JaxRequest), (ps, Request)):
        a = _req(cls, new=8)
        b = _req(cls, new=4, priority=1)
        s.submit(a)
        s.admit()
        s.submit(b)
        blocked = (s.admit(), s.head_blocked() is b, s.preempts(b, a))
        s.preempt(a)
        parked = (s.is_parked(a), s.n_active, [x is b for x in s.waiting])
        got = [x is b for x in s.admit()]
        s.retire(b)
        resumed = [x is a for x in s.admit()]
        out.append((blocked, parked, got, resumed, s.preemptions,
                    s.resumed, s.is_parked(a), s.n_active))
        s.retire(a)
    assert out[1] == out[0]
    assert out[1] == (([], True, True), (True, 0, [True, False]), [True],
                      [True], 1, 1, False, 1)


def test_lru_victim_policy_least_progress_most_recent():
    picks = []
    for policy, view in ((JaxLRU(), JaxView), (LRUVictimPolicy(),
                                               RequestView)):
        views = [view(tokens_done=5, admit_seq=1),
                 view(tokens_done=2, admit_seq=2),
                 view(tokens_done=2, admit_seq=7)]
        picks.append((policy.pick(view(), views), policy.pick(view(), [])))
    assert picks[0] == picks[1] == (2, None)     # least done, newest admit


# ---------------------------------------------------------------------------
# Overload: every request terminates, through both sessions and the
# port's async front end
# ---------------------------------------------------------------------------
STEP_S = 0.01           # the fake clock's seconds per session step


def _replay(side, params, spec, *, max_active=2, max_queue=8):
    """Replay a mix on a fake clock: requests arrive at their trace
    times, each step advances the clock by STEP_S and feeds STEP_S to the
    step-time EMA, cancels fire after `cancel_after` tokens. The front
    end's rules are kept (``max_queue`` backpressure)."""
    trace = (jax_make_trace if side.name == "jax" else make_trace)(
        spec, side.cfg.vocab_size)
    now = [0.0]
    metrics = side.Registry(clock=lambda: now[0])
    eng = _engine(side, params)
    cap = max(len(it.prompt) + it.max_new for it in trace)
    ses = side.Session(eng, capacity=cap, max_active=max_active,
                       metrics=metrics)
    ses.sched._clock = lambda: now[0]
    observe = ses.sched.observe_step
    ses.sched.observe_step = lambda dt: observe(STEP_S)
    reqs, got = [], {}
    i = 0
    while i < len(trace) or not ses.done:
        while i < len(trace) and trace[i].arrival_s <= now[0]:
            it = trace[i]
            r = side.Request(it.prompt.copy(), it.max_new,
                             speculate=it.speculate, deadline=it.deadline,
                             priority=it.priority)
            reqs.append((r, it))
            got[id(r)] = 0
            if ses.queue_depth >= max_queue:
                metrics.reject("queue_full")
            else:
                ses.submit(r)
            i += 1
        if ses.done:
            now[0] = trace[i].arrival_s
            continue
        for ev in ses.step():
            got[id(ev.request)] += len(ev.tokens)
        for r, it in reqs:
            if it.cancel_after is not None and got[id(r)] >= it.cancel_after:
                ses.cancel(r)
        now[0] += STEP_S
    out = _outcome(ses, eng, [r for r, _ in reqs if id(r) in ses._recs])
    out["summary"] = metrics.summary()
    ses.close()
    out["closed_live"] = eng.kv_pool.live_pages
    return out


@pytest.mark.parametrize("name", ["overload", "uniform"])
def test_trace_replay_matches_reference(params, name):
    """The overload mix (deadlines 0.05 / 2 / 30 s, priorities 0 / 1,
    arrivals outpacing two rows) and the uniform mix (cancellations) on
    the fake clock: every verdict, token, stat and swap byte equal."""
    spec = MIXES[name]
    got = both(params, lambda side, p: _replay(side, p, spec))
    s = got["summary"]
    assert s["n_done"] + s["n_cancelled"] + s["n_rejected"] \
        + s["n_errors"] == spec.n_requests
    assert got["closed_live"] == 0
    if name == "overload":
        assert s["slo_attainment"] is not None
        assert got["preemptions"] > 0 and got["pool"]["swap_out_bytes"] > 0
        assert s["reject_reasons"].get("deadline_infeasible", 0) > 0
    else:
        assert s["n_cancelled"] > 0


def test_overload_trace_every_request_terminates(params):
    """The reference test's run: the async front end, wall-clock
    arrivals and deadlines. Outcomes vary with timing, so the check is
    the accounting, as there."""
    from repro_torch.serve.traffic import run_trace
    eng = _engine(SIDES["port"], params)
    pool = eng.kv_pool
    spec = MIXES["overload"].override(n_requests=10)
    out = run_trace(eng, spec, max_active=2, max_queue=8)
    accounted = (out["n_done"] + out["n_cancelled"] + out["n_rejected"]
                 + out["n_errors"])
    assert accounted == out["n_trace"]           # nothing lost or stalled
    assert out["slo_attainment"] is not None     # deadlines were in play
    assert pool.live_pages == 0
    if out["preemptions"]:
        assert out["swap_out_bytes"] > 0
        assert out["n_resumed"] + out["n_errors"] + out["n_cancelled"] > 0


def test_mixes_are_the_reference_mixes():
    assert set(MIXES) == set(JAX_MIXES)
    for name, spec in MIXES.items():
        assert vars(spec) == vars(JAX_MIXES[name]), name
