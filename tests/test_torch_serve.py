"""The port's paged serving path against the JAX `ServeEngine` (fused
decode) on the starcoder2-7b smoke config with shared params and
4-token pages: greedy tokens are identical for static ``generate``,
continuous ``serve`` with dead (-1) rows, an all-int8 slow tier and
mid-run LRU demotion — the cases of ``tests/test_fused_decode.py`` — with
the reference's transfer accounting (2 host<->device transfers per
steady-state token), the reference's whole pool stats dict, an empty
pool after ``serve`` and intact pool invariants; deadlines, priorities
and preemption run as there, and what stays unported raises. On the CPU every paged attention call goes to the plain
version; `paged_attention.plain_calls` counts them."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.paged_attention.paged_attention import paged_attention
from repro_torch.serve.device_pool import DevicePagePool
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import PagedKVPool

ARCH = "starcoder2-7b"


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's state dict) — the same weights."""
    jparams = JaxEngine(jax_smoke(ARCH)).params
    return jparams, params_from_numpy(smoke_config(ARCH),
                                      jax.tree.map(np.asarray, jparams))


def _reqs(cls, n=2, plen=12, new=6, seed=0):
    rng = np.random.default_rng(seed)
    vocab = smoke_config(ARCH).vocab_size
    return [cls(rng.integers(0, vocab, plen).astype(np.int32), new)
            for _ in range(n)]


def _staggered(cls):
    rs = _reqs(cls, n=4, new=3)
    for i, r in enumerate(rs):
        r.max_new_tokens = 3 + i       # retire at different steps
    return rs


def _engines(params, page_tokens=4, policy=None, **pool_kw):
    jparams, state = params
    jax_pool = JaxPool(page_tokens=page_tokens,
                       placement_policy=policy() if policy else None,
                       **pool_kw)
    pool = PagedKVPool(page_tokens=page_tokens,
                       placement_policy=policy() if policy else None,
                       **pool_kw)
    return (JaxEngine(jax_smoke(ARCH), params=jparams, kv_pool=jax_pool,
                      decode_mode="fused"),
            ServeEngine(smoke_config(ARCH), params=state, kv_pool=pool,
                        device="cpu"))


def _check_pools(eng):
    eng.kv_pool.check_invariants()
    for dev in list(DevicePagePool._instances):
        dev.check_invariants()


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _assert_same_stats(pool, jax_pool):
    """The port's pool keeps the reference's whole stats dict (the host
    tier's and the swap stats included), and every value is equal."""
    assert pool.stats == jax_pool.stats


class AllSlow:
    def place(self, feats):
        return "slow"


def test_generate_matches_reference(params):
    jeng, eng = _engines(params)
    plain0, launches0 = paged_attention.plain_calls, paged_attention.launches
    _assert_same(jeng.generate(_reqs(JaxRequest)), eng.generate(_reqs(Request)))
    assert eng.last_transfers == jeng.last_transfers
    assert eng.last_request_stats == jeng.last_request_stats
    assert eng.stats["tokens"] == jeng.stats["tokens"]
    steps = eng.stats["decode_steps"]
    assert steps == jeng.stats["decode_steps"] == 5
    # every layer of every decode step attended through the wrapper, on
    # the plain version (CPU tensors): no kernel launch
    assert paged_attention.plain_calls - plain0 == steps * 2
    assert paged_attention.launches == launches0
    pool = eng.kv_pool
    assert pool.stats["fast_hits"] > 0
    assert {p.layer for p in pool.pages.values()} == {0, 1}
    _check_pools(eng)


def test_serve_with_dead_rows_matches_reference(params):
    jeng, eng = _engines(params)
    want = jeng.serve(_staggered(JaxRequest), max_active=2,
                      chunked_prefill=False, radix=False, preempt=False)
    got = eng.serve(_staggered(Request), max_active=2,
                    chunked_prefill=False, radix=False)
    _assert_same(want, got)
    assert eng.last_transfers == jeng.last_transfers
    assert eng.last_request_stats == jeng.last_request_stats
    assert eng.last_peak_active == jeng.last_peak_active == 2
    # retirement freed everything
    assert len(eng.kv_pool.pages) == 0 == len(jeng.kv_pool.pages)
    # steady state: one control upload + one token download per token
    assert eng.last_steady_transfers
    assert set(eng.last_steady_transfers) == {(1, 1)}
    _check_pools(eng)


def test_all_slow_tier_matches_reference(params):
    jeng, eng = _engines(params, policy=AllSlow)
    _assert_same(jeng.generate(_reqs(JaxRequest)), eng.generate(_reqs(Request)))
    pool = eng.kv_pool
    assert pool.stats["slow_hits"] > 0 and pool.stats["fast_hits"] == 0
    assert all(p.quantized for p in pool.pages.values())
    _assert_same_stats(pool, jeng.kv_pool)
    _check_pools(eng)


def test_lru_demotion_matches_reference(params):
    """A tiny fast tier forces mid-run LRU demotions (version bumps the
    device mirror rewrites as int8) — both sides see the same quantized
    content and agree."""
    jeng, eng = _engines(params, fast_capacity_pages=3)
    _assert_same(jeng.generate(_reqs(JaxRequest, new=8)),
                 eng.generate(_reqs(Request, new=8)))
    assert eng.kv_pool.stats["evictions"] > 0
    _assert_same_stats(eng.kv_pool, jeng.kv_pool)
    _check_pools(eng)


def test_pool_capacity_rejection_matches_reference(params):
    jeng, eng = _engines(params, capacity_pages=14)
    reqs = _reqs(Request, n=3)
    reqs[1] = Request(reqs[1].prompt[:4], 40)     # can never fit
    jreqs = [JaxRequest(r.prompt, r.max_new_tokens) for r in reqs]
    want = jeng.serve(jreqs, max_active=2, chunked_prefill=False,
                      radix=False, preempt=False)
    got = eng.serve(reqs, max_active=2, chunked_prefill=False, radix=False)
    assert got[1] is None and want[1] is None
    _assert_same([want[0], want[2]], [got[0], got[2]])
    assert eng.last_rejections[1].reason == "pool_capacity"
    assert eng.last_rejections[1].as_dict() == jeng.last_rejections[1].as_dict()
    assert len(eng.kv_pool.pages) == 0
    _check_pools(eng)


@pytest.mark.parametrize("num_layers", [2, 4])
def test_steady_state_two_transfers_per_token(num_layers):
    """Steady state (no page fills, mirror synced): one int32 control
    upload + one sampled-token download per token and no device-pool
    writes or readbacks, at every depth."""
    from repro_torch.serve.paged_decode import (PagedKVState,
                                                build_fused_step,
                                                extract_prefill_pages)
    cfg = dataclasses.replace(smoke_config(ARCH), num_layers=num_layers)
    eng = ServeEngine(cfg, kv_pool=PagedKVPool(page_tokens=16), device="cpu")
    prompt = _reqs(Request, n=1, plen=20)[0].prompt
    state = PagedKVState(eng.kv_pool, 32, eng.layout, cfg.num_kv_heads,
                         cfg.head_dim, device="cpu")
    logits, caches = eng.model.forward_prefill(torch.from_numpy(prompt[None]))
    extract_prefill_pages(eng.model, caches, state, [0])
    step = build_fused_step(eng.model, state.slots)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _, tok = state.run_fused(step, tok, [0], 20)    # syncs the prefill pages
    writes0 = state._device.writes
    h0, d0 = state.transfer_counts()
    for s in range(3):                 # tail rows 5..7 of 16: no fill
        _, tok = state.run_fused(step, tok, [0], 21 + s)
    h1, d1 = state.transfer_counts()
    assert state._device.writes == writes0
    assert (h1 - h0, d1 - d0) == (3, 3)
    _check_pools(eng)


def test_sampling_is_seeded(params):
    _, eng = _engines(params)
    a = eng.generate(_reqs(Request), greedy=False, temperature=1.5, seed=3)
    b = eng.generate(_reqs(Request), greedy=False, temperature=1.5, seed=3)
    c = eng.serve(_reqs(Request), greedy=False, temperature=1.5, seed=3)
    d = eng.serve(_reqs(Request), greedy=False, temperature=1.5, seed=3)
    _assert_same(a, b)
    _assert_same(c, d)
    for out in a + c:
        assert ((0 <= out) & (out < smoke_config(ARCH).vocab_size)).all()


def test_unported_options_raise(params):
    """The eager and numpy decode modes, once refused, construct and serve
    (their parity with JAX is `test_torch_decode_modes.py`'s). Without a
    page pool `generate` takes the dense-cache path (the reference's
    tokens), on one device and over a mesh's plan alike, while `serve()`
    needs the pool and raises `ValueError`, as the reference does."""
    from repro_torch.launch.mesh import make_serve_mesh
    jparams, state = params
    cfg = smoke_config(ARCH)
    pool = PagedKVPool(page_tokens=4)
    for kw in ({"decode_mode": "eager"}, {"decode_mode": "numpy"}):
        eng = ServeEngine(cfg, params=state, kv_pool=pool, device="cpu", **kw)
        assert eng.decode_mode == kw["decode_mode"]
        outs = eng.serve(_reqs(Request), max_active=2)
        assert [len(o) for o in outs] == [6, 6]
    want = JaxEngine(jax_smoke(ARCH), params=jparams) \
        .generate(_reqs(JaxRequest))
    on_mesh = ServeEngine(cfg, params=state, device="cpu",
                          mesh=make_serve_mesh(1, 2, devices=["cpu"] * 2))
    _assert_same(want, on_mesh.generate(_reqs(Request)))
    _assert_same(want, ServeEngine(cfg, params=state, device="cpu")
                 .generate(_reqs(Request)))
    for eng in (on_mesh, ServeEngine(cfg, params=state, device="cpu")):
        with pytest.raises(ValueError, match="kv_pool"):
            eng.serve(_reqs(Request))
    assert len(pool.pages) == 0


def test_preemption_deadlines_and_priorities_run(params):
    """Deadlines, priorities, ``preempt=True``, ``metrics=`` and
    ``preempt_policy=`` now run as in the reference: `generate` ignores
    deadlines and priorities (same tokens as JAX); `serve` admits its
    closed batch in urgency order; a `ServeSession` whose priority-1
    arrival finds the only row taken parks that row on the host tier and
    resumes it. Tokens, request stats, rejections, peak rows, metrics
    counts and the whole pool stats dict (swap bytes included) equal the
    JAX engine's. Deadlines are far (1e6 s), so the wall clock sheds
    nothing on either side."""
    from repro.serve.engine import ServeSession as JaxSession
    from repro.serve.metrics import MetricsRegistry as JaxRegistry
    from repro.serve.preemption import LRUVictimPolicy as JaxLRU
    from repro_torch.serve.engine import ServeSession
    from repro_torch.serve.metrics import MetricsRegistry
    from repro_torch.serve.preemption import LRUVictimPolicy

    def reqs(cls):
        rs = _staggered(cls)
        rs[0].deadline = 1e6
        rs[2].priority = 1
        rs[3].deadline, rs[3].priority = 1e6, 1
        return rs

    counts = ("n_done", "n_rejected", "tokens", "preemptions",
              "n_preempted", "slo_attainment")
    jeng, eng = _engines(params)
    _assert_same(jeng.generate(reqs(JaxRequest), free_pages=True),
                 eng.generate(reqs(Request), free_pages=True))
    jm, m = JaxRegistry(), MetricsRegistry()
    want = jeng.serve(reqs(JaxRequest), max_active=1, preempt=True,
                      metrics=jm, preempt_policy=JaxLRU())
    got = eng.serve(reqs(Request), max_active=1, preempt=True, metrics=m,
                    preempt_policy=LRUVictimPolicy())
    _assert_same(want, got)
    assert eng.last_request_stats == jeng.last_request_stats
    assert eng.last_rejections == jeng.last_rejections == [None] * 4
    assert eng.last_peak_active == jeng.last_peak_active == 1
    assert {k: m.summary()[k] for k in counts} == \
        {k: jm.summary()[k] for k in counts}

    def late_urgent(eng, Session, Registry, Policy, cls):
        metrics = Registry()
        ses = Session(eng, capacity=32, max_active=1, metrics=metrics,
                      radix=False, preempt_policy=Policy())
        a, b = reqs(cls)[1], reqs(cls)[3]
        a.max_new_tokens = 8
        ses.submit(a)
        for _ in range(5):             # 3 chunk steps, 2 decode steps
            ses.step()
        ses.submit(b)                  # priority 1 finds the row taken
        while not ses.done:
            ses.step()
        ses.close()
        return ([ses.result(r).tolist() for r in (a, b)],
                [ses.request_stats(r) for r in (a, b)],
                {k: metrics.summary()[k] for k in counts})

    jeng, eng = _engines(params)
    assert late_urgent(eng, ServeSession, MetricsRegistry, LRUVictimPolicy,
                       Request) == \
        late_urgent(jeng, JaxSession, JaxRegistry, JaxLRU, JaxRequest)
    assert eng.kv_pool.stats["swapped_out"] > 0
    _assert_same_stats(eng.kv_pool, jeng.kv_pool)
    assert len(eng.kv_pool.pages) == 0
    _check_pools(eng)


def test_session_streams_events_and_rejects_over_capacity(params):
    """A `ServeSession` driven step by step: each request's streamed
    tokens concatenate to its result, and a request longer than the
    session's page table is rejected with reason ``capacity``."""
    from repro_torch.serve.engine import ServeSession
    _, eng = _engines(params)
    session = ServeSession(eng, capacity=18, max_active=2,
                           chunked_prefill=False, radix=False)
    reqs = _staggered(Request)
    too_long = Request(reqs[0].prompt, 40)
    verdicts = [session.submit(r) for r in reqs + [too_long]]
    assert all(verdicts[:4]) and verdicts[4].reason == "capacity"
    streamed = {id(r): [] for r in reqs}
    while not session.done:
        for ev in session.step():
            streamed[id(ev.request)].extend(ev.tokens)
    for r in reqs:
        np.testing.assert_array_equal(session.result(r), streamed[id(r)])
    assert session.result(too_long) is None
    assert session.request_stats(too_long)["rejected"] == "capacity"
    assert len(eng.kv_pool.pages) == 0
    _check_pools(eng)
