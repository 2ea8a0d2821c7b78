"""The port's default serve path — chunked prefill riding the widened
fused steps plus the radix prefix cache — against the JAX engine's
default `serve()` on the starcoder2-7b smoke config with shared params and
4-token pages: greedy tokens, per-request stats, transfer counts, prefix
hit rate and pool stats. Plus the port counterparts of
``tests/test_prefix_cache.py``: chunked + radix == monolithic (plain and
k = 4), adoption across retired requests, admission credit for cached
pages, cancellation mid-prefill, LRU eviction of pins, and the radix
tree over a bare pool."""
import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.engine import ServeSession as JaxSession
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.paged_attention.paged_attention import paged_attention
from repro_torch.serve.engine import Request, ServeEngine, ServeSession
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.prefix_cache import RadixPrefixCache
from repro_torch.serve.scheduler import prefix_page_hashes

ARCH = "starcoder2-7b"
T = 4          # page tokens: small so short prompts span several pages


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's state dict) — the same weights."""
    jparams = JaxEngine(jax_smoke(ARCH)).params
    return jparams, params_from_numpy(smoke_config(ARCH),
                                      jax.tree.map(np.asarray, jparams))


def _port(params, capacity_pages=None, **kw):
    pool = PagedKVPool(page_tokens=T, capacity_pages=capacity_pages)
    return ServeEngine(smoke_config(ARCH), params=params[1], kv_pool=pool,
                       device="cpu", **kw), pool


def _jax(params, capacity_pages=None, **kw):
    pool = JaxPool(page_tokens=T, capacity_pages=capacity_pages)
    return JaxEngine(jax_smoke(ARCH), params=params[0], kv_pool=pool,
                     decode_mode="fused", **kw), pool


def _drive(session):
    while not session.done:
        session.step()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _shared_head(n_head, suffixes, seed):
    rng = np.random.default_rng(seed)
    vocab = smoke_config(ARCH).vocab_size
    head = rng.integers(0, vocab, n_head).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, n).astype(np.int32)])
            for n in suffixes]


# ---------------------------------------------------------------------------
# The default serve() against the JAX default serve()
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("speculate,budget", [(0, 1), (0, 2), (4, 1)],
                         ids=["plain", "budget2", "spec4"])
def test_default_serve_matches_jax_default(params, speculate, budget):
    """Prompts sharing a two-page head, admitted two at a time: later
    requests adopt the cached head, every suffix streams in page-sized
    chunk rows. Both engines are called with the same arguments and no
    path options, so each takes its own default path."""
    prompts = _shared_head(2 * T, (5, 9, 2, 13), seed=0)
    news = [5, 4, 6, 3]
    eng, pool = _port(params, speculate=speculate)
    jeng, jpool = _jax(params, speculate=speculate)
    plain0 = paged_attention.plain_calls
    got = eng.serve([Request(p.copy(), n) for p, n in zip(prompts, news)],
                    max_active=2, prefill_budget=budget)
    want = jeng.serve([JaxRequest(p.copy(), n) for p, n in
                       zip(prompts, news)], max_active=2,
                      prefill_budget=budget)
    _same(want, got)
    assert eng.last_request_stats == jeng.last_request_stats
    assert eng.last_transfers == jeng.last_transfers
    assert eng.last_prefix_hit_rate == jeng.last_prefix_hit_rate > 0
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert pool.stats == {k: jpool.stats[k] for k in pool.stats}
    assert pool.stats["adopted_pages"] > 0
    # every step, chunk-fill steps included, attends through the wrapper
    # once per layer; prefill attention never runs (no monolithic pass)
    assert paged_attention.plain_calls - plain0 == \
        eng.stats["decode_steps"] * smoke_config(ARCH).num_layers
    assert pool.live_pages == 0


# ---------------------------------------------------------------------------
# Greedy equivalence: chunked + radix == monolithic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("speculate", [0, 4], ids=["plain", "spec4"])
def test_chunked_radix_matches_monolithic(params, speculate):
    """Mixed prompt lengths (page-aligned and not, shorter and longer than
    a page) under staggered admission: the default session gives the
    monolithic-prefill tokens, plain and with the k = 4 verify step."""
    rng = np.random.default_rng(1)
    vocab = smoke_config(ARCH).vocab_size
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (13, 24, 3, 17)]
    news = [5, 4, 6, 3]

    def reqs():
        return [Request(p.copy(), n) for p, n in zip(prompts, news)]

    eng, _ = _port(params, speculate=speculate)
    expected = eng.serve(reqs(), max_active=2, chunked_prefill=False,
                         radix=False)
    eng2, pool2 = _port(params, speculate=speculate)
    _same(expected, eng2.serve(reqs(), max_active=2))
    assert pool2.live_pages == 0        # serve() closed the radix pins


# ---------------------------------------------------------------------------
# Adoption across retired requests
# ---------------------------------------------------------------------------
def test_adoption_across_retired_requests(params):
    """A retired request's prompt pages stay pinned in the tree; a later
    request with the same head adopts them (no re-prefill) and gives the
    JAX session's tokens; hit-rate accounting matches."""
    cfg = smoke_config(ARCH)
    p1, p2 = _shared_head(2 * T, (5, 7), seed=2)
    eng, pool = _port(params)
    jeng, _ = _jax(params)
    session = ServeSession(eng, capacity=32, max_active=1)
    jsession = JaxSession(jeng, capacity=32, max_active=1)
    r1, r2 = Request(p1.copy(), 4), Request(p2.copy(), 5)
    j1, j2 = JaxRequest(p1.copy(), 4), JaxRequest(p2.copy(), 5)
    assert session.submit(r1) and jsession.submit(j1)
    _drive(session)
    _drive(jsession)
    # r1 retired, but its full prompt pages survive as tree pins
    assert pool.live_pages == cfg.num_layers * (len(p1) // T)
    assert session.pages_adopted_total == 0

    assert session.submit(r2) and jsession.submit(j2)
    _drive(session)
    _drive(jsession)
    np.testing.assert_array_equal(session.result(r1), jsession.result(j1))
    np.testing.assert_array_equal(session.result(r2), jsession.result(j2))
    # r2 adopted exactly the shared head (2 pages per layer)
    assert pool.stats["adopted_pages"] == cfg.num_layers * 2
    assert session.pages_adopted_total == 2
    assert session.prefix_hit_rate == jsession.prefix_hit_rate == \
        pytest.approx(2 / ((len(p1) - 1) // T + (len(p2) - 1) // T))
    session.check_invariants()
    session.close()
    assert pool.live_pages == 0


# ---------------------------------------------------------------------------
# Admission credits radix-cached pages
# ---------------------------------------------------------------------------
def test_admission_credits_cached_prefix(params):
    """A request whose worst case exceeds the raw budget admits when the
    radix tree already pins its prompt prefix (the pages are resident
    either way); without the tree it is rejected at submit."""
    L = smoke_config(ARCH).num_layers
    prompt = np.random.default_rng(3).integers(
        0, smoke_config(ARCH).vocab_size, 4 * T).astype(np.int32)

    # control: without the radix index the big request can never fit
    # (ceil((16 + 8) / 4) + 1 = 7 pages per layer > 6); both engines give
    # the same verdict
    eng0, _ = _port(params, capacity_pages=6 * L)
    jeng0, _ = _jax(params, capacity_pages=6 * L)
    v0 = ServeSession(eng0, capacity=24, max_active=2, radix=False).submit(
        Request(prompt.copy(), 8))
    jv0 = JaxSession(jeng0, capacity=24, max_active=2, radix=False).submit(
        JaxRequest(prompt.copy(), 8))
    assert not v0.admitted and v0.reason == "pool_capacity"
    assert v0.as_dict() == jv0.as_dict()

    eng, pool = _port(params, capacity_pages=6 * L)
    session = ServeSession(eng, capacity=24, max_active=2)
    assert session.submit(Request(prompt.copy(), 4))   # 6 pages per layer
    _drive(session)
    big = Request(prompt.copy(), 8)                    # 7 pages per layer
    assert session.submit(big).admitted                # 3 pages credited
    _drive(session)
    assert len(session.result(big)) == 8
    session.close()
    assert pool.live_pages == 0


def test_late_rejection_when_credit_is_evicted(params):
    """A request admitted at submit on the strength of its cached prefix
    is rejected late, with an error event, when an earlier request's
    admission evicted those pins and nothing active can free room — the
    same verdict, stats and events as the JAX session."""
    L = smoke_config(ARCH).num_layers
    rng = np.random.default_rng(7)
    vocab = smoke_config(ARCH).vocab_size
    p = rng.integers(0, vocab, 4 * T).astype(np.int32)
    q = rng.integers(0, vocab, 3 * T).astype(np.int32)
    runs = []
    for lib in ("port", "jax"):
        mk, req, sess = (_port, Request, ServeSession) if lib == "port" \
            else (_jax, JaxRequest, JaxSession)
        eng, _ = mk(params, capacity_pages=6 * L)
        s = sess(eng, capacity=24, max_active=2)
        assert s.submit(req(p.copy(), 4))      # 6 pages per layer; pins 4
        _drive(s)
        other = req(q.copy(), 8)               # 6 pages: evicts every pin
        big = req(p.copy(), 8)                 # 7 pages, 3 credited now
        assert s.submit(other) and s.submit(big)
        events = []
        while not s.done:
            events += s.step()
        errors = [(e.request is big, e.done, e.error) for e in events
                  if e.error is not None]
        runs.append((s.result(big), s.request_stats(big), errors,
                     s.result(other)))
    (got, gstats, gerr, gother), (want, wstats, werr, wother) = runs
    assert got is None and want is None
    assert gstats == wstats and gstats["rejected"] == "pool_capacity"
    assert gerr == werr == [(True, True, "pool_capacity")]
    np.testing.assert_array_equal(gother, wother)


# ---------------------------------------------------------------------------
# Cancellation mid-prefill
# ---------------------------------------------------------------------------
def test_cancel_mid_prefill_frees_exactly_the_suffix_pages(params):
    """Cancelling a request mid-chunked-prefill frees exactly the suffix
    pages it wrote; the radix-pinned prefix it adopted drops back to the
    tree's single reference and stays live for the next request."""
    cfg = smoke_config(ARCH)
    p_seed, p_long = _shared_head(2 * T, (5, 7 * T), seed=4)
    eng, pool = _port(params)
    session = ServeSession(eng, capacity=48, max_active=1)
    session.submit(Request(p_seed.copy(), 3))
    _drive(session)                       # the tree now pins p_seed's pages
    live_before = set(pool.pages)
    assert live_before and all(pool.pages[pid].refs == 1
                               for pid in live_before)

    long_req = Request(p_long.copy(), 4)
    session.submit(long_req)
    session.step()                        # admit + first suffix chunk
    session.step()                        # second chunk
    act = session._recs[id(long_req)].active
    assert act.prefilling                 # genuinely mid-prefill
    assert act.prefilled > 2 * T          # adopted head + written chunks
    assert pool.live_pages > len(live_before)
    adopted = [pid for pid in live_before if pool.pages[pid].refs == 2]
    assert len(adopted) == cfg.num_layers * 2    # head pages: tree + seq
    session.check_invariants()

    assert session.cancel(long_req)
    assert not session.cancel(long_req)   # already cancelled
    # exactly the cancelled suffix pages died; every pinned page survives
    # with the tree as its sole holder again
    assert set(pool.pages) == live_before
    assert all(pool.pages[pid].refs == 1 for pid in live_before)
    assert len(session.result(long_req)) == 0    # no token was produced
    assert session.request_stats(long_req)["cancelled"]
    session.check_invariants()
    session.close()
    assert pool.live_pages == 0


# ---------------------------------------------------------------------------
# Eviction under pool pressure
# ---------------------------------------------------------------------------
def test_pins_evict_lru_under_pool_pressure(params):
    """Distinct prompts grow the tree until the page budget forces LRU
    eviction of the oldest exclusive pins: admission keeps working, every
    request completes with the JAX session's tokens, and pins + live work
    never exceed the pool's capacity."""
    L = smoke_config(ARCH).num_layers
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, smoke_config(ARCH).vocab_size, 3 * T)
               .astype(np.int32) for _ in range(4)]
    eng, pool = _port(params, capacity_pages=8 * L)
    jeng, _ = _jax(params, capacity_pages=8 * L)
    session = ServeSession(eng, capacity=20, max_active=1)
    jsession = JaxSession(jeng, capacity=20, max_active=1)
    reqs = [Request(p.copy(), 4) for p in prompts]
    jreqs = [JaxRequest(p.copy(), 4) for p in prompts]
    for r, j in zip(reqs, jreqs):
        assert session.submit(r) and jsession.submit(j)
    _drive(session)
    _drive(jsession)
    for r, j in zip(reqs, jreqs):
        np.testing.assert_array_equal(session.result(r), jsession.result(j))
    assert session.prefix_index.stats["evicted"] == \
        jsession.prefix_index.stats["evicted"] > 0
    assert session.peak_live_pages <= 8 * L
    session.close()
    assert pool.live_pages == 0


# ---------------------------------------------------------------------------
# Tree unit behaviour over a bare pool
# ---------------------------------------------------------------------------
def test_radix_tree_pin_match_protect_clear():
    pool = PagedKVPool(page_tokens=2)
    toks = np.arange(6, dtype=np.int32)
    hashes = prefix_page_hashes(toks, 2)
    rng = np.random.default_rng(6)
    for h in hashes:
        k = rng.standard_normal((2, 1, 4)).astype(np.float32)
        pool.put(0, k, k, layer=0, content_hash=h)
    released = []
    tree = RadixPrefixCache(pool, num_layers=1, on_release=released.append)
    assert tree.insert(hashes) == 3
    assert tree.insert(hashes) == 0          # idempotent: path re-touched
    pool.free(0)                             # owner retires; pins hold
    assert pool.live_pages == 3 and tree.pinned_pages() == 3
    pool.check_invariants(pins=tree.pin_counts())

    m = tree.match(hashes, limit=2)
    assert m.pages == 2 and m.hashes == hashes[:2]
    assert tree.match([hashes[1]]).pages == 0    # cumulative: no mid-entry

    # the protected head survives; leaf-first eviction frees the rest
    assert tree.reclaimable_pages(protect=frozenset(hashes[:1])) == 2
    freed = tree.make_room(3, protect=frozenset(hashes[:1]))
    assert freed == 2 and pool.live_pages == 1 and len(released) == 2
    assert tree.match(hashes).pages == 1

    tree.clear()
    assert pool.live_pages == 0 and tree.nodes() == 0 and len(released) == 3
