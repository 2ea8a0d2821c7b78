"""The port's speculative k-row verify against its own 1-token path and
the JAX engine, on the starcoder2-7b smoke config with shared params and
4-token pages — the cases of ``tests/test_speculative.py``: greedy k = 4
gives the k = 1 tokens and the JAX k = 4 tokens for static and continuous
batches (dead rows included), an all-int8 slow tier, mid-run LRU demotion
and an eos inside an accepted run; one batch mixes per-request k; the
transfer counts and per-request stats equal JAX's; rollback never stores
a phantom token. Plus the draft proposers and the wide paged-attention
case (k = 32 rows at g = 9) against the JAX oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.kernels.paged_attention import ref as jref
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import api, registry
from repro_torch.kernels.paged_attention.paged_attention import paged_attention
from repro_torch.serve.device_pool import DevicePagePool
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.speculative import ModelDraft, NGramDraft, make_draft

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


def _port(params, speculate=0, draft="ngram", policy=None, **pool_kw):
    pool = PagedKVPool(page_tokens=pool_kw.pop("page_tokens", 4),
                       placement_policy=policy() if policy else None,
                       **pool_kw)
    return ServeEngine(smoke_config(ARCH), params=params[1], kv_pool=pool,
                       device="cpu", speculate=speculate, draft=draft)


def _jax(params, speculate=0, draft="ngram", policy=None, **pool_kw):
    pool = JaxPool(page_tokens=pool_kw.pop("page_tokens", 4),
                   placement_policy=policy() if policy else None, **pool_kw)
    return JaxEngine(jax_smoke(ARCH), params=params[0], kv_pool=pool,
                     decode_mode="fused", speculate=speculate, draft=draft)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _check_pools(eng):
    eng.kv_pool.check_invariants()
    for dev in list(DevicePagePool._instances):
        dev.check_invariants()


class AllSlow:
    def place(self, feats):
        return "slow"


@pytest.mark.parametrize("pool_kw", [{}, {"policy": AllSlow},
                                     {"fast_capacity_pages": 3}],
                         ids=["fast", "all_int8", "lru_demotion"])
def test_spec_static_matches_k1_and_reference(params, pool_kw):
    """Static generate: k = 4 == k = 1 == JAX k = 4, with equal transfer
    counts, request stats and pool stats on both sides."""
    new = 10 if "fast_capacity_pages" in pool_kw else 8
    base = _port(params, **pool_kw)
    spec = _port(params, speculate=4, **pool_kw)
    jspec = _jax(params, speculate=4, **pool_kw)
    want = base.generate(_reqs(Request, new=new))
    plain0 = paged_attention.plain_calls
    got = spec.generate(_reqs(Request, new=new))
    _same(want, got)
    _same(jspec.generate(_reqs(JaxRequest, new=new)), got)
    assert spec.last_transfers == jspec.last_transfers
    assert spec.last_request_stats == jspec.last_request_stats
    assert spec.stats["decode_steps"] == jspec.stats["decode_steps"]
    # one k-row attention call per layer per verify step
    assert paged_attention.plain_calls - plain0 == \
        spec.stats["decode_steps"] * 2
    assert any(d["tokens_per_step"] > 1.0 for d in spec.last_request_stats)
    stats = spec.kv_pool.stats
    assert stats == {k: jspec.kv_pool.stats[k] for k in stats}
    if "policy" in pool_kw:
        assert stats["slow_hits"] > 0 and stats["fast_hits"] == 0
    if "fast_capacity_pages" in pool_kw:
        assert stats["evictions"] > 0
    _check_pools(spec)


def test_spec_continuous_dead_rows_matches_k1_and_reference(params):
    """Staggered lengths through max_active=2 (monolithic prefill): rows
    retire at different steps, so verify batches carry dead rows."""
    kw = dict(max_active=2, chunked_prefill=False, radix=False)
    want = _port(params).serve(_staggered(Request), **kw)
    spec = _port(params, speculate=3)
    got = spec.serve(_staggered(Request), **kw)
    jspec = _jax(params, speculate=3)
    _same(want, got)
    _same(jspec.serve(_staggered(JaxRequest), preempt=False, **kw), got)
    assert spec.last_transfers == jspec.last_transfers
    assert spec.last_request_stats == jspec.last_request_stats
    assert len(spec.kv_pool.pages) == 0
    _check_pools(spec)


def test_spec_with_eos_mid_run(params):
    """An eos sampled inside an accepted run truncates the output at eos
    (inclusive), as the 1-token path and the JAX engine do."""
    base = _port(params)
    for seed in range(6):
        [out] = base.generate(_reqs(Request, n=1, new=8, seed=seed))
        if len(set(out.tolist())) < len(out):     # a repeated token exists
            eos = int(out[-1])
            break
    else:
        raise AssertionError("no greedy repetition under these seeds")

    def req(cls):
        [r] = _reqs(cls, n=1, new=8, seed=seed)
        r.eos_token = eos
        return r

    [want] = base.generate([req(Request)])
    [got] = _port(params, speculate=4, draft="self").generate([req(Request)])
    [ref] = _jax(params, speculate=4, draft="self").generate([req(JaxRequest)])
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(ref, got)
    assert got[-1] == eos


def test_mixed_spec_and_plain_requests_one_batch(params):
    """One continuous batch mixes per-request k; plain rows ride the
    verify step with padding drafts that never count as accepted."""
    def rs(cls):
        out = _reqs(cls, n=3, new=6)
        out[0].speculate = 1
        out[2].speculate = 2
        return out

    kw = dict(max_active=3, chunked_prefill=False, radix=False)
    want = _port(params).serve(rs(Request), **kw)
    spec = _port(params, speculate=4)
    got = spec.serve(rs(Request), **kw)
    jspec = _jax(params, speculate=4)
    _same(want, got)
    _same(jspec.serve(rs(JaxRequest), preempt=False, **kw), got)
    assert spec.last_request_stats == jspec.last_request_stats
    d0, d1, d2 = spec.last_request_stats
    assert d0["proposed"] == 0 and d0["accept_rate"] is None
    assert d1["proposed"] >= d2["proposed"] > 0


def test_rollback_never_puts_phantom_tokens(params):
    """Pool pages cover exactly the accepted tokens: each sequence holds
    floor((plen + emitted - 1) / t) pages per layer, however many rows the
    verify steps scattered and rolled back; the stats stay consistent."""
    t = 4
    eng = _port(params, speculate=4, page_tokens=t)
    reqs = _reqs(Request, n=2, plen=11, new=9)
    outs = eng.generate(reqs)
    for i, (r, o) in enumerate(zip(reqs, outs)):
        assert len(eng.kv_pool.seq_pages(i, 0)) == \
            (len(r.prompt) + len(o) - 1) // t
    assert eng.stats["tokens"] == sum(len(o) for o in outs)
    for d, o in zip(eng.last_request_stats, outs):
        assert d["tokens"] == len(o)
        assert d["proposed"] >= d["accepted"] >= 0
        assert d["steps"] <= len(o) - 1 <= d["steps"] + d["accepted"]
    _check_pools(eng)


def test_spec_guardrails_and_scheduler_budget(params):
    with pytest.raises(ValueError, match="page pool"):
        ServeEngine(smoke_config(ARCH), params=params[1], device="cpu",
                    speculate=4).generate(_reqs(Request))
    with pytest.raises(ValueError, match="page_tokens"):
        _port(params, speculate=8).generate(_reqs(Request))
    rs = _reqs(Request)
    rs[0].speculate = 8
    with pytest.raises(ValueError, match="page_tokens"):
        _port(params).generate(rs)
    # a speculative request is budgeted one spill page per layer more
    eng = _port(params)
    plain = Request(np.zeros(8, np.int32), 4)
    spec = Request(np.zeros(8, np.int32), 4, speculate=4)
    s = Scheduler(eng.kv_pool, eng.layout)
    assert s.pages_needed(spec) == s.pages_needed(plain) + 2
    s2 = Scheduler(eng.kv_pool, eng.layout, default_speculate=4)
    assert s2.pages_needed(plain) == s.pages_needed(spec)


def test_ngram_draft_prompt_lookup():
    d = NGramDraft(n=3)
    h = np.array([5, 1, 2, 3, 9, 7, 1, 2, 3], np.int32)
    np.testing.assert_array_equal(d.propose(h, 2), [9, 7])
    np.testing.assert_array_equal(d.propose(h, 4), [9, 7, 1, 2])
    h2 = np.array([7, 1, 2, 3, 1, 2, 3], np.int32)
    np.testing.assert_array_equal(d.propose(h2, 4), [1, 2, 3, 3])
    np.testing.assert_array_equal(
        NGramDraft(n=3).propose(np.array([1, 2, 3], np.int32), 2), [3, 3])
    assert d.propose(h, 0).shape == (0,)
    # the most recent occurrence wins
    h3 = np.array([1, 2, 7, 1, 2, 8, 1, 2], np.int32)
    np.testing.assert_array_equal(NGramDraft(n=2).propose(h3, 1), [8])
    assert isinstance(make_draft("ngram:2"), NGramDraft)
    assert make_draft("ngram:2").n == 2
    with pytest.raises(ValueError, match="unknown draft"):
        make_draft("nope")


def test_model_draft_is_greedy_continuation(params):
    eng = _port(params)
    d = make_draft("self", eng.model)
    assert isinstance(d, ModelDraft)
    hist = np.random.default_rng(0).integers(
        0, smoke_config(ARCH).vocab_size, 9).astype(np.int32)
    out = d.propose(hist, 3)
    assert out.shape == (3,)
    np.testing.assert_array_equal(d.propose(hist, 2), out[:2])
    # the first draft token is the prefill's greedy answer
    logits, _ = eng.model.forward_prefill(torch.from_numpy(hist[None]))
    assert out[0] == int(torch.argmax(logits[0]))


def test_wide_paged_attention_case_matches_jax_oracle():
    """The port's wide paged-attention case (k = 32 query rows at g = 9,
    288 rows per kv head): the plain version against the JAX oracle, flat
    and layer-stacked."""
    spec = registry.get("paged_attention")
    case = spec.cases[-1]
    assert case.shape["k"] == 32 and case.shape["hq"] // case.shape["hkv"] == 9
    inp = spec.example_inputs(shape=dict(case.shape))
    targs = [torch.from_numpy(inp[n]) for n in spec.arg_names]
    jargs = [jnp.asarray(inp[n]) for n in spec.arg_names]
    got = api.run("paged_attention", *targs).numpy()
    want = np.asarray(jref.paged_attention(*jargs))
    np.testing.assert_allclose(got, want, atol=spec.tol["float32"], rtol=0)
    stacked = [torch.stack([a, a]) for a in targs[1:7]]
    got_l1 = api.run("paged_attention", targs[0], *stacked, *targs[7:],
                     1).numpy()
    np.testing.assert_array_equal(got_l1, got)
