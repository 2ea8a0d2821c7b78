"""The eager and numpy decode modes of the port's `ServeEngine` against the
JAX engine in the same mode, on the starcoder2-7b smoke config with
shared params and 4-token pages — the cases of the reference's
``tests/test_fused_decode.py`` (static ``generate``, continuous
``serve()`` with dead rows, an all-int8 slow tier, mid-run LRU demotion)
and ``tests/test_paged_serve.py``'s step wrapper: greedy tokens equal
JAX's in the mode and the port's fused tokens; transfer counts and the
whole pool stats dict equal JAX's; the refusals are JAX's, at the same
calls. On the CPU every paged-attention call runs the plain version.
The knee cache persists through ``ServeEngine(knee_cache=)`` in a file
of the port's own, beside which the JAX engine's stays loadable."""
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.kernels import api as jax_api
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.engine import ServeSession as JaxSession
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import api
from repro_torch.kernels.paged_attention.paged_attention import paged_attention
from repro_torch.serve.engine import Request, ServeEngine, ServeSession
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.paged_decode import (PagedKVState,
                                            extract_prefill_pages)
from repro_torch.serve.steps import make_paged_decode_step

ARCH = "starcoder2-7b"
MODES = ["eager", "numpy"]


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


class AllSlow:
    def place(self, feats):
        return "slow"


def _pair(params, mode, policy=None, **pool_kw):
    """(JAX engine, the port's engine) in `mode` over equal fresh pools."""
    jparams, state = params
    kw = dict(page_tokens=4, **pool_kw)
    return (JaxEngine(jax_smoke(ARCH), params=jparams, decode_mode=mode,
                      kv_pool=JaxPool(placement_policy=policy and policy(),
                                      **kw)),
            ServeEngine(smoke_config(ARCH), params=state, device="cpu",
                        decode_mode=mode,
                        kv_pool=PagedKVPool(placement_policy=policy
                                            and policy(), **kw)))


def _fused(params, **pool_kw):
    return ServeEngine(smoke_config(ARCH), params=params[1], device="cpu",
                       kv_pool=PagedKVPool(page_tokens=4, **pool_kw))


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _assert_engines_agree(jeng, eng):
    assert eng.last_transfers == jeng.last_transfers
    assert eng.kv_pool.stats == jeng.kv_pool.stats
    assert eng.stats["tokens"] == jeng.stats["tokens"]
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]
    eng.kv_pool.check_invariants()


# ---------------------------------------------------------------------------
# Tokens, transfers and pool stats against JAX in the same mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_static_generate_matches_reference(params, mode):
    jeng, eng = _pair(params, mode)
    plain0, launches0 = paged_attention.plain_calls, paged_attention.launches
    want = jeng.generate(_reqs(JaxRequest))
    got = eng.generate(_reqs(Request))
    _assert_same(want, got)
    _assert_same(got, _fused(params).generate(_reqs(Request)))
    _assert_engines_agree(jeng, eng)
    assert eng.last_request_stats == jeng.last_request_stats
    # one launch a layer a step, each on the plain version (CPU tensors)
    steps = eng.stats["decode_steps"]
    assert paged_attention.plain_calls - plain0 >= steps * 2
    assert paged_attention.launches == launches0
    # the per-layer path pays transfers per layer: more than fused's
    fused = _fused(params)
    fused.generate(_reqs(Request))
    assert sum(eng.last_transfers) > sum(fused.last_transfers)
    assert (eng.kv_pool.stats["fast_hits"] > 0
            and {p.layer for p in eng.kv_pool.pages.values()} == {0, 1})


@pytest.mark.parametrize("mode", MODES)
def test_continuous_serve_with_dead_rows_matches_reference(params, mode):
    """Staggered lengths through max_active=2 rows: dead (-1) rows decode
    beside live ones. The session prefills each prompt in one pass (the
    non-fused default) with the radix cache's pins on, as JAX's does."""
    jeng, eng = _pair(params, mode)
    want = jeng.serve(_staggered(JaxRequest), max_active=2, preempt=False)
    got = eng.serve(_staggered(Request), max_active=2)
    _assert_same(want, got)
    _assert_same(got, _fused(params).serve(_staggered(Request), max_active=2,
                                           chunked_prefill=False))
    _assert_engines_agree(jeng, eng)
    assert eng.last_request_stats == jeng.last_request_stats
    assert eng.last_peak_active == jeng.last_peak_active == 2
    assert len(eng.kv_pool.pages) == 0 == len(jeng.kv_pool.pages)
    assert eng.last_steady_transfers == []      # no fused steady state


@pytest.mark.parametrize("mode", MODES)
def test_all_slow_tier_matches_reference(params, mode):
    jeng, eng = _pair(params, mode, policy=AllSlow)
    want = jeng.generate(_reqs(JaxRequest))
    got = eng.generate(_reqs(Request))
    _assert_same(want, got)
    _assert_same(got, _fused(params, placement_policy=AllSlow())
                 .generate(_reqs(Request)))
    pool = eng.kv_pool
    assert pool.stats["slow_hits"] > 0 and pool.stats["fast_hits"] == 0
    assert all(p.quantized for p in pool.pages.values())
    _assert_engines_agree(jeng, eng)


@pytest.mark.parametrize("mode", MODES)
def test_lru_demotion_matches_reference(params, mode):
    """A 3-page fast tier demotes pages mid-run; the eager mode's device
    mirror rewrites them as int8 and the numpy mode reads them from the
    pool, both equal to JAX and to the fused step."""
    jeng, eng = _pair(params, mode, fast_capacity_pages=3)
    want = jeng.generate(_reqs(JaxRequest, new=8))
    got = eng.generate(_reqs(Request, new=8))
    _assert_same(want, got)
    _assert_same(got, _fused(params, fast_capacity_pages=3)
                 .generate(_reqs(Request, new=8)))
    assert eng.kv_pool.stats["evictions"] > 0
    _assert_engines_agree(jeng, eng)


@pytest.mark.parametrize("mode", MODES)
def test_session_preempt_resume_matches_reference(params, mode):
    """A `ServeSession` parks a row mid-decode and resumes it: a numpy
    tail is already on the host (nothing read back), an eager one comes
    back from the device pool. Tokens, transfers and the pool stats
    (swap bytes included) equal JAX's."""
    jeng, eng = _pair(params, mode)
    outs = {}
    for name, e, ses_cls, req_cls in (("jax", jeng, JaxSession, JaxRequest),
                                      ("port", eng, ServeSession, Request)):
        ses = ses_cls(e, capacity=40, max_active=2, radix=False)
        reqs = [req_cls(r.prompt, 10) for r in _reqs(req_cls, plen=10,
                                                     seed=3)]
        for r in reqs:
            ses.submit(r)
        for _ in range(4):
            ses.step()
        assert ses.preempt(reqs[0])
        while not ses.done:         # the admission rounds resume it
            ses.step()
        outs[name] = ([ses.result(r) for r in reqs], ses.transfer_counts(),
                      dict(e.kv_pool.stats), ses.preemptions, ses.resumes)
        ses.close()
    _assert_same(outs["jax"][0], outs["port"][0])
    assert outs["jax"][1:] == outs["port"][1:]
    assert outs["port"][2]["swapped_out"] > 0
    assert outs["port"][3:] == (1, 1)
    assert eng.kv_pool.live_pages == 0


def test_device_gather_false_is_the_numpy_mode(params):
    jparams, state = params
    eng = ServeEngine(smoke_config(ARCH), params=state, device="cpu",
                      kv_pool=PagedKVPool(page_tokens=4),
                      device_gather=False)
    jeng = JaxEngine(jax_smoke(ARCH), params=jparams,
                     kv_pool=JaxPool(page_tokens=4), device_gather=False)
    assert eng.decode_mode == jeng.decode_mode == "numpy"
    _assert_same(jeng.generate(_reqs(JaxRequest, n=1)),
                 eng.generate(_reqs(Request, n=1)))
    assert eng.last_transfers == jeng.last_transfers


def test_make_paged_decode_step_matches_engine_tokens(params):
    """The step wrapper drives the eager path: one step from the
    prefill's first token gives the engine's second greedy token."""
    _, state = params
    cfg = smoke_config(ARCH)
    eng = ServeEngine(cfg, params=state, device="cpu",
                      kv_pool=PagedKVPool(page_tokens=4))
    [expected] = eng.generate(_reqs(Request, n=1, new=2))
    pool = PagedKVPool(page_tokens=4)
    st = PagedKVState(pool, 12 + 2, eng.layout, cfg.num_kv_heads,
                      cfg.head_dim, mode="eager", device="cpu")
    [req] = _reqs(Request, n=1)
    logits, caches = eng.model.forward_prefill(
        torch.from_numpy(req.prompt[None]))
    extract_prefill_pages(eng.model, caches, st, [0])
    first = int(torch.argmax(logits, dim=-1)[0])
    step = make_paged_decode_step(eng.model, st)
    next_tok, step_logits = step(np.array([first], np.int32), [0],
                                 len(req.prompt))
    assert [first, int(next_tok[0])] == expected.tolist()
    assert tuple(step_logits.shape) == (1, cfg.vocab_size)


# ---------------------------------------------------------------------------
# Refusals: the same exception at the same call as the JAX engine
# ---------------------------------------------------------------------------
def _raises_both(exc, jax_call, port_call, match=None):
    with pytest.raises(exc, match=match):
        jax_call()
    with pytest.raises(exc, match=match):
        port_call()


@pytest.mark.parametrize("mode", MODES)
def test_refusals_match_reference(params, mode):
    jeng, eng = _pair(params, mode)
    # speculation rides the fused verify step
    _raises_both(ValueError, lambda: jeng.generate(
        [JaxRequest(r.prompt, 4, speculate=2) for r in _reqs(JaxRequest)]),
        lambda: eng.generate([Request(r.prompt, 4, speculate=2)
                              for r in _reqs(Request)]), "fused")
    # so does chunked prefill: a non-fused session stays monolithic
    _raises_both(ValueError, lambda: JaxSession(jeng, 32,
                                                chunked_prefill=True),
                 lambda: ServeSession(eng, 32, chunked_prefill=True),
                 "chunked")
    assert ServeSession(eng, 32).chunked is False
    # an unknown mode
    _raises_both(ValueError, lambda: JaxEngine(jax_smoke(ARCH),
                                               params=params[0],
                                               decode_mode="bogus"),
                 lambda: ServeEngine(smoke_config(ARCH), params=params[1],
                                     device="cpu", decode_mode="bogus"),
                 "not in")


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_stack_refuses_non_fused(mode):
    """Recurrent and ring layers serve through the fused step only: a
    hybrid stack raises `NotImplementedError` at generate and serve, and
    its paged state refuses the mode."""
    from repro_torch.serve.paged_state import StateLayout
    arch = "mamba2-780m"
    jeng = JaxEngine(jax_smoke(arch), kv_pool=JaxPool(page_tokens=4),
                     decode_mode=mode)
    eng = ServeEngine(smoke_config(arch), device="cpu", decode_mode=mode,
                      kv_pool=PagedKVPool(page_tokens=4))
    vocab = smoke_config(arch).vocab_size
    prompt = np.arange(8, dtype=np.int32) % vocab
    for call in ("generate", "serve"):
        _raises_both(NotImplementedError,
                     lambda: getattr(jeng, call)([JaxRequest(prompt, 3)]),
                     lambda: getattr(eng, call)([Request(prompt, 3)]),
                     "fused")
    cfg = smoke_config(arch)
    with pytest.raises(NotImplementedError, match="fused-only"):
        PagedKVState(PagedKVPool(page_tokens=4), 16, StateLayout(cfg, 4),
                     cfg.num_kv_heads, cfg.head_dim, mode=mode,
                     device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_mesh_plan_refuses_non_fused_state_and_engine_serves_unsharded(
        params, mode):
    """A plan takes the fused mode only (`ValueError` from the state, as
    JAX's); an eager or numpy engine built over a mesh serves unsharded on
    its first device, with JAX's one-device tokens."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve.paged_state import StateLayout
    from repro_torch.serve.sharding import ServePlan
    cfg = smoke_config(ARCH)
    mesh = make_serve_mesh(1, 2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="fused"):
        PagedKVState(PagedKVPool(page_tokens=4), 16, StateLayout(cfg, 4),
                     cfg.num_kv_heads, cfg.head_dim, mode=mode,
                     device="cpu", plan=ServePlan.from_mesh(mesh))
    jeng, _ = _pair(params, mode)
    eng = ServeEngine(cfg, params=params[1], device="cpu", decode_mode=mode,
                      kv_pool=PagedKVPool(page_tokens=4), mesh=mesh)
    assert eng.plan is None and str(eng.device) == "cpu"
    _assert_same(jeng.generate(_reqs(JaxRequest)),
                 eng.generate(_reqs(Request)))


# ---------------------------------------------------------------------------
# Knees persisted through the engine
# ---------------------------------------------------------------------------
def test_knee_cache_persists_and_preloads(tmp_path, params):
    """The port of the reference's test: a serve run with ``knee_cache=``
    resolves the paged kernel's launch shape from its shapes (on the CPU
    too; the plain version ignores it) and writes a ``paged_attention``
    entry; a restart over the same file preloads it and resolves none."""
    _, state = params
    api.invalidate_caches()
    path = api.knee_cache_path(tmp_path)
    eng = ServeEngine(smoke_config(ARCH), params=state, device="cpu",
                      kv_pool=PagedKVPool(page_tokens=4), knee_cache=path)
    eng.serve(_reqs(Request, n=2), max_active=2)
    entries = json.loads(path.read_text())
    assert any(e["kernel"] == "paged_attention" and e["arch"] == "sm_90a"
               for e in entries)
    assert not api.knees_dirty()          # the engine saved what it resolved

    api.invalidate_caches()
    eng2 = ServeEngine(smoke_config(ARCH), params=state, device="cpu",
                       kv_pool=PagedKVPool(page_tokens=4), knee_cache=path)
    eng2.serve(_reqs(Request, n=2), max_active=2)
    assert not api.knees_dirty()
    assert json.loads(path.read_text()) == entries


def test_jax_knee_cache_beside_the_ports_stays_loadable(tmp_path, params):
    """Both engines persist knees beside one checkpoint directory: the
    port's file is its own, so the JAX engine's ``knee_cache.json`` holds
    only its entries and loads and saves without a warning."""
    jparams, state = params
    port_path = api.knee_cache_path(tmp_path)
    jax_path = jax_api.knee_cache_path(tmp_path)
    assert port_path != jax_path and port_path.parent == jax_path.parent
    api.invalidate_caches()
    jax_api.invalidate_caches()
    ServeEngine(smoke_config(ARCH), params=state, device="cpu",
                kv_pool=PagedKVPool(page_tokens=4), knee_cache=port_path) \
        .generate(_reqs(Request, n=1))
    JaxEngine(jax_smoke(ARCH), params=jparams,
              kv_pool=JaxPool(page_tokens=4), knee_cache=jax_path) \
        .generate(_reqs(JaxRequest, n=1))
    assert port_path.exists() and jax_path.exists()
    jax_api.invalidate_caches()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        n = jax_api.load_knee_cache(jax_path)
        assert n == len(json.loads(jax_path.read_text())) > 0
        assert jax_api.save_knee_cache(jax_path) == n
        assert api.load_knee_cache(port_path) > 0
