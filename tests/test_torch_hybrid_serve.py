"""The hybrid stacks through the port's paged engine: mamba2-780m (SSD
layers, no MLP) and recurrentgemma-2b (RG-LRU, RG-LRU, local attention)
smoke configs with the JAX engine's params, against the JAX engine's
fused paged path — greedy tokens, per-request stats, transfer counts,
decode steps and pool stats for `generate` (plain and k = 4) and the
default `serve` (chunked prefill through the one-token cores, plain and
k = 4); the prefill logits and caches through the SSD / RG-LRU scan
wrappers and the windowed flash wrapper. Plus the port counterparts of
``tests/test_hybrid_serve.py`` (without its mesh, swap, preemption and
traffic tests): layout facts, ring wrap and the O(window) page bound,
O(1) recurrent verify traffic, two transfers per token, the forced
chunked session and admission beyond the page table."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro.serve.paged_state import StateLayout as JaxLayout
from repro_torch.configs import smoke_config
from repro_torch.configs.base import (ATTN, CROSS_ATTN, LOCAL_ATTN, MLA,
                                      MLP_DENSE)
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
from repro_torch.models.transformer import Model, pad_caches
from repro_torch.serve.engine import Request, ServeEngine, ServeSession
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.paged_decode import (PagedKVState, build_fused_step,
                                            extract_prefill_pages)
from repro_torch.serve.paged_state import (StateLayout, rec_array_names,
                                           supports_paged_layout)

HYBRIDS = ("mamba2-780m", "recurrentgemma-2b")
T = 4          # page tokens: short prompts span several pages and windows


@pytest.fixture(scope="module")
def params():
    """arch -> (JAX params, the port's state dict): the same weights."""
    out = {}
    for arch in HYBRIDS:
        jparams = JaxEngine(jax_smoke(arch)).params
        out[arch] = (jparams, params_from_numpy(
            smoke_config(arch), jax.tree.map(np.asarray, jparams)))
    return out


def _prompts(arch, lengths, seed=0):
    rng = np.random.default_rng(seed)
    vocab = smoke_config(arch).vocab_size
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _port(params, arch, **kw):
    pool = PagedKVPool(page_tokens=T)
    return ServeEngine(smoke_config(arch), params=params[arch][1],
                       kv_pool=pool, device="cpu", **kw), pool


def _jax(params, arch, **kw):
    pool = JaxPool(page_tokens=T)
    return JaxEngine(jax_smoke(arch), params=params[arch][0], kv_pool=pool,
                     decode_mode="fused", **kw), pool


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _plain_calls():
    return {f.__name__: f.plain_calls
            for f in (ssd_scan, rglru_scan, flash_attention)}


def _delta(before):
    return {k: v - before[k] for k, v in _plain_calls().items()}


# ---------------------------------------------------------------------------
# Layout facts
# ---------------------------------------------------------------------------
def test_layouts_match_reference():
    lay = StateLayout(smoke_config("mamba2-780m"), T)
    assert (lay.n_kv, lay.n_ssd, lay.n_rg) == (0, 2, 0)
    assert not lay.has_ring and lay.has_rec
    assert lay.pages_needed(1000) == 0          # pure SSM: zero pool pages
    lay = StateLayout(smoke_config("recurrentgemma-2b"), T)
    assert (lay.n_kv, lay.n_ssd, lay.n_rg) == (1, 0, 2)
    assert lay.has_ring and lay.has_rec and lay.window == 32
    assert lay.pages_needed(10_000) == lay.n_kv * (lay.ring_pages() + 1)
    for arch in HYBRIDS:
        mine = StateLayout(smoke_config(arch), T)
        ref = JaxLayout(jax_smoke(arch), T)
        for attr in ("n_kv", "n_ssd", "n_rg", "has_rec", "has_ring",
                     "window", "kv_of", "ssd_of", "rg_of"):
            assert getattr(mine, attr) == getattr(ref, attr), attr
        assert mine.ring_pages() == ref.ring_pages()
        for n in (0, 1, 31, 32, 33, 100, 1000):
            assert mine.ring_base(n) == ref.ring_base(n)
            assert mine.pages_needed(n, 2) == ref.pages_needed(n, 2)
        for k in (1, 4, 128):
            assert vars(mine.cols(16, k)) == vars(ref.cols(16, k))


def test_paged_layout_declines_unported_mixers():
    import dataclasses
    base = smoke_config("starcoder2-7b")
    for pattern, ok in ((((ATTN, MLP_DENSE),), True),
                        (((MLA, MLP_DENSE),), False),
                        (((CROSS_ATTN, MLP_DENSE),), False),
                        (((ATTN, MLP_DENSE), (LOCAL_ATTN, MLP_DENSE)), False)):
        cfg = dataclasses.replace(base, pattern=pattern)
        assert supports_paged_layout(cfg) is ok, pattern
    for arch in HYBRIDS:
        assert supports_paged_layout(smoke_config(arch))


# ---------------------------------------------------------------------------
# The model: prefill through the scan kernels' wrappers, dense decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", HYBRIDS)
def test_forward_prefill_and_dense_decode_match_jax(params, arch):
    """fp32 smoke logits at 1e-4 and every layer's prefill cache; each SSD
    / RG-LRU layer scans through its wrapper and each local-attention
    layer attends through the flash wrapper with the window. Then 8
    dense-cache decode steps (ring buffer for the window): same greedy
    tokens, logits at 1e-4."""
    from repro.models import Model as JaxModel
    from repro.serve.kvcache import pad_caches as jax_pad_caches
    cfg = smoke_config(arch)
    jm = JaxModel(jax_smoke(arch))
    jparams = params[arch][0]
    model = Model(cfg, device="cpu", state=params[arch][1])
    plen = 2 * cfg.window if cfg.window else 40     # ring-aligned
    toks = np.stack(_prompts(arch, [plen, plen], seed=3))
    want, wcaches = jax.jit(jm.forward_prefill)(
        jparams, {"tokens": jnp.asarray(toks)})
    before = _plain_calls()
    got, caches = model.forward_prefill(torch.from_numpy(toks))
    lay = StateLayout(cfg, T)
    assert _delta(before) == {"ssd_scan": lay.n_ssd, "rglru_scan": lay.n_rg,
                              "flash_attention": lay.n_kv}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    gs = cfg.group_size()
    for layer, c in enumerate(caches):
        wc = wcaches["groups"][f"l{layer % gs}"]
        for key, val in c.items():
            np.testing.assert_allclose(
                val.float().numpy(), np.asarray(wc[key])[layer // gs],
                atol=1e-4, rtol=0, err_msg=f"layer {layer} {key}")
    cap = plen + 8
    jc = jax_pad_caches(jm, wcaches, cap, plen)
    tc = pad_caches(caches, cap, cfg)
    jdec = jax.jit(jm.forward_decode)
    tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    for step in range(8):
        wl, jc = jdec(jparams, {"tokens": jnp.asarray(tok[:, None])}, jc,
                      jnp.int32(plen + step))
        tl = model.forward_decode(torch.from_numpy(tok[:, None]), tc,
                                  plen + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(wl), atol=1e-4,
                                   rtol=0)
        tok = np.asarray(jnp.argmax(wl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), tok)


# ---------------------------------------------------------------------------
# The engine against the JAX engine
# ---------------------------------------------------------------------------
def _check_engines(eng, pool, jeng, jpool, got, want):
    _same(want, got)
    assert eng.last_request_stats == jeng.last_request_stats
    assert eng.last_transfers == jeng.last_transfers
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert pool.stats == {k: jpool.stats[k] for k in pool.stats}


@pytest.mark.parametrize("speculate", [0, 4], ids=["plain", "spec4"])
@pytest.mark.parametrize("arch", HYBRIDS)
def test_generate_matches_jax(params, arch, speculate):
    """Left-padded prompts of two lengths (the pads run through the
    recurrences, as in the reference): tokens, request stats, transfers
    (the recurrent blocks' installs included), steps and pool stats. The
    prefill scans once per recurrent layer through the wrapper."""
    prompts = _prompts(arch, [10, 7])
    news = [8, 6]
    eng, pool = _port(params, arch, speculate=speculate)
    jeng, jpool = _jax(params, arch, speculate=speculate)
    before = _plain_calls()
    got = eng.generate([Request(p.copy(), n) for p, n in zip(prompts, news)])
    lay = StateLayout(smoke_config(arch), T)
    assert _delta(before) == {"ssd_scan": lay.n_ssd, "rglru_scan": lay.n_rg,
                              "flash_attention": lay.n_kv}
    # one prefill install per store tensor and sequence, no readback
    assert eng.last_rec_store == {
        "writes": len(rec_array_names(lay)) * len(prompts), "reads": 0}
    want = jeng.generate([JaxRequest(p.copy(), n)
                          for p, n in zip(prompts, news)])
    _check_engines(eng, pool, jeng, jpool, got, want)


@pytest.mark.parametrize("speculate", [0, 4], ids=["plain", "spec4"])
@pytest.mark.parametrize("arch", HYBRIDS)
def test_default_serve_matches_jax(params, arch, speculate):
    """The default `serve()` on both engines (chunked prefill forced, no
    radix): prompts shorter and longer than a page and than the window,
    staggered admission. No scan or flash launch: the prompts stream
    through the one-token cores, as in the reference."""
    prompts = _prompts(arch, [13, 3, 38, 9], seed=1)
    news = [5, 6, 4, 7]
    eng, pool = _port(params, arch, speculate=speculate)
    jeng, jpool = _jax(params, arch, speculate=speculate)
    before = _plain_calls()
    got = eng.serve([Request(p.copy(), n) for p, n in zip(prompts, news)],
                    max_active=2)
    assert _delta(before) == {"ssd_scan": 0, "rglru_scan": 0,
                              "flash_attention": 0}
    want = jeng.serve([JaxRequest(p.copy(), n)
                       for p, n in zip(prompts, news)], max_active=2)
    _check_engines(eng, pool, jeng, jpool, got, want)
    assert eng.last_prefix_hit_rate == jeng.last_prefix_hit_rate
    assert eng.last_peak_active == jeng.last_peak_active
    assert pool.live_pages == 0


@pytest.mark.parametrize("plen", [32, 41], ids=["aligned", "ragged"])
def test_ring_wrap_matches_jax(params, plen):
    """Prompts at and past the window: the ring drops pages at prefill
    and mid-decode; tokens and every stat equal the JAX engine's."""
    arch = "recurrentgemma-2b"
    prompts = _prompts(arch, [plen], seed=2)
    eng, pool = _port(params, arch)
    jeng, jpool = _jax(params, arch)
    got = eng.generate([Request(prompts[0].copy(), 16)])
    want = jeng.generate([JaxRequest(prompts[0].copy(), 16)])
    _check_engines(eng, pool, jeng, jpool, got, want)
    assert pool.stats["freed"] > 0                # pages were recycled


# ---------------------------------------------------------------------------
# Forced chunked session, admission
# ---------------------------------------------------------------------------
def test_hybrid_session_forces_chunked_and_no_radix(params):
    eng, _ = _port(params, "recurrentgemma-2b")
    with pytest.raises(ValueError, match="chunked"):
        ServeSession(eng, capacity=64, chunked_prefill=False)
    sess = ServeSession(eng, capacity=64)
    assert sess.chunked and not sess.radix and sess.prefix_index is None
    assert not sess.prefix_cache


def test_pure_ssm_session_admits_beyond_page_table(params):
    """A pure-SSM request takes no pool pages: the session must not
    reject it on page-table capacity."""
    eng, _ = _port(params, "mamba2-780m")
    sess = ServeSession(eng, capacity=16)        # tiny page table
    [prompt] = _prompts("mamba2-780m", [40])
    verdict = sess.submit(Request(prompt, 24))   # 64 tokens > capacity
    assert verdict, verdict.detail


def test_ring_session_admits_long_request(params):
    """A ring request's page need caps at O(window): a request far past
    the O(len) page table still admits, and is charged the ring bound."""
    eng, _ = _port(params, "recurrentgemma-2b")
    sess = ServeSession(eng, capacity=48)        # 12 slots at 4 tokens
    [prompt] = _prompts("recurrentgemma-2b", [64])
    req = Request(prompt, 32)                    # 96 tokens, window 32
    verdict = sess.submit(req)
    assert verdict, verdict.detail
    lay = eng.layout
    assert sess.sched.pages_needed(req) == lay.pages_needed(96) \
        == lay.n_kv * (lay.ring_pages() + 1)


# ---------------------------------------------------------------------------
# O(1) recurrent state, O(window) ring pages, transfers
# ---------------------------------------------------------------------------
def _direct_state(params, arch, prompt_len, capacity, page_tokens=T):
    """Prefill one prompt and set up the paged state and the fused step
    by hand, as the engine does."""
    cfg = smoke_config(arch)
    model = Model(cfg, device="cpu", state=params[arch][1])
    pool = PagedKVPool(page_tokens=page_tokens)
    lay = StateLayout(cfg, page_tokens)
    prompt = np.arange(prompt_len, dtype=np.int32) % cfg.vocab_size
    logits, caches = model.forward_prefill(torch.from_numpy(prompt[None]))
    state = PagedKVState(pool, capacity, lay, cfg.num_kv_heads, cfg.head_dim,
                         device="cpu")
    extract_prefill_pages(model, caches, state, [0])
    step = build_fused_step(model, state.slots, layout=lay)
    tok = torch.argmax(logits, -1).to(torch.int32)
    return state, step, tok, pool, lay


def test_recurrent_verify_is_o1_per_token(params):
    """k = 4 verify on a pure-SSM stack: tokens equal the JAX engine's,
    and the transfers stay at about two per verify step — the recurrent
    state never crosses after its prefill install."""
    arch = "mamba2-780m"
    [prompt] = _prompts(arch, [8])
    eng, pool = _port(params, arch, speculate=4)
    jeng, jpool = _jax(params, arch, speculate=4)
    got = eng.generate([Request(prompt.copy(), 24)])
    want = jeng.generate([JaxRequest(prompt.copy(), 24)])
    _check_engines(eng, pool, jeng, jpool, got, want)
    steps = eng.stats["decode_steps"]
    assert steps >= 5
    h2d, d2h = eng.last_transfers
    assert h2d <= 2 * steps + 8 and d2h <= steps + 8


def test_rec_store_counters_constant_per_step(params):
    """The recurrent store never crosses the host boundary during decode,
    at position 10 and position 40 alike."""
    state, step, tok, _, _ = _direct_state(params, "mamba2-780m", 8, 64)
    w0, r0 = state._rec.writes, state._rec.reads
    per_step = []
    for s in range(40):
        _, tok = state.run_fused(step, tok, [0], 8 + s)
        per_step.append((state._rec.writes - w0, state._rec.reads - r0))
    assert per_step[0] == per_step[-1] == (0, 0)
    state.free_seq(0)
    assert state._rec._used == {state._rec.trash}


def test_ring_pages_bounded_o_window(params):
    state, step, tok, pool, lay = _direct_state(params, "recurrentgemma-2b",
                                                32, 80)
    counts = []
    for s in range(40):
        _, tok = state.run_fused(step, tok, [0], 32 + s)
        counts.append(len(pool.seq_pages(0, 0)))
    assert max(counts) <= lay.ring_pages()       # O(window), not O(len)
    assert counts[-1] == counts[-2]              # steady state: recycled
    state.free_seq(0)
    assert pool.live_pages == 0


def test_hybrid_two_transfers_per_token(params):
    """Pure SSM steady state: one control upload + one token download per
    token; the recurrent state never crosses."""
    state, step, tok, _, _ = _direct_state(params, "mamba2-780m", 8, 16,
                                           page_tokens=16)
    _, tok = state.run_fused(step, tok, [0], 8)
    h0, d0 = state.transfer_counts()
    for s in range(3):
        _, tok = state.run_fused(step, tok, [0], 9 + s)
    h1, d1 = state.transfer_counts()
    assert (h1 - h0, d1 - d0) == (3, 3)
