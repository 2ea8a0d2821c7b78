"""Mesh-sharded serving on the port, against the JAX package's
single-device engine (which ``tests/test_sharded_serve.py`` holds its
own mesh path equal to), on the CPU with every shard on the CPU
(``make_serve_mesh(d, m, devices=["cpu"] * n)``):

- greedy `generate` under plans 1x4, 4x1, 8x1 and 2x4, speculative k = 4
  at 2x2 and 2x4 (n-gram drafts; at 2x2 also the model's own), the
  continuous `serve` at 2x2, the default chunked +
  radix `serve` (k = 1 and 4) and a `ServeSession` preempting one row on
  each data shard: the JAX engine's tokens, token for token, with the
  same weights (the port's seeded init, carried to JAX leaf for leaf);
- the transfer counts of `generate` are the JAX engine's at every plan,
  and a steady step costs one upload and one download;
- the scheduler's per-shard admission equals the reference's
  ``Scheduler(data_shards=, rows_per_shard=)`` decision for decision;
- the head-sharded calling convention: per-shard plain paged attention
  over local page tables, heads split over the model axis, equals the
  reference's `ref.paged_attention` over global tables;
- the hybrid stacks (mamba2-780m, recurrentgemma-2b smoke) at 2x2 and
  recurrentgemma at 2x1 / 1x2: `generate`, k = 4 and `serve` against the
  JAX engine;
- ``launch.serve.main(["--mesh", "2x2", ...])`` on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models.common import flatten, unflatten
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Request, ServeEngine, ServeSession
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.paged_state import StateLayout
from repro_torch.serve.scheduler import Scheduler

ARCH = "starcoder2-7b"
HYBRIDS = ("mamba2-780m", "recurrentgemma-2b")


def _params(arch):
    """The port's seeded init carried to JAX leaf for leaf (JAX's own
    eager init costs seconds an arch)."""
    state = flatten(Model(smoke_config(arch), device="cpu", seed=0).params)
    jparams = unflatten({n: jnp.asarray(t.float().numpy()).astype(
        str(t.dtype).replace("torch.", "")) for n, t in state.items()})
    return jparams, state


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and with several test processes on the machine's cores the default
    thread pool spends its time waiting for cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """arch -> (JAX params, the port's state dict): the same weights."""
    return {arch: _params(arch) for arch in (ARCH,) + HYBRIDS}


def _reqs(cls, arch=ARCH, n=2, plen=12, new=6, seed=0):
    rng = np.random.default_rng(seed)
    vocab = smoke_config(arch).vocab_size
    return [cls(rng.integers(0, vocab, plen).astype(np.int32), new)
            for _ in range(n)]


def _port(params, shape, arch=ARCH, t=8, **kw):
    d, m = shape
    return ServeEngine(smoke_config(arch), params=params[arch][1],
                       kv_pool=PagedKVPool(page_tokens=t), device="cpu",
                       mesh=make_serve_mesh(d, m, devices=["cpu"] * (d * m)),
                       **kw)


def _jax(params, arch=ARCH, t=8, **kw):
    return JaxEngine(jax_smoke(arch), params=params[arch][0],
                     kv_pool=JaxPool(page_tokens=t), decode_mode="fused",
                     **kw)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def jax_outs(params):
    """The JAX single-device engine's outputs the tests compare with."""
    out = {}
    eng = _jax(params)
    for new in (6, 10):
        out["generate", new] = eng.generate(_reqs(JaxRequest, new=new),
                                            free_pages=True)
        out["transfers", new] = eng.last_transfers
    out["serve"] = eng.serve(_staggered(JaxRequest), max_active=2)
    for k in (1, 4):
        spec = _jax(params, speculate=k, draft="ngram") if k > 1 else eng
        out["chunked", k] = spec.serve(
            _shared_head(JaxRequest, k), max_active=2,
            chunked_prefill=False, radix=False)
    reqs = _reqs(JaxRequest, n=4, plen=12, new=8, seed=3)
    out["solo"] = [eng.generate([JaxRequest(r.prompt.copy(),
                                            r.max_new_tokens)],
                                free_pages=True)[0]
                   for r in reqs]
    return out


@pytest.fixture(scope="module")
def jax_hybrid(params):
    """arch -> the JAX engine's generate, k = 4 generate and serve."""
    out = {}
    for arch in HYBRIDS:
        eng = _jax(params, arch, 4)
        spec = _jax(params, arch, 4, speculate=4)
        out[arch] = (
            eng.generate(_reqs(JaxRequest, arch, plen=10, new=8),
                         free_pages=True),
            spec.generate(_reqs(JaxRequest, arch, plen=10, new=8)),
            eng.serve(_reqs(JaxRequest, arch, n=3, plen=10, new=5),
                      max_active=2))
    return out


def _staggered(cls):
    rs = _reqs(cls, n=4, new=3)
    for i, r in enumerate(rs):
        r.max_new_tokens = 3 + i
    return rs


def _shared_head(cls, spec_k):
    rng = np.random.default_rng(7)
    vocab = smoke_config(ARCH).vocab_size
    head = rng.integers(0, vocab, 16).astype(np.int32)
    rs = []
    for i in range(4):
        tail = rng.integers(0, vocab, 5 + i).astype(np.int32)
        rs.append(cls(np.concatenate([head, tail]), 3 + i,
                      speculate=spec_k if spec_k > 1 else None))
    return rs


# ---------------------------------------------------------------------------
# Token-for-token equivalence with the JAX single-device engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 4), (4, 1), (8, 1), (2, 4)])
def test_sharded_greedy_matches_single_device(params, jax_outs, shape):
    eng = _port(params, shape)
    _same(eng.generate(_reqs(Request)), jax_outs["generate", 6])
    # transfer counts are the single-device engine's at every plan
    assert eng.last_transfers == jax_outs["transfers", 6]


@pytest.mark.parametrize("shape,draft", [((2, 2), "ngram"),
                                         ((2, 4), "ngram"),
                                         ((2, 2), "self")])
def test_sharded_speculative_matches_greedy(params, jax_outs, shape, draft):
    """k = 4 verify steps accept and reject as the unsharded greedy stream
    does, with n-gram drafts or the sharded model drafting for itself."""
    eng = _port(params, shape, speculate=4, draft=draft)
    _same(eng.generate(_reqs(Request, new=10)), jax_outs["generate", 10])


def test_sharded_continuous_matches_single_device(params, jax_outs):
    eng = _port(params, (2, 2))
    _same(eng.serve(_staggered(Request), max_active=2), jax_outs["serve"])
    assert len(eng.kv_pool.pages) == 0
    # two data shards, one row each: both decoded
    assert eng.last_peak_active == 2


@pytest.mark.parametrize("spec_k", [1, 4])
def test_sharded_chunked_prefill_matches_monolithic(params, jax_outs, spec_k):
    """The default chunked + radix `serve` on a 2x2 plan (one radix tree
    per data shard) gives the JAX engine's monolithic-prefill tokens."""
    kw = {"speculate": spec_k, "draft": "ngram"} if spec_k > 1 else {}
    eng = _port(params, (2, 2), **kw)
    _same(eng.serve(_shared_head(Request, spec_k), max_active=2),
          jax_outs["chunked", spec_k])
    assert len(eng.kv_pool.pages) == 0     # serve() dropped the pins


def test_sharded_preempt_resume_matches_single_device(params, jax_outs):
    """Preempt one active row on EACH data shard of a 2x2 plan: the
    victims swap to the host tier, resume onto their own shard, and every
    output equals its solo single-device decode."""
    reqs = _reqs(Request, n=4, plen=12, new=8, seed=3)
    eng = _port(params, (2, 2))
    ses = ServeSession(eng, capacity=64, max_active=4)
    for r in reqs:
        ses.submit(r)
    for _ in range(3):
        ses.step()
    by_shard = {}
    for r in reqs:
        by_shard.setdefault(ses.sched.assigned_shard(r), r)
    assert sorted(by_shard) == [0, 1]
    for r in by_shard.values():
        assert ses.preempt(r)
    assert eng.kv_pool.stats["swap_out_bytes"] > 0
    while not ses.done:
        ses.step()
        ses.check_invariants()
    _same([ses.result(r) for r in reqs], jax_outs["solo"])
    assert ses.preemptions == 2 and ses.resumes == 2
    ses.close()
    assert eng.kv_pool.live_pages == 0


# ---------------------------------------------------------------------------
# Transfers: two host<->device crossings per token at any plan
# ---------------------------------------------------------------------------
def test_transfers_per_token_mesh_independent(params, jax_outs):
    """Each extra token costs one upload and one download at a 2x2 plan,
    as at one device (the greedy test holds `generate`'s counts equal to
    JAX's at four more plans)."""
    for shape in ((2, 2),):
        got = {}
        for new in (6, 10):
            eng = _port(params, shape)
            eng.generate(_reqs(Request, new=new))
            got[new] = eng.last_transfers
            assert got[new] == jax_outs["transfers", new], (shape, new)
        assert (got[10][0] - got[6][0], got[10][1] - got[6][1]) == (4, 4)


def test_sharded_steady_state_two_transfers_per_token(params):
    """Once the mirror is synced, 3 tokens on a 1x4 plan cost exactly (3,
    3) transfers and no pool write."""
    import torch
    from repro_torch.serve.paged_decode import (PagedKVState,
                                                build_fused_step,
                                                extract_prefill_pages)
    eng = _port(params, (1, 4), t=16)
    cfg = eng.cfg
    prompt = np.asarray(_reqs(Request, n=1, plen=20)[0].prompt)
    state = PagedKVState(eng.kv_pool, 32, eng.layout, cfg.num_kv_heads,
                         cfg.head_dim, plan=eng.plan)
    logits, caches = eng.model.forward_prefill(
        torch.from_numpy(prompt[None]))
    extract_prefill_pages(eng.model, caches, state, [0])
    fused = build_fused_step(eng.model, state.slots, layout=eng.layout,
                             plan=eng.plan)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _, tok = state.run_fused(fused, tok, [0], 20)
    writes0 = state._device.writes
    h0, d0 = state.transfer_counts()
    for s in range(3):
        _, tok = state.run_fused(fused, tok, [0], 21 + s)
    h1, d1 = state.transfer_counts()
    assert state._device.writes == writes0
    assert (h1 - h0, d1 - d0) == (3, 3)


# ---------------------------------------------------------------------------
# Kernel calling convention: per-shard calls are local
# ---------------------------------------------------------------------------
def test_head_sharded_calling_convention_matches_reference():
    """Per-shard plain paged attention (the wrapper on CPU tensors) with
    LOCAL page tables, q and kv heads split over the model axis, equals
    the reference's `ref.paged_attention` with global page ids: no shard
    needs a remote page."""
    import torch
    from repro.kernels.paged_attention import ref as jax_ref
    from repro_torch.kernels import api
    from repro_torch.kernels.paged_attention.spec import head_sharded_specs
    from repro_torch.serve.sharding import ServePlan

    dp, tp = 2, 2
    b, pages_local, slots, t, hq, hkv, d = 4, 8, 2, 8, 4, 2, 16
    pages = dp * pages_local
    rng = np.random.default_rng(0)
    kf = rng.normal(size=(pages, t, hkv, d)).astype(np.float32)
    vf = rng.normal(size=(pages, t, hkv, d)).astype(np.float32)
    kq = np.zeros((pages, t, hkv, d), np.int8)
    vq = np.zeros((pages, t, hkv, d), np.int8)
    ks = np.zeros((pages, t, hkv), np.float32)
    vs = np.zeros((pages, t, hkv), np.float32)
    table_local = np.zeros((b, slots), np.int32)
    table_global = np.zeros((b, slots), np.int32)
    rows = b // dp
    for i in range(b):
        local = rng.permutation(pages_local)[:slots]
        table_local[i] = local
        table_global[i] = local + (i // rows) * pages_local
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    lengths = rng.integers(1, slots * t + 1, b).astype(np.int32)
    want = np.asarray(jax_ref.paged_attention(q, kf, vf, kq, vq, ks, vs,
                                              table_global, lengths))

    plan = ServePlan(make_serve_mesh(dp, tp, devices=["cpu"] * 4))
    specs = head_sharded_specs(layer_stacked=False)
    names = ("q", "k_pages", "v_pages", "k_quant", "v_quant", "k_scale",
             "v_scale", "page_table", "lengths")
    args = dict(zip(names, (q, kf, vf, kq, vq, ks, vs, table_local,
                            lengths)))
    got = np.zeros_like(want)
    for s in range(dp):
        for m in range(tp):
            # each argument's block: rows and the pool's pages over data,
            # q and kv heads over model
            local = {n: torch.from_numpy(np.ascontiguousarray(
                args[n][plan.local_index(args[n].shape, specs[n], s, m)]))
                for n in names}
            out = api.run("paged_attention", *(local[n] for n in names),
                          backend="auto")
            got[plan.local_index(want.shape, specs["out"], s, m)] = \
                out.numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# Scheduler: per-shard row + page budgets, decision for decision
# ---------------------------------------------------------------------------
def _scheds(capacity_pages=None, **kw):
    layout = StateLayout(smoke_config(ARCH), 4)
    js = JaxScheduler(JaxPool(page_tokens=4, capacity_pages=capacity_pages),
                      num_layers=2, **kw)
    ps = Scheduler(PagedKVPool(page_tokens=4, capacity_pages=capacity_pages),
                   layout, **kw)
    return js, ps


def _req(cls, plen=4, new=4):
    return cls(np.zeros(plen, np.int32), new)


def test_scheduler_unsharded_defaults_unchanged():
    for s, cls in zip(_scheds(max_active=2), (JaxRequest, Request)):
        r = _req(cls)
        assert s.submit(r)
        assert s.admit() == [r]
        assert s.assigned_shard(r) == 0
        s.retire(r)
        assert s.done


def test_scheduler_rejects_on_per_shard_budget():
    verdicts = []
    for s, cls in zip(_scheds(capacity_pages=12, max_active=4,
                              data_shards=2), (JaxRequest, Request)):
        v = s.submit(_req(cls, plen=8, new=8))
        assert not v and v.reason == "pool_capacity"
        verdicts.append(v.as_dict())
    assert verdicts[0] == verdicts[1]
    assert verdicts[1]["pages_budget"] == 6
    assert "per data shard (x2)" in verdicts[1]["detail"]


def test_scheduler_balances_shards_and_respects_rows():
    log = []
    for s, cls in zip(_scheds(max_active=8, data_shards=2,
                              rows_per_shard=1), (JaxRequest, Request)):
        reqs = [_req(cls) for _ in range(3)]
        for r in reqs:
            assert s.submit(r)
        first = s.admit()
        shards = [s.assigned_shard(r) for r in first]
        s.retire(first[0])
        second = s.admit()

        def index(rs):
            return [next(i for i, x in enumerate(reqs) if x is r)
                    for r in rs]

        log.append((index(first), shards, index(second),
                    s.assigned_shard(second[0]), len(s.waiting)))
    assert log[0] == log[1]
    assert log[1][0] == [0, 1] and sorted(log[1][1]) == [0, 1]


def test_scheduler_shard_reservations_release_on_retire():
    states = []
    for s, cls in zip(_scheds(capacity_pages=40, max_active=4,
                              data_shards=2), (JaxRequest, Request)):
        reqs = [_req(cls, plen=8, new=8) for _ in range(2)]
        for r in reqs:
            assert s.submit(r)
        s.admit()
        during = (list(s._shard_reserved), list(s._shard_active))
        for r in reqs:
            s.retire(r)
        states.append((during, list(s._shard_reserved),
                       list(s._shard_active), s.done))
    assert states[0] == states[1]
    assert states[1][0][0][0] > 0 and states[1][1:] == ([0, 0], [0, 0],
                                                         True)


def test_scheduler_preempt_resume_keeps_shard():
    log = []
    for s, cls in zip(_scheds(capacity_pages=64, max_active=4,
                              data_shards=2, rows_per_shard=1),
                      (JaxRequest, Request)):
        a, b, c = (_req(cls) for _ in range(3))
        for r in (a, b, c):
            s.submit(r)
        s.admit()
        shard_a = s.assigned_shard(a)
        s.preempt(a)
        got = s.admit()          # c takes a's freed row on a's shard
        s.retire(b)
        resumed = s.try_resume(a)
        log.append((shard_a, [r is c for r in got], s.assigned_shard(c),
                    resumed, s.assigned_shard(a),
                    list(s._shard_active)))
    assert log[0] == log[1]


# ---------------------------------------------------------------------------
# Hybrid stacks under plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", [("mamba2-780m", (2, 2)),
                                        ("recurrentgemma-2b", (2, 2)),
                                        ("recurrentgemma-2b", (2, 1)),
                                        ("recurrentgemma-2b", (1, 2))])
def test_hybrid_plans_match_single_device(params, jax_hybrid, arch, shape):
    kw = {"arch": arch, "t": 4}
    want, want_spec, want_serve = jax_hybrid[arch]
    _same(_port(params, shape, **kw).generate(
        _reqs(Request, arch, plen=10, new=8)), want)
    _same(_port(params, shape, speculate=4, **kw).generate(
        _reqs(Request, arch, plen=10, new=8)), want_spec)
    eng = _port(params, shape, **kw)
    _same(eng.serve(_reqs(Request, arch, n=3, plen=10, new=5),
                    max_active=2), want_serve)
    assert eng.kv_pool.live_pages == 0


def test_launcher_mesh_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--paged", "--mesh", "2x2", "--batch", "3",
                      "--prompt-len", "12", "--new-tokens", "4"])
    eng = out["engine"]
    assert (eng.plan.dp, eng.plan.tp) == (2, 2)
    assert [len(o) for o in out["outs"]] == [4, 4, 4]
    ref = ServeEngine(smoke_config(ARCH), kv_pool=PagedKVPool(page_tokens=16),
                      device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, ref.cfg.vocab_size, size=12)
                    .astype(np.int32), 4) for _ in range(3)]
    _same(out["outs"], ref.generate(reqs))
    assert "ServePlan(dp=2, tp=2)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="DxM"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--paged", "--mesh", "2by2"])
    with pytest.raises(SystemExit, match="--paged"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--mesh", "2x2"])


def test_kv_heads_the_model_axis_cannot_split_raise():
    """32 q and 4 kv heads on a model axis of 8: the reference's
    `check_config` lets the plan through (each shard's 4 q heads map into
    one kv head), but replicating all 4 kv heads would pair every shard's
    q heads with the wrong ones, so the engine and the pool refuse it.
    One kv head (MQA) replicates and serves (the recurrentgemma plans
    above)."""
    import dataclasses
    from repro_torch.serve.device_pool import DevicePagePool
    from repro_torch.serve.sharding import ServePlan
    cfg = dataclasses.replace(smoke_config("qwen3-moe-30b-a3b"),
                              num_heads=32, num_kv_heads=4)
    mesh = make_serve_mesh(1, 8, devices=["cpu"] * 8)
    plan = ServePlan(mesh)
    plan.check_config(cfg)
    with pytest.raises(ValueError, match="num_kv_heads=4 not divisible"):
        ServeEngine(cfg, kv_pool=PagedKVPool(page_tokens=8), device="cpu",
                    mesh=mesh)
    with pytest.raises(ValueError, match="num_kv_heads=4 not divisible"):
        DevicePagePool(cfg.num_layers, 8, cfg.num_kv_heads, cfg.head_dim,
                       device="cpu", plan=plan)
    assert plan.replicate_heads(1) and not plan.replicate_heads(8)
