"""The port's async streaming front end, traffic traces and serving
launcher against the JAX package's, on the starcoder2-7b smoke config
with shared params and 4-token pages — the cases of
``tests/test_frontend.py``: streamed tokens equal `ServeEngine.serve`'s
and the JAX front end's (plain and k = 4), cancellation frees exactly the
cancelled request's pages, a full queue rejects (structured, no
deadlock), pool / session capacity and speculate rejections carry the
reference's `Admission` verdicts, the per-request metrics satisfy the
latency-vocabulary invariants with the JAX front end's counts, and
`make_trace` gives the reference's arrays for every mix. Plus
``python -m repro_torch.launch.serve`` on the CPU: a batch, the front
end, the overload mix, and the options that stay unported."""
import asyncio
import types

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.frontend import AsyncServeFrontend as JaxFrontend
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro.serve.traffic import MIXES as JAX_MIXES
from repro.serve.traffic import make_trace as jax_make_trace
from repro.serve.traffic import parse_spec as jax_parse_spec
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.frontend import AsyncServeFrontend
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.traffic import (MIXES, make_trace, parse_spec,
                                       run_trace, trace_capacity)

ARCH = "starcoder2-7b"

SIDES = {
    "jax": types.SimpleNamespace(
        name="jax", Engine=JaxEngine, Request=JaxRequest, Pool=JaxPool,
        Frontend=JaxFrontend, cfg=jax_smoke(ARCH),
        kw={"decode_mode": "fused"}),
    "port": types.SimpleNamespace(
        name="port", Engine=ServeEngine, Request=Request, Pool=PagedKVPool,
        Frontend=AsyncServeFrontend, cfg=smoke_config(ARCH),
        kw={"device": "cpu"}),
}


@pytest.fixture(scope="module")
def ref():
    """Shared weights (side -> params), four prompts, their budgets and
    the JAX engine's `serve` of them at max_active=2."""
    cfg = jax_smoke(ARCH)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(4)]
    news = [3, 6, 4, 5]
    eng = JaxEngine(cfg, kv_pool=JaxPool(page_tokens=4), decode_mode="fused")
    expected = eng.serve([JaxRequest(p.copy(), n)
                          for p, n in zip(prompts, news)], max_active=2)
    params = {"jax": eng.params,
              "port": params_from_numpy(smoke_config(ARCH),
                                        jax.tree.map(np.asarray, eng.params))}
    return params, prompts, news, [e.tolist() for e in expected]


def _engine(side, params, capacity_pages=None, **kw):
    pool = side.Pool(page_tokens=4, capacity_pages=capacity_pages)
    return side.Engine(side.cfg, params=params[side.name], kv_pool=pool,
                       **side.kw, **kw), pool


def both(scenario):
    want, got = scenario(SIDES["jax"]), scenario(SIDES["port"])
    assert got == want
    return got


async def _stream_all(front, requests):
    """Submit all, collect each stream AND its result, assert they agree."""
    handles = [await front.submit(r) for r in requests]
    outs = []
    for h in handles:
        toks = [t async for t in h]
        final = await h.result()
        assert toks == final.tolist()      # the stream IS the result
        outs.append(toks)
    return handles, outs


def _counts(summary):
    return {k: summary[k] for k in ("n_requests", "n_done", "n_cancelled",
                                    "n_rejected", "n_errors", "tokens",
                                    "preemptions", "accept_rate")}


@pytest.mark.parametrize("speculate", [0, 4], ids=["plain", "spec4"])
def test_stream_matches_serve_token_for_token(ref, speculate):
    params, prompts, news, expected = ref

    def scenario(side):
        eng, pool = _engine(side, params, speculate=speculate)

        def reqs():
            return [side.Request(p.copy(), n) for p, n in zip(prompts, news)]

        served = [o.tolist() for o in eng.serve(reqs(), max_active=2)]

        async def go():
            async with side.Frontend(eng, capacity=18,
                                     max_active=2) as front:
                _, outs = await _stream_all(front, reqs())
                return outs, front.metrics.summary()

        outs, summary = asyncio.run(go())
        return served, outs, _counts(summary), len(pool.pages)

    served, outs, counts, live = both(scenario)
    assert served == outs
    if not speculate:
        assert outs == expected
        assert counts["n_done"] == 4 and counts["n_rejected"] == 0
        assert counts["tokens"] == sum(news)
    else:
        assert counts["accept_rate"] is not None   # SpecStats flowed
    assert live == 0


def test_cancel_frees_exactly_the_cancelled_pages(ref):
    # radix=False: every page has one holder, so cancel frees all of them
    params, prompts, _, expected = ref

    def scenario(side):
        eng, pool = _engine(side, params)

        async def go():
            async with side.Frontend(eng, capacity=20, max_active=2,
                                     radix=False) as front:
                keep = await front.submit(side.Request(prompts[0].copy(), 3))
                drop = await front.submit(side.Request(prompts[1].copy(), 8))
                got = 0
                async for _t in drop:
                    got += 1
                    if got == 2:
                        break
                before = {pid: p.seq_id for pid, p in pool.pages.items()}
                assert drop.cancel()
                after = set(pool.pages)
                partial = (await drop.result()).tolist()
                kept = (await keep.result()).tolist()
                return before, after, partial, kept, drop.cancelled

        before, after, partial, kept, cancelled = asyncio.run(go())
        removed = set(before) - after
        seqs = {before[pid] for pid in removed}
        return (sorted(removed), len(seqs),
                any(before[pid] in seqs for pid in after), partial, kept,
                cancelled, len(pool.pages))

    removed, n_seqs, survivor, partial, kept, cancelled, live = \
        both(scenario)
    assert removed and n_seqs == 1 and not survivor
    assert cancelled and len(partial) == 2
    assert kept == expected[0]                      # survivor clean
    assert live == 0


def test_backpressure_rejects_instead_of_deadlocking(ref):
    params, prompts, _, _ = ref

    def scenario(side):
        eng, pool = _engine(side, params)

        async def go():
            # max_active=1 and back-to-back submits: the waiting line
            # alone absorbs a and b, the third submit must shed
            async with side.Frontend(eng, capacity=20, max_active=1,
                                     max_queue=2) as front:
                hs = [await front.submit(side.Request(p.copy(), 3))
                      for p in prompts[:3]]
                outs = [(await h.result()).tolist() for h in hs]
                return ([h.admission.as_dict() for h in hs],
                        [h.rejected for h in hs], outs,
                        _counts(front.metrics.summary()))

        out = asyncio.run(asyncio.wait_for(go(), timeout=120))
        return out + (len(pool.pages),)

    verdicts, rejected, outs, counts, live = both(scenario)
    assert rejected == [False, False, True]
    assert verdicts[2]["reason"] == "queue_full"
    assert "max_queue=2" in verdicts[2]["detail"]
    assert [len(o) for o in outs] == [3, 3, 0]
    assert counts["n_rejected"] == 1 and counts["n_done"] == 2
    assert live == 0


def test_pool_capacity_rejection_through_frontend(ref):
    params, prompts, _, _ = ref
    need = jax_smoke(ARCH).num_layers * (-(-(12 + 4) // 4) + 1)

    def scenario(side):
        eng, pool = _engine(side, params, capacity_pages=need)

        async def go():
            async with side.Frontend(eng, capacity=60,
                                     max_active=2) as front:
                ok = await front.submit(side.Request(prompts[0].copy(), 4))
                bad = await front.submit(side.Request(prompts[1].copy(), 40))
                return (await ok.result()).tolist(), bad.rejected, \
                    bad.admission.as_dict()

        return asyncio.run(go()) + (len(pool.pages),)

    out, rejected, verdict, live = both(scenario)
    assert len(out) == 4                            # workload not aborted
    assert rejected and verdict["reason"] == "pool_capacity"
    assert verdict["pages_needed"] > verdict["pages_budget"]
    assert "never be admitted" in verdict["detail"]
    assert live == 0


def test_session_capacity_and_speculate_rejections(ref):
    params, prompts, _, _ = ref

    def scenario(side):
        eng, _ = _engine(side, params)

        async def go():
            # capacity=8 tokens rounds up to an 8-slot page table (32
            # tokens); a request spanning more cannot sit in the table
            async with side.Frontend(eng, capacity=8,
                                     max_active=1) as front:
                too_long = await front.submit(
                    side.Request(prompts[0].copy(), 24))
                too_wide = await front.submit(
                    side.Request(prompts[0][:4].copy(), 2, speculate=4))
                await front.drain()
                return [(h.rejected, h.admission.as_dict())
                        for h in (too_long, too_wide)]

        return asyncio.run(go())

    (long_rej, long_v), (wide_rej, wide_v) = both(scenario)
    assert long_rej and long_v["reason"] == "capacity"
    assert wide_rej and wide_v["reason"] == "speculate"


def test_metrics_invariants(ref):
    params, prompts, news, _ = ref
    eng, _ = _engine(SIDES["port"], params)
    reqs = [Request(p.copy(), n) for p, n in zip(prompts, news)]

    async def go():
        async with AsyncServeFrontend(eng, capacity=18,
                                      max_active=2) as front:
            _, outs = await _stream_all(front, reqs)
            return outs, front.metrics

    outs, metrics = asyncio.run(go())
    for m, out in zip(metrics.requests, outs):
        assert m.status == "done"
        assert m.tokens == len(out)                # count matches output
        assert m.queue_wait_s >= 0
        assert m.ttft_s >= m.queue_wait_s          # first token after admit
        assert m.total_s >= m.ttft_s               # TTFT <= total latency
        assert len(m.itl_s) == m.tokens - 1        # one gap per later token
    s = metrics.summary()
    for key in ("ttft", "tpot", "queue_wait"):
        assert s[key]["p50_ms"] <= s[key]["p99_ms"]


@pytest.mark.parametrize("name", sorted(JAX_MIXES))
def test_make_trace_matches_reference(name):
    """Same spec, same numpy draws: every field of every item equal, the
    prompts array-equal; the same seed twice gives the same trace."""
    vocab = smoke_config(ARCH).vocab_size
    want = jax_make_trace(JAX_MIXES[name], vocab)
    for got in (make_trace(MIXES[name], vocab),
                make_trace(MIXES[name], vocab)):
        assert len(got) == len(want) == MIXES[name].n_requests
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert a.prompt.dtype == b.prompt.dtype
            assert (a.arrival_s, a.max_new, a.speculate, a.cancel_after,
                    a.deadline, a.priority) == \
                (b.arrival_s, b.max_new, b.speculate, b.cancel_after,
                 b.deadline, b.priority)
        assert trace_capacity(got) == max(len(it.prompt) + it.max_new
                                          for it in want)


def test_trace_replay_prefix_sharing(ref):
    """The reference test's replay: 4 requests sharing an 8-token head at
    500 arrivals/s finish on both engines with the same tokens, and the
    prefix is reused (hashed puts or radix adoption)."""
    params = ref[0]
    spec = MIXES["prefix_heavy"].override(n_requests=4, arrival_rate=500.0,
                                          prefix_fraction=1.0, prefix_len=8)

    def scenario(side):
        eng, pool = _engine(side, params)
        if side.name == "jax":
            from repro.serve.traffic import run_trace as jax_run_trace
            out = jax_run_trace(eng, JAX_MIXES["prefix_heavy"].override(
                **{k: getattr(spec, k) for k in (
                    "n_requests", "arrival_rate", "prefix_fraction",
                    "prefix_len")}), max_active=2)
        else:
            out = run_trace(eng, spec, max_active=2)
        return {k: out[k] for k in ("n_done", "n_trace", "mix",
                                    "cancelled_pages_freed")}, \
            out["pool_shared_puts"] + out["pool_adopted_pages"] > 0, \
            pool.live_pages

    counts, reused, live = both(scenario)
    assert counts["n_done"] == 4 and counts["cancelled_pages_freed"]
    assert reused and live == 0


def test_parse_spec_matches_reference():
    for arg in ("uniform:n_requests=32,arrival_rate=100,prompt_lens=4+8",
                "speculative", "overload:deadlines=0.5+2.0,priorities=0+1",
                "chunked:prefix_len=16,seed=9"):
        assert vars(parse_spec(arg)) == vars(jax_parse_spec(arg))
    s = parse_spec("uniform:n_requests=32,arrival_rate=100,prompt_lens=4+8")
    assert (s.n_requests, s.arrival_rate, s.prompt_lens) == (32, 100.0,
                                                            (4, 8))
    assert parse_spec("speculative").speculate == 4
    with pytest.raises(ValueError, match="unknown trace mix"):
        parse_spec("bogus")
    with pytest.raises(ValueError, match="unknown TraceSpec field"):
        parse_spec("uniform:frobnicate=1")


# ---------------------------------------------------------------------------
# The serving launcher
# ---------------------------------------------------------------------------
LAUNCH = ["--arch", ARCH, "--smoke", "--device", "cpu", "--page-tokens", "4",
          "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"]


@pytest.mark.parametrize("mode", [["--continuous"], ["--paged"],
                                  ["--paged", "--speculate", "4"],
                                  ["--frontend", "--max-active", "2"]],
                         ids=["continuous", "generate", "spec4", "frontend"])
def test_launcher_serves(mode, capsys):
    from repro_torch.launch.serve import main
    out = main(LAUNCH + mode)
    vocab = smoke_config(ARCH).vocab_size
    for o in out["outs"]:
        assert len(o) == 4 and ((0 <= o) & (o < vocab)).all()
    printed = capsys.readouterr().out
    assert "paged state: 2 kv/ring layers" in printed
    assert "live_pages=0" in printed


def test_launcher_replays_overload_mix(capsys):
    from repro_torch.launch.serve import main
    out = main(LAUNCH + ["--paged", "--continuous", "--frontend", "--trace",
                         "overload:n_requests=6", "--max-active", "2"])
    s = out["summary"]
    assert s["mix"] == "overload" and s["n_trace"] == 6
    assert s["n_done"] + s["n_cancelled"] + s["n_rejected"] \
        + s["n_errors"] == 6
    assert s["slo_attainment"] is not None and s["pool_live_pages_end"] == 0
    assert "slo attainment" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--sibyl"], ["--sibyl-preempt"],
                                  ["--mesh", "2x2"],
                                  ["--knee-cache", "knees.json"],
                                  ["--decode-mode", "eager"]])
def test_launcher_unported_options_raise(flag):
    from repro_torch.launch.serve import main
    with pytest.raises(NotImplementedError):
        main(LAUNCH + ["--continuous"] + flag)


def test_launcher_dense_path_stays_refused():
    from repro_torch.launch.serve import main
    with pytest.raises(NotImplementedError, match="dense-cache"):
        main(LAUNCH)
