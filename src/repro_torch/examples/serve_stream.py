"""Async streaming serving: submit, stream tokens per fused step, cancel
mid-decode, and read the client-observed latency summary — the port of
the JAX package's ``examples/serve_stream.py``.

Walks the open-loop request lifecycle end to end over the smoke model:

1. replay a deterministic prefix-heavy trace through `AsyncServeFrontend`
   and assert the streams are token-for-token identical to the same
   requests through the closed-batch `ServeEngine.serve`;
2. cancel one request mid-stream and assert its pages (and only its
   in-flight state) are freed — the pool returns to empty;
3. print the `serve.metrics` p50/p99 summary the front end collected.

    PYTHONPATH=src python -m repro_torch.examples.serve_stream --device cpu

``params`` (a flat state dict, e.g. carried from the JAX example's
weights by `repro_torch.convert.params_from_numpy`) replaces the seeded
weights.
"""
from __future__ import annotations

import asyncio

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.examples import check_device, parser
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.frontend import AsyncServeFrontend
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.traffic import MIXES, make_trace


def main(argv=None, *, params=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    check_device(args.device)
    cfg = smoke_config("starcoder2-7b")
    pool = PagedKVPool(page_tokens=8)
    eng = ServeEngine(cfg, params=params, kv_pool=pool, device=args.device)
    trace = make_trace(MIXES["prefix_heavy"].override(n_requests=6),
                       cfg.vocab_size)
    capacity = max(len(t.prompt) + t.max_new for t in trace)

    # closed-batch reference: same requests through ServeEngine.serve
    ref = eng.serve([Request(t.prompt.copy(), t.max_new) for t in trace],
                    max_active=2)

    async def stream_all():
        async with AsyncServeFrontend(eng, capacity=capacity,
                                      max_active=2) as front:
            handles = [await front.submit(Request(t.prompt.copy(),
                                                  t.max_new))
                       for t in trace]
            streamed = []
            for h in handles:
                toks = [tok async for tok in h]
                final = await h.result()
                assert toks == final.tolist()      # stream IS the result
                streamed.append(final)
            return streamed, front.metrics.summary()

    streamed, summary = asyncio.run(stream_all())
    for want, got in zip(ref, streamed):
        np.testing.assert_array_equal(want, got)
    shared_puts = pool.stats["shared_puts"]
    print(f"streamed == serve() for {len(trace)} requests "
          f"({sum(len(o) for o in streamed)} tokens, "
          f"shared_puts={shared_puts})")

    async def cancel_one():
        async with AsyncServeFrontend(eng, capacity=capacity,
                                      max_active=2) as front:
            keep = await front.submit(Request(trace[0].prompt.copy(),
                                              trace[0].max_new))
            drop = await front.submit(Request(trace[1].prompt.copy(),
                                              trace[1].max_new))
            got = 0
            async for _tok in drop:
                got += 1
                if got == 2:
                    drop.cancel()
                    break
            partial = await drop.result()
            full = await keep.result()
            return full, partial, drop.cancelled

    full, partial, cancelled = asyncio.run(cancel_one())
    assert cancelled and len(partial) == 2
    np.testing.assert_array_equal(full, ref[0])    # survivor unaffected
    assert len(pool.pages) == 0                    # cancelled pages freed
    print(f"cancelled after {len(partial)} tokens; survivor finished "
          f"{len(full)} tokens; live pages: {len(pool.pages)}")

    s = summary
    print(f"metrics: {s['n_done']} done, {s['tokens']} tokens, "
          f"{s['throughput_tok_s']:.1f} tok/s, "
          f"ttft p50 {s['ttft']['p50_ms']:.2f}ms "
          f"p99 {s['ttft']['p99_ms']:.2f}ms, "
          f"tpot p50 {s['tpot']['p50_ms']:.2f}ms")
    return {"trace": trace, "ref": ref, "streamed": streamed,
            "shared_puts": shared_puts, "cancelled": cancelled,
            "partial": partial, "survivor": full,
            "live_pages": len(pool.pages), "summary": summary,
            "engine": eng}


if __name__ == "__main__":
    main()
