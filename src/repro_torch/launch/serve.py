"""Serving launcher on the port: batched generation, continuous batching,
the async front end and traffic replay with any paged ``--arch`` — the
counterpart of the JAX package's ``repro/launch/serve.py``. Runs on the
card unless ``--device cpu`` is given; ``--smoke`` takes the arch's
smoke config, else its published widths, with random weights from seed
0, as the reference.

    # continuous batching over a paged pool (chunked prefill + radix):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --smoke --paged --continuous --max-active 2

    # hybrid stacks (SSM / RG-LRU / sliding-window) through the same
    # paged step; the launcher prints the per-request paged-state budget:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --smoke --paged --continuous --max-active 2

    # speculative multi-token decode, n-gram drafts, 4-token verify steps:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --smoke --paged --speculate 4 --draft ngram

    # the async streaming front end (per-request p50/p99 summary):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --smoke --frontend --max-active 2

    # replay a named traffic mix (`serve.traffic.MIXES`, key=val overrides
    # after ':'), e.g. the overload mix with deadlines and priorities:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --smoke --paged --continuous --frontend --trace overload

Without ``--paged`` (or ``--continuous`` / ``--frontend`` / ``--trace``)
the reference decodes from dense caches; that path is not ported and
raises `NotImplementedError`, as do ``--sibyl`` / ``--sibyl-preempt``
(Sibyl, ROADMAP Queue 1 item 5), ``--mesh`` (multi-device serving, item
8) and ``--knee-cache`` (the knee cache's persistence, item 7).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import PagedKVPool


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="serve decode attention from a PagedKVPool")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (implies --paged)")
    ap.add_argument("--max-active", type=int, default=4,
                    help="decode rows for --continuous")
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--fast-pages", type=int, default=1024,
                    help="fast-tier capacity before LRU int8 demotion")
    ap.add_argument("--sibyl", action="store_true",
                    help="Sibyl DQN tier placement (not ported)")
    ap.add_argument("--decode-mode", default="fused",
                    choices=("fused", "eager", "numpy"),
                    help="fused = one step per token over the device pool "
                         "(the only mode ported)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decode: verify K-token runs per step "
                         "(requires --paged/--continuous; K <= "
                         "--page-tokens)")
    ap.add_argument("--draft", default="ngram",
                    help="draft proposer for --speculate: 'ngram' / "
                         "'ngram:N' (prompt-lookup, order N) or 'self'")
    ap.add_argument("--frontend", action="store_true",
                    help="stream the batch through the async front end "
                         "(implies --paged) and print the per-request "
                         "latency summary")
    ap.add_argument("--trace", default=None, metavar="SPEC",
                    help="replay a traffic mix through the async front end "
                         "(implies --frontend): a name from "
                         "repro_torch.serve.traffic.MIXES plus key=val "
                         "overrides, e.g. 'overload:n_requests=32'")
    ap.add_argument("--max-queue", type=int, default=16,
                    help="front-end waiting-line bound: submissions past "
                         "it are rejected (reason queue_full), not blocked")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serving mesh 'data x model' (not ported)")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="prefill prompts in one pass at admission instead "
                         "of streaming page-sized chunks through the steps")
    ap.add_argument("--prefill-budget", type=int, default=1, metavar="N",
                    help="chunk rows that may ride one step (default 1)")
    ap.add_argument("--no-radix", action="store_true",
                    help="disable the radix prefix cache")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable SLO-aware preemption: more-urgent "
                         "arrivals wait for rows instead of parking "
                         "eligible active requests on the host tier")
    ap.add_argument("--sibyl-preempt", action="store_true",
                    help="rank preemption victims with the Sibyl DQN "
                         "(not ported)")
    ap.add_argument("--knee-cache", default=None, metavar="PATH",
                    help="JSON cache of backend='auto' knee points "
                         "(not ported)")
    return ap


def _refuse_unported(args):
    if args.sibyl or args.sibyl_preempt:
        raise NotImplementedError(
            "Sibyl placement and preemption are not ported (ROADMAP Queue 1 "
            "item 5)")
    if args.mesh:
        raise NotImplementedError(
            "mesh serving is not ported (ROADMAP Queue 1 item 8)")
    if args.knee_cache:
        raise NotImplementedError(
            "the knee cache's persistence is not ported (ROADMAP Queue 1 "
            "item 7)")


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.external_embed:
        raise SystemExit(f"{args.arch} takes frame embeddings, not tokens")
    if args.trace:
        args.frontend = True
    if args.frontend:
        args.paged = True
    pool = None
    if args.paged or args.continuous:
        pool = PagedKVPool(page_tokens=args.page_tokens,
                           fast_capacity_pages=args.fast_pages)
    if args.speculate > 1 and pool is None:
        raise SystemExit("--speculate needs --paged or --continuous")
    eng = ServeEngine(cfg, kv_pool=pool, device=args.device,
                      decode_mode=args.decode_mode,
                      speculate=args.speculate, draft=args.draft)
    if pool is not None:
        # per-request paged-state budget for this arch at the launch shape
        lay = eng.layout
        cap = args.prompt_len + args.new_tokens
        print(f"paged state: {lay.n_kv} kv/ring layers "
              f"({lay.pages_needed(cap)} pages per request"
              f"{' — ring-bounded at O(window)' if lay.has_ring else ''}"
              f"), {lay.n_ssd + lay.n_rg} recurrent layers")
    if args.frontend:
        return _run_frontend(args, cfg, eng, pool)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab_size, size=args.prompt_len)
                    .astype(np.int32), args.new_tokens)
            for _ in range(args.batch)]
    t0 = time.time()
    if args.continuous:
        outs = eng.serve(reqs, max_active=args.max_active,
                         chunked_prefill=False
                         if args.no_chunked_prefill else None,
                         prefill_budget=args.prefill_budget,
                         radix=False if args.no_radix else None,
                         preempt=not args.no_preempt)
    else:
        outs = eng.generate(reqs, free_pages=True)
    dt = time.time() - t0
    tok = sum(len(o) for o in outs if o is not None)
    print(f"generated {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s); first row: {outs[0][:8]}")
    if args.speculate > 1:
        for i, d in enumerate(eng.last_request_stats):
            rate = "n/a" if d["accept_rate"] is None \
                else f"{d['accept_rate']:.2f}"
            print(f"req {i}: {d['tokens']} tokens in {d['steps']} verify "
                  f"steps ({d['tokens_per_step']:.2f} tok/step, "
                  f"accept_rate={rate})")
    print(f"kv pool: {pool.stats} live_pages={len(pool.pages)}")
    return {"outs": outs, "pool": dict(pool.stats)}


def _print_summary(summary: dict) -> None:
    def ms(d):
        return "n/a" if d["p50_ms"] is None else \
            f"p50 {d['p50_ms']:.2f}ms  p99 {d['p99_ms']:.2f}ms"
    print(f"requests: {summary['n_done']} done, "
          f"{summary['n_cancelled']} cancelled, "
          f"{summary['n_rejected']} rejected, "
          f"{summary.get('n_errors', 0)} errors")
    if summary.get("slo_attainment") is not None:
        print(f"slo attainment: {summary['slo_attainment']:.2f} "
              f"({summary['deadline_misses']} misses)")
    if summary.get("preemptions"):
        rw = summary["resume_wait"]
        wait = "n/a" if rw["p50_ms"] is None else \
            f"p50 {rw['p50_ms']:.2f}ms p99 {rw['p99_ms']:.2f}ms"
        print(f"preemptions: {summary['preemptions']} "
              f"({summary.get('n_resumed', 0)} resumed, "
              f"swap out {summary.get('swap_out_bytes', 0)}B / "
              f"in {summary.get('swap_in_bytes', 0)}B, "
              f"resume wait {wait})")
    rate = summary["throughput_tok_s"]
    print(f"tokens: {summary['tokens']} in {summary['wall_s']:.2f}s "
          f"({'n/a' if rate is None else f'{rate:.1f}'} tok/s)")
    print(f"queue wait: {ms(summary['queue_wait'])}")
    print(f"ttft:       {ms(summary['ttft'])}")
    print(f"per-token:  {ms(summary['tpot'])}")
    if summary.get("accept_rate") is not None:
        print(f"accept rate: {summary['accept_rate']:.2f}")
    for key in ("mix", "peak_active", "peak_live_pages",
                "pool_shared_puts", "decode_steps"):
        if key in summary:
            print(f"{key}: {summary[key]}")


def _run_frontend(args, cfg, eng, pool) -> dict:
    """Serve through `AsyncServeFrontend` — a named traffic mix when
    --trace is given, else the launcher's own synthetic batch — and
    print the `serve.metrics` p50/p99 summary."""
    import asyncio

    from repro_torch.serve.frontend import AsyncServeFrontend
    from repro_torch.serve.traffic import parse_spec, run_trace

    chunked = False if args.no_chunked_prefill else None
    radix = False if args.no_radix else None
    if args.trace:
        summary = run_trace(eng, parse_spec(args.trace),
                            max_active=args.max_active,
                            max_queue=args.max_queue,
                            chunked_prefill=chunked,
                            prefill_budget=args.prefill_budget,
                            radix=radix, preempt=not args.no_preempt)
        _print_summary(summary)
        print(f"kv pool: {pool.stats} live_pages={len(pool.pages)}")
        return {"summary": summary, "pool": dict(pool.stats)}

    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab_size, size=args.prompt_len)
                    .astype(np.int32), args.new_tokens)
            for _ in range(args.batch)]

    async def go():
        async with AsyncServeFrontend(
                eng, capacity=args.prompt_len + args.new_tokens,
                max_active=args.max_active, max_queue=args.max_queue,
                speculate=args.speculate or None, chunked_prefill=chunked,
                prefill_budget=args.prefill_budget, radix=radix,
                preempt=not args.no_preempt) as front:
            handles = [await front.submit(r) for r in reqs]
            outs = [await h.result() for h in handles]
            return front.metrics.summary(), outs

    summary, outs = asyncio.run(go())
    _print_summary(summary)
    print(f"first row: {outs[0][:8]}")
    print(f"kv pool: {pool.stats} live_pages={len(pool.pages)}")
    return {"summary": summary, "outs": outs, "pool": dict(pool.stats)}


if __name__ == "__main__":
    main()
