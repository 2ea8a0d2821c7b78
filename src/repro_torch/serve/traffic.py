"""Trace-driven open-loop traffic: reproducible synthetic request traces
replayed against the async streaming front end — the JAX package's
``repro/serve/traffic.py`` over the port's front end (the port imports
nothing of that package; `make_trace` draws the same numpy stream, so a
spec expands to the same trace on both).

The thesis' data-driven argument, applied to serving: let observed
traffic characteristics — arrival process, prompt/output length mixes,
prefix reuse — drive system measurement and decisions, instead of
closed-loop batch benchmarks that hide queueing. A `TraceSpec` pins a
mix (Poisson arrivals, mixed prompt/output length distributions,
prefix-heavy shares exercising the pool's ref-counted prefix cache,
optional speculative k, a cancellation fraction); `make_trace` expands
it into a deterministic request list (same seed -> bitwise-identical
trace); `replay`/`run_trace` push it through `AsyncServeFrontend` at the
trace's own arrival times (open loop: arrivals do not wait for
completions) and report the `serve.metrics` summary plus pool-side
checks (peak occupancy, prefix sharing, zero pages leaked by
cancellations).

`MIXES` names the reference's standing mixes, and `parse_spec` lets the
serve launcher replay one from the CLI:
``--trace prefix_heavy:n_requests=32,arrival_rate=100``.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serve.frontend import AsyncServeFrontend
from repro_torch.serve.metrics import MetricsRegistry, percentile
from repro_torch.serve.scheduler import Request


@dataclasses.dataclass
class TraceSpec:
    """A reproducible synthetic traffic mix (all randomness seeded)."""
    name: str = "uniform"
    n_requests: int = 12
    arrival_rate: float = 40.0        # Poisson arrivals per second
    prompt_lens: tuple = (8, 16, 24)  # sampled uniformly per request
    new_tokens: tuple = (4, 8)        # decode budget, sampled per request
    prefix_fraction: float = 0.0      # share of requests with a common head
    prefix_len: int = 0               # tokens of shared head (page-align it)
    speculate: int = 0                # per-request k for the whole mix
    cancel_fraction: float = 0.0      # share cancelled mid-stream
    cancel_after: int = 2             # tokens consumed before cancelling
    deadlines: tuple = ()             # SLO budgets (s), sampled; () = none
    priorities: tuple = (0,)          # sampled per request (higher wins)
    seed: int = 0

    def override(self, **kv) -> "TraceSpec":
        return dataclasses.replace(self, **kv)


@dataclasses.dataclass
class TraceItem:
    arrival_s: float
    prompt: np.ndarray
    max_new: int
    speculate: Optional[int]
    cancel_after: Optional[int]       # None -> runs to completion
    deadline: Optional[float] = None  # SLO budget in seconds from submit
    priority: int = 0


# Standing mixes (the reference's, unchanged): uniform, prefix-heavy,
# speculative, chunked, overload, hybrid. Sized for the smoke shape —
# scale n/rate/lengths up from the CLI for real measurements.
MIXES = {
    "uniform": TraceSpec(name="uniform", n_requests=12, arrival_rate=40.0,
                         prompt_lens=(8, 16, 24), new_tokens=(4, 8),
                         cancel_fraction=0.25, seed=0),
    "prefix_heavy": TraceSpec(name="prefix_heavy", n_requests=12,
                              arrival_rate=40.0, prompt_lens=(8, 16),
                              new_tokens=(4, 8), prefix_fraction=0.75,
                              prefix_len=16, cancel_fraction=0.0, seed=1),
    "speculative": TraceSpec(name="speculative", n_requests=8,
                             arrival_rate=40.0, prompt_lens=(16, 24),
                             new_tokens=(8,), speculate=4, seed=2),
    # long prompts + heavy prefix reuse: exercises chunked prefill (the
    # suffix streams page-by-page through wide fused steps while earlier
    # requests decode) and radix adoption across retired requests
    "chunked": TraceSpec(name="chunked", n_requests=8, arrival_rate=60.0,
                         prompt_lens=(64, 48), new_tokens=(4, 8),
                         prefix_fraction=0.5, prefix_len=32, seed=3),
    # sustained overload: arrivals far outpace the service rate with
    # mixed deadlines and priorities, so the SLO-aware path must preempt
    # (swap rows to the host tier for more urgent arrivals) and shed
    # (deadline_infeasible) instead of letting the queue grow without
    # bound — every request still terminates with a structured outcome
    # (arrivals must interleave with decode for preemption to matter: an
    # instantaneous burst just gets urgency-sorted at the first admit, so
    # the rate is set near the warm service rate, not far above it)
    "overload": TraceSpec(name="overload", n_requests=16,
                          arrival_rate=120.0, prompt_lens=(8, 16),
                          new_tokens=(16, 24), deadlines=(0.05, 2.0, 30.0),
                          priorities=(0, 1), seed=6),
    # hybrid-model mix (SSM / RG-LRU / sliding-window stacks served
    # through the paged-state protocol), with prompts long enough that a
    # ring layer wraps its window and recycles pages mid-decode
    "hybrid": TraceSpec(name="hybrid", n_requests=10, arrival_rate=60.0,
                        prompt_lens=(24, 40, 56), new_tokens=(8, 12),
                        cancel_fraction=0.2, seed=7),
}


def make_trace(spec: TraceSpec, vocab_size: int) -> list[TraceItem]:
    """Expand a spec into a deterministic open-loop trace. Prefix-heavy
    requests share `prefix_len` leading tokens (one common head per
    trace) and diverge after — with `prefix_len` a multiple of the
    pool's page size, their prefill pages dedup via the content-hash
    prefix cache."""
    rng = np.random.default_rng(spec.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / spec.arrival_rate,
                                         spec.n_requests))
    prefix = rng.integers(0, vocab_size, spec.prefix_len).astype(np.int32) \
        if spec.prefix_len else None
    items = []
    for i in range(spec.n_requests):
        plen = int(rng.choice(spec.prompt_lens))
        shared = (prefix is not None
                  and rng.random() < spec.prefix_fraction)
        if shared:
            tail = rng.integers(0, vocab_size,
                                max(1, plen - spec.prefix_len))
            prompt = np.concatenate([prefix, tail.astype(np.int32)])
        else:
            prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        cancel = spec.cancel_after \
            if rng.random() < spec.cancel_fraction else None
        items.append(TraceItem(
            arrival_s=float(arrivals[i]), prompt=prompt,
            max_new=int(rng.choice(spec.new_tokens)),
            speculate=spec.speculate if spec.speculate > 1 else None,
            cancel_after=cancel,
            deadline=(float(rng.choice(spec.deadlines))
                      if spec.deadlines else None),
            priority=int(rng.choice(spec.priorities))))
    return items


def trace_capacity(trace: list[TraceItem]) -> int:
    """Tokens of KV the longest request spans — the session capacity."""
    return max(len(it.prompt) + it.max_new for it in trace)


async def replay(engine, spec: TraceSpec, *, max_active: int = 4,
                 max_queue: int = 16, seed: int = 0,
                 chunked_prefill: Optional[bool] = None,
                 prefill_budget: int = 1,
                 radix: Optional[bool] = None,
                 preempt: bool = True, preempt_policy=None) -> dict:
    """Replay a trace open-loop against a fresh front end over `engine`.

    Each request is submitted at its trace arrival time (not when a row
    frees — queueing is part of the measurement) and consumed by its own
    task; items with `cancel_after` cancel mid-stream. Returns the
    metrics summary extended with scheduler/pool-side results."""
    trace = make_trace(spec, engine.cfg.vocab_size)
    metrics = MetricsRegistry()
    pool = engine.kv_pool
    front = AsyncServeFrontend(
        engine, capacity=trace_capacity(trace), max_active=max_active,
        max_queue=max_queue, speculate=max(1, spec.speculate), seed=seed,
        metrics=metrics, chunked_prefill=chunked_prefill,
        prefill_budget=prefill_budget, radix=radix, preempt=preempt,
        preempt_policy=preempt_policy)
    n_cancelled = 0

    async def consume(item: TraceItem, handle):
        nonlocal n_cancelled
        if handle.rejected:
            return
        n = 0
        async for _tok in handle:
            n += 1
            if item.cancel_after is not None and n >= item.cancel_after:
                if handle.cancel():
                    n_cancelled += 1
                break
        await handle.result()

    async with front:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        tasks = []
        for item in trace:
            delay = t0 + item.arrival_s - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            handle = await front.submit(
                Request(item.prompt.copy(), item.max_new,
                        speculate=item.speculate,
                        deadline=item.deadline, priority=item.priority))
            tasks.append(asyncio.create_task(consume(item, handle)))
        await asyncio.gather(*tasks)

    out = metrics.summary()
    out["mix"] = spec.name
    out["n_trace"] = len(trace)
    out["peak_active"] = front.session.sched.peak_active
    out["peak_live_pages"] = front.session.peak_live_pages
    out["pool_live_pages_end"] = pool.live_pages
    out["pool_shared_puts"] = pool.stats.get("shared_puts", 0)
    out["pool_adopted_pages"] = pool.stats.get("adopted_pages", 0)
    # radix prefix cache: pages adopted / adoptable prompt pages across
    # the chunked admissions (None when the mix never chunk-prefilled)
    out["prefix_hit_rate"] = front.session.prefix_hit_rate
    # per-token wall time of decode steps that shared their fused launch
    # with a prefill chunk — "decode p99 while a long prompt admits"
    ms = front.session.prefill_step_decode_ms
    out["decode_p99_during_prefill_ms"] = percentile(ms, 99) if ms else None
    # cancellation correctness: every cancelled (and finished) request's
    # pages must be freed — anything still live leaked
    out["cancelled_pages_freed"] = pool.live_pages == 0
    out["decode_steps"] = front.session.steps
    # overload-control outcomes: preempt/resume counts from the session,
    # swap volume from the pool's tier stats
    out["n_resumed"] = front.session.resumes
    out["swap_out_bytes"] = pool.stats.get("swap_out_bytes", 0)
    out["swap_in_bytes"] = pool.stats.get("swap_in_bytes", 0)
    return out


def run_trace(engine, spec: TraceSpec, *, max_active: int = 4,
              max_queue: int = 16, seed: int = 0,
              chunked_prefill: Optional[bool] = None,
              prefill_budget: int = 1, radix: Optional[bool] = None,
              preempt: bool = True, preempt_policy=None) -> dict:
    """Synchronous wrapper: replay one mix and return its summary."""
    return asyncio.run(replay(engine, spec, max_active=max_active,
                              max_queue=max_queue, seed=seed,
                              chunked_prefill=chunked_prefill,
                              prefill_budget=prefill_budget, radix=radix,
                              preempt=preempt,
                              preempt_policy=preempt_policy))


def parse_spec(arg: str) -> TraceSpec:
    """Parse a CLI trace spec: ``name[:key=val,...]`` where name is a
    `MIXES` entry and keys override `TraceSpec` fields, e.g.
    ``uniform:n_requests=32,arrival_rate=100,cancel_fraction=0.1``."""
    name, _, rest = arg.partition(":")
    if name not in MIXES:
        raise ValueError(f"unknown trace mix {name!r}; choose from "
                         f"{sorted(MIXES)}")
    spec = MIXES[name]
    if not rest:
        return spec
    kv = {}
    fields = {f.name: f.type for f in dataclasses.fields(TraceSpec)}
    for part in rest.split(","):
        key, _, val = part.partition("=")
        if key not in fields:
            raise ValueError(f"unknown TraceSpec field {key!r} in {arg!r}")
        cur = getattr(spec, key)
        if isinstance(cur, tuple):
            # deadline tuples carry fractional seconds; length/priority
            # tuples stay ints
            kv[key] = tuple(float(x) if "." in x else int(x)
                            for x in val.split("+"))
        elif isinstance(cur, float):
            kv[key] = float(val)
        elif isinstance(cur, int):
            kv[key] = int(val)
        else:
            kv[key] = val
    return spec.override(**kv)
