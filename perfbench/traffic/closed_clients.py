"""Closed-loop clients over the program's serving front end.

Each of ``clients`` clients sends a request, reads its tokens as they
stream, and sends its next request when the last token has come: a
fixed concurrency, as batch inference and agent pipelines run it (vLLM's
``benchmark_serving --max-concurrency``). The entry is
``AsyncServeFrontend.submit`` over ``ServeEngine(decode_mode="fused")``
with a ``PagedKVPool`` of the mix's page size and a fast tier that holds
every active row; greedy tokens, no end-of-sequence token.

Sizes are the same for every seed, in the same order: prompt and output
lengths are evenly spaced over the mix's ranges, each block of
``clients`` requests a fixed permutation of them, and with ``shared``
heads each block holds every head its weight's share of times. So every
seed offers the same work; the seed draws the token ids (and the
weights). Before the window the clients' first requests
fill every row, their outputs cut to lengths spread evenly up to the
longest, so that requests end at a steady rate from the window's start;
with shared heads, one request per head first puts every head in the
prefix cache, as a deployment that has served them before holds them.

The window opens when every row holds its first token. Output tokens
delivered inside it make ``out_tok_s``; a request's time to first token
is taken from its send on the client's clock, its time per output token
between its first and last token. Once the window closes, in-flight
requests are cancelled, and a sample of the requests finished in the
window, drawn from the seed and holding the longest, is read against the
plain reference: every served token's logit below the reference's best
at its position (``logit_gap``).
"""
from __future__ import annotations

import asyncio
import gc
import math
import time

import numpy as np
import torch

from perfbench.lib import harness, program, spec, trace, work


class Rec:
    __slots__ = ("prompt", "max_new", "shared", "t_send", "times", "tokens",
                 "done", "failed")

    def __init__(self, prompt, max_new, shared):
        self.prompt, self.max_new, self.shared = prompt, max_new, shared
        self.t_send = time.perf_counter()
        self.times: list = []
        self.tokens = None
        self.done = False
        self.failed = False


def _grid(lo: int, hi: int, n: int) -> np.ndarray:
    return np.array([round(lo + (hi - lo) * (i + 0.5) / n) for i in range(n)])


class Requests:
    """The seeded request stream of a mix: `warm` (the first request of
    every client), `prime` (one per shared head) and `next()`."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.rng = np.random.default_rng([seed, 1])
        self.order = np.random.default_rng(0)
        self.vocab = vocab
        self.n = mix["clients"]
        sh = mix.get("shared")
        self.heads = [] if not sh else [
            self.rng.integers(0, vocab, sh["head_tokens"]).astype(np.int32)
            for _ in sh["weights"]]
        if sh:
            counts = [int(round(w * self.n)) for w in sh["weights"]]
            counts[0] += self.n - sum(counts)
            self.head_ids = np.repeat(np.arange(len(counts)), counts)
        self.block: list = []

    def _item(self, n_tokens: int, head: int, max_new: int):
        """(prompt, max_new, tokens of a shared head)."""
        tail = self.rng.integers(0, self.vocab, n_tokens).astype(np.int32)
        if head < 0:
            return tail, max_new, 0
        return (np.concatenate([self.heads[head], tail]), max_new,
                len(self.heads[head]))

    def _new_block(self, outputs):
        p = self.mix["prompt"]
        lens = self.order.permutation(_grid(p["lo"], p["hi"], self.n))
        outs = self.order.permutation(outputs)
        heads = self.order.permutation(self.head_ids) if self.heads \
            else [-1] * self.n
        return [self._item(int(n), int(h), int(o))
                for n, h, o in zip(lens, heads, outs)]

    def warm(self) -> list:
        """Every client's first request, outputs cut to lengths spread
        evenly from 1 to the longest."""
        return self._new_block(_grid(1, self.mix["output"]["hi"], self.n))

    def prime(self) -> list:
        lo = self.mix["prompt"]["lo"]
        return [self._item(lo, h, 1) for h in range(len(self.heads))]

    def next(self):
        if not self.block:
            o = self.mix["output"]
            self.block = self._new_block(_grid(o["lo"], o["hi"], self.n))
        return self.block.pop()


def _engine(ctx, cfg, weights, mix):
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kvcache import PagedKVPool
    t = mix["page_tokens"]
    head = mix["shared"]["head_tokens"] if mix.get("shared") else 0
    longest = head + mix["prompt"]["hi"] + mix["output"]["hi"]
    heads = len(mix["shared"]["weights"]) if mix.get("shared") else 0
    # the fast tier holds every active row and the shared heads, per layer
    fast = (mix["max_active"] * (math.ceil(longest / t) + 2)
            + heads * math.ceil(head / t)) * cfg.num_layers
    pool = PagedKVPool(page_tokens=t, fast_capacity_pages=fast)
    eng = ServeEngine(cfg, params=weights, kv_pool=pool, device=ctx.device,
                      decode_mode="fused")
    return eng, longest


async def _serve(ctx, eng, capacity, reqs, records, steps_ms, state):
    from repro_torch.serve.frontend import AsyncServeFrontend
    from repro_torch.serve.scheduler import Request
    mix = ctx.mix
    front = AsyncServeFrontend(eng, capacity=capacity,
                               max_active=mix["max_active"],
                               max_queue=mix["clients"])
    sess = front.session
    step = sess.step

    def timed_step():
        t0 = time.perf_counter()
        with program.span("bench.step", state["tracing"]):
            out = step()
        steps_ms.append((t0, (time.perf_counter() - t0) * 1e3))
        return out

    sess.step = timed_step
    live: dict = {}
    started: list = []

    async def one(prompt, max_new, shared):
        rec = Rec(prompt, max_new, shared)
        started.append(rec)
        h = await front.submit(Request(prompt, max_new_tokens=max_new))
        if h.rejected:
            rec.failed = True
            records.append(rec)
            return rec
        live[id(rec)] = h
        streamed = []
        try:
            async for tok in h:
                rec.times.append(time.perf_counter())
                streamed.append(tok)
            await h.result()
            # what the client was sent is what is judged
            rec.tokens = np.array(streamed, np.int64)
            rec.done = not h.cancelled and h.error_reason is None
            rec.failed = h.error_reason is not None
        finally:
            live.pop(id(rec), None)
        records.append(rec)
        return rec

    async def client(first):
        item = first
        while not state["stop"]:
            await one(*item)
            item = reqs.next()

    front.start()
    try:
        for item in reqs.prime():
            await one(*item)
        warm = reqs.warm()
        n0 = len(started)
        tasks = [asyncio.get_running_loop().create_task(client(w))
                 for w in warm]
        # the window opens once every row holds its first token
        while len(started) < n0 + len(warm) or \
                not all(r.times for r in started[n0:n0 + len(warm)]):
            await asyncio.sleep(0)
        prof = None
        if ctx.trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            state["tracing"] = True
            state["calls"].on = True
        window = program.span("bench.window", ctx.trace)
        window.__enter__()
        state["t0"] = t0 = time.perf_counter()
        state["setup_s"] = t0 - ctx.t_start
        while time.perf_counter() < t0 + ctx.seconds:
            await asyncio.sleep(min(0.05, t0 + ctx.seconds
                                    - time.perf_counter()))
        state["t1"] = time.perf_counter()
        window.__exit__(None, None, None)
        state["stop"] = True
        state["tracing"] = False
        if state["calls"] is not None:
            state["calls"].on = False
        state["hit_rate"] = sess.prefix_hit_rate
        for h in list(live.values()):
            h.cancel()
        await asyncio.gather(*tasks)
        if prof is not None:
            program.sync(ctx.device)
            prof.__exit__(None, None, None)
            state["prof"] = prof
    finally:
        for h in list(live.values()):
            h.cancel()
        await front.close()


def _gaps(ref, c, weights, sample, prec: str, device) -> list:
    """Per request, the widest gap between the reference's best logit and
    the logit of the token ranked first: the served token (``prec`` None)
    or the lower precision's own first choice."""
    seqs = [torch.from_numpy(np.concatenate([r.prompt, r.tokens[:-1]])
                             .astype(np.int64)).to(device) for r in sample]
    truth = ref.sequence_logits(c, weights, seqs, "fp32")
    other = ref.sequence_logits(c, weights, seqs, prec) if prec else None
    out = []
    for i, r in enumerate(sample):
        n0 = len(r.prompt) - 1
        rows = truth[i][n0:n0 + len(r.tokens)]
        if other is None:
            pick = torch.as_tensor(r.tokens, device=rows.device).long()
        else:
            pick = other[i][n0:n0 + len(r.tokens)].argmax(-1)
        gap = rows.max(-1).values - rows.gather(-1, pick[:, None])[:, 0]
        out.append(float(gap.max()))
    return out


def sample_finished(records, t0, t1, k: int, seed: int) -> list:
    done = [r for r in records if r.done and t0 <= r.times[-1] <= t1]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.prompt) + len(r.tokens))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 2])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def window_flops(c: dict, records, t0, t1) -> float:
    """Model FLOPs of the window by the configuration's formula: every
    output token delivered in it, and the prompt tokens outside a shared
    head of every request whose first token came in it."""
    tokens, ctx_sum = 0, 0
    for r in records:
        plen = len(r.prompt)
        for j, t in enumerate(r.times):
            if t0 <= t <= t1:
                tokens += 1
                ctx_sum += plen + j + 1
        if r.times and t0 <= r.times[0] <= t1:
            n = plen - r.shared
            tokens += n
            ctx_sum += sum(range(r.shared + 1, plen + 1))
    return work.forward_flops(c, tokens, ctx_sum)


def run(ctx) -> harness.Result:
    c, mix = ctx.config, ctx.mix
    cfg = program.model_config(c)
    ref = spec.reference_module(c["reference"])
    weights = ref.weights(c, ctx.seed, ctx.device)
    eng, capacity = _engine(ctx, cfg, weights, mix)
    reqs = Requests(mix, c["vocab_size"], ctx.seed)
    records, steps_ms = [], []
    calls = program.KernelCalls(
        {"paged_attention": program.paged_attention_args}) \
        if ctx.trace else None
    state = {"stop": False, "tracing": False, "calls": calls}
    if calls is None:
        asyncio.run(_serve(ctx, eng, capacity, reqs, records, steps_ms,
                           state))
    else:
        with calls:
            asyncio.run(_serve(ctx, eng, capacity, reqs, records,
                               steps_ms, state))
    t0, t1 = state["t0"], state["t1"]
    device = program.device_block(ctx.device)
    del eng
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    in_window = [t for r in records for t in r.times if t0 <= t <= t1]
    ttft = [(r.times[0] - r.t_send) * 1e3 for r in records
            if r.times and t0 <= r.times[0] <= t1]
    tpot = [(r.times[-1] - r.times[0]) / (len(r.times) - 1) * 1e3
            for r in records if r.done and len(r.times) > 1
            and t0 <= r.times[-1] <= t1]
    metrics = {"out_tok_s": len(in_window) / (t1 - t0),
               "ttft_p95_ms": work.p95(ttft),
               "tpot_p95_ms": work.p95(tpot),
               "setup_s": state["setup_s"]}
    record, breakdown = None, None
    if ctx.trace:
        tr = trace.reduce(state["prof"])
        steps = [ms for s, ms in steps_ms if t0 <= s <= t1]
        record = {"trace": tr, "steps_ms": steps,
                  "kind": device["kind"], "config": c,
                  "calls": calls.calls(),
                  "counters": {"prefix_hit_rate": state["hit_rate"]},
                  "flops": window_flops(c, records, t0, t1),
                  "window_s": t1 - t0, "tails": metrics}
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tr.breakdown()
        del state["prof"]
    sample = sample_finished(records, t0, t1, mix["sample"], ctx.seed)
    short = sum(len(r.tokens) != r.max_new for r in sample)
    gap = max(_gaps(ref, c, weights, sample, None, ctx.device)) \
        if sample else None
    lim = ctx.limits.get("logit_gap", {}).get("limit", 0.0)
    checks = [("logit_gap", gap, lim), ("short_answers", short, 0)]
    control = None
    if ctx.control and sample:
        control = {"logit_gap": max(_gaps(ref, c, weights, sample, "fp8",
                                          ctx.device))}
    # requests in flight at some time of the window
    live = [r for r in records if r.t_send <= t1
            and (not r.times or r.times[-1] >= t0)]
    attempted = len(live)
    failed = sum(r.failed for r in live)
    return harness.Result(attempted=attempted, failed=failed,
                          metrics=metrics, checks=checks, device=device,
                          record=record, breakdown=breakdown,
                          control=control)
