"""Serving engine over one model — the port of ``repro/serve/engine.py``
for paged, fused, one-token decode.

- `generate` — static lockstep batch: prefill the (left-padded) prompts,
  write their K/V into the `PagedKVPool`, then decode every row in
  lockstep through the fused step (`serve.paged_decode.build_fused_step`).
- `serve` — continuous batching over a `ServeSession`: a `Scheduler`
  admits requests into free decode rows mid-flight (admission gated on
  pool headroom), each admission prefills its prompt in one pass, each
  row decodes at its own position, and retiring (per-request
  ``max_new_tokens`` or ``eos_token``) frees the request's pages.

Greedy decoding is argmax; temperature sampling draws from a
``torch.Generator`` seeded with ``seed``. Speculative verify, chunked
prefill, the radix prefix cache, preemption and mesh sharding are later
slices: the arguments that ask for them raise `NotImplementedError`.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import Model
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.paged_decode import (PagedKVState, build_fused_step,
                                            extract_prefill_pages, sample)
from repro_torch.serve.paged_state import StateLayout
from repro_torch.serve.scheduler import (Admission, Request, Scheduler,
                                         effective_speculate,
                                         prefix_page_hashes)
from repro_torch.serve.steps import prefill_all_positions

__all__ = ["Admission", "Request", "ServeEngine", "ServeSession"]


class SpecStats:
    """Per-request accounting in the reference's format. Without
    speculative decoding every step emits one token and ``proposed`` /
    ``accepted`` stay 0."""

    __slots__ = ("steps", "proposed", "accepted", "tokens")

    def __init__(self):
        self.steps = 0
        self.proposed = 0
        self.accepted = 0
        self.tokens = 0

    def as_dict(self) -> dict:
        return {"tokens": self.tokens, "steps": self.steps,
                "tokens_per_step": self.tokens / self.steps
                if self.steps else 0.0,
                "proposed": self.proposed, "accepted": self.accepted,
                "accept_rate": self.accepted / self.proposed
                if self.proposed else None}


def _check_request(req: Request):
    if effective_speculate(req) > 1:
        raise NotImplementedError("speculative decode (Request.speculate > 1)"
                                  " is not ported")
    if req.deadline is not None or req.priority != 0:
        raise NotImplementedError("deadlines and priorities (SLO shedding, "
                                  "preemption) are not ported")


class ServeEngine:
    """Engine over one model. ``params`` is a flat state dict (e.g. from
    `repro_torch.convert.params_from_numpy`); without it the weights are
    drawn from ``seed`` on ``device``. ``backend`` picks the paged
    attention implementation (`repro_torch.kernels.api.run`)."""

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None,
                 seed: int = 0, kv_pool: Optional[PagedKVPool] = None,
                 device="cuda", backend: str = "auto",
                 decode_mode: Optional[str] = None, speculate: int = 0,
                 mesh=None):
        if decode_mode not in (None, "fused"):
            raise NotImplementedError(f"decode_mode={decode_mode!r}: only "
                                      f"the fused step is ported")
        if speculate > 1:
            raise NotImplementedError("speculative decode is not ported")
        if mesh is not None:
            raise NotImplementedError("mesh-sharded serving is not ported")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = Model(cfg, device=self.device, seed=seed, state=params)
        self.kv_pool = kv_pool
        self.backend = backend
        self.layout = StateLayout(cfg, kv_pool.page_tokens) \
            if kv_pool is not None else None
        self._next_seq = 0           # pool seq ids are engine-lifetime unique
        self._fused_cache: dict = {}
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0,
                      "decode_steps": 0}
        self.last_request_stats: list[dict] = []

    def _require_paged(self):
        if self.kv_pool is None:
            raise NotImplementedError("the dense-cache serving path is not "
                                      "ported — construct the engine with "
                                      "kv_pool=")

    def _new_state(self, capacity: int, batch_hint: int) -> PagedKVState:
        cfg = self.cfg
        return PagedKVState(self.kv_pool, capacity, self.layout,
                            cfg.num_kv_heads, cfg.head_dim,
                            batch_hint=batch_hint, device=self.device)

    def _fused_step_fn(self, slots: int, greedy: bool, temperature: float):
        key = (slots, greedy, float(temperature))
        fn = self._fused_cache.get(key)
        if fn is None:
            fn = build_fused_step(self.model, slots, backend=self.backend,
                                  greedy=greedy, temperature=temperature)
            self._fused_cache[key] = fn
        return fn

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    # Static lockstep batch
    # ------------------------------------------------------------------
    def generate(self, requests: list[Request], greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 free_pages: bool = False) -> list[np.ndarray]:
        """Static lockstep decode. Per-request ``eos_token`` truncates the
        returned tokens (eos inclusive); the lockstep batch still decodes
        ``max_new_tokens`` steps. The batch's pages stay live after the
        call unless ``free_pages=True``."""
        self._require_paged()
        for r in requests:
            _check_request(r)
        b = len(requests)
        plen = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        prompts = np.zeros((b, plen), np.int32)
        for i, r in enumerate(requests):
            prompts[i, plen - len(r.prompt):] = r.prompt   # left-pad

        t0 = time.perf_counter()
        logits, caches = self.model.forward_prefill(
            torch.from_numpy(prompts).to(self.device))
        seq_ids = list(range(self._next_seq, self._next_seq + b))
        self._next_seq += b
        state = self._new_state(plen + max_new, batch_hint=b)
        extract_prefill_pages(self.model, caches, state, seq_ids)
        self.stats["prefill_s"] += time.perf_counter() - t0

        gen = self._generator(seed)
        tok = sample(logits, greedy, temperature, gen)
        outs = [[int(x)] for x in tok.cpu().numpy()]
        observe = getattr(self.kv_pool.policy, "observe", None)
        step_fn = self._fused_step_fn(state.slots, greedy, temperature)
        t0 = time.perf_counter()
        for step in range(max_new - 1):
            hits0 = (self.kv_pool.stats["fast_hits"],
                     self.kv_pool.stats["slow_hits"])
            g0 = state.gather_s
            # steady state: one control upload, one token download — `tok`
            # stays on the device
            tok_host, tok = state.run_fused(step_fn, tok, seq_ids,
                                            plen + step, gen)
            if observe is not None:
                observe(state.gather_s - g0,
                        self.kv_pool.stats["fast_hits"] - hits0[0],
                        self.kv_pool.stats["slow_hits"] - hits0[1])
            for i in range(b):
                outs[i].append(int(tok_host[i]))
            self.stats["decode_steps"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        self.last_transfers = state.transfer_counts()
        if free_pages:
            for seq in seq_ids:
                state.free_seq(seq)

        def trim(o, r):
            o = o[:r.max_new_tokens]
            if r.eos_token is not None and r.eos_token in o:
                o = o[:o.index(r.eos_token) + 1]   # eos inclusive, as serve
            return np.array(o)

        results = [trim(o, r) for o, r in zip(outs, requests)]
        self.stats["tokens"] += sum(len(o) for o in results)
        self.last_request_stats = []
        for res in results:
            st = SpecStats()
            st.steps = max(1, max_new - 1)
            st.tokens = max(0, len(res) - 1)
            d = st.as_dict()
            d["tokens"] = len(res)          # eos-trimmed, prefill token incl.
            self.last_request_stats.append(d)
        return results

    # ------------------------------------------------------------------
    # Continuous batching
    # ------------------------------------------------------------------
    def serve(self, requests: list[Request], max_active: int = 4,
              greedy: bool = True, temperature: float = 1.0, seed: int = 0,
              prefix_cache: bool = True,
              chunked_prefill: Optional[bool] = None,
              radix: Optional[bool] = None,
              preempt: bool = False) -> list[Optional[np.ndarray]]:
        """Continuous-batching decode: requests join free rows mid-flight
        and retire at their own lengths; finished requests' pages are
        freed. Returns outputs in submission order; a request that can
        never fit is rejected (its slot is None, its `Admission` verdict
        in ``last_rejections``). Prompts prefill in one pass at admission
        (``prefix_cache`` dedups identical prompt pages by content hash)."""
        if chunked_prefill or radix or preempt:
            raise NotImplementedError("chunked prefill, the radix prefix "
                                      "cache and preemption are not ported")
        if not requests:
            self.last_rejections = []
            return []
        if len({id(r) for r in requests}) != len(requests):
            raise ValueError("duplicate Request objects in one serve() call")
        cap = max(len(r.prompt) + r.max_new_tokens for r in requests)
        session = ServeSession(self, capacity=cap, max_active=max_active,
                               greedy=greedy, temperature=temperature,
                               seed=seed, prefix_cache=prefix_cache)
        self.last_rejections = []
        for r in requests:
            verdict = session.submit(r)
            self.last_rejections.append(None if verdict else verdict)
        while not session.done:
            session.step()
        self.last_peak_active = session.sched.peak_active
        self.last_transfers = session.state.transfer_counts()
        self.last_steady_transfers = list(session.steady_transfers)
        self.last_request_stats = [session.request_stats(r)
                                   for r in requests]
        return [session.result(r) for r in requests]


# ---------------------------------------------------------------------------
# Step-granular continuous batching
# ---------------------------------------------------------------------------
class _Active:
    """One occupied decode row of the continuous batch."""

    __slots__ = ("req", "seq", "plen", "outs", "stats")

    def __init__(self, req: Request, seq: int, plen: int):
        self.req, self.seq, self.plen = req, seq, plen
        self.outs: list[int] = []
        self.stats = SpecStats()

    @property
    def pos(self) -> int:
        """Absolute position of the token being fed this step."""
        return self.plen + len(self.outs) - 1

    @property
    def finished(self) -> bool:
        return (len(self.outs) >= self.req.max_new_tokens
                or self.outs[-1] == self.req.eos_token)


class StreamEvent:
    """Per-request outcome of one `ServeSession.step`: the tokens the
    request emitted this step (the admission prefill token included) and
    whether it just finished."""

    __slots__ = ("request", "tokens", "done")

    def __init__(self, request: Request, tokens: list, done: bool = False):
        self.request, self.tokens, self.done = request, tokens, done


class _SessionRec:
    """One request's lifecycle record inside a `ServeSession`."""

    __slots__ = ("req", "status", "active", "row", "result", "stats")

    def __init__(self, req: Request):
        self.req = req
        self.status = "waiting"          # waiting | active | done | rejected
        self.active: Optional[_Active] = None
        self.row = -1
        self.result: Optional[np.ndarray] = None
        self.stats: Optional[dict] = None


class ServeSession:
    """Resumable, step-granular continuous-batching loop: ``submit``
    queues a request and returns its `Admission` verdict, ``step`` runs
    one admission round plus one fused decode step over the live rows and
    returns per-request `StreamEvent`s. ``capacity`` (in tokens) sizes the
    page table for the session's lifetime — a longer request is rejected
    with reason ``capacity``.

    ``steady_transfers`` lists the (host->device, device->host) transfers
    of every step that fed its tokens back on the device and neither
    synced nor read back a page: the steady state, one control upload and
    one token download."""

    def __init__(self, engine: ServeEngine, capacity: int,
                 max_active: int = 4, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 prefix_cache: bool = True):
        engine._require_paged()
        self.engine = engine
        self.pool = engine.kv_pool
        self.capacity = int(capacity)
        self.max_active = max_active
        self.greedy, self.temperature = greedy, float(temperature)
        self.prefix_cache = prefix_cache
        self.sched = Scheduler(self.pool, engine.layout,
                               max_active=max_active)
        self.state = engine._new_state(self.capacity, batch_hint=max_active)
        self._rows: list[Optional[_Active]] = [None] * max_active
        self._recs: dict[int, _SessionRec] = {}
        self._gen = engine._generator(seed)
        self._observe = getattr(self.pool.policy, "observe", None)
        self._step_fn = engine._fused_step_fn(self.state.slots, greedy,
                                              temperature)
        self._tok_dev = None      # device-resident (max_active,) last tokens
        self._rows_dirty = True   # host-known token entered/left a row
        self.steps = 0
        self.steady_transfers: list[tuple[int, int]] = []

    @property
    def done(self) -> bool:
        """True when nothing is waiting and no decode row is occupied."""
        return self.sched.done

    def submit(self, req: Request) -> Admission:
        """Queue a request (FIFO). Returns the structured admission
        verdict; on rejection the request is fully accounted (result
        ``None``, stats carry the reason) but never does work."""
        _check_request(req)
        if id(req) in self._recs:
            raise ValueError("Request object already submitted to this "
                             "session")
        t = self.pool.page_tokens
        need_tokens = len(req.prompt) + req.max_new_tokens
        pages = -(-need_tokens // t)
        if pages + 1 > self.state.slots:
            verdict = Admission(
                False, reason="capacity",
                pages_needed=self.engine.layout.pages_needed(need_tokens),
                pages_budget=self.sched._budget(),
                detail=f"request spans {need_tokens} KV tokens = {pages} "
                       f"pages + 1 tail slot, beyond the session page table "
                       f"of {self.state.slots} slots "
                       f"({self.state.slots * t} tokens); raise the session "
                       f"capacity")
        else:
            verdict = self.sched.submit(req)
        rec = _SessionRec(req)
        self._recs[id(req)] = rec
        if not verdict:
            rec.status = "rejected"
            rec.stats = {"rejected": verdict.reason, "tokens": 0,
                         **verdict.as_dict()}
        return verdict

    def result(self, req: Request) -> Optional[np.ndarray]:
        """Final output tokens; None while the request is queued or
        decoding, and None forever if rejected."""
        rec = self._recs.get(id(req))
        return None if rec is None else rec.result

    def request_stats(self, req: Request) -> Optional[dict]:
        rec = self._recs.get(id(req))
        return None if rec is None else rec.stats

    def _finish(self, rec: _SessionRec):
        act = rec.active
        self.state.free_seq(act.seq)
        self._rows[rec.row] = None
        self.sched.retire(rec.req)
        rec.status = "done"
        rec.active = None
        rec.result = np.array(act.outs[:rec.req.max_new_tokens], np.int64)
        d = act.stats.as_dict()
        d["tokens"] = len(rec.result)   # eos-trimmed, prefill token incl.
        rec.stats = d

    def _admit(self, events: list):
        eng = self.engine
        t = self.pool.page_tokens
        while True:
            # loop: an admitted request finishing at its very first token
            # frees its row + reservation, unblocking the queue head again
            batch = self.sched.admit()
            if not batch:
                return
            for req in batch:
                rec = self._recs[id(req)]
                seq = eng._next_seq
                eng._next_seq += 1
                row_i = self._rows.index(None)
                toks = np.asarray(req.prompt, np.int32)
                act = _Active(req, seq, len(toks))
                t0 = time.perf_counter()
                logits_all, caches = prefill_all_positions(
                    eng.model, torch.from_numpy(toks[None]).to(eng.device))
                hashes = [prefix_page_hashes(toks, t)] \
                    if self.prefix_cache else None
                extract_prefill_pages(eng.model, caches, self.state, [seq],
                                      page_hashes=hashes)
                eng.stats["prefill_s"] += time.perf_counter() - t0
                tok = int(sample(logits_all[:, len(toks) - 1], self.greedy,
                                 self.temperature, self._gen)[0])
                eng.stats["tokens"] += 1
                act.outs.append(tok)
                self._rows[row_i] = act
                rec.active, rec.row, rec.status = act, row_i, "active"
                self._rows_dirty = True
                done = act.finished
                if done:
                    self._finish(rec)
                events.append(StreamEvent(req, [tok], done=done))

    def step(self) -> list[StreamEvent]:
        """One admission round + one decode step over the live rows.
        Returns the per-request token events (admission prefill tokens
        included); an idle session returns an empty list."""
        events: list[StreamEvent] = []
        self._admit(events)
        rows = self._rows
        if all(a is None for a in rows):
            if not self.sched.done:   # unreachable: submit() rejects instead
                raise RuntimeError("scheduler stalled with waiting "
                                   "requests and no active rows")
            return events
        eng, pool, state = self.engine, self.pool, self.state
        pos = np.zeros(len(rows), np.int32)
        seq_ids = [-1] * len(rows)
        for i, act in enumerate(rows):
            if act is not None:
                pos[i], seq_ids[i] = act.pos, act.seq
        t0 = time.perf_counter()
        hits0 = (pool.stats["fast_hits"], pool.stats["slow_hits"])
        g0 = state.gather_s
        tok_in = self._tok_dev
        fed_back = not (self._rows_dirty or tok_in is None)
        if not fed_back:
            # an admission or a retirement changed the rows — upload the
            # token vector once; steady-state steps feed the previous
            # step's device tokens back
            tok_in = np.zeros(len(rows), np.int32)
            for i, act in enumerate(rows):
                if act is not None:
                    tok_in[i] = act.outs[-1]
            self._rows_dirty = False
        before = state.transfer_counts()
        pool_io = (state._device.writes, state._device.reads)
        toks, self._tok_dev = state.run_fused(self._step_fn, tok_in,
                                              seq_ids, pos, self._gen)
        after = state.transfer_counts()
        if fed_back and pool_io == (state._device.writes,
                                    state._device.reads):
            self.steady_transfers.append((after[0] - before[0],
                                          after[1] - before[1]))
        dt = time.perf_counter() - t0
        eng.stats["decode_s"] += dt
        eng.stats["decode_steps"] += 1
        self.steps += 1
        if self._observe is not None:
            self._observe(state.gather_s - g0,
                          pool.stats["fast_hits"] - hits0[0],
                          pool.stats["slow_hits"] - hits0[1])
        for i, act in enumerate(rows):
            if act is None:
                continue
            rec = self._recs[id(act.req)]
            tok = int(toks[i])
            act.outs.append(tok)
            act.stats.steps += 1
            act.stats.tokens += 1
            eng.stats["tokens"] += 1
            done = act.finished
            if done:
                # the retired row turns into a -1 row: its stale device
                # token is never read, so nothing is uploaded for it
                self._finish(rec)
            events.append(StreamEvent(act.req, [tok], done=done))
        return events
