"""Continuous-batching scheduler: admit and retire requests mid-decode.

The JAX package's ``repro/serve/scheduler.py`` (the port imports nothing
of that package): urgency-ordered admission with the radix prefix
index's credit, deadline shedding and preemption, over one data shard or
several (`serve.sharding.ServePlan`: each shard owns a block of decode
rows and an equal share of the page budget, and a request admits into
the least-reserved shard that has a free row and headroom).

Admission rules (as the reference's):

- Urgency-ordered, no overtaking within a class: the waiting queue sorts
  by ``(priority desc, absolute deadline asc, submit order)`` — requests
  without deadline/priority (the defaults) are plain FIFO — and only the
  head is considered; if it does not fit, nothing behind it admits.
- A request admits only while a decode row is free (`max_active` bounds
  the lockstep kernel batch) AND the pool has headroom for its worst-case
  page need: ``kv_layers * (ceil((prompt + max_new) / page_tokens) + 1)``
  pages (+1 for the partial tail page per layer, +1 more for the spill
  page of a speculative request, whose verify step may hold rows past
  the page boundary). Worst-case reservations of all active requests are
  held until retire, so the total live page count stays within
  ``pool.capacity_pages``.
- With a radix prefix index, admission credits the prompt pages the tree
  already pins (they are resident either way) and counts the tree's pins
  against the budget; when the gate fails, LRU eviction of unprotected
  exclusive pins may make room. A queue head that no eviction can fit
  while nothing is active is rejected late (``late_rejections``)
  instead of stalling the queue.
- The budget excludes pages already live when the serve call started
  (e.g. left by static batches sharing the pool). A request whose worst
  case can never fit is REJECTED at ``submit`` time with a structured
  `Admission` verdict instead of an exception.
- Retiring frees the request's reservation, which unblocks the queue head
  on the next admission round.

Overload control (SLO-aware):

- A request may carry a ``deadline`` (seconds from submit) and a
  ``priority``. ``submit`` sheds a request whose deadline is predicted
  infeasible (reason ``deadline_infeasible``) from a decode-step-time
  EMA; ``admit`` late-sheds queued requests whose deadline has already
  expired. Shedding is structured (an `Admission` verdict), never an
  exception. Deadlines are wall-clock: ``_clock`` (``time.monotonic``)
  is swappable for a fake clock in tests.
- ``preempt(req)`` parks an admitted request: its row and page
  reservation free immediately (the session swaps its pages to the host
  tier) and it re-enters the waiting queue at its urgency position.
  Eligibility is the strict-urgency rule ``preempts(incoming, victim)``:
  the incoming request must sort strictly earlier on (priority, absolute
  deadline) — a static total order, so a victim can never preempt its
  preemptor back and every parked request eventually resumes. Parked
  requests resume via the normal admission path and are never
  deadline-shed: "preempted" always ends in "resumed" (or explicit
  cancellation).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Admission:
    """Structured admission verdict — truthy iff the request was queued.

    ``reason`` on rejection: ``pool_capacity`` (worst-case page need
    exceeds the pool budget that can ever be free), ``capacity`` (the
    session's page table cannot hold the request), ``speculate`` (the
    request's k exceeds the session's verify width), ``queue_full``
    (front-end backpressure) or ``deadline_infeasible`` (SLO shedding:
    the deadline is predicted unmeetable at submit, or expired while
    queued). ``pages_needed`` / ``pages_budget`` quantify the pool
    verdicts, ``deadline_headroom_s`` the SLO ones (predicted slack;
    negative == shed); ``detail`` is the human-readable sentence."""
    admitted: bool
    reason: str = ""
    detail: str = ""
    pages_needed: int = 0
    pages_budget: Optional[int] = None
    deadline_headroom_s: Optional[float] = None

    def __bool__(self) -> bool:
        return self.admitted

    def as_dict(self) -> dict:
        return {"admitted": self.admitted, "reason": self.reason,
                "detail": self.detail, "pages_needed": self.pages_needed,
                "pages_budget": self.pages_budget,
                "deadline_headroom_s": self.deadline_headroom_s}


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_token: Optional[int] = None    # stop (inclusive) when sampled
    # tokens per decode step: None -> the engine's default; <= 1 -> plain
    # one-token decode; k > 1 -> speculative verify steps of k rows
    speculate: Optional[int] = None
    # SLO budget in seconds from submit. None = best-effort (never shed
    # for deadline, preemptable by any deadline-carrying peer of equal
    # priority). The scheduler sheds predicted/actual misses with reason
    # ``deadline_infeasible`` and preempts to protect tighter deadlines.
    deadline: Optional[float] = None
    # higher admits first and may preempt strictly lower (see
    # `Scheduler.preempts`); equal-priority order falls back to the
    # earliest absolute deadline, then submit order
    priority: int = 0


def effective_speculate(req: Request, default: int = 0) -> int:
    """Resolve a request's per-step token budget: ``Request.speculate``
    wins over the engine default; floored at 1 (plain decode)."""
    k = req.speculate if req.speculate is not None else default
    return max(1, k)


def prefix_page_hashes(tokens: np.ndarray, page_tokens: int) -> list[str]:
    """Cumulative token-prefix digests, one per full prompt page: hash p
    covers ``tokens[:(p+1)*page_tokens]``, so a page is shared only when
    the *entire* prefix up to it matches (the prefix-cache key; K/V rows
    depend only on token and absolute position, so equal prefixes produce
    bitwise-identical pages under the same params)."""
    tokens = np.asarray(tokens, np.int32)
    out = []
    h = hashlib.sha1()
    for p in range(len(tokens) // page_tokens):
        h.update(tokens[p * page_tokens:(p + 1) * page_tokens].tobytes())
        out.append(h.hexdigest())
    return out


class Scheduler:
    """Urgency-ordered waiting queue + admission gate over a
    `PagedKVPool`."""

    def __init__(self, pool, layout, max_active: int = 4,
                 default_speculate: int = 0, prefix_index=None,
                 data_shards: int = 1, rows_per_shard: Optional[int] = None):
        if max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        self.pool = pool
        # paged-state layout (`paged_state.StateLayout`): the budget
        # charges pages only for KV-bearing layers
        self.layout = layout
        self.max_active = max_active
        # engine-level speculation default, to resolve each request's
        # effective k for the spill page (Request.speculate wins)
        self.default_speculate = default_speculate
        # radix prefix index (`prefix_cache.RadixPrefixCache`)
        self.prefix_index = prefix_index
        # mesh-sharded serving: each data shard owns an equal block of
        # decode rows AND an equal share of the page budget (its device
        # pool slice holds only its own rows' pages)
        self.data_shards = max(1, data_shards)
        self.rows_per_shard = rows_per_shard if rows_per_shard is not None \
            else max_active
        self._shard_active = [0] * self.data_shards
        self._shard_reserved = [0] * self.data_shards
        self._shard_of: dict[int, int] = {}    # id(request) -> data shard
        self._hashes: dict[int, list] = {}     # id(request) -> page hashes
        self._admit_match: dict = {}           # id(request) -> PrefixMatch
        self.late_rejections: list[tuple] = []  # (request, Admission)
        self.waiting: deque[Request] = deque()
        self._reserved: dict[int, int] = {}    # id(request) -> page need
        # SLO / preemption state
        self._order: dict[int, int] = {}       # id(request) -> submit seq
        self._submit_s: dict[int, float] = {}  # id(request) -> submit time
        self._submit_seq = 0
        self._parked: dict[int, int] = {}      # id(request) -> page need
        self._blocked_head: Optional[Request] = None
        self._step_ema: Optional[float] = None  # seconds per decode step
        self._clock = time.monotonic           # swappable in tests
        self.preemptions = 0
        self.resumed = 0
        # pages already live when this serve call started (e.g. left by
        # static generate() batches sharing the pool) are never freed by
        # this scheduler's requests, so they shrink the budget throughout
        self._base_pages = pool.live_pages
        self.peak_active = 0
        self.admitted = 0

    def _budget(self):
        if self.pool.capacity_pages is None:
            return None
        return self.pool.capacity_pages - self._base_pages

    def _shard_budget(self):
        """Per-shard page budget: the pool's capacity splits equally over
        the data shards, so a request must fit its OWNING shard's
        share."""
        budget = self._budget()
        return None if budget is None else budget // self.data_shards

    def _prompt_hashes(self, req: Request) -> list:
        """Cumulative page hashes of a request's prompt, cached per
        request object (submit, admission and adoption all need them)."""
        if self.prefix_index is None:
            return []
        h = self._hashes.get(id(req))
        if h is None:
            h = prefix_page_hashes(req.prompt, self.pool.page_tokens)
            self._hashes[id(req)] = h
        return h

    def adopt_cap(self, req: Request) -> int:
        """Max prompt pages a request may adopt from the radix index: at
        least one suffix token must be prefilled to produce the first
        token's logits."""
        return max(0, (len(req.prompt) - 1) // self.pool.page_tokens)

    def _credit(self, req: Request, shard: int = 0):
        """(match, credited pages) of `req` on `shard`: prompt pages the
        shard's radix tree already pins. They are resident either way, so
        admission charges the request only for the pages it may newly
        create."""
        if self.prefix_index is None:
            return None, 0
        hashes = self._prompt_hashes(req)
        if not hashes:
            return None, 0
        m = self.prefix_index.match(hashes, limit=self.adopt_cap(req),
                                    shard=shard)
        return m, self.layout.n_kv * m.pages

    def _pick_shard(self, req: Request, need: int):
        """The least-reserved data shard with a free row and page
        headroom: ``(shard, eff_need, match)``, or None when none fits
        now. With a radix index the gate per shard is::

            reserved[s] + (need - credit) + (pinned[s] - credit) <= budget

        — every resident page counts once, and the request's own matched
        path is exempt because it will be adopted, not re-created. When
        the gate fails, LRU eviction of unprotected exclusive pins
        (`make_room`) may free the shortfall: a shard qualifies only if
        enough pins are reclaimable, and the eviction runs once the
        winning shard is chosen."""
        budget = self._shard_budget()
        best = None
        for s in range(self.data_shards):
            if self._shard_active[s] >= self.rows_per_shard:
                continue
            match, credit = self._credit(req, s)
            eff = need - credit
            shortfall = 0
            if budget is not None:
                pinned = self.prefix_index.pinned_pages(s) \
                    if self.prefix_index is not None else 0
                shortfall = self._shard_reserved[s] + eff \
                    + (pinned - credit) - budget
                if shortfall > 0:
                    protect = frozenset(match.hashes) if match else \
                        frozenset()
                    if self.prefix_index is None or \
                            self.prefix_index.reclaimable_pages(
                                protect, shard=s) < shortfall:
                        continue
            if best is None or \
                    self._shard_reserved[s] < self._shard_reserved[best[0]]:
                best = (s, eff, match, max(0, shortfall))
        if best is None:
            return None
        s, eff, match, shortfall = best
        if shortfall > 0:
            protect = frozenset(match.hashes) if match else frozenset()
            if self.prefix_index.make_room(shortfall, protect,
                                           shard=s) < shortfall:
                return None
        return s, eff, match

    def assigned_shard(self, req: Request) -> int:
        """Data shard `admit()` placed this request on (0 unsharded)."""
        return self._shard_of.get(id(req), 0)

    # -- SLO urgency / overload control --------------------------------------
    def _urgency(self, req: Request) -> tuple:
        """Static total admission order: ``(-priority, absolute deadline,
        submit seq)``, ascending. Default requests collapse to plain FIFO.
        `preempts` compares the first two components strictly, so a
        preempted victim always sorts AFTER its preemptor and can never
        bounce it back (no preemption thrash)."""
        rid = id(req)
        abs_deadline = float("inf") if req.deadline is None \
            else self._submit_s[rid] + req.deadline
        return (-req.priority, abs_deadline, self._order[rid])

    def _insert_waiting(self, req: Request) -> None:
        key = self._urgency(req)
        for i, r in enumerate(self.waiting):
            if self._urgency(r) > key:
                self.waiting.insert(i, req)
                return
        self.waiting.append(req)

    def preempts(self, incoming: Request, victim: Request) -> bool:
        """Strict-urgency eligibility: True iff `incoming` outranks
        `victim` on (priority, absolute deadline) — strictly, so
        preemption chains terminate. Both requests must be known to the
        scheduler (queued, active, or parked)."""
        return self._urgency(incoming)[:2] < self._urgency(victim)[:2]

    def observe_step(self, dt: float) -> None:
        """Feed one decode-step wall time into the service-rate EMA that
        `estimate_completion_s` (deadline-infeasibility shedding) uses."""
        if dt <= 0:
            return
        self._step_ema = dt if self._step_ema is None \
            else 0.9 * self._step_ema + 0.1 * dt

    def estimate_completion_s(self, req: Request) -> Optional[float]:
        """Predicted seconds until `req` would finish: its own tokens cost
        one step each, and the backlog ahead drains ``max_active`` rows
        wide. None before the first observed step (no shedding on zero
        evidence)."""
        if self._step_ema is None:
            return None
        backlog = sum(r.max_new_tokens for r in self.waiting)
        steps = req.max_new_tokens + backlog / max(1, self.max_active)
        return steps * self._step_ema

    def overdue(self, req: Request) -> bool:
        """True when the request's SLO deadline has already passed."""
        if req.deadline is None:
            return False
        sub = self._submit_s.get(id(req))
        return sub is not None and self._clock() - sub > req.deadline

    def is_parked(self, req: Request) -> bool:
        return id(req) in self._parked

    def head_blocked(self) -> Optional[Request]:
        """The waiting head the last `admit()` round could not place
        (None when the queue drained or was empty) — the session's
        preemption pass asks this before hunting for a victim."""
        return self._blocked_head

    def preempt(self, req: Request) -> None:
        """Park an admitted request: its row and page reservation free
        NOW (the caller swaps its pages out), it re-enters the waiting
        queue at its urgency position, and `admit`/`try_resume` later
        re-reserve it on the SAME data shard (its swapped state belongs
        there)."""
        rid = id(req)
        need = self._reserved.pop(rid)
        shard = self._shard_of[rid]            # kept: resume rebinds
        self._shard_active[shard] -= 1
        self._shard_reserved[shard] -= need
        self._parked[rid] = need
        self.preemptions += 1
        self._insert_waiting(req)

    def try_resume(self, req: Request) -> bool:
        """Re-admit a parked request if its shard has a free row and the
        pool has
        headroom (evicting reclaimable prefix pins on shortfall). Its
        original worst-case reservation is restored unchanged — the
        decode progress it already made only shrinks what is left to
        produce, never the reservation. Returns False when it cannot be
        placed right now."""
        rid = id(req)
        if rid not in self._parked or self.n_active >= self.max_active:
            return False
        need = self._parked[rid]
        shard = self._shard_of[rid]
        if self._shard_active[shard] >= self.rows_per_shard:
            return False
        budget = self._shard_budget()
        if budget is not None:
            pinned = self.prefix_index.pinned_pages(shard) \
                if self.prefix_index is not None else 0
            shortfall = self._shard_reserved[shard] + need + pinned - budget
            if shortfall > 0:
                freed = self.prefix_index.make_room(shortfall, shard=shard) \
                    if self.prefix_index is not None else 0
                if freed < shortfall:
                    return False
        for i, r in enumerate(self.waiting):
            if r is req:
                del self.waiting[i]
                break
        del self._parked[rid]
        self._reserved[rid] = need
        self._shard_active[shard] += 1
        self._shard_reserved[shard] += need
        self.resumed += 1
        self.peak_active = max(self.peak_active, self.n_active)
        return True

    def take_match(self, req: Request):
        """Pop the `PrefixMatch` recorded when `admit()` placed this
        request (None when nothing was cached): the engine adopts exactly
        the pages the admission gate credited."""
        return self._admit_match.pop(id(req), None)

    def submit(self, req: Request) -> Admission:
        """Queue a request. A request whose worst case can never fit the
        pool budget (after crediting its radix-cached pages), or whose
        deadline the current service-rate estimate says cannot be met, is
        rejected immediately with a structured verdict — it is NOT
        queued, and nothing else in the workload is affected."""
        budget = self._shard_budget()
        need = self.pages_needed(req)
        credit = 0
        if budget is not None and self.prefix_index is not None:
            credit = max(self._credit(req, s)[1]
                         for s in range(self.data_shards))
        if budget is not None and need - credit > budget:
            per_shard = f" per data shard (x{self.data_shards})" \
                if self.data_shards > 1 else ""
            credited = f" after crediting {credit} radix-cached pages" \
                if credit else ""
            return Admission(
                False, reason="pool_capacity", pages_needed=need,
                pages_budget=budget,
                detail=f"request needs {need} pages worst-case{credited} "
                       f"but only {budget} of the pool's capacity_pages="
                       f"{self.pool.capacity_pages} budget are available"
                       f"{per_shard} ({self._base_pages} pages already "
                       f"live) — it can never be admitted")
        headroom = None
        if req.deadline is not None:
            est = self.estimate_completion_s(req)
            if est is not None:
                headroom = req.deadline - est
                if headroom < 0:
                    return Admission(
                        False, reason="deadline_infeasible",
                        pages_needed=need, pages_budget=budget,
                        deadline_headroom_s=headroom,
                        detail=f"deadline {req.deadline:.3f}s but the "
                               f"current backlog and step-time EMA "
                               f"predict ~{est:.3f}s to completion — "
                               f"shed instead of queueing a guaranteed "
                               f"SLO miss")
        rid = id(req)
        self._order[rid] = self._submit_seq
        self._submit_seq += 1
        self._submit_s[rid] = self._clock()
        self._insert_waiting(req)
        return Admission(True, pages_needed=need, pages_budget=budget,
                         deadline_headroom_s=headroom)

    def remove_waiting(self, req: Request) -> bool:
        """Drop a still-queued (or parked) request — cancellation before
        admission or while parked — by identity."""
        for i, r in enumerate(self.waiting):
            if r is req:
                del self.waiting[i]
                self._drop_request_state(req)
                return True
        return False

    @property
    def n_active(self) -> int:
        return len(self._reserved)

    def pages_needed(self, req: Request) -> int:
        tail = 1 + (1 if effective_speculate(req, self.default_speculate) > 1
                    else 0)
        return self.layout.pages_needed(len(req.prompt) + req.max_new_tokens,
                                        tail_slots=tail)

    def admit(self) -> list[Request]:
        """Pop every waiting request that fits right now, in urgency
        order: a free decode row under ``max_active`` AND a data shard
        with a free row and page headroom for its worst case on top of
        the shard's reservations (and its tree's pins). Expired-deadline
        requests shed here with a structured late rejection; parked
        (preempted) requests resume onto their own shard.
        A head the round could not place stays in `head_blocked` for
        the session's preemption pass."""
        out: list[Request] = []
        while self.waiting and self.n_active < self.max_active:
            req = self.waiting[0]
            rid = id(req)
            if req.deadline is not None and rid not in self._parked \
                    and self.overdue(req):
                # the deadline expired while queued — finishing it now
                # would only miss the SLO AND delay everyone behind it
                waited = self._clock() - self._submit_s[rid]
                self.waiting.popleft()
                self._drop_request_state(req)
                self.late_rejections.append((req, Admission(
                    False, reason="deadline_infeasible",
                    pages_needed=self.pages_needed(req),
                    pages_budget=self._shard_budget(),
                    deadline_headroom_s=req.deadline - waited,
                    detail=f"deadline {req.deadline:.3f}s expired after "
                           f"{waited:.3f}s in the queue — shed")))
                continue
            if rid in self._parked:
                if self.try_resume(req):
                    out.append(req)
                    continue
                if self.n_active == 0 and not out:
                    # cannot re-place even with every row free: unpinnable
                    # pages took the budget for good. Shed structurally
                    # instead of stalling (the session frees the swapped
                    # state).
                    need = self._parked[rid]
                    shard = self._shard_of.get(rid, 0)
                    self.waiting.popleft()
                    self._drop_request_state(req)
                    self.late_rejections.append((req, Admission(
                        False, reason="pool_capacity", pages_needed=need,
                        pages_budget=self._shard_budget(),
                        detail=f"preempted request needs its {need}-page "
                               f"reservation back on data shard {shard} "
                               f"but even an empty batch cannot host it "
                               f"— shed")))
                    continue
                break
            need = self.pages_needed(req)
            pick = self._pick_shard(req, need)
            if pick is None:
                if self.n_active == 0 and not out:
                    # nothing is active, so no retirement can change the
                    # verdict: the head's credit shrank since submit and
                    # even full eviction cannot fit it — reject it late
                    # instead of stalling the queue forever
                    self.waiting.popleft()
                    self._drop_request_state(req)
                    self.late_rejections.append((req, Admission(
                        False, reason="pool_capacity", pages_needed=need,
                        pages_budget=self._shard_budget(),
                        detail=f"request needs {need} pages worst-case "
                               f"but no data shard can fit it even "
                               f"after evicting every reclaimable "
                               f"prefix pin — it can never be "
                               f"admitted")))
                    continue
                break
            shard, eff, match = pick
            self.waiting.popleft()
            self._reserved[rid] = eff
            self._shard_of[rid] = shard
            self._shard_active[shard] += 1
            self._shard_reserved[shard] += eff
            if match is not None and match.pages:
                self._admit_match[rid] = match
            out.append(req)
            self.admitted += 1
        self.peak_active = max(self.peak_active, self.n_active)
        self._blocked_head = self.waiting[0] if self.waiting else None
        return out

    def _drop_request_state(self, req: Request):
        self._hashes.pop(id(req), None)
        self._admit_match.pop(id(req), None)
        if self._parked.pop(id(req), None) is not None:
            # a parked request holds no row or page counters, only the
            # shard pin: clear it so nothing dangles after a shed / cancel
            self._shard_of.pop(id(req), None)
        self._order.pop(id(req), None)
        self._submit_s.pop(id(req), None)
        if self._blocked_head is req:
            self._blocked_head = None

    def retire(self, req: Request):
        need = self._reserved.pop(id(req), None)
        shard = self._shard_of.pop(id(req), None)
        self._drop_request_state(req)
        if need is not None and shard is not None:
            self._shard_active[shard] -= 1
            self._shard_reserved[shard] -= need

    @property
    def done(self) -> bool:
        return not self.waiting and not self._reserved
