"""Continuous-batching scheduler: admit and retire requests mid-decode.

The part of the JAX package's ``repro/serve/scheduler.py`` that the port's
serving session drives (the port imports nothing of that package): FIFO
admission over one data shard with the radix prefix index's credit,
without deadlines, priorities or preemption. Those come with the slices
that port them.

Admission rules (as the reference's):

- FIFO, no overtaking: only the head of the waiting queue is considered;
  if it does not fit, nothing behind it admits.
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
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Admission:
    """Structured admission verdict — truthy iff the request was queued.

    ``reason`` on rejection: ``pool_capacity`` (worst-case page need
    exceeds the pool budget that can ever be free) or ``capacity`` (the
    session's page table cannot hold the request). ``pages_needed`` /
    ``pages_budget`` quantify the verdict; ``detail`` is the
    human-readable sentence. ``deadline_headroom_s`` stays None (no SLO
    shedding in the port yet) and is kept for the reference's format."""
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
    # the reference's SLO-deadline and priority fields; the engine raises
    # NotImplementedError on any non-default
    deadline: Optional[float] = None
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
    """FIFO waiting queue + admission gate over a `PagedKVPool`."""

    def __init__(self, pool, layout, max_active: int = 4,
                 default_speculate: int = 0, prefix_index=None):
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
        self._hashes: dict[int, list] = {}     # id(request) -> page hashes
        self._admit_match: dict = {}           # id(request) -> PrefixMatch
        self.late_rejections: list[tuple] = []  # (request, Admission)
        self.waiting: deque[Request] = deque()
        self._reserved: dict[int, int] = {}    # id(request) -> page need
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

    def _credit(self, req: Request):
        """(match, credited pages): prompt pages the radix tree already
        pins. They are resident either way, so admission charges the
        request only for the pages it may newly create."""
        if self.prefix_index is None:
            return None, 0
        hashes = self._prompt_hashes(req)
        if not hashes:
            return None, 0
        m = self.prefix_index.match(hashes, limit=self.adopt_cap(req))
        return m, self.layout.n_kv * m.pages

    def _fit(self, req: Request, need: int):
        """``(eff_need, match)`` when the request fits now, else None. With
        a radix index the gate is::

            reserved + (need - credit) + (pinned - credit) <= budget

        — every resident page counts once, and the request's own matched
        path is exempt because it will be adopted, not re-created. When
        the gate fails, LRU eviction of unprotected exclusive pins
        (`make_room`) may free the shortfall."""
        match, credit = self._credit(req)
        eff = need - credit
        budget = self._budget()
        if budget is None:
            return eff, match
        pinned = self.prefix_index.pinned_pages() \
            if self.prefix_index is not None else 0
        shortfall = sum(self._reserved.values()) + eff + (pinned - credit) \
            - budget
        if shortfall > 0:
            protect = frozenset(match.hashes) if match else frozenset()
            if self.prefix_index is None or \
                    self.prefix_index.reclaimable_pages(protect) < shortfall:
                return None
            if self.prefix_index.make_room(shortfall, protect) < shortfall:
                return None
        return eff, match

    def take_match(self, req: Request):
        """Pop the `PrefixMatch` recorded when `admit()` placed this
        request (None when nothing was cached): the engine adopts exactly
        the pages the admission gate credited."""
        return self._admit_match.pop(id(req), None)

    def submit(self, req: Request) -> Admission:
        """Queue a request. A request whose worst case can never fit the
        pool budget (after crediting its radix-cached pages) is rejected
        immediately with a structured verdict — it is NOT queued, and
        nothing else in the workload is affected."""
        budget = self._budget()
        need = self.pages_needed(req)
        credit = 0
        if budget is not None and self.prefix_index is not None:
            credit = self._credit(req)[1]
        if budget is not None and need - credit > budget:
            credited = f" after crediting {credit} radix-cached pages" \
                if credit else ""
            return Admission(
                False, reason="pool_capacity", pages_needed=need,
                pages_budget=budget,
                detail=f"request needs {need} pages worst-case{credited} "
                       f"but only {budget} of the pool's capacity_pages="
                       f"{self.pool.capacity_pages} budget are available"
                       f" ({self._base_pages} pages already "
                       f"live) — it can never be admitted")
        self.waiting.append(req)
        return Admission(True, pages_needed=need, pages_budget=budget)

    def remove_waiting(self, req: Request) -> bool:
        """Drop a still-queued request (cancellation before admission),
        by identity."""
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
        """Pop every waiting request that fits right now, in FIFO order: a
        free decode row under ``max_active`` AND page headroom for its
        worst case on top of the active reservations (and the tree's
        pins)."""
        out: list[Request] = []
        while self.waiting and self.n_active < self.max_active:
            req = self.waiting[0]
            need = self.pages_needed(req)
            fit = self._fit(req, need)
            if fit is None:
                if self.n_active == 0 and not out:
                    # nothing is active, so no retirement can change the
                    # verdict: the head's credit shrank since submit and
                    # even full eviction cannot fit it — reject it late
                    # instead of stalling the queue forever
                    self.waiting.popleft()
                    self._drop_request_state(req)
                    self.late_rejections.append((req, Admission(
                        False, reason="pool_capacity", pages_needed=need,
                        pages_budget=self._budget(),
                        # the reference's wording, so that verdicts compare
                        # equal to its one-shard ones
                        detail=f"request needs {need} pages worst-case "
                               f"but no data shard can fit it even "
                               f"after evicting every reclaimable "
                               f"prefix pin — it can never be "
                               f"admitted")))
                    continue
                break
            eff, match = fit
            self.waiting.popleft()
            self._reserved[id(req)] = eff
            if match is not None and match.pages:
                self._admit_match[id(req)] = match
            out.append(req)
            self.admitted += 1
        self.peak_active = max(self.peak_active, self.n_active)
        return out

    def _drop_request_state(self, req: Request):
        self._hashes.pop(id(req), None)
        self._admit_match.pop(id(req), None)

    def retire(self, req: Request):
        self._reserved.pop(id(req), None)
        self._drop_request_state(req)

    @property
    def done(self) -> bool:
        return not self.waiting and not self._reserved
