"""Continuous-batching scheduler: admit and retire requests mid-decode.

The part of the JAX package's ``repro/serve/scheduler.py`` that the port's
serving session drives (the port imports nothing of that package): FIFO
admission over one data shard, without a radix prefix index, deadlines,
priorities or preemption. Those come with the slices that port them.

Admission rules (as the reference's):

- FIFO, no overtaking: only the head of the waiting queue is considered;
  if it does not fit, nothing behind it admits.
- A request admits only while a decode row is free (`max_active` bounds
  the lockstep kernel batch) AND the pool has headroom for its worst-case
  page need: ``kv_layers * (ceil((prompt + max_new) / page_tokens) + 1)``
  pages (+1 for the partial tail page per layer). Worst-case reservations
  of all active requests are held until retire, so the total live page
  count stays within ``pool.capacity_pages``.
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
    # the reference's speculative-decode, SLO-deadline and priority
    # fields; the engine raises NotImplementedError on any non-default
    speculate: Optional[int] = None
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

    def __init__(self, pool, layout, max_active: int = 4):
        if max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        self.pool = pool
        # paged-state layout (`paged_state.StateLayout`): the budget
        # charges pages only for KV-bearing layers
        self.layout = layout
        self.max_active = max_active
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

    def submit(self, req: Request) -> Admission:
        """Queue a request. A request whose worst case can never fit the
        pool budget is rejected immediately with a structured verdict — it
        is NOT queued, and nothing else in the workload is affected."""
        budget = self._budget()
        need = self.pages_needed(req)
        if budget is not None and need > budget:
            return Admission(
                False, reason="pool_capacity", pages_needed=need,
                pages_budget=budget,
                detail=f"request needs {need} pages worst-case "
                       f"but only {budget} of the pool's capacity_pages="
                       f"{self.pool.capacity_pages} budget are available"
                       f" ({self._base_pages} pages already "
                       f"live) — it can never be admitted")
        self.waiting.append(req)
        return Admission(True, pages_needed=need, pages_budget=budget)

    @property
    def n_active(self) -> int:
        return len(self._reserved)

    def pages_needed(self, req: Request) -> int:
        return self.layout.pages_needed(len(req.prompt) + req.max_new_tokens)

    def admit(self) -> list[Request]:
        """Pop every waiting request that fits right now, in FIFO order: a
        free decode row under ``max_active`` AND page headroom for its
        worst case on top of the active reservations."""
        out: list[Request] = []
        budget = self._budget()
        while self.waiting and self.n_active < self.max_active:
            req = self.waiting[0]
            need = self.pages_needed(req)
            if budget is not None and \
                    sum(self._reserved.values()) + need > budget:
                break
            self.waiting.popleft()
            self._reserved[id(req)] = need
            out.append(req)
            self.admitted += 1
        self.peak_active = max(self.peak_active, self.n_active)
        return out

    def retire(self, req: Request):
        self._reserved.pop(id(req), None)

    @property
    def done(self) -> bool:
        return not self.waiting and not self._reserved
