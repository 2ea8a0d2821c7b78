"""Victim selection for SLO-aware preemption.

WHO may be preempted is the scheduler's deterministic strict-urgency rule
(`Scheduler.preempts`): only rows the blocked head strictly outranks on
(priority, absolute deadline) are candidates, so no learned component can
invert urgency or cause preemption thrash. A policy here only ranks
WITHIN that candidate set — which eligible row costs least to park. The
default is the deterministic `LRUVictimPolicy`; a learned alternative
(the reference's ``SibylPreemption``, the paper's Ch. 7 DQN with a
preempt action) plugs into the same two-method interface, and
correctness never depends on it. A copy of the JAX package's
``repro/serve/preemption.py`` (no jax there either).

Interface::

    pick(head, victims) -> index into victims, or None to decline
    observe(step_s, deadline_misses)   # optional: per-step reward feedback
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class RequestView:
    """What a policy may see about one request — plain numbers, no live
    scheduler state, so policies stay side-effect-free and testable."""
    priority: int = 0
    deadline_slack_s: Optional[float] = None  # abs deadline - now; None=inf
    tokens_done: int = 0        # decode progress (generated so far)
    tokens_left: int = 0        # remaining until max_new_tokens
    prefilling: bool = False    # still streaming prompt chunks
    pages: int = 0              # resident logical pages (swap cost proxy)
    admit_seq: int = 0          # scheduler submit order (unique)
    queue_depth: int = 0        # waiting-line length (head views only)


class LRUVictimPolicy:
    """Deterministic fallback victim choice: the eligible row with the
    least decode progress, ties broken toward the most recently submitted
    — the least-recently-useful row. Parking it wastes the least finished
    work and moves the fewest KV bytes, and the choice is a pure function
    of the views (reproducible across runs, no learned state)."""

    def pick(self, head: RequestView,
             victims: Sequence[RequestView]) -> Optional[int]:
        if not victims:
            return None
        return min(range(len(victims)),
                   key=lambda i: (victims[i].tokens_done,
                                  -victims[i].admit_seq))
