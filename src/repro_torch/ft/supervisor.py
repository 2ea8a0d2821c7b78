"""Restart supervisor — a copy of the JAX package's
``repro/ft/supervisor.py`` (no jax in it): run a step loop with crash
recovery from the latest checkpoint (the single-controller view of a
fleet-level supervisor). Used by launch/train.py and the fault-tolerance
tests (with injected failures)."""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.supervisor")


class FailureInjector:
    """Deterministically raise at given steps (once each) — test hook
    standing in for preempted/killed hosts."""

    def __init__(self, fail_at_steps=()):
        self.pending = set(fail_at_steps)

    def maybe_fail(self, step: int):
        if step in self.pending:
            self.pending.discard(step)
            raise RuntimeError(f"injected node failure at step {step}")


class Supervisor:
    def __init__(self, max_restarts: int = 5, backoff_s: float = 0.0):
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.restarts = 0

    def run(self, make_loop: Callable[[], Callable[[], None]]):
        """make_loop() -> run_fn; run_fn executes (resuming from the latest
        checkpoint internally) and returns when training completes."""
        while True:
            try:
                run_fn = make_loop()
                return run_fn()
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — supervisor catches all
                self.restarts += 1
                log.warning("worker failed (%s); restart %d/%d",
                            e, self.restarts, self.max_restarts)
                if self.restarts > self.max_restarts:
                    raise
                if self.backoff_s:
                    time.sleep(self.backoff_s)
