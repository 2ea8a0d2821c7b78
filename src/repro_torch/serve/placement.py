"""Sibyl-driven KV-page tier placement and preemption with *real* serving
rewards — the port of the JAX package's ``repro/serve/placement.py``.

The pool calls ``place(feats)`` per page write; the continuous engine
calls ``observe(gather_s, fast_hits, slow_hits)`` after every decode step
with the observed page-gather latency and the step's tier hit deltas from
``pool.stats``. Placements made since the previous step share that
deferred reward (Sibyl's system-feedback loop, thesis §7.5, driven by the
serving hot path instead of a synthetic trace): low gather latency is
good, slow-tier hits are penalized in proportion — the
latency-vs-footprint trade the agent must learn.

`SibylPreemption` extends the same DQN with a *preempt* action over live
decode rows: when the scheduler's strict-urgency rule has already decided
WHO is eligible, the agent ranks the candidates by preempt-advantage
(Q[preempt] - Q[keep]) and learns from step latency + deadline-miss
penalties which victim choice protects the p99. Victim *eligibility*
stays deterministic in the scheduler, so a badly-trained agent can pick a
suboptimal victim but never an incorrect one.

Both take ``device=`` for the agent's networks (the card unless the
caller asks for the CPU).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.sibyl.agent import SibylAgent, SibylConfig
from repro_torch.core.sibyl.env import N_FEATURES
from repro_torch.serve.preemption import RequestView


def _chained(agent: SibylAgent, pending: list, reward: float):
    """Each pending (obs, action) becomes a transition whose next state is
    the following decision's observation (the decision stream is the
    episode); the last one's is its own."""
    for i, (obs, act) in enumerate(pending):
        nobs = pending[i + 1][0] if i + 1 < len(pending) else obs
        agent.experience(obs, act, reward, nobs)
    pending.clear()


class SibylPlacement:
    """Adapts the Sibyl DQN to the KV-pool placement interface.

    Actions: 0 = fast (HBM float), 1 = slow (int8). Rewards arrive
    deferred through `observe`; decisions in flight queue up in between.
    """

    def __init__(self, seed: int = 0, slow_hit_weight: float = 2.0,
                 agent: SibylAgent | None = None, device="cuda"):
        self.agent = agent if agent is not None else \
            SibylAgent(SibylConfig(seed=seed, eps=0.2), device=device)
        self.slow_hit_weight = slow_hit_weight
        self._pending: list[tuple] = []     # (obs, action) awaiting reward
        self.last_reward = 0.0

    def place(self, feats: np.ndarray) -> str:
        obs = np.zeros(N_FEATURES, np.float32)
        obs[:len(feats)] = feats
        a = self.agent.act(obs, 2)
        self.agent._pending = None          # rewards arrive via observe()
        self._pending.append((obs, a))
        return "fast" if a == 0 else "slow"

    def observe(self, gather_s: float, fast_hits: int, slow_hits: int):
        """Feed one decode step's outcome back to the agent."""
        if not self._pending:
            return
        slow_frac = slow_hits / max(fast_hits + slow_hits, 1)
        reward = -(np.log1p(max(gather_s, 0.0) * 1e3)
                   + self.slow_hit_weight * slow_frac)
        self.last_reward = float(reward)
        _chained(self.agent, self._pending, reward)


class SibylPreemption:
    """The Sibyl DQN extended with a preempt action over live decode rows.

    Actions: 0 = keep the row resident, 1 = preempt (swap to host). Per
    decision the agent scores every *eligible* victim (eligibility is the
    scheduler's strict-urgency rule — see `serve.preemption`) and parks
    the row with the highest preempt-advantage ``Q[1] - Q[0]``
    (epsilon-greedy over the candidate set while exploring). Every scored
    candidate becomes a pending transition — the chosen one with action
    "preempt", the kept ones with "keep" — and the engine's per-step
    `observe(step_s, deadline_misses)` call turns them into experience
    with the real decode reward: step latency (log-compressed, as in
    `SibylPlacement`) plus a deadline-miss penalty.

    `serve.preemption.LRUVictimPolicy` is the deterministic fallback and
    the default; this class is opt-in (``--sibyl-preempt``)."""

    def __init__(self, seed: int = 0, miss_weight: float = 4.0,
                 agent: SibylAgent | None = None, device="cuda"):
        self.agent = agent if agent is not None else \
            SibylAgent(SibylConfig(seed=seed, eps=0.2), device=device)
        self.miss_weight = miss_weight
        self._pending: list[tuple] = []     # (obs, action) awaiting reward
        self.last_reward = 0.0
        self.decisions = 0

    def _obs(self, head: RequestView, v: RequestView) -> np.ndarray:
        """Fixed-width DQN observation for one (blocked head, candidate
        victim) pair — bounded features so the MLP sees the same scales
        the HSS environment trained on."""
        obs = np.zeros(N_FEATURES, np.float32)
        total = max(1, v.tokens_done + v.tokens_left)
        obs[0] = v.tokens_done / total                 # progress fraction
        obs[1] = min(1.0, v.tokens_left / 64.0)        # work remaining
        obs[2] = 1.0 if v.prefilling else 0.0          # mid-prefill victim
        obs[3] = np.tanh((head.priority - v.priority) / 4.0)
        obs[4] = 0.0 if v.deadline_slack_s is None \
            else float(np.tanh(v.deadline_slack_s))    # victim slack
        obs[5] = 0.0 if head.deadline_slack_s is None \
            else float(np.tanh(head.deadline_slack_s))  # head slack
        obs[6] = min(1.0, head.queue_depth / 16.0)     # backlog pressure
        obs[7] = min(1.0, v.pages / 64.0)              # swap-cost proxy
        return obs

    def pick(self, head: RequestView,
             victims: Sequence[RequestView]) -> Optional[int]:
        if not victims:
            return None
        obs = [self._obs(head, v) for v in victims]
        q = self.agent.q_batch(np.stack(obs))          # one forward
        adv = [float(row[1] - row[0]) for row in q]
        if self.agent.rng.random() < self.agent.epsilon:
            i = int(self.agent.rng.integers(0, len(victims)))
        else:
            i = int(np.argmax(adv))
        for j, o in enumerate(obs):
            self._pending.append((o, 1 if j == i else 0))
        self.decisions += 1
        return i

    def observe(self, step_s: float, deadline_misses: int) -> None:
        """Per-step reward feedback from the engine: decode-step latency
        plus a penalty per request that finished past its deadline this
        step. Chained like `SibylPlacement.observe`."""
        if not self._pending:
            return
        reward = -(np.log1p(max(step_s, 0.0) * 1e3)
                   + self.miss_weight * deadline_misses)
        self.last_reward = float(reward)
        _chained(self.agent, self._pending, reward)
