"""Sibyl RL agent: a small DQN on PyTorch (thesis §7.5-7.6) — the port of
the JAX package's ``repro/core/sibyl/agent.py``.

Two 2-hidden-layer MLPs (training + target network, Fig. 7-8), experience
replay, epsilon-greedy exploration, reward = negative served latency.
Hyper-parameters follow thesis Table 7.2 defaults.

Decision for decision as the reference: the host-side choices
(exploration, replay minibatches, `explain`'s sample, the preemption
policy's exploration) draw from one ``np.random.default_rng(cfg.seed)``
in the reference's order, and the training step is the reference's Adam
(bias-corrected, eps outside the square root) in float32. The networks,
their optimizer state and the training step live on ``device`` (the
card unless the caller asks for the CPU); the replay buffer is a host
ring that uploads one packed minibatch per training step.
"""
from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.core.sibyl.env import N_FEATURES

PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LOSS_READBACK_EVERY = 256   # training steps whose losses wait on the device


@dataclasses.dataclass
class SibylConfig:
    n_actions: int = 2
    hidden: int = 32            # thesis: 2 hidden layers, 20-30 nodes
    gamma: float = 0.9          # discount factor (Table 7.2)
    lr: float = 1e-3
    eps: float = 0.15           # initial exploration rate
    eps_final: float = 0.01
    eps_decay_steps: int = 3000
    batch_size: int = 32
    buffer_size: int = 4096
    target_sync: int = 256
    train_every: int = 2
    seed: int = 0


class QNet(nn.Module):
    """n_in -> hidden -> hidden -> n_out ReLU MLP. Weights are kept in the
    reference's (in, out) layout (``x @ w1 + b1``), so the reference's
    params carry over name for name without a transpose. Initialisation
    keeps the reference's shape: normal / sqrt(fan_in) weights from
    ``generator`` (drawn on the CPU, so every device starts from the same
    values), zero biases, and b3[0] = 0.5 — the fast tier is favoured at
    init, so exploration starts from the safe policy."""

    def __init__(self, n_in: int, hidden: int, n_out: int,
                 generator: torch.Generator | None = None):
        super().__init__()

        def w(a, b):
            return nn.Parameter(torch.randn(a, b, generator=generator)
                                / math.sqrt(a))

        self.w1 = w(n_in, hidden)
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = w(hidden, hidden)
        self.b2 = nn.Parameter(torch.zeros(hidden))
        self.w3 = w(hidden, n_out)
        b3 = torch.zeros(n_out)
        b3[0] = 0.5
        self.b3 = nn.Parameter(b3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ self.w1 + self.b1)
        h = torch.relu(h @ self.w2 + self.b2)
        return h @ self.w3 + self.b3


class ReplayRing:
    """The reference's ``deque(maxlen=cap)`` of (obs, act, reward,
    next_obs) as fixed host arrays. Index i counts from the oldest
    transition, as a deque's does: once the ring has wrapped it lives at
    slot ``(head + i) % cap``, where ``head`` is the next slot to write."""

    def __init__(self, cap: int, n_features: int):
        self.cap = cap
        # one row per transition: obs | act | reward | next_obs, so a
        # minibatch is one contiguous upload
        self.rows = np.zeros((cap, 2 * n_features + 2), np.float32)
        self.n_features = n_features
        self.head = 0
        self.size = 0

    def __len__(self) -> int:
        return self.size

    def append(self, obs, act: int, reward: float, next_obs):
        f = self.n_features
        row = self.rows[self.head]
        row[:f] = obs
        row[f] = act
        row[f + 1] = reward
        row[f + 2:] = next_obs
        self.head = (self.head + 1) % self.cap
        self.size = min(self.size + 1, self.cap)

    def slots(self, idx) -> np.ndarray:
        """Oldest-first indices -> ring slots."""
        idx = np.asarray(idx)
        start = self.head if self.size == self.cap else 0
        return (start + idx) % self.cap

    def gather(self, idx) -> np.ndarray:
        return self.rows[self.slots(idx)]

    def obs(self, idx) -> np.ndarray:
        return self.gather(idx)[:, :self.n_features]


class SibylAgent:
    name = "sibyl"

    def __init__(self, cfg: SibylConfig = SibylConfig(), device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.net = QNet(N_FEATURES, cfg.hidden, cfg.n_actions,
                        generator=gen).to(self.device)
        self.target = copy.deepcopy(self.net).requires_grad_(False)
        self.opt_m = {n: torch.zeros_like(p) for n, p in self._named()}
        self.opt_v = {n: torch.zeros_like(p) for n, p in self._named()}
        self.opt_step = 0
        self.buffer = ReplayRing(cfg.buffer_size, N_FEATURES)
        self.rng = np.random.default_rng(cfg.seed)
        self.t = 0
        self._pending = None
        self._losses: list[float] = []
        self._losses_dev: list[torch.Tensor] = []   # not yet read back

    def _named(self):
        return [(n, getattr(self.net, n)) for n in PARAM_NAMES]

    def sync_target(self):
        with torch.no_grad():
            for n in PARAM_NAMES:
                getattr(self.target, n).copy_(getattr(self.net, n))

    @property
    def losses(self) -> list[float]:
        """Every training step's loss, read back from the device in one
        transfer when asked for or every LOSS_READBACK_EVERY steps (not
        once per step)."""
        self._read_losses()
        return self._losses

    def _read_losses(self):
        if self._losses_dev:
            self._losses.extend(torch.stack(self._losses_dev).tolist())
            self._losses_dev.clear()

    # Policy interface ------------------------------------------------------
    @property
    def epsilon(self) -> float:
        c = self.cfg
        frac = min(1.0, self.t / max(c.eps_decay_steps, 1))
        return c.eps + (c.eps_final - c.eps) * frac

    def q_values(self, obs: np.ndarray) -> np.ndarray:
        """Q(obs, ·) for every action WITHOUT committing a decision —
        for adapters that rank many candidates per decision (the serve
        preemption policy scores each eligible victim's preempt-advantage
        Q[1] - Q[0]) and feed transitions back via `experience`."""
        return self.q_batch(np.asarray(obs)[None])[0]

    def q_batch(self, obs: np.ndarray) -> np.ndarray:
        """Q(obs_i, ·) for a (n, N_FEATURES) batch: one upload, one
        forward, one readback."""
        x = torch.from_numpy(np.ascontiguousarray(obs, np.float32))\
            .to(self.device)
        with torch.no_grad():
            return self.net(x).cpu().numpy()

    def act(self, obs: np.ndarray, n_devices: int) -> int:
        n_act = min(self.cfg.n_actions, n_devices)
        if self.rng.random() < self.epsilon:
            a = int(self.rng.integers(0, n_act))
        else:
            a = int(np.argmax(self.q_values(obs)[:n_act]))
        self._pending = (obs.copy(), a)
        return a

    def feedback(self, reward: float, next_obs=None):
        if self._pending is None:
            return
        obs, act = self._pending
        self._pending = None
        self.experience(obs, act, reward,
                        next_obs if next_obs is not None else obs)

    def experience(self, obs: np.ndarray, act: int, reward: float,
                   next_obs: np.ndarray):
        """Append one transition and run the training cadence. This is the
        deferred-reward entry point: the serve layer's placement policy
        calls act() several times per decode step and only learns the
        shared reward (gather latency, slow-hit penalty) afterwards."""
        self.buffer.append(obs, int(act), float(np.clip(reward, -50.0, 0.0)),
                           next_obs)
        self.t += 1
        cfg = self.cfg
        if self.t % cfg.train_every == 0 and \
                len(self.buffer) >= cfg.batch_size:
            idx = self.rng.integers(0, len(self.buffer), cfg.batch_size)
            self.train_step(self.buffer.gather(idx))
        if self.t % cfg.target_sync == 0:
            self.sync_target()

    def train_step(self, rows: np.ndarray) -> torch.Tensor:
        """One DQN step on a packed minibatch (`ReplayRing` rows): the
        mean squared TD error against the target network, then the
        reference's Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square
        root, bias-corrected) in float32. Returns the loss on the device
        (no readback)."""
        f = N_FEATURES
        batch = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        obs, act = batch[:, :f], batch[:, f].long()
        rew, nobs = batch[:, f + 1], batch[:, f + 2:]
        with torch.no_grad():
            target = rew + self.cfg.gamma * self.target(nobs).max(dim=1)\
                .values
        q = self.net(obs)
        qa = q.gather(1, act[:, None])[:, 0]
        loss = ((qa - target) ** 2).mean()
        params = [p for _, p in self._named()]
        grads = torch.autograd.grad(loss, params)
        self._adam(params, list(grads))
        loss = loss.detach()
        self._losses_dev.append(loss)
        if len(self._losses_dev) >= LOSS_READBACK_EVERY:
            self._read_losses()
        return loss

    def _adam(self, params, grads):
        self.opt_step += 1
        # the reference's int32 step and float32 bias corrections
        step = np.float32(self.opt_step)
        bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** step)
        bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** step)
        m = [self.opt_m[n] for n in PARAM_NAMES]
        v = [self.opt_v[n] for n in PARAM_NAMES]
        with torch.no_grad():
            # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
            torch._foreach_mul_(m, ADAM_B1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - ADAM_B1))
            torch._foreach_mul_(v, ADAM_B2)
            g2 = torch._foreach_mul(grads, 1 - ADAM_B2)
            torch._foreach_mul_(g2, grads)
            torch._foreach_add_(v, g2)
            # p = p - lr * (m / bc1) / (sqrt(v / bc2) + eps)
            num = torch._foreach_div(m, bc1)
            torch._foreach_mul_(num, self.cfg.lr)
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, ADAM_EPS)
            torch._foreach_div_(num, den)
            torch._foreach_sub_(params, num)

    # Explainability (thesis §7.9): mean |dQ/dfeature| over recent states ---
    def explain(self, n: int = 256) -> np.ndarray:
        if not len(self.buffer):
            return np.zeros(N_FEATURES)
        idx = self.rng.integers(0, len(self.buffer), min(n, len(self.buffer)))
        obs = torch.from_numpy(np.ascontiguousarray(self.buffer.obs(idx)))\
            .to(self.device).requires_grad_(True)
        qmax = self.net(obs).max(dim=1).values
        (grad,) = torch.autograd.grad(qmax.sum(), obs)
        return grad.abs().mean(dim=0).cpu().numpy()


def run_policy(env, trace, policy, warmup: int = 0) -> dict:
    """Drive a policy through a trace; online learning via feedback().
    `warmup`: number of leading requests excluded from the latency stats
    (the agent keeps learning throughout — Sibyl is online)."""
    env.reset()
    lats = []
    for (lba, size, is_write, dt) in trace:
        obs = env.observe(lba, size, is_write)
        if is_write or lba not in env.pages:
            action = policy.act(obs, len(env.devices))
        else:
            action = env.pages[lba].device
        lat, reward = env.step(lba, size, is_write, action, dt)
        if hasattr(policy, "feedback"):
            try:
                policy.feedback(reward, next_obs=obs)
            except TypeError:
                policy.feedback(reward)
        lats.append(lat)
    lats = np.array(lats[warmup:])
    return {"avg_latency_us": float(lats.mean()),
            "p99_latency_us": float(np.percentile(lats, 99)),
            "iops": 1e6 * len(lats) / max(env.now_us, 1.0),
            "migrations": env.migrations}
