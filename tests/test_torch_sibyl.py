"""The port's Sibyl stack (`repro_torch.core.sibyl`) against the JAX
package's on the same seeds: traces, the hybrid-storage simulator, the
heuristic policies and the DQN agent, decision for decision.

Tolerances. Decisions (actions, latencies, migrations, run statistics)
must be identical. The agent's float32 arithmetic is the reference's,
but PyTorch's CPU matmuls sum in another order than XLA's, so its
numbers drift by rounding as training goes on:
- losses: each within 1e-5 relative (``LOSS_RTOL``) over the 900-step
  scenario; over the longer runs (660-1921 training steps) within 1e-5
  of the run's largest loss;
- params, target params and Adam's moments: per tensor, max |port - JAX|
  <= 1e-5 x max |JAX| (``STATE_RTOL``) after the 900-step scenario, and
  1e-4 x after the longer runs;
- `explain`: within 1e-5 absolute.
The agent runs on the CPU here (``device="cpu"``); `chip_smoke.py`'s
``sibyl`` phase holds the card's agent to the CPU agent.
"""
from collections import deque

import jax
import numpy as np
import pytest
import torch

from repro.core.sibyl import agent as jagent
from repro.core.sibyl import env as jenv
from repro.core.sibyl import policies as jpol
from repro.core.sibyl import traces as jtraces
from repro_torch.convert import sibyl_params_from_numpy
from repro_torch.core.sibyl import agent as tagent
from repro_torch.core.sibyl import env as tenv
from repro_torch.core.sibyl import policies as tpol
from repro_torch.core.sibyl import traces as ttraces

LOSS_RTOL = 1e-5
STATE_RTOL = 1e-5
LONG_STATE_RTOL = 1e-4
EXPLAIN_ATOL = 1e-5
HSS = ("H&L", "H&M", "M&L", "H&M&L")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def agents(**cfg):
    """A JAX agent and the port's (CPU), the port's networks and Adam
    state bridged from the JAX agent's, both rngs at the same seed."""
    ja = jagent.SibylAgent(jagent.SibylConfig(**cfg))
    ta = tagent.SibylAgent(tagent.SibylConfig(**cfg), device="cpu")
    ta.net.load_state_dict(sibyl_params_from_numpy(_np(ja.params)))
    ta.target.load_state_dict(sibyl_params_from_numpy(_np(ja.target_params)))
    ta.opt_m = sibyl_params_from_numpy(_np(ja.opt_m))
    ta.opt_v = sibyl_params_from_numpy(_np(ja.opt_v))
    return ja, ta


def assert_state_close(ja, ta, rtol):
    pairs = [(ja.params, ta.net.state_dict()),
             (ja.target_params, ta.target.state_dict()),
             (ja.opt_m, ta.opt_m), (ja.opt_v, ta.opt_v)]
    for jt, tt in pairs:
        for name in tagent.PARAM_NAMES:
            want = np.asarray(jt[name])
            got = tt[name].numpy()
            assert got.shape == want.shape and got.dtype == np.float32
            scale = max(np.abs(want).max(), 1e-30)
            assert np.abs(got - want).max() <= rtol * scale, name
    assert ta.opt_step == int(ja.opt_step)


class Recording:
    """Wraps a policy and records its actions."""

    def __init__(self, policy):
        self.policy = policy
        self.actions = []
        self.name = getattr(policy, "name", "?")

    def act(self, obs, n_devices):
        a = self.policy.act(obs, n_devices)
        self.actions.append(a)
        return a

    def feedback(self, reward, next_obs=None):
        try:
            self.policy.feedback(reward, next_obs=next_obs)
        except TypeError:
            self.policy.feedback(reward)


# ---------------------------------------------------------------------------
# traces and the simulator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jtraces.WORKLOADS)
                         + sorted(jtraces.UNSEEN))
def test_generate_equals_jax(name):
    spec = {**jtraces.WORKLOADS, **jtraces.UNSEEN}[name]
    tspec = {**ttraces.WORKLOADS, **ttraces.UNSEEN}[name]
    assert tspec == ttraces.TraceSpec(*tuple(spec.__dict__.values()))
    for seed in (0, 7):
        assert ttraces.generate(tspec, 600, seed) == \
            jtraces.generate(spec, 600, seed)


def test_mixed_equals_jax():
    names = ["rsrch_0", "web_0", "hm_1"]
    want = jtraces.mixed([jtraces.WORKLOADS[n] for n in names], 900, seed=4)
    got = ttraces.mixed([ttraces.WORKLOADS[n] for n in names], 900, seed=4)
    assert got == want


@pytest.mark.parametrize("hss", HSS)
def test_env_step_and_observe_equal_jax(hss):
    """Same trace, same action sequence (drawn from a seed): identical
    observations, latencies, rewards, device fills and migrations."""
    trace = jtraces.generate(jtraces.WORKLOADS["prxy_1"], 2500, seed=2)
    je = jenv.HssEnv(jenv.hss_config(hss, fast_cap=16))
    te = tenv.HssEnv(tenv.hss_config(hss, fast_cap=16))
    actions = np.random.default_rng(5).integers(0, len(je.devices),
                                                len(trace))
    for (lba, size, w, dt), a in zip(trace, actions):
        np.testing.assert_array_equal(te.observe(lba, size, w),
                                      je.observe(lba, size, w))
        assert te.step(lba, size, w, int(a), dt) == \
            je.step(lba, size, w, int(a), dt)
    assert te.migrations == je.migrations > 0
    np.testing.assert_array_equal(te.dev_counts, je.dev_counts)
    assert te.avg_latency_us == je.avg_latency_us


POLICIES = {"fast_only": (jpol.FastOnly, tpol.FastOnly),
            "slow_only": (jpol.SlowOnly, tpol.SlowOnly),
            "random": (lambda: jpol.RandomPolicy(3),
                       lambda: tpol.RandomPolicy(3)),
            "cde": (jpol.CDE, tpol.CDE), "hps": (jpol.HPS, tpol.HPS),
            "archivist": (lambda: jpol.HotnessPredictor(2),
                          lambda: tpol.HotnessPredictor(2))}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_heuristic_policy_actions_equal_jax(name):
    trace = jtraces.generate(jtraces.WORKLOADS["rsrch_0"], 1500, seed=1)
    make_j, make_t = POLICIES[name]
    jp, tp = Recording(make_j()), Recording(make_t())
    want = jagent.run_policy(jenv.HssEnv(jenv.hss_config("H&L", 256)),
                             trace, jp, warmup=200)
    got = tagent.run_policy(tenv.HssEnv(tenv.hss_config("H&L", 256)),
                            trace, tp, warmup=200)
    assert tp.actions == jp.actions and jp.actions
    assert got == want


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------
def test_qnet_init_shape_and_bias():
    ta = tagent.SibylAgent(tagent.SibylConfig(seed=1, n_actions=3),
                           device="cpu")
    sd = ta.net.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "w1": (10, 32), "b1": (32,), "w2": (32, 32), "b2": (32,),
        "w3": (32, 3), "b3": (3,)}
    assert sd["b3"].tolist() == [0.5, 0.0, 0.0]
    # normal / sqrt(fan_in), from a generator seeded by cfg.seed
    assert 0.6 < float(sd["w2"].std() * np.sqrt(32)) < 1.4
    again = tagent.SibylAgent(tagent.SibylConfig(seed=1, n_actions=3),
                              device="cpu")
    for k, v in again.net.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    for k, v in ta.target.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="w9"):
        sibyl_params_from_numpy({**_np(jagent.SibylAgent().params),
                                 "w9": np.zeros(2)})


def _catastrophe(ja, ta, steps):
    """`tests/test_data_driven.py`'s scenario: action 1 costs 100x."""
    rng = np.random.default_rng(0)
    picks = []
    for _ in range(steps):
        obs = rng.uniform(0, 1, 10).astype(np.float32)
        a, b = ja.act(obs, 2), ta.act(obs, 2)
        picks.append((a, b))
        ja.feedback(-0.01 if a == 0 else -1.0, next_obs=obs)
        ta.feedback(-0.01 if b == 0 else -1.0, next_obs=obs)
    return picks


def test_agent_matches_jax_over_the_900_step_scenario():
    ja, ta = agents(seed=0, eps=0.3, eps_final=0.0, eps_decay_steps=600)
    picks = _catastrophe(ja, ta, 900)
    assert [a for a, _ in picks] == [b for _, b in picks]
    assert np.mean([b for _, b in picks[-200:]]) < 0.1     # it learned
    assert ta.t == ja.t == 900
    want, got = np.array(ja.losses), np.array(ta.losses)
    assert len(got) == len(want) == 435
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert_state_close(ja, ta, STATE_RTOL)
    # explain draws its sample from the same rng
    np.testing.assert_allclose(ta.explain(), ja.explain(), rtol=0,
                               atol=EXPLAIN_ATOL)
    assert ta.rng.random() == ja.rng.random()


def test_explain_on_an_empty_buffer():
    ja, ta = agents(seed=0)
    np.testing.assert_array_equal(ta.explain(), ja.explain())


def test_replay_ring_indexes_like_a_deque():
    ring = tagent.ReplayRing(5, 2)
    ref = deque(maxlen=5)
    for i in range(13):
        obs = np.array([i, -i], np.float32)
        ring.append(obs, i % 2, -float(i), obs + 0.5)
        ref.append(i)
        assert len(ring) == len(ref)
        idx = np.arange(len(ref))
        np.testing.assert_array_equal(ring.obs(idx)[:, 0], list(ref))
        np.testing.assert_array_equal(ring.gather(idx)[:, 3],
                                      [-float(x) for x in ref])


def _run_both(hss, n, fast_cap=256, warmup=300, **cfg):
    trace = jtraces.generate(jtraces.WORKLOADS["rsrch_0"], n, seed=1)
    n_dev = len(jenv.hss_config(hss))
    ja, ta = agents(seed=3, n_actions=n_dev, **cfg)
    jr, tr = Recording(ja), Recording(ta)
    want = jagent.run_policy(jenv.HssEnv(jenv.hss_config(hss, fast_cap)),
                             trace, jr, warmup=warmup)
    got = tagent.run_policy(tenv.HssEnv(tenv.hss_config(hss, fast_cap)),
                            trace, tr, warmup=warmup)
    assert tr.actions == jr.actions
    assert got == want
    want_l, got_l = np.array(ja.losses), np.array(ta.losses)
    assert len(got_l) == len(want_l) > 0
    assert np.abs(got_l - want_l).max() <= LOSS_RTOL * np.abs(want_l).max()
    assert_state_close(ja, ta, LONG_STATE_RTOL)
    return tr.actions, ta


def test_run_policy_on_rsrch_0_equals_jax():
    """1,500 requests of rsrch_0 on H&L: identical latency statistics,
    migrations and decisions."""
    actions, _ = _run_both("H&L", 1500)
    assert 0 < sum(actions) < len(actions)       # both tiers chosen


def test_three_actions_on_the_tri_hybrid():
    """H&M&L: n_actions = 3, every device chosen, equal to JAX."""
    actions, ta = _run_both("H&M&L", 1500)
    assert ta.cfg.n_actions == 3 and set(actions) == {0, 1, 2}


def test_ring_wraps_past_4096_transitions():
    """A 64-transition ring over 5,000 requests: the minibatches of the
    wrapped ring are the deque's, so the run stays equal to JAX's."""
    _, ta = _run_both("H&L", 5000, buffer_size=64)
    assert ta.t > 4096 and len(ta.buffer) == 64
