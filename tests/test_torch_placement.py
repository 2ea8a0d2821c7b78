"""The port's Sibyl serving adapters (`repro_torch.serve.placement`) and
the launcher flags that reach them, against the JAX package's.

- `SibylPlacement` and `SibylPreemption` fed the same feature streams and
  rewards as JAX's give the same decisions, and their agents the same
  params (per tensor within 1e-5 of the tensor's largest value).
- Serve parity on the starcoder2-7b smoke config with 4-token pages and
  bridged agent params on both engines: tokens, the pool's stats, the
  agent's transition count and its params equal JAX's. ``observe``'s
  ``gather_s`` is wall-clock bookkeeping time on both sides, so both are
  pinned to one constant (`GATHER_S`); the hit counts stay the engines'.
- `DecodeTraceRecorder` on the port's pool records JAX's events.
- The launcher's ``--sibyl`` and ``--sibyl-preempt``.
"""
import json

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke
from repro.core.sibyl.traces import DecodeTraceRecorder as JaxRecorder
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro.serve.placement import SibylPlacement as JaxPlacement
from repro.serve.placement import SibylPreemption as JaxPreemption
from repro.serve.preemption import RequestView as JaxView
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy, sibyl_params_from_numpy
from repro_torch.core.sibyl.agent import PARAM_NAMES
from repro_torch.core.sibyl.traces import DecodeTraceRecorder
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import PagedKVPool
from repro_torch.serve.placement import SibylPlacement, SibylPreemption
from repro_torch.serve.preemption import RequestView

ARCH = "starcoder2-7b"
T = 4
GATHER_S = 2.5e-4       # the pinned per-step gather time (seconds)
STATE_RTOL = 1e-5


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's state dict) — the same weights."""
    jparams = JaxEngine(jax_smoke(ARCH)).params
    return jparams, params_from_numpy(smoke_config(ARCH),
                                      jax.tree.map(np.asarray, jparams))


def _bridge(jpol, pol):
    """Start the port's agent from the JAX agent's networks."""
    tree = jax.tree.map(np.asarray, jpol.agent.params)
    pol.agent.net.load_state_dict(sibyl_params_from_numpy(tree))
    pol.agent.target.load_state_dict(sibyl_params_from_numpy(
        jax.tree.map(np.asarray, jpol.agent.target_params)))
    return jpol, pol


def _assert_agents_close(jagent, agent):
    assert agent.t == jagent.t and agent.opt_step == int(jagent.opt_step)
    for want_tree, got in ((jagent.params, agent.net.state_dict()),
                           (jagent.target_params, agent.target.state_dict()),
                           (jagent.opt_m, agent.opt_m),
                           (jagent.opt_v, agent.opt_v)):
        for name in PARAM_NAMES:
            want = np.asarray(want_tree[name])
            diff = np.abs(got[name].numpy() - want).max()
            assert diff <= STATE_RTOL * max(np.abs(want).max(), 1e-30), name


class _Pinned:
    """Mixin: ``observe`` with the gather time pinned to `GATHER_S`."""

    def observe(self, gather_s, fast_hits, slow_hits):
        super().observe(GATHER_S, fast_hits, slow_hits)


class PinnedJax(_Pinned, JaxPlacement):
    pass


class Pinned(_Pinned, SibylPlacement):
    pass


# ---------------------------------------------------------------------------
# The adapters, driven directly
# ---------------------------------------------------------------------------
def test_placement_decisions_and_params_equal_jax():
    """A stream of pool features and step rewards (gather time, hits)
    through both adapters: the same tiers, rewards and agent state."""
    jpol, pol = _bridge(JaxPlacement(seed=0), SibylPlacement(device="cpu"))
    rng = np.random.default_rng(1)
    want, got = [], []
    for step in range(120):
        for _ in range(int(rng.integers(0, 6))):
            feats = rng.uniform(0, 1.5, 4).astype(np.float32)
            want.append(jpol.place(feats))
            got.append(pol.place(feats))
        gather_s = float(rng.exponential(1e-3))
        fast, slow = (int(x) for x in rng.integers(0, 40, 2))
        jpol.observe(gather_s, fast, slow)
        pol.observe(gather_s, fast, slow)
        assert pol.last_reward == jpol.last_reward
        assert not pol._pending and not jpol._pending
    assert got == want and {"fast", "slow"} <= set(got)
    assert pol.agent.t == len(got) > pol.agent.cfg.batch_size
    _assert_agents_close(jpol.agent, pol.agent)


def _views(cls, rng, n):
    return [cls(priority=int(rng.integers(0, 3)),
                deadline_slack_s=None if rng.random() < 0.3
                else float(rng.normal(0, 2)),
                tokens_done=int(rng.integers(0, 40)),
                tokens_left=int(rng.integers(0, 80)),
                prefilling=bool(rng.random() < 0.3),
                pages=int(rng.integers(0, 90)), admit_seq=i,
                queue_depth=int(rng.integers(0, 20)))
            for i in range(n)]


def test_preemption_decisions_and_params_equal_jax():
    """Random (head, eligible victims) sets and step rewards through both
    victim policies: the same picks, observations and agent state."""
    jpol, pol = _bridge(JaxPreemption(seed=0), SibylPreemption(device="cpu"))
    rng = np.random.default_rng(2)
    picks = []
    for step in range(150):
        n = int(rng.integers(0, 4))
        state = rng.bit_generator.state
        jhead, *jvics = _views(JaxView, rng, n + 1)
        rng.bit_generator.state = state
        head, *vics = _views(RequestView, rng, n + 1)
        for v, jv in zip([head] + vics, [jhead] + jvics):
            np.testing.assert_array_equal(pol._obs(head, v),
                                          jpol._obs(jhead, jv))
        want = jpol.pick(jhead, jvics)
        assert pol.pick(head, vics) == want
        picks.append(want)
        step_s, misses = float(rng.exponential(0.03)), int(rng.integers(0, 3))
        jpol.observe(step_s, misses)
        pol.observe(step_s, misses)
        assert pol.last_reward == jpol.last_reward
    assert pol.decisions == jpol.decisions > 0
    assert len({p for p in picks if p is not None}) > 1
    _assert_agents_close(jpol.agent, pol.agent)


def test_sibyl_preemption_policy_learns_from_step_rewards():
    """The port of the reference's test of the same name."""
    pol = SibylPreemption(seed=0, device="cpu")
    head = RequestView(priority=1, queue_depth=3)
    views = [RequestView(tokens_done=i, tokens_left=8 - i, admit_seq=i)
             for i in range(3)]
    for _ in range(4):
        i = pol.pick(head, views)
        assert i is not None and 0 <= i < 3
        pol.observe(0.01, deadline_misses=1)
    assert pol.decisions == 4
    assert not pol._pending                      # rewards consumed
    assert pol.agent.t > 0                       # transitions recorded
    assert pol.pick(head, []) is None


# ---------------------------------------------------------------------------
# Serve parity with the rewards pinned
# ---------------------------------------------------------------------------
def _reqs(cls, lengths=(12, 7, 16, 9), news=(6, 5, 4, 7), seed=0):
    rng = np.random.default_rng(seed)
    vocab = smoke_config(ARCH).vocab_size
    return [cls(rng.integers(0, vocab, n).astype(np.int32), m)
            for n, m in zip(lengths, news)]


def _sibyl_engines(params, fast_pages=8):
    jpol, pol = _bridge(PinnedJax(seed=0), Pinned(device="cpu"))
    jeng = JaxEngine(jax_smoke(ARCH), params=params[0], decode_mode="fused",
                     kv_pool=JaxPool(page_tokens=T, placement_policy=jpol,
                                     fast_capacity_pages=fast_pages))
    eng = ServeEngine(smoke_config(ARCH), params=params[1], device="cpu",
                      kv_pool=PagedKVPool(page_tokens=T, placement_policy=pol,
                                          fast_capacity_pages=fast_pages))
    return jeng, eng


@pytest.mark.parametrize("path", ["generate", "serve_monolithic",
                                  "serve_default"])
def test_sibyl_serve_equals_jax_with_pinned_rewards(params, path):
    """Both tiers and LRU demotion are reached (8 fast pages); the tokens,
    the pool's stats, the agent's transitions and params equal JAX's."""
    jeng, eng = _sibyl_engines(params)
    if path == "generate":
        want = jeng.generate(_reqs(JaxRequest))
        got = eng.generate(_reqs(Request))
    else:
        kw = {} if path == "serve_default" else \
            {"chunked_prefill": False, "radix": False}
        want = jeng.serve(_reqs(JaxRequest), max_active=2, **kw)
        got = eng.serve(_reqs(Request), max_active=2, **kw)
        assert eng.kv_pool.live_pages == 0
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    pool, jpool = eng.kv_pool, jeng.kv_pool
    assert pool.stats == {k: jpool.stats[k] for k in pool.stats}
    assert pool.stats["fast_hits"] and pool.stats["slow_hits"]
    assert pool.stats["evictions"] > 0
    pol, jpol = pool.policy, jpool.policy
    assert not pol._pending and not jpol._pending
    assert pol.agent.t > 0
    _assert_agents_close(jpol.agent, pol.agent)


def test_decode_trace_recorder_matches_jax(params):
    """The pool events of one continuous serve: the same (page id, KiB,
    write) stream as the JAX pool's; the gaps are wall time."""
    jpool = JaxPool(page_tokens=T)
    pool = PagedKVPool(page_tokens=T)
    jpool.recorder, pool.recorder = JaxRecorder(), DecodeTraceRecorder()
    JaxEngine(jax_smoke(ARCH), params=params[0], kv_pool=jpool,
              decode_mode="fused").serve(_reqs(JaxRequest), max_active=2)
    ServeEngine(smoke_config(ARCH), params=params[1], kv_pool=pool,
                device="cpu").serve(_reqs(Request), max_active=2)
    want = [e[:3] for e in jpool.recorder.events]
    got = [e[:3] for e in pool.recorder.events]
    assert got == want
    assert any(w for _, _, w in got) and not all(w for _, _, w in got)
    assert all(e[3] >= 0 for e in pool.recorder.events)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
LAUNCH = ["--arch", ARCH, "--smoke", "--device", "cpu", "--page-tokens", "4",
          "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"]


@pytest.mark.parametrize("mode", [["--continuous"], ["--frontend"],
                                  ["--frontend", "--trace",
                                   "overload:n_requests=6"]],
                         ids=["continuous", "frontend", "trace"])
def test_launcher_sibyl_flags(mode, capsys):
    """``--sibyl`` and ``--sibyl-preempt`` run on the CPU: the pool places
    through the DQN and the session ranks victims with it."""
    from repro_torch.launch.serve import main
    out = main(LAUNCH + ["--max-active", "2", "--sibyl", "--sibyl-preempt"]
               + mode)
    eng = out["engine"]
    placement = eng.kv_pool.policy
    assert isinstance(placement, SibylPlacement)
    assert placement.agent.t > 0 and not placement._pending
    assert str(placement.agent.device) == "cpu"
    assert isinstance(out["preempt_policy"], SibylPreemption)
    assert out["preempt_policy"].agent.device.type == "cpu"
    assert eng.kv_pool.live_pages == 0
    assert "live_pages=0" in capsys.readouterr().out


@pytest.mark.parametrize("flag,exc,match", [
    (["--mesh", "2x2", "--mesh-devices", "cpu,cpu,cpu"], ValueError,
     "needs 4 devices"),
    (["--knee-cache", "knees.json"], None, None)],
    ids=["mesh", "knees"])
def test_launcher_mesh_raises_and_knee_cache_writes(flag, exc, match,
                                                 tmp_path):
    """Beside the Sibyl flags: a mesh with fewer devices than positions
    raises; ``--knee-cache`` writes the paged kernel's knee that serving
    resolved."""
    from repro_torch.kernels import api
    from repro_torch.launch.serve import main
    if exc is not None:
        with pytest.raises(exc, match=match):
            main(LAUNCH + ["--continuous", "--sibyl"] + flag)
        return
    api.invalidate_caches()
    path = tmp_path / flag[1]
    main(LAUNCH + ["--continuous", "--sibyl", flag[0], str(path)])
    assert any(e["kernel"] == "paged_attention"
               for e in json.loads(path.read_text()))
