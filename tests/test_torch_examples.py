"""The port's examples (`repro_torch.examples`) against the JAX package's
``examples/`` scripts, on the CPU (the kernels' plain versions):

- ``serve_stream``: with the JAX example's seed-0 weights carried across,
  the streams, the closed-batch `serve()`, the cancelled request's 2
  tokens, the survivor's tokens, ``shared_puts``, the live pages (0) and
  the summary's ``n_done`` / ``tokens`` equal the JAX flow's;
- ``serve_lm``: the speculative tokens and each request's ``accepted`` /
  ``steps`` equal JAX's; with the Sibyl agents started from the JAX
  agents' networks, the gather time pinned on both sides (as
  ``test_torch_placement.py`` pins it) and the recorded events' gaps
  pinned too (they are wall time), the pool stats, the events and the
  replay's average and p99 latency equal JAX's;
- ``quickstart``: the JAX trainer's step-20 checkpoint resumes in the
  port; steps 21-40's losses within `LOSS_ATOL` of JAX's, the final
  params within 2e-5 (``test_torch_train_system.py``'s tolerance) and
  the greedy tokens equal to JAX's `generate` on the same prompts;
- ``train_100m`` at ``--steps 2 --seq 16 --batch 2``: the printed
  parameter count is JAX's ``Model(cfg).param_count()`` (135,313,152),
  the loss finite, no restart;
- every example refuses ``--device cuda`` on a machine without a card.

Each JAX flow is the reference script's own lines over the JAX package.
The JAX trainer checkpoints blocking here: the reference's trainer saves
its last step twice (async at its interval, then at its end), two
writers of one temporary directory, which the port's checkpointer
serialises.
"""
import contextlib
import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke
from repro.core.sibyl.agent import SibylAgent as JaxAgent
from repro.core.sibyl.agent import run_policy as jax_run_policy
from repro.core.sibyl.env import HssEnv as JaxHssEnv
from repro.core.sibyl.env import hss_config as jax_hss_config
from repro.core.sibyl.traces import DecodeTraceRecorder as JaxRecorder
from repro.models import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.frontend import AsyncServeFrontend as JaxFrontend
from repro.serve.kvcache import PagedKVPool as JaxPool
from repro.serve.placement import SibylPlacement as JaxPlacement
from repro.serve.traffic import MIXES as JAX_MIXES
from repro.serve.traffic import make_trace as jax_make_trace
from repro.train.optimizer import OptimizerConfig as JaxOC
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainJobConfig as JaxJob
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy, sibyl_params_from_numpy
from repro_torch.core.sibyl.agent import SibylAgent
from repro_torch.core.sibyl.traces import DecodeTraceRecorder
from repro_torch.examples import (quickstart, serve_lm, serve_stream,
                                  train_100m, trainer)
from repro_torch.models.common import flatten
from repro_torch.serve.placement import SibylPlacement

CPU = ["--device", "cpu"]
GATHER_S = 2.5e-4       # the pinned per-step gather time (seconds)
GAP_US = 50.0           # the pinned gap between recorded pool events
LOSS_ATOL = 2e-5
PARAM_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(arch, jparams):
    """The JAX params as the port's flat state dict."""
    return params_from_numpy(smoke_config(arch),
                             jax.tree.map(np.asarray, jparams))


# ---------------------------------------------------------------------------
# serve_stream
# ---------------------------------------------------------------------------
def _jax_serve_stream():
    """``examples/serve_stream.py``'s flow over the JAX package; returns
    (what it computes, the engine's params)."""
    import asyncio
    cfg = jax_smoke("starcoder2-7b")
    pool = JaxPool(page_tokens=8)
    eng = JaxEngine(cfg, kv_pool=pool)
    trace = jax_make_trace(JAX_MIXES["prefix_heavy"].override(n_requests=6),
                           cfg.vocab_size)
    capacity = max(len(t.prompt) + t.max_new for t in trace)
    ref = eng.serve([JaxRequest(t.prompt.copy(), t.max_new) for t in trace],
                    max_active=2)

    async def stream_all():
        async with JaxFrontend(eng, capacity=capacity,
                               max_active=2) as front:
            handles = [await front.submit(JaxRequest(t.prompt.copy(),
                                                     t.max_new))
                       for t in trace]
            streamed = []
            for h in handles:
                toks = [tok async for tok in h]
                final = await h.result()
                assert toks == final.tolist()
                streamed.append(final)
            return streamed, front.metrics.summary()

    streamed, summary = asyncio.run(stream_all())
    shared_puts = pool.stats["shared_puts"]

    async def cancel_one():
        async with JaxFrontend(eng, capacity=capacity,
                               max_active=2) as front:
            keep = await front.submit(JaxRequest(trace[0].prompt.copy(),
                                                 trace[0].max_new))
            drop = await front.submit(JaxRequest(trace[1].prompt.copy(),
                                                 trace[1].max_new))
            got = 0
            async for _tok in drop:
                got += 1
                if got == 2:
                    drop.cancel()
                    break
            partial = await drop.result()
            full = await keep.result()
            return full, partial, drop.cancelled

    full, partial, cancelled = asyncio.run(cancel_one())
    return {"ref": ref, "streamed": streamed, "shared_puts": shared_puts,
            "cancelled": cancelled, "partial": partial, "survivor": full,
            "live_pages": len(pool.pages), "summary": summary}, eng.params


def test_serve_stream_equals_jax_flow():
    want, jparams = _jax_serve_stream()
    got = serve_stream.main(CPU, params=_carried("starcoder2-7b", jparams))
    for key in ("ref", "streamed"):
        assert len(got[key]) == len(want[key]) == 6
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got["streamed"], got["ref"]):
        np.testing.assert_array_equal(a, b)
    assert got["cancelled"] and want["cancelled"]
    np.testing.assert_array_equal(got["partial"], want["partial"])
    assert len(got["partial"]) == 2
    np.testing.assert_array_equal(got["survivor"], want["survivor"])
    assert got["shared_puts"] == want["shared_puts"] > 0
    assert got["live_pages"] == want["live_pages"] == 0
    for key in ("n_done", "tokens"):
        assert got["summary"][key] == want["summary"][key]


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------
class _PinnedGather:
    def observe(self, gather_s, fast_hits, slow_hits):
        super().observe(GATHER_S, fast_hits, slow_hits)


class _PinnedJaxPlacement(_PinnedGather, JaxPlacement):
    pass


class _PinnedPlacement(_PinnedGather, SibylPlacement):
    """The port's adapter, its agent started from the JAX adapter's."""

    def __init__(self, seed=0, device="cuda"):
        super().__init__(seed=seed, device=device)
        _load_agent(self.agent, JaxPlacement(seed=seed).agent)


def _load_agent(agent, jagent):
    agent.net.load_state_dict(sibyl_params_from_numpy(
        jax.tree.map(np.asarray, jagent.params)))
    agent.target.load_state_dict(sibyl_params_from_numpy(
        jax.tree.map(np.asarray, jagent.target_params)))
    return agent


class _PinnedGaps:
    """A recorder whose events have a fixed gap instead of wall time."""

    def record(self, lba, size_kb, is_write):
        if len(self.events) < self.max_events:
            self.events.append((int(lba), float(size_kb), bool(is_write),
                                GAP_US))


class _PinnedJaxRecorder(_PinnedGaps, JaxRecorder):
    pass


class _PinnedRecorder(_PinnedGaps, DecodeTraceRecorder):
    pass


def _bridged_agent(device="cuda"):
    return _load_agent(SibylAgent(device=device), JaxAgent())


def _jax_serve_lm():
    """``examples/serve_lm.py``'s flow over the JAX package with the
    gather time and the event gaps pinned; returns (what it computes,
    the engine's params)."""
    cfg = jax_smoke("llama3-405b")
    recorder = _PinnedJaxRecorder()
    pool = JaxPool(page_tokens=8, fast_capacity_pages=16,
                   placement_policy=_PinnedJaxPlacement(seed=0))
    pool.recorder = recorder
    eng = JaxEngine(cfg, kv_pool=pool)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
    reqs = [JaxRequest(shared.copy(), max_new_tokens=16),
            JaxRequest(shared.copy(), max_new_tokens=12),
            JaxRequest(rng.integers(0, cfg.vocab_size, 24).astype(np.int32),
                       max_new_tokens=20),
            JaxRequest(rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                       max_new_tokens=8)]
    outs = eng.serve(reqs, max_active=2)
    agent = pool.policy.agent
    out = {"outs": outs, "pool_stats": dict(pool.stats),
           "live_pages": len(pool.pages),
           "sibyl": {"transitions": agent.t,
                     "last_reward": pool.policy.last_reward},
           "events": list(recorder.events)}
    out["replay"] = jax_run_policy(JaxHssEnv(jax_hss_config("H&M",
                                                            fast_cap=16)),
                                   recorder.events, JaxAgent())
    seng = JaxEngine(cfg, params=eng.params,
                     kv_pool=JaxPool(page_tokens=8), speculate=4,
                     draft="ngram")
    out["spec_outs"] = seng.serve(
        [JaxRequest(shared.copy(), max_new_tokens=16),
         JaxRequest(rng.integers(0, cfg.vocab_size, 24).astype(np.int32),
                    max_new_tokens=20)], max_active=2)
    out["spec_stats"] = [dict(d) for d in seng.last_request_stats]
    return out, eng.params


def test_serve_lm_equals_jax_flow_with_pinned_rewards(monkeypatch):
    want, jparams = _jax_serve_lm()
    monkeypatch.setattr(serve_lm, "SibylPlacement", _PinnedPlacement)
    monkeypatch.setattr(serve_lm, "DecodeTraceRecorder", _PinnedRecorder)
    monkeypatch.setattr(serve_lm, "SibylAgent", _bridged_agent)
    got = serve_lm.main(CPU, params=_carried("llama3-405b", jparams))
    for a, b in zip(got["outs"], want["outs"]):
        np.testing.assert_array_equal(a, b)
    assert got["pool_stats"] == {k: want["pool_stats"][k]
                                 for k in got["pool_stats"]}
    assert got["pool_stats"]["slow_hits"] and got["pool_stats"]["evictions"]
    assert got["live_pages"] == want["live_pages"] == 0
    assert got["sibyl"]["transitions"] == want["sibyl"]["transitions"] > 0
    assert got["sibyl"]["last_reward"] == pytest.approx(
        want["sibyl"]["last_reward"], rel=1e-6)
    assert got["events"] == want["events"]
    for key in ("avg_latency_us", "p99_latency_us", "migrations"):
        assert got["replay"][key] == pytest.approx(want["replay"][key],
                                                   rel=1e-9), key
    assert len(got["spec_outs"]) == len(want["spec_outs"]) == 2
    for a, b in zip(got["spec_outs"], want["spec_outs"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["spec_outs"][0], got["plain_out"])
    for mine, theirs in zip(got["spec_stats"], want["spec_stats"]):
        assert (mine["tokens"], mine["accepted"], mine["steps"]) == \
            (theirs["tokens"], theirs["accepted"], theirs["steps"])
    assert any(d["accepted"] > 0 for d in got["spec_stats"])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
def _jax_quickstart(ckpt_dir):
    """``examples/quickstart.py``'s flow over the JAX package, its
    checkpoints kept in `ckpt_dir` (written blocking)."""
    cfg = jax_smoke("codeqwen1.5-7b")
    oc = JaxOC(lr=3e-3, warmup_steps=5, total_steps=40)
    job = JaxJob(steps=40, seq_len=64, global_batch=8, checkpoint_every=20,
                 checkpoint_dir=str(ckpt_dir), log_every=10,
                 async_checkpoint=False)
    out = JaxTrainer(cfg, oc, job).run()
    eng = JaxEngine(cfg, params=out["state"]["params"])
    rng = np.random.default_rng(0)
    reqs = [JaxRequest(rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                       max_new_tokens=8) for _ in range(2)]
    return out, eng.generate(reqs)


def test_quickstart_resumes_jax_checkpoint(tmp_path, monkeypatch):
    jout, jtokens = _jax_quickstart(tmp_path / "jax")
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    os.rename(tmp_path / "jax" / "step_20", port_dir / "step_20")

    @contextlib.contextmanager
    def kept_dir():
        yield str(port_dir)

    monkeypatch.setattr(quickstart.tempfile, "TemporaryDirectory", kept_dir)
    got = quickstart.main(CPU)
    assert [h["step"] for h in got["history"]] == list(range(20, 40))
    want = [h["loss"] for h in jout["history"][20:]]
    np.testing.assert_allclose(got["losses"], want, rtol=0, atol=LOSS_ATOL)
    jflat = flatten(jax.tree.map(np.asarray, jout["state"]["params"]))
    assert set(got["params"]) == set(jflat)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), jflat[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    assert len(got["generated"]) == len(jtokens) == 2
    for a, b in zip(got["generated"], jtokens):
        np.testing.assert_array_equal(a, b)


def test_trainer_starts_from_given_params():
    """`params=` of quickstart and train_100m: the trainer's model holds
    the given weights in place of its seeded ones."""
    from repro_torch.models import Model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import TrainJobConfig
    cfg = smoke_config("codeqwen1.5-7b")
    state = dict(Model(cfg, device="cpu", seed=7).weights.named_parameters())
    tr = trainer(cfg, OptimizerConfig(), TrainJobConfig(steps=1), "cpu",
                 state)
    seeded = dict(Model(cfg, device="cpu", seed=0).weights
                  .named_parameters())
    for name, p in tr.model.weights.named_parameters():
        assert torch.equal(p, state[name]) and p is not state[name]
    assert any(not torch.equal(state[n], seeded[n]) for n in state)


# ---------------------------------------------------------------------------
# train_100m
# ---------------------------------------------------------------------------
def test_train_100m_counts_jax_params_and_trains():
    jcfg = dataclasses.replace(
        jax_get_config("codeqwen1.5-7b"),
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=2048, vocab_size=32768,
        param_dtype="float32", compute_dtype="float32", remat="none")
    want = JaxModel(jcfg).param_count()
    assert want == 135_313_152
    got = train_100m.main(CPU + ["--steps", "2", "--seq", "16",
                                 "--batch", "2"])
    assert got["param_count"] == want
    assert len(got["losses"]) == 2
    assert all(math.isfinite(x) for x in got["losses"])
    assert got["restarts"] == 0


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the refusal is of a machine without a card")
@pytest.mark.parametrize("module", [serve_stream, serve_lm, quickstart,
                                    train_100m],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_refuse_cuda_without_a_card(module):
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main([])
