"""The port's training loop end to end on the CPU, as the JAX package's
``tests/test_system.py`` holds the reference's:

- loss falls (codeqwen1.5-7b smoke, 60 steps);
- checkpoint resume is bit-exact (mamba2-780m smoke: 16 steps straight
  against 8, a new `Trainer` resuming to 16);
- an injected failure is recovered by the supervisor (starcoder2-7b
  smoke);
- the straggler monitor flags the outlier, as the reference's on the
  same step times;
- a JAX `Trainer` checkpoint at step 8 resumes in the port to step 16,
  its params within 2e-5 of the JAX run's straight 16 steps (fp32, the
  gradients' summation order), and the port writes the reference's keys;
- bfloat16 leaves: an ``.npy`` written through ``ml_dtypes`` loads in the
  port bit for bit, the port's own bf16 save and restore round-trips, an
  async save keeps the values of the moment it was called;
- the launcher: ``python -m repro_torch.launch.train --smoke --device
  cpu``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs import smoke_config as jax_smoke
from repro.ft.straggler import StragglerMonitor as JaxMonitor
from repro.train.optimizer import OptimizerConfig as JaxOC
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainJobConfig as JaxJob
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import smoke_config
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.ft.supervisor import FailureInjector, Supervisor
from repro_torch.models.common import flatten
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainJobConfig

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-sized ops gain nothing from torch's intra-op thread pool, and
    beside other test workers on the same cores its spinning threads cost
    several times what they save (a 60-step CPU run: 2 s alone, 38 s
    under three workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _job(d=None, **kw):
    base = dict(steps=20, seq_len=32, global_batch=4, checkpoint_every=8,
                checkpoint_dir=d, log_every=100)
    base.update(kw)
    return TrainJobConfig(**base)


def test_training_reduces_loss():
    cfg = smoke_config("codeqwen1.5-7b")
    tr = Trainer(cfg, OptimizerConfig(lr=3e-3, warmup_steps=2,
                                      total_steps=60), _job(steps=60),
                 device="cpu")
    out = tr.run()
    first = np.mean([h["loss"] for h in out["history"][:5]])
    last = np.mean([h["loss"] for h in out["history"][-5:]])
    assert last < first - 0.2, (first, last)
    assert set(out["history"][0]) == {"total_loss", "loss", "aux_loss",
                                      "grad_norm", "lr", "step_time_s",
                                      "step"}


def test_checkpoint_resume_bit_exact(tmp_path):
    cfg = smoke_config("mamba2-780m")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=16)
    d1, d2 = tmp_path / "a", tmp_path / "b"
    a = Trainer(cfg, oc, _job(str(d1), steps=16, async_checkpoint=False),
                device="cpu").run()
    Trainer(cfg, oc, _job(str(d2), steps=8, async_checkpoint=False),
            device="cpu").run()
    b = Trainer(cfg, oc, _job(str(d2), steps=16, async_checkpoint=False),
                device="cpu").run()
    assert b["history"][0]["step"] == 8
    for name, p in a["state"]["params"].items():
        torch.testing.assert_close(p, b["state"]["params"][name], rtol=0,
                                   atol=0)
    for key in ("m", "v", "master"):
        for name, t in a["state"]["opt"][key].items():
            torch.testing.assert_close(t, b["state"]["opt"][key][name],
                                       rtol=0, atol=0)


def test_failure_injection_recovery(tmp_path):
    cfg = smoke_config("starcoder2-7b")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    inj = FailureInjector(fail_at_steps=[10])

    def make_loop():
        return Trainer(cfg, oc, _job(str(tmp_path), steps=15,
                                     checkpoint_every=4,
                                     async_checkpoint=False),
                       device="cpu", failure_hook=inj.maybe_fail).run

    sup = Supervisor(max_restarts=2)
    out = sup.run(make_loop)
    assert sup.restarts == 1
    assert out["final_metrics"]["step"] == 14
    assert out["history"][0]["step"] == 8       # resumed from step_8


def test_straggler_monitor_flags_outlier():
    mon, ref = StragglerMonitor(n_hosts=8), JaxMonitor(n_hosts=8)
    rng = np.random.default_rng(0)
    for _ in range(20):
        for h in range(8):
            t = 1.0 + 0.01 * rng.standard_normal() + \
                (2.5 if h == 5 else 0.0)
            mon.record(h, t)
            ref.record(h, t)
    assert mon.stragglers() == ref.stragglers() == [5]
    np.testing.assert_array_equal(mon.host_means(), ref.host_means())
    assert mon.should_mitigate()


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The reference trains 16 steps straight, saving at 8 and 16; the
    port resumes its step-8 checkpoint to 16."""
    arch = "starcoder2-7b"
    d = tmp_path / "jax"
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=16)
    jout = JaxTrainer(jax_smoke(arch), JaxOC(**oc),
                      JaxJob(steps=16, seq_len=24, global_batch=4,
                             checkpoint_every=8, checkpoint_dir=str(d),
                             async_checkpoint=False, log_every=100)).run()
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    os.rename(d / "step_8", port_dir / "step_8")
    out = Trainer(smoke_config(arch), OptimizerConfig(**oc),
                  _job(str(port_dir), steps=16, seq_len=24,
                       async_checkpoint=False), device="cpu").run()
    assert out["history"][0]["step"] == 8
    want = flatten(jax.tree.map(np.asarray, jout["state"]["params"]))
    got = out["state"]["params"]
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=2e-5, err_msg=name)
    mine = json.loads((port_dir / "step_16" / "meta.json").read_text())
    theirs = json.loads((d / "step_16" / "meta.json").read_text())
    assert list(mine["manifest"]) == list(theirs["manifest"])
    assert mine["extra"] == theirs["extra"]
    for key, entry in theirs["manifest"].items():
        assert mine["manifest"][key]["shape"] == entry["shape"]
        assert mine["manifest"][key]["dtype"] == entry["dtype"]


def test_bf16_leaves_load_and_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    # the reference's writer: ml_dtypes bfloat16 through numpy
    ref_state = {"params": {"w": rng.standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)},
        "opt": {"step": np.asarray(7, np.int32)}}
    JaxCheckpointer(tmp_path / "ref").save(1, ref_state, blocking=True)
    template = {"params": {"w": torch.empty(3, 5, dtype=torch.bfloat16)},
                "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    got, meta = Checkpointer(tmp_path / "ref").restore(template)
    assert meta["manifest"]["params##w"]["dtype"] == "bfloat16"
    np.testing.assert_array_equal(
        got["params"]["w"].view(torch.int16).numpy(),
        ref_state["params"]["w"].view(np.int16))
    assert int(got["opt"]["step"]) == 7
    # the port's own bf16 leaves, saved async and changed right after
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(
        np.float32)).to(torch.bfloat16)
    state = {"params": {"groups": {"l0": {"w": w}}},
             "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    before = w.clone()
    ck = Checkpointer(tmp_path / "port")
    ck.save(2, state, blocking=False)
    w.add_(1.0)                          # an in-place update at once
    ck.wait()
    meta = json.loads((tmp_path / "port" / "step_2" / "meta.json")
                      .read_text())
    assert list(meta["manifest"]) == ["opt##step", "params##groups##l0##w"]
    assert meta["manifest"]["params##groups##l0##w"]["dtype"] == "bfloat16"
    back, _ = ck.restore({"params": {"groups": {"l0": {
        "w": torch.empty_like(w)}}},
        "opt": {"step": torch.zeros((), dtype=torch.int32)}})
    assert torch.equal(back["params"]["groups"]["l0"]["w"].view(torch.int16),
                       before.view(torch.int16))


def test_launcher_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-780m", "--smoke", "--device", "cpu", "--steps", "4",
         "--seq", "16", "--batch", "2", "--checkpoint-dir",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300, check=True)
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("done: final loss ") and \
        last.endswith("over 4 steps; stragglers=[]"), last
    assert (tmp_path / "step_4" / "meta.json").exists()
