"""Runs of the benchmark on the CPU at a small size, with the program's
plain kernels: the plain references agree with the program, the control
(the references in fp8) and each fault that a cell can have come out not
correct, and the command fails without a card. A test on the card runs
one cell from the command."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.lib import harness  # noqa: E402
from perfbench.reference import mamba2, plain  # noqa: E402

SMALL_SC = {
    "config": {"num_layers": 2, "d_model": 64, "num_heads": 4,
               "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
               "vocab_size": 256, "dtype": "float32"},
    "mix": {"clients": 3, "max_active": 3, "page_tokens": 8,
            "prompt": {"lo": 8, "hi": 20}, "output": {"lo": 12, "hi": 20},
            "sample": 3},
    "limits": {"logit_gap": {"limit": 1e-3}}}
SMALL_MB = {
    "config": {"num_layers": 2, "d_model": 32, "vocab_size": 256,
               "ssm_state": 16, "ssm_head_dim": 16, "ssm_chunk": 32,
               "dtype": "float32"},
    "mix": {"batch": 2, "seq_len": 64},
    "limits": {k: {"limit": 1e-3}
               for k in ("loss_gap", "grad_gap", "change_gap")}}
SEED = 2 ** 31 + 17


def _serve(**kw):
    return harness.run_cell("sc2-7b.decode-c32", SEED, 0.5, False,
                            device="cpu", overrides=SMALL_SC, **kw)


def _train(**kw):
    return harness.run_cell("mamba2-780m.train-8x2048", SEED, 0.2, False,
                            device="cpu", overrides=SMALL_MB, **kw)


def test_served_tokens_agree_with_the_plain_reference_and_fp8_does_not():
    line = _serve(control=True)
    assert line["correct"], line["checked"]
    assert line["checked"]["logit_gap"]["value"] < 1e-4
    assert line["metrics"]["out_tok_s"]["value"] > 0
    assert line["control"]["logit_gap"] > \
        SMALL_SC["limits"]["logit_gap"]["limit"]


def test_a_token_altered_where_it_is_served_is_not_correct(monkeypatch):
    from repro_torch.serve import engine
    step = engine.ServeSession.step

    def altered(self):
        events = step(self)
        for ev in events:
            ev.tokens = [(t + 1) % 256 for t in ev.tokens]
        return events

    monkeypatch.setattr(engine.ServeSession, "step", altered)
    line = _serve()
    assert not line["correct"]


def test_training_agrees_with_the_plain_reference_and_fp8_does_not():
    line = _train(control=True)
    assert line["correct"], line["checked"]
    lim = SMALL_MB["limits"]
    assert any(line["control"][k] > lim[k]["limit"] for k in lim)


def test_a_train_step_that_leaves_its_state_unchanged_is_not_correct(
        monkeypatch):
    from repro_torch.train import train_step as ts
    monkeypatch.setattr(ts, "adamw_update", lambda params, grads, opt, oc,
                        gnorm=None: (params, opt, {"grad_norm": gnorm,
                                                   "lr": torch.zeros(())}))
    line = _train()
    assert not line["correct"], line["checked"]
    assert line["checked"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_train_step_over_half_the_batch_is_not_correct(monkeypatch):
    from repro_torch.train import train_step as ts
    make = ts.make_train_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)
        return lambda st, b: step(st, {k: v[:v.shape[0] // 2]
                                       for k, v in b.items()})

    monkeypatch.setattr(ts, "make_train_step", broken)
    line = _train()
    assert not line["correct"], line["checked"]


def test_the_blocked_ssd_is_the_step_by_step_recurrence():
    g = torch.Generator().manual_seed(3)
    B, S, H, P, N = 2, 96, 4, 8, 16
    x = torch.randn(B, S, H, P, generator=g, dtype=torch.float64)
    bm = torch.randn(B, S, 1, N, generator=g, dtype=torch.float64)
    cm = torch.randn(B, S, 1, N, generator=g, dtype=torch.float64)
    dt = torch.rand(B, S, H, generator=g, dtype=torch.float64) * 0.2
    a = -(1 + 15 * torch.rand(H, generator=g, dtype=torch.float64))
    h = torch.zeros(B, H, P, N, dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * a)[..., None, None] + \
            dt[:, t, :, None, None] * x[:, t, :, :, None] * \
            bm[:, t, 0, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, cm[:, t, 0]))
    loop = torch.stack(ys, 1)
    got = mamba2.ssd(x, bm, cm, dt, a, chunk=32)
    np.testing.assert_allclose(got.numpy(), loop.float().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_per_sequence_logits_are_the_batch_logits():
    c = dict(SMALL_MB["config"], family="ssm", ssm_expand=2, ssm_ngroups=1,
             ssm_conv_width=4)
    w = mamba2.weights(c, SEED, "cpu")
    w = {k: v.float() for k, v in w.items()}
    toks = torch.randint(0, 256, (2, 40), generator=torch.Generator()
                         .manual_seed(5))
    batch = mamba2.logits(c, w, toks)
    one = mamba2.sequence_logits(c, w, [toks[0], toks[1]])
    for i in range(2):
        torch.testing.assert_close(one[i], batch[i], rtol=1e-5, atol=1e-5)


def test_seeded_weights_repeat_and_differ_across_seeds():
    leaves = {"w": ((4, 8), "normal", 0.5, False),
              "a": ((3,), "alog", 0.0, True)}
    w1 = plain.make_weights(leaves, 2 ** 31 + 3, "cpu", torch.bfloat16)
    w2 = plain.make_weights(leaves, 2 ** 31 + 3, "cpu", torch.bfloat16)
    w3 = plain.make_weights(leaves, 2 ** 31 + 4, "cpu", torch.bfloat16)
    assert torch.equal(w1["w"], w2["w"]) and not torch.equal(w1["w"], w3["w"])
    assert w1["w"].dtype == torch.bfloat16 and w1["a"].dtype == torch.float32
    assert bool(((w1["a"] >= 0) & (w1["a"] <= np.log(16) + 1e-6)).all())


def test_the_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "sc2-7b.decode-c32", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only there")


def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mamba2-780m.train-8x2048", "--seed", str(SEED), "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
