"""The port's optimizer, gradient compression, data pipeline and train
step against the JAX package on the CPU:

- `TokenPipeline` batches equal the reference's for the same (seed, step,
  shard), token, external-embedding and image configs;
- `adamw_update` over 5 steps crossing warmup into the cosine schedule
  with clipping active (fp32 params with and without a master, bf16
  params with one): params, m, v, master, step, grad_norm and lr;
- the int8 error-feedback compressor over 3 steps: gradients and
  residuals;
- 4 `make_train_step` steps from the reference's `init_state` carried
  over by `convert.train_state_from_numpy`, for the starcoder2-7b,
  mamba2-780m, recurrentgemma-2b and granite-moe-3b-a800m smoke configs
  with 2 microbatches (starcoder2 also with gradient compression): every
  step's losses, grad_norm, lr and params.

Limits (fp32): the optimizer alone within 1e-6 relative (bf16 params
within one bf16 ulp); the compressor's gradients within 1e-6 and its
residuals within one fp32 ulp of the largest value (the reference
rounds ``total - q * scale`` once, as an FMA); trajectories at rtol 1e-5
for losses and the grad norm and atol 2e-5 for params (a step moves a
weight by at most lr = 1e-3; the gradients differ by summation order,
1e-5 relative); with compression atol 2e-4 for params, a fifth of lr:
a gradient that sits at an int8 rounding boundary lands one quantum
apart on the two sides, which moves that weight's Adam step (3.9e-5
seen).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models import Model as JaxModel
from repro.train import grad_compression as jgc
from repro.train import optimizer as jopt
from repro.train.train_step import init_state as jax_init_state
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.common import flatten
from repro_torch.models.transformer import Model
from repro_torch.train import grad_compression as gc
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

OC = opt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                         grad_clip=0.5)


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


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "musicgen-medium",
                                  "llama-3.2-vision-11b"])
def test_pipeline_batches_equal_jax(arch):
    for seed, step, shards, shard in ((0, 0, 1, 0), (7, 5, 2, 1),
                                      (3, 11, 4, 2)):
        mine = TokenPipeline(smoke_config(arch), 16, 8, seed=seed,
                             num_shards=shards, shard=shard).batch_at(step)
        theirs = JaxPipeline(jax_smoke(arch), 16, 8, seed=seed,
                             num_shards=shards, shard=shard).batch_at(step)
        assert set(mine) == set(theirs)
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(mine[k], theirs[k])
    p = TokenPipeline(smoke_config(arch), 16, 8, seed=7)
    p.step = 9
    q = TokenPipeline(smoke_config(arch), 16, 8, seed=7)
    q.restore(p.state())
    assert q.step == 9


SHAPES = {"a": (3, 5), "b.c": (7,), "b.d": (2, 2, 4)}


def _tree(rng, dtype):
    return {n: (rng.standard_normal(s) * 2).astype(dtype)
            for n, s in SHAPES.items()}


@pytest.mark.parametrize("dtype,use_master", [("float32", True),
                                              ("float32", False),
                                              ("bfloat16", True)])
def test_adamw_five_steps_match_jax(dtype, use_master):
    oc = dataclasses.replace(OC, use_master=use_master)
    rng = np.random.default_rng(0)
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    params = _tree(rng, np_dtype)
    tparams = {n: torch.from_numpy(v.astype(np.float32)).to(
        getattr(torch, dtype)) for n, v in params.items()}
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    tstate = opt.init_opt_state(tparams, oc)
    jstate = jopt.init_opt_state(jparams, oc)
    update = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, oc))
    for step in range(5):
        grads = _tree(rng, np.float32)
        jparams, jstate, jm = update(
            jparams, {n: jnp.asarray(g) for n, g in grads.items()}, jstate)
        tparams, tstate, tm = opt.adamw_update(
            tparams, {n: torch.from_numpy(g) for n, g in grads.items()},
            tstate, oc)
        assert float(jm["grad_norm"]) > oc.grad_clip      # clipping active
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for n in params:
            for key in ("m", "v") + (("master",) if use_master else ()):
                np.testing.assert_allclose(
                    tstate[key][n].numpy(), np.asarray(jstate[key][n]),
                    rtol=1e-6, atol=1e-9)
            got = tparams[n].float().numpy()
            want = np.asarray(jparams[n]).astype(np.float32)
            if dtype == "bfloat16":
                np.testing.assert_allclose(got, want, rtol=2 ** -7)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    # the schedule crossed warmup into the cosine part
    lrs = [float(opt.lr_at(OC, torch.tensor(s, dtype=torch.int32)))
           for s in range(5)]
    assert lrs[1] == pytest.approx(OC.lr) and lrs[4] < lrs[2]


def test_error_feedback_compressor_three_steps():
    rng = np.random.default_rng(2)
    mine, theirs = gc.make_error_feedback_compressor(), \
        jgc.make_error_feedback_compressor()
    ts = js = None
    for _ in range(3):
        grads = _tree(rng, np.float32)
        tg, ts = mine({n: torch.from_numpy(g) for n, g in grads.items()}, ts)
        jg, js = jax.jit(theirs)({n: jnp.asarray(g)
                                  for n, g in grads.items()}, js)
        for n in grads:
            np.testing.assert_allclose(tg[n].numpy(), np.asarray(jg[n]),
                                       rtol=1e-6, atol=1e-7)
            # XLA fuses total - q * scale into one FMA: a residual may
            # differ by the rounding of the product, one fp32 ulp of the
            # leaf's largest value (|g| < 16 here)
            np.testing.assert_allclose(ts[n].numpy(), np.asarray(js[n]),
                                       rtol=0, atol=2 ** -19)
    q, scale = gc.quantize_int8(torch.zeros(4))
    assert float(scale) == 1.0 and q.dtype == torch.int8 and not q.any()


@pytest.mark.parametrize("arch,compress", [
    ("starcoder2-7b", True), ("mamba2-780m", False),
    ("recurrentgemma-2b", False), ("granite-moe-3b-a800m", False)])
def test_train_step_trajectory_matches_jax(arch, compress):
    jm = JaxModel(jax_smoke(arch))
    jstate = jax_init_state(jm, OC, jax.random.PRNGKey(0))
    cfg = smoke_config(arch)
    start = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate))
    if compress:
        # the reference's first step starts its residuals at zeros when
        # the state has none; given zeros here its step compiles once.
        # The port's state starts without them
        jstate["grad_comp"] = jax.tree.map(
            lambda p: jnp.zeros(p.shape, jnp.float32), jstate["params"])
    model = Model(cfg, device="cpu", state=start["params"])
    state = {"params": model.train_params(), "opt": start["opt"]}
    jstep = jax.jit(jax_train_step(
        jm, OC, num_microbatches=2,
        grad_transform=jgc.make_error_feedback_compressor()
        if compress else None))
    step = make_train_step(
        model, OC, num_microbatches=2,
        grad_transform=gc.make_error_feedback_compressor()
        if compress else None)
    pipe = TokenPipeline(cfg, 24, 4, seed=1)
    for s in range(4):
        batch = pipe.batch_at(s)
        jstate, jmets = jstep(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        state, mets = step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        assert set(mets) == set(jmets)
        for k in mets:
            np.testing.assert_allclose(float(mets[k]), float(jmets[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        assert ("grad_comp" in state) == compress
        jflat = flatten(jax.tree.map(np.asarray, jstate["params"]))
        for n, p in state["params"].items():
            np.testing.assert_allclose(p.detach().numpy(), jflat[n],
                                       rtol=0, atol=2e-4 if compress
                                       else 2e-5, err_msg=n)
    assert int(state["opt"]["step"]) == 4
