"""The port's plain flash attention (`repro_torch.kernels.flash_attention.ref`)
against the JAX oracle (`ref.attention`) and the Pallas kernel run in
interpret mode, on every case of the JAX spec at the spec's tolerance,
plus a g = 9 (starcoder2-7b's grouping) and a ragged-length case against
the oracle; the dispatch contract and the CUDA wrapper's argument checks;
and the port's prefill, which now attends through the flash wrapper,
against the JAX prefill."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.kernels.flash_attention import ref as jref
from repro.kernels.flash_attention import spec as jspec
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.models import Model as JaxModel
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import api, registry
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    _check, flash_attention)
from repro_torch.models.transformer import Model

SPEC = registry.get("flash_attention")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _args(inp, dtype, lib):
    if lib == "jax":
        return [jnp.asarray(inp[n]).astype(JDT[dtype]) for n in SPEC.arg_names]
    return [torch.from_numpy(inp[n]).to(TDT[dtype]) for n in SPEC.arg_names]


def test_spec_matches_reference_spec():
    """Same cases (shapes, dtypes, keyword arguments), tolerances and
    bit-identical example inputs as the JAX spec."""
    js = jspec.SPEC
    assert [dict(c.shape) for c in SPEC.cases] == \
        [dict(c.shape) for c in js.cases]
    assert [c.dtype for c in SPEC.cases] == [c.dtype for c in js.cases]
    assert [dict(c.kwargs) for c in SPEC.cases] == \
        [dict(c.kwargs) for c in js.cases]
    assert dict(SPEC.tol) == dict(js.tol)
    assert SPEC.arg_names == js.arg_names
    for case in SPEC.cases:
        mine = SPEC.example_inputs(shape=dict(case.shape))
        theirs = js.example_inputs(shape=dict(case.shape))
        for n in SPEC.arg_names:
            np.testing.assert_array_equal(mine[n], theirs[n])


@pytest.mark.parametrize("i", range(len(jspec.SPEC.cases)))
def test_plain_matches_jax_oracle_and_pallas(i):
    case = SPEC.cases[i]
    kw = dict(case.kwargs)
    inp = SPEC.example_inputs(shape=dict(case.shape))
    tol = SPEC.tol[case.dtype]
    # the oracle's semantics in fp32 on both sides
    got32 = api.run("flash_attention", *_args(inp, "float32", "torch"),
                    backend="ref", **kw).numpy()
    want32 = np.asarray(jref.attention(*_args(inp, "float32", "jax"), **kw))
    np.testing.assert_allclose(got32, want32, atol=5e-6, rtol=0)
    # the case's dtype: the port's plain version within tol of the JAX
    # oracle and of the interpreted Pallas kernel, both in that dtype
    got = api.run("flash_attention", *_args(inp, case.dtype, "torch"),
                  **kw).float().numpy()
    jargs = _args(inp, case.dtype, "jax")
    oracle = np.asarray(jref.attention(*jargs, **kw), np.float32)
    tile = dict(jspec.SPEC.cases[i].tile)
    pallas = np.asarray(flash_attention_pallas(
        *jargs, block_q=tile["block_q"], block_k=tile["block_k"],
        interpret=True, **kw), np.float32)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)


@pytest.mark.parametrize("shape,kw", [
    # starcoder2-7b's grouping: 36 query heads over 4 kv heads
    ({"b": 1, "sq": 40, "skv": 40, "hq": 9, "hkv": 1, "d": 16}, {}),
    # ragged lengths no block size divides (the Pallas kernel cannot take
    # them; the CUDA kernel masks its last tile), windowed
    ({"b": 2, "sq": 37, "skv": 37, "hq": 6, "hkv": 2, "d": 24},
     {"window": 11}),
], ids=["g9", "ragged_window"])
def test_plain_matches_oracle_off_spec(shape, kw):
    inp = SPEC.example_inputs(shape=shape, seed=3)
    got = ref.attention(*_args(inp, "float32", "torch"), **kw).numpy()
    want = np.asarray(jref.attention(*_args(inp, "float32", "jax"), **kw))
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


def test_run_dispatch_and_plain_call_count():
    inp = SPEC.example_inputs(shape=dict(SPEC.cases[0].shape))
    args = _args(inp, "float32", "torch")
    with pytest.raises(ValueError, match="CUDA"):
        api.run("flash_attention", *args, backend="cuda")
    with pytest.raises(ValueError, match="tile"):
        api.run("flash_attention", *args, tile={"block_q": 64})
    launches, plain = flash_attention.launches, flash_attention.plain_calls
    out = api.run("flash_attention", *args, causal=False)   # auto on CPU
    assert flash_attention.plain_calls == plain + 1
    assert flash_attention.launches == launches
    np.testing.assert_array_equal(
        out.numpy(), ref.attention(*args, causal=False).numpy())
    assert "flash_attention" in registry.names()


@pytest.mark.parametrize("breakage", [
    "dtype", "mixed_dtype", "noncontiguous", "head_dim", "kv_heads",
    "kv_shape", "window"])
def test_cuda_wrapper_checks_raise(breakage):
    """The checks the wrapper runs before a launch (exercised on CPU
    tensors: the same Python code the card path runs)."""
    inp = SPEC.example_inputs(shape=dict(SPEC.cases[0].shape))
    q, k, v = _args(inp, "float32", "torch")
    window = 0
    if breakage == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif breakage == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif breakage == "noncontiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif breakage == "head_dim":
        q = torch.zeros(q.shape[:-1] + (300,))
        k = torch.zeros(k.shape[:-1] + (300,))
        v = torch.zeros(v.shape[:-1] + (300,))
    elif breakage == "kv_heads":
        q = torch.zeros(q.shape[:2] + (3,) + q.shape[3:])
    elif breakage == "kv_shape":
        v = v[:, :-1].contiguous()
    elif breakage == "window":
        window = -1
    with pytest.raises((ValueError, TypeError)):
        _check(q, k, v, window)
    _check(*_args(inp, "bfloat16", "torch"), 0)     # valid arguments pass


@pytest.mark.parametrize("arch", ["starcoder2-7b", "llama3-405b"])
def test_forward_prefill_matches_jax_through_flash(arch):
    """The port's prefill (flash attention, plain version on the CPU)
    against the JAX `forward_prefill` (jnp `attention_core`) at fp32: last
    position logits and the K/V caches, every layer's attention through
    the flash wrapper."""
    jm = JaxModel(jax_smoke(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    model = Model(smoke_config(arch), device="cpu", state=params_from_numpy(
        smoke_config(arch), jax.tree.map(np.asarray, jparams)))
    toks = np.random.default_rng(0).integers(
        0, smoke_config(arch).vocab_size, (2, 13)).astype(np.int32)
    want, wcaches = jax.jit(jm.forward_prefill)(
        jparams, {"tokens": jnp.asarray(toks)})
    plain = flash_attention.plain_calls
    got, caches = model.forward_prefill(torch.from_numpy(toks))
    assert flash_attention.plain_calls - plain == smoke_config(arch).num_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    wk = np.asarray(wcaches["groups"]["l0"]["k"])        # (groups, b, s, ...)
    np.testing.assert_allclose(caches[0]["k"].numpy(), wk[0], atol=1e-5,
                               rtol=0)
