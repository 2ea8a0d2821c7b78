"""The port's plain paged attention (`repro_torch.kernels.paged_attention.ref`)
against the JAX oracle and the Pallas kernel run in interpret mode, on
every case of the JAX spec, with flat and layer-stacked pools, mixed
fast/slow pages and a dead row of length 1 — plus the port's dispatch
contract (`kernels.api.run`) and the CUDA wrapper's argument checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels.paged_attention import spec as jspec
from repro_torch.kernels import api, registry
from repro_torch.kernels.paged_attention import paged_attention as pa_mod
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.paged_attention.paged_attention import (
    _check, paged_attention)

SPEC = registry.get("paged_attention")
N_JAX = len(jspec.SPEC.cases)      # the port's wide case follows the JAX ones
POOLS = ("k_pages", "v_pages", "k_quant", "v_quant", "k_scale", "v_scale")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, stacked: bool):
    """The case's numpy inputs; a dead row (length 1, zero table) when the
    batch has more than one row; layer-stacked: the case's pools are
    layer 1 of 3."""
    inp = SPEC.example_inputs(shape=dict(case.shape))
    if inp["q"].shape[0] > 1:
        inp["lengths"][-1] = 1
        inp["page_table"][-1] = 0
    layer = None
    if stacked:
        others = [SPEC.example_inputs(shape=dict(case.shape), seed=s)
                  for s in (1, 2)]
        for n in POOLS:
            inp[n] = np.stack([others[0][n], inp[n], others[1][n]])
        layer = 1
    return inp, layer


def _jax_args(inp, dtype):
    def cast(v):
        v = jnp.asarray(v)
        return v if jnp.issubdtype(v.dtype, jnp.integer) else v.astype(dtype)
    return [cast(inp[n]) for n in SPEC.arg_names]


def _torch_args(inp, dtype):
    def cast(v):
        t = torch.from_numpy(v)
        return t if not t.is_floating_point() else t.to(dtype)
    return [cast(inp[n]) for n in SPEC.arg_names]


def test_spec_matches_reference_spec():
    """The JAX spec's cases (then the port's one wide case), tolerances
    and (bit-identical) example inputs, so both sides hold the kernel to
    the same data."""
    js = jspec.SPEC
    assert [dict(c.shape) for c in SPEC.cases[:N_JAX]] == \
        [dict(c.shape) for c in js.cases]
    assert [c.dtype for c in SPEC.cases[:N_JAX]] == \
        [c.dtype for c in js.cases]
    assert len(SPEC.cases) == N_JAX + 1
    assert dict(SPEC.tol) == dict(js.tol)
    assert SPEC.arg_names == js.arg_names
    for case in SPEC.cases:
        mine = SPEC.example_inputs(shape=dict(case.shape))
        theirs = js.example_inputs(shape=dict(case.shape))
        for n in SPEC.arg_names:
            np.testing.assert_array_equal(mine[n], theirs[n])


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("i", range(N_JAX))
def test_plain_matches_jax_oracle_and_pallas(i, stacked):
    case = SPEC.cases[i]
    inp, layer = _inputs(case, stacked)
    extra = () if layer is None else (layer,)
    tol = SPEC.tol[case.dtype]
    # reference semantics in fp32 on both sides
    got32 = api.run("paged_attention", *_torch_args(inp, torch.float32),
                    *extra, backend="ref").numpy()
    want32 = np.asarray(japi.run("paged_attention",
                                 *_jax_args(inp, jnp.float32),
                                 *((jnp.int32(layer),) if stacked else ()),
                                 backend="ref"))
    np.testing.assert_allclose(got32, want32, atol=5e-6, rtol=0)
    # the case's dtype: the port's plain version and the interpreted
    # Pallas kernel each within tol of the fp32 oracle
    got = api.run("paged_attention", *_torch_args(inp, TDT[case.dtype]),
                  *extra).float().numpy()
    pallas = np.asarray(japi.run(
        "paged_attention", *_jax_args(inp, JDT[case.dtype]),
        *((jnp.int32(layer),) if stacked else ()), backend="pallas",
        tile=dict(jspec.SPEC.cases[i].tile), interpret=True), np.float32)
    np.testing.assert_allclose(got, want32, atol=tol, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)


def test_run_contract_and_plain_call_count():
    inp, _ = _inputs(SPEC.cases[0], stacked=False)
    args = _torch_args(inp, torch.float32)
    with pytest.raises(ValueError, match="backend"):
        api.run("paged_attention", *args, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        api.run("paged_attention", *args, backend="cuda")
    with pytest.raises(ValueError, match="tile"):
        api.run("paged_attention", *args, backend="ref",
                tile={"pages_per_block": 2})
    with pytest.raises(KeyError, match="no kernel"):
        api.run("nope", *args)
    launches, plain = paged_attention.launches, paged_attention.plain_calls
    out = api.run("paged_attention", *args)           # auto on CPU: plain
    assert paged_attention.plain_calls == plain + 1
    assert paged_attention.launches == launches
    np.testing.assert_array_equal(out.numpy(), ref.paged_attention(*args)
                                  .numpy())
    with pytest.raises(ValueError, match="layer"):
        ref.paged_attention(*args, 0)


@pytest.mark.parametrize("breakage", [
    "pool_dtype", "quant_dtype", "table_dtype", "noncontiguous", "head_dim",
    "stacked_no_layer", "layer_range", "scale_shape"])
def test_cuda_wrapper_checks_raise(breakage):
    """The checks the wrapper runs before a launch (exercised here on CPU
    tensors, which is the same Python code the card path runs)."""
    inp, layer = _inputs(SPEC.cases[0], stacked=breakage in (
        "stacked_no_layer", "layer_range"))
    a = dict(zip(SPEC.arg_names, _torch_args(inp, torch.float32)))
    if breakage == "pool_dtype":
        a["v_pages"] = a["v_pages"].double()
    elif breakage == "quant_dtype":
        a["k_quant"] = a["k_quant"].int()
    elif breakage == "table_dtype":
        a["page_table"] = a["page_table"].long()
    elif breakage == "noncontiguous":
        a["q"] = a["q"].transpose(0, 1).contiguous().transpose(0, 1)
    elif breakage == "head_dim":
        a["q"] = torch.zeros(a["q"].shape[:-1] + (300,))
    elif breakage == "stacked_no_layer":
        layer = None
    elif breakage == "layer_range":
        layer = 3
    elif breakage == "scale_shape":
        a["k_scale"] = a["k_scale"][..., :1].contiguous()
    with pytest.raises((ValueError, TypeError)):
        _check(*(a[n] for n in SPEC.arg_names), layer)


def test_cuda_wrapper_accepts_valid_arguments():
    for stacked in (False, True):
        inp, layer = _inputs(SPEC.cases[4], stacked)
        _check(*_torch_args(inp, torch.bfloat16), layer)
    assert pa_mod.MAX_HEAD_DIM >= 128
