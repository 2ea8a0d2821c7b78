"""The port's COSMO horizontal diffusion (`repro_torch.kernels.hdiff`):
its plain version against the JAX oracle (`ref.hdiff`) and the Pallas
kernel run in interpret mode on every case of the JAX spec, at the spec's
tolerance taken as the JAX package's conformance test takes it (rtol =
atol = tol, ``tests/test_kernels.py``); at the COSMO grid against the
oracle; `chip_smoke.py`'s broken variant against its correct form; the
spec, the dispatch's tile rules and the wrapper's counts."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hdiff import ref as jref
from repro.kernels.hdiff import spec as jspec
from repro.kernels.hdiff.hdiff import hdiff_pallas
from repro_torch.kernels import api, registry
from repro_torch.kernels.hdiff import ref
from repro_torch.kernels.hdiff.hdiff import hdiff

ROOT = Path(__file__).resolve().parents[1]
SPEC = registry.get("hdiff")


@pytest.fixture(scope="module")
def chip_smoke():
    """`chip_smoke.py` as a module (its helpers run on any device)."""
    mod_spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def test_spec_matches_reference_spec():
    """Same case shapes and dtypes, tolerances, flops, shapes and
    bit-identical example inputs as the JAX spec (whose TPU tiles the
    port's kernel does not take)."""
    js = jspec.SPEC
    assert [(dict(c.shape), c.dtype) for c in SPEC.cases] == \
        [(dict(c.shape), c.dtype) for c in js.cases]
    assert dict(SPEC.tol) == dict(js.tol)
    assert SPEC.arg_names == js.arg_names
    assert SPEC.shape_keys == js.shape_keys
    assert dict(SPEC.default_shape) == dict(js.default_shape)
    assert dict(SPEC.bench_shape) == dict(js.bench_shape) == \
        {"nz": 64, "ny": 256, "nx": 256}
    assert SPEC.dtypes == js.dtypes
    assert SPEC.flops((4, 16, 24)) == js.flops((4, 16, 24))
    for case in SPEC.cases:
        mine = SPEC.example_inputs(shape=dict(case.shape), seed=3)
        theirs = js.example_inputs(shape=dict(case.shape), seed=3)
        np.testing.assert_array_equal(mine["src"], theirs["src"])


@pytest.mark.parametrize("i", range(len(jspec.SPEC.cases)))
def test_plain_matches_jax_oracle_and_pallas(i):
    """fp32: the plain version against the oracle and interpreted Pallas
    at the spec's 1e-5. bf16: at the spec's 0.12 (JAX rounds to bf16
    after every operation, the port once at the end)."""
    case = SPEC.cases[i]
    tol = SPEC.tol[case.dtype]
    src = SPEC.example_inputs(shape=dict(case.shape))["src"]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[case.dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[case.dtype]
    got = api.run("hdiff", torch.from_numpy(src).to(tdt)).float().numpy()
    want = np.asarray(jref.hdiff(jnp.asarray(src, jdt)).astype(jnp.float32))
    pallas = np.asarray(hdiff_pallas(
        jnp.asarray(src, jdt), block_z=jspec.SPEC.cases[i].tile["block_z"],
        interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


def test_plain_matches_oracle_at_cosmo_grid():
    """The COSMO production grid (64 x 256 x 256) in fp32: within the
    spec's 1e-5 of the oracle (equal to the bit when both run op by
    op)."""
    src = SPEC.example_inputs(shape=dict(SPEC.bench_shape))["src"]
    got = ref.hdiff(torch.from_numpy(src)).numpy()
    want = np.asarray(jref.hdiff(jnp.asarray(src)))
    np.testing.assert_allclose(got, want, rtol=0, atol=SPEC.tol["float32"])


def test_small_planes_pass_through():
    """Planes with no interior (ny or nx <= 4) pass through, as in the
    oracle."""
    src = np.random.default_rng(0).normal(size=(2, 4, 9)).astype(np.float32)
    got = ref.hdiff(torch.from_numpy(src)).numpy()
    np.testing.assert_array_equal(got, src)
    np.testing.assert_array_equal(got, np.asarray(jref.hdiff(
        jnp.asarray(src))))


def test_broken_variant_differs_correct_form_equals(chip_smoke):
    """`chip_smoke.hdiff_variant` with no fault equals the plain version
    to the bit; with the x flux's limiter skipped it differs in many
    elements, so the card's bit-equality check rejects such a kernel."""
    for dtype in (torch.float32, torch.bfloat16):
        src = torch.from_numpy(SPEC.example_inputs(
            shape={"nz": 4, "ny": 32, "nx": 48})["src"]).to(dtype)
        want = ref.hdiff(src)
        assert chip_smoke.exact_check(chip_smoke.hdiff_variant(src),
                                      want)["mismatches"] == 0
        broken = chip_smoke.exact_check(
            chip_smoke.hdiff_variant(src, fault="skip_limiter"), want)
        assert broken["mismatches"] > 1000 and broken["max_ulps"] > 2


def test_tile_rules_and_counts():
    """A tile is taken only with a tune-space name and never with "ref";
    "auto" on the CPU runs the plain version (the tile has no effect);
    "cuda" on CPU tensors raises."""
    src = torch.from_numpy(SPEC.example_inputs()["src"])
    want = ref.hdiff(src)
    with pytest.raises(ValueError, match="backend='ref'"):
        api.run("hdiff", src, backend="ref", tile={"block_z": 2})
    with pytest.raises(ValueError, match="unknown tile"):
        api.run("hdiff", src, tile={"block_q": 2})
    with pytest.raises(ValueError, match="CUDA"):
        api.run("hdiff", src, backend="cuda")
    launches, plain = hdiff.launches, hdiff.plain_calls
    assert torch.equal(api.run("hdiff", src), want)
    assert torch.equal(api.run("hdiff", src, tile={"tile_x": 64,
                                                   "tile_y": 4}), want)
    assert hdiff.plain_calls == plain + 2
    assert hdiff.launches == launches
    assert torch.equal(api.run("hdiff", src, backend="ref"), want)
