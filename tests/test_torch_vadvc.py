"""The port's COSMO vertical advection (`repro_torch.kernels.vadvc`): its
plain version against the JAX oracle (`ref.vadvc`) and the Pallas kernel
run in interpret mode on every case of the JAX spec, at the spec's
tolerance taken as the JAX package's conformance test takes it (rtol =
atol = tol, ``tests/test_kernels.py``: the tridiagonal systems of the
random inputs are badly conditioned in places, so the outputs reach
|out| ~ 200 at the spec's own cases); the end levels at nz = 1 and 2;
`chip_smoke.py`'s broken variant against its correct form; the spec,
the dispatch's tile rules, the wrapper's counts and each route's
shared-memory limit."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vadvc import ref as jref
from repro.kernels.vadvc import spec as jspec
from repro.kernels.vadvc.vadvc import vadvc_pallas
from repro_torch.kernels import api, registry
from repro_torch.kernels.vadvc import ref
from repro_torch.kernels.vadvc.vadvc import simt_smem_bytes, smem_bytes, \
    vadvc

ROOT = Path(__file__).resolve().parents[1]
SPEC = registry.get("vadvc")


@pytest.fixture(scope="module")
def chip_smoke():
    """`chip_smoke.py` as a module (its helpers run on any device)."""
    mod_spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _inputs(shape, seed=0):
    inp = SPEC.example_inputs(shape=shape, seed=seed)
    return ([torch.from_numpy(inp[n]) for n in SPEC.arg_names],
            [jnp.asarray(inp[n]) for n in SPEC.arg_names])


def test_spec_matches_reference_spec():
    js = jspec.SPEC
    assert [(dict(c.shape), c.dtype) for c in SPEC.cases] == \
        [(dict(c.shape), c.dtype) for c in js.cases]
    assert dict(SPEC.tol) == dict(js.tol)
    assert SPEC.arg_names == js.arg_names
    assert SPEC.shape_keys == js.shape_keys
    assert dict(SPEC.default_shape) == dict(js.default_shape)
    assert dict(SPEC.bench_shape) == dict(js.bench_shape)
    assert SPEC.dtypes == js.dtypes
    for case in SPEC.cases:
        mine = SPEC.example_inputs(shape=dict(case.shape), seed=5)
        theirs = js.example_inputs(shape=dict(case.shape), seed=5)
        for n in SPEC.arg_names:
            np.testing.assert_array_equal(mine[n], theirs[n])


@pytest.mark.parametrize("i", range(len(jspec.SPEC.cases)))
def test_plain_matches_jax_oracle_and_pallas(i):
    case = SPEC.cases[i]
    tol = SPEC.tol[case.dtype]
    targs, jargs = _inputs(dict(case.shape))
    got = api.run("vadvc", *targs).numpy()               # plain on the CPU
    want = np.asarray(jref.vadvc(*jargs))
    pallas = np.asarray(vadvc_pallas(
        *jargs, tile_y=jspec.SPEC.cases[i].tile["tile_y"], interpret=True))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


@pytest.mark.parametrize("nz", [1, 2])
def test_end_levels_match_oracle(nz):
    """nz = 1 (k = 0 is also the last level: correction 0, both
    coefficients 0) and nz = 2 (only the two end levels)."""
    targs, jargs = _inputs({"nz": nz, "ny": 6, "nx": 40}, seed=nz)
    got = ref.vadvc(*targs).numpy()
    want = np.asarray(jref.vadvc(*jargs))
    np.testing.assert_allclose(got, want, rtol=SPEC.tol["float32"],
                               atol=SPEC.tol["float32"])


def test_broken_variant_differs_correct_form_equals(chip_smoke):
    """`chip_smoke.vadvc_variant` with no fault equals the plain version
    to the bit; with level 0's correction dropped it differs in many
    elements, so the card's bit-equality check rejects such a kernel."""
    targs, _ = _inputs({"nz": 16, "ny": 8, "nx": 64})
    want = ref.vadvc(*targs)
    assert chip_smoke.exact_check(chip_smoke.vadvc_variant(*targs),
                                  want)["mismatches"] == 0
    broken = chip_smoke.exact_check(
        chip_smoke.vadvc_variant(*targs, fault="drop_k0_correction"), want)
    assert broken["mismatches"] > 100 and broken["max_ulps"] > 2


def test_tile_rules_counts_and_shared_memory():
    targs, _ = _inputs(dict(SPEC.cases[0].shape))
    want = ref.vadvc(*targs)
    with pytest.raises(ValueError, match="backend='ref'"):
        api.run("vadvc", *targs, backend="ref", tile={"tile_y": 2})
    with pytest.raises(ValueError, match="unknown tile"):
        api.run("vadvc", *targs, tile={"block_z": 2})
    with pytest.raises(ValueError, match="CUDA"):
        api.run("vadvc", *targs, backend="cuda")
    launches, plain = vadvc.launches, vadvc.plain_calls
    assert torch.equal(api.run("vadvc", *targs), want)
    assert vadvc.plain_calls == plain + 1 and vadvc.launches == launches
    # the simt route: ccol and dcol of every level, 2 nz floats a column
    assert simt_smem_bytes(64, 128, 1) == 64 * 1024
    assert simt_smem_bytes(64, 128, 4) > 232_448    # 128 x 4: not feasible
    # the prefetch route keeps upos beside them: 3 nz floats a column
    assert smem_bytes(64, 128, 1) == 96 * 1024
    cost = SPEC.cost_fn((64, 256, 256), {"tile_x": 128, "tile_y": 4}, 4)
    assert cost[0] == smem_bytes(64, 128, 4) > 232_448   # listed, not
    # feasible
