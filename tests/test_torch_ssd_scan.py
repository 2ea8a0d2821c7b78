"""The port's SSD scan (`repro_torch.kernels.ssd_scan`): its plain versions
against the JAX oracle (`ref.ssd`) and the Pallas kernel run in
interpret mode on every case of the JAX spec at the spec's tolerance, y
and final state; the chunked form against the JAX model's
`ssd_chunked` at ragged lengths; the CUDA kernel's 64-chunk algorithm
(`chip_smoke.ssd_chunk_loop`, plain PyTorch) against the oracle, and the
on-card limit (`chip_smoke.ssd_limit`) passing it while rejecting two
deliberately broken chunk loops; the dispatch contract and the wrapper's
argument checks; and the Mamba2 layer's prefill and one-token step
against the JAX layer."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.kernels.ssd_scan import ref as jref
from repro.kernels.ssd_scan import spec as jspec
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro.models.common import materialize
from repro_torch.configs import smoke_config
from repro_torch.kernels import api, registry
from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan.ssd_scan import _check, ssd_scan
from repro_torch.models import ssm

SPEC = registry.get("ssd_scan")
ROOT = Path(__file__).resolve().parents[1]


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
    """Same cases, tolerance and bit-identical example inputs as the JAX
    spec (whose tiles the port's fixed-chunk kernel does not take)."""
    js = jspec.SPEC
    assert [dict(c.shape) for c in SPEC.cases] == \
        [dict(c.shape) for c in js.cases]
    assert [c.dtype for c in SPEC.cases] == ["float32"] * len(js.cases)
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
    tol = SPEC.tol[case.dtype]
    targs, jargs = _inputs(dict(case.shape))
    y, state = api.run("ssd_scan", *targs)              # plain on the CPU
    want_y, want_state = (np.asarray(a) for a in jref.ssd(*jargs))
    pallas = np.asarray(ssd_scan_pallas(
        *jargs, chunk=jspec.SPEC.cases[i].tile["chunk"], interpret=True))
    np.testing.assert_allclose(y.numpy(), want_y, atol=tol, rtol=0)
    np.testing.assert_allclose(y.numpy(), pallas, atol=tol, rtol=0)
    np.testing.assert_allclose(state.numpy(), want_state, atol=tol, rtol=0)
    # the token-level twin of the oracle
    ty, tstate = ref.ssd(*targs)
    np.testing.assert_allclose(ty.numpy(), want_y, atol=tol, rtol=0)
    np.testing.assert_allclose(tstate.numpy(), want_state, atol=tol, rtol=0)


@pytest.mark.parametrize("s_len,chunk", [(100, 32), (96, 32), (75, 256)])
def test_chunked_matches_jax_ssd_chunked(s_len, chunk):
    """`ref.ssd_chunked` is the JAX model's `ssd_chunked`: chunked when
    the chunk divides S, one chunk otherwise; y and final state, at the
    spec's fp32 tolerance (the einsums sum in another order)."""
    shape = {"B": 2, "S": s_len, "H": 6, "P": 8, "G": 3, "N": 16}
    targs, jargs = _inputs(shape, seed=4)
    y, state = ref.ssd_chunked(*targs, chunk=chunk)
    want_y, want_state = jssm.ssd_chunked(*jargs, chunk)
    tol = SPEC.tol["float32"]
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("shape", [
    {"B": 1, "S": 1000, "H": 4, "P": 64, "G": 1, "N": 128},
    {"B": 2, "S": 300, "H": 8, "P": 16, "G": 2, "N": 32},
], ids=["S1000", "S300_groups"])
def test_limit_passes_kernel_chunking_rejects_broken(chip_smoke, shape):
    """The CUDA kernel's algorithm (64-position chunks, ragged last chunk
    masked) stays well inside the on-card limit against the plain
    version; a loop that drops chunk 1's inter-chunk term or skips the
    ragged last chunk is far outside it."""
    targs, _ = _inputs(shape, seed=2)
    want = ref.ssd_chunked(*targs)
    assert chip_smoke.over_ssd_limit(chip_smoke.ssd_chunk_loop(*targs),
                                     want) < 0.25
    for fault in ("drop_inter", "skip_ragged"):
        got = chip_smoke.ssd_chunk_loop(*targs, fault=fault)
        assert chip_smoke.over_ssd_limit(got, want) > 10.0, fault


@pytest.mark.parametrize("i", range(len(jspec.SPEC.cases)))
def test_kernel_chunking_matches_oracle(chip_smoke, i):
    case = SPEC.cases[i]
    targs, jargs = _inputs(dict(case.shape))
    y, state = chip_smoke.ssd_chunk_loop(*targs)
    want_y, want_state = (np.asarray(a) for a in jref.ssd(*jargs))
    np.testing.assert_allclose(y.numpy(), want_y, atol=SPEC.tol["float32"],
                               rtol=0)
    np.testing.assert_allclose(state.numpy(), want_state,
                               atol=SPEC.tol["float32"], rtol=0)


def test_run_dispatch_and_plain_call_count():
    targs, _ = _inputs(dict(SPEC.cases[0].shape))
    with pytest.raises(ValueError, match="CUDA"):
        api.run("ssd_scan", *targs, backend="cuda")
    with pytest.raises(ValueError, match="tile"):
        api.run("ssd_scan", *targs, backend="ref", tile={"chunk": 64})
    launches, plain = ssd_scan.launches, ssd_scan.plain_calls
    y, state = api.run("ssd_scan", *targs)            # auto on the CPU
    assert ssd_scan.plain_calls == plain + 1
    assert ssd_scan.launches == launches
    want_y, want_state = ref.ssd_chunked(*targs)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    assert "ssd_scan" in registry.names()


@pytest.mark.parametrize("breakage", [
    "x_dtype", "mixed_dtype", "dt_dtype", "noncontiguous", "groups",
    "dt_shape", "state_size"])
def test_cuda_wrapper_checks_raise(breakage):
    """The checks the wrapper runs before a launch (exercised on CPU
    tensors: the same Python code the card path runs)."""
    (x, b, c, dt, a), _ = _inputs(dict(SPEC.cases[1].shape))
    if breakage == "x_dtype":
        x, b, c = x.double(), b.double(), c.double()
    elif breakage == "mixed_dtype":
        c = c.to(torch.bfloat16)
    elif breakage == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    elif breakage == "noncontiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif breakage == "groups":
        b, c = b[:, :, :1].repeat(1, 1, 3, 1), c[:, :, :1].repeat(1, 1, 3, 1)
    elif breakage == "dt_shape":
        dt = dt[:, :-1].contiguous()
    elif breakage == "state_size":
        b = torch.zeros(b.shape[:3] + (300,))
        c = torch.zeros(c.shape[:3] + (300,))
    with pytest.raises((ValueError, TypeError)):
        _check(x, b, c, dt, a)
    (x, b, c, dt, a), _ = _inputs(dict(SPEC.cases[1].shape))
    _check(x.to(torch.bfloat16), b.to(torch.bfloat16), c.to(torch.bfloat16),
           dt, a)                                   # valid arguments pass


@pytest.fixture(scope="module")
def layer():
    """mamba2-780m's smoke SSD layer params in both frameworks."""
    jcfg = jax_smoke("mamba2-780m")
    jp = materialize(jssm.ssm_spec(jcfg), jax.random.PRNGKey(3), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, jp, smoke_config("mamba2-780m"), tp


@pytest.mark.parametrize("s_len", [40, 64, 7])
def test_ssm_prefill_and_step_match_jax(layer, s_len):
    """The Mamba2 mixer's prefill (plain scan on the CPU, through the
    wrapper) and its one-token step against the JAX mixer: y, the conv
    taps and the final state, then one decode step from that cache, at
    1e-4 (the model tests' fp32 tolerance; the scan chunks by 256 here
    and by the config's 32 there)."""
    jcfg, jp, cfg, tp = layer
    x = np.random.default_rng(s_len).normal(
        size=(2, s_len, cfg.d_model)).astype(np.float32)
    want, wcache = jssm.ssm_apply(jcfg, jp, jnp.asarray(x), mode="prefill")
    plain = ssd_scan.plain_calls
    got, cache = ssm.ssm_apply(cfg, tp, torch.from_numpy(x), mode="prefill")
    assert ssd_scan.plain_calls == plain + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    for key in ("conv", "state"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(wcache[key]), atol=1e-4,
                                   rtol=0)
    x1 = np.random.default_rng(9).normal(
        size=(2, 1, cfg.d_model)).astype(np.float32)
    want1, wcache1 = jssm.ssm_apply(jcfg, jp, jnp.asarray(x1), mode="decode",
                                    cache=wcache)
    got1, cache1 = ssm.ssm_apply(cfg, tp, torch.from_numpy(x1),
                                 mode="decode", cache=cache)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(cache1["state"].numpy(),
                               np.asarray(wcache1["state"]), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("s_len", [7, 32])
def test_bf16_intra_is_not_ported(layer, s_len):
    """``ssm_bf16_intra`` (once refused, now the reference's rounding): the
    mixer's prefill with the flag against the JAX mixer's at lengths one
    chunk holds on both sides (the JAX mixer chunks by the config's 32,
    the port's plain scan by 256), at the fp32 tolerance; the flag moves
    y by more than that."""
    jcfg, jp, cfg, tp = layer
    jcfg = dataclasses.replace(jcfg, ssm_bf16_intra=True)
    cfg = dataclasses.replace(cfg, ssm_bf16_intra=True)
    x = np.random.default_rng(s_len).normal(
        size=(2, s_len, cfg.d_model)).astype(np.float32)
    want, _ = jssm.ssm_apply(jcfg, jp, jnp.asarray(x), mode="prefill")
    got, _ = ssm.ssm_apply(cfg, tp, torch.from_numpy(x), mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    fp32, _ = ssm.ssm_apply(dataclasses.replace(cfg, ssm_bf16_intra=False),
                            tp, torch.from_numpy(x), mode="prefill")
    assert float((fp32 - got).abs().max()) > 1e-4


@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_bf16_intra_plain_matches_reference_chunked(chunk):
    """`ref.ssd_chunked(bf16_intra=True)` against the reference model's
    ``ssd_chunked(bf16_intra=True)`` on the spec's inputs, both at the
    same chunk. The rounding is the same (scores and x to bf16, the sum
    fp32), but a score whose two fp32 values (each side's exp and sums)
    straddle a bf16 rounding boundary rounds one bf16 step apart: so y
    within 2^-8 of max |y| (one such step of the largest term), and past
    the fp32 tolerance in under 1% of its elements (0.11% at chunk
    256); the final state, which the flag does not round, at the fp32
    tolerance."""
    (x, b, c, dt, a), _ = _inputs({"B": 2, "S": 256, "H": 4, "P": 16,
                                   "G": 2, "N": 16})
    want_y, want_h = jssm.ssd_chunked(
        *(jnp.asarray(t.numpy()) for t in (x, b, c, dt, a)), chunk=chunk,
        bf16_intra=True)
    got_y, got_h = ref.ssd_chunked(x, b, c, dt, a, chunk=chunk,
                                   bf16_intra=True)
    err = np.abs(got_y.numpy() - np.asarray(want_y))
    assert err.max() <= 2.0 ** -8 * np.abs(np.asarray(want_y)).max()
    assert (err > 1e-4).mean() < 0.01
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-4,
                               rtol=1e-4)
    plain_y, _ = ref.ssd_chunked(x, b, c, dt, a, chunk=chunk)
    assert float((plain_y - got_y).abs().max()) > 1e-4
    # the spec's work moves the scores times x to the bf16 class
    from repro_torch.kernels.ssd_scan.spec import work
    w0, w1 = work(x, b, c, dt, a), work(x, b, c, dt, a, bf16_intra=True)
    assert w1["bytes"] == w0["bytes"]
    assert sum(w1["flops"].values()) == sum(w0["flops"].values())
    assert w1["flops"]["bf16"] > 0 and w1["flops"]["fp32"] < \
        w0["flops"]["fp32"]


# ---------------------------------------------------------------------------
# the wgmma route (chunk-parallel, tensor cores): its arithmetic emulated in
# plain PyTorch (`chip_smoke.ssd_wgmma_loop`), its route rule, its checks
# ---------------------------------------------------------------------------
def _bf16_inputs(shape, seed):
    """The spec's generator with x, B and C rounded to bf16 (the route's
    inputs), as fp32 tensors for the emulation and the plain versions,
    and the same values for JAX."""
    targs, _ = _inputs(shape, seed)
    targs = [t.to(torch.bfloat16).float() if i < 3 else t
             for i, t in enumerate(targs)]
    return targs, [jnp.asarray(t.numpy()) for t in targs]


WGMMA_SHAPES = [
    {"B": 1, "S": 300, "H": 3, "P": 64, "G": 1, "N": 128},
    {"B": 2, "S": 1000, "H": 4, "P": 64, "G": 2, "N": 128},
    {"B": 1, "S": 1536, "H": 2, "P": 64, "G": 1, "N": 128},
    {"B": 1, "S": 1536, "H": 4, "P": 64, "G": 2, "N": 128},
]
WGMMA_IDS = ["S300", "S1000_G2", "S1536", "S1536_G2"]


@pytest.mark.parametrize("shape", WGMMA_SHAPES, ids=WGMMA_IDS)
def test_wgmma_arithmetic_within_limit(chip_smoke, shape):
    """The wgmma route's arithmetic -- chunks of 128, the scores, w . x and
    h_prev in two bf16 pieces each, exact bf16 products in fp32 -- stays
    well inside the on-card limit against the plain version and the JAX
    oracle (the token-level recurrence) on the same bf16-valued inputs."""
    targs, jargs = _bf16_inputs(shape, seed=shape["S"])
    got = chip_smoke.ssd_wgmma_loop(*targs)
    assert chip_smoke.over_ssd_limit(got, ref.ssd_chunked(*targs)) < 0.1
    oracle = tuple(torch.from_numpy(np.array(t)) for t in jref.ssd(*jargs))
    assert chip_smoke.over_ssd_limit(got, oracle) < 0.1


@pytest.mark.parametrize("i", range(len(jspec.SPEC.cases)))
def test_wgmma_arithmetic_on_spec_cases(chip_smoke, i):
    """The same arithmetic on the spec's cases (whose P and N the route
    sends to simt on the card: the emulation takes any shape) against
    the JAX oracle at the spec's tolerance and within the limit."""
    case = SPEC.cases[i]
    targs, jargs = _bf16_inputs(dict(case.shape), seed=0)
    y, state = chip_smoke.ssd_wgmma_loop(*targs)
    want_y, want_state = (np.asarray(a) for a in jref.ssd(*jargs))
    tol = SPEC.tol["float32"]
    np.testing.assert_allclose(y.numpy(), want_y, atol=tol, rtol=0)
    np.testing.assert_allclose(state.numpy(), want_state, atol=tol, rtol=0)
    # the limit is tightest at S = 1 (it grows with sqrt(S)): 0.19 there
    assert chip_smoke.over_ssd_limit(
        (y, state), ref.ssd_chunked(*targs)) < 0.25


@pytest.mark.parametrize("shape", WGMMA_SHAPES[1:3], ids=WGMMA_IDS[1:3])
@pytest.mark.parametrize("operand", ["score_pieces", "wx_pieces"])
def test_one_bf16_piece_is_not_enough(chip_smoke, shape, operand):
    """The scores or w . x in one bf16 piece miss the limit: the route
    needs two."""
    targs, _ = _bf16_inputs(shape, seed=shape["S"])
    got = chip_smoke.ssd_wgmma_loop(*targs, **{operand: 1})
    assert chip_smoke.over_ssd_limit(got, ref.ssd_chunked(*targs)) > 1.2


@pytest.mark.parametrize("shape", WGMMA_SHAPES[1:3], ids=WGMMA_IDS[1:3])
def test_wgmma_broken_variants(chip_smoke, shape):
    """A state pass that leaves chunk 1's state out is far over the limit.
    h_prev in one bf16 piece stays inside it at these shapes (the limit
    does not demand the second piece; the route keeps it for margin)."""
    targs, _ = _bf16_inputs(shape, seed=shape["S"])
    want = ref.ssd_chunked(*targs)
    skip = chip_smoke.ssd_wgmma_loop(*targs, fault="skip_state_chunk")
    assert chip_smoke.over_ssd_limit(skip, want) > 10.0
    one = chip_smoke.ssd_wgmma_loop(*targs, fault="one_piece_state")
    over = chip_smoke.over_ssd_limit(one, want)
    two = chip_smoke.over_ssd_limit(chip_smoke.ssd_wgmma_loop(*targs), want)
    assert 5 * two < over < 1.0


def test_wgmma_chunk_of_64_within_limit(chip_smoke):
    """The route's other chunk (tools/ssd_variants.py times both)."""
    shape = WGMMA_SHAPES[1]
    targs, _ = _bf16_inputs(shape, seed=7)
    got = chip_smoke.ssd_wgmma_loop(*targs, chunk=64)
    assert chip_smoke.over_ssd_limit(got, ref.ssd_chunked(*targs)) < 0.1


@pytest.mark.parametrize("dtype,S,P,N,G,want", [
    (torch.bfloat16, 1536, 64, 128, 1, "wgmma"),
    (torch.bfloat16, 1, 64, 128, 1, "wgmma"),
    (torch.bfloat16, 1000, 64, 64, 2, "wgmma"),
    (torch.float32, 1536, 64, 128, 1, "simt"),
    (torch.bfloat16, 64, 16, 8, 1, "simt"),
    (torch.bfloat16, 64, 64, 256, 1, "simt"),
    (torch.bfloat16, 64, 128, 128, 1, "simt"),
])
def test_route(dtype, S, P, N, G, want):
    from repro_torch.kernels.ssd_scan.ssd_scan import route
    assert route(dtype, S, P, N, G) == want


def test_spec_cases_take_simt():
    """The spec's cases (fp32, P <= 32, N <= 16) all take the simt route,
    as in bf16 (N below the tensor cores' depth of 16 is not padded)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import route
    for case in SPEC.cases:
        s = dict(case.shape)
        for dtype in (torch.float32, torch.bfloat16):
            assert route(dtype, s["S"], s["P"], s["N"], s["G"]) == "simt"


def test_launch_counts_untouched_on_cpu():
    targs, _ = _inputs(dict(SPEC.cases[0].shape))
    launches, by_route = ssd_scan.launches, dict(ssd_scan.launches_by_route)
    api.run("ssd_scan", *targs)
    assert ssd_scan.launches == launches
    assert ssd_scan.launches_by_route == by_route
    assert set(by_route) == {"wgmma", "simt"}


def test_wgmma_route_checks_alignment():
    """The wgmma route loads x, B and C 16 bytes a copy: a tensor that
    starts off a 16-byte boundary raises before any launch."""
    shape = {"B": 1, "S": 8, "H": 2, "P": 64, "G": 1, "N": 128}
    (x, b, c, dt, a), _ = _inputs(shape)
    x, b, c = (t.to(torch.bfloat16) for t in (x, b, c))
    _check(x, b, c, dt, a)
    shifted = torch.empty(x.numel() + 1, dtype=torch.bfloat16)[1:]
    shifted = shifted.view(x.shape).copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        _check(shifted, b, c, dt, a)


def test_wgmma_scratch_shapes():
    from repro_torch.kernels.ssd_scan.ssd_scan import wgmma_scratch
    states, decay = wgmma_scratch(3, 1000, 48, 128, "cpu")
    assert tuple(states.shape) == (3, 8, 48, 64, 128)
    assert tuple(decay.shape) == (3, 8, 48)
    assert states.dtype == decay.dtype == torch.float32


def test_wrapper_constants_match_the_source():
    """The wrapper sizes the wgmma route's scratch and the emulation
    chunks by `WGMMA_CHUNK` and `WGMMA_PIECES`; the CUDA source builds
    its own constants (the wrapper also compares them when it loads the
    library on the card)."""
    import re
    from repro_torch.kernels.ssd_scan.ssd_scan import WGMMA_CHUNK, \
        WGMMA_PIECES
    src = (ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu") \
        .read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src)[1]) \
        == WGMMA_CHUNK
    assert int(re.search(r"constexpr int kPieces = (\d+);", src)[1]) \
        == WGMMA_PIECES


# ---------------------------------------------------------------------------
# The wgmma route's tile (`chunk`), its Hopper cost model and knee
# ---------------------------------------------------------------------------
TILE_GRIDS = [((1, 2048, 48, 64, 1, 128), "bfloat16"),
              ((3, 1536, 48, 64, 1, 128), "bfloat16"),
              ((1, 1000, 48, 64, 1, 64), "bfloat16"),
              ((1, 2048, 48, 64, 1, 128), "float32"),
              ((2, 64, 4, 16, 1, 8), "float32")]


@pytest.mark.parametrize("grid,dtype", TILE_GRIDS)
def test_tile_space_costs_or_refuses_and_knee_is_deterministic(grid, dtype):
    """Every chunk of the space costs (the route builds both); the knee is
    the same on every search; the launch before tiles (`WGMMA_CHUNK`) is
    in the space; the simt route is flat in the tile."""
    from repro_torch.core import autotune
    from repro_torch.kernels.ssd_scan import ssd_scan as sd
    costs = autotune.space_costs(SPEC, grid, dtype)
    assert [t["chunk"] for t, _ in costs] == list(sd.WGMMA_CHUNKS)
    for tile, cost in costs:
        assert cost is not None and cost[0] >= 0 and 0 < cost[1] < np.inf
    knee = autotune.autotune_kernel(SPEC, grid, dtype)["knee"]
    assert knee == autotune.autotune_kernel(SPEC, grid, dtype)["knee"]
    assert sd.WGMMA_CHUNK in sd.WGMMA_CHUNKS == SPEC.tune_space["chunk"]
    if dtype == "float32":
        assert len({c for _, c in costs}) == 1


def test_run_takes_the_chunk_and_work_ignores_it():
    from repro_torch.core import hlo_cost
    targs, _ = _inputs(dict(SPEC.cases[0].shape))
    want = ref.ssd_chunked(*targs)
    counts = []
    for q in SPEC.tune_space["chunk"]:
        got = api.run("ssd_scan", *targs, tile={"chunk": q})
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        counts.append(hlo_cost.analyze(
            lambda *a, q=q: api.run("ssd_scan", *a, tile={"chunk": q}),
            *targs))
    assert all(c == counts[0] for c in counts) and counts[0]["kernels"]
    with pytest.raises(ValueError, match="unknown tile"):
        api.run("ssd_scan", *targs, tile={"block_q": 64})
    with pytest.raises(ValueError, match="backend='ref'"):
        api.run("ssd_scan", *targs, backend="ref", tile={"chunk": 128})


@pytest.mark.parametrize("chunk", [64, 128])
def test_wgmma_arithmetic_at_every_chunk(chip_smoke, chunk):
    """At each chunk of the space the wgmma route's arithmetic stays
    within the on-card limit, and the broken forms (chunk 1 left out of
    the state pass; the scores in one bf16 piece) go over it."""
    shape = WGMMA_SHAPES[1]
    targs, _ = _bf16_inputs(shape, seed=shape["S"])
    want = ref.ssd_chunked(*targs)
    got = chip_smoke.ssd_wgmma_loop(*targs, chunk=chunk)
    assert chip_smoke.over_ssd_limit(got, want) < 0.1
    skip = chip_smoke.ssd_wgmma_loop(*targs, chunk=chunk,
                                     fault="skip_state_chunk")
    assert chip_smoke.over_ssd_limit(skip, want) > 10.0
    one = chip_smoke.ssd_wgmma_loop(*targs, chunk=chunk, score_pieces=1)
    assert chip_smoke.over_ssd_limit(one, want) > 1.0


def test_wgmma_scratch_follows_the_chunk():
    from repro_torch.kernels.ssd_scan.ssd_scan import wgmma_scratch
    states, decay = wgmma_scratch(3, 1000, 48, 128, "cpu", chunk=64)
    assert tuple(states.shape) == (3, 16, 48, 64, 128)
    assert tuple(decay.shape) == (3, 16, 48)
