"""The port's RG-LRU scan (`repro_torch.kernels.rglru_scan`): its plain
version against the JAX oracle (`ref.lru_scan`) and the Pallas kernel run
in interpret mode on every case of the JAX spec at the spec's tolerance;
the dispatch contract and the wrapper's argument checks; the RG-LRU
layer's prefill (through the wrapper) against the JAX layer's
associative scan, and its one-token step; and the sliding-window
attention layer's prefill (flash wrapper with the window) and ring-
buffer decode against the JAX layer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.kernels.rglru_scan import ref as jref
from repro.kernels.rglru_scan import spec as jspec
from repro.kernels.rglru_scan.rglru_scan import rglru_scan_pallas
from repro.models import attention as jattn
from repro.models import rglru as jrglru
from repro.models.common import materialize
from repro_torch.configs import smoke_config
from repro_torch.kernels import api, registry
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.rglru_scan import ref
from repro_torch.kernels.rglru_scan.rglru_scan import rglru_scan
from repro_torch.models import attention, rglru

SPEC = registry.get("rglru_scan")
ARCH = "recurrentgemma-2b"


def _inputs(shape, seed=0):
    inp = SPEC.example_inputs(shape=shape, seed=seed)
    return ([torch.from_numpy(inp[n]) for n in SPEC.arg_names],
            [jnp.asarray(inp[n]) for n in SPEC.arg_names])


def test_spec_matches_reference_spec():
    """Same cases, tolerance and bit-identical example inputs as the JAX
    spec (whose tiles the port's kernel does not take)."""
    js = jspec.SPEC
    assert [dict(c.shape) for c in SPEC.cases] == \
        [dict(c.shape) for c in js.cases]
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
    got = api.run("rglru_scan", *targs).numpy()          # plain on the CPU
    want = np.asarray(jref.lru_scan(*jargs))
    pallas = np.asarray(rglru_scan_pallas(
        *jargs, chunk=jspec.SPEC.cases[i].tile["chunk"], interpret=True))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)


def test_run_dispatch_and_plain_call_count():
    targs, _ = _inputs(dict(SPEC.cases[0].shape))
    with pytest.raises(ValueError, match="CUDA"):
        api.run("rglru_scan", *targs, backend="cuda")
    with pytest.raises(ValueError, match="tile"):
        api.run("rglru_scan", *targs, backend="ref", tile={"chunk": 64})
    launches, plain = rglru_scan.launches, rglru_scan.plain_calls
    out = api.run("rglru_scan", *targs)                  # auto on the CPU
    assert rglru_scan.plain_calls == plain + 1
    assert rglru_scan.launches == launches
    assert torch.equal(out, ref.lru_scan(*targs))
    assert "rglru_scan" in registry.names()


@pytest.fixture(scope="module")
def layers():
    """recurrentgemma-2b's smoke RG-LRU and attention params in both
    frameworks."""
    jcfg = jax_smoke(ARCH)
    out = {}
    for name, spec_fn in (("rglru", jrglru.rglru_spec),
                          ("attn", jattn.attn_spec)):
        jp = materialize(spec_fn(jcfg), jax.random.PRNGKey(7), jnp.float32)
        out[name] = (jp, {k: torch.from_numpy(np.array(v))
                          for k, v in jp.items()})
    return jcfg, smoke_config(ARCH), out


@pytest.mark.parametrize("s_len", [40, 3])
def test_rglru_prefill_and_step_match_jax(layers, s_len):
    """The RG-LRU block's prefill (sequential plain scan, through the
    wrapper) against the JAX block's associative scan, and one decode
    step from the prefill cache: y, h and the conv taps at 1e-5."""
    jcfg, cfg, ps = layers
    jp, tp = ps["rglru"]
    x = np.random.default_rng(s_len).normal(
        size=(2, s_len, cfg.d_model)).astype(np.float32)
    want, wcache = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x),
                                      mode="prefill")
    plain = rglru_scan.plain_calls
    got, cache = rglru.rglru_apply(cfg, tp, torch.from_numpy(x),
                                   mode="prefill")
    assert rglru_scan.plain_calls == plain + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    for key in ("h", "conv"):
        assert cache[key].dtype == torch.float32
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(wcache[key]), atol=1e-5,
                                   rtol=0)
    x1 = np.random.default_rng(5).normal(
        size=(2, 1, cfg.d_model)).astype(np.float32)
    want1, wcache1 = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x1),
                                        mode="decode", cache=wcache)
    got1, cache1 = rglru.rglru_apply(cfg, tp, torch.from_numpy(x1),
                                     mode="decode", cache=cache)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(cache1["h"].numpy(), np.asarray(wcache1["h"]),
                               atol=1e-5, rtol=0)


def test_local_attention_prefill_and_ring_decode_match_jax(layers):
    """A sliding-window layer: prefill through the flash wrapper with the
    window (plain on the CPU) against the JAX layer, then ring-buffer
    decode steps past the window (slot = pos % window)."""
    jcfg, cfg, ps = layers
    jp, tp = ps["attn"]
    w = cfg.window
    s_len = 2 * w                   # ring-aligned: a multiple of the window
    x = np.random.default_rng(1).normal(
        size=(1, s_len, cfg.d_model)).astype(np.float32)
    pos = np.arange(s_len, dtype=np.int32)[None]
    want, wcache = jattn.attn_apply(jcfg, jp, jnp.asarray(x), mode="prefill",
                                    positions=jnp.asarray(pos), window=w)
    plain = flash_attention.plain_calls
    got, cache = attention.attn_apply(
        cfg, tp, torch.from_numpy(x), mode="prefill",
        positions=torch.from_numpy(pos), window=w)
    assert flash_attention.plain_calls == plain + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    jring = {k: v[:, -w:] for k, v in wcache.items()}
    ring = {k: v[:, -w:].clone() for k, v in cache.items()}
    for step in range(w + 3):
        x1 = np.random.default_rng(100 + step).normal(
            size=(1, 1, cfg.d_model)).astype(np.float32)
        want1, jring = jattn.attn_apply(
            jcfg, jp, jnp.asarray(x1), mode="decode",
            positions=jnp.int32(s_len + step), cache=jring, window=w)
        got1, ring = attention.attn_apply(
            cfg, tp, torch.from_numpy(x1), mode="decode",
            positions=s_len + step, cache=ring, window=w)
        np.testing.assert_allclose(got1.numpy(), np.asarray(want1),
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the chunked route: its algorithm in plain PyTorch
# (`chip_smoke.rglru_chunked_loop`), its route rule
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chip_smoke():
    """`chip_smoke.py` as a module (its helpers run on any device)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    mod_spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def long_inputs():
    """recurrentgemma-2b's generate prefill length at a narrow width, from
    the spec's generator, with the plain version's and the JAX oracle's
    results."""
    targs, jargs = _inputs({"B": 2, "S": 2300, "W": 512}, seed=3)
    want = ref.lru_scan(*targs)
    oracle = torch.from_numpy(np.array(jref.lru_scan(*jargs)))
    return targs, want, oracle


@pytest.mark.parametrize("chunk", [32, 64, 100, 128])
def test_chunked_within_ulp_limit(chip_smoke, long_inputs, chunk):
    """The chunked route's algorithm -- chunk products and scans from zero,
    the carry chained over the chunks, each chunk's recurrence rerun from
    its carry -- stays inside the 2-ulp limit the kernel is held to on the
    card, against the plain version and the JAX oracle, with chunks that
    divide S (100) and that do not (32, 64, 128)."""
    targs, want, oracle = long_inputs
    got = chip_smoke.rglru_chunked_loop(*targs, chunk=chunk)
    assert chip_smoke.ulp_check(got, want)[2] < 0.5
    assert chip_smoke.ulp_check(got, oracle)[2] < 1.0


@pytest.mark.parametrize("i", range(len(jspec.SPEC.cases)))
def test_chunked_on_spec_cases(chip_smoke, i):
    """The chunked algorithm on every spec case (chunks of 32: S = 1 and 4
    are one short chunk, S = 96 three) against the JAX oracle at the
    spec's tolerance and within the 2-ulp limit of the plain version."""
    case = SPEC.cases[i]
    targs, jargs = _inputs(dict(case.shape))
    got = chip_smoke.rglru_chunked_loop(*targs, chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.lru_scan(*jargs)),
                               atol=SPEC.tol[case.dtype], rtol=0)
    assert chip_smoke.ulp_check(got, ref.lru_scan(*targs))[2] <= 1.0


def test_dropped_carry_is_over_limit(chip_smoke, long_inputs):
    targs, want, _ = long_inputs
    got = chip_smoke.rglru_chunked_loop(*targs, fault="drop_carry")
    assert chip_smoke.ulp_check(got, want)[2] > 1e3


def test_one_chunk_is_the_serial_recurrence(chip_smoke):
    """A sequence no longer than a chunk gives the plain version's bits."""
    targs, _ = _inputs({"B": 2, "S": 40, "W": 16}, seed=5)
    assert torch.equal(chip_smoke.rglru_chunked_loop(*targs, chunk=64),
                       ref.lru_scan(*targs))


@pytest.mark.parametrize("s_len,want", [
    (1, "serial"), (4, "serial"), (32, "serial"), (33, "chunked"),
    (64, "chunked"), (2300, "chunked")])
def test_route(s_len, want):
    from repro_torch.kernels.rglru_scan.rglru_scan import CHUNK, route
    assert CHUNK == 32
    assert route(s_len) == want


def test_launch_counts_untouched_on_cpu():
    targs, _ = _inputs(dict(SPEC.cases[1].shape))
    launches = rglru_scan.launches
    by_route = dict(rglru_scan.launches_by_route)
    api.run("rglru_scan", *targs)
    assert rglru_scan.launches == launches
    assert rglru_scan.launches_by_route == by_route
    assert set(by_route) == {"chunked", "serial"}


# ---------------------------------------------------------------------------
# The tile (`chunk`), its Hopper cost model and knee
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", [(2, 2300, 2560), (1, 2048, 2560),
                                  (1, 100, 2560), (2, 128, 32)])
def test_tile_space_costs_and_knee_is_deterministic(grid):
    """Every chunk of the space costs; the knee is the same on every
    search; the launch before tiles (`CHUNK`, 32) is in the space; a
    chunk that holds all of S takes the serial route."""
    from repro_torch.core import autotune
    from repro_torch.kernels.rglru_scan.rglru_scan import CHUNK, CHUNKS, route
    costs = autotune.space_costs(SPEC, grid, "float32")
    assert [t["chunk"] for t, _ in costs] == list(CHUNKS)
    for tile, cost in costs:
        assert cost is not None and 0 < cost[1] < np.inf
    knee = autotune.autotune_kernel(SPEC, grid)["knee"]
    assert knee == autotune.autotune_kernel(SPEC, grid)["knee"]
    assert CHUNK in CHUNKS == SPEC.tune_space["chunk"]
    assert route(100, 128) == "serial" and route(100, 64) == "chunked"


def test_run_takes_the_chunk_and_work_ignores_it():
    from repro_torch.core import hlo_cost
    targs, _ = _inputs(dict(SPEC.cases[1].shape))
    want = ref.lru_scan(*targs)
    counts = []
    for q in SPEC.tune_space["chunk"]:
        assert torch.equal(api.run("rglru_scan", *targs, tile={"chunk": q}),
                           want)
        counts.append(hlo_cost.analyze(
            lambda *a, q=q: api.run("rglru_scan", *a, tile={"chunk": q}),
            *targs))
    assert all(c == counts[0] for c in counts) and counts[0]["kernels"]
    with pytest.raises(ValueError, match="unknown tile"):
        api.run("rglru_scan", *targs, tile={"pages_per_block": 1})
    with pytest.raises(ValueError, match="backend='ref'"):
        api.run("rglru_scan", *targs, backend="ref", tile={"chunk": 64})


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_chunked_route_at_every_chunk(chip_smoke, long_inputs, chunk):
    """At every chunk of the space the chunked route's algorithm stays
    within the 2-ulp limit and a dropped carry goes over it."""
    targs, want, _ = long_inputs
    got = chip_smoke.rglru_chunked_loop(*targs, chunk=chunk)
    assert chip_smoke.ulp_check(got, want)[2] < 0.5
    broken = chip_smoke.rglru_chunked_loop(*targs, chunk=chunk,
                                           fault="drop_carry")
    assert chip_smoke.ulp_check(broken, want)[2] > 1e3


def test_autograd_reverse_scan_runs_at_the_chunk():
    """`RglruScanFn`'s backward is the same scan at the forward's chunk:
    the gradient through a tiled call equals the untiled one (the plain
    version on the CPU, whatever the chunk)."""
    targs, _ = _inputs({"B": 2, "S": 300, "W": 8}, seed=4)
    grads = []
    for chunk in (None, 128):
        a, b = (t.clone().requires_grad_() for t in targs)
        rglru_scan(a, b, chunk=chunk).square().sum().backward()
        grads.append((a.grad, b.grad))
    assert all(torch.equal(x, y) for x, y in zip(*grads))
