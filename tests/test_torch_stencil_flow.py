"""The port's NERO stencil flow (thesis Ch. 3 + 4) against the JAX
package: the dispatch's tile rules over all six kernels, the Hopper knee
(feasible, deterministic, cached by ``backend="auto"``), the number-format
quantizers (equal to the bit), the precision sweep over
``benchmarks/bench_precision.py``'s 14 formats and the fixed-point search
through ``api.numpy_fn`` on the CPU,
``repro_torch.launch.weather_stencil`` end to end, and the knee cache's
persistence (``--knee-cache``): merged on save, the JAX package's own
entries kept, a malformed file or an entry of another arch a warning,
never a launch."""
import importlib.util
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro.core.precision_search import search_kernel as jsearch_kernel
from repro_torch.core import autotune, precision as prec
from repro_torch.core.precision_search import search_kernel
from repro_torch.kernels import api, registry
from repro_torch.launch import weather_stencil

ROOT = Path(__file__).resolve().parents[1]
COSMO = (64, 256, 256)


@pytest.fixture(scope="module")
def bench_formats():
    """`FORMATS` of ``benchmarks/bench_precision.py`` (JAX package) and
    the same 14 formats built with the port's constructors."""
    mod_spec = importlib.util.spec_from_file_location(
        "bench_precision", ROOT / "benchmarks" / "bench_precision.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    mine = []
    for f in mod.FORMATS:
        if f.kind == "native":
            mine.append(prec.FP32)
        else:
            args = tuple(int(a) for a in f.label[f.label.index("(") + 1:-1]
                         .split(","))
            mine.append({"fixed": prec.fmt_fixed, "float": prec.fmt_float,
                         "posit": prec.fmt_posit}[f.kind](*args))
    return mod.FORMATS, mine


def test_registry_lists_six_kernels():
    assert registry.names() == ["flash_attention", "hdiff", "paged_attention",
                                "rglru_scan", "ssd_scan", "vadvc"]
    assert [s.name for s in registry.all_kernels()] == registry.names()
    assert {n for n in registry.names() if registry.get(n).tune_space} == \
        set(registry.names())
    assert api.as_spec(registry.get("hdiff")) is registry.get("hdiff")


@pytest.mark.parametrize("name", ["paged_attention", "flash_attention",
                                  "ssd_scan", "rglru_scan"])
def test_fixed_launch_kernels_refuse_tiles(name):
    """The serving and prefill kernels, once of fixed launch shapes, now
    take their own tiles, and still refuse another kernel's tile names
    and any tile with the plain version."""
    spec = registry.get(name)
    args = [torch.from_numpy(v) for v in spec.example_inputs().values()]
    for backend in ("auto", "cuda"):
        with pytest.raises(ValueError, match="unknown tile params"):
            api.run(name, *args, backend=backend, tile={"block_z": 1})
    own = {k: v[-1] for k, v in spec.tune_space.items()}
    with pytest.raises(ValueError, match="backend='ref'"):
        api.run(name, *args, backend="ref", tile=own)


@pytest.mark.parametrize("name", ["hdiff", "vadvc"])
def test_auto_on_cpu_equals_ref_at_any_tile(name):
    spec = registry.get(name)
    args = [torch.from_numpy(v) for v in spec.example_inputs().values()]
    want = api.run(name, *args, backend="ref")
    assert torch.equal(api.run(name, *args), want)
    tile = {k: v[-1] for k, v in spec.tune_space.items()}
    assert torch.equal(api.run(name, *args, tile=tile), want)
    with pytest.raises(ValueError, match="backend"):
        api.run(name, *args, backend="xla")


@pytest.mark.parametrize("name", ["hdiff", "vadvc"])
def test_hopper_knee_feasible_deterministic_and_cached(name):
    """At the COSMO grid, for fp32 and bf16: the knee is one of the
    feasible candidates, within the 232,448 bytes a block may take, the
    same on every search, and what `resolve_tile` (the ``auto`` backend's
    cache) returns. Whether it moves with dtype is reported in PERF.md,
    not asserted (hdiff's moves, vadvc's does not)."""
    spec = registry.get(name)
    for dtype in ("float32", "bfloat16"):
        first = autotune.autotune_kernel(spec, COSMO, dtype=dtype)
        again = autotune.autotune_kernel(spec, COSMO, dtype=dtype)
        knee = first["knee"]
        assert knee == again["knee"] and knee.feasible
        assert knee.smem_bytes <= autotune.SMEM_BYTES == 232_448
        assert knee in first["pareto"]
        assert all(c.smem_bytes > autotune.SMEM_BYTES or c.feasible
                   for c in first["candidates"])
        args = [torch.empty(COSMO, dtype=getattr(torch, dtype))]
        if name == "vadvc":
            args = args * 4 + [torch.empty(COSMO[0] + 1, COSMO[1],
                                           COSMO[2] + 1)]
        assert api.resolve_tile(name, args) == knee.params
        assert api._KNEES[(name, COSMO, dtype)] == \
            tuple(sorted(knee.params.items()))


def test_stream_time_model():
    """Waves over the 132 SMs and the launch overhead: one full wave of
    blocks with enough bytes in flight streams at the memory rate plus
    one launch, a second full wave doubles the streaming time, and a
    block that cannot launch has no time."""
    need = autotune.HBM_BW * autotune.MEM_LATENCY_S
    slots = autotune.NUM_SMS * autotune.blocks_per_sm(256, 0)
    one = autotune.stream_time(1e6, slots, 256, 0, need)
    two = autotune.stream_time(2e6, 2 * slots, 256, 0, need)
    over = autotune.LAUNCH_OVERHEAD_S
    assert one - over == pytest.approx(1e6 / autotune.HBM_BW)
    assert two - over == pytest.approx(2 * (one - over))
    assert autotune.stream_time(1e6, 10, 2048, 0, 4.0) is None
    assert autotune.stream_time(1e6, 10, 32, autotune.SMEM_BYTES + 1,
                                4.0) is None
    assert autotune.dtype_nbytes(torch.bfloat16) == 2
    assert autotune.dtype_nbytes("float32") == 4


def test_quantizers_equal_jax_to_the_bit():
    x = np.random.default_rng(0).normal(size=4096) * 4.0
    x[:8] = [0.0, -0.0, 1e-9, -1e9, 7.75, -8.0, 2.0 ** -20, 3.0]
    for w, i in ((16, 4), (8, 3), (20, 4), (14, 7)):
        np.testing.assert_array_equal(prec.quantize_fixed(x, w, i),
                                      jprec.quantize_fixed(x, w, i))
    for e, m in ((8, 7), (5, 10), (4, 3), (5, 6)):
        np.testing.assert_array_equal(prec.quantize_float(x, e, m),
                                      jprec.quantize_float(x, e, m))
    for n, es in ((8, 1), (12, 2), (16, 2)):
        np.testing.assert_array_equal(prec.quantize_posit(x, n, es),
                                      jprec.quantize_posit(x, n, es))
    a, b = x[:100], x[:100] + 1e-3
    assert prec.relative_error_2norm(a, b) == jprec.relative_error_2norm(a, b)
    assert prec.induced_2norm_error(x.reshape(64, 64), x.reshape(64, 64)
                                    * 1.01) == jprec.induced_2norm_error(
        x.reshape(64, 64), x.reshape(64, 64) * 1.01)


@pytest.mark.parametrize("name", ["hdiff", "vadvc"])
def test_precision_sweep_matches_jax(name, bench_formats):
    """The 14 formats through the port (plain versions on the CPU) and
    through the JAX package (its oracle): equal labels, kinds and bits,
    |delta rel_err| <= 1e-4 (measured at most 2.4e-5 for hdiff and
    3.3e-7 for vadvc: the JAX oracle is jitted, and XLA fuses products
    into sums the port rounds apart)."""
    jformats, formats = bench_formats
    mine = prec.precision_sweep_kernel(name, formats, device="cpu")
    theirs = jprec.precision_sweep_kernel(name, jformats)
    assert [(r["format"], r["kind"], r["bits"]) for r in mine] == \
        [(r["format"], r["kind"], r["bits"]) for r in theirs]
    for a, b in zip(mine, theirs):
        assert abs(a["rel_err"] - b["rel_err"]) <= 1e-4, (a, b)


@pytest.mark.parametrize("name", ["hdiff", "vadvc"])
def test_search_kernel_chooses_jax_label(name):
    mine = search_kernel(name, device="cpu")
    theirs = jsearch_kernel(name)
    assert mine["chosen"].label == theirs["chosen"].label
    assert mine["integer_bits"] == theirs["integer_bits"]
    assert [p.w for p in mine["points"]] == [p.w for p in theirs["points"]]


def test_weather_stencil_main_on_cpu():
    """The launch script end to end on the CPU: kernels (plain here)
    against their plain versions, the knees of the Hopper model, and the
    hdiff sweep at the smoke grid within 1e-4 of the JAX package's."""
    res = weather_stencil.main(["--device", "cpu"])
    assert res["device"] == "cpu"
    assert res["grid"] == {"nz": 4, "ny": 16, "nx": 16}
    assert res["check"] == {"hdiff": 0.0, "vadvc": 0.0}
    for (name, dtype), knee in res["knee"].items():
        assert knee == autotune.autotune_kernel(
            registry.get(name), COSMO, dtype=dtype)["knee"]
    jfmts = [jprec.fmt_fixed(16, 4), jprec.fmt_float(5, 10),
             jprec.fmt_posit(16, 2), jprec.fmt_posit(12, 2)]
    want = jprec.precision_sweep_kernel("hdiff", jfmts, shape=res["grid"])
    assert [r["format"] for r in res["sweep"]] == [r["format"] for r in want]
    for a, b in zip(res["sweep"], want):
        assert abs(a["rel_err"] - b["rel_err"]) <= 1e-4


# ---------------------------------------------------------------------------
# The knee cache
# ---------------------------------------------------------------------------
def _hdiff_args(nz=8, ny=32, nx=48):
    return [torch.zeros(nz, ny, nx)]


def test_knee_cache_persists_and_preloads(tmp_path):
    """The port of the reference's test, on the launcher that resolves
    knees: the first run saves the knees it resolved, a restart preloads
    them, re-tunes nothing and leaves the file as it was."""
    api.invalidate_caches()
    path = api.knee_cache_path(tmp_path)
    assert path == tmp_path / "knee_cache_sm_90a.json"
    res = weather_stencil.main(["--device", "cpu", "--knee-cache",
                                str(path)])
    assert res["knees_loaded"] == 0 and res["knees_saved"] == 2
    grid = [res["grid"][k] for k in ("nz", "ny", "nx")]
    assert json.loads(path.read_text()) == [
        {"arch": "sm_90a", "kernel": name, "grid": grid,
         "dtype": "float32", "tile": res["tile"][name]}
        for name in ("hdiff", "vadvc")]
    assert not api.knees_dirty()
    before = path.read_text()

    api.invalidate_caches()
    res2 = weather_stencil.main(["--device", "cpu", "--knee-cache",
                                 str(path)])
    assert res2["knees_loaded"] == 2 and "knees_saved" not in res2
    assert res2["tile"] == res["tile"] and not api.knees_dirty()
    assert path.read_text() == before


def test_knee_cache_merges_on_save(tmp_path):
    """In-memory knees win over the file's; the file's other entries, of
    any arch, are kept."""
    path = tmp_path / "k.json"
    api.invalidate_caches()
    old = api.resolve_tile("hdiff", _hdiff_args(4, 32, 48))
    assert api.save_knee_cache(path) == 1
    entries = json.loads(path.read_text())
    entries.append({"arch": "tpu", "kernel": "hdiff", "grid": [1, 2, 3],
                    "dtype": "float32", "tile": {"tile_x": 8}})
    stale = dict(entries[0], tile={"tile_x": 128, "tile_y": 32,
                                   "block_z": 4}, grid=[8, 32, 48])
    entries.append(stale)
    path.write_text(json.dumps(entries))
    api.invalidate_caches()
    new = api.resolve_tile("hdiff", _hdiff_args(8, 32, 48))
    assert api.save_knee_cache(path) == 3
    saved = {(e["arch"], tuple(e["grid"])): e["tile"]
             for e in json.loads(path.read_text())}
    assert saved == {("sm_90a", (4, 32, 48)): old,
                     ("sm_90a", (8, 32, 48)): new,
                     ("tpu", (1, 2, 3)): {"tile_x": 8}}
    assert not list(tmp_path.glob(".*.tmp"))      # replaced atomically


def test_knee_cache_save_keeps_jax_entries(tmp_path):
    """A file the JAX package wrote at the same canonical path (entries
    keyed on a VMEM budget, no arch): a save by the port adds its own
    entries and writes the reference's back unchanged, and a load takes
    only the port's, warning about the others."""
    path = api.knee_cache_path(tmp_path)
    jax_entries = [
        {"kernel": "hdiff", "grid": [8, 32, 48], "dtype": "float32",
         "vmem_budget": None, "tile": {"block_z": 4}},
        {"kernel": "vadvc", "grid": [16, 64, 64], "dtype": "bfloat16",
         "vmem_budget": 16777216, "tile": {"tile_x": 64}}]
    path.write_text(json.dumps(jax_entries))
    api.invalidate_caches()
    knee = api.resolve_tile("hdiff", _hdiff_args())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert api.save_knee_cache(path) == 3
    entries = json.loads(path.read_text())
    assert entries == [{"arch": "sm_90a", "kernel": "hdiff",
                        "grid": [8, 32, 48], "dtype": "float32",
                        "tile": knee}] + jax_entries
    api.invalidate_caches()
    with pytest.warns(UserWarning, match="malformed knee cache"):
        assert api.load_knee_cache(path) == 1
    assert api._KNEES == {("hdiff", (8, 32, 48), "float32"):
                          tuple(sorted(knee.items()))}


def test_knee_cache_malformed_file_warns(tmp_path):
    path = tmp_path / "k.json"
    path.write_text("{not json")
    api.invalidate_caches()
    with pytest.warns(UserWarning, match="malformed knee cache"):
        assert api.load_knee_cache(path) == 0
    assert api.load_knee_cache(tmp_path / "missing.json") == 0
    # a save over the malformed file replaces it
    api.resolve_tile("hdiff", _hdiff_args())
    with pytest.warns(UserWarning, match="malformed knee cache"):
        assert api.save_knee_cache(path) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert api.load_knee_cache(path) == 1


def test_knee_cache_skips_foreign_and_unlaunchable_entries(tmp_path):
    """Entries of another arch (a TPU cache keys on a VMEM budget), of
    an unknown kernel, or whose tile the tune space cannot launch are
    skipped with the warning: the resolver never sees them."""
    grid = [8, 32, 48]
    good = {"arch": "sm_90a", "kernel": "hdiff", "grid": grid,
            "dtype": "float32",
            "tile": {"tile_x": 128, "tile_y": 16, "block_z": 2}}
    bad = [dict(good, arch="tpu_v5e"),
           {"kernel": "hdiff", "grid": grid, "dtype": "bfloat16",
            "vmem_budget": None, "tile": {"block_z": 4}},
           dict(good, kernel="no_such_kernel"),
           dict(good, dtype="float16", tile={"tile_x": 128, "tile_y": 16}),
           dict(good, dtype="bfloat16",
                tile={"tile_x": 96, "tile_y": 16, "block_z": 2}),
           dict(good, grid=[1, 1, 1], tile={"tile_x": 64, "tile_y": 16,
                                            "block_z": 1, "vmem": 3})]
    path = tmp_path / "k.json"
    path.write_text(json.dumps([good] + bad))
    api.invalidate_caches()
    with pytest.warns(UserWarning, match="malformed knee cache") as rec:
        assert api.load_knee_cache(path) == 1
    assert "tpu_v5e" in str(rec[0].message)
    assert api._KNEES == {("hdiff", tuple(grid), "float32"):
                          tuple(sorted(good["tile"].items()))}
    assert api.resolve_tile("hdiff", _hdiff_args()) == good["tile"]
    assert not api.knees_dirty()           # loaded, not re-tuned
