"""The port's NERO stencil flow (thesis Ch. 3 + 4) against the JAX
package: the dispatch's tile rules over all six kernels, the Hopper knee
(feasible, deterministic, cached by ``backend="auto"``), the number-format
quantizers (equal to the bit), the precision sweep over
``benchmarks/bench_precision.py``'s 14 formats and the fixed-point search
through ``api.numpy_fn`` on the CPU, and
``repro_torch.launch.weather_stencil`` end to end."""
import importlib.util
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
        {"hdiff", "vadvc"}
    assert api.as_spec(registry.get("hdiff")) is registry.get("hdiff")


@pytest.mark.parametrize("name", ["paged_attention", "flash_attention",
                                  "ssd_scan", "rglru_scan"])
def test_fixed_launch_kernels_refuse_tiles(name):
    spec = registry.get(name)
    args = [torch.from_numpy(v) for v in spec.example_inputs().values()]
    for backend in ("auto", "cuda", "ref"):
        with pytest.raises(ValueError, match="launch shape is fixed"):
            api.run(name, *args, backend=backend, tile={"block_z": 1})


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
