"""`tools/serve_fit.py`, the fit of the serving and prefill kernels' Hopper
cost models to the kernel phase's tile sweeps, on logs made here from the
cost models themselves: a log the models predict exactly is fitted with
every error factor 1 and every knee the fastest tile, a log measured on a
slower card raises the constant it scales, and a paged row keyed on the
grid the specs used before the pool's page count was left out reads as
the same grid. Then the knee's margin over each kernel's own launch."""
from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

import pytest

from repro_torch.core import autotune
from repro_torch.kernels import registry

ROOT = Path(__file__).resolve().parents[1]
# one swept grid per kernel (the spec's shape_keys), at the dtype the
# kernel phase sweeps it in
GRIDS = {"paged_attention": ((4, 128, 16, 36, 4, 128, 1), "bfloat16"),
         "flash_attention": ((1, 600, 600, 36, 4, 128), "bfloat16"),
         "ssd_scan": ((1, 2048, 48, 64, 1, 128), "bfloat16"),
         "rglru_scan": ((2, 2300, 2560), "float32")}


@pytest.fixture(scope="module")
def serve_fit():
    spec = importlib.util.spec_from_file_location(
        "serve_fit", ROOT / "tools" / "serve_fit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _log(path, kernel, grid, dtype, scale=1.0, logged_grid=None):
    """One kernel-phase sweep row whose measured times are the cost
    model's estimates times `scale`."""
    spec = registry.get(kernel)
    tiles = [{"tile": t, "launchable": True, "device_ms": c[1] * 1e3 * scale}
             for t, c in autotune.space_costs(spec, grid, dtype)
             if c is not None]
    row = {"phase": "kernel", "case": f"{kernel}: tile sweep",
           "kernel": kernel, "grid": list(logged_grid or grid),
           "dtype": dtype, "tiles": tiles}
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")


@pytest.mark.parametrize("kernel", sorted(GRIDS))
def test_a_log_the_model_predicts_fits_exactly(serve_fit, tmp_path, kernel):
    grid, dtype = GRIDS[kernel]
    log = tmp_path / "run.log"
    _log(log, kernel, grid, dtype)
    got = serve_fit.fit(kernel, serve_fit.sweeps([log]))
    assert got["points"] >= 2
    assert got["before"]["max_error_factor"] == pytest.approx(1.0)
    assert got["after"]["max_error_factor"] == pytest.approx(1.0, rel=0.02)
    (row,) = [v for k, v in got["after"].items() if k.startswith("[")]
    assert row["knee_over_fastest"] == pytest.approx(1.0, rel=0.02)


def test_a_slower_card_is_fitted_back(serve_fit, tmp_path):
    """RG-LRU's one constant at two grids measured 1.5x its estimate
    where the recurrence's chain sets the time: the fit raises the step
    and leaves the module's constant as it found it."""
    from repro_torch.kernels.rglru_scan import spec as rspec
    log = tmp_path / "run.log"
    for grid in ((1, 4096, 256), (2, 8192, 128)):
        _log(log, "rglru_scan", grid, "float32", scale=1.5)
    before = rspec.ROW_STEP_S
    got = serve_fit.fit("rglru_scan", serve_fit.sweeps([log]))
    assert rspec.ROW_STEP_S == before
    assert got["after"]["constants"]["ROW_STEP_S"] > before
    assert got["after"]["max_error_factor"] < \
        got["before"]["max_error_factor"]
    assert math.isclose(got["before"]["max_error_factor"], 1.5, rel_tol=0.3)


def test_paged_rows_keyed_with_the_page_count_read_as_the_grid(serve_fit,
                                                              tmp_path):
    grid, dtype = GRIDS["paged_attention"]
    log = tmp_path / "run.log"
    _log(log, "paged_attention", grid, dtype,
         logged_grid=grid[:1] + (64,) + grid[1:])
    assert list(serve_fit.sweeps([log])) == [("paged_attention", grid,
                                              dtype)]


@pytest.mark.parametrize("gain,keeps_own", [(0.05, True), (0.3, False)])
def test_a_knee_gives_way_to_the_own_launch_within_the_margin(gain,
                                                              keeps_own):
    """`autotune_kernel` keeps a spec's own launch (``fixed_tile``) as the
    knee unless the cost model calls the knee `KNEE_MARGIN` faster; a
    spec without one keeps the search's knee."""
    import types

    def cost(grid, tile, dtype_bytes):
        return 1024, 1.0 - gain * (tile["t"] == 2)
    spec = types.SimpleNamespace(cost_fn=cost, tune_space={"t": (1, 2)},
                                 fixed_tile=lambda grid: {"t": 1})
    knee = autotune.autotune_kernel(spec, (1,))["knee"]
    assert knee.params == ({"t": 1} if keeps_own else {"t": 2})
    spec.fixed_tile = None
    assert autotune.autotune_kernel(spec, (1,))["knee"].params == {"t": 2}


@pytest.mark.parametrize("kernel", sorted(GRIDS))
def test_the_own_launch_is_a_launchable_tile_of_the_space(kernel):
    grid, dtype = GRIDS[kernel]
    spec = registry.get(kernel)
    own = spec.fixed_tile(grid)
    assert all(own[k] in spec.tune_space[k] for k in spec.tune_space)
    assert spec.cost_fn(grid, own, 2 if dtype == "bfloat16" else 4)
