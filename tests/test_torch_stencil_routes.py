"""The two routes of each NERO stencil kernel (`repro_torch.kernels.hdiff`:
"tma" and "simt"; `repro_torch.kernels.vadvc`: "prefetch" and "simt"):
the new routes' blocking restated in plain PyTorch (`chip_smoke.py`'s
`hdiff_tiled_loop` and `vadvc_prefetch_loop`) against the plain versions
to the bit, their broken forms against them, `route()`, the tma route's
shared-memory layout and tiles, the route-aware cost model and the
wrappers' checks. The kernels themselves run only on the card
(`chip_smoke.py --only stencil`)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import autotune
from repro_torch.kernels import registry
from repro_torch.kernels.hdiff import hdiff as hdiff_mod
from repro_torch.kernels.hdiff import ref as href
from repro_torch.kernels.hdiff import spec as hspec
from repro_torch.kernels.vadvc import ref as vref
from repro_torch.kernels.vadvc import vadvc as vadvc_mod

ROOT = Path(__file__).resolve().parents[1]
HDIFF = registry.get("hdiff")
VADVC = registry.get("vadvc")
COSMO = (64, 256, 256)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def chip_smoke():
    """`chip_smoke.py` as a module (its helpers run on any device)."""
    mod_spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _src(shape, dtype="float32", seed=0):
    inp = HDIFF.example_inputs(shape=dict(zip(HDIFF.shape_keys, shape)),
                               seed=seed)
    return torch.from_numpy(inp["src"]).to(DTYPES[dtype])


def _vadvc_args(shape, seed=0):
    inp = VADVC.example_inputs(shape=dict(zip(VADVC.shape_keys, shape)),
                               seed=seed)
    return [torch.from_numpy(inp[n]) for n in VADVC.arg_names]


@pytest.mark.parametrize("i", range(len(HDIFF.cases)))
def test_hdiff_tiled_loop_equals_plain_at_every_tma_tile(i, chip_smoke):
    """Each spec case through the tma route's blocking at every tile it
    is built for: zero-filled boxes, the Laplacian tile computed once,
    ragged last tiles (nx = 24 and 48 are ragged against every tile_x)."""
    case = HDIFF.cases[i]
    src = _src(tuple(case.shape[k] for k in HDIFF.shape_keys), case.dtype)
    want = href.hdiff(src)
    for tile in hdiff_mod.tma_tiles():
        got = chip_smoke.hdiff_tiled_loop(src, **tile)
        assert chip_smoke.exact_check(got, want)["mismatches"] == 0, tile


@pytest.mark.parametrize("shape,dtype", [((5, 37, 72), "float32"),
                                         ((3, 21, 40), "bfloat16"),
                                         ((2, 5, 8), "float32")])
def test_hdiff_tiled_loop_equals_plain_on_ragged_grids(shape, dtype,
                                                       chip_smoke):
    """Grids ragged in z, y and x against every built tile (and one with
    an interior of a single row), as `chip_smoke.py` runs them on the
    card."""
    src = _src(shape, dtype, seed=1)
    want = href.hdiff(src)
    for tile in hdiff_mod.tma_tiles():
        got = chip_smoke.hdiff_tiled_loop(src, **tile)
        assert chip_smoke.exact_check(got, want)["mismatches"] == 0, tile


def test_hdiff_tiled_loop_at_cosmo_grid(chip_smoke):
    """The COSMO grid in fp32 at the largest built tile, once."""
    src = _src(COSMO)
    got = chip_smoke.hdiff_tiled_loop(src, tile_x=128, tile_y=32, block_z=4)
    assert torch.equal(got, href.hdiff(src))


def test_hdiff_tiled_loop_broken_differs(chip_smoke):
    """A Laplacian tile built over the output cells alone (its halo ring
    left at 0) breaks every tile edge: `exact_check` sees it."""
    for dtype in ("float32", "bfloat16"):
        src = _src((4, 32, 48), dtype)
        broken = chip_smoke.exact_check(chip_smoke.hdiff_tiled_loop(
            src, 64, 16, 1, fault="lap_interior_only"), href.hdiff(src))
        assert broken["mismatches"] > 100 and broken["max_ulps"] > 2


@pytest.mark.parametrize("i", range(len(VADVC.cases)))
def test_vadvc_prefetch_loop_equals_plain(i, chip_smoke):
    """Each spec case through the prefetch route's order: level k's loads
    from a ring filled `AHEAD` levels before (nz = 16, 32 wrap it), upos
    kept from the forward sweep for the backward one."""
    case = VADVC.cases[i]
    args = _vadvc_args(tuple(case.shape[k] for k in VADVC.shape_keys))
    got = chip_smoke.vadvc_prefetch_loop(*args)
    assert chip_smoke.exact_check(got, vref.vadvc(*args))["mismatches"] == 0


@pytest.mark.parametrize("nz", [1, 2, 3])
def test_vadvc_prefetch_loop_short_columns(nz, chip_smoke):
    """Columns shorter than either ring, with the end-level rules (nz = 1:
    one level that is first and last), on a ragged plane."""
    args = _vadvc_args((nz, 5, 45), seed=nz)
    got = chip_smoke.vadvc_prefetch_loop(*args)
    assert chip_smoke.exact_check(got, vref.vadvc(*args))["mismatches"] == 0


def test_vadvc_prefetch_loop_other_depths_and_broken(chip_smoke):
    """Any ring depth gives the same bits (the order of the loads is not
    the order of the arithmetic); a slot left unrefilled, so that level
    `AHEAD` reuses level 0's loads, differs."""
    args = _vadvc_args((20, 4, 40))
    want = vref.vadvc(*args)
    for ahead in (1, 3, 8, 32):
        got = chip_smoke.vadvc_prefetch_loop(*args, ahead=ahead)
        assert chip_smoke.exact_check(got, want)["mismatches"] == 0
    broken = chip_smoke.exact_check(chip_smoke.vadvc_prefetch_loop(
        *args, fault="stale_slot"), want)
    assert broken["mismatches"] > 100 and broken["max_ulps"] > 2


def test_hdiff_route():
    """Every spec case and the COSMO grid go to the tma route in both
    dtypes; rows that are not a multiple of 16 bytes go to simt."""
    for case in HDIFF.cases:
        assert hdiff_mod.route(DTYPES[case.dtype], case.shape["nx"]) == "tma"
    for dtype in DTYPES.values():
        assert hdiff_mod.route(dtype, COSMO[2]) == "tma"
    assert hdiff_mod.route(torch.float32, 50) == "simt"     # 200 bytes
    assert hdiff_mod.route(torch.bfloat16, 36) == "simt"    # 72 bytes
    assert hdiff_mod.route(torch.bfloat16, 40) == "tma"     # 80 bytes
    assert hdiff_mod.ROUTES == ("tma", "simt")
    assert set(hdiff_mod.hdiff.launches_by_route) == set(hdiff_mod.ROUTES)


def test_vadvc_route():
    """Every grid goes to the prefetch route, spec cases and misaligned
    rows alike (its loads need no alignment)."""
    for case in VADVC.cases:
        assert vadvc_mod.route(*(case.shape[k] for k in VADVC.shape_keys)) \
            == "prefetch"
    assert vadvc_mod.route(*COSMO) == "prefetch"
    assert vadvc_mod.route(3, 5, 45) == "prefetch"
    assert set(vadvc_mod.vadvc.launches_by_route) == {"prefetch", "simt"}


def test_hdiff_shared_memory_formulas():
    """The tma route's layout (csrc/hdiff.cu `Layout`): 128 bytes of
    slack, 3 boxes each rounded to 128 bytes, the fp32 Laplacian tile, one
    8-byte mbarrier a stage; box rows are tile_x and 16 bytes on each side
    (a box starts on a 16-byte boundary). The simt route keeps PR 14's
    fp32 patch of every plane."""
    assert hdiff_mod.tma_box_width(32, 4) == 40
    assert hdiff_mod.tma_box_width(32, 2) == 48
    assert hdiff_mod.tma_box_width(128, 2) == 144
    # fp32 32 x 32, 1 plane: box 36 x 40 x 4 = 5760 = 45 x 128
    assert hdiff_mod.tma_smem_bytes(32, 32, 1, 4) == \
        128 + 3 * 5760 + 34 * 34 * 4 + 24 == 22056
    # bf16 64 x 16, 1 plane: box 20 x 80 x 2 = 3200 = 25 x 128
    assert hdiff_mod.tma_smem_bytes(64, 16, 1, 2) == \
        128 + 3 * 3200 + 18 * 66 * 4 + 24 == 14504
    assert hdiff_mod.tma_smem_bytes(128, 32, 4, 4) > autotune.SMEM_BYTES
    assert all(hdiff_mod.tma_smem_bytes(t["tile_x"], t["tile_y"],
                                        t["block_z"], 2)
               <= autotune.SMEM_BYTES for t in hdiff_mod.tma_tiles())
    assert len(hdiff_mod.tma_tiles()) == 12
    assert min(t["tile_x"] * t["tile_y"] for t in hdiff_mod.tma_tiles()) \
        == 1024
    assert hdiff_mod.simt_smem_bytes(32, 8, 2) == 2 * 12 * 36 * 4 == 3456


def test_hdiff_cost_prices_the_route_the_grid_takes():
    """Aligned grids: the tma model, whose every tile launches (256
    threads) and whose only infeasible tile is fp32 128 x 32 x 4; rows not
    a multiple of 16 bytes: PR 14's simt model, which has no tile over
    1024 threads. PR 14's knee comes back from its model and space."""
    for tile in hdiff_mod.tma_tiles():
        smem, t = hspec.hdiff_cost(COSMO, tile, 4)
        assert smem == hdiff_mod.tma_smem_bytes(
            tile["tile_x"], tile["tile_y"], tile["block_z"], 4)
        assert np.isfinite(t) == (smem <= autotune.SMEM_BYTES)
    misaligned = (64, 256, 250)
    assert hspec.hdiff_cost(misaligned, {"tile_x": 64, "tile_y": 32,
                                         "block_z": 1}, 4) is None
    assert hspec.hdiff_cost(misaligned, {"tile_x": 32, "tile_y": 8,
                                         "block_z": 2}, 4)[0] == 3456
    old = autotune.autotune(hspec.simt_cost, COSMO, hspec.SIMT_TUNE_SPACE, 4)
    assert old["knee"].params == {"block_z": 2, "tile_x": 32, "tile_y": 8}
    old = autotune.autotune(hspec.simt_cost, COSMO, hspec.SIMT_TUNE_SPACE, 2)
    assert old["knee"].params == {"block_z": 4, "tile_x": 32, "tile_y": 4}


def test_route_tiles_match_the_routes_limits(chip_smoke):
    """The tiles `chip_smoke.py` runs on each route: hdiff's tma route
    all 12 built tiles but fp32 128 x 32 x 4, its simt route those of at
    most 1024 threads; vadvc's tiles within each route's shared memory at
    nz (the tune space's largest block, 512 threads, is the prefetch
    kernel's launch bound)."""
    tma32 = chip_smoke.route_tiles("hdiff", "tma", COSMO, "float32")
    assert len(tma32) == 11
    assert len(chip_smoke.route_tiles("hdiff", "tma", COSMO,
                                      "bfloat16")) == 12
    simt = chip_smoke.route_tiles("hdiff", "simt", COSMO, "float32")
    assert simt and all(t["tile_x"] * t["tile_y"] <= 1024 for t in simt)
    assert {"tile_x": 64, "tile_y": 16, "block_z": 1} in simt
    assert {"tile_x": 64, "tile_y": 32, "block_z": 1} not in simt
    v = chip_smoke.route_tiles("vadvc", "prefetch", COSMO, "float32")
    assert {"tile_x": 64, "tile_y": 4} in v and len(v) == 8
    assert {"tile_x": 128, "tile_y": 4} not in v
    assert len(chip_smoke.route_tiles("vadvc", "simt", COSMO,
                                      "float32")) == 8
    assert len(chip_smoke.route_tiles("vadvc", "prefetch", (8, 4, 16),
                                      "float32")) == 9


def test_hdiff_wrapper_checks_the_tma_tile_and_alignment():
    """On the tma route the wrapper takes only the built tiles whose ring
    fits, and a 16-byte-aligned grid; the simt route (rows not a multiple
    of 16 bytes) keeps PR 14's limits. (`_check` raises before any launch,
    so it runs on CPU tensors.)"""
    src = torch.zeros(4, 16, 32)
    assert hdiff_mod._check(src, 64, 16, 1) == "tma"
    for tile in ((32, 16, 1), (48, 16, 1), (64, 16, 8), (128, 32, 4)):
        with pytest.raises(ValueError, match="tma route"):
            hdiff_mod._check(src, *tile)
    odd = torch.zeros(4, 16, 30)
    assert hdiff_mod._check(odd, 32, 4, 8) == "simt"
    with pytest.raises(ValueError, match="simt block"):
        hdiff_mod._check(odd, 64, 32, 1)
    shifted = torch.zeros(4 * 16 * 32 + 1)[1:].view(4, 16, 32)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        hdiff_mod._check(shifted, 64, 16, 1)
    with pytest.raises(TypeError):
        hdiff_mod._check(src.double(), 64, 16, 1)
    with pytest.raises(ValueError, match="non-empty"):
        hdiff_mod._check(torch.zeros(16, 32), 64, 16, 1)
