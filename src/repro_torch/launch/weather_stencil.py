"""NERO end to end on the port: the COSMO weather stencils through the
kernel registry, with the window knee from the Hopper cost model and a
number-format sweep — the thesis's Ch. 3 + 4 flow, the counterpart of
``examples/weather_stencil.py``.

    PYTHONPATH=src python -m repro_torch.launch.weather_stencil
    PYTHONPATH=src python -m repro_torch.launch.weather_stencil --device cpu
    PYTHONPATH=src python -m repro_torch.launch.weather_stencil --grid cosmo
    PYTHONPATH=src python -m repro_torch.launch.weather_stencil \\
        --knee-cache /path/to/ckpt/knee_cache.json

Three steps: (1) each kernel through ``api.run`` (``auto``: the kernel at
its knee on the card, the tile `api.resolve_tile` gives, which
``--knee-cache`` loads before the run and saves after it when a knee was
resolved anew) against its plain version on the same inputs; (2)
the knee of each kernel's tune space at the COSMO production grid for
fp32 and bf16; (3) the hdiff precision sweep over fixed(16,4),
floatx(5,10), posit(16,2) and posit(12,2), through the kernel on the
card. Steps 1 and 3 run at the smoke grid, as the reference example
does, or with ``--grid cosmo`` at the COSMO production grid. Runs on
``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.cosmo_stencil import cosmo_grid, smoke_grid
from repro_torch.core import precision as prec
from repro_torch.core.autotune import autotune_kernel
from repro_torch.kernels import api, registry

SWEEP_FORMATS = (prec.fmt_fixed(16, 4), prec.fmt_float(5, 10),
                 prec.fmt_posit(16, 2), prec.fmt_posit(12, 2))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--grid", default="smoke", choices=("smoke", "cosmo"),
                    help="grid of the kernel check and the sweep")
    ap.add_argument("--knee-cache", default=None, metavar="PATH",
                    help="JSON cache of the knees step 1 resolves (e.g. "
                         "<checkpoint-dir>/knee_cache.json): loaded first, "
                         "saved at the end, so a restart skips re-tuning")
    opts = ap.parse_args(argv)
    device = opts.device
    g = smoke_grid() if opts.grid == "smoke" else cosmo_grid()
    shape = {"nz": g.nz, "ny": g.ny, "nx": g.nx}
    result = {"device": device, "grid": shape, "check": {}, "tile": {},
              "knee": {}}
    if opts.knee_cache:
        result["knees_loaded"] = api.load_knee_cache(opts.knee_cache)

    # 1) the kernels (plain versions on the CPU) against their plain
    #    versions, through the single registry dispatch
    for name in ("hdiff", "vadvc"):
        spec = registry.get(name)
        args = [torch.from_numpy(v).to(device)
                for v in spec.example_inputs(shape=shape).values()]
        # the tile "auto" launches at on the card (cached per grid)
        result["tile"][name] = api.resolve_tile(name, args)
        out_k = api.run(name, *args, backend="auto")
        out_r = api.run(name, *args, backend="ref")
        err = (out_k - out_r).abs().max().item()
        result["check"][name] = err
        print(f"{name} kernel max|err| vs plain: {err:.2e}")

    # 2) NERO window auto-tune at the COSMO production grid, from the
    #    Hopper cost model; backend="auto" applies the same knee
    G = cosmo_grid()
    grid = (G.nz, G.ny, G.nx)
    for name in ("hdiff", "vadvc"):
        spec = registry.get(name)
        for dtype in ("float32", "bfloat16"):
            k = autotune_kernel(spec, grid, dtype=dtype)["knee"]
            result["knee"][(name, dtype)] = k
            tiles = " ".join(f"{p}={v}" for p, v in sorted(k.params.items()))
            print(f"{name} autotuned window ({dtype}): {tiles} "
                  f"smem={k.smem_bytes // 1024}KiB "
                  f"est={k.est_time_s * 1e6:.1f}us")

    # 3) precision sweep (thesis Fig. 4-4), via the spec's example_inputs
    result["sweep"] = prec.precision_sweep_kernel(
        "hdiff", SWEEP_FORMATS, shape=shape, device=device)
    for r in result["sweep"]:
        print(f"hdiff @ {r['format']:12s}: accuracy "
              f"{r['accuracy_pct']:.3f}%")
    if opts.knee_cache and api.knees_dirty():
        result["knees_saved"] = api.save_knee_cache(opts.knee_cache)
    return result


if __name__ == "__main__":
    main()
