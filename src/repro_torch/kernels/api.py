"""One `KernelSpec` per hand-written kernel, one `run()` dispatch over
all of them — the port's counterpart of ``repro/kernels/api.py``.

    from repro_torch.kernels import api
    y = api.run("paged_attention", *args)                   # "auto"
    y = api.run("paged_attention", *args, backend="cuda")   # the kernel
    y = api.run("paged_attention", *args, backend="ref")    # plain PyTorch
    y = api.run("hdiff", src, tile={"tile_x": 64, "tile_y": 16,
                                    "block_z": 1})          # a chosen tile
    y = api.run("paged_attention", *args, tile={"pages_per_block": 1})

``auto`` runs the kernel on CUDA tensors and the plain version on CPU
tensors (through the kernel's wrapper, which makes that choice). Under
autograd the flash-attention, SSD and RG-LRU wrappers run through their
autograd Functions, so ``auto`` and ``cuda`` are differentiable; ``ref``
is differentiated through the plain version's own operations. Every
spec has a ``tune_space`` and takes a ``tile`` from it: the stencils'
blocks, paged attention's ``pages_per_block``, flash attention's
``block_q`` / ``block_k``, the scans' ``chunk``. With ``auto`` and no
tile a kernel launches at the knee of the spec's Hopper cost model
(`resolve_tile`, once per kernel, grid and dtype); with ``cuda`` and no
tile, at the wrapper's own launch (the launch before tiles could be
chosen). A route that has no such freedom reads no tile, and neither
does the plain version. Resolved knees persist across restarts through
`save_knee_cache` / `load_knee_cache` (``launch.weather_stencil
--knee-cache``, ``launch.serve --knee-cache``, ``ServeEngine(
knee_cache=)``), keyed by kernel, grid, dtype and the arch they were
resolved for, in a file of the port's own (`knee_cache_path`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from pathlib import Path
from typing import Callable, Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One validation case: a shape dict, a dtype and the keyword
    arguments the function is called with."""
    shape: Mapping[str, int]
    dtype: str = "float32"
    kwargs: Mapping = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """What the port knows about a kernel. The fields after ``cases``
    serve the data-driven layers (autotune, precision sweeps) and default
    to a kernel with a fixed launch shape.

    cost_fn follows the `core.autotune` contract:
    ``cost_fn(grid_shape, tile, dtype_bytes) -> (smem_bytes, est_time_s)``
    or ``None`` when a block of that tile cannot launch. ``grid_shape`` is
    ``tuple(shape[k] for k in shape_keys)``, which ``grid_of`` recovers
    from live arrays. ``fixed_tile(grid_shape) -> tile`` is the wrapper's
    own launch shape (``backend="cuda"`` without a tile); a knee that the
    cost model does not call `autotune.KNEE_MARGIN` faster than it gives
    way to it (`autotune.autotune_kernel`).
    """
    name: str
    fn: Callable                 # the wrapper: kernel on CUDA, plain on CPU
    ref_fn: Callable             # the plain PyTorch version
    arg_names: tuple             # positional argument names, in order
    example_inputs: Callable     # (shape=None, dtype=..., seed=0) -> dict
    tol: Mapping[str, float]     # per-dtype max abs error vs ref_fn
    cases: tuple = ()            # KernelCase sweep for tests
    tune_space: Mapping[str, tuple] = dataclasses.field(
        default_factory=dict)    # tile param -> candidate values
    cost_fn: Callable | None = None       # Hopper cost model (see above)
    flops: Callable | None = None         # (grid_shape) -> useful flops
    grid_of: Callable | None = None       # (*args) -> grid_shape tuple
    shape_keys: tuple = ()                # logical dims of the grid shape
    fixed_tile: Callable | None = None    # (grid_shape) -> the own launch
    default_shape: Mapping[str, int] = dataclasses.field(
        default_factory=dict)             # smoke size (tests, sweeps)
    bench_shape: Mapping[str, int] = dataclasses.field(
        default_factory=dict)             # production size
    dtypes: tuple = ("float32",)


def as_spec(kernel) -> KernelSpec:
    """Accept a spec or a registered name everywhere."""
    if isinstance(kernel, KernelSpec):
        return kernel
    from repro_torch.kernels import registry
    return registry.get(kernel)


BACKENDS = ("cuda", "ref", "auto")


def run(name, *args, backend: str = "auto", tile=None, **kwargs):
    """Single entry point over every registered kernel. ``backend="cuda"``
    on CPU tensors raises. ``tile`` is taken only by a spec with a
    ``tune_space``, only with names from it, and never with ``"ref"``
    (the plain version takes no tile, so a tiled call would silently
    measure it). ``auto`` on CUDA tensors with no tile launches at the
    knee (`resolve_tile`); on CPU tensors the wrapper runs the plain
    version, which ignores a tile."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    spec = as_spec(name)
    if tile is not None:
        if not spec.tune_space:
            raise ValueError(f"{spec.name}: tile={tile!r} — the kernel's "
                             f"launch shape is fixed and the plain version "
                             f"takes no tile parameters")
        if backend == "ref":
            raise ValueError(f"{spec.name}: tile={tile!r} has no effect "
                             f"with backend='ref' — the plain version takes "
                             f"no tile parameters; drop it or use 'cuda'")
        unknown = set(tile) - set(spec.tune_space)
        if unknown:
            raise ValueError(f"{spec.name}: unknown tile params "
                             f"{sorted(unknown)} (tunable: "
                             f"{sorted(spec.tune_space)})")
    if backend == "ref":
        return spec.ref_fn(*args, **kwargs)
    if backend == "cuda" and not args[0].is_cuda:
        raise ValueError(f"{spec.name}: backend='cuda' needs CUDA tensors, "
                         f"got {args[0].device}")
    if tile is None and backend == "auto" and spec.tune_space \
            and args[0].is_cuda:
        tile = resolve_tile(spec, args)
    return spec.fn(*args, **(tile or {}), **kwargs)


# ---------------------------------------------------------------------------
# Tile resolution (NERO knee point), cached per (kernel, grid, dtype)
# ---------------------------------------------------------------------------
# Resolved knees live in a plain dict so they can be persisted and
# reloaded: a restart then skips re-tuning every (kernel, grid, dtype) it
# already saw.
_KNEES: dict[tuple, tuple] = {}    # (name, grid, dtype) -> frozen tile
_knees_dirty = False
# The arch the knees were resolved for. The cost models are Hopper's and
# the kernels are built for it, so a cache file's entries of another arch
# (a TPU knee cache, which keys on a VMEM budget instead) never load.
KNEE_ARCH = "sm_90a"


def resolve_tile(kernel, args) -> dict:
    """Knee-point tile for these arguments, from the spec's cost model."""
    global _knees_dirty
    spec = as_spec(kernel)
    grid = tuple(int(n) for n in spec.grid_of(*args))
    dtype = str(args[0].dtype).removeprefix("torch.")
    key = (spec.name, grid, dtype)
    tile = _KNEES.get(key)
    if tile is None:
        from repro_torch.core.autotune import autotune_kernel
        knee = autotune_kernel(spec, grid, dtype=dtype)["knee"]
        tile = _KNEES[key] = tuple(sorted(knee.params.items()))
        _knees_dirty = True
    return dict(tile)


def knee_cache_path(checkpoint_dir) -> Path:
    """The port's knee-cache file next to a checkpoint directory. It is
    not the JAX package's ``knee_cache.json``: the reference's loader
    drops a file holding entries it does not key (this arch's) and its
    saver raises on them, so both engines can serve beside one
    checkpoint only from files of their own."""
    return Path(checkpoint_dir) / f"knee_cache_{KNEE_ARCH}.json"


def _entry_key(e: dict) -> tuple:
    """(kernel, grid, dtype) of one entry of this arch, with its tile
    checked against the spec's tune space. Raises ValueError / KeyError /
    TypeError on an entry the port cannot launch."""
    key = (str(e["kernel"]), tuple(int(n) for n in e["grid"]),
           str(e["dtype"]))
    tile = e["tile"]
    if not isinstance(tile, dict):
        raise TypeError(f"tile {tile!r} is not a dict")
    space = as_spec(key[0]).tune_space
    if set(tile) != set(space) or any(tile[k] not in space[k] for k in tile):
        raise ValueError(f"{key[0]}: tile {tile} is not in the tune space "
                         f"{dict(space)}")
    return key


def _read_entries(p: Path) -> tuple[dict, list, list]:
    """The file's entries of this arch by (kernel, grid, dtype); its other
    entries as they are (another arch's, or the JAX package's, which key
    on a VMEM budget and name no arch); and the reasons for the entries of
    this arch skipped as malformed."""
    ours, foreign, skipped = {}, [], []
    raw = json.loads(p.read_text())
    if not isinstance(raw, list):
        raise TypeError(f"{type(raw).__name__}, not a list of entries")
    for e in raw:
        if isinstance(e, dict) and e.get("arch") != KNEE_ARCH:
            foreign.append(e)
            continue
        try:
            ours[_entry_key(e)] = dict(e["tile"])
        except (ValueError, KeyError, TypeError) as err:
            skipped.append(f"{err!r}")
    return ours, foreign, skipped


def _warn_malformed(p, why):
    warnings.warn(f"ignoring malformed knee cache entries in {p}: {why} "
                  f"(knees will be re-tuned and the file rewritten)")


def save_knee_cache(path) -> int:
    """Write every knee resolved so far to `path` (JSON), MERGED with the
    entries already in the file (in-memory knees win), so a process that
    only resolved a subset never truncates knees persisted by earlier
    runs. Entries of another arch, the JAX package's among them, are
    written back unchanged; malformed entries of this arch, or a file
    that is not a list of entries, are replaced with a warning. The write
    is an atomic replace: a crash mid-write never leaves a truncated
    file. Returns the entry count."""
    global _knees_dirty
    p = Path(path)
    ours, foreign = {}, []
    if p.exists():
        try:
            ours, foreign, skipped = _read_entries(p)
        except (ValueError, TypeError) as err:
            _warn_malformed(p, err)
        else:
            if skipped:
                _warn_malformed(p, "; ".join(skipped))
    ours.update({k: dict(t) for k, t in _KNEES.items()})
    entries = [{"arch": KNEE_ARCH, "kernel": k[0], "grid": list(k[1]),
                "dtype": k[2], "tile": t}
               for k, t in sorted(ours.items())] + foreign
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f".{p.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(entries, indent=1))
    os.replace(tmp, p)
    _knees_dirty = False
    return len(entries)


def load_knee_cache(path) -> int:
    """Load previously persisted knees of this arch (missing file -> 0).
    Loaded entries pre-populate the resolver, so ``backend="auto"``
    dispatches skip the tuning sweep for shapes a previous run already
    resolved. A malformed file, or an entry of another arch or with a tile
    the spec's tune space cannot launch, is a warning and is skipped,
    never a startup failure and never a launch. Returns the count loaded."""
    p = Path(path)
    if not p.exists():
        return 0
    try:
        ours, foreign, skipped = _read_entries(p)
    except (ValueError, TypeError) as err:
        _warn_malformed(p, err)
        return 0
    for key, tile in ours.items():
        _KNEES.setdefault(key, tuple(sorted(tile.items())))
    skipped += [f"arch {e.get('arch')!r} is not {KNEE_ARCH!r}"
                for e in foreign]
    if skipped:
        _warn_malformed(p, "; ".join(skipped))
    return len(ours)


def knees_dirty() -> bool:
    """True when a knee was resolved since the last save_knee_cache."""
    return _knees_dirty


def invalidate_caches():
    """Drop every resolved tile (the next ``auto`` dispatch re-tunes):
    nothing unsaved is left, so the store is clean."""
    global _knees_dirty
    _KNEES.clear()
    _knees_dirty = False


# ---------------------------------------------------------------------------
# Numpy adapter for the precision layers (Ch. 4 sweeps take numpy fns)
# ---------------------------------------------------------------------------
def numpy_fn(kernel, device: str = "cuda", backend: str = "auto") -> Callable:
    """fn(**inputs) running ``run(kernel, ..., backend=backend)`` on
    `device` with numpy inputs and a numpy output: the shape
    `precision_sweep` / `search_fixed_point` expect. Inexact inputs are
    cast to fp32 (integer inputs keep their dtype). On the card ``auto``
    goes through the kernel, never the plain version."""
    spec = as_spec(kernel)

    def fn(**inputs):
        import torch

        def cast(v):
            v = np.asarray(v)
            if not np.issubdtype(v.dtype, np.integer):
                v = v.astype(np.float32)
            return torch.from_numpy(np.ascontiguousarray(v)).to(device)

        args = [cast(inputs[n]) for n in spec.arg_names]
        out = run(spec.name, *args, backend=backend)
        return out.float().cpu().numpy()

    return fn
