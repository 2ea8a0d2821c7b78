"""Dry run: count every (arch x shape) cell's step on one device and record
its roofline inputs — the port of the JAX package's
``repro/launch/dryrun.py`` (`input_specs`, `run_cell`) at mesh 1x1.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-780m --shape train_4k
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --serve-plan   # serving-memory report
Results are cached as JSON under experiments/dryrun_torch/ (never the
reference's experiments/dryrun/, whose readers must not load them).

The reference lowers and compiles each step against ShapeDtypeStructs:
nothing is allocated on any device. The port does the same with PyTorch's
``meta`` device: the model's weights (`Model(cfg, device="meta")`), the
optimizer state, the caches and the batch are meta tensors, which carry
shapes and dtypes but no storage, and the step runs once under the cost
counter (`repro_torch.core.hlo_cost.CostCounter`), which counts each op
as it dispatches and each kernel call by its spec's ``work`` without
running it. This is the dry run's purpose — a full-width count of a
405B-parameter step on any machine — not a fallback from the card.

Memory: ``argument_bytes`` are the step's inputs (weights, optimizer
state, caches, batch), ``output_bytes`` the tensors it returns that it
created, ``temp_bytes`` the rest of the counter's peak of live bytes, so
``live_bytes_per_device`` = arguments + the peak; ``fits_hbm`` holds it
against `roofline.H100_SXM`. The roofline's memory term reads the
fusion-aware bytes (``bytes_accessed_fused``), as the reference's does;
the bytes eager PyTorch moves are recorded beside them.

``--serve-plan`` is the reference's pure-arithmetic serving report: per
arch and dp x tp serve mesh (`serve.sharding.ServePlan` on a deviceless
mesh), the weight and page-pool bytes one device holds against
`roofline.H100_SXM`'s memory, at 16 decode rows of 8192 tokens.

The step counts are of one device: ``--multi-pod``, ``--both-meshes``, a
``--mesh`` other than 1x1 and a ``--variant`` other than baseline belong
to the dry run on a mesh and raise `SystemExit` (ROADMAP Queue 1 item
6c).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.core.hlo_cost import CostCounter
from repro_torch.core.roofline import (H100_SXM, model_flops, roofline_terms,
                                       total_flops)
from repro_torch.models import Model
from repro_torch.models.common import flatten, torch_dtype
from repro_torch.models.transformer import model_spec, pad_caches
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train import train_step
from repro_torch.train.train_step import init_state, make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESH = "1x1"
PREFILL_ROWS = 4        # positions of the prefill that shapes decode caches
UNPORTED = ("belongs to the dry run on a mesh (ROADMAP Queue 1 item "
            "6c): the port's dry run counts one device, mesh 1x1")


def abstract_batch(model: Model, seq: int, global_batch: int,
                   kind: str = "train") -> dict:
    """Meta tensors for a step's batch on one device
    (`train.train_step.abstract_batch` without a mesh)."""
    return train_step.abstract_batch(model, seq, global_batch, None, kind)


def abstract_caches(model: Model, batch: int, capacity: int) -> list:
    """Decode caches at `capacity` on meta, as the engine makes them: a
    short prefill's caches through `pad_caches` (each cross layer holds
    its image tokens, each sliding-window layer its ring). The prefill
    has `PREFILL_ROWS` positions: a recurrent layer's conv cache keeps
    conv width - 1 rows only from a prompt at least that long."""
    cfg = model.cfg
    b = abstract_batch(model, min(PREFILL_ROWS, capacity), batch, "prefill")
    _, caches = model.forward_prefill(b.get("tokens"), embeds=b.get("embeds"),
                                      image_embeds=b.get("image_embeds"))
    return pad_caches(caches, capacity, cfg)


def input_specs(arch: str, shape_name: str, *, cfg=None, shape=None):
    """(fn, kwargs, model, shape) for the step of this cell, every input a
    meta tensor: the train step over the state and a batch, the prefill
    step over a batch, the decode step over capacity-sized caches at the
    last position. `cfg` and `shape` stand in for the registry's (a
    smoke config, a small shape)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    model = Model(cfg, device="meta")
    if shape.kind == "train":
        oc = OptimizerConfig()
        fn = make_train_step(model, oc,
                             num_microbatches=cfg.train_microbatches)
        kwargs = {"state": init_state(model, oc),
                  "batch": abstract_batch(model, shape.seq_len,
                                          shape.global_batch, "train")}
    elif shape.kind == "prefill":
        step = make_prefill_step(model)
        batch = abstract_batch(model, shape.seq_len, shape.global_batch,
                               "prefill")

        def fn(batch):
            return step(batch.get("tokens"), embeds=batch.get("embeds"),
                        image_embeds=batch.get("image_embeds"))
        kwargs = {"batch": batch}
    else:
        step = make_decode_step(model)
        batch = abstract_batch(model, shape.seq_len, shape.global_batch,
                               "decode")

        def fn(caches, batch, pos):
            return step(caches, batch.get("tokens"), pos,
                        embeds=batch.get("embeds"))
        kwargs = {"caches": abstract_caches(model, shape.global_batch,
                                            shape.seq_len),
                  "batch": batch, "pos": shape.seq_len - 1}
    return fn, kwargs, model, shape


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in `tree`."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


def count_cell(arch: str, shape_name: str, *, hw=H100_SXM, cfg=None,
               shape=None) -> dict:
    """Count one cell's step (`input_specs`); returns its record without
    status or path."""
    fn, kwargs, model, shape = input_specs(arch, shape_name, cfg=cfg,
                                           shape=shape)
    args_b = storage_bytes((kwargs, model.params))
    t0 = time.perf_counter()
    with CostCounter() as c:
        out = fn(**kwargs)
    count_s = time.perf_counter() - t0
    tc = c.summary()
    out_b = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                if isinstance(t, torch.Tensor)
                and id(t.untyped_storage()) in c._storages)
    flops = tc["flops"]
    rec = {
        "count_s": round(count_s, 3),
        "memory": {"argument_bytes": args_b, "output_bytes": out_b,
                   "temp_bytes": max(tc["peak_live_bytes"] - out_b, 0),
                   "alias_bytes": 0,
                   "live_bytes_per_device": args_b + tc["peak_live_bytes"]},
        "cost": {"flops_per_device": flops,
                 "flops_by_class": tc["flops_by_class"],
                 "bytes_per_device": tc["bytes_accessed_fused"],
                 "bytes_per_device_unfused": tc["bytes_accessed"],
                 "transcendentals": tc["transcendentals"],
                 "ops": tc["ops"]},
        "kernels": tc["kernels"], "kernel_routes": tc["kernel_routes"],
        "collectives": tc["collectives"], "cost_warnings": tc["warnings"],
        "roofline": roofline_terms(tc["flops_by_class"],
                                   tc["bytes_accessed_fused"],
                                   tc["collectives"]["total_bytes"], hw),
        "hardware": hw.name,
    }
    rec["memory"]["fits_hbm"] = bool(
        rec["memory"]["live_bytes_per_device"] <= hw.hbm_gib * 2 ** 30)
    mf = model_flops(model.cfg, shape, 1)
    rec["model_flops_per_device"] = mf
    rec["useful_flops_ratio"] = mf / total_flops(flops) if flops else 0.0
    return rec


def run_cell(arch: str, shape_name: str, *, out_dir: Path = OUT_DIR,
             force: bool = False, hw=H100_SXM, cfg=None, shape=None) -> dict:
    out_path = Path(out_dir) / f"{arch}__{shape_name}__{MESH}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH, "chips": 1,
           "status": "ok", "variant": "baseline"}
    t0 = time.perf_counter()
    try:
        rec.update(count_cell(arch, shape_name, hw=hw, cfg=cfg,
                              shape=shape))
    except Exception as e:  # record failures for triage, don't hide them
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.perf_counter() - t0, 3)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


# ---------------------------------------------------------------------------
# --serve-plan: the reference's analytic serving-memory report, plain
# arithmetic over the spec's shapes — no device, no allocation
# ---------------------------------------------------------------------------
SERVE_BATCH = 16           # decode rows
SERVE_CONTEXT = 8_192      # KV tokens held per sequence
SERVE_PAGE_TOKENS = 16     # serve launcher default page size
SERVE_MESHES = "1x1,1x8,2x4,4x8"


def _spec_divisor(spec, sizes: dict) -> int:
    """How many devices one leaf is split over under a spec."""
    div = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            div *= sizes[ax]
    return div


def serve_plan_cell(arch: str, dp: int, tp: int, hw=H100_SXM) -> dict:
    """Per-device serving memory of one (arch, dp x tp mesh) cell at the
    SERVE_BATCH x SERVE_CONTEXT serving point, the reference's arithmetic:
    weights split by `ServePlan.param_specs`, the page pool as
    `DevicePagePool` sizes it per data shard (every layer, kv heads over
    the model axis, fp32 K/V pages + int8 copies + fp32 scales)."""
    from repro_torch.serve.paged_state import supports_paged_layout
    from repro_torch.serve.sharding import ServePlan

    cfg = get_config(arch)
    rec = {"arch": arch, "mesh": f"{dp}x{tp}", "dp": dp, "tp": tp,
           "hardware": hw.name, "status": "ok"}
    if not supports_paged_layout(cfg):
        rec["status"] = "no_paged_path"
        return rec
    plan = ServePlan(make_abstract_mesh((dp, tp), ("data", "model")))
    try:
        plan.check_config(cfg)
    except ValueError as e:
        rec["status"] = "indivisible"
        rec["error"] = str(e)
        return rec
    sizes = {"data": dp, "model": tp}
    specs = plan.param_specs(cfg)
    params_dev = 0
    for name, ps in flatten(model_spec(cfg)).items():
        n = 1
        for d in ps.shape:
            n *= int(d)
        total = n * torch.empty((), dtype=torch_dtype(
            ps.dtype or cfg.param_dtype)).element_size()
        params_dev += total // _spec_divisor(specs[name], sizes)
    t, hkv, hd = SERVE_PAGE_TOKENS, cfg.num_kv_heads, cfg.head_dim
    rows_per_shard = -(-SERVE_BATCH // dp)
    slots_per_seq = -(-SERVE_CONTEXT // t) + 2     # + tail/spill headroom
    cap_local = 1
    while cap_local < max(8, rows_per_shard * slots_per_seq):
        cap_local *= 2
    hkv_local = hkv // tp
    slot_bytes = (2 * t * hkv_local * hd * (4 + 1)    # pages + quant
                  + 2 * t * hkv_local * 4)            # scales
    pool_dev = cfg.num_layers * cap_local * slot_bytes
    hbm = int(hw.hbm_gib * 2 ** 30)
    rec.update(params_bytes_per_device=params_dev,
               pool_bytes_per_device=pool_dev,
               pool_slots_per_device=cap_local,
               rows_per_shard=rows_per_shard,
               hbm_bytes=hbm,
               headroom_bytes=hbm - params_dev - pool_dev)
    if rec["headroom_bytes"] < 0:
        rec["status"] = "UNSERVABLE"
    return rec


def parse_meshes(spec: str) -> list:
    """"DxM[,DxM...]" -> [(d, m), ...]."""
    out = []
    for part in spec.split(","):
        try:
            d, m = (int(x) for x in part.strip().lower().split("x"))
        except ValueError:
            raise SystemExit(f"--serve-meshes wants DxM[,DxM...], got "
                             f"{part!r}")
        out.append((d, m))
    return out


def serve_plan_main(args, hw=H100_SXM) -> list:
    """Print and write (``serve_plan.json`` under ``--out``) the serve-plan
    records of every arch (or ``--arch``) at every ``--serve-meshes``
    mesh. Returns the records."""
    archs = [args.arch] if args.arch else list_archs()
    meshes = parse_meshes(args.serve_meshes)
    gib = 2 ** 30
    recs = []
    n_unservable = 0
    print(f"serving plan @ batch={SERVE_BATCH} context={SERVE_CONTEXT} "
          f"page_tokens={SERVE_PAGE_TOKENS} hw={hw.name} "
          f"({hw.hbm_gib:.1f} GiB/device)")
    print(f"{'arch':24s} {'mesh':7s} {'params/dev':>11s} {'pool/dev':>11s} "
          f"{'headroom':>11s} status")
    for arch in archs:
        for d, m in meshes:
            rec = serve_plan_cell(arch, d, m, hw=hw)
            recs.append(rec)
            if rec["status"] == "no_paged_path":
                print(f"{arch:24s} {rec['mesh']:7s} {'-':>11s} {'-':>11s} "
                      f"{'-':>11s} {rec['status']}")
                break                      # same verdict on every mesh
            if rec["status"] == "indivisible":
                print(f"{arch:24s} {rec['mesh']:7s} {'-':>11s} {'-':>11s} "
                      f"{'-':>11s} indivisible")
                continue
            n_unservable += rec["status"] == "UNSERVABLE"
            print(f"{arch:24s} {rec['mesh']:7s} "
                  f"{rec['params_bytes_per_device'] / gib:10.2f}G "
                  f"{rec['pool_bytes_per_device'] / gib:10.2f}G "
                  f"{rec['headroom_bytes'] / gib:10.2f}G {rec['status']}")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / "serve_plan.json"
    out_path.write_text(json.dumps(
        {"batch": SERVE_BATCH, "context": SERVE_CONTEXT,
         "page_tokens": SERVE_PAGE_TOKENS, "hardware": hw.name,
         "cells": recs}, indent=2))
    print(f"{n_unservable} unservable cells; wrote {out_path}")
    return recs


def all_cells():
    return [(arch, shape.name) for arch in list_archs()
            for shape in shapes_for(get_config(arch))]


def refuse_unported(args) -> None:
    if args.multi_pod or args.both_meshes:
        raise SystemExit(f"--multi-pod / --both-meshes {UNPORTED}")
    if args.mesh != MESH:
        raise SystemExit(f"--mesh {args.mesh} {UNPORTED}")
    if args.variant != "baseline":
        raise SystemExit(f"--variant {args.variant} {UNPORTED} "
                         f"(launch/variants.py waits for it)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--mesh", default=MESH)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--serve-plan", action="store_true",
                    help="analytic serving-memory report per arch x serve "
                         "mesh (no device): weights + page-pool bytes per "
                         "device vs the card's memory")
    ap.add_argument("--serve-meshes", default=SERVE_MESHES,
                    help="comma-separated DxM serve meshes for --serve-plan")
    args = ap.parse_args(argv)
    refuse_unported(args)
    if args.serve_plan:
        serve_plan_main(args)
        raise SystemExit(0)
    if not args.all and not (args.arch and args.shape):
        raise SystemExit("give --arch and --shape, or --all")
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    n_fail = 0
    for arch, shape in cells:
        rec = run_cell(arch, shape, out_dir=Path(args.out), force=args.force)
        n_fail += rec["status"] != "ok"
        if rec["status"] == "ok":
            r = rec["roofline"]
            extra = (f"bottleneck={r['bottleneck']} "
                     f"frac={r['roofline_fraction']:.3f} "
                     f"fits={rec['memory']['fits_hbm']} "
                     f"count={rec['count_s']:.1f}s")
        else:
            extra = rec["error"][:120]
        print(f"[{time.strftime('%H:%M:%S')}] {arch:24s} {shape:12s} "
              f"{MESH:5s} {rec['status']:5s} {extra}", flush=True)
    print(f"done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
