"""Dry run: count every (arch x shape) cell's step and record its roofline
inputs — the port of the JAX package's ``repro/launch/dryrun.py``
(`input_specs`, `run_cell`), on one device (mesh 1x1) or per device of a
mesh: the reference's 16 x 16 pod and 2 x 16 x 16 multi-pod.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-780m --shape train_4k
  python -m repro_torch.launch.dryrun --all                # one device
  python -m repro_torch.launch.dryrun --all --mesh 16x16   # the pod
  python -m repro_torch.launch.dryrun --all --multi-pod    # 2x16x16
  python -m repro_torch.launch.dryrun --all --both-meshes  # both pods
  python -m repro_torch.launch.dryrun --all --mesh 16x16 --variant no_remat
  python -m repro_torch.launch.dryrun --serve-plan   # serving-memory report
  python -m repro_torch.launch.dryrun --arch A --shape S --save-hlo
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

On a mesh (``--mesh DxM``; ``--multi-pod``, ``--both-meshes``) a cell
counts one device's step of the port's plan (`train.sharding.TrainPlan`):
the state or weights stored by `DEFAULT_RULES` (a ``--variant``'s rules,
`launch.variants`: FSDP over ``data``, as the reference's
``abstract_params_sharded``), the decode caches by `spec_for` over
`models.transformer.cache_spec` (``kv_seq`` over ``model`` where the kv
heads do not divide: the plan then decodes over the split positions),
both gathered to the per-shard compute slices. The plan is built with
``count_positions`` on ``meta``: only positions (0, 0) and (0, 1) run
(model shard 0 of a row also runs the embedding, final norm, LM head and
loss), each seam stands in for the others and records its collective.
The record reports the position with the longer roofline step as the
device's, both beside it under ``positions``, and says so in
``position_note``. ``count_s`` is the count's wall time, which takes the
place of the reference's ``lower_s`` / ``compile_s``.

``--save-hlo`` keeps the reference's flag. There is no HLO: the cell is
counted under ``CostCounter(inspect=True)`` and its op log
(`core.hlo_inspect.op_log`: the rows per op, shape and source, the
collectives' rows and the kernel entries; on a mesh the reported
position's) is written beside the record as
``<arch>__<shape>__<mesh>.ops.json``, whose path the record keeps under
``ops_path``. `core.hlo_inspect` reads it as it reads a live counter.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.core.hlo_inspect import op_log
from repro_torch.kernels import count
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.core.hlo_cost import CostCounter
from repro_torch.core.roofline import (H100_SXM, model_flops, roofline_terms,
                                       total_flops)
from repro_torch.models import Model
from repro_torch.models.common import flatten, torch_dtype
from repro_torch.models.transformer import (cache_spec, model_spec,
                                            pad_caches)
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train import train_step
from repro_torch.train.train_step import init_state, make_train_step
from repro_torch.sharding.partition import DEFAULT_RULES, spec_for
from repro_torch.train.sharding import ShardedTrainModel, TrainPlan

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESH = "1x1"
POD = "16x16"
PREFILL_ROWS = 4        # positions of the prefill that shapes decode caches
POSITION_NOTE = ("model shard 0 of a row also runs the embedding, final "
                 "norm, LM head and loss: the device's count is the larger "
                 "of positions (0, 0) and (0, 1) by roofline step time; both "
                 "are under positions")


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
               shape=None, ops: bool = False) -> dict:
    """Count one cell's step (`input_specs`); returns its record without
    status or path, and with `ops` its op log under ``"ops"``."""
    fn, kwargs, model, shape = input_specs(arch, shape_name, cfg=cfg,
                                           shape=shape)
    args_b = storage_bytes((kwargs, model.params))
    t0 = time.perf_counter()
    with CostCounter(inspect=ops) as c:
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
    if ops:
        rec["ops"] = op_log(c)
    return rec


def run_cell(arch: str, shape_name: str, *, out_dir: Path = OUT_DIR,
             force: bool = False, hw=H100_SXM, cfg=None, shape=None,
             mesh: str = MESH, multi_pod: bool = False,
             variant: str = "baseline", save_hlo: bool = False) -> dict:
    """Count one cell and write its record (cached: a second call reads
    it). `mesh` "1x1" counts one device (`count_cell`); any other
    ("16x16", "DxM", "PxDxM"; ``multi_pod``: 2x16x16) one device of the
    port's plan on that mesh (`count_cell_mesh`). With `save_hlo` the
    cell's op log is written beside the record (``.ops.json``, its path
    under ``ops_path``)."""
    shape_t = (2, 16, 16) if multi_pod else parse_mesh(mesh)
    one = math.prod(shape_t) == 1
    if one and variant != "baseline":
        raise SystemExit("--variant counts a plan: give --mesh DxM, "
                         "--multi-pod or --both-meshes")
    tag = "" if variant == "baseline" else f"__variant_{variant}"
    name = MESH if one else mesh_label(shape_t) + tag
    out_path = Path(out_dir) / f"{arch}__{shape_name}__{name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "chips": math.prod(shape_t), "status": "ok", "variant": variant}
    t0 = time.perf_counter()
    try:
        if one:
            rec.update(count_cell(arch, shape_name, hw=hw, cfg=cfg,
                                  shape=shape, ops=save_hlo))
        else:
            rec.update(count_cell_mesh(arch, shape_name, shape_t, hw=hw,
                                       variant=variant, cfg=cfg,
                                       shape=shape, ops=save_hlo))
        if save_hlo:
            ops_path = out_path.with_suffix(".ops.json")
            ops_path.parent.mkdir(parents=True, exist_ok=True)
            ops_path.write_text(json.dumps(rec.pop("ops")))
            rec["ops_path"] = str(ops_path)
    except Exception as e:  # record failures for triage, don't hide them
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.perf_counter() - t0, 3)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


# ---------------------------------------------------------------------------
# per device of a mesh: one or two positions of the port's plan
# ---------------------------------------------------------------------------
def parse_mesh(spec: str) -> tuple:
    """"DxM" -> (d, m); "PxDxM" -> (p, d, m)."""
    try:
        out = tuple(int(x) for x in spec.strip().lower().split("x"))
    except ValueError:
        out = ()
    if len(out) not in (2, 3) or min(out, default=0) < 1:
        raise SystemExit(f"--mesh wants DxM (or PxDxM), got {spec!r}")
    return out


def mesh_label(shape: tuple) -> str:
    """The record's mesh name: the reference's ``pod16x16`` /
    ``pod2x16x16`` for its two pods, else ``DxM``."""
    if shape in ((16, 16), (2, 16, 16)):
        return "pod" + "x".join(map(str, shape))
    return "x".join(map(str, shape))


def abstract_mesh(shape: tuple):
    axes = ("pod", "data", "model") if len(shape) == 3 else \
        ("data", "model")
    return make_abstract_mesh(shape, axes)


def count_positions(plan_like) -> list:
    """The positions a cell counts: (0, 0) and the next on its row (the
    next row on a mesh of one model shard)."""
    dp, tp = plan_like
    if tp > 1:
        return [(0, 0), (0, 1)]
    return [(0, 0), (1, 0)] if dp > 1 else [(0, 0)]


def _rows_of(plan, n: int) -> dict:
    """Rows of an n-row batch per data shard the plan runs: equal blocks,
    or every row on each (replicated) when dp does not divide n."""
    if n % plan.dp == 0:
        per = n // plan.dp
        return {d: slice(d * per, (d + 1) * per) for d in plan.rows()}
    return {d: slice(0, n) for d in plan.rows()}


def _decode_caches(plan, model, rules, batch, capacity: int, rows: dict):
    """Each position's decode caches: ``{d: per-layer lists over the
    row's model shards}``, and per position (storage bytes, the bytes of
    all-gathers its compute slices need). A short meta prefill through
    the position's body gives the compute layout (kv heads a shard reads,
    the SSD conv whole, ...), padded to `capacity`; an attention or MLA
    cache whose positions the storage splits over ``model`` keeps the
    storage's slice and decodes over it (``"seq_split"``)."""
    cfg = model.cfg
    abstract, logical = cache_spec(cfg, batch, capacity)
    out, held, gathers = {}, {}, {}
    for d, rs in rows.items():
        b = rs.stop - rs.start
        pre = train_step.abstract_batch(cfg, min(PREFILL_ROWS, capacity), b,
                                        None, "prefill")
        _, caches = model.run(d, pre, mode="prefill")
        ms = plan.row(d)
        shards = [pad_caches([c[j] for c in caches], capacity, cfg)
                  for j in range(len(ms))]
        for j, m in enumerate(ms):
            pos = (d, m)
            held[pos] = gathers[pos] = 0
            for layer, (a_l, l_l) in enumerate(zip(abstract, logical)):
                c = shards[j][layer]
                for name, a in a_l.items():
                    spec = spec_for(a.shape, l_l[name], plan.mesh, rules)
                    idx = plan.serve.local_index(a.shape, spec, 0, m)
                    shape = [len(range(*sl.indices(n)))
                             for sl, n in zip(idx, a.shape)]
                    # the batch dim is the data shard's rows
                    shape[0] = b
                    nbytes = math.prod(shape) * a.element_size()
                    held[pos] += nbytes
                    split = len(spec) > 1 and spec[1] is not None and \
                        name in ("k", "v", "ckv", "krope")
                    if split:
                        c[name] = torch.empty(shape, dtype=a.dtype,
                                              device="meta")
                        c["seq_split"] = True
                    elif c[name].numel() * a.element_size() > nbytes:
                        gathers[pos] += nbytes
        out[d] = [[shards[j][layer] for j in range(len(ms))]
                  for layer in range(len(abstract))]
    return out, held, gathers


def plan_input_specs(arch: str, shape_name: str, mesh_shape: tuple, *,
                     variant: str = "baseline", cfg=None, shape=None,
                     positions=None):
    """(fn, argument bytes per position, plan, cfg, shape) of one cell on
    a mesh: `fn()` runs the counted positions' step (the train step at
    ``cfg.train_microbatches``; the prefill; one decode step at the last
    position over capacity-sized caches), every input a meta tensor."""
    cfg = cfg or get_config(arch)
    rules = None
    if variant != "baseline":
        from repro_torch.launch import variants
        cfg, rules = variants.apply(variant, cfg)
    shape = shape or SHAPES[shape_name]
    mesh = abstract_mesh(mesh_shape)
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    dp = sizes.get("pod", 1) * sizes["data"]
    positions = positions or count_positions((dp, sizes["model"]))
    plan = TrainPlan(mesh, cfg, rules, count_positions=positions)
    model = ShardedTrainModel(cfg, plan)
    held = {p: storage_bytes(model.shards[p[0]][p[1]]) for p in plan.shards}
    batch = abstract_batch(cfg, shape.seq_len, shape.global_batch,
                           shape.kind)
    rows = _rows_of(plan, shape.global_batch)
    for p in plan.shards:
        held[p] += sum(v[rows[p[0]]].numel() * v.element_size()
                       for v in batch.values())
    if shape.kind == "train":
        oc = OptimizerConfig()
        state = init_state(model, oc)
        for d, m in plan.shards:
            held[(d, m)] += storage_bytes(state["opt"][d][m])
        step = make_train_step(model, oc,
                               num_microbatches=cfg.train_microbatches)

        def fn():
            return step(state, batch)
    elif shape.kind == "prefill":
        def fn():
            return [model.run(d, {k: v[rs] for k, v in batch.items()},
                              mode="prefill") for d, rs in rows.items()]
    else:
        caches, cache_b, gathers = _decode_caches(
            plan, model, rules or DEFAULT_RULES, shape.global_batch,
            shape.seq_len, rows)
        for p in plan.shards:
            held[p] += cache_b[p]

        def fn():
            for p, nbytes in gathers.items():
                if nbytes:
                    count.collective("all-gather", nbytes, p)
            return [model.run(d, {k: v[rs] for k, v in batch.items()},
                              mode="decode", caches=caches[d],
                              pos=shape.seq_len - 1)
                    for d, rs in rows.items()]
    return fn, held, plan, cfg, shape


def count_cell_mesh(arch: str, shape_name: str, mesh_shape: tuple, *,
                    hw=H100_SXM, variant: str = "baseline", cfg=None,
                    shape=None, positions=None, ops: bool = False) -> dict:
    """Count one cell's step per device of a mesh (`plan_input_specs`):
    the record's fields for the position with the longer roofline step,
    both positions' under ``positions``; with `ops` that position's op
    log under ``"ops"``."""
    fn, held, plan, cfg, shape = plan_input_specs(
        arch, shape_name, mesh_shape, variant=variant, cfg=cfg, shape=shape,
        positions=positions)
    t0 = time.perf_counter()
    with CostCounter(inspect=ops) as c:
        fn()
    count_s = time.perf_counter() - t0
    chips = math.prod(mesh_shape)
    per = {}
    for pos in plan.shards:
        tc = c.position_summary(pos)
        roof = roofline_terms(tc["flops_by_class"],
                              tc["bytes_accessed_fused"],
                              tc["collectives"]["total_bytes"], hw)
        live = held[pos] + tc["peak_live_bytes"]
        per[f"{pos[0]},{pos[1]}"] = {
            "memory": {"argument_bytes": held[pos],
                       "temp_bytes": tc["peak_live_bytes"],
                       "live_bytes_per_device": live,
                       "fits_hbm": bool(live <= hw.hbm_gib * 2 ** 30)},
            "cost": {"flops_per_device": tc["flops"],
                     "flops_by_class": tc["flops_by_class"],
                     "bytes_per_device": tc["bytes_accessed_fused"],
                     "bytes_per_device_unfused": tc["bytes_accessed"],
                     "transcendentals": tc["transcendentals"]},
            "kernels": tc["kernels"], "kernel_routes": tc["kernel_routes"],
            "collectives": tc["collectives"], "roofline": roof}
    key = max(per, key=lambda k: per[k]["roofline"]["step_time_bound_s"])
    top = per[key]
    flops = top["cost"]["flops_per_device"]
    mf = model_flops(cfg, shape, chips)
    rec = {"count_s": round(count_s, 3), "position": key,
           "position_note": POSITION_NOTE, **top, "cost_warnings": [],
           "model_flops_per_device": mf,
           "useful_flops_ratio": mf / total_flops(flops) if flops else 0.0,
           "hardware": hw.name, "positions": per}
    if ops:
        rec["ops"] = op_log(c, tuple(int(i) for i in key.split(",")))
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--mesh", default=MESH,
                    help="DxM (or PxDxM): 1x1 counts one device, any "
                         "other one device of the plan on that mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2x16x16 pod mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16x16 pod and the 2x16x16 multi-pod")
    ap.add_argument("--variant", default="baseline",
                    help="a named variant of launch/variants.py")
    ap.add_argument("--serve-plan", action="store_true",
                    help="analytic serving-memory report per arch x serve "
                         "mesh (no device): weights + page-pool bytes per "
                         "device vs the card's memory")
    ap.add_argument("--serve-meshes", default=SERVE_MESHES,
                    help="comma-separated DxM serve meshes for --serve-plan")
    ap.add_argument("--save-hlo", action="store_true",
                    help="there is no HLO: write the cell's counted op "
                         "breakdown (rows per op, shape and source, the "
                         "collectives, the kernel entries) beside its "
                         "record as <cell>.ops.json")
    args = ap.parse_args(argv)
    if args.serve_plan:
        serve_plan_main(args)
        raise SystemExit(0)
    if not args.all and not (args.arch and args.shape):
        raise SystemExit("give --arch and --shape, or --all")
    if args.variant != "baseline":
        from repro_torch.launch import variants
        try:
            variants.apply(args.variant, get_config(list_archs()[0]))
        except ValueError as e:
            raise SystemExit(str(e))
    if args.both_meshes:
        meshes = [(POD, False), (POD, True)]
    elif args.multi_pod:
        meshes = [(POD, True)]
    else:
        parse_mesh(args.mesh)
        meshes = [(args.mesh, False)]
    if args.variant != "baseline" and meshes == [(MESH, False)]:
        meshes = [(POD, False)]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    n_fail = 0
    for arch, shape in cells:
        for mesh, mp in meshes:
            rec = run_cell(arch, shape, out_dir=Path(args.out),
                           force=args.force, mesh=mesh, multi_pod=mp,
                           variant=args.variant, save_hlo=args.save_hlo)
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
                  f"{rec['mesh']:12s} {rec['status']:5s} {extra}",
                  flush=True)
    print(f"done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
